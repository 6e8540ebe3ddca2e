"""Device code of the port.

- ``batch``        the numpy op compiler (local edits, step fusion,
                   remote txns, by-order log prefill);
- ``span_arrays``  ``FlatDoc``, the per-char document on tensors;
- ``blocked``      the per-character block replay of one shared local
                   stream (the document in shared memory) and the block
                   helpers every replay shares: plain PyTorch version and
                   the wrapper of its CUDA kernel;
- ``blocked_hbm``  the per-character block replay with the rows in device
                   memory and a two-level live index (the full
                   automerge-paper trace), doc groups: plain version and
                   CUDA kernel wrapper;
- ``blocked_mixed`` the per-character block replay of mixed local/remote
                   streams (the config-4 storm): plain version and CUDA
                   kernel wrapper;
- ``rle``          the north-star run-block replay: plain PyTorch version
                   and the wrapper of its CUDA kernel;
- ``rle_hbm``      the run-block replay with millions of run rows (planes
                   in device memory, a two-level live index) of kevin and
                   the north star at 1,024 documents: plain PyTorch version
                   and the wrapper of its CUDA kernel;
- ``rle_mixed``    the mixed local/remote run replay of the storm: plain
                   PyTorch version and the wrapper of its CUDA kernel;
- ``rle_lanes``    the per-lane local replays of config 5 (un-blocked and
                   blocked): plain versions and their CUDA kernels' wrappers,
                   plus the lane-vector helpers the mixed ones share;
- ``rle_lanes_mixed`` the per-lane mixed replays of config 5r, likewise;
- ``lane_blocks``  per-lane K-row block helpers of the blocked engines;
- ``_kernels``     builds ``csrc/*.cu`` with nvcc, loads and counts them.
"""
