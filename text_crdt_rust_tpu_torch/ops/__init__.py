"""Device code of the port.

- ``batch``        the numpy op compiler (local edits, step fusion,
                   by-order log prefill);
- ``span_arrays``  ``FlatDoc``, the per-char document on tensors;
- ``blocked``      block-plane helpers of the run replays;
- ``rle``          the north-star run-block replay: plain PyTorch version
                   and the wrapper of its CUDA kernel;
- ``_kernels``     builds ``csrc/*.cu`` with nvcc, loads and counts them.
"""
