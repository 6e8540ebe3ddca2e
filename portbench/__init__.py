"""The port's benchmark: one cell of ``BENCHMARK.json`` run once.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

See ``README.md``. Nothing here imports JAX or the JAX package; the port
(``text_crdt_rust_tpu_torch``) is imported only by the entry adapters
under ``entries/``.
"""
