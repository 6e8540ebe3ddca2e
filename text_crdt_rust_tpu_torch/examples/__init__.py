"""Runnable examples of the port (``python -m
text_crdt_rust_tpu_torch.examples.<name>``):

- ``sync_stream``: peers' out-of-order txns through the causal buffer onto
  the per-lane engine;
- ``soak``: 1M seeded random edits on the native engine, checked against
  the rope and, for a prefix, the oracle step by step
  (`examples/simple.rs:14-49`);
- ``stats``: a trace replay with its memory and compaction report
  (`examples/stats.rs:39-73`).
"""
