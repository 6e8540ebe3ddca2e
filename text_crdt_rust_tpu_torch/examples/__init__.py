"""Runnable examples of the port (``python -m
text_crdt_rust_tpu_torch.examples.<name>``)."""
