"""Receive-side plumbing of the port: ``causal.CausalBuffer`` holds
out-of-order remote transactions until they are causally ready."""
