"""See ``portbench/README.md``."""
