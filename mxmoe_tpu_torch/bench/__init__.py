"""benchmarks of the PyTorch port (see mxmoe_tpu_torch/__init__.py)."""
