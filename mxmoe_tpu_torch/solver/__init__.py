"""The bitwidth-allocation MILP and its runtime models (PyTorch port)."""
