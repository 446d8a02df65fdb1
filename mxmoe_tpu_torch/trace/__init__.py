"""Gate and activation tracing and the kernel performance-table profiler of
the PyTorch port."""
