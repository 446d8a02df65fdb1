"""The harness: specs found by name, seeded weights and traffic, the serving
loop over the port's Engine, the trace reader, model operations and the
correctness check."""
