"""Plain reference of the benchmark's solves (PyTorch only, no import of the port)."""
