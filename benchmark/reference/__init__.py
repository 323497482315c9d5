"""Plain PyTorch references that the benchmark judges the program by."""
