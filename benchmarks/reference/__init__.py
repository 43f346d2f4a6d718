"""Plain references of the benchmark's configurations: straightforward
PyTorch and NumPy, importing nothing of the program under test."""
