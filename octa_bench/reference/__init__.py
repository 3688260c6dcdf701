"""The plain reference the benchmark's comparisons hold the program to:
plain PyTorch and NumPy, float32, importing nothing of the program or of
JAX."""
