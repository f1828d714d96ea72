"""The benchmark's plain reference: a dense particle filter and the
models it runs, in PyTorch and NumPy alone (nothing of the program)."""
