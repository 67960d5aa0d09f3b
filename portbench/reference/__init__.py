"""The plain reference of the benchmark: float64 NumPy and PyTorch,
written from the configuration files' stated semantics.  It imports
nothing of the program, of JAX or of the JAX package, and takes nothing
the program made: the program's outputs are only judged."""
