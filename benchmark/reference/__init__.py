"""The benchmark's plain reference: NumPy, hashlib and Python integers.
Nothing here imports the program or the JAX package."""
