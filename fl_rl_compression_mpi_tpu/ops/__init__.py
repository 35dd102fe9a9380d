"""Codecs: NumPy goldens and the JAX device paths."""
