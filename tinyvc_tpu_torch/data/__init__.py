"""Training data over the JAX package's cache format."""
