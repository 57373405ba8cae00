"""Plain PyTorch reference of whole-utterance conversion, independent of
the program under test: it imports neither the port nor the JAX package."""
