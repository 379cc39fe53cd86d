"""Device and frame residency for the PyTorch port (the rest of avutil is
the JAX package's host code, used as it is)."""
