"""Plain PyTorch references that decide `correct`: no code of the
measured package, no JAX."""
