"""The plain reference: plain PyTorch, f32 with TF32 off; imports nothing of the port, the JAX package or JAX."""
