"""The plain reference: the configurations' forward pass in plain PyTorch,
f32 with TF32 off, from the raw weights. It imports nothing of the port
and nothing of the JAX package."""
