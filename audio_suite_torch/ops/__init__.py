"""Device ops of the port: plain PyTorch functions on tensors, and the
wrappers of the hand-written kernels."""
