"""Device ops of the port, in PyTorch."""
