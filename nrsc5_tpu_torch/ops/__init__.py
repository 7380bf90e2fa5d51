"""Device operations of the FM chain: kernel wrappers, their plain PyTorch
versions, and the numpy tables they read."""
