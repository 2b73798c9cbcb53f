"""Index access methods, in PyTorch."""
