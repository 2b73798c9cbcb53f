"""Feedback loops over the PyTorch index."""
