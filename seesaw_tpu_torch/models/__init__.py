"""Embedding models: the framework-free hash embedding (CLIP is a later
slice of the port)."""
