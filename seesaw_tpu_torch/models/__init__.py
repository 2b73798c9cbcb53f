"""Embedding models: the CLIP towers (`clip`), their tokenizer and image
preprocessing, the framework-free hash embedding, and the registry that
resolves an index's model name."""
