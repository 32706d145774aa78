"""Encoder, tokenizer and embedding service of the port."""
