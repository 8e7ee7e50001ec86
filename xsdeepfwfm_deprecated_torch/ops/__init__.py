"""Embedding, interaction, MLP and int8 ops."""
