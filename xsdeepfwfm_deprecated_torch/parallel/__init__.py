"""Sharded training: the rank mesh, the row-sharded lookup exchanges, launching ranks."""
