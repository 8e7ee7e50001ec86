"""Serving."""
