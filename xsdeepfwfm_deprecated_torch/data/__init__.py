"""Host-side batching."""
