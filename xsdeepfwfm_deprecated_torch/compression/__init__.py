"""Post-training quantization."""
