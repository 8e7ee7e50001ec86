"""Training: optimizers, estimator, checkpoints, metrics, recovery."""
