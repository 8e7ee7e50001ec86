"""Training: optimizers, estimator, checkpoints, metrics, recovery."""

from .trainer import DeepFMEstimator, make_eval_fn, make_optimizer, make_train_step  # noqa: F401
