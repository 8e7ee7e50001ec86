"""PyTorch/CUDA port of ``xsdeepfwfm_deprecated_tpu`` for one NVIDIA H100.

Module paths mirror the JAX package (``config``, ``data/``, ``ops/``,
``models/``, ``compression/``, ``train/``, ``serving/``, ``utils/``), so each
function's counterpart is found at the same path there. The port imports
``torch``, numpy and the standard library only: never ``jax`` and nothing of
the JAX package.

Entry points (``serving.predictor.Predictor``,
``train.trainer.DeepFMEstimator``, ``train.checkpoint.load_checkpoint``,
``weights.load_*``) run on the CUDA device unless they are given
``device="cpu"``.
"""
