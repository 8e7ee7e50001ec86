"""PyTorch/CUDA port of ``xsdeepfwfm_deprecated_tpu`` for one NVIDIA H100.

Module paths mirror the JAX package (``config``, ``ops/``, ``models/``,
``compression/``, ``serving/``), so each function's counterpart is found at
the same path there. The port imports ``torch``, numpy and the standard
library only: never ``jax`` and nothing of the JAX package.

Entry points (``serving.predictor.Predictor``, ``weights.load_*``) run on
the CUDA device unless they are given ``device="cpu"``.
"""
