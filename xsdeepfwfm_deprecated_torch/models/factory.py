"""Model factory: flags → estimator (reference ``utils/util.py:58-73``).
Port of ``xsdeepfwfm_deprecated_tpu/models/factory.py:10-27``."""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from ..config import ModelConfig, TrainConfig, configs_from_args
from ..device import DeviceLike


def get_model(field_size: int, feature_sizes: Sequence[int], pars=None, logger=None,
              model_cfg: Optional[ModelConfig] = None,
              train_cfg: Optional[TrainConfig] = None,
              dynamic_quantization: bool = False, static_quantization: bool = False,
              quantization_aware: bool = False, device: DeviceLike = None, **_compat):
    """Build a :class:`DeepFMEstimator` from CLI flags (``pars``) or explicit
    configs. The single flags→constructor mapping of the framework.
    ``device=None`` means the CUDA device."""
    from ..train.trainer import DeepFMEstimator  # local import: avoids model↔train cycle
    if model_cfg is None or train_cfg is None:
        assert pars is not None, "need either pars or explicit configs"
        model_cfg, train_cfg = configs_from_args(pars, field_size, feature_sizes)
    if dynamic_quantization or static_quantization or quantization_aware:
        model_cfg = dataclasses.replace(
            model_cfg, dynamic_quantization=dynamic_quantization,
            static_quantization=static_quantization,
            quantization_aware=quantization_aware)
    return DeepFMEstimator(model_cfg, train_cfg, logger=logger, device=device)
