"""Serving predictor over fp32 params, a :class:`QuantizedModel` or a
:class:`CompactModel`.

Port of ``xsdeepfwfm_deprecated_tpu/serving/predictor.py:22-111``. The model
moves to the device once, at construction; each request runs the eager
forward there.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

from .. import _tree
from ..compression.quantization import QuantizedModel, quantized_forward
from ..config import ModelConfig
from ..device import DeviceLike, resolve_device
from ..models import deepfwfm
from ..ops.embedding import packed_lookup_serving
from .compaction import CompactModel, compact_forward

LAYOUTS = ("auto", "grouped", "flat", "super")


class Predictor:
    """Holds (params | QuantizedModel | CompactModel) on a device; batch or
    single-example.

    ``device=None`` means the CUDA device, and raises when there is none.
    ``layout`` accepts the JAX package's values ("auto", "grouped", "flat",
    "super"); all of them serve the flat packed table, because the grouped
    and super-row layouts are TPU gather workarounds with the same logits.
    A :class:`QuantizedModel` runs its deep tower through the fused int8
    kernel exactly when the device is CUDA, the activation scales are
    dynamic (``act_scales is None``) and the model has a deep tower. A
    :class:`CompactModel`'s int8 tower always runs layer by layer, with the
    per-batch scale its logits are defined by.
    """

    def __init__(self, model: Union[Dict, QuantizedModel, CompactModel],
                 cfg: Optional[ModelConfig] = None, layout: str = "auto",
                 device: DeviceLike = None):
        if layout not in LAYOUTS:
            raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
        if not isinstance(model, (dict, QuantizedModel, CompactModel)):
            raise TypeError(f"cannot serve a {type(model).__name__}: give fp32 params (a dict), "
                            "a QuantizedModel or a CompactModel")
        self.device = resolve_device(device)
        if isinstance(model, CompactModel):
            self.cfg = model.cfg
            self._model = model.to(self.device)
            self._model.deep_f, self._model.numeric_rows   # made once, on the device
            self._fn = compact_forward
        elif isinstance(model, QuantizedModel):
            self.cfg = model.cfg
            self._model = model.to(self.device)
            if model.deep_q is not None:
                self._model.deep_f    # the layerwise path's float copies, made once
            fused = (self.device.type == "cuda" and model.act_scales is None
                     and model.deep_q is not None)
            if fused and self.cfg.num_deeps == 1:
                self._model.fused_tower   # lay the kernel's weights out once, now
            self._fn = lambda m, xi, xv: quantized_forward(m, xi, xv, use_fused_kernel=fused)
        else:
            if cfg is None:
                raise ValueError("fp32 params need an explicit ModelConfig")
            self.cfg = cfg
            self._model = _tree.tree_map(lambda t: t.to(self.device), model)
            self._fn = lambda p, xi, xv: deepfwfm.forward(p, xi, xv, cfg,
                                                          lookup_fn=packed_lookup_serving)

    @torch.inference_mode()
    def logits(self, xi: np.ndarray, xv: np.ndarray) -> np.ndarray:
        xi = torch.as_tensor(np.asarray(xi, np.int32)).to(self.device)
        xv = torch.as_tensor(np.asarray(xv, np.float32)).to(self.device)
        return self._fn(self._model, xi, xv).cpu().numpy()

    def predict_proba(self, xi: np.ndarray, xv: np.ndarray) -> np.ndarray:
        return 1.0 / (1.0 + np.exp(-self.logits(xi, xv).astype(np.float64)))

    def predict(self, xi: np.ndarray, xv: np.ndarray) -> np.ndarray:
        return self.predict_proba(xi, xv) > 0.5

    def warmup(self, batch_sizes=(1, 8192)) -> "Predictor":
        """Run each serving batch shape once (on CUDA this builds the kernels)."""
        for b in batch_sizes:
            self.logits(np.zeros((b, self.cfg.num_categorical), np.int32),
                        np.zeros((b, self.cfg.numerical), np.float32))
        return self
