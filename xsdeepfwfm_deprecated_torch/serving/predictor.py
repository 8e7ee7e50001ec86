"""Serving predictor over fp32 params, a :class:`QuantizedModel` or a
:class:`CompactModel`.

Port of ``xsdeepfwfm_deprecated_tpu/serving/predictor.py:22-111``. The model
moves to the device once, at construction; DeepFwFM's fp32 params are copied
there, so that the Predictor serves them as they were given at every batch
size, as the JAX package's serves its immutable arrays (its small batches read
a laid-out copy of the tower, its larger ones the params). On the card each
batch shape is captured into a CUDA graph on its first request (or by
:meth:`Predictor.warmup`), as the JAX package traces one executable for each
shape with ``jax.jit``;
every request is then a copy into the graph's input buffers, one replay and
one copy of the logits back (:meth:`Predictor.replay` is the same without the
host copies, on tensors already on the device). On the CPU the forward runs
eagerly. On the card an fp32 DeepFwFM batch of at most ``SMALL_BATCH_MAX``
rows runs the two kernels of :mod:`..ops.cuda.small_forward` in place of the
graph of ops; ``small_forward_route`` decides. A request's spans
(:mod:`..utils.profiling`): ``request``, and in it
``request.copy_in`` (on the card the copy into the graph's input buffers),
``request.launch`` (the replay, or the eager forward), both in
:meth:`Predictor.replay`, ``request.wait`` (with tracing on only: the host
waits for the card) and ``request.copy_out`` (the logits to host numpy).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

from .. import _tree
from ..compression.quantization import QuantizedModel, quantized_forward
from ..config import ModelConfig
from ..device import DeviceLike, resolve_device
from ..models import deepfwfm, dlrm
from ..ops.cuda import small_forward
from ..ops.embedding import packed_lookup_serving
from ..utils import cuda_graph, profiling
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
                 device: DeviceLike = None, forward_fn: Optional[Callable] = None):
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
            if forward_fn is None and cfg.use_dlrm:
                forward_fn = dlrm.forward
            own = forward_fn is None    # deepfwfm.forward's params: the Predictor's own copy
            self._model = _tree.tree_map(lambda t: t.to(self.device, copy=own), model)
            if own:
                self._fn = _fp32_forward(self._model, cfg, kernels=self.device.type == "cuda")
            else:
                self._fn = lambda p, xi, xv: forward_fn(p, xi, xv, cfg)
        self._graphs = cuda_graph.Compiled(
            self._forward, f"the Predictor's forward of a {type(self._model).__name__}",
            device=self.device)

    def _forward(self, xi: torch.Tensor, xv: torch.Tensor) -> torch.Tensor:
        return self._fn(self._model, xi, xv)

    @torch.inference_mode()
    def replay(self, xi: torch.Tensor, xv: torch.Tensor) -> torch.Tensor:
        """The logits of a batch as a tensor on the device. On the card the
        batch is copied into the static buffers of its shape's CUDA graph,
        the graph is replayed and its output tensor is returned: the next
        request of that shape overwrites it. On the CPU the eager forward."""
        with profiling.named_scope("request.copy_in"):
            forward = self._graphs.load((), {"xi": xi, "xv": xv})
        with profiling.named_scope("request.launch"):
            return forward()

    def logits(self, xi: np.ndarray, xv: np.ndarray) -> np.ndarray:
        with profiling.named_scope("request", unit=True):
            out = self.replay(torch.from_numpy(np.ascontiguousarray(xi, np.int32)),
                              torch.from_numpy(np.ascontiguousarray(xv, np.float32)))
            if profiling.enabled():     # else the copy out waits for the card
                with profiling.named_scope("request.wait"):
                    if self.device.type == "cuda":
                        torch.cuda.current_stream(self.device).synchronize()
            with profiling.named_scope("request.copy_out"):
                return out.cpu().numpy()

    def predict_proba(self, xi: np.ndarray, xv: np.ndarray) -> np.ndarray:
        return 1.0 / (1.0 + np.exp(-self.logits(xi, xv).astype(np.float64)))

    def predict(self, xi: np.ndarray, xv: np.ndarray) -> np.ndarray:
        return self.predict_proba(xi, xv) > 0.5

    def warmup(self, batch_sizes=(1, 8192)) -> "Predictor":
        """Answer one request of each serving batch shape: on the card this
        captures the shape's graph (and builds the kernels), as the JAX
        ``warmup`` compiles for the serving shapes."""
        for b in batch_sizes:
            self.logits(np.zeros((b, self.cfg.index_columns), np.int32),
                        np.zeros((b, self.cfg.numerical), np.float32))
        return self


def _fp32_forward(params: Dict, cfg: ModelConfig, kernels: bool) -> Callable:
    """The fp32 forward of ``models/deepfwfm.forward``. With ``kernels`` (on the
    card), a batch that ``small_forward.small_forward_route`` takes runs the two
    kernels of ``ops/cuda/small_forward`` instead, on the model as
    :func:`small_forward.pack` lays it out now, from the Predictor's own copy of
    the params; every other batch runs the graph of ops. The route is picked once
    a batch shape, at its capture."""
    small = (small_forward.pack(params, cfg)
             if kernels and small_forward.small_forward_route(cfg, 1) else None)

    def forward(p: Dict, xi: torch.Tensor, xv: torch.Tensor) -> torch.Tensor:
        if small is not None and small_forward.small_forward_route(cfg, xi.shape[0]):
            return small_forward.small_forward(small, xi, xv)
        return deepfwfm.forward(p, xi, xv, cfg, lookup_fn=packed_lookup_serving)
    return forward
