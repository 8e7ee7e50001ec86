"""Carry weights across from the JAX package.

The port keeps the JAX parameter layout and leaf names, so weights cross as
they are: nested dicts and lists of arrays, ``(in, out)`` weights, no
transposes. This module reads what the JAX package writes:

* a parameter pytree already in numpy (:func:`params_from_numpy`);
* an npz checkpoint from either package's ``train/checkpoint.save_checkpoint``
  (:func:`load_jax_checkpoint` for the params, :func:`load_train_state` for
  params and optimizer state): ``params::`` and ``opt::`` names, COO entries
  (``@idx`` / ``@val`` / ``@shape``), bf16 tables stored widened to f32. The
  port's optimizer state has optax's leaf names (``train/trainer.Optimizer``),
  so the ``opt::`` entries cross unchanged, and the port's own checkpoints
  load in the JAX package through its ``load_checkpoint``;
* a ``_dynamic_quant`` / ``_static_quant`` npz from ``cli/quantization``
  (:func:`load_quantized_artifact`);
* a JAX ``CompactModel``'s leaves as numpy arrays (:func:`compact_from_numpy`).

A model family other than DeepFwFM (NFM) passes its own ``init_fn`` for the
template that names a checkpoint's entries.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from . import _tree
from .compression.quantization import QuantizedModel
from .config import ModelConfig, TrainConfig
from .device import DeviceLike, resolve_device
from .models import deepfwfm
from .serving.compaction import CompactModel
from .train import checkpoint as ckpt
from .train.trainer import make_optimizer

QUANT_SECTIONS = ("params_fp", "emb1_q", "emb2_q", "deep_q", "act_scales", "ffm1_q", "ffm2_q")


def _to_tensor(arr: Any, device: torch.device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":     # numpy's bfloat16 extension type
        return torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr)).to(device)


def params_from_numpy(tree: Any, device: DeviceLike = None) -> Any:
    """JAX param pytree (nested dicts and lists of numpy arrays, or arrays
    that convert to numpy) → the same tree of tensors on ``device``."""
    device = resolve_device(device)
    return _tree.tree_map(lambda a: _to_tensor(a, device), tree)


def params_to_numpy(params: Any) -> Any:
    """The reverse: tensors → numpy arrays. bf16 tensors become float32
    (lossless), as the JAX checkpoint stores them."""
    def conv(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return _tree.tree_map(conv, params)


InitFn = Callable[..., Dict]


def load_jax_checkpoint(path: str, cfg: ModelConfig, device: DeviceLike = None,
                        init_fn: InitFn = deepfwfm.init_params) -> Dict:
    """Params from an npz checkpoint of either package. Every parameter that
    ``cfg`` defines must be present with its shape; each takes the dtype the
    port gives it (bf16 tables are cast back from f32). ``init_fn`` is the
    model family's ``init_params`` (an estimator's ``model_init``)."""
    template = init_fn(None, cfg, device="meta")
    return ckpt.load_checkpoint(path, template, device=device)[0]


def load_train_state(path: str, cfg: ModelConfig, tcfg: TrainConfig,
                     device: DeviceLike = None,
                     init_fn: InitFn = deepfwfm.init_params) -> Tuple[Dict, Any, Dict]:
    """(params, optimizer state, metadata) from an npz checkpoint of either
    package, for the optimizer that ``tcfg`` names."""
    template = init_fn(None, cfg, device="meta")
    return ckpt.load_checkpoint(path, template, make_optimizer(tcfg).init(template),
                                device=device)


def load_quantized_artifact(path: str, cfg: ModelConfig, device: DeviceLike = None,
                            mode: Optional[str] = None) -> QuantizedModel:
    """A ``_dynamic_quant`` / ``_static_quant`` npz → :class:`QuantizedModel`.
    ``mode`` defaults to "static" when the artifact has activation scales."""
    device = resolve_device(device)
    sections: Dict[str, Dict[str, torch.Tensor]] = {s: {} for s in QUANT_SECTIONS}
    with np.load(path if path.endswith(".npz") else path + ".npz") as data:
        for key in data.files:
            section, name = key.split("::", 1)
            if section not in sections:
                raise ValueError(f"unknown section {section!r} in {path}")
            sections[section][name] = _to_tensor(data[key], device)
    trees = {s: (_tree.unflatten(flat) if flat else None) for s, flat in sections.items()}
    act = trees["act_scales"]
    return QuantizedModel(cfg=cfg, mode=mode or ("static" if act else "dynamic"),
                          params_fp=trees["params_fp"] or {}, emb1_q=trees["emb1_q"],
                          emb2_q=trees["emb2_q"], deep_q=trees["deep_q"], act_scales=act,
                          ffm1_q=trees["ffm1_q"], ffm2_q=trees["ffm2_q"])


def compact_from_numpy(cfg: ModelConfig, int8: bool, keep_in0: Sequence[int], params_fp: Any,
                       emb1: Any, emb2: Any, deep: Any, device: DeviceLike = None
                       ) -> CompactModel:
    """A JAX ``CompactModel``'s parts (its four trees as numpy arrays, with
    its ``int8`` flag and ``keep_in0``) → the port's :class:`CompactModel`
    on ``device``. ``cfg`` is the port's config of the same model."""
    device = resolve_device(device)
    trees = {name: _tree.tree_map(lambda a: _to_tensor(a, device), tree)
             for name, tree in (("params_fp", params_fp), ("emb1", emb1), ("emb2", emb2),
                                ("deep", deep))}
    return CompactModel(cfg=cfg, int8=bool(int8), keep_in0=tuple(int(i) for i in keep_in0),
                        **trees)
