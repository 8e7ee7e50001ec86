"""Checkpoint and resume: params, optimizer state, step, epoch and metadata.

Port of ``xsdeepfwfm_deprecated_tpu/train/checkpoint.py:24-108, 214-274``, in
the same format, so that a checkpoint written by either package loads in the
other: one ``.npz`` of flattened tree leaves (``params::emb2/dense``,
``opt::1/0/mu/emb2/dense``) plus a ``.meta.json`` sidecar. With
``sparse=True`` a mostly-zero (pruned) array is stored in COO form as
``<name>@idx / @val / @shape``. bf16 leaves are stored widened to float32
(lossless) and cast back to the template's dtype on load.

The port writes npz only: ``backend="orbax"`` raises.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .. import _tree
from ..device import DeviceLike, resolve_device

SPARSE_THRESHOLD = 0.5   # store arrays that are more than half zero in COO form


def _flatten(tree: Any, prefix: str) -> Dict[str, np.ndarray]:
    flat = {}
    for name, leaf in _tree.named_leaves(tree):
        t = leaf.detach().cpu()
        flat[prefix + name] = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return flat


def _encode(arrays: Dict[str, np.ndarray], sparse: bool) -> Dict[str, np.ndarray]:
    out = {}
    for name, arr in arrays.items():
        if sparse and arr.size > 1024 and np.issubdtype(arr.dtype, np.floating):
            nz = np.flatnonzero(arr)
            if len(nz) < (1.0 - SPARSE_THRESHOLD) * arr.size:
                out[name + "@idx"] = nz.astype(np.int64)
                out[name + "@val"] = arr.ravel()[nz]
                out[name + "@shape"] = np.asarray(arr.shape, np.int64)
                continue
        out[name] = arr
    return out


def _decode(data, key: str) -> Optional[np.ndarray]:
    """A dense entry, or a COO one expanded back to dense."""
    if key in data:
        return data[key]
    if key + "@idx" in data:
        shape = tuple(int(n) for n in data[key + "@shape"])
        flat = np.zeros(int(np.prod(shape)), dtype=data[key + "@val"].dtype)
        flat[data[key + "@idx"]] = data[key + "@val"]
        return flat.reshape(shape)
    return None


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _meta_path(path: str) -> str:
    return (path[:-4] if path.endswith(".npz") else path) + ".meta.json"


def _require_npz(backend: str) -> None:
    if backend != "npz":
        raise ValueError(f"checkpoint backend {backend!r}: the port writes npz only "
                         "(the orbax backend is not ported)")


def checkpoint_exists(path: str) -> bool:
    return os.path.exists(_npz_path(path))


def save_checkpoint(path: str, params: Any, opt_state: Any = None, *,
                    step: int = 0, epoch: int = 0, metadata: Optional[Dict] = None,
                    sparse: bool = False, backend: str = "npz") -> None:
    """Write ``<path>.npz`` and ``<path>.meta.json``."""
    _require_npz(backend)
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    arrays = _encode(_flatten(params, "params::"), sparse)
    if opt_state is not None:
        arrays.update(_encode(_flatten(opt_state, "opt::"), sparse))
    np.savez(_npz_path(path), **arrays)
    meta = dict(metadata or {})
    meta.update({"step": int(step), "epoch": int(epoch)})
    with open(_meta_path(path), "w") as f:
        json.dump(meta, f, indent=2)


def wait_for_saves() -> None:
    """Nothing to wait for: npz saves are written before ``save_checkpoint``
    returns. Kept so that callers of either package read the same."""


def load_checkpoint(path: str, params_template: Any, opt_state_template: Any = None,
                    *, strict: bool = True, device: DeviceLike = None
                    ) -> Tuple[Any, Any, Dict]:
    """Restore (params, opt_state, metadata) shaped like the templates, as
    tensors on ``device`` (``None``: the CUDA device). A template's leaves
    give shape and dtype and may live on any device, ``meta`` included.
    ``strict=False`` keeps the template's leaf (moved to ``device``) where
    the checkpoint has no entry."""
    device = resolve_device(device)
    with np.load(_npz_path(path)) as data:
        def restore(template: Any, prefix: str) -> Any:
            flat = {}
            for name, leaf in _tree.named_leaves(template):
                arr = _decode(data, prefix + name)
                if arr is None:
                    if strict:
                        raise KeyError(f"checkpoint missing {prefix}{name}")
                    flat[name] = leaf.to(device)
                    continue
                if tuple(arr.shape) != tuple(leaf.shape):
                    raise ValueError(f"{prefix}{name} has shape {tuple(arr.shape)}, "
                                     f"expected {tuple(leaf.shape)}")
                flat[name] = torch.from_numpy(np.array(arr)).to(device=device, dtype=leaf.dtype)
            return _tree.rebuild(template, flat)

        params = restore(params_template, "params::")
        opt_state = (restore(opt_state_template, "opt::")
                     if opt_state_template is not None else None)
    meta: Dict = {}
    if os.path.exists(_meta_path(path)):
        with open(_meta_path(path)) as f:
            meta = json.load(f)
    return params, opt_state, meta


def model_size_bytes(params: Any) -> int:
    """Bytes of the parameter tree's leaves."""
    return sum(t.numel() * t.element_size() for t in _tree.leaves(params))
