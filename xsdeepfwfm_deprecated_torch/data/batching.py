"""Host-side batching: dense arrays → fixed-shape device batches.

The port's own copy of ``xsdeepfwfm_deprecated_tpu/data/batching.py``. Every
batch has a static shape: the trailing partial batch is padded and carries a
validity mask (the loss divides by ``sum(mask)``), which is also what a
captured CUDA graph needs. Labels and values stay float32, indices int32.
"""

from __future__ import annotations

import collections
from typing import Dict, Iterable, Iterator, Tuple

import numpy as np
import torch


def shuffle_arrays(rng: np.random.Generator, *arrays: np.ndarray) -> Tuple[np.ndarray, ...]:
    """One shared permutation over N arrays."""
    n = arrays[0].shape[0]
    perm = rng.permutation(n)
    return tuple(a[perm] for a in arrays)


def iter_batches(index: np.ndarray, value: np.ndarray, label: np.ndarray,
                 batch_size: int, *, drop_remainder: bool = False,
                 pad_to_full: bool = True) -> Iterator[Dict[str, np.ndarray]]:
    """Yield dict batches {xi, xv, y, mask, n_valid}.

    ``mask`` is 1.0 for real rows, 0.0 for pad rows; padded rows replicate row 0
    (safe indices).
    """
    n = index.shape[0]
    for start in range(0, n, batch_size):
        end = min(n, start + batch_size)
        xi = index[start:end]
        xv = value[start:end]
        y = label[start:end]
        n_valid = end - start
        if n_valid < batch_size:
            if drop_remainder:
                return
            if pad_to_full:
                pad = batch_size - n_valid
                xi = np.concatenate([xi, np.repeat(xi[:1], pad, axis=0)], axis=0)
                xv = np.concatenate([xv, np.repeat(xv[:1], pad, axis=0)], axis=0)
                y = np.concatenate([y, np.zeros(pad, dtype=y.dtype)], axis=0)
        mask = np.zeros(xi.shape[0], dtype=np.float32)
        mask[:n_valid] = 1.0
        yield {"xi": xi.astype(np.int32), "xv": xv.astype(np.float32),
               "y": y.astype(np.float32), "mask": mask, "n_valid": n_valid}


def pad_batch_count(n: int, batch_size: int) -> int:
    return -(-n // batch_size)


def prefetch_to_device(batch_iter: Iterable[Dict], device: torch.device,
                       size: int = 2) -> Iterator[Dict]:
    """Double-buffered device prefetch: the next batch's copy is issued while
    the current step runs. The arrays of each batch become tensors on
    ``device``; on a CUDA device they go through pinned host buffers with
    ``non_blocking=True`` copies, so the host does not wait for them. Other
    values (``n_valid``) pass through."""
    pinned = device.type == "cuda"
    queue: collections.deque = collections.deque()

    def put(batch: Dict) -> None:
        out = {}
        for k, v in batch.items():
            if isinstance(v, np.ndarray):
                t = torch.from_numpy(np.ascontiguousarray(v)).reshape(v.shape)   # 0-d stays 0-d
                v = t.pin_memory().to(device, non_blocking=True) if pinned else t.to(device)
            out[k] = v
        queue.append(out)

    it = iter(batch_iter)
    for _ in range(size):
        batch = next(it, None)
        if batch is not None:
            put(batch)
    while queue:
        out = queue.popleft()
        batch = next(it, None)
        if batch is not None:
            put(batch)
        yield out
