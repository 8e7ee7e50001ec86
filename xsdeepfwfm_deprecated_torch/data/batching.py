"""Host-side batching: dense arrays → fixed-shape device batches.

The port's own copy of ``xsdeepfwfm_deprecated_tpu/data/batching.py``. Every
batch has a static shape: the trailing partial batch is padded and carries a
validity mask (the loss divides by ``sum(mask)``), which is also what a
captured CUDA graph needs. Labels and values stay float32, indices int32.
:func:`stack_groups` stacks K batches into the ``(K, B, ...)`` groups that a
multi-step or a scanned eval takes (the JAX package's ``stacked()``,
``train/trainer.py:537-556``).
"""

from __future__ import annotations

import collections
import itertools
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..utils import profiling


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


def stack_groups(batches: Iterable[Dict], k: int) -> Iterator[Dict]:
    """``k`` batches at a time (of :func:`iter_batches`, each padded as it
    pads a batch alone), every array stacked into ``(k, ...)``. A last group
    of fewer real batches is filled with all-padding batches (mask, labels
    and teacher logits 0) that a multi-step skips; ``k_real`` counts the real
    ones. Other values (``n_valid``) are dropped."""
    it = iter(batches)
    while True:
        chunk: List[Dict] = list(itertools.islice(it, k))
        if not chunk:
            return
        k_real = len(chunk)
        if k_real < k:
            phantom = {key: np.zeros_like(v) if key in ("y", "mask", "teacher") else v
                       for key, v in chunk[-1].items()}
            chunk += [phantom] * (k - k_real)
        group = {key: np.stack([b[key] for b in chunk]) for key, v in chunk[0].items()
                 if isinstance(v, np.ndarray)}
        group["k_real"] = k_real
        yield group


class _PinnedRing:
    """``slots`` sets of pinned host buffers, one buffer per array name,
    used in turn for host-to-device copies. A set is refilled only after the
    copies made from it have completed (an event recorded after them), so a
    ``non_blocking`` copy never reads a buffer that is being rewritten. A
    buffer is allocated once and then only written, which keeps the pinning
    allocator out of the feed's loop. Spans (:mod:`..utils.profiling`):
    ``feed.wait`` for the slot's copies, ``feed.stage`` for the copy into it
    and the issue of the copies."""

    def __init__(self, slots: int):
        self.buffers: List[Dict[str, torch.Tensor]] = [{} for _ in range(slots)]
        self.events: List[Optional[torch.cuda.Event]] = [None] * slots
        self.next = 0

    def to_device(self, batch: Dict, device: torch.device) -> Dict:
        i, self.next = self.next, (self.next + 1) % len(self.buffers)
        if self.events[i] is not None:
            with profiling.named_scope("feed.wait"):
                self.events[i].synchronize()
        with profiling.named_scope("feed.stage"):
            bufs, out = self.buffers[i], {}
            for key, v in batch.items():
                if isinstance(v, np.ndarray):
                    buf = bufs.get(key)
                    if (buf is None or buf.numpy().shape != v.shape
                            or buf.numpy().dtype != v.dtype):
                        buf = bufs[key] = torch.from_numpy(np.empty(v.shape, v.dtype)).pin_memory()
                    buf.numpy()[...] = v
                    v = buf.to(device, non_blocking=True)
                out[key] = v
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(device))
            self.events[i] = event
        return out


def _to_cpu_tensors(batch: Dict) -> Dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).reshape(v.shape)   # 0-d stays 0-d
            if isinstance(v, np.ndarray) else v for k, v in batch.items()}


def prefetch_to_device(batch_iter: Iterable[Dict], device: torch.device,
                       size: int = 2) -> Iterator[Dict]:
    """Double-buffered device prefetch: the next batch's copy is issued while
    the current step runs. The arrays of each batch become tensors on
    ``device``; on a CUDA device they are copied into a ring of ``size + 1``
    pinned host buffers and sent with ``non_blocking=True`` copies, so the
    host does not wait for them. Other values (``n_valid``, ``k_real``) pass
    through."""
    ring = _PinnedRing(size + 1) if device.type == "cuda" else None
    queue: collections.deque = collections.deque()

    def put(batch: Dict) -> None:
        if ring is not None:
            queue.append(ring.to_device(batch, device))
            return
        with profiling.named_scope("feed.stage"):
            queue.append(_to_cpu_tensors(batch))

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
