"""Multi-process input pipeline: sharded file reads + deterministic shuffling.

The port's own copy of ``xsdeepfwfm_deprecated_tpu/data/sharded_input.py``.
The reference loads the entire dataset into Python lists on one process
(``utils/data_preprocess.py:63-72``), which does not scale to full Criteo
(41.3M rows) across processes. This pipeline:

* assigns each process a disjoint slice of the row space (or of a file
  list) by its index: by default its ``torch.distributed`` rank among the
  world's, 0 of 1 without a process group;
* streams fixed-size chunks instead of materializing the dataset;
* shuffles deterministically per epoch from ``(seed, epoch)`` so every
  process permutes ITS OWN shard identically across restarts; with
  checkpoint and resume that gives reproducible epochs.

Process ``h``'s local batch is the global batch's rows
``[h·B_local, (h+1)·B_local)``, the rows a rank of a sharded fit steps on
(``parallel/mesh.batch_rows``).
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist


def _process(process_index: Optional[int], process_count: Optional[int]) -> Tuple[int, int]:
    """(index, count): the given pair, or this process's ``torch.distributed``
    rank and world size, or 0 and 1 without a process group."""
    if process_index is not None and process_count is not None:
        return process_index, process_count
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def host_shard(n_rows: int, process_index: Optional[int] = None,
               process_count: Optional[int] = None) -> Tuple[int, int]:
    """[start, end) row range owned by this process (balanced contiguous split)."""
    process_index, process_count = _process(process_index, process_count)
    base = n_rows // process_count
    extra = n_rows % process_count
    start = process_index * base + min(process_index, extra)
    end = start + base + (1 if process_index < extra else 0)
    return start, end


def shard_files(paths: Sequence[str], process_index: Optional[int] = None,
                process_count: Optional[int] = None) -> List[str]:
    """Round-robin file assignment for file-per-shard datasets."""
    process_index, process_count = _process(process_index, process_count)
    return [p for i, p in enumerate(sorted(paths)) if i % process_count == process_index]


def epoch_permutation(n: int, seed: int, epoch: int) -> np.ndarray:
    """Deterministic permutation for (seed, epoch) — identical across restarts."""
    return np.random.default_rng(np.random.SeedSequence([seed, epoch])).permutation(n)


class ShardedCsvPipeline:
    """Streaming mapped-CSV reader over this process's row shard.

    ``path`` must be an index-mapped CSV in the framework's layout (label,
    numeric values, categorical indices). Rows are chunk-read with
    ``np.loadtxt`` over line offsets, so memory stays O(chunk).
    """

    def __init__(self, path: str, n_numeric: int, *, chunk_rows: int = 262144,
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None):
        self.path = path
        self.n_numeric = n_numeric
        self.chunk_rows = chunk_rows
        self._line_offsets = self._index_lines(path)
        self.start, self.end = host_shard(len(self._line_offsets),
                                          process_index, process_count)

    @staticmethod
    def _index_lines(path: str) -> np.ndarray:
        offsets = [0]
        with open(path, "rb") as f:
            for line in f:
                offsets.append(offsets[-1] + len(line))
        return np.asarray(offsets[:-1], dtype=np.int64)

    @property
    def local_rows(self) -> int:
        return self.end - self.start

    def _read_rows(self, rows: np.ndarray) -> Dict[str, np.ndarray]:
        out = []
        with open(self.path, "rb") as f:
            for off in self._line_offsets[rows]:
                f.seek(off)
                out.append(f.readline().decode())
        data = np.loadtxt(out, delimiter=",", dtype=np.float64, ndmin=2)
        return {
            "label": data[:, 0].astype(np.float32),
            "value": data[:, 1:1 + self.n_numeric].astype(np.float32),
            "index": data[:, 1 + self.n_numeric:].astype(np.int32),
        }

    def epoch_batches(self, batch_size: int, seed: int, epoch: int,
                      drop_remainder: bool = True) -> Iterator[Dict[str, np.ndarray]]:
        """Shuffled fixed-size batches over this process's shard for one epoch."""
        perm = epoch_permutation(self.local_rows, seed, epoch) + self.start
        n = self.local_rows
        stop = n - batch_size + 1 if drop_remainder else n
        for lo in range(0, stop, batch_size):
            rows = np.sort(perm[lo:lo + batch_size])  # sorted seeks, shuffled set
            yield self._read_rows(rows)


class ShardedBinPipeline:
    """Memory-mapped fixed-record binary dataset: the ≥1M-rows/s input feed.

    The CSV pipeline above keeps format parity with the reference's text
    datasets, but its per-line seeks top out far below the rate a train step
    of a few ms consumes rows (b=2048 → ~0.4M rows/s). Production DLRM input
    pipelines stream a binary layout instead; offline preprocessing
    (:mod:`.preprocess`, reference ``data/large/preprocess_criteo.py``) runs
    once, so the one-time CSV→binary conversion belongs there.

    Layout: a directory of three standard ``.npy`` files —
    ``label.npy (N,) f32``, ``value.npy (N, num) f32``,
    ``index.npy (N, C) i32`` — opened with ``mmap_mode='r'``. An epoch is a
    deterministic two-level shuffle (window order + permutation within
    window), so reads stay within an O(window) locality footprint while every
    epoch is a true permutation of the process's shard; identical across
    restarts for (seed, epoch), like :class:`ShardedCsvPipeline`.
    """

    FILES = ("label", "value", "index")

    def __init__(self, dirpath: str, *, window_rows: int = 1 << 21,
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None):
        self.dirpath = dirpath
        self.window_rows = window_rows
        self.arrays = {name: np.load(os.path.join(dirpath, f"{name}.npy"),
                                     mmap_mode="r") for name in self.FILES}
        n = self.arrays["label"].shape[0]
        assert all(a.shape[0] == n for a in self.arrays.values())
        self.start, self.end = host_shard(n, process_index, process_count)

    @classmethod
    def create(cls, dirpath: str, n_rows: int, n_numeric: int, n_cat: int):
        """Preallocate writable memmaps; fill with ``writer[name][lo:hi] = ...``."""
        os.makedirs(dirpath, exist_ok=True)
        shapes = {"label": (n_rows,), "value": (n_rows, n_numeric),
                  "index": (n_rows, n_cat)}
        dtypes = {"label": np.float32, "value": np.float32, "index": np.int32}
        return {name: np.lib.format.open_memmap(
            os.path.join(dirpath, f"{name}.npy"), mode="w+",
            dtype=dtypes[name], shape=shapes[name]) for name in cls.FILES}

    @property
    def local_rows(self) -> int:
        return self.end - self.start

    def epoch_batches(self, batch_size: int, seed: int, epoch: int,
                      drop_remainder: bool = True
                      ) -> Iterator[Dict[str, np.ndarray]]:
        """Shuffled fixed-size batches over this process's shard for one epoch.

        Two-level deterministic shuffle: window ORDER from (seed, epoch, 0),
        row order WITHIN each window from (seed, epoch, w+1). Each window is
        read once per epoch (one big sequential mmap slice), permuted in RAM,
        then sliced into batches — sequential disk I/O, O(window) memory.
        """
        n, w = self.local_rows, self.window_rows
        n_windows = -(-n // w)
        worder = np.random.default_rng(
            np.random.SeedSequence([seed, epoch, 0])).permutation(n_windows)
        leftover: List[Dict[str, np.ndarray]] = []
        left_rows = 0
        for wi in worder:
            lo = self.start + wi * w
            hi = min(self.start + n, lo + w)
            perm = np.random.default_rng(
                np.random.SeedSequence([seed, epoch, int(wi) + 1])
            ).permutation(hi - lo)
            chunk = {name: np.asarray(arr[lo:hi])[perm]
                     for name, arr in self.arrays.items()}
            if left_rows:
                chunk = {k: np.concatenate([leftover[0][k], v])
                         for k, v in chunk.items()}
            m = chunk["label"].shape[0]
            stop = m - batch_size + 1
            pos = 0
            for pos in range(0, max(stop, 0), batch_size):
                yield {k: v[pos:pos + batch_size] for k, v in chunk.items()}
            pos = pos + batch_size if stop > 0 else 0
            left_rows = m - pos
            leftover = [{k: v[pos:] for k, v in chunk.items()}] if left_rows else []
        if left_rows and not drop_remainder:
            yield leftover[0]
