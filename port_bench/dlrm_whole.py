"""The benchmark's door for DLRM-DCNv2 whole over a host of cards
(``configs/dlrm_dcnv2_criteo1tb_whole.json``): the weights, drawn so that a
rank draws the rows it holds and the reference the rows a few batches touch,
without anyone making the 104.5 GB table whole; the hashed multi-hot traffic
of each rank; and where the configuration's ``deployment`` puts a row.

The table's rows (the whole packed table's numbering, ``reference/
dlrm_dcnv2.packed_rows``) are drawn N(0, 0.1²) in chunks of ``CHUNK`` rows,
chunk k from a card generator of its own seeded from the run's seed and k. The
other leaves are drawn in ``dlrm.layout``'s order (the table left out) from the
weights' generator of ``generator.py``, at the scales ``dlrm.py`` gives them.

The traffic of rank r comes from a generator of its own, seeded from the run's
seed and r, so a global batch is the ranks' batches side by side. A bag's
first id is a zipf(``zipf_a``) rank over its field's rows, cut at
``min_count`` over the configuration's ``dataset_rows`` as ``generator.py``
cuts it, then mapped to a row by a fixed bijection of the field's rows
(``i -> (a·i + c) mod rows``, ``a`` near 0.618·rows and prime to it), as the
hashing of Criteo 1TB's ids spreads its hot values: without it every hot row
would lie in the first card's block. Its other ids are uniform over the
field's rows; 13 standard-normal numeric values; labels at ``ctr``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from . import dlrm, generator
from .generator import STREAM_ROWS, STREAM_WEIGHTS, stream_seed, torch_generator

CHUNK = 1 << 20                     # table rows a generator draws
_MIX = 0x9E3779B97F4A7C15           # spreads the seeds of a run's chunks and ranks


def _generator(seed: int, stream: int, k: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        (stream_seed(seed, stream) + (k + 1) * _MIX) % (1 << 63))


@torch.no_grad()
def _chunk(cfg: Dict, seed: int, k: int, device) -> torch.Tensor:
    n = min(CHUNK, dlrm.table_rows(cfg) - k * CHUNK)
    t = torch.empty((n, cfg["embedding_size"]), dtype=torch.float32, device=device)
    gen = _generator(seed, STREAM_WEIGHTS, k, device)
    return t.normal_(generator=gen).mul_(dlrm.TABLE_SCALE)


class TableRows:
    """``rows(lo, hi)``: the table's rows [lo, hi) on ``device``, the last
    chunk drawn kept for the next call (a rank asks for its ranges in order)."""

    def __init__(self, cfg: Dict, seed: int, device):
        self.cfg, self.seed, self.device = cfg, seed, device
        self._last: Tuple[int, torch.Tensor] = (-1, None)

    def chunk(self, k: int) -> torch.Tensor:
        if self._last[0] != k:
            self._last = (k, _chunk(self.cfg, self.seed, k, self.device))
        return self._last[1]

    def __call__(self, lo: int, hi: int) -> torch.Tensor:
        parts = [self.chunk(k)[max(lo - k * CHUNK, 0):min(hi - k * CHUNK, CHUNK)]
                 for k in range(lo // CHUNK, (hi - 1) // CHUNK + 1)]
        return torch.cat(parts) if len(parts) > 1 else parts[0]

    def at(self, rows: torch.Tensor) -> torch.Tensor:
        """The table's rows at ``rows`` (sorted, distinct, int64), in that order."""
        out = torch.empty((rows.numel(), self.cfg["embedding_size"]), dtype=torch.float32,
                          device=self.device)
        edges = torch.arange(0, dlrm.table_rows(self.cfg) + CHUNK, CHUNK, device=rows.device)
        bounds = torch.searchsorted(rows, edges).tolist()
        for k, (a, b) in enumerate(zip(bounds[:-1], bounds[1:])):
            if b > a:
                out[a:b] = self.chunk(k).index_select(0, (rows[a:b] - k * CHUNK).to(self.device))
        return out


@torch.no_grad()
def dense(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every leaf but the table, name -> float32 tensor on ``device``."""
    gen = torch_generator(seed, STREAM_WEIGHTS, device)
    out = {}
    for name, shape, scale in dlrm.layout(cfg):
        if name == "bags/dense":
            continue
        t = torch.empty(shape, dtype=torch.float32, device=device)
        out[name] = t.normal_(generator=gen).mul_(scale) if scale else t.zero_()
    return out


def _bijection(rows: int) -> Tuple[int, int]:
    """(a, c) of the field's map ``i -> (a·i + c) mod rows``."""
    a = max(int(0.6180339887 * rows), 1)
    while math.gcd(a, rows) != 1:
        a += 1
    return a, (5 * rows) // 7


def sample_rows(cfg: Dict, traffic: Dict, n: int, seed: int, rank: int, device
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``n`` rows of rank ``rank``: xi int32 (n, Σ bag sizes), each field's
    bag in turn; xv float32 (n, numeric fields); y float32 (n,)."""
    num = cfg["numerical"]
    sizes = cfg["feature_sizes"][num:]
    gen = _generator(seed, STREAM_ROWS, rank, device)
    cdfs, cutoffs = generator._zipf_tables(sizes, traffic["zipf_a"], cfg["dataset_rows"],
                                           traffic["min_count"], device)
    xi = torch.empty((n, sum(cfg["bag_sizes"])), dtype=torch.int32, device=device)
    at = 0
    for size, k, cdf, cut in zip(sizes, cfg["bag_sizes"], cdfs, cutoffs):
        u = torch.rand((n,), generator=gen, dtype=torch.float64, device=device)
        first = torch.searchsorted(cdf, u).clamp_(max=cdf.numel() - 1)
        first = torch.where(first < cut, first, torch.zeros_like(first))
        a, c = _bijection(size)
        xi[:, at] = ((first * a + c) % size).to(torch.int32)
        if k > 1:
            xi[:, at + 1:at + k] = torch.randint(0, size, (n, k - 1), generator=gen,
                                                 dtype=torch.int32, device=device)
        at += k
    del cdfs
    xv = torch.randn((n, num), generator=gen, dtype=torch.float32, device=device)
    y = (torch.rand((n,), generator=gen, device=device) < cfg["ctr"]).to(torch.float32)
    return xi.cpu().numpy(), xv.cpu().numpy(), y.cpu().numpy()


def field_of(cfg: Dict, rows: torch.Tensor) -> torch.Tensor:
    """The field of each row of the whole packed table."""
    sizes = torch.tensor(cfg["feature_sizes"][cfg["numerical"]:], dtype=torch.long,
                         device=rows.device)
    return torch.searchsorted(torch.cumsum(sizes, 0), rows, right=True)


def holder(cfg: Dict, rows: torch.Tensor, ranks: int) -> torch.Tensor:
    """Where the deployment puts each row of the whole packed table: the rank
    whose contiguous block of its table (``ceil(rows / ranks)`` rows) holds it,
    -1 for a table of at most ``bag_row_wise_rows`` rows, held whole on every
    rank."""
    sizes = torch.tensor(cfg["feature_sizes"][cfg["numerical"]:], dtype=torch.long,
                         device=rows.device)
    f = field_of(cfg, rows)
    start = torch.cumsum(sizes, 0) - sizes
    block = -(-sizes // ranks)
    owner = (rows - start[f]) // block[f]
    return torch.where(sizes[f] > cfg["bag_row_wise_rows"], owner, torch.full_like(owner, -1))


def distinct_held(cfg: Dict, rows: torch.Tensor, rank: int, ranks: int) -> int:
    """The distinct rows of ``rows`` that rank ``rank`` holds."""
    u = torch.unique(rows)
    h = holder(cfg, u, ranks)
    return int(((h == -1) | (h == rank)).sum())


def counted_here(cfg: Dict, rows: torch.Tensor, rank: int, ranks: int) -> torch.Tensor:
    """Which of ``rows`` rank ``rank`` counts, so that the ranks count every
    row once: its blocks' rows, and the whole tables' on rank 0."""
    h = holder(cfg, rows, ranks)
    return (h == rank) | ((h == -1) & (rank == 0))


def whole_table_rows(cfg: Dict) -> List[Tuple[int, int]]:
    """The [lo, hi) ranges of the whole packed table that every rank holds."""
    out, at = [], 0
    for n in cfg["feature_sizes"][cfg["numerical"]:]:
        if n <= cfg["bag_row_wise_rows"]:
            out.append((at, at + n))
        at += n
    return out
