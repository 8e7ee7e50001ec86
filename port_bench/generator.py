"""The one traffic generator: rows of a CTR dataset's shape, drawn from a seed.

A frozen copy of the zipf sampler of ``tools/synthetic_scale_run`` (the
port's ``make_synthetic`` with ``full_dims``): each categorical field draws its
rank from zipf(``zipf_a``) over its cardinality, and the ranks whose expected
count over the published dataset's rows (the configuration's
``dataset_rows``) is below ``min_count`` map to index 0, as the reference's
preprocessing maps rare features. Numeric fields are standard normal, labels
Bernoulli of the configuration's ``ctr``, the dataset's published click rate.
The skew ``zipf_a`` is an assumption of the traffic file, not a published
figure. The draws are made on the card with a ``torch.Generator``
in a few large calls, so a pool of a million rows costs milliseconds; the
rows are then handed over as host numpy arrays, as callers hold them.

A traffic file, ``traffic/<mix>.json``, gives the parameters; which loop drives
them is its ``loop``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

STREAM_WEIGHTS, STREAM_ROWS, STREAM_DROPOUT, STREAM_SAMPLE = range(4)


def stream_seed(seed: int, stream: int) -> int:
    """A generator seed of its own for each use of the run's ``--seed``."""
    return (int(seed) * 8 + stream) % (1 << 63)


def torch_generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed, stream))


def _zipf_tables(sizes, a: float, rows: int, min_count: int, device):
    """Per field: the CDF over ranks and the first rank whose expected count
    over ``rows`` draws is below ``min_count``."""
    cdfs, cutoffs = [], []
    for s in sizes:
        w = 1.0 / torch.arange(1, s + 1, dtype=torch.float64, device=device) ** a
        p = w / w.sum()
        cdfs.append(torch.cumsum(p, 0))
        cutoffs.append(int(torch.count_nonzero(p * rows > min_count)))
    return cdfs, cutoffs


def sample_rows(cfg: Dict, traffic: Dict, n: int, seed: int, device
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``n`` rows: xi int32 (n, categorical fields), xv float32 (n, numeric
    fields), y float32 (n,)."""
    num = cfg["numerical"]
    sizes = cfg["feature_sizes"][num:]
    gen = torch_generator(seed, STREAM_ROWS, device)
    cdfs, cutoffs = _zipf_tables(sizes, traffic["zipf_a"], cfg["dataset_rows"],
                                 traffic["min_count"], device)
    u = torch.rand((len(sizes), n), generator=gen, dtype=torch.float64, device=device)
    xi = torch.empty((n, len(sizes)), dtype=torch.int32, device=device)
    for f, (cdf, cut) in enumerate(zip(cdfs, cutoffs)):
        k = torch.searchsorted(cdf, u[f]).clamp_(max=cdf.numel() - 1)
        xi[:, f] = torch.where(k < cut, k, torch.zeros_like(k)).to(torch.int32)
    xv = torch.randn((n, num), generator=gen, dtype=torch.float32, device=device)
    y = (torch.rand((n,), generator=gen, device=device) < cfg["ctr"]).to(torch.float32)
    return xi.cpu().numpy(), xv.cpu().numpy(), y.cpu().numpy()


def sample_positions(seed: int, every: int, limit: int) -> np.ndarray:
    """Sorted positions below ``limit``, one in about ``every`` on average,
    with gaps drawn from the seed: which answers of a window are checked."""
    rng = np.random.default_rng(stream_seed(seed, STREAM_SAMPLE))
    gaps = rng.integers(1, 2 * every, size=limit // every * 2 + 2)
    pos = np.cumsum(gaps) - 1
    return pos[pos < limit]
