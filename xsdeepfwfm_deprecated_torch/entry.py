"""The flagship model: DeepFwFM with lw+fwlw on Criteo-shaped fields, and
the multi-rank dry run.

The port's own copy of ``__graft_entry__._flagship`` and its cardinality list
(39 fields, 13 numeric, E=10, a 400x400x400 tower with a 1-unit head), and of
``__graft_entry__.dryrun_multichip`` (``:63-122``).
"""

from __future__ import annotations

import logging
import tempfile
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .config import ModelConfig, TrainConfig

# Full-Criteo categorical cardinalities: 1,326,042 categorical rows, plus the
# 13 single-row numeric slots = 1,326,055 packed rows.
FULL_CRITEO_CAT_SIZES = (
    1458, 556, 245197, 166166, 306, 20, 12055, 634, 4, 46330, 5229, 243454,
    3177, 27, 11745, 225322, 11, 4727, 2058, 5, 238640, 18, 16, 67856, 89,
    50942)

# tiny-criteo-like cardinalities, for small runs
TINY_CAT_SIZES = (
    83, 202, 78, 23, 201, 87, 51, 46, 71, 5, 24, 18, 37, 665, 511, 24186,
    27018, 172, 8, 8613, 330, 2, 14357, 4086, 24692, 2903)


def flagship_config(full_criteo: bool = True, *, feature_scale: int = 1, deep_nodes: int = 400,
                    embedding_size: int = 10) -> ModelConfig:
    """The flagship DeepFwFM config; ``full_criteo=False`` uses the
    tiny-criteo cardinalities, ``feature_scale`` divides them (at least 2
    rows a field), as ``__graft_entry__._flagship`` does for dry runs."""
    cat_sizes = FULL_CRITEO_CAT_SIZES if full_criteo else TINY_CAT_SIZES
    if feature_scale != 1:
        cat_sizes = tuple(max(2, s // feature_scale) for s in cat_sizes)
    return ModelConfig(field_size=39, feature_sizes=(1,) * 13 + cat_sizes, numerical=13,
                       embedding_size=embedding_size, deep_nodes=deep_nodes, h_depth=3,
                       use_fwfm=True, use_deep=True, use_lw=True, use_fwlw=True)


def flagship_train_config(**overrides) -> TrainConfig:
    """The reference's training defaults for the flagship: Adam, lr 1e-3,
    L2 3e-7, batches of 2,048, a prune refresh every 10 steps. Keyword
    arguments replace fields."""
    base = dict(optimizer_type="adam", learning_rate=1e-3, weight_decay=3e-7,
                batch_size=2048, prune_interval=10)
    base.update(overrides)
    return TrainConfig(**base)


EXCHANGES = ("a2a_grid", "a2a", "psum")


def dryrun_multichip(n_ranks: int, *, backend: Optional[str] = None,
                     device_of_rank: Optional[Callable[[int], str]] = None
                     ) -> Dict[str, np.ndarray]:
    """The multi-rank training path through ``DeepFMEstimator.fit``, as the
    ``-mesh_data/-mesh_model/-exchange`` flags drive it: ``n_ranks`` processes
    on an ``(n//2, 2)`` mesh (``(n, 1)`` for odd ``n``), the flagship's shapes
    cut down (cardinalities / 64, a 64-wide tower, E=8), one epoch of two
    global batches of ``16 n`` rows through each exchange, then the logits of
    the three held equal (rtol 2e-4, atol 2e-5). Returns each exchange's
    logits.

    The ranks go to the cards: one each over nccl where there is a card a
    rank, else card ``r % cards`` over gloo. ``device_of_rank`` places them
    elsewhere (``lambda r: "cpu"`` with ``backend="gloo"`` on the CPU)."""
    from .device import resolve_device
    from .parallel.launch import run_ranks
    model = 2 if n_ranks >= 2 and n_ranks % 2 == 0 else 1
    if device_of_rank is None:
        resolve_device(None)            # the card, or raise
        cards = torch.cuda.device_count()
        backend = backend or ("nccl" if cards >= n_ranks else "gloo")
        device_of_rank = lambda r: f"cuda:{r % cards}"   # noqa: E731
    with tempfile.TemporaryDirectory() as tmp:
        results = run_ranks(_dryrun_rank, n_ranks, backend=backend or "gloo",
                            devices=[device_of_rank(r) for r in range(n_ranks)], workdir=tmp,
                            args=(n_ranks // model, model))
    for exchange, loss in results[0]["loss"].items():
        print(f"dryrun_multichip({n_ranks}) {exchange}: mesh=({n_ranks // model} data, "
              f"{model} model) loss={loss:.4f} OK")
    logits = results[0]["logits"]
    if model > 1:
        np.testing.assert_allclose(logits["a2a"], logits["psum"], rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(logits["a2a_grid"], logits["a2a"], rtol=2e-4, atol=2e-5)
        print("a2a_grid = a2a = psum exchange: logits match")
    return logits


def _dryrun_rank(rank: int, device: torch.device, data: int, model: int) -> Dict:
    from .train.trainer import DeepFMEstimator
    cfg = flagship_config(full_criteo=False, feature_scale=64, deep_nodes=64, embedding_size=8)
    b = 16 * data * model
    rng = np.random.default_rng(0)
    n_rows = 2 * b
    xi = rng.integers(0, cfg.feature_sizes[13:], size=(n_rows, 26)).astype(np.int32)
    xv = rng.normal(size=(n_rows, 13)).astype(np.float32)
    y = (rng.random(n_rows) < 0.3).astype(np.float32)
    quiet = logging.getLogger(f"{__name__}.dryrun")
    quiet.addHandler(logging.NullHandler())
    quiet.propagate = False
    out: Dict[str, Dict] = {"loss": {}, "logits": {}}
    for exchange in EXCHANGES:
        tcfg = TrainConfig(n_epochs=1, batch_size=b, eval_batch_size=b, random_seed=0,
                           mesh_data=data, mesh_model=model, exchange=exchange)
        est = DeepFMEstimator(cfg, tcfg, logger=quiet, device=device).fit(xi, xv, y)
        loss = est.eval_by_batch(xi, xv, y)[0]
        if not np.isfinite(loss):
            raise FloatingPointError(f"{exchange}: non-finite loss {loss}")
        out["loss"][exchange] = loss
        out["logits"][exchange] = est._predict_logits(xi, xv)
    return out
