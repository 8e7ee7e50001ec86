"""Hashed-feature MLP baseline (counterpart of the reference ``baseline.py``).

Port of ``xsdeepfwfm_deprecated_tpu/models/hash_mlp_baseline.py:26-122``. The
reference ships a Keras MLP baseline for the Twitter dataset: categorical
values are feature-hashed (mmh3) into a fixed-width space, concatenated with
the dense features, and fed to a small MLP with PRAUC/RCE metrics
(``baseline.py:86-145``). Not part of the core DeepLight path — bundled for
experiment parity.

Multiplicative hashing of (field, value) pairs into ``hash_dim`` buckets,
bucket-count featurization, dense concat, and a train loop on the port's
``Optimizer`` with adam.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import _tree
from ..config import TrainConfig
from ..device import DeviceLike, resolve_device, scaled_normal
from ..train import metrics as M
from ..train.trainer import Optimizer
from ..utils.logging import get_logger


def hash_features(index: np.ndarray, hash_dim: int = 2048, seed: int = 0x9E3779B1
                  ) -> np.ndarray:
    """(N, C) int categorical indices → (N, hash_dim) float bucket counts.

    Fibonacci-style multiplicative hash of (field, value) in uint64
    arithmetic that wraps around; the mmh3 stand-in (mmh3 is not a framework
    dependency).
    """
    n, c = index.shape
    fields = np.arange(c, dtype=np.uint64)[None, :]
    vals = index.astype(np.uint64)
    mixed = (vals * np.uint64(0x9E3779B97F4A7C15) ^ (fields + np.uint64(seed))
             * np.uint64(0xBF58476D1CE4E5B9))
    mixed ^= mixed >> np.uint64(31)
    buckets = (mixed % np.uint64(hash_dim)).astype(np.int64)
    out = np.zeros((n, hash_dim), np.float32)
    np.add.at(out, (np.arange(n)[:, None], buckets), 1.0)
    return out


def init_params(generator: torch.Generator, in_dim: int, hidden=(256, 128),
                device: DeviceLike = None) -> Dict:
    device = resolve_device(device)
    dims = [in_dim] + list(hidden) + [1]
    layers = []
    for fi, fo in zip(dims[:-1], dims[1:]):
        glorot = (2.0 / (fi + fo)) ** 0.5
        layers.append({"w": scaled_normal(generator, (fi, fo), glorot, torch.float32, device),
                       "b": scaled_normal(generator, (fo,), glorot, torch.float32, device)})
    return {"layers": layers}


def forward(params: Dict, x: torch.Tensor) -> torch.Tensor:
    h = x
    for layer in params["layers"][:-1]:
        h = torch.relu(h @ layer["w"] + layer["b"])
    out = h @ params["layers"][-1]["w"] + params["layers"][-1]["b"]
    return out[:, 0]


class HashMLPBaseline:
    """Minimal estimator: fit/predict/eval with PRAUC+RCE (reference
    ``baseline.py:86-102`` metric pair). ``device=None`` means the CUDA
    device, and raises when there is none."""

    def __init__(self, hash_dim: int = 2048, hidden=(256, 128),
                 train_cfg: Optional[TrainConfig] = None, logger=None,
                 device: DeviceLike = None):
        self.hash_dim = hash_dim
        self.hidden = hidden
        self.tcfg = train_cfg or TrainConfig(n_epochs=3, batch_size=1024,
                                             learning_rate=1e-3)
        self.device = resolve_device(device)
        self.params: Optional[Dict] = None
        self.logger = logger or get_logger()

    def _featurize(self, index, value) -> np.ndarray:
        hashed = hash_features(np.asarray(index, np.int64), self.hash_dim)
        return np.concatenate([np.asarray(value, np.float32), hashed], axis=1)

    def fit(self, index, value, y):
        x = self._featurize(index, value)
        y = np.asarray(y, np.float32).ravel()
        gen = torch.Generator().manual_seed(self.tcfg.random_seed)
        self.params = init_params(gen, x.shape[1], self.hidden, device=self.device)
        # plain adam at the config's learning rate, without L2, whatever else it says
        opt = Optimizer(dataclasses.replace(self.tcfg, optimizer_type="adam",
                                            weight_decay=0.0))
        opt_state = opt.init(self.params)

        def step(xb: torch.Tensor, yb: torch.Tensor) -> torch.Tensor:
            leaves = [p.detach().requires_grad_(True) for p in _tree.leaves(self.params)]
            it = iter(leaves)
            live = _tree.tree_map(lambda _: next(it), self.params)
            loss = F.binary_cross_entropy_with_logits(forward(live, xb), yb)
            opt.update(self.params, list(torch.autograd.grad(loss, leaves)), opt_state)
            return loss.detach()

        bs = self.tcfg.batch_size
        rng = np.random.default_rng(self.tcfg.random_seed)
        for epoch in range(self.tcfg.n_epochs):
            perm = rng.permutation(len(y))
            losses = [step(torch.from_numpy(x[perm[lo:lo + bs]]).to(self.device),
                           torch.from_numpy(y[perm[lo:lo + bs]]).to(self.device))
                      for lo in range(0, len(y) - bs + 1, bs)]
            total = float(torch.stack(losses).sum()) if losses else 0.0
            self.logger.info(f"baseline epoch {epoch + 1} loss {total:.4f}")
        return self

    @torch.inference_mode()
    def predict_proba(self, index, value) -> np.ndarray:
        x = torch.from_numpy(self._featurize(index, value)).to(self.device)
        logits = forward(self.params, x).cpu().numpy()
        return 1.0 / (1.0 + np.exp(-logits.astype(np.float64)))

    def evaluate(self, index, value, y) -> Tuple[float, float, float]:
        p = self.predict_proba(index, value)
        y = np.asarray(y, np.float64).ravel()
        return M.roc_auc(y, p), M.prauc(p, y), M.rce(p, y)
