"""The benchmark's door into the program for DLRM-DCNv2 (``use_dlrm``), its
initial weights and its multi-hot traffic, made on the card from the run's
seed.

The door builds the program's configuration objects from a configuration file
of ``"model": "DLRM-DCNv2"``; the parameter tree is the program's own
``models.dlrm.init_params`` template, filled with these weights. A program
without the model refuses the configuration at once (``ModelConfig`` has no
``use_dlrm``; the module ``models.dlrm`` is not there), before any weight is
made.

The weights are drawn leaf by leaf in place from one card generator, so the
13.57 GB table is made where it stays, without a second copy: Glorot
(``N(0, 2 / (fan_in + fan_out))``) for the arches' weights and biases and for
the cross layers' V and W, zero cross biases, and N(0, 0.1²) for the table. At
the program's 0.01 a bag of one id would be a hundredth of the dense arch's
row in x₀ and the table's gradient far below the rest; at 0.1 a bag is 0.1
(one id) to 1.0 (a hundred ids) and every part of x₀ moves the logit, so the
comparison sees the bags.

The traffic: a bag's first id is drawn from the frozen zipf sampler of
``generator.py`` over its field's rows on this card (cut at ``min_count``
over ``dataset_rows``); its other ids uniformly over the same rows; 13
standard-normal numeric values; labels at the configuration's ``ctr``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from xsdeepfwfm_deprecated_torch import _tree
from xsdeepfwfm_deprecated_torch.config import ModelConfig, TrainConfig

from . import generator
from .generator import STREAM_ROWS, STREAM_WEIGHTS, torch_generator

MODEL_KEYS = ("field_size", "numerical", "embedding_size", "dcn_num_layers", "dcn_low_rank_dim")
TABLE_SCALE = 0.1


def model_config(cfg: Dict) -> ModelConfig:
    return ModelConfig(feature_sizes=tuple(cfg["feature_sizes"]), use_fwfm=False,
                       use_deep=False, use_dlrm=True, bag_sizes=tuple(cfg["bag_sizes"]),
                       dense_arch_layers=tuple(cfg["dense_arch_layers"]),
                       over_arch_layers=tuple(cfg["over_arch_layers"]),
                       **{k: cfg[k] for k in MODEL_KEYS})


def train_config(cfg: Dict, traffic: Dict) -> TrainConfig:
    return TrainConfig(optimizer_type=cfg["optimizer"], learning_rate=cfg["learning_rate"],
                       weight_decay=cfg["weight_decay"], batch_size=traffic["batch"],
                       steps_per_call=traffic["steps_per_call"])


def table_rows(cfg: Dict) -> int:
    return sum(cfg["feature_sizes"][cfg["numerical"]:])


def cross_width(cfg: Dict) -> int:
    return (cfg["field_size"] - cfg["numerical"] + 1) * cfg["embedding_size"]


def layout(cfg: Dict) -> List[Tuple[str, Tuple[int, ...], float]]:
    """(name, shape, scale) of every leaf, in draw order; scale 0 is zeros."""
    e, d, r = cfg["embedding_size"], cross_width(cfg), cfg["dcn_low_rank_dim"]
    out = [("bags/dense", (table_rows(cfg), e), TABLE_SCALE)]

    def arch(group, dims):
        for i, (fi, fo) in enumerate(zip(dims[:-1], dims[1:])):
            glorot = (2.0 / (fi + fo)) ** 0.5
            out.extend([(f"{group}/layers/{i}/w", (fi, fo), glorot),
                        (f"{group}/layers/{i}/b", (fo,), glorot)])
    arch("dense_arch", [cfg["numerical"]] + list(cfg["dense_arch_layers"]))
    glorot = (2.0 / (d + r)) ** 0.5
    for k in range(cfg["dcn_num_layers"]):
        out.extend([(f"cross/layers/{k}/v", (r, d), glorot), (f"cross/layers/{k}/w", (d, r), glorot),
                    (f"cross/layers/{k}/b", (d,), 0.0)])
    arch("over_arch", [d] + list(cfg["over_arch_layers"]))
    return out


@torch.no_grad()
def make(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """name -> float32 tensor on ``device``, each drawn in place."""
    gen = torch_generator(seed, STREAM_WEIGHTS, device)
    out = {}
    for name, shape, scale in layout(cfg):
        t = torch.empty(shape, dtype=torch.float32, device=device)
        out[name] = t.normal_(generator=gen).mul_(scale) if scale else t.zero_()
    return out


def params(mcfg: ModelConfig, flat: Dict[str, torch.Tensor]) -> Dict:
    """The program's parameter tree holding the tensors of ``flat``, which
    must name every leaf and no other."""
    from xsdeepfwfm_deprecated_torch.models import dlrm
    template = dlrm.init_params(None, mcfg, device="meta")
    names = {name for name, _ in _tree.named_leaves(template)}
    if names != set(flat):
        raise ValueError(f"weights do not match the program's tree: {sorted(names ^ set(flat))}")
    return _tree.rebuild(template, flat)


def sample_rows(cfg: Dict, traffic: Dict, n: int, seed: int, device
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``n`` rows: xi int32 (n, Σ bag sizes), each field's bag in turn; xv
    float32 (n, numeric fields); y float32 (n,)."""
    num = cfg["numerical"]
    sizes = cfg["feature_sizes"][num:]
    gen = torch_generator(seed, STREAM_ROWS, device)
    cdfs, cutoffs = generator._zipf_tables(sizes, traffic["zipf_a"], cfg["dataset_rows"],
                                           traffic["min_count"], device)
    xi = torch.empty((n, sum(cfg["bag_sizes"])), dtype=torch.int32, device=device)
    at = 0
    for size, k, cdf, cut in zip(sizes, cfg["bag_sizes"], cdfs, cutoffs):
        u = torch.rand((n,), generator=gen, dtype=torch.float64, device=device)
        first = torch.searchsorted(cdf, u).clamp_(max=cdf.numel() - 1)
        xi[:, at] = torch.where(first < cut, first, torch.zeros_like(first)).to(torch.int32)
        if k > 1:
            xi[:, at + 1:at + k] = torch.randint(0, size, (n, k - 1), generator=gen,
                                                 dtype=torch.int32, device=device)
        at += k
    xv = torch.randn((n, num), generator=gen, dtype=torch.float32, device=device)
    y = (torch.rand((n,), generator=gen, device=device) < cfg["ctr"]).to(torch.float32)
    return xi.cpu().numpy(), xv.cpu().numpy(), y.cpu().numpy()
