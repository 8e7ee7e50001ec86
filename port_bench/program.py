"""The benchmark's one door into the system under test, ``xsdeepfwfm_deprecated_torch``:
its configuration objects built from a configuration file, and its parameter
tree filled with the benchmark's weights."""

from __future__ import annotations

from typing import Dict

import torch

from xsdeepfwfm_deprecated_torch import _tree
from xsdeepfwfm_deprecated_torch.config import ModelConfig, TrainConfig
from xsdeepfwfm_deprecated_torch.models import deepfwfm

MODEL_KEYS = ("field_size", "numerical", "embedding_size", "deep_nodes", "h_depth", "use_fwfm",
              "use_deep", "use_lw", "use_fwlw", "dropout_deep")
PRUNE_KEYS = ("prune_fm", "prune_deep", "prune_r", "sparse", "emb_r", "emb_corr",
              "prune_interval", "prune_damping", "prune_omega")


def model_config(cfg: Dict) -> ModelConfig:
    return ModelConfig(feature_sizes=tuple(cfg["feature_sizes"]),
                       **{k: cfg[k] for k in MODEL_KEYS})


def train_config(cfg: Dict, traffic: Dict) -> TrainConfig:
    return TrainConfig(optimizer_type=cfg["optimizer"], learning_rate=cfg["learning_rate"],
                       weight_decay=cfg["weight_decay"], batch_size=traffic["batch"],
                       prune=bool(traffic["prune"]), steps_per_call=traffic["steps_per_call"],
                       **{k: cfg[k] for k in PRUNE_KEYS if k in cfg})


def params(mcfg: ModelConfig, flat: Dict[str, torch.Tensor]) -> Dict:
    """The program's parameter tree holding the tensors of ``flat``, which
    must name every leaf and no other."""
    template = deepfwfm.init_params(None, mcfg, device="meta")
    names = {name for name, _ in _tree.named_leaves(template)}
    if names != set(flat):
        raise ValueError(f"weights do not match the program's tree: {sorted(names ^ set(flat))}")
    return _tree.rebuild(template, flat)


def named(tree) -> Dict[str, torch.Tensor]:
    return dict(_tree.named_leaves(tree))
