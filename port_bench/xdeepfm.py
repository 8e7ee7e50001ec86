"""The benchmark's door into the program for xDeepFM (``use_cin``), and the
model's initial weights, made on the card from the run's seed.

The door builds the program's configuration objects from a configuration file
of ``"model": "xDeepFM"``; the parameter tree is ``program.params``'s, which
takes its template from the program's own ``init_params``. A program without
the CIN refuses the configuration at once (``ModelConfig`` has no
``use_cin``), before any weight is made.

The weights: one ``torch.randn`` over all parameters on a card generator, cut
into the leaves and scaled: Glorot for the CIN's matrices (fan-in H_{k-1}·m),
its head, and the DNN's weights and biases; sqrt(2 / (width + 1)) for the
DNN's head; N(0, 0.5²) for the second-order table and N(0, 0.1²) for the
first-order one. The tables are drawn wider than the program's 0.01: the
CIN's layer k is a polynomial of degree k + 1 in the embeddings, so at 0.01
its third layer would start near 1e-8 and its gradient below L2's, where the
comparison with the reference could not see it; at 0.5 each layer's maps are
of order 0.1 to 1 and the logit of order 1.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from xsdeepfwfm_deprecated_torch.config import ModelConfig, TrainConfig

from .generator import STREAM_WEIGHTS, torch_generator

MODEL_KEYS = ("field_size", "numerical", "embedding_size", "deep_nodes", "h_depth", "use_deep",
              "dropout_deep")
TABLE_SCALE, LINEAR_SCALE = 0.5, 0.1


def model_config(cfg: Dict) -> ModelConfig:
    return ModelConfig(feature_sizes=tuple(cfg["feature_sizes"]), use_fwfm=False, use_cin=True,
                       cin_layers=tuple(cfg["cin_layers"]), **{k: cfg[k] for k in MODEL_KEYS})


def train_config(cfg: Dict, traffic: Dict) -> TrainConfig:
    return TrainConfig(optimizer_type=cfg["optimizer"], learning_rate=cfg["learning_rate"],
                       weight_decay=cfg["weight_decay"], batch_size=traffic["batch"],
                       steps_per_call=traffic["steps_per_call"])


def layout(cfg: Dict) -> List[Tuple[str, Tuple[int, ...], float]]:
    """(name, shape, scale) of every leaf but the bias, in draw order."""
    m, e, h, d = cfg["field_size"], cfg["embedding_size"], cfg["deep_nodes"], cfg["h_depth"]
    rows = sum(cfg["feature_sizes"])
    out = [("emb1/dense", (rows, 1), LINEAR_SCALE), ("emb2/dense", (rows, e), TABLE_SCALE)]
    maps = [m] + list(cfg["cin_layers"])
    for k, (hp, hk) in enumerate(zip(maps[:-1], maps[1:])):
        out.append((f"cin/layers/{k}/w", (hk, hp * m), (2.0 / (hp * m + hk)) ** 0.5))
    total = sum(cfg["cin_layers"])
    out.append(("cin/fc_w", (total, 1), (2.0 / (total + 1)) ** 0.5))
    dims = [m * e] + [h] * d
    for i, (fi, fo) in enumerate(zip(dims[:-1], dims[1:])):
        glorot = (2.0 / (fi + fo)) ** 0.5
        out += [(f"deep/net_1/layers/{i}/w", (fi, fo), glorot),
                (f"deep/net_1/layers/{i}/b", (fo,), glorot)]
    out.append(("deep/net_1/fc_w", (h, 1), (2.0 / (h + 1)) ** 0.5))
    return out


@torch.no_grad()
def make(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """name -> float32 tensor on ``device``."""
    leaves = layout(cfg)
    sizes = [torch.Size(shape).numel() for _, shape, _ in leaves]
    flat = torch.randn((sum(sizes),), generator=torch_generator(seed, STREAM_WEIGHTS, device),
                       dtype=torch.float32, device=device)
    out = {"bias": torch.full((1,), 0.01, dtype=torch.float32, device=device)}
    for (name, shape, scale), part in zip(leaves, torch.split(flat, sizes)):
        out[name] = part.view(shape) * scale     # a tensor of its own, as a leaf is
    return out
