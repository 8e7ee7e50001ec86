"""A configuration's initial weights, made on the card from the run's seed.

One ``torch.randn`` over all parameters on a card generator, cut into the
leaves and scaled as DeepFwFM initialises them (N(0, 1) times: 0.01 for the
table, Glorot for the tower's weights and biases and for fwlw, sqrt(1/F) for
R, sqrt(2 / head width) for lw and the tower's head). The leaves carry the
checkpoint names that the program's parameter tree and the reference share
(``emb2/dense``, ``deep/net_1/layers/0/w``). The same seed gives the same
weights, so the reference makes them again after the window.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from .generator import STREAM_WEIGHTS, torch_generator


def layout(cfg: Dict) -> List[Tuple[str, Tuple[int, ...], float]]:
    """(name, shape, scale) of every leaf but the bias, in draw order."""
    f, e, h, d = cfg["field_size"], cfg["embedding_size"], cfg["deep_nodes"], cfg["h_depth"]
    head = (2.0 / (f + e + h + 1)) ** 0.5
    out = [("emb2/dense", (sum(cfg["feature_sizes"]), e), 0.01),
           ("lw_w", (f, 1), head),
           ("fwlw_w", (f, e), (2.0 / (f + e)) ** 0.5),
           ("field_cov", (f, f), (1.0 / f) ** 0.5)]
    dims = [f * e] + [h] * d
    for i, (fi, fo) in enumerate(zip(dims[:-1], dims[1:])):
        glorot = (2.0 / (fi + fo)) ** 0.5
        out += [(f"deep/net_1/layers/{i}/w", (fi, fo), glorot),
                (f"deep/net_1/layers/{i}/b", (fo,), glorot)]
    out.append(("deep/net_1/fc_w", (h, 1), head))
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
