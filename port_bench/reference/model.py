"""DeepFwFM in plain PyTorch: the fp32 forward, the dynamic-int8 forward and the
training-mode forward with dropout.

Written from the model's equations (DeepLight, Deng et al., WSDM'21, section 3):

    logit = bias + lw . (fwlw-term) + sum_e FwFM_e + tower(emb)
    fwlw-term_f = <e_f, w_f>                              (F values)
    FwFM_e = 1/2 (sum_{k,l} R_kl e_k,e e_l,e - sum_k R_kk e_k,e^2),  R = (R + R^T)/2
    tower  = fc . relu(W3 relu(W2 relu(W1 x + b1) + b2) + b3),  x = the F*E embeddings

Field f's row is ``offset_f + clip(index, 0, size_f - 1)``; a numeric field has
one row, scaled by its value. Weights are a dict of the checkpoint names
(``emb2/dense``, ``deep/net_1/layers/0/w``, ...) with ``(in, out)`` matrices.

``precision`` says how the products are computed:
``fp32`` in float32 with TF32 off; ``tf32`` with both operands of every
product rounded to TF32's 10-bit mantissa first (what TF32 tensor cores do,
on any device). The int8 forward takes ``qmax`` 127, and 7 for int4 codes.

Imports torch alone: nothing of the program under test.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

Weights = Dict[str, torch.Tensor]


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to nearest (ties to even) at 10 mantissa bits."""
    i = x.contiguous().view(torch.int32)
    bias = ((i >> 13) & 1) + 0x0FFF
    return ((i + bias) & ~0x1FFF).view(torch.float32)


class _RoundOperand(torch.autograd.Function):
    """A product's operand at TF32; its gradient passes unchanged."""

    @staticmethod
    def forward(ctx, x):
        return round_tf32(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _RoundCotangent(torch.autograd.Function):
    """A product's output as it is; the cotangent that enters its backward
    products at TF32."""

    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return round_tf32(g)


def _ops(precision: str):
    """The contraction of the given precision: at ``tf32`` both operands of
    every product are rounded, forward and backward."""
    if precision not in ("fp32", "tf32"):
        raise ValueError(f"unknown precision {precision!r}")
    if precision == "fp32":
        return torch.einsum

    def einsum(eq, *xs):
        return _RoundCotangent.apply(torch.einsum(eq, *(_RoundOperand.apply(x) for x in xs)))
    return einsum


def offsets(cfg: Dict, device) -> torch.Tensor:
    sizes = torch.tensor(cfg["feature_sizes"], dtype=torch.long, device=device)
    return torch.cumsum(sizes, 0) - sizes


def rows(cfg: Dict, xi: torch.Tensor) -> torch.Tensor:
    """(B, categorical) indices -> (B, F) table rows, numeric fields first."""
    num = cfg["numerical"]
    sizes = torch.tensor(cfg["feature_sizes"][num:], dtype=torch.long, device=xi.device)
    off = offsets(cfg, xi.device)
    cat = torch.minimum(xi.long().clamp(min=0), sizes - 1) + off[num:]
    return torch.cat([off[:num].expand(xi.shape[0], num), cat], dim=1)


def values(cfg: Dict, xv: torch.Tensor) -> torch.Tensor:
    """(B, numeric) values -> (B, F) row scales, 1 for categorical fields."""
    b = xv.shape[0]
    return torch.cat([xv.float(), xv.new_ones((b, cfg["field_size"] - cfg["numerical"]))], dim=1)


def embed(cfg: Dict, table: torch.Tensor, xi: torch.Tensor, xv: torch.Tensor) -> torch.Tensor:
    return table[rows(cfg, xi)] * values(cfg, xv)[..., None]          # (B, F, E)


def shallow(w: Weights, emb: torch.Tensor, einsum) -> torch.Tensor:
    """bias + lw . fwlw-term + sum_e FwFM_e, (B,)."""
    r = 0.5 * (w["field_cov"] + w["field_cov"].T)
    first = einsum("bfe,fe->bf", emb, w["fwlw_w"])
    lw = einsum("bf,fo->bo", first, w["lw_w"])[:, 0]
    pair = einsum("bke,kl,ble->b", emb, r, emb)
    diag = (torch.diagonal(r)[None, :, None] * emb * emb).sum(dim=(1, 2))
    return w["bias"][0] + lw + 0.5 * (pair - diag)


def _layers(w: Weights, depth: int):
    return [(w[f"deep/net_1/layers/{i}/w"], w[f"deep/net_1/layers/{i}/b"]) for i in range(depth)]


def _dropout(x: torch.Tensor, rate: float, gen: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout; one uniform draw of ``x``'s shape from ``gen``."""
    if gen is None or rate <= 0.0:
        return x
    u = torch.rand(x.shape, generator=gen, device=gen.device).to(x.device)
    return torch.where(u < 1.0 - rate, x / torch.tensor(1.0 - rate, device=x.device),
                       torch.zeros_like(x))


def forward(w: Weights, cfg: Dict, xi: torch.Tensor, xv: torch.Tensor, *,
            precision: str = "fp32", gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """Logits (B,). With ``gen`` the training-mode forward: dropout at
    ``dropout_deep`` on the tower's (B, F, E) input and after each hidden
    layer, drawn from ``gen`` in that order."""
    einsum = _ops(precision)
    emb = embed(cfg, w["emb2/dense"], xi, xv)
    rate = cfg["dropout_deep"]
    x = _dropout(emb, rate, gen).reshape(emb.shape[0], -1)
    for wt, b in _layers(w, cfg["h_depth"]):
        x = _dropout(torch.relu(einsum("bi,io->bo", x, wt) + b), rate, gen)
    deep = einsum("bi,io->bo", x, w["deep/net_1/fc_w"])[:, 0]
    return shallow(w, emb, einsum) + deep


def _scale(amax: torch.Tensor, qmax: int) -> torch.Tensor:
    return amax.clamp(min=1e-12) / torch.tensor(float(qmax), device=amax.device)


def _codes(x: torch.Tensor, s: torch.Tensor, qmax: int) -> torch.Tensor:
    return torch.round(x / s).clamp(-qmax, qmax)


def int_product(q: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Exact integer sums of integer-valued float tensors, in float64."""
    return (q.double() @ wq.double()).float()


def int8_forward(w: Weights, cfg: Dict, xi: torch.Tensor, xv: torch.Tensor, *,
                 tile_rows: int, qmax: int = 127) -> torch.Tensor:
    """Logits (B,) of the dynamic-int8 model made from fp32 weights ``w``:

    * table rows: per-row scale ``amax/qmax``, codes ``round(v/scale)``; a
      lookup returns codes * scale (times the value for a numeric field);
    * the tower: each hidden weight per output channel, the head per tensor;
      each ``tile_rows``-row tile of a layer's input its own scale from its
      abs-max; int32 sums of the codes, then ``relu(sum * s * w_scale + b)``,
      and the head ``sum * s * fc_scale`` without bias;
    * lw, fwlw and FwFM in float32 on the dequantized embeddings."""
    table = w["emb2/dense"]
    t_scale = _scale(table.abs().amax(dim=1, keepdim=True), qmax)
    table_dq = _codes(table, t_scale, qmax) * t_scale
    emb = embed(cfg, table_dq, xi, xv)
    b = emb.shape[0]
    tile = min(tile_rows, b)
    if b % tile:
        raise ValueError(f"batch {b} is not a multiple of the {tile}-row tile")

    def tiles_codes(h):
        t = h.reshape(b // tile, tile, -1)
        s = _scale(t.abs().amax(dim=(1, 2), keepdim=True), qmax)
        return _codes(t, s, qmax).reshape(b, -1), s.repeat_interleave(tile, 0).reshape(b, 1)

    h = emb.reshape(b, -1)
    for wt, bias in _layers(w, cfg["h_depth"]):
        w_scale = _scale(wt.abs().amax(dim=0, keepdim=True), qmax)
        q, s = tiles_codes(h)
        h = torch.relu(int_product(q, _codes(wt, w_scale, qmax)) * s * w_scale + bias)
    fc = w["deep/net_1/fc_w"]
    fc_scale = _scale(fc.abs().amax(), qmax)
    q, s = tiles_codes(h)
    deep = (int_product(q, _codes(fc, fc_scale, qmax)) * s * fc_scale)[:, 0]
    return shallow(w, emb, _ops("fp32")) + deep
