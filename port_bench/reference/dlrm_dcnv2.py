"""DLRM-DCNv2 in plain PyTorch: the forward, the binary cross-entropy, its
gradients by autograd and dense Adagrad on every leaf, which the program's
run is held to.

Written from the MLCommons training reference ``recommendation_v2/
torchrec_dlrm`` (Naumov et al., "Deep Learning Recommendation Model", 2019;
the interaction is Wang et al., "DCN V2", WWW 2021, sec. 3, Eq. 2 with
W = U·Vᵀ), one example at a time:

    d   = relu(... relu(x_dense W_1 + b_1) ... W_n + b_n)         the dense arch, (E,)
    e_f = Σ_{j < k_f} T[offset_f + clip(id_{f,j}, 0, rows_f - 1)]  field f's bag, (E,)
    x_0 = [d, e_1, ..., e_C]                                       (D,), D = (1 + C)·E
    x_{l+1} = x_0 ⊙ (W_l (V_l x_l) + b_l) + x_l                    l < L, V_l (r, D), W_l (D, r)
    logit = over arch of x_L: ReLU layers, then a linear unit with a bias

and the loss is the mean binary cross-entropy of the logits. Adagrad, on
every leaf alike: ``acc += g²``, ``w -= lr · g / sqrt(acc + 1e-10)`` where
acc > 0, else no change; no weight decay. Weights are a dict of the
checkpoint names (``bags/dense``, ``dense_arch/layers/{i}/w`` as (in, out),
``cross/layers/{k}/v``, ``/w``, ``/b``, ``over_arch/layers/{i}/w``).

Departures from the published model: Adagrad's eps sits inside the root
(FBGEMM's and ``torch.optim.Adagrad``'s sits after it), the program's form;
float32 throughout, where MLPerf's submissions may train in lower precision.

``precision`` ``fp32`` computes in float32 with TF32 off; ``tf32`` rounds
both operands of every product to TF32 first, forward and backward (the
control). At the benchmark's size the full table does not fit beside the
program: :func:`compact` gathers the rows a few batches touch and renumbers
their ids, which gives the same steps, since no other row's gradient is
anything but 0 and Adagrad leaves such a row as it is. Imports torch alone:
nothing of the program under test.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

Weights = Dict[str, torch.Tensor]
EPS = 1e-10
TABLE = "bags/dense"


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
    """A product's output as it is; the cotangent entering its backward
    products at TF32."""

    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return round_tf32(g)


def _matmul(precision: str):
    if precision not in ("fp32", "tf32"):
        raise ValueError(f"unknown precision {precision!r}")
    if precision == "fp32":
        return torch.matmul

    def mm(a, b):
        return _RoundCotangent.apply(torch.matmul(_RoundOperand.apply(a), _RoundOperand.apply(b)))
    return mm


def categorical_sizes(cfg: Dict) -> List[int]:
    return list(cfg["feature_sizes"][cfg["numerical"]:])


def packed_rows(cfg: Dict, xi: torch.Tensor) -> torch.Tensor:
    """(B, Σk) ids → rows of the packed table, int64: field f's k_f columns
    in turn, each id clipped into its field's rows."""
    sizes = torch.tensor(categorical_sizes(cfg), dtype=torch.long, device=xi.device)
    offsets = torch.cumsum(sizes, 0) - sizes
    field = torch.repeat_interleave(torch.arange(len(sizes), device=xi.device),
                                    torch.tensor(cfg["bag_sizes"], device=xi.device))
    ids = torch.minimum(xi.long().clamp(min=0), sizes[field] - 1)
    return ids + offsets[field]


def forward(w: Weights, cfg: Dict, rows: torch.Tensor, xv: torch.Tensor,
            precision: str = "fp32") -> torch.Tensor:
    """Logits (B,) from the packed rows (B, Σk) of ``w``'s table."""
    mm = _matmul(precision)
    x = xv.float()
    for i in range(len(cfg["dense_arch_layers"])):
        x = torch.relu(mm(x, w[f"dense_arch/layers/{i}/w"]) + w[f"dense_arch/layers/{i}/b"])
    emb = w[TABLE][rows]                                         # (B, Σk, E)
    bags, at = [], 0
    for k in cfg["bag_sizes"]:
        bags.append(emb[:, at:at + k].sum(dim=1))
        at += k
    x0 = torch.cat([x] + bags, dim=1)                            # (B, (1 + C)·E)
    x = x0
    for k in range(cfg["dcn_num_layers"]):
        v, wk, b = (w[f"cross/layers/{k}/{n}"] for n in ("v", "w", "b"))
        x = x0 * (mm(mm(x, v.T), wk.T) + b) + x
    layers = len(cfg["over_arch_layers"])
    for i in range(layers):
        x = mm(x, w[f"over_arch/layers/{i}/w"]) + w[f"over_arch/layers/{i}/b"]
        if i < layers - 1:
            x = torch.relu(x)
    return x[:, 0]


def bce(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean of max(x, 0) - x y + log(1 + exp(-|x|))."""
    return (logits.clamp(min=0) - logits * y + torch.log1p(torch.exp(-logits.abs()))).mean()


def grads(w: Weights, cfg: Dict, batch: Dict[str, torch.Tensor],
          precision: str) -> Tuple[float, Dict[str, torch.Tensor]]:
    """(loss, the gradient of every leaf) of one batch, by autograd."""
    live = {k: v.detach().clone().requires_grad_(True) for k, v in w.items()}
    loss = bce(forward(live, cfg, batch["rows"], batch["xv"], precision), batch["y"])
    g = torch.autograd.grad(loss, list(live.values()))
    return float(loss.detach()), dict(zip(live, g))


@torch.no_grad()
def adagrad_(w: Weights, g: Dict[str, torch.Tensor], acc: Dict[str, torch.Tensor],
             lr: float) -> None:
    """One dense Adagrad step of every leaf, in place."""
    for k, p in w.items():
        a = acc.setdefault(k, torch.zeros_like(p))
        a.add_(g[k] * g[k])
        p.sub_(lr * torch.where(a > 0, g[k] / torch.sqrt(a + EPS), torch.zeros_like(a)))


def norms(ts: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in ts.items()}


def steps(w0: Weights, cfg: Dict, batches: Sequence[Dict[str, torch.Tensor]],
          precision: str = "fp32") -> Dict:
    """Train a copy of ``w0`` over ``batches`` (``rows``, ``xv``, ``y``):
    ``losses`` of every step, ``grad`` the norm of each leaf's first
    gradient, ``change`` the norm of each leaf's change over all the steps."""
    no_tf32()
    w = {k: v.clone() for k, v in w0.items()}
    acc: Dict[str, torch.Tensor] = {}
    losses, first = [], None
    for batch in batches:
        loss, g = grads(w, cfg, batch, precision)
        if first is None:
            first = norms(g)
        adagrad_(w, g, acc, cfg["learning_rate"])
        losses.append(loss)
    return {"losses": losses, "grad": first, "change": norms({k: w[k] - w0[k] for k in w})}


def compact(w: Weights, batches: Sequence[Dict[str, torch.Tensor]]
            ) -> Tuple[Weights, List[Dict[str, torch.Tensor]], torch.Tensor]:
    """(weights whose table holds only the rows ``batches`` touch, the
    batches with their rows renumbered into it, those rows in the full
    table). Every leaf but the table is shared."""
    every = torch.cat([b["rows"].reshape(-1) for b in batches])
    touched, inverse = torch.unique(every, return_inverse=True)
    out, at = [], 0
    for b in batches:
        n = b["rows"].numel()
        out.append({**b, "rows": inverse[at:at + n].view_as(b["rows"])})
        at += n
    return {**w, TABLE: w[TABLE][touched]}, out, touched
