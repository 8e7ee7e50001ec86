"""The steps of ``dlrm_dcnv2.py`` at sizes that do not fit its straight form:
the same forward, loss and dense Adagrad, with the batch taken in blocks of
examples and the table's update in blocks of rows.

``dlrm_dcnv2.steps`` makes the table's gradient by autograd over the whole
batch and steps Adagrad on the whole table at once, with a few temporaries of
the table's size. A check of DLRM-DCNv2 whole at MLPerf's global batch of
65,536 rows touches about 28 M rows (14.4 GB, as much again of accumulator);
here each block of examples reads its own rows (those it touches, renumbered)
as a leaf of autograd's, and their gradient is added into the table's, then
the step runs over the table a block of rows at a time. The loss is the mean
over the whole batch: each block's mean weighed by its share of the rows. The
sums of a block's gradients into the batch's come in block order, so the
numbers part from the straight form's by float32 rounding alone.

Imports torch and ``dlrm_dcnv2.py`` alone: nothing of the program under test.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from . import dlrm_dcnv2 as ref

ROWS_A_BLOCK = 1 << 22      # table rows a pass of the update or of a norm takes


def _sum_sq(t: torch.Tensor) -> float:
    """Σ t² in float64, a block of rows at a time."""
    return sum(float(part.double().square().sum()) for part in torch.split(t, ROWS_A_BLOCK))


def _norms(ts: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: _sum_sq(v) ** 0.5 for k, v in ts.items()}


@torch.no_grad()
def _adagrad_(p: torch.Tensor, g: torch.Tensor, acc: torch.Tensor, lr: float) -> None:
    for ps, gs, a in zip(torch.split(p, ROWS_A_BLOCK), torch.split(g, ROWS_A_BLOCK),
                         torch.split(acc, ROWS_A_BLOCK)):
        a.add_(gs * gs)
        ps.sub_(lr * torch.where(a > 0, gs / torch.sqrt(a + ref.EPS), torch.zeros_like(a)))


def steps(w0: ref.Weights, cfg: Dict, batches: Sequence[Dict[str, torch.Tensor]],
          precision: str = "fp32", block: int = 16384, device=None) -> Dict:
    """``dlrm_dcnv2.steps`` on ``device`` (default: that of the batches): the
    ``losses`` of every step, ``grad`` the norm of each leaf's first gradient,
    ``change`` the norm of each leaf's change over all the steps. ``w0`` may
    live on the host; it is left as it is."""
    ref.no_tf32()
    device = device or batches[0]["rows"].device
    w = {k: v.to(device, copy=True) for k, v in w0.items()}
    acc = {k: torch.zeros_like(v) for k, v in w.items()}
    losses, first = [], None
    for batch in batches:
        n = batch["rows"].shape[0]
        g = {k: torch.zeros_like(v) for k, v in w.items()}
        loss = 0.0
        for lo in range(0, n, block):
            rows = batch["rows"][lo:lo + block]
            touched, inverse = torch.unique(rows, return_inverse=True)
            live = {k: v.detach().requires_grad_(True) for k, v in w.items() if k != ref.TABLE}
            live[ref.TABLE] = w[ref.TABLE].index_select(0, touched).requires_grad_(True)
            part = ref.bce(ref.forward(live, cfg, inverse.view_as(rows), batch["xv"][lo:lo + block],
                                       precision), batch["y"][lo:lo + block]) * (rows.shape[0] / n)
            got = dict(zip(live, torch.autograd.grad(part, list(live.values()))))
            with torch.no_grad():
                for k, v in got.items():
                    if k == ref.TABLE:
                        g[k].index_add_(0, touched, v)
                    else:
                        g[k].add_(v)
            loss += float(part.detach())
        if first is None:
            first = _norms(g)
        for k in w:
            _adagrad_(w[k], g[k], acc[k], cfg["learning_rate"])
        del g
        losses.append(loss)
    change = {k: _change(w[k], w0[k], device) for k in w}
    return {"losses": losses, "grad": first, "change": change}


def _change(w: torch.Tensor, w0: torch.Tensor, device) -> float:
    """|w - w0| in float64, a block of rows at a time (``w0`` may be on the host)."""
    return sum(float((a.double() - b.to(device).double()).square().sum())
               for a, b in zip(torch.split(w, ROWS_A_BLOCK), torch.split(w0, ROWS_A_BLOCK))) ** 0.5
