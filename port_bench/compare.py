"""The numbers that decide ``correct``: each a gap between what the timed path
produced and the reference, held to the cell's limit in ``limits/<cell>.json``.

Training (the first three steps of the window's own call and feed):

* ``loss_gap``: the largest |loss - reference loss| / |reference loss| of the steps;
* ``grad_gap``: by the worst leaf, |norm of the program's first gradient (with
  L2, from the optimizer's first moment) - the reference's| over the larger
  of the reference leaf's norm and the median leaf's;
* ``median_change_gap``: the same for each leaf's change over the three
  steps, taken at the median leaf: the worst leaf's change swings from seed
  to seed, where Adam meets a gradient near its eps in one small leaf and
  turns a rounding difference into a step of another size (it is reported
  beside, as ``worst_change_gap``, and not judged);
* ``refresh_gap``: one prune refresh of the window's own refresh call, from
  the program's state after the window, against the reference's refresh of
  the same state: by the worst pruned group, the share of values that differ.

Leaves whose reference gradient is below a thousandth of the median leaf's
move by rounding alone and are left out of both norm gaps.

Serving: ``logit_gap``, the largest |logit - reference logit| over the
sampled answers, over the standard deviation of the reference logits.
"""

from __future__ import annotations

import statistics
from typing import Dict, Iterable, List

import torch

NEGLIGIBLE = 1e-3


def counted(ref_grad: Dict[str, float]) -> List[str]:
    med = statistics.median(ref_grad.values())
    return [k for k, v in ref_grad.items() if v >= NEGLIGIBLE * med]


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keep: Iterable[str]) -> Dict[str, float]:
    """Each kept leaf's |norm - reference norm| over the larger of the
    reference leaf's norm and the median leaf's."""
    keep = list(keep)
    med = statistics.median(ref[k] for k in keep)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in keep}


def norm_gap(prog: Dict[str, float], ref: Dict[str, float], keep: Iterable[str]) -> float:
    return max(leaf_gaps(prog, ref, keep).values())


def train(prog: Dict, ref: Dict) -> Dict[str, float]:
    """``prog`` and ``ref`` hold ``losses``, ``grad`` and ``change`` as
    ``reference.train.steps`` returns them."""
    keep = counted(ref["grad"])
    return {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])),
            "grad_gap": norm_gap(prog["grad"], ref["grad"], keep),
            "median_change_gap": statistics.median(
                leaf_gaps(prog["change"], ref["change"], keep).values())}


def worst_leaf(prog: Dict[str, float], ref: Dict[str, float], keep: Iterable[str]) -> List:
    """[leaf, its gap, its norm, the reference's] of the leaf whose norm gap
    is widest."""
    gaps = leaf_gaps(prog, ref, keep)
    k = max(gaps, key=gaps.get)
    return [k, gaps[k], prog[k], ref[k]]


def refresh_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
                names: Iterable[str]) -> float:
    return max(float((prog[k].to(ref[k].device) != ref[k]).sum()) / ref[k].numel()
               for k in names)


def logit_gap(outs: List[torch.Tensor], refs: List[torch.Tensor]) -> float:
    ref = torch.cat([r.reshape(-1).double() for r in refs])
    out = torch.cat([o.reshape(-1).double().to(ref.device) for o in outs])
    return float((out - ref).abs().max() / ref.std().clamp(min=1e-30))
