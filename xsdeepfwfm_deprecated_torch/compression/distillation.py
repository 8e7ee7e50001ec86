"""Knowledge distillation: the DeepLight KD loss.

Port of ``xsdeepfwfm_deprecated_tpu/compression/distillation.py:20-37``.
KD loss = ``KLDiv(log_softmax(student/T), softmax(teacher/T)) * alpha * T^2 +
BCE_with_logits(student, y) * (1 - alpha)``. As in the reference, the softmax
is taken over the **batch** axis (the logits are 1-D) and the KL term is
reduced by an elementwise mean over the valid rows. The teacher's logits
are computed once per epoch by the estimator (``train/trainer.py``).

On a mesh each rank holds some rows of the global batch, over which JAX's
compiler takes the softmax. Given the ranks (``group``), the log-softmaxes
are formed over all of them: ``(x - m) - log(Σ_ranks Σ exp(x - m))``, where
``m`` is the maximum over the ranks (outside the gradient, as
``jax.nn.log_softmax`` holds its shift); the sums go through one SUM
all-reduce whose backward gathers every rank's cotangent
(``parallel.mesh.BatchGroup``). The student's and the teacher's maxima share
one MAX all-reduce and their sums one SUM all-reduce; the teacher's part
carries no gradient. The means divide by the global batch's count of real
rows.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..device import exact_div
from ..parallel.mesh import BatchGroup


def _global_log_softmax(s: torch.Tensor, te: torch.Tensor, group: BatchGroup
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(log p_s, log p_t, p_t): the softmaxes of the student's and the
    teacher's (masked, scaled) logits over the rows of every rank of
    ``group``."""
    m = group.max(torch.stack([s.detach().max(), te.max()]))
    shifted_s, shifted_t = s - m[0], te - m[1]
    exp_t = shifted_t.exp()
    sums = group.sum(torch.stack([shifted_s.exp().sum(), exp_t.sum()]))
    return shifted_s - sums[0].log(), shifted_t - sums[1].log(), exp_t / sums[1]


def kd_loss(student_logits: torch.Tensor, teacher_logits: torch.Tensor, y: torch.Tensor,
            mask: torch.Tensor, *, alpha: float = 0.9, temperature: float = 20.0,
            group: Optional[BatchGroup] = None, count: Optional[torch.Tensor] = None
            ) -> torch.Tensor:
    """Masked KD loss over a (possibly padded) batch of 1-D logits. Padded
    rows get a logit of -1e30, so they take no share of either softmax.
    ``group``: the ranks that hold the other rows of the global batch, over
    which the softmaxes run; ``count``: the global batch's number of real
    rows (a 0-d tensor), which the means divide by. Without them the batch
    is this one."""
    t = temperature
    valid = mask > 0
    neg_inf = torch.full_like(student_logits, -1e30)
    s = torch.where(valid, exact_div(student_logits, t), neg_inf)
    te = torch.where(valid, exact_div(teacher_logits, t), neg_inf)
    if group is None:
        log_p_s, log_p_t, p_t = (F.log_softmax(s, dim=0), F.log_softmax(te, dim=0),
                                 F.softmax(te, dim=0))
    else:
        log_p_s, log_p_t, p_t = _global_log_softmax(s, te, group)
    kl_elem = torch.where(valid, p_t * (log_p_t - log_p_s), torch.zeros_like(s))
    n_valid = mask.sum().clamp(min=1.0) if count is None else count
    kl = kl_elem.sum() / n_valid
    bce = (F.binary_cross_entropy_with_logits(student_logits, y, reduction="none")
           * mask).sum() / n_valid
    return kl * (alpha * t * t) + bce * (1.0 - alpha)
