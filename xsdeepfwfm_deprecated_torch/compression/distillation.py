"""Knowledge distillation: the DeepLight KD loss.

Port of ``xsdeepfwfm_deprecated_tpu/compression/distillation.py:20-37``.
KD loss = ``KLDiv(log_softmax(student/T), softmax(teacher/T)) * alpha * T^2 +
BCE_with_logits(student, y) * (1 - alpha)``. As in the reference, the softmax
is taken over the **batch** axis (the logits are 1-D) and the KL term is
reduced by an elementwise mean over the valid rows. The teacher's logits
are computed once per epoch by the estimator (``train/trainer.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..device import exact_div


def kd_loss(student_logits: torch.Tensor, teacher_logits: torch.Tensor, y: torch.Tensor,
            mask: torch.Tensor, *, alpha: float = 0.9, temperature: float = 20.0
            ) -> torch.Tensor:
    """Masked KD loss over a (possibly padded) batch of 1-D logits. Padded
    rows get a logit of -1e30, so they take no share of either softmax."""
    t = temperature
    valid = mask > 0
    neg_inf = torch.full_like(student_logits, -1e30)
    s = torch.where(valid, exact_div(student_logits, t), neg_inf)
    te = torch.where(valid, exact_div(teacher_logits, t), neg_inf)
    log_p_s = F.log_softmax(s, dim=0)
    log_p_t = F.log_softmax(te, dim=0)
    kl_elem = torch.where(valid, F.softmax(te, dim=0) * (log_p_t - log_p_s),
                          torch.zeros_like(s))
    n_valid = mask.sum().clamp(min=1.0)
    kl = kl_elem.sum() / n_valid
    bce = (F.binary_cross_entropy_with_logits(student_logits, y, reduction="none")
           * mask).sum() / n_valid
    return kl * (alpha * t * t) + bce * (1.0 - alpha)
