"""Failure detection and automatic restart-and-resume for ``fit``.

The port's own copy of ``xsdeepfwfm_deprecated_tpu/train/recovery.py``. It
supervises ``fit``:

* **detection**: a ``RuntimeError`` (which PyTorch raises for a CUDA failure;
  ``torch.OutOfMemoryError`` and ``torch.AcceleratorError`` derive from it) or
  an ``OSError`` that escapes the training loop counts as recoverable.
  Assertion, value and type errors do not: they are bugs and re-raise at once;
* **recovery**: the estimator's device state (params, optimizer state) and
  its cached functions with their CUDA graphs are dropped, and ``fit`` starts
  again with ``resume_from=save_path``, at the epoch after the last per-epoch
  checkpoint;
* bounded by ``max_restarts``; the last failure re-raises when they are used up.

The unit of recovery is the process-local fit.
"""

from __future__ import annotations

from typing import Tuple, Type

import torch

from . import checkpoint as ckpt


def _recoverable_types() -> Tuple[Type[BaseException], ...]:
    types = [RuntimeError, OSError]
    for name in ("OutOfMemoryError", "AcceleratorError"):   # by name: newer PyTorch only
        err = getattr(torch, name, None)
        if isinstance(err, type) and err not in types:
            types.append(err)
    return tuple(types)


def fit_with_recovery(est, *fit_args, save_path: str, max_restarts: int = 2,
                      **fit_kwargs):
    """Run ``est.fit(*fit_args, save_path=save_path, **fit_kwargs)`` under
    restart supervision. Returns the estimator, like ``fit``."""
    recoverable = _recoverable_types()
    attempt = 0
    while True:
        resume = fit_kwargs.pop("resume_from", None)
        if attempt > 0 and ckpt.checkpoint_exists(save_path):
            resume = save_path
        try:
            return est.fit(*fit_args, save_path=save_path, resume_from=resume, **fit_kwargs)
        except recoverable as e:
            attempt += 1
            if attempt > max_restarts:
                est._log(f"recovery: giving up after {max_restarts} restarts")
                raise
            has_ckpt = ckpt.checkpoint_exists(save_path)
            est._log(
                f"recovery: fit failed with {type(e).__name__}: {e}; "
                f"restart {attempt}/{max_restarts} "
                + (f"resuming from {save_path}" if has_ckpt
                   else "from scratch (no checkpoint written yet)"))
            # drop the device state: its tensors may be invalid after the failure, and
            # so may the graphs captured on them. fit() initializes params again and
            # builds the optimizer's template before it loads the checkpoint into them
            est.params = None
            est.opt_state = None
            est._fwd = est._eval_fn = est._scan_eval = None
