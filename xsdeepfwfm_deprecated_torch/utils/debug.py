"""Numerical-debugging hooks: trap non-finite values.

Port of ``xsdeepfwfm_deprecated_tpu/utils/debug.py:17-30``, where
``jax.debug_nans`` and ``checkify`` do this work. Here
:func:`nan_debugging` switches on autograd's anomaly detection for the block
(a backward that produces a NaN raises, naming the forward operation) and
makes ``DeepFMEstimator.fit`` check every step's loss with ``isfinite``,
which costs one device sync a step.
"""

from __future__ import annotations

import contextlib
import functools

import torch

_finite_checks = False


def finite_checks_enabled() -> bool:
    """Whether a :func:`nan_debugging` block is open; ``fit`` asks this."""
    return _finite_checks


@contextlib.contextmanager
def nan_debugging(enable: bool = True):
    """Trap NaNs and Infs produced by training inside the block."""
    global _finite_checks
    prev_anomaly, prev_checks = torch.is_anomaly_enabled(), _finite_checks
    torch.autograd.set_detect_anomaly(bool(enable))
    _finite_checks = bool(enable)
    try:
        yield
    finally:
        torch.autograd.set_detect_anomaly(prev_anomaly)
        _finite_checks = prev_checks


def require_finite(value: torch.Tensor, what: str) -> None:
    if not bool(torch.isfinite(value).all()):
        raise FloatingPointError(f"non-finite value in {what}")


def checkified(fn):
    """``fn`` wrapped so that a non-finite value in its output raises
    ``FloatingPointError`` instead of propagating in silence."""
    @functools.wraps(fn)
    def checked(*args, **kwargs):
        out = fn(*args, **kwargs)
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor) and t.is_floating_point():
                require_finite(t, getattr(fn, "__name__", "the output"))
        return out
    return checked
