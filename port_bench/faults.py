"""Faults planted underneath the timed path, to show that ``correct`` catches them.

Each is a context manager that replaces one function of the program under
test while it is open. ``calibrate.py --fault`` reads them on the card at a
cell's own size; the tests read them on the CPU.

* ``state_unchanged``: the optimizer's update does nothing;
* ``half_batch``: the loss is the mean over the first half of the batch;
* ``answer_altered_loss``: a training step's loss is 1% higher where it is made;
* ``answer_altered``: the first logit of a served answer is 1 higher;
* ``half_answer``: a served answer's second half of rows left out (zeros);
* ``refresh_skipped``: the prune refresh leaves the parameters as they are.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch

from xsdeepfwfm_deprecated_torch.serving import predictor
from xsdeepfwfm_deprecated_torch.train import trainer


@contextlib.contextmanager
def _swap(owner, name: str, new) -> Iterator[None]:
    old = getattr(owner, name)
    setattr(owner, name, new)
    try:
        yield
    finally:
        setattr(owner, name, old)


def _half_loss(orig):
    def loss(params, batch, *args, **kwargs):
        b = batch["xi"].shape[0]
        half = {k: v[:b // 2] if torch.is_tensor(v) and v.ndim and v.shape[0] == b else v
                for k, v in batch.items()}
        return orig(params, half, *args, **kwargs)
    return loss


def _changed_answer(orig, change):
    def replay(self, xi, xv):
        with torch.inference_mode():
            out = orig(self, xi, xv).clone()
            change(out)
        return out
    return replay


def _first_plus_one(out):
    out[0] += 1.0


def _second_half_zero(out):
    out[out.shape[0] // 2:] = 0.0


def plant(name: str):
    if name == "state_unchanged":
        return _swap(trainer.Optimizer, "update", lambda self, params, grads, state: None)
    if name == "half_batch":
        return _swap(trainer, "batch_loss", _half_loss(trainer.batch_loss))
    if name == "answer_altered_loss":
        orig = trainer.train_step
        return _swap(trainer, "train_step", lambda *a, **k: orig(*a, **k) * 1.01)
    if name == "answer_altered":
        return _swap(predictor.Predictor, "replay",
                     _changed_answer(predictor.Predictor.replay, _first_plus_one))
    if name == "half_answer":
        return _swap(predictor.Predictor, "replay",
                     _changed_answer(predictor.Predictor.replay, _second_half_zero))
    if name == "refresh_skipped":
        return _swap(trainer, "prune_params_", lambda *a, **k: None)
    raise ValueError(f"no fault {name!r}")
