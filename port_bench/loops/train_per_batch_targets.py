"""``train_per_batch`` at a pruning target the configuration file does not
hold: the traffic's ``prune_targets`` (DeepLight's sparsities and schedule)
are laid over the configuration, and ``train_per_batch.run`` drives the cell
unchanged, its refresh and its reference's at those targets.

The run's context then reads as ``train_per_batch``'s over the overlaid
configuration, so that the program's traced stretch
(``program_spans.py``) builds the same cell again."""

from __future__ import annotations

from ..harness import Context, Record
from . import train_per_batch


def run(ctx: Context) -> Record:
    tr = ctx.traffic
    ctx.config = {**ctx.config, **tr["prune_targets"]}
    ctx.traffic = {k: v for k, v in tr.items() if k != "prune_targets"}
    ctx.traffic["loop"] = "train_per_batch"
    return train_per_batch.run(ctx)
