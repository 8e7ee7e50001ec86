"""Faults of the sharded DLRM-DCNv2 step (``parallel/bag_sharding``), planted in
every rank underneath the timed path, to show that the four-card cell's
``correct`` catches them:

* ``pool_dropped``: rank 1's partial bags of the row-wise tables are zeros in
  the reduce-scatter, so every bag loses that rank's rows;
* ``ids_wrong_block``: each rank reads and steps the block of the rank after
  it where its own holds an id;
* ``grads_left_local``: the whole tables' gradients of the other ranks' rows
  are dropped after the gather, so each replica steps on its own rows alone;
* ``dense_not_reduced``: the dense leaves' gradients are not summed over the
  ranks.

    python3 -m port_bench.dlrm_sharded_faults --workload <cell> --seconds <s> \
        --seeds <n>... [--faults none|<name>...] [--control]

reads them on the cards as ``calibrate.py`` reads a cell's seeds: a run for
each fault (``none``: none planted; with ``--control`` those runs also read the
TF32 control) and seed, all in one start of the ranks, one JSON line each
with the cell's checks.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time
from typing import Iterator

import torch

from xsdeepfwfm_deprecated_torch.device import constant
from xsdeepfwfm_deprecated_torch.parallel import bag_sharding

from .faults import _swap
from .harness import Context

FAULTS = ("pool_dropped", "ids_wrong_block", "grads_left_local", "dense_not_reduced")


@contextlib.contextmanager
def plant(name: str, rank: int) -> Iterator[None]:
    cls = bag_sharding.ShardedBags
    if name == "pool_dropped":
        orig = cls._pool

        def pool(self, table, rows, row_wise):
            out = orig(self, table, rows, row_wise)
            return torch.zeros_like(out) if row_wise and rank == 1 else out
        with _swap(cls, "_pool", pool):
            yield
    elif name == "ids_wrong_block":
        orig_rows = bag_sharding.local_rows

        def local_rows(p, ids, table_rows):
            return orig_rows(dataclasses.replace(p, rank=(p.rank + 1) % p.ranks), ids, table_rows)
        with _swap(bag_sharding, "local_rows", local_rows):
            yield
    elif name == "grads_left_local":
        orig_grad = cls._grad

        def grad(self, rows, spec, sink, g):
            out = orig_grad(self, rows, spec, sink, g)
            b = g.shape[0]
            mine = torch.zeros(out.grad.shape[0], dtype=torch.bool, device=g.device)
            mine[rank * b:(rank + 1) * b] = True
            whole = constant(tuple(not rw for rw in self.placement.row_wise), torch.bool,
                             g.device)
            out.grad.mul_((mine[:, None] | ~whole[None, :]).to(out.grad.dtype)[..., None])
            return out
        with _swap(cls, "_grad", grad):
            yield
    elif name == "dense_not_reduced":
        with _swap(cls, "reduce", lambda self, grads: None):
            yield
    else:
        raise ValueError(f"no fault {name!r}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--faults", nargs="+", default=["none"], choices=("none",) + FAULTS)
    p.add_argument("--control", action="store_true")
    args = p.parse_args(argv)
    from port_bench import run
    from port_bench.loops import train_dlrm_sharded as loop
    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    spec = run.cell_spec(bench, args.workload)
    dev = torch.device("cuda", 0)
    torch.zeros(1, device=dev)
    t0 = time.perf_counter()
    runs = [(None if f == "none" else f, Context(
        cell=args.workload, config=spec["config"], traffic=spec["traffic"], seed=s,
        seconds=args.seconds, trace=False, device=dev, limits=spec["limits"], started=t0,
        control=args.control and f == "none")) for f in args.faults for s in args.seeds]
    ranks = loop.start([loop.jobs_of(ctx, fault) for fault, ctx in runs], dev)
    for i, (fault, ctx) in enumerate(runs):
        rec = loop.finish(ctx, [r[i] for r in ranks])
        print(json.dumps({"workload": args.workload, "fault": fault, "seed": ctx.seed,
                          "checks": rec.checks, "control": rec.control_checks,
                          "attempted": rec.attempted, "failed": rec.failed,
                          "info": {k: v for k, v in rec.info.items() if k != "setup_stages"},
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
