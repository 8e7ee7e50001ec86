"""Faults of DLRM-DCNv2's bags, planted underneath the timed path, to show
that the cell's ``correct`` catches them; ``faults.py``'s own faults are
planted through the same door.

* ``bag_duplicates_unsummed``: the sparse Adagrad steps each distinct row on
  one of its ids' gradients, the others dropped, where they must be summed;
* ``bag_update_skipped``: the bags' rows are left as they are.

    python3 -m port_bench.dlrm_faults --workload <cell> --seconds <s> --fault <name> \
        --seeds <n>...

reads them on the card as ``calibrate.py --fault`` does: one JSON line a
seed, with the cell's checks.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from xsdeepfwfm_deprecated_torch.ops import embedding as emb_ops

from . import faults


@torch.no_grad()
def _unsummed(table, acc, g, lr, eps, count):
    """``bag_adagrad_`` with each segment's gradient written by one of its
    ids (a plain store, the last writer wins) instead of their sum."""
    b, fields, e = g.grad.shape
    ids = g.rows.reshape(-1)
    sorted_ids, perm = torch.sort(ids)
    new = torch.ones_like(sorted_ids, dtype=torch.bool)
    new[1:] = sorted_ids[1:] != sorted_ids[:-1]
    seg = torch.cumsum(new, 0) - 1
    seg_of = torch.empty_like(seg).scatter_(0, perm, seg).view(b, -1)
    rows = sorted_ids.clone().scatter_(0, seg, sorted_ids)
    gsum = torch.zeros((ids.numel(), e), dtype=g.grad.dtype, device=ids.device)
    for c, f in enumerate(g.spec.column_field):
        gsum.index_put_((seg_of[:, c],), g.grad[:, f])
    a = acc.index_select(0, rows)
    sq = gsum * gsum
    a.add_(sq)
    acc.index_add_(0, rows, sq)
    live = a > 0
    table.index_add_(0, rows, a.add_(eps).rsqrt_().mul_(gsum).masked_fill_(~live, 0.0), alpha=-lr)
    count.add_(seg[-1] + 1)


def plant(name: str):
    if name == "bag_duplicates_unsummed":
        return faults._swap(emb_ops, "bag_adagrad_", _unsummed)
    if name == "bag_update_skipped":
        return faults._swap(emb_ops, "bag_adagrad_", lambda *a, **k: None)
    return faults.plant(name)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--fault", required=True)
    args = p.parse_args(argv)
    from port_bench import run
    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    spec = run.cell_spec(bench, args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        with plant(args.fault):
            rec, _ = run.run_spec(spec, args.workload, seed, args.seconds, False,
                                  torch.device("cuda", 0), t0)
        print(json.dumps({"workload": args.workload, "fault": args.fault, "seed": seed,
                          "checks": rec.checks, "info": {k: v for k, v in rec.info.items()
                                                         if k != "setup_stages"},
                          "seconds": time.perf_counter() - t0}), flush=True)
        del rec
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
