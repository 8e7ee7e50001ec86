"""The readings that the limits of ``correct`` are set from, on the card.

    python3 port_bench/calibrate.py --workload <cell> --seconds <s> --seeds <n>... \
        [--control-seeds <n>...]

For each seed, in one process: one run of the cell as ``run.py`` makes it
(set-up, a window of ``--seconds``, the comparison with the reference), and for
the control seeds also the control: the reference computed one precision below
the configuration's (TF32 for float32, int4 for int8) and compared in the
program's place. ``--fault`` plants one of ``faults.py`` underneath the timed
path for every seed. One JSON line a seed. The benchmark's own runs never run
the control.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--fault", default=None, help="a fault of faults.py, planted for every seed")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    import contextlib
    from port_bench import faults, run
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    bench = run.load_json(ROOT / "BENCHMARK.json")
    spec = run.cell_spec(bench, args.workload)
    for seed in args.seeds + [s for s in args.control_seeds if s not in args.seeds]:
        t0 = time.perf_counter()
        with faults.plant(args.fault) if args.fault else contextlib.nullcontext():
            rec, _ = run.run_spec(spec, args.workload, seed, args.seconds, False,
                                  torch.device("cuda", 0), t0, control=seed in args.control_seeds)
        print(json.dumps({"workload": args.workload, "fault": args.fault, "seed": seed,
                          "checks": rec.checks,
                          "control": rec.control_checks, "attempted": rec.attempted,
                          "failed": rec.failed, "info": rec.info,
                          "seconds": time.perf_counter() - t0}), flush=True)
        del rec
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
