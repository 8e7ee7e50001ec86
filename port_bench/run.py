"""One run of one benchmark cell of the PyTorch/CUDA port.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``workloads`` in ``BENCHMARK.json`` at the checkout's
root. Everything that belongs to one name is found by it:

* the configuration: the file its ``configs`` entry names;
* the traffic mix: ``port_bench/traffic/<traffic>.json``, whose ``loop`` names
  the driver ``port_bench/loops/<loop>.py``;
* a metric: its reader ``port_bench/end_to_end/<name>.py`` or
  ``port_bench/layer_metrics/<name>.py``, a function ``read(record, ctx)`` that
  returns a number or None (nothing to read: the metric is left out); a name
  with a suffix, ``<stem>.<part>``, without a file of its own is read by
  ``<stem>.py``;
* the limits of the numbers that decide ``correct``: ``port_bench/limits/<cell>.json``.

With ``--trace 0`` the result line holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics and the device's busy time. The run needs
as many CUDA cards as the cell asks for and exits with 2, printing no result,
where there are fewer; it never falls back to the CPU. It also exits without
a result where JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "port_bench"
FORBIDDEN = ("jax", "jaxlib", "flax", "xsdeepfwfm_deprecated_tpu")


class Refused(Exception):
    """The run cannot give a result; the message says why."""


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def cell_spec(bench: Dict, name: str) -> Dict:
    """The workload ``name`` with its configuration and traffic read in."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise Refused(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    config = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    limits_path = HERE / "limits" / f"{name}.json"
    return {"cell": cell,
            "config": load_json(ROOT / config["file"]),
            "traffic": load_json(HERE / "traffic" / f"{cell['traffic']}.json"),
            "limits": load_json(limits_path) if limits_path.exists() else None}


def metrics_of(bench: Dict, cell: str, trace: bool) -> List[Dict]:
    """The metrics a run of ``cell`` reports: the end-to-end ones with
    ``--trace 0``, the per-layer ones with ``--trace 1``; a metric without a
    ``workloads`` list goes with every cell that reports the metric it moves."""
    if not trace:
        return [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    reported = {m["name"] for m in bench["end_to_end"] if cell in m.get("workloads", [cell])}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in reported else [])]


def module(path: Path):
    spec = importlib.util.spec_from_file_location("port_bench_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader_path(metric: str, trace: bool) -> Path:
    """The reader of ``metric``: its own file, else that of the name's stem
    (``mfu_pct.tput`` falls back to ``mfu_pct.py``)."""
    folder = HERE / ("layer_metrics" if trace else "end_to_end")
    own = folder / f"{metric}.py"
    return own if own.exists() else folder / f"{metric.split('.', 1)[0]}.py"


def reader(metric: str, trace: bool):
    return module(reader_path(metric, trace)).read


def loop(name: str):
    return importlib.import_module(f"port_bench.loops.{name}")


def run_spec(spec: Dict, name: str, seed: int, seconds: float, trace: bool, device,
             started: float, control: bool = False, stages: Optional[Dict] = None):
    """(record, context) of one run of a cell as :func:`cell_spec` reads it,
    on ``device``; ``stages`` holds the set-up stages already passed."""
    from port_bench.harness import Context
    ctx = Context(cell=name, config=spec["config"], traffic=spec["traffic"], seed=seed,
                  seconds=seconds, trace=trace, device=device, limits=spec["limits"],
                  started=started, control=control, stages=dict(stages or {}))
    return loop(spec["traffic"]["loop"]).run(ctx), ctx


def loaded_forbidden() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def judge(checks: Dict[str, float], limits: Optional[Dict[str, float]]) -> bool:
    """True where every limit of the cell has its number and each number is
    within it: a check that was not made, or one without a limit, fails."""
    if not limits or set(checks) != set(limits):
        return False
    return all(math.isfinite(v) and v <= limits[k] for k, v in checks.items())


def result_line(bench: Dict, rec, ctx) -> Dict:
    """The last line of the run's standard output."""
    import torch
    dev = ctx.device
    metrics = {}
    for m in metrics_of(bench, ctx.cell, ctx.trace):
        value = reader(m["name"], ctx.trace)(rec, ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
              "count": 1, "memory_peak_bytes": rec.memory_peak_bytes}
    if ctx.trace:
        device.update(busy_s=rec.busy_s, window_s=rec.traced_s)
    limits = ctx.limits or {}
    line = {"correct": judge(rec.checks, ctx.limits) and rec.failed == 0,
            "attempted": rec.attempted, "failed": rec.failed, "metrics": metrics,
            "device": device}
    if ctx.trace and rec.breakdown is not None:
        line["breakdown"] = rec.breakdown
    line["checks"] = {k: {"value": v, "limit": limits.get(k)} for k, v in rec.checks.items()}
    return line


def main(argv=None) -> int:
    started_fallback = time.perf_counter()
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # the program's and torch's build caches live at fixed paths in the checkout
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
    sys.path.insert(0, str(ROOT))
    from port_bench import harness
    started = min(harness.process_start(), started_fallback)
    try:
        bench = load_json(ROOT / "BENCHMARK.json")
        chips = cell_spec(bench, args.workload)["cell"]["chips"]
        import torch
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise Refused(f"the cell needs {chips} CUDA card(s); "
                          f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} "
                          "available")
        stages = {"torch": time.perf_counter() - started}
        torch.set_num_threads(2)
        print(f"card: {harness.card_line()}", flush=True)
        dev = torch.device("cuda", 0)
        torch.zeros(1, device=dev)
        stages["card"] = time.perf_counter() - started
        rec, ctx = run_spec(cell_spec(bench, args.workload), args.workload, args.seed,
                            args.seconds, bool(args.trace), dev, started, stages=stages)
        bad = loaded_forbidden()
        if bad:
            raise Refused(f"the run loaded JAX or the JAX package: {', '.join(bad)}")
        line = result_line(bench, rec, ctx)
    except Refused as err:
        print(f"port_bench: {err}", file=sys.stderr)
        return 2
    for k, v in rec.info.items():
        if k != "first_losses":
            print(f"info {k} {json.dumps(v)}", file=sys.stderr)
    for k, c in line["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
