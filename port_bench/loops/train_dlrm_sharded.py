"""DLRM-DCNv2 whole over the cards of one host: ``traffic["ranks"]`` ranks,
one card each, through the program's sharded step (``parallel/bag_sharding``:
the large tables row-wise over the ranks, the small ones whole on each, the
ids, partial bags and gradients exchanged over NCCL inside the step's CUDA
graph), with the door, weights and traffic of ``port_bench/dlrm_whole.py``.

The ranks are started by the program's ``parallel.launch.run_ranks`` (fresh
interpreters joined over a file, a card a rank over NCCL; on the CPU over
gloo). Each rank builds its own table from the run's seed, draws its own pool
of ``pool_rows`` rows from the seed and its rank, and steps ``make_train_step``
on its ``batch`` rows of each global batch (the ranks' batches side by side),
one replay a step; a step is the one-process step of the global batch.

Set-up steps the window's first three global steps through the same calls
and feed, which the reference follows (``reference/dlrm_dcnv2_blocks.py``, in
this process on the first card once the ranks have ended, on a compact table
of the rows those batches touch): the global losses (each rank's share
summed), each leaf's first gradient (its Adagrad accumulator after one step,
over the rows each rank counts: its blocks', and the whole tables' on rank 0),
each leaf's change over the three steps (the same rows), and each rank's count
of rows stepped against the distinct rows it holds, which the benchmark counts
from the configuration's deployment. After the window every rank's whole
tables are held to rank 0's, row by row, by a hash of their bits
(``replica_gap``, the share of rows that differ).

The window's length is fixed in steps before it starts, from rank 0's time
over ``CAL_STEPS`` steps, so that every rank runs the same steps; it starts
after a barrier and ends in a sync. ``examples`` are global rows;
``memory_peak_bytes`` is the fullest rank's. With ``--trace 1`` every rank
carries CUDA events in the window (rank 0's are the record's), then runs a
profiled stretch of ``PROFILED_STEPS`` steps and the traced stretch of
``train_xdeepfm.traced_stretch``, all ranks stepping together and rank 0
alone profiling. ``info ranks`` holds each rank's mean step ms,
``exchange_bytes`` a step and memory.

On the cards each rank names the card it ran on (``info cards``); a run whose
ranks did not each hold a card of their own fails. ``run.py`` writes one card
into every result line; :func:`count_cards_in_line` makes the line of a run of
this loop count the distinct cards its ranks ran on.
"""

from __future__ import annotations

import contextlib
import gc
import math
import sys
import tempfile
import time
from functools import partial
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from xsdeepfwfm_deprecated_torch.data import batching
from xsdeepfwfm_deprecated_torch.models import dlrm as program_dlrm
from xsdeepfwfm_deprecated_torch.parallel import bag_sharding
from xsdeepfwfm_deprecated_torch.parallel import mesh as mesh_mod
from xsdeepfwfm_deprecated_torch.parallel.launch import run_ranks
from xsdeepfwfm_deprecated_torch.train.trainer import make_optimizer, make_train_step
from xsdeepfwfm_deprecated_torch.utils import cuda_graph, profiling

from .. import compare, dlrm, dlrm_whole, program, program_spans
from ..harness import Context, DeviceTimer, Record, profile, sync
from ..reference import dlrm_dcnv2 as ref
from ..reference import dlrm_dcnv2_blocks as ref_blocks
from .train_per_batch import CHECK_STEPS, _endless

PROFILED_STEPS = 30
CAL_STEPS = 5
TIMEOUT_S = 300.0        # the ranks' deadline a job: a collective whose peer died waits for ever
SLOTS = "/sum_of_squares/"
RUN_PY = Path(__file__).resolve().parents[1] / "run.py"


def _card(dev: torch.device) -> Optional[Dict]:
    """The card a rank runs on, by index, name and UUID; None on the CPU."""
    if dev.type != "cuda":
        return None
    props = torch.cuda.get_device_properties(dev)
    return {"index": dev.index, "name": props.name, "uuid": str(props.uuid)}


def cards_used(rec: Record) -> Optional[int]:
    """The distinct cards the ranks of ``rec``'s run ran on; None where the
    run held none (the CPU)."""
    cards = rec.info.get("cards")
    return len({c["uuid"] for c in cards}) if cards else None


def count_cards_in_line() -> None:
    """Make ``run.result_line`` write :func:`cards_used` into the line's
    ``device.count`` for a record of this loop, in each loaded copy of
    ``run.py`` (the script's ``__main__``, the module ``port_bench.run``); a
    record of any other loop keeps the line as ``run.py`` writes it.
    Idempotent."""
    for name in ("__main__", "port_bench.run"):
        mod = sys.modules.get(name)
        found = vars(mod) if mod is not None else {}
        inner = found.get("result_line")
        if (inner is None or getattr(inner, "counts_cards", False)
                or Path(found.get("__file__") or "").resolve() != RUN_PY):
            continue

        def result_line(bench, rec, ctx, _inner=inner):
            line = _inner(bench, rec, ctx)
            cards = cards_used(rec)
            if cards is not None:
                line["device"]["count"] = cards
            return line
        result_line.counts_cards = True
        mod.result_line = result_line


def _hash_rows(t: torch.Tensor) -> torch.Tensor:
    """One int64 a row from its bits: equal rows give equal hashes, rows that
    differ in any bit give other hashes but for a chance of 2^-60 or so."""
    g = torch.Generator(device=t.device).manual_seed(12345)
    w = torch.randint(1, 1 << 24, (t.shape[1],), generator=g, dtype=torch.int64, device=t.device)
    return (t.contiguous().view(torch.int32).long() * w).sum(dim=1)


def _sum_sq_at(t: torch.Tensor, rows: torch.Tensor, before: Optional[torch.Tensor] = None,
               chunk: int = 1 << 21) -> float:
    """Σ (t[rows] - before)² (or Σ t[rows], with ``before`` None) in float64,
    a chunk of rows at a time; ``before`` may be on the host."""
    total = 0.0
    for lo in range(0, rows.numel(), chunk):
        part = t.index_select(0, rows[lo:lo + chunk]).double()
        if before is None:
            total += float(part.sum())
        else:
            total += float((part - before[lo:lo + chunk].to(t.device).double()).square().sum())
    return total


def _rank(rank: int, device: torch.device, jobs: List[Dict]) -> List[Dict]:
    """Every job in turn on this rank; one result each."""
    mesh = mesh_mod.make_mesh(data=jobs[0]["traffic"]["ranks"], model=1, device=device)
    out = []
    for job in jobs:
        if job.get("fault"):
            from .. import dlrm_sharded_faults
            planted = dlrm_sharded_faults.plant(job["fault"], rank)
        else:
            planted = contextlib.nullcontext()
        with planted:
            out.append(_one(rank, device, job, mesh))
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def _one(rank: int, dev: torch.device, job: Dict, mesh) -> Dict:
    cfg, tr, seed = job["config"], job["traffic"], job["seed"]
    b, n_ranks = tr["batch"], mesh.size
    gb = b * n_ranks
    mcfg, tcfg = dlrm.model_config(cfg), dlrm.train_config(cfg, {**tr, "batch": gb})
    res: Dict = {"stages": {}, "card": _card(dev)}

    def stage(name):
        res["stages"][name] = time.perf_counter()

    xi, xv, y = dlrm_whole.sample_rows(cfg, tr, tr["pool_rows"], seed, rank, dev)
    if dev.type == "cuda":      # the sampler's tables: no part of what the step holds
        torch.cuda.empty_cache()
    stage("pool")
    bags = bag_sharding.ShardedBags(mesh, program_dlrm.make_bag_spec(mcfg),
                                    cfg["bag_row_wise_rows"])
    table = bag_sharding.local_table(bags.placement, dlrm_whole.TableRows(cfg, seed, dev),
                                     cfg["embedding_size"], torch.float32, dev)
    params = dlrm.params(mcfg, {**dlrm_whole.dense(cfg, seed, dev), ref.TABLE: table})
    optimizer = make_optimizer(tcfg)
    opt_state = optimizer.init(params)
    step = make_train_step(mcfg, tcfg, optimizer, mesh=mesh, reduce=bags.reduce,
                           forward_fn=partial(program_dlrm.forward, lookup_fn=bags.lookup))
    count = np.asarray(gb, np.float32)
    feed = batching.prefetch_to_device(
        ({**batch, "count": count} for batch in _endless(xi, xv, y, b)), dev)
    stage("weights")

    # the first steps, through the window's own call and feed, held to the reference
    mine = torch.from_numpy(xi[:CHECK_STEPS * b]).to(dev).view(CHECK_STEPS, b, -1)
    every = mesh.all_gather(mine, mesh_mod.GRID_AXES)              # (ranks, steps, b, columns)
    checked = [ref.packed_rows(cfg, every[:, i].reshape(gb, -1)) for i in range(CHECK_STEPS)]
    touched = torch.unique(torch.cat([r.reshape(-1) for r in checked]))
    here = touched[dlrm_whole.counted_here(cfg, touched, rank, n_ranks)]
    at = bag_sharding.packed_to_local(bags.placement, here, table.shape[0])
    leaves = program.named(params)
    before = table.index_select(0, at).cpu()
    p0 = {k: v.clone() for k, v in leaves.items() if k != ref.TABLE}
    counted = lambda: cuda_graph.device_counts().get("bag_rows_updated", 0)   # noqa: E731
    updated = counted()
    losses, grad_sq = [], {}
    for i in range(CHECK_STEPS):
        losses.append(float(step(params, opt_state, next(feed))))
        if i == 0:
            for name, acc in program.named(opt_state).items():
                leaf = name.split(SLOTS, 1)[1]
                grad_sq[leaf] = (_sum_sq_at(acc, at) if leaf == ref.TABLE
                                 else float(acc.double().sum()))
    res["check"] = {
        "losses": losses, "grad_sq": grad_sq,
        "change_sq": {k: (_sum_sq_at(table, at, before) if k == ref.TABLE
                          else float((v.double() - p0[k].double()).square().sum()))
                      for k, v in leaves.items()},
        "rows_updated": counted() - updated,
        "rows_held": sum(dlrm_whole.distinct_held(cfg, r, rank, n_ranks) for r in checked)}
    res["checked"] = tuple(a[:CHECK_STEPS * b].copy() for a in (xi, xv, y))
    del before, p0, every, mine, checked, touched, here, at
    # the window's length in steps, the same on every rank
    sync(dev)
    t = time.perf_counter()
    for _ in range(CAL_STEPS):
        step(params, opt_state, next(feed))
    sync(dev)
    per_step = (time.perf_counter() - t) / CAL_STEPS
    n = torch.tensor([math.ceil(job["seconds"] / per_step)], dtype=torch.float64, device=dev)
    n = int(mesh.all_reduce(n, mesh_mod.GRID_AXES, op=torch.distributed.ReduceOp.MAX).item())
    memory = {}
    if dev.type == "cuda":
        memory["setup_peak_reserved"] = int(torch.cuda.max_memory_reserved(dev))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    sent = profiling.counters()["exchange_bytes"]
    mesh.barrier()
    stage("window")

    window: List[torch.Tensor] = []
    timed = dev if job["trace"] else torch.device("cpu")     # events in a traced window alone
    steps_t, feed_t = DeviceTimer(timed), DeviceTimer(timed)
    end = None
    t0 = time.perf_counter()
    for _ in range(n):
        batch = next(feed)
        e = steps_t.start()
        if end is not None:
            feed_t.pairs.append((end, e))
        window.append(step(params, opt_state, batch))
        end = steps_t.stop(e)
    sync(dev)
    t1 = time.perf_counter()
    res.update(window_s=t1 - t0, t0=t0, steps=n,
               exchange_bytes=(profiling.counters()["exchange_bytes"] - sent) / n,
               failed=int((~torch.isfinite(torch.stack(window))).sum()),
               captures_in_window=sum(t0 * 1e9 <= at_ns <= t1 * 1e9
                                      for _, at_ns in cuda_graph.CAPTURES))
    if dev.type == "cuda":
        free, total = torch.cuda.mem_get_info(dev)
        memory.update(peak_allocated=int(torch.cuda.max_memory_allocated(dev)),
                      window_peak_reserved=int(torch.cuda.max_memory_reserved(dev)),
                      card_used=int(total - free))
    if job["trace"]:
        res["device_ms"] = {"train_step": steps_t.ms(), "feed_wait": feed_t.ms()}
        res.update(_traced(rank, dev, lambda: step(params, opt_state, next(feed))))
        if dev.type == "cuda":
            free, total = torch.cuda.mem_get_info(dev)
            memory["card_used_traced"] = int(total - free)
    res["memory"] = memory
    # the whole tables, row by row, after every step
    whole = torch.cat([torch.arange(lo, hi, device=dev)
                       for lo, hi in dlrm_whole.whole_table_rows(cfg)])
    res["whole_hashes"] = _hash_rows(table.index_select(0, bag_sharding.packed_to_local(
        bags.placement, whole, table.shape[0]))).cpu()
    del step, params, opt_state, optimizer, feed, window, leaves, table
    return res


def _traced(rank: int, dev: torch.device, one) -> Dict:
    """The profiled stretch and the program's traced stretch, every rank
    stepping, rank 0 alone under ``torch.profiler``: what rank 0 reads into
    its record."""
    out: Dict = {}
    rec = Record()

    def steps():
        for _ in range(PROFILED_STEPS):
            one()
    if rank == 0:
        profile(steps, PROFILED_STEPS, dev, rec)
    else:
        steps()
        sync(dev)
    with profiling.tracing():
        one()                       # the traced variant's capture
        sync(dev)
        profiling.spans()
        for _ in range(PROFILED_STEPS):
            one()
            sync(dev)
        spans = profiling.spans()
        if rank == 0:
            events, base_ns = program_spans._traced(steps, dev)
            profiled = profiling.spans()
            offset_ns = profiling.trace_clock_ns(0)
        else:
            steps()
            sync(dev)
            profiling.spans()
    if rank == 0:
        gaps, named = program_spans.gaps_by_span(events, profiled, offset_ns, base_ns)
        rec.breakdown["idle_gaps_by_span"] = gaps
        out.update(busy_s=rec.busy_s, traced_s=rec.traced_s, breakdown=rec.breakdown,
                   spans=spans, idle_named_by_span=named,
                   graph_launches_in_spans=program_spans.launches_in_spans(
                       events, profiled, offset_ns, base_ns),
                   program_spans=program_spans._summary(spans, profiling),
                   profiled_spans=program_spans._summary(profiled, profiling))
    return out


def jobs_of(ctx: Context, fault: Optional[str] = None) -> Dict:
    return {"config": ctx.config, "traffic": ctx.traffic, "seed": ctx.seed,
            "seconds": ctx.seconds, "trace": ctx.trace, "fault": fault}


def start(jobs: List[Dict], device: torch.device) -> List[List[Dict]]:
    """Run ``jobs`` on the traffic's ranks: a card each (NCCL) where ``device``
    is a card, the CPU (gloo) where it is not. Each rank's results."""
    ranks = jobs[0]["traffic"]["ranks"]
    if device.type == "cuda":
        if torch.cuda.device_count() < ranks:
            raise ValueError(f"train_dlrm_sharded needs {ranks} cards, "
                             f"{torch.cuda.device_count()} are here")
        backend, devices = "nccl", [f"cuda:{r}" for r in range(ranks)]
    else:
        backend, devices = "gloo", ["cpu"] * ranks
    with tempfile.TemporaryDirectory(prefix="port_bench_ranks_") as work:
        return run_ranks(_rank, ranks, backend=backend, devices=devices, workdir=work,
                         args=(jobs,), timeout_s=TIMEOUT_S * len(jobs))


def run(ctx: Context) -> Record:
    tr, cfg = ctx.traffic, ctx.config
    if (tr["steps_per_call"] != 1 or tr["prune"] or tr["pool_rows"] % tr["batch"]
            or tr["batch"] * tr["ranks"] != cfg["global_batch"]):
        raise ValueError("train_dlrm_sharded drives steps_per_call=1 without a refresh over whole "
                         "batches, the ranks' batches making the configuration's global batch")
    ranks = start([jobs_of(ctx)], ctx.device)
    rec = finish(ctx, [r[0] for r in ranks])
    count_cards_in_line()
    return rec


def finish(ctx: Context, ranks: List[Dict]) -> Record:
    """The record of one run from every rank's result, with the reference's
    comparison made here, on ``ctx.device``."""
    cfg, dev = ctx.config, ctx.device
    first = ranks[0]
    rec = Record()
    rec.setup_s = first["t0"] - ctx.started
    rec.window_s, rec.attempted = first["window_s"], first["steps"]
    rec.examples = rec.attempted * ctx.traffic["batch"] * len(ranks)
    rec.failed = sum(r["failed"] for r in ranks)
    rec.memory_peak_bytes = max(r["memory"].get("peak_allocated", 0) for r in ranks)
    if ctx.trace:
        rec.device_ms = first["device_ms"]
        rec.busy_s, rec.traced_s, rec.breakdown = (first["busy_s"], first["traced_s"],
                                                   first["breakdown"])
        rec.traced_units = PROFILED_STEPS
        rec.program_spans = first["spans"]
        for k in ("idle_named_by_span", "graph_launches_in_spans", "program_spans",
                  "profiled_spans"):
            rec.info[k] = first[k]
        rec.info["graph_captures_in_window"] = first["captures_in_window"]
    cards = [r["card"] for r in ranks if r["card"] is not None]
    if cards:
        rec.info["cards"] = cards
        if cards_used(rec) != len(ranks):
            raise ValueError(f"the {len(ranks)} ranks ran on {cards_used(rec)} distinct "
                             f"card(s): {cards}")
    rec.info["ranks"] = [{"step_ms": 1e3 * r["window_s"] / r["steps"],
                          "exchange_bytes": r["exchange_bytes"], "memory": r["memory"]}
                         for r in ranks]

    # the program's readings: each rank's share of the loss, the rows it counts
    checks = [r["check"] for r in ranks]
    prog = {"losses": [sum(c["losses"][i] for c in checks) for i in range(CHECK_STEPS)],
            "grad": {k: (sum(c["grad_sq"][k] for c in checks) if k == ref.TABLE
                         else checks[0]["grad_sq"][k]) ** 0.5 for k in checks[0]["grad_sq"]},
            "change": {k: (sum(c["change_sq"][k] for c in checks) if k == ref.TABLE
                           else checks[0]["change_sq"][k]) ** 0.5
                       for k in checks[0]["change_sq"]}}
    counts = [(c["rows_updated"], c["rows_held"]) for c in checks]
    whole = torch.stack([r["whole_hashes"] for r in ranks])
    replica_gap = float((whole != whole[0]).any(dim=0).double().mean())

    # the reference, on the rows the checked batches touch: global batch i is every
    # rank's batch i, side by side
    xi, xv, y = (torch.cat([torch.from_numpy(r["checked"][j]).to(dev).view(
        CHECK_STEPS, -1, *r["checked"][j].shape[1:]) for r in ranks], dim=1) for j in range(3))
    rows = [ref.packed_rows(cfg, xi[i]) for i in range(CHECK_STEPS)]
    touched, inverse = torch.unique(torch.stack(rows), return_inverse=True)
    batches = [{"rows": inverse[i], "xv": xv[i], "y": y[i]} for i in range(CHECK_STEPS)]
    w0 = {**dlrm_whole.dense(cfg, ctx.seed, dev),
          ref.TABLE: dlrm_whole.TableRows(cfg, ctx.seed, dev).at(touched)}
    del xi, rows, touched, inverse
    want = ref_blocks.steps(w0, cfg, batches, "fp32", device=dev)
    rec.checks = compare.train(prog, want)
    rec.checks["rows_gap"] = max(abs(p - h) / h for p, h in counts)
    rec.checks["replica_gap"] = replica_gap
    keep = compare.counted(want["grad"])
    rec.info["worst_grad_gap"] = compare.worst_leaf(prog["grad"], want["grad"], keep)
    rec.info["worst_change_gap"] = compare.worst_leaf(prog["change"], want["change"], keep)
    rec.info["rows_updated"] = counts
    rec.info["compact_rows"] = int(w0[ref.TABLE].shape[0])
    if ctx.control:
        control = ref_blocks.steps(w0, cfg, batches, "tf32", device=dev)
        rec.control_checks = {**compare.train(control, want), "rows_gap": 0.0,
                              "replica_gap": 0.0}
    rec.info["first_losses"] = prog["losses"]
    rec.info["setup_stages"] = {**ctx.stages, **{f"rank0.{k}": v - ctx.started
                                                 for k, v in first["stages"].items()}}
    return rec
