"""Full-Criteo-row-count input pipeline: the binary dataset feeding the card's train step.

Port of ``scripts/host_pipeline_41m.py``, with its flags, defaults and printed
lines. It generates a 41.3M-row synthetic dataset at the full-Criteo
cardinalities (the paper's row count) into the binary memmap layout of
:class:`..data.sharded_input.ShardedBinPipeline`, then:

1. measures the one-time CSV-to-arrays ingest rate of the native C++ loader
   (``native/dataloader``) on a sample shard, the offline-preprocessing leg;
2. streams one full training epoch through ``ShardedBinPipeline.epoch_batches``
   on the host and records rows/s;
3. with ``--card`` (``--tpu`` is kept as an alias), feeds the stream through
   ``data.batching.prefetch_to_device`` into ``train.trainer.train_step`` on the
   card, one step a batch, and reports the epoch's wall time against the same
   number of steps timed on one cached batch: the host pipeline keeps the card
   fed when the wall is within 15% of that budget. A second budget times the
   steps on the epoch's last batches, already on the card, so that the feed's
   share is also read against steps that differ only in having no feed.

The dataset goes to ``--dir`` (default ``synth41m_bin`` in the temporary
directory, which follows ``TMPDIR``); a complete set of ``--rows`` rows there
is reused, and a set of another size, or one left half written, is refused.

The port has no multi-step dispatch (the K-steps scan is not ported, see
``train/trainer.py``), so ``--k-steps`` is accepted and only sets how many
steps make one timed rep of the budget. :func:`generate` makes the script's
numpy draws in the script's order, so a seed gives the same ``.npy`` files,
bit for bit, in both packages.

Usage:
  python -m xsdeepfwfm_deprecated_torch.tools.host_pipeline_41m --rows 41300000
  python -m xsdeepfwfm_deprecated_torch.tools.host_pipeline_41m --card --max-steps 30000
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import time
import tempfile
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import ModelConfig, TrainConfig
from ..data import native_loader
from ..data.batching import prefetch_to_device
from ..data.sharded_input import ShardedBinPipeline
from ..device import DeviceLike, resolve_device
from ..models import deepfwfm
from ..train.trainer import make_optimizer, train_step
from .synthetic_scale_run import FULL_CRITEO_CAT_SIZES, _zipf_cdfs

BUDGET_REPS = 5          # timed reps of --k-steps steps on the last batch
H2D_BYTES = 256 << 20    # the bulk host-to-card probe: one pinned 256 MB buffer
H2D_REPS = 5


def generate(dirpath: str, rows: int, seed: int = 0, chunk: int = 1_000_000):
    """Chunked zipf-sampled full-Criteo-dims rows straight into the binary
    layout; returns the feature sizes. Labels come from a cheap planted
    linear logit: pipeline throughput is the subject here, not AUC."""
    n_num, n_cat = 13, 26
    cat_sizes = FULL_CRITEO_CAT_SIZES
    rng = np.random.default_rng(seed)
    w_num = (rng.normal(size=n_num) * 0.3).astype(np.float32)
    w_cat = [rng.normal(size=s).astype(np.float32) * 0.4 for s in cat_sizes]
    cdfs = _zipf_cdfs(cat_sizes)
    writer = ShardedBinPipeline.create(dirpath, rows, n_num, n_cat)
    t0 = time.time()
    for lo in range(0, rows, chunk):
        hi = min(rows, lo + chunk)
        n = hi - lo
        xi = np.empty((n, n_cat), np.int32)
        for f in range(n_cat):
            xi[:, f] = np.searchsorted(cdfs[f], rng.random(n)).astype(np.int32)
        xv = rng.normal(size=(n, n_num)).astype(np.float32)
        logit = xv @ w_num
        for f in range(n_cat):
            logit += w_cat[f][xi[:, f]]
        logit = logit * 1.2 - 1.1
        y = (rng.random(n) < 1.0 / (1.0 + np.exp(-logit))).astype(np.float32)
        writer["index"][lo:hi] = xi
        writer["value"][lo:hi] = xv
        writer["label"][lo:hi] = y
        print(f"  generated {hi:,}/{rows:,} rows "
              f"({hi / (time.time() - t0):,.0f} rows/s)", flush=True)
    for a in writer.values():
        a.flush()
    return [1] * n_num + cat_sizes


def default_dir() -> str:
    """``synth41m_bin`` in the temporary directory (``$TMPDIR``, else ``/tmp``)."""
    return os.path.join(tempfile.gettempdir(), "synth41m_bin")


def existing_set(dirpath: str, rows: int) -> Optional[List[int]]:
    """The feature sizes of the complete set of ``rows`` rows at ``dirpath``,
    or None where it holds no set. Raises on a set of another row count, or on
    one without ``feature_sizes.npy`` (written last, so its absence means that
    the generation did not finish)."""
    sizes_path = os.path.join(dirpath, "feature_sizes.npy")
    has_label = os.path.exists(os.path.join(dirpath, "label.npy"))
    if not has_label and not os.path.exists(sizes_path):
        return None
    if not (has_label and os.path.exists(sizes_path)):
        raise ValueError(f"{dirpath} holds a half-written dataset; remove it to regenerate")
    n = ShardedBinPipeline(dirpath).local_rows
    if n != rows:
        raise ValueError(f"{dirpath} holds {n:,} rows, not {rows:,}; remove it or pass --dir")
    return np.load(sizes_path).tolist()


def write_set(dirpath: str, rows: int) -> List[int]:
    """:func:`generate`, then ``feature_sizes.npy``, which marks the set whole."""
    sizes = generate(dirpath, rows)
    np.save(os.path.join(dirpath, "feature_sizes.npy"), np.asarray(sizes))
    return sizes


def native_ingest_rate(dirpath: str, sample_rows: int = 2_000_000) -> dict:
    """CSV to arrays through the native C++ loader on a sample shard (the
    offline leg: the reference's text format to binary)."""
    if not native_loader.available():
        return {"native_loader": "unavailable"}
    p = ShardedBinPipeline(dirpath)
    n = min(sample_rows, p.local_rows)
    csv_path = os.path.join(dirpath, "sample_shard.csv")
    lab = np.asarray(p.arrays["label"][:n])
    val = np.asarray(p.arrays["value"][:n])
    idx = np.asarray(p.arrays["index"][:n])
    mat = np.concatenate([lab[:, None], val, idx.astype(np.float32)], axis=1)
    np.savetxt(csv_path, mat, fmt="%.4g", delimiter=",")
    size_mb = os.path.getsize(csv_path) / 1e6
    t0 = time.time()
    label, value, index = native_loader.read_csv_arrays(csv_path, list(range(1, 14)))
    dt = time.time() - t0
    os.remove(csv_path)
    assert label.shape[0] == n
    return {"native_csv_rows_per_s": round(n / dt, 0),
            "native_csv_mb_per_s": round(size_mb / dt, 1)}


def host_stream_rate(dirpath: str, batch: int, seed: int = 3) -> dict:
    p = ShardedBinPipeline(dirpath)
    t0 = time.time()
    rows = 0
    for b in p.epoch_batches(batch, seed=seed, epoch=0):
        rows += b["label"].shape[0]
    dt = time.time() - t0
    return {"host_rows": rows, "host_epoch_s": round(dt, 1),
            "host_rows_per_s": round(rows / dt, 0)}


def model_config(feature_sizes) -> ModelConfig:
    """The flagship the script trains: DeepFwFM with lw+fwlw, E=10, 400^3."""
    return ModelConfig(field_size=39, feature_sizes=tuple(feature_sizes), numerical=13,
                       embedding_size=10, use_fwfm=True, use_deep=True, use_lw=True,
                       use_fwlw=True)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def h2d_rate(device: torch.device) -> Optional[float]:
    """GB/s (1e9 bytes) of a pinned bulk copy of 256 MB to ``device``; None
    on the CPU, which has no such copy."""
    if device.type != "cuda":
        return None
    src = torch.empty(H2D_BYTES, dtype=torch.uint8).pin_memory()
    dst = torch.empty(H2D_BYTES, dtype=torch.uint8, device=device)
    dst.copy_(src, non_blocking=True)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(H2D_REPS):
        dst.copy_(src, non_blocking=True)
    _sync(device)
    return round(H2D_BYTES * H2D_REPS / (time.perf_counter() - t0) / 1e9, 2)


def card_epoch(dirpath: str, feature_sizes, batch: int, k_steps: int, max_steps: int, *,
               mcfg: Optional[ModelConfig] = None, device: DeviceLike = None
               ) -> Tuple[dict, Dict]:
    """Feed the epoch's batches (``epoch_batches(batch, seed=4, epoch=0)``)
    through ``prefetch_to_device`` into one ``train_step`` each, until
    ``max_steps``; then time ``BUDGET_REPS * k_steps`` more steps on the last
    batch, already on the device, for the pure-step budget (the script's), and
    as many again over the loop's last ``BUDGET_REPS * k_steps`` batches, still
    on the device, in order and round again where the loop had fewer (the
    staged budget: the loop's own steps without the feed). Returns the
    script's keys (``tpu_`` renamed ``card_``, with ``h2d_gb_per_s``;
    ``card_step_ms_staged``, ``card_staged_budget_s`` and
    ``wall_over_staged_budget`` for the staged budget; ``card_feed_s``: host
    seconds the loop waited for its next batch, of which ``card_bin_s`` inside
    ``epoch_batches``; ``card_device`` names the device the steps ran on) and
    the trained parameters.
    ``mcfg`` defaults to :func:`model_config`; the parameters start from
    ``init_params`` seeded 0, dropout draws from a generator seeded 1."""
    device = resolve_device(device)
    mcfg = mcfg or model_config(feature_sizes)
    tcfg = TrainConfig(batch_size=batch, steps_per_call=k_steps)
    params = deepfwfm.init_params(torch.Generator().manual_seed(0), mcfg, device=device)
    opt = make_optimizer(tcfg)
    opt_state = opt.init(params)
    gen = torch.Generator(device=device).manual_seed(1)
    p = ShardedBinPipeline(dirpath)
    ones = np.ones(batch, np.float32)
    bin_s = 0.0

    def batches():
        nonlocal bin_s
        it = p.epoch_batches(batch, seed=4, epoch=0)
        while True:
            t = time.perf_counter()
            b = next(it, None)
            bin_s += time.perf_counter() - t
            if b is None:
                return
            yield {"xi": b["index"], "xv": b["value"], "y": b["label"], "mask": ones}

    n_budget = BUDGET_REPS * k_steps
    staged: collections.deque = collections.deque(maxlen=n_budget)
    steps, feed_s = 0, 0.0
    _sync(device)
    t0 = time.perf_counter()
    feed = prefetch_to_device(batches(), device, size=3)
    while steps < max_steps:
        t = time.perf_counter()
        g = next(feed, None)
        feed_s += time.perf_counter() - t
        if g is None:
            break
        train_step(params, opt_state, g, mcfg, tcfg, opt, generator=gen)
        staged.append(g)
        steps += 1
    _sync(device)
    wall = time.perf_counter() - t0
    if not staged:
        raise ValueError(f"{dirpath} holds no full batch of {batch} rows")

    def timed_steps(pick) -> float:
        t1 = time.perf_counter()
        for i in range(n_budget):
            train_step(params, opt_state, pick(i), mcfg, tcfg, opt, generator=gen)
        _sync(device)
        return (time.perf_counter() - t1) / n_budget

    step_s = timed_steps(lambda i: staged[-1])
    staged_s = timed_steps(lambda i: staged[i % len(staged)])
    budget, staged_budget = steps * step_s, steps * staged_s
    return {"card_steps": steps, "card_wall_s": round(wall, 1),
            "card_step_ms": round(step_s * 1e3, 2),
            "card_step_budget_s": round(budget, 1),
            "wall_over_budget": round(wall / budget, 3),
            "host_is_bottleneck": bool(wall > 1.15 * budget),
            "card_step_ms_staged": round(staged_s * 1e3, 2),
            "card_staged_budget_s": round(staged_budget, 1),
            "wall_over_staged_budget": round(wall / staged_budget, 3),
            "card_feed_s": round(feed_s, 1), "card_bin_s": round(bin_s, 1),
            "h2d_gb_per_s": h2d_rate(device),
            "card_device": (torch.cuda.get_device_name(device) if device.type == "cuda"
                            else device.type)}, params


def get_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=41_300_000)
    ap.add_argument("--dir", default=default_dir())
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--k-steps", type=int, default=8,
                    help="steps a timed rep of the budget (the port steps per batch)")
    ap.add_argument("--max-steps", type=int, default=2000)
    ap.add_argument("--card", "--tpu", dest="card", action="store_true",
                    help="feed the stream into the train step on the card")
    ap.add_argument("--skip-native", action="store_true")
    return ap


def main(argv=None, device: DeviceLike = None) -> dict:
    """Returns the ``RESULT`` dict, after printing the script's lines. With
    ``--card`` the device is resolved first: without a card it raises before
    any data is generated, unless ``device="cpu"``."""
    args = get_parser().parse_args(argv)
    if args.card:
        device = resolve_device(device)

    out = {"rows": args.rows}
    sizes = existing_set(args.dir, args.rows)
    if sizes is None:
        print(f"generating {args.rows:,} rows into {args.dir} ...", flush=True)
        sizes = write_set(args.dir, args.rows)

    if not args.skip_native:
        out.update(native_ingest_rate(args.dir))
        print(json.dumps(out), flush=True)

    out.update(host_stream_rate(args.dir, args.batch))
    print(json.dumps(out), flush=True)

    if args.card:
        out.update(card_epoch(args.dir, sizes, args.batch, args.k_steps, args.max_steps,
                              device=device)[0])
    print("RESULT " + json.dumps(out))
    return out


if __name__ == "__main__":
    main()
