"""Serving as a ranking service calls the port: one caller, each request sent
when the last one's reply is in.

Each request is one ``serving.predictor.Predictor.logits`` call with host
numpy in and host numpy out, on ``batch`` rows. Requests cycle through a pool
of ``pool_requests`` distinct requests drawn from the seed, held in pageable
memory as callers hold them. ``precision`` ``fp32`` serves the fp32
parameters; ``int8-dynamic`` serves ``compression.quantization.convert(params,
cfg, "dynamic")``, whose tower runs the fused int8 kernel where the batch is a
multiple of its tile.

Set-up makes the weights, the model and the pool and answers ``WARM``
requests (the first captures the request's graph and, on a checkout's first
run, builds the kernel). The window runs for ``--seconds``; every request's
latency is kept, and the answers at positions drawn from the seed (one in
about ``sample_every``) are kept for the check. With ``--trace 1`` the window
is followed by the forward alone on device-resident copies of the pool, the
int8 tower alone on its real input, and a profiled stretch of requests.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from xsdeepfwfm_deprecated_torch.compression.quantization import (convert,
                                                                  quantized_lookup_serving)
from xsdeepfwfm_deprecated_torch.models import deepfwfm
from xsdeepfwfm_deprecated_torch.ops.cuda.int8_mlp import int8_mlp
from xsdeepfwfm_deprecated_torch.serving.predictor import Predictor

from .. import compare, generator, program, weights
from ..harness import Context, Record, profile, sync
from ..reference import model as ref_model

WARM = 20
TOWER_CALLS, TOWER_REPLAYS = 20, 10
SAMPLE_LIMIT = 10 ** 8
REF_ROWS = 1 << 16          # rows of one block of the fp32 reference


def _timed_replays(pred: Predictor, xi_d: torch.Tensor, xv_d: torch.Tensor, n: int) -> float:
    """Device ms of one ``Predictor.replay`` on device-resident requests."""
    a, z = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for i in range(n):
        pred.replay(xi_d[i % len(xi_d)], xv_d[i % len(xv_d)])
    z.record()
    sync(xi_d.device)
    return a.elapsed_time(z) / n


def _tower_ms(model, cfg, xi_d: torch.Tensor, xv_d: torch.Tensor, tile: int) -> float:
    """Device ms of one int8 tower call as ``quantized_forward`` makes it, on
    the tower's real input for a pool request: a CUDA graph of
    ``TOWER_CALLS`` calls, the median of ``TOWER_REPLAYS`` replays."""
    spec = deepfwfm.make_embedding_spec(cfg)
    x = quantized_lookup_serving(model.emb2_q, spec, xi_d, xv_d).reshape(xi_d.shape[0], -1)
    x = x.contiguous()
    layers_q, fc_q = model.fused_tower
    stream = torch.cuda.Stream(x.device)
    stream.wait_stream(torch.cuda.current_stream(x.device))
    with torch.cuda.stream(stream):
        int8_mlp(x, layers_q, fc_q, block_b=tile)
    torch.cuda.current_stream(x.device).wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(TOWER_CALLS):
            int8_mlp(x, layers_q, fc_q, block_b=tile)
    times = []
    for _ in range(TOWER_REPLAYS):
        a, z = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        z.record()
        sync(x.device)
        times.append(a.elapsed_time(z) / TOWER_CALLS)
    return float(np.median(times))


def _reference(w, cfg: Dict, tr: Dict, xi: np.ndarray, xv: np.ndarray, kept: List[Tuple],
               dev, precision: str) -> List[torch.Tensor]:
    """The reference's logits of each kept answer's request. ``precision``
    ``fp32`` or ``tf32`` for fp32 serving, ``int8`` or ``int4`` for int8."""
    if tr["precision"] == "int8-dynamic":
        qmax = {"int8": 127, "int4": 7}[precision]
        by_request = {}
        for k in sorted({k for k, _ in kept}):
            by_request[k] = ref_model.int8_forward(
                w, cfg, torch.from_numpy(xi[k]).to(dev), torch.from_numpy(xv[k]).to(dev),
                tile_rows=tr["int8_tile_rows"], qmax=qmax)
        return [by_request[k] for k, _ in kept]
    rows_i = np.stack([xi[k] for k, _ in kept]).reshape(-1, xi.shape[-1])
    rows_v = np.stack([xv[k] for k, _ in kept]).reshape(-1, xv.shape[-1])
    out = torch.cat([ref_model.forward(w, cfg, torch.from_numpy(rows_i[i:i + REF_ROWS]).to(dev),
                                       torch.from_numpy(rows_v[i:i + REF_ROWS]).to(dev),
                                       precision=precision)
                     for i in range(0, len(rows_i), REF_ROWS)])
    return list(out.reshape(len(kept), -1))


def run(ctx: Context) -> Record:
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    rec = Record()
    mcfg = program.model_config(cfg)
    b, pool = tr["batch"], tr["pool_requests"]
    int8 = tr["precision"] == "int8-dynamic"
    if tr["precision"] not in ("fp32", "int8-dynamic"):
        raise ValueError(f"unknown precision {tr['precision']!r}")
    params = program.params(mcfg, weights.make(cfg, ctx.seed, dev))
    model = convert(params, mcfg, "dynamic") if int8 else params
    if int8:
        del params
    pred = Predictor(model, None if int8 else mcfg, device=dev)
    ctx.stage("weights")
    xi, xv, _ = generator.sample_rows(cfg, tr, b * pool, ctx.seed, dev)
    xi, xv = xi.reshape(pool, b, -1), xv.reshape(pool, b, -1)
    ctx.stage("pool")
    for k in range(WARM):
        pred.logits(xi[k % pool], xv[k % pool])
    sync(dev)
    ctx.stage("warm")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    positions = generator.sample_positions(ctx.seed, tr["sample_every"], SAMPLE_LIMIT)
    rec.setup_s = time.perf_counter() - ctx.started

    lat: List[float] = []
    kept: List[Tuple[int, np.ndarray]] = []
    i, s, nxt = 0, 0, positions[0]
    t0 = t = time.perf_counter()
    while t - t0 < ctx.seconds:
        k = i % pool
        ts = time.perf_counter()
        out = pred.logits(xi[k], xv[k])
        t = time.perf_counter()
        lat.append(t - ts)
        if i == nxt:
            kept.append((k, out))
            s += 1
            nxt = positions[s]
        i += 1
    rec.window_s = t - t0
    if not kept:        # a window shorter than the first sampled position
        kept.append((k, out))
    rec.attempted, rec.examples, rec.latencies_s = i, i * b, lat
    rec.failed = sum(int(not np.isfinite(o).all()) for _, o in kept)
    if dev.type == "cuda":
        rec.memory_peak_bytes = int(torch.cuda.max_memory_allocated(dev))

    if ctx.trace:
        if dev.type == "cuda":
            xi_d, xv_d = torch.from_numpy(xi).to(dev), torch.from_numpy(xv).to(dev)
            n = max(100, min(2000, 2_000_000 // b))
            rec.device_ms["forward"] = [_timed_replays(pred, xi_d, xv_d, n)]
            if int8:
                rec.device_ms["int8_tower"] = [_tower_ms(model, mcfg, xi_d[0], xv_d[0],
                                                         tr["int8_tile_rows"])]
            del xi_d, xv_d

        traced = max(50, min(500, 1_000_000 // b))

        def stretch():
            for j in range(traced):
                pred.logits(xi[j % pool], xv[j % pool])
        profile(stretch, traced, dev, rec)

    del pred, model
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the reference, on the same weights and requests
    w = weights.make(cfg, ctx.seed, dev)
    ref_model.no_tf32()
    outs = [torch.from_numpy(o) for _, o in kept]
    low = ("int8", "int4") if int8 else ("fp32", "tf32")
    ref = _reference(w, cfg, tr, xi, xv, kept, dev, low[0])
    rec.checks = {"logit_gap": compare.logit_gap(outs, ref)}
    if ctx.control:
        ctrl = _reference(w, cfg, tr, xi, xv, kept, dev, low[1])
        rec.control_checks = {"logit_gap": compare.logit_gap(ctrl, ref)}
    rec.info["answers_checked"] = len(kept)
    rec.info["setup_stages"] = ctx.stages
    return rec
