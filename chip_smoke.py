#!/usr/bin/env python3
"""Serve the full-Criteo DeepFwFM flagship through the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--iters 200]

Phases, each printed on its own line:
  1. device: needs CUDA (exits non-zero without it); prints the card's name and power limit
  2. build: compiles every CUDA source of the port with nvcc into build/kernels/;
     prints registers, spills and how many clusters of the tower kernel the card holds
  3. model: the flagship at full width (1,326,055 packed rows, 39x10 -> 400^3 -> 1),
     seeded random weights and seeded requests
  4. fp32 serving: Predictor answers 3 requests at B=8192, 1 at B=1, 1 at B=1000;
     the B=8192 logits equal the port's CPU forward
  5. int8 serving: the same on the dynamic-int8 model; the fused tower kernel runs on
     the B=8192 requests only, and the logits equal the port's CPU int8 forward
  6. the tower's two kernels (the cluster kernel and the layered route) against the
     plain PyTorch version on the card: the main path's shape, one small cluster,
     and more tiles than the card holds clusters
  7. times (cluster kernel, layered route, plain version, library yardstick, bound), kernels per tower call, the cluster kernel's own
     clock readings, and Predictor examples/s, each beside the card's name and power limit
  8. one JSON line of per-kernel results
  9. last line: {"ok": true, "device": {...}}
Any failed check raises, so the script exits non-zero and prints no result.
It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and int8 tensor-core ops/s
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15
BATCH = 8192
REQUEST_SIZES = (BATCH, BATCH, BATCH, 1, 1000)
TOL = 1e-4   # fp32: float32 sums in another order; int8: epilogue rounding


def phase(n: int, msg: str) -> None:
    print(f"phase {n}: {msg}", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 10) -> float:
    """Median of per-call CUDA-event times, after a warm-up and a sync."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(iters)]
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def graph_ms(fn, per_graph: int = 20, replays: int = 10) -> float:
    """Device time of one call: ``per_graph`` calls captured into a CUDA graph
    and replayed, so that no host gap between launches is timed. Median over
    the replays of CUDA-event time / per_graph."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / per_graph)
    return statistics.median(times)


def host_ms(fn, iters: int, warmup: int = 3) -> float:
    """Median host-clock time of calls that end in a device sync."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def profile_top(fn, calls: int = 20, top: int = 8):
    """torch.profiler over ``calls`` calls: per call, the host time under the
    profiler, the summed time of device-side events (kernels, copies, memsets;
    host ops that launched them are left out, so nothing counts twice), and
    the device events that took the most time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3 / calls
    rows = sorted(events, key=lambda e: -e.self_device_time_total)[:top]
    return wall_ms, busy_ms, [(e.key[:60], e.self_device_time_total / 1e3 / calls,
                               e.count / calls) for e in rows]


def seeded_tower(in_dim: int, hidden, seed: int, device):
    """A per-channel int8 tower from seeded weights, packed for the kernels."""
    from xsdeepfwfm_deprecated_torch.ops import quantized as q_ops
    from xsdeepfwfm_deprecated_torch.ops.cuda.int8_mlp import pack_quantized_deep
    rng = np.random.default_rng(seed)
    dims = [in_dim] + list(hidden)
    layers = []
    for fi, fo in zip(dims[:-1], dims[1:]):
        w = torch.from_numpy((rng.normal(size=(fi, fo)) * (2.0 / (fi + fo)) ** 0.5)
                             .astype(np.float32))
        w_q, w_s = q_ops.quantize_symmetric(w, axis=1)
        bias = torch.from_numpy((rng.normal(size=(fo,)) * 0.1).astype(np.float32))
        layers.append({"w_q": w_q, "w_scale": w_s.reshape(-1), "b": bias})
    fc_q, fc_s = q_ops.quantize_symmetric(
        torch.from_numpy((rng.normal(size=(dims[-1], 1)) * 0.2).astype(np.float32)), axis=1)
    layers_q, fc = pack_quantized_deep({"layers": layers,
                                        "fc": {"w_q": fc_q, "w_scale": fc_s.reshape(-1)}})
    return (tuple(tuple(t.to(device) for t in layer) for layer in layers_q),
            tuple(t.to(device) for t in fc))


def tiles_with_different_scales(b: int, k: int, block_b: int, seed: int) -> torch.Tensor:
    x = np.random.default_rng(seed).normal(size=(b, k)).astype(np.float32)
    for i in range(b // block_b):
        x[i * block_b:(i + 1) * block_b] *= 0.5 + i
    return torch.from_numpy(x)


def make_requests(cfg, seed: int):
    """Seeded requests: categorical indices within each field's cardinality,
    normal numeric values."""
    rng = np.random.default_rng(seed)
    highs = list(cfg.feature_sizes[cfg.numerical:])
    return [(rng.integers(0, highs, size=(b, len(highs))).astype(np.int32),
             rng.normal(size=(b, cfg.numerical)).astype(np.float32)) for b in REQUEST_SIZES]


def int_mm_tower(x, layers_kn, fc_kn, fc_scale, block_b):
    """The fused tower's function with its products through torch._int_mm on
    the padded operands: a yardstick timed here, never used by the port."""
    b, width = x.shape[0], layers_kn[0][0].shape[0]
    n_tiles = b // block_b

    def codes(h):
        tiles = h.reshape(n_tiles, block_b, -1)
        amax = tiles.abs().amax(dim=(1, 2), keepdim=True).clamp(min=1e-12)
        s = amax / torch.full_like(amax, 127.0)
        return s, torch.round(tiles / s).clamp(-127, 127).to(torch.int8).reshape(b, -1)

    h = torch.nn.functional.pad(x, (0, width - x.shape[1]))
    for w_kn, w_scale, bias in layers_kn:
        s, q = codes(h)
        acc = torch._int_mm(q, w_kn).to(torch.float32).reshape(n_tiles, block_b, width)
        h = torch.relu(acc * s * w_scale + bias).reshape(b, width)
    s, q = codes(h)
    acc = torch._int_mm(q, fc_kn)[:, :1].to(torch.float32).reshape(n_tiles, block_b, 1)
    return (acc * s * fc_scale).reshape(b, 1)


def tower_bound(deep_q, b: int, in_bytes: int):
    """Least time of one tower call on the card: each input read once (x and
    the unpadded weights, scales, biases), the output written once, and the
    int8 operations of the unpadded products."""
    net = deep_q["net_1"]
    mats = [l["w_q"] for l in net["layers"]] + [net["fc"]["w_q"]]
    vecs = ([l["w_scale"] for l in net["layers"]] + [l["b"] for l in net["layers"]]
            + [net["fc"]["w_scale"]])
    n_bytes = in_bytes + b * 4 + sum(t.numel() * t.element_size() for t in mats + vecs)
    n_ops = sum(2 * b * m.shape[0] * m.shape[1] for m in mats)
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / INT8_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), n_bytes, n_ops


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=200, help="timed calls per kernel")
    args = ap.parse_args(argv)

    # ---- 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from xsdeepfwfm_deprecated_torch.compression.quantization import (
        convert, quantized_forward, quantized_lookup_serving)
    from xsdeepfwfm_deprecated_torch.entry import flagship_config
    from xsdeepfwfm_deprecated_torch.models import deepfwfm
    from xsdeepfwfm_deprecated_torch.ops.cuda import _build
    from xsdeepfwfm_deprecated_torch.ops.cuda.int8_mlp import (
        int8_mlp, int8_mlp_reference, max_active_clusters, prof_steps, tower_route,
        untile_weight)
    from xsdeepfwfm_deprecated_torch.ops.embedding import packed_lookup_serving
    from xsdeepfwfm_deprecated_torch.serving.predictor import Predictor
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    phase(1, f"device {kind}, count {torch.cuda.device_count()}, torch {torch.__version__}, "
             f"cuda {torch.version.cuda}")
    print(card, flush=True)

    # ---- 2. build
    t0 = time.perf_counter()
    logs = _build.build()
    libs = {name: _build.load(name) for name in _build.sources()}
    phase(2, f"built {sorted(libs)} in {time.perf_counter() - t0:.2f} s (nvcc, sm_90a)")
    for name, log in logs.items():
        for line in log.splitlines():
            if "Used" in line or "spill" in line or "error" in line.lower():
                print(f"  {name}: {line.strip()}")
    n_clusters, smem = max_active_clusters(416, 512)
    print(f"  tower kernel at W=416: {smem} bytes of dynamic shared memory a block, the card "
          f"holds {n_clusters} clusters of 8 blocks at once (B={BATCH} is {BATCH // 512})")

    # ---- 3. model
    cfg = flagship_config(full_criteo=True)
    params_cpu = deepfwfm.init_params(torch.Generator().manual_seed(args.seed), cfg, device="cpu")
    reqs = make_requests(cfg, args.seed + 1)
    rows = params_cpu["emb2"]["dense"].shape[0]
    check(rows == 1_326_055, f"flagship has {rows} packed rows")
    phase(3, f"flagship {cfg.model_name}: {rows} packed rows, E={cfg.embedding_size}, "
             f"tower {cfg.field_size * cfg.embedding_size}->{'x'.join(map(str, cfg.deep_layers))}"
             f"->1, {deepfwfm.param_count(params_cpu)} params, requests {list(REQUEST_SIZES)}")

    # ---- 4-5. the main path: fp32 then int8 serving, through the Predictor
    int8_mlp.launches = 0
    pred = Predictor(params_cpu, cfg)
    fp32_out = []
    for xi, xv in reqs:
        out = pred.logits(xi, xv)
        check(out.shape == (xi.shape[0],) and np.isfinite(out).all(), "fp32 logits not finite")
        fp32_out.append(out)
    check(int8_mlp.launches == 0, "fp32 serving launched the int8 tower")
    want = Predictor(params_cpu, cfg, device="cpu").logits(*reqs[0])
    err = float(np.abs(fp32_out[0] - want).max())
    np.testing.assert_allclose(fp32_out[0], want, rtol=TOL, atol=TOL)
    phase(4, f"fp32 serving: {len(reqs)} requests, B=8192 logits vs CPU max |diff| {err:.3e}")

    qm_cpu = convert(params_cpu, cfg, "dynamic")
    pred_q = Predictor(qm_cpu)
    int8_out = []
    for xi, xv in reqs:
        before = int8_mlp.launches
        out = pred_q.logits(xi, xv)
        check(out.shape == (xi.shape[0],) and np.isfinite(out).all(), "int8 logits not finite")
        fused = xi.shape[0] % 512 == 0
        check(int8_mlp.launches == before + int(fused),
              f"B={xi.shape[0]}: int8 tower launches {before} -> {int8_mlp.launches}")
        int8_out.append(out)
    launches = int8_mlp.launches
    check(launches == 3, f"int8 tower launched {launches} times on the main path")
    xi_t, xv_t = (torch.from_numpy(a) for a in reqs[0])
    want = quantized_forward(qm_cpu, xi_t, xv_t, use_fused_kernel=True).numpy()
    err_q = float(np.abs(int8_out[0] - want).max())
    np.testing.assert_allclose(int8_out[0], want, rtol=0, atol=TOL)
    phase(5, f"int8 serving: {len(reqs)} requests, tower launches {launches}, "
             f"B=8192 logits vs CPU max |diff| {err_q:.3e}, "
             f"model {qm_cpu.size_bytes()} bytes")

    # ---- 6. both kernels against the plain version on the card
    dev = pred_q.device
    qm = pred_q._model
    spec = deepfwfm.make_embedding_spec(cfg)
    xi_d, xv_d = xi_t.to(dev), xv_t.to(dev)
    with torch.inference_mode():
        x = quantized_lookup_serving(qm.emb2_q, spec, xi_d, xv_d).reshape(BATCH, -1)
        x = x.contiguous()
        layers, fc = qm.fused_tower
        width = layers[0][0].shape[1]
        check(tower_route(width, 512, len(layers)) == "cluster", "the main path's route")
        plain = int8_mlp_reference(x, layers, fc)
        errs = {}
        for route in ("cluster", "layered"):
            got = int8_mlp(x, layers, fc, route=route)
            torch.cuda.synchronize()
            errs[route] = float((got - plain).abs().max())
        max_err, layered_err = errs["cluster"], errs["layered"]
        check(max(errs.values()) <= TOL, f"int8_mlp vs plain version: max |diff| {errs}")
        shapes = [f"main path B={BATCH} block_b=512 (16 clusters of 8): cluster {max_err:.3e} "
                  f"layered {layered_err:.3e}"]
        for in_dim, hidden, b, block_b in ((50, [40, 40], 256, 128),
                                           (390, [400, 400, 400], 2 * BATCH, 512)):
            layers_s, fc_s = seeded_tower(in_dim, hidden, args.seed + 2, dev)
            x_s = tiles_with_different_scales(b, in_dim, block_b, args.seed + 3).to(dev)
            plain_s = int8_mlp_reference(x_s, layers_s, fc_s, block_b=block_b)
            line = f"B={b} block_b={block_b} ({b // block_b} clusters of {block_b // 64}):"
            for route in ("cluster", "layered"):
                got = int8_mlp(x_s, layers_s, fc_s, block_b=block_b, route=route)
                torch.cuda.synchronize()
                err = float((got - plain_s).abs().max())
                check(err <= TOL, f"{line} {route} vs plain version: max |diff| {err}")
                line += f" {route} {err:.3e}"
            shapes.append(line)
        layers_kn = tuple((untile_weight(w).T.contiguous(), s, b) for w, s, b in layers)
        fc_kn = torch.zeros((fc[0].shape[0], 8), dtype=torch.int8, device=dev)
        fc_kn[:, 0] = fc[0]
        lib = int_mm_tower(x, layers_kn, fc_kn, fc[1], 512)
        lib_err = float((lib - plain).abs().max())
        check(lib_err <= TOL, f"torch._int_mm tower vs plain version: max |diff| {lib_err}")
        # the cluster route allocates its output and nothing else
        peaks = {}
        for route in ("cluster", "layered"):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            int8_mlp(x, layers, fc, route=route)
            torch.cuda.synchronize()
            peaks[route] = torch.cuda.max_memory_allocated() - before
        check(peaks["cluster"] <= BATCH * 4 + 512, f"cluster route allocated {peaks['cluster']} B")
    phase(6, f"int8_mlp vs plain version on the card, max |diff| (tol {TOL}; torch._int_mm "
             f"yardstick {lib_err:.3e}):")
    for line in shapes:
        print(f"  {line}")
    print(f"  memory a tower call allocates: cluster route {peaks['cluster']} B (the output), "
          f"layered route {peaks['layered']} B")

    # ---- 7. times
    def tower(route):
        return lambda: int8_mlp(x, layers, fc, route=route)

    with torch.inference_mode():
        # device time by graph replay, the two routes in turns
        k_ms = graph_ms(tower("cluster"))
        layered_ms = graph_ms(tower("layered"))
        k_ms = min(k_ms, graph_ms(tower("cluster")))
        layered_ms = min(layered_ms, graph_ms(tower("layered")))
        one_wave = graph_ms(lambda: int8_mlp(x[:BATCH - 512], layers, fc, route="cluster"))
        one_wave_layered = graph_ms(lambda: int8_mlp(x[:BATCH - 512], layers, fc,
                                                     route="layered"))
        # one launch at a time between CUDA events: host gaps included
        k_ev = cuda_ms(tower("cluster"), args.iters)
        layered_ev = cuda_ms(tower("layered"), args.iters)
        p_ms = cuda_ms(lambda: int8_mlp_reference(x, layers, fc), max(args.iters // 4, 10))
        l_ms = cuda_ms(lambda: int_mm_tower(x, layers_kn, fc_kn, fc[1], 512),
                       max(args.iters // 4, 10))
        kernels_per_call = {}
        for route in ("cluster", "layered"):
            _, _, top = profile_top(tower(route), calls=10, top=100)
            kernels_per_call[route] = sum(count for _, _, count in top)
        prof = torch.zeros(64, dtype=torch.int64, device=dev)
        for _ in range(3):
            int8_mlp(x, layers, fc, route="cluster", prof=prof)
        torch.cuda.synchronize()
        steps = prof_steps(len(layers))
        clocks = prof.cpu().tolist()[:len(steps)]
        look_ms = cuda_ms(lambda: quantized_lookup_serving(qm.emb2_q, spec, xi_d, xv_d),
                          args.iters)
        fwd_q_ms = cuda_ms(lambda: quantized_forward(qm, xi_d, xv_d, use_fused_kernel=True),
                           args.iters // 4)
        fwd_ms = cuda_ms(lambda: deepfwfm.forward(pred._model, xi_d, xv_d, cfg,
                                                  lookup_fn=packed_lookup_serving),
                         args.iters // 4)
    check(kernels_per_call["cluster"] == 1, f"kernels per tower call: {kernels_per_call}")
    bound_ms, bound_by, n_bytes, n_ops = tower_bound(qm.deep_q, BATCH, x.numel() * 4)
    e2e_fp32 = host_ms(lambda: pred.logits(*reqs[0]), 20)
    e2e_int8 = host_ms(lambda: pred_q.logits(*reqs[0]), 20)
    one_fp32 = host_ms(lambda: pred.logits(*reqs[3]), 50)
    one_int8 = host_ms(lambda: pred_q.logits(*reqs[3]), 50)
    where = f"[{card}]"
    phase(7, f"times, B={BATCH} {where}")
    print(f"  tower, device time (CUDA-graph replay of 20 calls, median of 10): cluster kernel "
          f"{k_ms:.4f} ms | layered route {layered_ms:.4f} ms | "
          f"at B={BATCH - 512} (one wave of clusters): cluster kernel {one_wave:.4f} ms, layered "
          f"route {one_wave_layered:.4f} ms {where}")
    print(f"  tower, one launch between CUDA events (median of {args.iters}, host gaps "
          f"included): cluster kernel {k_ev:.4f} ms | layered route {layered_ev:.4f} ms | plain "
          f"{p_ms:.4f} ms | torch._int_mm chain {l_ms:.4f} ms {where}")
    print(f"  bound {bound_ms:.5f} ms by {bound_by} ({n_bytes} B, {n_ops} int8 ops); kernels per "
          f"tower call: cluster route {kernels_per_call['cluster']:g}, layered route "
          f"{kernels_per_call['layered']:g} (memset included) {where}")
    print(f"  cluster kernel, SM clock of its first block, {clocks[-1] - clocks[0]} cycles "
          f"from first to last reading {where}:")
    for i in range(1, len(steps)):
        print(f"    {clocks[i] - clocks[i - 1]:7d}  {steps[i]}")
    print(f"  device forward: fp32 {fwd_ms:.4f} ms, int8 {fwd_q_ms:.4f} ms "
          f"(int8 lookup {look_ms:.4f} ms, tower {k_ev:.4f} ms) {where}")
    print(f"  Predictor.logits end to end (host clock, H2D+D2H included): "
          f"fp32 {e2e_fp32:.3f} ms = {BATCH / e2e_fp32 * 1e3:.0f} ex/s, "
          f"int8 {e2e_int8:.3f} ms = {BATCH / e2e_int8 * 1e3:.0f} ex/s {where}")
    print(f"  Predictor.logits at B=1 (host clock, median of 50): fp32 {one_fp32:.3f} ms, "
          f"int8 {one_int8:.3f} ms {where}")
    for name, pred_x in (("fp32", pred), ("int8", pred_q)):
        wall, busy, top = profile_top(lambda: pred_x.logits(*reqs[0]))
        print(f"  profile {name} Predictor.logits: {wall:.3f} ms per call under the profiler, "
              f"kernels {busy:.3f} ms ({busy / wall:.0%} busy) {where}")
        for key, ms, count in top:
            print(f"    {ms:.4f} ms  x{count:g}  {key}")
        if name == "int8":
            tower_rows = [(key, count) for key, _, count in top if "tower_kernel" in key]
            check(len(tower_rows) == 1 and tower_rows[0][1] == 1,
                  f"the int8 request's tower is not one kernel per call: {tower_rows}")
            check(not any("gemm_kernel" in key or "Memset" in key for key, _, _ in top),
                  "the int8 request still runs the layered route")

    # ---- 8-9. result lines
    kernels = [{
        "name": "int8_mlp", "route": "cuda",
        "source": "xsdeepfwfm_deprecated_torch/csrc/int8_mlp.cu",
        "replaces": "xsdeepfwfm_deprecated_tpu/ops/pallas/int8_mlp.py:26",
        "launches": launches, "max_abs_err": max_err, "max_abs_diff": max_err,
        "ms": k_ms, "kernel_ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": l_ms,
        "layered_ms": layered_ms, "layered_max_abs_err": layered_err,
        "kernels_per_call": kernels_per_call["cluster"],
        "layered_kernels_per_call": kernels_per_call["layered"],
        "one_wave_ms": one_wave, "one_wave_layered_ms": one_wave_layered,
        "event_ms": k_ev, "layered_event_ms": layered_ev}]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
