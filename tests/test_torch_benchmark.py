"""The port's serving benchmark, timers, debugging hooks, analysis helpers and
latency-simulator binding against the JAX package, on the CPU.

``run_benchmark`` runs in both packages on the same carried-across parameters
and rows: the quality metrics agree to 1e-6 (float64 on the host, from logits
that agree to 1e-5) and the result has the JAX package's keys. Times are held
to being positive, finite numbers: on the CPU they are the host clock's.
"""

import importlib.util
import json
import logging
import shutil

import jax
import numpy as np
import pytest
import torch

from test_torch_serving import F_SIZES, NUM, _batch, _cfgs, _port
from xsdeepfwfm_deprecated_tpu.models import deepfwfm as JD
from xsdeepfwfm_deprecated_tpu.serving import benchmark as JB
from xsdeepfwfm_deprecated_tpu.serving import native_latency as JNL
from xsdeepfwfm_deprecated_tpu.serving.predictor import Predictor as JPredictor
from xsdeepfwfm_deprecated_tpu.utils import analysis as JA
from xsdeepfwfm_deprecated_tpu.utils import profiling as JP
from xsdeepfwfm_deprecated_torch.compression import quantization as TQ
from xsdeepfwfm_deprecated_torch.config import TrainConfig
from xsdeepfwfm_deprecated_torch.serving import benchmark as TB
from xsdeepfwfm_deprecated_torch.serving import native_latency as TNL
from xsdeepfwfm_deprecated_torch.serving.predictor import Predictor as TPredictor
from xsdeepfwfm_deprecated_torch.train import metrics as M
from xsdeepfwfm_deprecated_torch.train.trainer import DeepFMEstimator
from xsdeepfwfm_deprecated_torch.utils import analysis as TA
from xsdeepfwfm_deprecated_torch.utils import debug
from xsdeepfwfm_deprecated_torch.utils import profiling as TP

QUIET = logging.getLogger("test_torch_benchmark")
QUIET.propagate = False
FLAGS = dict(use_fwfm=True, use_deep=True, use_lw=True, use_fwlw=True)
QUALITY = ("loss", "auc", "prauc", "rce")
TIMES = ("batch_ms", "batch_onchip_ms", "examples_per_s", "examples_per_s_per_chip",
         "single_example_ms", "single_example_onchip_ms")
N, BATCH = 100, 32


def _rows(seed=1):
    xi, xv = _batch(F_SIZES, NUM, N, seed)
    y = (np.random.default_rng(seed).random(N) < 0.3).astype(np.float32)
    return xi, xv, y


@pytest.fixture(scope="module")
def both_results():
    """``run_benchmark`` of both packages on the flagship family at a small
    size, 100 rows, batches of 32 (a padded tail)."""
    jcfg, tcfg = _cfgs(**FLAGS)
    params = JD.init_params(jax.random.PRNGKey(0), jcfg)
    xi, xv, y = _rows()
    lines = []
    want = JB.run_benchmark(JPredictor(params, jcfg, layout="flat"), xi, xv, y,
                            batch_size=BATCH, n_single=5, logger=None)
    log = logging.getLogger("test_torch_benchmark.lines")
    log.propagate = False
    log.setLevel(logging.INFO)
    handler = logging.Handler()
    handler.emit = lambda record: lines.append(record.getMessage())
    log.addHandler(handler)
    got = TB.run_benchmark(TPredictor(_port(params), tcfg, device="cpu"), xi, xv, y,
                           batch_size=BATCH, n_single=5, logger=log)
    return got, want, lines


@pytest.mark.parametrize("key", QUALITY)
def test_quality_metrics_equal_the_jax_package(both_results, key):
    got, want, _ = both_results
    assert got[key] == pytest.approx(want[key], abs=1e-6)


def test_result_has_the_jax_key_set(both_results):
    """Every JAX key but ``bytes_accessed_per_batch`` (XLA's cost analysis has
    no counterpart; the key is optional there too), and no other. The CPU has
    no ``memory/`` keys in either package."""
    got, want, _ = both_results
    assert set(got) == set(want) - {"bytes_accessed_per_batch"}
    assert {*QUALITY, *TIMES} <= set(got)
    assert {k for k in got if k.startswith("component_ms/")} == {
        "component_ms/Embedding lookup (packed gather)",
        "component_ms/FwFM interaction (R-weighted pairs)",
        "component_ms/Deep tower (MLP)", "component_ms/Full forward"}
    assert not any(k.startswith("memory/") for k in got)


@pytest.mark.parametrize("key", TIMES + ("flops_per_batch",))
def test_times_and_flops_are_positive_numbers(both_results, key):
    got, _, _ = both_results
    assert np.isfinite(got[key]) and got[key] > 0
    if key == "flops_per_batch":
        # one batch of 32: the tower's three products, the FwFM contraction, the fwlw
        # term and the lw head
        f, e, h = len(F_SIZES), 4, 16
        assert got[key] == 2 * BATCH * (f * e * h + h * h + h + f * f * e + f * e + f)


def test_log_lines_keep_their_text(both_results):
    _, _, lines = both_results
    text = "\n".join(lines)
    for phrase in ("\tLoss: ", "\tAcc: ", "\tPRAUC: ", "\tRCE: ", "Op-level summary (batch 32)",
                   "Avg forward pass time per batch (ms):", "Throughput (examples/s, on-chip):",
                   "Throughput (examples/s/chip):", "Avg forward pass time (ms):",
                   "Device memory: no allocator stats on this backend"):
        assert phrase in text, phrase


def test_run_benchmark_writes_a_chrome_trace(tmp_path):
    _, tcfg = _cfgs(use_fm=True)
    params = JD.init_params(jax.random.PRNGKey(1), _cfgs(use_fm=True)[0])
    xi, xv, y = _rows()
    res = TB.run_benchmark(TPredictor(_port(params), tcfg, device="cpu"), xi[:20], xv[:20],
                           y[:20], batch_size=8, n_single=3, trace_dir=str(tmp_path / "tr"),
                           logger=QUIET)
    assert "component_ms/FM interaction (sum-of-squares)" in res
    with open(tmp_path / "tr" / TP.TRACE_FILE) as f:
        assert json.load(f)["traceEvents"]


@pytest.mark.parametrize("kind", ["dynamic", "compact"])
def test_run_benchmark_serves_the_other_model_kinds(kind):
    """A model that is no parameter dict has one row, the full forward."""
    from xsdeepfwfm_deprecated_torch.serving.compaction import compact_for_serving
    jcfg, tcfg = _cfgs(**FLAGS)
    params = _port(JD.init_params(jax.random.PRNGKey(0), jcfg))
    model = (TQ.convert(params, tcfg, "dynamic") if kind == "dynamic"
             else compact_for_serving(params, tcfg, int8=True))
    xi, xv, y = _rows()
    res = TB.run_benchmark(TPredictor(model, device="cpu"), xi, xv, y, batch_size=BATCH,
                           n_single=3, logger=QUIET)
    assert [k for k in res if k.startswith("component_ms/")] == ["component_ms/Full forward"]
    assert all(np.isfinite(res[k]) for k in QUALITY + TIMES)


def test_estimator_run_benchmark_and_the_qat_conversion():
    """``DeepFMEstimator.run_benchmark`` serves its parameters; a QAT model is
    converted with ``mode="qat"`` first, as the JAX estimator does."""
    _, tcfg = _cfgs(**FLAGS)
    xi, xv, y = _rows()
    est = DeepFMEstimator(tcfg, TrainConfig(n_epochs=1, batch_size=BATCH), logger=QUIET,
                          device="cpu")
    est.fit(xi, xv, y)
    res = est.run_benchmark(xi, xv, y, batch_size=BATCH, cuda=True)
    assert res["auc"] == pytest.approx(est.evaluate(xi, xv, y), abs=1e-6)
    assert "component_ms/Deep tower (MLP)" in res
    _, qcfg = _cfgs(quantization_aware=True, **FLAGS)
    qat = DeepFMEstimator(qcfg, est.tcfg, logger=QUIET, device="cpu")
    qat.fit(xi, xv, y)
    res_q = qat.run_benchmark(xi, xv, y, batch_size=BATCH)
    assert [k for k in res_q if k.startswith("component_ms/")] == ["component_ms/Full forward"]
    pred = TPredictor(TQ.convert(qat.params, qcfg, mode="qat"), device="cpu")
    # batch by batch, as the benchmark scores them: the activation scale is a batch's
    want = np.concatenate([pred.logits(xi[lo:lo + BATCH], xv[lo:lo + BATCH])
                           for lo in range(0, N, BATCH)])
    assert res_q["loss"] == pytest.approx(
        M.bce_logits_sum(y.astype(np.float64), want.astype(np.float64)) / N, abs=1e-9)
    same = est.run_benchmark(xi, xv, y, batch_size=BATCH, quantization_aware=True)
    assert [k for k in same if k.startswith("component_ms/")] == ["component_ms/Full forward"]


def test_memory_summary_is_empty_on_the_cpu():
    assert TB.memory_summary(torch.device("cpu")) == {}
    if not torch.cuda.is_available():
        assert TB.memory_summary() == {}


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs an NVIDIA GPU")
def test_memory_summary_on_the_card_has_the_jax_keys():
    mem = TB.memory_summary()
    assert set(mem) == {"bytes_in_use", "peak_bytes_in_use", "bytes_limit"}
    assert mem["bytes_limit"] >= mem["peak_bytes_in_use"] >= 0


# ---- utils/profiling

def test_span_names_equal_the_jax_package():
    names = [n for n in dir(JP) if n.startswith("SCOPE_")]
    assert len(names) == 6
    assert all(getattr(TP, n) == getattr(JP, n) for n in names)


def test_named_scope_is_a_profiler_span_and_trace_exports(tmp_path):
    """A span is recorded with the program's tracing on, which ``trace``
    turns on for its block, and ``trace`` writes it into its chrome trace
    beside the profiler's own events."""
    import json
    with TP.trace(None):                     # nothing asked, nothing written
        with TP.named_scope(TP.SCOPE_DEEP):
            pass
    assert not TP.enabled() and TP.spans() == []
    with TP.trace(str(tmp_path / "a" / "b")):
        with TP.named_scope(TP.SCOPE_DEEP):
            torch.ones(8).sum()
    events = json.loads((tmp_path / "a" / "b" / TP.TRACE_FILE).read_text())["traceEvents"]
    assert any(e.get("name") == TP.SCOPE_DEEP and e.get("cat") == "user_annotation"
               for e in events)
    assert any(e.get("cat") == "cpu_op" for e in events)


def test_simple_timeit_counts_calls_and_returns_seconds():
    calls = []
    t = TP.simple_timeit(lambda x: calls.append(x), 7, tries=4, warmup=2)
    assert calls == [7] * 6 and 0 <= t < 1.0


def _work(model, x, *rest):
    return (x @ model).sum()


def test_marginal_timeit_needs_k2_distinct_inputs():
    model = torch.ones(64, 64)
    inputs = [(torch.full((64, 64), float(i)),) for i in range(8)]
    t = TP.marginal_timeit(_work, model, inputs, k2=8, reps=3)
    assert 0 < t < 1.0
    with pytest.raises(AssertionError, match="needs >= k2=16 distinct inputs, got 8"):
        TP.marginal_timeit(_work, model, inputs)
    with pytest.raises(AssertionError):
        TP.marginal_timeit(_work, model, inputs, k1=8, k2=8)


def test_scan_timeit_runs_iters_forwards_and_takes_the_median():
    calls = []

    def fn(model, xi, xv):
        calls.append(1)
        return xv.sum()

    t = TP.scan_timeit(fn, None, torch.zeros(1, 2, dtype=torch.int32), torch.zeros(1, 3),
                       iters=10, reps=3)
    assert len(calls) == 1 + 3 * 10 and 0 < t < 1.0
    calls.clear()
    TP.scan_timeit(fn, None, torch.zeros(1, 2), torch.zeros(1, 3), iters=4, reps=1, warmup=False)
    assert len(calls) == 4


# ---- utils/debug

def test_nan_debugging_sets_and_restores_both_switches():
    assert not torch.is_anomaly_enabled() and not debug.finite_checks_enabled()
    with debug.nan_debugging(True):
        assert torch.is_anomaly_enabled() and debug.finite_checks_enabled()
        with debug.nan_debugging(False):
            assert not torch.is_anomaly_enabled() and not debug.finite_checks_enabled()
        assert torch.is_anomaly_enabled() and debug.finite_checks_enabled()
    assert not torch.is_anomaly_enabled() and not debug.finite_checks_enabled()
    with pytest.raises(KeyError):
        with debug.nan_debugging():
            raise KeyError("x")
    assert not torch.is_anomaly_enabled() and not debug.finite_checks_enabled()


@pytest.mark.filterwarnings("ignore:Error detected in")      # anomaly mode names the forward op
def test_fit_checks_the_loss_inside_nan_debugging():
    _, tcfg = _cfgs(**FLAGS)
    xi, xv, y = _rows()
    xv[40, 1] = np.nan
    make = lambda: DeepFMEstimator(tcfg, TrainConfig(n_epochs=1, batch_size=BATCH),
                                   logger=QUIET, device="cpu")
    with debug.nan_debugging(True):
        with pytest.raises((FloatingPointError, RuntimeError), match="non-finite|nan"):
            make().fit(xi, xv, y)
    est = make().fit(xi, xv, y)              # outside the block the NaN passes in silence
    assert not np.isfinite(est.last_epoch_losses).all()
    with debug.nan_debugging(True):          # a clean run trips nothing
        clean = make().fit(xi[:32], np.nan_to_num(xv[:32]), y[:32])
    assert np.isfinite(clean.last_epoch_losses).all()


def test_checkified_raises_on_a_non_finite_output():
    safe = debug.checkified(lambda x: (x.log(), x.long()))
    assert torch.equal(safe(torch.ones(3))[0], torch.zeros(3))
    with pytest.raises(FloatingPointError, match="non-finite"):
        safe(torch.tensor([1.0, -1.0]))
    with pytest.raises(FloatingPointError):
        debug.checkified(lambda x: 1.0 / x)(torch.zeros(2))


# ---- utils/analysis

@pytest.mark.parametrize("sparse_rate", [0.5, 0.9, 0.99])
def test_analysis_equals_the_jax_package(sparse_rate):
    assert TA.dnn_param_count(390, 400, 3) == JA.dnn_param_count(390, 400, 3) == 477_600
    assert TA.find_similar_dense_dnn(sparse_rate) == JA.find_similar_dense_dnn(sparse_rate)
    r = np.random.default_rng(0).normal(size=(6, 6))
    got, want = TA.plot_r_matrix(r), JA.plot_r_matrix(r)
    if isinstance(want, np.ndarray):         # no matplotlib: the symmetrized matrix
        assert np.array_equal(got, want) and np.array_equal(got, got.T)
    else:
        assert type(got) is type(want)


@pytest.mark.skipif(importlib.util.find_spec("pandas") is None, reason="pandas is not installed")
def test_save_memory_downcasts_as_the_jax_package():
    import pandas as pd
    frame = pd.DataFrame({"a": np.arange(4, dtype=np.int64), "b": np.ones(4, np.float64),
                          "c": np.ones(4, np.uint8), "d": np.ones(4, np.uint32)})
    got, want = TA.save_memory(frame.copy()), JA.save_memory(frame.copy())
    pd.testing.assert_frame_equal(got, want)
    assert [str(t) for t in got.dtypes] == ["int32", "float32", "int8", "int32"]


# ---- serving/native_latency

@pytest.mark.skipif(shutil.which("g++") is None, reason="no C++ compiler")
def test_native_latency_binding():
    assert TNL.MODELS == JNL.MODELS
    lr = TNL.latency_ms("lr", iters=50)
    dense = TNL.latency_ms("deepfwfm", iters=50)
    assert 0 < lr < dense
    assert TNL.batched_throughput(batch=64, iters=2) > 0
    assert set(TNL.thread_sweep(batch=256, iters=1, threads=(1, 2))) == {1, 2}
    assert set(TNL.sparsity_sweep(densities=(0.2, 0.05), iters=10)) == {0.2, 0.05}
    name = TNL.cpu_name()
    assert name and "NVIDIA" not in name       # a CPU's numbers carry a CPU's name
