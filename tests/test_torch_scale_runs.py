"""The quality-at-scale tools (``xsdeepfwfm_deprecated_torch.tools``) against
the scripts of ``scripts/`` that they port, on the CPU at small sizes.

The scripts are loaded by path here, in the test only: the port never
imports them. Where a script trains, both sides start from the same
parameters (the port's init, handed to the JAX package as arrays) with
dropout off, patched here: the two packages draw their dropout from
different generators.
"""

import contextlib
import dataclasses
import functools
import importlib.util
import io
import json
import logging
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train import j_leaves
from xsdeepfwfm_deprecated_tpu import config as jconfig
from xsdeepfwfm_deprecated_tpu.models import deepfwfm as JD
from xsdeepfwfm_deprecated_tpu.models import nfm as JNFM
from xsdeepfwfm_deprecated_tpu.train import checkpoint as jckpt
from xsdeepfwfm_deprecated_tpu.train import trainer as JT
from xsdeepfwfm_deprecated_tpu.utils import profiling as JProf
from xsdeepfwfm_deprecated_torch import weights
from xsdeepfwfm_deprecated_torch.config import ModelConfig as TConfig
from xsdeepfwfm_deprecated_torch.models import deepfwfm as TD
from xsdeepfwfm_deprecated_torch.models import nfm as TNFM
from xsdeepfwfm_deprecated_torch.models.nfm import NFMConfig as TNFMConfig
from xsdeepfwfm_deprecated_torch.tools import int8_auc_parity as t_parity
from xsdeepfwfm_deprecated_torch.tools import kd_scale_run as t_kd
from xsdeepfwfm_deprecated_torch.tools import nfm_scale_run as t_nfm
from xsdeepfwfm_deprecated_torch.tools import pruned_serving_bench as t_bench
from xsdeepfwfm_deprecated_torch.tools import qr_scale_run as t_qr
from xsdeepfwfm_deprecated_torch.tools import synthetic_scale_run as t_syn
from xsdeepfwfm_deprecated_torch.train import trainer as TT

REPO = pathlib.Path(__file__).resolve().parents[1]
NO_DROPOUT = dict(is_shallow_dropout=False, is_deep_dropout=False)
ROWS = 4000          # n_test = 1,000 rows each for test and valid, 2,000 to train
SMALL = ["--rows", str(ROWS), "--epochs", "2", "--batch", "256", "--emb-size", "4",
         "--deep-nodes", "16"]
for _name in ("xsdeepfwfm_tpu", "xsdeepfwfm_torch"):     # the fits' per-epoch logs
    logging.getLogger(_name).setLevel(logging.WARNING)


def load_script(name):
    """``scripts/<name>.py`` as a module; its ``sys.path`` inserts are undone."""
    saved = list(sys.path)
    sys.path.insert(0, str(REPO / "scripts"))       # nfm_scale_run imports its sibling
    try:
        spec = importlib.util.spec_from_file_location(f"scripts_{name}",
                                                      REPO / "scripts" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = saved
    return mod


@pytest.fixture(scope="module")
def jsyn():
    return load_script("synthetic_scale_run")


@pytest.fixture(scope="module")
def data():
    return t_syn.make_synthetic(ROWS, 0)


def run_script(mod, argv, monkeypatch):
    """The script's ``main()`` under ``argv``; returns what it printed."""
    monkeypatch.setattr(sys, "argv", [mod.__file__] + list(argv))
    monkeypatch.syspath_prepend(str(REPO))        # pruned_serving_bench imports __graft_entry__
    monkeypatch.setattr("xsdeepfwfm_deprecated_tpu.utils.enable_compilation_cache",
                        lambda *a, **k: None)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        mod.main()
    return out.getvalue()


def printed(fn, *args, **kw):
    """(return value, printed text) of ``fn``."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ret = fn(*args, **kw)
    return ret, out.getvalue()


def json_lines(text, prefix=""):
    return [json.loads(line[len(prefix):]) for line in text.splitlines()
            if line.startswith(prefix + "{")]


def with_defaults(cls, **fixed):
    """``cls`` with some fields fixed: keyword construction only."""
    return lambda **kw: cls(**{**fixed, **kw})


@pytest.fixture
def same_init(monkeypatch):
    """Every estimator of either package takes the port's init of its model
    (drawn on the CPU from the estimator's seed: the JAX package's own init
    of these tables takes seconds), JAX's as ``jnp`` arrays; every model the
    tools build has its dropout off. Returns the fitted estimators, JAX's and
    the port's, in order."""
    fitted = []
    j_fit, t_fit = JT.DeepFMEstimator.fit, TT.DeepFMEstimator.fit
    port_init = {JD.init_params: (TD.init_params, TConfig),
                 JNFM.init_params: (TNFM.init_params, TNFMConfig)}

    def init_j(self, seed=None):
        init, cls = port_init[type(self).model_init]
        # the JAX config's fields: the port's own (xDeepFM's) keep their defaults
        cfg = cls(**{f.name: getattr(self.mcfg, f.name) for f in dataclasses.fields(self.mcfg)})
        gen = torch.Generator().manual_seed(self.tcfg.random_seed if seed is None else seed)
        self.params = jax.tree.map(jnp.asarray,
                                   weights.params_to_numpy(init(gen, cfg, device="cpu")))
        return self.params

    def fit_j(self, *a, **k):
        fitted.append(self)
        return j_fit(self, *a, **k)

    def fit_t(self, *a, **k):
        fitted.append(self)
        return t_fit(self, *a, **k)

    monkeypatch.setattr(JT.DeepFMEstimator, "init_params", init_j)
    monkeypatch.setattr(JT.DeepFMEstimator, "fit", fit_j)
    monkeypatch.setattr(TT.DeepFMEstimator, "fit", fit_t)
    monkeypatch.setattr(jconfig, "ModelConfig", with_defaults(jconfig.ModelConfig, **NO_DROPOUT))
    monkeypatch.setattr(JNFM, "NFMConfig", with_defaults(JNFM.NFMConfig, **NO_DROPOUT))
    monkeypatch.setattr(t_syn, "ModelConfig", with_defaults(TConfig, **NO_DROPOUT))
    monkeypatch.setattr(t_nfm, "NFMConfig", with_defaults(TNFMConfig, **NO_DROPOUT))
    return fitted


@pytest.fixture
def evals(monkeypatch):
    """Every ``eval_by_batch`` result, (loss, auc, prauc, rce), of each package."""
    got = {"jax": [], "port": []}
    for side, cls in (("jax", JT.DeepFMEstimator), ("port", TT.DeepFMEstimator)):
        def wrapped(self, *a, _orig=cls.eval_by_batch, _into=got[side]):
            res = _orig(self, *a)
            _into.append(res)
            return res
        monkeypatch.setattr(cls, "eval_by_batch", wrapped)
    return got


# ---------------------------------------------------------------- (1) the data

@pytest.mark.parametrize("kw", [dict(full_dims=False), dict(full_dims=True),
                                dict(full_dims=True, shape="avazu")],
                         ids=["criteo-random-dims", "criteo-full-dims", "avazu-full-dims"])
def test_make_synthetic_equals_the_script_bit_for_bit(jsyn, kw):
    want = jsyn.make_synthetic(5000, 0, **kw)
    got = t_syn.make_synthetic(5000, 0, **kw)
    for name, g, w in zip(("xi", "xv", "y", "feature_sizes", "logit", "kept"), got, want):
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and np.array_equal(g, w), name
        else:
            assert g == w, name
    assert t_syn.oracle_auc(got[4], got[2]) == pytest.approx(jsyn.oracle_auc(want[4], want[2]),
                                                             rel=0, abs=1e-12)


def test_cache_written_by_either_package_is_read_by_the_other(jsyn, tmp_path, monkeypatch):
    """Each ``main`` writes its cache and reads the other's: the arrays that
    reach ``train_one`` are equal, and so are the npz's keys and dtypes."""
    seen = []

    def stub(xi, xv, y, feature_sizes, n_test, args, **kw):
        seen.append((xi, xv, y, list(feature_sizes), n_test))
        return {}

    monkeypatch.setattr(jsyn, "train_one", stub)
    monkeypatch.setattr(t_syn, "train_one", stub)
    j_cache, t_cache = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    argv = ["--rows", "3000", "--full-criteo-dims", "--seed", "3"]
    run_script(jsyn, argv + ["--cache", j_cache], monkeypatch)            # JAX writes
    printed(t_syn.main, argv + ["--cache", t_cache], device="cpu")        # the port writes
    printed(t_syn.main, argv + ["--cache", j_cache], device="cpu")        # the port reads JAX's
    run_script(jsyn, argv + ["--cache", t_cache], monkeypatch)            # JAX reads the port's
    assert len(seen) == 4
    for other in seen[1:]:
        for a, b in zip(seen[0], other):
            assert (np.array_equal(a, b) and a.dtype == b.dtype) if isinstance(a, np.ndarray) \
                else a == b
    with np.load(j_cache) as zj, np.load(t_cache) as zt:
        assert sorted(zj.files) == sorted(zt.files)
        for k in zj.files:
            assert zj[k].dtype == zt[k].dtype and np.array_equal(zj[k], zt[k]), k


# ------------------------------------------------------------ (3) train_one

ARMS = {"dense": ([], False),
        # a refresh every 10 steps and at each epoch's last, Omega small enough
        # that 16 post-warm-up steps ramp to 38% sparsity
        "deeplight": (["--warm", "1", "--prune-epochs", "2", "--prune-omega", "0.05"], True),
        "qat": (["--qat"], False)}


def _leaves_close(got, want, pruned):
    """Checkpoint leaves of the two packages' fits: within rtol 1e-4, atol 2e-5
    (the diagonal of ``field_cov`` within 1e-3, see ``assert_trees_close``);
    on a pruned fit a leaf's zeros may differ by one weight (thresholds agree
    to 1e-5 relative, not to the bit) and values are compared where both kept
    them."""
    assert set(got) == set(want)
    for name in want:
        g, w = got[name], want[name]
        keep = np.ones(w.shape, bool)
        if pruned:
            assert int(((g == 0) != (w == 0)).sum()) <= 1, name
            keep = (g != 0) & (w != 0)
        if name.endswith("field_cov"):
            diag = np.eye(w.shape[0], dtype=bool)
            np.testing.assert_allclose(g[diag & keep], w[diag & keep], rtol=1e-4, atol=1e-3)
            keep &= ~diag
        np.testing.assert_allclose(g[keep], w[keep], rtol=1e-4, atol=2e-5, err_msg=name)


@pytest.mark.parametrize("arm", list(ARMS))
def test_train_one_matches_the_script(arm, jsyn, data, same_init, evals, tmp_path, monkeypatch):
    """One arm of the script against the port's, from the same init with
    dropout off: every eval (each epoch's train and valid, the test slice at
    the end and at the best epoch) within 1e-4 in AUC and logloss, the
    non-zero count within two parameters, the QAT model's int8 test AUC
    within 1e-4 (the dicts round it to 4 digits, so one unit of the last),
    and the checkpoints that ``--save`` wrote equal through the JAX loader.

    The DeepLight arm runs the JAX package on its flat table layout. Its
    default single-device layout packs rows into super-rows and counts the
    pack's tail padding (up to 11 zero rows) into the embedding threshold
    and the sparsity report, which keeps some tens more weights on this
    688,100-row table; the port thresholds the real rows, as the JAX package
    does on its flat layout and on a mesh."""
    extra, deeplight = ARMS[arm]
    if deeplight:
        monkeypatch.setattr(jconfig, "TrainConfig",
                            with_defaults(jconfig.TrainConfig, table_layout="flat"))
    xi, xv, y, sizes, _, _ = data
    parse = t_syn.get_parser().parse_args
    args_j = parse(SMALL + extra + ["--save", str(tmp_path / "j")])
    args_t = parse(SMALL + extra + ["--save", str(tmp_path / "t")])
    want, _ = printed(jsyn.train_one, xi, xv, y, sizes, 1000, args_j, deeplight=deeplight)
    got, _ = printed(t_syn.train_one, xi, xv, y, sizes, 1000, args_t, deeplight=deeplight,
                     device="cpu")

    assert set(got) == set(want) and got["mode"] == want["mode"]
    assert len(evals["port"]) == len(evals["jax"]) >= 4
    for (tl, ta, _, _), (jl, ja, _, _) in zip(evals["port"], evals["jax"]):
        assert ta == pytest.approx(ja, abs=1e-4) and tl == pytest.approx(jl, abs=1e-4)
    assert abs(got["nonzero_params"] - want["nonzero_params"]) <= 2
    if deeplight:
        assert got["sparsity_pct"] > 30 and got["dnn_sparsity_pct"] > 80
    if arm == "qat":
        assert got["int8_test_auc"] == pytest.approx(want["int8_test_auc"], abs=1e-4 + 1e-9)

    est_j = same_init[0]
    suffix = "deeplight" if deeplight else "dense"
    for tail in ("", "_best"):
        got_p = jckpt.load_checkpoint(str(tmp_path / f"t_{suffix}{tail}"), est_j.params)[0]
        want_p = jckpt.load_checkpoint(str(tmp_path / f"j_{suffix}{tail}"), est_j.params)[0]
        _leaves_close(j_leaves(got_p), j_leaves(want_p), pruned=deeplight and not tail)


# ------------------------------------------------------- (4) int8_auc_parity

def test_int8_auc_parity_on_a_jax_checkpoint(tmp_path, monkeypatch):
    """A checkpoint the JAX package wrote (the port's init of the 400^3
    flagship on the cache's fields, the tower's weights scaled up so that it
    moves the logits), served three ways by both. fp32 and layerwise int8 within 1e-5
    in AUC and logloss; the port's fused arm (the plain version of the tower
    kernel on the CPU) against the JAX fused path with the Pallas kernel in
    interpret mode within 1e-4."""
    import xsdeepfwfm_deprecated_tpu.ops.pallas.int8_mlp as jk
    xi, xv, y, sizes, logit, kept = t_syn.make_synthetic(5120, 1)
    cache = str(tmp_path / "c.npz")
    t_syn.save_cache(cache, xi, xv, y, logit, sizes, kept)
    params = weights.params_to_numpy(TD.init_params(
        torch.Generator().manual_seed(3), t_parity.model_config(sizes, 13), device="cpu"))
    params["deep"] = jax.tree.map(lambda w: w * 4.0, params["deep"])
    jckpt.save_checkpoint(str(tmp_path / "ck"), jax.tree.map(jnp.asarray, params))

    monkeypatch.setattr(jk, "int8_mlp_pallas", functools.partial(jk.int8_mlp_pallas,
                                                                 interpret=True))
    argv = ["--checkpoint", str(tmp_path / "ck"), "--cache", cache, "--batch", "512"]
    want = json_lines(run_script(load_script("int8_auc_parity"), argv, monkeypatch))[0]
    got, text = printed(t_parity.main, argv, device="cpu")
    assert json_lines(text) == [got] and set(got) == set(want)
    for arm, tol in (("fp32", 1e-5), ("int8-layerwise", 1e-5), ("int8-fused", 1e-4)):
        assert set(got[arm]) == set(want[arm])
        for key in ("auc", "logloss"):
            assert got[arm][key] == pytest.approx(want[arm][key], abs=tol), (arm, key)
    assert got["int8-fused"]["logit_corr_vs_fp32"] > 0.99


# ------------------------------------ (5) kd, qr, nfm and the pruned bench

@pytest.fixture(scope="module")
def cache_3k(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cache") / "c.npz")
    xi, xv, y, sizes, logit, kept = t_syn.make_synthetic(3000, 0)
    t_syn.save_cache(path, xi, xv, y, logit, sizes, kept)
    return path, sizes


def test_kd_scale_run_prints_the_scripts_keys(cache_3k):
    """The keys of ``scripts/kd_scale_run.py:105-141``."""
    res, text = printed(t_kd.main, ["--cache", cache_3k[0], "--teacher-epochs", "1",
                                    "--student-epochs", "1", "--cpu"])
    lines = json_lines(text)
    assert [list(line) for line in lines] == [["teacher"], ["student_alone"], ["student_kd"]]
    run = {"test_auc", "valid", "params_m", "wall_s"}
    assert set(lines[0]["teacher"]) == run
    assert set(lines[1]["student_alone"]) == set(lines[2]["student_kd"]) == run | {"best_test_auc"}
    assert json_lines(text, "RESULT ") == [res]
    assert set(res) == {"teacher", "student_alone", "student_kd", "student_serve_b8192_ms",
                        "teacher_serve_b8192_ms", "kd_minus_alone", "kd_minus_teacher", "ok"}
    assert res["student_alone"]["params_m"] < res["teacher"]["params_m"]
    assert res["teacher_serve_b8192_ms"] > 0 and res["student_serve_b8192_ms"] > 0


def test_qr_scale_run_prints_the_scripts_keys_and_table_bytes(cache_3k, monkeypatch):
    """The keys of ``scripts/qr_scale_run.py:148-164``; ``table_bytes`` equal
    to the script's on the same params (dense and QR). The timers run at
    small sizes here (the train step on 2 batches of 64 rows, serving on
    batches of 512 rows): the script's take a minute on the CPU."""
    jqr = load_script("qr_scale_run")
    sizes = (1,) * 13 + tuple(int(s) for s in np.random.default_rng(0).integers(10, 5000, 26))
    for qr in (False, True):
        kw = dict(field_size=39, feature_sizes=sizes, numerical=13,
                  embedding_size=10, h_depth=1, deep_nodes=8, use_fwfm=True, use_deep=True,
                  use_lw=True, use_fwlw=True, qr_flag=qr, qr_collisions=4, qr_threshold=200)
        params = JD.init_params(jax.random.PRNGKey(0), jconfig.ModelConfig(**kw))
        assert t_qr.table_bytes(weights.params_from_numpy(
            jax.tree.map(np.asarray, params), "cpu")) == jqr.table_bytes(params)
    monkeypatch.setattr(t_qr, "train_step_ms",
                        functools.partial(t_qr.train_step_ms, k=2, b=64))
    monkeypatch.setattr(t_qr, "serving_m_ex_s", functools.partial(t_qr.serving_m_ex_s, b=512))
    res, text = printed(t_qr.main, ["--cache", cache_3k[0], "--epochs", "1", "--cpu"])
    assert json_lines(text, "RESULT ") == res and [r["arm"] for r in res] == ["dense", "qr4"]
    for r in res:
        assert set(r) == {"arm", "valid_auc_by_epoch", "test_auc", "test_logloss",
                          "train_wall_s", "emb_table_mb", "best_test_auc",
                          "train_step_ms_b2048", "serve_b8192_m_ex_s", "serve_b8192_ms"}
    assert res[1]["emb_table_mb"] < res[0]["emb_table_mb"] / 3


def test_nfm_scale_run_matches_the_script(same_init, evals, monkeypatch):
    """Both arms from the same init with dropout off: the script's keys, and
    every eval within 1e-4 in AUC and logloss (relative for the faithful
    arm, whose N(0,1) tables give logits in the hundreds)."""
    argv = ["--rows", "2500", "--epochs", "2", "--batch", "256", "--faithful-too"]
    want = json_lines(run_script(load_script("nfm_scale_run"), argv, monkeypatch))
    got, text = printed(t_nfm.main, argv, device="cpu")
    assert json_lines(text) == got and [g["arm"] for g in got] == [w["arm"] for w in want]
    for g, w in zip(got, want):
        assert set(g) == set(w) and g["oracle_auc"] == w["oracle_auc"]
    assert len(evals["port"]) == len(evals["jax"]) >= 8
    for (tl, ta, _, _), (jl, ja, _, _) in zip(evals["port"], evals["jax"]):
        assert ta == pytest.approx(ja, abs=1e-4) and tl == pytest.approx(jl, rel=1e-4, abs=1e-4)


def test_pruned_serving_bench_matches_the_scripts_reports(tmp_path, monkeypatch):
    """``--smoke`` on a checkpoint the JAX package wrote: the compaction
    reports on stderr equal the script's, and the same arms and batch sizes
    are timed with the script's keys (the script's timers are replaced
    here: their numbers are not compared)."""
    from xsdeepfwfm_deprecated_torch.entry import flagship_config
    jbench = load_script("pruned_serving_bench")
    cfg = flagship_config(full_criteo=False, feature_scale=64, deep_nodes=64, embedding_size=8)
    jcfg = jconfig.ModelConfig(**{f: getattr(cfg, f) for f in (
        "field_size", "feature_sizes", "numerical", "embedding_size", "deep_nodes", "h_depth",
        "use_fwfm", "use_deep", "use_lw", "use_fwlw")})
    jckpt.save_checkpoint(str(tmp_path / "ck"), JD.init_params(jax.random.PRNGKey(5), jcfg))
    argv = ["--smoke", "--checkpoint", str(tmp_path / "ck")]

    monkeypatch.setattr(JProf, "marginal_timeit", lambda *a, **k: 1e-3)
    monkeypatch.setattr(JProf, "scan_timeit", lambda *a, **k: 1e-3)
    err_j, err_t = io.StringIO(), io.StringIO()
    with contextlib.redirect_stderr(err_j):
        want = json_lines(run_script(jbench, argv, monkeypatch))
    with contextlib.redirect_stderr(err_t):
        got, text = printed(t_bench.main, argv)
    assert json_lines(text) == got
    assert [(r["arm"], r["batch"], set(r)) for r in got] == \
        [(r["arm"], r["batch"], set(r)) for r in want]

    def reports(err):
        return [json.loads(line.split(":", 1)[1]) for line in err.getvalue().splitlines()
                if line.startswith("compaction (")]

    got_r, want_r = reports(err_t), reports(err_j)
    assert len(got_r) == 2
    for g, w in zip(got_r, want_r):
        assert set(g) == set(w)
        for k in w:
            assert g[k] == pytest.approx(w[k], rel=1e-12), k
    assert got_r[1]["tower_mac_reduction"] > 5
