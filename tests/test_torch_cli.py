"""The port's four command-line entry points, run in process on the CPU at tiny
widths, and the slice as a whole against the same steps in the JAX package.

Each ``main(argv, device="cpu")`` runs in a temporary working directory (the
CLIs write ``./saved_models`` and ``./logs``). Checkpoints and quantized
artifacts cross between the packages with the same logits: rtol and atol 1e-5
for fp32 (float32 sums in another order), atol 1e-4 for the int8 paths.
"""

import dataclasses
import glob

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xsdeepfwfm_deprecated_tpu.cli import quantization as j_quantization
from xsdeepfwfm_deprecated_tpu.compression import quantization as JQ
from xsdeepfwfm_deprecated_tpu.config import configs_from_args as j_configs_from_args
from xsdeepfwfm_deprecated_tpu.config import get_parser as j_get_parser
from xsdeepfwfm_deprecated_tpu.data import get_dataset as j_get_dataset
from xsdeepfwfm_deprecated_tpu.models import deepfwfm as JD
from xsdeepfwfm_deprecated_tpu.serving import compaction as JC
from xsdeepfwfm_deprecated_tpu.serving.predictor import Predictor as JPredictor
from xsdeepfwfm_deprecated_tpu.train import checkpoint as jckpt
from xsdeepfwfm_deprecated_tpu.train.trainer import DeepFMEstimator as JEstimator
from xsdeepfwfm_deprecated_torch import _tree
from xsdeepfwfm_deprecated_torch.cli import kd, main_all, nfm, quantization
from xsdeepfwfm_deprecated_torch.compression import quantization as TQ
from xsdeepfwfm_deprecated_torch.config import configs_from_args
from xsdeepfwfm_deprecated_torch.models import factory
from xsdeepfwfm_deprecated_torch.models.nfm import NFMEstimator
from xsdeepfwfm_deprecated_torch.serving.compaction import compact_for_serving
from xsdeepfwfm_deprecated_torch.serving.predictor import Predictor as TPredictor
from xsdeepfwfm_deprecated_torch.train import trainer as TT

TINY = ["-dataset", "tiny-criteo", "-use_fwfm", "1", "-use_fm", "0", "-use_logit", "0",
        "-use_deep", "1", "-use_lw", "1", "-use_fwlw", "1", "-n_epochs", "1",
        "-batch_size", "2048", "-deep_nodes", "16", "-embedding_size", "4", "-h_depth", "2"]
BENCH_KEYS = {"loss", "auc", "prauc", "rce", "batch_ms", "batch_onchip_ms", "examples_per_s",
              "examples_per_s_per_chip", "single_example_ms", "single_example_onchip_ms"}


@pytest.fixture(scope="module")
def tiny():
    return j_get_dataset("tiny-criteo")


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One ``main_all`` run that the other CLIs start from."""
    cwd = tmp_path_factory.mktemp("main_all")
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(cwd)
        model = main_all.main(TINY, device="cpu")
    model.save_model_name = str(cwd / model.save_model_name)
    return model, cwd


def _log_text(cwd):
    return "\n".join(open(p).read() for p in glob.glob(str(cwd / "logs" / "*.log")))


def test_main_all_trains_reloads_sizes_and_benchmarks(trained):
    model, cwd = trained
    assert isinstance(model, TT.DeepFMEstimator) and model.device.type == "cpu"
    assert model.mcfg.deep_layers == (16, 16) and model.mcfg.use_lw and model.mcfg.use_fwlw
    assert BENCH_KEYS <= set(model.benchmark)
    assert all(np.isfinite(model.benchmark[k]) for k in BENCH_KEYS)
    text = _log_text(cwd)
    for phrase in ("GET DATASET", "Training [1]", "Validation [1]", "MODEL SIZE", "TEST DATASET",
                   "Avg forward pass time"):       # what tests/test_cli.py greps for
        assert phrase in text, phrase
    assert glob.glob(model.save_model_name + ".npz") and glob.glob(
        model.save_model_name + ".meta.json")


def test_main_all_checkpoint_loads_in_the_jax_package(trained, tiny):
    model, _ = trained
    _, _, _, test = tiny
    pars = j_get_parser().parse_args(TINY)
    jcfg, _ = j_configs_from_args(pars, 39, test["feature_sizes"])
    template = JD.init_params(jax.random.PRNGKey(0), jcfg)
    j_params = jckpt.load_checkpoint(model.save_model_name, template)[0]
    xi, xv = test["index"][:512], test["value"][:512]
    want = np.asarray(JD.forward(j_params, jnp.asarray(xi), jnp.asarray(xv), jcfg))
    np.testing.assert_allclose(model._predict_logits(xi, xv), want, rtol=1e-5, atol=1e-5)


def test_quantization_cli_and_artifacts_cross_both_ways(trained, tiny, tmp_path, monkeypatch):
    model, _ = trained
    _, train, _, test = tiny
    monkeypatch.chdir(tmp_path)
    res = quantization.main(TINY + ["-save_model_path", model.save_model_name,
                                    "-dynamic_quantization", "1", "-static_quantization", "1"],
                            device="cpu")
    assert set(res) == {"original", "dynamic", "static"}
    assert all(BENCH_KEYS <= set(r["benchmark"]) for r in res.values())
    assert all(r["tower_launches"] == 0 for r in res.values())     # no card, no kernel
    assert res["dynamic"]["model"].act_scales is None
    assert res["static"]["model"].act_scales is not None
    assert abs(res["dynamic"]["benchmark"]["auc"] - res["original"]["benchmark"]["auc"]) < 0.02

    pars = j_get_parser().parse_args(TINY)
    jcfg, _ = j_configs_from_args(pars, 39, test["feature_sizes"])
    xi, xv = test["index"][:256], test["value"][:256]
    for mode in ("dynamic", "static"):
        path = f"{model.save_model_name}_{mode}_quant"
        qm_t = res[mode]["model"]
        # the port's artifact: back into the port, and into the JAX package
        back = quantization.load_quantized(path, model.mcfg, mode=mode, device="cpu")
        assert back.mode == mode and back.size_bytes() == qm_t.size_bytes()
        want = TQ.quantized_forward(qm_t, torch.from_numpy(xi), torch.from_numpy(xv))
        assert torch.equal(TQ.quantized_forward(back, torch.from_numpy(xi),
                                                torch.from_numpy(xv)), want)
        qm_j = j_quantization.load_quantized(path, jcfg, mode=mode)
        got_j = np.asarray(JQ.quantized_forward(qm_j, jnp.asarray(xi), jnp.asarray(xv)))
        np.testing.assert_allclose(got_j, want.numpy(), rtol=0, atol=1e-4)
        # the JAX package's artifact of the same model: same keys, same bytes
        j_path = str(tmp_path / f"j_{mode}")
        j_quantization._save_quantized(qm_j, j_path)
        with np.load(path + ".npz") as ours, np.load(j_path + ".npz") as theirs:
            assert set(ours.files) == set(theirs.files)
            assert all(np.array_equal(ours[k], theirs[k]) and ours[k].dtype == theirs[k].dtype
                       for k in ours.files)
        from_jax = quantization.load_quantized(j_path, model.mcfg, mode=mode, device="cpu")
        assert torch.equal(TQ.quantized_forward(from_jax, torch.from_numpy(xi),
                                                torch.from_numpy(xv)), want)


def test_quantization_aware_mode_trains_and_converts(trained, tmp_path, monkeypatch):
    model, _ = trained
    monkeypatch.chdir(tmp_path)
    res = quantization.main(TINY + ["-save_model_path", model.save_model_name,
                                    "-quantization_aware", "1"], device="cpu")
    assert set(res) == {"original", "qat"} and res["qat"]["model"].mode == "qat"
    assert np.isfinite(res["qat"]["benchmark"]["loss"])
    assert glob.glob(model.save_model_name + "_quant_aware.npz")


def test_kd_cli_trains_a_smaller_student(trained, tmp_path, monkeypatch):
    model, _ = trained
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(kd, "STUDENT_DEEP_NODES", 8)      # tiny widths: 16x2 -> 8x2
    teacher, student = kd.main(TINY + ["-save_model_path", model.save_model_name], device="cpu")
    assert student.mcfg.deep_layers == (8, 8) and teacher.mcfg.deep_layers == (16, 16)
    assert student.size_bytes < teacher.size_bytes
    assert np.isfinite(student.last_epoch_losses).all()
    assert BENCH_KEYS <= set(student.benchmark) and BENCH_KEYS <= set(teacher.benchmark)
    assert teacher.benchmark["auc"] == pytest.approx(model.benchmark["auc"], abs=1e-9)
    assert glob.glob(model.save_model_name + "_kd.npz")
    assert kd.STUDENT_H_DEPTH == 2


@pytest.mark.parametrize("extra", [[], ["-interaction_type", "0", "-nfm_sane_init", "1"],
                                   ["-refit", "1", "-nfm_sane_init", "1"]],
                         ids=["default", "pairwise_sane", "refit"])
def test_nfm_cli(extra, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    est = nfm.main(TINY + extra, device="cpu")
    assert isinstance(est, NFMEstimator) and est.device.type == "cpu"
    assert all(np.isfinite(v) for v in est.test_metrics)
    assert est.mcfg.interaction_type == ("-interaction_type" not in extra)
    assert est.mcfg.sane_init == ("-nfm_sane_init" in extra)
    assert est._step == (5 + 10 if "-refit" in extra else 5)
    assert "NFM test loss" in _log_text(tmp_path)


def test_debug_nans_flag_arms_the_checks_during_fit(tmp_path, monkeypatch):
    from xsdeepfwfm_deprecated_torch.utils import debug
    monkeypatch.chdir(tmp_path)
    seen = []
    real_fit = TT.DeepFMEstimator.fit

    def spying_fit(self, *a, **kw):
        seen.append((torch.is_anomaly_enabled(), debug.finite_checks_enabled()))
        return real_fit(self, *a, **kw)

    monkeypatch.setattr(TT.DeepFMEstimator, "fit", spying_fit)
    main_all.main(TINY + ["-debug_nans", "1", "-auto_resume", "1"], device="cpu")
    assert seen == [(True, True)]
    assert not torch.is_anomaly_enabled() and not debug.finite_checks_enabled()


def test_clis_refuse_what_the_jax_clis_refuse(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError, match="only one of"):
        main_all.main(["-dataset", "tiny-criteo", "-use_fm", "1", "-use_fwfm", "1"],
                      device="cpu")
    for cli in (quantization, kd):
        with pytest.raises(SystemExit):
            cli.main(TINY, device="cpu")              # no -save_model_path
    with pytest.raises(SystemExit):                   # argparse: not one of the datasets
        main_all.main(["-dataset", "movielens"], device="cpu")


def test_the_slice_as_a_whole_against_the_jax_package(tiny, tmp_path, monkeypatch):
    """Train through the port's ``main_all`` with structured pruning, quantize
    through its quantization CLI, compact and serve; the JAX package takes the
    same steps through its estimator, ``convert``, ``compact_for_serving`` and
    ``Predictor``. Both start from the same carried-across initial parameters
    and run without dropout (the random streams differ). Logits within 1e-4
    at every stage."""
    _, train, valid, test = tiny
    flags = TINY + ["-prune", "1", "-prune_deep_structured", "1", "-prune_fm", "0", "-warm", "0",
                    "-sparse", "0.6", "-prune_omega", "0.05", "-learning_rate", "0.01"]
    no_dropout = dict(is_shallow_dropout=False, is_deep_dropout=False)

    # the JAX package: the steps of its main_all, quantization CLI and compaction, by hand
    pars = j_get_parser().parse_args(flags)
    jcfg, jtc = j_configs_from_args(pars, 39, train["feature_sizes"])
    jcfg = dataclasses.replace(jcfg, **no_dropout)
    est_j = JEstimator(jcfg, jtc)
    est_j.init_params()
    initial = jax.tree.map(np.asarray, est_j.params)
    est_j.fit(train["index"], train["value"], train["label"],
              valid["index"], valid["value"], valid["label"],
              prune=True, prune_fm=False, prune_r=False, prune_deep=True,
              emb_r=pars.emb_r, emb_corr=pars.emb_corr)

    # the port: its CLIs, with the carried initial parameters and dropout off
    def carried_init(self, seed=None):
        self.params = _tree.tree_map(lambda a: torch.from_numpy(np.array(a)).to(self.device),
                                     initial)
        return self.params

    def configs_without_dropout(pars, field_size, feature_sizes):
        mcfg, tcfg = configs_from_args(pars, field_size, feature_sizes)
        return dataclasses.replace(mcfg, **no_dropout), tcfg

    monkeypatch.setattr(TT.DeepFMEstimator, "init_params", carried_init)
    monkeypatch.setattr(factory, "configs_from_args", configs_without_dropout)
    monkeypatch.chdir(tmp_path)
    est_t = main_all.main(flags, device="cpu")
    res = quantization.main(flags + ["-save_model_path", est_t.save_model_name,
                                     "-dynamic_quantization", "1"], device="cpu")

    xi, xv = test["index"][:1024], test["value"][:1024]
    dead_j = [~np.any(np.asarray(l["w"]) != 0, axis=0)
              for l in est_j.params["deep"]["net_1"]["layers"]]
    dead_t = [~(l["w"] != 0).any(dim=0).numpy() for l in est_t.params["deep"]["net_1"]["layers"]]
    assert all(np.array_equal(a, b) for a, b in zip(dead_j, dead_t))      # the same units went
    assert all(0.3 < d.mean() < 0.8 for d in dead_t)
    # trained and reloaded
    want = np.asarray(JD.forward(est_j.params, jnp.asarray(xi), jnp.asarray(xv), jcfg))
    np.testing.assert_allclose(est_t._predict_logits(xi, xv), want, rtol=1e-4, atol=1e-4)
    # quantized (the flat layout: the layerwise tower with a per-batch scale in both)
    qm_j = JQ.convert(est_j.params, jcfg, mode="dynamic")
    want_q = JPredictor(qm_j, layout="flat").logits(xi, xv)
    got_q = TPredictor(res["dynamic"]["model"], device="cpu").logits(xi, xv)
    np.testing.assert_allclose(got_q, want_q, rtol=1e-4, atol=1e-4)
    # compacted and served, fp32 and int8
    for int8 in (False, True):
        cm_j = JC.compact_for_serving(est_j.params, jcfg, int8=int8)
        cm_t = compact_for_serving(est_t.params, est_t.mcfg, int8=int8)
        assert cm_t.keep_in0 == tuple(cm_j.keep_in0)
        assert [tuple(l.get("w", l.get("w_q")).shape) for l in cm_t.deep["layers"]] == \
            [tuple(l.get("w", l.get("w_q")).shape) for l in cm_j.deep["layers"]]
        np.testing.assert_allclose(TPredictor(cm_t, device="cpu").logits(xi, xv),
                                   JPredictor(cm_j).logits(xi, xv), rtol=1e-4, atol=1e-4)
    assert cm_t.deep["layers"][1]["w_q"].shape[0] < 16
