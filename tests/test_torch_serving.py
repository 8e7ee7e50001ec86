"""The port's model, int8 conversion, Predictor and weight loading against the
JAX package, on the CPU.

Parameters are made by the JAX package and cross with ``params_from_numpy``
(or through its checkpoint files); inputs come from numpy with a seed. Each
comparison states its tolerance and why.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xsdeepfwfm_deprecated_tpu.cli.quantization import _save_quantized
from xsdeepfwfm_deprecated_tpu.compression import quantization as JQ
from xsdeepfwfm_deprecated_tpu.config import ModelConfig as JConfig
from xsdeepfwfm_deprecated_tpu.models import deepfwfm as JD
from xsdeepfwfm_deprecated_tpu.serving.predictor import Predictor as JPredictor
from xsdeepfwfm_deprecated_tpu.train import checkpoint as jckpt
from xsdeepfwfm_deprecated_torch import weights
from xsdeepfwfm_deprecated_torch.compression import quantization as TQ
from xsdeepfwfm_deprecated_torch.config import ModelConfig as TConfig
from xsdeepfwfm_deprecated_torch.entry import FULL_CRITEO_CAT_SIZES, flagship_config
from xsdeepfwfm_deprecated_torch.models import deepfwfm as TD
from xsdeepfwfm_deprecated_torch.ops.embedding import packed_lookup_serving
from xsdeepfwfm_deprecated_torch.serving.predictor import Predictor as TPredictor

F_SIZES = (1, 1, 1, 5, 9, 30)
NUM = 3
B = 8

# the model families of tests/test_model.py
ALL_VARIANTS = [
    dict(use_logit=True),
    dict(use_fm=True),
    dict(use_fwfm=True),
    dict(use_ffm=True),
    dict(use_fm=True, use_deep=True),
    dict(use_fwfm=True, use_deep=True),
    dict(use_ffm=True, use_deep=True),
    dict(use_deep=True),
    dict(use_fwfm=True, use_deep=True, use_lw=True),
    dict(use_fwfm=True, use_deep=True, use_fwlw=True),
    dict(use_fwfm=True, use_deep=True, use_lw=True, use_fwlw=True),
    dict(use_fwfm=True, use_deep=True, qr_flag=True, qr_threshold=8),
    dict(use_fwfm=True, use_deep=True, num_deeps=2),
]
VARIANT_IDS = ["LR", "FM", "FwFM", "FFM", "DeepFM", "DeepFwFM", "DeepFFM", "DNN", "lw", "fwlw",
               "lw_fwlw", "QR", "num_deeps2"]


def _cfgs(**kw):
    base = dict(field_size=len(F_SIZES), feature_sizes=F_SIZES, numerical=NUM,
                embedding_size=4, h_depth=2, deep_nodes=16, use_logit=False, use_fm=False,
                use_ffm=False, use_fwfm=False, use_deep=False)
    base.update(kw)
    return JConfig(**base), TConfig(**base)


def _port(tree):
    return weights.params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def _batch(sizes, num, b, seed):
    rng = np.random.default_rng(seed)
    xi = rng.integers(0, sizes[num:], size=(b, len(sizes) - num)).astype(np.int32)
    xv = rng.normal(size=(b, num)).astype(np.float32)
    return xi, xv


def _j_logits(params, xi, xv, cfg):
    return np.asarray(JD.forward(params, jnp.asarray(xi), jnp.asarray(xv), cfg))


@pytest.mark.parametrize("flags", ALL_VARIANTS, ids=VARIANT_IDS)
def test_eval_logits_match_jax(flags):
    """float32 sums in another order: rtol/atol 1e-5."""
    jcfg, tcfg = _cfgs(**flags)
    params = JD.init_params(jax.random.PRNGKey(0), jcfg)
    xi, xv = _batch(F_SIZES, NUM, B, seed=1)
    xi[0] = [7, -1, 99]                                        # out of range: last/first row
    want = _j_logits(params, xi, xv, jcfg)
    params_t = _port(params)
    xi_t, xv_t = torch.from_numpy(xi), torch.from_numpy(xv)
    got = TD.forward(params_t, xi_t, xv_t, tcfg)
    assert got.shape == (B,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    serving = TD.forward(params_t, xi_t, xv_t, tcfg, lookup_fn=packed_lookup_serving)
    np.testing.assert_allclose(serving.numpy(), want, rtol=1e-5, atol=1e-5)
    assert TD.param_count(params_t) == JD.param_count(params)
    assert TD.nonzero_param_count(params_t) == JD.nonzero_param_count(params)


def test_train_mode_draws_dropout_from_the_generator():
    jcfg, tcfg = _cfgs(use_fwfm=True, use_deep=True)
    params_t = _port(JD.init_params(jax.random.PRNGKey(0), jcfg))
    xi, xv = (torch.from_numpy(a) for a in _batch(F_SIZES, NUM, B, seed=2))
    run = lambda seed: TD.forward(params_t, xi, xv, tcfg, train=True,
                                  generator=torch.Generator().manual_seed(seed))
    assert torch.equal(run(3), run(3))
    assert not torch.equal(run(3), TD.forward(params_t, xi, xv, tcfg))


def test_init_params_statistics_match_jax():
    """Different RNG streams: compare each leaf's mean and std, within six
    standard errors of the two samples."""
    sizes = (1, 1, 1, 500, 900, 3000)
    kw = dict(field_size=6, feature_sizes=sizes, numerical=3, embedding_size=8,
              h_depth=2, deep_nodes=64, use_fwfm=True, use_deep=True, use_lw=True,
              use_fwlw=True)
    jp = jax.tree_util.tree_flatten_with_path(JD.init_params(jax.random.PRNGKey(0),
                                                             JConfig(**kw)))[0]
    tp = TD.init_params(torch.Generator().manual_seed(0), TConfig(**kw), device="cpu")
    from xsdeepfwfm_deprecated_torch import _tree
    t_leaves = dict(_tree.named_leaves(tp))
    j_leaves = {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p):
                np.asarray(v) for p, v in jp}
    assert t_leaves.keys() == j_leaves.keys()
    np.testing.assert_array_equal(t_leaves["bias"].numpy(), j_leaves["bias"])
    checked = 0
    for name, j in j_leaves.items():
        t = t_leaves[name].numpy()
        assert t.shape == j.shape and t.dtype == j.dtype, name
        n = j.size
        if n < 30:
            continue
        sd = j.std()
        assert abs(t.mean() - j.mean()) < 6 * sd * np.sqrt(2.0 / n), name
        assert abs(t.std() / sd - 1.0) < 6 * np.sqrt(1.0 / n), name
        checked += 1
    assert checked >= 8


@pytest.fixture(scope="module")
def served():
    """A DeepFwFM with lw+fwlw (the flagship's family) at small widths."""
    kw = dict(field_size=5, feature_sizes=(1, 1, 30, 40, 50), numerical=2, embedding_size=4,
              h_depth=2, deep_nodes=16, use_fwfm=True, use_deep=True, use_lw=True,
              use_fwlw=True)
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    params = JD.init_params(jax.random.PRNGKey(0), jcfg)
    xi, xv = _batch(kw["feature_sizes"], 2, 512, seed=3)
    return jcfg, tcfg, params, xi, xv


def test_predictor_fp32_matches_jax(served):
    """float32 sums in another order: rtol/atol 1e-5."""
    jcfg, tcfg, params, xi, xv = served
    want = JPredictor(params, jcfg).logits(xi, xv)
    p = TPredictor(_port(params), tcfg, device="cpu")
    np.testing.assert_allclose(p.logits(xi, xv), want, rtol=1e-5, atol=1e-5)
    probs = p.predict_proba(xi, xv)
    assert probs.shape == (512,) and np.all((probs > 0) & (probs < 1))
    assert p.predict(xi[:5], xv[:5]).dtype == bool
    assert p.warmup(batch_sizes=(1, 64)) is p
    for layout in ("grouped", "flat", "super"):       # all serve the flat table
        np.testing.assert_array_equal(
            TPredictor(_port(params), tcfg, layout=layout, device="cpu").logits(xi, xv),
            p.logits(xi, xv))


def test_predictor_rejects_unknown_layouts_and_models(served):
    jcfg, tcfg, params, xi, xv = served
    with pytest.raises(ValueError, match="layout"):
        TPredictor(_port(params), tcfg, layout="rows", device="cpu")
    with pytest.raises(ValueError, match="ModelConfig"):
        TPredictor(_port(params), device="cpu")

    class CompactModel:          # a stranger of that name, not serving.compaction's
        pass

    with pytest.raises(TypeError, match="cannot serve a CompactModel"):
        TPredictor(CompactModel(), device="cpu")


def test_predictor_dynamic_int8_matches_jax(served):
    """Per-batch scales on both sides (JAX serves layerwise on the CPU). The
    JAX ``Predictor`` jits its forward, and XLA multiplies by 1/127 where the
    port divides, so a batch's scale may differ by an ulp and an activation
    on a rounding boundary take the neighbouring code (bits are compared with
    eager JAX in ``test_torch_int8_mlp.py``); on these inputs the logits
    agree within atol 1e-4, float32 sums in another order included."""
    jcfg, tcfg, params, xi, xv = served
    qm_j = JQ.convert(params, jcfg, mode="dynamic")
    qm_t = TQ.convert(_port(params), tcfg, mode="dynamic")
    assert qm_t.size_bytes() == qm_j.size_bytes()
    want = JPredictor(qm_j).logits(xi, xv)
    np.testing.assert_allclose(TPredictor(qm_t, device="cpu").logits(xi, xv), want,
                               rtol=0, atol=1e-4)
    np.testing.assert_array_equal(qm_t.emb2_q["dense"]["qs"].numpy(),
                                  np.asarray(qm_j.emb2_q["dense"]["qs"]))


def test_predictor_static_int8_matches_jax(served):
    """Each package calibrates its own scales; same tolerance as the dynamic case."""
    jcfg, tcfg, params, xi, xv = served
    scales = JQ.calibrate(params, jcfg, xi, xv, n_batches=2, batch_size=128)
    want = JPredictor(JQ.convert(params, jcfg, mode="static", act_scales=scales)).logits(xi, xv)
    scales_t = TQ.calibrate(_port(params), tcfg, xi, xv, n_batches=2, batch_size=128)
    qm_t = TQ.convert(_port(params), tcfg, mode="static", act_scales=scales_t)
    np.testing.assert_allclose(TPredictor(qm_t, device="cpu").logits(xi, xv), want,
                               rtol=0, atol=1e-4)


def test_fused_branch_at_one_tile_matches_jax_layerwise(served):
    """B = 512 is one tile, so the per-tile scale is the per-batch scale:
    the fused branch (the plain version on the CPU) equals the JAX layerwise
    path, atol 1e-4 as above."""
    jcfg, tcfg, params, xi, xv = served
    want = np.asarray(JQ.quantized_forward(JQ.convert(params, jcfg), jnp.asarray(xi),
                                           jnp.asarray(xv), use_fused_kernel=False))
    qm_t = TQ.convert(_port(params), tcfg)
    xi_t, xv_t = torch.from_numpy(xi), torch.from_numpy(xv)
    fused = TQ.quantized_forward(qm_t, xi_t, xv_t, use_fused_kernel=True)
    np.testing.assert_allclose(fused.numpy(), want, rtol=0, atol=1e-4)
    layerwise = TQ.quantized_forward(qm_t, xi_t, xv_t)
    np.testing.assert_allclose(fused.numpy(), layerwise.numpy(), rtol=0, atol=1e-5)


def test_fused_fallback_logs_warning(served, caplog):
    jcfg, tcfg, params, xi, xv = served
    qm_t = TQ.convert(_port(params), tcfg)
    xi6, xv6 = (torch.from_numpy(np.concatenate([a, a[:88]])) for a in (xi, xv))   # B=600
    TQ._warn_fallback.cache_clear()
    with caplog.at_level(logging.WARNING, logger="xsdeepfwfm_torch"):
        TQ.quantized_forward(qm_t, xi6, xv6, use_fused_kernel=True)
        TQ.quantized_forward(qm_t, xi6[:100], xv6[:100], use_fused_kernel=True)
    msgs = [r.getMessage() for r in caplog.records if "falling back" in r.getMessage()]
    assert len(msgs) == 1 and "batch 600" in msgs[0]     # b < 512 stays silent


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("table_dtype", ["f32", "bf16"])
def test_jax_checkpoint_loads(tmp_path, sparse, table_dtype):
    """Weights cross unchanged: rtol/atol 1e-5 (float32 sum order only)."""
    kw = dict(field_size=5, feature_sizes=(1, 1, 300, 400, 500), numerical=2,
              embedding_size=4, h_depth=2, deep_nodes=16, use_fwfm=True, use_deep=True,
              use_lw=True, table_dtype=table_dtype)
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    params = JD.init_params(jax.random.PRNGKey(4), jcfg)
    if sparse:   # a pruned model: mostly-zero arrays are stored in COO form
        params["emb2"]["dense"] = params["emb2"]["dense"].at[::3].set(0).at[1::3].set(0)
        params["deep"]["net_1"]["layers"][0]["w"] = jnp.where(
            jnp.abs(params["deep"]["net_1"]["layers"][0]["w"]) < 0.3, 0.0,
            params["deep"]["net_1"]["layers"][0]["w"])
    path = str(tmp_path / "ckpt")
    jckpt.save_checkpoint(path, params, sparse=sparse)
    if sparse:
        assert "params::emb2/dense@idx" in np.load(path + ".npz").files
    params_t = weights.load_jax_checkpoint(path, tcfg, device="cpu")
    assert params_t["emb2"]["dense"].dtype == (torch.bfloat16 if table_dtype == "bf16"
                                               else torch.float32)
    xi, xv = _batch(kw["feature_sizes"], 2, 64, seed=5)
    want = _j_logits(params, xi, xv, jcfg)
    got = TD.forward(params_t, torch.from_numpy(xi), torch.from_numpy(xv), tcfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        weights.params_to_numpy(params_t)["deep"]["net_1"]["fc_w"],
        np.asarray(params["deep"]["net_1"]["fc_w"]))


def test_jax_checkpoint_missing_entry_raises(tmp_path, served):
    jcfg, tcfg, params, xi, xv = served
    path = str(tmp_path / "partial")
    jckpt.save_checkpoint(path, {k: v for k, v in params.items() if k != "field_cov"})
    with pytest.raises(KeyError, match="field_cov"):
        weights.load_jax_checkpoint(path, tcfg, device="cpu")


@pytest.mark.parametrize("mode", ["dynamic", "static"])
def test_quantized_artifact_loads(tmp_path, served, mode):
    """The artifact's int8 bytes cross unchanged; atol 1e-4 as for the int8
    Predictor."""
    jcfg, tcfg, params, xi, xv = served
    scales = (JQ.calibrate(params, jcfg, xi, xv, n_batches=2, batch_size=128)
              if mode == "static" else None)
    qm_j = JQ.convert(params, jcfg, mode=mode, act_scales=scales)
    path = str(tmp_path / f"model_{mode}_quant")
    _save_quantized(qm_j, path)
    qm_t = weights.load_quantized_artifact(path, tcfg, device="cpu")
    assert qm_t.mode == mode and (qm_t.act_scales is None) == (mode == "dynamic")
    want = np.asarray(JQ.quantized_forward(qm_j, jnp.asarray(xi), jnp.asarray(xv)))
    got = TQ.quantized_forward(qm_t, torch.from_numpy(xi), torch.from_numpy(xv))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_flagship_config_is_the_jax_flagship():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "__graft_entry__.py"
    spec = importlib.util.spec_from_file_location("graft_entry", path)
    entry = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(entry)
    assert FULL_CRITEO_CAT_SIZES == tuple(entry.FULL_CRITEO_CAT_SIZES)
    for full in (True, False):
        j, t = entry._flagship(full_criteo=full), flagship_config(full_criteo=full)
        assert {f: getattr(t, f) for f in vars(j)} == vars(j)
    assert sum(flagship_config().feature_sizes) == 1_326_055
