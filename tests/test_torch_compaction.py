"""The port's serve-time compaction and its kept float codes against the JAX
package, on the CPU.

The cases are those of ``tests/test_compaction.py``. Parameters are made and
pruned by the JAX package and cross with ``params_from_numpy``; inputs come
from numpy with a seed. Both packages fold the tower in numpy float32 on the
host, so the compact arrays are compared for equality. Logits: rtol and atol
1e-5 (float32 sums in another order); int8 logits atol 1e-4, as the int8
paths of ``tests/test_torch_serving.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_serving import _port
from xsdeepfwfm_deprecated_tpu.compression import quantization as JQ
from xsdeepfwfm_deprecated_tpu.compression.pruning import prune_params as j_prune
from xsdeepfwfm_deprecated_tpu.config import ModelConfig as JConfig
from xsdeepfwfm_deprecated_tpu.models import deepfwfm as JD
from xsdeepfwfm_deprecated_tpu.serving import compaction as JC
from xsdeepfwfm_deprecated_tpu.serving.predictor import Predictor as JPredictor
from xsdeepfwfm_deprecated_torch import _tree, weights
from xsdeepfwfm_deprecated_torch.cli.quantization import _save_quantized
from xsdeepfwfm_deprecated_torch.compression import quantization as TQ
from xsdeepfwfm_deprecated_torch.config import ModelConfig as TConfig
from xsdeepfwfm_deprecated_torch.models import deepfwfm as TD
from xsdeepfwfm_deprecated_torch.ops import quantized as q_ops
from xsdeepfwfm_deprecated_torch.serving import compaction as TC
from xsdeepfwfm_deprecated_torch.serving.predictor import Predictor as TPredictor

F_SIZES = (1, 1, 300, 400, 250)
NUM = 2
B = 64
TREES = ("params_fp", "emb1", "emb2", "deep")


def _base(qr=False, **kw):
    cfg = dict(field_size=5, feature_sizes=F_SIZES, numerical=NUM, embedding_size=8, h_depth=3,
               deep_nodes=32, use_fwfm=True, use_deep=True, use_lw=True, use_fwlw=True,
               qr_flag=qr, qr_threshold=260, qr_collisions=4)
    cfg.update(kw)
    return JConfig(**cfg), TConfig(**cfg)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    xi = rng.integers(0, [300, 400, 250], size=(B, 3)).astype(np.int32)
    xv = rng.normal(size=(B, NUM)).astype(np.float32)
    xi[0] = [10_000, -3, 249]        # beyond the table, below it, a field's last row
    xi[1] = [299, 400, 250]          # one past two fields' ends: the next field's first row
    return xi, xv


def _zero_rows(params, frac, rng):
    """Zero a random fraction of emb rows (the F-pruning zero-row pattern)."""
    for name in ("emb1", "emb2"):
        if name in params:
            t = np.asarray(params[name]["dense"]).copy()
            t[rng.random(t.shape[0]) < frac] = 0.0
            params[name]["dense"] = jnp.asarray(t)
    return params


def _row_pruned(params, rng):
    return _zero_rows(params, 0.5, rng)


def _element_pruned(params, rng):
    return j_prune(params, jnp.float32(0.9), prune_fm=True, prune_deep=True, prune_r=True)


def _structured(params, rng):
    return j_prune(params, jnp.float32(0.75), prune_fm=False, prune_deep=True, prune_r=False,
                   structured_deep=True)


def _bias_folding(params, rng):
    """Units with zero incoming weights: a positive bias passes a constant on
    (folded into the next bias), a negative one is dead; one in the last
    hidden layer folds into the fc bias."""
    net = params["deep"]["net_1"]
    for layer, unit, bias in ((0, 3, 1.7), (0, 7, -2.0), (2, 5, 0.9)):
        w = np.asarray(net["layers"][layer]["w"]).copy()
        b = np.asarray(net["layers"][layer]["b"]).copy()
        w[:, unit] = 0.0
        b[unit] = bias
        net["layers"][layer] = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
    return params


def _rows_and_units(params, rng):
    return _structured(_zero_rows(params, 0.5, rng), rng)


def _dead_inputs(params, rng):
    """All-zero ROWS of layer 0: input dimensions that the static gather drops."""
    w = np.asarray(params["deep"]["net_1"]["layers"][0]["w"]).copy()
    w[[0, 5, 17, 39]] = 0.0
    params["deep"]["net_1"]["layers"][0]["w"] = jnp.asarray(w)
    return params


# name -> (prune, config flags, compact_for_serving keywords)
CASES = {
    "row_pruned": (_row_pruned, {}, {}),
    "element_pruned": (_element_pruned, {}, {}),
    "structured": (_structured, {}, {}),
    "bias_folding": (_bias_folding, {}, {}),
    "dead_inputs": (_dead_inputs, {}, {}),
    "qr": (lambda p, rng: _zero_rows(p, 0.4, rng), dict(qr=True), {}),
    "emb1_tables": (_rows_and_units, dict(use_fwlw=False), {}),
    "fm_only": (_row_pruned, dict(use_fwfm=False, use_fm=True, use_deep=False, use_lw=False,
                                  use_fwlw=False), {}),
    "rows_kept": (_rows_and_units, {}, dict(compact_rows=False)),
    "int8": (_rows_and_units, {}, dict(int8=True)),
    "int8_rows_kept": (_rows_and_units, {}, dict(int8=True, compact_rows=False)),
    "int8_qr": (lambda p, rng: _zero_rows(p, 0.4, rng), dict(qr=True), dict(int8=True)),
}


def _both(name):
    """(JAX config, port config, pruned JAX params, JAX CompactModel, port CompactModel)."""
    prune, flags, kw = CASES[name]
    jcfg, tcfg = _base(**flags)
    params = prune(JD.init_params(jax.random.PRNGKey(0), jcfg), np.random.default_rng(7))
    return (jcfg, tcfg, params, JC.compact_for_serving(params, jcfg, **kw),
            TC.compact_for_serving(_port(params), tcfg, **kw))


def _j_named(tree):
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("name", CASES)
def test_compact_arrays_equal_the_jax_package(name):
    """Same arrays, names, shapes, dtypes and bits; same static gather; same size."""
    _, _, _, cm_j, cm_t = _both(name)
    assert cm_t.keep_in0 == tuple(cm_j.keep_in0) and cm_t.int8 == cm_j.int8
    for tree in TREES:
        want = _j_named(getattr(cm_j, tree))
        got = {k: v.numpy() for k, v in _tree.named_leaves(getattr(cm_t, tree))}
        assert set(got) == set(want), tree
        for key, arr in want.items():
            assert got[key].dtype == arr.dtype and got[key].shape == arr.shape, (tree, key)
            assert np.array_equal(got[key], arr), (tree, key)
    assert cm_t.size_bytes() == cm_j.size_bytes()
    for tables in (cm_t.emb1, cm_t.emb2):
        if tables is not None and "remap" in tables:
            assert tables["remap"].dtype == torch.int32


@pytest.mark.parametrize("name", CASES)
def test_compact_logits_match_jax_and_the_dense_forward(name):
    """The port's compact forward against the JAX one on the same inputs, an
    out-of-range index included (both clip to the table, not to the field);
    and, for in-range rows in fp32, against the port's dense forward on the
    pruned parameters."""
    jcfg, tcfg, params, cm_j, cm_t = _both(name)
    xi, xv = _inputs()
    want = np.asarray(jax.jit(JC.compact_forward)(cm_j, jnp.asarray(xi), jnp.asarray(xv)))
    got = TC.compact_forward(cm_t, torch.from_numpy(xi), torch.from_numpy(xv)).numpy()
    assert got.shape == (B,)
    tol = dict(rtol=0, atol=1e-4) if cm_t.int8 else dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, want, **tol)
    if not cm_t.int8:
        dense = TD.forward(_port(params), torch.from_numpy(xi[2:]), torch.from_numpy(xv[2:]),
                           tcfg).numpy()
        np.testing.assert_allclose(got[2:], dense, rtol=1e-5, atol=1e-5)


def test_out_of_range_index_clips_to_the_table_not_the_field():
    """Field 0 has 300 rows. Index 300 in it reads the next field's first row
    in the compact lookup, where every other lookup of the port reads the
    field's last row."""
    jcfg, tcfg, params, cm_j, cm_t = _both("row_pruned")
    xi, xv = _inputs()
    beyond, last, next_first = xi[2:5].copy(), xi[2:5].copy(), xi[2:5].copy()
    beyond[:, 0], last[:, 0] = 300, 299
    xv3 = torch.from_numpy(xv[2:5])
    spec = TD.make_embedding_spec(tcfg)
    got = TC._lookup(cm_t.emb2, spec, torch.from_numpy(beyond), xv3, False)
    field1_row0 = TC._lookup(cm_t.emb2, spec, torch.from_numpy(np.zeros_like(xi[2:5])), xv3, False)
    assert torch.equal(got[:, NUM], field1_row0[:, NUM + 1])
    per_field = TD.forward(_port(params), torch.from_numpy(beyond), xv3, tcfg)
    at_last = TD.forward(_port(params), torch.from_numpy(last), xv3, tcfg)
    assert torch.equal(per_field, at_last)
    want = np.asarray(JC.compact_forward(cm_j, jnp.asarray(beyond), jnp.asarray(xv[2:5])))
    np.testing.assert_allclose(TC.compact_forward(cm_t, torch.from_numpy(beyond), xv3).numpy(),
                               want, rtol=1e-5, atol=1e-5)


def test_structured_pruning_shrinks_the_tower():
    _, tcfg, params, cm_j, cm_t = _both("structured")
    rep = TC.compaction_report(_port(params), cm_t, tcfg)
    assert rep["tower_mac_reduction"] > 5.0, rep
    assert rep["tower_shapes_compact"][1][0] <= 12 and rep["tower_shapes_compact"][1][1] <= 12


def test_bias_folding_drops_the_doctored_units():
    *_, cm_t = _both("bias_folding")
    assert cm_t.deep["layers"][0]["w"].shape[1] == 30
    assert cm_t.deep["layers"][2]["w"].shape[1] == 31
    assert float(cm_t.deep["fc_b"][0]) != 0.0


@pytest.mark.parametrize("name", ["row_pruned", "structured", "int8", "rows_kept"])
def test_compaction_report_equals_the_jax_package(name):
    jcfg, tcfg, params, cm_j, cm_t = _both(name)
    want = JC.compaction_report(params, cm_j, jcfg)
    got = TC.compaction_report(_port(params), cm_t, tcfg)
    assert set(got) == set(want)
    for key, value in want.items():
        if key.startswith("tower_shapes"):
            assert [tuple(s) for s in got[key]] == [tuple(s) for s in value]
        else:
            assert got[key] == pytest.approx(value), key


@pytest.mark.parametrize("name", ["row_pruned", "structured", "qr", "int8", "int8_rows_kept"])
def test_predictor_serves_a_compact_model(name):
    """``Predictor(CompactModel)`` against the JAX ``Predictor`` of its
    ``CompactModel``, one example and a batch."""
    _, _, _, cm_j, cm_t = _both(name)
    xi, xv = _inputs()
    pred = TPredictor(cm_t, device="cpu")
    assert pred.cfg is cm_t.cfg and pred._fn is TC.compact_forward
    tol = dict(rtol=0, atol=1e-4) if cm_t.int8 else dict(rtol=1e-5, atol=1e-5)
    jpred = JPredictor(cm_j)
    np.testing.assert_allclose(pred.logits(xi, xv), jpred.logits(xi, xv), **tol)
    np.testing.assert_allclose(pred.logits(xi[:1], xv[:1]), jpred.logits(xi[:1], xv[:1]), **tol)
    assert pred.predict(xi, xv).dtype == bool
    pred.warmup(batch_sizes=(1, 4))


@pytest.mark.parametrize("name", ["row_pruned", "int8"])
def test_compact_from_numpy_carries_a_jax_compact_model(name):
    _, tcfg, _, cm_j, cm_t = _both(name)
    trees = {t: jax.tree.map(np.asarray, getattr(cm_j, t)) for t in TREES}
    carried = weights.compact_from_numpy(tcfg, cm_j.int8, cm_j.keep_in0, device="cpu", **trees)
    assert carried.keep_in0 == cm_t.keep_in0 and carried.size_bytes() == cm_t.size_bytes()
    xi, xv = (torch.from_numpy(a) for a in _inputs())
    assert torch.equal(TC.compact_forward(carried, xi, xv), TC.compact_forward(cm_t, xi, xv))


def test_ffm_raises_as_in_jax():
    jcfg, tcfg = _base(use_fwfm=False, use_ffm=True, use_lw=False, use_fwlw=False)
    params = JD.init_params(jax.random.PRNGKey(0), jcfg)
    with pytest.raises(NotImplementedError, match="DeepLight families"):
        JC.compact_for_serving(params, jcfg)
    with pytest.raises(NotImplementedError, match="DeepLight families"):
        TC.compact_for_serving(_port(params), tcfg)


def test_compact_model_moves_and_keeps_its_float_codes_out_of_the_count():
    *_, cm = _both("int8")
    size = cm.size_bytes()
    moved = cm.to(torch.device("cpu"))
    assert moved is not cm and moved.size_bytes() == size
    codes = moved.deep_f
    assert moved.deep_f is codes and moved.size_bytes() == size        # made once, not counted
    assert all(f.dtype == torch.float32 and torch.equal(f, l["w_q"].float())
               for f, l in zip(codes["layers"], moved.deep["layers"]))
    assert _both("row_pruned")[-1].deep_f is None
    rows = moved.numeric_rows
    assert moved.numeric_rows is rows and rows["emb2"].dtype == torch.int32
    assert torch.equal(rows["emb2"], moved.emb2["remap"][:NUM])


# ---- the float32 copies of the int8 codes (ops/quantized.exact_int_matmul)

def _quantized(mode="dynamic"):
    jcfg, tcfg = _base()
    params = JD.init_params(jax.random.PRNGKey(1), jcfg)
    return jcfg, tcfg, params, TQ.convert(_port(params), tcfg, mode)


def test_exact_int_matmul_with_kept_codes_gives_the_same_bits():
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.integers(-127, 128, size=(9, 2100)).astype(np.int8))
    b = torch.from_numpy(rng.integers(-127, 128, size=(2100, 17)).astype(np.int8))
    want = a.to(torch.int64) @ b.to(torch.int64)
    plain = q_ops.exact_int_matmul(a, b)
    kept = q_ops.exact_int_matmul(a, b, q_ops.float_codes(b))
    assert plain.dtype == kept.dtype == torch.int32
    assert torch.equal(plain.to(torch.int64), want) and torch.equal(kept, plain)


def test_layerwise_int8_forward_converts_no_weight_per_call(monkeypatch):
    """The float32 copies are made once per model: later calls convert none,
    and the logits are those of the per-call conversion, bit for bit."""
    _, tcfg, _, qm = _quantized()
    xi, xv = (torch.from_numpy(a) for a in _inputs())
    calls = []
    real = q_ops.float_codes
    monkeypatch.setattr(q_ops, "float_codes", lambda w: calls.append(w.shape) or real(w))
    first = TQ.quantized_forward(qm, xi, xv)
    assert len(calls) == tcfg.h_depth + 1
    second = TQ.quantized_forward(qm, xi, xv)
    assert len(calls) == tcfg.h_depth + 1 and torch.equal(first, second)
    # without the kept copies: every layer converts, same bits
    net = qm.deep_q["net_1"]
    h = TQ.quantized_lookup_serving(qm.emb2_q, TD.make_embedding_spec(tcfg), xi, xv
                                    ).reshape(B, -1)
    for layer in net["layers"]:
        h = torch.relu(q_ops.quantized_dense(h, layer["w_q"], layer["w_scale"], layer["b"]))
    per_call = q_ops.quantized_dense(h, net["fc"]["w_q"], net["fc"]["w_scale"], None)
    kept = h
    assert len(calls) == 2 * (tcfg.h_depth + 1)
    h = TQ.quantized_lookup_serving(qm.emb2_q, TD.make_embedding_spec(tcfg), xi, xv
                                    ).reshape(B, -1)
    for layer, w_f in zip(net["layers"], qm.deep_f["net_1"]["layers"]):
        h = torch.relu(q_ops.quantized_dense(h, layer["w_q"], layer["w_scale"], layer["b"],
                                             w_f=w_f))
    assert torch.equal(h, kept)
    assert torch.equal(q_ops.quantized_dense(h, net["fc"]["w_q"], net["fc"]["w_scale"], None,
                                             w_f=qm.deep_f["net_1"]["fc"]), per_call)


@pytest.mark.parametrize("mode", ["dynamic", "static"])
def test_kept_codes_change_neither_size_nor_artifact_nor_logits(mode, tmp_path):
    jcfg, tcfg, params, qm = _quantized()
    xi, xv = _inputs()
    if mode == "static":
        scales = TQ.calibrate(_port(params), tcfg, xi, xv, n_batches=2, batch_size=32)
        qm = TQ.convert(_port(params), tcfg, "static", act_scales=scales)
        j_scales = JQ.calibrate(params, jcfg, xi, xv, n_batches=2, batch_size=32)
        qm_j = JQ.convert(params, jcfg, "static", act_scales=j_scales)
    else:
        qm_j = JQ.convert(params, jcfg, "dynamic")
    size = qm.size_bytes()
    assert size == qm_j.size_bytes()
    pred = TPredictor(qm, device="cpu")
    assert "deep_f" in vars(pred._model)               # made when the model moved
    assert pred._model.size_bytes() == size
    got = pred.logits(xi[2:], xv[2:])
    want = np.asarray(JQ.quantized_forward(qm_j, jnp.asarray(xi[2:]), jnp.asarray(xv[2:])))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    _save_quantized(pred._model, str(tmp_path / "art"))
    with np.load(str(tmp_path / "art.npz")) as data:
        assert not any("deep_f" in key for key in data.files)
        assert sum(data[key].nbytes for key in data.files) == size
