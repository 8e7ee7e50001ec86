"""Checkpoints cross between the packages, on the CPU: what the JAX package
writes the port loads, and what the port writes loads through the JAX
package's ``load_checkpoint`` with JAX templates. Dense and COO entries,
parameters and optimizer state, bf16 tables, and a resume that crosses from
one package to the other.

Stored values are compared exactly: a checkpoint is a copy, not arithmetic.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_serving import _port
from test_torch_train import (NO_DROPOUT, OPTIMIZERS, QUIET, assert_trees_close, j_leaves,
                              to_jax, to_torch)
from xsdeepfwfm_deprecated_tpu.compression import pruning as JP
from xsdeepfwfm_deprecated_tpu.config import ModelConfig as JConfig
from xsdeepfwfm_deprecated_tpu.config import TrainConfig as JTrain
from xsdeepfwfm_deprecated_tpu.models import deepfwfm as JD
from xsdeepfwfm_deprecated_tpu.train import checkpoint as jckpt
from xsdeepfwfm_deprecated_tpu.train import trainer as JT
from xsdeepfwfm_deprecated_torch import _tree, weights
from xsdeepfwfm_deprecated_torch.config import ModelConfig as TConfig
from xsdeepfwfm_deprecated_torch.config import TrainConfig as TTrain
from xsdeepfwfm_deprecated_torch.models import deepfwfm as TD
from xsdeepfwfm_deprecated_torch.train import checkpoint as tckpt
from xsdeepfwfm_deprecated_torch.train import trainer as TT

SIZES = (1, 50, 60, 70)      # 181 rows x 8: above the 1,024 elements a COO entry needs
CFG = dict(field_size=4, feature_sizes=SIZES, numerical=1, embedding_size=8, h_depth=2,
           deep_nodes=40, use_fwfm=True, use_deep=True, use_lw=True, use_fwlw=True, **NO_DROPOUT)
B = 16


def batch(seed, b=B):
    rng = np.random.default_rng(seed)
    return dict(xi=rng.integers(0, SIZES[1:], size=(b, 3)).astype(np.int32),
                xv=rng.normal(size=(b, 1)).astype(np.float32),
                y=(rng.random(b) < 0.4).astype(np.float32), mask=np.ones(b, np.float32))


def trained_pair(train_kw, steps=2, table_dtype="f32"):
    """Both packages' (params, optimizer, state) after ``steps`` JAX train steps."""
    jcfg, tcfg = JConfig(**CFG, table_dtype=table_dtype), TConfig(**CFG, table_dtype=table_dtype)
    jt, tt = JTrain(**train_kw), TTrain(**train_kw)
    params = JD.init_params(jax.random.PRNGKey(0), jcfg)
    opt = JT.make_optimizer(jt)
    state = opt.init(params)
    step = JT.make_train_step(jcfg, jt, opt)
    for i in range(steps):
        params, state, _ = step(params, state, *to_jax(batch(i)), jax.random.PRNGKey(0),
                                jnp.zeros(B))
    return (jcfg, jt, params, opt, state), (tcfg, tt)


@pytest.mark.parametrize("wd", [0.0, 3e-7], ids=["no_l2", "l2"])
@pytest.mark.parametrize("kind", list(OPTIMIZERS))
def test_jax_checkpoint_loads_in_the_port(tmp_path, kind, wd):
    """Params and optimizer state for every optimizer, with and without the
    weight-decay level of the chain. The ``opt::`` names are the ones that
    flattening the JAX state gives, and the port's own state has the same."""
    kw = dict(OPTIMIZERS[kind], weight_decay=wd)
    (jcfg, jt, params, opt, state), (tcfg, tt) = trained_pair(kw)
    path = str(tmp_path / "ckpt")
    jckpt.save_checkpoint(path, params, state, step=2, epoch=1, metadata={"model": "x"})
    template = TD.init_params(None, tcfg, device="meta")
    state_template = TT.make_optimizer(tt).init(template)
    assert set(t_leaves_names(state_template)) == set(j_leaves(state))
    got_p, got_s, meta = tckpt.load_checkpoint(path, template, state_template, device="cpu")
    assert_trees_close(got_p, params, rtol=0, atol=0)
    assert_trees_close(got_s, state, rtol=0, atol=0)
    assert meta == {"model": "x", "step": 2, "epoch": 1}
    assert all(t.device.type == "cpu" for t in _tree.leaves(got_p) + _tree.leaves(got_s))
    via_weights = weights.load_train_state(path, tcfg, tt, device="cpu")
    assert_trees_close(via_weights[1], state, rtol=0, atol=0)
    assert_trees_close(weights.load_jax_checkpoint(path, tcfg, device="cpu"), params, rtol=0,
                       atol=0)


def t_leaves_names(tree):
    return [name for name, _ in _tree.named_leaves(tree)]


@pytest.mark.parametrize("wd", [0.0, 3e-7], ids=["no_l2", "l2"])
@pytest.mark.parametrize("kind", list(OPTIMIZERS))
def test_port_checkpoint_loads_in_jax(tmp_path, kind, wd):
    """The reverse, through the JAX package's ``load_checkpoint`` with JAX
    templates (fresh params and ``optimizer.init``)."""
    kw = dict(OPTIMIZERS[kind], weight_decay=wd)
    (jcfg, jt, params, opt, state), (tcfg, tt) = trained_pair(kw, steps=0)
    params_t = _port(params)
    opt_t = TT.make_optimizer(tt)
    state_t = opt_t.init(params_t)
    for i in range(2):
        TT.train_step(params_t, state_t, to_torch(batch(i)), tcfg, tt, opt_t)
    path = str(tmp_path / "ckpt")
    tckpt.save_checkpoint(path, params_t, state_t, step=2, epoch=0, metadata={"seed": 7})
    got_p, got_s, meta = jckpt.load_checkpoint(path, params, opt.init(params))
    assert_trees_close(params_t, got_p, rtol=0, atol=0)
    assert_trees_close(state_t, got_s, rtol=0, atol=0)
    assert jax.tree.structure(got_s) == jax.tree.structure(state)
    assert meta == {"seed": 7, "step": 2, "epoch": 0}
    if kind == "adam":
        count = j_leaves(got_s)["1/0/count" if wd else "0/count"]
        assert count.dtype == np.int32 and int(count) == 2


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_coo_entries_cross(tmp_path, writer):
    """A pruned model saved with ``sparse=True``: tables and weights that are
    more than half zero are stored as index, value and shape, in both
    packages by the same rule, and load back dense in the other."""
    (jcfg, jt, params, opt, state), (tcfg, tt) = trained_pair(dict(optimizer_type="adam"))
    params = JP.prune_params(params, jnp.float32(0.8), prune_fm=True, prune_deep=True,
                             prune_r=True)
    params_t, state_t = _port(params), _port_state(state, tt, params)
    path = str(tmp_path / "ckpt")
    if writer == "jax":
        jckpt.save_checkpoint(path, params, state, sparse=True)
    else:
        tckpt.save_checkpoint(path, params_t, state_t, sparse=True)
    with np.load(path + ".npz") as data:
        names = set(data.files)
    assert "params::emb2/dense@idx" in names and "params::emb2/dense" not in names
    assert "params::deep/net_1/layers/0/w@shape" in names
    assert "params::bias" in names and "opt::1/0/mu/emb2/dense" in names
    other = str(tmp_path / "other")
    (tckpt if writer == "jax" else jckpt).save_checkpoint(
        other, *((params_t, state_t) if writer == "jax" else (params, state)), sparse=True)
    with np.load(other + ".npz") as data:
        assert set(data.files) == names
    got_p, got_s, _ = tckpt.load_checkpoint(path, params_t, state_t, device="cpu")
    assert_trees_close(got_p, params, rtol=0, atol=0)
    assert_trees_close(got_s, state, rtol=0, atol=0)
    got_p, got_s, _ = jckpt.load_checkpoint(path, params, state)
    assert_jax_trees_equal(got_p, params)
    assert_jax_trees_equal(got_s, state)


def _port_state(state, tt, params):
    """The JAX optimizer state as the port's tree: through the names."""
    flat = {k: torch.from_numpy(np.array(v)) for k, v in j_leaves(state).items()}
    return _tree.rebuild(TT.make_optimizer(tt).init(_port(params)), flat)


def assert_jax_trees_equal(got, want):
    got, want = j_leaves(got), j_leaves(want)
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_bf16_tables_are_stored_widened_and_cast_back(tmp_path):
    (jcfg, jt, params, opt, state), (tcfg, tt) = trained_pair(
        dict(optimizer_type="adam"), table_dtype="bf16")
    assert params["emb2"]["dense"].dtype == jnp.bfloat16
    path = str(tmp_path / "from_jax")
    jckpt.save_checkpoint(path, params, state)
    template = TD.init_params(None, tcfg, device="meta")
    got_p, got_s, _ = tckpt.load_checkpoint(path, template, TT.make_optimizer(tt).init(template),
                                            device="cpu")
    assert got_p["emb2"]["dense"].dtype == torch.bfloat16
    assert dict(_tree.named_leaves(got_s))["1/0/mu/emb2/dense"].dtype == torch.bfloat16
    assert_trees_close(got_p, params, rtol=0, atol=0)
    assert_trees_close(got_s, state, rtol=0, atol=0)
    back = str(tmp_path / "from_port")
    tckpt.save_checkpoint(back, got_p, got_s)
    with np.load(back + ".npz") as data:
        assert data["params::emb2/dense"].dtype == np.float32
    again_p, again_s, _ = jckpt.load_checkpoint(back, params, state)
    assert again_p["emb2"]["dense"].dtype == jnp.bfloat16
    assert_jax_trees_equal(again_p, params)
    assert_jax_trees_equal(again_s, state)
    assert tckpt.model_size_bytes(got_p) == jckpt.model_size_bytes(params)


def test_strict_missing_shape_and_backend(tmp_path):
    tcfg = TConfig(**CFG)
    params = TD.init_params(torch.Generator().manual_seed(0), tcfg, device="cpu")
    path = str(tmp_path / "dir" / "ckpt")
    assert not tckpt.checkpoint_exists(path)
    tckpt.save_checkpoint(path, {"bias": params["bias"], "field_cov": params["field_cov"]})
    assert tckpt.checkpoint_exists(path) and tckpt.checkpoint_exists(path + ".npz")
    with pytest.raises(KeyError, match="checkpoint missing params::"):
        tckpt.load_checkpoint(path, params, device="cpu")
    other = TD.init_params(torch.Generator().manual_seed(1), tcfg, device="cpu")
    got, opt_state, meta = tckpt.load_checkpoint(path, other, strict=False, device="cpu")
    assert opt_state is None and meta == {"step": 0, "epoch": 0}
    assert torch.equal(got["field_cov"], params["field_cov"])          # from the file
    assert torch.equal(got["emb2"]["dense"], other["emb2"]["dense"])   # the template's own
    wrong = TD.init_params(None, TConfig(**{**CFG, "embedding_size": 4}), device="meta")
    tckpt.save_checkpoint(path, params)
    with pytest.raises(ValueError, match="has shape"):
        tckpt.load_checkpoint(path, wrong, device="cpu")
    with pytest.raises(ValueError, match="npz only"):
        tckpt.save_checkpoint(path, params, backend="orbax")
    assert tckpt.wait_for_saves() is None
    assert tckpt.SPARSE_THRESHOLD == jckpt.SPARSE_THRESHOLD
    with open(str(tmp_path / "dir" / "ckpt.meta.json")) as f:
        assert json.load(f) == {"step": 0, "epoch": 0}


def fit_data(n, seed):
    big = batch(seed, n)
    return big["xi"], big["xv"], big["y"]


def estimators(train_kw):
    est_j = JT.DeepFMEstimator(JConfig(**CFG), JTrain(table_layout="flat", **train_kw),
                               logger=QUIET)
    est_t = TT.DeepFMEstimator(TConfig(**CFG), TTrain(table_layout="flat", **train_kw),
                               logger=QUIET, device="cpu")
    return est_j, est_t


def test_estimator_save_and_load_cross(tmp_path):
    """``save`` of one package's estimator, ``load`` of the other's: the same
    logits (rtol/atol 1e-5, float32 sums in another order), the step counter
    and the metadata."""
    est_j, est_t = estimators(dict(n_epochs=1, batch_size=B))
    xi, xv, y = fit_data(50, seed=1)
    est_j.fit(xi, xv, y, save_path=str(tmp_path / "j"))
    est_t.fit(xi, xv, y, save_path=str(tmp_path / "t"))
    _, loaded_t = estimators(dict())
    loaded_t.load(str(tmp_path / "j"))
    assert loaded_t._step == 4
    np.testing.assert_allclose(loaded_t._predict_logits(xi, xv), est_j._predict_logits(xi, xv),
                               rtol=1e-5, atol=1e-5)
    loaded_j, _ = estimators(dict())
    loaded_j.load(str(tmp_path / "t"))
    assert loaded_j._step == 4
    np.testing.assert_allclose(loaded_j._predict_logits(xi, xv), est_t._predict_logits(xi, xv),
                               rtol=1e-5, atol=1e-5)
    with open(str(tmp_path / "t.meta.json")) as f_t, open(str(tmp_path / "j.meta.json")) as f_j:
        assert json.load(f_t) == json.load(f_j)
    assert est_t.print_size_of_model() == est_j.print_size_of_model()
    _, reloaded = estimators(dict())
    reloaded.load(str(tmp_path / "t"))
    assert all(torch.equal(a, b) for a, b in zip(_tree.leaves(reloaded.params),
                                                 _tree.leaves(est_t.params)))


@pytest.mark.parametrize("first", ["jax", "port"])
def test_crossed_resume_equals_an_uninterrupted_run(tmp_path, first):
    """Two steps in one package, a checkpoint, two more in the other, against
    four steps in the JAX package: parameters and optimizer state within the
    tolerance of the train-step test (atol 2e-6, rtol 1e-5)."""
    kw = dict(optimizer_type="adam", weight_decay=3e-7)
    (jcfg, jt, want_p, opt, want_s), (tcfg, tt) = trained_pair(kw, steps=4)
    (_, _, params, _, state), _ = trained_pair(kw, steps=0)
    path = str(tmp_path / "ckpt")
    opt_t = TT.make_optimizer(tt)
    step_j = JT.make_train_step(jcfg, jt, opt)
    if first == "jax":
        (_, _, params, _, state), _ = trained_pair(kw, steps=2)
        jckpt.save_checkpoint(path, params, state, step=2)
        params_t, state_t, meta = weights.load_train_state(path, tcfg, tt, device="cpu")
        for i in (2, 3):
            TT.train_step(params_t, state_t, to_torch(batch(i)), tcfg, tt, opt_t)
        assert_trees_close(params_t, want_p, rtol=1e-5, atol=2e-6)
        assert_trees_close(state_t, want_s, rtol=1e-5, atol=2e-6)
    else:
        params_t = _port(params)
        state_t = opt_t.init(params_t)
        for i in (0, 1):
            TT.train_step(params_t, state_t, to_torch(batch(i)), tcfg, tt, opt_t)
        tckpt.save_checkpoint(path, params_t, state_t, step=2)
        params, state, meta = jckpt.load_checkpoint(path, params, state)
        for i in (2, 3):
            params, state, _ = step_j(params, state, *to_jax(batch(i)), jax.random.PRNGKey(0),
                                      jnp.zeros(B))
        for got, want in ((params, want_p), (state, want_s)):
            got, want = j_leaves(got), j_leaves(want)
            for name in want:
                np.testing.assert_allclose(got[name], want[name], rtol=1e-5, atol=2e-6,
                                           err_msg=name)
    assert meta["step"] == 2


def test_fit_resumes_from_a_jax_checkpoint_like_jax(tmp_path):
    """One epoch in the JAX estimator with a per-epoch checkpoint, then
    ``fit(resume_from=...)`` to the second epoch in both: the same epoch
    counter, step counter and final parameters (atol 2e-5, rtol 1e-4 as in the
    fit test)."""
    kw = dict(n_epochs=1, batch_size=B, learning_rate=1e-2)
    est_j, _ = estimators(kw)
    xi, xv, y = fit_data(70, seed=2)
    path = str(tmp_path / "epoch")
    est_j.fit(xi, xv, y, save_path=path)
    cont_j, cont_t = estimators(dict(kw, n_epochs=2))
    cont_j.fit(xi, xv, y, resume_from=path)
    cont_t.fit(xi, xv, y, resume_from=path)
    assert cont_t._step == cont_j._step == 10
    assert len(cont_t.train_result) == len(cont_j.train_result) == 1
    assert_trees_close(cont_t.params, cont_j.params, rtol=1e-4, atol=2e-5,
                       field_cov_diag_atol=1e-3)
    np.testing.assert_allclose(cont_t.train_result, cont_j.train_result, rtol=0, atol=1e-6)
