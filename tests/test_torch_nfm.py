"""The port's NFM, model factory and hashed-feature baseline against the JAX
package, on the CPU.

Parameters are made by the JAX package and cross with ``params_from_numpy``;
inputs come from numpy with a seed; dropout is off where two runs are
compared (the random streams differ). Forward and gradients: rtol and atol
1e-5 (float32 sums in another order). ``init_params`` draws from another
generator, so it is held to its shapes, names and statistics.
"""

import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from test_torch_serving import _port
from xsdeepfwfm_deprecated_tpu.config import TrainConfig as JTrain
from xsdeepfwfm_deprecated_tpu.models import hash_mlp_baseline as JH
from xsdeepfwfm_deprecated_tpu.models import nfm as JN
from xsdeepfwfm_deprecated_tpu.train import checkpoint as jckpt
from xsdeepfwfm_deprecated_torch import _tree, weights
from xsdeepfwfm_deprecated_torch.compression.pruning import prune_params
from xsdeepfwfm_deprecated_torch.config import ModelConfig, TrainConfig
from xsdeepfwfm_deprecated_torch.models import factory
from xsdeepfwfm_deprecated_torch.models import hash_mlp_baseline as TH
from xsdeepfwfm_deprecated_torch.models import nfm as TN
from xsdeepfwfm_deprecated_torch.train.trainer import DeepFMEstimator

F_SIZES = (1, 1, 8, 12, 20)
NUM = 2
B = 16
QUIET = logging.getLogger("test_torch_nfm")
QUIET.propagate = False
NO_DROPOUT = dict(is_shallow_dropout=False, is_deep_dropout=False)


def _cfgs(**kw):
    base = dict(field_size=5, feature_sizes=F_SIZES, numerical=NUM, embedding_size=4, h_depth=2,
                deep_nodes=16, use_fm=True, use_fwfm=False, use_deep=True)
    base.update(kw)
    return JN.NFMConfig(**base), TN.NFMConfig(**base)


def _batch(seed, b=B):
    rng = np.random.default_rng(seed)
    xi = rng.integers(0, [8, 12, 20], size=(b, 3)).astype(np.int32)
    xv = rng.normal(size=(b, NUM)).astype(np.float32)
    y = (rng.random(b) < 0.4).astype(np.float32)
    return xi, xv, y


CASES = [(inter, act) for inter in (True, False) for act in ("relu", "sigmoid", "tanh")]
CASE_IDS = [f"{'bi' if inter else 'pairwise'}-{act}" for inter, act in CASES]


@pytest.mark.parametrize("interaction,activation", CASES, ids=CASE_IDS)
def test_forward_matches_jax(interaction, activation):
    jcfg, tcfg = _cfgs(interaction_type=interaction, deep_activation=activation)
    params = JN.init_params(jax.random.PRNGKey(0), jcfg)
    xi, xv, _ = _batch(1)
    xi[0] = [30, -2, 19]          # out of range: the field's last and first rows
    want = np.asarray(JN.forward(params, jnp.asarray(xi), jnp.asarray(xv), jcfg))
    got = TN.forward(_port(params), torch.from_numpy(xi), torch.from_numpy(xv), tcfg)
    assert got.shape == (B,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    in_dim = 4 if interaction else 5 * 4 // 2
    assert params["deep"]["layers"][0]["w"].shape[0] == in_dim


@pytest.mark.parametrize("interaction,activation", CASES, ids=CASE_IDS)
def test_gradients_match_jax(interaction, activation):
    """Mean BCE of the eval-mode logits; every leaf's gradient against
    ``jax.grad``'s."""
    jcfg, tcfg = _cfgs(interaction_type=interaction, deep_activation=activation)
    params = JN.init_params(jax.random.PRNGKey(2), jcfg)
    xi, xv, y = _batch(3)

    def j_loss(p):
        logits = JN.forward(p, jnp.asarray(xi), jnp.asarray(xv), jcfg)
        return jnp.mean(optax.sigmoid_binary_cross_entropy(logits, jnp.asarray(y)))

    want = jax.grad(j_loss)(params)
    params_t = _port(params)
    leaves = [p.requires_grad_(True) for p in _tree.leaves(params_t)]
    loss = F.binary_cross_entropy_with_logits(
        TN.forward(params_t, torch.from_numpy(xi), torch.from_numpy(xv), tcfg),
        torch.from_numpy(y))
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(j_loss(params)), rtol=1e-5, atol=1e-6)
    names = [n for n, _ in _tree.named_leaves(params_t)]
    j_named = {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): np.asarray(g)
               for path, g in jax.tree_util.tree_flatten_with_path(want)[0]}
    assert set(names) == set(j_named)
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), j_named[name], rtol=1e-5, atol=1e-5, err_msg=name)


def test_train_mode_dropout_profile():
    """[0.0, p, p, ...]: nothing is dropped from the tower's input, the given
    share after each hidden layer; eval mode and a missing generator drop
    nothing."""
    _, tcfg = _cfgs(dropout_deep=0.5, deep_nodes=256, h_depth=1)
    params = TN.init_params(torch.Generator().manual_seed(0), tcfg, device="cpu")
    params["deep"]["layers"][0]["w"].zero_()
    params["deep"]["layers"][0]["b"].fill_(1.0)        # every hidden unit outputs 1
    params["emb1"]["dense"].zero_()
    params["bias"].zero_()
    xi, xv, _ = _batch(4, b=64)
    xi_t, xv_t = torch.from_numpy(xi), torch.from_numpy(xv)
    gen = torch.Generator().manual_seed(1)
    out = TN.forward(params, xi_t, xv_t, tcfg, train=True, generator=gen)
    kept = out / 2.0                                    # units kept, each scaled by 1/(1-p)
    assert torch.equal(kept, kept.round()) and 90 < float(kept.mean()) < 166
    assert torch.equal(TN.forward(params, xi_t, xv_t, tcfg), torch.full((64,), 256.0))
    assert torch.equal(TN.forward(params, xi_t, xv_t, tcfg, train=True),
                       torch.full((64,), 256.0))


def test_init_params_statistics_and_tree():
    sizes = (1, 1, 3000, 2000)
    kw = dict(field_size=4, feature_sizes=sizes, numerical=2, embedding_size=8, h_depth=2,
              deep_nodes=64, use_fm=True, use_fwfm=False, use_deep=True)
    jcfg, tcfg = JN.NFMConfig(**kw), TN.NFMConfig(**kw)
    want = JN.init_params(jax.random.PRNGKey(0), jcfg)
    got = TN.init_params(torch.Generator().manual_seed(0), tcfg, device="cpu")
    j_shapes = {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
                (tuple(leaf.shape), str(leaf.dtype))
                for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]}
    t_shapes = {n: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
                for n, t in _tree.named_leaves(got)}
    assert t_shapes == j_shapes
    assert "fc_w" not in got["deep"] and "net_1" not in got["deep"]
    for name in ("emb1", "emb2"):                       # torch's Embedding default: N(0, 1)
        t = got[name]["dense"]
        assert abs(float(t.mean())) < 0.05 and abs(float(t.std()) - 1.0) < 0.05
    for layer, fan_in in zip(got["deep"]["layers"], (8, 64)):   # Linear default: U(+-1/sqrt(in))
        bound = 1.0 / np.sqrt(fan_in)
        for t in (layer["w"], layer["b"]):
            assert float(t.abs().max()) <= bound
        assert abs(float(layer["w"].std()) - bound / np.sqrt(3)) < 0.1 * bound
        assert abs(float(layer["w"].mean())) < 0.1 * bound
    again = TN.init_params(torch.Generator().manual_seed(0), tcfg, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(_tree.leaves(got), _tree.leaves(again)))
    sane = TN.init_params(torch.Generator().manual_seed(0),
                          dataclasses.replace(tcfg, sane_init=True), device="cpu")
    assert float(sane["bias"][0]) == pytest.approx(0.01)
    assert abs(float(sane["emb2"]["dense"].std()) - 0.01) < 0.001
    meta = TN.init_params(None, tcfg, device="meta")
    assert all(t.device.type == "meta" for t in _tree.leaves(meta))
    assert [n for n, _ in _tree.named_leaves(meta)] == [n for n, _ in _tree.named_leaves(got)]
    pairwise = TN.init_params(torch.Generator().manual_seed(0),
                              dataclasses.replace(tcfg, interaction_type=False), device="cpu")
    assert pairwise["deep"]["layers"][0]["w"].shape == (4 * 3 // 2, 64)


def test_nfm_config_is_frozen_and_skips_the_family_check():
    base = dict(field_size=5, feature_sizes=F_SIZES, numerical=NUM)
    with pytest.raises(ValueError, match="only one of"):
        ModelConfig(use_fm=True, use_fwfm=True, **base)
    cfg = TN.NFMConfig(use_fm=True, use_fwfm=True, **base)        # NFM composes differently
    assert cfg.interaction_type and cfg.deep_activation == "relu" and not cfg.sane_init
    with pytest.raises(ValueError, match="length mismatch"):
        TN.NFMConfig(field_size=4, feature_sizes=F_SIZES, numerical=NUM)
    with pytest.raises(dataclasses.FrozenInstanceError):
        cfg.sane_init = True
    assert TN.make_spec(cfg).dense_rows == sum(F_SIZES) and not TN.make_spec(cfg).has_qr


def _fit_data(n, seed):
    rng = np.random.default_rng(seed)
    xi = rng.integers(0, [8, 12, 20], size=(n, 3)).astype(np.int32)
    xv = rng.normal(size=(n, NUM)).astype(np.float32)
    y = (rng.random(n) < 1 / (1 + np.exp(-xv[:, 0]))).astype(np.float32)
    return xi, xv, y


@pytest.mark.parametrize("refit", [False, True], ids=["fit", "refit"])
def test_estimator_fit_matches_jax(refit):
    """``NFMEstimator.fit`` in both packages from the same carried-across
    initial parameters, dropout off, two epochs with a padded tail batch; with
    ``refit`` the second fit goes on from the first's parameters on
    train+valid. Parameters rtol 1e-4, atol 2e-5 and metrics 1e-6, as
    ``tests/test_torch_train.py::test_fit_matches_jax_fit``."""
    jcfg, tcfg = _cfgs(sane_init=True, **NO_DROPOUT)
    kw = dict(n_epochs=2, batch_size=32, learning_rate=1e-2)
    est_j = JN.NFMEstimator(jcfg, JTrain(table_layout="flat", **kw))
    est_t = TN.NFMEstimator(tcfg, TrainConfig(**kw), logger=QUIET, device="cpu")
    est_j.init_params()
    est_t.params = _port(est_j.params)
    xi, xv, y = _fit_data(150, seed=1)
    xi_v, xv_v, y_v = _fit_data(70, seed=2)
    est_j.fit(xi, xv, y, xi_v, xv_v, y_v, refit=refit)
    est_t.fit(xi, xv, y, xi_v, xv_v, y_v, refit=refit)
    assert est_t._step == est_j._step == (10 + 14 if refit else 10)
    for (name, got), want in zip(_tree.named_leaves(est_t.params),
                                 _tree.leaves(_port(est_j.params))):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=2e-5, err_msg=name)
    np.testing.assert_allclose(est_t.train_result, est_j.train_result, rtol=0, atol=1e-6)
    assert len(est_t.valid_result) == (0 if refit else 2)
    np.testing.assert_allclose(est_t.eval_by_batch(xi_v, xv_v, y_v),
                               est_j.eval_by_batch(xi_v, xv_v, y_v), rtol=0, atol=1e-6)


def test_estimator_surface_on_the_nfm_tree(tmp_path):
    """What assumes the DeepFwFM tree elsewhere works on NFM's: the counts,
    the size report, a prune refresh (key order kept) and checkpoints, both
    ways between the packages."""
    jcfg, tcfg = _cfgs(sane_init=True)
    est = TN.NFMEstimator(tcfg, TrainConfig(n_epochs=1, batch_size=32), logger=QUIET,
                          device="cpu")
    xi, xv, y = _fit_data(100, seed=3)
    est.fit(xi, xv, y)
    assert est.print_size_of_model() == sum(t.numel() * 4 for t in _tree.leaves(est.params))
    pruned = prune_params(est.params, 0.5, prune_fm=True, prune_deep=True)
    assert [n for n, _ in _tree.named_leaves(pruned)] == \
        [n for n, _ in _tree.named_leaves(est.params)]
    w = pruned["deep"]["layers"][1]["w"]
    assert abs(1.0 - float(torch.count_nonzero(w)) / w.numel() - 0.5) < 0.01
    assert torch.equal(pruned["deep"]["layers"][1]["b"], est.params["deep"]["layers"][1]["b"])
    # port -> JAX
    path = str(tmp_path / "nfm_t")
    est.save(path)
    j_params = jckpt.load_checkpoint(path, JN.init_params(jax.random.PRNGKey(0), jcfg))[0]
    want = np.asarray(JN.forward(j_params, jnp.asarray(xi), jnp.asarray(xv), jcfg))
    np.testing.assert_allclose(est._predict_logits(xi, xv), want, rtol=1e-5, atol=1e-5)
    # JAX -> port, through the template of the NFM family
    jpath = str(tmp_path / "nfm_j")
    jckpt.save_checkpoint(jpath, j_params)
    loaded = weights.load_jax_checkpoint(jpath, tcfg, device="cpu", init_fn=TN.init_params)
    assert all(torch.equal(a, b) for a, b in zip(_tree.leaves(loaded), _tree.leaves(est.params)))
    fresh = TN.NFMEstimator(tcfg, est.tcfg, logger=QUIET, device="cpu").load(jpath)
    assert np.array_equal(fresh._predict_logits(xi, xv), est._predict_logits(xi, xv))
    with pytest.raises(KeyError):        # the DeepFwFM template does not name NFM's entries
        weights.load_jax_checkpoint(jpath, ModelConfig(
            field_size=5, feature_sizes=F_SIZES, numerical=NUM, embedding_size=4, h_depth=2,
            deep_nodes=16, use_fm=True, use_fwfm=False), device="cpu")


# ---- models/factory

def test_get_model_builds_the_estimator_from_flags_or_configs():
    from xsdeepfwfm_deprecated_torch.config import get_parser
    pars = get_parser().parse_args(["-deep_nodes", "8", "-h_depth", "2", "-embedding_size", "4",
                                    "-numerical", "2", "-use_cuda", "1"])
    est = factory.get_model(5, F_SIZES, pars=pars, logger=QUIET, device="cpu")
    assert isinstance(est, DeepFMEstimator) and est.device.type == "cpu"   # -use_cuda is dead
    assert est.mcfg.deep_layers == (8, 8) and est.mcfg.feature_sizes == F_SIZES
    qat = factory.get_model(5, F_SIZES, pars=pars, logger=QUIET, device="cpu",
                            quantization_aware=True, ignored_compat_flag=1)
    assert qat.mcfg.quantization_aware and not qat.mcfg.dynamic_quantization
    explicit = factory.get_model(5, F_SIZES, model_cfg=est.mcfg, train_cfg=est.tcfg,
                                 logger=QUIET, device="cpu")
    assert explicit.mcfg is est.mcfg and explicit.tcfg is est.tcfg
    with pytest.raises(AssertionError, match="pars or explicit"):
        factory.get_model(5, F_SIZES, device="cpu")


# ---- models/hash_mlp_baseline

@pytest.mark.parametrize("hash_dim,seed", [(2048, 0x9E3779B1), (64, 7), (1000, 0)])
def test_hash_features_equal_the_jax_package(hash_dim, seed):
    """numpy uint64 arithmetic that wraps around: the same buckets, exactly."""
    rng = np.random.default_rng(5)
    index = rng.integers(0, 2**31 - 1, size=(40, 7))
    index[0] = 0
    index[1] = 2**31 - 1
    want = JH.hash_features(index, hash_dim, seed)
    got = TH.hash_features(index, hash_dim, seed)
    assert got.dtype == want.dtype == np.float32 and np.array_equal(got, want)
    assert np.all(got.sum(axis=1) == 7)


def test_hash_mlp_forward_matches_jax_and_the_baseline_learns():
    params = JH.init_params(jax.random.PRNGKey(0), 20, hidden=(16, 8))
    x = np.random.default_rng(6).normal(size=(12, 20)).astype(np.float32)
    want = np.asarray(JH.forward(params, jnp.asarray(x)))
    got = TH.forward(_port(params), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    t_params = TH.init_params(torch.Generator().manual_seed(0), 20, hidden=(16, 8), device="cpu")
    assert [tuple(l["w"].shape) for l in t_params["layers"]] == [(20, 16), (16, 8), (8, 1)]

    rng = np.random.default_rng(7)
    index = rng.integers(0, 50, size=(600, 4))
    value = rng.normal(size=(600, 3)).astype(np.float32)
    y = ((index[:, 0] % 2 == 0) ^ (rng.random(600) < 0.1)).astype(np.float32)
    tc = TrainConfig(n_epochs=15, batch_size=64, learning_rate=1e-2, random_seed=0)
    base = TH.HashMLPBaseline(hash_dim=128, hidden=(32, 16), train_cfg=tc, logger=QUIET,
                              device="cpu").fit(index, value, y)
    auc, prauc, rce = base.evaluate(index, value, y)
    assert auc > 0.8 and np.isfinite(prauc) and np.isfinite(rce)
    assert base.predict_proba(index[:5], value[:5]).shape == (5,)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TH.HashMLPBaseline()
