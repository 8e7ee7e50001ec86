"""The port's DeepLight pruning against the JAX package, on the CPU: the cases
of ``tests/test_pruning.py`` on both packages, and a pruned ``fit`` whose
sparsity trajectory equals the JAX estimator's.

Thresholds are compared with a relative tolerance, because ``log``/``exp``
(the bisection) and the quantile's interpolation differ in the last bit
between XLA and PyTorch. Zero patterns are compared by count: where a test
gives both thresholds to one array, a value that lies between the two may
fall on either side, so the counts may differ by one; everywhere else they
are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_serving import _port
from test_torch_train import NO_DROPOUT, QUIET, assert_trees_close, j_leaves, t_leaves
from xsdeepfwfm_deprecated_tpu.compression import pruning as JP
from xsdeepfwfm_deprecated_tpu.config import ModelConfig as JConfig
from xsdeepfwfm_deprecated_tpu.config import TrainConfig as JTrain
from xsdeepfwfm_deprecated_tpu.models import deepfwfm as JD
from xsdeepfwfm_deprecated_tpu.train import trainer as JT
from xsdeepfwfm_deprecated_torch import _tree
from xsdeepfwfm_deprecated_torch.compression import pruning as TP
from xsdeepfwfm_deprecated_torch.config import ModelConfig as TConfig
from xsdeepfwfm_deprecated_torch.config import TrainConfig as TTrain
from xsdeepfwfm_deprecated_torch.models import deepfwfm as TD
from xsdeepfwfm_deprecated_torch.train import trainer as TT

THR_RTOL = 1e-5   # last-bit differences of log / exp / lerp between XLA and PyTorch


def both_thresholds(w, target):
    got = float(TP.magnitude_threshold(torch.from_numpy(w), target))
    want = float(JP.magnitude_threshold(jnp.asarray(w), jnp.float32(target)))
    return got, want


def test_constants_match():
    assert (TP.BISECT_SIZE, TP.BISECT_ITERS) == (JP.BISECT_SIZE, JP.BISECT_ITERS)


@pytest.mark.parametrize("target", [0.1, 0.5, 0.9])
def test_magnitude_threshold_small_is_the_quantile(target):
    w = np.random.default_rng(0).normal(size=(1000,)).astype(np.float32)
    got, want = both_thresholds(w, target)
    assert got == pytest.approx(want, rel=THR_RTOL)
    assert abs(np.mean(np.abs(w) < got) - target) < 0.01
    assert np.sum(np.abs(w) < got) == np.sum(np.abs(w) < want)


@pytest.mark.parametrize("target", [0.05, 0.4, 0.9])
def test_bisection_threshold_matches_quantile_large(target):
    w = np.random.default_rng(1).normal(size=(TP.BISECT_SIZE + 7,)).astype(np.float32)
    got, want = both_thresholds(w, target)
    assert got == pytest.approx(want, rel=THR_RTOL)
    assert abs(np.mean(np.abs(w) < got) - target) < 1e-4
    assert abs(got - float(np.quantile(np.abs(w), target))) < 1e-4
    assert abs(int(np.sum(np.abs(w) < got)) - int(np.sum(np.abs(w) < want))) <= 1


@pytest.mark.parametrize("target", [0.02, 0.30, 0.79])
def test_bisection_resolves_collapsed_row_cluster(target):
    """80% of the values sit at |w| ~ 1e-20, where rows that no batch samples
    end up under Adam+L2. A linear search would return a threshold above the
    whole cluster; the log-space search must land inside it and prune only
    the target."""
    rng = np.random.default_rng(3)
    n = TP.BISECT_SIZE * 4
    w = rng.normal(size=(n,)).astype(np.float32) * 0.01
    k = int(n * 0.8)
    w[:k] = (np.abs(rng.normal(size=(k,))) + 0.1) * np.float32(1e-20)
    got, want = both_thresholds(w, target)
    assert got == pytest.approx(want, rel=THR_RTOL)
    w64 = np.abs(w).astype(np.float64)
    assert abs(np.mean(w64 < got) - target) < 1e-3
    assert got < 5e-18
    assert abs(int(np.sum(w64 < got)) - int(np.sum(w64 < want))) <= 1


def test_zero_target_prunes_nothing():
    w = np.random.default_rng(2).normal(size=(TP.BISECT_SIZE + 3,)).astype(np.float32)
    w[: w.size // 2] = 1e-31
    for values in (w, w[:100]):                       # the bisection and the quantile
        thr = TP.magnitude_threshold(torch.from_numpy(values), 0.0)
        assert float(thr) == 0.0
        assert int((TP.apply_threshold(torch.from_numpy(values), thr) == 0).sum()) == 0


def test_threshold_takes_a_tensor_target_and_clips_it():
    w = torch.from_numpy(np.random.default_rng(4).normal(size=(500,)).astype(np.float32))
    assert float(TP.magnitude_threshold(w, torch.tensor(0.5))) == \
        float(TP.magnitude_threshold(w, 0.5))
    assert float(TP.magnitude_threshold(w, 1.7)) == float(w.abs().max())


def test_apply_threshold():
    w = torch.tensor([-0.5, 0.01, 0.3, -0.02])
    out = TP.apply_threshold(w, torch.tensor(0.1))
    np.testing.assert_allclose(out.numpy(), [-0.5, 0.0, 0.3, 0.0], atol=1e-7)


PRUNE_CFG = dict(field_size=4, feature_sizes=(1, 50, 60, 70), numerical=1, embedding_size=8,
                 h_depth=2, deep_nodes=32, use_fwfm=True, use_deep=True, use_fwlw=True)


@pytest.fixture(scope="module")
def dfm_params():
    params = JD.init_params(jax.random.PRNGKey(0), JConfig(**PRUNE_CFG))
    return params, _port(params)


def zero_share(t):
    return float((t == 0).float().mean())


def test_prune_groups(dfm_params):
    params_j, params_t = dfm_params
    kw = dict(prune_fm=True, prune_deep=True, prune_r=True)
    pruned = TP.prune_params(params_t, 0.6, **kw)
    assert abs(zero_share(pruned["emb2"]["dense"]) - 0.6) < 0.02           # group (a)
    for layer in pruned["deep"]["net_1"]["layers"]:                        # group (b)
        assert abs(zero_share(layer["w"]) - 0.6) < 0.05
        assert zero_share(layer["b"]) < 0.2
    assert zero_share(pruned["deep"]["net_1"]["fc_w"]) == 0.0
    assert zero_share(pruned["fwlw_w"]) > 0.3
    assert zero_share(pruned["field_cov"]) > 0.3                           # group (c)
    # the same zeros and the same survivors as the JAX package
    want = JP.prune_params(params_j, jnp.float32(0.6), **kw)
    assert_trees_close(pruned, want, rtol=0, atol=0)
    # the input's tensors are left as they were
    assert_trees_close(params_t, params_j, rtol=0, atol=0)


def test_group_ratios(dfm_params):
    params_j, params_t = dfm_params
    kw = dict(emb_r=0.5, emb_corr=2.0, prune_fm=True, prune_deep=False, prune_r=True)
    pruned = TP.prune_params(params_t, 0.5, **kw)
    assert abs(zero_share(pruned["emb2"]["dense"]) - 0.25) < 0.03   # 0.5 * emb_r
    assert zero_share(pruned["field_cov"]) > 0.8                    # 0.5 * emb_corr, clipped to 1
    assert zero_share(pruned["deep"]["net_1"]["layers"][0]["w"]) == 0.0
    assert_trees_close(pruned, JP.prune_params(params_j, jnp.float32(0.5), **kw), rtol=0, atol=0)


def test_field_cov_is_thresholded_on_its_symmetrized_half_sum():
    r = torch.tensor([[1.0, 4.0, 0.1], [-4.0, 2.0, 0.3], [0.1, 0.1, 3.0]])
    params = {"field_cov": r}
    out = TP.prune_params(params, 0.5, prune_fm=False, prune_deep=False, prune_r=True)
    # the half-sum of (0, 1) and (1, 0) is 0, so both large entries go, in place
    assert out["field_cov"][0, 1] == 0 and out["field_cov"][1, 0] == 0
    want = JP.prune_params({"field_cov": jnp.asarray(r.numpy())}, jnp.float32(0.5),
                           prune_fm=False, prune_deep=False, prune_r=True)
    np.testing.assert_array_equal(out["field_cov"].numpy(), np.asarray(want["field_cov"]))


def test_structured_deep_prunes_whole_units(dfm_params):
    params_j, params_t = dfm_params
    kw = dict(prune_fm=False, prune_deep=True, structured_deep=True)
    pruned = TP.prune_params(params_t, 0.5, **kw)
    for layer in pruned["deep"]["net_1"]["layers"]:
        dead = (layer["w"] == 0).all(dim=0)
        assert int(dead.sum()) == 16
        assert bool((layer["b"][dead] == 0).all()) and bool((layer["b"][~dead] != 0).all())
        assert bool((layer["w"][:, ~dead] != 0).all())
    assert_trees_close(pruned, JP.prune_params(params_j, jnp.float32(0.5), **kw), rtol=0, atol=0)


def test_embedding_threshold_is_global_over_dense_q_and_r():
    """One threshold over all three tables: with the small-valued q table
    taking the whole target, dense and r keep everything."""
    rng = np.random.default_rng(5)
    tables = {"dense": rng.normal(size=(40, 4)).astype(np.float32) + 5.0,
              "q": rng.normal(size=(40, 4)).astype(np.float32) * 1e-3,
              "r": rng.normal(size=(20, 4)).astype(np.float32) + 5.0}
    pruned = TP.prune_params({"emb2": _port(tables)}, 0.2, prune_deep=False)["emb2"]
    assert zero_share(pruned["dense"]) == 0 and zero_share(pruned["r"]) == 0
    assert zero_share(pruned["q"]) == pytest.approx(0.5, abs=0.01)
    want = JP.prune_params({"emb2": jax.tree.map(jnp.asarray, tables)}, jnp.float32(0.2),
                           prune_deep=False)
    assert_trees_close({"emb2": pruned}, want, rtol=0, atol=0)


def test_dense_rows_leaves_padding_out_of_the_threshold():
    rng = np.random.default_rng(6)
    real = rng.normal(size=(100, 4)).astype(np.float32)
    padded = np.concatenate([real, np.zeros((60, 4), np.float32)])
    out = TP.prune_params({"emb2": {"dense": torch.from_numpy(padded)}}, 0.3, prune_deep=False,
                          dense_rows=100)["emb2"]["dense"]
    assert zero_share(out[:100]) == pytest.approx(0.3, abs=0.01)
    want = JP.prune_params({"emb2": {"dense": jnp.asarray(padded)}}, jnp.float32(0.3),
                           prune_deep=False, dense_rows=100)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want["emb2"]["dense"]))


def test_adaptive_schedule():
    tc = TTrain(sparse=0.9)
    assert tc.adaptive_sparse(0) == 0.0
    assert tc.adaptive_sparse(100) == pytest.approx(0.9 * (1 - 0.99), rel=1e-6)
    assert tc.adaptive_sparse(100000) == pytest.approx(0.9, abs=1e-4)


def test_sparsity_report_and_masks(dfm_params):
    params_j, params_t = dfm_params
    assert TP.sparsity_report(params_t) == JP.sparsity_report(params_j)
    kw = dict(prune_fm=True, prune_deep=True, prune_r=True)
    pruned = TP.prune_params(params_t, 0.9, **kw)
    rep = TP.sparsity_report(pruned)
    assert rep == JP.sparsity_report(JP.prune_params(params_j, jnp.float32(0.9), **kw))
    assert rep["sparsity_pct"] > 40
    masks = TP.make_masks(pruned, TConfig(**PRUNE_CFG))
    for (name, m), (_, p) in zip(_tree.named_leaves(masks), _tree.named_leaves(pruned)):
        assert m.dtype == p.dtype and torch.equal(m != 0, p != 0), name
    cfg = TConfig(**PRUNE_CFG)
    assert TD.param_group_counts(pruned, cfg, nonzero=True) == \
        JD.param_group_counts(jax.tree.map(jnp.asarray, t_leaves_tree(pruned)),
                              JConfig(**PRUNE_CFG), nonzero=True)
    assert TD.param_group_counts(params_t, cfg) == JD.param_group_counts(params_j,
                                                                         JConfig(**PRUNE_CFG))


def t_leaves_tree(tree):
    return _tree.tree_map(lambda t: t.numpy(), tree)


FIT_SIZES = (1, 1, 1, 500, 900, 3000)     # 4,403 rows x 4: the table is thresholded by bisection


def pruned_fit_pair(train_kw, n=400, **fit_kw):
    flags = dict(field_size=6, feature_sizes=FIT_SIZES, numerical=3, embedding_size=4, h_depth=2,
                 deep_nodes=16, use_fwfm=True, use_deep=True, use_lw=True, use_fwlw=True,
                 **NO_DROPOUT)
    rng = np.random.default_rng(7)
    xi = rng.integers(0, FIT_SIZES[3:], size=(n, 3)).astype(np.int32)
    xv = rng.normal(size=(n, 3)).astype(np.float32)
    y = (rng.random(n) < 1 / (1 + np.exp(-xv[:, 0]))).astype(np.float32)
    est_j = JT.DeepFMEstimator(JConfig(**flags), JTrain(table_layout="flat", **train_kw),
                               logger=QUIET)
    est_t = TT.DeepFMEstimator(TConfig(**flags), TTrain(table_layout="flat", **train_kw),
                               logger=QUIET, device="cpu")
    est_j.params = JD.init_params(jax.random.PRNGKey(0), est_j.mcfg)
    est_t.params = _port(est_j.params)
    est_j.fit(xi, xv, y, **fit_kw)
    est_t.fit(xi, xv, y, **fit_kw)
    return est_j, est_t


def test_pruned_fit_sparsity_trajectory_matches_jax():
    """Three epochs, one of warm-up, a refresh every 3 batches and at the
    last one (13 batches an epoch), all three groups, up to 67% sparsity. A
    weight whose magnitude lies between the two packages' thresholds (they
    differ in the last bit) is pruned by one and kept by the other, so each
    leaf's count of zeros may differ by one and the per-epoch sparsity by two
    parameters of the 18 thousand. Where both kept a weight, the parameters
    agree within atol 2e-5, rtol 1e-4, as in the unpruned fit test."""
    kw = dict(n_epochs=3, batch_size=32, learning_rate=1e-2, prune=True, warm=1, sparse=0.8,
              prune_interval=3, prune_r=True, prune_omega=10.0, prune_damping=0.5)
    est_j, est_t = pruned_fit_pair(kw)
    assert est_t.epoch_sparsity[0] == 0.0 and est_t.epoch_sparsity[-1] > 30
    two_params = 100.0 * 2 / TD.param_count(est_t.params)
    assert est_t.epoch_sparsity == pytest.approx(est_j.epoch_sparsity, abs=two_params)
    got, want = t_leaves(est_t.params), j_leaves(est_j.params)
    for name in want:
        zeros_t, zeros_j = got[name] == 0, want[name] == 0
        assert abs(int(zeros_t.sum()) - int(zeros_j.sum())) <= 1, name
        assert int((zeros_t != zeros_j).sum()) <= 1, name
        both = ~zeros_t & ~zeros_j
        np.testing.assert_allclose(got[name][both], want[name][both], rtol=1e-4, atol=2e-5,
                                   err_msg=name)
    np.testing.assert_allclose(est_t.train_result, est_j.train_result, rtol=0, atol=1e-5)


def test_steps_per_call_keeps_the_prune_schedule():
    """With ``steps_per_call > 1`` both packages fuse ``prune_interval``
    steps and one refresh into a dispatch (the port's K path, eager on the
    CPU), on the per-batch schedule, so the sparsity trajectories are equal."""
    kw = dict(n_epochs=2, batch_size=32, learning_rate=1e-2, prune=True, warm=1, sparse=0.8,
              prune_interval=4, prune_omega=10.0, prune_damping=0.5, steps_per_call=4)
    est_j, est_t = pruned_fit_pair(kw, n=300)
    assert est_t.epoch_sparsity[-1] > 5
    two_params = 100.0 * 2 / TD.param_count(est_t.params)
    assert est_t.epoch_sparsity == pytest.approx(est_j.epoch_sparsity, abs=two_params)


def test_fit_prune_arguments_override_the_config():
    kw = dict(n_epochs=1, batch_size=32, prune=False, warm=0, sparse=0.9, prune_omega=1.0)
    _, est_t = pruned_fit_pair(kw, n=100, prune=True, prune_fm=False, emb_r=0.5)
    assert zero_share(est_t.params["emb2"]["dense"]) == 0.0
    assert zero_share(est_t.params["deep"]["net_1"]["layers"][1]["w"]) > 0.02


def test_unread_table_rows_stop_where_xla_stops_them():
    """A table of 32,768 values (above ``BISECT_SIZE``, so the threshold is the
    log-space bisection with its floor at the largest magnitude * 2^-120)
    whose first half gets a gradient every step and whose second half, rows
    that no batch reads, gets L2 alone; a refresh at 40% every 10 steps, for
    2,000 steps of Adam in both packages. The unread rows decay until their
    first moment is subnormal, which XLA reads as 0: there they stop, at
    |w| ~ 1e-31, and each refresh zeroes the target share. With the
    subnormals kept they crept on below the search's floor, and a refresh
    zeroed every unread row: half the table, not 40%."""
    rows, e, steps = 8192, 4, 2000
    kw = dict(learning_rate=1e-3, weight_decay=3e-7)
    rng = np.random.default_rng(3)
    w0 = (rng.normal(size=(rows, e)) * 0.01).astype(np.float32)
    params_j = {"emb2": {"dense": jnp.asarray(w0)}}
    params_t = {"emb2": {"dense": torch.from_numpy(w0.copy())}}
    opt_j, opt_t = JT.make_optimizer(JTrain(**kw)), TT.make_optimizer(TTrain(**kw))
    state_j, state_t = opt_j.init(params_j), opt_t.init(params_t)

    @jax.jit
    def step_j(p, s, g):
        u, s = opt_j.update(g, s, p)
        return optax.apply_updates(p, u), s

    prune_j = jax.jit(lambda p: JP.prune_params(p, jnp.float32(0.4), prune_deep=False))
    for step in range(1, steps + 1):
        g = np.zeros((rows, e), np.float32)
        g[:rows // 2] = rng.normal(size=(rows // 2, e)) * 1e-3
        params_j, state_j = step_j(params_j, state_j, {"emb2": {"dense": jnp.asarray(g)}})
        opt_t.update(params_t, [torch.from_numpy(g)], state_t)
        if step % 10 == 0:
            params_j = prune_j(params_j)
            params_t = TP.prune_params(params_t, 0.4, prune_deep=False)
    got, want = params_t["emb2"]["dense"].numpy(), np.asarray(params_j["emb2"]["dense"])
    assert int((want == 0).sum()) == pytest.approx(0.4 * got.size, abs=2)
    assert abs(int((got == 0).sum()) - int((want == 0).sum())) <= 2
    unread_t, unread_j = np.abs(got[rows // 2:]), np.abs(want[rows // 2:])
    assert 1e-33 < unread_t.max() < 1e-29 and unread_t.max() == pytest.approx(unread_j.max(),
                                                                              rel=0.1)
