"""The JAX package's compiled dispatch in the port, on the CPU: ``make_multi_step``
and ``make_scan_eval_fn`` against JAX's, ``fit`` with ``steps_per_call > 1``
against its own per-batch steps and against JAX's ``fit``, ``_predict_logits``
over scanned groups, and the pipeline leg's K path. The capture itself is
tested in ``test_torch_cuda_graph.py``, which imports no JAX.

On the CPU the port captures nothing: the K steps of a multi-step and the K
forwards of a scanned eval run eagerly, which is the plain version of the
card's CUDA graph replay (``utils/cuda_graph.py``). Parameters are made by the
JAX package and cross through ``weights.py``; inputs come from numpy seeds.
Each test states its tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_host_pipeline import small_bin
from test_torch_pruning import pruned_fit_pair
from test_torch_serving import F_SIZES, NUM, _batch, _cfgs, _port
from test_torch_train import (NO_DROPOUT, QUIET, assert_trees_close, fit_data, j_leaves,
                              t_leaves)
from xsdeepfwfm_deprecated_tpu.config import TrainConfig as JTrain
from xsdeepfwfm_deprecated_tpu.models import deepfwfm as JD
from xsdeepfwfm_deprecated_tpu.train import trainer as JT
from xsdeepfwfm_deprecated_torch import _tree
from xsdeepfwfm_deprecated_torch.config import ModelConfig as TConfig
from xsdeepfwfm_deprecated_torch.config import TrainConfig as TTrain
from xsdeepfwfm_deprecated_torch.data import batching as TB
from xsdeepfwfm_deprecated_torch.data.sharded_input import ShardedBinPipeline
from xsdeepfwfm_deprecated_torch.models import deepfwfm as TD
from xsdeepfwfm_deprecated_torch.tools import host_pipeline_41m as hp
from xsdeepfwfm_deprecated_torch.train import trainer as TT

K, B = 4, 32
FLAGSHIP_SHAPED = dict(use_fwfm=True, use_deep=True, use_lw=True, use_fwlw=True)
PRUNE_KW = dict(emb_r=0.5, emb_corr=1.0, prune_fm=True, prune_deep=True, prune_r=True)


def stacked_inputs(seed, phantom=False):
    """(K, B, ...) inputs from numpy; with ``phantom`` the step before the last
    is padded in its last 5 rows and the last is all padding."""
    xi = np.empty((K, B, len(F_SIZES) - NUM), np.int32)
    xv = np.empty((K, B, NUM), np.float32)
    for i in range(K):
        xi[i], xv[i] = _batch(F_SIZES, NUM, B, seed + i)
    rng = np.random.default_rng(seed + 50)
    y = (rng.random((K, B)) < 0.4).astype(np.float32)
    mask = np.ones((K, B), np.float32)
    if phantom:
        mask[-2, -5:] = 0.0
        mask[-1] = 0.0
        y[-1] = 0.0
    teacher = (rng.normal(size=(K, B)) * 3).astype(np.float32)
    return xi, xv, y, mask, teacher


@pytest.mark.parametrize("case", ["plain", "prune", "kd"])
def test_multi_step_matches_jax(case):
    """Two dispatches of K=4 steps at B=32 on a small flagship-shaped model,
    Adam + L2, dropout off: the second dispatch ends in a padded step and an
    all-padding one, which both packages skip. After each dispatch the losses,
    the parameters and the optimizer state: rtol 1e-4, atol 2e-5, as
    ``test_fit_matches_jax_fit`` (Adam at lr 1e-2 for up to 8 steps), the
    diagonal of ``field_cov`` 1e-3 (it cancels out of the logit, so its
    gradient is rounding noise that Adam turns into steps). With a refresh,
    a weight between the two packages' thresholds (they differ in the last
    bit) may be pruned by one and kept by the other: each leaf's zeros may
    differ by one, and the kept values are held to the tolerances above."""
    flags = dict(FLAGSHIP_SHAPED, **NO_DROPOUT)
    jcfg, tcfg = _cfgs(**flags)
    train_kw = dict(batch_size=B, learning_rate=1e-2, weight_decay=1e-4)
    jtc, ttc = JTrain(table_layout="flat", **train_kw), TTrain(**train_kw)
    use_kd, prune_kw = case == "kd", PRUNE_KW if case == "prune" else None
    opt_j, opt_t = JT.make_optimizer(jtc), TT.make_optimizer(ttc)
    multi_j = JT.make_multi_step(jcfg, jtc, opt_j, use_kd=use_kd, prune_kw=prune_kw)
    multi_t = TT.make_multi_step(tcfg, ttc, opt_t, use_kd=use_kd, prune_kw=prune_kw)
    params_j = JD.init_params(jax.random.PRNGKey(0), jcfg)
    params_t = _port(params_j)
    state_j, state_t = opt_j.init(params_j), opt_t.init(params_t)
    for d, adaptive in enumerate((0.3, 0.5)):
        xi, xv, y, mask, teacher = stacked_inputs(10 * d, phantom=d == 1)
        extra_j = [jnp.float32(adaptive)] if prune_kw else []
        params_j, state_j, losses_j = multi_j(
            params_j, state_j, *map(jnp.asarray, (xi, xv, y, mask)), jax.random.PRNGKey(d),
            jnp.asarray(teacher if use_kd else np.zeros_like(teacher)), *extra_j)
        losses_t = multi_t(params_t, state_t, *map(torch.from_numpy, (xi, xv, y, mask)), None,
                           torch.from_numpy(teacher) if use_kd else None,
                           adaptive if prune_kw else None)
        assert losses_t.shape == (K,)
        np.testing.assert_allclose(losses_t.numpy(), np.asarray(losses_j), rtol=1e-4, atol=2e-5)
        if d == 1:
            assert float(losses_t[-1]) == 0.0
        if prune_kw:
            assert_kept_close(params_t, params_j)
            assert zero_share(params_t) > 0.2
        else:
            assert_trees_close(params_t, params_j, rtol=1e-4, atol=2e-5,
                               field_cov_diag_atol=1e-3)
            assert_trees_close(state_t, state_j, rtol=1e-4, atol=2e-5)


def assert_kept_close(params_t, params_j):
    """Each leaf's zeros within one of JAX's; where both kept a weight, rtol
    1e-4 and atol 2e-5, the diagonal of ``field_cov`` 1e-3."""
    got, want = t_leaves(params_t), j_leaves(params_j)
    for name in want:
        zeros_t, zeros_j = got[name] == 0, want[name] == 0
        assert int((zeros_t != zeros_j).sum()) <= 1, name
        both = ~zeros_t & ~zeros_j
        atol = np.full(both.shape, 2e-5)
        if name.endswith("field_cov"):
            np.fill_diagonal(atol, 1e-3)
        g, w = got[name][both], want[name][both]
        assert np.all(np.abs(g - w) <= atol[both] + 1e-4 * np.abs(w)), name


def zero_share(params):
    leaves = _tree.leaves(params)
    return sum(int((t == 0).sum()) for t in leaves) / sum(t.numel() for t in leaves)


def test_scan_eval_matches_jax():
    """``EVAL_SCAN_K`` stacked eval batches through both packages' scanned
    eval: the same ``(K, B)`` logits, rtol/atol 1e-5 (float32 sums in
    another order, as ``test_eval_logits_match_jax``), and each row equal to
    the port's own per-batch forward to the bit."""
    assert TT.EVAL_SCAN_K == JT.EVAL_SCAN_K == 8
    jcfg, tcfg = _cfgs(**FLAGSHIP_SHAPED)
    params_j = JD.init_params(jax.random.PRNGKey(3), jcfg)
    params_t = _port(params_j)
    k = TT.EVAL_SCAN_K
    xs = [_batch(F_SIZES, NUM, B, seed) for seed in range(k)]
    xi, xv = np.stack([x[0] for x in xs]), np.stack([x[1] for x in xs])
    want = np.asarray(JT.make_scan_eval_fn(jcfg)(params_j, jnp.asarray(xi), jnp.asarray(xv)))
    got = TT.make_scan_eval_fn(tcfg)(params_t, torch.from_numpy(xi), torch.from_numpy(xv))
    assert got.shape == (k, B)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    with torch.inference_mode():
        one = [TD.forward(params_t, torch.from_numpy(xi[i]), torch.from_numpy(xv[i]), tcfg)
               for i in range(k)]
    assert torch.equal(got, torch.stack(one))


FIT_CASES = {
    "prune_dropout": (dict(FLAGSHIP_SHAPED), dict(prune=True, warm=1, sparse=0.8,
                                                  prune_omega=10.0, prune_damping=0.5)),
    "kd_dropout": (dict(FLAGSHIP_SHAPED), dict(kd=True)),
    "qat_dropout": (dict(FLAGSHIP_SHAPED, quantization_aware=True), dict()),
}


@pytest.mark.parametrize("case", sorted(FIT_CASES))
def test_fit_k_steps_equals_per_batch_steps_to_the_bit(case):
    """The port's ``fit`` with ``steps_per_call=4`` against its own
    ``steps_per_call=1``, two epochs of ten batches (the last of 12 rows), so
    that each epoch ends in a group of two real batches; dropout on, with
    pruning (a refresh every 4 batches after a warm-up epoch: K becomes
    ``prune_interval``), with a KD teacher, or with QAT. The same generator
    stream and the same schedule: parameters, optimizer state, losses,
    sparsity and step count equal to the bit."""
    flags, extra = FIT_CASES[case]
    _, tcfg = _cfgs(**flags)
    xi, xv, y = fit_data(300, seed=5)
    teacher = None
    if extra.get("kd"):
        teacher = TT.DeepFMEstimator(tcfg, TTrain(batch_size=B), logger=QUIET, device="cpu")
        teacher.init_params(seed=9)
    runs = []
    for k in (1, 4):
        tc = TTrain(n_epochs=2, batch_size=B, learning_rate=1e-2, random_seed=2,
                    steps_per_call=k, prune_interval=4, **extra)
        est = TT.DeepFMEstimator(tcfg, tc, logger=QUIET, device="cpu")
        runs.append(est.fit(xi, xv, y, teacher_model=teacher))
    per_batch, grouped = runs
    for a, b in zip(_tree.leaves((per_batch.params, per_batch.opt_state)),
                    _tree.leaves((grouped.params, grouped.opt_state))):
        assert torch.equal(a, b)
    assert grouped.last_epoch_losses == per_batch.last_epoch_losses
    assert len(grouped.last_epoch_losses) == 10
    assert grouped.epoch_sparsity == per_batch.epoch_sparsity
    assert grouped._step == per_batch._step == 20
    if extra.get("prune"):
        assert grouped.epoch_sparsity[-1] > 1


def test_fit_k_steps_matches_jax_fit_k_steps():
    """Both packages' ``fit`` at ``steps_per_call=4`` with pruning (K becomes
    ``prune_interval``), dropout off: the sparsity per epoch within two
    parameters and each leaf's zeros within one of JAX's (a weight between
    the packages' thresholds, which differ in the last bit); where both kept
    a weight, rtol 1e-4 and atol 2e-5, the diagonal of ``field_cov`` 1e-3, as
    ``test_fit_matches_jax_fit``."""
    kw = dict(n_epochs=2, batch_size=B, learning_rate=1e-2, prune=True, warm=1, sparse=0.8,
              prune_interval=4, prune_omega=10.0, prune_damping=0.5, steps_per_call=4)
    est_j, est_t = pruned_fit_pair(kw, n=300)
    assert est_t.epoch_sparsity[-1] > 5
    two_params = 100.0 * 2 / TD.param_count(est_t.params)
    assert est_t.epoch_sparsity == pytest.approx(est_j.epoch_sparsity, abs=two_params)
    assert_kept_close(est_t.params, est_j.params)


def test_predict_logits_scans_full_groups(monkeypatch):
    """Two full groups of ``EVAL_SCAN_K`` batches of 8 rows and a tail of 5
    rows: the groups go through the scanned eval (two calls), the tail batch
    by batch, and the logits equal per-batch forwards to the bit."""
    _, tcfg = _cfgs(**FLAGSHIP_SHAPED)
    est = TT.DeepFMEstimator(tcfg, TTrain(batch_size=B), logger=QUIET, device="cpu")
    params = est.init_params(seed=4)
    bs, k = 8, TT.EVAL_SCAN_K
    n = 2 * k * bs + 5
    xi, xv = _batch(F_SIZES, NUM, n, seed=6)
    calls = []
    scan = TT.ScanEval.__call__
    monkeypatch.setattr(TT.ScanEval, "__call__",
                        lambda self, *a: calls.append(a[1].shape) or scan(self, *a))
    got = est._predict_logits(xi, xv, batch_size=bs)
    assert calls == [(k, bs, xi.shape[1])] * 2
    with torch.inference_mode():
        want = [TD.forward(params, torch.from_numpy(b["xi"]), torch.from_numpy(b["xv"]),
                           tcfg)[:b["n_valid"]]
                for b in TB.iter_batches(xi, xv, np.zeros(n, np.float32), bs)]
    assert got.shape == (n,)
    assert np.array_equal(got, torch.cat(want).numpy())


def test_card_epoch_dispatches_groups_of_k_steps(tmp_path, monkeypatch):
    """``host_pipeline_41m.card_epoch`` at ``--k-steps 2``, on the CPU with a
    narrow model: the epoch's groups (whole ones only) and the budgets' are
    the pipeline's batches in order, two to a ``make_multi_step`` dispatch,
    and the parameters equal the port's ``train_step`` over the same batches
    with the same generator, to the bit."""
    sizes = [1] * 13 + [7, 30, 5, 60] * 6 + [9, 11]
    d = str(tmp_path / "bin")
    small_bin(d, 300, sizes, seed=0)
    cfg = TConfig(field_size=39, feature_sizes=tuple(sizes), numerical=13, embedding_size=4,
                  h_depth=2, deep_nodes=16, use_fwfm=True, use_deep=True, use_lw=True,
                  use_fwlw=True)
    dispatched = []
    make = hp.make_multi_step

    def spy(*args, **kw):
        multi = make(*args, **kw)

        def step(params, opt_state, xi_k, xv_k, y_k, mask_k, *rest, **kw2):
            dispatched.append([{"xi": xi_k[i].clone(), "xv": xv_k[i].clone(),
                                "y": y_k[i].clone(), "mask": mask_k[i].clone()}
                               for i in range(xi_k.shape[0])])
            return multi(params, opt_state, xi_k, xv_k, y_k, mask_k, *rest, **kw2)
        return step

    monkeypatch.setattr(hp, "make_multi_step", spy)
    monkeypatch.setattr(hp, "make_train_step", None)      # K > 1 never steps one batch alone
    res, params = hp.card_epoch(d, sizes, 64, 2, 4, mcfg=cfg, device="cpu")
    assert res["card_steps"] == 4
    # the epoch's 2 groups, the budget's 5 replays of the last, the staged budget's 5 over them
    assert len(dispatched) == 2 + 2 * hp.BUDGET_REPS
    want = list(ShardedBinPipeline(d).epoch_batches(64, seed=4, epoch=0))[:4]
    groups = [want[0:2], want[2:4]]
    order = groups + [groups[-1]] * hp.BUDGET_REPS + [groups[i % 2] for i in range(5)]
    seen = [b for group in dispatched for b in group]
    for got, b in zip(seen, [b for group in order for b in group]):
        assert np.array_equal(got["xi"].numpy(), b["index"])
        assert np.array_equal(got["xv"].numpy(), b["value"])
        assert np.array_equal(got["y"].numpy(), b["label"])
        assert torch.equal(got["mask"], torch.ones(64))
    ref = TD.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    tcfg = TTrain(batch_size=64)
    opt = TT.make_optimizer(tcfg)
    state = opt.init(ref)
    gen = torch.Generator().manual_seed(1)
    for batch in seen:
        TT.train_step(ref, state, batch, cfg, tcfg, opt, generator=gen)
    for got, w in zip(_tree.leaves(params), _tree.leaves(ref)):
        assert torch.equal(got, w)


def test_stack_groups_pads_like_per_batch():
    """Each group stacks ``iter_batches``' own batches (the tail padded with
    its own first row); the last group is filled with all-padding batches
    and counts its real ones in ``k_real``."""
    xi, xv, y = fit_data(70, seed=8)
    batches = list(TB.iter_batches(xi, xv, y, 16))
    groups = list(TB.stack_groups(iter(batches), 3))
    assert [g["k_real"] for g in groups] == [3, 2]
    for i, b in enumerate(batches):
        g = groups[i // 3]
        for key in ("xi", "xv", "y", "mask"):
            assert np.array_equal(g[key][i % 3], b[key])
    assert groups[1]["mask"][2].sum() == 0 and groups[1]["y"][2].sum() == 0
