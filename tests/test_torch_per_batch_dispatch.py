"""The JAX package's per-batch compiled dispatch in the port, on the CPU:
``make_train_step`` and ``make_eval_fn`` against JAX's, ``fit`` at
``steps_per_call=1`` with pruning against JAX's ``fit``, the estimator's JAX
names (``forward_fn``, ``eval_fn``, ``scan_eval_fn``) and ``train``'s
exports, and recovery dropping the cached functions.

On the CPU the port captures nothing: the train step, the prune refresh and
the eval fn run eagerly, the plain version of the card's CUDA graph replays
(``utils/cuda_graph.py``; ``chip_smoke.py`` phase 22 counts the replays on
the card). Parameters are made by the JAX package and cross through
``weights.py``; inputs come from numpy seeds. Each test states its tolerance.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_multi_step import FLAGSHIP_SHAPED, assert_kept_close
from test_torch_serving import F_SIZES, NUM, _batch, _cfgs, _port
from test_torch_train import (NO_DROPOUT, QUIET, assert_trees_close, fit_data, labelled_batch,
                              to_jax, to_torch)
from xsdeepfwfm_deprecated_tpu.config import TrainConfig as JTrain
from xsdeepfwfm_deprecated_tpu.models import deepfwfm as JD
from xsdeepfwfm_deprecated_tpu.train import trainer as JT
from xsdeepfwfm_deprecated_torch import _tree, train
from xsdeepfwfm_deprecated_torch.config import TrainConfig as TTrain
from xsdeepfwfm_deprecated_torch.data import batching as TB
from xsdeepfwfm_deprecated_torch.models import deepfwfm as TD
from xsdeepfwfm_deprecated_torch.train import recovery as t_recovery
from xsdeepfwfm_deprecated_torch.train import trainer as TT
from xsdeepfwfm_deprecated_torch.utils import debug

B = 32


@pytest.mark.parametrize("kd", [False, True], ids=["plain", "kd"])
def test_make_train_step_matches_jax(kd):
    """Three steps with Adam + L2 on padded batches, dropout off, through both
    packages' ``make_train_step`` (the KD step with seeded teacher logits):
    each loss within 1e-6 (KD's within rtol 1e-4: its KL term is alpha * T^2
    = 360 times a sum of float32 log-softmaxes, whose last bits, about 2e-7
    each, reach 1e-5 of the loss), then the parameters and
    the optimizer state within atol 2e-6, rtol 1e-5, as
    ``test_train_steps_match_jax`` (lr 1e-3: a last-bit difference in a
    gradient moves a weight by up to about 1e-7 a step). The port's loss is a
    0-d tensor that the next step leaves as it was."""
    jcfg, tcfg = _cfgs(**FLAGSHIP_SHAPED, **NO_DROPOUT)
    kw = dict(weight_decay=3e-7, learning_rate=1e-3, batch_size=B)
    jt, tt = JTrain(**kw), TTrain(**kw)
    params_j = JD.init_params(jax.random.PRNGKey(0), jcfg)
    params_t = _port(params_j)
    opt_j, opt_t = JT.make_optimizer(jt), TT.make_optimizer(tt)
    state_j, state_t = opt_j.init(params_j), opt_t.init(params_t)
    step_j = JT.make_train_step(jcfg, jt, opt_j, use_kd=kd)
    step_t = TT.make_train_step(tcfg, tt, opt_t, use_kd=kd)
    losses = []
    for i in range(3):
        batch = labelled_batch(B, seed=20 + i, n_pad=5)
        teacher = (np.random.default_rng(40 + i).normal(size=B) * 3).astype(np.float32)
        params_j, state_j, loss_j = step_j(params_j, state_j, *to_jax(batch),
                                           jax.random.PRNGKey(i),
                                           jnp.asarray(teacher if kd else np.zeros(B, np.float32)))
        batch_t = to_torch(batch)
        if kd:
            batch_t["teacher"] = torch.from_numpy(teacher)
        loss_t = step_t(params_t, state_t, batch_t)
        assert loss_t.shape == ()
        losses.append((loss_t, float(loss_t)))
        np.testing.assert_allclose(float(loss_t), float(loss_j), **(
            dict(rtol=1e-4, atol=0) if kd else dict(rtol=0, atol=1e-6)))
    assert all(float(t) == v for t, v in losses)
    assert_trees_close(params_t, params_j, rtol=1e-5, atol=2e-6)
    assert_trees_close(state_t, state_j, rtol=1e-5, atol=2e-6)


def test_make_train_step_is_the_eager_step_to_the_bit():
    """With dropout on, the dispatched step and the port's eager
    ``train_step`` from the same state and generator: parameters, optimizer
    state and losses equal to the bit, and a KD step refuses a batch without
    the teacher's logits, a plain one a batch with them."""
    _, tcfg = _cfgs(**FLAGSHIP_SHAPED)
    tt = TTrain(batch_size=B, learning_rate=1e-2, weight_decay=1e-4)
    opt = TT.make_optimizer(tt)
    runs = []
    for dispatched in (True, False):
        params = TD.init_params(torch.Generator().manual_seed(3), tcfg, device="cpu")
        state = opt.init(params)
        gen = torch.Generator().manual_seed(4)
        step = TT.make_train_step(tcfg, tt, opt)
        losses = []
        for i in range(3):
            batch = to_torch(labelled_batch(B, seed=50 + i, n_pad=3 * (i == 2)))
            losses.append(step(params, state, batch, gen) if dispatched else
                          TT.train_step(params, state, batch, tcfg, tt, opt, generator=gen))
        runs.append((params, state, torch.stack(losses)))
    for a, w in zip(_tree.leaves(runs[0]), _tree.leaves(runs[1])):
        assert torch.equal(a, w)
    batch = to_torch(labelled_batch(B, seed=60))
    with pytest.raises(ValueError, match="teacher"):
        TT.make_train_step(tcfg, tt, opt, use_kd=True)(params, state, batch)
    with pytest.raises(ValueError, match="teacher"):
        TT.make_train_step(tcfg, tt, opt)(params, state, {**batch, "teacher": batch["y"]})


def test_make_eval_fn_matches_jax():
    """One eval batch through both packages' ``make_eval_fn``: the same
    ``(B,)`` logits within rtol/atol 1e-5 (float32 sums in another order, as
    ``test_eval_logits_match_jax``), and equal to the port's own forward to
    the bit."""
    jcfg, tcfg = _cfgs(**FLAGSHIP_SHAPED)
    params_j = JD.init_params(jax.random.PRNGKey(5), jcfg)
    params_t = _port(params_j)
    xi, xv = _batch(F_SIZES, NUM, B, seed=7)
    want = np.asarray(JT.make_eval_fn(jcfg)(params_j, jnp.asarray(xi), jnp.asarray(xv)))
    got = TT.make_eval_fn(tcfg)(params_t, torch.from_numpy(xi), torch.from_numpy(xv))
    assert got.shape == (B,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    with torch.inference_mode():
        assert torch.equal(got, TD.forward(params_t, torch.from_numpy(xi), torch.from_numpy(xv),
                                           tcfg))


class _EpochLosses(logging.Handler):
    """The mean train-step loss of each epoch, from the line both packages'
    ``fit`` log at debug level."""

    def __init__(self):
        super().__init__(logging.DEBUG)
        self.means = []

    def emit(self, record):
        msg = record.getMessage()
        if "mean train-step loss" in msg:
            self.means.append(float(msg.rsplit(":", 1)[1]))


def _loss_logger(name):
    logger = logging.getLogger(f"test_torch_per_batch.{name}")
    logger.handlers, logger.propagate = [_EpochLosses()], False
    logger.setLevel(logging.DEBUG)
    return logger


PRUNE_FIT_KW = dict(n_epochs=3, batch_size=B, learning_rate=1e-2, prune=True, warm=1, sparse=0.8,
                    prune_interval=3, prune_r=True, prune_omega=10.0, prune_damping=0.5)


def test_per_batch_fit_matches_jax_fit():
    """Both packages' ``fit`` at ``steps_per_call=1``, three epochs of 13
    batches (the last of 16 real rows), one of warm-up, then a refresh every 3
    batches and at the last, dropout off. The port steps through its
    dispatched step and refresh, one call a batch and one a refresh. The
    sparsity per epoch within two parameters of JAX's (the packages'
    thresholds differ in the last bit, ROADMAP.md section 3); each epoch's
    mean step loss within 2e-6 (logged to 6 decimals); where both kept a
    weight, rtol 1e-4 and atol 2e-5, the diagonal of ``field_cov`` 1e-3;
    the train metric within 1e-5."""
    jcfg, tcfg = _cfgs(**FLAGSHIP_SHAPED, **NO_DROPOUT)
    xi, xv, y = fit_data(400, seed=9)
    est_j = JT.DeepFMEstimator(jcfg, JTrain(table_layout="flat", **PRUNE_FIT_KW),
                               logger=_loss_logger("jax"))
    est_t = TT.DeepFMEstimator(tcfg, TTrain(**PRUNE_FIT_KW), logger=_loss_logger("port"),
                               device="cpu")
    est_j.params = JD.init_params(jax.random.PRNGKey(0), jcfg)
    est_t.params = _port(est_j.params)
    calls = {"step": 0, "refresh": 0}
    step_call, refresh_call = TT.TrainStep.__call__, TT.PruneRefresh.__call__

    def count(name, fn):
        def counted(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return counted
    mp = pytest.MonkeyPatch()
    mp.setattr(TT.TrainStep, "__call__", count("step", step_call))
    mp.setattr(TT.PruneRefresh, "__call__", count("refresh", refresh_call))
    try:
        est_j.fit(xi, xv, y)
        est_t.fit(xi, xv, y)
    finally:
        mp.undo()
    assert calls == {"step": 39, "refresh": 2 * 5}
    assert est_t._step == est_j._step == 39
    two_params = 100.0 * 2 / TD.param_count(est_t.params)
    assert est_t.epoch_sparsity[0] == 0.0 and est_t.epoch_sparsity[-1] > 30
    assert est_t.epoch_sparsity == pytest.approx(est_j.epoch_sparsity, abs=two_params)
    means_t, means_j = (e.logger.handlers[0].means for e in (est_t, est_j))
    assert len(means_t) == len(means_j) == 3
    np.testing.assert_allclose(means_t, means_j, rtol=0, atol=2e-6)
    assert len(est_t.last_epoch_losses) == 13
    assert_kept_close(est_t.params, est_j.params)
    np.testing.assert_allclose(est_t.train_result, est_j.train_result, rtol=0, atol=1e-5)


def test_nan_debugging_fit_steps_eagerly_to_the_same_bits():
    """Inside ``utils.debug.nan_debugging`` the per-batch fit steps and
    refreshes eagerly (no dispatched step or refresh is made) and checks each
    loss; it trains the same parameters, losses and sparsity as the
    dispatched fit, to the bit, dropout on."""
    _, tcfg = _cfgs(**FLAGSHIP_SHAPED)
    xi, xv, y = fit_data(200, seed=11)
    kw = dict(PRUNE_FIT_KW, n_epochs=2, random_seed=3)
    runs = []
    for debugging in (False, True):
        est = TT.DeepFMEstimator(tcfg, TTrain(**kw), logger=QUIET, device="cpu")
        est.init_params(seed=1)
        made = []
        mp = pytest.MonkeyPatch()
        mp.setattr(TT, "make_train_step", lambda *a, _m=TT.make_train_step, **k:
                   made.append("step") or _m(*a, **k))
        mp.setattr(TT, "PruneRefresh", lambda *a, _c=TT.PruneRefresh, **k:
                   made.append("refresh") or _c(*a, **k))
        try:
            if debugging:
                with debug.nan_debugging():
                    est.fit(xi, xv, y)
            else:
                est.fit(xi, xv, y)
        finally:
            mp.undo()
        assert made == ([] if debugging else ["step", "refresh"])
        runs.append(est)
    dispatched, eager = runs
    for a, w in zip(_tree.leaves((dispatched.params, dispatched.opt_state)),
                    _tree.leaves((eager.params, eager.opt_state))):
        assert torch.equal(a, w)
    assert dispatched.last_epoch_losses == eager.last_epoch_losses
    assert dispatched.epoch_sparsity == eager.epoch_sparsity
    assert dispatched.epoch_sparsity[-1] > 0


def test_estimator_exposes_the_jax_names():
    """``train`` exports what JAX's ``train/__init__.py`` does, and the
    estimator's ``forward_fn``, ``eval_fn`` and ``scan_eval_fn`` are the
    functions ``_predict_logits`` runs: the eval fn and the scanned eval over
    ``forward_fn``, kept while it stays, equal to the forward to the bit;
    ``_predict_logits`` sends the batches that do not fill a scanned group
    through the eval fn, one call each."""
    for name in ("DeepFMEstimator", "make_optimizer", "make_train_step", "make_eval_fn"):
        assert getattr(train, name) is getattr(TT, name)
    _, tcfg = _cfgs(**FLAGSHIP_SHAPED)
    est = TT.DeepFMEstimator(tcfg, TTrain(batch_size=B), logger=QUIET, device="cpu")
    params = est.init_params(seed=2)
    assert est.forward_fn is TD.forward
    eval_fn, scan_eval_fn = est.eval_fn, est.scan_eval_fn
    assert isinstance(eval_fn, TT.EvalFn) and isinstance(scan_eval_fn, TT.ScanEval)
    assert est.eval_fn is eval_fn and est.scan_eval_fn is scan_eval_fn
    assert eval_fn.forward_fn is scan_eval_fn.forward_fn is est.forward_fn
    n = 2 * TT.EVAL_SCAN_K * 8 + 13
    xi, xv = _batch(F_SIZES, NUM, n, seed=12)
    with torch.inference_mode():
        want = [TD.forward(params, torch.from_numpy(b["xi"]), torch.from_numpy(b["xv"]),
                           tcfg)[:b["n_valid"]]
                for b in TB.iter_batches(xi, xv, np.zeros(n, np.float32), 8)]
    assert torch.equal(eval_fn(params, torch.from_numpy(xi[:8]), torch.from_numpy(xv[:8])),
                       want[0])
    calls = []
    run = TT.EvalFn.__call__
    mp = pytest.MonkeyPatch()
    mp.setattr(TT.EvalFn, "__call__", lambda self, *a: calls.append(a[1].shape) or run(self, *a))
    try:
        got = est._predict_logits(xi, xv, batch_size=8)
    finally:
        mp.undo()
    assert calls == [(8, xi.shape[1])] * 2     # 13 rows left: a batch of 8 and a padded one
    assert np.array_equal(got, torch.cat(want).numpy())


def test_recovery_drops_the_cached_functions(tmp_path):
    """A fit that fails with a device error after its eval functions were
    made: ``fit_with_recovery`` drops the parameters, the optimizer state and
    the cached forward, eval fn and scanned eval (and so their graphs), and
    the restart resumes from the checkpoint with new ones."""
    _, tcfg = _cfgs(**FLAGSHIP_SHAPED)
    xi, xv, y = fit_data(100, seed=13)
    est = TT.DeepFMEstimator(tcfg, TTrain(n_epochs=2, batch_size=B), logger=QUIET, device="cpu")
    est.init_params(seed=3)
    seen, made = [], []
    fit = TT.DeepFMEstimator.fit

    def flaky(self, *args, **kw):
        seen.append((self.params is None, self._fwd, self._eval_fn, self._scan_eval))
        if len(seen) == 1:
            fit(self, *args, **kw)
            made.append(self._eval_fn)
            raise RuntimeError("CUDA error: an illegal memory access was encountered")
        return fit(self, *args, **kw)
    mp = pytest.MonkeyPatch()
    mp.setattr(TT.DeepFMEstimator, "fit", flaky)
    try:
        t_recovery.fit_with_recovery(est, xi, xv, y, save_path=str(tmp_path / "ck"))
    finally:
        mp.undo()
    assert seen[0][0] is False and isinstance(made[0], TT.EvalFn)
    assert seen[1] == (True, None, None, None)
    assert est._step == 2 * -(-100 // B) and est.params is not None
    est._predict_logits(xi, xv)
    assert isinstance(est._eval_fn, TT.EvalFn) and est._eval_fn is not made[0]
