"""The port's training path against the JAX package, on the CPU: optimizers
against optax, loss and gradients against ``jax.value_and_grad``, train steps
against ``make_train_step``, ``fit`` against the JAX estimator's ``fit``.

Parameters are made by the JAX package and cross as numpy; inputs come from
numpy with a seed; dropout is off wherever the two are compared, because the
RNG streams differ. Each comparison states its tolerance and why.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_serving import F_SIZES, NUM, _batch, _cfgs, _port
from xsdeepfwfm_deprecated_tpu.config import TrainConfig as JTrain
from xsdeepfwfm_deprecated_tpu.config import configs_from_args as j_configs_from_args
from xsdeepfwfm_deprecated_tpu.config import get_parser as j_get_parser
from xsdeepfwfm_deprecated_tpu.data import batching as JB
from xsdeepfwfm_deprecated_tpu.models import deepfwfm as JD
from xsdeepfwfm_deprecated_tpu.train import checkpoint as jckpt
from xsdeepfwfm_deprecated_tpu.train import metrics as JM
from xsdeepfwfm_deprecated_tpu.train import trainer as JT
from xsdeepfwfm_deprecated_torch import _tree
from xsdeepfwfm_deprecated_torch.config import TrainConfig as TTrain
from xsdeepfwfm_deprecated_torch.config import configs_from_args, get_parser
from xsdeepfwfm_deprecated_torch.data import batching as TB
from xsdeepfwfm_deprecated_torch.entry import flagship_train_config
from xsdeepfwfm_deprecated_torch.models import deepfwfm as TD
from xsdeepfwfm_deprecated_torch.ops import mlp as t_mlp
from xsdeepfwfm_deprecated_torch.train import metrics as TM
from xsdeepfwfm_deprecated_torch.train import recovery as t_recovery
from xsdeepfwfm_deprecated_torch.train import trainer as TT

B = 32
NO_DROPOUT = dict(is_shallow_dropout=False, is_deep_dropout=False)
QUIET = logging.getLogger("test_torch_quiet")
QUIET.addHandler(logging.NullHandler())
QUIET.propagate = False

FAMILIES = {
    "DeepFwFM_lw_fwlw": dict(use_fwfm=True, use_deep=True, use_lw=True, use_fwlw=True),
    "FM": dict(use_fm=True),
    "DeepFFM": dict(use_ffm=True, use_deep=True),
    "LR": dict(use_logit=True),
    "DNN": dict(use_deep=True),
    "QR": dict(use_fwfm=True, use_deep=True, qr_flag=True, qr_threshold=8),
}
OPTIMIZERS = {
    "adam": dict(optimizer_type="adam"),
    "rmsp": dict(optimizer_type="rmsp"),
    "adag": dict(optimizer_type="adag"),
    "sgd": dict(optimizer_type="sgd"),
    "sgd_momentum": dict(optimizer_type="sgd", momentum=0.9),
}


def j_leaves(tree):
    """A JAX tree's leaves by the checkpoint's names, as numpy (bf16 as f32)."""
    return jckpt._flatten(tree)


def t_leaves(tree):
    return {name: (t.float() if t.dtype == torch.bfloat16 else t).detach().numpy()
            for name, t in _tree.named_leaves(tree)}


def assert_trees_close(got, want, rtol, atol, field_cov_diag_atol=None):
    """``field_cov_diag_atol``: the diagonal of ``field_cov`` cancels out of the
    logit (the pair term minus the diag term), so its gradient is rounding
    noise of the order of Adam's eps, which Adam turns into steps of up to lr
    each. Where a test runs enough steps for that to show, it compares the
    diagonal with this tolerance and everything else with ``atol``."""
    got, want = t_leaves(got), j_leaves(want)
    assert set(got) == set(want)
    for name in want:
        g, w = got[name], want[name]
        if field_cov_diag_atol is not None and name.endswith("field_cov"):
            np.testing.assert_allclose(np.diagonal(g), np.diagonal(w), rtol=rtol,
                                       atol=field_cov_diag_atol, err_msg=name + " diagonal")
            off = ~np.eye(g.shape[0], dtype=bool)
            g, w = g[off], w[off]
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=name)


def labelled_batch(b, seed, n_pad=0):
    xi, xv = _batch(F_SIZES, NUM, b, seed)
    y = (np.random.default_rng(seed + 100).random(b) < 0.4).astype(np.float32)
    mask = np.ones(b, np.float32)
    if n_pad:
        mask[-n_pad:] = 0.0
    return dict(xi=xi, xv=xv, y=y, mask=mask)


def to_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def to_jax(batch):
    return [jnp.asarray(batch[k]) for k in ("xi", "xv", "y", "mask")]


# ------------------------------------------------------------- optimizers

@pytest.mark.parametrize("wd", [0.0, 1e-2], ids=["no_l2", "l2"])
@pytest.mark.parametrize("kind", list(OPTIMIZERS))
def test_optimizer_matches_optax(kind, wd):
    """Five steps on one seeded tree and seeded gradients, some of them exactly
    zero. Parameters and every state leaf, under optax's own leaf names:
    rtol 2e-6 (the same float32 operations, fused differently by XLA), atol
    1e-7 (updates are 0.05 to 0.5 at this learning rate; a parameter that one
    of them brings close to zero keeps the update's rounding error)."""
    kw = dict(OPTIMIZERS[kind], weight_decay=wd, learning_rate=0.05)
    rng = np.random.default_rng(0)
    shapes = {"a": (5, 3), "b": {"c": (4,), "d": [(2, 2), (3,)]}}
    draw = lambda: jax.tree.map(lambda s: rng.normal(size=s).astype(np.float32), shapes,
                                is_leaf=lambda s: isinstance(s, tuple))
    params_j = jax.tree.map(jnp.asarray, draw())
    params_t = _port(params_j)
    opt_j = JT.make_optimizer(JTrain(**kw))
    opt_t = TT.make_optimizer(TTrain(**kw))
    state_j, state_t = opt_j.init(params_j), opt_t.init(params_t)
    assert set(t_leaves(state_t)) == set(j_leaves(state_j))
    for step in range(5):
        grads = draw()
        grads["a"][step % 5] = 0.0
        grads["b"]["c"][:2] = 0.0                    # never a gradient: adagrad's exact 0
        updates, state_j = opt_j.update(jax.tree.map(jnp.asarray, grads), state_j, params_j)
        params_j = optax.apply_updates(params_j, updates)
        opt_t.update(params_t, _tree.leaves(_port(grads)), state_t)
        assert_trees_close(params_t, params_j, rtol=2e-6, atol=1e-7)
        assert_trees_close(state_t, state_j, rtol=2e-6, atol=1e-7)
    if kind == "adag" and wd == 0.0:
        np.testing.assert_array_equal(params_t["b"]["c"][:2].numpy(),
                                      np.asarray(params_j["b"]["c"][:2]))
    if kind == "adam":
        count = dict(_tree.named_leaves(state_t))["1/0/count" if wd else "0/count"]
        assert count.dtype == torch.int32 and count.ndim == 0 and int(count) == 5


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="unknown optimizer"):
        TT.make_optimizer(TTrain(optimizer_type="lion"))


# ------------------------------------------------------ loss and gradients

def j_loss_and_grads(params, batch, jcfg):
    def loss_fn(p, xi, xv, y, mask):
        logits = JD.forward(p, xi, xv, jcfg, train=True, rng=None)
        elem = optax.sigmoid_binary_cross_entropy(logits, y)
        return jnp.sum(elem * mask) / jnp.maximum(jnp.sum(mask), 1.0)
    return jax.value_and_grad(loss_fn)(params, *to_jax(batch))


GRAD_CASES = {
    "numeric_single_rows": dict(use_fwfm=True, use_deep=True, use_lw=True, use_fwlw=True),
    "emb1_and_emb2": dict(use_fm=True, use_deep=True),
    "qr_mult": dict(use_fwfm=True, use_deep=True, qr_flag=True, qr_threshold=8,
                    qr_operation="mult"),
    "qr_add": dict(use_fwfm=True, use_deep=True, qr_flag=True, qr_threshold=8,
                   qr_operation="add"),
    # with fwlw there is no 1-wide first-order table, which concat cannot split
    "qr_concat": dict(use_fwfm=True, use_deep=True, use_fwlw=True, qr_flag=True,
                      qr_threshold=8, qr_operation="concat"),
    "ffm": dict(use_ffm=True, use_deep=True),
    "two_nets": dict(use_fwfm=True, use_deep=True, num_deeps=2),
}


@pytest.mark.parametrize("flags", list(GRAD_CASES.values()), ids=list(GRAD_CASES))
def test_loss_and_gradients_match_jax(flags):
    """A padded tail batch with out-of-range indices. The loss and every
    leaf's gradient: rtol 1e-4, atol 1e-7 (float32 sums in another order; the
    scatter-add adds a row's cotangents in another order)."""
    jcfg, tcfg = _cfgs(**flags, **NO_DROPOUT)
    params = JD.init_params(jax.random.PRNGKey(1), jcfg)
    batch = labelled_batch(B, seed=3, n_pad=5)
    batch["xi"][0] = [7, -1, 99]                     # out of range: last / first row
    batch["xi"][1] = batch["xi"][2]                  # a repeated row: two adds to one place
    want_loss, want = j_loss_and_grads(params, batch, jcfg)
    params_t = _port(params)
    loss, grads = TT.loss_and_grads(params_t, to_torch(batch), tcfg, TTrain())
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-6)
    got = _tree.rebuild(params_t, dict(zip(t_leaves(params_t), grads)))
    assert_trees_close(got, want, rtol=1e-4, atol=1e-7)
    assert not any(p.requires_grad for p in _tree.leaves(params_t))


def test_bf16_table_gradients_match_jax():
    """bf16 tables: the cotangents are cast to bf16 before the scatter-add, as
    in JAX, and the table's gradient is bf16. Rows that two examples share are
    added in bf16 in another order: rtol 2e-2 (bf16 has 8 bits), atol 1e-4."""
    jcfg, tcfg = _cfgs(use_fwfm=True, use_deep=True, table_dtype="bf16", **NO_DROPOUT)
    params = JD.init_params(jax.random.PRNGKey(1), jcfg)
    batch = labelled_batch(B, seed=4)
    want_loss, want = j_loss_and_grads(params, batch, jcfg)
    params_t = _port(params)
    assert params_t["emb2"]["dense"].dtype == torch.bfloat16
    loss, grads = TT.loss_and_grads(params_t, to_torch(batch), tcfg, TTrain())
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    named = dict(zip(t_leaves(params_t), grads))
    assert named["emb2/dense"].dtype == torch.bfloat16
    assert named["emb1/dense"].dtype == torch.bfloat16
    assert named["field_cov"].dtype == torch.float32
    assert_trees_close(_tree.rebuild(params_t, named), want, rtol=2e-2, atol=1e-4)


def test_single_row_fields_take_the_batch_sum():
    """The backward adds one batch-sum per single-row field, not B rows: the
    gradient of a numeric slot equals the sum over the batch of value times
    cotangent, and the indices get no gradient."""
    from xsdeepfwfm_deprecated_torch.ops import embedding as t_emb
    spec = t_emb.make_spec(F_SIZES, NUM)
    table = torch.from_numpy(np.random.default_rng(0).normal(
        size=(spec.dense_rows, 4)).astype(np.float32)).requires_grad_(True)
    batch = to_torch(labelled_batch(B, seed=5))
    out = t_emb.packed_lookup({"dense": table}, spec, batch["xi"], batch["xv"])
    cot = torch.from_numpy(np.random.default_rng(1).normal(size=tuple(out.shape))
                           .astype(np.float32))
    (grad,) = torch.autograd.grad(out, table, cot)
    want = (cot[:, :NUM] * batch["xv"][:, :, None]).sum(dim=0)
    np.testing.assert_allclose(grad[:NUM].numpy(), want.numpy(), rtol=1e-5, atol=1e-6)
    plain = torch.zeros_like(table).index_add_(
        0, (batch["xi"].long() + torch.tensor(spec.dense_offsets[NUM:])).reshape(-1),
        cot[:, NUM:].reshape(-1, 4))
    np.testing.assert_allclose(grad[NUM:].numpy(), plain[NUM:].numpy(), rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------- train steps

@pytest.mark.parametrize("opt", ["adam", "rmsp", "adag", "sgd_momentum"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_train_steps_match_jax(family, opt):
    """Five steps with L2 on a padded batch, dropout off, against the JAX
    package's jitted ``make_train_step``. Losses within 1e-6. Parameters and
    optimizer state: atol 2e-6, rtol 1e-5. Adam's step is ``lr * g / (|g| +
    eps)`` at first, so a last-bit difference in a gradient moves a weight by
    up to about 1e-7 here (lr is 1e-3); five steps add up to 4e-7 at most in
    what was measured."""
    jcfg, tcfg = _cfgs(**FAMILIES[family], **NO_DROPOUT)
    kw = dict(OPTIMIZERS[opt], weight_decay=3e-7, learning_rate=1e-3, batch_size=B)
    jt, tt = JTrain(**kw), TTrain(**kw)
    params_j = JD.init_params(jax.random.PRNGKey(0), jcfg)
    params_t = _port(params_j)
    opt_j, opt_t = JT.make_optimizer(jt), TT.make_optimizer(tt)
    state_j, state_t = opt_j.init(params_j), opt_t.init(params_t)
    step_j = JT.make_train_step(jcfg, jt, opt_j)
    for i in range(5):
        batch = labelled_batch(B, seed=10 + i, n_pad=4)
        params_j, state_j, loss_j = step_j(params_j, state_j, *to_jax(batch),
                                           jax.random.PRNGKey(0), jnp.zeros(B))
        loss_t = TT.train_step(params_t, state_t, to_torch(batch), tcfg, tt, opt_t)
        np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=0, atol=1e-6)
    assert_trees_close(params_t, params_j, rtol=1e-5, atol=2e-6)
    assert_trees_close(state_t, state_j, rtol=1e-5, atol=2e-6)


@pytest.mark.parametrize("opt", list(OPTIMIZERS))
def test_bf16_table_train_steps_match_jax(opt):
    """Three steps with bf16 tables: the table's gradient and its moments are
    bf16 in both packages. XLA may keep excess precision between fused bf16
    operations where PyTorch rounds after each, so after three steps a table
    value may land up to two bf16 numbers away (rtol 2^-6), and a small value
    carries the rounding of its updates (atol = 3 steps x the largest update x
    2^-7; the largest update is lr, and 10 lr for RMSprop, whose first steps
    are g / sqrt(0.01 g^2)). The float32 leaves see the tables' ulps as
    percent-level changes of their gradients, which Adam and RMSprop
    normalize: a fifteenth of the three steps' reach."""
    jcfg, tcfg = _cfgs(use_fwfm=True, use_deep=True, table_dtype="bf16", **NO_DROPOUT)
    kw = dict(OPTIMIZERS[opt], weight_decay=3e-7, learning_rate=1e-3, batch_size=B)
    jt, tt = JTrain(**kw), TTrain(**kw)
    params_j = JD.init_params(jax.random.PRNGKey(0), jcfg)
    params_t = _port(params_j)
    opt_j, opt_t = JT.make_optimizer(jt), TT.make_optimizer(tt)
    state_j, state_t = opt_j.init(params_j), opt_t.init(params_t)
    step_j = JT.make_train_step(jcfg, jt, opt_j)
    for i in range(3):
        batch = labelled_batch(B, seed=10 + i, n_pad=4)
        params_j, state_j, _ = step_j(params_j, state_j, *to_jax(batch), jax.random.PRNGKey(0),
                                      jnp.zeros(B))
        TT.train_step(params_t, state_t, to_torch(batch), tcfg, tt, opt_t)
    for name, t in list(_tree.named_leaves(params_t)) + list(_tree.named_leaves(state_t)):
        is_table = "emb" in name
        assert t.dtype == (torch.bfloat16 if is_table else
                           torch.int32 if name.endswith("count") else torch.float32), name
    got, want = t_leaves(params_t), j_leaves(params_j)
    reach = 3 * 1e-3 * (10 if opt == "rmsp" else 1)
    for name in want:
        tol = (dict(rtol=2.0 ** -6, atol=reach * 2.0 ** -7) if "emb" in name
               else dict(rtol=1e-4, atol=reach / 15))
        np.testing.assert_allclose(got[name], want[name], err_msg=name, **tol)


def test_untouched_rows_change_only_by_l2():
    """A table row that no example reads has the gradient ``wd * w`` exactly,
    so SGD moves it to ``w - lr * wd * w`` and nowhere else."""
    _, tcfg = _cfgs(use_fwfm=True, use_deep=True, **NO_DROPOUT)
    tt = TTrain(optimizer_type="sgd", weight_decay=0.5, learning_rate=0.1)
    params = TD.init_params(torch.Generator().manual_seed(0), tcfg, device="cpu")
    before = params["emb2"]["dense"].clone()
    batch = to_torch(labelled_batch(B, seed=6))
    batch["xi"][:] = 0                               # every field reads its first row
    opt = TT.make_optimizer(tt)
    TT.train_step(params, opt.init(params), batch, tcfg, tt, opt)
    offsets = TD.make_embedding_spec(tcfg).dense_offsets
    untouched = torch.ones(before.shape[0], dtype=torch.bool)
    untouched[list(offsets)] = False
    want = before + (-0.1) * (0.5 * before)
    after = params["emb2"]["dense"]
    # one float32 rounding, fused or not
    np.testing.assert_allclose(after[untouched].numpy(), want[untouched].numpy(), rtol=2e-7,
                               atol=0)
    assert float((after[~untouched] - want[~untouched]).abs().max()) > 1e-5


def test_dropout_divides_by_a_tensor_at_rate_0_3():
    """The kept values are ``x / (1 - p)`` by a 0-d tensor on ``x``'s device:
    by a Python number PyTorch multiplies by the reciprocal on a CUDA device
    and divides on the CPU, and at p = 0.3 the two differ in the last bit of
    some values. Every division the dropout makes is watched."""
    from torch.overrides import TorchFunctionMode

    class Divisions(TorchFunctionMode):
        def __init__(self):
            super().__init__()
            self.divisors = []

        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func in (torch.Tensor.__truediv__, torch.Tensor.div, torch.div):
                self.divisors.append(args[1])
            return func(*args, **(kwargs or {}))

    x = torch.from_numpy(np.random.default_rng(3).normal(size=(64, 100)).astype(np.float32))
    with Divisions() as seen:
        out = t_mlp.dropout(torch.Generator().manual_seed(0), x, 0.3, True)
    assert len(seen.divisors) == 1
    divisor = seen.divisors[0]
    assert isinstance(divisor, torch.Tensor) and divisor.device == x.device
    keep_rate = torch.tensor(1.0 - 0.3, dtype=torch.float32)
    assert divisor.ndim == 0 and torch.equal(divisor, keep_rate)
    kept = out != 0
    assert torch.equal(out[kept], x[kept] / keep_rate)
    assert not torch.equal(x[kept] / keep_rate, x[kept] * (1.0 / keep_rate))


def test_dropout_keep_rate_scaling_and_seed():
    """With dropout on the streams differ from JAX's, so check the port's own:
    the keep rate (within five standard errors), the 1/(1-p) scaling, and that
    one generator seed repeats a train step."""
    x = torch.ones(200, 500)
    out = t_mlp.dropout(torch.Generator().manual_seed(0), x, 0.3, True)
    kept = out != 0
    assert abs(float(kept.float().mean()) - 0.7) < 5 * (0.3 * 0.7 / x.numel()) ** 0.5
    assert torch.equal(out[kept], torch.full_like(out[kept], 1.0) / (1.0 - 0.3))
    _, tcfg = _cfgs(use_fwfm=True, use_deep=True)
    tt = TTrain()
    batch = to_torch(labelled_batch(B, seed=7))

    def run(seed):
        params = TD.init_params(torch.Generator().manual_seed(0), tcfg, device="cpu")
        opt = TT.make_optimizer(tt)
        loss = TT.train_step(params, opt.init(params), batch, tcfg, tt, opt,
                             generator=torch.Generator().manual_seed(seed))
        return float(loss), params

    (l1, p1), (l2, p2), (l3, _) = run(3), run(3), run(4)
    assert l1 == l2 and l1 != l3
    assert all(torch.equal(a, b) for a, b in zip(_tree.leaves(p1), _tree.leaves(p2)))


# -------------------------------------------------------------------- fit

def fit_data(n, seed):
    rng = np.random.default_rng(seed)
    xi, xv = _batch(F_SIZES, NUM, n, seed)
    logit = xv[:, 0] - 0.5 * xv[:, 1] + (xi[:, 0] % 2) - 0.5
    y = (rng.random(n) < 1.0 / (1.0 + np.exp(-logit))).astype(np.float32)
    return xi, xv, y


def both_estimators(flags, train_kw, seed=0):
    jcfg, tcfg = _cfgs(**flags)
    est_j = JT.DeepFMEstimator(jcfg, JTrain(table_layout="flat", **train_kw), logger=QUIET)
    est_t = TT.DeepFMEstimator(tcfg, TTrain(table_layout="flat", **train_kw), logger=QUIET,
                               device="cpu")
    est_j.params = JD.init_params(jax.random.PRNGKey(seed), jcfg)
    est_t.params = _port(est_j.params)
    return est_j, est_t


FIT_KW = dict(n_epochs=2, batch_size=B, learning_rate=1e-2)


def test_fit_matches_jax_fit():
    """Two epochs (so the shared ``default_rng`` shuffle is used), a padded
    tail batch, a validation set, dropout off. Final parameters: atol 2e-5,
    rtol 1e-4 (16 Adam steps at lr 1e-2: ten times the step of the five-step
    test, three times the steps); the diagonal of ``field_cov`` 1e-3, see
    ``assert_trees_close``. Metrics per epoch: 1e-6 (float64 on the host,
    from logits that agree to 1e-5)."""
    flags = dict(use_fwfm=True, use_deep=True, use_lw=True, use_fwlw=True, **NO_DROPOUT)
    est_j, est_t = both_estimators(flags, FIT_KW)
    xi, xv, y = fit_data(230, seed=1)
    xi_v, xv_v, y_v = fit_data(90, seed=2)
    est_j.fit(xi, xv, y, xi_v, xv_v, y_v)
    est_t.fit(xi, xv, y, xi_v, xv_v, y_v)
    assert_trees_close(est_t.params, est_j.params, rtol=1e-4, atol=2e-5,
                       field_cov_diag_atol=1e-3)
    assert_trees_close(est_t.opt_state, est_j.opt_state, rtol=1e-4, atol=2e-5)
    assert len(est_t.train_result) == 2 and len(est_t.valid_result) == 2
    np.testing.assert_allclose(est_t.train_result, est_j.train_result, rtol=0, atol=1e-6)
    np.testing.assert_allclose(est_t.valid_result, est_j.valid_result, rtol=0, atol=1e-6)
    assert est_t.epoch_sparsity == est_j.epoch_sparsity
    np.testing.assert_allclose(est_t.last_epoch_mean_loss, est_j.last_epoch_mean_loss, atol=1e-6)
    assert est_t._step == est_j._step == 16
    np.testing.assert_allclose(est_t.eval_by_batch(xi_v, xv_v, y_v),
                               est_j.eval_by_batch(xi_v, xv_v, y_v), rtol=0, atol=1e-6)
    np.testing.assert_allclose(est_t.predict_proba(xi_v, xv_v), est_j.predict_proba(xi_v, xv_v),
                               rtol=0, atol=1e-6)
    assert est_t.evaluate(xi_v, xv_v, y_v) == pytest.approx(est_j.evaluate(xi_v, xv_v, y_v),
                                                            abs=1e-6)
    assert est_t.predict(xi_v, xv_v).dtype == bool


def test_steps_per_call_changes_no_result():
    """``steps_per_call`` and ``table_layout`` choose a dispatch form and a
    table layout in the JAX package. With ``steps_per_call=4`` the port takes
    its K path (``make_multi_step``, eager on the CPU) and trains the flat
    table: the same parameters, bit for bit."""
    flags = dict(use_fwfm=True, use_deep=True, **NO_DROPOUT)
    xi, xv, y = fit_data(100, seed=3)
    runs = []
    for extra in (dict(), dict(steps_per_call=4, table_layout="super")):
        _, tcfg = _cfgs(**flags)
        est = TT.DeepFMEstimator(tcfg, TTrain(n_epochs=1, batch_size=B, **extra), logger=QUIET,
                                 device="cpu")
        runs.append(est.fit(xi, xv, y).params)
    assert all(torch.equal(a, b) for a, b in zip(*map(_tree.leaves, runs)))


def test_keep_best_early_stop_and_termination_rule():
    flags = dict(use_fwfm=True, use_deep=True, **NO_DROPOUT)
    _, tcfg = _cfgs(**flags)
    est = TT.DeepFMEstimator(tcfg, TTrain(n_epochs=3, batch_size=B, learning_rate=1e-2),
                             logger=QUIET, device="cpu")
    xi, xv, y = fit_data(120, seed=4)
    xi_v, xv_v, y_v = fit_data(80, seed=5)
    est.fit(xi, xv, y, xi_v, xv_v, y_v, keep_best=True)
    assert est.valid_result[est.best_epoch] == max(est.valid_result) == est.best_valid_auc
    assert all(t.device.type == "cpu" for t in _tree.leaves(est.best_params))
    assert est.training_termination([0.9, 0.8, 0.7, 0.6, 0.5])
    assert not est.training_termination([0.9, 0.8, 0.7, 0.6])          # needs five epochs
    assert not est.training_termination([0.5, 0.9, 0.8, 0.85, 0.7])
    # early stopping ends fit at the epoch of the third decline in a row
    est.n_calls = 0
    est.eval_by_batch = lambda *a: (0.0, [0.9, 0.9, 0.8, 0.8, 0.7, 0.7, 0.6, 0.6, 0.5, 0.5,
                                          0.4, 0.4][_count(est)], 0.0, 0.0)
    est.tcfg = TTrain(n_epochs=6, batch_size=B)
    est.fit(xi, xv, y, xi_v, xv_v, y_v, early_stopping=True)
    assert len(est.valid_result) == 5


def _count(est):
    est.n_calls += 1
    return est.n_calls - 1


def test_mesh_flags_raise_until_the_sharding_slice():
    """A mesh larger than 1x1 trains sharded over ranks that the caller starts
    (``tests/test_torch_sharding.py``); without them ``fit`` says how to
    launch instead of training on one device."""
    _, tcfg = _cfgs(use_fwfm=True, use_deep=True)
    est = TT.DeepFMEstimator(tcfg, TTrain(mesh_model=2), logger=QUIET, device="cpu")
    with pytest.raises(ValueError, match="torchrun"):
        est.fit(*fit_data(40, seed=6))
    # run_benchmark no longer waits for serving/benchmark.py: it serves a fitted estimator
    est = TT.DeepFMEstimator(tcfg, TTrain(n_epochs=1, batch_size=B), logger=QUIET, device="cpu")
    res = est.fit(*fit_data(40, seed=6)).run_benchmark(*fit_data(40, seed=6), batch_size=B)
    assert np.isfinite(res["auc"]) and res["batch_ms"] > 0


# ------------------------------------------- own copies of jax-free modules

# the port's own models (xDeepFM, DLRM-DCNv2): flags and config fields that the JAX package lacks
PORT_FLAGS = {"use_cin": 0, "cin_layers": "200,200,200", "use_dlrm": 0, "bag_sizes": "",
              "dense_arch_layers": "512,256,128", "dcn_num_layers": 3, "dcn_low_rank_dim": 512,
              "over_arch_layers": "1024,1024,512,256,1", "optimizer_type": "adam",
              "bag_row_wise_rows": 1_000_000}
PORT_FIELDS = {"use_cin": False, "cin_layers": (), "use_dlrm": False, "bag_sizes": (),
               "dense_arch_layers": (), "dcn_num_layers": 0, "dcn_low_rank_dim": 0,
               "over_arch_layers": (), "bag_row_wise_rows": 1_000_000}


def _shared(ns, own):
    """``ns``'s fields less the port's own, which must hold their defaults."""
    d = dict(vars(ns))
    assert {k: d.pop(k) for k in own} == own
    return d


def test_parser_and_configs_match_the_jax_package():
    argv = ["-use_fwlw", "1", "-prune", "1", "-sparse", "0.8", "-qr_emb", "1", "-l2", "1e-6",
            "-steps_per_call", "8", "-table_layout", "flat", "-mesh_data", "1", "-exchange",
            "psum", "-save_model_path", "m", "-table_dtype", "bf16", "-prune_omega", "50"]
    got, want = get_parser().parse_args(argv), j_get_parser().parse_args(argv)
    assert _shared(got, PORT_FLAGS) == vars(want)
    assert _shared(get_parser().parse_args([]), PORT_FLAGS) == vars(j_get_parser().parse_args([]))
    t_m, t_t = configs_from_args(got, 6, F_SIZES)
    j_m, j_t = j_configs_from_args(want, 6, F_SIZES)
    assert _shared(t_m, PORT_FIELDS) == vars(j_m) and vars(t_t) == vars(j_t)
    # the JAX package's namespace, without the port's flags, builds the same configs
    assert configs_from_args(want, 6, F_SIZES) == (t_m, t_t)
    assert vars(TTrain()) == vars(JTrain())
    for n_iter in (0, 7, 100, 100000):
        assert TTrain(sparse=0.7).adaptive_sparse(n_iter) == JTrain(sparse=0.7).adaptive_sparse(n_iter)
    flagship = flagship_train_config()
    assert (flagship.optimizer_type, flagship.learning_rate, flagship.weight_decay,
            flagship.batch_size, flagship.prune_interval) == ("adam", 1e-3, 3e-7, 2048, 10)


def test_batching_matches_the_jax_package():
    xi, xv, y = fit_data(70, seed=8)
    got = list(TB.iter_batches(xi, xv, y, 32))
    want = list(JB.iter_batches(xi, xv, y, 32))
    assert len(got) == len(want) == TB.pad_batch_count(70, 32) == 3
    for g, w in zip(got, want):
        assert g["n_valid"] == w["n_valid"]
        for k in ("xi", "xv", "y", "mask"):
            np.testing.assert_array_equal(g[k], w[k])
            assert g[k].dtype == w[k].dtype
    assert got[-1]["mask"].sum() == 6 and got[-1]["xi"].shape == (32, 3)
    a = TB.shuffle_arrays(np.random.default_rng(5), xi, xv, y)
    b = JB.shuffle_arrays(np.random.default_rng(5), xi, xv, y)
    assert all(np.array_equal(p, q) for p, q in zip(a, b))
    on_device = list(TB.prefetch_to_device(iter(got), torch.device("cpu")))
    assert len(on_device) == 3 and on_device[2]["n_valid"] == 6
    for g, d in zip(got, on_device):
        assert d["xi"].dtype == torch.int32 and d["mask"].dtype == torch.float32
        np.testing.assert_array_equal(d["xv"].numpy(), g["xv"])


def test_metrics_match_the_jax_package():
    rng = np.random.default_rng(9)
    y = (rng.random(300) < 0.3).astype(np.float64)
    p = np.round(rng.random(300), 2)                  # ties
    for name in ("roc_auc", "log_loss"):
        assert getattr(TM, name)(y, p) == getattr(JM, name)(y, p)
    assert TM.prauc(p, y) == JM.prauc(p, y) and TM.rce(p, y) == JM.rce(p, y)
    assert TM.bce_logits_sum(y, p * 8 - 4) == JM.bce_logits_sum(y, p * 8 - 4)
    assert np.isnan(TM.roc_auc(np.ones(4), p[:4]))


class _Flaky:
    """Fails ``fail`` times with ``error``, writing a checkpoint first."""

    def __init__(self, fail, error, tmp_path):
        self.fail, self.error, self.calls, self.logs = fail, error, [], []
        self.params = self.opt_state = "device state"
        self.path = str(tmp_path / "ckpt")

    def _log(self, msg):
        self.logs.append(msg)

    def fit(self, *args, save_path, resume_from, **kw):
        self.calls.append(resume_from)
        if len(self.calls) <= self.fail:
            np.savez(save_path + ".npz", x=np.zeros(1))
            raise self.error
        return self


def test_fit_with_recovery_restarts_from_the_checkpoint(tmp_path):
    est = _Flaky(2, RuntimeError("CUDA error: an illegal memory access"), tmp_path)
    assert t_recovery.fit_with_recovery(est, 1, 2, save_path=est.path, max_restarts=2) is est
    assert est.calls == [None, est.path, est.path]
    assert est.params is None and est.opt_state is None
    assert any("restart 2/2 resuming from" in m for m in est.logs)
    with pytest.raises(RuntimeError):
        t_recovery.fit_with_recovery(_Flaky(3, RuntimeError("x"), tmp_path), save_path=est.path,
                                     max_restarts=2)
    bug = _Flaky(1, ValueError("a bug, not a device failure"), tmp_path)
    with pytest.raises(ValueError):
        t_recovery.fit_with_recovery(bug, save_path=bug.path)
    assert bug.calls == [None]
    types = t_recovery._recoverable_types()
    assert RuntimeError in types and OSError in types
    assert not any(t.__module__.startswith("jax") for t in types)
