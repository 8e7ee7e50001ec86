"""Distillation and quantization-aware training in the port against the JAX
package, on the CPU: ``kd_loss``, ``fake_quant`` and its straight-through
gradient, ``qat_mlp_forward``, ``calibrate``, a KD ``fit``, and a QAT ``fit``
that is converted and served.

Inputs come from numpy with a seed; parameters are made by the JAX package.
Each comparison states its tolerance and why.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_serving import F_SIZES, NUM, _batch, _cfgs, _port
from test_torch_train import (NO_DROPOUT, assert_trees_close, both_estimators, fit_data,
                              labelled_batch, to_jax, to_torch)
from xsdeepfwfm_deprecated_tpu.compression import distillation as JKD
from xsdeepfwfm_deprecated_tpu.compression import quantization as JQ
from xsdeepfwfm_deprecated_tpu.config import TrainConfig as JTrain
from xsdeepfwfm_deprecated_tpu.models import deepfwfm as JD
from xsdeepfwfm_deprecated_tpu.ops import mlp as j_mlp
from xsdeepfwfm_deprecated_tpu.ops import quantized as j_q
from xsdeepfwfm_deprecated_tpu.serving.predictor import Predictor as JPredictor
from xsdeepfwfm_deprecated_tpu.train import trainer as JT
from xsdeepfwfm_deprecated_torch import _tree, weights
from xsdeepfwfm_deprecated_torch.compression import distillation as TKD
from xsdeepfwfm_deprecated_torch.compression import quantization as TQ
from xsdeepfwfm_deprecated_torch.config import TrainConfig as TTrain
from xsdeepfwfm_deprecated_torch.models import deepfwfm as TD
from xsdeepfwfm_deprecated_torch.ops import mlp as t_mlp
from xsdeepfwfm_deprecated_torch.ops import quantized as t_q
from xsdeepfwfm_deprecated_torch.serving.predictor import Predictor as TPredictor
from xsdeepfwfm_deprecated_torch.train import trainer as TT

B = 32


# ------------------------------------------------------------ distillation

@pytest.mark.parametrize("n_pad", [0, 7], ids=["full", "padded_tail"])
def test_kd_loss_value_and_gradient_match_jax(n_pad):
    """The softmax runs over the batch axis and masked rows take no share of
    it. Value: rtol 1e-5. Gradient with respect to the student's logits: rtol
    1e-4, atol 1e-7 (float32 log-sum-exp in another order)."""
    rng = np.random.default_rng(0)
    student = rng.normal(size=B).astype(np.float32) * 3
    teacher = rng.normal(size=B).astype(np.float32) * 3
    batch = labelled_batch(B, seed=1, n_pad=n_pad)
    y, mask = batch["y"], batch["mask"]
    want, want_grad = jax.value_and_grad(JKD.kd_loss)(
        jnp.asarray(student), jnp.asarray(teacher), jnp.asarray(y), jnp.asarray(mask),
        alpha=0.9, temperature=20.0)
    s = torch.from_numpy(student).requires_grad_(True)
    got = TKD.kd_loss(s, torch.from_numpy(teacher), torch.from_numpy(y), torch.from_numpy(mask),
                      alpha=0.9, temperature=20.0)
    (got_grad,) = torch.autograd.grad(got, s)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(got_grad.numpy(), np.asarray(want_grad), rtol=1e-4, atol=1e-7)
    if n_pad:
        assert bool((got_grad[-n_pad:] == 0).all())


def test_kd_fit_matches_jax_fit():
    """One epoch of distillation from a teacher with the same weights in both
    packages, a padded tail batch: the student's parameters within atol 2e-5,
    rtol 1e-4 and the train metric within 1e-6, as in the plain fit test."""
    flags = dict(use_fwfm=True, use_deep=True, use_lw=True, use_fwlw=True, **NO_DROPOUT)
    kw = dict(n_epochs=1, batch_size=B, learning_rate=1e-2, kd=True)
    teacher_j, teacher_t = both_estimators(flags, kw, seed=1)
    student_j, student_t = both_estimators(flags, kw, seed=2)
    xi, xv, y = fit_data(150, seed=3)
    student_j.fit(xi, xv, y, teacher_model=teacher_j)
    student_t.fit(xi, xv, y, teacher_model=teacher_t)
    assert_trees_close(student_t.params, student_j.params, rtol=1e-4, atol=2e-5,
                       field_cov_diag_atol=1e-3)
    np.testing.assert_allclose(student_t.train_result, student_j.train_result, rtol=0, atol=1e-6)
    # the KL term is a difference of float32 log-softmaxes times alpha * T^2 = 360
    np.testing.assert_allclose(student_t.last_epoch_mean_loss, student_j.last_epoch_mean_loss,
                               rtol=0, atol=2e-6)
    # the KD loss is not the BCE: the same run without a teacher ends elsewhere
    _, plain = both_estimators(flags, kw, seed=2)
    plain.fit(xi, xv, y)
    assert abs(plain.last_epoch_mean_loss - student_t.last_epoch_mean_loss) > 1e-3


# -------------------------------------------------------------- fake quant

def test_fake_quant_value_and_straight_through_gradient():
    """Values equal JAX's exactly (one division, one rounding, one product);
    the gradient is the cotangent itself, for clipped values too, and the
    scale gets none."""
    rng = np.random.default_rng(2)
    x = (rng.normal(size=(6, 5)) * 3).astype(np.float32)
    cot = rng.normal(size=(6, 5)).astype(np.float32)
    scale = np.float32(0.02)                                   # clips |x| > 2.54
    want = j_q.fake_quant(jnp.asarray(x), jnp.float32(scale))
    want_grad = jax.grad(lambda v: jnp.sum(j_q.fake_quant(v, jnp.float32(scale)) * cot))(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    st = torch.tensor(scale, requires_grad=True)
    got = t_q.fake_quant(xt, st)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    assert float(got.detach().abs().max()) == pytest.approx(127 * 0.02, rel=1e-6)
    grad_x, grad_s = torch.autograd.grad(got, (xt, st), torch.from_numpy(cot), allow_unused=True)
    np.testing.assert_array_equal(grad_x.numpy(), cot)
    np.testing.assert_array_equal(grad_x.numpy(), np.asarray(want_grad))
    assert grad_s is None
    per_tensor = t_q.fake_quant_per_tensor(torch.from_numpy(x))
    np.testing.assert_array_equal(per_tensor.numpy(),
                                  np.asarray(j_q.fake_quant_per_tensor(jnp.asarray(x))))
    assert len(np.unique(per_tensor.numpy())) <= 255


def test_qat_mlp_forward_and_gradients_match_jax():
    """The fake-quantized tower. Output: rtol/atol 1e-5. Gradients of the
    weights, biases and input: rtol 1e-4, atol 1e-6."""
    jcfg, _ = _cfgs(use_deep=True)
    net = JD.init_params(jax.random.PRNGKey(3), jcfg)["deep"]["net_1"]
    x = np.random.default_rng(4).normal(size=(B, len(F_SIZES) * 4)).astype(np.float32)
    rates = (0.0,) * 3

    def j_fn(net, x):
        return jnp.sum(j_mlp.qat_mlp_forward(net, x, dropout_rates=rates) ** 2)

    want_out = j_mlp.qat_mlp_forward(net, jnp.asarray(x), dropout_rates=rates)
    want_net, want_x = jax.grad(j_fn, argnums=(0, 1))(net, jnp.asarray(x))
    net_t = _tree.tree_map(lambda t: t.requires_grad_(True), _port(net))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = t_mlp.qat_mlp_forward(net_t, xt, dropout_rates=rates)
    assert out.shape == (B, 1)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), rtol=1e-5, atol=1e-5)
    leaves = _tree.leaves(net_t)
    grads = torch.autograd.grad((out ** 2).sum(), leaves + [xt])
    named = dict(zip([n for n, _ in _tree.named_leaves(net_t)], grads))
    assert_trees_close(_tree.rebuild(net_t, named), want_net, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(grads[-1].numpy(), np.asarray(want_x), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("flags", [dict(use_fwfm=True, use_deep=True, use_lw=True, use_fwlw=True),
                                   dict(use_ffm=True, use_deep=True), dict(use_deep=True)],
                         ids=["DeepFwFM", "DeepFFM", "DNN"])
def test_quantization_aware_forward_matches_jax(flags):
    """``quantization_aware`` switches the tower to the QAT form on the flat
    activation vector, in eval mode too: rtol/atol 1e-5."""
    jcfg, tcfg = _cfgs(quantization_aware=True, **flags)
    params = JD.init_params(jax.random.PRNGKey(5), jcfg)
    xi, xv = _batch(F_SIZES, NUM, B, seed=6)
    want = np.asarray(JD.forward(params, jnp.asarray(xi), jnp.asarray(xv), jcfg))
    got = TD.forward(_port(params), torch.from_numpy(xi), torch.from_numpy(xv), tcfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    plain_cfg = _cfgs(**flags)[1]
    plain = TD.forward(_port(params), torch.from_numpy(xi), torch.from_numpy(xv), plain_cfg)
    assert not np.allclose(plain.numpy(), want, rtol=1e-5, atol=1e-5)


def test_qat_train_steps_match_jax():
    """Three QAT train steps against ``make_train_step``. A fake-quantized
    value that lies on a rounding boundary may fall to either code when the
    two packages differ in its last bit, which moves a logit by one quantum;
    none did on these inputs, and the tolerance is the train-step test's."""
    jcfg, tcfg = _cfgs(use_fwfm=True, use_deep=True, quantization_aware=True, **NO_DROPOUT)
    kw = dict(optimizer_type="adam", weight_decay=3e-7, batch_size=B)
    jt, tt = JTrain(**kw), TTrain(**kw)
    params_j = JD.init_params(jax.random.PRNGKey(7), jcfg)
    params_t = _port(params_j)
    opt_j, opt_t = JT.make_optimizer(jt), TT.make_optimizer(tt)
    state_j, state_t = opt_j.init(params_j), opt_t.init(params_t)
    step_j = JT.make_train_step(jcfg, jt, opt_j)
    for i in range(3):
        batch = labelled_batch(B, seed=20 + i)
        params_j, state_j, loss_j = step_j(params_j, state_j, *to_jax(batch),
                                           jax.random.PRNGKey(0), jnp.zeros(B))
        loss_t = TT.train_step(params_t, state_t, to_torch(batch), tcfg, tt, opt_t)
        np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=0, atol=1e-6)
    assert_trees_close(params_t, params_j, rtol=1e-5, atol=2e-6)


# ------------------------------------------------------------- calibration

@pytest.mark.parametrize("flags", [dict(use_fwfm=True, use_deep=True),
                                   dict(use_fwfm=True, use_deep=True, num_deeps=2),
                                   dict(use_ffm=True, use_deep=True)],
                         ids=["one_net", "two_nets", "DeepFFM"])
def test_calibrate_matches_jax(flags):
    """Abs-max of float32 activations, divided by 127 in float64 on the host
    and rounded once: rtol 1e-6 (a matmul's sums in another order can move an
    abs-max by an ulp)."""
    jcfg, tcfg = _cfgs(**flags)
    params = JD.init_params(jax.random.PRNGKey(8), jcfg)
    xi, xv = _batch(F_SIZES, NUM, 300, seed=9)
    want = JQ.calibrate(params, jcfg, xi, xv, n_batches=3, batch_size=128)
    got = TQ.calibrate(_port(params), tcfg, xi, xv, n_batches=3, batch_size=128)
    assert got["input"].dtype == torch.float32 and got["input"].ndim == 0
    assert set(got["nets"]) == set(want["nets"])
    np.testing.assert_allclose(float(got["input"]), float(want["input"]), rtol=1e-6)
    for name, scales in want["nets"].items():
        assert len(got["nets"][name]) == len(scales) == jcfg.h_depth
        np.testing.assert_allclose([float(s) for s in got["nets"][name]],
                                   [float(s) for s in scales], rtol=1e-6)
    # the port's own scales serve: static int8 logits equal the JAX static path
    qm_t = TQ.convert(_port(params), tcfg, "static", act_scales=got)
    qm_j = JQ.convert(params, jcfg, "static", act_scales=want)
    got_logits = TQ.quantized_forward(qm_t, torch.from_numpy(xi[:B]), torch.from_numpy(xv[:B]))
    want_logits = JQ.quantized_forward(qm_j, jnp.asarray(xi[:B]), jnp.asarray(xv[:B]))
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits), rtol=1e-4, atol=1e-4)


# ------------------------------------------------------- QAT end to end

def test_qat_fit_convert_and_serve():
    """Train with ``quantization_aware``, convert with ``mode="qat"``, serve
    through the ``Predictor``. The int8 logits stay near the fake-quantized
    eval logits (both quantize to 8 bits, per tensor against per channel and
    per batch: within 0.05 on logits of the order of 1), and equal the JAX
    package's conversion and ``Predictor`` on the same trained parameters
    (rtol/atol 1e-4, the int8 serving tests' tolerance)."""
    flags = dict(use_fwfm=True, use_deep=True, use_lw=True, use_fwlw=True,
                 quantization_aware=True, **NO_DROPOUT)
    kw = dict(n_epochs=2, batch_size=B, learning_rate=1e-2)
    est_j, est_t = both_estimators(flags, kw)
    xi, xv, y = fit_data(200, seed=10)
    est_t.fit(xi, xv, y)
    assert np.isfinite(est_t.last_epoch_mean_loss)
    qm = TQ.convert(est_t.params, est_t.mcfg, mode="qat")
    assert qm.mode == "qat" and qm.act_scales is None
    served = TPredictor(qm, device="cpu").logits(xi[:64], xv[:64])
    trained = est_t._predict_logits(xi[:64], xv[:64])
    assert np.abs(served - trained).max() < 0.05
    params_j = jax.tree.map(jnp.asarray, weights.params_to_numpy(est_t.params))
    want = JPredictor(JQ.convert(params_j, est_j.mcfg, mode="qat"), layout="flat").logits(
        xi[:64], xv[:64])
    np.testing.assert_allclose(served, want, rtol=1e-4, atol=1e-4)
    # the fp32 Predictor serves what the estimator trained
    fp32 = TPredictor(est_t.params, est_t.mcfg, device="cpu").logits(xi[:64], xv[:64])
    np.testing.assert_allclose(fp32, trained, rtol=1e-5, atol=1e-5)
