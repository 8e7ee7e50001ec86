"""xDeepFM (``use_cin``) on the port's normal path, at tiny sizes on the CPU,
against the plain reference of ``xdeepfm_reference.py`` on seeded random
weights: the forward, every gradient, the train step, the fp32 Predictor, the
checkpoint, a fit from the command-line flags and the CIN's spans; and the
paths that have no CIN refusing it by name.

Tolerances: the program and the reference sum the same float32 terms in other
orders (the CIN's products as one GEMM of (B·D, H·m) against an einsum over
(H, m)), so they part by a few units in the last place of the largest term;
at these sizes that is below 1e-6 of a logit of order 1."""

import numpy as np
import pytest
import torch

import xdeepfm_reference as ref
from xsdeepfwfm_deprecated_torch import _tree
from xsdeepfwfm_deprecated_torch.compression.quantization import convert
from xsdeepfwfm_deprecated_torch.config import (ModelConfig, TrainConfig, configs_from_args,
                                                get_parser)
from xsdeepfwfm_deprecated_torch.models import deepfwfm
from xsdeepfwfm_deprecated_torch.models.factory import get_model
from xsdeepfwfm_deprecated_torch.serving.compaction import compact_for_serving
from xsdeepfwfm_deprecated_torch.serving.predictor import Predictor
from xsdeepfwfm_deprecated_torch.train import trainer
from xsdeepfwfm_deprecated_torch.utils import profiling

SIZES = (1, 1, 7, 5, 9, 4)          # F=6, the first 2 numeric
B = 16
CFG = {"feature_sizes": SIZES, "numerical": 2, "embedding_size": 4, "cin_layers": (5, 3),
       "h_depth": 2, "deep_nodes": 8, "dropout_deep": 0.5, "learning_rate": 1e-3,
       "weight_decay": 1e-4}
FLAGS = ["-use_cin", "1", "-cin_layers", "5,3", "-use_fwfm", "0", "-use_deep", "1",
         "-deep_nodes", "8", "-h_depth", "2", "-embedding_size", "4", "-numerical", "2",
         "-batch_size", str(B), "-n_epochs", "1", "-l2", "1e-4"]


def _mcfg(**kw):
    return ModelConfig(field_size=len(SIZES), feature_sizes=SIZES, numerical=2, embedding_size=4,
                       use_fwfm=False, use_deep=True, use_cin=True, cin_layers=(5, 3),
                       h_depth=2, deep_nodes=8, dropout_deep=0.5, **kw)


def _tcfg(**kw):
    return TrainConfig(batch_size=B, learning_rate=1e-3, weight_decay=1e-4, **kw)


def _params(seed=0):
    """The program's init, its tables scaled up (emb2 to N(0, 0.5²), emb1 to
    N(0, 0.1²)) so that the CIN's deeper layers, polynomials of degree 3 and
    4 in the embeddings, are far from rounding noise."""
    params = deepfwfm.init_params(torch.Generator().manual_seed(seed), _mcfg(), device="cpu")
    params["emb2"]["dense"].mul_(50.0)
    params["emb1"]["dense"].mul_(0.1)
    return params


def _weights(params):
    return {k: v.clone() for k, v in _tree.named_leaves(params)}


def _rows(n, seed=1):
    g = torch.Generator().manual_seed(seed)
    xi = torch.stack([torch.randint(0, s + 2, (n,), generator=g) for s in SIZES[2:]], 1)
    xv = torch.randn((n, 2), generator=g)
    y = (torch.rand((n,), generator=g) < 0.3).float()
    return xi.to(torch.int32), xv, y


def _batch(xi, xv, y):
    return {"xi": xi, "xv": xv, "y": y, "mask": torch.ones(xi.shape[0])}


def test_eval_logits_match_the_reference():
    params = _params()
    xi, xv, _ = _rows(B)
    got = deepfwfm.forward(params, xi, xv, _mcfg())
    want = ref.forward(_weights(params), CFG, xi, xv)
    assert float(want.std()) > 0.3             # a logit of order 1, the CIN's share in it
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)


def test_every_gradient_matches_the_reference():
    params = _params()
    xi, xv, y = _rows(B)
    loss, grads = trainer.loss_and_grads(params, _batch(xi, xv, y), _mcfg(), _tcfg(),
                                         generator=torch.Generator().manual_seed(4))
    want_loss, want = ref.grads(_weights(params), CFG, {"xi": xi, "xv": xv, "y": y},
                                torch.Generator().manual_seed(4))
    assert float(loss) == pytest.approx(want_loss, rel=1e-6)
    names = [k for k, _ in _tree.named_leaves(params)]
    assert {"cin/layers/0/w", "cin/layers/1/w", "cin/fc_w"} <= set(names)
    for name, g in zip(names, grads):
        # a few ulps of the leaf's largest gradient: the sums run in other orders
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=1e-4,
                                   atol=1e-6 * float(want[name].abs().max()), err_msg=name)
        assert float(want[name].abs().max()) > 0, name


def test_two_train_steps_match_the_reference():
    params = _params()
    w0 = _weights(params)
    xi, xv, y = _rows(2 * B)
    tcfg = _tcfg()
    opt = trainer.make_optimizer(tcfg)
    state = opt.init(params)
    step = trainer.make_train_step(_mcfg(), tcfg, opt)
    gen = torch.Generator().manual_seed(9)
    batches = [(xi[i * B:(i + 1) * B], xv[i * B:(i + 1) * B], y[i * B:(i + 1) * B])
               for i in range(2)]
    losses = [float(step(params, state, _batch(*b), gen)) for b in batches]
    want_losses, want = ref.steps(w0, CFG, [{"xi": a, "xv": b, "y": c} for a, b, c in batches],
                                  torch.Generator().manual_seed(9))
    np.testing.assert_allclose(losses, want_losses, rtol=1e-6)
    for name, p in _tree.named_leaves(params):
        # Adam's step is about lr a value: a thousandth of it covers the rounding of g/sqrt(v)
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=0, atol=1e-6,
                                   err_msg=name)
        assert not torch.equal(p, w0[name]), name


def test_fp32_predictor_matches_the_reference():
    params = _params()
    xi, xv, _ = _rows(3 * B, seed=5)
    got = Predictor(params, _mcfg(), device="cpu").logits(xi.numpy(), xv.numpy())
    np.testing.assert_allclose(got, ref.forward(_weights(params), CFG, xi, xv).numpy(),
                               rtol=1e-5, atol=1e-6)


def test_npz_checkpoint_round_trip_keeps_the_cin(tmp_path):
    est = trainer.DeepFMEstimator(_mcfg(), _tcfg(), device="cpu")
    est.params = _params(seed=3)
    path = str(tmp_path / "xdeepfm")
    est.save(path)
    back = trainer.DeepFMEstimator(_mcfg(), _tcfg(), device="cpu").load(path)
    got, want = dict(_tree.named_leaves(back.params)), dict(_tree.named_leaves(est.params))
    assert set(got) == set(want) and "cin/layers/1/w" in got and "cin/fc_w" in got
    for k in want:
        assert torch.equal(got[k], want[k]), k
    xi, xv, _ = _rows(B)
    assert torch.equal(deepfwfm.forward(back.params, xi, xv, _mcfg()),
                       deepfwfm.forward(est.params, xi, xv, _mcfg()))


def test_fit_from_the_flags_matches_the_reference():
    pars = get_parser().parse_args(FLAGS)
    mcfg, tcfg = configs_from_args(pars, len(SIZES), SIZES)
    # -use_lw keeps its default, 1, which weighs FM terms this model does not have
    assert mcfg == _mcfg(use_lw=True) and mcfg.model_name == "xDeepFM"
    est = get_model(len(SIZES), SIZES, pars=pars, device="cpu")
    est.params = _params(seed=2)
    w0 = _weights(est.params)
    xi, xv, y = _rows(2 * B, seed=6)
    est.fit(xi.numpy(), xv.numpy(), y.numpy())
    batches = [{"xi": xi[i * B:(i + 1) * B], "xv": xv[i * B:(i + 1) * B],
                "y": y[i * B:(i + 1) * B]} for i in range(2)]
    # fit's dropout generator is seeded random_seed + 1 and the first epoch keeps row order
    want_losses, want = ref.steps(w0, CFG, batches,
                                  torch.Generator().manual_seed(tcfg.random_seed + 1))
    np.testing.assert_allclose(est.last_epoch_losses, want_losses, rtol=1e-6)
    for name, p in _tree.named_leaves(est.params):
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=0, atol=1e-6,
                                   err_msg=name)


def test_the_cin_is_one_span_with_a_child_a_layer():
    params = _params()
    xi, xv, _ = _rows(B)
    profiling.spans()
    with profiling.tracing():
        deepfwfm.forward(params, xi, xv, _mcfg())
        spans = profiling.spans()
    cin = [s for s in spans if s.name == profiling.SCOPE_CIN]
    assert len(cin) == 1
    layers = sorted((s for s in spans if s.name.startswith("CIN - Layer")), key=lambda s: s.name)
    assert [s.name for s in layers] == ["CIN - Layer 1", "CIN - Layer 2"]
    assert all(s.parent_id == cin[0].span_id for s in layers)
    assert any(s.name == profiling.SCOPE_DEEP for s in spans)


def test_the_flagship_tree_is_unchanged_without_the_cin():
    cfg = ModelConfig(field_size=len(SIZES), feature_sizes=SIZES, numerical=2, embedding_size=4,
                      use_fwfm=True, use_deep=True, use_lw=True, use_fwlw=True, h_depth=3,
                      deep_nodes=8)
    tree = deepfwfm.init_params(None, cfg, device="meta")
    assert [(k, tuple(v.shape)) for k, v in _tree.named_leaves(tree)] == [
        ("bias", (1,)), ("emb2/dense", (sum(SIZES), 4)), ("lw_w", (6, 1)), ("fwlw_w", (6, 4)),
        ("field_cov", (6, 6)),
        ("deep/net_1/layers/0/w", (24, 8)), ("deep/net_1/layers/0/b", (8,)),
        ("deep/net_1/layers/1/w", (8, 8)), ("deep/net_1/layers/1/b", (8,)),
        ("deep/net_1/layers/2/w", (8, 8)), ("deep/net_1/layers/2/b", (8,)),
        ("deep/net_1/fc_w", (8, 1))]
    assert not cfg.use_cin and cfg.cin_layers == () and cfg.model_name == "DeepFwFM"


def test_the_config_refuses_a_cin_beside_a_shallow_term_or_without_widths():
    with pytest.raises(ValueError, match="use_cin"):
        ModelConfig(field_size=6, feature_sizes=SIZES, use_cin=True, cin_layers=(5,))  # FwFM on
    with pytest.raises(ValueError, match="use_cin"):
        ModelConfig(field_size=6, feature_sizes=SIZES, use_fwfm=False, use_cin=True)
    with pytest.raises(ValueError, match="use_cin"):
        ModelConfig(field_size=6, feature_sizes=SIZES, cin_layers=(5,))
    cin_only = ModelConfig(field_size=6, feature_sizes=SIZES, use_fwfm=False, use_deep=False,
                           use_cin=True, cin_layers=(5,))
    assert cin_only.model_name == "CIN"
    assert "deep" not in deepfwfm.init_params(None, cin_only, device="meta")


# ---------------------------------------------------- the paths without a CIN

@pytest.mark.parametrize("mode", ["dynamic", "static"])
def test_int8_conversion_refuses_the_cin(mode):
    with pytest.raises(ValueError, match="use_cin"):
        convert(_params(), _mcfg(), mode)


def test_quantization_aware_training_refuses_the_cin():
    with pytest.raises(ValueError, match="use_cin"):
        _mcfg(quantization_aware=True)
    pars = get_parser().parse_args(FLAGS)
    with pytest.raises(ValueError, match="use_cin"):
        get_model(len(SIZES), SIZES, pars=pars, quantization_aware=True, device="cpu")


def test_compaction_refuses_the_cin():
    with pytest.raises(ValueError, match="use_cin"):
        compact_for_serving(_params(), _mcfg())


def test_a_sharded_fit_refuses_the_cin():
    est = trainer.DeepFMEstimator(_mcfg(), _tcfg(mesh_data=2), device="cpu")
    xi, xv, y = _rows(2 * B)
    with pytest.raises(ValueError, match="use_cin"):
        est.fit(xi.numpy(), xv.numpy(), y.numpy())


def test_the_prune_refresh_leaves_the_cin_as_it_is():
    params = _params()
    before = _weights(params)
    trainer.PruneRefresh(dict(emb_r=1.0, emb_corr=1.0, prune_fm=True, prune_deep=True,
                              prune_r=False, structured_deep=False))(params, 0.5)
    after = dict(_tree.named_leaves(params))
    for k in ("cin/layers/0/w", "cin/layers/1/w", "cin/fc_w"):
        assert torch.equal(after[k], before[k]), k
    w = after["deep/net_1/layers/0/w"]
    assert 0.4 < float((w == 0).float().mean()) < 0.6          # the tower was pruned
    assert float((after["emb2/dense"] == 0).float().mean()) > 0.4
