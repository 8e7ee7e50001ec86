"""DLRM-DCNv2 (``use_dlrm``) on the port's normal path, at tiny sizes on the
CPU, against the plain reference of ``dlrm_dcnv2_reference.py`` on seeded
random weights: the forward, every gradient, the train step's sparse Adagrad
(ids repeated within a bag and across rows), the rows no batch reads, the fp32
Predictor, the checkpoint, a fit from the command-line flags and the spans;
the paths that have no bags refusing the model by name; and the flagship
unchanged beside it.

Tolerances: the program and the reference sum the same float32 terms in
other orders (a bag through ``embedding_bag`` against a sum of gathered rows,
Adagrad's ``g · rsqrt(acc)`` against ``g / sqrt(acc)``), so they part by a
few units in the last place; at these sizes that is below 1e-6 of a logit of
order 1 and of a step of order lr."""

import jax
import numpy as np
import pytest
import torch

import dlrm_dcnv2_reference as ref
from test_torch_serving import F_SIZES, NUM, _batch, _cfgs, _j_logits, _port
from xsdeepfwfm_deprecated_torch import _tree
from xsdeepfwfm_deprecated_torch.compression.quantization import convert
from xsdeepfwfm_deprecated_torch.config import (ModelConfig, TrainConfig, configs_from_args,
                                                get_parser)
from xsdeepfwfm_deprecated_torch.models import deepfwfm, dlrm
from xsdeepfwfm_deprecated_torch.models.factory import get_model
from xsdeepfwfm_deprecated_torch.ops import embedding as emb_ops
from xsdeepfwfm_deprecated_torch.serving.compaction import compact_for_serving
from xsdeepfwfm_deprecated_torch.serving.predictor import Predictor
from xsdeepfwfm_deprecated_torch.train import trainer
from xsdeepfwfm_deprecated_torch.utils import cuda_graph, profiling
from xsdeepfwfm_deprecated_tpu.models import deepfwfm as JD

SIZES = (1, 1, 7, 5, 9, 4)          # F=6, the first 2 numeric, 4 bags
BAGS = (1, 3, 5, 2)
B, LR = 16, 0.05
CFG = {"feature_sizes": SIZES, "numerical": 2, "bag_sizes": BAGS, "embedding_size": 8,
       "dense_arch_layers": (16, 8), "dcn_num_layers": 2, "dcn_low_rank_dim": 4,
       "over_arch_layers": (16, 8, 1), "learning_rate": LR}
FLAGS = ["-use_dlrm", "1", "-use_fwfm", "0", "-use_deep", "0", "-bag_sizes", "1,3,5,2",
         "-embedding_size", "8", "-dense_arch_layers", "16,8", "-dcn_num_layers", "2",
         "-dcn_low_rank_dim", "4", "-over_arch_layers", "16,8,1", "-numerical", "2",
         "-optimizer_type", "adag", "-l2", "0", "-learning_rate", str(LR),
         "-batch_size", str(B), "-n_epochs", "1"]


def _mcfg(**kw):
    return ModelConfig(field_size=len(SIZES), feature_sizes=SIZES, numerical=2, embedding_size=8,
                       use_fwfm=False, use_deep=False, use_dlrm=True, bag_sizes=BAGS,
                       dense_arch_layers=(16, 8), dcn_num_layers=2, dcn_low_rank_dim=4,
                       over_arch_layers=(16, 8, 1), **kw)


def _tcfg(**kw):
    return TrainConfig(**{"batch_size": B, "optimizer_type": "adag", "learning_rate": LR,
                          "weight_decay": 0.0, **kw})


def _params(seed=0):
    """The program's init, the table scaled up to N(0, 0.5²) and the cross
    biases drawn, so that the bags and every leaf move the logit."""
    params = dlrm.init_params(torch.Generator().manual_seed(seed), _mcfg(), device="cpu")
    params["bags"]["dense"].mul_(50.0)
    g = torch.Generator().manual_seed(seed + 100)
    for layer in params["cross"]["layers"]:
        layer["b"].copy_(0.1 * torch.randn(layer["b"].shape, generator=g))
    return params


def _weights(params):
    return {k: v.clone() for k, v in _tree.named_leaves(params)}


def _rows(n, seed=1):
    """Ids past each field's rows too (clipped to its last), repeats within a
    bag and across rows."""
    g = torch.Generator().manual_seed(seed)
    cols = [torch.randint(0, SIZES[2 + f] + 2, (n, 1), generator=g)
            for f, k in enumerate(BAGS) for _ in range(k)]
    xi = torch.cat(cols, dim=1)
    xi[:, 5] = xi[:, 4]                  # a repeat inside the third field's bag
    xi[1::2] = xi[0::2]                  # every odd row repeats the row before it
    xv = torch.randn((n, 2), generator=g)
    y = (torch.rand((n,), generator=g) < 0.3).float()
    return xi.to(torch.int32), xv, y


def _batch_of(xi, xv, y):
    return {"xi": xi, "xv": xv, "y": y, "mask": torch.ones(xi.shape[0])}


def _ref_batch(xi, xv, y):
    return {"rows": ref.packed_rows(CFG, xi), "xv": xv, "y": y}


def test_eval_logits_match_the_reference():
    params = _params()
    xi, xv, _ = _rows(B)
    got = dlrm.forward(params, xi, xv, _mcfg())
    want = ref.forward(_weights(params), CFG, ref.packed_rows(CFG, xi), xv)
    assert float(want.std()) > 0.1
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)
    # the bags are a share of the logit the comparison sees
    w_off = {**_weights(params), "bags/dense": torch.zeros_like(params["bags"]["dense"])}
    assert float((ref.forward(w_off, CFG, ref.packed_rows(CFG, xi), xv) - want).abs().max()) > 0.05


def _dense_table_grad(g: emb_ops.BagGrad, rows: int) -> torch.Tensor:
    """What a dense gradient of the table would be, from the bags' gradient."""
    b, fields, e = g.grad.shape
    per_id = g.grad[:, list(g.spec.column_field)].reshape(-1, e)
    return torch.zeros((rows, e)).index_add_(0, g.rows.reshape(-1), per_id)


def test_every_gradient_matches_the_reference():
    params = _params()
    xi, xv, y = _rows(B)
    loss, grads = trainer.loss_and_grads(params, _batch_of(xi, xv, y), _mcfg(), _tcfg())
    want_loss, want = ref.grads(_weights(params), CFG, _ref_batch(xi, xv, y), "fp32")
    assert float(loss) == pytest.approx(want_loss, rel=1e-6)
    names = [k for k, _ in _tree.named_leaves(params)]
    assert {"bags/dense", "cross/layers/1/v", "cross/layers/1/w", "cross/layers/1/b",
            "over_arch/layers/2/b", "dense_arch/layers/0/w"} <= set(names)
    for name, g in zip(names, grads):
        if name == "bags/dense":     # the bags' gradient and their ids, nothing the table's size
            assert isinstance(g, emb_ops.BagGrad) and g.grad.shape == (B, len(BAGS), 8)
            g = _dense_table_grad(g, sum(SIZES[2:]))
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=1e-4,
                                   atol=1e-6 * float(want[name].abs().max()), err_msg=name)
        assert float(want[name].abs().max()) > 0, name
    # outside a train step autograd reaches the table through embedding_bag's own backward
    live = _tree.tree_map(lambda t: t.detach().requires_grad_(True), params)
    ref.bce(dlrm.forward(live, xi, xv, _mcfg()), y).backward()
    np.testing.assert_allclose(live["bags"]["dense"].grad.numpy(), want["bags/dense"].numpy(),
                               rtol=1e-4, atol=1e-6 * float(want["bags/dense"].abs().max()))


def _steps(params, batches, tcfg=None):
    tcfg = tcfg or _tcfg()
    opt = trainer.make_optimizer(tcfg)
    state = opt.init(params)
    step = trainer.make_train_step(_mcfg(), tcfg, opt)
    return [float(step(params, state, _batch_of(*b))) for b in batches], state


def _batches(n_batches, seed=1):
    xi, xv, y = _rows(n_batches * B, seed)
    return [(xi[i * B:(i + 1) * B], xv[i * B:(i + 1) * B], y[i * B:(i + 1) * B])
            for i in range(n_batches)]


def _assert_matches_reference(params, w0, batches, losses):
    want = ref.steps(w0, CFG, [_ref_batch(*b) for b in batches])
    np.testing.assert_allclose(losses, want["losses"], rtol=1e-6)
    for name, p in _tree.named_leaves(params):
        # Adagrad's first step is about lr a value: a ten-thousandth of it covers the rounding
        np.testing.assert_allclose(float((p - w0[name]).double().norm()), want["change"][name],
                                   rtol=1e-4, err_msg=name)


def test_three_train_steps_match_the_references_dense_adagrad():
    params = _params()
    w0 = _weights(params)
    batches = _batches(3)
    losses, _ = _steps(params, batches)
    _assert_matches_reference(params, w0, batches, losses)
    # and each leaf as a whole, against the reference's own steps on a copy
    w = {k: v.clone() for k, v in w0.items()}
    acc = {}
    for b in batches:
        _, g = ref.grads(w, CFG, _ref_batch(*b), "fp32")
        ref.adagrad_(w, g, acc, LR)
    for name, p in _tree.named_leaves(params):
        np.testing.assert_allclose(p.numpy(), w[name].numpy(), rtol=0, atol=1e-6, err_msg=name)


def test_rows_no_batch_reads_stay_bit_unchanged_and_the_count_is_the_distinct_rows():
    params = _params()
    w0 = params["bags"]["dense"].clone()
    batches = _batches(3, seed=4)
    before = cuda_graph.device_counts().get("bag_rows_updated", 0)
    _, state = _steps(params, batches)
    read = [ref.packed_rows(CFG, b[0]) for b in batches]
    touched = torch.unique(torch.cat([r.reshape(-1) for r in read]))
    untouched = torch.ones(w0.shape[0], dtype=torch.bool)
    untouched[touched] = False
    assert 0 < int(untouched.sum()) < w0.shape[0]
    table, acc = params["bags"]["dense"], dict(_tree.named_leaves(state))
    acc = next(v for k, v in acc.items() if k.endswith("sum_of_squares/bags/dense"))
    assert torch.equal(table[untouched], w0[untouched])
    assert torch.equal(acc[untouched], torch.zeros_like(acc[untouched]))
    assert bool((table[touched] != w0[touched]).any(dim=1).all())
    after = cuda_graph.device_counts()["bag_rows_updated"]
    assert after - before == sum(int(torch.unique(r).numel()) for r in read)
    assert profiling.counters()["on_card"]["bag_rows_updated"] == after


def test_fit_from_the_flags_matches_the_reference():
    pars = get_parser().parse_args(FLAGS)
    mcfg, tcfg = configs_from_args(pars, len(SIZES), SIZES)
    # -use_lw keeps its default, 1, which weighs FM terms this model does not have
    assert mcfg == _mcfg(use_lw=True) and mcfg.model_name == "DLRM-DCNv2"
    assert tcfg.optimizer_type == "adag" and tcfg.weight_decay == 0.0
    est = get_model(len(SIZES), SIZES, pars=pars, device="cpu")
    assert isinstance(est, trainer.DLRMEstimator)
    est.params = _params(seed=2)
    w0 = _weights(est.params)
    batches = _batches(2, seed=6)
    xi = torch.cat([b[0] for b in batches])
    xv, y = torch.cat([b[1] for b in batches]), torch.cat([b[2] for b in batches])
    est.fit(xi.numpy(), xv.numpy(), y.numpy())      # the first epoch keeps row order
    _assert_matches_reference(est.params, w0, batches, est.last_epoch_losses)
    logits = est._predict_logits(xi.numpy(), xv.numpy())
    np.testing.assert_allclose(logits, dlrm.forward(est.params, xi, xv, mcfg).numpy(),
                               rtol=1e-6, atol=1e-7)


def test_fp32_predictor_matches_the_reference():
    params = _params()
    xi, xv, _ = _rows(3 * B, seed=5)
    got = Predictor(params, _mcfg(), device="cpu").logits(xi.numpy(), xv.numpy())
    want = ref.forward(_weights(params), CFG, ref.packed_rows(CFG, xi), xv).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    passed = Predictor(params, _mcfg(), device="cpu", forward_fn=dlrm.forward)
    np.testing.assert_allclose(passed.logits(xi.numpy(), xv.numpy()), got, rtol=0, atol=0)


def test_npz_checkpoint_round_trip_keeps_every_leaf(tmp_path):
    est = trainer.DLRMEstimator(_mcfg(), _tcfg(), device="cpu")
    est.params = _params(seed=3)
    path = str(tmp_path / "dlrm")
    est.save(path)
    back = trainer.DLRMEstimator(_mcfg(), _tcfg(), device="cpu").load(path)
    got, want = dict(_tree.named_leaves(back.params)), dict(_tree.named_leaves(est.params))
    assert set(got) == set(want) and "bags/dense" in got and "cross/layers/1/v" in got
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_the_spans_are_the_bags_and_the_cross_network_with_a_child_a_layer():
    params = _params()
    tcfg = _tcfg()
    opt = trainer.make_optimizer(tcfg)
    state = opt.init(params)
    step = trainer.make_train_step(_mcfg(), tcfg, opt)
    profiling.spans()
    with profiling.tracing():
        step(params, state, _batch_of(*_batches(1)[0]))
        spans = profiling.spans()
    by = {s.name: s for s in spans}
    assert {profiling.SCOPE_BAGS_LOOKUP, profiling.SCOPE_BAGS_UPDATE, profiling.SCOPE_DCN} <= set(by)
    assert by[profiling.SCOPE_BAGS_LOOKUP].parent_id == by["step.forward"].span_id
    assert by[profiling.SCOPE_BAGS_UPDATE].parent_id == by["step.optimizer"].span_id
    layers = sorted((s for s in spans if s.name.startswith("DCN - Layer")), key=lambda s: s.name)
    assert [s.name for s in layers] == ["DCN - Layer 1", "DCN - Layer 2"]
    assert all(s.parent_id == by[profiling.SCOPE_DCN].span_id for s in layers)


def test_a_warm_up_takes_the_bags_state_as_one_row():
    params = _params()
    state = trainer.make_optimizer(_tcfg()).init(params)
    clones = cuda_graph._warmup_state((params, state, None), dlrm.is_bag_state)
    named = dict(_tree.named_leaves(clones))
    for name, leaf in _tree.named_leaves((params, state, None)):
        want = leaf[:1] if "bags" in name.split("/") else leaf
        assert torch.equal(named[name], want) and named[name].data_ptr() != leaf.data_ptr(), name
    assert {n for n in named if "bags" in n.split("/")} == {"0/bags/dense",
                                                           "1/0/sum_of_squares/bags/dense"}


@pytest.mark.parametrize("kw, match", [
    (dict(use_fwfm=True), "use_dlrm"), (dict(use_deep=True), "use_dlrm"),
    (dict(use_cin=True, cin_layers=(4,)), "use_dlrm"), (dict(quantization_aware=True), "use_dlrm"),
    (dict(bag_sizes=(1, 3, 5)), "bag size"), (dict(dense_arch_layers=(16, 4)), "dense arch"),
    (dict(over_arch_layers=(16, 2)), "over arch"), (dict(dcn_num_layers=0), "dcn_num_layers")])
def test_the_config_refuses_what_makes_no_sense(kw, match):
    base = dict(field_size=len(SIZES), feature_sizes=SIZES, numerical=2, embedding_size=8,
                use_fwfm=False, use_deep=False, use_dlrm=True, bag_sizes=BAGS,
                dense_arch_layers=(16, 8), dcn_num_layers=2, dcn_low_rank_dim=4,
                over_arch_layers=(16, 8, 1))
    with pytest.raises(ValueError, match=match):
        ModelConfig(**{**base, **kw})
    with pytest.raises(ValueError, match="without use_dlrm"):
        ModelConfig(field_size=len(SIZES), feature_sizes=SIZES, bag_sizes=BAGS)


# ---------------------------------------------------- the paths without bags

@pytest.mark.parametrize("path", ["int8_dynamic", "int8_static", "qat", "compaction",
                                  "prune_fit", "prune_refresh", "sharded_fit", "adam_fit",
                                  "deepfwfm_estimator"])
def test_the_paths_without_bags_refuse_the_model(path):
    xi, xv, y = _rows(2 * B)
    fit = (xi.numpy(), xv.numpy(), y.numpy())
    with pytest.raises(ValueError, match="use_dlrm|DLRM"):
        if path.startswith("int8"):
            convert(_params(), _mcfg(), path.split("_")[1])
        elif path == "qat":
            get_model(len(SIZES), SIZES, pars=get_parser().parse_args(FLAGS),
                      quantization_aware=True, device="cpu")
        elif path == "compaction":
            compact_for_serving(_params(), _mcfg())
        elif path == "prune_fit":
            trainer.DLRMEstimator(_mcfg(), _tcfg(prune=True), device="cpu").fit(*fit)
        elif path == "prune_refresh":
            trainer.PruneRefresh(dict(emb_r=1.0, emb_corr=1.0, prune_fm=True, prune_deep=True,
                                      prune_r=False, structured_deep=False))(_params(), 0.5)
        elif path == "sharded_fit":     # its bags shard over -mesh_data alone
            trainer.DLRMEstimator(_mcfg(), _tcfg(mesh_data=2, mesh_model=2),
                                  device="cpu").fit(*fit)
        elif path == "adam_fit":
            trainer.DLRMEstimator(_mcfg(), _tcfg(optimizer_type="adam"), device="cpu").fit(*fit)
        else:
            trainer.DeepFMEstimator(_mcfg(), _tcfg(), device="cpu")


def test_the_flagship_tree_and_logits_are_unchanged():
    jcfg, tcfg = _cfgs(use_fwfm=True, use_deep=True, use_lw=True, use_fwlw=True)
    assert not tcfg.use_dlrm and tcfg.bag_sizes == () and tcfg.index_columns == 3
    params = JD.init_params(jax.random.PRNGKey(0), jcfg)
    xi, xv = _batch(F_SIZES, NUM, 8, seed=1)
    got = deepfwfm.forward(_port(params), torch.from_numpy(xi), torch.from_numpy(xv), tcfg)
    np.testing.assert_allclose(got.numpy(), _j_logits(params, xi, xv, jcfg), rtol=1e-5, atol=1e-5)
    tree = deepfwfm.init_params(None, tcfg, device="meta")
    assert [k for k, _ in _tree.named_leaves(tree)] == [
        "bias", "emb2/dense", "lw_w", "fwlw_w", "field_cov", "deep/net_1/layers/0/w",
        "deep/net_1/layers/0/b", "deep/net_1/layers/1/w", "deep/net_1/layers/1/b",
        "deep/net_1/fc_w"]
    # the flagship's train step hands the optimizer dense gradients only
    t_params = _port(params)
    _, grads = trainer.loss_and_grads(
        t_params, {"xi": torch.from_numpy(xi), "xv": torch.from_numpy(xv),
                   "y": torch.zeros(8), "mask": torch.ones(8)}, tcfg, TrainConfig())
    assert all(isinstance(g, torch.Tensor) for g in grads)
