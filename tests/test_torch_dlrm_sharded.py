"""DLRM-DCNv2 sharded over four ranks (``parallel/bag_sharding.py``), on the CPU.

Four ranks run over gloo, started once for the module by
``parallel.launch.run_ranks``; each runs every case of
``torch_dlrm_sharded_ranks.py`` (torch and the port only) and returns its
results through a file. The test process holds them to the uncut lookup, to
the one-process program's steps on the global batch and to the plain
reference of ``dlrm_dcnv2_reference.py``: a row-wise table's partial pools,
three steps through ``make_train_step`` on the mesh (the losses, every leaf
gathered, the optimizer state), each rank's count of rows updated, the whole
tables equal to the bit on every rank, the collectives and their bytes, the
exchanges' spans, ``DLRMEstimator.fit`` at ``-mesh_data 4`` and ``unshard``.

Tolerances: the sharded step sums the same float32 terms as the one-process
step in other orders (a row-wise bag as the sum of its blocks' parts, a dense
gradient as the sum of the ranks' parts), so the losses part by a few units in
the last place (rtol 1e-6). A gradient's sum rounds differently by a few ulps
of its largest terms (about 1e-9 here), and Adagrad divides it by its own size
with eps 1e-10 inside the root: where a value's gradient nearly cancels over
the batch (|g| near sqrt(eps) = 1e-5) its step, of order lr = 0.05, moves by
lr·1e-9/1e-5 = 5e-6, so the parameters, of order 1, are held to atol 1e-5, and
each leaf's change to the reference's at rtol 1e-4 as ``test_torch_dlrm.py``
holds the one-process steps. A partial pool's sum against the uncut bag: rtol
1e-6. The whole tables on every rank: equal to the bit.
"""

import numpy as np
import pytest
import torch

import dlrm_dcnv2_reference as ref
import torch_dlrm_sharded_ranks as R
from xsdeepfwfm_deprecated_torch import _tree
from xsdeepfwfm_deprecated_torch.config import ModelConfig, TrainConfig
from xsdeepfwfm_deprecated_torch.models import dlrm
from xsdeepfwfm_deprecated_torch.ops import embedding as emb_ops
from xsdeepfwfm_deprecated_torch.parallel.launch import run_ranks
from xsdeepfwfm_deprecated_torch.train import trainer
from xsdeepfwfm_deprecated_torch.utils import profiling

ATOL = 1e-5


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    work = tmp_path_factory.mktemp("dlrm_sharded")
    return run_ranks(R.rank_cases, R.WORLD, backend="gloo", devices=["cpu"] * R.WORLD,
                     workdir=str(work), timeout_s=300.0)


@pytest.fixture(scope="module")
def one():
    return R.one_device_steps()


def _named(tree):
    return {k: v for k, v in _tree.named_leaves(tree)}


def test_the_placement_cuts_the_large_tables_and_keeps_the_small_whole(ranks):
    row_wise, blocks, offsets, rows, whole = ranks[0]["placement"]
    assert row_wise == (False, True, False, True)
    assert blocks == (7, 13, 9, 11) and whole == 16
    assert offsets == (0, 16, 7, 29) and rows == 7 + 13 + 9 + 11 + 1
    assert all(r["placement"] == ranks[0]["placement"] for r in ranks)


def test_a_row_wise_tables_four_partial_pools_add_up_to_the_uncut_lookup(ranks):
    xi = R.batches(1)[0][0]
    spec = dlrm.make_bag_spec(R.mcfg())
    uncut = emb_ops.bag_lookup(R.params()["bags"]["dense"], spec, xi)[:, [1, 3]]
    parts = [r["partial_pools"] for r in ranks]
    assert all(float(p.abs().sum()) > 0 for p in parts)
    np.testing.assert_allclose(sum(parts).numpy(), uncut.numpy(), rtol=1e-6,
                               atol=1e-6 * float(uncut.abs().max()))
    # each id of a row-wise column is held by one rank, each id of a whole one by all
    sink = ranks[0]["placement"][3] - 1
    held = torch.stack([r["held_rows"] != sink for r in ranks])
    col = torch.tensor(spec.column_field)
    row_wise = (col == 1) | (col == 3)
    assert bool((held.sum(0)[:, row_wise] == 1).all())
    assert bool(held[:, :, ~row_wise].all())
    # a row of the whole packed table finds the same row of a rank's table
    assert all(r["packed_rows_agree"] for r in ranks)


def test_three_sharded_steps_equal_the_one_process_steps_and_the_reference(ranks, one):
    losses = np.sum([r["losses"] for r in ranks], axis=0)      # each rank's share of the mean
    np.testing.assert_allclose(losses, one["losses"], rtol=1e-6)
    want = ref.steps({k: v.clone() for k, v in _named(R.params()).items()}, R.CFG,
                     [{"rows": ref.packed_rows(R.CFG, xi), "xv": xv, "y": y}
                      for xi, xv, y in R.batches()])
    np.testing.assert_allclose(losses, want["losses"], rtol=1e-6)
    w0 = _named(R.params())
    prog = _named(one["params"])
    for r in ranks:
        got = _named(r["gathered"])
        assert set(got) == set(prog)
        for name in prog:
            assert float((got[name] - w0[name]).abs().max()) > 0, name
            np.testing.assert_allclose(got[name].numpy(), prog[name].numpy(), rtol=0, atol=ATOL,
                                       err_msg=name)
            np.testing.assert_allclose(float((got[name] - w0[name]).double().norm()),
                                       want["change"][name], rtol=1e-4, err_msg=name)
        state, want_state = _named(r["gathered_state"]), _named(one["state"])
        for name in want_state:
            np.testing.assert_allclose(state[name].numpy(), want_state[name].numpy(), rtol=1e-5,
                                       atol=1e-9, err_msg=name)


def test_each_ranks_count_of_updated_rows_is_its_distinct_held_rows(ranks, one):
    for rank, r in enumerate(ranks):
        assert r["rows_updated"] == R.owned_distinct(rank) > 0
    # the blocks' rows are each counted once over the ranks, the whole tables' on every rank
    assert one["rows_updated"] < sum(r["rows_updated"] for r in ranks)


def test_the_whole_tables_stay_equal_to_the_bit_on_every_rank(ranks):
    whole = ranks[0]["placement"][4]
    first = ranks[0]["table"]
    assert bool((first[:whole] != R.params()["bags"]["dense"][:whole]).any())
    for r in ranks[1:]:
        assert torch.equal(r["table"][:whole], first[:whole])
    assert all(float(r["table"][-1].abs().max()) == 0.0 for r in ranks)    # the sink stays 0
    for r in ranks[1:]:
        for (k, a), (_, b) in zip(_tree.named_leaves(r["gathered"]),
                                  _tree.named_leaves(ranks[0]["gathered"])):
            assert torch.equal(a, b), k


def test_the_collectives_and_their_bytes(ranks, one):
    # one device: no collective, no byte, no launch on the CPU
    assert one["exchange_bytes"] == 0
    assert all(n == 0 for n in profiling.counters()["launches"].values())
    e, f, cols = 8, len(R.BAGS), sum(R.BAGS)
    dense = sum(v.numel() for k, v in _named(R.params()).items() if k != "bags/dense") * 4
    step = [("all-gather", "world", 4, R.GLOBAL * cols * 4),
            ("reduce-scatter", "world", 4, R.GLOBAL * 2 * e * 4),
            ("all-gather", "world", 4, R.GLOBAL * f * e * 4),
            ("all-reduce", "world", 4, dense)]
    for r in ranks:
        assert r["traffic"] == step * R.STEPS
        sent = sum(n * 3 // 4 * (2 if kind == "all-reduce" else 1) for kind, _, _, n in step)
        assert r["exchange_bytes"] == R.STEPS * sent


def test_the_exchanges_have_spans_of_their_own(ranks):
    spans = ranks[0]["spans"]
    by = {name: (sid, parent) for name, sid, parent in spans}
    for name in (profiling.SCOPE_BAGS_IDS_EXCHANGE, profiling.SCOPE_BAGS_LOOKUP,
                 profiling.SCOPE_BAGS_POOL_EXCHANGE):
        assert by[name][1] == by["step.forward"][0], name
    assert by[profiling.SCOPE_BAGS_GRAD_EXCHANGE][1] == by["step.backward"][0]
    assert by[profiling.SCOPE_BAGS_UPDATE][1] == by["step.optimizer"][0]
    assert by[profiling.SCOPE_DENSE_ALL_REDUCE][1] == by["train.step"][0]
    assert sum(name == profiling.SCOPE_BAGS_LOOKUP for name, _, _ in spans) == 1


def test_a_sharded_fit_trains_the_one_device_model(ranks):
    est = trainer.DLRMEstimator(R.mcfg(), R.tcfg(n_epochs=1, eval_batch_size=32),
                                logger=R.QUIET, device="cpu")
    est.params = R.params(seed=2)
    xi, xv, y = (torch.cat(t) for t in zip(*R.batches(2, seed=6)))
    est.fit(xi.numpy(), xv.numpy(), y.numpy())
    for r in ranks:
        np.testing.assert_allclose(r["fit_losses"], est.last_epoch_losses, rtol=1e-6)
        np.testing.assert_allclose(r["fit_logits"], est._predict_logits(xi.numpy(), xv.numpy()),
                                   rtol=1e-5, atol=1e-6)
        got = _named(r["fit_params"])
        for name, want in _named(est.params).items():
            np.testing.assert_allclose(got[name].numpy(), want.numpy(), rtol=0, atol=ATOL,
                                       err_msg=name)
        assert r["fit_blocks_left"]


def test_unshard_refuses_where_the_whole_tables_do_not_fit(ranks):
    msg = ranks[0]["unshard_refused"]
    assert "do not fit" in msg and f"{sum(R.SIZES[2:]):,} rows" in msg and "GB" in msg


def test_a_sharded_fit_still_refuses_the_cin_and_a_model_axis():
    xi, xv, y = R.batches(1)[0]
    cin = ModelConfig(field_size=len(R.SIZES), feature_sizes=R.SIZES, numerical=2,
                      embedding_size=4, use_fwfm=False, use_deep=True, use_cin=True,
                      cin_layers=(5, 3), h_depth=2, deep_nodes=8)
    with pytest.raises(ValueError, match="use_cin"):
        trainer.DeepFMEstimator(cin, TrainConfig(batch_size=R.GLOBAL, mesh_data=4),
                                logger=R.QUIET, device="cpu").fit(
            xi[:, :4].numpy(), xv.numpy(), y.numpy())
    with pytest.raises(ValueError, match="-mesh_model 1"):
        trainer.DLRMEstimator(R.mcfg(), R.tcfg(mesh_data=2, mesh_model=2), logger=R.QUIET,
                              device="cpu").fit(xi.numpy(), xv.numpy(), y.numpy())
