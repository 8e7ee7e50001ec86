"""The K-step dispatch and the scanned eval of a sharded ``fit``, on the CPU.

Four ranks on a (2 data, 2 model) mesh run over gloo, started once for the
module by ``parallel.launch.run_ranks``; each runs every case of
``torch_mesh_multi_step_ranks.py`` (torch and the port only) and returns its
results through a file. Over gloo a group of K steps runs eagerly, through
the same ``MultiStep`` code as a replay over NCCL, so the CPU holds the
grouping, the refresh's place, the loss bookkeeping, the global group's
``k_real`` and counts, and ``Mesh.traffic``; the capture itself runs on the
card (``chip_smoke.py`` phase 17 on four cards).

Tolerances: ``steps_per_call=K`` against ``steps_per_call=1`` on the same
mesh runs the same operations in the same order, so losses, parameters,
metrics, sparsity and traffic are equal to the bit (the bound stated for
them is ``STEP_TOL``, rtol 1e-4 and atol 2e-5; equality is what holds). The
JAX package's mesh ``fit`` at ``steps_per_call=K``, dropout off: rtol 2e-4,
atol 2e-5 as ``tests/test_sharding.py::test_fit_mesh_multi_step_dispatch``,
with ``field_cov``'s diagonal at atol 1e-3 (ROADMAP.md section 3).
"""

import dataclasses
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_multi_step_ranks as R
from test_torch_train import assert_trees_close
from xsdeepfwfm_deprecated_torch import _tree
from xsdeepfwfm_deprecated_torch.parallel.launch import run_ranks
from xsdeepfwfm_deprecated_tpu.config import ModelConfig as JConfig
from xsdeepfwfm_deprecated_tpu.config import TrainConfig as JTrain
from xsdeepfwfm_deprecated_tpu.models import deepfwfm as JD
from xsdeepfwfm_deprecated_tpu.parallel import mesh as j_mesh
from xsdeepfwfm_deprecated_tpu.train import trainer as JT

QUIET = logging.getLogger("test_torch_mesh_multi_step")
QUIET.addHandler(logging.NullHandler())
QUIET.propagate = False
N_GROUPS = -(-R.N // (R.K * R.B))          # groups of K batches an epoch: 4, 4 and 2


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    work = tmp_path_factory.mktemp("mesh_multi_step")
    return run_ranks(R.rank_cases, R.WORLD, backend="gloo", devices=["cpu"] * R.WORLD,
                     workdir=str(work), args=(str(work),), timeout_s=300.0)


def _same_fits(ranks, name):
    """The fit at steps_per_call=K equals the fit at 1 on every rank: every
    step's loss, the sparsity, the train metrics, the collectives of the whole
    fit and (rank 0) the gathered parameters, to the bit."""
    for res in ranks:
        grouped, single = res[(name, R.K)], res[(name, 1)]
        assert grouped["step"] == single["step"] == 2 * 10
        assert grouped["losses"] == single["losses"] and len(grouped["losses"]) == 10
        assert grouped["sparsity"] == single["sparsity"]
        np.testing.assert_array_equal(grouped["metrics"], single["metrics"])
        assert grouped["traffic"] == single["traffic"]
    grouped, single = ranks[0][(name, R.K)], ranks[0][(name, 1)]
    assert set(grouped["params"]) == set(single["params"])
    for leaf, w in single["params"].items():
        np.testing.assert_array_equal(grouped["params"][leaf], w, err_msg=leaf)
    return grouped, single


@pytest.mark.parametrize("exchange", R.EXCHANGES)
def test_grouped_fit_equals_per_batch_fit(ranks, exchange):
    """(a) Each exchange, dropout on, two epochs of 10 global batches in
    groups of 4, 4 and 2 (the last with padding steps; the last batch's 6
    real rows on one rank of the batch's ranks): ``fit`` at
    ``steps_per_call=4`` equals the port's own mesh ``fit`` at 1, and its
    mesh line says the groups run eagerly over gloo."""
    grouped, single = _same_fits(ranks, exchange)
    assert grouped["lines"] == [line + f", {R.K} steps eager a group (gloo collectives cannot "
                                "be captured)" for line in single["lines"]]
    assert all("backend gloo" in line for line in grouped["lines"])


def test_grouped_pruned_fit_equals_per_batch_fit(ranks):
    """(b) DeepLight pruning on a2a_grid, dropout off: K is
    ``prune_interval`` and each group ends in the sharded refresh; the
    sparsity trajectory equals the per-batch fit's (within two parameters is
    the bound), and it prunes."""
    grouped, single = _same_fits(ranks, "pruned")
    total = sum(v.size for v in single["params"].values())
    for a, b in zip(grouped["sparsity"], single["sparsity"]):
        assert abs(a - b) * total / 100.0 <= 2
    assert single["sparsity"][-1] > 0.0


@pytest.mark.parametrize("kind", ["kd", "qat"])
def test_grouped_kd_and_qat_fits_equal_per_batch_fits(ranks, kind):
    """(c) KD under a2a_grid (the teacher's logits stacked into the same
    groups) and QAT under psum (the tower's scales over the batch's ranks),
    dropout off, at ``steps_per_call=4`` against 1."""
    _same_fits(ranks, kind)


def test_grouped_mesh_fit_matches_jax_mesh_fit(ranks):
    """(d) The a2a exchange at ``steps_per_call=4``, dropout off, against the
    JAX package's ``fit`` on a 2x2 mesh of the virtual CPU devices at the same
    ``steps_per_call`` from the same parameters: the gathered parameters and
    the train metrics."""
    cfg, params, xi, xv, y = R.case(dropout=False)
    est = JT.DeepFMEstimator(JConfig(**{f.name: getattr(cfg, f.name)
                                        for f in dataclasses.fields(JConfig)}),
                             JTrain(**R.FIT_KW, mesh_data=2, mesh_model=2, exchange=R.JAX_EXCHANGE,
                                    steps_per_call=R.K, table_layout="flat"), logger=QUIET)
    est.params = _tree.tree_map(lambda t: jnp.asarray(t.numpy()), params)
    est.fit(xi, xv, y)
    assert est.mesh is not None and est.mesh.devices.size == 4
    got = ranks[0][("jax", R.K)]
    want = j_mesh.unpad_rows(est.params, JD.make_embedding_spec(est.mcfg).dense_rows)
    assert_trees_close(_tree.rebuild(want, {n: torch.from_numpy(v)
                                            for n, v in got["params"].items()}),
                       want, rtol=2e-4, atol=2e-5, field_cov_diag_atol=1e-3)
    np.testing.assert_allclose(got["metrics"], est.train_result, rtol=2e-4, atol=2e-5)


def test_scanned_eval_on_the_mesh_equals_per_batch(ranks):
    """(e) ``_predict_logits`` on the mesh at batch 64: a scanned group of 8
    batches (each rank's rows, the logits gathered inside) and two batches
    after it, against every batch per batch: equal, on every rank, and every
    rank returns every row's logit."""
    for res in ranks:
        got = res["eval"]
        assert got["scanned"].shape == (R.N,)
        np.testing.assert_array_equal(got["scanned"], got["per_batch"])
        np.testing.assert_array_equal(got["scanned"], ranks[0]["eval"]["scanned"])


@pytest.mark.parametrize("exchange", R.EXCHANGES)
def test_group_traffic_is_k_steps_traffic(ranks, exchange):
    """(f) ``Mesh.traffic`` of one group of 4 full steps through the
    multi-step equals 4 times a per-batch step's, entry for entry, on every
    rank; a sharded multi-step without the global group's ``k_real`` and
    counts is refused."""
    for res in ranks:
        got = res["traffic"][exchange]
        assert got["step"] and got["group"] == got["step"] * R.K
        assert "k_real and count_k" in got["refused"]
