"""The port's sharded training against the JAX package, on the CPU.

Eight ranks run over gloo, started once for the module by
``parallel.launch.run_ranks`` (spawn, one thread each, joined through a file
under ``tmp_path``); each runs every case of ``torch_sharding_ranks.py``,
which imports torch and the port only, and returns its results through a
file. The JAX reference is computed here, on conftest's 8-device virtual CPU
mesh, from the same seeded inputs and the port's own initial parameters.

Tolerances: the lookups as ``tests/test_sharding.py`` holds JAX's sharded
lookups to the dense one (values rtol 1e-6, gradients rtol 1e-5, atol 1e-6);
a train step as ``test_full_sharded_train_step`` (loss rel 1e-5, tables rtol
1e-4, atol 1e-6); a fit as ``test_fit_mesh_matches_single_device`` (rtol
2e-4, atol 2e-5), with dropout on against the port's one-device fit and off
against JAX's sharded fit, whose random bits differ from torch's.

Distillation and QAT on the mesh (the softmax and the activation scale over
the global batch): a step's loss and gradients as ``test_torch_kd_qat.py``
holds ``kd_loss`` to JAX's (loss rtol 1e-5, gradients rtol 1e-4, atol
1e-7), every QAT scale equal to the one-device port's to the bit; a fit as
``test_kd_fit_matches_jax_fit`` (rtol 1e-4, atol 2e-5, ``field_cov``'s
diagonal 1e-3); the command-line programs under ``torch.distributed.run``
within the CLI tests' 1e-4.
"""

import dataclasses
import glob
import logging
import os
import pickle
import subprocess
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_sharding_ranks as R
from test_torch_train import assert_trees_close
from xsdeepfwfm_deprecated_torch import _tree
from xsdeepfwfm_deprecated_torch.config import TrainConfig as TTrain
from xsdeepfwfm_deprecated_torch.entry import dryrun_multichip, flagship_config
from xsdeepfwfm_deprecated_torch.models import deepfwfm as TD
from xsdeepfwfm_deprecated_torch.parallel.launch import run_ranks
from xsdeepfwfm_deprecated_torch.train import trainer as TT
from xsdeepfwfm_deprecated_tpu.compression import distillation as JKD
from xsdeepfwfm_deprecated_tpu.config import ModelConfig as JConfig
from xsdeepfwfm_deprecated_tpu.config import TrainConfig as JTrain
from xsdeepfwfm_deprecated_tpu.models import deepfwfm as JD
from xsdeepfwfm_deprecated_tpu.ops import embedding as j_emb
from xsdeepfwfm_deprecated_tpu.parallel import embedding_sharding as j_es
from xsdeepfwfm_deprecated_tpu.parallel import mesh as j_mesh
from xsdeepfwfm_deprecated_tpu.train import checkpoint as jckpt
from xsdeepfwfm_deprecated_tpu.train import trainer as JT

FIT_TOL = dict(rtol=2e-4, atol=2e-5)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUIET = logging.getLogger("test_torch_sharding")
QUIET.addHandler(logging.NullHandler())
QUIET.propagate = False


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    work = tmp_path_factory.mktemp("ranks")
    return run_ranks(R.rank_cases, R.WORLD, backend="gloo", devices=["cpu"] * R.WORLD,
                     workdir=str(work), args=(str(work),), timeout_s=300.0)


def _jax(tree):
    return jax.tree.map(lambda t: jnp.asarray(t.detach().numpy()), tree)


def _jcfg(cfg):
    # the JAX package's fields: the port's own (xDeepFM's) hold their defaults here
    return JConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(JConfig)})


def _assemble(results, key, field, n_rows):
    """The global (B, ...) array of ``field`` from every rank's rows; ranks
    that hold the same rows (psum's model ranks) must agree."""
    out = None
    for res in results:
        case = res["lookups"][key]
        lo, hi = case["rows"]
        if out is None:
            out = np.full((n_rows,) + case[field].shape[1:], np.nan, np.float32)
        elif not np.isnan(out[lo]).any():
            np.testing.assert_array_equal(case[field], out[lo:hi])
        out[lo:hi] = case[field]
    assert not np.isnan(out).any()
    return out


def _table_grad(results, key):
    blocks = {}
    for res in results:
        case = res["lookups"][key]
        blocks.setdefault(case["block"], case["grads"]["dense"])
    return np.concatenate([blocks[i] for i in sorted(blocks)])


# ------------------------------------------------------------------ lookups

LOOKUP_IDS = [f"{d}x{m}-{ex}" for d, m in R.MESHES for ex in R.EXCHANGES]


@pytest.mark.parametrize("key", [(d, m, ex) for d, m in R.MESHES for ex in R.EXCHANGES],
                         ids=LOOKUP_IDS)
def test_lookup_and_gradient_match_jax(ranks, key):
    """Each exchange's lookup and the gradient of sum(out²) on (4,2), (2,4)
    and (8,1), a QR field beside the dense ones, against JAX's packed_lookup
    and JAX's own sharded lookup of the same exchange on the same mesh."""
    data, model, exchange = key
    spec_t, tables_t, xi, xv = R.lookup_case()
    spec = j_emb.make_spec(R.QR_SIZES, R.NUM, qr_flag=True, qr_collisions=4, qr_threshold=200)
    tables = _jax(tables_t)
    got = _assemble(ranks, key, "out", R.B)
    got_grad = _table_grad(ranks, key)[:spec.dense_rows]

    def loss_dense(t):
        return jnp.sum(j_emb.packed_lookup(t, spec, jnp.asarray(xi), jnp.asarray(xv)) ** 2)

    want = np.asarray(j_emb.packed_lookup(tables, spec, jnp.asarray(xi), jnp.asarray(xv)))
    want_grad = jax.grad(loss_dense)(tables)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(got_grad, np.asarray(want_grad["dense"]), rtol=1e-5, atol=1e-6)
    for k in ("q", "r"):
        np.testing.assert_allclose(ranks[0]["lookups"][key]["grads"][k], np.asarray(want_grad[k]),
                                   rtol=1e-5, atol=1e-6)

    mesh = j_mesh.make_mesh(data=data, model=model)
    axes = j_es.GRID_AXES if exchange == "a2a_grid" else "model"
    batch = NamedSharding(mesh, P(j_mesh.batch_axes(exchange != "psum"), None))
    lookup = {"a2a_grid": j_es.make_grid_lookup, "a2a": j_es.make_a2a_lookup,
              "psum": j_es.make_sharded_lookup}[exchange](mesh, spec)
    sharded = {"dense": jax.device_put(tables["dense"], NamedSharding(mesh, P(axes, None))),
               "q": jax.device_put(tables["q"], NamedSharding(mesh, P())),
               "r": jax.device_put(tables["r"], NamedSharding(mesh, P()))}
    xi_s, xv_s = jax.device_put(jnp.asarray(xi), batch), jax.device_put(jnp.asarray(xv), batch)

    def loss_sharded(t):
        return jnp.sum(lookup(t, spec, xi_s, xv_s) ** 2)

    np.testing.assert_allclose(got, np.asarray(jax.jit(lambda t: lookup(t, spec, xi_s, xv_s))(
        sharded)), rtol=1e-6)
    np.testing.assert_allclose(got_grad, np.asarray(jax.jit(jax.grad(loss_sharded))(sharded)
                                                    ["dense"]), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("exchange", R.EXCHANGES)
def test_index_past_its_field_reads_the_fields_last_row(ranks, exchange):
    """The exchanges clip an index to its field and then to the real rows, as
    the unsharded lookup does, so no index reaches the next field or a pad
    row (JAX's sharded lookups clip only to the padded table: ROADMAP.md
    section 3)."""
    from xsdeepfwfm_deprecated_torch.ops import embedding as t_emb
    spec, tables, xi, xv = R.lookup_case()
    sizes = np.asarray(R.QR_SIZES[R.NUM:], np.int32)
    last = np.ascontiguousarray(np.broadcast_to(sizes - 1, xi.shape))
    want = t_emb.packed_lookup(tables, spec, torch.from_numpy(last), torch.from_numpy(xv)).numpy()
    np.testing.assert_array_equal(_assemble(ranks, ("past", exchange), "out", R.B), want)


# --------------------------------------------------------------- train step

def _jax_sharded_step(exchange):
    cfg_t, params_t, batch = R.step_case()
    cfg = _jcfg(cfg_t)
    mesh = j_mesh.make_mesh(data=4, model=2)
    n_shards = mesh.devices.size if exchange == "a2a_grid" else mesh.shape["model"]
    table_axes = j_es.GRID_AXES if exchange == "a2a_grid" else "model"
    params = j_mesh.pad_rows_for_mesh(_jax(params_t), mesh, n_shards)
    params = jax.device_put(params, j_mesh.param_shardings(params, mesh, table_axes))
    opt = optax.adam(1e-3)
    spec = JD.make_embedding_spec(cfg)
    lookup = {"a2a": j_es.make_a2a_lookup, "psum": j_es.make_sharded_lookup,
              "a2a_grid": j_es.make_grid_lookup}[exchange](mesh, spec)
    axes = j_mesh.batch_axes(exchange != "psum")
    s2, s1 = NamedSharding(mesh, P(axes, None)), NamedSharding(mesh, P(axes))
    xi, xv, y = (jax.device_put(jnp.asarray(batch[k]), s) for k, s in
                 (("xi", s2), ("xv", s2), ("y", s1)))

    @jax.jit
    def step(p, o, a, b, t):
        def loss_fn(p):
            logits = JD.forward(p, a, b, cfg, lookup_fn=lookup)
            return jnp.mean(optax.sigmoid_binary_cross_entropy(logits, t))
        loss, grads = jax.value_and_grad(loss_fn)(p)
        updates, o = opt.update(grads, o, p)
        return optax.apply_updates(p, updates), o, loss

    p2, _, loss = step(params, opt.init(params), xi, xv, y)
    return float(loss), jckpt._flatten(j_mesh.unpad_rows(p2, spec.dense_rows))


@pytest.mark.parametrize("exchange", R.EXCHANGES)
def test_train_step_matches_jax_sharded_step(ranks, exchange):
    """One Adam step on the (4 data, 2 model) mesh, dropout off, against JAX's
    sharded step of the same exchange: the global loss within 1e-5 relative,
    the tables within rtol 1e-4, atol 1e-6 (``test_full_sharded_train_step``),
    every other leaf too, but the diagonal of ``field_cov``, whose gradient is
    rounding noise that Adam's first step turns into up to lr (ROADMAP.md
    section 3)."""
    got = ranks[0]["steps"][exchange]
    loss, want = _jax_sharded_step(exchange)
    assert got["loss"] == pytest.approx(loss, rel=1e-5)
    assert set(got["params"]) == set(want)
    for name, w in want.items():
        g = got["params"][name]
        if name == "field_cov":
            off = ~np.eye(g.shape[0], dtype=bool)
            g, w = g[off], w[off]
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("exchange", R.EXCHANGES)
def test_collective_bytes_match_the_analytic_model(ranks, exchange):
    """The bytes of every collective of one train step, as
    ``tests/test_sharding.py::test_compiled_collective_bytes`` asserts them of
    JAX's compiled step on the (4 data, 2 model) mesh: the exchange's
    all-to-alls (forward and backward, a table each), its index all-gather,
    the gradient all-reduce of the replicated leaves, and the table-gradient
    all-reduce over ``data`` under a2a and psum, which a2a_grid does not
    have."""
    d, m, n, f = 4, 2, 8, len(R.F_SIZES)
    b_loc, b_g = R.STEP_B // n, R.STEP_B // d
    rows_local = 128 // m
    _, params, _ = R.step_case()
    repl = sum(t.numel() * 4 for name, t in _tree.named_leaves(params)
               if not name.endswith("dense"))
    traffic = ranks[0]["steps"][exchange]["traffic"]
    by = {}
    for kind, _, size, n_bytes in traffic:
        by.setdefault((kind, size), []).append(n_bytes)
    for res in ranks[1:]:            # every rank moves the same
        assert res["steps"][exchange]["traffic"] == traffic
    if exchange == "psum":
        assert set(by) == {("all-reduce", m), ("all-reduce", d)}
        assert sum(by[("all-reduce", m)]) == b_g * f * 4 * 4 + b_g * f * 1 * 4
        assert sum(by[("all-reduce", d)]) == repl + rows_local * 4 * 4 + rows_local * 1 * 4
        return
    g = n if exchange == "a2a_grid" else m
    assert sorted(by[("all-to-all", g)]) == sorted([g * b_loc * f * 4 * 4] * 2
                                                   + [g * b_loc * f * 1 * 4] * 2)
    assert by[("all-gather", g)] == [g * b_loc * f * 4]
    assert sum(by[("all-reduce", n)]) == repl
    if exchange == "a2a":
        assert set(by) == {("all-to-all", m), ("all-gather", m), ("all-reduce", n),
                           ("all-reduce", d)}
        assert sum(by[("all-reduce", d)]) == rows_local * 4 * 4 + rows_local * 1 * 4
    else:
        assert set(by) == {("all-to-all", n), ("all-gather", n), ("all-reduce", n)}


# ---------------------------------------------------------------------- fit

@pytest.fixture(scope="module")
def single_fits():
    """The port's one-device fits, dropout on and off."""
    out = {}
    for dropout in (True, False):
        cfg, params, xi, xv, y = R.fit_case(dropout)
        est = R.fit(cfg, params, xi, xv, y)
        out[dropout] = dict(metrics=np.array(est.eval_by_batch(xi, xv, y)),
                            logits=est._predict_logits(xi, xv), losses=est.last_epoch_losses)
    return out


SHARDS = {"a2a_grid": 8, "a2a": 2, "psum": 2, "pure_dp": 1, "grid_data_only": 8,
          "all_remaining_ranks": 2}


@pytest.mark.parametrize("case", list(SHARDS))
def test_fit_matches_one_device_fit_with_dropout(ranks, single_fits, case):
    """``fit`` through the mesh flags, dropout on: the metrics, the logits and
    every step's loss of the port's one-device fit. Every rank draws the
    global batch's dropout numbers and keeps its rows (``ops.mlp.BatchShard``).
    ``mesh_data=0`` takes the ranks that ``mesh_model`` leaves."""
    got, want = ranks[0]["fits"][case], single_fits[True]
    assert got["shards"] == SHARDS[case]
    assert got["mesh"] == ((4, 2) if case == "all_remaining_ranks" else R.FIT_CASES[case][:2])
    np.testing.assert_allclose(got["metrics"], want["metrics"], **FIT_TOL)
    np.testing.assert_allclose(got["logits"], want["logits"], **FIT_TOL)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    for res in ranks[1:]:           # every rank returns every logit
        np.testing.assert_array_equal(res["fits"][case]["logits"], got["logits"])


@pytest.mark.parametrize("exchange", R.EXCHANGES)
def test_fit_matches_jax_sharded_fit(ranks, single_fits, exchange):
    """``fit`` on the (4, 2) mesh with dropout off against JAX's ``fit`` on the
    same mesh and exchange from the same parameters, and against the port's
    one-device fit."""
    cfg, params, xi, xv, y = R.fit_case(dropout=False)
    est = JT.DeepFMEstimator(_jcfg(cfg), JTrain(**R.FIT_KW, mesh_data=4, mesh_model=2,
                                                exchange=exchange, table_layout="flat"),
                             logger=QUIET)
    est.params = _jax(params)
    est.fit(xi, xv, y)
    got = ranks[0]["fits"][f"{exchange}_no_dropout"]
    np.testing.assert_allclose(got["metrics"], np.array(est.eval_by_batch(xi, xv, y)), **FIT_TOL)
    np.testing.assert_allclose(got["logits"], est._predict_logits(xi, xv), **FIT_TOL)
    np.testing.assert_allclose(got["metrics"], single_fits[False]["metrics"], **FIT_TOL)


# ------------------------------------------------------------ KD and QAT

KD_QAT_IDS = [f"{kind}-{ex}" for kind in R.KD_QAT_KINDS for ex in R.KD_QAT_EXCHANGES]
KD_QAT_KEYS = [(kind, ex) for kind in R.KD_QAT_KINDS for ex in R.KD_QAT_EXCHANGES]


def _one_device_kd_qat_step(kind):
    """(loss, gradients by name, QAT scales) of the port's one-device step and
    JAX's ``value_and_grad`` of its loss on the whole batch (KD: ``kd_loss``;
    QAT: the masked mean BCE of the QAT forward)."""
    cfg, params, batch = R.kd_qat_step_case(kind)
    jcfg = _jcfg(cfg)
    b = {k: jnp.asarray(v) for k, v in batch.items() if k != "n_valid"}

    def loss_fn(p):
        logits = JD.forward(p, b["xi"], b["xv"], jcfg)
        if kind == "kd":
            return JKD.kd_loss(logits, b["teacher"], b["y"], b["mask"], alpha=0.9,
                               temperature=20.0)
        elem = optax.sigmoid_binary_cross_entropy(logits, b["y"])
        return jnp.sum(elem * b["mask"]) / jnp.sum(b["mask"])

    loss_j, grads_j = jax.value_and_grad(loss_fn)(_jax(params))
    scales = []
    batch_t = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    fwd = partial(TD.forward, amax_fn=R.recording(scales) if kind == "qat" else None)
    loss_t, _ = TT.loss_and_grads(params, batch_t, cfg, TTrain(**R.TRAIN_KW), forward_fn=fwd,
                                  teacher_logits=batch_t.get("teacher"))
    return float(loss_j), jckpt._flatten(grads_j), float(loss_t), scales


@pytest.mark.parametrize("key", KD_QAT_KEYS, ids=KD_QAT_IDS)
def test_kd_and_qat_step_match_jax_on_the_whole_batch(ranks, key):
    """One KD and one QAT step on the (4, 2) mesh, 10 padded rows at the
    batch's tail (the last a2a_grid rank holds padding only): the global loss
    and every reduced gradient against ``jax.value_and_grad`` of the JAX loss
    over the whole batch; the KD loss's softmax and the QAT scales span every
    rank's rows. Every QAT activation scale, on every rank, equals the
    one-device port's to the bit: the abs-max is exact under MAX."""
    kind, exchange = key
    loss_j, grads_j, loss_one, scales_one = _one_device_kd_qat_step(kind)
    got = ranks[0]["kd_qat_steps"][key]
    assert got["loss"] == pytest.approx(loss_j, rel=1e-5)
    assert got["loss"] == pytest.approx(loss_one, rel=1e-5)
    assert set(got["grads"]) == set(grads_j)
    for name, w in grads_j.items():
        np.testing.assert_allclose(got["grads"][name], w, rtol=1e-4, atol=1e-7, err_msg=name)
    assert len(scales_one) == (3 if kind == "qat" else 0)      # the input and 2 hidden layers
    for res in ranks:
        assert res["kd_qat_steps"][key]["scales"] == scales_one


@pytest.mark.parametrize("key", KD_QAT_KEYS, ids=KD_QAT_IDS)
def test_kd_and_qat_collectives_span_the_batchs_ranks(ranks, key):
    """What the loss adds to a step's collectives, over the batch's ranks
    (the world under a2a_grid, ``data`` under psum): KD, one MAX and one SUM
    all-reduce of the student's and teacher's (maximum, sum) in the forward
    and one SUM of their cotangents in the backward, 8 bytes each; QAT, one
    4-byte MAX all-reduce of each fake-quantized activation."""
    kind, exchange = key
    group, size = ("world", 8) if exchange == "a2a_grid" else ("data", 4)
    small = [(k, g, n, b) for k, g, n, b in ranks[0]["kd_qat_steps"][key]["traffic"]
             if k == "all-reduce" and g == group]
    assert small == [("all-reduce", group, size, 8 if kind == "kd" else 4)] * 3
    for res in ranks[1:]:
        assert res["kd_qat_steps"][key]["traffic"] == ranks[0]["kd_qat_steps"][key]["traffic"]


def _jax_kd_qat_fit(kind, exchange):
    """JAX's ``fit`` on the (4, 2) mesh from the parameters of the port's case."""
    cfg, params, teacher_params, xi, xv, y = R.kd_qat_fit_case(kind)
    teacher = None
    if teacher_params is not None:
        teacher = JT.DeepFMEstimator(_jcfg(cfg), JTrain(**R.FIT_KW), logger=QUIET)
        teacher.params = _jax(teacher_params)
    est = JT.DeepFMEstimator(_jcfg(cfg), JTrain(**R.FIT_KW, mesh_data=4, mesh_model=2,
                                                exchange=exchange, table_layout="flat"),
                             logger=QUIET)
    est.params = _jax(params)
    return est.fit(xi, xv, y, teacher_model=teacher), xi, xv


@pytest.mark.parametrize("key", KD_QAT_KEYS, ids=KD_QAT_IDS)
def test_kd_and_qat_fit_match_jax_sharded_fit(ranks, key):
    """``fit`` with a teacher, and with ``quantization_aware``, on the (4, 2)
    mesh, dropout off, a padded tail batch, against JAX's ``fit`` on the same
    mesh and exchange: the student's parameters and the train metrics as
    ``test_kd_fit_matches_jax_fit``; the teacher's logits are cut into the
    ranks' rows with the batch. Every rank returns every eval logit."""
    kind, exchange = key
    est, _, _ = _jax_kd_qat_fit(kind, exchange)
    got = ranks[0]["fits"][key]
    spec = JD.make_embedding_spec(est.mcfg)
    want = j_mesh.unpad_rows(est.params, spec.dense_rows)
    assert_trees_close(_tree.rebuild(want, {n: torch.from_numpy(v)
                                            for n, v in got["params"].items()}),
                       want, rtol=1e-4, atol=2e-5, field_cov_diag_atol=1e-3)
    np.testing.assert_allclose(got["metrics"], est.train_result, rtol=0, atol=1e-6)
    for res in ranks[1:]:
        np.testing.assert_array_equal(res["fits"][key]["logits"], got["logits"])


@pytest.mark.parametrize("exchange", R.KD_QAT_EXCHANGES)
def test_qat_eval_on_a_mesh_matches_jax(ranks, exchange):
    """A QAT model's eval depends on its batches: each takes its own scales.
    The port's eval on the mesh (batches of 128 rows cut over the ranks, the
    second padded) against JAX's ``_predict_logits`` on the same mesh with
    the port's trained parameters (rtol 1e-5, atol 1e-6: float32 sums in
    another order), and against the port's one-device eval of them. Batches
    of 64 rows give other logits."""
    cfg, _, _, xi, xv, _ = R.kd_qat_fit_case("qat")
    got = ranks[0]["fits"][("qat", exchange)]
    n = R.KD_QAT_EVAL_N
    trained = {name: torch.from_numpy(v) for name, v in got["params"].items()}
    est = JT.DeepFMEstimator(_jcfg(cfg), JTrain(**{**R.FIT_KW, "n_epochs": 0}, mesh_data=4,
                                                mesh_model=2, exchange=exchange,
                                                table_layout="flat"), logger=QUIET)
    est.params = _jax(_tree.rebuild(TD.init_params(torch.Generator(), cfg, device="meta"),
                                    trained))
    est.fit(xi, xv, np.zeros(len(xi), np.float32))    # no epoch: the mesh and the blocks
    assert est.mesh is not None
    np.testing.assert_allclose(got["logits"], est._predict_logits(xi[:n], xv[:n]), rtol=1e-5,
                               atol=1e-6)
    one = TT.DeepFMEstimator(cfg, TTrain(**R.FIT_KW), logger=QUIET, device="cpu")
    one.params = _tree.rebuild(one.init_params(), trained)
    np.testing.assert_allclose(got["logits"], one._predict_logits(xi[:n], xv[:n]), rtol=1e-5,
                               atol=1e-6)
    assert not np.allclose(got["logits"], one._predict_logits(xi[:n], xv[:n], batch_size=64),
                           rtol=1e-5, atol=1e-6)


def test_kd_and_qat_clis_under_torchrun_match_one_process(tmp_path, monkeypatch):
    """``cli.kd`` and ``cli.quantization -quantization_aware 1`` with
    ``-mesh_data 2 -mesh_model 2`` on 4 CPU ranks under
    ``torch.distributed.run`` (gloo), dropout on: both fit on the mesh, and
    rank 0's benchmarks and trained parameters equal the one-process run's
    within the CLI tests' 1e-4 (``field_cov``'s diagonal 1e-3)."""
    from xsdeepfwfm_deprecated_torch.cli import kd, main_all, quantization
    monkeypatch.chdir(tmp_path)
    teacher = os.path.abspath(main_all.main(R.CLI_ARGV, device="cpu").save_model_name)
    monkeypatch.setattr(kd, "STUDENT_DEEP_NODES", 8)             # 400x2 -> 8x2 at these widths
    flags = R.CLI_ARGV + ["-save_model_path", teacher]
    _, student = kd.main(flags, device="cpu")
    qat = quantization.main(flags + ["-quantization_aware", "1"], device="cpu")["qat"]
    work = tmp_path / "ranks"
    work.mkdir()
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")])}
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "4",
           os.path.join(os.path.dirname(__file__), "torch_cli_ranks.py"), str(work), teacher,
           "8"] + R.CLI_ARGV
    res = subprocess.run(cmd, cwd=work, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-4000:]
    with open(work / "rank0.pkl", "rb") as f:
        got = pickle.load(f)
    logs = "".join(open(p).read() for p in glob.glob(str(work / "logs" / "*.log")))
    assert "mesh: data=2 model=2" in logs
    assert got["qat_keys"] == ["original", "qat"]
    for name, want in (("student", student.benchmark), ("qat", qat["benchmark"])):
        for key in ("loss", "auc", "prauc", "rce"):
            assert got[name][key] == pytest.approx(want[key], rel=1e-4, abs=1e-4), (name, key)
    for name, want in (("student_params", student.params), ("qat_params",
                                                            qat["estimator"].params)):
        for leaf, w in _tree.named_leaves(want):
            g, w = got[name][leaf], w.numpy()
            if leaf == "field_cov":        # its diagonal trains on rounding noise (ROADMAP.md 3)
                np.testing.assert_allclose(np.diagonal(g), np.diagonal(w), rtol=1e-4, atol=1e-3)
                off = ~np.eye(g.shape[0], dtype=bool)
                g, w = g[off], w[off]
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4, err_msg=f"{name} {leaf}")


@pytest.mark.parametrize("axes", ["model", "grid"])
def test_sharded_table_threshold_is_the_whole_tables(ranks, axes):
    """Above ``BISECT_SIZE`` the threshold of a row-sharded table is the
    bisection with its maximum and every halving's count all-reduced: the
    one-device search to the bit, on every rank, whether the rows are cut
    over ``model`` or over the grid."""
    from xsdeepfwfm_deprecated_torch.compression import pruning
    tables, targets = R.threshold_case()
    flat = torch.cat([t.reshape(-1) for t in tables.values()])
    assert flat.numel() > pruning.BISECT_SIZE
    key_axes = "model" if axes == "model" else ("data", "model")
    for target in targets:
        want = float(pruning.magnitude_threshold(flat, target))
        assert all(res["thresholds"][(key_axes, target)] == want for res in ranks), target


def test_pruned_fit_reaches_the_one_device_sparsity(ranks):
    """DeepLight pruning on the (4, 2) mesh (a2a, dropout off): the threshold
    of the row-sharded table is the whole table's, so every epoch's sparsity
    is the port's one-device fit's and within 0.1 points of JAX's
    (``test_fit_mesh_pruned_matches_single_device``)."""
    got = ranks[0]["fits"]["pruned"]
    cfg, params, xi, xv, y = R.fit_case(dropout=False)
    one = R.fit(cfg, params, xi, xv, y, **R.PRUNE_KW)
    np.testing.assert_allclose(got["sparsity"], one.epoch_sparsity, atol=0.1)
    assert got["sparsity"][-1] > 0.0
    np.testing.assert_allclose(got["metrics"], np.array(one.eval_by_batch(xi, xv, y)), **FIT_TOL)
    est = JT.DeepFMEstimator(_jcfg(cfg), JTrain(**R.FIT_KW, table_layout="flat", **R.PRUNE_KW),
                             logger=QUIET)
    est.params = _jax(params)
    est.fit(xi, xv, y)
    np.testing.assert_allclose(got["sparsity"], est.epoch_sparsity, atol=0.1)


def test_checkpoint_from_a_mesh_loads_anywhere(ranks):
    """A checkpoint written by a (4, 2) fit loads into a one-device estimator
    of either package and into a (2, 4) grid-sharded one with the sharded
    model's predictions, and training resumes on (2, 4) as on (4, 2)
    (``test_mesh_reshape_checkpoint_roundtrip``)."""
    fits = ranks[0]["fits"]
    cfg, _, xi, xv, _ = R.fit_case()
    path, want = fits["ckpt"]["path"], fits["ckpt"]["proba"]
    one = TT.DeepFMEstimator(cfg, TTrain(random_seed=7), logger=QUIET, device="cpu").load(path)
    np.testing.assert_allclose(one.predict_proba(xi[:64], xv[:64]), want, rtol=2e-5, atol=2e-6)
    j = JT.DeepFMEstimator(_jcfg(cfg), JTrain(random_seed=7), logger=QUIET).load(path)
    np.testing.assert_allclose(j.predict_proba(xi[:64], xv[:64]), want, rtol=2e-5, atol=2e-6)
    loaded = fits["loaded_sharded"]
    assert loaded["rows"] == -(-sum(R.PP_FSIZES) // 8)
    np.testing.assert_allclose(loaded["proba"], want, rtol=2e-5, atol=2e-6)
    r24, r42 = fits["resumed"][(2, 4)], fits["resumed"][(4, 2)]
    assert r24["model"] == 4 and r24["step"] == r42["step"] == 8
    np.testing.assert_allclose(r24["metrics"], r42["metrics"], **FIT_TOL)


def test_indivisible_batch_raises(ranks):
    assert all("not divisible" in res["fits"]["indivisible"] for res in ranks)


def test_cli_on_a_mesh_matches_one_device(ranks, tmp_path, monkeypatch):
    """``cli.main_all`` with ``-mesh_data 4 -mesh_model 2`` on 8 ranks (the
    default a2a_grid exchange, dropout on): every rank fits on its blocks,
    rank 0 reloads the checkpoint and benchmarks it with the metrics of the
    one-device command."""
    from xsdeepfwfm_deprecated_torch.cli import main_all
    monkeypatch.chdir(tmp_path)
    want = main_all.main(R.CLI_ARGV, device="cpu").benchmark
    got = ranks[0]["cli"]
    assert all(res["cli"]["benchmark"] is None and res["cli"]["shards"] == 8 for res in ranks[1:])
    for key in ("loss", "auc", "prauc", "rce"):
        assert got["benchmark"][key] == pytest.approx(want[key], rel=2e-4, abs=2e-5), key


def test_each_rank_reads_its_shard_of_the_input(ranks):
    """``data.sharded_input`` takes the rank and world size from the process
    group by default."""
    spans = [res["host_shard"] for res in ranks]
    assert [r for lo, hi in spans for r in range(lo, hi)] == list(range(103))
    files = [res["files"] for res in ranks]
    assert sorted(sum(files, [])) == sorted(f"f{i}" for i in range(19))
    assert files[0] == ["f0", "f16", "f7"]


def test_dryrun_multichip_on_cpu_ranks():
    """``entry.dryrun_multichip``: four ranks on a (2, 2) mesh, the three
    exchanges equal, and equal to the one-device fit (dropout on)."""
    logits = dryrun_multichip(4, backend="gloo", device_of_rank=lambda r: "cpu")
    cfg = flagship_config(full_criteo=False, feature_scale=64, deep_nodes=64, embedding_size=8)
    rng = np.random.default_rng(0)
    xi = rng.integers(0, cfg.feature_sizes[13:], size=(128, 26)).astype(np.int32)
    xv = rng.normal(size=(128, 13)).astype(np.float32)
    y = (rng.random(128) < 0.3).astype(np.float32)
    est = TT.DeepFMEstimator(cfg, TTrain(n_epochs=1, batch_size=64, eval_batch_size=64,
                                         random_seed=0), logger=QUIET, device="cpu")
    one = est.fit(xi, xv, y)._predict_logits(xi, xv)
    for exchange in ("a2a_grid", "a2a", "psum"):
        np.testing.assert_allclose(logits[exchange], one, **FIT_TOL)


def test_batch_shard_dropout_keeps_the_global_masks():
    """A rank's dropout masks are the rows of the global batch's masks, also
    for a rank whose rows are all padding."""
    from xsdeepfwfm_deprecated_torch.ops.mlp import BatchShard, dropout
    x = torch.ones(12, 5)
    whole = dropout(torch.Generator().manual_seed(4), x, 0.5, True)
    for start in (0, 4, 8):
        part = dropout(BatchShard(torch.Generator().manual_seed(4), 12, start), x[:4], 0.5, True)
        torch.testing.assert_close(part, whole[start:start + 4], rtol=0, atol=0)
