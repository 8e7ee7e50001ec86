"""The rank side of ``test_torch_sharding.py``: what each of 8 ranks runs on
the CPU over gloo, started by ``parallel.launch.run_ranks``. This module
imports torch, numpy and the port only (never JAX): the test process
computes the JAX reference from the same seeded inputs, which it builds with
the functions below.
"""

import dataclasses
import logging
import os
from functools import partial

import numpy as np
import torch

from xsdeepfwfm_deprecated_torch import _tree
from xsdeepfwfm_deprecated_torch.compression import pruning
from xsdeepfwfm_deprecated_torch.config import ModelConfig, TrainConfig
from xsdeepfwfm_deprecated_torch.data import batching, sharded_input
from xsdeepfwfm_deprecated_torch.models import deepfwfm
from xsdeepfwfm_deprecated_torch.ops import embedding as emb_ops
from xsdeepfwfm_deprecated_torch.parallel import embedding_sharding as es
from xsdeepfwfm_deprecated_torch.parallel import mesh as mesh_mod
from xsdeepfwfm_deprecated_torch.train import trainer

WORLD = 8
MESHES = ((4, 2), (2, 4), (8, 1))
EXCHANGES = ("a2a_grid", "a2a", "psum")
LOOKUPS = {"a2a_grid": es.make_grid_lookup, "a2a": es.make_a2a_lookup,
           "psum": es.make_sharded_lookup}

# the lookup cases: a QR spec (the last field > 200 rows) beside dense fields, 72 dense rows
QR_SIZES = (1, 1, 30, 40, 312)
NUM, B, E = 2, 16, 4
# the train-step cases (tests/test_sharding.py's F_SIZES: 128 dense rows)
F_SIZES = (1, 1, 30, 40, 56)
STEP_B = 64
# the fit cases (tests/test_sharding.py::_pp_case)
PP_FSIZES = (1, 1, 1, 40, 56, 30, 17)
FIT_KW = dict(n_epochs=2, batch_size=64, eval_batch_size=128, random_seed=7)
NO_DROPOUT = dict(is_shallow_dropout=False, is_deep_dropout=False)
PRUNE_KW = dict(prune=True, sparse=0.5, warm=0, prune_r=True)
FIT_CASES = {       # name -> (mesh_data, mesh_model, exchange, dropout)
    "a2a_grid": (4, 2, "a2a_grid", True), "a2a": (4, 2, "a2a", True),
    "psum": (4, 2, "psum", True), "pure_dp": (8, 1, "a2a", True),
    "grid_data_only": (8, 1, "a2a_grid", True), "all_remaining_ranks": (0, 2, "psum", True),
    "a2a_grid_no_dropout": (4, 2, "a2a_grid", False), "a2a_no_dropout": (4, 2, "a2a", False),
    "psum_no_dropout": (4, 2, "psum", False)}
# distillation and QAT on a mesh: the batch's ranks are the world under a2a_grid, `data` under psum
KD_QAT_EXCHANGES = ("a2a_grid", "psum")
KD_QAT_KINDS = ("kd", "qat")
STEP_REAL = STEP_B - 10      # the KD/QAT step's batch: 10 padded rows, one rank's all padding
KD_QAT_FIT_N = 250           # the KD/QAT fits: a padded tail batch of 58 real rows in 64
KD_QAT_EVAL_N = 200          # QAT eval: batches of 128 rows, the second padded
TRAIN_KW = dict(learning_rate=1e-3, weight_decay=0.0, batch_size=STEP_B)
CLI_ARGV = ["-dataset", "tiny-criteo", "-n_epochs", "1", "-batch_size", "1024",
            "-deep_nodes", "16", "-h_depth", "2", "-embedding_size", "4", "-use_fwlw", "1"]

QUIET = logging.getLogger("torch_sharding_ranks")
QUIET.addHandler(logging.NullHandler())
QUIET.propagate = False


def lookup_case():
    """(spec, tables, xi, xv) of the lookup cases, on the CPU."""
    spec = emb_ops.make_spec(QR_SIZES, NUM, qr_flag=True, qr_collisions=4, qr_threshold=200)
    tables = emb_ops.init_tables(torch.Generator().manual_seed(3), spec, E)
    rng = np.random.default_rng(11)
    xi = rng.integers(0, QR_SIZES[NUM:], size=(B, len(QR_SIZES) - NUM)).astype(np.int32)
    xv = rng.normal(size=(B, NUM)).astype(np.float32)
    return spec, tables, xi, xv


def step_case():
    """(cfg, params, batch) of the train-step cases: JAX's _compile_step_hlo model
    (emb1 and emb2, a 16x16 tower), dropout off."""
    cfg = ModelConfig(field_size=5, feature_sizes=F_SIZES, numerical=NUM, embedding_size=E,
                      h_depth=2, deep_nodes=16, use_fwfm=True, use_deep=True, use_lw=True,
                      **NO_DROPOUT)
    params = deepfwfm.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    rng = np.random.default_rng(12)
    batch = dict(xi=rng.integers(0, F_SIZES[NUM:], size=(STEP_B, 3)).astype(np.int32),
                 xv=rng.normal(size=(STEP_B, NUM)).astype(np.float32),
                 y=(rng.random(STEP_B) < 0.3).astype(np.float32),
                 mask=np.ones(STEP_B, np.float32))
    return cfg, params, batch


def fit_case(dropout=True, n=256):
    """(cfg, params, xi, xv, y) of the fit cases (tests/test_sharding.py::_pp_case)."""
    cfg = ModelConfig(field_size=7, feature_sizes=PP_FSIZES, numerical=3, embedding_size=4,
                      deep_nodes=16, h_depth=2, use_fwfm=True, use_deep=True, use_lw=True,
                      use_fwlw=True, **({} if dropout else NO_DROPOUT))
    params = deepfwfm.init_params(torch.Generator().manual_seed(5), cfg, device="cpu")
    rng = np.random.default_rng(13)
    xi = rng.integers(0, [40, 56, 30, 17], size=(n, 4)).astype(np.int32)
    xv = rng.normal(size=(n, 3)).astype(np.float32)
    y = (rng.random(n) < 0.3).astype(np.float32)
    return cfg, params, xi, xv, y


def kd_qat_step_case(kind):
    """(cfg, params, batch) of one KD or QAT step: step_case's model (QAT:
    ``quantization_aware``), dropout off, its batch cut to STEP_REAL real rows
    and padded as ``fit`` pads a tail batch, and for KD the teacher's logits
    (seeded; zero on the padded rows, as ``fit`` pads them)."""
    cfg, params, full = step_case()
    cfg = dataclasses.replace(cfg, quantization_aware=kind == "qat")
    batch = next(batching.iter_batches(full["xi"][:STEP_REAL], full["xv"][:STEP_REAL],
                                       full["y"][:STEP_REAL], STEP_B))
    if kind == "kd":
        teacher = np.random.default_rng(14).normal(size=STEP_B).astype(np.float32) * 3
        batch["teacher"] = np.where(batch["mask"] > 0, teacher, 0).astype(np.float32)
    return cfg, params, batch


def kd_qat_fit_case(kind):
    """(cfg, student params, teacher params or None, xi, xv, y) of a KD or QAT
    fit: fit_case's model and rows, dropout off, KD_QAT_FIT_N rows; the KD
    student starts from other parameters than the teacher's."""
    cfg, params, xi, xv, y = fit_case(dropout=False, n=KD_QAT_FIT_N)
    if kind == "qat":
        return dataclasses.replace(cfg, quantization_aware=True), params, None, xi, xv, y
    student = deepfwfm.init_params(torch.Generator().manual_seed(6), cfg, device="cpu")
    return cfg, student, params, xi, xv, y


def recording(scales, amax_fn=None):
    """An ``amax_fn`` that appends each scale's abs-max to ``scales``."""
    def record(amax):
        out = amax if amax_fn is None else amax_fn(amax)
        scales.append(float(out))
        return out
    return record


def fit(cfg, params, xi, xv, y, device="cpu", **train_kw):
    """A DeepFMEstimator fitted from ``params`` (a copy)."""
    est = trainer.DeepFMEstimator(cfg, TrainConfig(**{**FIT_KW, **train_kw}), logger=QUIET,
                                  device=device)
    est.params = _tree.tree_map(lambda t: t.clone().to(device), params)
    return est.fit(xi, xv, y)


def numpy_tree(tree):
    return {name: t.detach().cpu().numpy() for name, t in _tree.named_leaves(tree)}


def _lookups(rank):
    spec, tables, xi, xv = lookup_case()
    out = {}
    for data, model in MESHES:
        mesh = mesh_mod.make_mesh(data, model, device="cpu")
        for exchange in EXCHANGES:
            axes = mesh_mod.GRID_AXES if exchange == "a2a_grid" else mesh_mod.MODEL_AXIS
            both = exchange != "psum"
            batch_axes = mesh_mod.batch_axes(both)
            rows = mesh_mod.batch_rows(mesh, batch_axes, B)
            local = mesh_mod.shard_params({"emb2": tables}, mesh, axes)["emb2"]
            live = {k: t.clone().requires_grad_(True) for k, t in local.items()}
            got = LOOKUPS[exchange](mesh, spec)(live, spec, torch.from_numpy(xi[rows]),
                                                torch.from_numpy(xv[rows]))
            grads = list(torch.autograd.grad((got ** 2).sum(), list(live.values())))
            mesh_mod.reduce_gradients(mesh, grads, [axes if k == "dense" else None
                                                    for k in live], batch_axes)
            out[(data, model, exchange)] = dict(
                rows=(rows.start, rows.stop), block=mesh.axis_index(axes),
                out=got.detach().numpy(), grads={k: g.numpy() for k, g in zip(live, grads)})
            if (data, model) == MESHES[0]:     # every index past its field's end
                past = xi + np.asarray(QR_SIZES[NUM:], np.int32)
                got = LOOKUPS[exchange](mesh, spec)(local, spec, torch.from_numpy(past[rows]),
                                                    torch.from_numpy(xv[rows]))
                out[("past", exchange)] = dict(rows=(rows.start, rows.stop), out=got.numpy())
    return out


def _steps(rank):
    cfg, params, batch = step_case()
    mesh = mesh_mod.make_mesh(4, 2, device="cpu")
    spec = deepfwfm.make_embedding_spec(cfg)
    tc = TrainConfig(learning_rate=1e-3, weight_decay=0.0, batch_size=STEP_B)
    out = {}
    for exchange in EXCHANGES:
        lookup, axes, shards, both = es.setup_exchange(mesh, spec, exchange)
        batch_axes = mesh_mod.batch_axes(both)
        opt = trainer.make_optimizer(tc)
        state = mesh_mod.shard_params(opt.init(params), mesh, axes)
        local = mesh_mod.shard_params(_tree.tree_map(torch.clone, params), mesh, axes)
        shardings = mesh_mod.param_shardings(local, axes)
        rows = mesh_mod.shard_batch({**batch, "count": np.asarray(STEP_B, np.float32)}, mesh,
                                    batch_axes, STEP_B)
        mesh.traffic.clear()
        loss = trainer.train_step(
            local, state, {k: torch.from_numpy(v) for k, v in rows.items()}, cfg, tc, opt,
            reduce=partial(mesh_mod.reduce_gradients, mesh, shardings=list(shardings.values()),
                           batch=batch_axes),
            forward_fn=partial(deepfwfm.forward, lookup_fn=lookup))
        traffic = list(mesh.traffic)
        loss = float(mesh.all_reduce(loss, batch_axes))
        full = mesh_mod.gather_params(local, mesh, axes, spec.dense_rows)
        out[exchange] = dict(loss=loss, params=numpy_tree(full), traffic=traffic)
    return out


def _kd_qat_steps(rank):
    """One KD and one QAT loss-and-gradient step on the (4, 2) mesh under
    a2a_grid and psum: the global loss, the reduced gradients gathered whole,
    the collectives, and (QAT) every activation abs-max the tower took."""
    mesh = mesh_mod.make_mesh(4, 2, device="cpu")
    tc = TrainConfig(**TRAIN_KW)
    out = {}
    for kind in KD_QAT_KINDS:
        cfg, params, batch = kd_qat_step_case(kind)
        spec = deepfwfm.make_embedding_spec(cfg)
        for exchange in KD_QAT_EXCHANGES:
            lookup, axes, _, both = es.setup_exchange(mesh, spec, exchange)
            batch_axes = mesh_mod.batch_axes(both)
            group = mesh_mod.BatchGroup(mesh, batch_axes)
            local = mesh_mod.shard_params(_tree.tree_map(torch.clone, params), mesh, axes)
            rows = mesh_mod.shard_batch({**batch, "count": np.asarray(STEP_REAL, np.float32)},
                                        mesh, batch_axes, STEP_B)
            rows = {k: torch.from_numpy(np.asarray(v)) for k, v in rows.items()}
            scales = []
            fwd = partial(deepfwfm.forward, lookup_fn=lookup,
                          amax_fn=recording(scales, group.max) if kind == "qat" else None)
            mesh.traffic.clear()
            loss, grads = trainer.loss_and_grads(local, rows, cfg, tc, forward_fn=fwd, group=group,
                                                 teacher_logits=rows.get("teacher"))
            loss_traffic = list(mesh.traffic)
            mesh_mod.reduce_gradients(mesh, grads, list(mesh_mod.param_shardings(
                local, axes).values()), batch_axes)
            names = [n for n, _ in _tree.named_leaves(local)]
            full = mesh_mod.gather_params(_tree.rebuild(local, dict(zip(names, grads))), mesh,
                                          axes, spec.dense_rows)
            out[(kind, exchange)] = dict(
                loss=float(mesh.all_reduce(loss, batch_axes)), scales=scales,
                grads=numpy_tree(full) if rank == 0 else None, traffic=loss_traffic,
                group=mesh_mod.batch_axes(both))
    return out


def threshold_case():
    """Tables above the bisection size (5,003 dense rows of 4, a replicated
    q table) and the sparsity targets of the threshold cases."""
    gen = torch.Generator().manual_seed(9)
    tables = {"dense": torch.randn(5003, 4, generator=gen) * torch.rand(5003, 1, generator=gen),
              "q": torch.randn(60, 4, generator=gen)}
    return tables, (0.0, 0.3, 0.9)


def _thresholds(rank):
    tables, targets = threshold_case()
    mesh = mesh_mod.make_mesh(4, 2, device="cpu")
    out = {}
    for axes in (mesh_mod.MODEL_AXIS, mesh_mod.GRID_AXES):
        local = mesh_mod.shard_params({"emb2": tables}, mesh, axes)["emb2"]
        for target in targets:
            out[(axes, target)] = float(pruning._sharded_table_threshold(
                local, torch.tensor(target), 5003, mesh, axes))
    return out


def _fits(rank, workdir):
    out = {}
    for name, (data, model, exchange, dropout) in FIT_CASES.items():
        cfg, params, xi, xv, y = fit_case(dropout)
        est = fit(cfg, params, xi, xv, y, mesh_data=data, mesh_model=model, exchange=exchange)
        out[name] = dict(metrics=np.array(est.eval_by_batch(xi, xv, y)),
                         logits=est._predict_logits(xi, xv), losses=est.last_epoch_losses,
                         shards=est._table_shards, mesh=(est.mesh.data, est.mesh.model))
    cfg, params, xi, xv, y = fit_case(dropout=False)
    est = fit(cfg, params, xi, xv, y, mesh_data=4, mesh_model=2, exchange="a2a", **PRUNE_KW)
    out["pruned"] = dict(metrics=np.array(est.eval_by_batch(xi, xv, y)),
                         sparsity=est.epoch_sparsity, params=numpy_tree(est.gather_params()))

    # a (4, 2) checkpoint, resumed on (2, 4) and on (4, 2)
    cfg, params, xi, xv, y = fit_case()
    path = os.path.join(workdir, "mesh_ckpt")
    est = trainer.DeepFMEstimator(cfg, TrainConfig(**{**FIT_KW, "n_epochs": 1}, mesh_data=4,
                                                   mesh_model=2, exchange="a2a"),
                                  logger=QUIET, device="cpu")
    est.params = _tree.tree_map(torch.clone, params)
    est.fit(xi, xv, y, save_path=path)
    out["ckpt"] = dict(path=path, proba=est.predict_proba(xi[:64], xv[:64]))
    resumed = {}
    for data, model in ((2, 4), (4, 2)):
        est = trainer.DeepFMEstimator(cfg, TrainConfig(**FIT_KW, mesh_data=data, mesh_model=model,
                                                       exchange="a2a"), logger=QUIET, device="cpu")
        est.fit(xi, xv, y, resume_from=path)
        resumed[(data, model)] = dict(metrics=np.array(est.eval_by_batch(xi, xv, y)),
                                      model=est.mesh.model, step=est._step)
    out["resumed"] = resumed
    # a sharded estimator loads the checkpoint into its own blocks
    est = trainer.DeepFMEstimator(cfg, TrainConfig(**FIT_KW, mesh_data=2, mesh_model=4,
                                                   exchange="a2a_grid"), logger=QUIET,
                                  device="cpu")
    est._setup_mesh()
    est.load(path)
    out["loaded_sharded"] = dict(rows=est.params["emb2"]["dense"].shape[0],
                                 proba=est.predict_proba(xi[:64], xv[:64]))

    # distillation and QAT, dropout off: the student's tree, the metrics, every step's loss;
    # for QAT the eval logits of KD_QAT_EVAL_N rows (a padded second batch)
    for kind in KD_QAT_KINDS:
        cfg, params, teacher_params, xi, xv, y = kd_qat_fit_case(kind)
        teacher = None
        if teacher_params is not None:
            teacher = trainer.DeepFMEstimator(cfg, TrainConfig(**FIT_KW), logger=QUIET,
                                              device="cpu")
            teacher.params = _tree.tree_map(torch.clone, teacher_params)
        for exchange in KD_QAT_EXCHANGES:
            est = trainer.DeepFMEstimator(cfg, TrainConfig(**FIT_KW, mesh_data=4, mesh_model=2,
                                                           exchange=exchange),
                                          logger=QUIET, device="cpu")
            est.params = _tree.tree_map(torch.clone, params)
            est.fit(xi, xv, y, teacher_model=teacher)
            res = dict(metrics=np.array(est.train_result), losses=est.last_epoch_losses,
                       logits=est._predict_logits(xi[:KD_QAT_EVAL_N], xv[:KD_QAT_EVAL_N]),
                       params=numpy_tree(est.gather_params()))
            out[(kind, exchange)] = res if rank == 0 else {**res, "params": None}

    tcfg = TrainConfig(n_epochs=1, batch_size=60, mesh_data=4, mesh_model=2)
    try:
        trainer.DeepFMEstimator(cfg, tcfg, logger=QUIET, device="cpu").fit(xi[:64], xv[:64], y[:64])
        out["indivisible"] = None
    except ValueError as e:
        out["indivisible"] = str(e)
    return out


def _cli(rank, workdir):
    from xsdeepfwfm_deprecated_torch.cli import main_all
    home = os.getcwd()
    os.makedirs(os.path.join(workdir, "cli"), exist_ok=True)
    os.chdir(os.path.join(workdir, "cli"))
    try:
        model = main_all.main(CLI_ARGV + ["-mesh_data", "4", "-mesh_model", "2"], device="cpu")
    finally:
        os.chdir(home)
    return dict(benchmark=getattr(model, "benchmark", None), shards=model._table_shards)


def rank_cases(rank, device, workdir):
    """Every case of one rank; rank 0's results carry the gathered tensors."""
    out = {"host_shard": sharded_input.host_shard(103),
           "files": sharded_input.shard_files([f"f{i}" for i in range(19)])}
    out["lookups"] = _lookups(rank)
    out["steps"] = _steps(rank)
    out["kd_qat_steps"] = _kd_qat_steps(rank)
    out["thresholds"] = _thresholds(rank)
    out["fits"] = _fits(rank, workdir)
    out["cli"] = _cli(rank, workdir)
    if rank:
        out["steps"] = {k: {**v, "params": None} for k, v in out["steps"].items()}
    return out

