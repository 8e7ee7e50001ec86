"""The rank side of ``test_torch_mesh_multi_step.py``: what each of 4 ranks
on a (2 data, 2 model) mesh runs on the CPU over gloo, started by
``parallel.launch.run_ranks``. Each case fits the same rows at
``steps_per_call=K`` and at ``steps_per_call=1`` on the same mesh (the
grouped steps run eagerly over gloo, in the order of a replay). This module
imports torch, numpy and the port only; the test process computes the JAX
reference from the same seeded inputs.
"""

import dataclasses
import logging

import numpy as np
import torch

from xsdeepfwfm_deprecated_torch import _tree
from xsdeepfwfm_deprecated_torch.config import ModelConfig, TrainConfig
from xsdeepfwfm_deprecated_torch.data import batching
from xsdeepfwfm_deprecated_torch.models import deepfwfm
from xsdeepfwfm_deprecated_torch.ops.mlp import BatchShard
from xsdeepfwfm_deprecated_torch.parallel import mesh as mesh_mod
from xsdeepfwfm_deprecated_torch.train import trainer

WORLD, MESH = 4, (2, 2)
K = 4                           # steps_per_call of the grouped fits
B = 64
N = 9 * B + 6                   # 10 batches a epoch: groups of 4, 4 and 2, the last batch's 6
                                # real rows on the first rank of the batch's ranks only
FSIZES = (1, 1, 1, 40, 56, 30, 17)
FIT_KW = dict(n_epochs=2, batch_size=B, eval_batch_size=128, random_seed=7)
NO_DROPOUT = dict(is_shallow_dropout=False, is_deep_dropout=False)
PRUNE_KW = dict(prune=True, sparse=0.5, warm=0, prune_r=True, prune_interval=K)
EXCHANGES = ("a2a_grid", "a2a", "psum")
KD_EXCHANGE, QAT_EXCHANGE = "a2a_grid", "psum"   # the batch's ranks: the world, then `data`
JAX_EXCHANGE = "a2a"

QUIET = logging.getLogger("torch_mesh_multi_step_ranks")
QUIET.addHandler(logging.NullHandler())
QUIET.propagate = False


class _Lines(logging.Handler):
    """Keeps the messages a fit logs (rank 0's ``mesh:`` line)."""

    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def case(dropout=True, qat=False):
    """(cfg, params, xi, xv, y): a 7-field DeepFwFM with lw and fwlw, E=4, a
    16x16 tower, and N seeded rows."""
    cfg = ModelConfig(field_size=7, feature_sizes=FSIZES, numerical=3, embedding_size=4,
                      deep_nodes=16, h_depth=2, use_fwfm=True, use_deep=True, use_lw=True,
                      use_fwlw=True, quantization_aware=qat, **({} if dropout else NO_DROPOUT))
    params = deepfwfm.init_params(torch.Generator().manual_seed(5), cfg, device="cpu")
    rng = np.random.default_rng(13)
    xi = rng.integers(0, [40, 56, 30, 17], size=(N, 4)).astype(np.int32)
    xv = rng.normal(size=(N, 3)).astype(np.float32)
    y = (rng.random(N) < 0.3).astype(np.float32)
    return cfg, params, xi, xv, y


def teacher_params():
    cfg, _, _, _, _ = case(dropout=False)
    return deepfwfm.init_params(torch.Generator().manual_seed(6), cfg, device="cpu")


def numpy_tree(tree):
    return {name: t.detach().cpu().numpy() for name, t in _tree.named_leaves(tree)}


def _fit(cfg, params, xi, xv, y, mesh, teacher=None, **train_kw):
    """A fit on ``mesh`` from ``params``: its losses, sparsity, gathered
    parameters, logits, the traffic of the whole fit and the lines it logged."""
    lines = _Lines()
    logger = logging.getLogger("torch_mesh_multi_step_ranks.fit")
    logger.handlers, logger.propagate = [lines], False
    logger.setLevel(logging.INFO)
    est = trainer.DeepFMEstimator(cfg, TrainConfig(**{**FIT_KW, **train_kw}, mesh_data=MESH[0],
                                                   mesh_model=MESH[1]),
                                  logger=logger, device="cpu")
    est.mesh = mesh          # one set of groups for every fit
    est.params = _tree.tree_map(torch.clone, params)
    mesh.traffic.clear()
    est.fit(xi, xv, y, teacher_model=teacher)
    return est, dict(losses=est.last_epoch_losses, sparsity=est.epoch_sparsity,
                     metrics=np.array(est.train_result), traffic=list(mesh.traffic),
                     params=numpy_tree(est.gather_params()), step=est._step,
                     lines=[line for line in lines.lines if line.startswith("mesh:")])


def _pair(out, name, cfg, params, xi, xv, y, mesh, teacher=None, **train_kw):
    """The fit at steps_per_call=K and at 1, under ``name``."""
    est = None
    for k in (K, 1):
        est, out[(name, k)] = _fit(cfg, params, xi, xv, y, mesh, teacher, steps_per_call=k,
                                   **train_kw)
    return est


def _eval(est, xi, xv):
    """``_predict_logits`` of 9 full batches and a tail, batch 64: a scanned
    group of EVAL_SCAN_K and the rest per batch, against every batch per
    batch (a group larger than the rows)."""
    scanned = est._predict_logits(xi, xv, batch_size=B)
    scan_k, trainer.EVAL_SCAN_K = trainer.EVAL_SCAN_K, 10 ** 9
    try:
        per_batch = est._predict_logits(xi, xv, batch_size=B)
    finally:
        trainer.EVAL_SCAN_K = scan_k
    return dict(scanned=scanned, per_batch=per_batch)


def _traffic(mesh, exchange):
    """``Mesh.traffic`` of one group of K full steps through the multi-step,
    and of one step through ``train_step``, from the same state."""
    cfg, params, xi, xv, y = case()
    tc = TrainConfig(**FIT_KW, mesh_data=MESH[0], mesh_model=MESH[1], exchange=exchange)
    est = trainer.DeepFMEstimator(cfg, tc, logger=QUIET, device="cpu")
    est.mesh, est.params = mesh, _tree.tree_map(torch.clone, params)
    est._setup_mesh()
    opt = trainer.make_optimizer(tc)
    est.opt_state = opt.init(est.params)
    est._shard_state()
    axes, gen = est._batch_axes(), torch.Generator().manual_seed(8)
    shard = BatchShard(gen, B, mesh_mod.batch_rows(mesh, axes, B).start)
    batches = list(est._local_batches(batching.iter_batches(xi[:K * B], xv[:K * B], y[:K * B], B)))
    stacked = next(batching.stack_groups(batches, K))
    stacked = {key: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
               for key, v in stacked.items()}
    multi = trainer.make_multi_step(cfg, tc, opt, forward_fn=est.forward_fn, mesh=mesh,
                                    reduce=est._reducer(), group=est._batch_group())
    mesh.traffic.clear()
    multi(est.params, est.opt_state, stacked["xi"], stacked["xv"], stacked["y"], stacked["mask"],
          shard, k_real=K, count_k=stacked["count"])
    group = list(mesh.traffic)
    mesh.traffic.clear()
    trainer.train_step(est.params, est.opt_state,
                       {key: torch.from_numpy(np.asarray(v)) for key, v in batches[0].items()
                        if key != "n_valid"}, cfg, tc, opt, reduce=est._reducer(),
                       generator=shard, forward_fn=est.forward_fn, group=est._batch_group())
    step = list(mesh.traffic)
    try:
        multi(est.params, est.opt_state, stacked["xi"], stacked["xv"], stacked["y"],
              stacked["mask"], shard)
        refused = None
    except ValueError as e:
        refused = str(e)
    return dict(group=group, step=step, refused=refused)


def rank_cases(rank, device, workdir):
    mesh = mesh_mod.make_mesh(*MESH, device="cpu")
    out = {}
    for exchange in EXCHANGES:
        cfg, params, xi, xv, y = case()
        est = _pair(out, exchange, cfg, params, xi, xv, y, mesh, exchange=exchange)
        if exchange == "a2a_grid":
            out["eval"] = _eval(est, xi, xv)
    cfg, params, xi, xv, y = case(dropout=False)
    _pair(out, "pruned", cfg, params, xi, xv, y, mesh, exchange="a2a_grid", **PRUNE_KW)
    out[("jax", K)] = _fit(cfg, params, xi, xv, y, mesh, exchange=JAX_EXCHANGE,
                           steps_per_call=K)[1]
    teacher = trainer.DeepFMEstimator(cfg, TrainConfig(**FIT_KW), logger=QUIET, device="cpu")
    teacher.params = teacher_params()
    _pair(out, "kd", cfg, params, xi, xv, y, mesh, teacher, exchange=KD_EXCHANGE)
    qcfg = dataclasses.replace(cfg, quantization_aware=True)
    _pair(out, "qat", qcfg, params, xi, xv, y, mesh, exchange=QAT_EXCHANGE)
    out["traffic"] = {exchange: _traffic(mesh, exchange) for exchange in EXCHANGES}
    if rank:        # rank 0 returns the gathered trees; the others their losses and traffic
        out = {key: ({**v, "params": None} if isinstance(v, dict) and "params" in v else v)
               for key, v in out.items()}
    return out
