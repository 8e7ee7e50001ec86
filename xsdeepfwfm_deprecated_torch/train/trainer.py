"""Training runtime: optimizers, the train step and the sklearn-style estimator.

Port of ``xsdeepfwfm_deprecated_tpu/train/trainer.py``. The estimator keeps
the reference's public surface (``fit(Xi, Xv, y, ...)`` with prune and KD
options, ``predict``, ``predict_proba``, ``evaluate``,
``print_size_of_model``, ``save``, ``load``). The compute is plain functions
on a dict of tensors:

* the four optimizers are this module's own update rules over the parameter
  tree, with optax's arithmetic, state layout and leaf names
  (:class:`Optimizer`), so an optimizer state crosses between the packages in
  a checkpoint. L2 joins the raw gradient before the moment updates;
* static batch shapes with a padded, masked tail batch;
* DeepLight pruning every ``prune_interval`` steps past the warm-up epochs;
* per-epoch train/valid logloss, AUC, PRAUC and RCE plus sparsity, the
  epoch-end shuffle, per-epoch checkpoints, the three-declines early stop.

Nothing in the per-step loop reads a value back from the device: the losses
stay there and are fetched once per epoch. Inside a
``utils.debug.nan_debugging`` block every step runs eagerly and its loss is
checked with ``isfinite``, which does read it.

A ``mesh_data x mesh_model`` mesh larger than 1x1 trains sharded
(``:227-336, 419-462, 671-722, 773-779``), one process per rank
(``parallel/mesh.py`` says how the ranks are laid out and started): the
dense tables row-sharded and looked up through the configured exchange
(``parallel/embedding_sharding.py``), each rank stepping on its rows of
every global batch. What JAX's compiler does implicitly is written out:

* the loss of a rank is ``sum(elem * mask)`` over its rows divided by the
  global batch's count of real rows, so the losses of the ranks sum to the
  global mean;
* gradients are summed over the ranks with other rows of the batch
  (``parallel.mesh.reduce_gradients``) before the optimizer adds L2, and the
  optimizer then runs on each rank's own leaves;
* DLRM-DCNv2's bags (``DLRMEstimator``, ``-mesh_data`` alone) take their own
  placement (``parallel/bag_sharding.py``): the large tables row-wise over
  the ranks, the small ones whole on each, their ids, partial bags and
  gradients exchanged inside the step;
* dropout draws the global batch's numbers and keeps the rank's rows
  (``ops.mlp.BatchShard``), so a sharded fit trains the model of the
  unsharded one;
* the prune refresh takes the table threshold over every block's real
  rows; eval gathers the logits, so every rank returns them all; ``save``
  gathers and unpads the tree and rank 0 writes it; ``load`` and
  ``resume_from`` read the whole checkpoint on every rank, which keeps its
  blocks, into any mesh shape;
* what spans the whole batch spans the batch's ranks
  (``parallel.mesh.BatchGroup``): the distillation loss's softmax over the
  batch (``compression.distillation.kd_loss``) and the QAT tower's
  activation scale, in training and in eval (``ops.mlp.qat_mlp_forward``).
  The teacher's logits are cut into the ranks' rows with the batch.

The JAX package's compiled dispatch is ported as CUDA graphs
(``utils/cuda_graph.py``): :func:`make_train_step` (``:63-85``) runs one
train step, :class:`PruneRefresh` one prune refresh and :func:`make_eval_fn`
(``:162-169``) one eval batch as one graph replay on the card;
:func:`make_multi_step` (``:88-159``) runs K train steps over stacked
``(K, B, ...)`` batches, padded or not, and optionally one prune refresh, and
:func:`make_scan_eval_fn` (``:171-195``) ``EVAL_SCAN_K`` eval batches. ``fit``
steps through the first two at ``steps_per_call=1`` and through the fourth
above it; ``_predict_logits`` runs its full groups through the last and the
rest through the eval fn, on one device and on a mesh alike, as in JAX. On a mesh a
replay holds the rank's collectives: over NCCL, where a CUDA graph can hold
them; over gloo (and on the CPU) the same groups run their steps eagerly.
Not ported: super-row table packing, a TPU layout with the same results
(``table_layout="super"`` and ``mesh_table_layout="super"`` train the flat
table).
"""

from __future__ import annotations

import time
from functools import partial
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from .. import _tree
from ..compression.distillation import kd_loss
from ..compression.pruning import prune_params_, sparsity_report
from ..compression.quantization import convert
from ..config import ModelConfig, TrainConfig
from ..data import batching
from ..device import DeviceLike, resolve_device
from ..models import deepfwfm, dlrm
from ..ops import embedding as emb_ops
from ..ops.cuda.fused_adam import fused_adam
from ..ops.mlp import BatchShard
from ..parallel import embedding_sharding as es
from ..parallel import mesh as mesh_mod
from ..parallel.bag_sharding import ShardedBags
from ..utils import cuda_graph, debug, profiling
from ..utils.logging import get_logger
from . import checkpoint as ckpt
from . import metrics as M

_SLOTS = {"adam": ("mu", "nu"), "rmsp": ("nu",), "adag": ("sum_of_squares",)}
ADAGRAD_EPS = 1e-10
_TABLE_GROUPS = ("emb1", "emb2", "ffm1", "ffm2")   # the parameter groups that hold table rows


class Optimizer:
    """adam | rmsp | adag | sgd with optax 0.2.6's update rules and state tree.

    The state is the tree that ``optax.chain(add_decayed_weights(wd), core)``
    keeps, with tuples for optax's chains and dicts for its named tuples, so
    its leaves flatten to optax's names: ``1/0/count``, ``1/0/mu/<param>``,
    ``1/0/nu/<param>`` for adam under weight decay, ``0/...`` without it.
    ``rmsp`` keeps eps inside the root with a zero initial scale, and ``adag``
    gives an exact 0 where the accumulator is 0, both unlike ``torch.optim``.
    Moments take their parameter's dtype. ``update`` changes parameters and
    state in place.

    A bag table's gradient (:class:`..ops.embedding.BagGrad`, DLRM-DCNv2's)
    takes ``adag`` without weight decay: its gradient is 0 off the batch's
    rows, where Adagrad's update is exactly 0, so
    :func:`..ops.embedding.bag_adagrad_` steps the batch's distinct rows
    alone (a span ``Bags - Update``; the card's count ``bag_rows_updated``).
    """

    def __init__(self, tcfg: TrainConfig):
        if tcfg.optimizer_type not in ("adam", "rmsp", "adag", "sgd"):
            raise ValueError(f"unknown optimizer {tcfg.optimizer_type!r}")
        self.kind = tcfg.optimizer_type
        self.lr = tcfg.learning_rate
        self.wd = tcfg.weight_decay
        self.momentum = tcfg.momentum

    def _slot_names(self) -> Tuple[str, ...]:
        if self.kind == "sgd":
            return ("trace",) if self.momentum else ()
        return _SLOTS[self.kind]

    def init(self, params: Dict) -> Any:
        slots: Any = {name: _tree.tree_map(torch.zeros_like, params)
                      for name in self._slot_names()}
        if self.kind == "adam":
            device = _tree.leaves(params)[0].device
            slots = {"count": torch.zeros((), dtype=torch.int32, device=device), **slots}
        core = (slots or (), ())                    # (the scaler's state, scale by -lr)
        return ((), core) if self.wd else core      # (add_decayed_weights, core)

    def _slots(self, state: Any) -> Any:
        return (state[1] if self.wd else state)[0]

    @torch.no_grad()
    def update(self, params: Dict, grads: List[torch.Tensor], state: Any) -> None:
        """One step. ``grads`` are in the order of ``_tree.leaves(params)``."""
        p = _tree.leaves(params)
        slots = self._slots(state)
        bags = [i for i, g in enumerate(grads) if isinstance(g, emb_ops.BagGrad)]
        if bags:
            if self.kind != "adag" or self.wd:
                raise ValueError(f"a bag table trains with adag and no weight decay (-optimizer_type "
                                 f"adag -l2 0), got {self.kind} with weight decay {self.wd}: "
                                 f"only then are its rows off the batch left exactly as they are")
            acc = _tree.leaves(slots["sum_of_squares"])
            for i in bags:
                with profiling.named_scope(profiling.SCOPE_BAGS_UPDATE):
                    emb_ops.bag_adagrad_(p[i], acc[i], grads[i], self.lr, ADAGRAD_EPS,
                                         cuda_graph.device_count("bag_rows_updated", p[i].device))
            rest = [i for i in range(len(p)) if i not in bags]
            p, grads = [p[i] for i in rest], [grads[i] for i in rest]
            slots = {"sum_of_squares": [acc[i] for i in rest]}
        if self.kind == "adam":
            b1, b2, eps = 0.9, 0.999, 1e-8
            count = slots["count"].add_(1)
            # A table row that no batch reads has L2 as its only gradient, so its
            # first moment decays into the subnormals. There optax under XLA reads 0
            # and the row stops moving (at |w| ~ 1e-31); with the subnormals kept it
            # creeps on towards 1e-38, below the prune search's floor (its largest
            # magnitude * 2^-120), and one refresh zeroes every such row, far past
            # the target. Every other value gets a loss gradient each step.
            flush = [name.split("/")[0] in _TABLE_GROUPS
                     for name, _ in _tree.named_leaves(params)]
            # one kernel launch on the card; the `_foreach` passes on the CPU
            fused_adam(p, grads, _tree.leaves(slots["mu"]), _tree.leaves(slots["nu"]), flush,
                       1 - torch.pow(b1, count), 1 - torch.pow(b2, count), lr=self.lr,
                       wd=self.wd, b1=b1, b2=b2, eps=eps)
            return
        g = torch._foreach_add(grads, p, alpha=self.wd) if self.wd else list(grads)
        if self.kind == "rmsp":
            decay, eps = 0.99, 1e-8
            nu = _tree.leaves(slots["nu"])
            torch._foreach_mul_(nu, decay)
            torch._foreach_add_(nu, torch._foreach_mul(g, g), alpha=1 - decay)
            upd = torch._foreach_add(nu, eps)
            torch._foreach_sqrt_(upd)
            torch._foreach_reciprocal_(upd)
            torch._foreach_mul_(upd, g)
        elif self.kind == "adag":
            acc = _tree.leaves(slots["sum_of_squares"])
            torch._foreach_add_(acc, torch._foreach_mul(g, g))
            upd = [torch.where(a > 0, torch.rsqrt(a + ADAGRAD_EPS), torch.zeros_like(a)) * x
                   for a, x in zip(acc, g)]
        elif self.momentum:
            trace = _tree.leaves(slots["trace"])
            torch._foreach_mul_(trace, self.momentum)
            torch._foreach_add_(trace, g)
            upd = trace
        else:
            upd = g
        torch._foreach_add_(p, upd, alpha=-self.lr)


def make_optimizer(tcfg: TrainConfig) -> Optimizer:
    return Optimizer(tcfg)


ForwardFn = Callable[..., torch.Tensor]


def _model_forward(mcfg: ModelConfig) -> ForwardFn:
    """The forward of the configuration's model family, where none is given."""
    return dlrm.forward if mcfg.use_dlrm else deepfwfm.forward


def batch_loss(params: Dict, batch: Dict, mcfg: ModelConfig, tcfg: TrainConfig, *,
               generator: Optional[torch.Generator] = None,
               teacher_logits: Optional[torch.Tensor] = None,
               forward_fn: Optional[ForwardFn] = None,
               group: Optional[mesh_mod.BatchGroup] = None) -> torch.Tensor:
    """The train-mode loss of one batch: the masked mean BCE (the per-batch
    ``binary_cross_entropy_with_logits`` mean on an unpadded batch), or the
    KD loss when the teacher's logits are given. A rank's shard of a global
    batch carries ``batch["count"]``, the global batch's number of real rows
    as a 0-d tensor: its masked sum divided by that, so that the ranks'
    losses sum to the global mean; ``group`` (the batch's ranks) is where the
    KD loss takes its softmax."""
    forward_fn = forward_fn or _model_forward(mcfg)
    logits = forward_fn(params, batch["xi"], batch["xv"], mcfg, train=True, generator=generator)
    y, mask = batch["y"], batch["mask"]
    if teacher_logits is not None:
        return kd_loss(logits, teacher_logits, y, mask, alpha=tcfg.kd_alpha,
                       temperature=tcfg.kd_temperature, group=group, count=batch.get("count"))
    elem = F.binary_cross_entropy_with_logits(logits, y, reduction="none")
    count = batch["count"] if "count" in batch else mask.sum().clamp(min=1.0)
    return (elem * mask).sum() / count


def loss_and_grads(params: Dict, batch: Dict, mcfg: ModelConfig, tcfg: TrainConfig,
                   **loss_kw) -> Tuple[torch.Tensor, List[Any]]:
    """(loss, one gradient per leaf of ``params`` in ``_tree.leaves`` order).
    A parameter the loss does not reach gets zeros, so that L2 still decays
    it. A table that a pooled bag lookup read
    (:func:`..ops.embedding.recording_bags`) gets a
    :class:`..ops.embedding.BagGrad`: the backward stops at the pooled bags,
    and nothing the size of the table is made (on a mesh the gradient of a
    rank's bags is gathered over the ranks, ``parallel/bag_sharding``, inside
    the backward's span). ``params`` itself is left without ``requires_grad``."""
    leaves = [p.detach().requires_grad_(True) for p in _tree.leaves(params)]
    it = iter(leaves)
    live = _tree.tree_map(lambda _: next(it), params)
    with profiling.named_scope("step.forward"), emb_ops.recording_bags() as tape:
        loss = batch_loss(live, batch, mcfg, tcfg, **loss_kw)
    records = {id(r.table): r for r in tape.records}
    if len(records) != len(tape.records):
        raise ValueError("a bag table is looked up once a step")
    dense = [p for p in leaves if id(p) not in records]
    with profiling.named_scope("step.backward"):
        got = torch.autograd.grad(loss, dense + [r.pooled for r in records.values()],
                                  allow_unused=True)
        by_leaf = dict(zip([id(p) for p in dense] + list(records), got))
        grads: List[Any] = []
        for p in leaves:
            g, r = by_leaf[id(p)], records.get(id(p))
            if r is None:
                grads.append(torch.zeros_like(p) if g is None else g)
            else:       # a sharded lookup's record exchanges the bags' gradient here
                grads.append(r.grad(torch.zeros_like(r.pooled) if g is None else g))
    return loss.detach(), grads


def train_step(params: Dict, opt_state: Any, batch: Dict, mcfg: ModelConfig,
               tcfg: TrainConfig, optimizer: Optimizer,
               reduce: Optional[Callable[[List[torch.Tensor]], None]] = None,
               **loss_kw) -> torch.Tensor:
    """One optimizer step, in place on ``params`` and ``opt_state``. Returns
    the loss as a 0-d tensor on the device. ``reduce`` sums the gradients
    over the ranks of a sharded fit, in place, before the optimizer (and its
    L2) sees them. Its spans (:mod:`..utils.profiling`) are ``step.forward``,
    ``step.backward`` and ``step.optimizer``; inside a CUDA graph, device time."""
    loss, grads = loss_and_grads(params, batch, mcfg, tcfg, **loss_kw)
    if reduce is not None:
        reduce(grads)
    with profiling.named_scope("step.optimizer"):
        optimizer.update(params, grads, opt_state)
    return loss


def _collectives(mesh: Optional[mesh_mod.Mesh]) -> Dict[str, Any]:
    """What a compiled call of a mesh's steps passes to
    :class:`..utils.cuda_graph.Compiled`: the mesh's traffic as a counter, its
    barrier before a capture, and whether its backend's collectives can be
    captured."""
    if mesh is None:
        return {}
    return dict(counters=(cuda_graph.Log(mesh.traffic),), barrier=mesh.barrier,
                capturable=mesh.capturable)


def _graph_name(function: str, forward_fn: ForwardFn) -> str:
    return f"{function}({getattr(forward_fn, '__qualname__', '')})"


_BATCH = ("xi", "xv", "y", "mask", "teacher", "count")    # a step's inputs, where given


class _Steps:
    """What :class:`TrainStep` and :class:`MultiStep` share: the step's
    configuration and one :func:`train_step` on a batch, on a ``mesh`` this
    rank's sharded step (``reduce`` sums the gradients over the ranks,
    ``group`` is the batch's ranks for KD's softmax and QAT's scale, the
    generator a :class:`..ops.mlp.BatchShard`)."""

    name: str           # what the graphs are called

    def __init__(self, mcfg: ModelConfig, tcfg: TrainConfig, optimizer: Optimizer, *,
                 use_kd: bool = False, forward_fn: Optional[ForwardFn] = None,
                 mesh: Optional[mesh_mod.Mesh] = None,
                 reduce: Optional[Callable[[List[torch.Tensor]], None]] = None,
                 group: Optional[mesh_mod.BatchGroup] = None):
        self.mcfg, self.tcfg, self.optimizer, self.use_kd = mcfg, tcfg, optimizer, use_kd
        self.forward_fn = forward_fn or _model_forward(mcfg)
        self.mesh, self.reduce, self.group = mesh, reduce, group
        # a warm-up takes a bag table and its accumulator as one row: a step reads and
        # writes them at its batch's rows alone (utils.cuda_graph.Compiled)
        self.compiled_kw = dict(writes_state=True, **_collectives(mesh),
                                row_state=dlrm.is_bag_state if mcfg.use_dlrm else None)

    def _step(self, params: Dict, opt_state: Any, generator, **batch) -> torch.Tensor:
        return train_step(params, opt_state, batch, self.mcfg, self.tcfg, self.optimizer,
                          reduce=self.reduce, generator=generator, forward_fn=self.forward_fn,
                          group=self.group, teacher_logits=batch.get("teacher"))


class TrainStep(_Steps):
    """One train step a dispatch: what :func:`make_train_step` returns.

    ``train_step(params, opt_state, batch, generator=None)`` updates
    ``params`` and ``opt_state`` in place and returns the loss, a 0-d tensor
    on their device that the next call does not overwrite. ``batch`` holds
    ``xi``, ``xv``, ``y`` and ``mask``, the teacher's logits under
    ``teacher`` for a KD step, and on a mesh this rank's rows with the global
    batch's real-row count under ``count`` (``DeepFMEstimator._local_batches``).
    On the card one CUDA graph replay of :func:`train_step` and its optimizer
    update (on a mesh over NCCL with the gradient reduction inside), with the
    dropout generator registered; on the CPU and over gloo the step runs
    eagerly. Every batch is stepped, a rank's all-padding rows of a global
    batch too, as the eager step does."""

    name = "make_train_step"

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self._graphs = cuda_graph.Compiled(self._step, _graph_name(self.name, self.forward_fn),
                                           **self.compiled_kw)

    def __call__(self, params: Dict, opt_state: Any, batch: Dict[str, torch.Tensor],
                 generator: Any = None) -> torch.Tensor:
        with profiling.named_scope("train.step", unit=True):
            if ("teacher" in batch) != self.use_kd:
                raise ValueError("batch['teacher'] is the KD step's input, and only its")
            if self.mesh is not None and "count" not in batch:
                raise ValueError("a sharded step takes the global batch's real-row count as "
                                 "batch['count']: its loss divides by it")
            return self._graphs((params, opt_state, generator),
                                {key: batch[key] for key in _BATCH if key in batch})


def make_train_step(mcfg: ModelConfig, tcfg: TrainConfig, optimizer: Optimizer, *,
                    use_kd: bool = False, forward_fn: Optional[ForwardFn] = None,
                    mesh: Optional[mesh_mod.Mesh] = None,
                    reduce: Optional[Callable[[List[torch.Tensor]], None]] = None,
                    group: Optional[mesh_mod.BatchGroup] = None) -> TrainStep:
    """One optimizer step a dispatch (the JAX package's jitted
    ``make_train_step``, ``:63-85``); on a ``mesh``, a rank's sharded step
    with ``reduce`` and ``group``. See :class:`TrainStep`."""
    return TrainStep(mcfg, tcfg, optimizer, use_kd=use_kd, forward_fn=forward_fn, mesh=mesh,
                     reduce=reduce, group=group)


class MultiStep(_Steps):
    """K train steps over stacked ``(K, B, ...)`` batches in one dispatch,
    then one prune refresh where ``prune_kw`` is given: what
    :func:`make_multi_step` returns.

    ``multi_step(params, opt_state, xi_k, xv_k, y_k, mask_k, generator,
    teacher_k, adaptive, k_real=None, count_k=None)`` updates ``params`` and
    ``opt_state`` in place and returns the per-step losses ``(K,)`` on their
    device (a copy: the next call does not overwrite it). ``teacher_k`` is
    the ``(K, B)`` teacher logits of a KD step, else None; ``adaptive`` the
    refresh's schedule value (a float or a 0-d tensor) where ``prune_kw`` is
    given, else None.

    A step whose mask is all padding is skipped and gives a loss of 0, as the
    JAX scan's ``lax.cond`` skips it (``:121-139``): padding comes at the end,
    and ``k_real`` (the number of real steps, which the host knows from its
    group) saves reading the mask back to count them.

    On a ``mesh`` each step is this rank's sharded step, and ``count_k`` the
    ``(K,)`` real-row counts of the global batches, which the losses divide
    by. Both ``k_real`` and ``count_k`` come from the global group and are
    required there: a rank's share of the last global batch can be all
    padding while another rank's is not (the JAX scan tests the sum of the
    global mask), and a rank that skipped a step would leave the others'
    collectives waiting.

    On the card a group is one CUDA graph replay: captured on the first call
    for each input shape, state and pattern of real steps (the parameters and
    optimizer state are updated at the addresses they were captured with, so
    a refresh writes into them in place), with ``adaptive`` a device input
    filled before each replay and the dropout generator registered with the
    graph, so that the real steps draw the numbers that as many eager steps
    would. A group with padding steps (the last group of an epoch) is a
    graph of its own, which holds its real steps and the refresh, as JAX's
    one compiled dispatch holds the ``lax.cond`` of every step: its skipped
    steps draw nothing, touch no state and give a loss of 0. On a mesh the
    graph holds every collective of the steps and the refresh, which NCCL's
    process groups allow and gloo's do not: over gloo (and on the CPU) every
    real step runs eagerly, in the same order."""

    name = "make_multi_step"

    def __init__(self, *args, prune_kw: Optional[Dict] = None, **kw):
        super().__init__(*args, **kw)
        self.prune_kw = prune_kw
        self._graphs = cuda_graph.Compiled(self._steps, _graph_name(self.name, self.forward_fn),
                                           **self.compiled_kw)

    def _steps(self, params: Dict, opt_state: Any, generator, live: Tuple[bool, ...],
               **k_in: torch.Tensor) -> torch.Tensor:
        losses = []
        for i, run in enumerate(live):
            if not run:
                losses.append(torch.zeros((), device=k_in["mask"].device))
                continue
            losses.append(self._step(params, opt_state, generator,
                                     **{key: x[i] for key, x in k_in.items() if key in _BATCH}))
        if self.prune_kw is not None:
            prune_params_(params, k_in["adaptive"], **self.prune_kw)
        return torch.stack(losses)

    def __call__(self, params: Dict, opt_state: Any, xi_k: torch.Tensor, xv_k: torch.Tensor,
                 y_k: torch.Tensor, mask_k: torch.Tensor, generator: Any = None,
                 teacher_k: Optional[torch.Tensor] = None, adaptive: Any = None, *,
                 k_real: Optional[int] = None,
                 count_k: Optional[torch.Tensor] = None) -> torch.Tensor:
        with profiling.named_scope("train.step", unit=True):
            if (teacher_k is None) == self.use_kd:
                raise ValueError("teacher_k is the KD multi-step's input, and only its")
            if (adaptive is None) == (self.prune_kw is not None):
                raise ValueError("adaptive is the pruning multi-step's input, and only its")
            if self.mesh is not None and (k_real is None or count_k is None):
                raise ValueError("a sharded multi-step takes k_real and count_k from the global "
                                 "group: a rank's rows of a batch can be all padding where "
                                 "another rank's are not, and every rank must run the same steps")
            k = xi_k.shape[0]
            if k_real is None:
                live = tuple((mask_k.reshape(k, -1).sum(dim=1) > 0).tolist())
            else:
                live = tuple(i < k_real for i in range(k))
            k_in = {"xi": xi_k, "xv": xv_k, "y": y_k, "mask": mask_k, "teacher": teacher_k,
                    "count": count_k}
            k_in = {key: t for key, t in k_in.items() if t is not None}
            if self.prune_kw is not None:       # a 0-d device tensor, made by a fill
                device = _tree.leaves(params)[0].device
                k_in["adaptive"] = (adaptive.to(device=device, dtype=torch.float32)
                                    if isinstance(adaptive, torch.Tensor)
                                    else torch.full((), float(adaptive), dtype=torch.float32,
                                                    device=device))
            return self._graphs((params, opt_state, generator), k_in, live=live)


def make_multi_step(mcfg: ModelConfig, tcfg: TrainConfig, optimizer: Optimizer, *,
                    use_kd: bool = False, forward_fn: Optional[ForwardFn] = None,
                    prune_kw: Optional[Dict] = None, mesh: Optional[mesh_mod.Mesh] = None,
                    reduce: Optional[Callable[[List[torch.Tensor]], None]] = None,
                    group: Optional[mesh_mod.BatchGroup] = None) -> MultiStep:
    """K optimizer steps a dispatch over stacked ``(K, B, ...)`` batches (the
    JAX package's ``make_multi_step``, ``:88-159``), with one DeepLight prune
    refresh after them when ``prune_kw`` (keyword arguments of
    :func:`..compression.pruning.prune_params`) is given; on a ``mesh``, a
    rank's sharded steps with ``reduce`` and ``group``. See
    :class:`MultiStep`."""
    return MultiStep(mcfg, tcfg, optimizer, use_kd=use_kd, forward_fn=forward_fn,
                     prune_kw=prune_kw, mesh=mesh, reduce=reduce, group=group)


class PruneRefresh:
    """One DeepLight prune refresh a dispatch, the JAX package's jitted
    ``prune_params`` (``compression/pruning.py:108-109``):
    ``refresh(params, adaptive)`` is :func:`..compression.pruning.prune_params_`
    with ``prune_kw``, in place on ``params``. On the card one CUDA graph
    replay, captured for each parameter tree, the schedule value a 0-d device
    input; on a ``mesh`` over NCCL with the sharded threshold's all-reduces
    inside. On the CPU and over gloo the refresh runs eagerly."""

    name = "prune_params"

    def __init__(self, prune_kw: Dict, mesh: Optional[mesh_mod.Mesh] = None):
        self.prune_kw, self.mesh = prune_kw, mesh
        self._graphs = cuda_graph.Compiled(self._refresh, self.name, writes_state=True,
                                           **_collectives(mesh))

    def _refresh(self, params: Dict, target: torch.Tensor) -> None:
        prune_params_(params, target, **self.prune_kw)

    def __call__(self, params: Dict, adaptive: float) -> None:
        with profiling.named_scope("train.refresh"):
            target = torch.full((), float(adaptive), dtype=torch.float32,
                                device=_tree.leaves(params)[0].device)
            self._graphs((params,), {"target": target})


EVAL_SCAN_K = 8


class _Eval:
    """The eval forward a dispatch, on a ``mesh`` of this rank's rows with
    each batch's logits gathered over the ranks of ``axes``, so that every
    rank returns them all. On the card one CUDA graph replay, captured for
    each input shape and parameter tree (with the gathers inside, over NCCL);
    on the CPU and over gloo eager forwards."""

    name: str           # what the graphs are called

    def __init__(self, mcfg: ModelConfig, forward_fn: Optional[ForwardFn] = None, *,
                 mesh: Optional[mesh_mod.Mesh] = None, axes: Optional[mesh_mod.Axes] = None):
        self.mcfg = mcfg
        self.forward_fn = forward_fn or _model_forward(mcfg)
        self.mesh, self.axes = mesh, axes
        self._graphs = cuda_graph.Compiled(self._forwards, _graph_name(self.name, self.forward_fn),
                                           **_collectives(mesh))

    def _forward(self, params: Dict, xi: torch.Tensor, xv: torch.Tensor) -> torch.Tensor:
        logits = self.forward_fn(params, xi, xv, self.mcfg)
        if self.mesh is not None:
            logits = self.mesh.all_gather(logits, self.axes).reshape(-1)
        return logits

    @torch.inference_mode()
    def __call__(self, params: Dict, xi: torch.Tensor, xv: torch.Tensor) -> torch.Tensor:
        return self._graphs((params,), {"xi": xi, "xv": xv})


class ScanEval(_Eval):
    """The eval forward of K stacked batches in one dispatch:
    ``scan_eval(params, xi_k, xv_k)`` gives the ``(K, B)`` logits (a copy,
    which the next call does not overwrite); see :class:`_Eval`."""

    name = "make_scan_eval_fn"

    def _forwards(self, params: Dict, xi: torch.Tensor, xv: torch.Tensor) -> torch.Tensor:
        return torch.stack([self._forward(params, xi[i], xv[i]) for i in range(xi.shape[0])])


class EvalFn(_Eval):
    """The eval forward of one batch a dispatch: ``eval_fn(params, xi, xv)``
    gives the ``(B,)`` logits (a copy, which the next call does not
    overwrite); see :class:`_Eval`."""

    name = "make_eval_fn"
    _forwards = _Eval._forward


def make_eval_fn(mcfg: ModelConfig, forward_fn: Optional[ForwardFn] = None, *,
                 mesh: Optional[mesh_mod.Mesh] = None,
                 axes: Optional[mesh_mod.Axes] = None) -> EvalFn:
    """One eval batch a dispatch → its logits (the JAX package's jitted
    ``make_eval_fn``, ``:162-169``); see :class:`EvalFn`."""
    return EvalFn(mcfg, forward_fn, mesh=mesh, axes=axes)


def make_scan_eval_fn(mcfg: ModelConfig, forward_fn: Optional[ForwardFn] = None, *,
                      mesh: Optional[mesh_mod.Mesh] = None,
                      axes: Optional[mesh_mod.Axes] = None) -> ScanEval:
    """K eval batches a dispatch over stacked ``(K, B, ...)`` inputs → ``(K, B)``
    logits (the JAX package's ``make_scan_eval_fn``, ``:174-195``); see
    :class:`ScanEval`."""
    return ScanEval(mcfg, forward_fn, mesh=mesh, axes=axes)


class DeepFMEstimator:
    """sklearn-estimator-shaped wrapper (the reference ``DeepFMs`` surface).

    ``device=None`` means the CUDA device, and raises when there is none; a
    rank of a sharded fit passes its own (``cuda:{local_rank}``, ``cuda:0``
    for ranks that share a card, or ``cpu``). A subclass swaps the model
    family by overriding ``model_forward`` / ``model_init`` / ``model_spec``.

    On a mesh (``mesh_data x mesh_model > 1``), ``fit``, ``save``, ``load``,
    the predictions and the reports are collective: every rank calls them.
    """

    model_forward = staticmethod(deepfwfm.forward)
    model_init = staticmethod(deepfwfm.init_params)
    model_spec = staticmethod(deepfwfm.make_embedding_spec)

    def __init__(self, model_cfg: ModelConfig, train_cfg: TrainConfig, logger=None,
                 device: DeviceLike = None):
        if model_cfg.use_dlrm != (type(self).model_forward is dlrm.forward):
            raise ValueError("DLRM-DCNv2 (use_dlrm) trains through DLRMEstimator, and only it "
                             "(models.factory.get_model picks it)")
        self.mcfg = model_cfg
        self.tcfg = train_cfg
        self.device = resolve_device(device)
        self.logger = logger or get_logger()
        self.params: Optional[Dict] = None
        self.opt_state: Any = None
        self._step = 0
        self.train_result: list = []
        self.valid_result: list = []
        self.epoch_sparsity: list = []
        self.last_epoch_mean_loss: float = float("nan")
        self.last_epoch_losses: List[float] = []  # the last epoch's loss of every step
        self.best_params: Optional[Dict] = None   # filled by fit(keep_best=True)
        self.best_epoch: int = -1
        self.best_valid_auc: float = float("nan")
        # the mesh of a sharded fit (set by _setup_mesh; None: one device)
        self.mesh: Optional[mesh_mod.Mesh] = None
        self._lookup_fn = None      # the exchange's lookup, bound into model_forward
        self._table_axes: mesh_mod.Axes = mesh_mod.MODEL_AXIS
        self._table_shards = 1
        self._batch_both = False
        self._blocks = False        # params and optimizer state hold this rank's row blocks
        # _predict_logits' groups and the batches left over, made on first use
        self._scan_eval: Optional[ScanEval] = None
        self._eval_fn: Optional[EvalFn] = None
        self._fwd: Optional[Tuple[Tuple, ForwardFn]] = None   # forward_fn's, and what it binds

    # ------------------------------------------------------------------ util

    def _log(self, msg: str):
        if not (dist.is_initialized() and dist.get_rank() != 0):   # rank 0 logs
            self.logger.info(msg)

    def init_params(self, seed: Optional[int] = None) -> Dict:
        gen = torch.Generator().manual_seed(self.tcfg.random_seed if seed is None else seed)
        self.params = type(self).model_init(gen, self.mcfg, device=self.device)
        return self.params

    def _log_counts(self, counts: Dict[str, int], word: str = "", indent: str = "") -> None:
        head = f"{indent}Number of {word}"
        self._log(f"{head}1st order embeddings: {counts['first_order_embeddings']:,}")
        self._log(f"{head}2nd order embeddings: {counts['second_order_embeddings']:,}")
        if self.mcfg.use_fwfm:
            self._log(f"{head}2nd order interactions: {counts['field_cov_nonzero_sym']:,}")
        if self.mcfg.use_deep:
            self._log(f"{head}DNN parameters: {counts['dnn']:,}")
        self._log(f"{head}total parameters: {counts['total']:,}")

    # --------------------------------------------------------------- sharding

    def _setup_mesh(self) -> Optional[mesh_mod.Mesh]:
        """The ``(data, model)`` mesh and the lookup exchange of the
        TrainConfig (``-mesh_data``/``-mesh_model``/``-exchange``); None for
        1x1. Raises a ``ValueError`` that says how to launch when the process
        group is missing or has another number of ranks, and one for a model
        with ``use_cin``, whose sharded forward has no CIN. DLRM-DCNv2's bags
        take their own placement (:meth:`_place_tables`)."""
        tc = self.tcfg
        if tc.mesh_data == 1 and tc.mesh_model == 1:
            self._leave_mesh()
            return None
        if self.mcfg.use_cin:
            raise ValueError("a sharded fit does not take use_cin: train xDeepFM on one device "
                             "(-mesh_data 1 -mesh_model 1)")
        data = None if tc.mesh_data == 0 else tc.mesh_data
        mesh = self.mesh
        if mesh is None or mesh.model != tc.mesh_model or data not in (None, mesh.data):
            mesh = mesh_mod.make_mesh(data=data, model=tc.mesh_model, device=self.device)
        self._place_tables(mesh)
        self.mesh = mesh
        return mesh

    def _place_tables(self, mesh: mesh_mod.Mesh) -> None:
        """The lookup exchange and the tables' layout on ``mesh``: one resolver
        for exchange -> (lookup, table layout, batch layout): a2a_grid shards the
        tables over the whole grid, a2a and psum over `model`, and both of these
        fall back to pure data parallelism when model == 1."""
        (self._lookup_fn, self._table_axes, self._table_shards,
         self._batch_both) = es.setup_exchange(mesh, type(self).model_spec(self.mcfg),
                                               self._exchange())

    def _leave_mesh(self) -> None:
        self.mesh, self._lookup_fn = None, None
        self._table_axes, self._table_shards, self._batch_both = mesh_mod.MODEL_AXIS, 1, False

    def unshard(self) -> "DeepFMEstimator":
        """Gather the row blocks of a sharded fit and leave the mesh
        (collective): from then on the estimator predicts, reports, saves and
        benchmarks the whole model on its own device, as after a one-device
        fit. The command-line programs call it on every rank after the fit, so
        that rank 0 measures the model while the others return."""
        if self.mesh is not None:
            self.params, self.opt_state = self.gather_params(), self._full(self.opt_state)
            self._blocks = False
            self._leave_mesh()
        return self

    def _exchange(self) -> str:
        return self.tcfg.exchange

    def _batch_over_both_axes(self) -> bool:
        """The all-to-all exchanges shard the batch over both mesh axes."""
        return self._lookup_fn is not None and self._batch_both

    def _n_batch_shards(self) -> int:
        if self.mesh is None:
            return 1
        return self.mesh.axis_size(self._batch_axes())

    def _batch_axes(self) -> mesh_mod.Axes:
        return mesh_mod.batch_axes(self._batch_over_both_axes())

    def _batch_group(self) -> Optional[mesh_mod.BatchGroup]:
        """The ranks that hold one global batch's rows; None on one device."""
        return None if self.mesh is None else mesh_mod.BatchGroup(self.mesh, self._batch_axes())

    def _shard_state(self) -> None:
        """Pad the dense tables to the shard count and keep this rank's row
        blocks, of the parameters and of the optimizer state."""
        if self._table_shards > 1:
            self.params = self._shard_tree(self.params)
            if self.opt_state is not None:
                self.opt_state = self._shard_tree(self.opt_state)
            self._blocks = True

    def _shard_tree(self, tree: Any) -> Any:
        """This rank's part of a whole tree (parameters or optimizer state)."""
        return mesh_mod.shard_params(tree, self.mesh, self._table_axes)

    def _gather_tree(self, tree: Any) -> Any:
        """Inverse of :meth:`_shard_tree` (collective)."""
        return mesh_mod.gather_params(tree, self.mesh, self._table_axes,
                                      type(self).model_spec(self.mcfg).dense_rows)

    def _full(self, tree: Any) -> Any:
        """``tree`` (parameters or optimizer state) whole and unpadded: as it
        is unless it holds row blocks, which are gathered from every rank
        (collective)."""
        if not self._blocks or tree is None:
            return tree
        return self._gather_tree(tree)

    def gather_params(self) -> Dict:
        """The whole, unpadded parameter tree on every rank (collective on a
        mesh): what ``save`` writes and the ``Predictor`` serves."""
        return self._full(self.params)

    @property
    def forward_fn(self) -> ForwardFn:
        """``model_forward`` with, on a mesh, the exchange's lookup bound and
        a QAT tower's activation abs-max taken over the batch's ranks (the
        JAX estimator's ``forward_fn``). The same function while these stay,
        so that the eval fns keep their graphs."""
        fwd = type(self).model_forward
        key = (fwd, self._lookup_fn, self.mesh, self._batch_axes(), self.mcfg.quantization_aware)
        if self._fwd is None or self._fwd[0] != key:
            kw: Dict[str, Any] = {}
            if self._lookup_fn is not None:
                kw["lookup_fn"] = self._lookup_fn
            if self.mesh is not None and self.mcfg.quantization_aware:
                kw["amax_fn"] = self._batch_group().max
            self._fwd = (key, partial(fwd, **kw) if kw else fwd)
        return self._fwd[1]

    @property
    def eval_fn(self) -> EvalFn:
        """One eval batch a dispatch (:func:`make_eval_fn`) over
        :attr:`forward_fn`, kept while that stays."""
        fwd = self.forward_fn
        if self._eval_fn is None or self._eval_fn.forward_fn is not fwd:
            self._eval_fn = make_eval_fn(self.mcfg, fwd, mesh=self.mesh, axes=self._batch_axes())
        return self._eval_fn

    @property
    def scan_eval_fn(self) -> ScanEval:
        """``EVAL_SCAN_K`` eval batches a dispatch (:func:`make_scan_eval_fn`)
        over :attr:`forward_fn`, kept while that stays."""
        fwd = self.forward_fn
        if self._scan_eval is None or self._scan_eval.forward_fn is not fwd:
            self._scan_eval = make_scan_eval_fn(self.mcfg, fwd, mesh=self.mesh,
                                                axes=self._batch_axes())
        return self._scan_eval

    def _reducer(self) -> Callable[[List[torch.Tensor]], None]:
        """The gradient reduction of this rank's sharded step: each leaf summed
        over the ranks with other rows of the batch for it."""
        shardings = mesh_mod.param_shardings(self.params, self._table_axes)
        return partial(mesh_mod.reduce_gradients, self.mesh, batch=self._batch_axes(),
                       shardings=[sh if self._blocks else None for sh in shardings.values()])

    def _local_batches(self, batches) -> Iterator[Dict]:
        """This rank's rows of each global batch, with the global count of real
        rows that its loss divides by."""
        axes = self._batch_axes()
        for batch in batches:
            batch = {**batch, "count": np.asarray(batch["n_valid"], np.float32)}
            yield mesh_mod.shard_batch(batch, self.mesh, axes, self.tcfg.batch_size)

    def _sparsity_report(self, total: int) -> Dict[str, float]:
        """``sparsity_report`` of the whole model; on sharded tables the blocks'
        non-zero counts are summed over their ranks, and ``total`` is the
        unpadded parameter count."""
        if not self._blocks:
            return sparsity_report(self.params)
        shardings = mesh_mod.param_shardings(self.params, self._table_axes)
        named = list(_tree.named_leaves(self.params))
        table = torch.stack([torch.count_nonzero(t) for n, t in named if shardings[n]]).sum()
        rest = torch.stack([torch.count_nonzero(t) for n, t in named if not shardings[n]]).sum()
        nonzero = int(self.mesh.all_reduce(table, self._table_axes) + rest)
        return {"total": total, "nonzero": nonzero,
                "sparsity_pct": 100.0 * (1.0 - nonzero / max(total, 1))}

    # ------------------------------------------------------------------- fit

    def fit(self, Xi_train, Xv_train, y_train, Xi_valid=None, Xv_valid=None,
            y_valid=None, *, early_stopping: bool = False, save_path: Optional[str] = None,
            prune: Optional[bool] = None, prune_fm: Optional[bool] = None,
            prune_r: Optional[bool] = None, prune_deep: Optional[bool] = None,
            emb_r: Optional[float] = None, emb_corr: Optional[float] = None,
            teacher_model: Optional["DeepFMEstimator"] = None,
            resume_from: Optional[str] = None,
            keep_best: bool = False) -> "DeepFMEstimator":
        """Train. Xi (N, C[, 1]) int indices of the categorical fields, Xv
        (N, Nnum) float values, y (N,) labels, as the reference ``fit``.
        On a mesh every rank passes the same arrays: the ranks shuffle alike
        and each steps on its rows of every batch.

        ``resume_from``: a checkpoint path; restores params, optimizer state
        and epoch counter and continues training.

        ``keep_best``: keep host copies of the params at the epoch of the best
        valid AUC in ``self.best_params`` / ``self.best_epoch``.

        At the default ``steps_per_call=1`` each batch is one call of
        :func:`make_train_step` and each refresh one of :class:`PruneRefresh`,
        as the JAX ``fit`` calls its jitted step and ``prune_params``: on the
        card one CUDA graph replay each (over NCCL on a mesh; over gloo eager).
        Inside ``utils.debug.nan_debugging`` they run eagerly, each loss
        checked as it comes.

        ``steps_per_call > 1`` steps K batches a dispatch through
        :func:`make_multi_step`, as the JAX ``fit`` does (``:464-560``): K is
        ``prune_interval`` when pruning, and each group of K batches ends in
        the refresh that the per-batch schedule makes there; the teacher's
        logits are stacked into the same groups. On the card a group is one
        CUDA graph replay, the last group of fewer real batches too (a graph
        of its own, captured once a fit). The parameters, the losses and the schedule
        are those of ``steps_per_call=1``. On a mesh each rank stacks its
        rows of the global batches, with their global real-row counts, and a
        group is one replay on every rank over NCCL, the K steps eager over
        gloo (its collectives cannot be captured): ``fit``'s mesh line says
        which."""
        tc = self.tcfg
        do_prune = tc.prune if prune is None else bool(prune)
        prune_kw = dict(
            emb_r=tc.emb_r if emb_r is None else float(emb_r),
            emb_corr=tc.emb_corr if emb_corr is None else float(emb_corr),
            prune_fm=(tc.prune_fm if prune_fm is None else bool(prune_fm)) and self.mcfg.needs_emb2,
            prune_deep=tc.prune_deep if prune_deep is None else bool(prune_deep),
            prune_r=(tc.prune_r if prune_r is None else bool(prune_r)) and self.mcfg.use_fwfm,
            structured_deep=tc.prune_deep_structured)

        Xi_train = np.asarray(Xi_train, dtype=np.int32).reshape(-1, self.mcfg.index_columns)
        Xv_train = np.asarray(Xv_train, dtype=np.float32)
        y_train = np.asarray(y_train, dtype=np.float32).ravel()
        is_valid = Xi_valid is not None and len(Xi_valid) > 0
        if is_valid:
            Xi_valid = np.asarray(Xi_valid, dtype=np.int32).reshape(-1, self.mcfg.index_columns)
            Xv_valid = np.asarray(Xv_valid, dtype=np.float32)
            y_valid = np.asarray(y_valid, dtype=np.float32).ravel()

        self._log("init_weights")
        if self._blocks:            # a sharded fit before this one left row blocks
            self.params, self._blocks = self.gather_params(), False
        if self.params is None:
            self.init_params()

        optimizer = make_optimizer(tc)
        self.opt_state = optimizer.init(self.params)
        start_epoch = 0
        if resume_from is not None:
            self.params, self.opt_state, meta = ckpt.load_checkpoint(
                resume_from, self.params, self.opt_state, device=self.device)
            self._step = meta.get("step", 0)
            start_epoch = meta.get("epoch", -1) + 1
            self._log(f"resumed from {resume_from} at epoch {start_epoch}")

        mesh = self._setup_mesh()
        n_shards = self._n_batch_shards()
        if mesh is not None:
            if tc.batch_size % n_shards:
                raise ValueError(
                    f"batch_size {tc.batch_size} not divisible by the {n_shards} batch shards of "
                    f"mesh (data={mesh.data}, model={mesh.model}) with "
                    f"exchange={self._exchange()!r}")
        forward_fn = self.forward_fn
        counts = deepfwfm.param_group_counts(self.params, self.mcfg)
        self._log("========")
        self._log(f"Summation of feature sizes: {sum(self.mcfg.feature_sizes):,}")
        self._log_counts(counts)
        self._log("========")
        num_total_original = counts["total"]

        rng_np = np.random.default_rng(tc.random_seed)
        generator = torch.Generator(device=self.device).manual_seed(tc.random_seed + 1)
        step_generator: Any = generator
        reduce, group = None, self._batch_group()
        # K steps a dispatch: K = prune_interval when pruning, so that each group ends
        # in the refresh the per-batch schedule makes there
        k_steps = tc.steps_per_call if tc.steps_per_call > 1 else 1
        fuse_prune = do_prune and k_steps > 1
        if fuse_prune:
            k_steps = tc.prune_interval
        if mesh is not None:
            self._shard_state()
            form = ("" if k_steps == 1 else f", {k_steps} steps a replay" if mesh.capturable
                    else f", {k_steps} steps eager a group ({mesh.backend} collectives cannot "
                         f"be captured)")
            self._log(f"mesh: data={mesh.data} model={mesh.model} exchange={self._exchange()} "
                      f"({mesh.size} ranks, backend {mesh.backend}, rank 0 on {self.device})"
                      + form)
            reduce = self._reducer()
            step_generator = BatchShard(generator, tc.batch_size, mesh_mod.batch_rows(
                mesh, self._batch_axes(), tc.batch_size).start)
            if self._table_shards > 1 and do_prune:
                prune_kw.update(mesh=mesh, table_axes=self._table_axes,
                                dense_rows=type(self).model_spec(self.mcfg).dense_rows)
        step_kw = dict(use_kd=teacher_model is not None, forward_fn=forward_fn, mesh=mesh,
                       reduce=reduce, group=group)
        if k_steps > 1:
            multi_step = make_multi_step(self.mcfg, tc, optimizer, **step_kw)
            multi_prune = (make_multi_step(self.mcfg, tc, optimizer, prune_kw=prune_kw, **step_kw)
                           if fuse_prune else None)
        elif debug.finite_checks_enabled():
            # nan_debugging asks for every step's loss to be checked as it comes, under
            # autograd's anomaly detection (as jax_debug_nans makes JAX run op by op): the
            # steps and refreshes run eagerly, the one eager route on the card
            def one_step(params, opt_state, batch, generator):
                return train_step(params, opt_state, batch, self.mcfg, tc, optimizer,
                                  reduce=reduce, generator=generator,
                                  teacher_logits=batch.get("teacher"), forward_fn=forward_fn,
                                  group=group)
            refresh = partial(prune_params_, **prune_kw)
        else:               # one graph replay a step, and one a refresh, on the card
            one_step = make_train_step(self.mcfg, tc, optimizer, **step_kw)
            refresh = PruneRefresh(prune_kw, mesh)
        n_iter = 0
        self.train_result, self.valid_result = [], []
        # total sparsity % per epoch, parallel to train_result / valid_result
        self.epoch_sparsity = []
        n_train = Xi_train.shape[0]

        for epoch in range(start_epoch, tc.n_epochs):
            epoch_begin = time.time()
            epoch_losses = []

            teacher_logits_all = None
            if teacher_model is not None:
                t0 = time.time()
                teacher_logits_all = teacher_model._predict_logits(Xi_train, Xv_train)
                self._log(f"- Finished computing teacher outputs after {time.time() - t0:.0f} secs..")

            batches = batching.iter_batches(Xi_train, Xv_train, y_train, tc.batch_size)
            if teacher_logits_all is not None:
                batches = _with_teacher(batches, teacher_logits_all, tc.batch_size)
            if mesh is not None:
                batches = self._local_batches(batches)
            if k_steps > 1:
                prune_now = fuse_prune and epoch >= tc.warm
                groups = batching.stack_groups(batches, k_steps)
                for stacked in batching.prefetch_to_device(groups, self.device):
                    k_real = stacked["k_real"]
                    if epoch >= tc.warm:
                        n_iter += k_real
                    step = multi_prune if prune_now else multi_step
                    losses = step(self.params, self.opt_state, stacked["xi"], stacked["xv"],
                                  stacked["y"], stacked["mask"], step_generator,
                                  stacked.get("teacher"),
                                  tc.adaptive_sparse(n_iter) if prune_now else None,
                                  k_real=k_real, count_k=stacked.get("count"))[:k_real]
                    epoch_losses.append(losses)
                    if debug.finite_checks_enabled():
                        debug.require_finite(losses, f"the losses of steps {self._step} on")
                    self._step += k_real
            else:
                for i_batch, batch in enumerate(batching.prefetch_to_device(batches, self.device)):
                    if epoch >= tc.warm:
                        n_iter += 1
                    # the loss stays on the device: reading it here would make the host
                    # wait for every step. It is fetched once, at the end of the epoch
                    epoch_losses.append(one_step(self.params, self.opt_state, batch,
                                                 step_generator))
                    if debug.finite_checks_enabled():
                        debug.require_finite(epoch_losses[-1], f"the loss of step {self._step}")
                    self._step += 1

                    # DeepLight pruning inside the loop: after every prune_interval real
                    # batches and after the last one, n_iter counting post-warm-up batches
                    is_last = (i_batch + 1) * tc.batch_size >= n_train
                    if do_prune and epoch >= tc.warm and (
                            is_last or i_batch % tc.prune_interval == tc.prune_interval - 1):
                        refresh(self.params, tc.adaptive_sparse(n_iter))

            if epoch_losses:   # the epoch's one read of the losses
                losses = torch.cat([l.reshape(-1) for l in epoch_losses])
                if mesh is not None:        # each rank's share of every step's mean
                    mesh.all_reduce(losses, self._batch_axes())
                self.last_epoch_losses = losses.tolist()
                self.last_epoch_mean_loss = sum(self.last_epoch_losses) / len(losses)
                self.logger.debug("epoch %d mean train-step loss: %.6f"
                                  % (epoch + 1, self.last_epoch_mean_loss))
            rep = self._sparsity_report(num_total_original)
            self.epoch_sparsity.append(rep["sparsity_pct"])
            self._log("Model parameters %d, sparse rate %.2f%%"
                      % (rep["nonzero"], rep["sparsity_pct"]))
            n_te = tc.eval_train_rows or n_train
            train_loss, train_auc, train_prauc, train_rce = self.eval_by_batch(
                Xi_train[:n_te], Xv_train[:n_te], y_train[:n_te])
            self.train_result.append(train_auc)
            self._log("Training [%d] loss: %.6f metric: %.6f prauc: %.4f rce: %.2f "
                      "sparse %.2f%% time: %.1f s"
                      % (epoch + 1, train_loss, train_auc, train_prauc, train_rce,
                         rep["sparsity_pct"], time.time() - epoch_begin))
            if is_valid:
                vl, va, vp, vr = self.eval_by_batch(Xi_valid, Xv_valid, y_valid)
                self.valid_result.append(va)
                self._log("Validation [%d] loss: %.6f metric: %.6f prauc: %.4f rce: %.2f "
                          "sparse %.2f%% time: %.1f s"
                          % (epoch + 1, vl, va, vp, vr, rep["sparsity_pct"],
                             time.time() - epoch_begin))
                if keep_best and va >= max(self.valid_result):
                    self.best_params = _tree.tree_map(lambda t: t.detach().cpu().clone(),
                                                      self.gather_params())
                    self.best_epoch = epoch
                    self.best_valid_auc = va
            self._log("*" * 50)

            Xi_train, Xv_train, y_train = batching.shuffle_arrays(
                rng_np, Xi_train, Xv_train, y_train)

            if save_path:
                # pruned runs store mostly-zero arrays in COO form
                self.save(save_path, epoch=epoch, sparse=do_prune)
            if is_valid and early_stopping and self.training_termination(self.valid_result):
                self._log("early stop at [%d] epoch!" % (epoch + 1))
                break

        if do_prune:
            counts = deepfwfm.param_group_counts(self.gather_params(), self.mcfg, nonzero=True)
            self._log("========")
            self._log_counts(counts, "pruned ")
            self._log(f"Non pruned model parameters: \t{num_total_original:,}")
            self._log(f"Pruned Parameters: \t{num_total_original - counts['total']:,}")
            self._log("========")
        ckpt.wait_for_saves()
        return self

    # ------------------------------------------------------------------ eval

    @torch.inference_mode()
    def _predict_logits(self, Xi: np.ndarray, Xv: np.ndarray,
                        batch_size: Optional[int] = None) -> np.ndarray:
        """Batched eval-mode forward with a padded tail → logits on the host.
        Every batch is issued before the one copy back. The full groups of
        ``EVAL_SCAN_K`` batches go through the scanned eval, the rest batch
        by batch through the eval fn, the tail padded to ``bs``, as the JAX
        package's (``:696-726``): on the card each a CUDA graph replay (over
        NCCL on a mesh). On a mesh the batch is rounded up to the shard
        count, each rank runs its rows, and the logits are gathered, so every
        rank returns them all."""
        bs = batch_size or (self.tcfg.eval_batch_size * (2 if self.mcfg.use_ffm else 1))
        n_shards = self._n_batch_shards()
        bs = -(-bs // n_shards) * n_shards
        Xi = np.asarray(Xi, dtype=np.int32).reshape(-1, self.mcfg.index_columns)
        Xv = np.asarray(Xv, dtype=np.float32).reshape(Xi.shape[0], -1)
        axes = self._batch_axes()
        rows = slice(None) if self.mesh is None else mesh_mod.batch_rows(self.mesh, axes, bs)
        k = EVAL_SCAN_K
        pos = Xi.shape[0] // (k * bs) * (k * bs)
        scan_eval, eval_fn = self.scan_eval_fn, self.eval_fn
        groups = ({"xi": Xi[lo:lo + k * bs].reshape(k, bs, -1)[:, rows],
                   "xv": Xv[lo:lo + k * bs].reshape(k, bs, -1)[:, rows]}
                  for lo in range(0, pos, k * bs))
        out = [scan_eval(self.params, group["xi"], group["xv"]).reshape(-1)
               for group in batching.prefetch_to_device(groups, self.device)]
        Xi, Xv = Xi[pos:], Xv[pos:]
        dummy_y = np.zeros(Xi.shape[0], dtype=np.float32)
        batches = batching.iter_batches(Xi, Xv, dummy_y, bs)
        if self.mesh is not None:
            batches = (mesh_mod.shard_batch(b, self.mesh, axes, bs) for b in batches)
        for batch in batching.prefetch_to_device(batches, self.device):
            out.append(eval_fn(self.params, batch["xi"], batch["xv"])[:batch["n_valid"]])
        return torch.cat(out).cpu().numpy() if out else np.zeros((0,), np.float32)

    def eval_by_batch(self, Xi, Xv, y) -> Tuple[float, float, float, float]:
        """(logloss, AUC, PRAUC, RCE) in float64 on the host."""
        y = np.asarray(y, dtype=np.float64).ravel()
        logits = self._predict_logits(Xi, Xv).astype(np.float64)
        pred = 1.0 / (1.0 + np.exp(-logits))
        loss = M.bce_logits_sum(y, logits) / max(len(y), 1)
        return (loss, M.roc_auc(y, pred), M.prauc(pred, y), M.rce(pred, y))

    # ------------------------------------------------- prediction API parity

    def predict(self, Xi, Xv) -> np.ndarray:
        return self.predict_proba(Xi, Xv) > 0.5

    def predict_proba(self, Xi, Xv) -> np.ndarray:
        logits = self._predict_logits(Xi, Xv).astype(np.float64)
        return 1.0 / (1.0 + np.exp(-logits))

    inner_predict = predict
    inner_predict_proba = predict_proba

    def evaluate(self, Xi, Xv, y) -> float:
        return M.roc_auc(np.asarray(y, np.float64).ravel(), self.predict_proba(Xi, Xv))

    def training_termination(self, valid_result) -> bool:
        """Three consecutive declines."""
        if len(valid_result) > 4:
            last = valid_result[-4:]
            if self.tcfg.greater_is_better:
                return last[3] < last[2] < last[1] < last[0]
            return last[3] > last[2] > last[1] > last[0]
        return False

    # ---------------------------------------------------------- persistence

    def save(self, path: str, epoch: int = 0, sparse: bool = False):
        """Write the checkpoint. On a mesh the tree is gathered and unpadded,
        so that it loads into any mesh shape and into either package; rank 0
        writes it and every rank waits for that."""
        params, opt_state = self.gather_params(), self._full(self.opt_state)
        if self.mesh is None or self.mesh.rank == 0:
            ckpt.save_checkpoint(path, params, opt_state, step=self._step,
                                 epoch=epoch, sparse=sparse,
                                 backend=self.tcfg.checkpoint_backend, metadata={
                                     "model": self.mcfg.model_name,
                                     "field_size": self.mcfg.field_size,
                                     "sparse": self.tcfg.sparse,
                                     "seed": self.tcfg.random_seed})
        if self.mesh is not None:
            self.mesh.barrier()

    def load(self, path: str, strict: bool = True):
        """Read the whole checkpoint (on every rank of a mesh, which keeps its
        own blocks)."""
        if self.params is None:
            self.init_params()      # with strict=False, missing entries keep these values
        self.params, _, meta = ckpt.load_checkpoint(path, self.gather_params(), strict=strict,
                                                    device=self.device)
        if self.mesh is not None and self._table_shards > 1:
            self.params = self._shard_tree(self.params)
            self._blocks = True
        self._step = meta.get("step", 0)
        return self

    def run_benchmark(self, Xi, Xv, y, batch_size: int = 8192, cuda: bool = False,
                      quantization_aware: bool = False, trace_dir: Optional[str] = None):
        """Reference ``run_benchmark`` parity (``model/DeepFMs.py:947-1009``):
        quality metrics, a profiler trace, batch timing and one-example
        latency, on the estimator's device. A QAT model is converted to a true
        int8 model first (reference ``:751-755, :968-971``). ``cuda`` is
        accepted for API compatibility and ignored. A sharded model is
        gathered first and served whole on each rank."""
        # here, as the JAX package imports them: serving.benchmark imports this package
        from ..serving.benchmark import run_benchmark
        from ..serving.predictor import Predictor
        params = self.gather_params()
        if quantization_aware or self.mcfg.quantization_aware:
            predictor = Predictor(convert(params, self.mcfg, mode="qat"), device=self.device)
        else:
            predictor = Predictor(params, self.mcfg, device=self.device)
        return run_benchmark(predictor, Xi, Xv, y, batch_size=batch_size,
                             trace_dir=trace_dir, logger=self.logger)

    def print_size_of_model(self) -> int:
        params = self.gather_params()
        size = ckpt.model_size_bytes(params)
        self._log("========")
        self._log("MODEL SIZE")
        self._log("\tSize (MB):\t" + str(size / 1e6))
        counts = deepfwfm.param_group_counts(params, self.mcfg, nonzero=True)
        orig = deepfwfm.param_group_counts(params, self.mcfg, nonzero=False)
        self._log(f"\tSummation of feature sizes: {sum(self.mcfg.feature_sizes):,}")
        self._log_counts(counts, indent="\t")
        self._log(f"\tNon pruned model parameters: \t{orig['total']:,}")
        self._log(f"\tPruned Parameters: \t{orig['total'] - counts['total']:,}")
        self._log("========")
        return size


class DLRMEstimator(DeepFMEstimator):
    """DLRM-DCNv2 (``use_dlrm``, :mod:`..models.dlrm`) with the estimator's
    surface: ``fit`` steps its bags' Adagrad on the batch's rows alone, eval
    and ``predict`` run its forward, ``save`` and ``load`` its leaves. It
    trains with ``adag`` and no weight decay, unpruned and without a teacher:
    ``fit`` refuses the rest, each with a ``ValueError`` that says why.

    On a ``-mesh_data N`` mesh (``-mesh_model 1``) the batch is split over the
    ranks and the bags are placed as ``parallel/bag_sharding`` says: the tables
    of more than ``-bag_row_wise_rows`` rows row-wise over every rank, the
    others whole on each, the dense leaves whole on each with their gradients
    all-reduced; a step is the one-process step of the global batch.
    ``unshard`` gathers the tables where the device holds them whole and raises
    where it cannot, naming the sizes."""

    model_forward = staticmethod(dlrm.forward)
    model_init = staticmethod(dlrm.init_params)
    model_spec = staticmethod(dlrm.make_bag_spec)

    def _setup_mesh(self) -> Optional[mesh_mod.Mesh]:
        if self.tcfg.mesh_model != 1:
            raise ValueError(f"DLRM-DCNv2's bags take a mesh of -mesh_data ranks alone (row-wise "
                             f"tables over every rank, the batch split over them): set "
                             f"-mesh_model 1, not {self.tcfg.mesh_model}")
        return super()._setup_mesh()

    def _place_tables(self, mesh: mesh_mod.Mesh) -> None:
        self._bags = ShardedBags(mesh, dlrm.make_bag_spec(self.mcfg),
                                 self.mcfg.bag_row_wise_rows)
        self._lookup_fn, self._table_axes = self._bags.lookup, mesh_mod.GRID_AXES
        self._table_shards, self._batch_both = mesh.size, False

    def _exchange(self) -> str:
        return f"bags row-wise over {self.mcfg.bag_row_wise_rows:,} rows"

    def _shard_tree(self, tree: Any) -> Any:
        return self._bags.shard(tree)

    def _gather_tree(self, tree: Any) -> Any:
        return self._bags.gather(tree)

    def _reducer(self) -> Callable[[List[torch.Tensor]], None]:
        return self._bags.reduce

    def _sparsity_report(self, total: int) -> Dict[str, float]:
        if not self._blocks:
            return sparsity_report(self.params)
        p, named = self._bags.placement, list(_tree.named_leaves(self.params))
        table = next(t for n, t in named if dlrm.is_bag_state(n))
        nonzero = int(self.mesh.all_reduce(torch.count_nonzero(table[p.whole_rows:]),
                                           mesh_mod.GRID_AXES)
                      + torch.count_nonzero(table[:p.whole_rows])
                      + sum(torch.count_nonzero(t) for n, t in named if not dlrm.is_bag_state(n)))
        return {"total": total, "nonzero": nonzero,
                "sparsity_pct": 100.0 * (1.0 - nonzero / max(total, 1))}

    def fit(self, *args, prune: Optional[bool] = None,
            teacher_model: Optional[DeepFMEstimator] = None, **kw) -> "DLRMEstimator":
        if (self.tcfg.prune if prune is None else prune):
            raise ValueError("the prune refresh does not take use_dlrm: DeepLight prunes "
                             "one-hot tables, FwFM's R and the tower, which DLRM-DCNv2 lacks")
        if teacher_model is not None:
            raise ValueError("distillation does not take use_dlrm: train DLRM-DCNv2 on its labels")
        if self.tcfg.optimizer_type != "adag" or self.tcfg.weight_decay:
            raise ValueError("DLRM-DCNv2's bags train with adag and no weight decay "
                             "(-optimizer_type adag -l2 0)")
        return super().fit(*args, prune=prune, teacher_model=teacher_model, **kw)


def _with_teacher(batches, teacher_logits: np.ndarray, batch_size: int):
    """Add each batch's slice of the teacher's logits, zero-padded like the
    batch's tail."""
    for i, batch in enumerate(batches):
        t = teacher_logits[i * batch_size:(i + 1) * batch_size].astype(np.float32)
        if t.shape[0] < batch_size:
            t = np.concatenate([t, np.zeros(batch_size - t.shape[0], np.float32)])
        yield {**batch, "teacher": t}
