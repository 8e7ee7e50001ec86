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
``utils.debug.nan_debugging`` block every step's loss is checked with
``isfinite``, which does read it.

Not ported, because they are dispatch and layout forms with the same
results: the K-steps-per-dispatch scan (``:88-159``), the scanned eval
(``:171-195``) and super-row table packing. ``steps_per_call > 1`` runs plain
per-batch steps on the same prune schedule, and ``table_layout="super"``
trains the flat table. A mesh other than 1x1 raises until the sharding slice.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import _tree
from ..compression.distillation import kd_loss
from ..compression.pruning import prune_params, sparsity_report
from ..compression.quantization import convert
from ..config import ModelConfig, TrainConfig
from ..data import batching
from ..device import DeviceLike, resolve_device
from ..models import deepfwfm
from ..serving.benchmark import run_benchmark
from ..serving.predictor import Predictor
from ..utils import debug
from ..utils.logging import get_logger
from . import checkpoint as ckpt
from . import metrics as M

_SLOTS = {"adam": ("mu", "nu"), "rmsp": ("nu",), "adag": ("sum_of_squares",)}


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
        g = torch._foreach_add(grads, p, alpha=self.wd) if self.wd else list(grads)
        if self.kind == "adam":
            b1, b2, eps = 0.9, 0.999, 1e-8
            mu, nu = _tree.leaves(slots["mu"]), _tree.leaves(slots["nu"])
            count = slots["count"].add_(1)
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, g, alpha=1 - b1)
            torch._foreach_mul_(nu, b2)
            torch._foreach_add_(nu, torch._foreach_mul(g, g), alpha=1 - b2)
            upd = torch._foreach_div(mu, 1 - torch.pow(b1, count))
            den = torch._foreach_div(nu, 1 - torch.pow(b2, count))
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, eps)
            torch._foreach_div_(upd, den)
        elif self.kind == "rmsp":
            decay, eps = 0.99, 1e-8
            nu = _tree.leaves(slots["nu"])
            torch._foreach_mul_(nu, decay)
            torch._foreach_add_(nu, torch._foreach_mul(g, g), alpha=1 - decay)
            upd = torch._foreach_add(nu, eps)
            torch._foreach_sqrt_(upd)
            torch._foreach_reciprocal_(upd)
            torch._foreach_mul_(upd, g)
        elif self.kind == "adag":
            eps = 1e-10
            acc = _tree.leaves(slots["sum_of_squares"])
            torch._foreach_add_(acc, torch._foreach_mul(g, g))
            upd = [torch.where(a > 0, torch.rsqrt(a + eps), torch.zeros_like(a)) * x
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


def batch_loss(params: Dict, batch: Dict, mcfg: ModelConfig, tcfg: TrainConfig, *,
               generator: Optional[torch.Generator] = None,
               teacher_logits: Optional[torch.Tensor] = None,
               forward_fn: ForwardFn = deepfwfm.forward) -> torch.Tensor:
    """The train-mode loss of one batch: the masked mean BCE (the per-batch
    ``binary_cross_entropy_with_logits`` mean on an unpadded batch), or the
    KD loss when the teacher's logits are given."""
    logits = forward_fn(params, batch["xi"], batch["xv"], mcfg, train=True, generator=generator)
    y, mask = batch["y"], batch["mask"]
    if teacher_logits is not None:
        return kd_loss(logits, teacher_logits, y, mask, alpha=tcfg.kd_alpha,
                       temperature=tcfg.kd_temperature)
    elem = F.binary_cross_entropy_with_logits(logits, y, reduction="none")
    return (elem * mask).sum() / mask.sum().clamp(min=1.0)


def loss_and_grads(params: Dict, batch: Dict, mcfg: ModelConfig, tcfg: TrainConfig,
                   **loss_kw) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """(loss, one gradient per leaf of ``params`` in ``_tree.leaves`` order).
    A parameter the loss does not reach gets zeros, so that L2 still decays
    it. ``params`` itself is left without ``requires_grad``."""
    leaves = [p.detach().requires_grad_(True) for p in _tree.leaves(params)]
    it = iter(leaves)
    live = _tree.tree_map(lambda _: next(it), params)
    loss = batch_loss(live, batch, mcfg, tcfg, **loss_kw)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), [torch.zeros_like(p) if g is None else g
                           for p, g in zip(leaves, grads)]


def train_step(params: Dict, opt_state: Any, batch: Dict, mcfg: ModelConfig,
               tcfg: TrainConfig, optimizer: Optimizer, **loss_kw) -> torch.Tensor:
    """One optimizer step, in place on ``params`` and ``opt_state``. Returns
    the loss as a 0-d tensor on the device."""
    loss, grads = loss_and_grads(params, batch, mcfg, tcfg, **loss_kw)
    optimizer.update(params, grads, opt_state)
    return loss


class DeepFMEstimator:
    """sklearn-estimator-shaped wrapper (the reference ``DeepFMs`` surface).

    ``device=None`` means the CUDA device, and raises when there is none.
    A subclass swaps the model family by overriding ``model_forward`` /
    ``model_init`` / ``model_spec``.
    """

    model_forward = staticmethod(deepfwfm.forward)
    model_init = staticmethod(deepfwfm.init_params)
    model_spec = staticmethod(deepfwfm.make_embedding_spec)

    def __init__(self, model_cfg: ModelConfig, train_cfg: TrainConfig, logger=None,
                 device: DeviceLike = None):
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

    # ------------------------------------------------------------------ util

    def _log(self, msg: str):
        self.logger.info(msg)

    def init_params(self, seed: Optional[int] = None) -> Dict:
        gen = torch.Generator().manual_seed(self.tcfg.random_seed if seed is None else seed)
        self.params = type(self).model_init(gen, self.mcfg, device=self.device)
        return self.params

    def _require_single_device(self):
        if self.tcfg.mesh_data != 1 or self.tcfg.mesh_model != 1:
            raise NotImplementedError(
                f"mesh_data={self.tcfg.mesh_data}, mesh_model={self.tcfg.mesh_model}: sharded "
                "training comes with the sharding slice (ROADMAP.md queue 1); use 1 and 1")

    def _log_counts(self, counts: Dict[str, int], word: str = "", indent: str = "") -> None:
        head = f"{indent}Number of {word}"
        self._log(f"{head}1st order embeddings: {counts['first_order_embeddings']:,}")
        self._log(f"{head}2nd order embeddings: {counts['second_order_embeddings']:,}")
        if self.mcfg.use_fwfm:
            self._log(f"{head}2nd order interactions: {counts['field_cov_nonzero_sym']:,}")
        if self.mcfg.use_deep:
            self._log(f"{head}DNN parameters: {counts['dnn']:,}")
        self._log(f"{head}total parameters: {counts['total']:,}")

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

        ``resume_from``: a checkpoint path; restores params, optimizer state
        and epoch counter and continues training.

        ``keep_best``: keep host copies of the params at the epoch of the best
        valid AUC in ``self.best_params`` / ``self.best_epoch``."""
        tc = self.tcfg
        self._require_single_device()
        do_prune = tc.prune if prune is None else bool(prune)
        prune_kw = dict(
            emb_r=tc.emb_r if emb_r is None else float(emb_r),
            emb_corr=tc.emb_corr if emb_corr is None else float(emb_corr),
            prune_fm=(tc.prune_fm if prune_fm is None else bool(prune_fm)) and self.mcfg.needs_emb2,
            prune_deep=tc.prune_deep if prune_deep is None else bool(prune_deep),
            prune_r=(tc.prune_r if prune_r is None else bool(prune_r)) and self.mcfg.use_fwfm,
            structured_deep=tc.prune_deep_structured)

        Xi_train = np.asarray(Xi_train, dtype=np.int32).reshape(-1, self.mcfg.num_categorical)
        Xv_train = np.asarray(Xv_train, dtype=np.float32)
        y_train = np.asarray(y_train, dtype=np.float32).ravel()
        is_valid = Xi_valid is not None and len(Xi_valid) > 0
        if is_valid:
            Xi_valid = np.asarray(Xi_valid, dtype=np.int32).reshape(-1, self.mcfg.num_categorical)
            Xv_valid = np.asarray(Xv_valid, dtype=np.float32)
            y_valid = np.asarray(y_valid, dtype=np.float32).ravel()

        self._log("init_weights")
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

        forward_fn = type(self).model_forward
        counts = deepfwfm.param_group_counts(self.params, self.mcfg)
        self._log("========")
        self._log(f"Summation of feature sizes: {sum(self.mcfg.feature_sizes):,}")
        self._log_counts(counts)
        self._log("========")
        num_total_original = counts["total"]

        rng_np = np.random.default_rng(tc.random_seed)
        generator = torch.Generator(device=self.device).manual_seed(tc.random_seed + 1)
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
            for i_batch, batch in enumerate(batching.prefetch_to_device(batches, self.device)):
                if epoch >= tc.warm:
                    n_iter += 1
                # the loss stays on the device: reading it here would make the host
                # wait for every step. It is fetched once, at the end of the epoch
                epoch_losses.append(train_step(
                    self.params, self.opt_state, batch, self.mcfg, tc, optimizer,
                    generator=generator, teacher_logits=batch.get("teacher"),
                    forward_fn=forward_fn))
                if debug.finite_checks_enabled():
                    debug.require_finite(epoch_losses[-1], f"the loss of step {self._step}")
                self._step += 1

                # DeepLight pruning inside the loop: after every prune_interval real
                # batches and after the last one, n_iter counting post-warm-up batches
                is_last = (i_batch + 1) * tc.batch_size >= n_train
                if do_prune and epoch >= tc.warm and (
                        is_last or i_batch % tc.prune_interval == tc.prune_interval - 1):
                    self.params = prune_params(self.params, tc.adaptive_sparse(n_iter),
                                               **prune_kw)

            if epoch_losses:   # the epoch's one read of the losses
                self.last_epoch_losses = torch.stack(epoch_losses).tolist()
                self.last_epoch_mean_loss = sum(self.last_epoch_losses) / len(epoch_losses)
                self.logger.debug("epoch %d mean train-step loss: %.6f"
                                  % (epoch + 1, self.last_epoch_mean_loss))
            rep = sparsity_report(self.params)
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
                                                      self.params)
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
            counts = deepfwfm.param_group_counts(self.params, self.mcfg, nonzero=True)
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
        Every batch is issued before the one copy back."""
        bs = batch_size or (self.tcfg.eval_batch_size * (2 if self.mcfg.use_ffm else 1))
        Xi = np.asarray(Xi, dtype=np.int32).reshape(-1, self.mcfg.num_categorical)
        Xv = np.asarray(Xv, dtype=np.float32).reshape(Xi.shape[0], -1)
        forward_fn = type(self).model_forward
        dummy_y = np.zeros(Xi.shape[0], dtype=np.float32)
        out = [forward_fn(self.params, batch["xi"], batch["xv"], self.mcfg)[:batch["n_valid"]]
               for batch in batching.prefetch_to_device(
                   batching.iter_batches(Xi, Xv, dummy_y, bs), self.device)]
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
        ckpt.save_checkpoint(path, self.params, self.opt_state, step=self._step,
                             epoch=epoch, sparse=sparse,
                             backend=self.tcfg.checkpoint_backend, metadata={
                                 "model": self.mcfg.model_name,
                                 "field_size": self.mcfg.field_size,
                                 "sparse": self.tcfg.sparse,
                                 "seed": self.tcfg.random_seed})

    def load(self, path: str, strict: bool = True):
        if self.params is None:
            self.init_params()      # with strict=False, missing entries keep these values
        self.params, _, meta = ckpt.load_checkpoint(path, self.params, strict=strict,
                                                    device=self.device)
        self._step = meta.get("step", 0)
        return self

    def run_benchmark(self, Xi, Xv, y, batch_size: int = 8192, cuda: bool = False,
                      quantization_aware: bool = False, trace_dir: Optional[str] = None):
        """Reference ``run_benchmark`` parity (``model/DeepFMs.py:947-1009``):
        quality metrics, a profiler trace, batch timing and one-example
        latency, on the estimator's device. A QAT model is converted to a true
        int8 model first (reference ``:751-755, :968-971``). ``cuda`` is
        accepted for API compatibility and ignored."""
        if quantization_aware or self.mcfg.quantization_aware:
            predictor = Predictor(convert(self.params, self.mcfg, mode="qat"),
                                  device=self.device)
        else:
            predictor = Predictor(self.params, self.mcfg, device=self.device)
        return run_benchmark(predictor, Xi, Xv, y, batch_size=batch_size,
                             trace_dir=trace_dir, logger=self.logger)

    def print_size_of_model(self) -> int:
        size = ckpt.model_size_bytes(self.params)
        self._log("========")
        self._log("MODEL SIZE")
        self._log("\tSize (MB):\t" + str(size / 1e6))
        counts = deepfwfm.param_group_counts(self.params, self.mcfg, nonzero=True)
        orig = deepfwfm.param_group_counts(self.params, self.mcfg, nonzero=False)
        self._log(f"\tSummation of feature sizes: {sum(self.mcfg.feature_sizes):,}")
        self._log_counts(counts, indent="\t")
        self._log(f"\tNon pruned model parameters: \t{orig['total']:,}")
        self._log(f"\tPruned Parameters: \t{orig['total'] - counts['total']:,}")
        self._log("========")
        return size


def _with_teacher(batches, teacher_logits: np.ndarray, batch_size: int):
    """Add each batch's slice of the teacher's logits, zero-padded like the
    batch's tail."""
    for i, batch in enumerate(batches):
        t = teacher_logits[i * batch_size:(i + 1) * batch_size].astype(np.float32)
        if t.shape[0] < batch_size:
            t = np.concatenate([t, np.zeros(batch_size - t.shape[0], np.float32)])
        yield {**batch, "teacher": t}
