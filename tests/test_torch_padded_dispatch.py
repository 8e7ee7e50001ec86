"""The last compiled forms of the JAX package in the port, on the CPU: a
``make_multi_step`` group with padding steps (JAX's scan skips them with
``lax.cond`` inside its one jitted dispatch), ``calibrate``'s jitted
``layer_maxes``, the hash-MLP baseline's jitted step, and
``host_pipeline_41m.card_epoch`` at ``--k-steps 1`` through
``make_train_step``.

Each is held against the JAX package on the same seeded numpy inputs, with
its tolerance stated. The card's capture paths are driven on the CPU by
stand-ins (:class:`CardOnTheCPU`): ``utils.cuda_graph._on_card`` says yes for
the CPU, CUDA's streams do nothing, a capture runs the function once (it
stands for the first replay, which runs on the capture's inputs) and each
later replay runs it again on the static inputs, writing into the static
outputs as the recorded kernels would. The card's own test of these forms,
graphed against eager to the bit, is in ``test_torch_cuda_graph.py``, which
imports no JAX.
"""

import contextlib
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_cuda_graph import _streams_on_the_cpu
from test_torch_host_pipeline import small_bin
from test_torch_multi_step import FLAGSHIP_SHAPED, PRUNE_KW, assert_kept_close, stacked_inputs
from test_torch_serving import F_SIZES, NUM, _batch, _cfgs, _port
from test_torch_train import NO_DROPOUT, assert_trees_close, fit_data
from xsdeepfwfm_deprecated_tpu.compression import quantization as JQ
from xsdeepfwfm_deprecated_tpu.config import TrainConfig as JTrain
from xsdeepfwfm_deprecated_tpu.models import deepfwfm as JD
from xsdeepfwfm_deprecated_tpu.models import hash_mlp_baseline as JH
from xsdeepfwfm_deprecated_tpu.train import trainer as JT
from xsdeepfwfm_deprecated_torch import _tree
from xsdeepfwfm_deprecated_torch.compression import quantization as TQ
from xsdeepfwfm_deprecated_torch.config import ModelConfig as TConfig
from xsdeepfwfm_deprecated_torch.config import TrainConfig as TTrain
from xsdeepfwfm_deprecated_torch.models import deepfwfm as TD
from xsdeepfwfm_deprecated_torch.models import hash_mlp_baseline as TH
from xsdeepfwfm_deprecated_torch.tools import host_pipeline_41m as hp
from xsdeepfwfm_deprecated_torch.train import trainer as TT
from xsdeepfwfm_deprecated_torch.utils import cuda_graph

K, B = 4, 32
ADAPTIVE = 0.4
# the real steps of a group: a padded tail (the host's k_real 3 of 4), and an
# all-padding step in the middle, which the mask says (k_real None)
PATTERNS = {"tail": (3, (True, True, True, False)), "middle": (None, (True, False, True, True))}


class CardOnTheCPU:
    """The card's graphs, stood in for on the CPU (see the module's
    docstring). ``captures`` and ``replays`` hold each graph's name in
    order; ``patterns`` the real steps of each multi-step captured. A capture
    for which ``fail(self)`` is true raises as CUDA's does."""

    def __init__(self, monkeypatch, fail=lambda card: False):
        self.captures, self.replays, self.patterns = [], [], []
        self._fail, self._making = fail, None
        monkeypatch.setattr(cuda_graph, "_on_card", lambda device: True)
        _streams_on_the_cpu(monkeypatch, self._capture)
        init, capture = cuda_graph.Graphed.__init__, cuda_graph.Compiled._capture
        card = self

        def recording_init(graphed, fn, inputs, **kw):
            card._making = (graphed, fn)
            init(graphed, fn, inputs, **kw)

        def recording_capture(compiled, device, state, leaves, inputs, static):
            if "live" in static:
                card.patterns.append(static["live"])
            return capture(compiled, device, state, leaves, inputs, static)
        monkeypatch.setattr(cuda_graph.Graphed, "__init__", recording_init)
        monkeypatch.setattr(cuda_graph.Compiled, "_capture", recording_capture)

    @contextlib.contextmanager
    def _capture(self, graph, stream=None, capture_error_mode="global"):
        graphed, fn = self._making
        if self._fail(self):
            raise RuntimeError("operation not permitted when stream is capturing")
        self.captures.append(graphed.name)
        done = [True]       # the capture ran the function: it stands for the first replay

        def replay():
            self.replays.append(graphed.name)
            if done:
                done.pop()
                return
            out = fn(*graphed.inputs)
            for static, new in zip(_tree.leaves(graphed.outputs), _tree.leaves(out)):
                static.copy_(new)
        graph.fn = replay
        yield


def padded_inputs(pattern: str, seed: int = 3):
    """(k_real, live, xi, xv, y, mask) of one group of K batches of B rows:
    the padding steps of ``pattern`` all padding (labels 0), the last real
    step padded in its last 5 rows."""
    k_real, live = PATTERNS[pattern]
    xi, xv, y, mask, _ = stacked_inputs(seed)
    for i, real in enumerate(live):
        if not real:
            mask[i], y[i] = 0.0, 0.0
    mask[max(i for i, real in enumerate(live) if real), -5:] = 0.0
    return k_real, live, xi, xv, y, mask


@pytest.mark.parametrize("form", ["eager", "graphed"])
@pytest.mark.parametrize("pattern", sorted(PATTERNS))
def test_padded_pruning_group_matches_jax(pattern, form, monkeypatch):
    """One pruning ``make_multi_step`` dispatch of K=4 steps at B=32 with
    padding steps, Adam + L2, dropout off, against JAX's
    ``multi_step_prune``: the losses, 0.0 in each skipped slot (both
    packages); the parameters (each leaf's zeros within one of JAX's, a weight
    between the two packages' thresholds, which differ in the last bit; kept
    values rtol 1e-4, atol 2e-5, the diagonal of ``field_cov`` 1e-3, as
    ``test_multi_step_matches_jax``); the optimizer state, rtol 1e-4, atol
    2e-5 (the refresh does not touch it). Graphed, the group is one capture
    of its own pattern of real steps, and one replay."""
    card = CardOnTheCPU(monkeypatch) if form == "graphed" else None
    jcfg, tcfg = _cfgs(**FLAGSHIP_SHAPED, **NO_DROPOUT)
    train_kw = dict(batch_size=B, learning_rate=1e-2, weight_decay=1e-4)
    opt_j, opt_t = JT.make_optimizer(JTrain(table_layout="flat", **train_kw)), \
        TT.make_optimizer(TTrain(**train_kw))
    multi_j = JT.make_multi_step(jcfg, JTrain(table_layout="flat", **train_kw), opt_j,
                                 prune_kw=PRUNE_KW)
    multi_t = TT.make_multi_step(tcfg, TTrain(**train_kw), opt_t, prune_kw=PRUNE_KW)
    params_j = JD.init_params(jax.random.PRNGKey(0), jcfg)
    params_t = _port(params_j)
    state_j, state_t = opt_j.init(params_j), opt_t.init(params_t)
    k_real, live, xi, xv, y, mask = padded_inputs(pattern)

    params_j, state_j, losses_j = multi_j(
        params_j, state_j, *map(jnp.asarray, (xi, xv, y, mask)), jax.random.PRNGKey(0),
        jnp.zeros((K, B), jnp.float32), jnp.float32(ADAPTIVE))
    losses_t = multi_t(params_t, state_t, *map(torch.from_numpy, (xi, xv, y, mask)), None,
                       None, ADAPTIVE, k_real=k_real)
    assert losses_t.shape == (K,)
    np.testing.assert_allclose(losses_t.numpy(), np.asarray(losses_j), rtol=1e-4, atol=2e-5)
    skipped = [not real for real in live]
    assert list(losses_t.numpy() == 0.0) == list(np.asarray(losses_j) == 0.0) == skipped
    assert_kept_close(params_t, params_j)
    assert_trees_close(state_t, state_j, rtol=1e-4, atol=2e-5)
    if card is not None:
        assert card.patterns == [live]
        assert card.replays == card.captures == [multi_t.name + "(forward)"]


def test_skipped_steps_draw_nothing_and_touch_nothing(monkeypatch):
    """Graphed (the stand-ins), a group whose steps 2 and 4 are all padding,
    dropout on: the parameters, the optimizer state and the generator after
    the replay equal two eager ``train_step`` s on the real batches from the
    same state and generator, to the bit (the warm-up ran on clones and the
    skipped steps drew nothing); the skipped slots hold 0.0."""
    card = CardOnTheCPU(monkeypatch)
    _, tcfg = _cfgs(**FLAGSHIP_SHAPED)
    tc = TTrain(batch_size=B, learning_rate=1e-2, weight_decay=1e-4)
    opt = TT.make_optimizer(tc)
    xi, xv, y, mask, _ = stacked_inputs(7)
    mask[1], mask[3] = 0.0, 0.0
    runs = []
    for graphed in (True, False):
        params = TD.init_params(torch.Generator().manual_seed(0), tcfg, device="cpu")
        state = opt.init(params)
        gen = torch.Generator().manual_seed(11)
        if graphed:
            losses = TT.make_multi_step(tcfg, tc, opt)(
                params, state, *map(torch.from_numpy, (xi, xv, y, mask)), gen)
            assert losses[1] == 0.0 and losses[3] == 0.0 and bool((losses[::2] > 0).all())
        else:
            for i in (0, 2):
                batch = {"xi": xi[i], "xv": xv[i], "y": y[i], "mask": mask[i]}
                TT.train_step(params, state, {k: torch.from_numpy(v) for k, v in batch.items()},
                              tcfg, tc, opt, generator=gen)
        runs.append((params, state, gen.get_state()))
    assert card.patterns == [(True, False, True, False)] and len(card.replays) == 1
    (p_g, s_g, g_g), (p_e, s_e, g_e) = runs
    assert torch.equal(g_g, g_e)
    for a, b in zip(_tree.leaves((p_g, s_g)), _tree.leaves((p_e, s_e))):
        assert torch.equal(a, b)


def test_fit_captures_the_tail_group_once_and_replays_it(monkeypatch):
    """``fit`` at ``steps_per_call=4`` with pruning from the first epoch
    (a refresh a group) and dropout on, two epochs of 11 batches: each
    epoch's last group holds 3 real batches. Graphed (the stand-ins), the
    full group and the tail group are captured once each, and the second
    epoch replays both; no group runs eagerly. The parameters, the optimizer
    state, the losses and the sparsity equal the eager fit's to the bit."""
    _, tcfg = _cfgs(**FLAGSHIP_SHAPED)
    xi, xv, y = fit_data(11 * B - 7, seed=5)
    tc = TTrain(n_epochs=2, batch_size=B, learning_rate=1e-2, random_seed=2, steps_per_call=4,
                prune=True, warm=0, sparse=0.8, prune_interval=4)
    eager = TT.DeepFMEstimator(tcfg, tc, logger=QUIET, device="cpu").fit(xi, xv, y)
    card = CardOnTheCPU(monkeypatch)
    steps = []
    run = TT.MultiStep._steps
    monkeypatch.setattr(TT.MultiStep, "_steps",
                        lambda self, *a, live, **kw: steps.append(live) or run(self, *a,
                                                                               live=live, **kw))
    graphed = TT.DeepFMEstimator(tcfg, tc, logger=QUIET, device="cpu").fit(xi, xv, y)

    full, tail = (True,) * 4, (True, True, True, False)
    assert card.patterns == [full, tail]
    multi = [name for name in card.replays if name.startswith(TT.MultiStep.name)]
    assert len(multi) == 2 * 3 and card.captures.count(multi[0]) == 2
    # what ran the steps: each capture's warm-up (the group on clones) and the capture (the
    # first replay), then the later replays; nothing else
    assert steps == [full, full, full, tail, tail, full, full, tail]
    for a, b in zip(_tree.leaves((eager.params, eager.opt_state)),
                    _tree.leaves((graphed.params, graphed.opt_state))):
        assert torch.equal(a, b)
    assert graphed.last_epoch_losses == eager.last_epoch_losses
    assert len(graphed.last_epoch_losses) == 11
    assert graphed.epoch_sparsity == eager.epoch_sparsity and graphed.epoch_sparsity[-1] > 0
    assert graphed._step == eager._step == 22


def test_failed_tail_capture_raises_and_steps_nothing(monkeypatch):
    """A capture of the tail group that fails raises, naming the function;
    nothing gives way to eager steps: the parameters and the optimizer state
    stay as the full group left them."""
    card = CardOnTheCPU(monkeypatch, fail=lambda card: len(card.captures) == 1)
    _, tcfg = _cfgs(**FLAGSHIP_SHAPED)
    tc = TTrain(batch_size=B, learning_rate=1e-2)
    opt = TT.make_optimizer(tc)
    multi = TT.make_multi_step(tcfg, tc, opt)
    params = TD.init_params(torch.Generator().manual_seed(0), tcfg, device="cpu")
    state = opt.init(params)
    gen = torch.Generator().manual_seed(1)
    xi, xv, y, mask, _ = (torch.from_numpy(a) for a in stacked_inputs(4))
    multi(params, state, xi, xv, y, mask, gen, k_real=K)
    before = [t.clone() for t in _tree.leaves((params, state))] + [gen.get_state()]
    with pytest.raises(RuntimeError, match=r"make_multi_step\(forward\) cannot be captured"):
        multi(params, state, xi, xv, y, mask * (torch.arange(K) < 3)[:, None], gen, k_real=3)
    after = _tree.leaves((params, state)) + [gen.get_state()]
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert card.captures == [multi.name + "(forward)"] and card.replays == card.captures


@pytest.mark.parametrize("form", ["eager", "graphed"])
def test_calibrate_matches_jax(form, monkeypatch):
    """``calibrate`` of 5 batches of 128 rows, eager and graphed (one
    capture, a replay a batch), against JAX's scales: rtol 1e-6 (a matmul's
    sums in another order can move an abs-max by an ulp), and the two forms
    of the port equal to the bit."""
    jcfg, tcfg = _cfgs(**FLAGSHIP_SHAPED)
    params = JD.init_params(jax.random.PRNGKey(8), jcfg)
    xi, xv = _batch(F_SIZES, NUM, 300, seed=9)
    want = JQ.calibrate(params, jcfg, xi, xv, n_batches=5, batch_size=128)
    eager = TQ.calibrate(_port(params), tcfg, xi, xv, n_batches=5, batch_size=128)
    card = CardOnTheCPU(monkeypatch) if form == "graphed" else None
    got = TQ.calibrate(_port(params), tcfg, xi, xv, n_batches=5, batch_size=128)
    flat = lambda s: [s["input"]] + s["nets"]["net_1"]     # noqa: E731
    np.testing.assert_allclose([float(s) for s in flat(got)], [float(s) for s in flat(want)],
                               rtol=1e-6)
    assert all(torch.equal(a, b) for a, b in zip(flat(got), flat(eager)))
    assert all(s.dtype == torch.float32 and s.ndim == 0 for s in flat(got))
    if card is not None:
        assert card.captures == ["calibrate"] and card.replays == ["calibrate"] * 5


QUIET = logging.getLogger("test_torch_padded_dispatch")
QUIET.addHandler(logging.NullHandler())
QUIET.propagate = False


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def epoch_losses(lines):
    return [float(line.rsplit(" ", 1)[1]) for line in lines if line.startswith("baseline epoch")]


@pytest.mark.parametrize("form", ["eager", "graphed"])
def test_hash_mlp_fit_matches_jax(form, monkeypatch):
    """``HashMLPBaseline.fit`` (no dropout: the baseline has none), 3 epochs
    of 600 rows at B=64 (9 steps an epoch, the partial batch dropped), Adam
    at lr 1e-2, from JAX's initial parameters in both packages: every
    parameter rtol 1e-4, atol 2e-5, and each epoch's summed loss rtol 1e-5
    against JAX's fit. Graphed (the stand-ins), one capture and one replay a
    step."""
    rng = np.random.default_rng(7)
    index = rng.integers(0, 50, size=(600, 4))
    value = rng.normal(size=(600, 3)).astype(np.float32)
    y = ((index[:, 0] % 2 == 0) ^ (rng.random(600) < 0.1)).astype(np.float32)
    kw = dict(n_epochs=3, batch_size=64, learning_rate=1e-2, random_seed=0)
    logs = {}
    models = {}
    for name, module, tc in (("jax", JH, JTrain(**kw)), ("torch", TH, TTrain(**kw))):
        log = logging.getLogger(f"test_torch_padded_dispatch.{name}")
        log.propagate, log.level = False, logging.INFO
        lines = _Lines()
        log.addHandler(lines)
        extra = {"device": "cpu"} if name == "torch" else {}
        base = module.HashMLPBaseline(hash_dim=128, hidden=(32, 16), train_cfg=tc, logger=log,
                                      **extra)
        if name == "torch":
            start = _port(JH.init_params(jax.random.PRNGKey(0), 128 + 3, (32, 16)))
            monkeypatch.setattr(TH, "init_params", lambda *a, **k: start)
            card = CardOnTheCPU(monkeypatch) if form == "graphed" else None
        models[name] = base.fit(index, value, y)
        logs[name] = epoch_losses(lines.lines)
        log.removeHandler(lines)
    assert len(logs["torch"]) == 3
    np.testing.assert_allclose(logs["torch"], logs["jax"], rtol=1e-5)
    assert_trees_close(models["torch"].params, models["jax"].params, rtol=1e-4, atol=2e-5)
    if card is not None:
        assert card.captures == ["HashMLPBaseline.fit step"]
        assert card.replays == ["HashMLPBaseline.fit step"] * 27


def test_card_epoch_k1_replays_make_train_step(tmp_path, monkeypatch):
    """``host_pipeline_41m.card_epoch`` at ``--k-steps 1``, graphed (the
    stand-ins): one ``make_train_step`` capture, then one replay a batch of
    the epoch and a batch of each budget rep, none eager; the parameters equal
    the eager epoch's (which steps the same ``make_train_step`` on the CPU),
    to the bit."""
    sizes = [1] * 13 + [7, 30, 5, 60] * 6 + [9, 11]
    d = str(tmp_path / "bin")
    small_bin(d, 300, sizes, seed=0)
    cfg = TConfig(field_size=39, feature_sizes=tuple(sizes), numerical=13, embedding_size=4,
                  h_depth=2, deep_nodes=16, use_fwfm=True, use_deep=True, use_lw=True,
                  use_fwlw=True)
    _, eager = hp.card_epoch(d, sizes, 64, 1, 4, mcfg=cfg, device="cpu")
    card = CardOnTheCPU(monkeypatch)
    monkeypatch.setattr(hp, "make_multi_step", None)      # K=1 makes no group
    res, graphed = hp.card_epoch(d, sizes, 64, 1, 4, mcfg=cfg, device="cpu")
    assert res["card_steps"] == 4
    assert card.captures == [TT.TrainStep.name + "(forward)"] and card.patterns == []
    assert card.replays == card.captures * (4 + 2 * hp.BUDGET_REPS)
    for a, b in zip(_tree.leaves(graphed), _tree.leaves(eager)):
        assert torch.equal(a, b)
