"""The fused Adam step (``ops/cuda/fused_adam.py``, ``csrc/fused_adam.cu``):
on the CPU, ``Optimizer.update`` runs the ``_foreach`` passes it ran before
the kernel, bit for bit, and launches nothing, and the wrapper's checks
refuse what the kernel does not take; on the card (marked ``cuda``), the
kernel against the ``_foreach`` path over 5 steps, bit for bit: the
flagship's leaves, ragged and unaligned leaves, the flush of a table's
subnormal first moments, bfloat16 tables (``-table_dtype bf16``), more leaves
than one launch takes, with and without L2, eager and inside a CUDA graph,
and one launch a ``make_train_step`` replay. No JAX here, so the card's
machine runs the card's tests:
``python -m pytest --noconftest tests/test_torch_fused_adam.py -m cuda``.
"""

import math

import numpy as np
import pytest
import torch

from xsdeepfwfm_deprecated_torch import _tree
from xsdeepfwfm_deprecated_torch.config import ModelConfig, TrainConfig
from xsdeepfwfm_deprecated_torch.models import deepfwfm
from xsdeepfwfm_deprecated_torch.ops.cuda import fused_adam as fa
from xsdeepfwfm_deprecated_torch.train import trainer

B1, B2, EPS, LR = 0.9, 0.999, 1e-8, 1e-3
TINY = torch.finfo(torch.float32).tiny

# The Criteo flagship's 12 leaves (flagship_config(full_criteo=True)) at 5,000 table rows
FLAGSHIP = (("bias", (1,)), ("emb2/dense", (5000, 10)), ("lw_w", (39, 1)),
            ("fwlw_w", (39, 10)), ("field_cov", (39, 39)),
            ("deep/net_1/layers/0/w", (390, 400)), ("deep/net_1/layers/0/b", (400,)),
            ("deep/net_1/layers/1/w", (400, 400)), ("deep/net_1/layers/1/b", (400,)),
            ("deep/net_1/layers/2/w", (400, 400)), ("deep/net_1/layers/2/b", (400,)),
            ("deep/net_1/fc_w", (400, 1)))
# counts that are no multiple of 4, one element, one value past a 4,096-value chunk
RAGGED = (("emb2/dense", (7, 3)), ("bias", (1,)), ("w", (4097,)), ("v", (4095,)),
          ("emb1/dense", (5,)))
# a table leaf and another leaf, both started with first moments just above FLT_MIN
SUBNORMAL = (("emb2/dense", (64, 16)), ("deep/net_1/fc_w", (64, 16)))
# 40 leaves, two launches: tables with full chunks and a tail, and 38 small dense leaves
MANY = ((("emb2/dense", (2000, 8)), ("emb1/dense", (2000, 1)))
        + tuple((f"deep/net_{i}/layers/{j}/w", (16 + i, 9 + j)) for i in range(19) for j in range(2)))
# each case's leaves and the storage type of its table leaves
CASES = {"flagship": (FLAGSHIP, torch.float32), "ragged": (RAGGED, torch.float32),
         "subnormal": (SUBNORMAL, torch.float32), "flagship_bf16": (FLAGSHIP, torch.bfloat16),
         "ragged_bf16": (RAGGED, torch.bfloat16), "subnormal_bf16": (SUBNORMAL, torch.bfloat16),
         "many_bf16": (MANY, torch.bfloat16)}


def _flush_flags(leaves):
    return [name.split("/")[0] in trainer._TABLE_GROUPS for name, _ in leaves]


def _dtypes(leaves, table_dtype=torch.float32):
    """Each leaf's storage type: ``table_dtype`` for table leaves, float32 else."""
    return [table_dtype if f else torch.float32 for f in _flush_flags(leaves)]


def _state(leaves, seed, device, subnormal=False, offset=0, table_dtype=torch.float32):
    """(p, mu, nu) from seeded numpy, each leaf a contiguous tensor that
    starts ``offset`` values into its own buffer (1: not 16-byte aligned),
    table leaves stored in ``table_dtype``."""
    rng = np.random.default_rng(seed)

    def leaf(shape, values, dtype):
        buf = torch.zeros(int(np.prod(shape)) + offset, device=device, dtype=dtype)
        t = buf[offset:].view(shape)
        t.copy_(torch.from_numpy(values.astype(np.float32)))
        return t

    out = ([], [], [])
    for (_, shape), dtype in zip(leaves, _dtypes(leaves, table_dtype)):
        if subnormal:           # p = 0 and no gradient: L2 and the loss leave mu to decay
            p = np.zeros(shape)
            mu = TINY * rng.uniform(1.0, 1.6, size=shape) * rng.choice([-1, 1], size=shape)
            nu = np.zeros(shape)
        else:
            p = rng.normal(0, 0.1, size=shape)
            mu = rng.normal(0, 1e-3, size=shape)
            nu = np.abs(rng.normal(0, 1e-6, size=shape))
        for dst, v in zip(out, (p, mu, nu)):
            dst.append(leaf(shape, v, dtype))
    return out


def _grads(leaves, seed, device, zero=False, table_dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy((np.zeros(s) if zero else rng.normal(0, 1e-2, size=s))
                             .astype(np.float32)).to(device, dtype)
            for (_, s), dtype in zip(leaves, _dtypes(leaves, table_dtype))]


def _clone(ts):
    return [t.clone() for t in ts]


def _bits_equal(a, b):
    def bits(t):
        return t.view(torch.int16 if t.element_size() == 2 else torch.int32)

    return all(x.dtype == y.dtype and torch.equal(bits(x), bits(y)) for x, y in zip(a, b))


def _foreach_update_before_the_kernel(p, grads, mu, nu, flush, count, wd):
    """``Optimizer.update``'s Adam branch as it was before the kernel, word
    for word but for the leaf names (``flush`` stands for them)."""
    g = torch._foreach_add(grads, p, alpha=wd) if wd else list(grads)
    count.add_(1)
    torch._foreach_mul_(mu, B1)
    torch._foreach_add_(mu, g, alpha=1 - B1)
    for m in [m for m, f in zip(mu, flush) if f]:
        m.masked_fill_(m.abs() < torch.finfo(m.dtype).tiny, 0)
    torch._foreach_mul_(nu, B2)
    torch._foreach_add_(nu, torch._foreach_mul(g, g), alpha=1 - B2)
    upd = torch._foreach_div(mu, 1 - torch.pow(B1, count))
    den = torch._foreach_div(nu, 1 - torch.pow(B2, count))
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, EPS)
    torch._foreach_div_(upd, den)
    torch._foreach_add_(p, upd, alpha=-LR)


@pytest.mark.parametrize("wd", [0.0, 3e-7])
def test_cpu_update_runs_the_foreach_passes_and_launches_nothing(wd):
    """On the CPU, ``Optimizer.update`` gives what its ``_foreach`` code gave
    before the kernel, to the bit, over 5 steps of a DeepFwFM tree with a
    table (the flush included), and the kernel's count does not move."""
    cfg = ModelConfig(field_size=6, feature_sizes=(1, 1, 1, 5, 9, 30), numerical=3,
                      embedding_size=4, h_depth=2, deep_nodes=16, use_fwfm=True, use_deep=True,
                      use_lw=True, use_fwlw=True)
    opt = trainer.make_optimizer(TrainConfig(learning_rate=LR, weight_decay=wd))
    params = deepfwfm.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    state = opt.init(params)
    named = [(name, tuple(t.shape)) for name, t in _tree.named_leaves(params)]
    flush = _flush_flags(named)
    assert any(flush) and not all(flush)
    slots = opt._slots(state)
    mu, nu = _tree.leaves(slots["mu"]), _tree.leaves(slots["nu"])
    # the table's first moments just above FLT_MIN, so that the flush bites
    for m, f in zip(mu, flush):
        if f:
            m.fill_(1.2 * TINY)
    want_p, want_mu, want_nu = (_clone(_tree.leaves(params)), _clone(mu), _clone(nu))
    count = slots["count"].clone()
    before = fa.fused_adam.launches
    for step in range(5):
        grads = _grads(named, 10 + step, "cpu")
        grads[1].zero_()        # one leaf with L2 alone
        opt.update(params, grads, state)
        _foreach_update_before_the_kernel(want_p, grads, want_mu, want_nu, flush, count, wd)
        assert _bits_equal(_tree.leaves(params), want_p)
        assert _bits_equal(mu, want_mu) and _bits_equal(nu, want_nu)
        assert torch.equal(slots["count"], count)
    assert fa.fused_adam.launches == before


def _refusal(name, device):
    p, mu, nu = _state(RAGGED, 0, device)
    grads = _grads(RAGGED, 1, device)
    bc = torch.ones((), device=device)
    if name == "float64":
        grads[2] = grads[2].double()
    elif name == "non-contiguous":
        mu[0] = torch.zeros(3, 7, device=device).T
    elif name == "shape":
        nu[3] = nu[3][:-1]
    elif name == "float16":
        p[1], grads[1], mu[1], nu[1] = (t.half() for t in (p[1], grads[1], mu[1], nu[1]))
    elif name == "dtype":
        mu[2] = mu[2].bfloat16()
    elif name == "leaves":
        p, grads, mu, nu = ([t[0]] * (fa.MAX_LEAVES + 1) for t in (p, grads, mu, nu))
    return p, grads, mu, nu, [True] * len(p), bc, bc


REFUSALS = {"float64": "not float32", "non-contiguous": "not contiguous",
            "shape": "differ in shape", "leaves": "takes 1 to", "float16": "not float32",
            "dtype": "differ in dtype"}
# what the wrapper refuses: it splits a longer leaf list into launches of MAX_LEAVES
WRAPPER_REFUSALS = sorted(set(REFUSALS) - {"leaves"})


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_check_leaves_refuses(name):
    """The checks a CUDA launch goes through, run here on CPU operands: they
    are plain Python over shapes, types and strides."""
    with pytest.raises(ValueError, match=REFUSALS[name]):
        fa.check_leaves(*_refusal(name, "cpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("name", WRAPPER_REFUSALS)
def test_cuda_wrapper_refuses_before_any_launch(name):
    """On the card: what the kernel does not take raises before a launch,
    and nothing runs the plain version instead."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    *leaves, flush, bc1, bc2 = _refusal(name, "cuda")
    before = fa.fused_adam.launches
    with pytest.raises(ValueError, match=REFUSALS[name]):
        fa.fused_adam(*leaves, flush, bc1, bc2, lr=LR, wd=0.0, b1=B1, b2=B2, eps=EPS)
    assert fa.fused_adam.launches == before


def _step(fn, p, grads, mu, nu, flush, count, wd):
    count.add_(1)
    fn(p, grads, mu, nu, flush, 1 - torch.pow(B1, count), 1 - torch.pow(B2, count),
       lr=LR, wd=wd, b1=B1, b2=B2, eps=EPS)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("wd", [0.0, 3e-7])
@pytest.mark.parametrize("case", sorted(CASES))
def test_cuda_kernel_equals_the_foreach_path_bit_for_bit(case, wd, offset):
    """On the card: 5 steps of the kernel against 5 steps of the ``_foreach``
    path from equal states, p, mu and nu equal to the bit after each step;
    with ``offset`` 1 no leaf is 16-byte aligned (the one-value path). In
    the subnormal case the table's first moments fall below FLT_MIN and are
    flushed to 0, the other leaf's keep their subnormals. In the ``_bf16``
    cases the table leaves are bfloat16, rounded after each operation as
    the ``_foreach`` passes round them; ``many_bf16`` takes two launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    (leaves, table_dtype), dev = CASES[case], torch.device("cuda")
    flush = _flush_flags(leaves)
    subnormal = case.startswith("subnormal")
    got = _state(leaves, 3, dev, subnormal=subnormal, offset=offset, table_dtype=table_dtype)
    want = _state(leaves, 3, dev, subnormal=subnormal, offset=offset, table_dtype=table_dtype)
    counts = [torch.zeros((), dtype=torch.int32, device=dev) for _ in range(2)]
    for step in range(5):
        grads = _grads(leaves, 20 + step, dev, zero=subnormal, table_dtype=table_dtype)
        before = fa.fused_adam.launches
        _step(fa.fused_adam, got[0], grads, got[1], got[2], flush, counts[0], wd)
        assert fa.fused_adam.launches == before + math.ceil(len(leaves) / fa.MAX_LEAVES)
        _step(fa.adam_reference, want[0], grads, want[1], want[2], flush, counts[1], wd)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert _bits_equal(a, b), f"step {step}"
    if subnormal:
        table, other = got[1]
        assert int((table != 0).sum()) == 0
        sub = (other != 0) & (other.abs() < TINY)
        assert int(sub.sum()) == other.numel()


@pytest.mark.cuda
@pytest.mark.parametrize("wd", [0.0, 3e-7])
def test_cuda_optimizer_update_with_bf16_tables_and_40_leaves(wd):
    """On the card: ``Optimizer.update`` of a DeepFwFM tree with bfloat16
    tables (``-table_dtype bf16``) and 5 deep nets of depth 3, 40 leaves,
    against its ``_foreach`` code from before the kernel over 5 steps, bit
    for bit, two launches a step."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cfg = ModelConfig(field_size=6, feature_sizes=(1, 1, 1, 5, 9, 3000), numerical=3,
                      embedding_size=4, h_depth=3, deep_nodes=16, use_fwfm=True, use_deep=True,
                      use_lw=True, use_fwlw=True, num_deeps=5, table_dtype="bf16")
    opt = trainer.make_optimizer(TrainConfig(learning_rate=LR, weight_decay=wd))
    params = deepfwfm.init_params(torch.Generator().manual_seed(0), cfg, device="cuda")
    state = opt.init(params)
    named = list(_tree.named_leaves(params))
    assert len(named) == 40 and {t.dtype for _, t in named} == {torch.float32, torch.bfloat16}
    flush = _flush_flags([(name, None) for name, _ in named])
    slots = opt._slots(state)
    mu, nu = _tree.leaves(slots["mu"]), _tree.leaves(slots["nu"])
    want_p, want_mu, want_nu = (_clone(_tree.leaves(params)), _clone(mu), _clone(nu))
    count = slots["count"].clone()
    rng = np.random.default_rng(7)
    for step in range(5):
        grads = [torch.from_numpy(rng.normal(0, 1e-2, size=tuple(t.shape)).astype(np.float32))
                 .to("cuda", t.dtype) for _, t in named]
        before = fa.fused_adam.launches
        opt.update(params, grads, state)
        assert fa.fused_adam.launches == before + 2
        _foreach_update_before_the_kernel(want_p, grads, want_mu, want_nu, flush, count, wd)
        torch.cuda.synchronize()
        assert _bits_equal(_tree.leaves(params), want_p), f"step {step}"
        assert _bits_equal(mu, want_mu) and _bits_equal(nu, want_nu), f"step {step}"


@pytest.mark.cuda
@pytest.mark.parametrize("wd", [0.0, 3e-7])
def test_cuda_kernel_in_a_graph_equals_eager_foreach_steps(wd):
    """On the card: the step (count, bias corrections and the kernel)
    captured into a CUDA graph and replayed 4 times on fresh gradients
    against 4 eager ``_foreach`` steps, after one eager step of each (the
    warm-up, which also loads the kernel): equal to the bit after each."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    flush = _flush_flags(FLAGSHIP)
    got, want = _state(FLAGSHIP, 4, dev), _state(FLAGSHIP, 4, dev)
    counts = [torch.zeros((), dtype=torch.int32, device=dev) for _ in range(2)]
    static = _grads(FLAGSHIP, 30, dev)
    _step(fa.fused_adam, got[0], static, got[1], got[2], flush, counts[0], wd)
    _step(fa.adam_reference, want[0], static, want[1], want[2], flush, counts[1], wd)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        _step(fa.fused_adam, got[0], static, got[1], got[2], flush, counts[0], wd)
    for step in range(4):
        for buf, g in zip(static, _grads(FLAGSHIP, 31 + step, dev)):
            buf.copy_(g)
        graph.replay()
        _step(fa.adam_reference, want[0], static, want[1], want[2], flush, counts[1], wd)
        torch.cuda.synchronize()
        assert torch.equal(counts[0], counts[1])
        for a, b in zip(got, want):
            assert _bits_equal(a, b), f"replay {step}"


@pytest.mark.cuda
def test_cuda_make_train_step_replay_launches_the_kernel_once():
    """On the card: each replay of a ``make_train_step`` graph adds exactly
    1 to the kernel's count, the first call's capture and warm-up nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    sizes = (1, 1, 1, 5, 9, 30)
    cfg = ModelConfig(field_size=6, feature_sizes=sizes, numerical=3, embedding_size=4,
                      h_depth=2, deep_nodes=64, use_fwfm=True, use_deep=True, use_lw=True,
                      use_fwlw=True)
    rng = np.random.default_rng(5)
    b = 256
    batch = {"xi": torch.from_numpy(rng.integers(0, sizes[3:], size=(b, 3)).astype(np.int32)),
             "xv": torch.from_numpy(rng.normal(size=(b, 3)).astype(np.float32)),
             "y": torch.from_numpy((rng.random(b) < 0.4).astype(np.float32)),
             "mask": torch.ones(b)}
    batch = {k: v.cuda() for k, v in batch.items()}
    tc = TrainConfig(batch_size=b, learning_rate=LR, weight_decay=3e-7)
    opt = trainer.make_optimizer(tc)
    params = deepfwfm.init_params(torch.Generator().manual_seed(0), cfg, device="cuda")
    state = opt.init(params)
    step = trainer.make_train_step(cfg, tc, opt)
    gen = torch.Generator(device="cuda").manual_seed(6)
    for _ in range(3):
        before = fa.fused_adam.launches
        step(params, state, batch, gen)
        assert fa.fused_adam.launches == before + 1
    assert len(step._graphs) == 1
