"""The prune refresh's threshold search (``ops/cuda/prune_search.py``,
``csrc/prune_search.cu``): on the CPU, the kernel's rounds in plain PyTorch
(``search_reference``) give ``compression.pruning._bisect``'s threshold bit for
bit, at 8 and at 5 halvings a round, over ties, a cluster collapsed at 1e-31
and sizes from just above ``BISECT_SIZE`` to a few million; the groups that
``prune_params_`` hands the kernel, searched that way, prune a tree as the
torch path does; and the wrapper refuses what the kernel does not take, CPU
tensors included. On the card (marked ``cuda``):
``expf`` and ``logf`` as the kernel computes them equal torch's ``exp`` and
``log`` over every float32, and ``expf`` is monotone; the kernel's thresholds
and pruned leaves equal the torch path's, bit for bit, on the Criteo tree,
with QR tables, padded ``dense_rows``, bfloat16 tables and a zero target,
eager, inside a captured ``PruneRefresh`` graph and inside a ``make_multi_step``
group, with ``rounds + 2`` launches a refresh. No JAX here, so the card's
machine runs the card's tests:
``python -m pytest --noconftest tests/test_torch_prune_search.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from xsdeepfwfm_deprecated_torch import _tree
from xsdeepfwfm_deprecated_torch.compression import pruning
from xsdeepfwfm_deprecated_torch.config import ModelConfig, TrainConfig
from xsdeepfwfm_deprecated_torch.entry import flagship_config
from xsdeepfwfm_deprecated_torch.models import deepfwfm
from xsdeepfwfm_deprecated_torch.ops.cuda import prune_search as ps
from xsdeepfwfm_deprecated_torch.train import trainer

LAUNCHES = ps.LAUNCHES
TARGETS = (0.0, 0.04, 0.4, 0.9, 1.0)
# just above the bisection's floor, the Criteo tower's first and later weights
SIZES = (pruning.BISECT_SIZE + 1, 156_000, 160_000)
# the benchmark's refresh (deepfwfm_criteo's keyword arguments)
CRITEO_KW = dict(emb_r=0.444, emb_corr=1.0, prune_fm=True, prune_deep=True, prune_r=True)


def _values(kind: str, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    w = rng.normal(size=n).astype(np.float32) * np.float32(0.01)
    if kind == "ties":          # 41 magnitudes, zeros among them, each about n/41 times
        w = (rng.integers(-20, 21, size=n) * 1e-3).astype(np.float32)
    elif kind == "collapsed":   # 80% parked by Adam+L2 at ~1e-31, as rows no batch samples
        k = int(n * 0.8)
        w[:k] = (np.abs(rng.normal(size=k)) + 0.1).astype(np.float32) * np.float32(1e-31)
    return w


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int16 if t.element_size() == 2 else torch.int32)


def _bits_equal(a, b) -> bool:
    return all(x.dtype == y.dtype and torch.equal(_bits(x), _bits(y)) for x, y in zip(a, b))


def _torch_threshold(values: torch.Tensor, target: float) -> torch.Tensor:
    return pruning.magnitude_threshold(values, torch.tensor(target, device=values.device))


@pytest.mark.parametrize("levels", [8, 5])
@pytest.mark.parametrize("kind", ["normal", "ties", "collapsed"])
@pytest.mark.parametrize("n", SIZES)
def test_reference_threshold_is_the_bisection_threshold(n, kind, levels):
    """The kernel's rounds, written in torch, give ``magnitude_threshold``'s
    threshold to the bit for every target (0 included), with 8 or 5
    halvings resolved a round."""
    t = torch.from_numpy(_values(kind, n, seed=n % 97))
    targets = [torch.tensor(x) for x in TARGETS]
    got = ps.search_reference([[(t, n)]] * len(TARGETS), targets, levels=levels)
    want = torch.stack([_torch_threshold(t, x) for x in TARGETS])
    assert _bits_equal([got], [want]), (got, want)


@pytest.mark.parametrize("target", [0.04, 0.4, 0.9])
def test_reference_threshold_at_a_few_million_values(target):
    """3,000,000 values over two leaves of one group, the first counted in
    part (a padded table's real rows), a collapsed cluster among them."""
    w = torch.from_numpy(_values("collapsed", 3_000_000, seed=11))
    table, other = w[:2_000_000].clone(), w[2_000_000:].clone()
    padded = torch.cat([table, torch.full((4_000,), 5.0)])
    got = ps.search_reference([[(padded, table.numel()), (other, other.numel())]],
                              [torch.tensor(target)])
    assert _bits_equal([got[0]], [_torch_threshold(w, target)])


def _tree_cases():
    """name: (ModelConfig, padding rows past ``dense_rows``, target) for the trees
    the wrapper is held to; small enough for the CPU, above the bisection floor."""
    small = dict(field_size=6, feature_sizes=(1, 1, 1, 900, 3000, 2000), numerical=3,
                 embedding_size=8, h_depth=2, deep_nodes=400, use_fwfm=True, use_deep=True,
                 use_lw=True, use_fwlw=True)
    return {
        "plain": (ModelConfig(**small), 0, 0.5),
        "qr": (ModelConfig(**small, qr_flag=True, qr_threshold=500), 0, 0.5),
        "padded": (ModelConfig(**small), 300, 0.5),
        "bf16": (ModelConfig(**small, table_dtype="bf16"), 0, 0.5),
        "zero_target": (ModelConfig(**small), 0, 0.0),
    }


TREE_CASES = sorted(_tree_cases())


def _model_tree(cfg: ModelConfig, pad: int, device, seed: int = 0):
    """The model's leaves as a refresh finds them in training: 40% of the table
    already zero, a block of rows parked at ~1e-31, ``pad`` padding rows with
    values in them (``dense_rows`` leaves them out of the count, not out of the
    zeroing)."""
    params = deepfwfm.init_params(torch.Generator().manual_seed(seed), cfg, device="cpu")
    rng = np.random.default_rng(seed)
    dense = params["emb2"]["dense"]
    rows = dense.shape[0]
    vals = dense.float().numpy().copy()
    vals[rng.random(vals.shape) < 0.4] = 0
    vals[rows // 3: rows // 2] *= np.float32(1e-29)
    if pad:
        vals = np.concatenate([vals, rng.normal(size=(pad, vals.shape[1])).astype(np.float32)])
    params["emb2"]["dense"] = torch.from_numpy(vals).to(dense.dtype)
    return _tree.tree_map(lambda t: t.to(device), params), rows


def _prune_both(params, kw, target, monkeypatch):
    """The tree pruned by the kernel's route and by the torch path, from equal
    copies."""
    a, b = (_tree.tree_map(torch.clone, params) for _ in range(2))
    pruning.prune_params_(a, target, **kw)
    with monkeypatch.context() as m:
        m.setattr(pruning, "_kernel_takes", lambda leaf: False)
        pruning.prune_params_(b, target, **kw)
    return a, b


def _reference_search(groups, targets):
    """The kernel's effect in plain PyTorch: ``search_reference``'s thresholds,
    every leaf of a group zeroed below its group's."""
    thr = ps.search_reference(groups, targets)
    for group, t in zip(groups, thr):
        for leaf, _ in group:
            leaf.masked_fill_(leaf.abs().to(torch.float32) < t, 0)
    return thr


@pytest.mark.parametrize("case", TREE_CASES)
def test_kernel_route_groups_prune_as_the_torch_path(case, monkeypatch):
    """On the CPU, the kernel's route forced and the kernel stood in for by
    ``search_reference``: the groups ``prune_params_`` hands it (the tables
    together over their real rows, each tower weight) give the torch path's
    leaves bit for bit."""
    cfg, pad, target = _tree_cases()[case]
    params, rows = _model_tree(cfg, pad, "cpu")
    kw = dict(CRITEO_KW, dense_rows=rows if pad else 0)
    searched = []

    def search(groups, targets):
        searched.append(len(groups))
        return _reference_search(groups, targets)

    monkeypatch.setattr(pruning, "_kernel_takes", lambda leaf: True)
    monkeypatch.setattr(pruning, "prune_search", search)
    got, want = _prune_both(params, kw, target, monkeypatch)
    counted = [sum(t.numel() for t in params["emb2"].values()) - pad * cfg.embedding_size]
    counted += [layer["w"].numel() for layer in params["deep"]["net_1"]["layers"]]
    assert searched == [sum(n > pruning.BISECT_SIZE for n in counted)]
    assert _bits_equal(_tree.leaves(got), _tree.leaves(want))
    if target:
        assert pruning.sparsity_report(got)["nonzero"] < pruning.sparsity_report(params)["nonzero"]


def test_prune_params_is_prune_params_on_a_copy():
    cfg, pad, target = _tree_cases()["padded"]
    params, rows = _model_tree(cfg, pad, "cpu")
    before = _tree.tree_map(torch.clone, params)
    kw = dict(CRITEO_KW, dense_rows=rows)
    out = pruning.prune_params(params, target, **kw)
    assert _bits_equal(_tree.leaves(params), _tree.leaves(before))
    pruning.prune_params_(params, target, **kw)
    assert _bits_equal(_tree.leaves(out), _tree.leaves(params))
    assert [n for n, _ in _tree.named_leaves(out)] == [n for n, _ in _tree.named_leaves(params)]


def test_the_kernel_makes_the_bisections_halvings():
    assert ps.ITERS == pruning.BISECT_ITERS and ps.ITERS % ps.LEVELS == 0
    assert ps.LAUNCHES == ps.ITERS // ps.LEVELS + 2


def test_launches_hold_whole_groups_of_at_most_max_segments_leaves():
    sizes = [3, 1, ps.MAX_SEGMENTS - 4, 2, ps.MAX_SEGMENTS, 1]
    groups = [[(torch.zeros(1), 1)] * n for n in sizes]
    batches = ps._batches(groups)
    assert batches == [[0, 1, 2], [3], [4], [5]]
    assert all(sum(sizes[g] for g in b) <= ps.MAX_SEGMENTS for b in batches)


def _refusal(name, device):
    leaf = torch.zeros(pruning.BISECT_SIZE + 5, device=device)
    groups, targets = [[(leaf, leaf.numel())]], [torch.tensor(0.5, device=device)]
    if name == "float16":
        groups = [[(leaf.half(), leaf.numel())]]
    elif name == "float64":
        groups = [[(leaf.double(), leaf.numel())]]
    elif name == "non-contiguous":
        groups = [[(torch.zeros(200, 100, device=device).T, 20_000)]]
    elif name == "empty group":
        groups = [[(leaf, leaf.numel())], []]
        targets = targets * 2
    elif name == "counts nothing":
        groups = [[(leaf, 0)]]
    elif name == "counts past the leaf":
        groups = [[(leaf, leaf.numel() + 1)]]
    elif name == "targets":
        targets = targets * 2
    elif name == "no groups":
        groups, targets = [], []
    elif name == "leaves":
        groups = [[(leaf, 1)] * (ps.MAX_SEGMENTS + 1)]
    elif name == "device":
        groups, targets = [[(leaf.cpu(), leaf.numel())]], [targets[0].cpu()]
    return groups, targets


REFUSALS = {"float16": "not float32", "float64": "not float32",
            "non-contiguous": "not contiguous", "empty group": "is empty",
            "counts nothing": "counts no value", "counts past the leaf": "counts",
            "targets": "targets", "no groups": "at least one group",
            "leaves": "more than", "device": "takes CUDA tensors"}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_wrapper_refuses_before_anything_runs(name):
    """On CPU operands, each fault is named before the device is (on the card,
    before any launch: the ``cuda`` case below)."""
    groups, targets = _refusal(name, "cpu")
    with pytest.raises(ValueError, match=REFUSALS[name]):
        ps.prune_search(groups, targets)


# ---- on the card

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_cuda_wrapper_refuses_before_any_launch(name):
    dev = _card()
    groups, targets = _refusal(name, dev)
    before = ps.prune_search.launches
    with pytest.raises(ValueError, match=REFUSALS[name]):
        ps.prune_search(groups, targets)
    assert ps.prune_search.launches == before


@pytest.mark.cuda
def test_cuda_expf_and_logf_are_torchs_over_every_float():
    """Every float32 bit pattern through the kernel's ``expf`` and ``logf`` and
    through torch's ``exp`` and ``log`` on the card: equal bits (or both NaN);
    and ``expf`` never decreases as its argument grows, which is what lets one
    pass count against a whole tree of thresholds."""
    dev = _card()
    step = 1 << 28
    prev = {}
    for start in range(-(1 << 31), 1 << 31, step):
        bits = torch.arange(step, dtype=torch.int32, device=dev) + start
        x = bits.view(torch.float32)
        k_exp, k_log = ps.kernel_math(x)
        for got, want in ((k_exp, torch.exp(x)), (k_log, torch.log(x))):
            same = (_bits(got) == _bits(want)) | (torch.isnan(got) & torch.isnan(want))
            assert bool(same.all()), f"bits from {start:#x}: {int((~same).sum())} differ"
        # non-negative bits grow with the value, negative ones shrink with it
        sign = 1 if start >= 0 else -1
        keep = ~torch.isnan(x)
        y = k_exp[keep]
        if sign in prev:
            y = torch.cat([prev[sign].reshape(1), y])
        if y.numel() > 1:
            rises = y[1:] >= y[:-1] if sign > 0 else y[1:] <= y[:-1]
            assert bool(rises.all()), f"bits from {start:#x}"
            prev[sign] = y[-1]
        del bits, x, k_exp, k_log


def _flagship_tree(dev, seed=0):
    """The Criteo flagship's leaves (1,326,055 table rows, a 400-wide tower) as
    a refresh finds them: 40% of the table zero, a block of rows parked at
    ~1e-31."""
    cfg = flagship_config(full_criteo=True)
    params = deepfwfm.init_params(torch.Generator().manual_seed(seed), cfg, device=dev)
    dense = params["emb2"]["dense"]
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    dense.masked_fill_(torch.rand(dense.shape, generator=gen, device=dev) < 0.4, 0)
    dense[200_000:500_000] *= 1e-29
    return params


@pytest.mark.cuda
@pytest.mark.parametrize("target", [0.0, 0.04, 0.4, 0.9])
def test_cuda_kernel_prunes_the_criteo_tree_as_the_torch_path(target, monkeypatch):
    """The benchmark's refresh of the flagship's tree: the kernel's route
    against the torch path on the card, every leaf equal to the bit, 7 launches;
    and the thresholds the wrapper returns equal ``magnitude_threshold``'s and
    ``search_reference``'s on the card."""
    dev = _card()
    params = _flagship_tree(dev)
    before = ps.prune_search.launches
    got, want = _prune_both(params, CRITEO_KW, target, monkeypatch)
    torch.cuda.synchronize()
    assert ps.prune_search.launches == before + LAUNCHES
    assert _bits_equal(_tree.leaves(got), _tree.leaves(want))

    tables = params["emb2"]
    layers = [layer["w"] for layer in params["deep"]["net_1"]["layers"]]
    groups = [[(t, t.numel()) for t in tables.values()]] + [[(w, w.numel())] for w in layers]
    a = torch.tensor(target, device=dev)
    targets = [a * CRITEO_KW["emb_r"]] + [a] * len(layers)
    ref = ps.search_reference(groups, targets)
    flat = [torch.cat([t.reshape(-1) for t, _ in g]) for g in groups]
    torch_thr = torch.stack([pruning.magnitude_threshold(f, t) for f, t in zip(flat, targets)])
    thr = ps.prune_search([[(t.clone(), n) for t, n in g] for g in groups], targets)
    assert _bits_equal([thr], [torch_thr]) and _bits_equal([ref], [torch_thr])


@pytest.mark.cuda
def test_cuda_kernel_takes_many_groups_unaligned_leaves_and_non_finite_values():
    """40 groups of 1 to 3 leaves, 79 in all, in three launches (some leaves are
    views that start one value past 16-byte alignment, read one value a
    thread), float32 and bfloat16, one group holding a NaN and one an inf:
    each threshold equal to ``magnitude_threshold``'s on the card and each leaf
    zeroed as ``apply_threshold`` zeroes it."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(9)
    groups, want_leaves, targets = [], [], []
    for g in range(40):
        dtype = torch.bfloat16 if g % 3 == 1 else torch.float32
        leaves = []
        for j in range(1 + g % 3):
            n = pruning.BISECT_SIZE + 1 + 4_001 * (g + j)
            buf = torch.randn(n + 1, generator=gen, device=dev).mul_(0.01).to(dtype)
            leaves.append(buf[1:] if (g + j) % 4 == 0 else buf[:n])
        if g == 5:
            leaves[0][17] = float("nan")
        if g == 6:
            leaves[0][17] = float("inf")
        groups.append([(leaf, leaf.numel()) for leaf in leaves])
        targets.append(torch.tensor((g % 10) / 9.0, device=dev))
    want_thr = []
    for group, t in zip(groups, targets):
        thr = pruning.magnitude_threshold(torch.cat([x.float() for x, _ in group]), t)
        want_thr.append(thr)
        want_leaves.append([pruning.apply_threshold(x, thr) for x, _ in group])
    before = ps.prune_search.launches
    got_thr = ps.prune_search(groups, targets)
    torch.cuda.synchronize()
    assert torch.isnan(got_thr[5]) and torch.isnan(want_thr[5])
    keep = [g for g in range(40) if g != 5]
    assert _bits_equal([got_thr[keep]], [torch.stack(want_thr)[keep]])
    for group, want in zip(groups, want_leaves):
        assert _bits_equal([x for x, _ in group], want)
    launches = len(ps._batches(groups))
    assert launches > 1 and ps.prune_search.launches == before + launches * LAUNCHES


@pytest.mark.cuda
@pytest.mark.parametrize("case", TREE_CASES)
def test_cuda_kernel_prunes_as_the_torch_path(case, monkeypatch):
    """QR tables, a padded table (``dense_rows``: padding not counted, but
    zeroed), bfloat16 tables and a zero target, on the card, bit for bit."""
    dev = _card()
    cfg, pad, target = _tree_cases()[case]
    params, rows = _model_tree(cfg, pad, dev)
    kw = dict(CRITEO_KW, dense_rows=rows if pad else 0)
    before = ps.prune_search.launches
    got, want = _prune_both(params, kw, target, monkeypatch)
    torch.cuda.synchronize()
    assert ps.prune_search.launches == before + LAUNCHES
    assert _bits_equal(_tree.leaves(got), _tree.leaves(want))


@pytest.mark.cuda
def test_cuda_refresh_graph_replays_the_kernel(monkeypatch):
    """``PruneRefresh`` on the card: one graph captured, each call a replay that
    adds ``rounds + 2`` launches, and after each the leaves equal the torch
    path's refresh of the state before it."""
    dev = _card()
    cfg, pad, _ = _tree_cases()["padded"]
    params, rows = _model_tree(cfg, pad, dev)
    kw = dict(CRITEO_KW, dense_rows=rows)
    refresh = trainer.PruneRefresh(kw)
    for target in (0.2, 0.5, 0.8):
        want = _tree.tree_map(torch.clone, params)
        with monkeypatch.context() as m:
            m.setattr(pruning, "_kernel_takes", lambda leaf: False)
            pruning.prune_params_(want, target, **kw)
        before = ps.prune_search.launches
        refresh(params, target)
        torch.cuda.synchronize()
        assert ps.prune_search.launches == before + LAUNCHES
        assert _bits_equal(_tree.leaves(params), _tree.leaves(want)), target
    assert len(refresh._graphs) == 1


@pytest.mark.cuda
def test_cuda_multi_step_group_refreshes_with_the_kernel(monkeypatch):
    """A ``make_multi_step`` group of 3 steps and a refresh, one replay: at
    learning rate 0 the steps leave the parameters as they are, so the group's
    parameters equal the torch path's refresh of the parameters before it; each
    replay adds ``rounds + 2`` launches."""
    dev = _card()
    cfg, _, _ = _tree_cases()["plain"]
    params, _ = _model_tree(cfg, 0, dev)
    tc = TrainConfig(batch_size=128, learning_rate=0.0, weight_decay=3e-7)
    opt = trainer.make_optimizer(tc)
    state = opt.init(params)
    multi = trainer.make_multi_step(cfg, tc, opt, prune_kw=CRITEO_KW)
    rng = np.random.default_rng(4)
    k, b = 3, 128
    xi = torch.from_numpy(rng.integers(0, (900, 3000, 2000), size=(k, b, 3)).astype(np.int32))
    xv = torch.from_numpy(rng.normal(size=(k, b, 3)).astype(np.float32))
    y = torch.from_numpy((rng.random((k, b)) < 0.3).astype(np.float32))
    mask = torch.ones(k, b)
    gen = torch.Generator(device=dev).manual_seed(5)
    for target in (0.3, 0.6):
        want = _tree.tree_map(torch.clone, params)
        with monkeypatch.context() as m:
            m.setattr(pruning, "_kernel_takes", lambda leaf: False)
            pruning.prune_params_(want, target, **CRITEO_KW)
        before = ps.prune_search.launches
        multi(params, state, xi, xv, y, mask, gen, None, target)
        torch.cuda.synchronize()
        assert ps.prune_search.launches == before + LAUNCHES
        assert _bits_equal(_tree.leaves(params), _tree.leaves(want)), target
    assert len(multi._graphs) == 1
