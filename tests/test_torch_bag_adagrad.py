"""DLRM-DCNv2's sparse Adagrad kernel (``ops/cuda/bag_adagrad.py``, ``csrc/bag_adagrad.cu``).

On the CPU: the wrapper's checks refuse what the kernel does not take before they look at
the device; the plain version of the kernel's order (each segment summed in position order,
cut into slices of the sorted order that are added in order) equals a loop over the
segments to the bit, and ``ops/embedding.bag_adagrad_torch`` within float32
rounding (to the bit where every id is distinct); the count of distinct rows is exact and
rows off the batch are not touched, a one-row table (a warm-up's stand-in) and segments
several slices long included; and the CPU keeps the torch form, with no launch.

Tolerance: the torch form adds a segment's gradients column by column and the kernel in
position order, so a sum of k terms parts by a few units in its last place. The accumulator
then parts by a few float32 ulps of its size (rtol 1e-5); a step of at most lr (0.05, whose
ulp is 3.7e-9) by a few ulps of lr, which is all that is left where it cancels a weight
(atol 1e-7).

On the card (marked ``cuda``): the kernel against its plain version, to the bit, on the
same cases and a gradient strided as the backward's, two runs equal, 2 launches a step, a
graph's replays against eager steps, and the refusal of an operand off 16 bytes.
No JAX here, so the card's machine runs the card's tests:
``python -m pytest --noconftest tests/test_torch_bag_adagrad.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from xsdeepfwfm_deprecated_torch.config import TrainConfig
from xsdeepfwfm_deprecated_torch.ops import embedding as emb_ops
from xsdeepfwfm_deprecated_torch.ops.cuda import bag_adagrad as ba
from xsdeepfwfm_deprecated_torch.train import trainer
from xsdeepfwfm_deprecated_torch.utils import profiling

LR, EPS = 0.05, trainer.ADAGRAD_EPS
BAGS = (1, 3, 5, 2)
# segment lengths that start and end on and off the 32-id slices: 5 + 27 ends on a slice's
# end, 32 fills one, 64 two, 33 runs one id past, 100 crosses four; then short ones
CRAFTED = (5, 27, 32, 64, 33, 1, 100, 31, 2, 1, 40)


def _column_field(bags):
    return tuple(f for f, k in enumerate(bags) for _ in range(k))


def _problem(rows, b, bags=BAGS, width=8, seed=0, ids=None):
    """(table, acc, ids (b, columns), grad (b, fields, width)) from seeded numpy: a
    quarter of the accumulator's rows at 0, and field 0's gradient 0 on every other
    row of the batch, so that some rows see acc + g² = 0 and stay where they are."""
    rng = np.random.default_rng(seed)
    cols = sum(bags)
    if ids is None:
        ids = rng.integers(0, rows, size=(b, cols))
    table = rng.normal(0, 0.1, size=(rows, width))
    acc = np.abs(rng.normal(0, 1e-2, size=(rows, width)))
    acc[rng.random(rows) < 0.25] = 0.0
    grad = rng.normal(0, 1e-2, size=(b, len(bags), width))
    grad[::2, 0] = 0.0
    f32 = lambda x: torch.from_numpy(np.ascontiguousarray(x).astype(np.float32))   # noqa: E731
    return f32(table), f32(acc), torch.from_numpy(np.asarray(ids, dtype=np.int64)), f32(grad)


def _crafted(width=8, seed=3):
    """One id a row (a single one-id bag), the rows of CRAFTED's segments in a
    shuffled order: the sorted order's slices fall where CRAFTED says."""
    rng = np.random.default_rng(seed)
    keys = np.repeat(np.arange(len(CRAFTED)) * 3 + 1, CRAFTED)
    ids = rng.permutation(keys)[:, None]
    return _problem(3 * len(CRAFTED) + 2, ids.shape[0], bags=(1,), width=width, seed=seed,
                    ids=ids)


def _torch_form(table, acc, ids, grad, bags):
    count = torch.zeros((), dtype=torch.int64)
    spec = emb_ops.BagSpec(tuple(int(table.shape[0]) for _ in bags), tuple(bags))
    emb_ops.bag_adagrad_torch(table, acc, emb_ops.BagGrad(ids, grad, spec), LR, EPS, count)
    return count


def _reference(table, acc, ids, grad, bags, slice_ids=ba.SLICE):
    count = torch.zeros((), dtype=torch.int64)
    ba.bag_adagrad_reference(table, acc, ids, grad, _column_field(bags), LR, EPS, count,
                             slice_ids=slice_ids)
    return count


def _loop_sums(ids, grad, bags, slice_ids):
    """Each distinct id's summed gradient, written as the kernel's order reads: the
    ids in (key, position) order, each segment cut at the multiples of ``slice_ids``
    of that order, each piece summed from 0 in order, the pieces added from 0."""
    cols = _column_field(bags)
    flat = ids.reshape(-1).tolist()
    g = grad.numpy()
    order = sorted(range(len(flat)), key=lambda p: (flat[p], p))
    out, i = {}, 0
    while i < len(order):
        j = i
        while j < len(order) and flat[order[j]] == flat[order[i]]:
            j += 1
        total, k = np.zeros(g.shape[2], np.float32), i
        while k < j:
            end = min(j, (k // slice_ids + 1) * slice_ids)
            part = np.zeros(g.shape[2], np.float32)
            for q in range(k, end):
                p = order[q]
                part = part + g[p // len(cols), cols[p % len(cols)]]
            total, k = total + part, end
        out[flat[order[i]]] = total
        i = j
    return out


# ------------------------------------------------------------------ the checks

def _refusal(name):
    table, acc, ids, grad = _problem(40, 6)
    cols, count = _column_field(BAGS), torch.zeros((), dtype=torch.int64)
    if name == "dtype":
        table, acc = table.double(), acc.double()
    elif name == "width":
        table, acc, grad = table[:, :6].contiguous(), acc[:, :6].contiguous(), grad[..., :6]
    elif name == "wide":
        table = torch.zeros(40, 132)
        acc, grad = torch.zeros(40, 132), torch.zeros(6, len(BAGS), 132)
    elif name == "rows":
        table = torch.empty((ba.INDEX_LIMIT, 8), device="meta")
        acc = torch.empty((ba.INDEX_LIMIT, 8), device="meta")
    elif name == "noncontiguous":
        table = torch.zeros(8, 40).T
    elif name == "strides":
        grad = torch.zeros(6, 8, len(BAGS)).transpose(1, 2)
    elif name == "ids":
        ids = ids.float()
    elif name == "columns":
        cols = cols[:-1]
    elif name == "field":
        cols = cols[:-1] + (len(BAGS),)
    elif name == "count":
        count = torch.zeros((), dtype=torch.int32)
    return table, acc, ids, grad, cols, count


REFUSALS = {"dtype": "not float32", "width": "width 6", "wide": "width 132",
            "rows": "2147483648 rows", "noncontiguous": "table is not contiguous",
            "strides": "strides \\(32, 1, 4\\) are not \\(4k, 4k, 1\\)",
            "ids": "not \\(B, columns\\) int32 or int64", "columns": "11 columns of ids for a map of 10", "field": "a column's field",
            "count": "count is not one int64", "device": "takes CUDA tensors, not cpu"}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_check_bags_refuses_before_the_device(name):
    """The checks a launch goes through, on CPU operands (the 2^31-row table on the
    meta device): each refusal names what the kernel does not take, and only
    operands it would take reach the device's refusal."""
    with pytest.raises(ValueError, match=REFUSALS[name]):
        ba.check_bags(*_refusal(name))


def test_the_wrapper_refuses_cpu_operands_before_any_launch():
    before = ba.bag_adagrad.launches
    table, acc, ids, grad, cols, count = _refusal("device")
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        ba.bag_adagrad(table, acc, ids, grad, cols, LR, EPS, count)
    assert ba.bag_adagrad.launches == before


# ------------------------------------------------- the kernel's order, on the CPU

CASES = {"bags": lambda: (_problem(40, 24), BAGS), "crafted": lambda: (_crafted(), (1,)),
         "one_row": lambda: (_problem(1, 30), BAGS),
         "hot": lambda: (_problem(3, 64, bags=(4, 1, 2)), (4, 1, 2))}


@pytest.mark.parametrize("slice_ids", [ba.SLICE, 4])
@pytest.mark.parametrize("case", sorted(CASES))
def test_segment_sums_equal_a_loop_over_the_segments_to_the_bit(case, slice_ids):
    (table, acc, ids, grad), bags = CASES[case]()
    keys, pos = torch.sort(ids.reshape(-1), stable=True)
    rows, sums = ba.segment_sums(keys, pos, grad, _column_field(bags), slice_ids=slice_ids)
    want = _loop_sums(ids, grad, bags, slice_ids)
    assert rows.tolist() == sorted(want)
    got = sums.numpy()
    for i, r in enumerate(rows.tolist()):
        assert np.array_equal(got[i].view(np.int32), want[r].view(np.int32)), r


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_kernels_order_matches_the_torch_form(case):
    """Against ``bag_adagrad_`` on the CPU: the table and the accumulator within
    float32 rounding, the count exact (the distinct ids), and every row that no id
    reads unchanged to the bit in both."""
    (table, acc, ids, grad), bags = CASES[case]()
    got, want = (table.clone(), acc.clone()), (table.clone(), acc.clone())
    n_got = _reference(*got, ids, grad, bags)
    n_want = _torch_form(*want, ids, grad, bags)
    distinct = int(torch.unique(ids).numel())
    assert int(n_got) == int(n_want) == distinct
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-7)
    off = torch.ones(table.shape[0], dtype=torch.bool)
    off[ids.reshape(-1)] = False
    for t, t0 in zip((*got, *want), (table, acc, table, acc)):
        assert torch.equal(t[off], t0[off])
    moved = got[0][~off] != table[~off]
    assert bool(moved.any())
    # a row whose ids all read zero gradients where its accumulator is 0 stays put
    still = (got[1][~off] == 0).all(dim=1)
    assert torch.equal(got[0][~off][still], table[~off][still])


def test_the_kernels_order_equals_the_torch_form_to_the_bit_where_ids_are_distinct():
    b, bags = 30, BAGS
    ids = torch.randperm(1000, generator=torch.Generator().manual_seed(2))[:b * sum(bags)]
    table, acc, ids, grad = _problem(1000, b, ids=ids.view(b, -1).numpy())
    got, want = (table.clone(), acc.clone()), (table.clone(), acc.clone())
    _reference(*got, ids, grad, bags)
    _torch_form(*want, ids, grad, bags)
    for a, b_ in zip(got, want):
        assert torch.equal(a.view(torch.int32), b_.view(torch.int32))


def test_a_one_row_table_takes_every_id_as_one_segment_of_many_slices():
    """A warm-up's stand-in: every id clipped to row 0, 120 ids in 4 slices."""
    (table, acc, ids, grad), bags = CASES["one_row"]()
    assert ids.numel() > 3 * ba.SLICE and int(ids.max()) == 0
    got = (table.clone(), acc.clone())
    assert int(_reference(*got, ids, grad, bags)) == 1
    total = _loop_sums(ids, grad, bags, ba.SLICE)[0]
    a = acc[0].numpy() + total * total
    assert np.array_equal(got[1][0].numpy(), a)


def test_the_cpu_keeps_the_torch_form_and_launches_nothing():
    """``Optimizer.update`` on a bag table on the CPU runs ``bag_adagrad_``'s torch
    form: equal to it to the bit, the kernel's count and ``profiling.counters()``'s
    ``bag_adagrad`` launches unchanged at 0."""
    (table, acc, ids, grad), bags = CASES["bags"]()
    spec = emb_ops.BagSpec(tuple(40 for _ in bags), bags)
    before = ba.bag_adagrad.launches
    assert profiling.counters()["launches"]["bag_adagrad"] == before == 0
    opt = trainer.make_optimizer(TrainConfig(optimizer_type="adag", learning_rate=LR,
                                             weight_decay=0.0))
    params = {"bags": {"dense": table.clone()}, "w": torch.ones(3)}
    state = opt.init(params)
    opt.update(params, [emb_ops.BagGrad(ids, grad, spec), torch.full((3,), 0.5)], state)
    want = (table.clone(), acc.new_zeros(acc.shape))
    _torch_form(*want, ids, grad, bags)
    assert torch.equal(params["bags"]["dense"], want[0])
    assert bool((params["w"] < 1).all())
    assert ba.bag_adagrad.launches == 0
    assert profiling.counters()["launches"]["bag_adagrad"] == 0


# ------------------------------------------------------------------- on the card

def _inside_x0(grad):
    """``grad`` as the backward hands the bags' gradient over: a view of the fields'
    columns inside a wider (B, 1 + fields, E) gradient, as x₀'s holds the bags."""
    wide = torch.zeros(grad.shape[0], 1 + grad.shape[1], grad.shape[2], device=grad.device)
    wide[:, 1:] = grad
    return wide[:, 1:]


CARD_CASES = {**CASES, "wide": lambda: (_problem(5000, 512, width=128, seed=7), BAGS),
              "strided": lambda: (_problem(900, 256, width=128, seed=8), BAGS),
              "crafted_wide": lambda: (_crafted(width=128), (1,)),
              "ragged": lambda: (_problem(300, 333, bags=(1, 1, 1), width=12, seed=9),
                                 (1, 1, 1))}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_cuda_kernel_equals_its_order_reference_to_the_bit(case):
    """On the card: the kernel against :func:`bag_adagrad_reference` on the same
    operands, table, accumulator and count equal to the bit; a second run from the
    same state equal to the first; 2 launches a step."""
    dev = _card()
    (table, acc, ids, grad), bags = CARD_CASES[case]()
    table, acc, ids, grad = (t.to(dev) for t in (table, acc, ids, grad))
    if case == "strided":
        grad = _inside_x0(grad)
        assert not grad.is_contiguous()
    cols = _column_field(bags)
    runs = []
    for _ in range(2):
        got, count = (table.clone(), acc.clone()), torch.zeros((), dtype=torch.int64, device=dev)
        before = ba.bag_adagrad.launches
        ba.bag_adagrad(*got, ids, grad, cols, LR, EPS, count)
        assert ba.bag_adagrad.launches == before + ba.LAUNCHES
        runs.append((*got, count))
    want, n_want = (table.clone(), acc.clone()), torch.zeros((), dtype=torch.int64, device=dev)
    ba.bag_adagrad_reference(*want, ids, grad, cols, LR, EPS, n_want)
    torch.cuda.synchronize()
    for run in runs:
        assert int(run[2]) == int(n_want) == int(torch.unique(ids).numel())
        for a, b in zip(run[:2], want):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
def test_cuda_wrapper_refuses_an_operand_off_16_bytes_before_any_launch():
    dev = _card()
    table, acc, ids, grad = (t.to(dev) for t in _problem(40, 6))
    shifted = torch.zeros(table.numel() + 1, device=dev)[1:].view(table.shape)
    before = ba.bag_adagrad.launches
    with pytest.raises(ValueError, match="16 bytes"):
        ba.bag_adagrad(shifted, acc, ids, grad, _column_field(BAGS), LR, EPS,
                       torch.zeros((), dtype=torch.int64, device=dev))
    assert ba.bag_adagrad.launches == before


@pytest.mark.cuda
def test_cuda_kernel_in_a_graph_equals_eager_steps():
    """On the card: a step captured into a CUDA graph and replayed 3 times on fresh
    gradients against 3 eager steps: equal to the bit after each."""
    dev = _card()
    (table, acc, ids, grad), bags = CARD_CASES["wide"]()
    table, acc, ids, grad = (t.to(dev) for t in (table, acc, ids, grad))
    cols = _column_field(bags)
    got, want = (table.clone(), acc.clone()), (table.clone(), acc.clone())
    counts = [torch.zeros((), dtype=torch.int64, device=dev) for _ in range(2)]
    static = grad.clone()
    ba.bag_adagrad(*got, ids, static, cols, LR, EPS, counts[0])      # loads the kernel
    ba.bag_adagrad(*want, ids, static, cols, LR, EPS, counts[1])
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        ba.bag_adagrad(*got, ids, static, cols, LR, EPS, counts[0])
    for k in range(3):
        static.copy_(grad * (k + 2))
        graph.replay()
        ba.bag_adagrad(*want, ids, static, cols, LR, EPS, counts[1])
        torch.cuda.synchronize()
        assert torch.equal(counts[0], counts[1])
        for a, b in zip(got, want):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32)), k
