"""One CIN layer (``ops/cuda/cin.py``, ``csrc/cin.cu``): on the CPU, the layer's
plain forward and plain backward against autograd over the materialized form
in float64 (``gradcheck`` on the layer ``Function``) at ragged tiny shapes; no
launch counted; the wrapper's refusals; W_k's packed tiles against their index
formulas; dW's split over the rows. On the card (marked ``cuda``): the kernels
against the plain version at ragged shapes and at the xDeepFM cell's, two runs
bit-equal, the launches counted eagerly and through a graph's replay. No JAX
here, so the card's machine runs the card's tests:
``python -m pytest --noconftest tests/test_torch_cin.py -m cuda``.

Tolerances on the card: the kernels and the plain version (cuBLAS) sum the same
float32 products in other orders, so they part by a few units in the last
place of the sum of the terms' magnitudes; at the cell's depth (7,800 terms a
value) that is below 1e-5 of the largest value of a result.
"""

import pytest
import torch

from xsdeepfwfm_deprecated_torch.ops import interactions
from xsdeepfwfm_deprecated_torch.ops.cuda import cin as cin_ops

# (H_{k-1}, m, H_k, rows): ragged against the 80 x 200 tile and the 25-deep k-tile
SHAPES = [(5, 5, 7, 83), (7, 5, 3, 9), (3, 3, 2, 1), (11, 7, 203, 161)]


def _operands(hp, m, h, rows, seed=0, dtype=torch.float64, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    xk1t = torch.randn((hp, rows), generator=g, dtype=dtype)
    x0t = torch.randn((m, rows), generator=g, dtype=dtype)
    w = torch.randn((h, hp * m), generator=g, dtype=dtype) / (hp * m) ** 0.5
    return [t.to(device) for t in (xk1t, x0t, w)]


def _materialized(xk1t, x0t, w):
    """The layer as autograd sees it written out: (M, H_{k-1}·m) z, one GEMM."""
    rows = xk1t.shape[1]
    z = (xk1t.T.unsqueeze(-1) * x0t.T.unsqueeze(-2)).reshape(rows, -1)
    return (z @ w.T).T


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_forward_and_backward_match_autograd_over_the_materialized_form(shape):
    ops = [t.requires_grad_() for t in _operands(*shape)]
    g = torch.randn(shape[2], shape[3], generator=torch.Generator().manual_seed(3),
                    dtype=torch.float64)
    got = cin_ops.CinLayer.apply(*ops)
    want = _materialized(*ops)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    for a, b in zip(torch.autograd.grad(got, ops, g), torch.autograd.grad(want, ops, g)):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("shape", SHAPES[:3])
def test_gradcheck_on_the_layer_function(shape):
    ops = [t.requires_grad_() for t in _operands(*shape, seed=1)]
    assert torch.autograd.gradcheck(cin_ops.CinLayer.apply, ops)
    # layer 1: X0 on both sides, autograd adds the two gradients
    x0t, w = _operands(shape[1], shape[1], shape[2], shape[3], seed=2)[1:]
    x0t.requires_grad_()
    w.requires_grad_()
    assert torch.autograd.gradcheck(lambda x, v: cin_ops.CinLayer.apply(x, x, v), (x0t, w))


def test_the_cpu_counts_no_launch():
    before = cin_ops.cin.launches
    x0 = torch.randn(4, 6, 3, requires_grad=True)
    weights = [torch.randn(5, 36, requires_grad=True), torch.randn(3, 30, requires_grad=True)]
    out = interactions.cin_forward(x0, weights)
    assert out.shape == (4, 8)
    out.square().sum().backward()
    assert cin_ops.cin.launches == before
    assert all(t.grad is not None and t.grad.abs().sum() > 0 for t in [x0, *weights])


def test_cin_forward_keeps_the_cin_of_the_batch_major_form():
    """The feature-major layers give the (B, D, H) materialized form's p⁺."""
    g = torch.Generator().manual_seed(5)
    x0 = torch.randn(6, 5, 3, generator=g, dtype=torch.float64)
    weights = [torch.randn(7, 25, generator=g, dtype=torch.float64),
               torch.randn(4, 35, generator=g, dtype=torch.float64)]
    x0t = x0.transpose(1, 2)
    h, pooled = x0t, []
    for w in weights:
        z = (h.unsqueeze(-1) * x0t.unsqueeze(-2)).reshape(6 * 3, -1)
        h = (z @ w.T).reshape(6, 3, -1)
        pooled.append(h.sum(dim=1))
    want = torch.cat(pooled, dim=1)
    # the wrapper takes float32 only: run the layers' Function as cin_forward does
    got_t = [x0.permute(1, 0, 2).reshape(5, 18)]
    for w in weights:
        got_t.append(cin_ops.CinLayer.apply(got_t[-1], got_t[0], w))
    got = torch.cat([t.view(-1, 6, 3).sum(dim=2).T for t in got_t[1:]], dim=1)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    f32 = interactions.cin_forward(x0.float(), [w.float() for w in weights])
    torch.testing.assert_close(f32, want.float(), rtol=1e-5, atol=1e-5)


REFUSALS = {
    "float64": ("not float32", lambda a, b, w: (a.double(), b, w)),
    "non-contiguous X^{k-1}": ("not contiguous", lambda a, b, w: (a.T.contiguous().T, b, w)),
    "non-contiguous W_k": ("not contiguous", lambda a, b, w: (a, b, w.T.contiguous().T)),
    "W_k's width": (r"W_k is \(3, 34\)", lambda a, b, w: (a, b, w[:, :34].contiguous())),
    "rows": ("rows", lambda a, b, w: (a, b[:, :8].contiguous(), w)),
    "3-d": ("not 2-d", lambda a, b, w: (a.unsqueeze(0), b, w)),
    "fields": ("201 fields", lambda a, b, w: (a, b.new_zeros(201, 9), w.new_zeros(3, 7 * 201))),
}


def _refusal(name, device):
    a, b, w = _operands(7, 5, 3, 9, dtype=torch.float32, device=device)
    return REFUSALS[name][1](a, b, w)


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_the_wrapper_refuses_what_the_kernels_do_not_take(name):
    with pytest.raises(ValueError, match=REFUSALS[name][0]):
        cin_ops.cin(*_refusal(name, "cpu"))


def test_the_wrapper_refuses_more_values_than_32_bit_offsets_reach():
    xk1t, x0t = torch.empty((2, 1 << 30), device="meta"), torch.empty((3, 1 << 30), device="meta")
    with pytest.raises(ValueError, match="32 bits"):
        cin_ops.cin(xk1t, x0t, torch.empty((4, 6), device="meta"))


@pytest.mark.parametrize("h,k", [(3, 35), (200, 7800), (203, 26)])
def test_the_forward_tiles_hold_w_in_the_kernels_order(h, k):
    w = torch.arange(h * k, dtype=torch.float32).view(h, k) + 1
    wf = cin_ops.pack_forward(w)
    nt, kt = -(-h // cin_ops.COLS), -(-k // cin_ops.DEPTH)
    assert wf.shape == (nt, kt, cin_ops.DEPTH, cin_ops.COLS) and wf.is_contiguous()
    n = torch.arange(nt * cin_ops.COLS).view(nt, 1, 1, -1)
    c = (torch.arange(kt).view(1, -1, 1, 1) * cin_ops.DEPTH
         + torch.arange(cin_ops.DEPTH).view(1, 1, -1, 1))
    inside = (n < h) & (c < k)
    want = torch.where(inside, w[n.clamp(max=h - 1), c.clamp(max=k - 1)], torch.zeros(()))
    assert torch.equal(wf, want)


@pytest.mark.parametrize("h,hp,m", [(3, 7, 5), (200, 200, 39), (200, 39, 39), (30, 2, 200),
                                    (7, 9, 1)])
def test_the_dx_tiles_hold_whole_fields_in_the_kernels_order(h, hp, m):
    w = torch.arange(h * hp * m, dtype=torch.float32).view(h, hp * m) + 1
    wx = cin_ops.pack_grad_x(w, m)
    g = cin_ops.fields_a_chunk(m)
    chunks, kt = -(-hp // g), -(-h // cin_ops.DEPTH)
    assert g * m <= cin_ops.COLS
    assert wx.shape == (chunks, kt, cin_ops.DEPTH, cin_ops.COLS) and wx.is_contiguous()
    for ch in range(chunks):
        for t in range(kt):
            for k in range(cin_ops.DEPTH):
                row = t * cin_ops.DEPTH + k
                cols = torch.arange(cin_ops.COLS)
                col = ch * g * m + cols
                inside = (row < h) & (cols < g * m) & (col < hp * m)
                want = torch.where(inside, w[min(row, h - 1), col.clamp(max=hp * m - 1)],
                                   torch.zeros(()))
                assert torch.equal(wx[ch, t, k], want), (ch, t, k)


@pytest.mark.parametrize("tiles,rows,sms,want", [(98, 40960, 132, 8), (20, 40960, 132, 39),
                                                 (1, 83, 132, 1), (1, 0, 132, 1),
                                                 (2, 100_000, 132, 64)])
def test_dw_splits_the_rows_into_full_slices(tiles, rows, sms, want):
    n, per = cin_ops.slices(tiles, rows, sms)
    assert n == want and per % cin_ops.DEPTH == 0
    assert (n - 1) * per < max(rows, 1) <= n * per or rows == 0


# ---- on the card

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _plain_and_kernel(shape, seed, dev):
    """The layer's output and gradients, kernels and plain version (float32, the
    same operands, the same incoming gradient)."""
    ops = _operands(*shape, seed=seed, dtype=torch.float32, device=dev)
    g = torch.randn(shape[2], shape[3], generator=torch.Generator().manual_seed(seed + 7)).to(dev)
    out = []
    for kernel in (True, False):
        leaves = [t.clone().requires_grad_() for t in ops]
        y = cin_ops.cin(*leaves) if kernel else cin_ops.cin_layer_reference(*leaves)
        out.append((y.detach(), *torch.autograd.grad(y, leaves, g)))
    return out


def _close(got, want):
    """Within 1e-5 of the largest value of the result (the module's tolerance)."""
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * max(scale, 1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES + [(200, 39, 200, 1000), (39, 39, 200, 2000)])
def test_cuda_kernels_match_the_plain_version(shape):
    dev = _card()
    before = cin_ops.cin.launches
    (y, *grads), (y_ref, *grads_ref) = _plain_and_kernel(shape, 11, dev)
    torch.cuda.synchronize()
    assert cin_ops.cin.launches - before in (3, 4)       # forward, dW (and its sum), dX
    for got, want in zip((y, *grads), (y_ref, *grads_ref)):
        _close(got, want)


@pytest.mark.cuda
def test_cuda_two_runs_are_bit_equal():
    dev = _card()
    runs = [_plain_and_kernel((200, 39, 200, 4000), 21, dev)[0] for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.cuda
def test_cuda_wrapper_refuses_before_any_launch():
    dev = _card()
    before = cin_ops.cin.launches
    for name in REFUSALS:
        with pytest.raises(ValueError):
            cin_ops.cin(*_refusal(name, dev))
    assert cin_ops.cin.launches == before


@pytest.mark.cuda
def test_cuda_cin_forward_in_a_graph_counts_its_launches_at_each_replay():
    from xsdeepfwfm_deprecated_torch.utils.cuda_graph import Graphed
    dev = _card()
    x0 = torch.randn(64, 39, 10, device=dev, requires_grad=True)
    weights = [torch.randn(200, 39 * 39, device=dev, requires_grad=True),
               torch.randn(200, 200 * 39, device=dev, requires_grad=True)]

    def step(x):
        x = x.detach().requires_grad_()
        out = interactions.cin_forward(x, weights)
        return torch.autograd.grad(out.square().sum(), [x, *weights])

    graph = Graphed(step, [x0], device=dev, name="cin_step")
    before = cin_ops.cin.launches
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    assert cin_ops.cin.launches - before == 2 * graph.captured["cin"] > 0
