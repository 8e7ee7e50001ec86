"""The port's ops against the JAX package's, on the CPU.

Inputs come from numpy with a seed; parameters cross with
``params_from_numpy``. Each comparison states its tolerance and why.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xsdeepfwfm_deprecated_tpu.ops import embedding as j_emb
from xsdeepfwfm_deprecated_tpu.ops import interactions as j_inter
from xsdeepfwfm_deprecated_tpu.ops import mlp as j_mlp
from xsdeepfwfm_deprecated_tpu.ops import quantized as j_q
from xsdeepfwfm_deprecated_torch.ops import embedding as t_emb
from xsdeepfwfm_deprecated_torch.ops import interactions as t_inter
from xsdeepfwfm_deprecated_torch.ops import mlp as t_mlp
from xsdeepfwfm_deprecated_torch.ops import quantized as t_q
from xsdeepfwfm_deprecated_torch.weights import params_from_numpy, params_to_numpy

SIZES = (1, 1, 1, 7, 12, 40, 300)
NUM = 3
B = 16


def _t(a):
    return torch.from_numpy(np.array(a))


def _batch(seed, out_of_range=True):
    rng = np.random.default_rng(seed)
    xi = rng.integers(0, SIZES[NUM:], size=(B, len(SIZES) - NUM)).astype(np.int32)
    if out_of_range:
        xi[0] = [999, -5, 40, 10**6]      # past the end, negative, at the end
    xv = rng.normal(size=(B, NUM)).astype(np.float32)
    return xi, xv


LOOKUP_CASES = [
    dict(),
    dict(qr_flag=True, qr_operation="mult", qr_threshold=10, qr_collisions=3),
    dict(qr_flag=True, qr_operation="add", qr_threshold=10, qr_collisions=3),
    dict(qr_flag=True, qr_operation="concat", qr_threshold=10, qr_collisions=3),
    dict(dtype="bf16"),
]


@pytest.mark.parametrize("fn", ["packed_lookup", "packed_lookup_serving"])
@pytest.mark.parametrize("case", LOOKUP_CASES, ids=["dense", "qr_mult", "qr_add", "qr_concat",
                                                    "bf16"])
def test_lookup_matches_jax(fn, case):
    """Gathers and one multiply per element, the same in both: exact."""
    case = dict(case)
    dtype = jnp.bfloat16 if case.pop("dtype", None) == "bf16" else jnp.float32
    spec_j = j_emb.make_spec(SIZES, NUM, **case)
    spec_t = t_emb.make_spec(SIZES, NUM, **case)
    assert spec_t == t_emb.PackedEmbeddingSpec(**vars(spec_j))
    tables_j = j_emb.init_tables(jax.random.PRNGKey(0), spec_j, 6, scale=0.5, dtype=dtype)
    tables_t = params_from_numpy(jax.tree.map(np.asarray, tables_j), "cpu")
    xi, xv = _batch(1)
    want = np.asarray(getattr(j_emb, fn)(tables_j, spec_j, jnp.asarray(xi), jnp.asarray(xv)),
                      np.float32)
    got = getattr(t_emb, fn)(tables_t, spec_t, _t(xi), _t(xv))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_out_of_range_index_reads_last_row():
    spec = t_emb.make_spec(SIZES, NUM)
    table = {"dense": torch.arange(spec.dense_rows * 2, dtype=torch.float32).reshape(-1, 2)}
    xi = torch.tensor([[999, -5, 40, 10**6]], dtype=torch.int32)
    out = t_emb.packed_lookup_serving(table, spec, xi, torch.ones((1, NUM)))
    last = [spec.dense_offsets[f] + SIZES[f] - 1 for f in range(NUM, len(SIZES))]
    first = [spec.dense_offsets[f] for f in range(NUM, len(SIZES))]
    rows = [last[0], first[1], last[2], last[3]]
    np.testing.assert_array_equal(out[0, NUM:].numpy(), table["dense"][rows].numpy())


def _interaction_inputs(seed):
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(8, 5, 4)).astype(np.float32)
    r = rng.normal(size=(5, 5)).astype(np.float32)
    w = rng.normal(size=(5, 4)).astype(np.float32)
    pairs = rng.normal(size=(8, 5, 5, 4)).astype(np.float32)
    return emb, r, w, pairs


@pytest.mark.parametrize("name", ["fm_second_order", "fwfm_second_order", "fwfm_linear_term",
                                  "ffm_second_order"])
def test_interactions_match_jax(name):
    """float32 sums in another order: rtol/atol 1e-5."""
    emb, r, w, pairs = _interaction_inputs(2)
    args = {"fm_second_order": (emb,), "fwfm_second_order": (emb, r),
            "fwfm_linear_term": (emb, w), "ffm_second_order": (pairs,)}[name]
    want = np.asarray(getattr(j_inter, name)(*map(jnp.asarray, args)))
    got = getattr(t_inter, name)(*map(_t, args)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("masked", [False, True])
def test_mlp_forward_matches_jax(ndim, masked):
    """float32 matmuls in another order: rtol/atol 1e-5."""
    net_j = j_mlp.init_mlp(jax.random.PRNGKey(3), 6 * 4, [32, 16], head_scale=0.3)
    net_np = jax.tree.map(np.asarray, net_j)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(8, 6, 4) if ndim == 3 else (8, 24)).astype(np.float32)
    masks = None
    if masked:
        masks = {"layers": [(rng.random(l["w"].shape) > 0.3).astype(np.float32)
                            for l in net_np["layers"]],
                 "fc_w": (rng.random(net_np["fc_w"].shape) > 0.3).astype(np.float32)}
    want = np.asarray(j_mlp.mlp_forward(net_j, jnp.asarray(x), dropout_rates=(0.5,) * 3,
                                        masks=jax.tree.map(jnp.asarray, masks)))
    got = t_mlp.mlp_forward(params_from_numpy(net_np, "cpu"), _t(x), dropout_rates=(0.5,) * 3,
                            masks=params_from_numpy(masks, "cpu")).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_dropout_with_generator():
    x = torch.ones(200_000)
    a = t_mlp.dropout(torch.Generator().manual_seed(5), x, 0.25, train=True)
    b = t_mlp.dropout(torch.Generator().manual_seed(5), x, 0.25, train=True)
    assert torch.equal(a, b)                                    # seeded
    assert set(torch.unique(a).tolist()) == {0.0, float(np.float32(1.0) / np.float32(0.75))}
    assert abs(float((a == 0).float().mean()) - 0.25) < 0.01    # ~5 sigma
    assert torch.equal(t_mlp.dropout(None, x, 0.25, train=True), x)
    assert torch.equal(t_mlp.dropout(torch.Generator(), x, 0.25, train=False), x)


def test_init_mlp_shapes_and_layout():
    net = t_mlp.init_mlp(torch.Generator().manual_seed(0), 24, [32, 16], 0.3)
    assert [tuple(l["w"].shape) for l in net["layers"]] == [(24, 32), (32, 16)]
    assert tuple(net["fc_w"].shape) == (16, 1)
    tree = params_to_numpy(net)
    assert isinstance(tree["layers"], list) and tree["layers"][0]["w"].dtype == np.float32


def test_quantize_embedding_rows_bytes_equal_jax():
    """Rounding half-to-even and the inline f32 scale: byte-exact."""
    rng = np.random.default_rng(4)
    table = (rng.normal(size=(300, 10)) * 0.01).astype(np.float32)
    table[7] = 0.0                                   # the 1e-12 floor
    table[8, :2] = [0.5, -0.0015]                    # a half-way code
    want = np.asarray(j_q.quantize_embedding_rows(jnp.asarray(table))["qs"])
    got = t_q.quantize_embedding_rows(_t(table))["qs"]
    assert got.dtype == torch.int8 and got.shape == (300, 14)
    np.testing.assert_array_equal(got.numpy(), want)
    vals, scales = t_q.unpack_qs(got)
    j_vals, j_scales = j_q.unpack_qs(jnp.asarray(want))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(j_vals))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(j_scales))
    idx = np.array([[0, 5], [299, 7]])
    np.testing.assert_array_equal(
        t_q.gather_dequant({"qs": got}, _t(idx)).numpy(),
        np.asarray(j_q.gather_dequant({"qs": jnp.asarray(want)}, jnp.asarray(idx))))


@pytest.mark.parametrize("k", [50, 390, 2100])
def test_quantized_dense_int32_accumulators_exact(k):
    """Integer products: exact, including K past one float32 chunk (1040)."""
    rng = np.random.default_rng(k)
    x = rng.normal(size=(24, k)).astype(np.float32)
    w = rng.normal(size=(k, 12)).astype(np.float32)
    wq_j, ws_j = j_q.quantize_symmetric(jnp.asarray(w), axis=1)
    wq_t, ws_t = t_q.quantize_symmetric(_t(w), axis=1)
    np.testing.assert_array_equal(wq_t.numpy(), np.asarray(wq_j))
    np.testing.assert_array_equal(ws_t.numpy(), np.asarray(ws_j))
    xq_j, xs_j = j_q.quantize_symmetric(jnp.asarray(x))
    xq_t, xs_t = t_q.quantize_symmetric(_t(x))
    np.testing.assert_array_equal(xq_t.numpy(), np.asarray(xq_j))
    want = np.asarray(jax.lax.dot_general(xq_j, wq_j, (((1,), (0,)), ((), ())),
                                          preferred_element_type=jnp.int32))
    got = t_q.exact_int_matmul(xq_t, wq_t)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    b = rng.normal(size=(12,)).astype(np.float32)
    out_j = np.asarray(j_q.quantized_dense(jnp.asarray(x), wq_j, ws_j.reshape(-1), jnp.asarray(b)))
    out_t = t_q.quantized_dense(_t(x), wq_t, ws_t.reshape(-1), _t(b)).numpy()
    np.testing.assert_array_equal(out_t, out_j)
    static = np.float32(0.02)
    out_j = np.asarray(j_q.quantized_dense(jnp.asarray(x), wq_j, ws_j.reshape(-1), None,
                                           jnp.float32(static)))
    out_t = t_q.quantized_dense(_t(x), wq_t, ws_t.reshape(-1), None, _t(static)).numpy()
    np.testing.assert_array_equal(out_t, out_j)
