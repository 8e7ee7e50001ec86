"""The fused int8 tower: plain version against the Pallas kernel, the CPU
route of the wrapper, and (on a machine with an NVIDIA GPU) the CUDA kernel
against the plain version.

Only the Pallas comparison imports JAX, so that the CUDA tests also run on
a GPU machine without it:
``python -m pytest --noconftest tests/test_torch_int8_mlp.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from xsdeepfwfm_deprecated_torch.ops import quantized as t_q
from xsdeepfwfm_deprecated_torch.ops.cuda import int8_mlp as t_k


def _deep_q(in_dim, hidden, seed):
    """A per-channel quantized tower (the port's ``deep_q['net_1']``) from
    seeded numpy weights."""
    rng = np.random.default_rng(seed)
    dims = [in_dim] + list(hidden)
    layers = []
    for fi, fo in zip(dims[:-1], dims[1:]):
        w = torch.from_numpy((rng.normal(size=(fi, fo)) * (2.0 / (fi + fo)) ** 0.5)
                             .astype(np.float32))
        w_q, w_s = t_q.quantize_symmetric(w, axis=1)
        b = torch.from_numpy((rng.normal(size=(fo,)) * 0.1).astype(np.float32))
        layers.append({"w_q": w_q, "w_scale": w_s.reshape(-1), "b": b})
    fc_q, fc_s = t_q.quantize_symmetric(
        torch.from_numpy((rng.normal(size=(dims[-1], 1)) * 0.2).astype(np.float32)), axis=1)
    return {"net_1": {"layers": layers, "fc": {"w_q": fc_q, "w_scale": fc_s.reshape(-1)}}}


def _tiles_with_different_scales(b, k, block_b, seed):
    x = np.random.default_rng(seed).normal(size=(b, k)).astype(np.float32)
    for i in range(b // block_b):
        x[i * block_b:(i + 1) * block_b] *= 0.5 + i        # every tile its own scale
    return x


def test_reference_matches_pallas_interpret():
    """Four tiles with different scales, K = 50 (not a multiple of 8).
    atol 1e-4: the int8 codes and int32 sums agree exactly, the float
    epilogue may round differently in the last bit."""
    import jax.numpy as jnp

    from xsdeepfwfm_deprecated_tpu.ops.pallas.int8_mlp import int8_mlp_pallas
    deep_q = _deep_q(50, [40, 40], seed=0)
    net = deep_q["net_1"]
    layers_j = tuple((jnp.asarray(l["w_q"].numpy()), jnp.asarray(l["w_scale"].numpy()),
                      jnp.asarray(l["b"].numpy())) for l in net["layers"])
    fc_j = (jnp.asarray(net["fc"]["w_q"].numpy()), jnp.asarray(net["fc"]["w_scale"].numpy()))
    x = _tiles_with_different_scales(256, 50, 64, seed=1)
    want = np.asarray(int8_mlp_pallas(jnp.asarray(x), layers_j, fc_j, block_b=64,
                                      interpret=True))
    layers_t, fc_t = t_k.pack_quantized_deep(deep_q)
    got = t_k.int8_mlp_reference(torch.from_numpy(x), layers_t, fc_t, block_b=64)
    assert got.shape == (256, 1) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    # per-tile scales matter: one tile over the whole batch gives other codes
    whole = t_k.int8_mlp_reference(torch.from_numpy(x), layers_t, fc_t, block_b=256)
    assert not np.allclose(whole.numpy(), want, rtol=0, atol=1e-4)


def test_pack_quantized_deep_layout():
    deep_q = _deep_q(50, [40, 40], seed=2)
    layers_t, (fc, fc_scale) = t_k.pack_quantized_deep(deep_q)
    assert len(layers_t) == 2 and fc.shape == (64,) and fc_scale.shape == (1,)
    w_t, w_scale, b = layers_t[0]
    assert w_t.shape == (64, 64) and w_t.dtype == torch.int8
    assert torch.equal(w_t[:40, :50], deep_q["net_1"]["layers"][0]["w_q"].T)
    assert not w_t[40:].any() and not w_t[:, 50:].any()
    assert not w_scale[40:].any() and not b[40:].any() and not fc[40:].any()


def test_cpu_wrapper_runs_the_plain_version():
    layers_t, fc_t = t_k.pack_quantized_deep(_deep_q(50, [40, 40], seed=3))
    x = torch.from_numpy(_tiles_with_different_scales(128, 50, 64, seed=4))
    before = t_k.int8_mlp.launches
    got = t_k.int8_mlp(x, layers_t, fc_t, block_b=64)
    assert t_k.int8_mlp.launches == before          # no kernel launch on the CPU
    assert torch.equal(got, t_k.int8_mlp_reference(x, layers_t, fc_t, block_b=64))
    # block_b = min(block_b, B), as in JAX
    assert torch.equal(t_k.int8_mlp(x[:64], layers_t, fc_t),
                       t_k.int8_mlp_reference(x[:64], layers_t, fc_t, block_b=64))


def test_wrapper_rejects_other_devices_and_ragged_batches():
    layers_t, fc_t = t_k.pack_quantized_deep(_deep_q(50, [40], seed=5))
    with pytest.raises(ValueError, match="unsupported device"):
        t_k.int8_mlp(torch.zeros((64, 50), device="meta"), layers_t, fc_t)
    with pytest.raises(ValueError, match="multiple of block_b"):
        t_k.int8_mlp_reference(torch.zeros((96, 50)), layers_t, fc_t, block_b=64)


@pytest.mark.cuda
@pytest.mark.parametrize("in_dim,hidden,b,block_b", [(50, [40, 40], 256, 64),
                                                     (390, [400, 400, 400], 2048, 512)])
def test_cuda_kernel_matches_plain_version(in_dim, hidden, b, block_b):
    """On the card: the kernel against the plain version on the same inputs.
    atol 1e-4, the tolerance of the fused path: codes and int32 sums are
    exact and the epilogue rounds as the plain version does."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    layers_t, fc_t = t_k.pack_quantized_deep(_deep_q(in_dim, hidden, seed=6))
    layers_d = tuple(tuple(t.to(dev) for t in layer) for layer in layers_t)
    fc_d = tuple(t.to(dev) for t in fc_t)
    x = torch.from_numpy(_tiles_with_different_scales(b, in_dim, block_b, seed=7)).to(dev)
    before = t_k.int8_mlp.launches
    got = t_k.int8_mlp(x, layers_d, fc_d, block_b=block_b)
    torch.cuda.synchronize()
    assert t_k.int8_mlp.launches == before + 1
    want = t_k.int8_mlp_reference(x, layers_d, fc_d, block_b=block_b)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=0, atol=1e-4)
