"""The fp32 forward at a small batch (``ops/cuda/small_forward.py``,
``csrc/small_forward.cu``). On the CPU: which configurations and batches the
route takes, the plain version against the JAX package's ``Predictor`` and
bit for bit against the port's graph of ops, the ``Predictor``'s choice of
route, and the tower's column-slice layout. On the card (marked ``cuda``): the
two kernels against the plain version at the Avazu and Criteo widths and every
batch the route takes, and the launches a ``Predictor`` request adds. On both: a
``Predictor`` serves one model at every batch size after its caller's params
change in place.

Only the JAX comparison imports JAX (inside the test), so that the card's
machine runs the card's tests:
``python -m pytest --noconftest tests/test_torch_small_forward.py -m cuda``.

Tolerance on the card: the kernels sum the same float32 products as the graph
of ops in another order (the tower's 300 to 460 terms a value split over the
threads and blocks, FwFM's second order over field pairs and not as
``0.5 (pair - diagonal)``), so the logits part by a few units in the last
place of the terms' magnitudes: within 1e-5 of the largest |logit| and 1.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

from xsdeepfwfm_deprecated_torch import weights
from xsdeepfwfm_deprecated_torch.config import ModelConfig
from xsdeepfwfm_deprecated_torch.models import deepfwfm
from xsdeepfwfm_deprecated_torch.ops.cuda import small_forward as sf
from xsdeepfwfm_deprecated_torch.ops.embedding import packed_lookup_serving
from xsdeepfwfm_deprecated_torch.serving import predictor
from xsdeepfwfm_deprecated_torch.serving.predictor import Predictor

CONFIGS = pathlib.Path(__file__).resolve().parents[1] / "port_bench" / "configs"
KEYS = ("field_size", "numerical", "embedding_size", "deep_nodes", "h_depth", "use_fwfm",
        "use_deep", "use_lw", "use_fwlw")
# the benchmark's two DeepFwFM configurations at their widths
WIDTHS = {"avazu": dict(field_size=23, numerical=1, embedding_size=20, deep_nodes=300, h_depth=3),
          "criteo": dict(field_size=39, numerical=13, embedding_size=10, deep_nodes=400,
                         h_depth=3)}
TOL = 1e-5


def _bench_config(name: str, **kw) -> ModelConfig:
    cfg = json.loads((CONFIGS / f"deepfwfm_{name}.json").read_text())
    return ModelConfig(feature_sizes=tuple(cfg["feature_sizes"]),
                       **{**{k: cfg[k] for k in KEYS}, **kw})


def _small_tables(name: str, **kw) -> dict:
    """The configuration's widths, flags and fields over small tables."""
    w = WIDTHS[name]
    cats = (3, 7, 11, 30, 5, 50, 2, 17)
    sizes = (1,) * w["numerical"] + tuple(cats[i % len(cats)]
                                          for i in range(w["field_size"] - w["numerical"]))
    return {"feature_sizes": sizes, "use_fwfm": True, "use_deep": True, "use_lw": True,
            "use_fwlw": True, **w, **kw}


def _rows(cfg: ModelConfig, b: int, seed: int):
    """Seeded requests with indices past both ends of their fields."""
    rng = np.random.default_rng(seed)
    hi = np.array(cfg.feature_sizes[cfg.numerical:])
    xi = rng.integers(-3, hi + 3, size=(b, len(hi))).astype(np.int32)
    xi[0, :3] = [-7, 10 ** 6, -1]
    xv = rng.normal(size=(b, cfg.numerical)).astype(np.float32)
    return xi, xv


def _pruned(tree: dict, seed: int) -> dict:
    """numpy leaves with a share of the tower's, R's and fwlw_w's values zeroed, as
    a pruned model has them."""
    rng = np.random.default_rng(seed)
    out = {k: _pruned(v, seed + 1) if isinstance(v, dict) else
           [_pruned(x, seed + 2) for x in v] if isinstance(v, list) else np.array(v)
           for k, v in tree.items()}
    for name in ("w", "field_cov", "fwlw_w"):
        if name in out:
            out[name][rng.random(out[name].shape) < 0.4] = 0.0
    return out


# ----------------------------------------------------------------- the route

@pytest.mark.parametrize("name", ["avazu", "criteo"])
def test_route_takes_the_benchmark_configs_at_small_batches(name):
    cfg = _bench_config(name)
    assert sf.small_forward_route(cfg, 1) and sf.small_forward_route(cfg, sf.SMALL_BATCH_MAX)
    assert not sf.small_forward_route(cfg, sf.SMALL_BATCH_MAX + 1)
    assert not sf.small_forward_route(cfg, 8192)
    assert not sf.small_forward_route(cfg, 0)
    dims = (cfg.field_size * cfg.embedding_size,) + cfg.deep_layers
    slots, slot = sf.tower_plan(dims, 1)
    assert slots == cfg.h_depth     # every layer's slab in shared memory at B=1
    assert sf.tower_plan(dims, sf.SMALL_BATCH_MAX)[0] >= 1
    assert sf.tower_smem(slots, slot, max(dims), 1) <= sf.MAX_SMEM


@pytest.mark.parametrize("kw", [
    dict(qr_flag=True, qr_threshold=200), dict(table_dtype="bf16"),
    dict(use_fwfm=False, use_fm=True), dict(use_fwfm=False, use_ffm=True),
    dict(use_fwfm=False, use_cin=True, cin_layers=(8, 8)), dict(quantization_aware=True),
    dict(num_deeps=2), dict(use_deep=False), dict(use_fwfm=False),
    dict(deep_nodes=8000),            # a slice wider than a block
    dict(h_depth=9),                  # more layers than the kernel's parameter block holds
], ids=["qr", "bf16", "fm", "ffm", "cin", "qat", "num_deeps2", "no_tower", "dnn", "wide", "deep"])
def test_route_refuses_other_models(kw):
    assert sf.small_forward_route(_bench_config("avazu"), 1)
    assert not sf.small_forward_route(_bench_config("avazu", **kw), 1)


def test_route_refuses_dlrm():
    sizes = (1, 1, 10, 20)
    cfg = ModelConfig(field_size=4, feature_sizes=sizes, numerical=2, embedding_size=8,
                      use_fwfm=False, use_deep=False, use_dlrm=True, bag_sizes=(2, 3),
                      dense_arch_layers=(16, 8), dcn_num_layers=2, dcn_low_rank_dim=4,
                      over_arch_layers=(16, 8, 1))
    assert not sf.small_forward_route(cfg, 1)


def test_route_refuses_numeric_fields_of_more_than_a_row():
    cfg = ModelConfig(**_small_tables("avazu", feature_sizes=(2,) + (5,) * 22))
    assert not sf.small_forward_route(cfg, 1)


# ------------------------------------------------------- the plain version

@pytest.mark.parametrize("name", ["avazu", "criteo"])
def test_plain_version_matches_jax_predictor(name):
    """float32 sums in another order: rtol/atol 1e-5. The plain version is the
    port's graph of ops, so against it: bit for bit."""
    import jax

    from xsdeepfwfm_deprecated_tpu.config import ModelConfig as JConfig
    from xsdeepfwfm_deprecated_tpu.models import deepfwfm as JD
    from xsdeepfwfm_deprecated_tpu.serving.predictor import Predictor as JPredictor
    kw = _small_tables(name)
    jcfg, tcfg = JConfig(**kw), ModelConfig(**kw)
    tree = _pruned(jax.tree.map(np.asarray, JD.init_params(jax.random.PRNGKey(0), jcfg)), 1)
    params = weights.params_from_numpy(tree, "cpu")
    model = sf.pack(params, tcfg)
    jpred = JPredictor(jax.tree.map(jax.numpy.asarray, tree), jcfg)
    before = sf.small_forward.launches
    for b in (1, 3, sf.SMALL_BATCH_MAX):
        assert sf.small_forward_route(tcfg, b)
        xi, xv = _rows(tcfg, b, seed=b)
        xi_t, xv_t = torch.from_numpy(xi), torch.from_numpy(xv)
        got = sf.small_forward(model, xi_t, xv_t)
        np.testing.assert_allclose(got.numpy(), jpred.logits(xi, xv), rtol=TOL, atol=TOL)
        graph = deepfwfm.forward(params, xi_t, xv_t, tcfg, lookup_fn=packed_lookup_serving)
        assert torch.equal(got, graph)
    assert sf.small_forward.launches == before   # none on the CPU


@pytest.mark.parametrize("lw,fwlw", [(False, False), (True, False), (False, True)])
def test_plain_version_without_lw_or_fwlw_is_the_graph_of_ops(lw, fwlw):
    cfg = ModelConfig(**_small_tables("avazu", use_lw=lw, use_fwlw=fwlw, deep_nodes=40))
    params = deepfwfm.init_params(torch.Generator().manual_seed(2), cfg, device="cpu")
    xi, xv = (torch.from_numpy(a) for a in _rows(cfg, 5, seed=3))
    got = sf.small_forward(sf.pack(params, cfg), xi, xv)
    assert torch.equal(got, deepfwfm.forward(params, xi, xv, cfg,
                                             lookup_fn=packed_lookup_serving))


def test_predictor_takes_the_route_by_batch(monkeypatch):
    """The forward the card's Predictor runs takes the kernels at the batches the
    route takes and the graph of ops at the others (here with the kernels' plain
    version); the CPU's Predictor runs the graph of ops at every batch."""
    cfg = ModelConfig(**_small_tables("criteo", deep_nodes=24))
    params = deepfwfm.init_params(torch.Generator().manual_seed(4), cfg, device="cpu")
    calls = []
    kernel = sf.small_forward
    monkeypatch.setattr(sf, "small_forward", lambda *a: calls.append(a[1].shape[0]) or kernel(*a))
    card = predictor._fp32_forward(params, cfg, kernels=True)
    pred = Predictor(params, cfg, device="cpu")
    for b in (1, sf.SMALL_BATCH_MAX, sf.SMALL_BATCH_MAX + 1, 64):
        xi, xv = _rows(cfg, b, seed=b)
        xi_t, xv_t = torch.from_numpy(xi), torch.from_numpy(xv)
        want = deepfwfm.forward(params, xi_t, xv_t, cfg, lookup_fn=packed_lookup_serving)
        np.testing.assert_array_equal(pred.logits(xi, xv), want.numpy())
        assert torch.equal(card(params, xi_t, xv_t), want)
    assert calls == [1, sf.SMALL_BATCH_MAX]     # the card's forward only


def _serves_one_model(dev: torch.device) -> None:
    """A Predictor made before its caller changes the params in place (a further
    fit, a pruning) serves the params as they were given at B=1 and B=64 alike."""
    cfg = ModelConfig(**_small_tables("avazu", deep_nodes=40))
    params = deepfwfm.init_params(torch.Generator().manual_seed(9), cfg, device=dev)
    given = weights.params_from_numpy(weights.params_to_numpy(params), dev)
    pred = Predictor(params, cfg, device=dev)
    with torch.no_grad():
        params["deep"]["net_1"]["layers"][0]["w"].mul_(-2.0)
        params["deep"]["net_1"]["fc_w"].mul_(0.5)
        params["field_cov"].add_(1.0)
        params["emb2"]["dense"].mul_(3.0)
    xi, xv = _rows(cfg, 64, seed=10)
    for b in (1, 64):
        xi_t, xv_t = torch.from_numpy(xi[:b]).to(dev), torch.from_numpy(xv[:b]).to(dev)
        want = deepfwfm.forward(given, xi_t, xv_t, cfg, lookup_fn=packed_lookup_serving).cpu()
        changed = deepfwfm.forward(params, xi_t, xv_t, cfg, lookup_fn=packed_lookup_serving)
        assert (changed.cpu() - want).abs().min() > 1e-3     # the change shows in every row
        got = torch.from_numpy(pred.logits(xi[:b], xv[:b]))
        if dev.type == "cpu":
            assert torch.equal(got, want), b
        else:
            _close(got, want)


def test_predictor_serves_one_model_after_its_params_change():
    _serves_one_model(torch.device("cpu"))


# ------------------------------------------------------------- the layout

@pytest.mark.parametrize("last", [False, True])
@pytest.mark.parametrize("k,n", [(460, 300), (390, 400), (300, 300), (5, 3), (7, 17)])
def test_layout_round_trip(k, n, last):
    g = torch.Generator().manual_seed(k + n)
    w, b, fc = (torch.randn(shape, generator=g) for shape in ((k, n), (n,), (n,)))
    slab = sf.pack_slab(w, b, fc if last else None)
    ns = sf.slice_width(n)
    assert slab.shape == (sf.CLUSTER, sf.slab_floats(k, n, last)) and slab.is_contiguous()
    assert slab.shape[1] % 4 == 0
    w2, b2, fc2 = sf.unpack_slab(slab, k, n, last)
    assert torch.equal(w2, w) and torch.equal(b2, b)
    assert torch.equal(fc2, fc) if last else fc2 is None
    for q in range(sf.CLUSTER):    # block q's columns: its weights row by row, biases, head
        cols = slice(q * ns, max(q * ns, min((q + 1) * ns, n)))
        have = slab[q, :k * ns].reshape(k, ns)
        m = cols.stop - cols.start
        assert torch.equal(have[:, :m], w[:, cols]) and not have[:, m:].any()
        assert torch.equal(slab[q, k * ns:k * ns + m], b[cols])
        if last:
            assert torch.equal(slab[q, (k + 1) * ns:(k + 1) * ns + m], fc[cols])
    used = k * ns + ns * (2 if last else 1)
    assert not slab[:, used:].any()     # the padding is zero


# ------------------------------------------------------------------ the card

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _close(got: torch.Tensor, want: torch.Tensor) -> float:
    err = float((got - want).abs().max())
    assert err <= TOL * max(1.0, float(want.abs().max())), err
    return err


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["avazu", "criteo"])
def test_cuda_kernels_match_the_plain_version(name):
    dev = _card()
    cfg = ModelConfig(**_small_tables(name))
    params = deepfwfm.init_params(torch.Generator().manual_seed(5), cfg, device="cpu")
    params = weights.params_from_numpy(_pruned(weights.params_to_numpy(params), 6), dev)
    model = sf.pack(params, cfg)
    for b in range(1, sf.SMALL_BATCH_MAX + 1):
        xi, xv = (torch.from_numpy(a).to(dev) for a in _rows(cfg, b, seed=b))
        before = sf.small_forward.launches
        got = sf.small_forward(model, xi, xv)
        torch.cuda.synchronize()
        assert sf.small_forward.launches == before + 2
        x, sums = sf.shallow_reference(model, xi, xv)
        _close(got, sf.tower_reference(model, x, sums))
        _close(sf.shallow(model, xi, xv), sums)                      # each kernel alone
        _close(sf.tower(model, xi, xv, sums), sf.tower_reference(model, x, sums))
        assert torch.equal(sf.small_forward(model, xi, xv), got)     # two runs bit-equal
        assert torch.equal(sf.small_forward(model, xi.long(), xv), got)


@pytest.mark.cuda
@pytest.mark.parametrize("lw,fwlw", [(True, True), (False, False)])
def test_cuda_first_orders(lw, fwlw):
    dev = _card()
    cfg = ModelConfig(**_small_tables("avazu", use_lw=lw, use_fwlw=fwlw))
    params = deepfwfm.init_params(torch.Generator().manual_seed(7), cfg, device=dev)
    model = sf.pack(params, cfg)
    for b in (1, 5, sf.SMALL_BATCH_MAX):
        xi, xv = (torch.from_numpy(a).to(dev) for a in _rows(cfg, b, seed=b))
        got = sf.small_forward(model, xi, xv)
        _close(got, deepfwfm.forward(params, xi, xv, cfg, lookup_fn=packed_lookup_serving))


@pytest.mark.cuda
def test_cuda_predictor_launches_the_kernels_at_b1_only():
    dev = _card()
    cfg = ModelConfig(**_small_tables("avazu"))
    params = deepfwfm.init_params(torch.Generator().manual_seed(8), cfg, device="cpu")
    pred = Predictor(params, cfg, device=dev)
    cpu = Predictor(params, cfg, device="cpu")
    for b, added in ((1, 2), (1, 2), (8192, 0), (sf.SMALL_BATCH_MAX, 2)):
        xi, xv = _rows(cfg, b, seed=b)
        before = sf.small_forward.launches
        got = pred.logits(xi, xv)
        assert sf.small_forward.launches == before + added, (b, sf.small_forward.launches - before)
        _close(torch.from_numpy(got), torch.from_numpy(cpu.logits(xi, xv)))


@pytest.mark.cuda
def test_cuda_predictor_serves_one_model_after_its_params_change():
    _serves_one_model(_card())
