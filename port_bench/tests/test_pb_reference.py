"""The plain reference against the program under test, at tiny sizes on the CPU,
and the operations and bytes of ``roofline.py`` pinned to the shapes."""

import json
import pathlib

import numpy as np
import pytest
import torch

from port_bench import generator, program, roofline, weights
from port_bench.reference import model as ref_model
from port_bench.reference import train as ref_train
from xsdeepfwfm_deprecated_torch.compression.pruning import prune_params_
from xsdeepfwfm_deprecated_torch.compression.quantization import convert, quantized_forward
from xsdeepfwfm_deprecated_torch.models import deepfwfm
from xsdeepfwfm_deprecated_torch.ops.embedding import packed_lookup_serving
from xsdeepfwfm_deprecated_torch.train.trainer import make_optimizer, make_train_step

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parents[1]
CPU = torch.device("cpu")


def _cfg(name):
    return json.loads((HERE / "data" / f"{name}.json").read_text())


def _rows(cfg, n, seed=11):
    tr = {"zipf_a": 1.05, "min_count": 4, "ctr": 0.25}
    xi, xv, y = generator.sample_rows(cfg, tr, n, seed, CPU)
    return torch.from_numpy(xi), torch.from_numpy(xv), torch.from_numpy(y)


def _program_params(cfg, seed=5):
    w = weights.make(cfg, seed, CPU)
    return w, program.params(program.model_config(cfg), {k: v.clone() for k, v in w.items()})


@pytest.mark.parametrize("name", ["tiny_criteo", "tiny_avazu"])
def test_fp32_forward_matches_the_program(name):
    cfg = _cfg(name)
    w, params = _program_params(cfg)
    xi, xv, _ = _rows(cfg, 300)
    got = deepfwfm.forward(params, xi, xv, program.model_config(cfg),
                           lookup_fn=packed_lookup_serving)
    np.testing.assert_allclose(got.numpy(), ref_model.forward(w, cfg, xi, xv).numpy(),
                               rtol=1e-5, atol=1e-6)


def test_training_forward_draws_the_programs_dropout():
    cfg = _cfg("tiny_criteo")
    w, params = _program_params(cfg)
    xi, xv, _ = _rows(cfg, 64)
    got = deepfwfm.forward(params, xi, xv, program.model_config(cfg), train=True,
                           generator=torch.Generator().manual_seed(3))
    want = ref_model.forward(w, cfg, xi, xv, gen=torch.Generator().manual_seed(3))
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("batch", [256, 1024])
def test_int8_forward_matches_the_programs_fused_tower(batch):
    cfg = _cfg("tiny_criteo")
    w, params = _program_params(cfg)
    xi, xv, _ = _rows(cfg, batch)
    qm = convert(params, program.model_config(cfg), "dynamic")
    got = quantized_forward(qm, xi, xv, use_fused_kernel=True)   # the plain tiled tower on a CPU
    want = ref_model.int8_forward(w, cfg, xi, xv, tile_rows=512)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)
    int4 = ref_model.int8_forward(w, cfg, xi, xv, tile_rows=512, qmax=7)
    assert float((int4 - want).abs().max()) > 100 * float((got - want).abs().max())


def test_three_steps_match_the_programs_train_step():
    cfg = _cfg("tiny_criteo")
    tr = {"batch": 64, "prune": 0, "steps_per_call": 1}
    w, params = _program_params(cfg)
    mcfg, tcfg = program.model_config(cfg), program.train_config(cfg, tr)
    opt = make_optimizer(tcfg)
    state = opt.init(params)
    step = make_train_step(mcfg, tcfg, opt)
    xi, xv, y = _rows(cfg, 3 * 64)
    batches = [{"xi": xi[i * 64:(i + 1) * 64], "xv": xv[i * 64:(i + 1) * 64],
                "y": y[i * 64:(i + 1) * 64]} for i in range(3)]
    gen = torch.Generator().manual_seed(9)
    losses = [float(step(params, state, {**b, "mask": torch.ones(64)}, gen)) for b in batches]
    ref = ref_train.steps(w, cfg, batches, torch.Generator().manual_seed(9))
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-5)
    got = program.named(params)
    for k, v in w.items():
        np.testing.assert_allclose(float((got[k] - v).double().norm()), ref["change"][k],
                                   rtol=1e-3, atol=1e-9)


def test_refresh_matches_the_programs_prune():
    cfg = _cfg("tiny_criteo")
    w, params = _program_params(cfg)
    target = 0.35
    prune_params_(params, target, emb_r=cfg["emb_r"], emb_corr=cfg["emb_corr"], prune_fm=True,
                  prune_deep=True, prune_r=True)
    want = ref_train.refresh(w, cfg, target)
    got = program.named(params)
    for k in ref_train.pruned_names(cfg):
        differ = int((got[k] != want[k]).sum())
        assert differ <= max(2, want[k].numel() // 10000), (k, differ)
        assert float((want[k] == 0).double().mean()) > 0.0


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -3.0 + 2 ** -12])
    assert ref_model.round_tf32(x).tolist() == [1.0 + 2 ** -10, 1.0, 1.0 + 2 ** -9, -3.0]


CRITEO = json.loads((ROOT / "port_bench" / "configs" / "deepfwfm_criteo.json").read_text())
AVAZU = json.loads((ROOT / "port_bench" / "configs" / "deepfwfm_avazu.json").read_text())


def test_int8_tower_bound_at_8192_rows():
    assert roofline.int8_tower_bytes(CRITEO, 8192) == 13_298_292
    assert 2 * roofline.tower_macs(CRITEO) * 8192 == 7_805_337_600
    assert roofline.int8_tower_least_seconds(CRITEO, 8192) * 1e3 == pytest.approx(0.00397,
                                                                                 abs=5e-6)


@pytest.mark.parametrize("cfg, values", [(CRITEO, 13_738_461), (AVAZU, 31_208_240)],
                         ids=["criteo", "avazu"])
def test_refresh_bytes(cfg, values):
    assert roofline.pruned_values(cfg) == values
    assert roofline.refresh_bytes(cfg) == 8 * values


@pytest.mark.parametrize("cfg, forward, params", [(CRITEO, 985_638, 13_740_101),
                                                  (AVAZU, 660_566, 31_209_993)],
                         ids=["criteo", "avazu"])
def test_model_operations_per_example(cfg, forward, params):
    assert roofline.forward_ops(cfg, 1) == {"fp32": forward, "int8": 0}
    assert roofline.train_step_ops(cfg, 1)["fp32"] == 3 * forward
    assert sum(roofline.forward_ops(cfg, 1, "int8-dynamic").values()) == forward
    assert roofline.param_count(cfg) == params
    assert 1 + sum(int(np.prod(shape)) for _, shape, _ in weights.layout(cfg)) == params
