"""The port stands alone: it imports neither JAX nor the JAX package, and its
entry points go to the card unless asked for the CPU."""

import ast
import logging
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from xsdeepfwfm_deprecated_torch import _tree

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "xsdeepfwfm_deprecated_torch"
FORBIDDEN = ("jax", "jaxlib", "optax", "orbax", "xsdeepfwfm_deprecated_tpu")


def _port_modules():
    return sorted(".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
                  for p in PORT.rglob("*.py"))


def test_importing_every_port_module_loads_no_jax():
    code = ("import importlib, sys\n"
            f"for m in {_port_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


# the rank-side test scripts run where JAX may be absent: torch, numpy and the port only
RANK_SCRIPTS = [REPO / "tests" / "torch_sharding_ranks.py", REPO / "tests" / "torch_cli_ranks.py"]


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
                         + RANK_SCRIPTS, ids=lambda p: str(p.relative_to(REPO)))
def test_port_sources_import_no_jax(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        assert not any(n.split(".")[0] in FORBIDDEN for n in names), (path, names)


def test_entry_points_default_to_the_card(tmp_path):
    from xsdeepfwfm_deprecated_torch import weights
    from xsdeepfwfm_deprecated_torch.config import ModelConfig, TrainConfig
    from xsdeepfwfm_deprecated_torch.models import deepfwfm
    from xsdeepfwfm_deprecated_torch.serving.predictor import Predictor
    from xsdeepfwfm_deprecated_torch.train.checkpoint import load_checkpoint, save_checkpoint
    from xsdeepfwfm_deprecated_torch.train.trainer import DeepFMEstimator
    cfg = ModelConfig(field_size=3, feature_sizes=(1, 4, 5), numerical=1, embedding_size=2,
                      h_depth=1, deep_nodes=4)
    tcfg = TrainConfig(n_epochs=1, batch_size=4)
    params = deepfwfm.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, params)
    xi, xv, y = np.zeros((8, 2), np.int32), np.ones((8, 1), np.float32), np.arange(8) % 2
    quiet = logging.getLogger("test_torch_isolation")
    quiet.propagate = False

    # the CPU only when asked
    est = DeepFMEstimator(cfg, tcfg, logger=quiet, device="cpu").load(path)
    assert all(t.device.type == "cpu" for t in _tree.leaves(est.fit(xi, xv, y).params))
    assert load_checkpoint(path, params, device="cpu")[0]["bias"].device.type == "cpu"

    if torch.cuda.is_available():
        assert Predictor(params, cfg).device.type == "cuda"
        est = DeepFMEstimator(cfg, tcfg, logger=quiet).load(path)
        assert est.device.type == "cuda"
        assert all(t.device.type == "cuda" for t in _tree.leaves(est.fit(xi, xv, y).params))
        assert load_checkpoint(path, params)[0]["bias"].device.type == "cuda"
        return
    for call in (lambda: Predictor(params, cfg),
                 lambda: deepfwfm.init_params(torch.Generator(), cfg),
                 lambda: weights.params_from_numpy({"w": np.zeros(2)}),
                 lambda: DeepFMEstimator(cfg, tcfg, logger=quiet).fit(xi, xv, y),
                 lambda: DeepFMEstimator(cfg, tcfg, logger=quiet).load(path),
                 lambda: load_checkpoint(path, params),
                 lambda: weights.load_train_state(path, cfg, tcfg)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_deploy_entry_points_default_to_the_card(tmp_path, monkeypatch):
    """The entry points of the deploy slice: the four CLIs, ``run_benchmark``,
    ``Predictor`` on a ``CompactModel``, ``NFMEstimator``, the factory, the
    hashed-feature baseline and the loaders of compact and quantized models."""
    from xsdeepfwfm_deprecated_torch import weights
    from xsdeepfwfm_deprecated_torch.cli import kd, main_all, nfm, quantization
    from xsdeepfwfm_deprecated_torch.config import ModelConfig, TrainConfig
    from xsdeepfwfm_deprecated_torch.models import deepfwfm
    from xsdeepfwfm_deprecated_torch.models.factory import get_model
    from xsdeepfwfm_deprecated_torch.models.hash_mlp_baseline import HashMLPBaseline
    from xsdeepfwfm_deprecated_torch.models.nfm import NFMConfig, NFMEstimator
    from xsdeepfwfm_deprecated_torch.serving.compaction import compact_for_serving
    from xsdeepfwfm_deprecated_torch.serving.predictor import Predictor
    from xsdeepfwfm_deprecated_torch.train.checkpoint import save_checkpoint
    from xsdeepfwfm_deprecated_torch.train.trainer import DeepFMEstimator
    sizes = (1, 4, 5)
    shape = dict(field_size=3, feature_sizes=sizes, numerical=1, embedding_size=2, h_depth=1,
                 deep_nodes=4)
    cfg, ncfg = ModelConfig(**shape), NFMConfig(use_fm=True, use_fwfm=False, **shape)
    tcfg = TrainConfig(n_epochs=1, batch_size=4)
    params = deepfwfm.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    cm = compact_for_serving(params, cfg)              # built on the host, wherever it serves
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, params)
    xi, xv, y = np.zeros((8, 2), np.int32), np.ones((8, 1), np.float32), np.arange(8) % 2
    quiet = logging.getLogger("test_torch_isolation")
    quiet.propagate = False
    monkeypatch.chdir(tmp_path)
    tiny = ["-dataset", "tiny-criteo", "-n_epochs", "1", "-deep_nodes", "4", "-h_depth", "1",
            "-embedding_size", "2"]
    trees = dict(params_fp=cm.params_fp, emb1=cm.emb1, emb2=cm.emb2, deep=cm.deep)

    # the CPU only when asked
    est = DeepFMEstimator(cfg, tcfg, logger=quiet, device="cpu").load(path)
    assert "auc" in est.run_benchmark(xi, xv, y, batch_size=4)
    assert Predictor(cm, device="cpu").device.type == "cpu"
    assert NFMEstimator(ncfg, tcfg, logger=quiet, device="cpu").fit(xi, xv, y).device.type == "cpu"
    assert get_model(3, sizes, model_cfg=cfg, train_cfg=tcfg, device="cpu").device.type == "cpu"

    if torch.cuda.is_available():
        assert Predictor(cm).device.type == "cuda"
        est = DeepFMEstimator(cfg, tcfg, logger=quiet).load(path)
        assert "memory/bytes_in_use" in est.run_benchmark(xi, xv, y, batch_size=4)
        assert NFMEstimator(ncfg, tcfg, logger=quiet).fit(xi, xv, y).device.type == "cuda"
        assert get_model(3, sizes, model_cfg=cfg, train_cfg=tcfg).device.type == "cuda"
        assert weights.compact_from_numpy(cfg, False, cm.keep_in0, **trees
                                          ).params_fp["bias"].device.type == "cuda"
        return
    for call in (lambda: main_all.main(tiny),
                 lambda: nfm.main(tiny),
                 lambda: quantization.main(tiny + ["-save_model_path", path]),
                 lambda: kd.main(tiny + ["-save_model_path", path]),
                 lambda: DeepFMEstimator(cfg, tcfg, logger=quiet).run_benchmark(xi, xv, y),
                 lambda: Predictor(cm),
                 lambda: NFMEstimator(ncfg, tcfg, logger=quiet),
                 lambda: get_model(3, sizes, model_cfg=cfg, train_cfg=tcfg),
                 lambda: HashMLPBaseline(),
                 lambda: weights.compact_from_numpy(cfg, False, cm.keep_in0, **trees),
                 lambda: quantization.load_quantized(path, cfg)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_sharded_entry_points_default_to_the_card(tmp_path, monkeypatch):
    """The sharding slice's entry points: ``dryrun_multichip``, the three
    training CLIs with mesh flags (``cli.main_all``, ``cli.kd``,
    ``cli.quantization -quantization_aware 1``) and the rank setup go to the
    card unless asked for the CPU."""
    from argparse import Namespace

    from xsdeepfwfm_deprecated_torch.cli import kd, main_all, quantization
    from xsdeepfwfm_deprecated_torch.cli.ranks import join_ranks
    from xsdeepfwfm_deprecated_torch.entry import dryrun_multichip
    from xsdeepfwfm_deprecated_torch.parallel.mesh import local_rank_setup
    assert local_rank_setup("cpu") == (torch.device("cpu"), "gloo")
    assert join_ranks(Namespace(mesh_data=1, mesh_model=1), "cpu") == ("cpu", 0)
    assert {"xsdeepfwfm_deprecated_torch.parallel.mesh",
            "xsdeepfwfm_deprecated_torch.parallel.embedding_sharding",
            "xsdeepfwfm_deprecated_torch.data.sharded_input",
            "xsdeepfwfm_deprecated_torch.cli.ranks"} <= set(_port_modules())
    if torch.cuda.is_available():
        assert local_rank_setup()[0].type == "cuda"
        return
    monkeypatch.chdir(tmp_path)
    mesh = ["-dataset", "tiny-criteo", "-mesh_data", "2", "-save_model_path", "none"]
    for call in (lambda: dryrun_multichip(2), local_rank_setup,
                 lambda: main_all.main(["-dataset", "tiny-criteo", "-mesh_data", "2"]),
                 lambda: kd.main(mesh),
                 lambda: quantization.main(mesh + ["-quantization_aware", "1"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_scale_tools_default_to_the_card(tmp_path):
    """The tools (``tools/``): each ``main`` that trains or serves goes to the
    card unless given ``device="cpu"`` (or the script's own ``--cpu`` /
    ``--smoke``), and raises before it reads or generates any data;
    ``host_pipeline_41m`` does so with ``--card``. The host-only tools (the
    generator of the 41.3M-row bin set and the preprocessing CLIs) take no
    device."""
    import inspect

    from xsdeepfwfm_deprecated_torch.tools import (gen_41m_bin, host_pipeline_41m,
                                                   int8_auc_parity, kd_scale_run, nfm_scale_run,
                                                   preprocess_ali, preprocess_avazu,
                                                   preprocess_criteo, preprocess_twitter,
                                                   pruned_serving_bench, qr_scale_run,
                                                   synthetic_scale_run)
    card_tools = (int8_auc_parity, kd_scale_run, nfm_scale_run, pruned_serving_bench,
                  qr_scale_run, synthetic_scale_run, host_pipeline_41m)
    host_tools = (gen_41m_bin, preprocess_ali, preprocess_avazu, preprocess_criteo,
                  preprocess_twitter)
    tools = {m.__name__.rsplit(".", 1)[1] for m in card_tools + host_tools}
    assert {p.stem for p in (PORT / "tools").glob("*.py")} == tools | {"__init__"}
    for m in card_tools:
        assert "device" in inspect.signature(m.main).parameters, m.__name__
    for m in host_tools:
        assert "device" not in inspect.signature(m.main).parameters, m.__name__
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the tools would run in full")
    missing = str(tmp_path / "missing")
    for main, argv in ((synthetic_scale_run.main, ["--rows", "2000"]),
                       (int8_auc_parity.main, ["--checkpoint", missing, "--cache", missing]),
                       (kd_scale_run.main, ["--cache", missing]),
                       (qr_scale_run.main, ["--cache", missing]),
                       (nfm_scale_run.main, ["--rows", "2000"]),
                       (pruned_serving_bench.main, []),
                       (host_pipeline_41m.main, ["--card", "--tpu", "--rows", "2000", "--dir",
                                                 missing])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv)
    assert not os.path.exists(missing)


def test_chip_smoke_fails_without_a_card_or_the_package(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: chip_smoke.py would run in full")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], cwd=REPO,
                         capture_output=True, text=True, timeout=120, env=env)
    assert res.returncode != 0 and '"ok"' not in res.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((REPO / "chip_smoke.py").read_text())
    res = subprocess.run([sys.executable, str(alone)], cwd=tmp_path, capture_output=True,
                         text=True, timeout=120, env=env)
    assert res.returncode != 0 and '"ok"' not in res.stdout
