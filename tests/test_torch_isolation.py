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


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
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
