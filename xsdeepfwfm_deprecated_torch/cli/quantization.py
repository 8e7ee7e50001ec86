"""Quantization CLI — counterpart of the reference ``quantization.py`` script.

Port of ``xsdeepfwfm_deprecated_tpu/cli/quantization.py``. Three modes on a
trained checkpoint (``-save_model_path``):

* ``-dynamic_quantization 1``  — int8 deep-tower weights, activation scales
  taken at run time (reference ``quantization.py:48-64``). On the CUDA device
  the ``Predictor`` runs this tower as the fused int8 kernel;
* ``-static_quantization 1``   — calibration over 5 × batch_size train rows →
  fixed activation scales, weight-only int8 embeddings (reference ``:72-114``);
* ``-quantization_aware 1``    — QAT training run with fake-quant, converted
  on eval (reference ``:118-147``).

Each mode benchmarks the original and quantized model and saves the quantized
artifact under the reference's ``_dynamic_quant`` / ``_static_quant`` /
``_quant_aware`` suffixes, in the JAX package's key format
(``section::a/b/0/c``), so either package loads the other's artifacts.

With ``-mesh_data``/``-mesh_model`` under ``torchrun`` (see ``cli.main_all``)
the QAT run fits on the mesh, its activation scales taken over the global
batch. Rank 0 measures the loaded model, the post-training modes and the
converted QAT model on its device; the other ranks only fit and save.
"""

from __future__ import annotations

import sys
from typing import Dict

import numpy as np

from .. import _tree, weights
from ..compression import quantization as Q
from ..config import get_parser
from ..data.datasets import get_dataset
from ..device import DeviceLike
from ..models.factory import get_model
from ..ops.cuda.int8_mlp import int8_mlp
from ..serving.benchmark import run_benchmark
from ..serving.predictor import Predictor
from .ranks import join_ranks, rank_logger


def load_quantized(path: str, cfg, mode: str = "dynamic",
                   device: DeviceLike = None) -> "Q.QuantizedModel":
    """Load a ``_dynamic_quant`` / ``_static_quant`` artifact back into a
    servable :class:`QuantizedModel` (counterpart of the reference reloading
    its quantized state_dicts, ``quantization.py:64,114``)."""
    return weights.load_quantized_artifact(path, cfg, device=device, mode=mode)


def _save_quantized(qm: Q.QuantizedModel, path: str):
    arrays = {}
    for name in weights.QUANT_SECTIONS:
        for leaf_name, leaf in _tree.named_leaves(getattr(qm, name)):
            arrays[name + "::" + leaf_name] = leaf.detach().cpu().numpy()
    np.savez(path + ".npz", **arrays)


def main(argv=None, device: DeviceLike = None, data_dir: str = None) -> Dict[str, Dict]:
    """Returns, for every model it measured (``original``, ``dynamic``,
    ``static``, ``qat``): its benchmark results under ``benchmark``, the model
    under ``model`` and, under ``tower_launches``, how often the fused int8
    tower kernel was launched while it was measured. The QAT run's estimator
    is under ``qat``/``estimator``; on a mesh the ranks other than 0 measure
    nothing and return only that."""
    pars = get_parser().parse_args(argv)
    device, rank = join_ranks(pars, device)
    logger = rank_logger("Quantization", rank)
    logger.info(pars)

    field_size, train_dict, valid_dict, test_dict = get_dataset(
        pars.dataset, data_dir=data_dir, twitter_category=pars.twitter_category)

    if not pars.save_model_path or pars.save_model_path in ("0", 0):
        logger.info("no model path given: -save_model_path")
        sys.exit(1)

    test = (test_dict["index"], test_dict["value"], test_dict["label"])
    results: Dict[str, Dict] = {}

    def measure(name: str, served, bench) -> None:
        before = int8_mlp.launches
        results[name] = {"model": served, "benchmark": bench()}
        results[name]["tower_launches"] = int8_mlp.launches - before

    def measure_quantized(name: str, qm: Q.QuantizedModel) -> None:
        logger.info("\tSize (MB):\t" + str(qm.size_bytes() / 1e6))
        measure(name, qm, lambda: run_benchmark(Predictor(qm, device=device), *test,
                                                logger=logger))
        logger.info(f"\tFused int8 tower launches: {results[name]['tower_launches']}")

    if rank == 0:       # on a mesh, rank 0 measures the loaded model and its int8 forms
        model = get_model(field_size=field_size, feature_sizes=train_dict["feature_sizes"],
                          pars=pars, logger=logger, device=device)
        model.load(pars.save_model_path, strict=not pars.prune)
        logger.info("Original model:")
        model.print_size_of_model()
        measure("original", model, lambda: model.run_benchmark(*test))

        if pars.dynamic_quantization:
            qm = Q.convert(model.params, model.mcfg, mode="dynamic")
            logger.info("Dynamic Quantization model:")
            measure_quantized("dynamic", qm)
            _save_quantized(qm, pars.save_model_path + "_dynamic_quant")

        if pars.static_quantization:
            calib = model.tcfg.batch_size * 5      # reference :94
            xi = np.asarray(train_dict["index"][:calib], np.int32)
            xv = np.asarray(train_dict["value"][:calib], np.float32)
            scales = Q.calibrate(model.params, model.mcfg, xi, xv,
                                 n_batches=5, batch_size=model.tcfg.batch_size)
            logger.info("Post Static Quantization: Calibration done")
            qm = Q.convert(model.params, model.mcfg, mode="static", act_scales=scales)
            logger.info("Post Static Quantization model:")
            measure_quantized("static", qm)
            _save_quantized(qm, pars.save_model_path + "_static_quant")

    if pars.quantization_aware:
        qat_model = get_model(field_size=field_size,
                              feature_sizes=train_dict["feature_sizes"],
                              pars=pars, logger=logger, quantization_aware=True,
                              device=device)
        qat_model.fit(train_dict["index"], train_dict["value"], train_dict["label"],
                      valid_dict["index"], valid_dict["value"], valid_dict["label"],
                      prune=bool(pars.prune), prune_fm=bool(pars.prune_fm),
                      prune_r=bool(pars.prune_r), prune_deep=bool(pars.prune_deep),
                      emb_r=pars.emb_r, emb_corr=pars.emb_corr)
        qat_model.save(pars.save_model_path + "_quant_aware")
        qat_model.unshard()     # collective on a mesh: rank 0 converts the whole model
        if rank != 0:
            return {"qat": {"estimator": qat_model}}
        logger.info("Quantization Aware model:")
        measure_quantized("qat", Q.convert(qat_model.params, qat_model.mcfg, mode="qat"))
        results["qat"]["estimator"] = qat_model
    return results


if __name__ == "__main__":
    main()
