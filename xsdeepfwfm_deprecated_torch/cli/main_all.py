"""Training CLI — flag-for-flag counterpart of the reference ``main_all.py``.

Port of ``xsdeepfwfm_deprecated_tpu/cli/main_all.py:26-80``. Flow (reference
``main_all.py:17-63``): parse flags → seed → dataset → model → fit (with
optional pruning) → reload checkpoint → size report → benchmark.

Example::

    python -m xsdeepfwfm_deprecated_torch.cli.main_all -dataset tiny-criteo \
        -use_fwfm 1 -use_deep 1 -use_lw 1 -use_fwlw 1 -n_epochs 3

It runs on the CUDA device; ``-use_cuda`` is a compatibility flag that
nothing reads. ``main(argv, device="cpu")`` runs it on the CPU.
"""

from __future__ import annotations

import os
import random
from datetime import datetime

import numpy as np

from ..config import get_parser
from ..data.datasets import get_dataset
from ..device import DeviceLike
from ..models.factory import get_model
from ..train.recovery import fit_with_recovery
from ..utils.debug import nan_debugging
from ..utils.logging import get_logger


def main(argv=None, device: DeviceLike = None, data_dir: str = None):
    """``data_dir`` replaces the repo's ``data/`` as the datasets' root."""
    pars = get_parser().parse_args(argv)

    np.random.seed(pars.random_seed)
    random.seed(pars.random_seed)

    save_model_name = "./saved_models/" + pars.c + "_l2_" + str(pars.l2) + "_dt_" + pars.dataset
    if pars.prune:
        save_model_name += "_sparse_" + str(pars.sparse) + "_seed_" + str(pars.random_seed)
    if pars.emb_bag and not pars.qr_emb:
        save_model_name += "_emb_bag"
    if pars.qr_emb:
        save_model_name += "_qr"
    save_model_name += "_" + datetime.now().strftime("%Y%m%d%H%M%S")
    os.makedirs(os.path.dirname(save_model_name), exist_ok=True)

    logger = get_logger(os.path.basename(save_model_name))
    logger.info(pars)

    logger.info("GET DATASET")
    field_size, train_dict, valid_dict, test_dict = get_dataset(
        pars.dataset, data_dir=data_dir, twitter_category=pars.twitter_category)

    model = get_model(field_size=field_size, feature_sizes=train_dict["feature_sizes"],
                      pars=pars, logger=logger, device=device)
    fit_args = (train_dict["index"], train_dict["value"], train_dict["label"],
                valid_dict["index"], valid_dict["value"], valid_dict["label"])
    fit_kwargs = dict(prune=bool(pars.prune), prune_fm=bool(pars.prune_fm),
                      prune_r=bool(pars.prune_r), prune_deep=bool(pars.prune_deep),
                      emb_r=pars.emb_r, emb_corr=pars.emb_corr,
                      early_stopping=False)
    # -debug_nans 1: anomaly detection and a finite check of every step's loss during fit
    with nan_debugging(bool(pars.debug_nans)):
        if pars.auto_resume:
            # -auto_resume N: supervised fit — transient device failures
            # restart + resume from the per-epoch checkpoint
            fit_with_recovery(model, *fit_args, save_path=save_model_name,
                              max_restarts=pars.auto_resume, **fit_kwargs)
        else:
            model.fit(*fit_args, save_path=save_model_name, **fit_kwargs)

    # reload-for-measurement (reference main_all.py:56-63)
    model2 = get_model(field_size=field_size, feature_sizes=train_dict["feature_sizes"],
                       pars=pars, logger=logger, device=device)
    model2.load(save_model_name, strict=not pars.prune)
    model2.print_size_of_model()
    logger.info("TEST DATASET")
    model2.benchmark = model2.run_benchmark(
        test_dict["index"], test_dict["value"], test_dict["label"], batch_size=8192)
    model2.save_model_name = save_model_name
    return model2


if __name__ == "__main__":
    main()
