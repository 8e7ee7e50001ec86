"""Knowledge-distillation CLI — counterpart of the reference ``kd.py``.

Port of ``xsdeepfwfm_deprecated_tpu/cli/kd.py:23-62``. Loads a trained teacher
from ``-save_model_path``, trains a smaller student (400 nodes × 2 hidden
layers, reference ``kd.py:40-43``) against its cached logits with the
DeepLight KD loss, then benchmarks both and reports the size ratio (reference
``kd.py:60-74``).
"""

from __future__ import annotations

import dataclasses
import sys

from ..config import configs_from_args, get_parser
from ..data.datasets import get_dataset
from ..device import DeviceLike
from ..models.factory import get_model
from ..train.trainer import DeepFMEstimator
from ..utils.logging import get_logger

STUDENT_DEEP_NODES = 400   # reference kd.py:40
STUDENT_H_DEPTH = 2        # reference kd.py:41


def main(argv=None, device: DeviceLike = None):
    """Returns (teacher, student); each holds its results in ``.benchmark``
    and its size in ``.size_bytes``."""
    pars = get_parser().parse_args(argv)
    logger = get_logger("Knowledge Distillation")
    logger.info(pars)

    if not pars.save_model_path or pars.save_model_path in ("0", 0):
        logger.error("no model path given: -save_model_path")
        sys.exit(1)

    field_size, train_dict, valid_dict, test_dict = get_dataset(
        pars.dataset, twitter_category=pars.twitter_category)

    teacher = get_model(field_size=field_size, feature_sizes=train_dict["feature_sizes"],
                        pars=pars, logger=logger, device=device)
    teacher.load(pars.save_model_path, strict=not pars.prune)

    mcfg, tcfg = configs_from_args(pars, field_size, train_dict["feature_sizes"])
    student_mcfg = dataclasses.replace(mcfg, deep_nodes=STUDENT_DEEP_NODES,
                                       h_depth=STUDENT_H_DEPTH)
    student = DeepFMEstimator(student_mcfg, tcfg, logger=logger, device=device)

    logger.info("Train student model")
    student.fit(train_dict["index"], train_dict["value"], train_dict["label"],
                valid_dict["index"], valid_dict["value"], valid_dict["label"],
                prune=bool(pars.prune), prune_fm=bool(pars.prune_fm),
                prune_r=bool(pars.prune_r), prune_deep=bool(pars.prune_deep),
                emb_r=pars.emb_r, emb_corr=pars.emb_corr,
                save_path=pars.save_model_path + "_kd", teacher_model=teacher)
    test = (test_dict["index"], test_dict["value"], test_dict["label"])

    logger.info("Original model:")
    teacher.size_bytes = f = teacher.print_size_of_model()
    teacher.benchmark = teacher.run_benchmark(*test)

    logger.info("Student model:")
    student.size_bytes = s = student.print_size_of_model()
    logger.info("\t{0:.2f} times smaller".format(f / s))
    student.benchmark = student.run_benchmark(*test)
    return teacher, student


if __name__ == "__main__":
    main()
