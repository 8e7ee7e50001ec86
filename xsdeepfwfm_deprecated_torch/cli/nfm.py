"""NFM baseline CLI — counterpart of the reference's script-style ``NFM.py``
bottom block (``NFM.py:561-575``). Port of
``xsdeepfwfm_deprecated_tpu/cli/nfm.py``."""

from __future__ import annotations

from ..config import TrainConfig, get_parser
from ..data.datasets import get_dataset
from ..device import DeviceLike
from ..models.nfm import NFMConfig, NFMEstimator
from ..utils.logging import get_logger


def main(argv=None, device: DeviceLike = None):
    parser = get_parser()
    parser.add_argument("-interaction_type", default=1, type=int,
                        help="1: bi-interaction pooling; 0: pairwise concat")
    parser.add_argument("-refit", default=0, type=int)
    parser.add_argument("-nfm_sane_init", default=0, type=int,
                        help="Extension: N(0,0.01) table init instead of the "
                             "reference's torch-default N(0,1) (which diverges)")
    pars = parser.parse_args(argv)
    logger = get_logger("NFM")
    logger.info(pars)

    field_size, train_dict, valid_dict, test_dict = get_dataset(
        pars.dataset, twitter_category=pars.twitter_category)

    mcfg = NFMConfig(field_size=field_size,
                     feature_sizes=tuple(train_dict["feature_sizes"]),
                     numerical=pars.numerical, embedding_size=pars.embedding_size,
                     h_depth=pars.h_depth, deep_nodes=pars.deep_nodes,
                     use_fm=True, use_deep=True, use_fwfm=False,
                     interaction_type=bool(pars.interaction_type),
                     sane_init=bool(pars.nfm_sane_init))
    tcfg = TrainConfig(n_epochs=pars.n_epochs, batch_size=pars.batch_size,
                       learning_rate=pars.learning_rate, weight_decay=pars.l2,
                       random_seed=pars.random_seed)
    nfm = NFMEstimator(mcfg, tcfg, logger=logger, device=device)
    nfm.fit(train_dict["index"], train_dict["value"], train_dict["label"],
            valid_dict["index"], valid_dict["value"], valid_dict["label"],
            refit=bool(pars.refit))
    loss, auc, prauc, rce = nfm.test_metrics = nfm.eval_by_batch(
        test_dict["index"], test_dict["value"], test_dict["label"])
    logger.info(f"NFM test loss {loss:.6f} auc {auc:.6f} prauc {prauc:.4f} rce {rce:.2f}")
    return nfm


if __name__ == "__main__":
    main()
