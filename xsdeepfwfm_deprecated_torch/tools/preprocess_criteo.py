"""Offline Criteo preprocessing CLI over :func:`..data.preprocess.preprocess_criteo`.

Port of ``scripts/preprocess_criteo.py`` (the reference's
``data/large/preprocess_criteo.py``), with its arguments and printed lines.
It runs on the host only and takes no device.

Usage:
  python -m xsdeepfwfm_deprecated_torch.tools.preprocess_criteo <raw_train.txt> <out_dir>
      [--cutoff 4] [--max-rows N] [--valid-test-fraction 0.1]
"""

from __future__ import annotations

import argparse

from ..data.preprocess import preprocess_criteo


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("raw_path")
    ap.add_argument("out_dir")
    ap.add_argument("--cutoff", type=int, default=4)
    ap.add_argument("--max-rows", type=int, default=None)
    ap.add_argument("--valid-test-fraction", type=float, default=0.1)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    paths = preprocess_criteo(args.raw_path, args.out_dir, cutoff=args.cutoff,
                              max_rows=args.max_rows,
                              valid_test_fraction=args.valid_test_fraction,
                              seed=args.seed)
    for p in paths:
        print(p)


if __name__ == "__main__":
    main()
