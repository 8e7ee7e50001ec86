"""Pre-generate the 41.3M-row binary dataset of :mod:`.host_pipeline_41m`.

Port of ``scripts/gen_41m_bin.py``, with its flags and printed lines: it
writes the dataset (and ``feature_sizes.npy``) once, so that a later
``host_pipeline_41m`` run skips the generation leg. It runs on the host only
and takes no device. ``--dir`` defaults to ``synth41m_bin`` in the temporary
directory (``$TMPDIR``, else ``/tmp``); a complete set of ``--rows`` rows there
is kept, and a set of another size, or one left half written, is refused.

Usage:
  python -m xsdeepfwfm_deprecated_torch.tools.gen_41m_bin [--rows 41300000] [--dir DIR]
"""

from __future__ import annotations

import argparse

from .host_pipeline_41m import default_dir, existing_set, write_set


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=41_300_000)
    ap.add_argument("--dir", default=default_dir())
    args = ap.parse_args(argv)
    if existing_set(args.dir, args.rows) is not None:
        print("already generated")
        return
    write_set(args.dir, args.rows)
    print("done")


if __name__ == "__main__":
    main()
