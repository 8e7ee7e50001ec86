"""ctypes bindings to the native C++ CSV loader (``native/dataloader``). The
port's own copy of ``xsdeepfwfm_deprecated_tpu/data/native_loader.py``.

The data-layer counterpart of the reference's pure-Python row loops
(``utils/data_preprocess.py:54-117``): label/value/index arrays are filled by
a memory-mapped, multithreaded C++ parser instead of ``np.loadtxt`` /
per-line ``str.split`` — the host-side ingest cost that dominates when feeding
full-Criteo-scale (41M-row) training. Builds the shared library on demand
(:mod:`..utils.native_build`); callers fall back to the numpy readers when it
cannot be built (:func:`.readers.read_data` handles that, and records which
reader ran in ``readers.LAST_READER``).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Sequence, Tuple

import numpy as np

from ..utils.native_build import REPO_ROOT, build_shared_library

_NATIVE_DIR = os.path.join(REPO_ROOT, "native", "dataloader")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libcsv_loader.so")

_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _ensure_built() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    if _lib is not None:
        return _lib
    if _build_failed:
        return None
    try:
        if not os.path.exists(_LIB_PATH):
            build_shared_library(_NATIVE_DIR, "libcsv_loader.so", "csv_loader.cpp")
        lib = ctypes.CDLL(_LIB_PATH)
        lib.csv_count_rows.restype = ctypes.c_int64
        lib.csv_count_rows.argtypes = [ctypes.c_char_p]
        lib.csv_load_v2.restype = ctypes.c_int64
        lib.csv_load_v2.argtypes = [
            ctypes.c_char_p,
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            ctypes.c_int32,
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
        ]
        _lib = lib
        return lib
    except (OSError, subprocess.CalledProcessError):
        _build_failed = True
        return None


def available() -> bool:
    return _ensure_built() is not None and os.environ.get(
        "XSDEEPFWFM_NATIVE_LOADER", "1") != "0"


def _first_valid_line_cols(path: str) -> int:
    with open(path, "rb") as f:
        for raw in f:
            line = raw.strip()
            if line and (line[:1].isdigit() or line[:1] in (b"-", b"+", b".")):
                return line.count(b",") + 1
    raise ValueError(f"no data rows in {path}")


def read_csv_arrays(path: str, num_cols: Sequence[int]
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Parse a label+numeric+categorical CSV into ``(label, value, index)``.

    ``num_cols``: 1-based column positions of numeric fields (column 0 is the
    label; remaining columns are categorical indices, ascending order) — the
    exact layout of the reference readers. Header rows whose first cell is
    non-numeric are skipped, like the reference's ``y2`` check (``:73``).

    Malformed input (unparseable cells, short/ragged rows, indices outside
    int32) raises ``IOError`` instead of silently zero-filling — callers fall
    back to the strict numpy reader, matching the reference's fail-loud
    ``int(item)``/``float(item)`` row loops.
    """
    lib = _ensure_built()
    if lib is None:
        raise RuntimeError("native CSV loader unavailable")
    n_cols = _first_valid_line_cols(path)
    num_set = set(int(c) for c in num_cols)
    role = np.zeros(n_cols, dtype=np.int32)           # col 0 stays label
    for c in range(1, n_cols):
        role[c] = 1 if c in num_set else 2
    n_value = int((role == 1).sum())
    n_index = int((role == 2).sum())

    n_rows = lib.csv_count_rows(path.encode())
    if n_rows < 0:
        raise IOError(f"cannot read {path}")
    label = np.empty(n_rows, dtype=np.float32)
    value = np.empty((n_rows, n_value), dtype=np.float32)
    index = np.empty((n_rows, n_index), dtype=np.int32)
    n_bad = ctypes.c_int64(0)
    got = lib.csv_load_v2(path.encode(), role, n_cols, label,
                          value.reshape(-1), index.reshape(-1), n_rows,
                          ctypes.byref(n_bad))
    if got != n_rows:
        raise IOError(f"parsed {got}/{n_rows} rows from {path}")
    if n_bad.value > 0:
        raise IOError(f"{n_bad.value} malformed cells/rows in {path}")
    return label, value, index
