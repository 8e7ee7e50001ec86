"""ctypes bindings to the native C++ serving-latency simulator. The port's own
copy of ``xsdeepfwfm_deprecated_tpu/serving/native_latency.py``.

Python-side binding of ``native/serving/latency_sim.cpp`` (the counterpart of
the reference's ``./criteo.out`` workflow, ``latency/criteo_latency.cpp`` +
``README.md:170-173``). Builds the shared library on demand
(:mod:`..utils.native_build`).

The simulator runs on the host: its numbers are a CPU's, and :func:`cpu_name`
gives the name to print beside them. They say nothing about a GPU.
"""

from __future__ import annotations

import ctypes
import os
import platform
from typing import Dict, Optional

from ..utils.native_build import REPO_ROOT, build_shared_library

_NATIVE_DIR = os.path.join(REPO_ROOT, "native", "serving")
_LIB_PATH = os.path.join(_NATIVE_DIR, "liblatency_sim.so")

MODELS = {"lr": 0, "fm": 1, "fwfm": 2, "deepfwfm": 3,
          "deepfwfm_sparse": 4, "deepfwfm_int8": 5}

_lib: Optional[ctypes.CDLL] = None


def _ensure_built() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    # make runs on every first use: it compares timestamps, costs nothing when the
    # library is current, and replaces one that is older than its source
    build_shared_library(_NATIVE_DIR, "liblatency_sim.so", "latency_sim.cpp",
                         defines=("-DLATENCY_SIM_NO_MAIN",))
    lib = ctypes.CDLL(_LIB_PATH)
    lib.latency_ms.restype = ctypes.c_double
    lib.latency_ms.argtypes = [ctypes.c_int, ctypes.c_double, ctypes.c_int]
    lib.batched_throughput.restype = ctypes.c_double
    lib.batched_throughput.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.batched_throughput_mt.restype = ctypes.c_double
    lib.batched_throughput_mt.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
    _lib = lib
    return lib


def cpu_name() -> str:
    """The host CPU's model name, to print beside every number from here."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or platform.machine()


def latency_ms(model: str = "deepfwfm", density: float = 1.0,
               iters: int = 1000) -> float:
    """Mean single-example CPU latency in ms (reference main loop,
    ``latency/criteo_latency.cpp:227-298``)."""
    lib = _ensure_built()
    return float(lib.latency_ms(MODELS[model], density, iters))


def batched_throughput(batch: int = 2048, iters: int = 5) -> float:
    """Batched dense DeepFwFM CPU throughput (examples/s)."""
    lib = _ensure_built()
    return float(lib.batched_throughput(batch, iters))


def batched_throughput_mt(batch: int = 8192, iters: int = 5,
                          threads: int = 4) -> float:
    """Multi-threaded batched throughput — the reference's 1-vs-4-thread
    8192-batch benchmark rows (``model/DeepFMs.py:982-997``)."""
    lib = _ensure_built()
    return float(lib.batched_throughput_mt(batch, iters, threads))


def thread_sweep(batch: int = 8192, iters: int = 5,
                 threads=(1, 4)) -> Dict[int, float]:
    """examples/s at each thread count (reference benchmark table parity)."""
    return {t: batched_throughput_mt(batch, iters, t) for t in threads}


def sparsity_sweep(densities=(0.2, 0.1, 0.05, 0.02, 0.01, 0.005, 0.001),
                   iters: int = 1000) -> Dict[float, float]:
    """The reference's sparsity-rate sweep (``latency/criteo_latency.cpp:287-298``)."""
    return {d: latency_ms("deepfwfm_sparse", d, iters) for d in densities}
