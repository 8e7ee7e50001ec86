"""Build the port's CUDA sources with ``nvcc`` and bind them through ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
into ``build/kernels/lib<name>-<hash>.so`` at the root of the checkout, on
first use. The hash covers the source and the flags, so an edited source
is rebuilt and a stale library is never loaded. Nothing here includes
PyTorch's headers, which keeps a build to seconds. Each wrapper registers
with :func:`counted`, which gives it a count of its launches.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional

from ...utils import cuda_graph

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")
    return path


def counted(kernel: Callable) -> Callable:
    """``kernel``, the wrapper of ``csrc/<its name>.cu``, with ``launches`` (0),
    which it adds to at each launch on the card, registered in
    ``utils.cuda_graph.KERNELS``: graphs keep it through a capture and add
    the captured launches at each replay, and ``utils.profiling.counters``
    reads it."""
    kernel.launches = 0
    cuda_graph.KERNELS[kernel.__name__] = kernel
    return kernel


def sources() -> list:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile every named source (default: all) that is not built yet, one
    ``nvcc`` per source, all started together. Returns each new build's
    compiler output (register and shared-memory use from ``-Xptxas -v``)."""
    pending = {}
    for name in (sources() if names is None else names):
        out = library_path(name)
        if not out.exists():
            pending[name] = out
    if not pending:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name, out in pending.items():
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, out)          # atomic: a reader never sees half a library
        else:
            failed.append(name)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(f"--- {n}.cu\n{logs[n]}" for n in failed))
    return logs


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, building it first if needed."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))
