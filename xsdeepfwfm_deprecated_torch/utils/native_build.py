"""Build one of the repo's native C++ libraries under ``native/``.

``make`` with the Makefile that is there, which does nothing when the library
is current. On a machine without ``make`` a missing library is built with the
Makefile's one compiler command, into the same path. A library that exists is
never deleted or rebuilt here.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import Sequence

# the Makefiles' defaults
CXX = "g++"
CXXFLAGS = ("-O3", "-march=native", "-std=c++17", "-Wall", "-pthread")

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_shared_library(native_dir: str, target: str, source: str,
                         defines: Sequence[str] = ()) -> str:
    """Make ``native_dir/target`` from ``native_dir/source``; returns its path.
    Raises ``OSError`` or ``subprocess.CalledProcessError`` when it cannot."""
    out = os.path.join(native_dir, target)
    if shutil.which("make"):
        subprocess.run(["make", "-C", native_dir, target], check=True, capture_output=True)
    elif not os.path.exists(out):
        cxx = os.environ.get("CXX", CXX)
        tmp = f"{out}.{os.getpid()}.tmp"      # another process may build it at the same time
        subprocess.run([cxx, *CXXFLAGS, *defines, "-shared", "-fPIC", "-o", tmp,
                        os.path.join(native_dir, source)], check=True, capture_output=True)
        os.replace(tmp, out)
    return out
