"""Run logging: stdout plus a per-run file under ``./logs/``. The port's own
copy of ``xsdeepfwfm_deprecated_tpu/utils/logging.py``."""

from __future__ import annotations

import logging
import os
import sys

# a child of the package's logger: switching its propagation off leaves the parent's alone
_LOGGER_NAME = "xsdeepfwfm_torch.run"
_FORMAT = "%(asctime)s - %(name)s - %(levelname)s - %(message)s"


def get_logger(filename: str | None = None, log_dir: str = "./logs") -> logging.Logger:
    root = logging.getLogger(_LOGGER_NAME)
    root.setLevel(logging.DEBUG)
    if not any(isinstance(h, logging.StreamHandler) and getattr(h, "stream", None) is sys.stdout
               for h in root.handlers):
        handler = logging.StreamHandler(sys.stdout)
        handler.setLevel(logging.DEBUG)
        handler.setFormatter(logging.Formatter(_FORMAT))
        root.addHandler(handler)
    if filename:
        os.makedirs(log_dir, exist_ok=True)
        path = os.path.join(log_dir, filename + ".log")
        if not any(isinstance(h, logging.FileHandler) and h.baseFilename == os.path.abspath(path)
                   for h in root.handlers):
            fh = logging.FileHandler(filename=path)
            fh.setLevel(logging.DEBUG)
            fh.setFormatter(logging.Formatter(_FORMAT))
            root.addHandler(fh)
    root.propagate = False
    return root
