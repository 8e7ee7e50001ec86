"""The rank setup the command-line programs share under ``torchrun``.

With ``-mesh_data``/``-mesh_model`` other than 1 a program is one rank of a
sharded run: it takes its device and backend from torchrun's environment
(``parallel.mesh.local_rank_setup``) and joins the group. Every rank fits;
rank 0 logs and measures, the others log nothing.
"""

from __future__ import annotations

import logging
from typing import Tuple

import torch
import torch.distributed as dist

from ..device import DeviceLike
from ..parallel.mesh import init_distributed, local_rank_setup
from ..utils.logging import get_logger


def join_ranks(pars, device: DeviceLike = None) -> Tuple[DeviceLike, int]:
    """(this rank's device, its rank): for a mesh, card ``LOCAL_RANK`` (or
    the CPU when ``device`` is the CPU) and the process group joined;
    otherwise ``device`` as given and rank 0."""
    if pars.mesh_data != 1 or pars.mesh_model != 1:
        device, backend = local_rank_setup(device)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        init_distributed(backend)
    return device, (dist.get_rank() if dist.is_initialized() else 0)


def rank_logger(name: str, rank: int) -> logging.Logger:
    """The run's logger (stdout and ``./logs/<name>.log``) on rank 0; one that
    drops everything on the other ranks."""
    if rank == 0:
        return get_logger(name)
    logger = logging.getLogger(f"{__name__}.rank{rank}")
    logger.addHandler(logging.NullHandler())
    logger.propagate = False
    return logger
