"""Start the ranks of a sharded run on this host, one process each.

Every rank starts from a fresh interpreter (the ``spawn`` start method): a
process that has initialized CUDA cannot fork children that use it. A rank
joins the group through a file under ``workdir`` (no port to collide on),
takes one thread for its CPU work, calls ``target(rank, device, *args)`` and
writes what it returns to ``workdir/rank<r>.pkl``. The caller waits with a
deadline: the first rank that fails, or the deadline, ends every rank, and
the error is raised with that rank's traceback. A collective whose peer has
died would otherwise wait for ever, and on a card hold it until the
machine's limit.

``torchrun`` does the same job for the command-line drivers.
"""

from __future__ import annotations

import os
import pickle
import time
import traceback
from pathlib import Path
from typing import Any, Callable, List, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .mesh import init_distributed


def run_ranks(target: Callable[..., Any], world_size: int, *, backend: str,
              devices: Sequence[str], workdir: str, args: tuple = (),
              timeout_s: float = 600.0) -> List[Any]:
    """Run ``target(rank, device, *args)`` on ``world_size`` ranks joined in
    one process group over ``backend``, rank ``r`` on ``devices[r]``.
    ``target`` and ``args`` must pickle (a function at a module's top level).
    Returns each rank's result, in rank order."""
    work = Path(workdir)
    work.mkdir(parents=True, exist_ok=True)
    init = work / "init"
    init.unlink(missing_ok=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(target, r, world_size, backend, str(devices[r]), str(init),
                               str(work), args, timeout_s))
             for r in range(world_size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    try:
        while True:
            codes = [p.exitcode for p in procs]
            failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if failed:
                err = work / f"rank{failed[0]}.err"
                raise RuntimeError(f"rank {failed[0]} of {world_size} exited with "
                                   f"{codes[failed[0]]}:\n"
                                   + (err.read_text() if err.exists() else "(no traceback)"))
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                raise TimeoutError(f"ranks {[r for r, c in enumerate(codes) if c is None]} of "
                                   f"{world_size} still ran after {timeout_s} s")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(timeout=30)
    results = []
    for r in range(world_size):
        with open(work / f"rank{r}.pkl", "rb") as f:
            results.append(pickle.load(f))     # written by the rank above
    return results


def _rank_main(target, rank: int, world_size: int, backend: str, device: str, init_file: str,
               workdir: str, args: tuple, timeout_s: float) -> None:
    try:
        dev = torch.device(device)
        torch.set_num_threads(1)       # the ranks share the host's cores
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        init_distributed(backend, f"file://{init_file}", world_size, rank, timeout_s)
        result = target(rank, dev, *args)
        out = Path(workdir) / f"rank{rank}.pkl"
        with open(f"{out}.tmp", "wb") as f:
            pickle.dump(result, f)
        os.replace(f"{out}.tmp", out)
        dist.destroy_process_group()
    except BaseException:
        (Path(workdir) / f"rank{rank}.err").write_text(traceback.format_exc())
        raise
