"""``parallel.mesh.init_distributed`` leaves the process group cleanly at
exit, on the CPU: 2-rank gloo worlds under ``torch.distributed.run`` whose
ranks join through ``init_distributed`` (twice, as a process that runs one
program after another does), run collectives over a mesh's axes and exit
without destroying the group. The
group is destroyed at exit, as ``jax.distributed.initialize`` registers its
shutdown; a gloo group left to the interpreter's teardown aborted a rank
there ("terminate called without an active exception"). No JAX here.
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RANK = """
import atexit, os, sys
import torch
import torch.distributed as dist
from xsdeepfwfm_deprecated_torch.parallel.mesh import init_distributed, make_mesh


def at_exit():    # registered before the group exists: it runs after init_distributed's hook
    with open(f"{sys.argv[2]}/rank{os.environ['RANK']}.txt", "w") as f:
        f.write(str(dist.is_initialized()))


atexit.register(at_exit)
assert init_distributed("gloo") and init_distributed("gloo")   # the second keeps the group
RANK = dist.get_rank()
mesh = make_mesh(data=2, model=1, device="cpu")     # its axes are gloo groups of their own
t = torch.full((4,), float(RANK + 1))
for axes in ("data", "model", ("data", "model")):
    mesh.all_reduce(t, axes)
assert t.tolist() == [6.0] * 4 and mesh.all_gather(t, "data").shape == (2, 4)
if sys.argv[1] == "destroy":      # as parallel.launch's ranks do: the exit hook then does nothing
    dist.destroy_process_group()
"""


@pytest.mark.parametrize("how", ["left", "destroy"])
def test_ranks_leave_the_group_cleanly_at_exit(tmp_path, how):
    """Three worlds run at once (the exit abort showed under load): each exits
    with 0, no rank aborts, and each rank's last exit handler finds the
    group gone, whether the rank left it to the exit or destroyed it."""
    script = tmp_path / "rank.py"
    script.write_text(RANK)
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")])}
    dirs = [tmp_path / f"world{i}" for i in range(3)]
    runs = []
    for d in dirs:
        d.mkdir()
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
               "2", str(script), how, str(d)]
        runs.append(subprocess.Popen(cmd, cwd=d, env=env, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True))
    for d, run in zip(dirs, runs):
        out, err = run.communicate(timeout=120)
        assert run.returncode == 0, out[-2000:] + err[-4000:]
        assert "terminate called" not in err, err[-4000:]
        assert [(d / f"rank{r}.txt").read_text() for r in range(2)] == ["False", "False"]
