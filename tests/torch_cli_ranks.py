"""One rank of ``cli.kd`` and ``cli.quantization -quantization_aware 1`` on a
(2, 2) mesh, started by ``test_torch_sharding.py`` through
``python -m torch.distributed.run --nproc_per_node 4`` on the CPU (gloo).

    python torch_cli_ranks.py WORKDIR TEACHER_CHECKPOINT STUDENT_DEEP_NODES

Each rank runs both programs in WORKDIR with ``device="cpu"``; rank 0 writes
what they measured to ``WORKDIR/rank0.pkl``. Imports torch, numpy and the
port only.
"""

import os
import pickle
import sys

import torch

from xsdeepfwfm_deprecated_torch import _tree
from xsdeepfwfm_deprecated_torch.cli import kd, quantization

MESH = ["-mesh_data", "2", "-mesh_model", "2"]


def numpy_tree(tree):
    return {name: t.detach().cpu().numpy() for name, t in _tree.named_leaves(tree)}


def main(workdir, teacher_path, student_nodes, argv):
    torch.set_num_threads(1)             # four ranks share the host's cores
    os.chdir(workdir)
    kd.STUDENT_DEEP_NODES = student_nodes
    flags = argv + ["-save_model_path", teacher_path] + MESH
    teacher, student = kd.main(flags, device="cpu")
    qat = quantization.main(flags + ["-quantization_aware", "1"], device="cpu")
    rank = int(os.environ["RANK"])
    if rank == 0:
        with open(os.path.join(workdir, "rank0.pkl"), "wb") as f:
            pickle.dump(dict(teacher=teacher.benchmark, student=student.benchmark,
                             student_params=numpy_tree(student.params),
                             qat=qat["qat"]["benchmark"], qat_keys=sorted(qat),
                             qat_params=numpy_tree(qat["qat"]["estimator"].params)), f)
    else:
        assert not hasattr(student, "benchmark") and set(qat) == {"qat"}


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2], int(sys.argv[3]), sys.argv[4:])
