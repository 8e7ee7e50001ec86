"""The card's captures on a mesh, stood in for on the CPU: 4 gloo ranks on a
(2 data, 2 model) mesh (``tests/torch_mesh_multi_step_ranks.py``'s case),
``Mesh.capturable`` made true, a capture a run of the function and each later
replay a run on the graph's static inputs, as
``test_torch_padded_dispatch.CardOnTheCPU`` stands in on one device. An
a2a_grid fit at ``steps_per_call=1`` and its eval, graphed so, equal the same
fit and eval eager, bit for bit: a replay holds what the eager step computes,
the lookup's one index exchange a forward included (it is cached by the
input's identity, ``parallel/embedding_sharding._make_lookup``, so a capture
that took the warm-up's exchange would replay the first batch's indices).
NCCL's own capture runs on four cards only: ``chip_smoke.py --phases 17``.
"""

import contextlib

import numpy as np

import torch_mesh_multi_step_ranks as R
from xsdeepfwfm_deprecated_torch.parallel.launch import run_ranks


def _captures_on_the_cpu():
    """In this rank: the card's graphs stood in for, for good."""
    import torch

    from xsdeepfwfm_deprecated_torch import _tree
    from xsdeepfwfm_deprecated_torch.parallel import mesh as mesh_mod
    from xsdeepfwfm_deprecated_torch.utils import cuda_graph

    class Stream:
        def wait_stream(self, other):
            pass

    class Graph:
        def register_generator_state(self, gen):
            pass

        def replay(self):
            self.fn()

    making = {}
    init = cuda_graph.Graphed.__init__

    def recording_init(graphed, fn, inputs, **kw):
        making["now"] = (graphed, fn)
        init(graphed, fn, inputs, **kw)

    @contextlib.contextmanager
    def capture(graph, stream=None, capture_error_mode="global"):
        graphed, fn = making["now"]
        done = [True]       # the capture ran the function: it stands for the first replay

        def replay():
            if done:
                done.pop()
                return
            for static, new in zip(_tree.leaves(graphed.outputs),
                                   _tree.leaves(fn(*graphed.inputs))):
                static.copy_(new)
        graph.fn = replay
        yield

    cuda_graph._on_card = lambda device: True
    cuda_graph.Graphed.__init__ = recording_init
    mesh_mod.Mesh.capturable = property(lambda mesh: True)
    torch.cuda.CUDAGraph, torch.cuda.graph = Graph, capture
    torch.cuda.Stream, torch.cuda.stream = (lambda device: Stream()), contextlib.nullcontext
    torch.cuda.current_stream = lambda device=None: Stream()
    torch.cuda.synchronize = lambda device=None: None


def graphed_and_eager(rank, device):
    """(eager, graphed) a2a_grid fits at steps_per_call=1 of the case, with their evals."""
    from xsdeepfwfm_deprecated_torch.parallel import mesh as mesh_mod
    mesh = mesh_mod.make_mesh(*R.MESH, device="cpu")
    out = []
    for graphed in (False, True):
        if graphed:
            _captures_on_the_cpu()
        cfg, params, xi, xv, y = R.case()
        est, res = R._fit(cfg, params, xi, xv, y, mesh, exchange="a2a_grid", steps_per_call=1)
        res["eval"] = R._eval(est, xi, xv)
        res["graphs"] = len(est._eval_fn._graphs) + len(est._scan_eval._graphs)
        out.append(res)
    return out


def test_graphed_mesh_fit_and_eval_equal_the_eager_ones(tmp_path):
    eager, graphed = run_ranks(graphed_and_eager, R.WORLD, backend="gloo",
                               devices=["cpu"] * R.WORLD, workdir=str(tmp_path))[0]
    assert eager["graphs"] == 0 and graphed["graphs"] > 0
    assert graphed["losses"] == eager["losses"]
    assert all(np.array_equal(graphed["params"][n], eager["params"][n]) for n in eager["params"])
    for form in ("scanned", "per_batch"):
        assert np.array_equal(graphed["eval"][form], eager["eval"][form])
