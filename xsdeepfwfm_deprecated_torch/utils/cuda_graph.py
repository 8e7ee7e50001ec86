"""CUDA graphs: the card's form of the JAX package's compiled dispatch.

In the JAX package every hot-path call is one compiled executable, traced
once for each input shape (``jax.jit``), and ``make_multi_step`` and
``make_scan_eval_fn`` put K steps into one dispatch through ``lax.scan``. On
the card the counterpart is a CUDA graph: a call's work is captured once for
each input shape and then replayed, one launch for all of its kernels.
:class:`Graphed` holds one capture:

* static input buffers: a call copies its inputs into them (non-blocking, on
  the current stream), replays, and returns the static outputs, which the
  next replay overwrites: the caller copies out what it keeps;
* before capture, one warm-up call on the capture's side stream, so that
  what the function makes on first use exists before capture (the tensors of
  ``device.constant``, the kernel library of ``ops.cuda``, cuBLAS's workspace,
  autograd's engine). A function that changes state (a train step) passes its
  own ``warmup``, which runs on clones;
* the ``torch.Generator`` s the function draws from are registered with the
  graph, so that each replay draws the numbers that eager calls would have
  drawn next from them;
* the launch counts of the port's kernels (:data:`KERNELS`): the warm-up and
  the capture are set-up, like a compile, and leave the counts as they found
  them; each replay adds the launches that the capture recorded.

A failure to capture raises, naming the function. Nothing gives way to eager
calls on the card. On the CPU nothing is captured: the callers run their
functions eagerly there.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Hashable, Optional, Sequence, Tuple

import torch

from .. import _tree
from ..ops.cuda.int8_mlp import int8_mlp

KERNELS = (int8_mlp,)    # the wrappers of csrc/, each counting its launches


def launch_counts() -> Tuple[int, ...]:
    return tuple(k.launches for k in KERNELS)


def _set_launch_counts(counts: Tuple[int, ...]) -> None:
    for kernel, n in zip(KERNELS, counts):
        kernel.launches = n


def state_key(*trees: Any) -> Tuple:
    """The address, shape and dtype of every tensor of ``trees``: a graph
    reads and writes its state at the addresses it was captured with, so a
    caller keeps one graph for each key."""
    return tuple((t.data_ptr(), tuple(t.shape), t.dtype)
                 for tree in trees for t in _tree.leaves(tree))


class Graphs:
    """The graphs of one caller: one for each input shape, as ``jax.jit``
    keeps one executable for each, captured again when the state it reads
    (:func:`state_key`) has moved, which frees the old capture's memory."""

    def __init__(self):
        self._held: Dict[Hashable, Tuple[Tuple, "Graphed"]] = {}

    def __len__(self) -> int:
        return len(self._held)

    def get(self, shapes: Hashable, state: Tuple, capture: Callable[[], "Graphed"]) -> "Graphed":
        held = self._held.get(shapes)
        if held is None or held[0] != state:
            self._held.pop(shapes, None)
            held = self._held[shapes] = (state, capture())
        return held[1]


def clone_generator(gen: Optional[torch.Generator]) -> Optional[torch.Generator]:
    """A generator on ``gen``'s device in ``gen``'s state, for a warm-up that
    must not advance ``gen``."""
    if gen is None:
        return None
    out = torch.Generator(device=gen.device)
    out.set_state(gen.get_state())
    return out


class Graphed:
    """``fn(*inputs)`` captured into one CUDA graph on ``device``.

    ``inputs`` are the first call's tensors (on any device): they fill the
    static buffers, and the warm-up runs on them. ``warmup(*static_inputs)``
    replaces the warm-up call of ``fn`` where ``fn`` changes state.
    ``outputs`` is what ``fn`` returned during capture."""

    def __init__(self, fn: Callable[..., Any], inputs: Sequence[torch.Tensor], *,
                 device: torch.device, name: str,
                 warmup: Optional[Callable[..., Any]] = None,
                 generators: Sequence[torch.Generator] = ()):
        self.name = name
        before = launch_counts()
        self.inputs = [torch.empty(t.shape, dtype=t.dtype, device=device) for t in inputs]
        for buf, t in zip(self.inputs, inputs):
            buf.copy_(t)
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        try:
            with torch.cuda.stream(stream):
                (warmup or fn)(*self.inputs)
            torch.cuda.current_stream(device).wait_stream(stream)
            self.graph = torch.cuda.CUDAGraph()
            for gen in generators:
                self.graph.register_generator_state(gen)
            start = launch_counts()
            with torch.cuda.graph(self.graph, stream=stream):
                self.outputs = fn(*self.inputs)
            self.launches = tuple(b - a for a, b in zip(start, launch_counts()))
        except RuntimeError as err:
            raise RuntimeError(f"{name} cannot be captured into a CUDA graph: {err}") from err
        finally:
            _set_launch_counts(before)

    def replay(self) -> Any:
        """Replay on the inputs already in the static buffers."""
        self.graph.replay()
        for kernel, n in zip(KERNELS, self.launches):
            kernel.launches += n
        return self.outputs

    def __call__(self, *inputs: torch.Tensor) -> Any:
        for buf, t in zip(self.inputs, inputs):
            buf.copy_(t, non_blocking=True)
        return self.replay()
