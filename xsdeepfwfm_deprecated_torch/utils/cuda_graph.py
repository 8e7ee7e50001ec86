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
  graph (a :class:`..ops.mlp.BatchShard` through the generator it wraps), so
  that each replay draws the numbers that eager calls would have drawn next
  from them;
* what the function counts (:class:`Counter`): the launches of the port's
  kernels (:data:`KERNELS`) and, on a mesh, the collectives of
  ``Mesh.traffic``. The warm-up and the capture are set-up, like a compile,
  and leave every counter as they found it; each replay adds what the
  capture recorded.
* spans (:mod:`.profiling`): a capture made with tracing on records each
  span opened inside it as a pair of timing events in the graph, and each
  replay's device time per span is read into the program's spans
  (:class:`.profiling.DeviceSpans`). Whether tracing is on is part of the key
  of :meth:`Graphs.get`, so turning it on captures a traced variant beside a
  graph captured with it off, and turning it off goes back to that graph.
  :data:`CAPTURES` logs every capture that :class:`Graphs` makes, by name and
  time, which :func:`.profiling.counters` reads; a replay counts nothing.

A graph may hold ``torch.distributed`` collectives where the backend can
capture them (NCCL; not gloo, whose collectives go through the host): the
warm-up runs each of them once eagerly on every rank, which makes NCCL's
communicators, and ``barrier`` waits for every rank before the capture. The
capture is ``thread_local``: NCCL's watchdog thread queries its events while
it runs, which would end a ``global`` capture.

A failure to capture raises, naming the function. Nothing gives way to eager
calls on the card. On the CPU nothing is captured: the callers ask
:func:`on_card` and run their functions eagerly there.
"""

from __future__ import annotations

import time
from dataclasses import replace
from typing import Any, Callable, Dict, Hashable, List, Optional, Sequence, Tuple, Union

import torch

from .. import _tree
from ..ops.cuda.fused_adam import fused_adam
from ..ops.cuda.int8_mlp import int8_mlp
from ..ops.cuda.prune_search import prune_search
from ..ops.mlp import BatchShard
from . import profiling

# the wrappers of csrc/, each counting its launches
KERNELS = (int8_mlp, fused_adam, prune_search)


class Counter:
    """What a graphed function counts, seen as a mark now, what was added
    since a mark, a return to a mark, and adding again what was added."""

    def mark(self) -> Any:
        raise NotImplementedError

    def since(self, mark: Any) -> Any:
        raise NotImplementedError

    def reset(self, mark: Any) -> None:
        raise NotImplementedError

    def add(self, added: Any) -> None:
        raise NotImplementedError


class Launches(Counter):
    """A kernel wrapper's ``launches``."""

    def __init__(self, kernel: Any):
        self.kernel = kernel

    def mark(self) -> int:
        return self.kernel.launches

    def since(self, mark: int) -> int:
        return self.kernel.launches - mark

    def reset(self, mark: int) -> None:
        self.kernel.launches = mark

    def add(self, added: int) -> None:
        self.kernel.launches += added


class Log(Counter):
    """A list that is only appended to, such as ``Mesh.traffic``."""

    def __init__(self, entries: list):
        self.entries = entries

    def mark(self) -> int:
        return len(self.entries)

    def since(self, mark: int) -> list:
        return list(self.entries[mark:])

    def reset(self, mark: int) -> None:
        del self.entries[mark:]

    def add(self, added: list) -> None:
        self.entries.extend(added)


COUNTERS: Tuple[Counter, ...] = tuple(Launches(k) for k in KERNELS)
CAPTURES: List[Tuple[str, int]] = []    # (graph name, perf_counter_ns) of each capture of Graphs


def on_card(device: torch.device) -> bool:
    """Whether work on ``device`` is captured into graphs: on the card, not on
    the CPU."""
    return device.type == "cuda"


def state_key(*trees: Any) -> Tuple:
    """The address, shape and dtype of every tensor of ``trees``: a graph
    reads and writes its state at the addresses it was captured with, so a
    caller keeps one graph for each key."""
    return tuple((t.data_ptr(), tuple(t.shape), t.dtype)
                 for tree in trees for t in _tree.leaves(tree))


class Graphs:
    """The graphs of one caller: one for each input shape, as ``jax.jit``
    keeps one executable for each, captured again when the state it reads
    (:func:`state_key`) has moved, which frees the old capture's memory. A
    held graph keeps the state it was captured on alive, so state that was
    replaced has moved on every rank of a mesh alike, and the ranks capture
    (with their collectives) together. A graph captured with tracing on is
    held apart from the one captured with it off."""

    def __init__(self):
        self._held: Dict[Hashable, Tuple[Tuple, "Graphed"]] = {}

    def __len__(self) -> int:
        return len(self._held)

    def get(self, shapes: Hashable, state: Tuple, capture: Callable[[], "Graphed"]) -> "Graphed":
        key = (shapes, profiling.enabled())
        held = self._held.get(key)
        if held is None or held[0] != state:
            self._held.pop(key, None)
            held = self._held[key] = (state, capture())
            CAPTURES.append((held[1].name, time.perf_counter_ns()))
        return held[1]


Generator = Union[torch.Generator, BatchShard]


def clone_generator(gen: Optional[Generator]) -> Optional[Generator]:
    """A generator on ``gen``'s device in ``gen``'s state, for a warm-up that
    must not advance ``gen`` (a ``BatchShard`` around a clone of its own)."""
    if gen is None:
        return None
    if isinstance(gen, BatchShard):
        return replace(gen, generator=clone_generator(gen.generator))
    out = torch.Generator(device=gen.device)
    out.set_state(gen.get_state())
    return out


def _torch_generator(gen: Generator) -> torch.Generator:
    return gen.generator if isinstance(gen, BatchShard) else gen


class Graphed:
    """``fn(*inputs)`` captured into one CUDA graph on ``device``.

    ``inputs`` are the first call's tensors (on any device): they fill the
    static buffers, and the warm-up runs on them. ``warmup(*static_inputs)``
    replaces the warm-up call of ``fn`` where ``fn`` changes state.
    ``counters`` are what ``fn`` counts besides the kernels' launches;
    ``barrier`` runs between the warm-up and the capture (a mesh's, where
    ``fn`` holds collectives). ``outputs`` is what ``fn`` returned during
    capture, ``captured`` what each counter recorded, ``device_spans`` the
    timing events of the spans opened during a capture made with tracing on
    (None without)."""

    def __init__(self, fn: Callable[..., Any], inputs: Sequence[torch.Tensor], *,
                 device: torch.device, name: str,
                 warmup: Optional[Callable[..., Any]] = None,
                 generators: Sequence[Generator] = (),
                 counters: Sequence[Counter] = (),
                 barrier: Optional[Callable[[], None]] = None):
        self.name = name
        self.counters: List[Counter] = list(COUNTERS) + list(counters)
        before = [c.mark() for c in self.counters]
        self.inputs = [torch.empty(t.shape, dtype=t.dtype, device=device) for t in inputs]
        for buf, t in zip(self.inputs, inputs):
            buf.copy_(t)
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        try:
            with torch.cuda.stream(stream):
                (warmup or fn)(*self.inputs)
            torch.cuda.current_stream(device).wait_stream(stream)
            if barrier is not None:
                torch.cuda.synchronize(device)
                barrier()
            self.graph = torch.cuda.CUDAGraph()
            for gen in generators:
                self.graph.register_generator_state(_torch_generator(gen))
            start = [c.mark() for c in self.counters]
            with profiling.capturing(device) as spans:
                with torch.cuda.graph(self.graph, stream=stream,
                                      capture_error_mode="thread_local"):
                    self.outputs = fn(*self.inputs)
            self.device_spans = spans if spans is not None and spans.scopes else None
            self.captured = tuple(c.since(m) for c, m in zip(self.counters, start))
        except RuntimeError as err:
            raise RuntimeError(f"{name} cannot be captured into a CUDA graph: {err}") from err
        finally:
            for c, m in zip(self.counters, before):
                c.reset(m)

    def replay(self) -> Any:
        """Replay on the inputs already in the static buffers."""
        if self.device_spans is not None:
            self.device_spans.before_replay()
        self.graph.replay()
        for c, added in zip(self.counters, self.captured):
            c.add(added)
        if self.device_spans is not None:
            self.device_spans.replayed()
        return self.outputs

    def load(self, *inputs: torch.Tensor) -> None:
        """Copy ``inputs`` into the static buffers (non-blocking, on the
        current stream)."""
        for buf, t in zip(self.inputs, inputs):
            buf.copy_(t, non_blocking=True)

    def __call__(self, *inputs: torch.Tensor) -> Any:
        self.load(*inputs)
        return self.replay()
