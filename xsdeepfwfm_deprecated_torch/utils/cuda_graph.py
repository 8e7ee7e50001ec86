"""CUDA graphs: the card's form of the JAX package's compiled dispatch.

In the JAX package every hot-path call is one compiled executable, traced
once for each input shape (``jax.jit``), and ``make_multi_step`` and
``make_scan_eval_fn`` put K steps into one dispatch through ``lax.scan``. On
the card the counterpart is a CUDA graph: a call's work is captured once for
each input shape and then replayed, one launch for all of its kernels.

:class:`Compiled` is the port's ``jax.jit``: every compiled call of the port
(the train step, the K-step group, the prune refresh, both eval fns, the
``Predictor``, ``calibrate`` and the hash-MLP step) goes through it, and it
alone decides, on every call:

* eager or replay: a graph replays exactly where the call runs on the card
  and its collectives can be captured (NCCL; not gloo, whose collectives go
  through the host); elsewhere the function runs eagerly. On the card a call
  that writes state raises inside autograd's anomaly mode, which reads values
  back and cannot be captured;
* the graph: one for each key (the inputs' names, shapes and dtypes, what the
  caller adds as static, and whether tracing is on), captured again when the
  state has moved (the address, shape and dtype of each of its tensors and the
  identity of each generator), which frees the old capture. A held graph keeps
  the state it was captured on alive, so state that was replaced has moved on
  every rank of a mesh alike, and the ranks capture (with their collectives)
  together;
* the warm-up: a call that writes state warms up on clones of the state and of
  its generators; a leaf that ``row_state`` names (a bag table and its
  Adagrad accumulator, which a step reads and writes at the rows its inputs
  name, clipped to the leaf's rows) is cloned as its first row, so that a
  warm-up of a 13 GB table costs one row;
* the output: a copy, which the next replay does not overwrite (``load``
  returns the replay itself, whose output the next replay overwrites).

:class:`Graphed` holds one capture:

* static input buffers: a call copies its inputs into them (non-blocking, on
  the current stream), replays, and returns the static outputs;
* before capture, one warm-up call on the capture's side stream, so that
  what the function makes on first use exists before capture (the tensors of
  ``device.constant``, the kernel library of ``ops.cuda``, cuBLAS's workspace,
  autograd's engine);
* the ``torch.Generator`` s the function draws from are registered with the
  graph, so that each replay draws the numbers that eager calls would have
  drawn next from them;
* what the function counts (:class:`Counter`): the launches of the port's
  kernels (:data:`KERNELS`, which ``ops/cuda`` fills), the bytes its
  collectives send (:data:`EXCHANGE_BYTES`) and, on a mesh, the collectives
  of ``Mesh.traffic``. The warm-up and the capture are set-up,
  like a compile, and leave every counter as they found it; each replay adds
  what the capture recorded. A count kept on the card (:func:`device_count`)
  is added to by the replay's own kernels; the warm-up's additions are taken
  back;
* spans (:mod:`.profiling`): a capture made with tracing on records each
  span opened inside it as a pair of timing events in the graph, and each
  replay's device time per span is read into the program's spans
  (:class:`.profiling.DeviceSpans`). :data:`CAPTURES` logs every capture that
  :class:`Compiled` makes, by name and time, which :func:`.profiling.counters`
  reads; a replay counts nothing.

A graph's collectives: the warm-up runs each of them once eagerly on every
rank, which makes NCCL's communicators, and ``barrier`` waits for every rank
before the capture. The capture is ``thread_local``: NCCL's watchdog thread
queries its events while it runs, which would end a ``global`` capture.

A failure to capture raises, naming the function. Nothing gives way to eager
calls on the card.
"""

from __future__ import annotations

import inspect
import time
import weakref
from typing import Any, Callable, Dict, Hashable, List, Optional, Sequence, Tuple

import torch

from .. import _tree
from ..device import clone_generator
from . import profiling

KERNELS: Dict[str, Any] = {}    # the wrappers of csrc/ by name, with their `launches` (ops/cuda)


class Counter:
    """What a graphed function counts, seen as a mark now, what was added
    since a mark, a return to a mark, and adding again what was added."""

    name: str

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
        self.kernel, self.name = kernel, kernel.__name__

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

    def __init__(self, entries: list, name: str = "traffic"):
        self.entries, self.name = entries, name

    def mark(self) -> int:
        return len(self.entries)

    def since(self, mark: int) -> list:
        return list(self.entries[mark:])

    def reset(self, mark: int) -> None:
        del self.entries[mark:]

    def add(self, added: list) -> None:
        self.entries.extend(added)


class Total(Counter):
    """A running total that the program adds to, such as the bytes its
    collectives send (:data:`EXCHANGE_BYTES`)."""

    def __init__(self, name: str):
        self.name, self.value = name, 0

    def mark(self) -> int:
        return self.value

    def since(self, mark: int) -> int:
        return self.value - mark

    def reset(self, mark: int) -> None:
        self.value = mark

    def add(self, added: int) -> None:
        self.value += added


EXCHANGE_BYTES = Total("exchange_bytes")   # what this process's collectives send (parallel.mesh)

CAPTURES: List[Tuple[str, int]] = []    # (graph name, perf_counter_ns) of each capture of Compiled
_ON_CARD: Dict[Tuple[str, str], torch.Tensor] = {}    # (name, device) -> a count kept there


def device_count(name: str, device: torch.device) -> torch.Tensor:
    """The 0-d int64 count ``name`` on ``device``, which the program's kernels
    add to in place (inside graphs too) and only :func:`device_counts` reads."""
    key = (name, str(device))
    if key not in _ON_CARD:
        _ON_CARD[key] = torch.zeros((), dtype=torch.int64, device=device)
    return _ON_CARD[key]


def device_counts() -> Dict[str, int]:
    """Each count kept on a device, summed over the devices, read back."""
    out: Dict[str, int] = {}
    for (name, _), t in _ON_CARD.items():
        out[name] = out.get(name, 0) + int(t)
    return out


def _on_card(device: torch.device) -> bool:
    """Whether work on ``device`` is captured into graphs: on the card, not on
    the CPU."""
    return device.type == "cuda"


def _state_key(leaves: Sequence[Any]) -> Tuple:
    """The address, shape and dtype of every tensor of the state and the
    identity of every generator: a graph reads and writes its state at the
    addresses it was captured with."""
    return tuple((t.data_ptr(), t.shape, t.dtype) if isinstance(t, torch.Tensor) else id(t)
                 for t in leaves)


def _generator(leaf: Any) -> torch.Generator:
    """The ``torch.Generator`` a generator of the state draws from: itself, or
    the one a wrapper holds (``ops.mlp.BatchShard``)."""
    return leaf if isinstance(leaf, torch.Generator) else leaf.generator


def _clone(leaf: Any) -> Any:
    """A leaf of the state for a warm-up that must leave the state as it was:
    a tensor's clone, a generator in the same state (a wrapper's own clone)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.clone()
    return clone_generator(leaf) if isinstance(leaf, torch.Generator) else leaf.clone()


def _warmup_state(state: Tuple, row_state: Optional[Callable[[str], bool]]) -> Tuple:
    """Clones of the state for a warm-up; a leaf that ``row_state`` names by
    its path is cloned as its first row."""
    if row_state is None:
        return _tree.tree_map(_clone, state)
    return _tree.tree_map_with_path(
        lambda path, leaf: leaf[:1].clone() if row_state(path) else _clone(leaf), state)


class Compiled:
    """``fn`` as one compiled call, the port's ``jax.jit``:
    ``compiled(state, inputs, **static)`` runs ``fn(*state, **static,
    **inputs)``, on the card as a replay of a CUDA graph (see the module's
    docstring for what it decides).

    ``state`` is a tuple of what ``fn`` reads, and with ``writes_state``
    updates in place: trees of tensors (parameters, optimizer state) and the
    generators it draws from (a ``torch.Generator``, or a wrapper of one with
    a ``generator`` and a ``clone()``, as ``ops.mlp.BatchShard``; None for
    none). ``inputs`` are the tensors that change from call to call, by name;
    ``static`` what the caller adds to the graph's key (hashable values, such
    as a multi-step's pattern of real steps). The call runs on ``device``
    where it is given (the ``Predictor``, whose inputs are host tensors and
    whose model is not state), else on the device of the state's first tensor.
    ``counters``, ``barrier`` and ``capturable`` are a mesh's: what the
    function counts besides the kernels' launches, what runs between the
    warm-up and the capture, and whether its collectives can be captured.
    ``row_state`` names, by path in ``state``, the leaves a warm-up takes as
    their first row (see the module's docstring).
    ``len(compiled)`` is the number of graphs it holds.

    A method ``fn`` is held weakly: its object holds this ``Compiled``, and
    the cycle would leave their graphs to Python's cyclic collector, which
    can free one in the middle of another capture and so end it."""

    def __init__(self, fn: Callable[..., Any], name: str, *,
                 device: Optional[torch.device] = None, writes_state: bool = False,
                 counters: Sequence[Counter] = (), barrier: Optional[Callable[[], None]] = None,
                 capturable: bool = True, row_state: Optional[Callable[[str], bool]] = None):
        self._fn = weakref.WeakMethod(fn) if inspect.ismethod(fn) else (lambda: fn)
        self.name, self.device, self.writes_state = name, device, writes_state
        self.row_state = row_state
        self.counters, self.barrier, self.capturable = counters, barrier, capturable
        self._held: Dict[Hashable, Tuple[Tuple, Graphed]] = {}

    def __len__(self) -> int:
        return len(self._held)

    def __call__(self, state: Tuple, inputs: Dict[str, torch.Tensor], **static: Hashable) -> Any:
        run, replay = self._loaded(state, inputs, static)
        return _tree.tree_map(torch.clone, run()) if replay else run()

    def load(self, state: Tuple, inputs: Dict[str, torch.Tensor],
             **static: Hashable) -> Callable[[], Any]:
        """What runs the call, its inputs loaded: on the card the graph's
        replay, whose output the next replay overwrites; elsewhere the eager
        call."""
        return self._loaded(state, inputs, static)[0]

    def _loaded(self, state: Tuple, inputs: Dict[str, torch.Tensor],
                static: Dict[str, Hashable]) -> Tuple[Callable[[], Any], bool]:
        leaves = _tree.leaves(state) if state else ()
        device = self.device or next(t.device for t in leaves if isinstance(t, torch.Tensor))
        if not (self.capturable and _on_card(device)):
            moved = {k: t.to(device, non_blocking=True) for k, t in inputs.items()}
            return (lambda: self._fn()(*state, **static, **moved)), False
        if self.writes_state and torch.is_anomaly_enabled():
            raise RuntimeError(f"autograd's anomaly detection (utils.debug.nan_debugging) reads "
                               f"values back every step and cannot be captured ({self.name}): "
                               f"inside it fit steps eagerly at steps_per_call=1")
        key = (tuple([(k, t.shape, t.dtype) for k, t in inputs.items()]),
               tuple(static.items()) if static else (), profiling.enabled())
        at = _state_key(leaves) if leaves else ()
        held = self._held.get(key)
        if held is None or held[0] != at:
            self._held.pop(key, None)
            held = self._held[key] = (at, self._capture(device, state, leaves, inputs, static))
            CAPTURES.append((self.name, time.perf_counter_ns()))
        held[1].load(*inputs.values())
        return held[1].replay, True

    def _capture(self, device: torch.device, state: Tuple, leaves: Sequence[Any],
                 inputs: Dict[str, torch.Tensor], static: Dict[str, Hashable]) -> "Graphed":
        names, fn = tuple(inputs), self._fn()

        # each run gets views of its own over the static buffers, as each trace of jax.jit gets
        # tracers of its own: code that caches by a tensor's identity (the all-to-all lookup's
        # one index exchange a forward) must not carry the warm-up's result into the graph
        def call(on: Tuple, xs: Sequence[torch.Tensor]) -> Any:
            return fn(*on, **static, **{k: x.view_as(x) for k, x in zip(names, xs)})
        warmup = ((lambda *xs: call(_warmup_state(state, self.row_state), xs))
                  if self.writes_state else None)     # on clones of the state and its generators
        return Graphed(lambda *xs: call(state, xs), list(inputs.values()), device=device,
                       name=self.name, warmup=warmup,
                       generators=[_generator(g) for g in leaves
                                   if not isinstance(g, torch.Tensor)],
                       counters=self.counters, barrier=self.barrier)


class Graphed:
    """``fn(*inputs)`` captured into one CUDA graph on ``device``.

    ``inputs`` are the first call's tensors (on any device): they fill the
    static buffers, and the warm-up runs on them. ``warmup(*static_inputs)``
    replaces the warm-up call of ``fn`` where ``fn`` changes state.
    ``counters`` are what ``fn`` counts besides the kernels' launches;
    ``barrier`` runs between the warm-up and the capture (a mesh's, where
    ``fn`` holds collectives). ``outputs`` is what ``fn`` returned during
    capture, ``captured`` what each counter recorded, by the counter's name,
    ``device_spans`` the timing events of the spans opened during a capture
    made with tracing on (None without)."""

    def __init__(self, fn: Callable[..., Any], inputs: Sequence[torch.Tensor], *,
                 device: torch.device, name: str,
                 warmup: Optional[Callable[..., Any]] = None,
                 generators: Sequence[torch.Generator] = (),
                 counters: Sequence[Counter] = (),
                 barrier: Optional[Callable[[], None]] = None):
        self.name = name
        self.counters: List[Counter] = ([Launches(k) for k in KERNELS.values()] + [EXCHANGE_BYTES]
                                        + list(counters))
        before = [c.mark() for c in self.counters]
        counts = {key: t.clone() for key, t in _ON_CARD.items()}
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
                self.graph.register_generator_state(gen)
            start = [c.mark() for c in self.counters]
            with profiling.capturing(device) as spans:
                with torch.cuda.graph(self.graph, stream=stream,
                                      capture_error_mode="thread_local"):
                    self.outputs = fn(*self.inputs)
            self.device_spans = spans if spans is not None and spans.scopes else None
            self.captured = {c.name: c.since(m) for c, m in zip(self.counters, start)}
        except RuntimeError as err:
            raise RuntimeError(f"{name} cannot be captured into a CUDA graph: {err}") from err
        finally:
            for c, m in zip(self.counters, before):
                c.reset(m)
            for key, t in _ON_CARD.items():     # a count the warm-up made starts at 0
                if key in counts:
                    t.copy_(counts[key])
                else:
                    t.zero_()

    def replay(self) -> Any:
        """Replay on the inputs already in the static buffers."""
        if self.device_spans is not None:
            self.device_spans.before_replay()
        self.graph.replay()
        for c in self.counters:
            c.add(self.captured[c.name])
        if self.device_spans is not None:
            self.device_spans.replayed()
        return self.outputs

    def load(self, *inputs: torch.Tensor) -> None:
        """Copy ``inputs`` into the static buffers (non-blocking, on the
        current stream)."""
        for buf, t in zip(self.inputs, inputs):
            buf.copy_(t, non_blocking=True)
