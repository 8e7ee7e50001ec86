"""The fp32 DeepFwFM forward at a small batch: two CUDA kernels, the plain version and the layout.

Replaces no TPU kernel: the JAX package runs this forward as XLA ops. The kernels are in
``csrc/small_forward.cu``, whose header notes what bounds them on the card (latency, not
the 0.38 us that Avazu's 1.28 MB of weights take at 3.35 TB/s) and the design:
``shallow_kernel`` does the lookup (each index clipped into its field as
``ops/embedding.packed_lookup_serving`` does, the numeric rows scaled by their values),
the FwLW term with its ``lw_w`` product and the FwFM second order in one launch and a block
a row, and ``tower_kernel`` runs the hidden layers and the head in one thread block
cluster, each block a slice of every layer's columns, the activations passed between the
blocks' shared memory. :func:`small_forward` launches both for CUDA tensors, the first
under the ``FM - Component`` span and the second under ``Deep - Component``, and adds 2 to
its ``launches``; for CPU tensors it runs the plain version, which is the graph of ops
(``models/deepfwfm.forward`` with the serving lookup) on the same operands, bit for bit.

:func:`small_forward_route` decides from the configuration and the batch alone whether a
forward takes this route; ``serving/predictor.Predictor`` asks it once a batch shape on
the card (on the CPU it runs the graph of ops).
:func:`pack` lays the model out once, when a ``Predictor`` is made: the tower's weights as
slabs, a block's slice of a layer's weights with its biases (and the head's weights)
contiguous, which the kernel fetches with one bulk copy (:func:`pack_slab`,
:func:`unpack_slab`); the tables, R, ``fwlw_w``, ``lw_w`` and the bias are the parameters'
own tensors. A ``Predictor`` packs its own copy of the parameters, which nothing else
writes, so its two routes serve one model.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch

from ...config import ModelConfig
from ...utils import profiling as prof
from ..embedding import PackedEmbeddingSpec, make_spec, packed_lookup_serving
from ..interactions import fwfm_linear_term, fwfm_second_order
from . import _build

# The largest batch the route takes: the largest at which the kernels beat the graph of
# ops at both benchmark configurations' widths on an H100 (PERF.md).
SMALL_BATCH_MAX = 32
# Tower blocks: one cluster of a non-portable size (csrc/small_forward.cu). On an H100 a
# cluster of 16 ties one of 8 at B=1, is faster at 16 rows, and alone fits 32 (PERF.md).
CLUSTER = 16
THREADS = 512           # threads of a tower block
MAX_LAYERS = 8          # hidden layers whose pointers fit the kernel's parameter block
ROW_STEP = 4            # rows of one 16-byte load of the tower's transposed input
MAX_SMEM = 232_448      # bytes of shared memory one H100 block may use
SHALLOW_SMEM = 48 * 1024
SHALLOW_THREADS = 256


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"small_forward: {msg}")


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def slice_width(n: int) -> int:
    """NS: the columns of a layer of width ``n`` that one block of the cluster owns."""
    return _ceil(n, CLUSTER)


def slab_floats(k: int, n: int, last: bool) -> int:
    """Floats of one block's slab of a layer ``k -> n``: its (k, NS) weights, its NS
    biases and, after the last layer, the head's NS weights, padded to a multiple of 4
    (a bulk copy moves multiples of 16 bytes)."""
    ns = slice_width(n)
    return _ceil(k * ns + ns * (2 if last else 1), 4) * 4


def tower_smem(slots: int, slot: int, width: int, rows: int) -> int:
    """Dynamic shared memory of a tower block (``tower_smem`` in the source): ``slots``
    slabs of ``slot`` floats, the transposed input and output of a layer at ``width``,
    the groups' partial sums, the head's row sums of every block, a barrier a slot,
    one for each of the two inputs and one for the head."""
    rp = _ceil(rows, ROW_STEP) * ROW_STEP
    return 4 * (slots * slot + 2 * width * rp + rp * THREADS + CLUSTER * rp) + 8 * (slots + 3)



def shallow_smem(fields: int, emb: int) -> int:
    return 4 * (fields * fields + 2 * fields * emb + 4 * fields + SHALLOW_THREADS // 32)


def lookup_fits(fields: int, emb: int) -> bool:
    """Whether both kernels take ``fields`` fields of ``emb`` values: the shallow
    kernel's shared memory, and the tower's rows and scales of a row's fields in its
    partial sums' room."""
    return shallow_smem(fields, emb) <= SHALLOW_SMEM and 2 * fields <= THREADS


def tower_plan(dims: Sequence[int], rows: int) -> Optional[Tuple[int, int]]:
    """(slabs shared memory holds at once, floats of the largest slab) of a tower of
    widths ``dims`` (the input, then each hidden layer) at ``rows`` rows, or None
    where the kernel does not take the shape: no hidden layer or more than
    :data:`MAX_LAYERS`, a slice wider than a block, or not one slab beside the rest."""
    n_hidden = len(dims) - 1
    if not (1 <= n_hidden <= MAX_LAYERS and min(dims) >= 1):
        return None
    if any(slice_width(n) > THREADS for n in dims[1:]):
        return None
    slot = max(slab_floats(k, n, l == n_hidden - 1)
               for l, (k, n) in enumerate(zip(dims[:-1], dims[1:])))
    slots = min(n_hidden, (MAX_SMEM - tower_smem(0, 0, max(dims), rows)) // (4 * slot + 8))
    return (slots, slot) if slots >= 1 else None


def small_forward_route(cfg: ModelConfig, batch: int) -> bool:
    """Whether an fp32 forward of ``batch`` rows of the model ``cfg`` takes the two
    kernels: DeepFwFM (FwFM and a tower, with any ``use_lw`` and ``use_fwlw``), one
    tower, float32 tables without QR, no QAT, leading single-row numeric fields, the
    kernels' shapes, and at most :data:`SMALL_BATCH_MAX` rows. A pure function of the
    configuration and the batch; nothing at run time changes the choice."""
    model = (cfg.use_fwfm and cfg.use_deep and not (cfg.use_logit or cfg.use_fm or cfg.use_ffm
                                                      or cfg.use_cin or cfg.use_dlrm))
    plain = (cfg.num_deeps == 1 and not cfg.quantization_aware and not cfg.qr_flag
             and cfg.table_dtype == "f32"
             and all(n == 1 for n in cfg.feature_sizes[:cfg.numerical]))
    dims = (cfg.field_size * cfg.embedding_size,) + tuple(cfg.deep_layers)
    return bool(model and plain and 0 < batch <= SMALL_BATCH_MAX
                and lookup_fits(cfg.field_size, cfg.embedding_size)
                and tower_plan(dims, batch) is not None)


# ------------------------------------------------------------------- the layout

def pack_slab(w: torch.Tensor, b: torch.Tensor, fc: Optional[torch.Tensor]) -> torch.Tensor:
    """A layer's (K, N) ``(in, out)`` weights, its (N,) biases and, for the last
    layer, the head's (N,) weights -> (CLUSTER, slab) slabs: block q's
    ``w[:, q NS:(q + 1) NS]`` row by row, then ``b[q NS:(q + 1) NS]``, then the head's
    same columns; the columns past N and the padding zero."""
    k, n = w.shape
    ns = slice_width(n)

    def columns(t: torch.Tensor) -> torch.Tensor:    # (R, N) -> (CLUSTER, R * NS)
        out = t.new_zeros((t.shape[0], CLUSTER * ns))
        out[:, :n] = t
        return out.reshape(t.shape[0], CLUSTER, ns).permute(1, 0, 2).reshape(CLUSTER, -1)

    parts = [columns(w), columns(b.reshape(1, n))]
    if fc is not None:
        parts.append(columns(fc.reshape(1, n)))
    slab = torch.cat(parts, dim=1)
    pad = slab_floats(k, n, fc is not None) - slab.shape[1]
    return torch.nn.functional.pad(slab, (0, pad)).contiguous()


def unpack_slab(slab: torch.Tensor, k: int, n: int, last: bool
                ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """The inverse of :func:`pack_slab`: (weights (K, n), biases (n,), the head's
    weights (n,) or None), each contiguous."""
    ns = slice_width(n)

    def columns(at: int, r: int) -> torch.Tensor:    # (CLUSTER, r * NS) -> (r, n)
        part = slab[:, at:at + r * ns].reshape(CLUSTER, r, ns).permute(1, 0, 2)
        return part.reshape(r, CLUSTER * ns)[:, :n].contiguous()

    fc = columns((k + 1) * ns, 1).reshape(n) if last else None
    return columns(0, k), columns(k * ns, 1).reshape(n), fc


@dataclass(frozen=True)
class SmallModel:
    """What the two kernels read, on one device: the parameters' own shallow tensors
    and the tower as slabs (:func:`pack`)."""
    spec: PackedEmbeddingSpec
    table: torch.Tensor                 # emb2's (rows, E)
    first_row: torch.Tensor             # (F,) int32 each field's first packed row
    last_index: torch.Tensor            # (F,) int32 each field's last index
    field_cov: torch.Tensor             # (F, F) R
    fwlw_w: Optional[torch.Tensor]      # (F, E), or None: emb1 gives the first order
    emb1: Optional[torch.Tensor]        # emb1's (rows, 1), where fwlw_w is None
    lw_w: Optional[torch.Tensor]        # (F, 1), or None
    bias: torch.Tensor                  # (1,)
    slabs: Tuple[torch.Tensor, ...]     # (CLUSTER, slab) a hidden layer (pack_slab)
    dims: Tuple[int, ...]               # the tower's input width, then each hidden layer's

    def layers(self) -> Tuple[Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]], ...]:
        """Each hidden layer's (weights, biases, the head's weights or None), unpacked."""
        n = len(self.slabs)
        return tuple(unpack_slab(s, k, m, l == n - 1) for l, (s, k, m)
                     in enumerate(zip(self.slabs, self.dims[:-1], self.dims[1:])))


def pack(params: Dict, cfg: ModelConfig) -> SmallModel:
    """The model as the kernels read it, on the parameters' device. The tower is
    copied into its slabs now, so a request is served with the tower as it was
    when the model was packed."""
    spec = make_spec(cfg.feature_sizes, cfg.numerical)
    table = params["emb2"]["dense"]
    dev = table.device
    net = params["deep"]["net_1"]
    n = len(net["layers"])
    slabs = tuple(pack_slab(l["w"], l["b"], net["fc_w"] if i == n - 1 else None)
                  for i, l in enumerate(net["layers"]))
    return SmallModel(
        spec=spec, table=table,
        first_row=torch.tensor(spec.dense_offsets, dtype=torch.int32, device=dev),
        last_index=torch.tensor([max(size - 1, 0) for size in spec.feature_sizes],
                                dtype=torch.int32, device=dev),
        field_cov=params["field_cov"], fwlw_w=params.get("fwlw_w"),
        emb1=None if "fwlw_w" in params else params["emb1"]["dense"],
        lw_w=params.get("lw_w"), bias=params["bias"], slabs=slabs,
        dims=(cfg.field_size * cfg.embedding_size,) + tuple(l["w"].shape[1] for l in net["layers"]))


# ---------------------------------------------------------------- the plain version

def shallow_reference(m: SmallModel, xi: torch.Tensor, xv: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the tower's input (B, F·E), the shallow sum (B,)) by the graph of ops of
    ``models/deepfwfm.forward``: the serving lookup, the FwLW term (or the
    first-order lookup) and its ``lw_w`` product, the FwFM second order."""
    emb = packed_lookup_serving({"dense": m.table}, m.spec, xi, xv)
    if m.fwlw_w is not None:
        first = fwlw = fwfm_linear_term(emb, m.fwlw_w)
    else:
        first = fwlw = packed_lookup_serving({"dense": m.emb1}, m.spec, xi, xv)[..., 0]
    if m.lw_w is not None:
        first = fwlw @ m.lw_w
    second = fwfm_second_order(emb, m.field_cov)
    return emb.reshape(emb.shape[0], -1), first.sum(dim=1) + second.sum(dim=1)


def tower_reference(m: SmallModel, x: torch.Tensor, shallow: torch.Tensor) -> torch.Tensor:
    """The logits (B,): the tower on ``x`` (``ops/mlp.mlp_forward``'s ops on the
    unpacked weights), its head, then the shallow sum and the bias added as
    ``models/deepfwfm._assemble`` adds them."""
    for w, b, fc in m.layers():
        x = torch.relu(x @ w + b)
    x_deep = x @ fc.reshape(-1, 1)
    return (shallow + x_deep.sum(dim=1)) + m.bias[0]


# ------------------------------------------------------------------- the kernels

@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("small_forward")
    ptr, i32, ptrs = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_void_p)
    lib.small_forward_shallow.argtypes = [
        ptr, i32, ptr, i32, i32, i32, i32, ptr, i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr]
    lib.small_forward_tower.argtypes = [
        ptr, i32, ptr, i32, i32, i32, ptr, i32, ptr, ptr, ptr, ptr, i32, i32,
        ctypes.POINTER(i32), ptrs, ctypes.POINTER(i32), i32, i32, ptr, ptr]
    lib.small_forward_tower_smem.argtypes = [i32, i32, i32, i32]
    lib.small_forward_tower_smem.restype = ctypes.c_longlong
    for fn in (lib.small_forward_shallow, lib.small_forward_tower):
        fn.restype = i32
    # the wrapper's shared-memory plan is the kernel's
    for args in ((3, 8760, 460, 1), (1, 10040, 400, 32)):
        if lib.small_forward_tower_smem(*args) != tower_smem(*args):
            raise RuntimeError("csrc/small_forward.cu's shared memory is not "
                               "ops/cuda/small_forward.py's")
    return lib


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"small_forward: CUDA error {rc} at the launch of {name}")


def check_operands(m: SmallModel, xi: torch.Tensor, xv: torch.Tensor) -> None:
    """Every check a launch needs; raises ``ValueError`` on what the kernels do not
    take. Plain Python over shapes, types and strides; it touches no device."""
    f, num = m.spec.field_size, m.spec.numerical
    b = xi.shape[0] if xi.dim() == 2 else 0
    _check(xi.dim() == 2 and xi.shape[1] == f - num and xi.dtype in (torch.int32, torch.int64),
           f"xi must be (B, {f - num}) int32 or int64, got {xi.dtype} {tuple(xi.shape)}")
    _check(xv.shape == (b, num) and xv.dtype == torch.float32,
           f"xv must be ({b}, {num}) float32, got {xv.dtype} {tuple(xv.shape)}")
    _check(0 < b <= SMALL_BATCH_MAX, f"batch {b}: the kernels take 1 to {SMALL_BATCH_MAX} rows")
    _check(tower_plan(m.dims, b) is not None and lookup_fits(f, m.table.shape[1]),
           f"the tower {m.dims} at {b} rows is not a shape the kernels take")
    leaves = [m.table, m.first_row, m.last_index, m.field_cov, m.bias, *m.slabs,
              *(t for t in (m.fwlw_w, m.emb1, m.lw_w) if t is not None)]
    _check(all(t.dtype == (torch.int32 if t is m.first_row or t is m.last_index
                           else torch.float32) for t in leaves),
           "the model must be float32 (pack() lays it out)")
    _check(all(t.device == xi.device and t.is_contiguous() for t in leaves + [xi, xv]),
           "the model and the batch must be contiguous and on one device")


def _lookup(xi: torch.Tensor, xv: torch.Tensor) -> tuple:
    """The lookup's operands of both C entries."""
    return (xi.data_ptr(), int(xi.dtype == torch.int64), xv.data_ptr())


def shallow(m: SmallModel, xi: torch.Tensor, xv: torch.Tensor) -> torch.Tensor:
    """``shallow_kernel`` on CUDA tensors: the shallow sums (B,), as
    :func:`shallow_reference` gives them."""
    check_operands(m, xi, xv)
    b, f, e = xi.shape[0], m.spec.field_size, m.table.shape[1]
    sums = torch.empty((b,), dtype=torch.float32, device=xi.device)
    with torch.cuda.device(xi.device):
        _launch(_lib().small_forward_shallow(
            *_lookup(xi, xv), b, f, m.spec.numerical, e, m.table.data_ptr(),
            m.table.shape[0], m.first_row.data_ptr(), m.last_index.data_ptr(), _ptr(m.fwlw_w),
            _ptr(m.emb1), _ptr(m.lw_w), m.field_cov.data_ptr(), sums.data_ptr(), _stream(xi)),
            "shallow_kernel")
    small_forward.launches += 1
    return sums


def tower(m: SmallModel, xi: torch.Tensor, xv: torch.Tensor, sums: torch.Tensor
          ) -> torch.Tensor:
    """``tower_kernel`` on CUDA tensors: the logits (B,) of the batch, the tower's
    input gathered as :func:`shallow` gathers it and ``sums`` the shallow sums that
    :func:`shallow`, launched just before on the same stream, gives: as
    :func:`tower_reference`."""
    check_operands(m, xi, xv)
    b, f, e = xi.shape[0], m.spec.field_size, m.table.shape[1]
    _check(sums.shape == (b,) and sums.dtype == torch.float32 and sums.device == xi.device,
           f"the sums must be ({b},) float32 on the batch's device")
    n = len(m.slabs)
    out = torch.empty((b,), dtype=torch.float32, device=xi.device)
    dims = (ctypes.c_int * (n + 1))(*m.dims)
    slabs = (ctypes.c_void_p * n)(*(t.data_ptr() for t in m.slabs))
    floats = (ctypes.c_int * n)(*(t.shape[1] for t in m.slabs))
    with torch.cuda.device(xi.device):
        _launch(_lib().small_forward_tower(
            *_lookup(xi, xv), f, m.spec.numerical, e, m.table.data_ptr(), m.table.shape[0],
            m.first_row.data_ptr(), m.last_index.data_ptr(), sums.data_ptr(),
            m.bias.data_ptr(), b, n, dims, slabs, floats, *tower_plan(m.dims, b),
            out.data_ptr(), _stream(xi)), "tower_kernel")
    small_forward.launches += 1
    return out


@_build.counted     # kernel launches on the card: 2 a forward
def small_forward(m: SmallModel, xi: torch.Tensor, xv: torch.Tensor) -> torch.Tensor:
    """The logits (B,) of a batch of at most :data:`SMALL_BATCH_MAX` rows. CUDA
    tensors launch ``shallow_kernel`` under the ``FM - Component`` span and
    ``tower_kernel`` under ``Deep - Component`` (or raise); CPU tensors run the
    plain version under the same spans."""
    if xi.device.type == "cpu":
        with prof.named_scope(prof.SCOPE_FM):
            x, sums = shallow_reference(m, xi, xv)
        with prof.named_scope(prof.SCOPE_DEEP):
            return tower_reference(m, x, sums)
    _check(xi.device.type == "cuda", f"unsupported device {xi.device}")
    with prof.named_scope(prof.SCOPE_FM):
        sums = shallow(m, xi, xv)
    with prof.named_scope(prof.SCOPE_DEEP):
        return tower(m, xi, xv, sums)
