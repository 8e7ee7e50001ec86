"""Fused int8 deep tower: the Hopper kernels, the plain version and the operand layout.

Replaces the TPU kernel ``_int8_mlp_kernel``
(``xsdeepfwfm_deprecated_tpu/ops/pallas/int8_mlp.py:26-49``); the kernels are
in ``csrc/int8_mlp.cu``, whose header notes the bound on the card (about
4.0 us at B = 8192, bytes and int8 operations level) and the design. For each
hidden layer, with the scale over a whole ``block_b``-row tile: quantize the
activations to int8, take the int8 x int8 -> int32 product, then
``relu((acc*s)*w_scale + b)``; the bias-free head is quantized the same way.
Output (B, 1) f32.

:func:`pack_quantized_deep` lays the weights out once, when a model is
prepared for serving: every width zero-padded to one W (zeros change neither
an abs-max nor a sum) and each layer stored as W/16 slabs ``w[k16][n][16]``,
the byte order a wgmma operand has in shared memory, so that the kernel
fetches a K chunk with one bulk copy. :func:`untile_weight` gives back the
``[out][in]`` matrix. :func:`int8_mlp_reference` is the same function in plain
PyTorch on that layout. :func:`int8_mlp` launches a kernel for a CUDA tensor
and runs the plain version only for a CPU tensor.

Two kernels, and :func:`tower_route` picks one from the shapes alone:

``"cluster"``
    One launch per tower call. A thread block cluster of ``block_b / 64``
    blocks owns a scale tile, the activations stay in shared memory and
    registers, the tile abs-max is reduced through distributed shared memory,
    the products are ``wgmma`` m64nNk32 (N = W/2) and the weights stream
    through a ring of ``cp.async.bulk`` stages. It takes W in :data:`CLUSTER_WIDTHS`, ``block_b`` up to 512 and
    at most :data:`MAX_LAYERS` hidden layers, and allocates only the output.
``"layered"``
    Every other shape: each layer a launch of its own (2 + 2 * n_hidden
    kernels and a memset), the abs-max passed through global memory, and
    scratch for the codes and the f32 activations.

Neither gives way to the other or to the plain version: a build, launch or
run failure raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from ..quantized import exact_int_matmul
from . import _build

PAD = 32         # K step of both kernels' products (k32)
BLOCK_ROWS = 64  # rows of one kernel block; a scale tile holds whole blocks
MAX_SMEM = 232_448  # bytes of shared memory one H100 block may use
# the cluster kernel
CLUSTER_WIDTHS = (64, 128, 256, 416)  # W/2 is a wgmma N; one kernel is built for each
MAX_SUMS = 104   # int32 sums a thread holds (W/4): what the register file takes without spills
MAX_CLUSTER = 8  # blocks of a portable cluster, so block_b <= 512
MAX_LAYERS = 8   # hidden layers whose pointers fit the kernel's parameter block

Layers = Tuple[Tuple[torch.Tensor, torch.Tensor, torch.Tensor], ...]
Head = Tuple[torch.Tensor, torch.Tensor]


def padded_width(dims) -> int:
    """The common width W of a tower with these layer widths: the smallest
    width the cluster kernel is built for, else the next multiple of 32."""
    need = max(dims)
    return next((w for w in CLUSTER_WIDTHS if w >= need), -(-need // PAD) * PAD)


def tile_weight(w_t: torch.Tensor) -> torch.Tensor:
    """(W, W) ``[out][in]`` -> (W/16, W, 16) slabs ``[in // 16][out][in % 16]``."""
    width = w_t.shape[0]
    return w_t.reshape(width, width // 16, 16).permute(1, 0, 2).contiguous()


def untile_weight(w: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`tile_weight`."""
    width = w.shape[1]
    return w.permute(1, 0, 2).reshape(width, width)


def pack_quantized_deep(deep_q: Dict) -> Tuple[Layers, Head]:
    """(layers_q, fc_q) in the kernels' layout from a ``QuantizedModel``'s
    ``deep_q`` (its ``net_1``): layers_q = ((w int8 (W/16, W, 16) slabs,
    w_scale f32 (W,), b f32 (W,)), ...), fc_q = (fc int8 (W,), fc_scale f32 (1,))."""
    net = deep_q["net_1"] if "net_1" in deep_q else deep_q
    if net["fc"]["w_q"].shape[1] != 1:
        raise ValueError("the fused tower has a 1-unit head")
    dims = [net["layers"][0]["w_q"].shape[0]] + [l["w_q"].shape[1] for l in net["layers"]]
    width = padded_width(dims)

    def vec(v: torch.Tensor) -> torch.Tensor:
        out = v.new_zeros(width)
        out[:v.numel()] = v.reshape(-1)
        return out

    layers = []
    for layer in net["layers"]:
        w = layer["w_q"]
        w_t = w.new_zeros((width, width))
        w_t[:w.shape[1], :w.shape[0]] = w.T
        layers.append((tile_weight(w_t), vec(layer["w_scale"].to(torch.float32)),
                       vec(layer["b"].to(torch.float32))))
    fc = (vec(net["fc"]["w_q"]), net["fc"]["w_scale"].to(torch.float32).reshape(1).clone())
    return tuple(layers), fc


def cluster_smem_bytes(width: int) -> int:
    """Dynamic shared memory of one block of the cluster kernel (``Shape`` in
    ``csrc/int8_mlp.cu``): the 64-row A tile, the weight ring, and every
    layer's scales and biases with the head's codes."""
    a_bytes = -(-(width // 16) * (BLOCK_ROWS * 16 + 16) // 128) * 128
    stage = 32 * width
    ring = min(2 * (width // 32), 160 * 1024 // stage) * stage
    return a_bytes + ring + MAX_LAYERS * 2 * width * 4 + width


def tower_route(width: int, block_b: int, n_hidden: int) -> str:
    """Which kernel serves a tower of padded width ``width`` with ``n_hidden``
    hidden layers at ``block_b`` rows per scale tile: ``"cluster"`` where the
    cluster kernel takes the shape, else ``"layered"``. A pure function of the
    shapes; nothing at run time changes the choice."""
    fits = (width in CLUSTER_WIDTHS and width // 4 <= MAX_SUMS
            and cluster_smem_bytes(width) + 2048 <= MAX_SMEM   # 2 KB: barriers and reductions
            and block_b % BLOCK_ROWS == 0 and 0 < block_b <= BLOCK_ROWS * MAX_CLUSTER
            and 1 <= n_hidden <= MAX_LAYERS)
    return "cluster" if fits else "layered"


def _tile_codes(h: torch.Tensor, block_b: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tile scale (T, 1, 1) and int8 codes (B, W) of h (B, W)."""
    b = h.shape[0]
    tiles = h.reshape(b // block_b, block_b, -1)
    amax = tiles.abs().amax(dim=(1, 2), keepdim=True).clamp(min=1e-12)
    s = amax / torch.full_like(amax, 127.0)   # not `/ 127.0`: see ops.quantized._scale_of
    q = torch.round(tiles / s).clamp(-127, 127).to(torch.int8)
    return s, q.reshape(b, -1)


def int8_mlp_reference(x: torch.Tensor, layers_q: Layers, fc_q: Head,
                       block_b: int = 512) -> torch.Tensor:
    """The kernel's function in plain PyTorch: x (B, IN) f32 → (B, 1) f32.
    The int32 products are exact (:func:`..quantized.exact_int_matmul`)."""
    b = x.shape[0]
    block_b = min(block_b, b)
    if b % block_b:
        raise ValueError(f"batch {b} is not a multiple of block_b {block_b}")
    n_tiles, width = b // block_b, layers_q[0][0].shape[1]
    h = torch.nn.functional.pad(x.to(torch.float32), (0, width - x.shape[1]))
    for w, w_scale, bias in layers_q:
        s, q = _tile_codes(h, block_b)
        acc = exact_int_matmul(q, untile_weight(w).T).to(torch.float32)
        acc = acc.reshape(n_tiles, block_b, width)
        h = torch.relu(acc * s * w_scale + bias).reshape(b, width)
    fc, fc_scale = fc_q
    s, q = _tile_codes(h, block_b)
    acc = exact_int_matmul(q, fc.reshape(-1, 1)).to(torch.float32).reshape(n_tiles, block_b, 1)
    return (acc * s * fc_scale).reshape(b, 1)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("int8_mlp")
    ptr, i32, ptrs = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_void_p)
    lib.int8_mlp_forward.argtypes = [
        ptr, i32, i32, i32, i32, i32, ptrs, ptrs, ptrs, ptr, ptr, ptr, ptr, ptr]
    lib.int8_mlp_forward_layered.argtypes = [
        ptr, i32, i32, i32, i32, i32, ptrs, ptrs, ptrs, ptr, ptr, ptr, ptr, ptr, ptr, ptr]
    lib.int8_mlp_max_active_clusters.argtypes = [
        i32, i32, ctypes.POINTER(i32), ctypes.POINTER(i32)]
    for fn in (lib.int8_mlp_forward, lib.int8_mlp_forward_layered,
               lib.int8_mlp_max_active_clusters):
        fn.restype = i32
    return lib


def max_active_clusters(width: int, block_b: int) -> Tuple[int, int]:
    """(clusters of ``block_b / 64`` blocks of the cluster kernel that the
    current card holds at once, dynamic shared memory of a block in bytes)."""
    n, smem = ctypes.c_int(0), ctypes.c_int(0)
    rc = _lib().int8_mlp_max_active_clusters(width, block_b, ctypes.byref(n), ctypes.byref(smem))
    if rc != 0:
        raise RuntimeError(f"int8_mlp: CUDA error {rc} from cudaOccupancyMaxActiveClusters")
    return n.value, smem.value


def prof_steps(n_hidden: int) -> Tuple[str, ...]:
    """Names of the clock readings the cluster kernel writes into ``prof``."""
    steps = ["barriers set", "block in step", "input read, own abs-max",
             "cluster started", "abs-max 0 across the cluster", "input codes stored"]
    for l in range(n_hidden):
        steps += [f"layer {l}: first weights landed", f"layer {l}: products done",
                  f"layer {l}: epilogue", f"layer {l}: abs-max across the cluster",
                  f"layer {l}: " + ("head written" if l == n_hidden - 1 else "codes stored")]
    return tuple(steps)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"int8_mlp: {msg}")


def launch_plan(x: torch.Tensor, layers_q: Layers, fc_q: Head, block_b: int,
                route: Optional[str]) -> Tuple[str, int]:
    """(route, rows per scale tile) for a launch, after every check a launch
    needs: raises ``ValueError`` on what the kernels do not take. Plain
    Python over shapes, types and strides; it touches no device."""
    b = x.shape[0]
    block_b = min(block_b, b)
    width = layers_q[0][0].shape[1] if layers_q else 0
    n = len(layers_q)
    _check(x.dtype == torch.float32 and x.ndim == 2 and x.is_contiguous()
           and x.data_ptr() % 16 == 0,
           "x must be a contiguous 2-D float32 tensor, 16-byte aligned")
    _check(n >= 1 and width % PAD == 0 and x.shape[1] <= width,
           f"needs >= 1 hidden layer and a width that is a multiple of {PAD} and >= the input")
    _check(b > 0 and b % block_b == 0 and block_b % BLOCK_ROWS == 0,
           f"batch {b} must be a multiple of block_b {block_b}, itself a multiple of {BLOCK_ROWS}")
    chosen = tower_route(width, block_b, n)
    _check(route in (None, "layered", chosen),
           f"the {route} kernel does not take width {width}, block_b {block_b}, {n} layers")
    route = route or chosen
    # a layered gemm block holds (64 + 32) rows of (W + 16) bytes (csrc/int8_mlp.cu)
    _check(route == "cluster" or (BLOCK_ROWS + 32) * (width + 16) <= MAX_SMEM,
           f"width {width} too large")
    for w, w_scale, bias in layers_q:
        _check(w.dtype == torch.int8 and w.shape == (width // 16, width, 16)
               and w_scale.dtype == torch.float32 and bias.dtype == torch.float32
               and w_scale.shape == (width,) and bias.shape == (width,),
               "layers_q must come from pack_quantized_deep")
    fc, fc_scale = fc_q
    _check(fc.dtype == torch.int8 and fc.shape == (width,) and fc_scale.dtype == torch.float32,
           "fc_q must come from pack_quantized_deep")
    tensors = [fc, fc_scale] + [t for layer in layers_q for t in layer]
    _check(all(t.device == x.device and t.is_contiguous() for t in tensors),
           "weights must be contiguous and on x's device")
    return route, block_b


@_build.counted     # tower calls that launched on the card, by either route
def int8_mlp(x: torch.Tensor, layers_q: Layers, fc_q: Head, block_b: int = 512,
             route: Optional[str] = None, prof: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (B, IN) f32 -> (B, 1) f32 through the fused int8 tower, with
    ``block_b = min(block_b, B)`` rows per scale tile. A CUDA tensor launches
    a kernel (or raises); a CPU tensor runs the plain version.

    The kernel is the one :func:`tower_route` names for the shapes. ``route``
    asks for one by name, to hold the two against each other: ``"layered"``
    takes every shape, ``"cluster"`` raises on a shape it does not take.
    ``prof``, an int64 CUDA tensor of at least ``6 + 5 * n_hidden`` elements,
    receives the SM clock of the cluster kernel's first block at each of
    :func:`prof_steps`."""
    if x.device.type == "cpu":
        return int8_mlp_reference(x, layers_q, fc_q, block_b)
    _check(x.device.type == "cuda", f"unsupported device {x.device}")
    route, block_b = launch_plan(x, layers_q, fc_q, block_b, route)
    b, width, n = x.shape[0], layers_q[0][0].shape[1], len(layers_q)
    fc, fc_scale = fc_q
    _check(prof is None or (prof.dtype == torch.int64 and prof.device == x.device
                            and prof.is_contiguous() and prof.numel() >= 6 + 5 * n),
           f"prof must be a contiguous int64 tensor of >= {6 + 5 * n} elements on x's device")

    lib = _lib()
    out = torch.empty((b, 1), dtype=torch.float32, device=x.device)
    w, w_scale, bias = ((ctypes.c_void_p * n)(*(layer[i].data_ptr() for layer in layers_q))
                        for i in range(3))
    head = (x.data_ptr(), b, x.shape[1], width, n, block_b, w, w_scale, bias,
            fc.data_ptr(), fc_scale.data_ptr())
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if route == "cluster":
            rc = lib.int8_mlp_forward(*head, out.data_ptr(),
                                      None if prof is None else prof.data_ptr(), stream)
        else:
            q = torch.empty((b, width), dtype=torch.int8, device=x.device)
            y = torch.empty((b, width), dtype=torch.float32, device=x.device)
            amax = torch.empty(((n + 1) * (b // block_b),), dtype=torch.int32, device=x.device)
            rc = lib.int8_mlp_forward_layered(*head, q.data_ptr(), y.data_ptr(), amax.data_ptr(),
                                              out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"int8_mlp: CUDA error {rc} at launch ({route} route)")
    int8_mlp.launches += 1
    return out
