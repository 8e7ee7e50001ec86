"""Device resolution for the port's entry points, seeded draws that give the
same values on every device, and generators cloned in their state."""

from __future__ import annotations

import functools
from typing import Sequence, Union

import torch

DeviceLike = Union[str, torch.device, None]


def scaled_normal(generator: torch.Generator, shape: Sequence[int], scale: float,
                  dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``N(0, 1) * scale`` drawn on the CPU from ``generator`` (so a seed gives
    the same values on the CPU and the card), then cast and moved. On the
    ``meta`` device it draws nothing: that gives a shape-and-dtype template."""
    if device.type == "meta":
        return torch.empty(tuple(shape), dtype=dtype, device=device)
    x = torch.randn(tuple(shape), generator=generator) * scale
    return x.to(dtype=dtype, device=device)


def clone_generator(gen: torch.Generator) -> torch.Generator:
    """A generator on ``gen``'s device in ``gen``'s state, for a warm-up that
    must not advance ``gen``."""
    out = torch.Generator(device=gen.device)
    out.set_state(gen.get_state())
    return out


def exact_div(x: torch.Tensor, value: float) -> torch.Tensor:
    """``x / value`` as an IEEE division on every device. By a Python number
    PyTorch multiplies by ``1/value`` on a CUDA device, which is off by one
    ulp from the division for some values; a tensor divisor is divided by."""
    return x / torch.full_like(x, value)


@functools.lru_cache(maxsize=512)
def constant(values: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A small read-only tensor of static values (offsets, masks), built once
    per device instead of copied to the device on every call."""
    return torch.tensor(values, dtype=dtype, device=device)


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the CUDA device; a missing GPU raises, never a quiet
    fallback to the CPU. On CUDA, float32 matmuls and convolutions run in
    full float32 (TF32 off), as the JAX package's ``precision="highest"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
