"""The deep tower: dropout → (linear → relu → dropout)×depth → bias-free head.

Port of ``xsdeepfwfm_deprecated_tpu/ops/mlp.py:19-117``. Weights are stored
``(in, out)`` with the JAX leaf names (``layers/i/w``, ``layers/i/b``,
``fc_w``), so parameters carry across without transposes. Optional 0/1
masks implement structural sparsity. :func:`qat_mlp_forward` (``:94-117``)
is the same tower with fake-quant on input, weights and activations.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Dict, List, Optional, Sequence, Union

import torch

from ..device import clone_generator, constant, scaled_normal
from .quantized import AmaxFn, fake_quant_per_tensor


@dataclass(frozen=True)
class BatchShard:
    """The dropout generator of one shard of a global batch: :func:`dropout`
    draws the numbers of the whole ``batch`` rows and keeps the rows from
    ``start`` on. So every rank of a sharded fit advances the generator
    alike, and its masks are those of the unsharded run's rows, as JAX's
    threefry bits do not depend on the sharding."""

    generator: torch.Generator
    batch: int
    start: int

    def clone(self) -> "BatchShard":
        """The same shard around a clone of its generator, for a warm-up that
        must not advance it (``utils.cuda_graph.Compiled``, which registers
        :attr:`generator` with its graphs)."""
        return replace(self, generator=clone_generator(self.generator))


def dropout(generator: Union[torch.Generator, BatchShard, None], x: torch.Tensor, rate: float,
            train: bool) -> torch.Tensor:
    """Inverted dropout (scale by 1/(1-p) at train time). The keep mask is
    drawn from ``generator`` on its own device, then moved to ``x``'s. The
    kept values are divided by a 0-d tensor on ``x``'s device: by a Python
    number PyTorch multiplies by the reciprocal on a CUDA device, which the
    CPU does not."""
    if not train or rate <= 0.0 or generator is None:
        return x
    if isinstance(generator, BatchShard):
        gen, start = generator.generator, generator.start
        u = torch.rand((generator.batch,) + tuple(x.shape[1:]), generator=gen,
                       device=gen.device)[start:start + x.shape[0]]
    else:
        u = torch.rand(x.shape, generator=generator, device=generator.device)
    keep = (u < 1.0 - rate).to(x.device)
    keep_rate = constant((1.0 - rate,), x.dtype, x.device).reshape(())
    return torch.where(keep, x / keep_rate, torch.zeros_like(x))


def init_mlp(generator: torch.Generator, in_dim: int, hidden: Sequence[int],
             head_scale: float, dtype: torch.dtype = torch.float32,
             device: torch.device = torch.device("cpu")) -> Dict:
    """Init one deep net: hidden layers draw weight AND bias from glorot
    ``N(0,1)·sqrt(2/(fan_in+fan_out))``; the head draws ``N(0,1)·head_scale``."""
    layers: List[Dict[str, torch.Tensor]] = []
    dims = [in_dim] + list(hidden)
    for fi, fo in zip(dims[:-1], dims[1:]):
        glorot = (2.0 / (fi + fo)) ** 0.5
        layers.append({"w": scaled_normal(generator, (fi, fo), glorot, dtype, device),
                       "b": scaled_normal(generator, (fo,), glorot, dtype, device)})
    fc_w = scaled_normal(generator, (dims[-1], 1), head_scale, dtype, device)
    return {"layers": layers, "fc_w": fc_w}


def mlp_forward(net: Dict, x: torch.Tensor, *, dropout_rates: Sequence[float],
                train: bool = False, generator: Optional[torch.Generator] = None,
                masks: Optional[Dict] = None,
                activation: Callable[[torch.Tensor], torch.Tensor] = torch.relu
                ) -> torch.Tensor:
    """(B, in_dim) or (B, F, E) → (B, 1). ``dropout_rates`` has
    len(hidden)+1 entries: rate[0] applies to the input, rate[i] after
    hidden layer i. A 3-D input is contracted over (F, E) by the first layer,
    the same sum as flattening it."""
    x = dropout(generator, x, dropout_rates[0], train)
    if x.ndim == 3:
        x = x.reshape(x.shape[0], -1)
    for i, layer in enumerate(net["layers"]):
        w = layer["w"]
        if masks is not None:
            w = w * masks["layers"][i]
        x = activation(x @ w + layer["b"])
        x = dropout(generator, x, dropout_rates[i + 1], train)
    fc_w = net["fc_w"]
    if masks is not None and masks.get("fc_w") is not None:
        fc_w = fc_w * masks["fc_w"]
    return x @ fc_w


def qat_mlp_forward(net: Dict, x: torch.Tensor, *, dropout_rates: Sequence[float],
                    train: bool = False, generator: Optional[torch.Generator] = None,
                    amax_fn: Optional[AmaxFn] = None) -> torch.Tensor:
    """The tower with fake-quant on its input, weights and activations (QAT),
    (B, in_dim) → (B, 1). Each scale is the current tensor's abs-max, outside
    the gradient (straight-through). ``amax_fn`` takes the activations'
    abs-max over the whole batch when ``x`` is one rank's rows of it (the
    maximum over the batch's ranks); the weights are replicated and keep
    their own."""
    x = dropout(generator, fake_quant_per_tensor(x, amax_fn), dropout_rates[0], train)
    for i, layer in enumerate(net["layers"]):
        x = torch.relu(x @ fake_quant_per_tensor(layer["w"]) + layer["b"])
        x = dropout(generator, fake_quant_per_tensor(x, amax_fn), dropout_rates[i + 1], train)
    return x @ fake_quant_per_tensor(net["fc_w"])
