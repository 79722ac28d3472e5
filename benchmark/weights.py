"""The benchmark's weights: made from ``--seed`` on the device, in the dtype
the cell serves them in, and handed alike to the program and to the
reference.

The parameters are those of a reference model (``benchmark/reference``),
in its order.  The scale rule is a frozen copy of the port's
``init_random_`` (flax's lecun-normal kernels, std 1 / sqrt(fan_in)) with
one deliberate difference: no layer is zero.  The layers that the published
models, and the port's ``init_random_``, start at zero (every ResBlock's
output conv, every transformer's and CAM's ``proj_out``, the ControlNet's
``conv_out``, the last conv of each temporal stack) get lecun-normal
kernels too, so that every layer on the timed path changes the compared
output.  Biases, norm scales and shifts and the blend factors are random
as well, around the values a trained model has: bias N(0, 0.02), norm
scale 1 + N(0, 0.1), norm shift N(0, 0.1), blend factor N(0, 1).

One standard-normal draw of every parameter at once, in chunks of
``CHUNK`` values, from a ``torch.Generator`` on the device seeded with the
seed; each parameter is a view of that buffer (at an aligned offset),
scaled in place.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, Tuple

import torch
from torch import nn

from benchmark.reference.layers import KERNEL_LAYERS

CHUNK = 1 << 28
# each parameter starts at a multiple of this many values (512 bytes in
# bf16): the kernels load their operands in aligned 16-byte pieces or wider
ALIGN = 256
BIAS_STD = 0.02
NORM_STD = 0.1


def plan(module: nn.Module) -> Iterator[Tuple[str, torch.Size, str, float]]:
    """(name, shape, kind, std) of every parameter of a reference model:
    kind is kernel (std 1/sqrt(fan_in)), bias, scale, shift or mix."""
    kernels = {}
    for prefix, m in module.named_modules():
        if isinstance(m, KERNEL_LAYERS):
            kernels[f"{prefix}.kernel" if prefix else "kernel"] = 1.0 / math.sqrt(m.fan_in())
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if name in kernels:
            yield name, p.shape, "kernel", kernels[name]
        elif leaf.endswith("_scale"):
            yield name, p.shape, "scale", NORM_STD
        elif leaf.endswith("_bias"):
            yield name, p.shape, "shift", NORM_STD
        elif leaf == "bias":
            yield name, p.shape, "bias", BIAS_STD
        elif leaf.endswith("mix_factor"):
            yield name, p.shape, "mix", 1.0
        else:
            raise ValueError(f"no initialiser for parameter {name}")


def zero_init_layers(module: nn.Module) -> list:
    """Names of the layers that the published models start at zero."""
    return [prefix for prefix, m in module.named_modules()
            if isinstance(m, KERNEL_LAYERS) and m.zero_init]


def make_weights(module: nn.Module, seed: int, device, dtype) -> Dict[str, torch.Tensor]:
    """The state dict of ``module``'s parameters from ``seed``: views of one
    buffer of ``dtype`` on ``device``."""
    entries = list(plan(module))
    offsets, total = [], 0
    for _, shape, _, _ in entries:
        offsets.append(total)
        total += -(-math.prod(shape) // ALIGN) * ALIGN
    device = torch.device(device)
    flat = torch.empty(total, dtype=dtype, device=device)
    gen = torch.Generator(device).manual_seed(int(seed))
    for start in range(0, total, CHUNK):
        n = min(CHUNK, total - start)
        flat[start:start + n] = torch.randn(n, generator=gen, device=device, dtype=dtype)
    out = {}
    for (name, shape, kind, std), offset in zip(entries, offsets):
        v = flat[offset:offset + math.prod(shape)].view(shape)
        if kind == "scale":
            v.mul_(std).add_(1.0)
        elif std != 1.0:
            v.mul_(std)
        out[name] = v
    return out
