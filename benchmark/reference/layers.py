"""Parameter-holding layers of the reference models.

Their parameter names and layouts are those of the published models as the
benchmark stores them (``kernel``, ``bias``; norms as ``<name>_scale`` and
``<name>_bias``), so that one state dict made by ``benchmark/weights.py``
loads into the reference and into the program under test alike:
dense (out, in), convolution (out, in, kh, kw), temporal convolution
(kt, in, out).  Each layer says how its kernel is initialised: ``fan_in``,
and ``zero_init`` for the output layers that the published models start
at zero (the benchmark gives them random weights all the same).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from benchmark.reference import ops


def param(*shape) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape), requires_grad=False)


def norm(module: nn.Module, name: str, c: int) -> None:
    module.register_parameter(f"{name}_scale", param(c))
    module.register_parameter(f"{name}_bias", param(c))


def norm_of(module: nn.Module, name: str) -> tuple:
    return getattr(module, f"{name}_scale"), getattr(module, f"{name}_bias")


class Dense(nn.Module):
    def __init__(self, cin: int, cout: int, bias: bool = True, zero_init: bool = False):
        super().__init__()
        self.zero_init = zero_init
        self.kernel = param(cout, cin)
        self.bias = param(cout) if bias else None

    def fan_in(self) -> int:
        return self.kernel.shape[1]

    def forward(self, x):
        return ops.linear(x, self.kernel, self.bias)


class Conv(nn.Module):
    """Channel-last 2-D convolution; ``padding`` None keeps the size
    (stride 1)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 padding: Optional[int] = None, zero_init: bool = False):
        super().__init__()
        self.zero_init = zero_init
        self.stride = stride
        self.padding = k // 2 if padding is None else padding
        self.kernel = param(cout, cin, k, k)
        self.bias = param(cout)

    def fan_in(self) -> int:
        return self.kernel[0].numel()

    def forward(self, x):
        return ops.conv2d(x, self.kernel, self.bias, stride=self.stride, padding=self.padding)


class TimeConv(nn.Module):
    """(kt, 1, 1) convolution over the frames of (B, T, H, W, C)."""

    def __init__(self, cin: int, cout: int, kt: int = 3, zero_init: bool = False):
        super().__init__()
        self.zero_init = zero_init
        self.kernel = param(kt, cin, cout)
        self.bias = param(cout)

    def fan_in(self) -> int:
        return self.kernel.shape[0] * self.kernel.shape[1]

    def forward(self, x, residual: bool = False):
        return ops.time_conv(x, self.kernel, self.bias, residual)


KERNEL_LAYERS = (Dense, Conv, TimeConv)
