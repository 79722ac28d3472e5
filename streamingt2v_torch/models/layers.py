"""Parameter-holding layers in the JAX package's layouts.

``Dense``, ``Embed``, ``Conv``, ``Conv1D``, ``ConvTranspose`` and ``TimeConv`` carry the
flax parameter names (``kernel``, ``bias``) so that a module's state-dict keys
are the flax paths with ``/`` replaced by ``.``; their kernels are stored in
PyTorch's layouts: Dense (out, in), Conv (out, in/groups, kh, kw), Conv1D
(out, in, k), ConvTranspose (in, out, kh, kw), and the (kt, 1, 1) time conv as the
temporal-conv kernel's (kt, in, out).  Activations stay
channel-last; a Conv permutes to an NCHW view only around the cuDNN call
(the view of an NHWC tensor is already channels_last, so nothing copies).

Like flax with ``dtype=None``, a layer computes in the wider of its
input's and its parameters' dtypes.
"""

from __future__ import annotations

import math
from typing import Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn


def _param(shape, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype), requires_grad=False)


def norm_params(module: nn.Module, name: str, c: int, device=None, dtype=None) -> None:
    """Register ``{name}_scale`` (ones) and ``{name}_bias`` (zeros)."""
    module.register_parameter(f"{name}_scale", _param((c,), device, dtype))
    module.register_parameter(f"{name}_bias", _param((c,), device, dtype))


def norm_pair(module: nn.Module, name: str) -> tuple:
    return getattr(module, f"{name}_scale"), getattr(module, f"{name}_bias")


def _common(x: torch.Tensor, w: torch.Tensor) -> torch.dtype:
    return torch.promote_types(x.dtype, w.dtype)


class Dense(nn.Module):
    """flax ``nn.Dense``: kernel (out, in), optional bias (out,)."""

    def __init__(self, in_features: int, out_features: int, *, bias: bool = True,
                 zero_init: bool = False, device=None, dtype=None):
        super().__init__()
        self.zero_init = zero_init
        self.kernel = _param((out_features, in_features), device, dtype)
        self.bias = _param((out_features,), device, dtype) if bias else None

    def fan_in(self) -> int:
        return self.kernel.shape[1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.apply_bias(x, self.bias)

    def apply_bias(self, x: torch.Tensor, bias) -> torch.Tensor:
        """x W^T + ``bias`` (None: no bias): a row-parallel slice adds its
        layer's bias once, after the reduction."""
        dt = _common(x, self.kernel)
        return F.linear(x.to(dt), self.kernel.to(dt), None if bias is None else bias.to(dt))


class Embed(nn.Module):
    """flax ``nn.Embed``: an (n, features) table looked up by integer ids."""

    def __init__(self, num_embeddings: int, features: int, *, device=None, dtype=None):
        super().__init__()
        self.embedding = _param((num_embeddings, features), device, dtype)

    @torch.no_grad()
    def init_extra_(self, generator: torch.Generator) -> None:
        """normal(1/sqrt(features))."""
        e = self.embedding
        e.copy_(torch.randn(e.shape, generator=generator, device=e.device)
                * e.shape[1] ** -0.5)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.embedding[ids]


class Conv(nn.Module):
    """flax ``nn.Conv`` over channel-last (..., H, W, C); kernel
    (out, in/groups, kh, kw).  ``padding`` is 'SAME' (stride 1), 'VALID' or a
    symmetric int; ``dilation`` is flax's ``kernel_dilation`` and ``groups``
    its ``feature_group_count``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, *,
                 stride: int = 1, padding: Union[str, int] = "SAME", dilation: int = 1,
                 groups: int = 1, bias: bool = True, zero_init: bool = False, device=None,
                 dtype=None):
        super().__init__()
        if padding == "SAME":
            if stride != 1:
                raise ValueError("SAME padding is only used with stride 1")
            padding = kernel_size // 2 * dilation
        elif padding == "VALID":
            padding = 0
        self.stride = stride
        self.padding = padding
        self.dilation = dilation
        self.groups = groups
        self.zero_init = zero_init
        self.kernel = _param((out_channels, in_channels // groups, kernel_size, kernel_size),
                             device, dtype)
        self.bias = _param((out_channels,), device, dtype) if bias else None

    def fan_in(self) -> int:
        return self.kernel[0].numel()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-3]
        dt = _common(x, self.kernel)
        xn = x.reshape((-1,) + x.shape[-3:]).to(dt).permute(0, 3, 1, 2)
        y = F.conv2d(xn, self.kernel.to(dt), None if self.bias is None else self.bias.to(dt),
                     stride=self.stride, padding=self.padding, dilation=self.dilation,
                     groups=self.groups)
        y = y.permute(0, 2, 3, 1)
        return y.reshape(lead + y.shape[1:])


class Conv1D(nn.Module):
    """flax ``nn.Conv(out, (k,), padding="SAME")`` over channel-FIRST
    (N, in, L) input, as torch's ``conv1d``: kernel (out, in, k)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, *,
                 device=None, dtype=None):
        super().__init__()
        if kernel_size % 2 != 1:
            raise ValueError(f"SAME padding needs an odd kernel, got {kernel_size}")
        self.zero_init = False
        self.kernel = _param((out_channels, in_channels, kernel_size), device, dtype)
        self.bias = _param((out_channels,), device, dtype)

    def fan_in(self) -> int:
        return self.kernel[0].numel()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _common(x, self.kernel)
        return F.conv1d(x.to(dt), self.kernel.to(dt), self.bias.to(dt),
                        padding=self.kernel.shape[-1] // 2)


class ConvTranspose(nn.Module):
    """flax ``nn.ConvTranspose(features, (k, k), strides=(s, s), padding="SAME")``
    over channel-last (N, H, W, C): output (N, s*H, s*W, out).  flax convolves
    the stride-dilated input with its (kh, kw, in, out) kernel as it is;
    ``conv_transpose2d`` convolves with the spatially flipped kernel, so the
    kernel is stored flipped, as (in, out, kh, kw) (``utils/weights.py``).
    It runs as ``conv_transpose_subpixel``: the same function from forward
    convolutions only, so that it is the same from run to run on a card."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 4, *,
                 stride: int = 2, device=None, dtype=None):
        super().__init__()
        if (kernel_size - stride) % 2:
            raise ValueError(f"SAME transposed conv needs an even kernel - stride, "
                             f"got {kernel_size} - {stride}")
        self.stride = stride
        self.padding = (kernel_size - stride) // 2
        self.zero_init = False
        self.kernel = _param((in_channels, out_channels, kernel_size, kernel_size), device, dtype)
        self.bias = _param((out_channels,), device, dtype)

    def fan_in(self) -> int:
        return self.kernel.shape[0] * self.kernel.shape[2] * self.kernel.shape[3]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _common(x, self.kernel)
        y = conv_transpose_subpixel(x.to(dt).permute(0, 3, 1, 2), self.kernel.to(dt),
                                    self.bias.to(dt), self.stride, self.padding)
        return y.permute(0, 2, 3, 1)


def conv_transpose_subpixel(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                            stride: int, padding: int) -> torch.Tensor:
    """``F.conv_transpose2d(x, kernel, bias, stride, padding)`` over NCHW,
    for an output of stride times the input's size, as one ordinary
    stride-1 convolution and an interleave: output row s*m + a (phase a)
    takes input row m + d through tap t wherever d = (a + padding - t) / s
    is whole, so each of the s*s phases is a small convolution of x (its
    taps at their offsets d in a window shared by the phases), and all of
    them are one convolution into s*s*out channels.  Every convolution is
    then a forward one: the transposed one runs cuDNN's backward-data
    algorithms, whose default sums in an order that varies between runs."""
    cin, cout, k, _ = kernel.shape
    s = stride
    taps = [[(t, (a + padding - t) // s) for t in range(k) if (a + padding - t) % s == 0]
            for a in range(s)]
    first = [min(d for _, d in phase) for phase in taps]
    win = max(max(d for _, d in phase) - f + 1 for phase, f in zip(taps, first))
    pad = max(-min(first), max(first) + win - 1)    # (k 4, stride 2: window 2, pad 1)
    sub = kernel.new_zeros(s, s, cout, cin, win, win)
    for a, (rows, fa) in enumerate(zip(taps, first)):
        for b, (cols, fb) in enumerate(zip(taps, first)):
            for ty, dy in rows:
                for tx, dx in cols:
                    sub[a, b, :, :, dy - fa, dx - fb] = kernel[:, :, ty, tx].t()
    y = F.conv2d(x, sub.reshape(s * s * cout, cin, win, win), bias.repeat(s * s), padding=pad)
    n, _, h, w = x.shape
    y = y.view(n, s, s, cout, y.shape[-2], y.shape[-1])
    out = y.new_empty(n, cout, h, s, w, s)
    for a in range(s):
        for b in range(s):
            ra, rb = first[a] + pad, first[b] + pad
            out[:, :, :, a, :, b] = y[:, a, b, :, ra:ra + h, rb:rb + w]
    return out.view(n, cout, h * s, w * s)


def prelu_param(module: nn.Module, name: str, c: int, device=None, dtype=None) -> None:
    """Register a per-channel PReLU slope ``name`` (torch ``nn.PReLU(c)``;
    ``init_random_`` sets it to 0.25)."""
    module.register_parameter(name, _param((c,), device, dtype))


def prelu(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, a.to(x.dtype) * x)


class TimeConv(nn.Module):
    """flax ``nn.Conv`` with a (kt, 1, 1) kernel over (B, T, H, W, C), zero
    SAME padding on T; kernel stored as (kt, in, out)."""

    def __init__(self, in_channels: int, out_channels: int, kernel: Tuple[int, int, int], *,
                 zero_init: bool = False, device=None, dtype=None):
        super().__init__()
        kt, kh, kw = kernel
        if (kh, kw) != (1, 1) or kt % 2 != 1:
            raise NotImplementedError(f"temporal kernel {kernel}: only odd (kt, 1, 1)")
        self.zero_init = zero_init
        self.kernel = _param((kt, in_channels, out_channels), device, dtype)
        self.bias = _param((out_channels,), device, dtype)

    def fan_in(self) -> int:
        return self.kernel.shape[0] * self.kernel.shape[1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Plain conv3d (cuDNN on the card)."""
        dt = _common(x, self.kernel)
        kt = self.kernel.shape[0]
        w = self.kernel.to(dt).permute(2, 1, 0)[..., None, None]
        y = F.conv3d(x.to(dt).permute(0, 4, 1, 2, 3), w, self.bias.to(dt), padding=(kt // 2, 0, 0))
        return y.permute(0, 2, 3, 4, 1)


@torch.no_grad()
def init_random_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights from ``generator``, following the flax initialisers:
    lecun-normal kernels (zeros where the layer is zero-initialised), zero
    biases, unit norm scales, zero blend factors, PReLU slopes of 0.25;
    modules with other initialisers define ``init_extra_(generator)``."""
    done = set()
    for m in module.modules():
        if isinstance(m, (Dense, Conv, Conv1D, ConvTranspose, TimeConv)):
            if m.zero_init:
                m.kernel.zero_()
            else:
                std = 1.0 / math.sqrt(m.fan_in())
                m.kernel.copy_(torch.randn(m.kernel.shape, generator=generator,
                                           device=m.kernel.device) * std)
            done.add(id(m.kernel))
    for name, p in module.named_parameters():
        if id(p) in done:
            continue
        if name.endswith("_scale"):
            p.fill_(1.0)
        elif name.rsplit(".", 1)[-1].endswith("prelu"):
            p.fill_(0.25)
        else:
            p.zero_()
    for m in module.modules():
        extra = getattr(m, "init_extra_", None)
        if extra is not None:
            extra(generator)
    return module


def per_frame(h: torch.Tensor, fn) -> torch.Tensor:
    """Apply a spatial function to (B, T, H, W, C) with frames folded into
    the batch (per-frame statistics, 2x resampling)."""
    out = fn(h.reshape((-1,) + h.shape[2:]))
    return out.reshape(h.shape[:2] + out.shape[1:])


def silu_f32(x: torch.Tensor) -> torch.Tensor:
    """SiLU computed in f32, returned in x's dtype (the JAX package's idiom
    for the embedding inputs)."""
    return F.silu(x.float()).to(x.dtype)

