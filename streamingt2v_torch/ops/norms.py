"""Normalization primitives over the trailing channel axis (channel-last).

Counterpart of ``streamingt2v_tpu/ops/norms.py``.  Statistics are taken in
float32 with the two-pass shifted variance E[(x - mean)^2] for GroupNorm
(the JAX package's f32 path; its bf16 one-pass form with the robust
fallback is a TPU bandwidth trade the port does not need) and the
one-pass clamped form for LayerNorm, as the JAX package computes it.

Per-frame (4-D) GroupNorm(+SiLU) runs the fused kernel K5
(``ops/fused_group_norm.py``) when the routing in force has
``fused_group_norm``: the JAX package's ``STREAMINGT2V_FUSED_GN`` route.
Under the same routing the statistics of K4's prologue
(``group_norm_affine``, any rank) take K5's statistics pass
(``fused_group_norm_affine``, which raises under grad as K5 does); outside
it they take the same plain version, the path autograd goes through.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from streamingt2v_torch.ops.fused_group_norm import (
    fits_fused, fused_group_norm, fused_group_norm_affine, group_norm_affine_reference)
from streamingt2v_torch.ops.routing import current_routing
from streamingt2v_torch.utils.profiling import span


def _grouped(x: torch.Tensor, num_groups: int) -> tuple:
    """(N, ..., C) -> f32 view (N, L, G, C/G) and the clamped group count."""
    c = x.shape[-1]
    # clamp for the tiny test configs; production widths are >= 128
    g = min(num_groups, c)
    if c % g:
        raise ValueError(f"channels {c} not divisible by {g} groups")
    return x.float().reshape(x.shape[0], -1, g, c // g), g


def _group_stats(xg: torch.Tensor, eps: float) -> tuple:
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = (xg - mean).square().mean(dim=(1, 3), keepdim=True)
    return mean, torch.rsqrt(var + eps)


@span("st2v.norm")
def group_norm(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    *,
    num_groups: int = 32,
    eps: float = 1e-6,
    act: Optional[str] = None,
) -> torch.Tensor:
    """GroupNorm of (N, ..., C) with statistics over every non-batch axis
    (so a 5-D (B, T, H, W, C) input reduces over T*H*W per batch row),
    optionally fused with SiLU (``act='silu'``)."""
    if act not in (None, "silu"):
        raise ValueError(act)
    if x.ndim == 4 and current_routing().fused_group_norm:
        n, hh, ww, c = x.shape
        g = min(num_groups, c)
        if fits_fused(hh * ww, c, g):
            return fused_group_norm(x.reshape(n, hh * ww, c).contiguous(),
                                    scale.float().contiguous(), bias.float().contiguous(),
                                    num_groups=g, eps=eps, act=act).reshape(x.shape)
    xg, _ = _grouped(x, num_groups)
    mean, inv = _group_stats(xg, eps)
    out = ((xg - mean) * inv).reshape(x.shape) * scale.float() + bias.float()
    if act == "silu":
        out = F.silu(out)
    return out.to(x.dtype)


@span("st2v.norm")
def group_norm_affine(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    *,
    num_groups: int = 32,
    eps: float = 1e-6,
) -> tuple:
    """GroupNorm as a per-(batch row, channel) affine: f32 (a, b), each
    (N, C), with group_norm(x, scale, bias) == x * a + b.  The temporal-conv
    kernel applies it (plus SiLU) as it reads its input."""
    n, c = x.shape[0], x.shape[-1]
    # clamp for the tiny test configs; production widths are >= 128
    g = min(num_groups, c)
    if c % g:
        raise ValueError(f"channels {c} not divisible by {g} groups")
    if current_routing().fused_group_norm and fits_fused(math.prod(x.shape[1:-1]), c, g):
        return fused_group_norm_affine(x.reshape(n, -1, c).contiguous(),
                                       scale.float().contiguous(), bias.float().contiguous(),
                                       num_groups=g, eps=eps)
    return group_norm_affine_reference(x.reshape(n, -1, c), scale, bias, num_groups=g, eps=eps)


@span("st2v.norm")
def layer_norm(
    x: torch.Tensor,
    scale: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    *,
    eps: float = 1e-5,
) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf.square().mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0.0)
    out = (xf - mean) * torch.rsqrt(var + eps)
    if scale is not None:
        out = out * scale.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)
