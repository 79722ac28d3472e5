"""Normalization primitives over the trailing channel axis (channel-last).

Counterpart of ``streamingt2v_tpu/ops/norms.py``.  Statistics are taken in
float32 with the two-pass shifted variance E[(x - mean)^2] for GroupNorm
(the JAX package's f32 path; its bf16 one-pass form with the robust
fallback is a TPU bandwidth trade the port does not need) and the
one-pass clamped form for LayerNorm, as the JAX package computes it.

Per-frame (4-D) GroupNorm(+SiLU) runs the fused kernel K5
(``ops/fused_group_norm.py``, the JAX package's ``STREAMINGT2V_FUSED_GN``
route) and the statistics of K4's prologue (``group_norm_affine``, any rank)
K5's statistics pass, wherever the kernel's gate holds and autograd records
no graph (``needs_grad``: K5 has no backward).  Everything else takes the
one plain version of these statistics, the path autograd goes through.
"""

from __future__ import annotations

from typing import Optional

import torch

from streamingt2v_torch.ops.fused_group_norm import (
    fits_fused, fused_group_norm, fused_group_norm_affine, fused_group_norm_reference,
    group_norm_affine_reference, needs_grad)
from streamingt2v_torch.utils.profiling import span


def _rows(x: torch.Tensor, num_groups: int) -> tuple:
    """(N, ..., C) -> its (N, L, C) view and the group count."""
    c = x.shape[-1]
    # clamp for the tiny test configs; production widths are >= 128
    g = min(num_groups, c)
    if c % g:
        raise ValueError(f"channels {c} not divisible by {g} groups")
    return x.reshape(x.shape[0], -1, c), g


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
    rows, g = _rows(x, num_groups)
    if x.ndim == 4 and fits_fused(*rows.shape[1:], g) and not needs_grad(x, scale, bias):
        out = fused_group_norm(rows.contiguous(), scale.float().contiguous(),
                               bias.float().contiguous(), num_groups=g, eps=eps, act=act)
    else:
        out = fused_group_norm_reference(rows, scale, bias, num_groups=g, eps=eps, act=act)
    return out.reshape(x.shape)


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
    rows, g = _rows(x, num_groups)
    if fits_fused(*rows.shape[1:], g) and not needs_grad(x, scale, bias):
        return fused_group_norm_affine(rows.contiguous(), scale.float().contiguous(),
                                       bias.float().contiguous(), num_groups=g, eps=eps)
    return group_norm_affine_reference(rows, scale, bias, num_groups=g, eps=eps)


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
