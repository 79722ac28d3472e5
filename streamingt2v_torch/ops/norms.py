"""Normalization primitives over the trailing channel axis (channel-last).

Counterpart of ``streamingt2v_tpu/ops/norms.py``.  Statistics are taken in
float32 with the two-pass shifted variance E[(x - mean)^2] for GroupNorm
(the JAX package's f32 path; its bf16 one-pass form with the robust
fallback is a TPU bandwidth trade the port does not need) and the
one-pass clamped form for LayerNorm, as the JAX package computes it.

Per-frame (4-D) GroupNorm(+SiLU) runs the fused kernel K5
(``ops/fused_group_norm.py``, the JAX package's ``STREAMINGT2V_FUSED_GN``
route), the statistics of K4's prologue (``group_norm_affine``, any rank)
K5's statistics pass, and LayerNorm and RMSNorm (Wan's q/k norm across
heads) the one-pass kernel K7 (``ops/fused_layer_norm.py``; rows up to
8192 channels, past 4096 split over several warps), wherever the kernel's
gate holds and autograd records no graph (``needs_grad``: none has a
backward).  Everything else takes the one plain version of these
statistics, the path autograd goes through.
"""

from __future__ import annotations

from typing import Optional

import torch

from streamingt2v_torch.ops import _native
from streamingt2v_torch.ops.fused_group_norm import (
    fits_fused, fused_group_norm, fused_group_norm_affine, fused_group_norm_reference,
    group_norm_affine_reference, needs_grad)
from streamingt2v_torch.ops.fused_layer_norm import (
    fits_fused_ln, fused_layer_norm, fused_rms_norm, layer_norm_reference, rms_norm_reference)
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
    """LayerNorm over the last axis, statistics in f32, returned in x's
    dtype: K7 on the card, else the plain version."""
    c = x.shape[-1]
    params = [t for t in (scale, bias) if t is not None]
    if x.is_cuda and fits_fused_ln(c, x.dtype) and not needs_grad(x, *params):
        rows = _native.aligned(x.reshape(-1, c).contiguous())
        return fused_layer_norm(rows, _f32(scale), _f32(bias), eps).view(x.shape)
    return layer_norm_reference(x, scale, bias, eps=eps)


def _f32(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if t is None else _native.aligned(t.float().contiguous())


@span("st2v.norm")
def rms_norm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis (all of a token's channels: Wan's q/k norm
    across heads), in f32, times ``scale``, returned in x's dtype: K7's RMS
    entry on the card, else the plain version."""
    c = x.shape[-1]
    if x.is_cuda and fits_fused_ln(c, x.dtype) and not needs_grad(x, scale):
        rows = _native.aligned(x.reshape(-1, c).contiguous())
        return fused_rms_norm(rows, _f32(scale), eps).view(x.shape)
    return rms_norm_reference(x, scale, eps=eps)
