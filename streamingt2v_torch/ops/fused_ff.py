"""K3: fused GEGLU feed-forward, ``x + (a * gelu_erf(b)) W2 + b2`` with
``[a | b] = LN(x) W1 + b1``.

Replaces the Pallas kernel ``_ff_kernel`` (``streamingt2v_tpu/ops/
fused_ff.py:65``, launched from ``_geglu_pallas:247``) with the
hand-written CUDA kernel in ``csrc/geglu_ff.cu``.

What bounds it on the H100: the two products (2*N*C*2*inner +
2*N*inner*C_out flops) on the tensor cores; the unfused form would also
write and re-read the (N, 2*inner) GEGLU tensor, 2.4 GB per call at the
level-0 UNet geometry.  The kernel keeps that tensor on chip: per row tile
it takes the LayerNorm statistics once (one-pass mean/var clamped at 0,
eps 1e-5), walks the inner axis in tiles (both halves of LN(x) W1, GEGLU
with the exact erff, then the tile's W2 product into an f32 accumulator
held in registers) and adds b2 and the residual at the end.  Weights
stream through shared memory once per row tile, from L2.

Weights come in the PyTorch Linear layout: ``w1`` (2*inner, C) holding
[a | b] and ``w2`` (C_out, inner).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from streamingt2v_torch.ops import _native

# widest output the kernel's register accumulator takes (16 rows x 1280)
MAX_C_OUT = 1280


def geglu_ff_reference(x, w1, b1, w2, b2, ln_scale=None, ln_bias=None,
                       residual: bool = False) -> torch.Tensor:
    """Plain version in f32: the same function without the fusion."""
    inner = w2.shape[1]
    h = x.float()
    if ln_scale is not None:
        mean = h.mean(dim=-1, keepdim=True)
        var = (h.square().mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0.0)
        h = (h - mean) * torch.rsqrt(var + 1e-5) * ln_scale.float()
        if ln_bias is not None:
            h = h + ln_bias.float()
    z = F.linear(h, w1.float(), b1.float())
    g = z[..., :inner] * F.gelu(z[..., inner:])
    out = F.linear(g, w2.float(), b2.float())
    if residual:
        out = out + x.float()
    return out.to(x.dtype)


def geglu_ff(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
             b2: torch.Tensor, *, ln_scale: Optional[torch.Tensor] = None,
             ln_bias: Optional[torch.Tensor] = None, residual: bool = False) -> torch.Tensor:
    """x: (..., C); w1 (2*inner, C); b1 (2*inner,); w2 (C_out, inner);
    b2 (C_out,).  CPU tensors take the plain version; CUDA tensors launch
    K3 (or raise)."""
    if x.device.type == "cpu":
        return geglu_ff_reference(x, w1, b1, w2, b2, ln_scale, ln_bias, residual)
    if not x.is_cuda:
        raise ValueError(f"geglu_ff: expected a CUDA tensor, got {x.device}")
    if x.dtype not in _native.DTYPE_CODE or w1.dtype != x.dtype or w2.dtype != x.dtype:
        raise TypeError(f"geglu_ff: x/w1/w2 must be one of f32/bf16, got "
                        f"{x.dtype}/{w1.dtype}/{w2.dtype}")
    c = x.shape[-1]
    c_out, inner = w2.shape
    if w1.shape != (2 * inner, c) or b1.shape != (2 * inner,) or b2.shape != (c_out,):
        raise ValueError(f"geglu_ff: bad weight shapes w1{tuple(w1.shape)} b1{tuple(b1.shape)} "
                         f"w2{tuple(w2.shape)} b2{tuple(b2.shape)} for C={c}")
    if c % 16 or c_out % 8 or inner % 32 or c_out > MAX_C_OUT:
        raise ValueError(f"geglu_ff: needs C % 16 == 0, C_out % 8 == 0, inner % 32 == 0 "
                         f"and C_out <= {MAX_C_OUT}; got C={c} C_out={c_out} inner={inner}")
    if residual and c_out != c:
        raise ValueError("geglu_ff: residual needs C_out == C")
    f32 = [b1, b2] + ([] if ln_scale is None else [ln_scale, ln_bias])
    if any(t is None or t.dtype != torch.float32 or t.device != x.device or not t.is_contiguous()
           for t in f32):
        raise TypeError("geglu_ff: b1, b2, ln_scale, ln_bias must be contiguous f32 on x's device")
    if ln_scale is not None and (ln_scale.shape != (c,) or ln_bias.shape != (c,)):
        raise ValueError("geglu_ff: ln_scale/ln_bias must be (C,)")
    for t in (x, w1, w2):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("geglu_ff: x, w1 and w2 must be contiguous on one device")
    n = x.numel() // c
    out = torch.empty(x.shape[:-1] + (c_out,), dtype=x.dtype, device=x.device)
    rc = _native.library().st2v_geglu_ff(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        None if ln_scale is None else ln_scale.data_ptr(),
        None if ln_scale is None else ln_bias.data_ptr(),
        out.data_ptr(), n, c, inner, c_out, int(residual), _native.DTYPE_CODE[x.dtype],
        _native.stream_of(x))
    _native.check(rc, "geglu_ff")
    geglu_ff.launches += 1
    return out


geglu_ff.launches = 0
