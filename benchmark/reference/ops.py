"""Plain operations of the reference models: float32 matrix products and
convolutions, attention in blocks of queries, GroupNorm and LayerNorm with
f32 statistics, sinusoidal embeddings.

Two switches, both set by a context manager and read by every product:

- ``precision("fp8")`` rounds both operands of every matrix product and
  convolution to float8 e4m3 (a per-tensor scale, the largest magnitude to
  448) before an f32 product: the reference computed one precision below
  the bfloat16 that the configurations state, the control of the
  comparison that decides ``correct``.
- ``recording(log)`` appends one entry per attention, GEGLU feed-forward
  and temporal convolution to ``log``: the shapes from which
  ``benchmark/flops.py`` counts each kernel's operations and bytes.
"""

from __future__ import annotations

import contextlib
import math
from contextvars import ContextVar
from typing import List, Optional

import torch
import torch.nn.functional as F

_PRECISION: ContextVar = ContextVar("reference_precision", default="f32")
_LOG: ContextVar = ContextVar("reference_op_log", default=None)
FP8_MAX = 448.0
# f32 scores a block of queries may hold
ATTN_BLOCK_BYTES = 1 << 30


@contextlib.contextmanager
def precision(name: str):
    if name not in ("f32", "fp8"):
        raise ValueError(name)
    token = _PRECISION.set(name)
    try:
        yield
    finally:
        _PRECISION.reset(token)


@contextlib.contextmanager
def recording(log: List[dict]):
    token = _LOG.set(log)
    try:
        yield log
    finally:
        _LOG.reset(token)


def record(kind: str, **shape) -> None:
    log = _LOG.get()
    if log is not None:
        log.append(dict(kind=kind, **shape))


def operand(x: torch.Tensor) -> torch.Tensor:
    """An operand of a product in the precision in force, as f32."""
    x = x.float()
    if _PRECISION.get() == "fp8" and x.device.type != "meta":
        scale = x.abs().amax().clamp_min(1e-30) / FP8_MAX
        return (x / scale).to(torch.float8_e4m3fn).float() * scale
    return x


def linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor]) -> torch.Tensor:
    """x (..., in) @ w (out, in)^T + b."""
    return F.linear(operand(x), operand(w), None if b is None else b.float())


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(operand(a), operand(b))


def conv2d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], *, stride: int = 1,
           padding: int = 0) -> torch.Tensor:
    """Channel-last (..., H, W, C) convolution with w (out, in, kh, kw)."""
    lead = x.shape[:-3]
    xn = operand(x).reshape((-1,) + x.shape[-3:]).permute(0, 3, 1, 2)
    y = F.conv2d(xn, operand(w), None if b is None else b.float(), stride=stride,
                 padding=padding)
    y = y.permute(0, 2, 3, 1)
    return y.reshape(lead + y.shape[1:])


def time_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              residual: bool = False) -> torch.Tensor:
    """(kt, 1, 1) convolution of (B, T, H, W, C) over T with zero padding,
    w (kt, in, out): the sum over taps of shifted matrix products.
    ``residual`` only marks, for the op log, that its output is added to a
    residual."""
    kt = w.shape[0]
    bsz, t, hh, ww, c = x.shape
    record("time_conv", b=bsz, t=t, s=hh * ww, c=c, c_out=w.shape[2], kt=kt, residual=residual)
    lo = kt // 2
    xp = F.pad(operand(x), (0, 0, 0, 0, 0, 0, lo, kt - 1 - lo))
    wq = operand(w)
    out = b.float()
    for k in range(kt):
        out = out + torch.matmul(xp[:, k:k + t], wq[k])
    return out


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v over (N, Lq, D) x (N, Lk, D), f32, in
    blocks of queries whose scores fit ``ATTN_BLOCK_BYTES``."""
    n, lq, d = q.shape
    lk = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    rows = max(1, ATTN_BLOCK_BYTES // (4 * n * lk))
    outs = []
    for s in range(0, lq, rows):
        sc = matmul(q[:, s:s + rows], k.transpose(1, 2)) * scale
        outs.append(matmul(torch.softmax(sc, dim=-1), v))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def multihead(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int) -> torch.Tensor:
    """Attention over (B, L, H*D) with H heads, returned as (B, Lq, H*D)."""
    b, lq, hd = q.shape
    lk = k.shape[1]
    d = hd // heads
    record("attention", bh=b * heads, lq=lq, lk=lk, d=d)

    def split(z, l):
        return z.reshape(b, l, heads, d).transpose(1, 2).reshape(b * heads, l, d)

    o = attention(split(q, lq), split(k, lk), split(v, lk))
    return o.reshape(b, heads, lq, d).transpose(1, 2).reshape(b, lq, hd)


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *, groups: int = 32,
               eps: float = 1e-6, silu: bool = False) -> torch.Tensor:
    """GroupNorm of (N, ..., C): statistics per group over every axis but
    the first, in f32."""
    c = x.shape[-1]
    g = min(groups, c)
    xg = x.float().reshape(x.shape[0], -1, g, c // g)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = (xg - mean).square().mean(dim=(1, 3), keepdim=True)
    out = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape) * scale.float() + bias.float()
    return F.silu(out) if silu else out


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    return (xf - mean) * torch.rsqrt(var + eps) * scale.float() + bias.float()


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """(N,) -> (N, dim): cos then sin of t * exp(-log(max_period) i / half)."""
    t = t.float().reshape(-1)
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU."""
    return F.gelu(x.float())


def per_frame(h: torch.Tensor, fn) -> torch.Tensor:
    """A per-frame function of (B, T, H, W, C) with T folded into the batch."""
    out = fn(h.reshape((-1,) + h.shape[2:]))
    return out.reshape(h.shape[:2] + out.shape[1:])
