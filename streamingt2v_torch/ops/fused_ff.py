"""K3: GEGLU feed-forward, ``x + (a * gelu_erf(b)) W2 + b2`` with
``[a | b] = LN(x) W1 + b1``.

Replaces the Pallas kernel ``_ff_kernel`` (``streamingt2v_tpu/ops/
fused_ff.py:65``, launched from ``_geglu_pallas:247``) with the
hand-written CUDA kernels in ``csrc/geglu_ff.cu``.

What bounds it on the H100: the two products (2*N*C*2*inner +
2*N*inner*C_out flops) on the tensor cores.  A fused kernel that keeps the
(rows, C_out) output accumulator on chip fits only 16 rows per block at
C_out = 1280, and then streams all of W1 and W2 from L2 once per 16 rows.
The bf16 path therefore runs, over chunks of rows (``chunk_plan``), LN(x)
in bf16 (one kernel, once per element) and two passes of one tiled ``wgmma``
GEMM core: pass "up" writes G = a * gelu(b) (GEGLU in the epilogue, G
rounded to bf16 as the Pallas kernel rounds g to the input dtype), pass
"down" computes G W2 + b2 (+ x).  G and LN(x) live in scratch buffers of
one chunk (``G_CHUNK_BYTES``), sized in whole waves of the down pass so that
no pass ends on a part-filled card.  This module makes the plan (rows per
chunk, the down pass's tile width ``down_cols``, the SM count that caps the
persistent up pass) and hands it to the C entry, which launches as told.
The f32 path keeps the first, fused kernel (output widths up to
``MAX_C_OUT_F32``).

Weights come in the PyTorch Linear layout: ``w1`` (2*inner, C) holding
[a | b] and ``w2`` (C_out, inner).

Gradients: on the card ``geglu_ff`` is a ``torch.autograd.Function`` whose
forward launches K3 and saves the caller's operands, and whose backward is
the VJP of ``geglu_ff_reference`` (the JAX package's ``_geglu_core_bwd``,
``:207``: with and without LN, ``None`` for an absent LN), in chunks of rows
that keep one chunk's f32 intermediates within ``BWD_CHUNK_BYTES``
(``geglu_ff_backward``); ``geglu_ff.bwd_chunks`` counts them.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from streamingt2v_torch.ops import _native
from streamingt2v_torch.ops._backward import BWD_CHUNK_BYTES, chunked_vjp

# widest output the f32 kernel's register accumulator takes (16 rows x 1280)
MAX_C_OUT_F32 = 1280
# G (rows x inner bf16) of one chunk of rows stays within this budget, or
# holds one wave of the down pass where that is more (``chunk_size``).  Not
# sized for L2: on the H100 each chunk's launches and their tails cost more
# than reading G back from HBM (PERF.md, ``scripts/time_kernels.py
# --budgets-mib``).
G_CHUNK_BYTES = 192 << 20
# rows of a tile of the GEMM core (``GW_BM`` in geglu_ff.cu)
ROW_TILE = 128


def _layer_norm(x: torch.Tensor, ln_scale, ln_bias) -> torch.Tensor:
    """One-pass statistics clamped at 0, eps 1e-5, in f32."""
    h = x.float()
    mean = h.mean(dim=-1, keepdim=True)
    var = (h.square().mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0.0)
    h = (h - mean) * torch.rsqrt(var + 1e-5) * ln_scale.float()
    return h if ln_bias is None else h + ln_bias.float()


def geglu_up_reference(x, w1, b1, ln_scale=None, ln_bias=None) -> torch.Tensor:
    """Pass "up" in f32: G = a * gelu_erf(b), [a | b] = LN(x) W1 + b1."""
    inner = w1.shape[0] // 2
    h = x.float() if ln_scale is None else _layer_norm(x, ln_scale, ln_bias)
    z = F.linear(h, w1.float(), b1.float())
    return z[..., :inner] * F.gelu(z[..., inner:])


def geglu_down_reference(g, w2, b2, x=None) -> torch.Tensor:
    """Pass "down" in f32: G W2 + b2, plus x when given (the residual)."""
    out = F.linear(g.float(), w2.float(), b2.float())
    return out if x is None else out + x.float()


def geglu_ff_reference(x, w1, b1, w2, b2, ln_scale=None, ln_bias=None,
                       residual: bool = False, g_dtype=None) -> torch.Tensor:
    """Plain version in f32: the two passes of the bf16 kernels without the
    fusion, G rounded to ``g_dtype`` between them when given (the bf16
    kernels store it in bf16)."""
    g = geglu_up_reference(x, w1, b1, ln_scale, ln_bias)
    if g_dtype is not None:
        g = g.to(g_dtype).float()
    return geglu_down_reference(g, w2, b2, x if residual else None).to(x.dtype)


def down_cols(c_out: int) -> int:
    """Output columns per block of the down pass: 320 where C_out allows (the
    UNet widths: G is then read once per row tile), else 64.  The C entry
    takes this as its ``down_cols`` and has an instance for each."""
    return 320 if c_out % 320 == 0 else 64


def chunk_size(n: int, inner: int, c_out: int, sms: int = 132) -> int:
    """Rows per chunk: whole waves of the down pass (as many ``ROW_TILE``-row
    tiles as fill ``sms`` SMs at one block each) whose bf16 G fits
    ``G_CHUNK_BYTES``, at least one wave, and no more than n."""
    wave = max(1, sms // -(-c_out // down_cols(c_out))) * ROW_TILE
    return min(n, max(1, G_CHUNK_BYTES // (2 * inner * wave)) * wave)


def chunk_plan(n: int, rows: int) -> list:
    """(start, count) of each chunk of ``rows`` rows, in order, covering n."""
    return [(start, min(rows, n - start)) for start in range(0, n, rows)]


def geglu_ff(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
             b2: torch.Tensor, *, ln_scale: Optional[torch.Tensor] = None,
             ln_bias: Optional[torch.Tensor] = None, residual: bool = False) -> torch.Tensor:
    """x: (..., C); w1 (2*inner, C); b1 (2*inner,); w2 (C_out, inner);
    b2 (C_out,).  CPU tensors take the plain version; CUDA tensors launch
    K3 (or raise), differentiable through ``geglu_ff_backward``."""
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
    f32 = x.dtype == torch.float32
    if c % 16 or c_out % 8 or inner % 32 or (f32 and c_out > MAX_C_OUT_F32):
        raise ValueError(f"geglu_ff: needs C % 16 == 0, C_out % 8 == 0, inner % 32 == 0 "
                         f"(and C_out <= {MAX_C_OUT_F32} in f32); got C={c} C_out={c_out} "
                         f"inner={inner}")
    if residual and c_out != c:
        raise ValueError("geglu_ff: residual needs C_out == C")
    vecs = [b1, b2] + ([] if ln_scale is None else [ln_scale, ln_bias])
    if any(t is None or t.dtype != torch.float32 or t.device != x.device or not t.is_contiguous()
           for t in vecs):
        raise TypeError("geglu_ff: b1, b2, ln_scale, ln_bias must be contiguous f32 on x's device")
    if ln_scale is not None and (ln_scale.shape != (c,) or ln_bias.shape != (c,)):
        raise ValueError("geglu_ff: ln_scale/ln_bias must be (C,)")
    for t in (x, w1, w2):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("geglu_ff: x, w1 and w2 must be contiguous on one device")
    return _GegluFF.apply(x, w1, b1, w2, b2, ln_scale, ln_bias, residual)


def _launch_geglu(x, w1, b1, w2, b2, ln_scale, ln_bias, residual: bool) -> torch.Tensor:
    """One K3 call (its chunks of rows) on checked operands."""
    c = x.shape[-1]
    c_out, inner = w2.shape
    n = x.numel() // c
    out = torch.empty(x.shape[:-1] + (c_out,), dtype=x.dtype, device=x.device)
    lib, stream, code = _native.library(), _native.stream_of(x), _native.DTYPE_CODE[x.dtype]
    if x.dtype == torch.float32:
        plan, g, xn, cols, sms = [(0, n)], None, None, 0, 0
    else:
        x, w1, b1, w2, ln_scale, ln_bias = map(_native.aligned,
                                                (x, w1, b1, w2, ln_scale, ln_bias))
        cols, sms = down_cols(c_out), _native.sm_count(x.device)
        rows = chunk_size(n, inner, c_out, sms)
        plan = chunk_plan(n, rows)
        g = torch.empty((rows, inner), dtype=x.dtype, device=x.device)
        xn = None if ln_scale is None else torch.empty((rows, c), dtype=x.dtype, device=x.device)
    elem = x.element_size()
    for start, count in plan:
        rc = lib.st2v_geglu_ff(
            x.data_ptr() + start * c * elem, w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), None if ln_scale is None else ln_scale.data_ptr(),
            None if ln_scale is None else ln_bias.data_ptr(),
            out.data_ptr() + start * c_out * elem, None if g is None else g.data_ptr(),
            None if xn is None else xn.data_ptr(), count, c, inner, c_out, int(residual),
            code, cols, sms, stream)
        _native.check(rc, "geglu_ff")
    geglu_ff.launches += 1
    return out


def backward_chunk_rows(c: int, inner: int, c_out: int) -> int:
    """Rows per backward chunk: autograd through the plain version keeps
    about 4C + 8*inner + 2*C_out f32 values a row (x, LN, [a | b], GEGLU,
    G, the output and their gradients); as many rows as fit
    ``BWD_CHUNK_BYTES``, at least one."""
    return max(1, BWD_CHUNK_BYTES // (4 * (4 * c + 8 * inner + 2 * c_out)))


def geglu_ff_backward(x, w1, b1, w2, b2, ln_scale, ln_bias, residual: bool, g: torch.Tensor,
                      chunk: Optional[int] = None) -> tuple:
    """The VJP of ``geglu_ff_reference`` at the operands for the cotangent
    g (x's leading shape by C_out), in chunks of ``chunk`` rows
    (``backward_chunk_rows`` unless given).  Returns ((dx, dw1, db1, dw2,
    db2, dln_scale, dln_bias), chunks run): each in its operand's dtype,
    ``None`` for an absent LN."""
    c = x.shape[-1]
    c_out, inner = w2.shape
    rows = chunk or backward_chunk_rows(c, inner, c_out)

    def plain(x_, w1_, b1_, w2_, b2_, lns_, lnb_):
        return geglu_ff_reference(x_, w1_, b1_, w2_, b2_, lns_, lnb_, residual)

    grads, chunks = chunked_vjp(plain, (x.reshape(-1, c), w1, b1, w2, b2, ln_scale, ln_bias),
                                (0,), g.reshape(-1, c_out), 0, rows)
    return (grads[0].reshape(x.shape),) + grads[1:], chunks


class _GegluFF(torch.autograd.Function):
    """K3 forward, the plain version's VJP backward."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, ln_scale, ln_bias, residual):
        ctx.save_for_backward(x, w1, b1, w2, b2, ln_scale, ln_bias)
        ctx.residual = residual
        return _launch_geglu(x, w1, b1, w2, b2, ln_scale, ln_bias, residual)

    @staticmethod
    def backward(ctx, g):
        grads, chunks = geglu_ff_backward(*ctx.saved_tensors, ctx.residual, g)
        geglu_ff.bwd_chunks += chunks
        return grads + (None,)


geglu_ff.launches = 0
geglu_ff.bwd_chunks = 0
