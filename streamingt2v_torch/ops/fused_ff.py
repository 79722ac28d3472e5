"""K3: GEGLU feed-forward, ``x + (a * gelu_erf(b)) W2 + b2`` with
``[a | b] = LN(x) W1 + b1``.

Replaces the Pallas kernel ``_ff_kernel`` (``streamingt2v_tpu/ops/
fused_ff.py:65``, launched from ``_geglu_pallas:247``) with the
hand-written CUDA kernels in ``csrc/geglu_ff.cu``.

What bounds it on the H100: the two products (2*N*C*2*inner +
2*N*inner*C_out flops), on the tensor cores in bf16 and on the FMA units in
f32.  A fused kernel that keeps the (rows, C_out) output accumulator on
chip fits only 16 rows per block at C_out = 1280, and then streams all of
W1 and W2 from L2 once per 16 rows.  Both dtypes therefore run, over chunks
of rows (``chunk_plan``), an LN step and two passes of one tiled GEMM core:
pass "up" writes G = a * gelu(b) (GEGLU in the epilogue), pass "down"
computes G W2 + b2 (+ x).  G lives in a scratch buffer of one chunk
(``G_CHUNK_BYTES``), sized in whole waves of the down pass so that no pass
ends on a part-filled card.

- bf16: LN(x) in bf16 (one kernel, once per element, into a scratch of one
  chunk), the core on ``wgmma``; G rounded to bf16 as the Pallas kernel
  rounds g to the input dtype.  This module makes the plan (rows per chunk,
  the down pass's tile width ``down_cols``, the SM count that caps the
  persistent up pass) and hands it to the C entry, which launches as told.
- f32 (full f32, TF32 off): each row's LN mean and rstd (8 bytes a row),
  applied by the up pass as it stages x; the core on the FMA units, 128 x
  128 tiles of 8 x 8 register microtiles, the weights repacked k-major
  once a call (``f32_operands``); G in f32.  It takes every width bf16
  takes.

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
from streamingt2v_torch.utils.profiling import count_launch

# G (rows x inner, in x's dtype) of one chunk of rows stays within this budget, or
# holds one wave of the down pass where that is more (``chunk_size``).  Not
# sized for L2: on the H100 each chunk's launches and their tails cost more
# than reading G back from HBM (PERF.md, ``scripts/time_kernels.py
# --budgets-mib``).
G_CHUNK_BYTES = 192 << 20
# rows of a tile of the GEMM cores (``GW_BM`` and ``GT_BM`` in geglu_ff.cu)
ROW_TILE = 128
# the f32 core's tile columns and blocks an SM (``GT_BN``, ``GT_BLOCKS``)
F32_COLS = 128
F32_BLOCKS = 2


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


def chunk_size(n: int, inner: int, c_out: int, sms: int = 132, elem: int = 2) -> int:
    """Rows per chunk: whole waves of the down pass (as many ``ROW_TILE``-row
    tiles as fill ``sms`` SMs: bf16 one block an SM over ``down_cols``
    columns, f32 ``F32_BLOCKS`` over ``F32_COLS``) whose G of ``elem``-byte
    elements fits ``G_CHUNK_BYTES``, at least one wave, and no more than n."""
    if elem == 2:
        blocks, cols = sms, down_cols(c_out)
    else:
        blocks, cols = F32_BLOCKS * sms, F32_COLS
    wave = max(1, blocks // -(-c_out // cols)) * ROW_TILE
    return min(n, max(1, G_CHUNK_BYTES // (elem * inner * wave)) * wave)


def f32_operands(w1: torch.Tensor, w2: torch.Tensor) -> tuple:
    """The f32 core's B operands, contiguous and k-major: W1 (2*inner, C) as
    (C, 2*inner64), each 128 columns 64 rows of W1's a slab then the
    matching 64 of its b slab (zero rows past inner: inner64 is inner
    rounded up to 64), so a lane's four a and four b columns are those of
    the same G elements; and W2^T (inner, C_out)."""
    inner, c = w1.shape[0] // 2, w1.shape[1]
    pad = -inner % 64
    a, b = (F.pad(h, (0, 0, 0, pad)).view(-1, 64, c) for h in (w1[:inner], w1[inner:]))
    return torch.stack((a, b), dim=1).reshape(-1, c).t().contiguous(), w2.t().contiguous()


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
    check_operands(x, w1, b1, w2, b2, ln_scale, ln_bias, residual)
    return _GegluFF.apply(x, w1, b1, w2, b2, ln_scale, ln_bias, residual)


def check_operands(x, w1, b1, w2, b2, ln_scale, ln_bias, residual: bool) -> None:
    """Raises on operands the kernels do not take: f32 or bf16 x/w1/w2,
    C % 16 == 0, C_out % 8 == 0, inner % 32 == 0 (any width, in both
    dtypes), contiguous and on x's device, f32 biases and LN parameters."""
    if x.dtype not in _native.DTYPE_CODE or w1.dtype != x.dtype or w2.dtype != x.dtype:
        raise TypeError(f"geglu_ff: x/w1/w2 must be one of f32/bf16, got "
                        f"{x.dtype}/{w1.dtype}/{w2.dtype}")
    c = x.shape[-1]
    c_out, inner = w2.shape
    if w1.shape != (2 * inner, c) or b1.shape != (2 * inner,) or b2.shape != (c_out,):
        raise ValueError(f"geglu_ff: bad weight shapes w1{tuple(w1.shape)} b1{tuple(b1.shape)} "
                         f"w2{tuple(w2.shape)} b2{tuple(b2.shape)} for C={c}")
    if c % 16 or c_out % 8 or inner % 32:
        raise ValueError(f"geglu_ff: needs C % 16 == 0, C_out % 8 == 0, inner % 32 == 0; got "
                         f"C={c} C_out={c_out} inner={inner}")
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


def _launch_geglu(x, w1, b1, w2, b2, ln_scale, ln_bias, residual: bool) -> torch.Tensor:
    """One K3 call (its chunks of rows) on checked operands."""
    c = x.shape[-1]
    c_out, inner = w2.shape
    n = x.numel() // c
    out = torch.empty(x.shape[:-1] + (c_out,), dtype=x.dtype, device=x.device)
    lib, stream, code = _native.library(), _native.stream_of(x), _native.DTYPE_CODE[x.dtype]
    x, b1, b2, ln_scale, ln_bias = map(_native.aligned, (x, b1, b2, ln_scale, ln_bias))
    sms, elem = _native.sm_count(x.device), x.element_size()
    rows = chunk_size(n, inner, c_out, sms, elem)
    plan = chunk_plan(n, rows)
    g = torch.empty((rows, inner), dtype=x.dtype, device=x.device)
    if x.dtype == torch.float32:
        # the repack is fresh, so 16-byte aligned; the LN scratch is each
        # row's (mean, rstd)
        w1, w2 = f32_operands(w1, w2)
        cols, ln_shape = 0, (rows, 2)
    else:
        w1, w2 = map(_native.aligned, (w1, w2))
        cols, ln_shape = down_cols(c_out), (rows, c)
    ln_buf = None if ln_scale is None else torch.empty(ln_shape, dtype=x.dtype, device=x.device)
    for start, count in plan:
        rc = lib.st2v_geglu_ff(
            x.data_ptr() + start * c * elem, w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), None if ln_scale is None else ln_scale.data_ptr(),
            None if ln_scale is None else ln_bias.data_ptr(),
            out.data_ptr() + start * c_out * elem, g.data_ptr(),
            None if ln_buf is None else ln_buf.data_ptr(), count, c, inner, c_out, int(residual),
            code, cols, sms, stream)
        _native.check(rc, "geglu_ff")
    count_launch("geglu_ff")
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


geglu_ff.bwd_chunks = 0
