"""K4: (kt,1,1) temporal convolution over (B, T, S, C) activations.

Replaces the Pallas kernel ``_conv_body`` and its four variants
``_kernel``, ``_kernel_res``, ``_kernel_pre``, ``_kernel_pre_res``
(``streamingt2v_tpu/ops/temporal_conv.py:29-96``, launched from
``_tc_pallas:197``) with the hand-written CUDA kernel in
``csrc/temporal_conv.cu``:

    xin = silu(x * pre_a[b] + pre_b[b])          optional GN+SiLU prologue
    y[t] = sum_k xin[t + k - kt//2] W[k] + bias   zero SAME padding on T
    out  = res + res_w[b, t] * y                  optional epilogue

What bounds it on the H100: at the VAE decoder's 128-channel,
589824-position levels it moves x and out once each and is bandwidth
bound; at the UNet's 320-1280-channel levels it is a kt-tap matrix product
on the tensor cores.  The bf16 kernel treats it as the implicit GEMM it is
(rows (b, t, s), columns C_out, contraction kt x C): a persistent kernel
whose tile is one output frame's 128 positions by 320, 128 or 64 output
channels (``conv_tile_cols``), the contraction running over the taps that
exist and C on ``wgmma`` from a ``cp.async`` ring in the 128-byte swizzle.
It reads W tap-major with each output channel's row K-major, (kt, C_out,
C8) (``kernel_operands``), applies the GroupNorm+SiLU prologue in shared
memory (the normalised activation never reaches device memory) and the
bias and epilogue before each tile's one store, and takes C in multiples
of 8: the wrapper zero-pads x's channels.  The f32 kernel (the stage-1
temporal VAE decoder under the reference's f32 decode, bound by the FP32
rate at every width) is the same implicit GEMM on the FMA units in full
f32: tiles of 128 positions by 128 output
channels, 8 x 8 register microtiles fed by 128-bit shared loads, x staged
through registers with the prologue applied there, W by ``cp.async``, two
buffers; it takes C in multiples of 4 and W as (kt, C4, C_out4)
(``f32_operands``).

Gradients: on the card ``temporal_conv`` is a ``torch.autograd.Function``
whose forward launches K4 and saves the caller's operands (not the padded
copies the kernel reads), and whose backward is the VJP of
``temporal_conv_reference`` over the live operands, ``None`` for the absent
ones (the JAX package's ``_tc_core_bwd``, ``:159``), in chunks of positions
that keep one chunk's f32 intermediates within ``BWD_CHUNK_BYTES``
(``temporal_conv_backward``); ``temporal_conv.bwd_chunks`` counts them.
"""

from __future__ import annotations

from typing import Optional

import torch

from streamingt2v_torch.ops import _native
from streamingt2v_torch.ops._backward import BWD_CHUNK_BYTES, chunked_vjp
from streamingt2v_torch.utils.profiling import count_launch

# CUDA's grid limit on the batch rows the C entry takes
_MAX_GRID = 65535
# the JAX package's VMEM budget in its gate (streamingt2v_tpu/ops/temporal_conv.py)
_JAX_VMEM_BUDGET = 10 * 1024 * 1024


def conv_tile_cols(c_out: int) -> int:
    """The bf16 kernel's output channels a tile: all 320 of a UNet level's
    block (or 320 of 640 and 1280) as one 256 + 64 product, so each x tile
    staged feeds every output channel and the W taps are 40 of a stage's
    56 KB; 128 at the VAE's 128 channels; 64 elsewhere."""
    return 320 if c_out % 320 == 0 else 128 if c_out % 128 == 0 else 64


def _kernel_takes(kt: int, s: int, batch: int) -> bool:
    """Centred odd taps up to 5, any S and T, and at most 65535 batch rows
    (the C entry's bound); both bodies count their tiles in a 1-D grid or a
    persistent loop."""
    return kt % 2 == 1 and kt <= 5 and s > 0 and 0 < batch <= _MAX_GRID


def fits_temporal_conv(t: int, c: int, c_out: int, kt: int, *, s: int = 1,
                       batch: int = 1) -> bool:
    """The JAX package's gate (``fits_temporal_conv:276``: its VMEM budget,
    which bounds T) and what the kernel takes."""
    dsize = 2
    jax_fits = (2 * t * 8 * c + kt * c * 128 * 2) * dsize + 4 * t * 8 * 128 <= _JAX_VMEM_BUDGET
    return t > 0 and jax_fits and _kernel_takes(kt, s, batch)


def temporal_conv_reference(x, w, b, res=None, res_w=None, pre_a=None, pre_b=None):
    """Plain version in f32 (the JAX package's ``_tc_reference``)."""
    kt = w.shape[0]
    lo = kt // 2
    t = x.shape[1]
    h = x.float()
    if pre_a is not None:
        h = torch.nn.functional.silu(h * pre_a[:, None, None, :] + pre_b[:, None, None, :])
    hp = torch.nn.functional.pad(h, (0, 0, 0, 0, lo, kt - 1 - lo))
    out = sum(torch.matmul(hp[:, k:k + t], w[k].float()) for k in range(kt)) + b.float()
    if res is not None:
        out = res.float() + res_w[:, :, None, None].float() * out
    return out.to(x.dtype)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _pad_channels(x, pre_a, pre_b, pc: int):
    """x's channels (and pre_a, pre_b) zero-padded by pc.  The padded channels
    add nothing to the product: zero weights, and a zero prologue affine
    gives silu(0) = 0."""
    if pc:
        x = torch.nn.functional.pad(x, (0, pc))
        if pre_a is not None:
            pre_a, pre_b = (torch.nn.functional.pad(p, (0, pc)) for p in (pre_a, pre_b))
    return x, pre_a, pre_b


def kernel_operands(x, w, pre_a=None, pre_b=None):
    """The bf16 kernel's layout: x's channels (and pre_a, pre_b) zero-padded to
    a multiple of 8, and w (kt, C, C_out) repacked tap-major and K-major as
    (kt, C_out, C8): output channel o's row of tap k is W[k, :, o], its
    channels contiguous and zero past C (wgmma's B operand, one 16-byte copy
    per 8 channels).  C_out is not padded: the kernel zero-fills the rows
    past it."""
    pc = _round_up(w.shape[1], 8) - w.shape[1]
    x, pre_a, pre_b = _pad_channels(x, pre_a, pre_b, pc)
    wk = torch.nn.functional.pad(w, (0, 0, 0, pc)) if pc else w
    return x, wk.transpose(1, 2).contiguous(), pre_a, pre_b


def f32_operands(x, w, pre_a=None, pre_b=None):
    """The f32 kernel's layout: x's channels (and pre_a, pre_b) zero-padded to
    a multiple of 4 (its 128-bit loads), and w (kt, C, C_out) zero-padded to
    (kt, C4, C_out4), output channels contiguous (its B rows, copied 16
    bytes at a time).  The kernel stores only the C_out true channels."""
    kt, c, c_out = w.shape
    pc, po = _round_up(c, 4) - c, _round_up(c_out, 4) - c_out
    x, pre_a, pre_b = _pad_channels(x, pre_a, pre_b, pc)
    if pc or po:
        w = torch.nn.functional.pad(w, (0, po, 0, pc))
    return x, w, pre_a, pre_b


def temporal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  res: Optional[torch.Tensor] = None, res_w: Optional[torch.Tensor] = None,
                  pre_a: Optional[torch.Tensor] = None,
                  pre_b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (B, T, S, C); w: (kt, C, C_out); b: (C_out,) f32 -> (B, T, S, C_out).

    ``pre_a``/``pre_b`` ((B, C) f32) fuse ``silu(x * a + b)`` into the input
    read; ``res`` ((B, T, S, C_out)) with ``res_w`` ((B, T) f32) fuses
    ``res + res_w * conv`` into the store.  CPU tensors take the plain
    version; CUDA tensors launch K4 (or raise), differentiable through
    ``temporal_conv_backward``."""
    if x.device.type == "cpu":
        return temporal_conv_reference(x, w, b, res, res_w, pre_a, pre_b)
    if not x.is_cuda:
        raise ValueError(f"temporal_conv: expected a CUDA tensor, got {x.device}")
    if x.dtype not in _native.DTYPE_CODE or w.dtype != x.dtype:
        raise TypeError(f"temporal_conv: x and w must be one of f32/bf16, got {x.dtype}/{w.dtype}")
    if x.ndim != 4 or w.ndim != 3 or w.shape[1] != x.shape[3]:
        raise ValueError(f"temporal_conv: bad shapes x{tuple(x.shape)} w{tuple(w.shape)}")
    bsz, t, s, c = x.shape
    kt, _, c_out = w.shape
    if not _kernel_takes(kt, s, bsz):
        raise ValueError(f"temporal_conv: geometry B={bsz} T={t} S={s} kt={kt} not supported")
    if (pre_a is None) != (pre_b is None) or (res is None) != (res_w is None):
        raise ValueError("temporal_conv: pre_a/pre_b and res/res_w come in pairs")
    f32 = [(b, (c_out,))]
    if pre_a is not None:
        f32 += [(pre_a, (bsz, c)), (pre_b, (bsz, c))]
    if res is not None:
        f32.append((res_w, (bsz, t)))
        if res.shape != (bsz, t, s, c_out) or res.dtype != x.dtype:
            raise ValueError(f"temporal_conv: res must be {(bsz, t, s, c_out)} {x.dtype}")
    for tensor, shape in f32:
        if tensor.dtype != torch.float32 or tuple(tensor.shape) != shape:
            raise TypeError(f"temporal_conv: expected f32 {shape}, got {tensor.dtype} "
                            f"{tuple(tensor.shape)}")
    operands = [x, w] + [tensor for tensor, _ in f32] + ([] if res is None else [res])
    if any(o.device != x.device or not o.is_contiguous() for o in operands):
        raise ValueError("temporal_conv: operands must be contiguous on one device")
    return _TemporalConv.apply(x, w, b, res, res_w, pre_a, pre_b)


def _launch_temporal_conv(x, w, b, res, res_w, pre_a, pre_b) -> torch.Tensor:
    """One K4 launch on checked operands."""
    bsz, t, s, c = x.shape
    kt, _, c_out = w.shape
    cols = sms = 0
    if x.dtype == torch.bfloat16:
        x, w, pre_a, pre_b = kernel_operands(x, w, pre_a, pre_b)
        cols, sms = conv_tile_cols(c_out), _native.sm_count(x.device)
    else:
        x, w, pre_a, pre_b = f32_operands(x, w, pre_a, pre_b)
    c = x.shape[3]
    x, w, res, pre_a, pre_b = map(_native.aligned, (x, w, res, pre_a, pre_b))
    out = torch.empty((bsz, t, s, c_out), dtype=x.dtype, device=x.device)
    rc = _native.library().st2v_temporal_conv(
        x.data_ptr(), w.data_ptr(), b.data_ptr(),
        None if pre_a is None else pre_a.data_ptr(),
        None if pre_b is None else pre_b.data_ptr(),
        None if res is None else res.data_ptr(),
        None if res_w is None else res_w.data_ptr(),
        out.data_ptr(), bsz, t, s, c, c_out, kt, _native.DTYPE_CODE[x.dtype], cols, sms,
        _native.stream_of(x))
    _native.check(rc, "temporal_conv")
    count_launch("temporal_conv", f32=x.dtype == torch.float32)
    return out


def backward_chunk_positions(b: int, t: int, c: int, c_out: int) -> int:
    """Positions per backward chunk: autograd through the plain version
    keeps about 8 (C + C_out) f32 values a (row, frame, position) (x, the
    prologue's steps, the padded input, the taps' sums, the output and
    their gradients); as many positions as fit ``BWD_CHUNK_BYTES``, at least
    one."""
    return max(1, BWD_CHUNK_BYTES // (4 * b * t * 8 * (c + c_out)))


def temporal_conv_backward(x, w, b, res, res_w, pre_a, pre_b, g: torch.Tensor,
                           chunk: Optional[int] = None) -> tuple:
    """The VJP of ``temporal_conv_reference`` at the operands for the
    cotangent g (B, T, S, C_out), in chunks of ``chunk`` positions
    (``backward_chunk_positions`` unless given).  Returns ((dx, dw, db, dres,
    dres_w, dpre_a, dpre_b), chunks run): each in its operand's dtype,
    ``None`` for an absent one."""
    bsz, t, _, c = x.shape
    rows = chunk or backward_chunk_positions(bsz, t, c, w.shape[2])
    return chunked_vjp(temporal_conv_reference, (x, w, b, res, res_w, pre_a, pre_b), (0, 3),
                       g, 2, rows)


class _TemporalConv(torch.autograd.Function):
    """K4 forward, the plain version's VJP backward."""

    @staticmethod
    def forward(ctx, x, w, b, res, res_w, pre_a, pre_b):
        ctx.save_for_backward(x, w, b, res, res_w, pre_a, pre_b)
        return _launch_temporal_conv(x, w, b, res, res_w, pre_a, pre_b)

    @staticmethod
    def backward(ctx, g):
        grads, chunks = temporal_conv_backward(*ctx.saved_tensors, g)
        temporal_conv.bwd_chunks += chunks
        return grads


temporal_conv.bwd_chunks = 0
