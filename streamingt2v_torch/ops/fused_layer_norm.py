"""K7: LayerNorm and RMSNorm over rows of C contiguous channels as one pass
of the hand-written CUDA kernel in ``csrc/layer_norm.cu``.

Replaces no Pallas kernel: the JAX package leaves LayerNorm to XLA
(``streamingt2v_tpu/ops/norms.py`` ``layer_norm``) and has no RMSNorm.  The
plain versions, ``layer_norm_reference`` and ``rms_norm_reference``, are
those functions step by step in f32: a chain of separate passes (the f32
copy, the means, the square, the variance, the subtraction, rsqrt, the
scale, the bias, the cast), each over the whole tensor.

What bounds it on the H100: bytes.  The kernel reads each element once and
writes it once, in the input's dtype (bf16 or f32); the statistics come from
the row held in registers.  ``launch_plan`` adapts the lanes a row takes to
C, so that 16-byte vectors cover a row with as few idle lanes as it can: up
to ``NARROW_CHANNELS`` in one warp, wider rows (Wan's 5120) over 2 to 8
warps of the block, up to ``MAX_CHANNELS``.  The RMS entry
(``fused_rms_norm``) is the same body without the mean and the bias.

No gradient: on the card an input that requires grad under grad mode
(``needs_grad``) raises; ``ops/norms`` sends such inputs to the plain
versions, which autograd differentiates.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from streamingt2v_torch.ops import _native
from streamingt2v_torch.ops.fused_group_norm import needs_grad
from streamingt2v_torch.utils.profiling import count_launch

# a row in one warp up to NARROW_CHANNELS, over 2 to 8 warps past it
NARROW_CHANNELS = 4096
MAX_CHANNELS = 8192
# the kernel's instances: 16-byte vectors a lane holds (csrc/layer_norm.cu),
# a row in one warp and (WIDE) a row over warps
VPT_INSTANCES = (1, 2, 3, 4, 5, 6, 8, 12, 16, 24, 32)
WIDE_VPT_INSTANCES = (4, 5, 6, 8)
BLOCK_THREADS = 256


def fits_fused_ln(c: int, dtype: torch.dtype) -> bool:
    """What K7 takes, in either entry: 16-byte rows (C % 8), C up to its
    widest plan, bf16 or f32."""
    return dtype in _native.DTYPE_CODE and 0 < c <= MAX_CHANNELS and c % 8 == 0


def layer_norm_reference(x: torch.Tensor, scale: Optional[torch.Tensor] = None,
                         bias: Optional[torch.Tensor] = None, *, eps: float = 1e-5
                         ) -> torch.Tensor:
    """Plain version in f32 over the last axis, the one-pass clamped
    statistics of the JAX package's ``layer_norm``, returned in x's dtype.
    Also the plain path of ``norms.layer_norm``, which autograd goes
    through."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf.square().mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0.0)
    out = (xf - mean) * torch.rsqrt(var + eps)
    if scale is not None:
        out = out * scale.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


def rms_norm_reference(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6
                       ) -> torch.Tensor:
    """Plain RMSNorm in f32 over the last axis (all of a token's channels:
    Wan's q/k norm across heads), times ``scale``, returned in x's dtype.
    Also the plain path of ``norms.rms_norm``, which autograd goes
    through."""
    xf = x.float()
    r = xf.square().mean(dim=-1, keepdim=True).add_(eps).rsqrt_()
    return (xf * r).mul_(scale.float()).to(x.dtype)


class LaunchPlan(NamedTuple):
    """Lane ``l`` of a row's ``lanes`` holds its 16-byte vectors l, l + lanes,
    ... (``vpt`` of them), and takes ``rows`` rows at once; past 32 lanes a
    row spans ``lanes // 32`` warps."""
    lanes: int
    vpt: int
    rows: int
    rows_per_block: int   # a block's rows: one block a group of them


@functools.lru_cache(maxsize=None)
def launch_plan(c: int, itemsize: int) -> LaunchPlan:
    """The lanes a row and vectors a lane that cover C's 16-byte vectors with
    the fewest idle slots, then the most lanes (the fewest registers): up to
    ``NARROW_CHANNELS`` within one warp, past it over 2, 4 or 8 warps."""
    vectors = c // (16 // itemsize)
    wide = c > NARROW_CHANNELS
    best = None
    for lanes in (256, 128, 64) if wide else (32, 16, 8, 4, 2, 1):
        need = -(-vectors // lanes)
        vpt = next((v for v in (WIDE_VPT_INSTANCES if wide else VPT_INSTANCES) if v >= need),
                   None)
        if vpt is not None and (best is None or lanes * vpt - vectors < best[0]):
            best = (lanes * vpt - vectors, lanes, vpt)
    _, lanes, vpt = best
    rows = -(-4 // vpt)    # at least 4 loads in flight a lane
    return LaunchPlan(lanes, vpt, rows, BLOCK_THREADS // lanes * rows)


def _check_param(what: str, name: str, t: Optional[torch.Tensor], x: torch.Tensor) -> int:
    if t is None:
        return 0
    c = x.shape[1]
    if t.dtype != torch.float32 or tuple(t.shape) != (c,) or t.device != x.device \
            or not t.is_contiguous() or t.data_ptr() % 16:
        raise TypeError(f"{what}: {name} must be contiguous, 16-byte aligned f32 ({c},) on "
                        f"x's device")
    return t.data_ptr()


def _check_rows(what: str, x: torch.Tensor, params: tuple) -> None:
    """What both entries refuse: x off the card, under grad, of another
    dtype, rank or C, or not contiguous and 16-byte aligned."""
    if not x.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor, got {x.device}")
    if needs_grad(x, *(t for t in params if t is not None)):
        raise RuntimeError(f"{what}: K7 has no backward; ops.norms takes the plain version "
                           f"under grad")
    if x.dtype not in _native.DTYPE_CODE:
        raise TypeError(f"{what}: f32 or bf16, got {x.dtype}")
    if x.ndim != 2:
        raise ValueError(f"{what}: expected (rows, C), got {tuple(x.shape)}")
    rows, c = x.shape
    if not fits_fused_ln(c, x.dtype) or rows >= 2**31:
        raise ValueError(f"{what}: rows={rows} C={c} not supported")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{what}: x must be contiguous and 16-byte aligned")


def _launch(what: str, entry: str, x: torch.Tensor, params: list, eps: float) -> torch.Tensor:
    """One launch of the C entry ``entry`` on x's rows, with the parameters'
    pointers (None for none) between x and the output; counted as
    ``launches.<entry>``."""
    out = torch.empty_like(x)
    rows, c = x.shape
    if rows == 0:
        return out
    plan = launch_plan(c, x.element_size())
    rc = getattr(_native.library(), "st2v_" + entry)(
        x.data_ptr(), *params, out.data_ptr(), rows, c, plan.lanes, plan.vpt, eps,
        _native.DTYPE_CODE[x.dtype], _native.stream_of(x))
    _native.check(rc, what)
    count_launch(entry, f32=x.dtype == torch.float32)
    return out


def fused_layer_norm(x: torch.Tensor, scale: Optional[torch.Tensor],
                     bias: Optional[torch.Tensor], eps: float) -> torch.Tensor:
    """x: (rows, C) on the card, bf16 or f32; scale, bias: f32 (C,) or None
    -> LayerNorm(x) * scale + bias in x's dtype, one launch of K7 (or
    raises)."""
    what = "fused_layer_norm"
    _check_rows(what, x, (scale, bias))
    params = [_check_param(what, "scale", scale, x) or None,
              _check_param(what, "bias", bias, x) or None]
    return _launch(what, "layer_norm", x, params, eps)


def fused_rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """x: (rows, C) on the card, bf16 or f32; scale: f32 (C,) -> x
    rsqrt(mean(x^2) + eps) * scale in x's dtype, one launch of K7's RMS
    entry (or raises)."""
    what = "fused_rms_norm"
    if scale is None:
        raise TypeError(f"{what}: scale is required")
    _check_rows(what, x, (scale,))
    return _launch(what, "rms_norm", x, [_check_param(what, "scale", scale, x)], eps)
