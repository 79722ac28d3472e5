"""K7: LayerNorm over rows of C contiguous channels as one pass of the
hand-written CUDA kernel in ``csrc/layer_norm.cu``.

Replaces no Pallas kernel: the JAX package leaves LayerNorm to XLA
(``streamingt2v_tpu/ops/norms.py`` ``layer_norm``).  Its plain version,
``layer_norm_reference``, is that function step by step in f32: a chain of
separate passes (the f32 copy, two means, the square, the variance, the
subtraction, rsqrt, the scale, the bias, the cast), each over the whole
tensor.

What bounds it on the H100: bytes.  The kernel reads each element once and
writes it once, in the input's dtype (bf16 or f32); the statistics come from
the row held in registers.  ``launch_plan`` adapts the lanes a row takes to
C, so that 16-byte vectors cover a row with as few idle lanes as it can.

No gradient: on the card an input that requires grad under grad mode
(``needs_grad``) raises; ``ops/norms.layer_norm`` sends such inputs to the
plain version, which autograd differentiates.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from streamingt2v_torch.ops import _native
from streamingt2v_torch.ops.fused_group_norm import needs_grad
from streamingt2v_torch.utils.profiling import count_launch

MAX_CHANNELS = 4096
# the kernel's instances: 16-byte vectors a lane holds (csrc/layer_norm.cu)
VPT_INSTANCES = (1, 2, 3, 4, 5, 6, 8, 12, 16, 24, 32)
BLOCK_THREADS = 256


def fits_fused_ln(c: int, dtype: torch.dtype) -> bool:
    """What K7 takes: 16-byte rows (C % 8), C up to its widest instance, bf16
    or f32."""
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


class LaunchPlan(NamedTuple):
    """Lane ``l`` of a row's ``lanes`` holds its 16-byte vectors l, l + lanes,
    ... (``vpt`` of them), and takes ``rows`` rows at once."""
    lanes: int
    vpt: int
    rows: int
    rows_per_block: int   # a block's rows: one block a group of them


@functools.lru_cache(maxsize=None)
def launch_plan(c: int, itemsize: int) -> LaunchPlan:
    """The lanes a row and vectors a lane that cover C's 16-byte vectors with
    the fewest idle slots, then the most lanes (the fewest registers)."""
    vectors = c // (16 // itemsize)
    best = None
    for lanes in (32, 16, 8, 4, 2, 1):
        need = -(-vectors // lanes)
        vpt = next((v for v in VPT_INSTANCES if v >= need), None)
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


def fused_layer_norm(x: torch.Tensor, scale: Optional[torch.Tensor],
                     bias: Optional[torch.Tensor], eps: float) -> torch.Tensor:
    """x: (rows, C) on the card, bf16 or f32; scale, bias: f32 (C,) or None
    -> LayerNorm(x) * scale + bias in x's dtype, one launch of K7 (or
    raises)."""
    what = "fused_layer_norm"
    if not x.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor, got {x.device}")
    if needs_grad(x, *(t for t in (scale, bias) if t is not None)):
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
    pscale = _check_param(what, "scale", scale, x)
    pbias = _check_param(what, "bias", bias, x)
    out = torch.empty_like(x)
    if rows == 0:
        return out
    plan = launch_plan(c, x.element_size())
    rc = _native.library().st2v_layer_norm(
        x.data_ptr(), pscale or None, pbias or None, out.data_ptr(), rows, c, plan.lanes,
        plan.vpt, eps, _native.DTYPE_CODE[x.dtype], _native.stream_of(x))
    _native.check(rc, what)
    count_launch("layer_norm", f32=x.dtype == torch.float32)
    return out
