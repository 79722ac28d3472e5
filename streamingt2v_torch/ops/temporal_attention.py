"""K6: per-pixel attention over the frame axis on the spatial-major layout.

Replaces the Pallas kernel ``_kernel`` (``streamingt2v_tpu/ops/
temporal_attention.py:43``, launched from ``_temporal_attention_pallas:94``)
with the hand-written CUDA kernel in ``csrc/temporal_attention.cu``.

The temporal transformers keep their activations spatial-major, (B*T, S, H*D);
attention over frames needs, per (pixel, head), the T rows that sit S*H*D
apart.  The plain version (the JAX package's fallback) folds q, k, v to
(B*S*H, T, D), attends, and folds o back: four full copies.  The kernel
reads each (pixel, head)'s frames where they lie, keeps the T x T scores on
chip and writes o in place.

What bounds it on the H100: bytes.  At the stage-2 level-0 geometry (38
frames, 14400 pixels, 5 heads of 64) it moves q, k, v and o once each, about
1.4 GB in bf16, for about 27 GFLOP: about 20 flops per byte.  The bf16
head-dim-64 body (every head of the main path) therefore keeps HBM busy: it
copies groups of four pairs' frames as bf16 by 16-byte ``cp.async`` into one
of two buffers while the other group's products run on the tensor cores
(``mma.sync``; scores and probabilities in registers), and writes o in
16-byte stores.  f32 at every head dim and bf16 at the other head dims run
the FMA body: one pair a group, copied by ``cp.async`` into one of two
buffers while the other pair computes, its query rows split over four
warps, S and P V in full f32 from register microtiles, the grid
persistent.

No gradient: the JAX package defines no VJP for its kernel (``jax.grad``
through it fails to linearise the pallas_call), so on the card an input
that requires grad under grad mode raises rather than return an output that
autograd cannot see through.
"""

from __future__ import annotations

import math

import torch

from streamingt2v_torch.ops import _native
from streamingt2v_torch.ops.attention import attention_pre_split
from streamingt2v_torch.ops.routing import current_routing
from streamingt2v_torch.utils.profiling import count_launch

MAX_FRAMES = 64
MAX_HEAD_DIM = 128


def fits_temporal_attention(frames_q: int, frames_kv: int, head_dim: int) -> bool:
    """The JAX package's gate without ``interpret``: T <= 64, d <= 128."""
    return 0 < max(frames_q, frames_kv) <= MAX_FRAMES and 0 < head_dim <= MAX_HEAD_DIM


def _time_major(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, batch: int,
                frames_q: int, frames_kv: int, num_heads: int) -> tuple:
    """(B*T, S, H*D) q, k, v -> (B*S*H, T, D), one copy each."""
    s, d = q.shape[1], q.shape[2] // num_heads
    return tuple(z.reshape(batch, t, s, num_heads, d).permute(0, 2, 3, 1, 4).reshape(-1, t, d)
                 for z, t in ((q, frames_q), (k, frames_kv), (v, frames_kv)))


def _spatial_major(o: torch.Tensor, batch: int, num_heads: int) -> torch.Tensor:
    """(B*S*H, T, D) -> (B*T, S, H*D), one copy."""
    bsh, t, d = o.shape
    s = bsh // (batch * num_heads)
    return o.reshape(batch, s, num_heads, t, d).permute(0, 3, 1, 2, 4).reshape(
        batch * t, s, num_heads * d)


def temporal_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                                 batch: int, frames_q: int, frames_kv: int,
                                 num_heads: int) -> torch.Tensor:
    """Plain version (the JAX package's fallback): fold each operand to
    (B*S*H, T, D) in one copy, attend (``attention_pre_split``), fold the
    output back in one copy."""
    q, k, v = _time_major(q, k, v, batch, frames_q, frames_kv, num_heads)
    return _spatial_major(attention_pre_split(q, k, v), batch, num_heads)


def fused_temporal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                             batch: int, frames_q: int, frames_kv: int,
                             num_heads: int) -> torch.Tensor:
    """q: (batch*frames_q, S, H*D); k, v: (batch*frames_kv, S, H*D) -> like q.
    CPU tensors take the plain version; CUDA tensors launch K6 (or raise)."""
    kw = dict(batch=batch, frames_q=frames_q, frames_kv=frames_kv, num_heads=num_heads)
    if q.device.type == "cpu":
        return temporal_attention_reference(q, k, v, **kw)
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"temporal_attention: tensors must share one CUDA device, got "
                         f"{q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("temporal_attention: K6 has no backward (the JAX package defines "
                           "no VJP for it); train with the temporal_attention routing off")
    if q.dtype not in _native.DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"temporal_attention: f32 or bf16 of one dtype, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if q.ndim != 3:
        raise ValueError(f"temporal_attention: expected (B*T, S, H*D), got {tuple(q.shape)}")
    bt, s, hd = q.shape
    d = hd // num_heads
    if (num_heads * d != hd or bt != batch * frames_q
            or tuple(k.shape) != (batch * frames_kv, s, hd) or k.shape != v.shape):
        raise ValueError(f"temporal_attention: bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} for batch {batch}, frames {frames_q}/{frames_kv}, "
                         f"{num_heads} heads")
    if not fits_temporal_attention(frames_q, frames_kv, d) or not 0 < batch <= 65535:
        raise ValueError(f"temporal_attention: frames {frames_q}/{frames_kv} head dim {d} "
                         f"batch {batch} not supported (T <= {MAX_FRAMES}, "
                         f"d <= {MAX_HEAD_DIM})")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("temporal_attention: q, k and v must be contiguous")
    q, k, v = map(_native.aligned, (q, k, v))
    out = torch.empty_like(q)
    rc = _native.library().st2v_temporal_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), batch, frames_q, frames_kv,
        s * num_heads, d, _native.DTYPE_CODE[q.dtype], d ** -0.5 * math.log2(math.e),
        _native.stream_of(q))
    _native.check(rc, "temporal_attention")
    count_launch("fused_temporal_attention", f32=q.dtype == torch.float32)
    return out


def temporal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, batch: int,
                       frames_q: int, frames_kv: int, num_heads: int) -> torch.Tensor:
    """Per-pixel attention over the frame axis, spatial-major layout
    (``streamingt2v_tpu/ops/temporal_attention.py:135``): equivalent to
    rearranging (b t) s c -> (b s) t c, attending, and rearranging back.
    Under the ``temporal_attention`` routing, geometries inside the kernel's
    gate go to K6; the rest to the plain version."""
    kw = dict(batch=batch, frames_q=frames_q, frames_kv=frames_kv, num_heads=num_heads)
    d = q.shape[-1] // num_heads
    if (current_routing().temporal_attention and num_heads * d == q.shape[-1]
            and fits_temporal_attention(frames_q, frames_kv, d)):
        return fused_temporal_attention(q, k, v, **kw)
    # the plain version, written out rather than called: rebinding q, k, v
    # here frees the spatial-major operands that a caller passes as
    # temporaries (the temporal transformers do) before the attention takes
    # its workspace
    q, k, v = _time_major(q, k, v, batch, frames_q, frames_kv, num_heads)
    return _spatial_major(attention_pre_split(q, k, v), batch, num_heads)
