"""K1: flash attention over head-folded (B*H, L, D) tensors.

Replaces the Pallas kernel ``_flash_kernel`` (``streamingt2v_tpu/ops/
flash_attention.py:38``, launched from ``_flash_pallas:387``) with the
hand-written CUDA kernel in ``csrc/flash_attention.cu``.

What bounds it on the H100: at D=64 the UNet's 9216-token self-attention
does 4*L^2*D flops over 4*L*D*2 bytes per head, so it is tensor-core
bound; the (Lq, Lk) scores are what would otherwise cost memory (85 GB in
f32 at the level-0 geometry).  The kernel keeps a q-tile's scores, running
max, denominator and f32 output accumulator on chip and walks the KV tiles
inside the block, so the scores never reach device memory.  It masks the
ragged KV edge directly, so the TPU's zero-pad denominator correction is
not needed.  bf16 runs on the tensor cores (mma.sync, f32 accumulation);
f32 runs the same tiles on the FMA units in full f32 (no TF32).  D=512 (the
VAE mid-block attention) uses 16-row q tiles so its accumulator fits in
registers.  This first version is synchronous (no cp.async/TMA pipeline).
"""

from __future__ import annotations

import math

import torch

from streamingt2v_torch.ops import _native

_HEAD_DIMS = (64, 512)


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain version: softmax(q k^T / sqrt(d)) v with f32 scores."""
    scale = q.shape[-1] ** -0.5
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v.float()).to(v.dtype)


def _kernel_head_dim(d: int) -> int:
    """Head dims up to 64 run zero-padded to 64; 512 runs as is."""
    kd = 64 if d <= 64 else d
    if kd not in _HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} is not supported (<= 64 or 512)")
    return kd


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Softmax attention over (B*H, L, D).  CPU tensors take the plain
    version; CUDA tensors launch K1 (or raise)."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v)
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"flash_attention: tensors must share one CUDA device, got {q.device}")
    if q.dtype not in _native.DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: f32 or bf16 of one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.ndim != 3 or k.shape != v.shape or k.ndim != 3 or k.shape[0] != q.shape[0] \
            or k.shape[2] != q.shape[2]:
        raise ValueError(f"flash_attention: bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k and v must be contiguous")
    bh, lq, d = q.shape
    lk = k.shape[1]
    if not 0 < bh <= 65535:
        raise ValueError(f"flash_attention: batch*heads {bh} outside (0, 65535]")
    kd = _kernel_head_dim(d)
    if kd != d:
        pad = (0, kd - d)
        q, k, v = (torch.nn.functional.pad(t, pad) for t in (q, k, v))
    out = torch.empty_like(q)
    rc = _native.library().st2v_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, lq, lk, kd,
        _native.DTYPE_CODE[q.dtype], d ** -0.5 * math.log2(math.e), _native.stream_of(q))
    _native.check(rc, "flash_attention")
    flash_attention.launches += 1
    return out[..., :d] if kd != d else out


flash_attention.launches = 0
