"""Attention dispatcher (counterpart of ``streamingt2v_tpu/ops/attention.py``).

One entry point for every attention geometry of the pipeline: spatial
self-attention (9216 tokens at the 72x128 latent), temporal attention (25
frames over a huge batch), CLIP-token cross-attention, CAM per-pixel
cross-attention (F x 7) and the single-head 512-dim VAE bottleneck.  The
large geometries go to flash attention when the tensors lie on a CUDA
device, exactly the geometries the JAX package sends to its Pallas kernel
on a TPU: K1 on head-folded copies, or K2 on the packed layout when the
routing in force (``ops/routing.py``) has ``flash_packed``; small ones take
plain matrix products with an f32 softmax.

Under an active mesh (``parallel/sharding.py``): a self-attention over
tokens split by the seq axis goes around the ring (``_maybe_ring``), or,
with the routing's ``ring_attention`` off, against k/v gathered over seq;
a flash geometry whose rows are whole on several ranks splits its
batch*heads rows over them (``_flash_sharded``), each rank running K1 on
its slice.
"""

from __future__ import annotations

from typing import Optional

import torch

from streamingt2v_torch.ops.flash_attention import (
    flash_attention, flash_attention_packed, packed_applicable)
from streamingt2v_torch.ops.routing import current_routing
from streamingt2v_torch.parallel.mesh import AXIS_SEQ
from streamingt2v_torch.parallel.sharding import (
    copy_to, current_scope, gather_dim, is_split)

# Below this many score elements per (batch*head) the plain path is used.
_FLASH_MIN_SCORE_ELEMS = 2048 * 2048
# ... unless the total f32 scores of a rectangular geometry exceed this.
_FLASH_MIN_SCORE_BYTES = 256 * 1024 * 1024
# Tiny-L attention (temporal T=25, CAM 25x7) packs rows block-diagonally.
_GROUP_MAX_LEN = 64
NEG_INF_MASK = -1e30


def _use_flash(bh: int, lq: int, lk: int, device: torch.device) -> bool:
    if device.type != "cuda":
        return False
    if lq * lk >= _FLASH_MIN_SCORE_ELEMS:
        return True
    return lq >= 4096 and bh * lq * lk * 4 >= _FLASH_MIN_SCORE_BYTES


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain attention. q: (..., Lq, D), k/v: (..., Lk, D); ``bias`` is added
    to the f32 scores (the CLIP text tower's causal mask)."""
    scale = q.shape[-1] ** -0.5
    s = torch.matmul(q, (k.to(v.dtype) * scale).transpose(-1, -2)).float()
    if bias is not None:
        s = s + bias
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(v.dtype), v)


def _grouped_tiny_attention(qf: torch.Tensor, kf: torch.Tensor, vf: torch.Tensor) -> torch.Tensor:
    """Exact attention for (B, Lq, D) with tiny Lq/Lk: G = 128 // max(L)
    rows are packed into one product with a block-diagonal mask
    (exp(-inf) = 0 drops every cross-member term)."""
    b, lq, d = qf.shape
    lk = kf.shape[1]
    g = max(1, 128 // max(lq, lk))
    pad = (-b) % g
    if pad:
        widths = (0, 0, 0, 0, 0, pad)
        qf, kf, vf = (torch.nn.functional.pad(t, widths) for t in (qf, kf, vf))
    n = qf.shape[0] // g
    qg = qf.reshape(n, g * lq, d)
    kg = kf.reshape(n, g * lk, d)
    vg = vf.reshape(n, g * lk, d)
    qi = torch.arange(g * lq, device=qf.device) // lq
    kj = torch.arange(g * lk, device=qf.device) // lk
    mask = torch.where(qi[:, None] == kj[None, :], 0.0, NEG_INF_MASK)
    s = torch.matmul(qg, (kg.to(vg.dtype) * d ** -0.5).transpose(-1, -2)).float()
    p = torch.softmax(s + mask, dim=-1)
    o = torch.matmul(p.to(vg.dtype), vg).reshape(n * g, lq, d)
    return o[:b] if pad else o


def _maybe_ring(qf: torch.Tensor, kf: torch.Tensor, vf: torch.Tensor, mesh) -> Optional[torch.Tensor]:
    """Ring attention over the seq ranks, or None where it does not apply
    (no mesh, or the routing's ``ring_attention`` off: the JAX package's
    ``STREAMINGT2V_RING_ATTN=0``)."""
    from streamingt2v_torch.parallel.ring_attention import (
        ring_attention, ring_attention_available)

    if mesh is None or not current_routing().ring_attention:
        return None
    if not ring_attention_available(mesh, qf.shape[0], qf.shape[1], kf.shape[1]):
        return None
    return ring_attention(qf, kf, vf, mesh)


def _seq_split_attention(qf: torch.Tensor, kf: torch.Tensor, vf: torch.Tensor, mesh) -> torch.Tensor:
    """Self-attention of this rank's token block against every rank's: the
    ring, else k/v gathered over seq (each rank's queries whole against the
    gathered keys).  Forward only, as the ring is: each rank's gathered k/v
    would take a gradient from its own queries alone."""
    o = _maybe_ring(qf, kf, vf, mesh)
    if o is not None:
        return o
    if torch.is_grad_enabled() and any(t.requires_grad for t in (qf, kf, vf)):
        raise RuntimeError("attention over tokens split by seq has no backward (training "
                           "with seq > 1 is not supported)")
    kf, vf = gather_dim(kf, mesh, AXIS_SEQ, 1), gather_dim(vf, mesh, AXIS_SEQ, 1)
    return attention_pre_split(qf, kf, vf)


def _flash_rows(qf: torch.Tensor, kf: torch.Tensor, vf: torch.Tensor, n: int, i: int
                ) -> torch.Tensor:
    """Rank i of n's part of ``_flash_sharded``: the (B*H) rows zero-padded
    to a multiple of n, its block of them through flash attention."""
    pad = (-qf.shape[0]) % n
    if pad:
        widths = (0, 0, 0, 0, 0, pad)
        qf, kf, vf = (torch.nn.functional.pad(t, widths) for t in (qf, kf, vf))
    per = qf.shape[0] // n
    return flash_attention(*(t[i * per:(i + 1) * per].contiguous() for t in (qf, kf, vf)))


def _flash_sharded(qf: torch.Tensor, kf: torch.Tensor, vf: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Flash attention over (B*H, L, D) rows that are whole on every rank of
    the mesh ``axes``: each rank runs K1 on its slice of the rows
    (``_flash_rows``) and the slices are gathered back (attention is
    independent per row).  Each rank's q/k/v gradient covers its own rows
    only: ``copy_to`` sums them over ``axes``."""
    b = qf.shape[0]
    qf, kf, vf = (copy_to(t, mesh, axes) for t in (qf, kf, vf))
    o = _flash_rows(qf, kf, vf, mesh.axis_size(axes), mesh.axis_index(axes))
    return gather_dim(o, mesh, axes, 0)[:b]


def attention_pre_split(qf: torch.Tensor, kf: torch.Tensor, vf: torch.Tensor) -> torch.Tensor:
    """Attention on head-folded (B*H, L, D) tensors; returns the same layout.
    Flash on its geometries (its rows split over the ranks that hold the
    same rows, where an active mesh has them), else the plain paths."""
    bh, lq, _ = qf.shape
    lk = kf.shape[1]
    if _use_flash(bh, lq, lk, qf.device):
        scope = current_scope()
        axes = scope.replicated() if scope is not None else ()
        if axes:
            return _flash_sharded(qf, kf, vf, scope.mesh, axes)
        return flash_attention(qf.contiguous(), kf.contiguous(), vf.contiguous())
    if lq <= _GROUP_MAX_LEN and lk <= _GROUP_MAX_LEN and bh >= 256:
        return _grouped_tiny_attention(qf, kf, vf)
    return dot_product_attention(qf, kf, vf)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              num_heads: int = 1, over_tokens: bool = False) -> torch.Tensor:
    """Multi-head attention over flat (B, L, H*D) tensors.  ``over_tokens``
    marks a self-attention over the token axis: where the active mesh has
    split the tokens over seq, it attends across the ranks."""
    b, lq, hd = q.shape
    lk = k.shape[1]
    d = hd // num_heads
    if num_heads * d != hd:
        raise ValueError(f"{hd} channels do not split into {num_heads} heads")
    bh = b * num_heads
    seq_split = over_tokens and is_split(AXIS_SEQ)
    scope = current_scope()
    if (_use_flash(bh, lq, lk, q.device) and current_routing().flash_packed
            and packed_applicable(num_heads, d) and not seq_split
            and (scope is None or not scope.replicated())):
        return flash_attention_packed(q.contiguous(), k.contiguous(), v.contiguous(),
                                      num_heads=num_heads)
    qh = q.reshape(b, lq, num_heads, d).transpose(1, 2)
    kh = k.reshape(b, lk, num_heads, d).transpose(1, 2)
    vh = v.reshape(b, lk, num_heads, d).transpose(1, 2)
    if seq_split:
        o = _seq_split_attention(qh.reshape(bh, lq, d), kh.reshape(bh, lk, d),
                                 vh.reshape(bh, lk, d), scope.mesh).reshape(b, num_heads, lq, d)
    elif _use_flash(bh, lq, lk, q.device):
        o = attention_pre_split(qh.reshape(bh, lq, d), kh.reshape(bh, lk, d),
                                vh.reshape(bh, lk, d)).reshape(b, num_heads, lq, d)
    elif lq <= _GROUP_MAX_LEN and lk <= _GROUP_MAX_LEN and bh >= 256:
        o = _grouped_tiny_attention(qh.reshape(bh, lq, d), kh.reshape(bh, lk, d),
                                    vh.reshape(bh, lk, d)).reshape(b, num_heads, lq, d)
    else:
        o = dot_product_attention(qh, kh, vh)
    return o.transpose(1, 2).reshape(b, lq, hd)
