"""Ring (blockwise-KV) attention over the ``seq`` mesh axis (counterpart of
``streamingt2v_tpu/parallel/ring_attention.py``).

The sequence-parallel spatial self-attention: q, k and v stay split by
tokens over the seq ranks, and the k/v blocks travel around the ring
(n - 1 hops of ``batch_isend_irecv`` on the seq group, each started before
the current block's products so that the transfer overlaps them) while
each rank folds every arriving block into an online-softmax accumulator:
the exp2-domain math of the flash kernel, with an f32 running max, sum and
accumulator.  No rank holds the whole k/v.  The JAX ring computes its
blocks with ``dot_general``, not Pallas, so the blocks here are
``torch.matmul`` in f32 (p rounded to v's dtype first, as the JAX ring
casts it), and the ring has no kernel of its own.

It has no backward: training with seq > 1 is not supported (under grad it
raises).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from streamingt2v_torch.parallel.mesh import AXIS_SEQ, Mesh

_LOG2E = 1.4426950408889634


def ring_attention_available(mesh: Optional[Mesh], bh: int, lq: int, lk: int) -> bool:
    """The ring applies: a mesh with more than one seq rank and a
    self-attention geometry (each rank's q and k/v blocks of equal
    length)."""
    return mesh is not None and mesh.shape[AXIS_SEQ] > 1 and lq == lk and bh > 0


def ring_attention(qf: torch.Tensor, kf: torch.Tensor, vf: torch.Tensor, mesh: Mesh,
                   blocks: Optional[list] = None) -> torch.Tensor:
    """Self-attention over (B*H, L, D) whose L is split over the seq ranks:
    this rank's (B*H, L/n, D) query block against every rank's k/v block.
    ``blocks`` (a list, for tests and counts) receives each hop's source
    seq index."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (qf, kf, vf)):
        raise RuntimeError("ring_attention has no backward (training with seq > 1 is not "
                           "supported)")
    n = mesh.shape[AXIS_SEQ]
    group, line = mesh.group(AXIS_SEQ)
    me = mesh.axis_index(AXIS_SEQ)
    nxt, prv = line[(me + 1) % n], line[(me - 1) % n]
    state = ring_start(qf)
    k, v = kf.contiguous(), vf.contiguous()
    for j in range(n):
        pending = []
        if j < n - 1:
            k_next, v_next = torch.empty_like(k), torch.empty_like(v)
            pending = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, k, nxt, group), dist.P2POp(dist.irecv, k_next, prv, group),
                dist.P2POp(dist.isend, v, nxt, group), dist.P2POp(dist.irecv, v_next, prv, group)])
        if blocks is not None:
            blocks.append((me - j) % n)
        state = ring_fold(state, k, v)
        for work in pending:
            work.wait()
        if j < n - 1:
            k, v = k_next, v_next
    return ring_finish(state, qf.dtype)


def ring_start(qf: torch.Tensor) -> tuple:
    """(scaled q in the log2 domain, running max, running sum, accumulator)."""
    d = qf.shape[-1]
    qs = (qf.float() * (d ** -0.5 * _LOG2E)).to(qf.dtype).float()
    m = torch.full(qf.shape[:2], -torch.inf, dtype=torch.float32, device=qf.device)
    l = torch.zeros(qf.shape[:2], dtype=torch.float32, device=qf.device)
    return qs, m, l, torch.zeros(qf.shape, dtype=torch.float32, device=qf.device)


def ring_fold(state: tuple, k: torch.Tensor, v: torch.Tensor) -> tuple:
    """Fold one k/v block into the online softmax."""
    qs, m, l, acc = state
    s = torch.matmul(qs, k.float().transpose(-1, -2))          # (B*H, Lq, Lk), log2 domain
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp2(s - m_new[..., None])
    alpha = torch.exp2(m - m_new)
    l = l * alpha + p.sum(dim=-1)
    acc = acc * alpha[..., None] + torch.matmul(p.to(v.dtype).float(), v.float())
    return qs, m_new, l, acc


def ring_finish(state: tuple, dtype: torch.dtype) -> torch.Tensor:
    _, _, l, acc = state
    return (acc / l[..., None]).to(dtype)
