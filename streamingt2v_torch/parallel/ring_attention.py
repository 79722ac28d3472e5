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

The JAX package differentiates its ring through the ``ppermute``s; here
``ring_attention`` is an ``autograd.Function`` whose backward is
FlashAttention-2's, run around the ring a second time: each rank keeps its
rows' log-sum-exp from the forward, recomputes each held block's
probabilities from it (``ring_bwd_fold``), accumulates dq locally, and adds
its dk/dv contributions into f32 accumulators that travel with their k/v
block.  k/v take n - 1 hops; the accumulators take n, the last one home
to the block's owner.  Each hop's transfers overlap the block's products.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from streamingt2v_torch.ops.flash_attention import backward_chunk_rows
from streamingt2v_torch.parallel.mesh import AXIS_SEQ, Mesh

_LOG2E = 1.4426950408889634


def ring_attention_available(mesh: Optional[Mesh], bh: int, lq: int, lk: int) -> bool:
    """The ring applies: a mesh with more than one seq rank and a
    self-attention geometry (each rank's q and k/v blocks of equal
    length)."""
    return mesh is not None and mesh.shape[AXIS_SEQ] > 1 and lq == lk and bh > 0


def _ring_peers(mesh: Mesh) -> tuple:
    """(seq group, n, the next rank, the previous rank) of this rank's ring."""
    n = mesh.shape[AXIS_SEQ]
    group, line = mesh.group(AXIS_SEQ)
    me = mesh.axis_index(AXIS_SEQ)
    return group, n, line[(me + 1) % n], line[(me - 1) % n]


def _pass(tensors, nxt: int, prv: int, group) -> tuple:
    """Send ``tensors`` to the next rank and receive as many from the
    previous one: (received tensors, pending works)."""
    got = [torch.empty_like(t) for t in tensors]
    ops = []
    for t, r in zip(tensors, got):
        ops += [dist.P2POp(dist.isend, t, nxt, group), dist.P2POp(dist.irecv, r, prv, group)]
    return got, dist.batch_isend_irecv(ops)


def _wait(pending) -> None:
    for work in pending:
        work.wait()


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qf, kf, vf, mesh, blocks):
        group, n, nxt, prv = _ring_peers(mesh)
        me = mesh.axis_index(AXIS_SEQ)
        state = ring_start(qf)
        k, v = kf.contiguous(), vf.contiguous()
        for j in range(n):
            pending = []
            if j < n - 1:
                (k_next, v_next), pending = _pass((k, v), nxt, prv, group)
            if blocks is not None:
                blocks.append((me - j) % n)
            state = ring_fold(state, k, v)
            _wait(pending)
            if j < n - 1:
                k, v = k_next, v_next
        out = ring_finish(state, qf.dtype)
        ctx.mesh = mesh
        ctx.save_for_backward(qf, kf, vf, out, ring_lse(state))
        return out

    @staticmethod
    def backward(ctx, g):
        qf, kf, vf, out, lse = ctx.saved_tensors
        group, n, nxt, prv = _ring_peers(ctx.mesh)
        g = g.contiguous()
        delta = ring_delta(out, g)
        dq = torch.zeros(qf.shape, dtype=torch.float32, device=qf.device)
        k, v = kf.contiguous(), vf.contiguous()
        acc, sent, acc_pending = None, None, []
        for j in range(n):
            pending = []
            if j < n - 1:
                (k_next, v_next), pending = _pass((k, v), nxt, prv, group)
            dq_p, dk_p, dv_p = ring_bwd_fold(qf, k, v, g, lse, delta)
            dq += dq_p
            # the held block's accumulators arrive from the previous rank
            # (``sent`` keeps the last hop's outgoing ones alive until then)
            _wait(acc_pending)
            if acc is not None:
                dk_p += acc[0]
                dv_p += acc[1]
            sent = (dk_p, dv_p)
            acc, acc_pending = _pass(sent, nxt, prv, group)
            _wait(pending)
            if j < n - 1:
                k, v = k_next, v_next
        _wait(acc_pending)          # this rank's own block, home after n hops
        return (dq.to(qf.dtype), acc[0].to(kf.dtype), acc[1].to(vf.dtype), None, None)


def ring_attention(qf: torch.Tensor, kf: torch.Tensor, vf: torch.Tensor, mesh: Mesh,
                   blocks: Optional[list] = None) -> torch.Tensor:
    """Self-attention over (B*H, L, D) whose L is split over the seq ranks:
    this rank's (B*H, L/n, D) query block against every rank's k/v block,
    differentiable (every seq rank must run the backward too).  ``blocks``
    (a list, for tests and counts) receives each forward hop's source seq
    index."""
    return _RingAttention.apply(qf, kf, vf, mesh, blocks)


def ring_start(qf: torch.Tensor) -> tuple:
    """(scaled q in the log2 domain, running max, running sum, accumulator)."""
    d = qf.shape[-1]
    qs = (qf.float() * (d ** -0.5 * _LOG2E)).to(qf.dtype).float()
    m = torch.full(qf.shape[:2], -torch.inf, dtype=torch.float32, device=qf.device)
    l = torch.zeros(qf.shape[:2], dtype=torch.float32, device=qf.device)
    return qs, m, l, torch.zeros(qf.shape, dtype=torch.float32, device=qf.device)


def ring_fold(state: tuple, k: torch.Tensor, v: torch.Tensor) -> tuple:
    """Fold one k/v block into the online softmax, in chunks of batch*head
    rows that keep two f32 (Lq, Lk) matrices a row within
    ``BWD_CHUNK_BYTES`` (``backward_chunk_rows``)."""
    qs = state[0]
    rows = backward_chunk_rows(qs.shape[1], k.shape[1])
    if rows >= qs.shape[0]:
        return (qs,) + _fold(*state[1:], qs, k, v)
    parts = [_fold(*(t[i:i + rows] for t in state[1:] + (qs, k, v)))
             for i in range(0, qs.shape[0], rows)]
    return (qs,) + tuple(torch.cat(ts) for ts in zip(*parts))


def _fold(m, l, acc, qs, k, v) -> tuple:
    s = torch.matmul(qs, k.float().transpose(-1, -2))          # (B*H, Lq, Lk), log2 domain
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = s.sub_(m_new[..., None]).exp2_()
    alpha = torch.exp2(m - m_new)
    l = l * alpha + p.sum(dim=-1)
    acc = acc * alpha[..., None] + torch.matmul(p.to(v.dtype).float(), v.float())
    return m_new, l, acc


def ring_finish(state: tuple, dtype: torch.dtype) -> torch.Tensor:
    _, _, l, acc = state
    return (acc / l[..., None]).to(dtype)


def ring_lse(state: tuple) -> torch.Tensor:
    """Each row's log-sum-exp of its log2-domain scores, (B*H, Lq) f32."""
    _, m, l, _ = state
    return m + torch.log2(l)


def ring_delta(out: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """rowsum(dO * O) in f32, (B*H, Lq): the backward's softmax correction."""
    return (g.float() * out.float()).sum(dim=-1)


def ring_bwd_fold(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
                  lse: torch.Tensor, delta: torch.Tensor) -> tuple:
    """One hop of the backward: this rank's queries ``q`` (with their
    forward ``lse``, ``delta`` and output cotangent ``g``) against the held
    k/v block.  Returns f32 (dq part, dk part, dv part).  The probabilities
    are recomputed from the saved log-sum-exp, P = exp2(s - lse), in chunks
    of batch*head rows that keep two f32 (Lq, Lk) matrices a row within
    ``BWD_CHUNK_BYTES`` (``backward_chunk_rows``)."""
    bh, lq, d = q.shape
    rows = backward_chunk_rows(lq, k.shape[1])
    scale = d ** -0.5
    dq, dk, dv = (torch.empty(t.shape, dtype=torch.float32, device=q.device) for t in (q, k, v))
    for start in range(0, bh, rows):
        part = slice(start, start + rows)
        qf, kf, vf, gf = (t[part].float() for t in (q, k, v, g))
        qs = (qf * (scale * _LOG2E)).to(q.dtype).float()   # the forward's rounded scores
        p = torch.matmul(qs, kf.transpose(-1, -2)).sub_(lse[part, :, None]).exp2_()
        dv[part] = torch.matmul(p.transpose(-1, -2), gf)
        ds = torch.matmul(gf, vf.transpose(-1, -2)).sub_(delta[part, :, None]).mul_(p)
        del p
        dq[part] = torch.matmul(ds, kf).mul_(scale)
        dk[part] = torch.matmul(ds.transpose(-1, -2), qf).mul_(scale)
    return dq, dk, dv
