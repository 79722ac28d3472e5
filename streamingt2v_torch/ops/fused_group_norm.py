"""K5: GroupNorm (+ SiLU) over channel-last (N, L, C) with statistics over
(L, C/G) per row, as two launches of the hand-written CUDA kernels in
``csrc/fused_group_norm.cu``.

Replaces the Pallas kernel ``_kernel`` (``streamingt2v_tpu/ops/
fused_group_norm.py:30``, launched from ``fused_group_norm:83``).  The TPU
kernel carries its group sums across a sequential grid axis; on the H100 the
blocks run in parallel, so pass 1 writes per-(row, L-chunk, group)
count/mean/M2 partials to a small scratch and pass 2 merges its row's
partials (Chan's formula) before it normalises.  Partials around each tile's
own mean keep the variance of a group at a large common offset, which the
one-pass E[x^2] - E[x]^2 of the TPU kernel loses.

What bounds it on the H100: bytes.  It reads x twice and writes the output
once (at the SD-VAE's (2, 921600, 128) level, 708 MB in bf16) and keeps the
normalised tensor and its f32 upcast out of device memory; the plain
version materialises both.  Every thread of both passes owns one 16-byte
vector of channels and a row slot (``launch_plan``), so the statistics stay
in registers and the affine is computed once per thread.

``fused_group_norm_affine`` launches pass 1 alone and a small merge
(``gn_affine_kernel``, one block per (group, row)) that turns the partials into the
per-(row, channel) f32 affine ``(a, b)`` of GroupNorm(x) = x * a + b: the
statistics of K4's GroupNorm+SiLU prologue, which applies them as it reads
x.  It reads x once, so it has a launch plan of its own
(``affine_launch_plan``): about one wave of resident pass-1 blocks, whatever
N is, where K5's plan caps a row at 256 L-chunks (half a wave at N = 1).

No gradient: the JAX package defines no VJP for its kernel (``jax.grad``
through it fails in pallas_call's JVP rule), so on the card an input that
requires grad under grad mode (``needs_grad``) raises rather than return
an output that autograd cannot see through; ``ops/norms.py`` sends such
inputs to the plain version.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from streamingt2v_torch.ops import _native
from streamingt2v_torch.utils.profiling import count_launch

MAX_CHANNELS = 4096   # the JAX package's fits_fused cap
MAX_GROUPS = 256
# about this many blocks per launch (a few per SM of the H100's 132), at most
# 256 L-chunks per row so that each pass-2 block merges few partials
_TARGET_BLOCKS = 1024
_MAX_CHUNKS = 256
# the affine entry's pass 1: about one wave of resident blocks whatever N is
# (4 blocks of 256 threads at 52 registers an SM, 132 SMs); its merge reads
# N * chunks * G partials
_AFFINE_BLOCKS = 512
# threads a block aims at: C/VEC channel vectors times as many row slots as fit
BLOCK_THREADS = 256
# shared memory one block may take on the H100
SMEM_LIMIT = 232448


def fits_fused(l: int, c: int, num_groups: int) -> bool:
    """The JAX package's gate (``fits_fused``: C <= 4096) plus what the
    kernel needs: 16-byte channel rows (C % 8) and at most 256 groups."""
    return 0 < l and c <= MAX_CHANNELS and c % 8 == 0 and 0 < num_groups <= MAX_GROUPS \
        and c % num_groups == 0


def needs_grad(*tensors: torch.Tensor) -> bool:
    """Whether autograd records a graph through an op on ``tensors``: the
    condition under which K5 refuses and the norms take the plain version."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _mean_rstd(x: torch.Tensor, num_groups: int, eps: float) -> tuple:
    """(N, L, C) -> its f32 view (N, L, G, C/G) and the two-pass statistics
    per (row, group), mean and 1/sqrt(var + eps), each (N, 1, G, 1)."""
    n, l, c = x.shape
    xg = x.float().reshape(n, l, num_groups, c // num_groups)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = (xg - mean).square().mean(dim=(1, 3), keepdim=True)
    return xg, mean, torch.rsqrt(var + eps)


def fused_group_norm_reference(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *,
                               num_groups: int, eps: float = 1e-6,
                               act: Optional[str] = None) -> torch.Tensor:
    """Plain version in f32: two-pass statistics per (row, group).  Also
    the plain path of ``norms.group_norm``, which autograd goes through."""
    xg, mean, rstd = _mean_rstd(x, num_groups, eps)
    out = ((xg - mean) * rstd).reshape(x.shape) * scale.float() + bias.float()
    if act == "silu":
        out = F.silu(out)
    return out.to(x.dtype)


def group_norm_affine_reference(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *,
                                num_groups: int, eps: float = 1e-6) -> tuple:
    """Plain version in f32: the two-pass statistics per (row, group) as the
    affine (a, b), each (N, C), with GroupNorm(x) = x * a + b.  Also the
    plain path of ``norms.group_norm_affine``, which autograd goes through."""
    n, _, c = x.shape
    _, mean, rstd = _mean_rstd(x, num_groups, eps)
    rep = c // num_groups
    a = rstd.reshape(n, num_groups).repeat_interleave(rep, dim=1) * scale.float()
    b = bias.float() - mean.reshape(n, num_groups).repeat_interleave(rep, dim=1) * a
    return a, b


class LaunchPlan(NamedTuple):
    """Both passes' grid (chunks, N) and block (``vectors`` x ``slots``
    threads): thread (slot s, vector v) takes channels [v*VEC, v*VEC + VEC)
    of rows chunk*rows_per_chunk + s, + 2s, ... within its chunk."""
    rows_per_chunk: int
    chunks: int
    vectors: int       # 16-byte channel vectors per row, C / VEC
    slots: int         # rows a block walks side by side
    threads: int
    smem_bytes: int    # pass 1: (count, mean, M2) per (slot, channel)


def launch_plan(n: int, l: int, c: int, itemsize: int) -> LaunchPlan:
    return _plan(n, l, c, itemsize, _TARGET_BLOCKS, _MAX_CHUNKS)


def affine_launch_plan(n: int, l: int, c: int, itemsize: int) -> LaunchPlan:
    """The affine entry's pass 1 (its merge takes one block per group and row)."""
    return _plan(n, l, c, itemsize, _AFFINE_BLOCKS, _AFFINE_BLOCKS)


def _plan(n: int, l: int, c: int, itemsize: int, target_blocks: int,
          max_chunks: int) -> LaunchPlan:
    vectors = c // (16 // itemsize)
    slots = max(1, BLOCK_THREADS // vectors)
    chunks = max(1, min(max_chunks, -(-target_blocks // n), -(-l // slots)))
    # whole row slots per chunk, so that every slot walks as many rows
    rows = -(-(-(-l // chunks)) // slots) * slots
    return LaunchPlan(rows, -(-l // rows), vectors, slots, vectors * slots,
                      12 * slots * c)


def _refuse_grad(what: str, *tensors: torch.Tensor) -> None:
    if needs_grad(*tensors):
        raise RuntimeError(f"{what}: K5 has no backward (the JAX package defines no VJP for "
                           f"it); ops.norms takes the plain version under grad")


def _check_card_inputs(what: str, x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                       num_groups: int) -> tuple:
    """What both entries need of a CUDA call; returns (N, L, C)."""
    if not x.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor, got {x.device}")
    _refuse_grad(what, x, scale, bias)
    if x.dtype not in _native.DTYPE_CODE:
        raise TypeError(f"{what}: f32 or bf16, got {x.dtype}")
    if x.ndim != 3:
        raise ValueError(f"{what}: expected (N, L, C), got {tuple(x.shape)}")
    n, l, c = x.shape
    if not fits_fused(l, c, num_groups) or not 0 < n <= 65535:
        raise ValueError(f"{what}: N={n} L={l} C={c} groups={num_groups} not supported")
    for name, t in (("scale", scale), ("bias", bias)):
        if t.dtype != torch.float32 or tuple(t.shape) != (c,) or t.device != x.device \
                or not t.is_contiguous():
            raise TypeError(f"{what}: {name} must be contiguous f32 ({c},) on x's device")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{what}: x must be contiguous and 16-byte aligned")
    return n, l, c


def fused_group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *,
                     num_groups: int, eps: float = 1e-6,
                     act: Optional[str] = None) -> torch.Tensor:
    """x: (N, L, C); scale, bias: (C,) -> (N, L, C) in x's dtype.  CPU
    tensors take the plain version; CUDA tensors launch K5 (or raise)."""
    if act not in (None, "silu"):
        raise ValueError(act)
    if x.device.type == "cpu":
        return fused_group_norm_reference(x, scale, bias, num_groups=num_groups, eps=eps,
                                          act=act)
    n, l, c = _check_card_inputs("fused_group_norm", x, scale, bias, num_groups)
    plan = launch_plan(n, l, c, x.element_size())
    part = torch.empty((n, plan.chunks, num_groups, 3), dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    rc = _native.library().st2v_fused_group_norm(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(), part.data_ptr(),
        n, l, c, num_groups, plan.rows_per_chunk, plan.slots, eps, int(act == "silu"),
        _native.DTYPE_CODE[x.dtype], _native.stream_of(x))
    _native.check(rc, "fused_group_norm")
    count_launch("fused_group_norm")
    return out


def fused_group_norm_affine(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *,
                            num_groups: int, eps: float = 1e-6) -> tuple:
    """x: (N, L, C); scale, bias: (C,) -> f32 (a, b), each (N, C), with
    GroupNorm(x) = x * a + b.  CPU tensors take the plain version; CUDA
    tensors launch K5's pass 1 and the merge (or raise).  Raises on either
    device under grad for an input that requires grad, as the card's K5
    does: the plain version is the path that differentiates."""
    _refuse_grad("fused_group_norm_affine", x, scale, bias)
    if x.device.type == "cpu":
        return group_norm_affine_reference(x, scale, bias, num_groups=num_groups, eps=eps)
    n, l, c = _check_card_inputs("fused_group_norm_affine", x, scale, bias, num_groups)
    plan = affine_launch_plan(n, l, c, x.element_size())
    part = torch.empty((n, plan.chunks, num_groups, 3), dtype=torch.float32, device=x.device)
    a = torch.empty((n, c), dtype=torch.float32, device=x.device)
    b = torch.empty_like(a)
    rc = _native.library().st2v_group_norm_affine(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), a.data_ptr(), b.data_ptr(),
        part.data_ptr(), n, l, c, num_groups, plan.rows_per_chunk, plan.slots, eps,
        _native.DTYPE_CODE[x.dtype], _native.stream_of(x))
    _native.check(rc, "fused_group_norm_affine")
    count_launch("fused_group_norm_affine", f32=x.dtype == torch.float32)
    return a, b
