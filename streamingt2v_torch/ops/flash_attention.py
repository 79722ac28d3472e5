"""K1 and K2: flash attention over head-folded (B*H, L, D) tensors (K1) and
over head-packed (B, L, H*D) tensors (K2).

K1 replaces the Pallas kernel ``_flash_kernel`` (``streamingt2v_tpu/ops/
flash_attention.py:38``, launched from ``_flash_pallas:387``), K2 replaces
``_flash_kernel_packed`` (``:201``, launched from ``_flash_pallas_packed:320``).
Both are one hand-written CUDA kernel in ``csrc/flash_attention.cu`` that
reads its rows at a stride: D for K1, H*D from the head's column offset for
K2, so the packed layout needs no head-fold transposes (four copies of q, k,
v and o per call on the K1 route).

What bounds it on the H100: at D=64 the UNet's 9216-token self-attention
does 4*L^2*D flops over 4*L*D*2 bytes per head, so it is tensor-core
bound; the (Lq, Lk) scores are what would otherwise cost memory (85 GB in
f32 at the level-0 geometry).  The kernel keeps a q-tile's scores, running
max, denominator and f32 output accumulator on chip and walks the KV tiles
inside the block, so the scores never reach device memory.  It masks the
ragged KV edge directly, so the TPU's zero-pad denominator correction is
not needed.  The bf16 D=64 instance (all UNet attention) is
FlashAttention-3's outline: two warpgroups of 64 query rows, S = Q K^T on
``wgmma`` from the 128-byte swizzle, P kept in registers as the A operand
of P V on ``wgmma`` with V read N-major, K/V tiles of 128 keys
double-buffered by ``cp.async``, two blocks an SM.  The bf16 D=512
instance (the VAE mid-block attention, one head) gives a 64-row q tile to
two warpgroups: S = Q K^T once on wgmma, P through shared memory, and each
warp 64 of the 512 output columns.  f32 runs on the FMA units in full f32
(no TF32).  At D=512 (the stage-1 VAE's attention in f32) its body blocks 64
query rows, splits S's contraction over its eight warps and feeds its FMAs
from register microtiles; where the row blocks would fill the SMs unevenly
the wrapper splits the keys over blocks and the kernel merges them
(``f32_d512_plan``).  At D=64 (the f32 references and the tiny configs) its
body blocks 128 query rows, walks 64-key tiles with K and V copied by
``cp.async`` under the products, and feeds its FMAs from 8 x 8 register
microtiles (S and P V alike), two blocks an SM.  Head dims below 64 are
zero-padded to 64
(``pad_head_dim``), with the scale of the true head dim.  K1 also runs
bf16 at D=128 (the video DiTs' heads): the D=64 outline with 64-key tiles
(``flash_kernel_bf16_d128_wgmma``).  D=128 has no f32 body and no K2 route:
``ops/attention.py`` sends f32 at D=128 to its chunked plain path
(``bf16_only``).  Each wrapper counts its launches
(``utils/profiling.read_launches``) and, apart, those of the bf16 D=512
instance (``<name>_d512``), of the bf16 D=128 one (``<name>_d128``) and
those in f32 (``<name>_f32``).

Gradients: on the card each wrapper is a ``torch.autograd.Function`` whose
forward launches the kernel and saves q, k and v, and whose backward is the
VJP of the plain version (the JAX package's ``custom_vjp``: its backward
differentiates ``_attention_reference`` at ``:155``), with f32 scores, over
chunks of the batch*head axis that keep one chunk's probabilities and their
gradient within ``BWD_CHUNK_BYTES`` (``flash_attention_backward``).  Each
wrapper counts the chunks its backward ran (``bwd_chunks``).  On the CPU
the plain version is returned and autograd differentiates it.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from streamingt2v_torch.ops import _native
from streamingt2v_torch.ops._backward import BWD_CHUNK_BYTES
from streamingt2v_torch.utils.profiling import count_launch

_HEAD_DIMS = (64, 512)
# head dims that only the bf16 instances run (K1 alone)
_BF16_HEAD_DIMS = (128,)
# the JAX package's cap on the packed lane width (PACKED_MAX_LANES)
PACKED_MAX_LANES = 1280
# the f32 D=512 body's query rows a block and keys a tile (``FF_BQ``,
# ``FF_BK`` in csrc/flash_attention.cu), and the most key splits it is given
F32_ROWS, F32_KEYS, F32_MAX_SPLITS = 64, 16, 16
# a split's partial rows cost about this many KV tiles of a block's time
# (written once and read once by the merge at HBM's rate)
_SPLIT_COST_TILES = 2


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain version: softmax(q k^T / sqrt(d)) v with f32 scores."""
    scale = q.shape[-1] ** -0.5
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v.float()).to(v.dtype)


def _kernel_head_dim(d: int, dtype: torch.dtype = torch.float32) -> int:
    """Head dims up to 64 run zero-padded to 64; 512 runs as is, and 128 in
    bf16."""
    kd = 64 if d <= 64 else d
    if kd not in _HEAD_DIMS and not (kd in _BF16_HEAD_DIMS and dtype == torch.bfloat16):
        raise ValueError(f"flash_attention: head dim {d} in {dtype} is not supported "
                         f"(<= 64 or 512, or 128 in bf16)")
    return kd


def bf16_only(d: int, dtype: torch.dtype) -> bool:
    """Whether head dim ``d`` has a K1 instance in bf16 alone and ``dtype``
    is another (f32 at D=128)."""
    return d in _BF16_HEAD_DIMS and dtype != torch.bfloat16


def pad_head_dim(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> tuple:
    """q, k, v with their head dim zero-padded to the kernel's: zero columns
    add nothing to q k^T, and the output's padded columns are zero."""
    d = q.shape[-1]
    kd = _kernel_head_dim(d, q.dtype)
    if kd == d:
        return q, k, v
    return tuple(torch.nn.functional.pad(t, (0, kd - d)) for t in (q, k, v))


def backward_chunk_rows(lq: int, lk: int) -> int:
    """Batch*head rows per backward chunk: as many as keep two f32 (Lq, Lk)
    matrices a row within ``BWD_CHUNK_BYTES``, at least one."""
    return max(1, BWD_CHUNK_BYTES // (2 * 4 * lq * lk))


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
                             chunk: Optional[int] = None) -> tuple:
    """The VJP of ``flash_attention_reference`` at (q, k, v) for the
    cotangent g, over (B*H, L, D) in chunks of ``chunk`` batch*head rows
    (``backward_chunk_rows`` unless given): f32 scores, the gradients in the
    inputs' dtypes.  Returns (dq, dk, dv, chunks run).

    Per chunk: P = softmax(q k^T / sqrt(d)); dv = P^T g; dP = g v^T;
    dS = P * (dP - rowsum(g * P v)) (rowsum(dP * P) without a third
    (Lq, Lk) matrix); dq = dS k / sqrt(d); dk = dS^T q / sqrt(d)."""
    bh, lq, d = q.shape
    rows = chunk or backward_chunk_rows(lq, k.shape[1])
    scale = d ** -0.5
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    chunks = 0
    for start in range(0, bh, rows):
        part = slice(start, start + rows)
        qf, kf, vf, gf = (t[part].float() for t in (q, k, v, g))
        p = torch.matmul(qf, kf.transpose(-1, -2)).mul_(scale)
        p.sub_(p.amax(dim=-1, keepdim=True)).exp_()
        p.div_(p.sum(dim=-1, keepdim=True))
        dv[part] = torch.matmul(p.transpose(-1, -2), gf)
        delta = (gf * torch.matmul(p, vf)).sum(dim=-1, keepdim=True)
        ds = torch.matmul(gf, vf.transpose(-1, -2)).sub_(delta).mul_(p)
        del p
        dq[part] = torch.matmul(ds, kf).mul_(scale)
        dk[part] = torch.matmul(ds.transpose(-1, -2), qf).mul_(scale)
        chunks += 1
    return dq, dk, dv, chunks


def kernel_geometry(q_shape: tuple, k_shape: tuple, num_heads: int = 1,
                    dtype: torch.dtype = torch.float32) -> dict:
    """What the kernel is told about (B, L, H*D) operands of ``dtype`` (K1:
    H = 1 over (B*H, L, D)): ``batch``, ``heads``, ``lq``, ``lk`` and the head
    dim it runs ``d`` (64 or 512, or 128 in bf16: ``_kernel_head_dim``).  The
    kernel reads head h of batch row b at the row stride H*d from element
    (b*L)*H*d + h*d: in K2's packed layout a head is a d-wide column slice."""
    batch, lq, hd = q_shape
    d = _kernel_head_dim(hd // num_heads, dtype)
    return dict(batch=batch, heads=num_heads, lq=lq, lk=k_shape[1], d=d)


def f32_d512_plan(batch_heads: int, lq: int, lk: int, sms: int) -> dict:
    """How the f32 D=512 body covers (B*H, Lq, Lk) on ``sms`` SMs: its
    ceil(Lq / 64) * B*H row blocks each split over ``splits`` ranges of
    ``tiles_per_split`` 16-key tiles.  Chosen to least (waves * tiles a
    block + the merge's cost), where waves = ceil(blocks * splits / sms): at
    (1, 9216, 512) 144 row blocks are 1.09 waves of 132 SMs, split they fill
    the waves evenly.  Ties go to fewer splits (no merge at one)."""
    blocks = -(-lq // F32_ROWS) * batch_heads
    tiles = -(-lk // F32_KEYS)
    best = None
    for n in range(1, min(F32_MAX_SPLITS, tiles) + 1):
        per = -(-tiles // n)
        splits = -(-tiles // per)   # ranges that hold a tile
        waves = -(-blocks * splits // sms)
        cost = waves * per + (_SPLIT_COST_TILES * blocks * splits / sms if splits > 1 else 0)
        if best is None or cost < best["cost"]:
            best = dict(splits=splits, tiles_per_split=per, waves=blocks * splits / sms,
                        cost=cost)
    return best


def _split_scratch(q: torch.Tensor, geo: dict) -> tuple:
    """(splits, tiles per split, partial rows, their max and sum) for one
    launch: the f32 D=512 body's key split (``f32_d512_plan``) with its
    scratch, one split and no scratch for every other instance."""
    if q.dtype != torch.float32 or geo["d"] != 512:
        return 1, 1, None, None
    rows = geo["batch"] * geo["heads"]
    plan = f32_d512_plan(rows, geo["lq"], geo["lk"], _native.sm_count(q.device))
    n = plan["splits"]
    if n == 1:
        return 1, plan["tiles_per_split"], None, None
    part = torch.empty((n, rows, geo["lq"], 512), dtype=torch.float32, device=q.device)
    ml = torch.empty((n, rows, geo["lq"], 2), dtype=torch.float32, device=q.device)
    return n, plan["tiles_per_split"], part, ml


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _launch_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """One K1 launch on checked inputs."""
    d = q.shape[-1]
    q, k, v = pad_head_dim(q, k, v)
    geo = kernel_geometry(q.shape, k.shape, dtype=q.dtype)
    out = torch.empty_like(q)
    splits, per, part, ml = _split_scratch(q, geo)
    rc = _native.library().st2v_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), geo["batch"], geo["lq"],
        geo["lk"], geo["d"], _native.DTYPE_CODE[q.dtype], d ** -0.5 * math.log2(math.e),
        splits, per, _ptr(part), _ptr(ml), _native.stream_of(q))
    _native.check(rc, "flash_attention")
    count_launch("flash_attention", d512=geo["d"] == 512 and q.dtype == torch.bfloat16,
                 d128=geo["d"] == 128, f32=q.dtype == torch.float32)
    return out[..., :d] if geo["d"] != d else out


class _FlashAttention(torch.autograd.Function):
    """K1 forward, the plain version's VJP backward."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return _launch_flash(q, k, v)

    @staticmethod
    def backward(ctx, g):
        dq, dk, dv, chunks = flash_attention_backward(*ctx.saved_tensors, g)
        flash_attention.bwd_chunks += chunks
        return dq, dk, dv


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Softmax attention over (B*H, L, D).  CPU tensors take the plain
    version; CUDA tensors launch K1 (or raise), differentiable through
    ``flash_attention_backward``."""
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
    if not 0 < q.shape[0] <= 65535:
        raise ValueError(f"flash_attention: batch*heads {q.shape[0]} outside (0, 65535]")
    _kernel_head_dim(q.shape[-1], q.dtype)
    return _FlashAttention.apply(q, k, v)


flash_attention.bwd_chunks = 0


# ---------------------------------------------------------------- K2 -----

def packed_applicable(num_heads: int, head_dim: int) -> bool:
    """The JAX package's gate for the packed kernel (64-multiple head dims,
    at most 1280 packed lanes), narrowed to the head dims K2 is built for."""
    return (head_dim % 64 == 0 and num_heads * head_dim <= PACKED_MAX_LANES
            and head_dim in _HEAD_DIMS)


def flash_attention_packed_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                     num_heads: int) -> torch.Tensor:
    """Plain version over (B, L, H*D) with f32 scores (the JAX package's
    ``_attention_reference_packed``)."""
    b, lq, hd = q.shape
    d = hd // num_heads
    qh = q.float().reshape(b, lq, num_heads, d).transpose(1, 2)
    kh = k.float().reshape(b, k.shape[1], num_heads, d).transpose(1, 2)
    vh = v.float().reshape(b, v.shape[1], num_heads, d).transpose(1, 2)
    p = torch.softmax(torch.matmul(qh, kh.transpose(-1, -2)) * d ** -0.5, dim=-1)
    return torch.matmul(p, vh).transpose(1, 2).reshape(b, lq, hd).to(v.dtype)


def flash_attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                           num_heads: int) -> torch.Tensor:
    """Softmax attention over head-packed q (B, Lq, H*D), k/v (B, Lk, H*D).
    CPU tensors take the plain version; CUDA tensors launch K2 (or raise),
    differentiable through ``flash_attention_packed_backward``."""
    if q.device.type == "cpu":
        return flash_attention_packed_reference(q, k, v, num_heads)
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"flash_attention_packed: tensors must share one CUDA device, "
                         f"got {q.device}")
    if q.dtype not in _native.DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention_packed: f32 or bf16 of one dtype, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if q.ndim != 3 or k.ndim != 3 or k.shape != v.shape or k.shape[0] != q.shape[0] \
            or k.shape[2] != q.shape[2]:
        raise ValueError(f"flash_attention_packed: bad shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    b, _, hd = q.shape
    d = hd // num_heads
    if num_heads * d != hd or not packed_applicable(num_heads, d):
        raise ValueError(f"flash_attention_packed: {num_heads} heads of {hd} channels "
                         f"(head dim 64 or 512, at most {PACKED_MAX_LANES} channels)")
    if not 0 < b * num_heads <= 65535:
        raise ValueError(f"flash_attention_packed: batch*heads {b * num_heads} outside "
                         f"(0, 65535]")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention_packed: q, k and v must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention_packed: q, k and v must be 16-byte aligned")
    return _FlashAttentionPacked.apply(q, k, v, num_heads)


def _fold_heads(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, L, H*D) -> (B*H, L, D)."""
    b, length, hd = t.shape
    return t.reshape(b, length, num_heads, hd // num_heads).transpose(1, 2).reshape(
        b * num_heads, length, hd // num_heads)


def _unfold_heads(t: torch.Tensor, b: int) -> torch.Tensor:
    """(B*H, L, D) -> (B, L, H*D)."""
    bh, length, d = t.shape
    return t.reshape(b, bh // b, length, d).transpose(1, 2).reshape(b, length, bh // b * d)


def flash_attention_packed_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                    g: torch.Tensor, num_heads: int,
                                    chunk: Optional[int] = None) -> tuple:
    """The VJP of ``flash_attention_packed_reference`` (the JAX package's
    ``_attention_reference_packed``): ``flash_attention_backward`` on the
    head-folded copies, over chunks of batch rows x heads.  Returns (dq, dk,
    dv, chunks run) in the packed layout."""
    b = q.shape[0]
    dq, dk, dv, chunks = flash_attention_backward(
        *(_fold_heads(t, num_heads) for t in (q, k, v, g)), chunk)
    return _unfold_heads(dq, b), _unfold_heads(dk, b), _unfold_heads(dv, b), chunks


def _launch_flash_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         num_heads: int) -> torch.Tensor:
    """One K2 launch on checked inputs."""
    geo = kernel_geometry(q.shape, k.shape, num_heads, q.dtype)
    d = geo["d"]
    out = torch.empty_like(q)
    splits, per, part, ml = _split_scratch(q, geo)
    rc = _native.library().st2v_flash_attention_packed(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), geo["batch"], geo["heads"],
        geo["lq"], geo["lk"], d, _native.DTYPE_CODE[q.dtype], d ** -0.5 * math.log2(math.e),
        splits, per, _ptr(part), _ptr(ml), _native.stream_of(q))
    _native.check(rc, "flash_attention_packed")
    count_launch("flash_attention_packed", d512=d == 512 and q.dtype == torch.bfloat16,
                 f32=q.dtype == torch.float32)
    return out


class _FlashAttentionPacked(torch.autograd.Function):
    """K2 forward, the plain version's VJP backward."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads):
        ctx.save_for_backward(q, k, v)
        ctx.num_heads = num_heads
        return _launch_flash_packed(q, k, v, num_heads)

    @staticmethod
    def backward(ctx, g):
        dq, dk, dv, chunks = flash_attention_packed_backward(*ctx.saved_tensors, g,
                                                             ctx.num_heads)
        flash_attention_packed.bwd_chunks += chunks
        return dq, dk, dv, None


flash_attention_packed.bwd_chunks = 0
