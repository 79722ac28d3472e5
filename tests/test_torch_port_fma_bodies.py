"""PyTorch port: the FMA bodies of K1/K2 at D=64 in f32 (``flash_kernel_f32_d64``)
and of K6 (``temporal_attention_fma_kernel``: f32 at every head dim, bf16 at
head dims other than 64), on the CPU.

The kernels run only on the card; their arithmetic is checked here by
recomputing the plain function from the operands as each body reads them,
lane by lane, in f64: within 1e-6 of max |reference| of the plain versions'
formula evaluated in f64, and within 1e-5 (the ops tests' tolerance) of
``flash_attention_reference`` / ``temporal_attention_reference`` themselves,
which compute in f32 (their own rounding reaches 1.2e-6 of max |reference|
at D=64 over 200 keys).  Each walk also checks that its lanes' tiles cover
every (row, key) score and every (row, column) output exactly once.
K1: row blocks of 128 queries (32 a warp, lane 8 rg + kg owning rows
32 w + rg + 4 i), 64-key tiles with the ragged edge masked, the online
softmax in log2 units with each lane's share of the sum folded at the end,
P through the warp's [key][8 rg + i] slice, K2's row stride, head dims below
64 zero-padded.  K6: the pairs in the persistent grid's order, the query
quads over four warps, frames padded to quads and to the eight key lanes,
the padded keys masked, P through [key][4 rg + i], the column groups of 32.
Also: both bodies' shared memory and thread constants read from the sources,
the bank layout of their loads, and ``chip_smoke``'s f32 work counts and
SDPA views at the new timed shapes."""

import math
import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from _torch_port_helpers import assert_close, t
from streamingt2v_torch.ops import flash_attention as fa
from streamingt2v_torch.ops._native import CSRC
from streamingt2v_torch.ops.temporal_attention import (
    fits_temporal_attention, temporal_attention_reference)

TOL = 1e-6
REF_TOL = 1e-5   # against the f32 plain versions


def _attention_f64(q, k, v) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v in f64 over (..., L, d): the plain versions'
    formula without their f32 rounding."""
    q, k, v = (x.double() for x in (q, k, v))
    return torch.softmax(q @ k.transpose(-1, -2) * q.shape[-1] ** -0.5, dim=-1) @ v


def _heads_f64(x, frames: int, batch: int, num_heads: int) -> torch.Tensor:
    """K6's (B*T, S, H*d) as (B, S, H, T, d): attention over the frames."""
    _, s_len, hd = x.shape
    return x.reshape(batch, frames, s_len, num_heads, hd // num_heads).permute(0, 2, 3, 1, 4)
SMEM_OPT_IN = 232448     # a block's dynamic shared memory (227 KB)
SMEM_PER_SM = 233472     # 228 KB, 1 KB of it reserved per block


def _consts(name: str, prefix: str) -> dict:
    """The integer constants ``prefix*`` of a kernel source, each an
    expression of integers and the constants before it."""
    src = (CSRC / name).read_text()
    out = {}
    for key, expr in re.findall(rf"constexpr int ({prefix}\w+) = ([^;]+);", src):
        out[key] = int(eval(expr, {}, dict(out)))   # noqa: S307 - the repo's own source
    return out


def _banks16(byte_offsets) -> set:
    """The 16-byte bank groups (of 8 in a 128-byte row of banks) of offsets."""
    return {(o % 128) // 16 for o in byte_offsets}


# ------------------------------------------------------- K1 f32 D=64 ---

def _flash_f32_d64_as_the_body_walks(q, k, v, lk: int, scale_log2: float) -> torch.Tensor:
    """The body on (B*H, L, 64): per row block and 64-key tile, each lane's
    8 x 8 microtile of S (rows 32 w + rg + 4 i, keys kg + 8 j), the row max
    over the eight kg lanes, the online softmax in log2 units, P stored to
    and read from the warp's [key][8 rg + i] slice, and O's 8 x 8 microtile
    (columns 4 kg + c and 32 + 4 kg + c); the lanes' sums folded at the end."""
    c = _consts("flash_attention.cu", "FS_")
    bq, bk, d, warps = c["FS_BQ"], c["FS_BK"], c["FS_D"], c["FS_THREADS"] // 32
    assert (bq, bk, d) == (128, 64, 64) and bq == 32 * warps
    q, k, v = (x.double() for x in (q, k, v))
    bh, lq = q.shape[:2]
    w, rg, kg, i8 = torch.meshgrid(torch.arange(warps), torch.arange(4), torch.arange(8),
                                   torch.arange(8), indexing="ij")
    rows = (32 * w + rg + 4 * i8)[:, :, 0, :]             # [w, rg, i]
    keys = kg[0, 0] + 8 * i8[0, 0]                        # [kg, j]
    cols = 4 * kg[0, 0] + i8[0, 0] % 4 + 32 * (i8[0, 0] // 4)   # [kg, c]
    assert sorted(rows.flatten().tolist()) == list(range(bq))
    assert sorted(keys.flatten().tolist()) == list(range(bk))
    assert sorted(cols.flatten().tolist()) == list(range(d))
    slots = 8 * rg[0, :, 0, :] + i8[0, 0, 0]              # [rg, i]: P's column of row (rg, i)
    assert sorted(slots.flatten().tolist()) == list(range(32))
    # P's element (rg, kg, i, j) of a warp goes to [kg + 8 j][8 rg + i], each once
    key_of_p = keys[None, :, None, :].expand(4, 8, 8, 8).reshape(-1)
    slot_of_p = slots[:, None, :, None].expand(4, 8, 8, 8).reshape(-1)
    assert len(set(zip(key_of_p.tolist(), slot_of_p.tolist()))) == 4 * 8 * 8 * 8
    tiles = -(-lk // bk)
    kp, vp = (F.pad(x, (0, 0, 0, tiles * bk - x.shape[1])) for x in (k, v))
    out = torch.full((bh, lq, d), math.nan, dtype=torch.float64)
    for q0 in range(0, lq, bq):
        qb = F.pad(q[:, q0:q0 + bq], (0, 0, 0, bq - q[:, q0:q0 + bq].shape[1]))
        mx = torch.full((bh, warps, 4, 8), -math.inf, dtype=torch.float64)   # [.., w, rg, i]
        den = torch.zeros(bh, warps, 4, 8, 8, dtype=torch.float64)          # [.., w, rg, kg, i]
        acc = torch.zeros(bh, warps, 4, 8, 8, 8, dtype=torch.float64)       # [.., w, rg, kg, i, c]
        for j in range(tiles):
            kt, vt = kp[:, j * bk:(j + 1) * bk], vp[:, j * bk:(j + 1) * bk]
            s = torch.einsum("bwrid,bkjd->bwrkij", qb[:, rows], kt[:, keys])
            s = s.masked_fill((j * bk + keys >= lk)[:, None, :], -math.inf)   # the ragged tile
            r = s.amax(-1).amax(3)                             # over j, then the kg lanes
            mnew = torch.maximum(mx, r * scale_log2)
            alpha = torch.exp2(mx - mnew)
            p = torch.exp2(s * scale_log2 - mnew[:, :, :, None, :, None])
            den = den * alpha[:, :, :, None] + p.sum(-1)
            acc = acc * alpha[:, :, :, None, :, None]
            pw = torch.full((bh, warps, bk, 32), math.nan, dtype=torch.float64)
            pw[:, :, key_of_p, slot_of_p] = p.reshape(bh, warps, -1)
            pr = pw[:, :, :, slots]                            # [.., w, key, rg, i]
            acc = acc + torch.einsum("bwkri,bkgc->bwrgic", pr, vt[:, :, cols])
            mx = mnew
        o = acc / den.sum(3)[:, :, :, None, :, None]
        n = min(bq, lq - q0)
        for (wi, ri, ii), row in np.ndenumerate(rows.numpy()):
            if row < n:
                out[:, q0 + row, cols] = o[:, wi, ri, :, ii, :]
    assert not torch.isnan(out).any()                                      # every output written
    return out


@pytest.mark.parametrize("bh,lq,lk,d", [
    (2, 128, 64, 64),     # one row block, one tile
    (1, 300, 145, 64),    # ragged rows and keys: three row blocks, three tiles
    (3, 70, 200, 64),     # one partial row block, a ragged fourth tile
    (2, 40, 9, 32),       # head dim 32 zero-padded, one short tile
    (1, 129, 65, 48),     # one row and one key past a block and a tile
])
def test_flash_f32_d64_walk_keeps_the_function(bh, lq, lk, d):
    """K1 f32 at D=64: the wrapper's zero-padded head dim with the true head
    dim's scale, walked as the body walks it, gives the plain version's
    output."""
    rng = np.random.RandomState(5)
    q, k, v = (t(rng.randn(bh, n, d)) for n in (lq, lk, lk))
    qp, kp, vp = fa.pad_head_dim(q, k, v)
    assert fa.kernel_geometry(qp.shape, kp.shape)["d"] == 64
    got = _flash_f32_d64_as_the_body_walks(qp, kp, vp, lk, d ** -0.5 * math.log2(math.e))
    assert not got[..., d:].any()   # the padded columns of v are zero
    assert_close(got[..., :d], _attention_f64(q, k, v).numpy(), TOL, "K1 walk")
    assert_close(got[..., :d], fa.flash_attention_reference(q, k, v).numpy(), REF_TOL, "K1 ref")


@pytest.mark.parametrize("b,lq,lk,heads", [(2, 150, 70, 3), (1, 77, 130, 5)])
def test_flash_f32_d64_packed_rows_keep_the_function(b, lq, lk, heads):
    """K2 f32 at D=64 on head-packed (B, L, H*64): each head read at the row
    stride H*64 from its column offset and walked as the body walks it gives
    the packed plain version's output."""
    rng = np.random.RandomState(6)
    d = 64
    q = t(rng.randn(b, lq, heads * d))
    k, v = (t(rng.randn(b, lk, heads * d)) for _ in range(2))
    assert fa.kernel_geometry(q.shape, k.shape, heads) == dict(batch=b, heads=heads, lq=lq,
                                                               lk=lk, d=d)

    def heads_of(x, length):
        return torch.stack([torch.as_strided(x.reshape(-1), (length, d), (heads * d, 1),
                                             i * length * heads * d + h * d)
                            for i in range(b) for h in range(heads)])

    got = _flash_f32_d64_as_the_body_walks(heads_of(q, lq), heads_of(k, lk), heads_of(v, lk), lk,
                                           d ** -0.5 * math.log2(math.e))
    got = got.reshape(b, heads, lq, d).transpose(1, 2).reshape(b, lq, heads * d)
    f64 = _attention_f64(*(x.reshape(b, -1, heads, d).transpose(1, 2) for x in (q, k, v)))
    assert_close(got, f64.transpose(1, 2).reshape(b, lq, heads * d).numpy(), TOL, "K2 walk")
    ref = fa.flash_attention_packed_reference(q, k, v, heads)
    assert_close(got, ref.numpy(), REF_TOL, "K2 f32 D=64 row stride")


def test_flash_f32_d64_body_fits_two_blocks_an_sm():
    """Q resident (128 rows), one K and one V tile of 64 keys and the four
    warps' P fit two blocks an SM; 128 threads hold an 8 x 8 tile of S and one
    of O each (16 128-bit loads a 256 FMAs); the rows' strides put one load's
    four Q rows or eight K keys, and a P store's eight keys, in distinct
    16-byte bank groups."""
    c = _consts("flash_attention.cu", "FS_")
    assert (c["FS_D"], c["FS_THREADS"], c["FS_BQ"], c["FS_BK"], c["FS_BLOCKS"]) == (
        64, 128, 128, 64, 2)
    floats = (c["FS_BQ"] * c["FS_LD"] + c["FS_BK"] * c["FS_LD"] + c["FS_BK"] * c["FS_LDV"]
              + c["FS_THREADS"] // 32 * c["FS_BK"] * c["FS_LDP"])
    assert c["FS_BLOCKS"] * (4 * floats + 1024) <= SMEM_PER_SM and 4 * floats <= SMEM_OPT_IN
    assert c["FS_BQ"] * c["FS_BK"] == 64 * c["FS_THREADS"] == c["FS_BQ"] * c["FS_D"]
    assert all(c[key] % 4 == 0 for key in ("FS_LD", "FS_LDV", "FS_LDP"))
    assert len(_banks16(4 * c["FS_LD"] * r for r in range(8))) == 8     # Q rows rg, K keys kg
    assert len(_banks16(4 * c["FS_LDP"] * kg for kg in range(8))) == 8  # P stores, keys kg
    assert len(_banks16(4 * 8 * rg for rg in range(4))) == 4            # P loads, rows 8 rg
    assert len(_banks16(4 * 4 * kg for kg in range(8))) == 8            # V loads, columns 4 kg


# ------------------------------------------------------------------ K6 ---

def _k6_as_the_body_walks(q, k, v, *, batch, frames_q, frames_kv, num_heads,
                          grid: int = 3) -> torch.Tensor:
    """The FMA body on (B*Tq, S, H*d): the (batch row, pair) groups in the
    persistent grid's order (block g takes g, g + grid, ...), each pair's
    frames padded to quads (queries) and to the eight key lanes, quad
    w + 4 i of warp w, lane 8 rg + kg owning rows 4 (w + 4 i) + rg and keys
    kg + 8 j, the padded keys masked, the softmax over all keys, P through
    the warp's [key][4 rg + i] slice, O's columns 4 kg + c + 32 h."""
    c = _consts("temporal_attention.cu", "TF_")
    warps, quad, lanes_k, cols_g = (c["TF_THREADS"] // 32, c["TF_QUAD"], c["TF_KEYS"],
                                    c["TF_COLS"])
    assert (warps, quad, lanes_k, cols_g) == (4, 4, 8, 32)
    bt, s_len, hd = q.shape
    d = hd // num_heads
    sh = s_len * num_heads
    tqp, tkp = -(-frames_q // quad) * quad, -(-frames_kv // lanes_k) * lanes_k
    kj, dh, d_pad = tkp // 8, -(-d // 32), -(-d // 32) * 32
    scale_log2 = d ** -0.5 * math.log2(math.e)
    qp, kp, vp = (x.double().reshape(batch, n, sh, d) for x, n in (
        (q, frames_q), (k, frames_kv), (v, frames_kv)))
    out = torch.full((batch, frames_q, sh, d), math.nan, dtype=torch.float64)
    order = [g for blk in range(grid) for g in range(blk, batch * sh, grid)]
    assert sorted(order) == list(range(batch * sh))
    quads = tqp // quad
    for grp in order:
        b, p = divmod(grp, sh)
        qs = torch.zeros(tqp, d_pad, dtype=torch.float64)
        ks = torch.zeros(tkp, d_pad, dtype=torch.float64)
        vs = torch.zeros(tkp, d_pad, dtype=torch.float64)
        qs[:frames_q, :d], ks[:frames_kv, :d], vs[:frames_kv, :d] = (
            qp[b, :, p], kp[b, :, p], vp[b, :, p])
        seen = []
        for w in range(warps):
            ri = (quads - w + 3) >> 2
            if ri <= 0:
                continue
            rg, kg, i, j = torch.meshgrid(torch.arange(4), torch.arange(8), torch.arange(ri),
                                          torch.arange(kj), indexing="ij")
            rows = 4 * (w + 4 * i[:, 0, :, 0]) + rg[:, 0, :, 0]        # [rg, i]
            keys = kg[0, :, 0, :] + 8 * j[0, :, 0, :]                  # [kg, j]
            seen += rows.flatten().tolist()
            sc = torch.einsum("rid,kjd->rkij", qs[rows], ks[keys])
            sc = sc.masked_fill((keys >= frames_kv)[:, None, :], -math.inf)
            m = sc.amax(-1).amax(1) * scale_log2                      # [rg, i]
            pr = torch.exp2(sc * scale_log2 - m[:, None, :, None])
            inv = 1.0 / pr.sum(-1).sum(1)                              # [rg, i]
            pw = torch.full((tkp, 16), math.nan, dtype=torch.float64)  # [key][4 rg + i]
            pw[keys[None, :, None, :].expand(4, 8, ri, kj).reshape(-1),
               (4 * rg + i).reshape(-1)] = pr.reshape(-1)
            acc = torch.zeros(4, 8, ri, dh, 4, dtype=torch.float64)   # [rg, kg, i, h, c]
            cols = (4 * torch.arange(8)[:, None, None] + 32 * torch.arange(dh)[None, :, None]
                    + torch.arange(4)[None, None, :])                  # [kg, h, c]
            for key in range(frames_kv):
                prow = pw[key, (4 * torch.arange(4)[:, None] + torch.arange(ri)[None, :])]
                acc += prow[:, None, :, None, None] * vs[key, cols][None, :, None]
            for (rgi, ii), row in np.ndenumerate(rows.numpy()):
                if row >= frames_q:
                    continue
                o = acc[rgi, :, ii] * inv[rgi, ii]                     # [kg, h, c]
                keep = cols < d
                out[b, row, p, cols[keep]] = o[keep]
        assert sorted(seen) == list(range(tqp))       # every padded row once
    assert not torch.isnan(out).any()
    return out.reshape(batch * frames_q, s_len, hd)


@pytest.mark.parametrize("b,tq,tkv,s,h,d", [
    (1, 38, 38, 4, 5, 64),     # stage 2's 38 frames
    (2, 25, 25, 3, 5, 64),     # stage 1's 25
    (2, 25, 7, 3, 2, 64),      # Tq != Tkv (the CAM contract)
    (1, 1, 1, 5, 3, 64),       # one frame: one quad, three warps idle
    (1, 64, 64, 2, 2, 32),     # the gate's 64 frames, d = 32
    (1, 64, 41, 2, 2, 96),     # d = 96: three column groups; ragged keys
    (1, 17, 64, 2, 1, 128),    # d = 128: four column groups
    (1, 9, 13, 3, 2, 30),      # d not a multiple of 4 (4-byte copies, scalar stores)
])
def test_temporal_attention_fma_walk_keeps_the_function(b, tq, tkv, s, h, d):
    """K6's FMA body, walked as it walks its operands, gives the plain
    version's output at the gate's edges and head dims."""
    assert fits_temporal_attention(tq, tkv, d)
    rng = np.random.RandomState(15)
    q = t(rng.randn(b * tq, s, h * d))
    k, v = (t(rng.randn(b * tkv, s, h * d)) for _ in range(2))
    kw = dict(batch=b, frames_q=tq, frames_kv=tkv, num_heads=h)
    got = _k6_as_the_body_walks(q, k, v, **kw)
    f64 = _attention_f64(_heads_f64(q, tq, b, h), _heads_f64(k, tkv, b, h),
                         _heads_f64(v, tkv, b, h))               # (B, S, H, Tq, d)
    assert_close(got, f64.permute(0, 3, 1, 2, 4).reshape(b * tq, s, h * d).numpy(), TOL,
                 "K6 walk")
    assert_close(got, temporal_attention_reference(q, k, v, **kw).numpy(), REF_TOL, "K6 ref")


def _k6_smem(c: dict, tq: int, tkv: int, d: int, elem: int) -> int:
    """``TaRows<T>::smem_bytes`` from the source's constants."""
    dp = -(-d // c["TF_COLS"]) * c["TF_COLS"]
    ldq, ldv = dp + c["TF_PAD_BYTES"] // elem, dp
    tqp, tkp = -(-tq // c["TF_QUAD"]) * c["TF_QUAD"], -(-tkv // c["TF_KEYS"]) * c["TF_KEYS"]
    buffer = (tqp + tkp) * ldq + tkp * ldv
    return 2 * buffer * elem + 4 * c["TF_THREADS"] // 32 * tkp * c["TF_LDP"]


def test_temporal_attention_fma_body_fits_shared_memory():
    """Two buffers of one pair's q, k and v and the four warps' P: three
    blocks an SM in f32 at stage 2's (38 frames) and stage 1's (25) level 0,
    one block at the gate's corner (64 frames, d = 128, f32); one load's
    four q rows or eight keys, and a P store's eight keys, in distinct
    16-byte bank groups at every head dim."""
    c = _consts("temporal_attention.cu", "TF_")
    assert (c["TF_THREADS"], c["TF_MAX_T"], c["TF_MAX_D"], c["TF_BLOCKS"]) == (128, 64, 128, 3)
    for tq in (38, 25):
        assert c["TF_BLOCKS"] * (_k6_smem(c, tq, tq, 64, 4) + 1024) <= SMEM_PER_SM
    assert _k6_smem(c, 64, 64, 128, 4) <= SMEM_OPT_IN
    assert _k6_smem(c, 64, 64, 128, 2) <= SMEM_OPT_IN
    assert c["TF_LDP"] >= 16 and len(_banks16(4 * c["TF_LDP"] * kg for kg in range(8))) == 8
    for d in (8, 30, 32, 64, 96, 128):
        for elem in (4, 2):
            dp = -(-d // c["TF_COLS"]) * c["TF_COLS"]
            ldq = dp + c["TF_PAD_BYTES"] // elem
            assert (ldq * elem) % 16 == 0 and (dp * elem) % 16 == 0
            assert len(_banks16(elem * ldq * r for r in range(8))) == 8


def test_bf16_widens_to_f32_by_a_shift():
    """The body widens bf16 to f32 by moving its 16 bits to the top of the
    word (``ld4``): exact, as ``torch``'s widening."""
    x = torch.tensor(np.random.RandomState(16).randn(4096), dtype=torch.bfloat16)
    bits = x.view(torch.int16).numpy().astype(np.uint16).astype(np.uint32) << 16
    assert np.array_equal(bits.view(np.float32), x.float().numpy())


# ----------------------------------------------------------- chip_smoke ---

@pytest.mark.parametrize("name,work,want_ms,by", [
    ("K1 f32 (10, 9216, 64)", ("flash", (10, 1, 9216, 9216, 64)), 3.245, "operations"),
    ("K2 f32 (2, 14400, 5x64)", ("flash", (2, 5, 14400, 14400, 64)), 7.92, "operations"),
    ("K6 f32 (38, 14400, 5x64)", ("ta", (1, 38, 38, 14400, 5, 64)), 0.836, "bytes"),
    ("K6 f32 (50, 9216, 5x64)", ("ta", (2, 25, 25, 9216, 5, 64)), 0.704, "bytes"),
])
def test_chip_smoke_f32_work_counts_at_the_new_timed_shapes(name, work, want_ms, by):
    """The f32 bounds of the timed shapes: K1/K2 4 B H Lq Lk d flops at the
    FP32 rate; K6 q, k, v and o once each in 4-byte values over HBM's rate."""
    kind, args = work
    if kind == "flash":
        got = chip_smoke.work_flash(*args, elem=4)
        batch, heads, lq, lk, d = args
        assert got == (4 * batch * heads * lq * lk * d, 4 * batch * heads * d * 2 * (lq + lk))
    else:
        got = chip_smoke.work_temporal_attention(*args, elem=4)
        b, tq, tkv, s, heads, d = args
        assert got == (4 * b * s * heads * tq * tkv * d, 4 * b * s * heads * d * 2 * (tq + tkv))
    bd = chip_smoke.bound(got, peak_flops=chip_smoke.PEAK_F32_FLOPS)
    assert bd["bound_by"] == by
    assert bd["bound_ms"] == pytest.approx(want_ms, abs=5e-3), name


def test_chip_smoke_times_the_fma_bodies_at_the_main_geometries():
    """K1's f32 D=64 row and K6's f32 rows are keyed to the geometries the
    bf16 rows time (stage 2's and stage 1's level 0 for K6); K6's FMA body
    in bf16 runs at stage 2's level-0 width as 10 heads of 32, bound by the
    same bytes as the bf16 row's 5 heads of 64."""
    assert chip_smoke.K1_F32_PREFIX[(10, 9216, 64)] == "f32_d64_"
    assert chip_smoke.K6_F32_PREFIX == {(1, 38, 14400, 5): "f32_", (2, 25, 9216, 5): "f32_stage1_"}
    b, tq, tkv, s, heads, d = chip_smoke.K6_BF16_FMA_TIMED
    assert d != 64 and fits_temporal_attention(tq, tkv, d) and heads * d == 5 * 64
    work = chip_smoke.work_temporal_attention(b, tq, tkv, s, heads, d)
    assert work[1] == chip_smoke.work_temporal_attention(1, 38, 38, 14400, 5, 64)[1]
    assert chip_smoke.bound(work) == dict(bound_ms=pytest.approx(0.418, abs=5e-4),
                                          bound_by="bytes")


@pytest.mark.parametrize("b,tq,s,heads,d", [(1, 6, 5, 3, 16), (2, 5, 4, 2, 8)])
def test_chip_smoke_k6_views_are_sdpa_over_frames(b, tq, s, heads, d):
    """The SDPA yardstick's strided views of K6's operands, attended and
    mapped back, give K6's plain version: each (pixel, head) pair a head."""
    rng = np.random.RandomState(17)
    q, k, v = (t(rng.randn(b * tq, s, heads * d)) for _ in range(3))
    views, name, unview = chip_smoke._k6_views(q, k, v, b, s, heads, d)
    assert name == ("(S, H, T, D)" if b == 1 else "(B, S*H, T, D)")
    assert all(x.data_ptr() == y.data_ptr() for x, y in zip(views, (q, k, v)))
    got = unview(F.scaled_dot_product_attention(*views))
    ref = temporal_attention_reference(q, k, v, batch=b, frames_q=tq, frames_kv=tq,
                                       num_heads=heads)
    assert_close(got, ref.numpy(), 1e-5, "SDPA view")
