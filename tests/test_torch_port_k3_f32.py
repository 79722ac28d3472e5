"""PyTorch port: K3's f32 body (``geglu_stats_kernel`` and the two passes of
``geglu_f32_gemm_kernel``), on the CPU.

The kernels run only on the card; their arithmetic is checked here by
recomputing the function from the operands as the body reads them, in f64:
the chunks of rows, each row's LN statistics, and for both passes the
tiles in launch order, each step's 16 rows of A staged by the threads that
load them (x normalised on the way, rows past the chunk and the K tail
zero) and of B copied from the wrapper's repack (``fused_ff.f32_operands``,
absent columns zero), every lane's 8 x 8 microtile (rows 4 ty + (i & 3) +
64 (i >> 2), columns 4 tx + (j & 3) + 64 (j >> 2)) and its epilogue.  The
walk reproduces the plain function evaluated in f64 within 1e-6 of max
|reference|, and the JAX ``geglu_ff`` in f32 (interpret mode) and
``geglu_ff_reference`` within 1e-5 (the ops tests' tolerance).  Each walk
also checks that every staged cell is written once a step, that every
(row, G column) and (row, output column) is written exactly once, and that a
lane's a and b columns are those of one G element.  Also: the body's shared
memory and threads read from the source, the f32 chunk plan, and
``chip_smoke``'s f32 work counts at the four timed shapes."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from _torch_port_helpers import assert_close, t
from streamingt2v_tpu.ops.fused_ff import geglu_ff as jax_geglu
from streamingt2v_torch.ops import fused_ff
from streamingt2v_torch.ops._native import CSRC

TOL = 1e-6
REF_TOL = 1e-5    # against the f32 plain versions
SMEM_PER_SM = 233472     # 228 KB, 1 KB of it reserved per block
REGS_PER_SM = 65536


def _consts() -> dict:
    """The integer constants ``GT_*`` of geglu_ff.cu, each an expression of
    integers and the constants before it."""
    src = (CSRC / "geglu_ff.cu").read_text()
    out = {"GW_BM": int(re.search(r"constexpr int GW_BM = (\d+);", src).group(1))}
    for key, expr in re.findall(r"constexpr int (GT_\w+) = ([^;]+);", src):
        out[key] = int(eval(expr, {}, dict(out)))   # noqa: S307 - the repo's own source
    return out


C = _consts()
BM, BN, BK, THREADS = C["GT_BM"], C["GT_BN"], C["GT_BK"], C["GT_THREADS"]

# a lane's microtile: thread tid, warp w, lane l: tx = (w & 1) * 8 + (l & 7),
# ty = (w >> 1) * 4 + (l >> 3)
_TID = np.arange(THREADS)
_TX = (_TID >> 5 & 1) * 8 + (_TID & 31 & 7)
_TY = (_TID >> 5 >> 1) * 4 + ((_TID & 31) >> 3)
_I8 = np.arange(8)
LANE_ROWS = 4 * _TY[:, None] + (_I8 & 3)[None] + 64 * (_I8 >> 2)[None]     # [tid, i]
LANE_COLS = 4 * _TX[:, None] + (_I8 & 3)[None] + 64 * (_I8 >> 2)[None]     # [tid, j]
# A staging: thread tid loads rows tid / 4 (+ 64) at k 4 (tid % 4) .. + 3
_E4 = np.arange(4)
A_ROW = (_TID >> 2)[:, None, None] + 64 * np.arange(2)[None, :, None] + 0 * _E4   # [tid, r, e]
A_K = ((_TID & 3) * 4)[:, None, None] + 0 * A_ROW + _E4                         # its k
A_K0 = ((_TID & 3) * 4)[:, None, None] + 0 * A_ROW                              # the group's first k
# B staging: thread tid copies k rows tid / 32 (+ 8) at columns 4 (tid % 32) .. + 3
B_K = (_TID >> 5)[:, None, None] + 8 * np.arange(2)[None, :, None] + 0 * _E4
B_COL = ((_TID & 31) * 4)[:, None, None] + 0 * B_K + _E4
B_COL0 = ((_TID & 31) * 4)[:, None, None] + 0 * B_K


def test_lane_and_staging_maps_cover_each_tile_cell_once():
    assert (BM, BN, BK, THREADS) == (128, 128, 16, 256)
    assert sorted(set(LANE_ROWS.ravel().tolist())) == list(range(BM))
    assert sorted(set(LANE_COLS.ravel().tolist())) == list(range(BN))
    cells = {(r, c) for tid in range(THREADS) for r in LANE_ROWS[tid] for c in LANE_COLS[tid]}
    assert len(cells) == BM * BN == THREADS * 64          # each output cell one lane's
    assert len(set(zip(A_K.ravel(), A_ROW.ravel()))) == BK * BM == A_K.size
    assert len(set(zip(B_K.ravel(), B_COL.ravel()))) == BK * BN == B_K.size
    # the eight column groups a warp reads lie in 128 consecutive bytes
    for w in range(THREADS // 32):
        assert len({4 * tx for tx in _TX[32 * w:32 * w + 32]}) == 8


def _gelu_f64(b):
    return 0.5 * b * (1.0 + torch.special.erf(b * 2 ** -0.5))


def _geglu_f64(x, w1, b1, w2, b2, lns=None, lnb=None, residual=False):
    """The plain function in f64 (one-pass LN statistics clamped at 0)."""
    x, w1, b1, w2, b2 = (v.double() for v in (x, w1, b1, w2, b2))
    h = x
    if lns is not None:
        mean = x.mean(-1, keepdim=True)
        var = ((x * x).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
        h = (x - mean) / torch.sqrt(var + 1e-5) * lns.double() + lnb.double()
    z = h @ w1.T + b1
    inner = w2.shape[1]
    out = (z[:, :inner] * _gelu_f64(z[:, inner:])) @ w2.T + b2
    return out + x if residual else out


def _core_walk(a, b, bias, rows: int, k: int, ldb: int, n: int, up: bool, inner: int = 0,
               stats=None, lns=None, lnb=None, res=None):
    """One launch of ``geglu_f32_gemm_kernel<up>`` in f64: a (rows, k) row-major,
    b (k, ldb) k-major; returns (out (rows, n), times each cell was written)."""
    assert k % 4 == 0 and ldb % 4 == 0
    out = torch.full((rows, n), float("nan"), dtype=torch.float64)
    writes = torch.zeros((rows, n), dtype=torch.int64)
    col_blocks = -(-ldb // BN)
    steps = -(-k // BK)
    for tile in range(col_blocks * -(-rows // BM)):
        row0, col0 = tile // col_blocks * BM, tile % col_blocks * BN
        acc = torch.zeros(THREADS, 8, 8, dtype=torch.float64)
        for step in range(steps):
            As = torch.full((BK, BM), float("nan"), dtype=torch.float64)
            src_r, src_k = row0 + A_ROW, step * BK + A_K
            ok = (src_r < rows) & (step * BK + A_K0 < k)
            val = torch.zeros(A_ROW.shape, dtype=torch.float64)
            val[ok] = a[src_r[ok], src_k[ok]]
            if up and stats is not None:   # LN as the thread stages it
                ln_ok = ok
                mean, rstd = stats[src_r[ln_ok], 0], stats[src_r[ln_ok], 1]
                val[ln_ok] = (val[ln_ok] - mean) * rstd * lns[src_k[ln_ok]] + lnb[src_k[ln_ok]]
            As[A_K, A_ROW] = val
            Bs = torch.full((BK, BN), float("nan"), dtype=torch.float64)
            src_k = step * BK + B_K
            ok = (col0 + B_COL0 < ldb) & (src_k < k)
            bval = torch.zeros(B_K.shape, dtype=torch.float64)
            bval[ok] = b[src_k[ok], col0 + B_COL[ok]]
            Bs[B_K, B_COL] = bval
            assert not (torch.isnan(As).any() or torch.isnan(Bs).any())   # every cell staged
            acc += torch.einsum("kti,ktj->tij", As[:, LANE_ROWS], Bs[:, LANE_COLS])
        for tid in range(THREADS):
            rws = row0 + LANE_ROWS[tid]
            if up:   # columns j < 4 a, j >= 4 b of G columns gc .. gc + 3
                gc = col0 // 2 + 4 * _TX[tid]
                if gc >= n:
                    continue
                cols = gc + _E4
                g = (acc[tid, :, :4] + bias[cols]) * _gelu_f64(acc[tid, :, 4:] + bias[inner + cols])
                for i in range(8):
                    if rws[i] < rows:
                        out[rws[i], cols] = g[i]
                        writes[rws[i], cols] += 1
            else:
                for h in range(2):
                    co = col0 + 4 * _TX[tid] + 64 * h
                    if co >= n:
                        continue
                    cols = co + _E4
                    for i in range(8):
                        if rws[i] < rows:
                            y = acc[tid, i, 4 * h:4 * h + 4] + bias[cols]
                            out[rws[i], cols] = y if res is None else y + res[rws[i], cols]
                            writes[rws[i], cols] += 1
    return out, writes


def _geglu_f32_as_the_body_runs(x, w1, b1, w2, b2, lns, lnb, residual, chunk_rows):
    """The wrapper's chunks of rows, then per chunk the statistics kernel, the
    up pass into G and the down pass, in f64 on the wrapper's own repack."""
    n, c = x.shape
    c_out, inner = w2.shape
    w1p, w2t = (v.double() for v in fused_ff.f32_operands(w1, w2))
    ldb1 = 2 * -(-inner // 64) * 64
    assert w1p.shape == (c, ldb1) and w2t.shape == (inner, c_out)
    x, b1, b2 = x.double(), b1.double(), b2.double()
    out = torch.full((n, c_out), float("nan"), dtype=torch.float64)
    for start, count in fused_ff.chunk_plan(n, chunk_rows):
        xc = x[start:start + count]
        stats = None
        if lns is not None:   # one-pass statistics clamped at 0, eps 1e-5
            mean = xc.sum(-1) / c
            var = ((xc * xc).sum(-1) / c - mean * mean).clamp_min(0.0)
            stats = torch.stack((mean, 1.0 / torch.sqrt(var + 1e-5)), -1)
        g, gw = _core_walk(xc, w1p, b1, count, c, ldb1, inner, True, inner, stats,
                           None if lns is None else lns.double(),
                           None if lnb is None else lnb.double())
        assert (gw == 1).all()                          # every (row, G column) once
        y, yw = _core_walk(g, w2t, b2, count, inner, c_out, c_out, False,
                           res=xc if residual else None)
        assert (yw == 1).all()                          # every (row, output column) once
        out[start:start + count] = y
    assert not torch.isnan(out).any()
    return out


def _operands(n, c, inner, c_out, ln, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, c).astype(np.float32)
    w1 = (rng.randn(c, 2 * inner) / np.sqrt(c)).astype(np.float32)
    b1 = (rng.randn(2 * inner) * 0.1).astype(np.float32)
    w2 = (rng.randn(inner, c_out) / np.sqrt(inner)).astype(np.float32)
    b2 = (rng.randn(c_out) * 0.1).astype(np.float32)
    lns = (rng.randn(c) * 0.2 + 1.0).astype(np.float32) if ln else None
    lnb = (rng.randn(c) * 0.1).astype(np.float32) if ln else None
    return x, w1, b1, w2, b2, lns, lnb


@pytest.mark.parametrize("n,c,inner,c_out,ln,residual,chunk", [
    (300, 48, 192, 48, True, True, 0),       # ragged rows, C off the tile
    (300, 48, 192, 48, False, False, 0),
    (130, 32, 96, 32, True, False, 0),       # inner off 64: the repack's zero columns
    (129, 48, 160, 136, False, False, 0),    # C_out off the 128-column tile
    (20, 16, 64, 1296, True, False, 0),      # C_out above 1280
    (290, 32, 128, 32, True, True, 128),     # three chunks of rows, the last ragged
])
def test_f32_walk_keeps_the_function(n, c, inner, c_out, ln, residual, chunk):
    x, w1, b1, w2, b2, lns, lnb = _operands(n, c, inner, c_out, ln, seed=n + c)
    args = (t(x), t(w1.T), t(b1), t(w2.T), t(b2), None if lns is None else t(lns),
            None if lnb is None else t(lnb), residual)
    got = _geglu_f32_as_the_body_runs(*args, chunk or n)
    assert_close(got, _geglu_f64(*args), TOL, "K3 f32 walk")
    assert_close(got, fused_ff.geglu_ff_reference(*args), REF_TOL, "K3 f32 walk vs plain")
    ref = jax_geglu(jnp.asarray(x), jnp.asarray(w1), jnp.asarray(b1), jnp.asarray(w2),
                    jnp.asarray(b2), ln_scale=None if lns is None else jnp.asarray(lns),
                    ln_bias=None if lnb is None else jnp.asarray(lnb), residual=residual,
                    block_n=64, block_i=128, interpret=True)
    assert_close(got, ref, REF_TOL, "K3 f32 walk vs Pallas")


@pytest.mark.parametrize("rows,k,cols", [(200, 36, 72), (64, 20, 8), (129, 16, 260)])
def test_f32_core_walk_takes_a_ragged_k_tail(rows, k, cols):
    """The down pass's core alone, A B + bias (+ res), at a K that is not a
    multiple of the 16-deep step and columns off the tile."""
    rng = np.random.RandomState(k)
    a, b = torch.from_numpy(rng.randn(rows, k)), torch.from_numpy(rng.randn(k, cols))
    bias, res = torch.from_numpy(rng.randn(cols)), torch.from_numpy(rng.randn(rows, cols))
    got, writes = _core_walk(a, b, bias, rows, k, cols, cols, False, res=res)
    assert (writes == 1).all()
    assert_close(got, a @ b + bias + res, TOL, "core with a K tail")


@pytest.mark.parametrize("inner,c", [(96, 16), (128, 32), (1280, 320)])
def test_f32_repack_pairs_a_lane_s_a_and_b_columns(inner, c):
    """In W1's repack, a lane's columns j < 4 of every tile are W1 rows g (its
    a slab) and j >= 4 rows inner + g of the same four G columns g; G columns
    past inner are zero columns."""
    w1 = torch.arange(1, 2 * inner + 1, dtype=torch.float32)[:, None].repeat(1, c)
    w1p, w2t = fused_ff.f32_operands(w1, torch.zeros(8, inner))
    assert w1p.is_contiguous() and w2t.shape == (inner, 8) and w2t.is_contiguous()
    assert (w1p == w1p[:1]).all()     # each column one W1 row
    label = w1p[0].long()             # W1 row + 1, or 0 for padding
    seen = []
    for col0 in range(0, w1p.shape[1], BN):
        for tid in range(THREADS):
            for e in range(4):
                g = col0 // 2 + 4 * _TX[tid] + e
                a_row, b_row = label[col0 + LANE_COLS[tid, e]], label[col0 + LANE_COLS[tid, 4 + e]]
                if g < inner:
                    assert (a_row, b_row) == (g + 1, inner + g + 1)
                    seen.append(g)
                else:
                    assert a_row == b_row == 0
    assert sorted(set(seen)) == list(range(inner))


def test_f32_body_fits_two_blocks_an_sm():
    """Shared memory, threads and the 128-register cap of two blocks an SM,
    read from the source; the tile the wrapper's chunk plan counts."""
    smem = 4 * 2 * (BK * C["GT_LDA"] + BK * C["GT_LDB"])
    blocks = C["GT_BLOCKS"]
    assert blocks == fused_ff.F32_BLOCKS == 2
    assert blocks * (smem + 1024) <= SMEM_PER_SM
    assert THREADS * blocks * 128 <= REGS_PER_SM
    assert BM == C["GW_BM"] == fused_ff.ROW_TILE and BN == fused_ff.F32_COLS
    src = (CSRC / "geglu_ff.cu").read_text()
    assert "__launch_bounds__(GT_THREADS, GT_BLOCKS)" in src
    for old in ("geglu_kernel<", "FFLayout", "block_rows", "launch_geglu_f32"):
        assert old not in src
    assert "mma_tile" not in (CSRC / "common.cuh").read_text()


@pytest.mark.parametrize("n,c,c_out", [(460800, 320, 320), (115200, 640, 640),
                                       (28800, 1280, 1280), (547200, 320, 320), (4099, 48, 48),
                                       (2050, 1536, 1536), (300, 320, 2048), (1, 1280, 1280)])
def test_f32_chunk_plan_covers_every_row_once_within_budget(n, c, c_out):
    inner = 4 * c
    rows = fused_ff.chunk_size(n, inner, c_out, 132, elem=4)
    plan = fused_ff.chunk_plan(n, rows)
    seen = np.zeros(n, np.int64)
    for start, count in plan:
        assert 0 < count <= rows
        seen[start:start + count] += 1
    assert (seen == 1).all()
    # one wave of the down pass: two blocks on each of 132 SMs over its 128-column tiles
    wave = 2 * 132 // -(-c_out // 128) * 128
    assert rows * inner * 4 <= max(fused_ff.G_CHUNK_BYTES, wave * inner * 4)
    assert rows == n or rows % wave == 0


@pytest.mark.parametrize("n,c,bound_ms", [(460800, 320, 16.902), (115200, 640, 16.902),
                                          (28800, 1280, 16.902), (547200, 320, 20.072)])
def test_chip_smoke_f32_bounds(n, c, bound_ms):
    b = chip_smoke.bound(chip_smoke.work_geglu(n, c, 4 * c, elem=4), chip_smoke.PEAK_F32_FLOPS)
    assert b["bound_by"] == "operations" and round(b["bound_ms"], 3) == bound_ms
    assert (n, c) in chip_smoke.K3_LEVELS + (chip_smoke.K3_STAGE2,)
