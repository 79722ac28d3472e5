"""PyTorch port: the operand layouts and tile plans of the ``wgmma`` bodies of
K4 (temporal conv) and the flash D=64 body (K1/K2), on the CPU.

The kernels run only on the card; what surrounds them is Python and is
checked here.  Each layout is checked by recomputing the plain function from
the operands as the kernel reads them, walked as the kernel walks them (K4:
one output frame's taps that exist, 64 channels a step; flash: 128-key tiles
with an online softmax and the ragged last tile masked), in f32 against
``temporal_conv_reference`` / ``flash_attention_reference`` within 1e-6 of
max |reference|: the same arithmetic in another order.  K4's tile width is
checked over every shape the main path sends, and the flash body's shared
memory against the card's."""

import math
import re

import numpy as np
import pytest
import torch

import chip_smoke
from _torch_port_helpers import assert_close, t
from streamingt2v_torch.ops import flash_attention as fa, temporal_conv as tc
from streamingt2v_torch.ops._native import CSRC

TOL = 1e-6
# K4's tile rows and channels a contraction step (``TW_BM``, ``TW_BK`` in
# csrc/temporal_conv.cu)
CONV_ROWS, CONV_STEP = 128, 64


def _consts(name: str, prefix: str) -> dict:
    """The integer constants ``prefix*`` of a kernel source (products such as
    ``220 * 1024`` multiplied out)."""
    src = (CSRC / name).read_text()
    found = re.findall(rf"constexpr (?:int|size_t) ({prefix}\w+) = (\d+(?: \* \d+)*);", src)
    return {k: math.prod(int(n) for n in v.split(" * ")) for k, v in found}


# ------------------------------------------------------------------ K4 ---

def _conv_operands(rng, b, t_len, s, c, co, kt, pre, res):
    x = t(rng.randn(b, t_len, s, c))
    w = t(rng.randn(kt, c, co) / np.sqrt(kt * c))
    bias = t(0.1 * rng.randn(co))
    r = t(rng.randn(b, t_len, s, co)) if res else None
    rw = t(rng.rand(b, t_len)) if res else None
    pa = t(1.0 + 0.2 * rng.randn(b, c)) if pre else None
    pb = t(0.2 * rng.randn(b, c)) if pre else None
    return x, w, bias, r, rw, pa, pb


def _conv_as_the_kernel_walks(x8, wk, bias, res, res_w, pa8, pb8, c_out):
    """K4's wgmma body on its operands: output frame t sums, over the taps k
    whose input frame t + k - kt//2 exists and over 64-channel steps, the
    step's x tile times the tap's K-major W rows (transposed), then bias and
    the epilogue."""
    kt, _, c8 = wk.shape
    b, t_len = x8.shape[:2]
    lo = kt // 2
    h = x8 if pa8 is None else torch.nn.functional.silu(
        x8 * pa8[:, None, None, :] + pb8[:, None, None, :])
    out = torch.zeros(x8.shape[:3] + (c_out,))
    for f in range(t_len):
        for k in range(max(0, lo - f), min(kt - 1, t_len - 1 - f + lo) + 1):
            for kc in range(0, c8, CONV_STEP):
                out[:, f] += h[:, f + k - lo, :, kc:kc + CONV_STEP] @ wk[k, :, kc:kc + CONV_STEP].T
    out = out + bias
    if res is not None:
        out = res + res_w[:, :, None, None] * out
    return out


@pytest.mark.parametrize("pre,res", [(False, False), (True, False), (False, True), (True, True)])
@pytest.mark.parametrize("b,t_len,s,c,co,kt", [
    (1, 3, 5, 3, 128, 3),     # the VAE's 3 -> 128 (C padded to 8)
    (1, 3, 5, 128, 3, 3),     # 128 -> 3: C_out odd, not padded
    (2, 1, 4, 72, 40, 3),     # T = 1: only the centre tap
    (1, 2, 6, 136, 24, 3),    # T = 2: the halo is a skipped tap; C over two 64-channel steps
    (1, 4, 3, 12, 5, 5),      # kt = 5
    (2, 3, 4, 16, 8, 1),      # kt = 1
])
def test_temporal_conv_kernel_operands_keep_the_function(b, t_len, s, c, co, kt, pre, res):
    """W repacked tap-major and K-major, (kt, C_out, C8), zero past C, and x,
    pre_a, pre_b zero-padded to C8: the kernel's tile walk over them gives
    the plain version's output."""
    rng = np.random.RandomState(11)
    x, w, bias, r, rw, pa, pb = _conv_operands(rng, b, t_len, s, c, co, kt, pre, res)
    x8, wk, pa8, pb8 = tc.kernel_operands(x, w, pa, pb)
    c8 = -(-c // 8) * 8
    assert x8.shape == (b, t_len, s, c8) and wk.shape == (kt, co, c8) and wk.is_contiguous()
    assert torch.equal(wk[:, :, :c], w.transpose(1, 2)) and float(wk[:, :, c:].abs().sum()) == 0
    assert pa is None or (pa8.shape == (b, c8) and float(pa8[:, c:].abs().sum()) == 0)
    got = _conv_as_the_kernel_walks(x8, wk, bias, r, rw, pa8, pb8, co)
    ref = tc.temporal_conv_reference(x, w, bias, r, rw, pa, pb)
    assert_close(got, ref.numpy(), TOL, "K4 wgmma operands")


# (B, T, S, C, C_out, kt) of every K4 call on the main paths: the stage-1
# UNet and ControlNet levels, the temporal VAE decoder's levels and its 3-channel
# time mix, stage 2's UNet levels at 38 frames and the 2-frame pre-pass
MAIN_PATH_CONVS = [
    (2, 25, 9216, 320, 320, 3), (2, 25, 2304, 640, 640, 3), (2, 25, 576, 1280, 1280, 3),
    (2, 25, 144, 1280, 1280, 3), (2, 7, 576, 1280, 1280, 3), (2, 7, 9216, 320, 320, 3),
    (1, 8, 589824, 128, 128, 3), (1, 8, 147456, 256, 256, 3), (1, 8, 36864, 512, 512, 3),
    (1, 8, 9216, 512, 512, 3), (1, 8, 589824, 3, 3, 3),
    (1, 38, 14400, 320, 320, 3), (1, 38, 3600, 640, 640, 3), (1, 38, 920, 1280, 1280, 3),
    (1, 38, 240, 1280, 1280, 3), (1, 2, 14400, 320, 320, 3)]


@pytest.mark.parametrize("b,t_len,s,c,co,kt", MAIN_PATH_CONVS)
def test_temporal_conv_tile_plan_serves_the_main_path(b, t_len, s, c, co, kt):
    """The bf16 kernel's tile width: one the C entry has an instance for,
    column blocks that cover C_out, and a tile count within the kernel's
    int.  (Each instance's ring fits a block's 227 KB of shared memory by a
    static_assert in the kernel.)"""
    width = tc.conv_tile_cols(co)
    assert width in (320, 128, 64)
    cols = -(-co // width)
    assert (cols - 1) * width < co <= cols * width
    assert cols * -(-s // CONV_ROWS) * t_len * b < 2 ** 31
    assert tc.fits_temporal_conv(t_len, c, co, kt, s=s, batch=b)
    if co % 320 == 0:
        assert width == 320   # every UNet level: one 256 + 64 product per x tile


# --------------------------------------------------------------- flash ---

def _heads_from_storage(flat: torch.Tensor, geo: dict, length: int) -> torch.Tensor:
    """(batch * heads, length, d): head h of batch row b read as the kernel
    reads it, rows at the stride ld = heads * d from element b * length * ld
    + h * d."""
    d = geo["d"]
    ld = geo["heads"] * d
    views = [torch.as_strided(flat, (length, d), (ld, 1), b * length * ld + h * d)
             for b in range(geo["batch"]) for h in range(geo["heads"])]
    return torch.stack(views)


def _flash_as_the_kernel_walks(q, k, v, lk: int, scale: float, bk: int) -> torch.Tensor:
    """The flash body's online softmax over KV tiles of bk keys (zero-filled
    past lk, masked on the last tile only), in log2 units as the kernel
    keeps them."""
    scale_log2 = scale * math.log2(math.e)
    rows = q.shape[:-1]
    mx = torch.full(rows, -math.inf)
    den = torch.zeros(rows)
    acc = torch.zeros(q.shape)
    tiles = -(-lk // bk)
    kp = torch.nn.functional.pad(k, (0, 0, 0, tiles * bk - lk))
    vp = torch.nn.functional.pad(v, (0, 0, 0, tiles * bk - lk))
    for j in range(tiles):
        s = q @ kp[:, j * bk:(j + 1) * bk].transpose(-1, -2)
        if (j + 1) * bk > lk:
            s[..., lk - j * bk:] = -math.inf
        mnew = torch.maximum(mx, s.amax(-1) * scale_log2)
        alpha = torch.exp2(mx - mnew)
        p = torch.exp2(s * scale_log2 - mnew[..., None])
        den = den * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + p @ vp[:, j * bk:(j + 1) * bk]
        mx = mnew
    return acc / den[..., None]


@pytest.mark.parametrize("bh,lq,lk,d", [(3, 77, 77, 64), (2, 130, 145, 64), (2, 200, 256, 64),
                                        (1, 65, 129, 32), (2, 9, 300, 40)])
def test_flash_k1_geometry_and_tile_walk_keep_the_function(bh, lq, lk, d):
    """K1 on (B*H, L, D): the kernel's geometry (one head, rows at the padded
    head dim) read back from the padded operands' storage, walked over
    128-key tiles with the ragged edge masked, gives the plain version's
    output; Lq and Lk not multiples of the tiles."""
    rng = np.random.RandomState(7)
    q, k, v = (t(rng.randn(bh, n, d)) for n in (lq, lk, lk))
    qp, kp, vp = fa.pad_head_dim(q, k, v)
    geo = fa.kernel_geometry(qp.shape, kp.shape)
    assert geo == dict(batch=bh, heads=1, lq=lq, lk=lk, d=64)
    qh, kh, vh = (_heads_from_storage(x.reshape(-1), geo, n)
                  for x, n in ((qp, lq), (kp, lk), (vp, lk)))
    bk = _consts("flash_attention.cu", "FW_")["FW_BK"]
    got = _flash_as_the_kernel_walks(qh, kh, vh, lk, d ** -0.5, bk)[..., :d]
    assert_close(got, fa.flash_attention_reference(q, k, v).numpy(), TOL, "K1 tile walk")


@pytest.mark.parametrize("b,lq,lk,heads", [(2, 70, 145, 5), (1, 129, 64, 2), (3, 40, 200, 1)])
def test_flash_k2_row_stride_keeps_the_function(b, lq, lk, heads):
    """K2 on head-packed (B, L, H*64): each head read at the row stride H*64
    from its column offset, walked as the kernel walks it, gives the packed
    plain version's output (no head-fold transposes)."""
    rng = np.random.RandomState(8)
    d = 64
    q = t(rng.randn(b, lq, heads * d))
    k, v = (t(rng.randn(b, lk, heads * d)) for _ in range(2))
    geo = fa.kernel_geometry(q.shape, k.shape, heads)
    assert geo == dict(batch=b, heads=heads, lq=lq, lk=lk, d=d)
    qh, kh, vh = (_heads_from_storage(x.reshape(-1), geo, n)
                  for x, n in ((q, lq), (k, lk), (v, lk)))
    bk = _consts("flash_attention.cu", "FW_")["FW_BK"]
    got = _flash_as_the_kernel_walks(qh, kh, vh, lk, d ** -0.5, bk)
    got = got.reshape(b, heads, lq, d).transpose(1, 2).reshape(b, lq, heads * d)
    ref = fa.flash_attention_packed_reference(q, k, v, heads)
    assert_close(got, ref.numpy(), TOL, "K2 row stride")


def test_flash_geometry_refuses_other_head_dims():
    with pytest.raises(ValueError, match="head dim"):
        fa.kernel_geometry((1, 8, 128), (1, 8, 128))


def test_flash_wgmma_body_fits_shared_memory():
    """The wgmma D=64 body: two warpgroups of 64 query rows, Q and two stages
    of K and V tiles in the 128-byte swizzle (rows of 128 bytes) and the
    alignment slack fit two blocks an SM (228 KB, 1 KB of it reserved per
    block); the tiles are whole swizzle atoms."""
    const = _consts("flash_attention.cu", "FW_")
    d, bq, bk, stages = const["FW_D"], const["FW_BQ"], const["FW_BK"], const["FW_STAGES"]
    assert (d, const["FW_THREADS"], bq) == (64, 256, 128) and stages >= 2
    assert d * 2 == 128 and (bk * 128) % 1024 == 0 and (bq * 128) % 1024 == 0
    smem = 1024 + bq * 128 + stages * 2 * bk * 128
    assert const["FW_BLOCKS"] * (smem + 1024) <= 233472


def _sw128_off(r: int, c: int) -> int:
    """``common.cuh``'s ``sw128_off``: row r's 16-byte chunk c."""
    return r * 128 + ((c ^ (r & 7)) << 4)


def test_flash_d128_body_layout():
    """The bf16 D=128 body: two warpgroups of 64 query rows, 64-key tiles, Q
    and two stages of K and V tiles as two 64-column blocks of the 128-byte
    swizzle fit two blocks an SM; ``fh_load``'s 256 threads copy every
    16-byte chunk of a tile once, into distinct bytes of the tile; and the k16
    slice kk of S's contraction starts at columns 16 kk of every row."""
    const = _consts("flash_attention.cu", "FH_")
    d, bq, bk, stages = const["FH_D"], const["FH_BQ"], const["FH_BK"], const["FH_STAGES"]
    assert (d, const["FH_THREADS"], bq, bk) == (128, 256, 128, 64) and stages == 2
    smem = 1024 + bq * d * 2 + stages * 2 * bk * d * 2
    assert const["FH_BLOCKS"] * (smem + 1024) <= 233472 and (bk * 128) % 1024 == 0
    for rows in (bq, bk):
        seen = {}
        for tid in range(const["FH_THREADS"]):
            cr, cc = tid >> 4, tid & 15
            for it in range(rows // 16):
                row, chunk = cr + 16 * it, cc
                off = (cc >> 3) * rows * 128 + _sw128_off(cr, cc & 7) + 2048 * it
                assert off == (chunk >> 3) * rows * 128 + _sw128_off(row, chunk & 7)
                seen[(row, chunk)] = off
        assert len(seen) == rows * 16 and len(set(seen.values())) == rows * 16
        assert max(seen.values()) < rows * d * 2
        for kk in range(d // 16):
            start = (kk >> 2) * rows * 128 + 32 * (kk & 3)
            assert start == seen[(0, 2 * kk)]


@pytest.mark.parametrize("bh,lq,lk", [(2, 130, 257), (1, 77, 1), (3, 200, 512)])
def test_flash_d128_tile_walk_keeps_the_function(bh, lq, lk):
    """K1 at bf16 D=128: the geometry the kernel is told (one head, D=128 as
    is), walked over its 64-key tiles with the ragged edge masked, gives the
    plain version's output."""
    rng = np.random.RandomState(9)
    q, k, v = (t(rng.randn(bh, n, 128)) for n in (lq, lk, lk))
    geo = fa.kernel_geometry(q.shape, k.shape, dtype=torch.bfloat16)
    assert geo == dict(batch=bh, heads=1, lq=lq, lk=lk, d=128)
    bk = _consts("flash_attention.cu", "FH_")["FH_BK"]
    got = _flash_as_the_kernel_walks(q, k, v, lk, 128 ** -0.5, bk)
    assert_close(got, fa.flash_attention_reference(q, k, v).numpy(), TOL, "K1 D=128 tile walk")


# ---------------------------------------------------------- chip_smoke ---

def test_chip_smoke_flags_serialized_wgmma():
    """The kernels phase fails on ptxas's note that it serialized a kernel's
    wgmma, and passes other numbered notes."""
    ok = ["ptxas info    : (C7519) warpgroup.arrive is injected in around line 2688"]
    chip_smoke.check_wgmma_notes(ok)
    bad = ok + ["ptxas info    : (C7510) Potential Performance Loss: wgmma.mma_async "
                "instructions are serialized due to the presence of Extern calls"]
    with pytest.raises(AssertionError, match="serialized"):
        chip_smoke.check_wgmma_notes(bad)


def test_chip_smoke_work_counts_for_f32_rows():
    """The f32 rows' bounds are at the card's FP32 rate (67 TFLOP/s outside the
    tensor cores: no TF32), their bytes at 4 a value."""
    work = chip_smoke.work_flash(1, 1, 9216, 9216, 512, elem=4)
    assert work == (4 * 9216 * 9216 * 512, 4 * 4 * 9216 * 512)
    got = chip_smoke.bound(work, peak_flops=chip_smoke.PEAK_F32_FLOPS)
    assert got["bound_by"] == "operations"
    assert got["bound_ms"] == pytest.approx(4 * 9216 * 9216 * 512 / 67e12 * 1e3, rel=1e-9)
