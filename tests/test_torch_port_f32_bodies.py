"""PyTorch port: the f32 bodies of K1/K2 at D=512 (``flash_kernel_f32_d512``)
and of K4 (``temporal_conv_f32_kernel``), on the CPU.

The kernels run only on the card; their arithmetic is checked here by
recomputing the plain function from the operands as each body reads them,
walked as it walks them, against ``flash_attention_reference`` /
``temporal_conv_reference`` (f32) within 1e-6 of max |reference|: the same
sums in another order.  The walks run in f64, so that the tolerance takes
the reference's own f32 rounding and not the walk's (at D=512 the two f32
orders alone differ by about 1e-6).  K1: row blocks of 64 queries, the key
split the wrapper plans, 16-key tiles with the ragged edge masked, S's
512-long contraction in four partial sums added in the kernel's order, the
online softmax in log2 units, then the splits' merge.  K4: the wrapper's padded operands, tiles of
128 positions x 128 output channels, the taps whose input frame exists,
16-channel steps, the prologue once per staged element.  Also: the bodies'
shared memory and thread constants read from the sources, the key split's
waves at the encoder's (1, 9216, 512) on 132 SMs, and ``chip_smoke``'s f32
work counts at the temporal decoder's four widths."""

import math
import re

import numpy as np
import pytest
import torch

import chip_smoke
from _torch_port_helpers import assert_close, t
from streamingt2v_torch.config import PipelineConfig, VAEConfig
from streamingt2v_torch.ops import flash_attention as fa, temporal_conv as tc
from streamingt2v_torch.ops._native import CSRC

TOL = 1e-6
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


# ------------------------------------------------------- K1 f32 D=512 ---

def _flash_f32_as_the_body_walks(q, k, v, lk: int, plan: dict) -> torch.Tensor:
    """The body on (B*H, L, 512): each split of ``plan["tiles_per_split"]``
    16-key tiles runs the online softmax (log2 units, S's contraction as eight
    64-wide partial sums, one a warp, added pairwise, ((p0 + p1) + (p2 + p3))
    + ((p4 + p5) + (p6 + p7)), the keys past lk masked) and leaves its
    unnormalised rows with their max and sum; the merge weighs each split by
    2^(m_s - M)."""
    const = _consts("flash_attention.cu", "FF_")
    bq, bk, parts, d = const["FF_BQ"], const["FF_BK"], const["FF_SPLIT"], const["FF_D"]
    assert (bq, bk) == (fa.F32_ROWS, fa.F32_KEYS)
    scale_log2 = d ** -0.5 * math.log2(math.e)
    q, k, v = (x.double() for x in (q, k, v))
    rows, lq = q.shape[0], q.shape[1]
    tiles = -(-lk // bk)
    kp, vp = (torch.nn.functional.pad(x, (0, 0, 0, tiles * bk - lk)) for x in (k, v))
    out = torch.empty(rows, lq, d, dtype=torch.float64)
    width = d // parts
    for q0 in range(0, lq, bq):   # row blocks; rows past lq are zero-filled and not stored
        qb = torch.nn.functional.pad(q[:, q0:q0 + bq], (0, 0, 0, bq - q[:, q0:q0 + bq].shape[1]))
        ms, ls, accs = [], [], []
        for split in range(plan["splits"]):
            j0 = split * plan["tiles_per_split"]
            j1 = min(tiles, j0 + plan["tiles_per_split"])
            assert j0 < j1   # every split holds a tile
            mx, den, acc = (torch.full((rows, bq), -math.inf, dtype=torch.float64),
                            torch.zeros(rows, bq, dtype=torch.float64),
                            torch.zeros(rows, bq, d, dtype=torch.float64))
            for j in range(j0, j1):
                kt, vt = kp[:, j * bk:(j + 1) * bk], vp[:, j * bk:(j + 1) * bk]
                p = [qb[..., g * width:(g + 1) * width] @ kt[..., g * width:(g + 1) * width]
                     .transpose(-1, -2) for g in range(parts)]
                while len(p) > 1:
                    p = [p[i] + p[i + 1] for i in range(0, len(p), 2)]
                s = p[0] * scale_log2
                s[..., max(0, lk - j * bk):] = -math.inf
                mnew = torch.maximum(mx, s.amax(-1))
                alpha = torch.exp2(mx - mnew)
                pr = torch.exp2(s - mnew[..., None])
                den = den * alpha + pr.sum(-1)
                acc = acc * alpha[..., None] + pr @ vt
                mx = mnew
            ms.append(mx), ls.append(den), accs.append(acc)
        if plan["splits"] == 1:
            o = accs[0] / ls[0][..., None]
        else:
            top = torch.stack(ms).amax(0)
            w = [torch.exp2(m - top) for m in ms]
            o = sum(wi[..., None] * a for wi, a in zip(w, accs)) / sum(
                wi * li for wi, li in zip(w, ls))[..., None]
        n = min(bq, lq - q0)
        out[:, q0:q0 + n] = o[:, :n]
    return out


@pytest.mark.parametrize("bh,lq,lk,sms", [
    (2, 70, 45, 132),     # ragged rows and keys; split over the keys
    (1, 64, 16, 132),     # one row block, one tile
    (3, 130, 200, 1),     # one SM: no split
    (1, 150, 333, 4),     # a few SMs: splits of several tiles, a short last one
])
def test_flash_f32_d512_walk_keeps_the_function(bh, lq, lk, sms):
    """K1 f32 at D=512: the body's row blocks, key split, tiles, split
    contraction, online softmax and merge give the plain version's output."""
    rng = np.random.RandomState(3)
    q, k, v = (t(rng.randn(bh, n, 512)) for n in (lq, lk, lk))
    plan = fa.f32_d512_plan(bh, lq, lk, sms)
    tiles = -(-lk // fa.F32_KEYS)
    assert (plan["splits"] - 1) * plan["tiles_per_split"] < tiles \
        <= plan["splits"] * plan["tiles_per_split"]
    got = _flash_f32_as_the_body_walks(q, k, v, lk, plan)
    assert_close(got, fa.flash_attention_reference(q, k, v).numpy(), TOL, "K1 f32 walk")


@pytest.mark.parametrize("b,lq,lk,heads,splits", [(2, 70, 45, 1, 2), (1, 40, 90, 2, 3)])
def test_flash_f32_d512_packed_rows_keep_the_function(b, lq, lk, heads, splits):
    """K2 f32 at D=512 on head-packed (B, L, H*512): each head read at the row
    stride H*512 from its column offset and walked as the body walks it, with
    its keys split, gives the packed plain version's output."""
    rng = np.random.RandomState(4)
    d = 512
    q = t(rng.randn(b, lq, heads * d))
    k, v = (t(rng.randn(b, lk, heads * d)) for _ in range(2))
    geo = fa.kernel_geometry(q.shape, k.shape, heads)
    assert geo == dict(batch=b, heads=heads, lq=lq, lk=lk, d=d)

    def heads_of(x, length):
        return torch.stack([torch.as_strided(x.reshape(-1), (length, d), (heads * d, 1),
                                             i * length * heads * d + h * d)
                            for i in range(b) for h in range(heads)])

    tiles = -(-lk // fa.F32_KEYS)
    per = -(-tiles // splits)
    plan = dict(splits=-(-tiles // per), tiles_per_split=per)
    got = _flash_f32_as_the_body_walks(heads_of(q, lq), heads_of(k, lk), heads_of(v, lk), lk,
                                       plan)
    got = got.reshape(b, heads, lq, d).transpose(1, 2).reshape(b, lq, heads * d)
    ref = fa.flash_attention_packed_reference(q, k, v, heads)
    assert_close(got, ref.numpy(), TOL, "K2 f32 row stride")


def test_flash_f32_d512_plan_fills_the_waves():
    """At the encoder's (1, 9216, 512) the 144 row blocks are 1.09 waves of 132
    SMs (the second wave 12 blocks); the key split fills at least 95% of its
    waves.  At the decoder chunk's (8, 9216, 512) it fills at least as well as
    no split.  One SM never splits."""
    blocks = -(-9216 // fa.F32_ROWS)
    assert blocks == 144 and blocks / (math.ceil(blocks / 132) * 132) < 0.55
    for rows in (1, 8):
        plan = fa.f32_d512_plan(rows, 9216, 9216, 132)
        n = rows * blocks * plan["splits"]
        assert plan["waves"] == pytest.approx(n / 132)
        assert n / (math.ceil(n / 132) * 132) >= 0.95
        assert plan["splits"] <= fa.F32_MAX_SPLITS
    assert fa.f32_d512_plan(1, 9216, 9216, 132)["splits"] > 1
    assert fa.f32_d512_plan(5, 1000, 1000, 1)["splits"] == 1


def test_flash_f32_d512_body_fits_shared_memory():
    """Q resident (64 rows), one K and one V tile of 16 keys, P and the row
    statistics fit one block an SM, the eight warps' partial score tiles in
    K's place; 256 threads hold a 4 x 8 partial score tile (1.5 bytes loaded
    a FMA: at most 1 keeps the FMA units fed) and 128 output accumulators (8
    x 16: 0.75 bytes a FMA) each."""
    c = _consts("flash_attention.cu", "FF_")
    assert (c["FF_D"], c["FF_THREADS"], c["FF_BQ"], c["FF_BK"]) == (512, 256, 64, 16)
    floats = (c["FF_BQ"] * c["FF_LDQ"] + c["FF_BK"] * c["FF_LDQ"] + c["FF_BK"] * c["FF_LDV"]
              + c["FF_BK"] * c["FF_LDP"] + 3 * c["FF_BQ"])
    assert 4 * floats <= SMEM_OPT_IN and 4 * floats + 1024 <= SMEM_PER_SM
    assert c["FF_SPLIT"] * c["FF_BQ"] * c["FF_BK"] == 4 * 8 * c["FF_THREADS"]
    assert c["FF_SPLIT"] * c["FF_BQ"] * c["FF_BK"] <= c["FF_BK"] * c["FF_LDQ"]
    assert c["FF_BQ"] * c["FF_D"] == 128 * c["FF_THREADS"]
    assert 4 * (4 + 8) / (4 * 8) == 1.5 and 4 * (8 + 16) / (8 * 16) == 0.75
    # 128-bit loads along rows: every row stride a multiple of 4 floats
    assert all(c[key] % 4 == 0 for key in ("FF_LDQ", "FF_LDV", "FF_LDP"))
    # 8 neighbouring Q rows in distinct 4-bank groups
    assert len({(r * c["FF_LDQ"]) % 32 for r in range(8)}) == 8


# ---------------------------------------------------------------- K4 f32 ---

def _conv_operands(rng, b, t_len, s, c, co, kt, pre, res):
    x = t(rng.randn(b, t_len, s, c))
    w = t(rng.randn(kt, c, co) / np.sqrt(kt * c))
    bias = t(0.1 * rng.randn(co))
    r = t(rng.randn(b, t_len, s, co)) if res else None
    rw = t(rng.rand(b, t_len)) if res else None
    pa = t(1.0 + 0.2 * rng.randn(b, c)) if pre else None
    pb = t(0.2 * rng.randn(b, c)) if pre else None
    return x, w, bias, r, rw, pa, pb


def _conv_f32_as_the_body_walks(x4, w4, bias, res, res_w, pa4, pb4, c_out):
    """The f32 body on its operands: per (batch row, output frame, 128
    positions, 128 output channels) tile, the taps whose input frame exists,
    16-channel steps of the staged x (the prologue applied once an element,
    positions past S left zero) times W's rows; then bias and the epilogue
    on the C_out true channels."""
    const = _consts("temporal_conv.cu", "TF_")
    bm, bn, step = const["TF_BM"], const["TF_BN"], const["TF_BK"]
    x4, w4, bias, res, res_w, pa4, pb4 = (None if a is None else a.double() for a in (
        x4, w4, bias, res, res_w, pa4, pb4))
    kt, c4, co4 = w4.shape
    b, t_len, s_len = x4.shape[:3]
    lo = kt // 2
    out = torch.empty(b, t_len, s_len, c_out, dtype=torch.float64)
    for bi in range(b):
        for f in range(t_len):
            for s0 in range(0, s_len, bm):
                for co0 in range(0, c_out, bn):
                    acc = torch.zeros(bm, bn, dtype=torch.float64)
                    for k in range(max(0, lo - f), min(kt - 1, t_len - 1 - f + lo) + 1):
                        for c0 in range(0, c4, step):
                            xs = torch.zeros(bm, step, dtype=torch.float64)
                            part = x4[bi, f + k - lo, s0:s0 + bm, c0:c0 + step]
                            if pa4 is not None:
                                part = torch.nn.functional.silu(
                                    part * pa4[bi, c0:c0 + step] + pb4[bi, c0:c0 + step])
                            xs[:part.shape[0], :part.shape[1]] = part
                            ws = torch.zeros(step, bn, dtype=torch.float64)
                            rows = w4[k, c0:c0 + step, co0:co0 + bn]
                            ws[:rows.shape[0], :rows.shape[1]] = rows
                            acc += xs @ ws
                    n, m = min(bm, s_len - s0), min(bn, c_out - co0)
                    y = acc[:n, :m] + bias[co0:co0 + m]
                    if res is not None:
                        y = res[bi, f, s0:s0 + n, co0:co0 + m] + res_w[bi, f] * y
                    out[bi, f, s0:s0 + n, co0:co0 + m] = y
    return out


@pytest.mark.parametrize("pre,res", [(False, False), (True, False), (False, True), (True, True)])
@pytest.mark.parametrize("b,t_len,s,c,co,kt", [
    (1, 3, 20, 3, 3, 3),        # the decoder's conv_out time mix: C = C_out = 3, padded to 4
    (1, 2, 130, 3, 130, 3),     # 3 -> 130: T = 2 (a skipped tap), S and C_out past a tile
    (1, 3, 9, 20, 3, 3),        # 20 -> 3: C past a 16-channel step, C_out odd
    (2, 1, 7, 36, 40, 3),       # T = 1: the centre tap only
    (1, 4, 5, 12, 5, 5),        # kt = 5
    (1, 3, 6, 16, 8, 1),        # kt = 1
])
def test_temporal_conv_f32_walk_keeps_the_function(b, t_len, s, c, co, kt, pre, res):
    """K4 f32: x, pre_a and pre_b zero-padded to C4 and W to (kt, C4, C_out4),
    walked as the body walks them, give the plain version's output."""
    rng = np.random.RandomState(12)
    x, w, bias, r, rw, pa, pb = _conv_operands(rng, b, t_len, s, c, co, kt, pre, res)
    x4, w4, pa4, pb4 = tc.f32_operands(x, w, pa, pb)
    c4, co4 = -(-c // 4) * 4, -(-co // 4) * 4
    assert x4.shape == (b, t_len, s, c4) and w4.shape == (kt, c4, co4) and w4.is_contiguous()
    assert float(w4[:, c:].abs().sum()) == 0 and float(w4[:, :, co:].abs().sum()) == 0
    assert float(x4[..., c:].abs().sum()) == 0
    assert pa is None or (pa4.shape == (b, c4) and float(pa4[:, c:].abs().sum()) == 0)
    got = _conv_f32_as_the_body_walks(x4, w4, bias, r, rw, pa4, pb4, co)
    ref = tc.temporal_conv_reference(x, w, bias, r, rw, pa, pb)
    assert_close(got, ref.numpy(), TOL, "K4 f32 walk")


def test_temporal_conv_f32_operands_leave_aligned_widths_alone():
    """At widths that are multiples of 4 (every decoder level) nothing is
    padded or copied."""
    x, w, pa = torch.zeros(1, 2, 3, 128), torch.zeros(3, 128, 256), torch.zeros(1, 128)
    x4, w4, pa4, pb4 = tc.f32_operands(x, w, pa, pa)
    assert x4 is x and w4 is w and pa4 is pa and pb4 is pa


def test_temporal_conv_f32_body_fits_shared_memory():
    """Two buffers of a 16-channel step (A transposed with its pad, B) fit two
    blocks an SM; 256 threads tile 128 x 128 outputs 8 x 8 each."""
    c = _consts("temporal_conv.cu", "TF_")
    assert (c["TF_THREADS"], c["TF_BM"], c["TF_BN"], c["TF_BK"]) == (256, 128, 128, 16)
    smem = 4 * 2 * (c["TF_BK"] * c["TF_LDA"] + c["TF_BK"] * c["TF_LDB"])
    assert c["TF_BLOCKS"] * (smem + 1024) <= SMEM_PER_SM
    assert c["TF_BM"] * c["TF_BN"] == 64 * c["TF_THREADS"]
    assert c["TF_LDA"] % 4 == 0 and c["TF_LDB"] % 4 == 0


# ----------------------------------------------------------- chip_smoke ---

def test_chip_smoke_f32_shapes_are_the_stage1_vaes():
    """The timed f32 K4 shapes are the temporal decoder's four levels on one
    8-frame chunk at 576x1024 (C = the level's width), and the f32 K1 shapes
    the encoder's and the decoder's mid attention at its 72x128 bottleneck."""
    vae, cfg = VAEConfig(), PipelineConfig()
    chunk = cfg.inference.decode_chunk_size
    h, w = cfg.height, cfg.width
    levels = {((h >> i) * (w >> i), vae.ch * m) for i, m in enumerate(vae.ch_mult)}
    assert {(s, c) for _, _, s, c, _ in chip_smoke.K4_F32_DECODER} == levels
    assert all((b, t_len, c) == (1, chunk, co) for b, t_len, _, c, co in
               chip_smoke.K4_F32_DECODER)
    bottleneck = (h >> (len(vae.ch_mult) - 1)) * (w >> (len(vae.ch_mult) - 1))
    assert chip_smoke.K1_F32_TIMED == ((1, bottleneck), (chunk, bottleneck))


@pytest.mark.parametrize("s,c", [(9216, 512), (36864, 512), (147456, 256), (589824, 128)])
def test_chip_smoke_f32_work_counts_at_the_decoder_widths(s, c):
    """K4 f32 at a decoder level: 2 * rows * C * C_out * kt flops over 4-byte
    values (bare: x read, out written; pre+res: also res, the affine and
    res_w); bound at the FP32 rate, by the operations."""
    rows, kt = 8 * s, 3
    flops = 2 * rows * c * c * kt
    bare = chip_smoke.work_temporal_conv(1, 8, s, c, c, res=False, pre=False, elem=4)
    assert bare == (flops, 4 * (rows * c + kt * c * c + rows * c) + 4 * c)
    full = chip_smoke.work_temporal_conv(1, 8, s, c, c, elem=4)
    assert full == (flops, 4 * (rows * c + kt * c * c + 2 * rows * c) + 4 * (c + 2 * c + 8))
    for work in (bare, full):
        got = chip_smoke.bound(work, peak_flops=chip_smoke.PEAK_F32_FLOPS)
        assert got["bound_by"] == "operations"
        assert got["bound_ms"] == pytest.approx(flops / 67e12 * 1e3, rel=1e-12)
    if s == 589824:   # the top level: 6.923 ms at the FP32 rate
        assert chip_smoke.bound(bare, chip_smoke.PEAK_F32_FLOPS)["bound_ms"] == \
            pytest.approx(6.923, abs=5e-4)


def test_chip_smoke_counts_f32_launches_apart():
    """K1, K2, K4, K6, K5's affine entry and K7's two entries count their
    f32 launches apart: the launch reader adds them (``<name>_f32``) only
    when asked, the reset zeroes them, and the kernels line carries them as
    ``launches_f32`` on those seven rows only."""
    from streamingt2v_torch.utils.profiling import LAUNCHES, count

    chip_smoke._reset_launches()
    for name, n in (("flash_attention", 3), ("flash_attention_packed", 5),
                    ("temporal_conv", 7), ("fused_temporal_attention", 9),
                    ("fused_group_norm_affine", 11), ("layer_norm", 13), ("rms_norm", 15)):
        count(LAUNCHES + name + "_f32", n)
    got = chip_smoke._read_launches(f32=True)
    assert {k: got[k] for k in chip_smoke.F32_COUNTED} == {
        "flash_attention_f32": 3, "flash_attention_packed_f32": 5, "temporal_conv_f32": 7,
        "fused_temporal_attention_f32": 9, "fused_group_norm_affine_f32": 11,
        "layer_norm_f32": 13, "rms_norm_f32": 15}
    assert set(chip_smoke._read_launches()) == set(chip_smoke.KERNEL_META)
    lines = {line["name"]: line for line in chip_smoke.kernel_lines(
        {}, {**dict.fromkeys(chip_smoke.KERNEL_META, 1), **got},
        dict.fromkeys(chip_smoke.KERNEL_META, 0))}
    assert [n for n, line in lines.items() if "launches_f32" in line] == [
        "flash_attention", "flash_attention_packed", "temporal_conv", "fused_temporal_attention",
        "fused_group_norm_affine", "layer_norm", "rms_norm"]
    assert lines["temporal_conv"]["launches_f32"] == 7
    chip_smoke._reset_launches()
    assert not any(chip_smoke._read_launches(f32=True).values())
