"""PyTorch port: the entry points' device default, the bounds and work counts
that ``chip_smoke.py`` reports beside each kernel, its ptxas summary, and the
Python-side layout work of the rebuilt K1/K2 and K4 wrappers against the
plain versions on the CPU.

Work counts are checked against hand-worked numbers for each kernel's timed
main-path shape (flops of the matrix products; each input byte read once and
each output byte written once).  The layout tests compare in f32 at 1e-5 of
max |reference| (the same arithmetic, padded with zeros)."""

import dataclasses
import inspect
import re

import numpy as np
import pytest
import torch

import chip_smoke
from _torch_port_helpers import assert_close, t
from streamingt2v_torch.config import EnhanceConfig, PipelineConfig, VAEConfig
from streamingt2v_torch.models.clip import CLIPVisionConfig
from streamingt2v_torch.models.clip_text import CLIPTextConfig
from streamingt2v_torch.models.enhance.unet import I2VGenXLUNetConfig
from streamingt2v_torch.ops import fused_ff
from streamingt2v_torch.ops._native import CSRC, aligned
from streamingt2v_torch.ops.flash_attention import flash_attention, pad_head_dim
from streamingt2v_torch.ops import fused_group_norm as gn
from streamingt2v_torch.ops.fused_group_norm import MAX_CHANNELS, SMEM_LIMIT, launch_plan
from streamingt2v_torch.ops.temporal_conv import kernel_operands, temporal_conv_reference
from streamingt2v_torch.pipeline import build

TOL = 1e-5
REPO = CSRC.parent.parent


# ------------------------------------------------------- device default ---

def _tiny_enhance_kwargs() -> dict:
    return dict(unet=I2VGenXLUNetConfig.tiny(),
                vae=dataclasses.replace(VAEConfig.tiny(), temporal_decoder=False),
                clip_vision=CLIPVisionConfig.tiny(),
                text=CLIPTextConfig(vocab_size=514, width=32, layers=1, heads=2, max_length=8),
                tokenizer_length=8)


def _modules(models) -> list:
    """The modules of a models dataclass."""
    return [getattr(models, f.name) for f in dataclasses.fields(models)
            if isinstance(getattr(models, f.name), torch.nn.Module)]


def _product_modules(pipe) -> list:
    return _modules(pipe.stage1.models) + _modules(pipe.enhance.m) + [pipe.interpolate.model]


BUILDERS = {
    "build_models": lambda: _modules(build.build_models(PipelineConfig.tiny())),
    "build_pipeline": lambda: _modules(build.build_pipeline(PipelineConfig.tiny()).models),
    "build_enhance_models": lambda: _modules(build.build_enhance_models(**_tiny_enhance_kwargs())),
    "build_enhance": lambda: _modules(build.build_enhance(EnhanceConfig(),
                                                          **_tiny_enhance_kwargs()).m),
    "build_interpolate": lambda: [build.build_interpolate(PipelineConfig.tiny()).model],
    "build_product": lambda: _product_modules(build.build_product(PipelineConfig.tiny())),
}


@pytest.mark.parametrize("name", list(BUILDERS))
def test_builders_default_to_the_card(name):
    """Called without ``device``, a builder puts its modules on the card;
    without a card it raises instead of building on the CPU."""
    fn = getattr(build, name)
    if name != "build_enhance":
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            BUILDERS[name]()
        return
    devices = {p.device.type for m in BUILDERS[name]() for p in m.parameters()}
    assert devices == {"cuda"}


# ------------------------------------------------------ bounds and work ---

@pytest.mark.parametrize("work,flops,nbytes", [
    # K1 (250, 9216, 64): 4 B*L^2*D; q, k, v read and o written in bf16
    (chip_smoke.work_flash(250, 1, 9216, 9216, 64),
     4 * 250 * 9216 * 9216 * 64, 4 * 250 * 9216 * 64 * 2),
    # K2 (38, 14400, 5 x 64)
    (chip_smoke.work_flash(38, 5, 14400, 14400, 64),
     4 * 38 * 5 * 14400 * 14400 * 64, 4 * 38 * 14400 * 320 * 2),
    # K2 cross-attention: 145 keys
    (chip_smoke.work_flash(38, 5, 14400, 145, 64),
     4 * 38 * 5 * 14400 * 145 * 64, (2 * 38 * 14400 + 2 * 38 * 145) * 320 * 2),
    # K3 x (460800, 320), inner 1280: x @ (320, 2560), then (., 1280) @ (1280, 320)
    (chip_smoke.work_geglu(460800, 320, 1280),
     2 * 460800 * 320 * 2560 + 2 * 460800 * 1280 * 320,
     2 * (2 * 460800 * 320 + 320 * 2560 + 1280 * 320) + 4 * (2560 + 320 + 2 * 320)),
    # K3 level 1, x (115200, 640), inner 2560: the same 1.13 TFLOP
    (chip_smoke.work_geglu(115200, 640, 2560),
     2 * 115200 * 640 * 5120 + 2 * 115200 * 2560 * 640,
     2 * (2 * 115200 * 640 + 640 * 5120 + 2560 * 640) + 4 * (5120 + 640 + 2 * 640)),
    # K3 level 2, x (28800, 1280), inner 5120
    (chip_smoke.work_geglu(28800, 1280, 5120),
     2 * 28800 * 1280 * 10240 + 2 * 28800 * 5120 * 1280,
     2 * (2 * 28800 * 1280 + 1280 * 10240 + 5120 * 1280) + 4 * (10240 + 1280 + 2 * 1280)),
    # K4 (2, 25, 9216, 320) -> 320, kt 3, prologue and residual epilogue
    (chip_smoke.work_temporal_conv(2, 25, 9216, 320, 320),
     2 * 460800 * 320 * 320 * 3,
     2 * (460800 * 320 + 3 * 320 * 320 + 2 * 460800 * 320) + 4 * (320 + 2 * 2 * 320 + 2 * 25)),
    # K4 bare (what one conv3d computes)
    (chip_smoke.work_temporal_conv(1, 38, 14400, 320, 320, res=False, pre=False),
     2 * 547200 * 320 * 320 * 3, 2 * (547200 * 320 + 3 * 320 * 320 + 547200 * 320) + 4 * 320),
    # K5 (38, 14400, 320): read once, write once
    (chip_smoke.work_group_norm(38, 14400, 320), 0, 2 * 2 * 38 * 14400 * 320 + 8 * 320),
    # K6 (38 frames, 14400 pixels, 5 x 64): q, k, v, o once
    (chip_smoke.work_temporal_attention(1, 38, 38, 14400, 5, 64),
     4 * 14400 * 5 * 38 * 38 * 64, 4 * 38 * 14400 * 320 * 2),
    # K6 at stage 1 (2 x 25 frames, 9216 pixels, 5 x 64)
    (chip_smoke.work_temporal_attention(2, 25, 25, 9216, 5, 64),
     4 * 2 * 9216 * 5 * 25 * 25 * 64, 4 * 2 * 25 * 9216 * 320 * 2),
    # flash D=512: stage 1's VAE decoder (8 frames of 9216 tokens), stage 2's
    # SD VAE decode (2 frames of 14400) and encode (4 frames) chunks
    (chip_smoke.work_flash(8, 1, 9216, 9216, 512),
     4 * 8 * 9216 * 9216 * 512, 4 * 8 * 9216 * 512 * 2),
    (chip_smoke.work_flash(2, 1, 14400, 14400, 512),
     4 * 2 * 14400 * 14400 * 512, 4 * 2 * 14400 * 512 * 2),
    (chip_smoke.work_flash(4, 1, 14400, 14400, 512),
     4 * 4 * 14400 * 14400 * 512, 4 * 4 * 14400 * 512 * 2),
    # K5 at the SD VAE's top level (2 frames, 720x1280, 128 channels)
    (chip_smoke.work_group_norm(2, 921600, 128), 0, 2 * 2 * 2 * 921600 * 128 + 8 * 128),
])
def test_chip_smoke_work_counts(work, flops, nbytes):
    assert work == (flops, nbytes)


@pytest.mark.parametrize("work,bound_ms,bound_by", [
    ((989e12, 1.0), 1000.0, "operations"),       # one second of tensor-core peak
    ((0, 3.35e12), 1000.0, "bytes"),              # one second of HBM3
    ((989e9, 6.7e9), 2.0, "bytes"),               # 1 ms of flops, 2 ms of bytes
    (chip_smoke.work_flash(250, 1, 9216, 9216, 64), 5.435817984e12 / 989e12 * 1e3,
     "operations"),
    (chip_smoke.work_group_norm(38, 14400, 320), 700418560 / 3.35e12 * 1e3, "bytes"),
    # the D=512 rows: 1.3915 and 0.8493 TFLOP of products; 75 and 59 MB
    (chip_smoke.work_flash(8, 1, 9216, 9216, 512), 1.391569403904e12 / 989e12 * 1e3,
     "operations"),
    (chip_smoke.work_flash(2, 1, 14400, 14400, 512), 8.49346560e11 / 989e12 * 1e3,
     "operations"),
    (chip_smoke.work_group_norm(2, 921600, 128), 943719424 / 3.35e12 * 1e3, "bytes"),
])
def test_chip_smoke_bound(work, bound_ms, bound_by):
    got = chip_smoke.bound(work)
    assert got["bound_by"] == bound_by
    assert got["bound_ms"] == pytest.approx(bound_ms, rel=1e-4)


def test_chip_smoke_yardstick_share():
    rec = chip_smoke._yardstick(dict(ms=10.0), (989e10, 0))
    assert rec["bound_ms"] == pytest.approx(10.0) and rec["share"] == pytest.approx(1.0)


def test_chip_smoke_ptxas_summary_names_each_kernel():
    log = ("ptxas info    : Compiling entry function '_ZN4st2v25temporal_conv_bf16_kernelILi3EEEv"
           "PK13__nv_bfloat16S3_PKfS5_S5_S3_S5_PS1_iiii' for 'sm_90a'\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
           "ptxas info    : Used 220 registers, used 1 barriers\n"
           "ptxas info    : Compiling entry function '_ZN4st2v21flash_kernel_bf16_d64EPK13__nv_"
           "bfloat16S2_S2_PS0_iiiif' for 'sm_90a'\n"
           "    0 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads\n"
           "ptxas info    : Used 226 registers, used 1 barriers\n")
    assert chip_smoke._ptxas_summary(log) == [
        "temporal_conv_bf16_kernel<Li3E>: 220 registers, 0 bytes stack frame, "
        "0 bytes spill stores, 0 bytes spill loads",
        "flash_kernel_bf16_d64: 226 registers, 0 bytes stack frame, 4 bytes spill stores, "
        "4 bytes spill loads"]


def test_chip_smoke_ptxas_summary_keeps_numbered_notes():
    """ptxas's numbered notes on a kernel's code (an injected
    ``warpgroup.arrive``, serialized ``wgmma``) pass through as they are and
    are not read as a kernel's register line."""
    note = ("ptxas info    : (C7519) warpgroup.arrive is injected in around line 2688 by "
            "compiler to allow use of registers in GMMA in function '_ZN4st2v22flash_kernel_"
            "bf16_d512EPK13__nv_bfloat16S2_S2_PS0_iiiif'")
    log = (note + "\n"
           "ptxas info    : Compiling entry function '_ZN4st2v22flash_kernel_bf16_d512EPK13__nv_"
           "bfloat16S2_S2_PS0_iiiif' for 'sm_90a'\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
           "ptxas info    : Used 250 registers, used 1 barriers\n")
    assert chip_smoke._ptxas_summary(log) == [
        note, "flash_kernel_bf16_d512: 250 registers, 0 bytes stack frame, 0 bytes spill "
              "stores, 0 bytes spill loads"]


def test_chip_smoke_kernel_lines_carry_every_field():
    """Every row of the kernels JSON line has the keys the check reads; the
    D=512 instances have rows of their own with their D=512 launches, their
    SDPA backend and (K2) the encode chunk's numbers; K5's row carries the
    SD VAE's shape; K7's names the JAX package's XLA ``layer_norm``, which it
    replaces, and so does its RMS entry's (the JAX package has no RMSNorm;
    the entry shares K7's body); every row carries the product phase's launches apart,
    and those of any other phase given (the apm and samplers phases)."""
    rec = dict(ms=2.0, plain_ms=9.0, bound_ms=1.0, bound_by="operations", library_ms=4.0,
               share=0.5, max_abs_err=1e-3)
    records = {name: dict(rec) for name in chip_smoke.KERNEL_META}
    records["flash_attention_d512"]["sdpa_backend"] = "EFFICIENT_ATTENTION"
    records["flash_attention_packed_d512"].update(b4_ms=3.0, b4_share=0.6)
    records["fused_group_norm"].update(vae_ms=0.6, vae_bound_ms=0.28, vae_share=0.47)
    launches = {name: i + 1 for i, name in enumerate(chip_smoke.KERNEL_META)}
    product = {name: 10 * n for name, n in launches.items()}
    apm = {name: 100 * n for name, n in launches.items()}
    lines = chip_smoke.kernel_lines(records, launches, product, {"apm": apm})
    by_name = {line["name"]: line for line in lines}
    assert {"flash_attention_d512", "flash_attention_packed_d512"} <= set(by_name)
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms"}
    for line in lines:
        assert keys <= set(line) and line["route"] == "cuda"
        assert line["launches"] == launches[line["name"]]
        assert line["product_launches"] == product[line["name"]]
        assert line["apm_launches"] == apm[line["name"]]
        assert (REPO / line["source"]).exists()
        # the Pallas kernel's def line; K7's, the XLA function it replaces
        path, lineno = line["replaces"].split(":")
        want = "def layer_norm(" if line["name"] in ("layer_norm", "rms_norm") else "def _"
        assert (REPO / path).read_text().splitlines()[int(lineno) - 1].startswith(want)
    assert by_name["flash_attention_d512"]["sdpa_backend"] == "EFFICIENT_ATTENTION"
    assert by_name["flash_attention_packed_d512"]["b4_share"] == 0.6
    assert by_name["fused_group_norm"]["vae_share"] == 0.47
    # no record: every number null, the row still there
    empty = chip_smoke.kernel_lines({}, launches, product)
    assert all(line["ms"] is None and line["bound_ms"] is None for line in empty)


def test_chip_smoke_counts_d512_launches_apart():
    """The flash wrappers count their D=512 launches apart; the launch
    reader reports them under ``<name>_d512`` and the reset zeroes them."""
    from streamingt2v_torch.utils.profiling import LAUNCHES, count

    chip_smoke._reset_launches()
    count(LAUNCHES + "flash_attention_d512", 3)
    count(LAUNCHES + "flash_attention_packed_d512", 5)
    got = chip_smoke._read_launches()
    assert got["flash_attention_d512"] == 3 and got["flash_attention_packed_d512"] == 5
    assert set(got) == set(chip_smoke.KERNEL_META)
    chip_smoke._reset_launches()
    assert all(v == 0 for v in chip_smoke._read_launches().values())


def test_chip_smoke_product_check_leaves_out_the_d128_body():
    """The product, loader and mesh runs run no 128-wide head and no
    RMSNorm: their launch check takes K1's D=128 row and K7's RMS entry out
    of what must launch, and no other."""
    from types import SimpleNamespace

    cfg = SimpleNamespace(enhance=SimpleNamespace(chunk_size=24), use_randomized_blending=True,
                          stage1_frames=16)
    launches = {**dict.fromkeys(chip_smoke.KERNEL_META, 1), "flash_attention_d128": 0,
                "rms_norm": 0}
    chip_smoke._check_product_launches(cfg, launches, "the product")
    for name in chip_smoke.KERNEL_META:
        if name not in ("flash_attention_d128", "rms_norm"):
            with pytest.raises(AssertionError, match=name):
                chip_smoke._check_product_launches(cfg, {**launches, name: 0}, "the product")


def test_chip_smoke_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the script would run")
    assert chip_smoke.main(["--phases", "card"]) == 2


# ------------------------------------------------- K4 operand layout ---

@pytest.mark.parametrize("pre", [False, True])
@pytest.mark.parametrize("res", [False, True])
@pytest.mark.parametrize("c,co,kt", [(3, 3, 3), (12, 5, 3), (16, 24, 1), (3, 8, 5)])
def test_temporal_conv_kernel_operands_keep_the_function(c, co, kt, pre, res):
    """The zero padding of C (x, pre_a, pre_b, W's rows) and W repacked
    tap-major and K-major, (kt, C_out, C8), change nothing in the plain
    version's output."""
    rng = np.random.RandomState(5)
    b, t_len, s = 2, 4, 9
    x = t(rng.randn(b, t_len, s, c))
    w = t(rng.randn(kt, c, co) / np.sqrt(kt * c))
    bias = t(0.1 * rng.randn(co))
    r = t(rng.randn(b, t_len, s, co)) if res else None
    rw = t(rng.rand(b, t_len)) if res else None
    pa = t(1.0 + 0.2 * rng.randn(b, c)) if pre else None
    pb = t(0.2 * rng.randn(b, c)) if pre else None
    xp, wp, pap, pbp = kernel_operands(x, w, pa, pb)
    c8 = -(-c // 8) * 8
    assert xp.shape == (b, t_len, s, c8) and wp.shape == (kt, co, c8) and wp.is_contiguous()
    assert pre is False or (pap.shape == (b, c8) and pbp.shape == (b, c8))
    assert float(wp[:, :, c:].abs().sum()) == 0.0
    ref = temporal_conv_reference(x, w, bias, r, rw, pa, pb)
    got = temporal_conv_reference(xp, wp.transpose(1, 2).contiguous(), bias, r, rw, pap, pbp)
    assert_close(got, ref.numpy(), TOL, "padded K4 operands")


def test_temporal_conv_kernel_operands_leave_aligned_widths_alone():
    x, w = torch.zeros(1, 2, 3, 320), torch.zeros(3, 320, 640)
    pa = torch.zeros(1, 320)
    xp, wp, pap, pbp = kernel_operands(x, w, pa, pa)
    assert xp is x and pap is pa and pbp is pa
    assert torch.equal(wp, w.transpose(1, 2))   # repacked (kt, C_out, C), not padded


def test_temporal_conv_operands_off_16_bytes_are_copied():
    """The bf16 kernel loads 16 bytes at a time: an operand whose data starts
    off a 16-byte boundary is copied (same values), an aligned one is not."""
    base = torch.arange(40, dtype=torch.bfloat16)
    aligned_part, off = base[:32], base[1:33]
    assert aligned_part.data_ptr() % 16 == 0 and off.data_ptr() % 16 == 2
    assert aligned(aligned_part) is aligned_part and aligned(None) is None
    moved = aligned(off)
    assert moved.data_ptr() % 16 == 0 and torch.equal(moved, off)


# ------------------------------------------------------ K3 row chunks ---

def test_geglu_row_tile_is_the_kernels():
    """The chunk plan counts in the GEMM core's tile rows (``GW_BM`` in
    ``geglu_ff.cu``)."""
    src = (CSRC / "geglu_ff.cu").read_text()
    assert int(re.search(r"constexpr int GW_BM = (\d+);", src).group(1)) == fused_ff.ROW_TILE


@pytest.mark.parametrize("c_out,cols", [(320, 320), (640, 320), (1280, 320), (48, 64),
                                        (8, 64)])
def test_geglu_down_pass_tile_width(c_out, cols):
    """The down pass takes 320 output columns a block at the UNet widths
    (G read once per row tile), 64 elsewhere; the C entry has an instance for
    each and takes nothing else."""
    assert fused_ff.down_cols(c_out) == cols
    src = (CSRC / "geglu_ff.cu").read_text()
    assert "down_cols == 320" in src and "down_cols == 64" in src


# ------------------------------------------------ K1 head-dim padding ---

def _attention_scaled(q, k, v, scale):
    p = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) * scale, dim=-1)
    return torch.matmul(p, v)


@pytest.mark.parametrize("bh,lq,lk,d", [(3, 25, 7, 32), (2, 130, 145, 40), (1, 65, 63, 64)])
def test_flash_head_dim_padding_keeps_the_function(bh, lq, lk, d):
    """Zero-padded head dims (what the bf16 D=64 kernel runs) give the same
    attention under the true head dim's scale, at ragged q and kv lengths;
    the padded output columns are zero."""
    rng = np.random.RandomState(6)
    q, k, v = (t(rng.randn(bh, n, d)) for n in (lq, lk, lk))
    qp, kp, vp = pad_head_dim(q, k, v)
    assert qp.shape[-1] == 64 and kp.shape == (bh, lk, 64) and vp.shape == (bh, lk, 64)
    got = _attention_scaled(qp, kp, vp, d ** -0.5)
    assert float(got[..., d:].abs().sum()) == 0.0
    assert_close(got[..., :d], flash_attention(q, k, v).numpy(), TOL, "padded K1 operands")


# ----------------------------------------------------- K5 launch plan ---

@pytest.mark.parametrize("n,l,c,itemsize", [
    (38, 14400, 320, 2), (38, 3600, 640, 2), (38, 920, 1280, 2), (38, 240, 1280, 2),  # UNet
    (2, 921600, 128, 2), (2, 230400, 256, 2), (2, 57600, 512, 2), (4, 14400, 512, 2),  # SD VAE
    (1, 1, 4096, 2), (1, 7, 4096, 4), (3, 48, 64, 4), (2, 16, 32, 4), (5, 1000, 8, 2)])
def test_group_norm_plan_covers_every_row_and_channel_once(n, l, c, itemsize):
    """Thread (slot s, vector v) of block (chunk, n) takes channels
    [v*VEC, v*VEC + VEC) of rows chunk*rows_per_chunk + s, + 2s, ... of its
    chunk: every (row, channel vector) once; the block stays within the
    kernel's thread cap and the card's shared memory."""
    _check_plan(launch_plan(n, l, c, itemsize), l, c, itemsize)


def _check_plan(plan, l: int, c: int, itemsize: int) -> None:
    vec = 16 // itemsize
    assert plan.vectors * vec == c and plan.threads == plan.vectors * plan.slots
    assert 32 <= plan.threads <= MAX_CHANNELS // vec
    assert plan.smem_bytes == 12 * plan.slots * c <= SMEM_LIMIT
    assert plan.rows_per_chunk % plan.slots == 0
    assert (plan.chunks - 1) * plan.rows_per_chunk < l <= plan.chunks * plan.rows_per_chunk
    seen = np.zeros((l, plan.vectors), np.uint8)
    for chunk in range(plan.chunks):
        r0, r1 = chunk * plan.rows_per_chunk, min(l, (chunk + 1) * plan.rows_per_chunk)
        for slot in range(plan.slots):
            seen[r0 + slot:r1:plan.slots] += 1   # all of the slot's vectors
    assert (seen == 1).all()


@pytest.mark.parametrize("n,l,c,itemsize", [
    *((n, l, c, size) for n, l, c, *_ in chip_smoke.k4_prologue_geometries() for size in (2, 4)),
    (1, 1, 4096, 2), (1, 7, 4096, 4), (3, 48, 64, 4), (2, 16, 32, 4), (5, 1000, 8, 2)])
def test_group_norm_affine_plan_covers_every_row_and_channel_once(n, l, c, itemsize):
    """The affine entry's pass 1 walks its rows as K5's pass 1 does, every
    (row, channel vector) once, in about one wave of blocks (``_AFFINE_BLOCKS``)
    where the rows are long enough, whatever N is; K5's own plan is the one
    it was."""
    plan = gn.affine_launch_plan(n, l, c, itemsize)
    _check_plan(plan, l, c, itemsize)
    k5 = launch_plan(n, l, c, itemsize)
    assert (plan.slots, plan.threads) == (k5.slots, k5.threads)
    assert plan.chunks <= gn._AFFINE_BLOCKS
    if l >= plan.slots * gn._AFFINE_BLOCKS:   # rows enough for a wave of blocks
        assert 0.9 * gn._AFFINE_BLOCKS <= n * plan.chunks <= gn._AFFINE_BLOCKS + n
    assert k5 == gn._plan(n, l, c, itemsize, 1024, 256)


def test_group_norm_thread_cap_is_the_kernels():
    """The plan's thread cap (one row slot of the widest row) is the kernel's
    ``GN_MAX_C``."""
    src = (CSRC / "fused_group_norm.cu").read_text()
    assert int(re.search(r"constexpr int GN_MAX_C = (\d+);", src).group(1)) == MAX_CHANNELS


def test_flash_d512_block_fits_shared_memory():
    """The D=512 body: 8 warps own 64 output columns each (all 512), and Q,
    one K and one V tile, P and the row reductions fit one block's shared
    memory (the kernel asserts the same at compile time)."""
    src = (CSRC / "flash_attention.cu").read_text()
    const = {k: int(v) for k, v in re.findall(r"constexpr int (FB_\w+) = (\d+);", src)}
    d, bq, bk, threads = const["FB_D"], const["FB_BQ"], const["FB_BK"], const["FB_THREADS"]
    assert (d, bq, threads) == (512, 64, 256) and threads // 32 * 64 == d
    smem = 1024 + 2 * (bq * d + bk * d + bk * (d + 8) + bq * (bk + 8)) + 4 * 5 * bq
    assert smem <= SMEM_LIMIT
