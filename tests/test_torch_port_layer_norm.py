"""PyTorch port, K7 (one-pass LayerNorm and RMSNorm, ``ops/fused_layer_norm.py``
over ``csrc/layer_norm.cu``) on the CPU: ``ops.norms.layer_norm`` and
``ops.norms.rms_norm`` against their plain versions, the route each takes on
the card (a CPU tensor dressed as a CUDA one, the wrapper spied), the
kernel's gate, the wrappers' refusals, the launch plan walked lane by lane
(and, past one warp, warp by warp) as the kernel walks it, and the norms one
unit of each timed cell runs, counted on the meta device at production
widths."""

import collections
import dataclasses
import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from streamingt2v_torch.config import CogVideoXConfig, PipelineConfig, WanConfig
from streamingt2v_torch.models import unet_blocks
from streamingt2v_torch.models.cogvideox import CogVideoXTransformer3D
from streamingt2v_torch.models.enhance.unet import I2VGenXLUNet, I2VGenXLUNetConfig
from streamingt2v_torch.models.wan import WanTransformer3D
from streamingt2v_torch.ops import fused_layer_norm as k7
from streamingt2v_torch.ops import norms
from streamingt2v_torch.pipeline.build import (
    build_enhance, build_interpolate, build_pipeline)

CSRC = Path(__file__).resolve().parent.parent / "streamingt2v_torch" / "csrc" / "layer_norm.cu"


class _OnCard(torch.Tensor):
    """A CPU tensor that says it is on the card: it reaches the route the
    card takes, where the spied wrapper stands in for the kernel."""
    is_cuda = True


def _draw(shape, dtype=torch.float32, seed=3):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy((rng.randn(*shape) * 2 + 0.5).astype(np.float32)).to(dtype)
    c = shape[-1]
    s = torch.from_numpy((1 + 0.1 * rng.randn(c)).astype(np.float32))
    b = torch.from_numpy((0.1 * rng.randn(c)).astype(np.float32))
    return x, s, b


def _affine(s, b, which):
    return {"none": (None, None), "scale": (s, None), "both": (s, b)}[which]


@pytest.fixture
def spied(monkeypatch):
    """Replaces K7's wrapper in ``ops.norms`` by its plain version on the
    rows it is handed, recording (shape, dtype, contiguous, scale, bias,
    eps) of each call."""
    calls = []

    def wrapper(x, scale, bias, eps):
        calls.append((tuple(x.shape), x.dtype, x.is_contiguous(),
                      None if scale is None else scale.dtype,
                      None if bias is None else bias.dtype, eps))
        return k7.layer_norm_reference(x.as_subclass(torch.Tensor), scale, bias, eps=eps)

    monkeypatch.setattr(norms, "fused_layer_norm", wrapper)
    return calls


@pytest.fixture
def spied_rms(monkeypatch):
    """Replaces K7's RMS wrapper in ``ops.norms`` by its plain version on the
    rows it is handed, recording (shape, dtype, contiguous, scale dtype,
    eps) of each call."""
    calls = []

    def wrapper(x, scale, eps):
        calls.append((tuple(x.shape), x.dtype, x.is_contiguous(), scale.dtype, eps))
        return k7.rms_norm_reference(x.as_subclass(torch.Tensor), scale, eps=eps)

    monkeypatch.setattr(norms, "fused_rms_norm", wrapper)
    return calls


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("which", ["none", "scale", "both"])
def test_layer_norm_on_the_cpu_is_the_plain_version(spied, dtype, which):
    """On the CPU ``norms.layer_norm`` is ``layer_norm_reference``, bit for
    bit, in x's dtype, whatever C is; the wrapper is never reached."""
    for shape in ((2, 5, 64), (3, 4, 2, 40), (7, 12)):
        x, s, b = _draw(shape, dtype)
        scale, bias = _affine(s, b, which)
        got = norms.layer_norm(x, scale, bias, eps=1e-6)
        want = k7.layer_norm_reference(x, scale, bias, eps=1e-6)
        assert got.dtype == dtype and got.shape == x.shape
        assert torch.equal(got, want)
    assert not spied


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("which", ["none", "scale", "both"])
def test_layer_norm_takes_k7_on_the_card_without_grad(spied, dtype, which):
    """On the card, where autograd records no graph, every LayerNorm whose C
    the gate takes reaches the wrapper once, as contiguous (rows, C) with f32
    parameters, and comes back in x's shape and dtype; a slice whose rows
    are not one stride apart is copied first."""
    x, s, b = _draw((2, 6, 5, 64), dtype)
    scale, bias = _affine(s.to(dtype), b.to(dtype), which)
    with torch.no_grad():
        got = norms.layer_norm(x.as_subclass(_OnCard), scale, bias, eps=1e-6)
    want = k7.layer_norm_reference(x, scale, bias, eps=1e-6)
    assert got.shape == x.shape and got.dtype == dtype
    assert torch.equal(got.as_subclass(torch.Tensor), want)
    f32 = torch.float32
    assert spied == [((60, 64), dtype, True, scale is not None and f32 or None,
                      bias is not None and f32 or None, 1e-6)]
    with torch.inference_mode():
        sliced = x[:, 1:].as_subclass(_OnCard)
        got = norms.layer_norm(sliced, scale, bias)
    assert torch.equal(got.as_subclass(torch.Tensor),
                       k7.layer_norm_reference(x[:, 1:], scale, bias))
    assert spied[-1][:3] == ((50, 64), dtype, True)


@pytest.mark.parametrize("needs", ["x", "scale", "bias"])
def test_layer_norm_under_grad_takes_the_plain_path(spied, needs):
    """Under grad, with any input that requires grad, the card's route is
    the plain version: the wrapper is not called, and the gradients of x,
    scale and bias flow as through ``layer_norm_reference``."""
    x, s, b = _draw((3, 10, 64))
    leaves = {"x": x, "scale": s, "bias": b}
    leaves[needs].requires_grad_()
    got = norms.layer_norm(leaves["x"].as_subclass(_OnCard), leaves["scale"], leaves["bias"])
    assert not spied and got.grad_fn is not None
    g = torch.from_numpy(np.random.RandomState(4).randn(3, 10, 64).astype(np.float32))
    (grad,) = torch.autograd.grad(got, leaves[needs], g)
    want = k7.layer_norm_reference(leaves["x"], leaves["scale"], leaves["bias"])
    (ref,) = torch.autograd.grad(want, leaves[needs], g)
    assert torch.allclose(grad, ref, rtol=1e-5, atol=1e-6) and grad.abs().max() > 0
    with torch.no_grad():
        norms.layer_norm(x.as_subclass(_OnCard), leaves["scale"], leaves["bias"])
    assert len(spied) == 1


@pytest.mark.parametrize("c,dtype,takes", [
    (8, torch.bfloat16, True), (64, torch.bfloat16, True), (320, torch.bfloat16, True),
    (1280, torch.bfloat16, True), (3072, torch.float32, True), (4096, torch.float32, True),
    (4, torch.bfloat16, False),      # stage 2's TemporalEncoder: under 16 bytes a row
    (12, torch.float32, False), (4104, torch.bfloat16, True),
    (5120, torch.float32, True), (5120, torch.bfloat16, True),    # Wan's stream, its q/k
    (8192, torch.float32, True), (8200, torch.bfloat16, False), (5124, torch.float32, False),
    (64, torch.float16, False), (64, torch.float64, False),
])
def test_the_gate_takes_16_byte_rows_of_bf16_and_f32(spied, c, dtype, takes):
    """``fits_fused_ln``: C % 8 == 0, C at most 8192 (past 4096 on the wide
    plan), bf16 or f32; what it refuses takes the plain version on the card
    too."""
    assert k7.fits_fused_ln(c, dtype) == takes
    x, s, b = _draw((4, c), dtype)
    with torch.no_grad():
        got = norms.layer_norm(x.as_subclass(_OnCard), s, b)
    assert torch.equal(got.as_subclass(torch.Tensor), k7.layer_norm_reference(x, s, b))
    assert len(spied) == int(takes)


def _refused(case):
    """(error, message, call) of one refused input."""
    x, s, b = _draw((6, 64))
    card = x.as_subclass(_OnCard)
    wide = torch.cat([card, card], 1)
    ln = k7.fused_layer_norm
    return {
        "cpu tensor": (ValueError, "CUDA tensor", lambda: ln(x, s, b, 1e-5)),
        "meta tensor": (ValueError, "CUDA tensor", lambda: ln(x.to("meta"), None, None, 1e-5)),
        "non-contiguous rows": (ValueError, "contiguous", lambda: ln(wide[:, ::2], s, b, 1e-5)),
        "a row stride past C": (ValueError, "contiguous", lambda: ln(wide[:, :64], s, b, 1e-5)),
        "3-D input": (ValueError, "rows, C", lambda: ln(card.view(2, 3, 64), s, b, 1e-5)),
        "C % 8": (ValueError, "not supported",
                  lambda: ln(card[:, :60].contiguous(), None, None, 1e-5)),
        "f16 input": (TypeError, "f32 or bf16", lambda: ln(card.half(), s, b, 1e-5)),
        "bf16 scale": (TypeError, "scale must", lambda: ln(card, s.bfloat16(), b, 1e-5)),
        "short bias": (TypeError, "bias must", lambda: ln(card, s, b[:32], 1e-5)),
        "grad": (RuntimeError, "no backward", lambda: ln(card, s.requires_grad_(), b, 1e-5)),
    }[case]


@pytest.mark.parametrize("case", ["cpu tensor", "meta tensor", "non-contiguous rows",
                                  "a row stride past C", "3-D input", "C % 8", "f16 input",
                                  "bf16 scale", "short bias", "grad"])
def test_the_wrapper_raises_on_what_the_kernel_does_not_take(case):
    """The wrapper launches K7 or raises: a tensor off the card, rows that
    are not contiguous (C apart), another rank, C, dtype or parameter, and
    an input that requires grad under grad."""
    error, match, call = _refused(case)
    before = chip_smoke._read_launches(f32=True)
    with pytest.raises(error, match=match):
        call()
    assert chip_smoke._read_launches(f32=True) == before


def test_the_plan_matches_the_kernel_source():
    """The instances the wrapper may choose are the ones ``layer_norm.cu``
    builds (a row in one warp and, WIDE, over several), with its block size,
    its widest row in one warp and its widest row."""
    src = CSRC.read_text()
    assert tuple(int(v) for v in re.findall(r"ST2V_LN_CASE\((\d+)\)\n", src)) == \
        k7.VPT_INSTANCES
    assert tuple(int(v) for v in re.findall(r"ST2V_LN_WIDE_CASE\((\d+)\)\n", src)) == \
        k7.WIDE_VPT_INSTANCES
    assert f"LN_THREADS = {k7.BLOCK_THREADS};" in src
    assert f"LN_NARROW_C = {k7.NARROW_CHANNELS};" in src
    assert f"LN_MAX_C = {k7.MAX_CHANNELS};" in src
    assert "(vpt + 3) / vpt" in src   # the rows a lane takes, as launch_plan's


@pytest.mark.parametrize("itemsize", [2, 4])
def test_the_launch_plan_covers_every_row_once(itemsize):
    """At every C the gate takes, each of a row's 16-byte vectors belongs to
    exactly one (lane, slot) of the plan, at least 4 loads are in flight a
    lane, and the widths the cells run take the fewest idle lanes: a row of
    64 four rows a warp, stage 1's three widths 5 vectors a lane, the f32
    stream of 3072 one warp of 24 vectors a lane; past 4096 a row spans
    warps, Wan's 5120 128 lanes of 5 in bf16 and 256 of 5 in f32."""
    vec = 16 // itemsize
    for c in range(8, k7.MAX_CHANNELS + 1, 8):
        p = k7.launch_plan(c, itemsize)
        vectors = c // vec
        if c > k7.NARROW_CHANNELS:
            assert p.lanes in (64, 128, 256) and p.vpt in k7.WIDE_VPT_INSTANCES
        else:
            assert p.lanes in (1, 2, 4, 8, 16, 32) and p.vpt in k7.VPT_INSTANCES
        owned = sorted(sub + i * p.lanes for sub in range(p.lanes) for i in range(p.vpt)
                       if sub + i * p.lanes < vectors)
        assert owned == list(range(vectors)), c
        assert p.vpt * p.rows >= 4 and p.rows_per_block == 256 // p.lanes * p.rows
    want = {2: {64: (8, 1, 4), 320: (8, 5, 1), 640: (16, 5, 1), 1280: (32, 5, 1),
                32: (4, 1, 4), 96: (4, 3, 2), 256: (32, 1, 4), 512: (32, 2, 2),
                5120: (128, 5, 1)},
            4: {3072: (32, 24, 1), 64: (16, 1, 4), 5120: (256, 5, 1)}}[itemsize]
    for c, plan in want.items():
        assert k7.launch_plan(c, itemsize)[:3] == plan, c


@pytest.mark.parametrize("rows,c", [(300, 64), (70, 320), (9, 3072), (130, 96)])
def test_the_kernel_walk_normalises_every_row_once(rows, c):
    """The kernel's walk in f32 numpy, lane by lane: one block a group of
    rows, each lane's loads and sums, the butterfly within a row's lanes
    and the one-pass clamped statistics give every row exactly once, within
    f32 rounding of the plain version."""
    x, s, b = _draw((rows, c))
    out, written = _walk(x.numpy(), s.numpy(), b.numpy(), 1e-5, 4, rms=False)
    assert (written == 1).all()
    np.testing.assert_allclose(out, k7.layer_norm_reference(x, s, b).numpy(), rtol=0, atol=2e-5)


# the plans the cells' narrow rows (C <= 4096) ran on before the wide plan,
# (C, dtype) -> (lanes, vpt, rows): every (C, dtype) of
# ``layer_norm_geometries`` that K7 takes at or under one warp's row
NARROW_PLANS = {
    (320, "bfloat16"): (8, 5, 1), (640, "bfloat16"): (16, 5, 1),
    (1280, "bfloat16"): (32, 5, 1), (32, "bfloat16"): (4, 1, 4), (96, "bfloat16"): (4, 3, 2),
    (256, "bfloat16"): (32, 1, 4), (512, "bfloat16"): (32, 2, 2), (64, "bfloat16"): (8, 1, 4),
    (1024, "bfloat16"): (32, 4, 1), (3072, "float32"): (32, 24, 1),
    (1280, "float32"): (32, 12, 1), (256, "float32"): (32, 2, 2), (512, "float32"): (32, 4, 1)}


def _one_warp_plan(c: int, itemsize: int) -> tuple:
    """The one-warp search as it was before the wide plan: the fewest idle
    slots over 32 to 1 lanes and ``VPT_INSTANCES``, then the most lanes."""
    vectors = c // (16 // itemsize)
    best = None
    for lanes in (32, 16, 8, 4, 2, 1):
        need = -(-vectors // lanes)
        vpt = next((v for v in (1, 2, 3, 4, 5, 6, 8, 12, 16, 24, 32) if v >= need), None)
        if vpt is not None and (best is None or lanes * vpt - vectors < best[0]):
            best = (lanes * vpt - vectors, lanes, vpt)
    return best[1], best[2], -(-4 // best[2])


def test_the_narrow_plans_stay_as_they_were():
    """The wide plan leaves every C up to 4096 on the one-warp plan it had:
    the same lanes, vectors and rows at every C the gate takes there, in
    both dtypes, and so at every narrow (C, dtype) the cells send."""
    for itemsize in (2, 4):
        for c in range(8, k7.NARROW_CHANNELS + 1, 8):
            assert k7.launch_plan(c, itemsize)[:3] == _one_warp_plan(c, itemsize), c
    sent = {(c, dtype) for _, c, dtype, _, _, _ in chip_smoke.layer_norm_geometries()
            if c <= k7.NARROW_CHANNELS and k7.fits_fused_ln(c, getattr(torch, dtype))}
    assert sent == set(NARROW_PLANS)
    for (c, dtype), plan in NARROW_PLANS.items():
        assert k7.launch_plan(c, getattr(torch, dtype).itemsize)[:3] == plan


def _walk(x: np.ndarray, scale, bias, eps: float, itemsize: int, rms: bool) -> tuple:
    """The kernel's walk in f32 numpy over rows of f32 values (bf16 ones
    held as f32), lane by lane and block by block: each lane's loads and
    sums, the xor butterfly within a warp's (or a row's) lanes, and past 32
    lanes the warps' parts added in warp order; then the statistics of
    either entry and the output in f32.  Returns (output, times each row was
    written)."""
    rows, c = x.shape
    p = k7.launch_plan(c, itemsize)
    vec, slots = 16 // itemsize, k7.BLOCK_THREADS // p.lanes
    warp = min(p.lanes, 32)
    out, written = np.zeros_like(x), np.zeros(rows, int)
    for block in range(-(-rows // p.rows_per_block)):
        base = block * p.rows_per_block
        for r in range(p.rows):
            for slot in range(slots):
                row = base + r * slots + slot
                if row >= rows:
                    continue
                lane_sums = []
                for sub in range(p.lanes):
                    js = [sub + i * p.lanes for i in range(p.vpt)
                          if sub + i * p.lanes < c // vec]
                    v = np.concatenate([x[row, j * vec:(j + 1) * vec] for j in js]) \
                        if js else np.zeros(0, np.float32)
                    lane_sums.append((np.float32(0 if rms else v.sum(dtype=np.float32)),
                                      np.float32((v * v).sum(dtype=np.float32))))
                parts = []
                for w in range(0, p.lanes, warp):    # each warp's butterfly
                    sums = lane_sums[w:w + warp]
                    o = warp // 2
                    while o:
                        sums = [(a + sums[i ^ o][0], q + sums[i ^ o][1])
                                for i, (a, q) in enumerate(sums)]
                        o //= 2
                    assert len(set(sums)) == 1    # every lane holds its warp's sums
                    parts.append(sums[0])
                s1, s2 = np.float32(0), np.float32(0)
                for a, q in parts:    # in warp order
                    s1, s2 = np.float32(s1 + a), np.float32(s2 + q)
                inv_c = np.float32(1) / np.float32(c)
                if rms:
                    y = x[row] * np.float32(1 / np.sqrt(s2 * inv_c + np.float32(eps)))
                else:
                    mean = np.float32(s1 * inv_c)
                    rstd = np.float32(1 / np.sqrt(max(s2 * inv_c - mean * mean, 0) + eps))
                    y = (x[row] - mean) * rstd
                out[row] = y * scale if bias is None else y * scale + bias
                written[row] += 1
    return out, written


@pytest.mark.parametrize("rows,c,dtype", [
    (9, 5120, torch.float32), (11, 5120, torch.bfloat16),    # Wan's stream, its q/k rows
    (7, 4104, torch.float32), (13, 4104, torch.bfloat16),    # ragged, past one warp
    (5, 8192, torch.float32), (6, 6144, torch.bfloat16), (40, 320, torch.bfloat16)])
@pytest.mark.parametrize("norm", ["layer", "rms"])
def test_the_wide_walk_normalises_every_row_once(rows, c, dtype, norm):
    """Past 4096 channels a row spans 2 to 8 warps: walked as the kernel
    walks it, each of a row's 16-byte vectors is loaded by one lane, each
    warp's butterfly gives its part, the parts added in warp order give the
    row's sums, and every row is written exactly once, within f32 rounding
    of the plain version, in the LayerNorm and the RMS entry alike (and on
    a one-warp row, 320, the RMS entry too)."""
    x, s, b = _draw((rows, c), dtype)
    xs = x.float().numpy()
    itemsize = torch.tensor([], dtype=dtype).element_size()
    p = k7.launch_plan(c, itemsize)
    if c > k7.NARROW_CHANNELS:
        assert p.lanes > 32 and p.rows_per_block == k7.BLOCK_THREADS // p.lanes * p.rows
    if norm == "rms":
        got, written = _walk(xs, s.numpy(), None, 1e-6, itemsize, rms=True)
        want = k7.rms_norm_reference(x.float(), s, eps=1e-6)
    else:
        got, written = _walk(xs, s.numpy(), b.numpy(), 1e-6, itemsize, rms=False)
        want = k7.layer_norm_reference(x.float(), s, b, eps=1e-6)
    assert (written == 1).all()
    np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=3e-5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rms_norm_on_the_cpu_is_the_plain_version(spied_rms, dtype):
    """On the CPU ``norms.rms_norm`` is ``rms_norm_reference``, bit for bit,
    in x's dtype (the scale in its own dtype); the wrapper is never
    reached."""
    for shape in ((2, 5, 64), (3, 4, 2, 40), (7, 5120)):
        x, s, _ = _draw(shape, dtype)
        for scale in (s, s.to(dtype)):
            got = norms.rms_norm(x, scale, eps=1e-6)
            assert got.dtype == dtype and got.shape == x.shape
            assert torch.equal(got, k7.rms_norm_reference(x, scale, eps=1e-6))
    assert not spied_rms


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rms_norm_takes_k7_on_the_card_without_grad(spied_rms, dtype):
    """On the card, where autograd records no graph, an RMSNorm whose C the
    gate takes reaches K7's RMS wrapper once, as contiguous (rows, C) with
    an f32 scale, and comes back in x's shape and dtype; a slice is copied
    first; a C the gate refuses takes the plain version."""
    x, s, _ = _draw((2, 6, 5, 64), dtype)
    with torch.no_grad():
        got = norms.rms_norm(x.as_subclass(_OnCard), s.to(dtype), eps=1e-6)
    assert got.shape == x.shape and got.dtype == dtype
    assert torch.equal(got.as_subclass(torch.Tensor),
                       k7.rms_norm_reference(x, s.to(dtype), eps=1e-6))
    assert spied_rms == [((60, 64), dtype, True, torch.float32, 1e-6)]
    with torch.inference_mode():
        got = norms.rms_norm(x[:, 1:].as_subclass(_OnCard), s)
        assert torch.equal(got.as_subclass(torch.Tensor), k7.rms_norm_reference(x[:, 1:], s))
        odd, so, _ = _draw((3, 12), dtype)
        got = norms.rms_norm(odd.as_subclass(_OnCard), so)
        assert torch.equal(got.as_subclass(torch.Tensor), k7.rms_norm_reference(odd, so))
    assert [call[:3] for call in spied_rms] == [((60, 64), dtype, True), ((50, 64), dtype, True)]


@pytest.mark.parametrize("needs", ["x", "scale"])
def test_rms_norm_under_grad_takes_the_plain_path(spied_rms, needs):
    """Under grad, with x or the scale requiring grad, the card's route is
    the plain version: the wrapper is not called, and the gradients flow as
    through ``rms_norm_reference``."""
    x, s, _ = _draw((3, 10, 64))
    leaves = {"x": x, "scale": s}
    leaves[needs].requires_grad_()
    got = norms.rms_norm(leaves["x"].as_subclass(_OnCard), leaves["scale"])
    assert not spied_rms and got.grad_fn is not None
    g = torch.from_numpy(np.random.RandomState(4).randn(3, 10, 64).astype(np.float32))
    (grad,) = torch.autograd.grad(got, leaves[needs], g)
    (ref,) = torch.autograd.grad(k7.rms_norm_reference(leaves["x"], leaves["scale"]),
                                 leaves[needs], g)
    assert torch.allclose(grad, ref, rtol=1e-5, atol=1e-6) and grad.abs().max() > 0
    with torch.no_grad():
        norms.rms_norm(x.as_subclass(_OnCard), leaves["scale"])
    assert len(spied_rms) == 1


def _rms_refused(case):
    """(error, message, call) of one input the RMS wrapper refuses."""
    x, s, _ = _draw((6, 64))
    card = x.as_subclass(_OnCard)
    wide = torch.cat([card, card], 1)
    rms = k7.fused_rms_norm
    return {
        "cpu tensor": (ValueError, "CUDA tensor", lambda: rms(x, s, 1e-6)),
        "no scale": (TypeError, "scale is required", lambda: rms(card, None, 1e-6)),
        "non-contiguous rows": (ValueError, "contiguous", lambda: rms(wide[:, ::2], s, 1e-6)),
        "3-D input": (ValueError, "rows, C", lambda: rms(card.view(2, 3, 64), s, 1e-6)),
        "C % 8": (ValueError, "not supported", lambda: rms(card[:, :60].contiguous(),
                                                           s[:60], 1e-6)),
        "C past 8192": (ValueError, "not supported", lambda: rms(
            torch.zeros(2, 8200).as_subclass(_OnCard), torch.ones(8200), 1e-6)),
        "f16 input": (TypeError, "f32 or bf16", lambda: rms(card.half(), s, 1e-6)),
        "bf16 scale": (TypeError, "scale must", lambda: rms(card, s.bfloat16(), 1e-6)),
        "short scale": (TypeError, "scale must", lambda: rms(card, s[:32], 1e-6)),
        "grad": (RuntimeError, "no backward", lambda: rms(card, s.requires_grad_(), 1e-6)),
    }[case]


@pytest.mark.parametrize("case", ["cpu tensor", "no scale", "non-contiguous rows", "3-D input",
                                  "C % 8", "C past 8192", "f16 input", "bf16 scale",
                                  "short scale", "grad"])
def test_the_rms_wrapper_raises_on_what_the_kernel_does_not_take(case):
    """``fused_rms_norm`` launches K7's RMS entry or raises, as the
    LayerNorm's wrapper does, and also without a scale: no launch is
    counted."""
    error, match, call = _rms_refused(case)
    before = chip_smoke._read_launches(f32=True)
    with pytest.raises(error, match=match):
        call()
    assert chip_smoke._read_launches(f32=True) == before


def _count_layer_norms(monkeypatch, networks: dict):
    """Patches the plain version (the route of a meta tensor) to count each
    call by the innermost watched network open, as (rows, C, dtype, eps,
    whether K3 takes it on the card), and each network's calls.  A LayerNorm
    of the UNets' feed-forward (``unet_blocks.FeedForward._ff``) where K3's
    gate (``unet_blocks._k3_geometry``) holds runs inside K3 on the card,
    and ``norms.layer_norm`` is not called there."""
    seen, calls, open_, in_k3 = collections.Counter(), collections.Counter(), [], []
    plain = norms.layer_norm_reference
    ff = unet_blocks.FeedForward._ff

    def counted(x, scale=None, bias=None, *, eps=1e-5):
        if open_:
            c = x.shape[-1]
            seen[open_[-1], x.numel() // c, c, str(x.dtype).split(".")[-1], eps,
                 bool(in_k3) and in_k3[-1]] += 1
        return plain(x, scale, bias, eps=eps)

    def gated_ff(self, x, ln, residual, b2, m):
        in_k3.append(unet_blocks._k3_geometry(x, self, m))
        try:
            return ff(self, x, ln, residual, b2, m)
        finally:
            in_k3.pop()

    monkeypatch.setattr(norms, "layer_norm_reference", counted)
    monkeypatch.setattr(unet_blocks.FeedForward, "_ff", gated_ff)
    for name, module in networks.items():
        module.register_forward_pre_hook(
            lambda mod, args, name=name: calls.update([name]) or open_.append(name))
        module.register_forward_hook(lambda mod, args, out: open_.pop() and None)
    return seen, calls


def _per_call(seen, calls):
    """The counts of ``_count_layer_norms`` a call of their network."""
    per = collections.Counter()
    for key, k in seen.items():
        assert k % calls[key[0]] == 0, key
        per[key] = k // calls[key[0]]
    return per


def _stage1(monkeypatch):
    """Full-width stage 1 on the meta device, 43 frames, one sampler step a
    chunk: the AR chunk's VideoUNet and ControlNet calls, and the key
    image's conditioning CLIP tower."""
    cfg = PipelineConfig()
    cfg = dataclasses.replace(
        cfg, sampler=dataclasses.replace(cfg.sampler, num_steps=1),
        first_chunk_sampler=dataclasses.replace(cfg.first_chunk_sampler, num_steps=1))
    pipe = build_pipeline(cfg, device="meta", bf16=True, init=False)
    monkeypatch.setattr(norms, "fused_group_norm", lambda x, *a, **kw: torch.empty_like(x))
    counted = _count_layer_norms(monkeypatch, {
        "stage-1 VideoUNet": pipe.models.unet, "stage-1 ControlNet": pipe.models.controlnet,
        "stage-1 CLIP vision": pipe.models.conditioner.clip})
    with torch.inference_mode():
        pipe.image_to_video(torch.zeros(cfg.height, cfg.width, 3, device="meta"), num_frames=43,
                            seed=7, noise=lambda g, s, shape: torch.zeros(shape, device="meta"))
    return _per_call(*counted)


def _stage2(monkeypatch):
    """One call of stage 2's full-width UNet on a 38-frame chunk of 720p."""
    unet = I2VGenXLUNet(I2VGenXLUNetConfig(), device="meta", dtype=torch.bfloat16).eval()
    monkeypatch.setattr(norms, "fused_group_norm", lambda x, *a, **kw: torch.empty_like(x))
    counted = _count_layer_norms(monkeypatch, {"stage-2 UNet": unet})
    z = functools.partial(torch.zeros, device="meta")
    with torch.inference_mode():
        unet(z(1, 38, 90, 160, 4), z(1, dtype=torch.int32), z(1), z(1, 38, 90, 160, 4),
             z(1, 1024), z(1, 77, 1024))
    return _per_call(*counted)


def _stage2_conditioning(monkeypatch):
    """Stage 2's full-width conditioning towers on the meta device, as the
    pipeline calls them: the text tower on the two prompts, the CLIP vision
    tower on the key image of 720p."""
    cfg = PipelineConfig().enhance
    pipe = build_enhance(cfg, device="meta", init=False)
    monkeypatch.setattr(norms, "fused_group_norm", lambda x, *a, **kw: torch.empty_like(x))
    counted = _count_layer_norms(monkeypatch, {"stage-2 CLIP vision": pipe.m.clip_vision,
                                               "stage-2 CLIP text": pipe.m.text_encoder})
    z = functools.partial(torch.zeros, device="meta")
    with torch.inference_mode():
        pipe.encode_prompts()
        pipe._key_image_cond(z(cfg.height, cfg.width, 3),
                             z(1, cfg.height // 8, cfg.width // 8, 4), 38)
    return _per_call(*counted)


def _stage3(monkeypatch):
    """Stage 3's full-width EMA-VFI on the meta device: one network call, the
    pipeline's pairs a call of 720p with flip-TTA."""
    cfg = PipelineConfig()
    pipe = build_interpolate(cfg, device="meta", init=False)
    counted = _count_layer_norms(monkeypatch, {"stage-3 EMA-VFI": pipe.model})
    with torch.inference_mode():
        pipe.interpolate_video(torch.zeros(pipe.pair_batch + 1, cfg.enhance.height,
                                           cfg.enhance.width, 3, device="meta"))
    return _per_call(*counted)


def _cogvideox(monkeypatch):
    """One call of CogVideoX-5B's transformer on the CFG batch of 2."""
    cfg = CogVideoXConfig()
    dit = CogVideoXTransformer3D(cfg, device="meta", dtype=torch.bfloat16).eval()
    counted = _count_layer_norms(monkeypatch, {"CogVideoX-5B": dit})
    z = functools.partial(torch.zeros, device="meta", dtype=torch.bfloat16)
    with torch.inference_mode():
        dit(z(cfg.latent_shape(2)), z(2, cfg.max_text_seq_length, cfg.text_embed_dim),
            torch.zeros(2, dtype=torch.int64, device="meta"))
    return _per_call(*counted)


@pytest.mark.parametrize("cell,run,on_k3", [
    ("streamingsvd.ar_chunk", _stage1, {"stage-1 VideoUNet": 48, "stage-1 ControlNet": 21}),
    ("i2vgen_xl.enhance_chunk", _stage2, {"stage-2 UNet": 33}),
    ("cogvideox_5b.t2v_step", _cogvideox, {})])
def test_meta_count_gives_k7_launches_a_unit(monkeypatch, cell, run, on_k3):
    """The LayerNorms of one network call of each timed cell's unit, counted
    on the meta device at production widths: those of the UNets'
    feed-forwards run inside K3 on the card (its gate holds for each); the
    others are ``chip_smoke``'s ``layer_norm_geometries``, which its kernels
    phase holds K7 at; every one passes K7's gate but stage 2's 4-channel
    TemporalEncoder norm; and so K7's launches a unit are
    ``layer_norm_launches``': 98 an AR step, 132 a stage-2 step, 170 a
    CogVideoX step (86 on the f32 stream).  Stage 1's run also holds its
    conditioning CLIP tower to the table, which adds nothing to the AR
    step."""
    seen = run(monkeypatch)
    k3 = collections.Counter()
    for (network, *_, in_k3), k in seen.items():
        k3[network] += k * in_k3
    assert {n: k for n, k in k3.items() if k} == on_k3
    seen = collections.Counter({key[:-1]: k for key, k in seen.items() if not key[-1]})
    networks = {network for network, *_ in seen}
    want = collections.Counter({(network, n, c, dtype, eps): k for n, c, dtype, eps, network, k
                                in chip_smoke.layer_norm_geometries() if network in networks})
    assert seen == want
    plain = {(network, n, c) for network, n, c, dtype, _ in seen
             if not k7.fits_fused_ln(c, getattr(torch, dtype))}
    assert plain == ({("stage-2 UNet", 547200, 4)} if cell.startswith("i2vgen") else set())
    assert chip_smoke.layer_norm_launches() == {
        "ar_step": 98, "stage2_step": 132, "t2v_step": 170, "t2v_step_f32": 86,
        "i2v_step": 123, "i2v_step_f32": 121, "i2v_step_rms": 200}


def test_meta_count_gives_k7_launches_a_wan_step(monkeypatch):
    """One call of Wan2.1-I2V-14B's transformer on the CFG batch of 2 (a
    step), counted on the meta device at the published widths: its
    LayerNorms (the f32 stream's three a block and the head's at 5120, the
    image projector's two in bf16) are ``chip_smoke``'s
    ``layer_norm_geometries`` of that network and its q/k RMSNorms (five a
    block) its ``rms_norm_geometries``; K7's gate takes every one, so a step
    launches 123 LayerNorms (121 f32) and 200 RMSNorms, as
    ``layer_norm_launches`` and ``wan_step_launches`` predict."""
    cfg = WanConfig()
    dit = WanTransformer3D(cfg, device="meta", dtype=torch.bfloat16).eval()
    seen = collections.Counter()
    plain_ln, plain_rms = norms.layer_norm_reference, norms.rms_norm_reference

    def ln(x, scale=None, bias=None, *, eps=1e-5):
        seen["layer", x.numel() // x.shape[-1], x.shape[-1], str(x.dtype).split(".")[-1],
             eps] += 1
        return plain_ln(x, scale, bias, eps=eps)

    def rms(x, scale, *, eps=1e-6):
        seen["rms", x.numel() // x.shape[-1], x.shape[-1], str(x.dtype).split(".")[-1],
             eps] += 1
        return plain_rms(x, scale, eps=eps)

    monkeypatch.setattr(norms, "layer_norm_reference", ln)
    monkeypatch.setattr(norms, "rms_norm_reference", rms)
    z = functools.partial(torch.zeros, device="meta")
    _, c, f, h, w = cfg.latent_shape(2)
    with torch.inference_mode():
        dit(z(cfg.latent_shape(2)), torch.zeros(2, dtype=torch.int64, device="meta"),
            z(2, cfg.text_len, cfg.text_dim), z(2, cfg.clip_tokens, cfg.clip_dim),
            z(2, cfg.in_dim - c, f, h, w))
    want = collections.Counter()
    for norm, geometries in (("layer", chip_smoke.layer_norm_geometries()),
                             ("rms", chip_smoke.rms_norm_geometries())):
        for n, c, dtype, eps, network, k in geometries:
            if network == "Wan2.1-I2V-14B":
                want[norm, n, c, dtype, eps] += k
    assert seen == want
    assert all(k7.fits_fused_ln(c, getattr(torch, dtype)) for _, _, c, dtype, _ in seen)
    per_step = chip_smoke.layer_norm_launches()
    assert (per_step["i2v_step"], per_step["i2v_step_f32"], per_step["i2v_step_rms"]) == \
        (123, 121, 200)
    assert chip_smoke.wan_step_launches() == {
        "flash_attention": 120, "flash_attention_d128": 120, "layer_norm": 123,
        "layer_norm_f32": 121, "rms_norm": 200}


@pytest.mark.parametrize("run", [_stage2_conditioning, _stage3])
def test_meta_count_gives_k7_geometries_off_the_cells(monkeypatch, run):
    """The full-width LayerNorms that the smoke's phases run and no cell
    times, counted on the meta device: stage 2's conditioning towers and
    stage 3's EMA-VFI are ``chip_smoke``'s ``layer_norm_geometries`` of
    those networks, which its kernels phase holds K7 at; none runs inside
    K3, and every one passes K7's gate."""
    seen = run(monkeypatch)
    assert seen and not any(key[-1] for key in seen)
    seen = collections.Counter({key[:-1]: k for key, k in seen.items()})
    networks = {network for network, *_ in seen}
    want = collections.Counter({(network, n, c, dtype, eps): k for n, c, dtype, eps, network, k
                                in chip_smoke.layer_norm_geometries() if network in networks})
    assert seen == want
    assert all(k7.fits_fused_ln(c, getattr(torch, dtype)) for _, _, c, dtype, _ in seen)
