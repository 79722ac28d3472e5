"""Wan2.1 image-to-video on the port (``models/wan.py``,
``diffusion/flow_unipc.py``, ``pipeline/wan.py``, ``build_wan``, K1's gate
at D=128) against the plain reference ``tests/_wan_reference.py``, at the
tiny size on the CPU: 2 blocks of 256 (2 heads of 128), FFN 512, text 32
wide (8 rows after padding), 5 CLIP tokens of 32, latents of 2 frames of
4 x 6 with 16 channels, seeded random weights with every bias, norm and
modulation parameter away from its initial value."""

from __future__ import annotations

import importlib
import math
from collections import Counter

import pytest
import torch

from streamingt2v_torch.config import WanConfig
from streamingt2v_torch.diffusion.flow_unipc import FlowUniPCScheduler, UniPCState
from streamingt2v_torch.models.wan import WanTransformer3D
from streamingt2v_torch.ops import flash_attention as fa
from streamingt2v_torch.ops import rope
from streamingt2v_torch.pipeline.build import build_wan
from streamingt2v_torch.pipeline.wan import first_frame_mask
from streamingt2v_torch.utils import profiling

import _wan_reference as ref

attention_ops = importlib.import_module("streamingt2v_torch.ops.attention")

torch.set_num_threads(2)

CFG = WanConfig.tiny()
REF_CFG = ref.config(CFG.num_layers, CFG.num_heads, CFG.head_dim, CFG.ffn_dim, CFG.freq_dim,
                     CFG.text_dim, CFG.text_len, CFG.clip_dim)
# f32 on both sides: what is left is the order of the sums, LayerNorm's
# one-pass variance and the RoPE angles' rounding to f32
F32_REL = 1e-4


def relative(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


def pipeline(seed: int):
    """The tiny pipeline from ``build_wan`` with every bias, norm and
    modulation parameter drawn too (``init_random_`` leaves the first two at
    0 and 1)."""
    pipe = build_wan(CFG, seed, device="cpu", bf16=False)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in pipe.transformer.named_parameters():
            if name.endswith("_scale"):
                p.copy_(1 + 0.1 * torch.randn(p.shape, generator=g))
            elif name.endswith("bias"):
                p.copy_(0.1 * torch.randn(p.shape, generator=g))
    return pipe


def inputs(seed: int) -> dict:
    g = torch.Generator().manual_seed(seed + 1)
    return dict(noise=torch.randn(CFG.latent_shape(1), generator=g),
                image_latent=torch.randn(CFG.latent_shape(1), generator=g),
                prompt=torch.randn((1, 5, CFG.text_dim), generator=g),
                negative=torch.randn((1, 7, CFG.text_dim), generator=g),
                clip=torch.randn((1, CFG.clip_tokens, CFG.clip_dim), generator=g))


def weights(pipe) -> dict:
    return {k: v.detach().clone() for k, v in pipe.transformer.state_dict().items()}


@pytest.mark.parametrize("seed", [1, 2, 2**31 + 7])
def test_transformer_matches_the_reference(seed):
    pipe, inp = pipeline(seed), inputs(seed)
    x = torch.cat([inp["noise"], 0.5 * inp["noise"]])
    y = pipe.condition(torch.cat([inp["image_latent"]] * 2))
    text = torch.cat([inp["negative"][:, :5], inp["prompt"]])
    clip = torch.cat([inp["clip"], -inp["clip"]])
    t = torch.tensor([999, 412])
    with torch.no_grad():
        out = pipe.transformer(x, t, text, clip, y)
    w = weights(pipe)
    want = ref.forward(w, REF_CFG, x, t, text, clip, y)
    assert out.shape == want.shape == x.shape and out.dtype == torch.float32
    assert relative(out, want) < F32_REL
    # the image keys and RoPE move the output, each far past the agreement
    assert relative(want, ref.forward(w, REF_CFG, x, t, text, clip, y, image=False)) > 1e-2
    assert relative(want, ref.forward(w, REF_CFG, x, t, text, clip, y, rope=False)) > 1e-3


def test_rope_is_wans_rope_params_and_built_once_a_geometry():
    """``rope_3d`` at (44, 42, 42) with ``apply_rope`` turns q as Wan's
    complex ``rope_apply`` over ``rope_params`` does (f64 there, f32 here);
    the model builds one table a grid and device."""
    g = torch.Generator().manual_seed(4)
    f, h, w = 3, 2, 5
    x = torch.randn((2, f * h * w, 3, 128), generator=g)
    cos, sin = rope.rope_3d(f, h, w, CFG.rope_dims, 1e4)
    assert CFG.rope_dims == (44, 42, 42) and cos.shape == (30, 128)
    want = ref.rope_apply(x, (f, h, w), ref.model_freqs(128, 1e4))
    assert torch.allclose(rope.apply_rope(x, cos, sin), want, rtol=0, atol=2e-6)
    # token (f=2, h=1, w=3), channel pair 1 of the w group: 3 * 1e4^(-2/42)
    a = 3 * 1e4 ** (-2 / 42)
    assert math.isclose(float(sin[2 * 10 + 1 * 5 + 3, 44 + 42 + 2]), math.sin(a), abs_tol=1e-7)
    profiling.reset_counters()
    model = WanTransformer3D(CFG, device="meta")
    first = model.rope(f, h, w, "cpu")
    assert torch.equal(first[0], cos) and torch.equal(first[1], sin)
    assert model.rope(f, h, w, "cpu")[0] is first[0]
    model.rope(f, h, 4, "cpu")
    assert profiling.read_counters()["rope_tables"] == 2
    profiling.reset_counters()


@pytest.mark.parametrize("cfg", [CFG, WanConfig()], ids=["tiny", "published"])
def test_first_frame_mask_is_image2videos(cfg):
    _, _, f, h, w = cfg.latent_shape()
    got = first_frame_mask(cfg)
    want = ref.first_frame_mask(cfg.frames, h, w)
    assert got.shape == (1, 4, f, h, w) and torch.equal(got[0], want)
    assert bool((got[:, :, 0] == 1).all()) and not bool(got[:, :, 1:].any())


@pytest.mark.parametrize("steps", [40, 4, 7, 2])
def test_unipc_is_the_reference(steps):
    """Sigmas, timesteps and every step's update (order 1 first, 2 between,
    1 on the last, the corrector from the second step on) against Wan's
    scheduler, from the same model outputs."""
    port, want = FlowUniPCScheduler(CFG.scheduler, steps), ref.Scheduler(steps)
    assert port.timesteps == want.timesteps.tolist()
    assert port.sigmas == want.sigmas.tolist()
    assert port.sigmas[-1] == 0.0 and len(port.sigmas) == steps + 1
    assert [port.order(i) for i in range(steps)] == [1] + [2] * (steps - 2) + [1] * (steps > 1)
    g = torch.Generator().manual_seed(steps)
    x = torch.randn((1, 16, 2, 3, 5), generator=g)
    xp, xr, state = x, x, UniPCState()
    for i in range(steps):
        v = torch.randn(x.shape, generator=g)
        xp, state = port.step(v, i, xp, state)
        xr = want.step(v, xr)
        assert relative(xp, xr) < 1e-5, i
    if steps == 40:
        assert port.timesteps[:3] == [999, 991, 982] and port.timesteps[-1] == 71


def test_generate_matches_the_reference_loop():
    """``build_wan`` then ``generate``: 4 guided steps against the
    reference's, from the same noise and conditioning."""
    pipe, inp = pipeline(4), inputs(4)
    out = pipe.generate(inp["prompt"], inp["negative"], inp["clip"], inp["image_latent"],
                        inp["noise"])
    sched, w = ref.Scheduler(CFG.num_steps), weights(pipe)
    y = torch.cat([ref.first_frame_mask(CFG.frames, *CFG.latent_shape()[-2:])[None],
                   inp["image_latent"]], dim=1)
    x = inp["noise"]
    assert pipe.timesteps() == sched.timesteps.tolist() == [999, 899, 749, 499]
    with torch.no_grad():
        for _ in range(CFG.num_steps):
            x = ref.guided_step(w, REF_CFG, sched, x, inp["prompt"], inp["negative"],
                                inp["clip"], y, CFG.guidance_scale)
    assert out.shape == x.shape and out.dtype == torch.float32
    assert relative(out, x) < F32_REL
    assert relative(out, inp["noise"]) > 0.1


def test_spans_and_counters_of_a_step():
    pipe, inp = pipeline(5), inputs(5)
    y = pipe.condition(inp["image_latent"])
    args = (inp["prompt"], inp["negative"], inp["clip"], y)
    profiling.reset_counters()
    with torch.inference_mode():
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            pipe.denoise_step(inp["noise"], UniPCState(), 0, *args)
        pipe.denoise_step(inp["noise"], UniPCState(), 0, *args)
    counters = profiling.read_counters()
    profiling.reset_counters()
    assert counters["steps"] == counters["dit_calls"] == 2 and counters["rope_tables"] == 1
    spans = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events() if e.name().startswith("st2v.")]
    names = Counter(n for n, _, _ in spans)
    n = CFG.num_layers
    assert names["st2v.step"] == names["st2v.dit"] == names["st2v.conv"] == 1
    for block in ("st2v.transformer", "st2v.attention", "st2v.cross_attention", "st2v.ff"):
        assert names[block] == n, block
    assert names["st2v.rope"] == 2 * n
    # a block's three LayerNorms and five RMSNorms; the projector's two
    # LayerNorms and the head's
    assert names["st2v.norm"] == 8 * n + 3
    # a block's table, two modulations and two gated adds; the head's
    assert names["st2v.modulate"] == 5 * n + 1
    # the inputs and time path, the sinusoid, the head's table
    assert names["st2v.embed"] == 3
    (_, a, b), = [s for s in spans if s[0] == "st2v.dit"]
    assert all(a <= x and y <= b for nm, x, y in spans if nm not in ("st2v.step", "st2v.dit"))
    # the cross-attention opens no st2v.attention inside itself
    for _, ca, cb in (s for s in spans if s[0] == "st2v.cross_attention"):
        assert not any(ca <= x and y <= cb for nm, x, y in spans if nm == "st2v.attention")


def test_k1_gate_at_d128(monkeypatch):
    """bf16 D=128 is K1's; f32 D=128 takes the chunked plain path; other
    widths still raise."""
    assert fa.kernel_geometry((80, 300, 128), (80, 257, 128), dtype=torch.bfloat16)["d"] == 128
    for d, dtype in ((128, torch.float32), (96, torch.bfloat16), (256, torch.bfloat16)):
        with pytest.raises(ValueError, match="head dim"):
            fa.kernel_geometry((2, 8, d), (2, 8, d), dtype=dtype)
    assert fa.bf16_only(128, torch.float32) and not fa.bf16_only(128, torch.bfloat16)
    assert not fa.bf16_only(64, torch.float32) and not fa.packed_applicable(2, 128)
    launched = []

    def flash(q, k, v):
        launched.append((q.shape[-1], q.dtype))
        fa._kernel_head_dim(q.shape[-1], q.dtype)
        return fa.flash_attention_reference(q, k, v)

    monkeypatch.setattr(attention_ops, "_use_flash", lambda *a: True)
    monkeypatch.setattr(attention_ops, "flash_attention", flash)
    monkeypatch.setattr(attention_ops, "_FLASH_MIN_SCORE_BYTES", 4 * 37 * 9)
    g = torch.Generator().manual_seed(6)
    q, k, v = (torch.randn((3, n, 128), generator=g) for n in (70, 37, 37))
    out = attention_ops.attention_pre_split(q, k, v)
    assert launched == [] and torch.allclose(out, fa.flash_attention_reference(q, k, v),
                                             atol=1e-6)
    attention_ops.attention_pre_split(*(t.bfloat16() for t in (q, k, v)))
    assert launched == [(128, torch.bfloat16)]
    with pytest.raises(ValueError, match="head dim"):
        attention_ops.attention_pre_split(*(t[..., :96].contiguous() for t in (q, k, v)))


def test_published_configuration():
    cfg = WanConfig()
    assert (cfg.num_layers, cfg.dim, cfg.num_heads, cfg.head_dim, cfg.ffn_dim, cfg.in_dim,
            cfg.out_dim, cfg.freq_dim, cfg.text_dim, cfg.text_len, cfg.eps) == (
        40, 5120, 40, 128, 13824, 36, 16, 256, 4096, 512, 1e-6)
    assert cfg.latent_shape(1) == (1, 16, 21, 60, 104)
    _, _, f, h, w = cfg.latent_shape(1)
    assert f * (h // cfg.patch_size[1]) * (w // cfg.patch_size[2]) == 32760
    assert (cfg.num_steps, cfg.guidance_scale, cfg.scheduler.shift) == (40, 5.0, 3.0)
    assert (cfg.clip_tokens, cfg.clip_dim, cfg.rope_dims) == (257, 1280, (44, 42, 42))
    model = WanTransformer3D(cfg, device="meta", dtype=torch.bfloat16)
    assert sum(p.numel() for p in model.parameters()) == 16_394_878_784
