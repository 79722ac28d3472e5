"""The port's tracing (``streamingt2v_torch/utils/profiling.py``): its spans
at call, step, network and block level as a profiler sees them in the
tiny stage-1 chunk, stage-2 step and stage-1 decode, the counters beside
them, the no-op a span is without a profiler, and the launch counters."""

from __future__ import annotations

import dataclasses
from collections import Counter

import pytest
import torch

from streamingt2v_torch.config import DTypePolicy, EnhanceConfig, PipelineConfig, VAEConfig
from streamingt2v_torch.diffusion.ddim import DDIMScheduler
from streamingt2v_torch.models.enhance.unet import I2VGenXLUNet, I2VGenXLUNetConfig
from streamingt2v_torch.models.layers import init_random_
from streamingt2v_torch.models.vae import AutoencoderKL
from streamingt2v_torch.pipeline.build import build_pipeline
from streamingt2v_torch.pipeline.enhance import EnhanceModels, EnhancePipeline
from streamingt2v_torch.utils import profiling

# xdist runs several workers on one machine
torch.set_num_threads(2)

NETWORKS = {"st2v.unet", "st2v.controlnet", "st2v.vae_decoder"}
BLOCKS = {"st2v.norm", "st2v.attention", "st2v.ff", "st2v.conv", "st2v.blend", "st2v.embed",
          "st2v.cam", "st2v.resblock", "st2v.transformer"}
# the spans and counters each unit opens, beyond its blocks
EXPECTED = {
    "stream_chunk": {"st2v.chunk", "st2v.step", "st2v.unet", "st2v.controlnet", "st2v.cam",
                     "st2v.blend"},
    "denoise_step": {"st2v.step", "st2v.unet"},
    "decode_video": {"st2v.decode", "st2v.vae_decoder"},
}
COUNTED = {"steps": "st2v.step", "unet_calls": "st2v.unet",
           "controlnet_calls": "st2v.controlnet", "vae_decoder_calls": "st2v.vae_decoder"}


class _Offsets:
    """The write-back's offsets, fixed: ``_denoise_step`` draws nothing else."""

    def offset(self, step: int, chunk: int, high: int) -> int:
        return (step + chunk) % high


def _stage1_unit(unit: str):
    cfg = PipelineConfig.tiny()
    pipe = build_pipeline(cfg, seed=3, device="cpu")
    g = torch.Generator().manual_seed(3)
    inf = cfg.inference
    shape = pipe.latent_shape(inf.chunk_frames)
    if unit == "decode_video":
        z = torch.randn(shape, generator=g)
        return lambda: pipe.decode_video(z), {"pieces": -(-inf.chunk_frames
                                                          // inf.decode_chunk_size)}
    image = torch.rand((1, cfg.height, cfg.width, 3), generator=g) * 2 - 1
    c, uc = pipe.condition(image, torch.rand(image.shape, generator=g))
    ctrl = torch.rand((1, inf.num_conditional_frames, cfg.height, cfg.width, 3), generator=g)
    c["ctrl_frames"] = uc["ctrl_frames"] = ctrl * 2 - 1
    noise = torch.randn(shape, generator=g)
    return lambda: pipe.stream_chunk(c, uc, noise), {"steps": cfg.sampler.num_steps}


def _stage2_unit():
    ucfg = dataclasses.replace(I2VGenXLUNetConfig.tiny(), dtypes=DTypePolicy.fp32())
    unet = init_random_(I2VGenXLUNet(ucfg, device="cpu").eval(), torch.Generator().manual_seed(4))
    vae = AutoencoderKL(dataclasses.replace(VAEConfig.tiny(), temporal_decoder=False),
                        use_quant_conv=True, device="meta")
    ecfg = dataclasses.replace(EnhanceConfig(), num_steps=3, chunk_size=4, overlap_size=2,
                               height=32, width=32, vae_bf16=False)
    pipe = EnhancePipeline(ecfg, EnhanceModels(unet=unet, vae=vae, clip_vision=None,
                                               text_encoder=None, scheduler=DDIMScheduler()))
    g = torch.Generator().manual_seed(4)
    chunks, size, stride, hw = 2, 4, 2, 4
    latents = torch.randn((1, stride * (chunks - 1) + size, hw, hw, 4), generator=g)
    prompt = torch.randn((2, 5, ucfg.cross_attention_dim), generator=g)
    clip = torch.randn((chunks, 2, ucfg.image_embed_dim), generator=g)
    image_latents = torch.randn((chunks, 2, size, hw, hw, 4), generator=g)
    t = int(pipe.m.scheduler.sdedit_timesteps(ecfg.num_steps, ecfg.strength)[0])

    def run():
        return pipe._denoise_step(latents, 0, t, prompt, clip, image_latents, _Offsets(),
                                  chunk_size=size, stride=stride, overlap_size=size - stride)
    return run, {"steps": 1, "unet_calls": 2 * chunks}


@pytest.fixture(scope="module", params=sorted(EXPECTED))
def traced(request):
    """(unit, its expected counts, its spans (name, start, end), the
    counters it left) for one unit run under the profiler."""
    unit = request.param
    run, want = _stage2_unit() if unit == "denoise_step" else _stage1_unit(unit)
    with torch.inference_mode():
        profiling.reset_counters()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            run()
        counters = profiling.read_counters()
    spans = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events() if e.name().startswith("st2v.")]
    return unit, want, spans, counters


def _inside(span, outer, names) -> bool:
    _, a, b = span
    return any(n in names and x <= a and b <= y for n, x, y in outer)


def test_spans_are_named_nested_and_counted(traced):
    """Each unit opens its call, step and network spans and block spans;
    every block span lies inside a network span and every network span
    inside a step (the decode's inside ``st2v.decode``); one step span per
    sampler step, one UNet and one ControlNet call per stage-1 step, two
    UNet calls per chunk in a stage-2 step."""
    unit, want, spans, _ = traced
    names = Counter(n for n, _, _ in spans)
    assert EXPECTED[unit] <= set(names), names
    assert set(names) <= EXPECTED[unit] | BLOCKS, names
    assert {"st2v.norm", "st2v.conv", "st2v.resblock"} <= set(names)
    if unit != "decode_video":
        assert {"st2v.attention", "st2v.ff", "st2v.transformer", "st2v.embed"} <= set(names)
    nets = [s for s in spans if s[0] in NETWORKS]
    assert all(_inside(s, nets, NETWORKS) for s in spans if s[0] in BLOCKS)
    outer = "st2v.decode" if unit == "decode_video" else "st2v.step"
    assert nets and all(_inside(s, spans, {outer}) for s in nets)
    if unit == "stream_chunk":
        assert names["st2v.step"] == names["st2v.unet"] == names["st2v.controlnet"] \
            == want["steps"]
        assert names["st2v.chunk"] == 1
    elif unit == "denoise_step":
        assert names["st2v.step"] == want["steps"]
        assert names["st2v.unet"] == want["unet_calls"]
    else:
        assert names["st2v.decode"] == 1 and names["st2v.vae_decoder"] == want["pieces"]


def test_counters_match_the_spans(traced):
    unit, _, spans, counters = traced
    names = Counter(n for n, _, _ in spans)
    for counter, span_name in COUNTED.items():
        assert counters.get(counter, 0) == names[span_name], (unit, counter)
    assert counters.get("decode_pieces", 0) == names["st2v.vae_decoder"]


def test_span_without_a_profiler_is_the_shared_no_op():
    """No profiler: ``span`` returns one shared no-op per name, which records
    nothing, as a context manager and as a decorator; with a profiler, a
    ``record_function`` range, and a function decorated before it started
    is recorded on every call."""
    assert not torch.autograd._profiler_enabled()
    off = profiling.span("st2v.norm")
    assert off is profiling.span("st2v.norm") and not isinstance(
        off, torch.profiler.record_function)

    @profiling.span("st2v.ff")
    def twice(x):
        return 2 * x

    with off as entered:
        assert entered is None
        assert twice(3) == 6
    assert twice.__name__ == "twice"
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert isinstance(profiling.span("st2v.norm"), torch.profiler.record_function)
        with profiling.span("st2v.norm"):
            assert twice(1) == 2
        assert twice(2) == 4
    names = Counter(e.name() for e in prof.profiler.kineto_results.events())
    assert names["st2v.norm"] == 1 and names["st2v.ff"] == 2


def test_read_launches_keys_and_values():
    """``read_launches`` keeps its keys and order: each wrapper, the flash
    wrappers' D=512 launches apart, the f32 launches of K1, K2, K4, K6 and
    K5's affine entry only when asked; ``count_launch`` adds to each,
    ``reset_launches`` zeroes them and leaves the other counters."""
    profiling.reset_counters()
    base = ["flash_attention", "flash_attention_d512", "flash_attention_packed",
            "flash_attention_packed_d512", "geglu_ff", "temporal_conv", "fused_group_norm",
            "fused_temporal_attention", "fused_group_norm_affine"]
    assert list(profiling.read_launches()) == base
    assert list(profiling.read_launches(f32=True)) == [
        "flash_attention", "flash_attention_d512", "flash_attention_f32",
        "flash_attention_packed", "flash_attention_packed_d512", "flash_attention_packed_f32",
        "geglu_ff", "temporal_conv", "temporal_conv_f32", "fused_group_norm",
        "fused_temporal_attention", "fused_temporal_attention_f32", "fused_group_norm_affine",
        "fused_group_norm_affine_f32"]
    profiling.count_launch("flash_attention", d512=True)
    profiling.count_launch("flash_attention", f32=True)
    profiling.count_launch("temporal_conv", f32=True)
    profiling.count_launch("geglu_ff")
    profiling.count("steps", 4)
    got = profiling.read_launches(f32=True)
    assert {k: v for k, v in got.items() if v} == {
        "flash_attention": 2, "flash_attention_d512": 1, "flash_attention_f32": 1,
        "geglu_ff": 1, "temporal_conv": 1, "temporal_conv_f32": 1}
    assert all(isinstance(v, int) for v in got.values())
    profiling.reset_launches()
    assert not any(profiling.read_launches(f32=True).values())
    assert profiling.read_counters() == {"steps": 4}
    profiling.reset_counters()


def test_timing_report_carries_the_counters():
    saved = dict(profiling._STAGE_TIMES)
    profiling.reset_timers()
    try:
        with profiling.stage_timer("s"):
            profiling.count("unet_calls", 2)
        report = profiling.timing_report()
        assert report["counters"] == {"unet_calls": 2}
        assert profiling.stage_seconds() == {"s": report["s"]["total_s"]}
        profiling.reset_timers()
        assert profiling.timing_report() == {}
    finally:
        profiling._STAGE_TIMES.update(saved)
