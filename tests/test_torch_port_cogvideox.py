"""CogVideoX text-to-video on the port (``models/cogvideox.py``,
``ops/rope.py``, ``pipeline/cogvideox.py``, ``build_cogvideox``) against
the plain reference ``tests/_cogvideox_reference.py``, at the tiny size on
the CPU: 2 blocks of 128 (2 heads of 64), text 32 wide x 8 tokens, time 32,
latents of 3 frames of 4 x 6 with 16 channels, seeded random weights with
every bias and norm parameter away from its initial value."""

from __future__ import annotations

import math
from collections import Counter

import numpy as np
import pytest
import torch

from streamingt2v_torch.config import CogVideoXConfig
from streamingt2v_torch.diffusion.ddim import DDIMConfig, DDIMScheduler
from streamingt2v_torch.models import cogvideox as cogvideox_model
from streamingt2v_torch.models.cogvideox import CogVideoXTransformer3D
from streamingt2v_torch.ops import rope
from streamingt2v_torch.pipeline.build import build_cogvideox
from streamingt2v_torch.utils import profiling

import _cogvideox_reference as ref

torch.set_num_threads(2)

CFG = CogVideoXConfig.tiny()
REF_CFG = ref.config(CFG.num_layers, CFG.num_attention_heads, CFG.attention_head_dim,
                     CFG.text_embed_dim, CFG.time_embed_dim, CFG.in_channels, CFG.patch_size)
# f32 on both sides: what is left is the order of the sums and LayerNorm's
# one-pass variance in the port against the reference's two-pass one
F32_REL = 1e-4


def relative(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


def pipeline(seed: int):
    """The tiny pipeline from ``build_cogvideox`` with every bias and norm
    parameter drawn too (``init_random_`` leaves them at 0 and 1)."""
    pipe = build_cogvideox(CFG, seed, device="cpu", bf16=False)
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
    text = (1, CFG.max_text_seq_length, CFG.text_embed_dim)
    return dict(noise=torch.randn(CFG.latent_shape(1), generator=g),
                prompt=torch.randn(text, generator=g), negative=torch.randn(text, generator=g))


def weights(pipe) -> dict:
    return {k: v.detach().clone() for k, v in pipe.transformer.state_dict().items()}


@pytest.mark.parametrize("seed", [1, 2, 2**31 + 7])
def test_transformer_matches_the_reference(seed):
    pipe, inp = pipeline(seed), inputs(seed)
    x = torch.cat([inp["noise"], 0.5 * inp["noise"]])
    text = torch.cat([inp["negative"], inp["prompt"]])
    t = torch.tensor([999, 412])
    with torch.no_grad():
        out = pipe.transformer(x, text, t)
    want = ref.forward(weights(pipe), REF_CFG, x, text, t)
    assert out.shape == want.shape == x.shape and out.dtype == torch.float32
    assert relative(out, want) < F32_REL
    # the output moves with what each kind of token carries
    assert relative(want, ref.forward(weights(pipe), REF_CFG, x, text, t, rope=False)) > 1e-2
    assert relative(want, ref.forward(weights(pipe), REF_CFG, x, text, t, qk_norm=False)) > 1e-2


def test_rope_table_is_the_formula_and_built_once_a_geometry():
    """Each token's angles, evaluated directly (f64, then f32: within one
    rounding of cos and sin); the model builds one table a grid and
    device."""
    profiling.reset_counters()
    cos, sin = rope.rope_3d(3, 2, 5, (16, 24, 24), 1e4)
    want_cos, want_sin = ref.rope_tables(3, 2, 5, (16, 24, 24), 1e4)
    assert cos.shape == sin.shape == (30, 64) and cos.dtype == torch.float32
    assert torch.allclose(cos, want_cos, rtol=0, atol=1e-7)
    assert torch.allclose(sin, want_sin, rtol=0, atol=1e-7)
    # token (f=2, h=1, w=3), channel pair 1 of the w group: 3 * 1e4^(-2/24)
    a = 3 * 1e4 ** (-2 / 24)
    assert math.isclose(float(sin[2 * 10 + 1 * 5 + 3, 40 + 2]), math.sin(a), abs_tol=1e-7)
    model = CogVideoXTransformer3D(CFG, device="meta")
    first = model.rope(3, 2, 5, "cpu")
    assert torch.equal(first[0], cos) and torch.equal(first[1], sin)
    again = model.rope(3, 2, 5, "cpu")
    assert again[0] is first[0] and again[1] is first[1]
    model.rope(3, 2, 4, "cpu")
    assert profiling.read_counters()["rope_tables"] == 3
    profiling.reset_counters()


def test_apply_rope_rotates_interleaved_pairs():
    g = torch.Generator().manual_seed(5)
    x = torch.randn((2, 30, 3, 64), generator=g)
    cos, sin = rope.rope_3d(3, 2, 5)
    out = rope.apply_rope(x, cos, sin)
    want = ref.rotate(x.transpose(1, 2), cos, sin).transpose(1, 2)
    assert torch.allclose(out, want, rtol=0, atol=1e-6)
    # a rotation keeps each pair's length
    assert torch.allclose(out.unflatten(-1, (32, 2)).norm(dim=-1),
                          x.unflatten(-1, (32, 2)).norm(dim=-1), atol=1e-5)


def test_text_tokens_are_not_rotated(monkeypatch):
    """q and k reach the attention with the text tokens as the q/k norm left
    them and every video token rotated (frame 0, row 0, column 0 has angle
    0 and so stays)."""
    pipe, inp = pipeline(3), inputs(3)
    seen = []
    real = cogvideox_model.attention

    def attention(q, k, v, *, num_heads):
        seen.append((q.clone(), k.clone()))
        return real(q, k, v, num_heads=num_heads)

    monkeypatch.setattr(cogvideox_model, "attention", attention)
    block = pipe.transformer.transformer_blocks[0]
    captured = {}

    def keep_input(mod, args):
        captured.setdefault("x", args[0])

    block.attn1.register_forward_pre_hook(keep_input)
    with torch.no_grad():
        pipe.transformer(inp["noise"], inp["prompt"], torch.tensor([500]))
    x, n_text = captured["x"], CFG.max_text_seq_length
    att, (q, k) = block.attn1, seen[0]
    b, l, _ = x.shape
    for name, lin, got in (("norm_q", att.to_q, q), ("norm_k", att.to_k, k)):
        plain = torch.nn.functional.layer_norm(
            lin(x).view(b, l, 2, 64), (64,), getattr(att, name + "_scale"),
            getattr(att, name + "_bias"), eps=cogvideox_model.QK_NORM_EPS).view(b, l, -1)
        assert torch.allclose(got[:, :n_text], plain[:, :n_text], atol=1e-5)
        assert torch.allclose(got[:, n_text], plain[:, n_text], atol=1e-5)
        moved = (got[:, n_text + 1:] - plain[:, n_text + 1:]).abs().amax(dim=-1)
        assert (moved > 1e-3).all()


def test_stage_2s_schedule_is_bit_for_bit_as_before():
    """``DDIMConfig()`` (stage 2's scheduler) still gives the scaled-linear
    cumprod computed in f64 and kept as f32, and leading spacing with
    offset 1, bit for bit."""
    s = DDIMScheduler(DDIMConfig())
    betas = np.linspace(0.00085 ** 0.5, 0.012 ** 0.5, 1000, dtype=np.float64) ** 2
    before = np.cumprod(1.0 - betas).astype(np.float32)
    assert s.alphas_cumprod.dtype == np.float32
    assert np.array_equal(s.alphas_cumprod, before)
    assert s.final_alpha_cumprod == float(np.cumprod(1.0 - betas)[0])
    for n in (30, 50, 7):
        assert np.array_equal(s.timesteps(n), (np.arange(n) * (1000 // n)).round()[::-1]
                              .astype(np.int64) + 1)


@pytest.mark.parametrize("steps", [50, 3, 7])
def test_cogvideox_schedule_is_the_reference(steps):
    """The published scheduler (zero-terminal SNR, trailing, v-prediction)
    against the reference's: the table, the timesteps and each step's
    update.  The port keeps the table in f32, the reference in f64."""
    s, want = DDIMScheduler(CogVideoXConfig().scheduler), ref.Scheduler()
    assert np.allclose(s.alphas_cumprod, want.acp, rtol=1e-6, atol=0)
    assert s.alphas_cumprod[-1] == 0.0 and s.final_alpha_cumprod == 1.0
    assert list(s.timesteps(steps)) == want.timesteps(steps)
    g = torch.Generator().manual_seed(steps)
    x, v = torch.randn(2, 3, 5, generator=g), torch.randn(2, 3, 5, generator=g)
    for t in want.timesteps(steps):
        assert torch.allclose(s.step(v, t, x, steps), want.step(v, t, x, steps), atol=1e-5)
    if steps == 50:
        assert want.timesteps(steps) == list(range(999, 0, -20))


def test_generate_matches_the_reference_loop():
    """``build_cogvideox`` then ``generate``: 3 guided steps against the
    reference's, from the same noise and embeddings."""
    pipe, inp = pipeline(4), inputs(4)
    out = pipe.generate(inp["prompt"], inp["negative"], inp["noise"])
    sched, w = ref.Scheduler(), weights(pipe)
    x = inp["noise"]
    assert pipe.timesteps() == sched.timesteps(CFG.num_steps) == [999, 666, 332]
    with torch.no_grad():
        for t in sched.timesteps(CFG.num_steps):
            x = ref.guided_step(w, REF_CFG, sched, x, t, CFG.num_steps, inp["prompt"],
                                inp["negative"], CFG.guidance_scale)
    assert out.shape == x.shape and out.dtype == torch.float32
    assert relative(out, x) < F32_REL
    assert relative(out, inp["noise"]) > 0.1


def test_spans_and_counters_of_a_step():
    pipe, inp = pipeline(5), inputs(5)
    t = pipe.timesteps()[0]
    profiling.reset_counters()
    with torch.inference_mode():
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            pipe.denoise_step(inp["noise"], 0, t, inp["prompt"], inp["negative"])
        pipe.denoise_step(inp["noise"], 0, t, inp["prompt"], inp["negative"])
    counters = profiling.read_counters()
    profiling.reset_counters()
    assert counters["steps"] == counters["dit_calls"] == 2 and counters["rope_tables"] == 1
    spans = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events() if e.name().startswith("st2v.")]
    names = Counter(n for n, _, _ in spans)
    assert names["st2v.step"] == names["st2v.dit"] == 1
    assert names["st2v.transformer"] == names["st2v.attention"] == names["st2v.ff"] \
        == CFG.num_layers
    # q and k a block; the LayerNorms of norm1, norm2, q and k a block, then
    # norm_final and norm_out's
    assert names["st2v.rope"] == 2 * CFG.num_layers
    assert names["st2v.norm"] == 4 * CFG.num_layers + 2
    assert names["st2v.modulate"] == 6 * CFG.num_layers + 1
    assert names["st2v.embed"] >= 2
    (_, a, b), = [s for s in spans if s[0] == "st2v.dit"]
    assert all(a <= x and y <= b for n, x, y in spans if n not in ("st2v.step", "st2v.dit"))


def test_published_configuration():
    cfg = CogVideoXConfig()
    assert (cfg.num_layers, cfg.inner_dim, cfg.num_attention_heads, cfg.attention_head_dim,
            cogvideox_model.FF_MULT * cfg.inner_dim, cfg.patch_size, cfg.text_embed_dim,
            cfg.max_text_seq_length, cfg.time_embed_dim) == (
        42, 3072, 48, 64, 12288, 2, 4096, 226, 512)
    assert cfg.latent_shape(1) == (1, 13, 16, 60, 90)
    _, f, _, h, w = cfg.latent_shape(1)
    assert f * (h // 2) * (w // 2) + cfg.max_text_seq_length == 17776
    assert (cfg.num_steps, cfg.guidance_scale) == (50, 6.0)
    s = cfg.scheduler
    assert (s.prediction_type, s.timestep_spacing, s.steps_offset, s.set_alpha_to_one,
            s.rescale_betas_zero_snr) == ("v_prediction", "trailing", 0, True, True)
    model = CogVideoXTransformer3D(cfg, device="meta", dtype=torch.bfloat16)
    assert sum(p.numel() for p in model.parameters()) == 5_570_283_072
