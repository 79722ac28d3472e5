"""PyTorch port, stage 2 (I2VGen-XL enhancement): DDIM, the CLIP text tower
and tokenizer, the spatial SD VAE, the I2VGen-XL UNet and ``EnhancePipeline``
against the JAX package on the same weights and the same draws, in f32 on the
CPU.

Tolerances: 1e-4 relative to max |reference| for the modules (f32 with a
different summation order on each side, as in test_torch_port_models.py);
5e-4 max-abs on the [-1, 1] video for the pipelines (measured 1.9e-5 and
4.3e-5 on the CPU: two guided DDIM steps at guidance 9 amplify
summation-order differences), the bound of the stage-1 slice test."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import (
    TEXT_TINY,
    JaxEnhanceDraws,
    assert_close,
    enhance_pair as make_enhance_pair,
    flat_for as _flat_for,
    jax_variables,
    port_module,
    t,
)
from streamingt2v_tpu.config import VAEConfig as JaxVAEConfig
from streamingt2v_tpu.diffusion import ddim as jddim
from streamingt2v_tpu.models import clip_text as jtext
from streamingt2v_tpu.models import vae as jvae
from streamingt2v_tpu.models.enhance import unet as junet
from streamingt2v_tpu.pipeline import enhance as jenh
from streamingt2v_torch import config as pcfg
from streamingt2v_torch.diffusion import ddim as pddim
from streamingt2v_torch.models import clip as pclip
from streamingt2v_torch.models import clip_text as ptext
from streamingt2v_torch.models import unet_blocks as pub
from streamingt2v_torch.models import vae as pvae
from streamingt2v_torch.models.enhance import unet as punet
from streamingt2v_torch.ops.routing import current_routing, use_routing
from streamingt2v_torch.pipeline import enhance as penh
from streamingt2v_torch.utils.rng import GeneratorEnhanceNoise

TOL = 1e-4
VIDEO_ATOL = 5e-4


# ------------------------------------------------------------------ DDIM ---

@pytest.mark.parametrize("cfg", [
    dict(),
    dict(timestep_spacing="trailing", prediction_type="v_prediction",
         rescale_betas_zero_snr=True),
    dict(timestep_spacing="linspace", beta_schedule="squaredcos_cap_v2", set_alpha_to_one=True,
         clip_sample=True),
    dict(beta_schedule="linear", prediction_type="v_prediction"),
])
def test_ddim_matches_jax(cfg):
    js = jddim.DDIMScheduler(jddim.DDIMConfig(**cfg))
    ps = pddim.DDIMScheduler(pddim.DDIMConfig(**cfg))
    np.testing.assert_array_equal(ps.alphas_cumprod, js.alphas_cumprod)
    for n, strength in [(30, 0.97), (10, 0.5), (3, 0.97)]:
        np.testing.assert_array_equal(ps.timesteps(n), js.timesteps(n))
        np.testing.assert_array_equal(ps.sdedit_timesteps(n, strength),
                                      js.sdedit_timesteps(n, strength))
    rng = np.random.RandomState(0)
    x, eps, noise = (rng.randn(1, 3, 4, 4, 2).astype(np.float32) for _ in range(3))
    for tt in (1, 34, 501, 967):
        assert_close(ps.add_noise(t(x), t(noise), tt),
                     js.add_noise(jnp.asarray(x), jnp.asarray(noise), tt), 1e-6, "add_noise")
        assert_close(ps.step(t(eps), tt, t(x), 30), js.step(jnp.asarray(eps), tt,
                                                             jnp.asarray(x), 30),
                     1e-5, f"step t={tt}")


def test_ddim_from_config_ignores_unknown():
    s = pddim.DDIMScheduler.from_config({"prediction_type": "v_prediction", "foo": 1})
    assert s.cfg.prediction_type == "v_prediction"


# ------------------------------------------------------------ CLIP text ---

def test_clip_text_tower_matches_jax():
    jcfg, pcfg_ = jtext.CLIPTextConfig(**TEXT_TINY), ptext.CLIPTextConfig(**TEXT_TINY)
    ids = ptext.CLIPTokenizer.synthetic(8)(["High Quality, HQ, detailed.", "blurry"])
    jmod = jtext.CLIPTextTower(jcfg)
    flat = _flat_for(jmod, jnp.asarray(ids))
    ref = jax.jit(jmod.apply)(jax_variables(flat), jnp.asarray(ids))
    pmod = port_module(ptext.CLIPTextTower(pcfg_), flat)
    with torch.no_grad():
        got = pmod(torch.from_numpy(ids.astype(np.int64)))
    assert_close(got, ref, TOL, "clip text")
    # causality: a later token does not change earlier positions
    ids2 = ids.copy()
    ids2[0, 5] = 3
    with torch.no_grad():
        got2 = pmod(torch.from_numpy(ids2.astype(np.int64)))
    torch.testing.assert_close(got2[0, :5], got[0, :5], rtol=0, atol=1e-6)


@pytest.mark.parametrize("text", [
    "High Quality, HQ, detailed.",
    "Distorted, blurry, discontinuous, Ugly, blurry, low resolution, motionless",
    "  spaces   &amp; 12 digits, don't, ümlauts ",
])
def test_tokenizer_ids_match_jax(text, tmp_path):
    for max_length in (8, 77):
        np.testing.assert_array_equal(ptext.CLIPTokenizer.synthetic(max_length)([text]),
                                      jtext.CLIPTokenizer.synthetic(max_length)([text]))
    # BPE from files: a small vocabulary with merges
    merges = ["#version: 0.2", "h i", "hi g", "t </w>", "e d</w>", "q u", "qu a"]
    syn = ptext.CLIPTokenizer.synthetic()
    vocab = dict(syn.encoder)
    for m in merges[1:]:
        vocab["".join(m.split())] = len(vocab)
    (tmp_path / "vocab.json").write_text(json.dumps(vocab))
    (tmp_path / "merges.txt").write_text("\n".join(merges))
    files = (str(tmp_path / "vocab.json"), str(tmp_path / "merges.txt"))
    np.testing.assert_array_equal(ptext.CLIPTokenizer.from_files(*files)([text, "high"]),
                                  jtext.CLIPTokenizer.from_files(*files)([text, "high"]))


# ------------------------------------------------------- SD VAE, CLIP ---

def test_spatial_vae_sampled_encode_and_decode_match_jax():
    vcfg = dataclasses.replace(JaxVAEConfig.tiny(), temporal_decoder=False)
    pvcfg = dataclasses.replace(pcfg.VAEConfig.tiny(), temporal_decoder=False)
    jmod = jvae.AutoencoderKL(vcfg, use_quant_conv=True)
    rng = np.random.RandomState(1)
    x = rng.uniform(-1, 1, (2, 16, 24, 3)).astype(np.float32)
    flat = _flat_for(jmod, jnp.asarray(x))
    variables = jax_variables(flat)
    key = jax.random.PRNGKey(3)
    ref_z = jmod.apply(variables, jnp.asarray(x), key, method=jvae.AutoencoderKL.encode)
    ref_mode = jmod.apply(variables, jnp.asarray(x), method=jvae.AutoencoderKL.encode)
    eps = jax.random.normal(key, ref_mode.shape, jnp.float32)
    ref_dec = jmod.apply(variables, ref_z, method=jvae.AutoencoderKL.decode)
    pmod = port_module(pvae.AutoencoderKL(pvcfg, use_quant_conv=True), flat)
    with torch.no_grad():
        got_z = pmod.encode(t(x), t(eps))
        got_mode = pmod.encode(t(x))
        got_dec = pmod.decode(t(ref_z))
    assert_close(got_z, ref_z, TOL, "sampled encode")
    assert_close(got_mode, ref_mode, TOL, "mode encode")
    assert_close(got_dec, ref_dec, TOL, "spatial decode")
    assert not np.allclose(np.asarray(ref_z), np.asarray(ref_mode))


def test_key_image_crop_and_bilinear_resize_match_jax():
    rng = np.random.RandomState(2)
    img = rng.uniform(-1, 1, (45, 80, 3)).astype(np.float32)
    sq_j = jenh.center_crop_wide(jnp.asarray(img), (80, 80))
    sq_p = penh.center_crop_wide(t(img), (80, 80))
    assert tuple(sq_p.shape) == tuple(sq_j.shape) == (45, 80, 3)
    for size in (28, 224):
        ref = jax.image.resize(sq_j, (size, size, 3), method="bilinear")
        assert_close(pclip.resize(sq_p[None], size, size, "bilinear")[0], ref, TOL, "resize")


# --------------------------------------------------------- I2VGen-XL UNet ---

def _unet_inputs(rng, b=1, frames=3, hw=8):
    return [rng.randn(b, frames, hw, hw, 4).astype(np.float32), np.array([500] * b, np.int32),
            np.array([16.0] * b, np.float32), rng.randn(b, frames, hw, hw, 4).astype(np.float32),
            rng.randn(b, 16).astype(np.float32), rng.randn(b, 7, 32).astype(np.float32)]


@pytest.fixture(scope="module")
def unet_pair():
    jmod = junet.I2VGenXLUNet(junet.I2VGenXLUNetConfig.tiny())
    args = _unet_inputs(np.random.RandomState(0))
    flat = _flat_for(jmod, *[jnp.asarray(a) for a in args])
    pmod = port_module(punet.I2VGenXLUNet(punet.I2VGenXLUNetConfig.tiny()), flat)
    return jmod, jax_variables(flat), pmod


@pytest.mark.parametrize("frames,hw", [(3, 8), (4, 6)])  # 6 -> 3 -> 6: odd skip size
def test_i2vgen_unet_matches_jax(unet_pair, frames, hw):
    jmod, variables, pmod = unet_pair
    args = _unet_inputs(np.random.RandomState(frames), frames=frames, hw=hw)
    ref = jax.jit(jmod.apply)(variables, *[jnp.asarray(a) for a in args])
    with torch.no_grad():
        got = pmod(*[torch.from_numpy(a) for a in args])
    assert got.dtype == torch.float32
    assert_close(got, ref, TOL, "i2vgen unet")


def test_adaptive_avg_pool_matches_jax():
    x = np.random.RandomState(4).randn(2, 45, 80, 3).astype(np.float32)
    ref = junet.adaptive_avg_pool_2d(jnp.asarray(x), (32, 32))
    assert_close(punet.adaptive_avg_pool_2d(t(x), (32, 32)), ref, 1e-5, "pool")


def test_routing_on_matches_routing_off(unet_pair, monkeypatch):
    """Stage 2's routing (K2, K5, K6 routes; plain versions on the CPU)
    computes what the default routing computes, and under either the
    temporal self-attentions reach ``ops.temporal_attention`` with the
    spatial-major q/k/v, without the head-folding transposes."""
    _, _, pmod = unet_pair
    seen = []
    real = pub.temporal_attention

    def spy(q, k, v, **kw):
        seen.append((tuple(q.shape), kw["batch"], kw["frames_q"], kw["num_heads"]))
        return real(q, k, v, **kw)

    monkeypatch.setattr(pub, "temporal_attention", spy)
    args = [torch.from_numpy(a) for a in _unet_inputs(np.random.RandomState(5))]
    with torch.no_grad():
        off = pmod(*args)
        seen_off = list(seen)
        seen.clear()
        with use_routing(pcfg.EnhanceConfig().routing):
            assert current_routing() == pcfg.KernelRouting.all_on()
            on = pmod(*args)
    assert current_routing() == pcfg.KernelRouting()
    # five temporal transformers (transformer_in with 8 heads of 8 at 8x8, the
    # level-0 down block with 2 heads, mid, two level-0 up blocks), each with
    # two self-attentions
    assert ((3, 64, 64), 1, 3, 8) in seen and ((3, 64, 16), 1, 3, 2) in seen
    assert len(seen) == 2 * 5 and seen_off == seen
    assert_close(on, off.numpy(), 1e-5, "routing on vs off")


# ------------------------------------------------------------- pipeline ---

ENH = dict(num_steps=3, height=32, width=32, chunk_size=4, overlap_size=2,
           use_randomized_blending=True, vae_bf16=False)
SEED = 8888


@pytest.fixture(scope="module")
def enhance_pair():
    """(jax pipeline, port pipeline) on identical weights: the tiny configs
    of tests/test_enhance.py, with a 514-token text tower so that the
    synthetic tokenizer's ids fit."""
    return make_enhance_pair(ENH)


def _video(rng, frames, size=32):
    return rng.uniform(-1, 1, (frames, size, size, 3)).astype(np.float32)


def _check_video(got, ref, frames):
    ref = np.asarray(ref)
    assert tuple(got.shape) == ref.shape == (frames, 32, 32, 3)
    # the comparison means something only if the video is not clipped flat
    assert np.mean(np.abs(ref) < 0.999) > 0.5 and ref.std() > 0.05
    err = float(np.abs(got.numpy() - ref).max())
    assert err <= VIDEO_ATOL, f"stage-2 video max-abs err {err:.3e} > {VIDEO_ATOL}"


def test_encode_prompts_matches_jax(enhance_pair):
    jpipe, pipe = enhance_pair
    assert_close(pipe.encode_prompts(), jpipe.encode_prompts(), TOL, "prompts")


def test_enhance_blending_matches_jax(enhance_pair):
    """8 frames, chunk 4, overlap 2: three blended chunks, each on its own
    key image, prompts through the synthetic tokenizer and the text tower."""
    jpipe, pipe = enhance_pair
    rng = np.random.RandomState(0)
    video = _video(rng, 8)
    keys = [_video(rng, 1)[0] for _ in range(3)]
    ref = jpipe.enhance(jnp.asarray(video), [jnp.asarray(k) for k in keys],
                        use_randomized_blending=True)
    draws = JaxEnhanceDraws(SEED)
    got = pipe.enhance(t(video), [t(k) for k in keys], use_randomized_blending=True,
                       noise=draws)
    # every chunk but the first draws an offset at each of the 2 DDIM steps
    assert sorted(u for u in draws.used if u[0] == "offset") == [
        ("offset", s, c) for s in (0, 1) for c in (1, 2)]
    _check_video(got, ref, 8)


def test_enhance_with_keyframe_prepass_matches_jax(enhance_pair):
    jpipe, pipe = enhance_pair
    rng = np.random.RandomState(1)
    video, image = _video(rng, 9), _video(rng, 1)[0]
    ref = jpipe.enhance_with_keyframe_prepass(jnp.asarray(video), jnp.asarray(image))
    draws = JaxEnhanceDraws(SEED)
    got = pipe.enhance_with_keyframe_prepass(t(video), t(image), noise=draws)
    # the pre-pass encodes the 3 key frames, the main pass 8 of the 9 frames
    assert ("latent", 0, (1, 3, 16, 16, 4)) in draws.used
    assert ("latent", 0, (1, 8, 16, 16, 4)) in draws.used
    _check_video(got, ref, 8)


def test_enhance_bad_chunking_raises(enhance_pair):
    _, pipe = enhance_pair
    video = torch.zeros((7, 32, 32, 3))
    pe = torch.zeros((2, 7, 32))
    with pytest.raises(ValueError, match="not divisible"):
        pipe.enhance(video, [video[0]] * 2, prompt_embeds=pe, use_randomized_blending=True)


def test_enhance_default_noise_is_seeded(enhance_pair):
    """Without injected draws the port draws from address-seeded
    generators: the same seed repeats, another seed differs."""
    _, pipe = enhance_pair
    rng = np.random.RandomState(2)
    video = t(_video(rng, 4))
    pe = t(rng.randn(2, 7, 32).astype(np.float32))
    kw = dict(prompt_embeds=pe, use_randomized_blending=False)
    v1 = pipe.enhance(video, [video[0]], seed=1, **kw)
    v2 = pipe.enhance(video, [video[0]], seed=1, **kw)
    v3 = pipe.enhance(video, [video[0]], seed=2, **kw)
    assert torch.equal(v1, v2) and not torch.allclose(v1, v3)
    noise = GeneratorEnhanceNoise(5, "cpu")
    assert torch.equal(noise.normal("latent", 0, (3,)), noise.normal("latent", 0, (3,)))
    assert all(0 <= noise.offset(s, c, 4) < 4 for s in range(3) for c in range(3))
