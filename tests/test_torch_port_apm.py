"""PyTorch port, APM (the Appearance Preservation Module): the context mixer,
the APM transformer block, the conditioner's per-frame CLIP tokens, the
anchor gather over the video so far, the loader's behaviour under
``use_apm`` and the tiny stage 1 with a 3+1-token APM context, each against
the JAX package on the same weights and inputs, in f32.

``apm_alpha`` is zero at init and silu(0) = 0, so a mixer at its init value
is the identity on the first token and proves nothing about the mixer:
every case draws ``apm_alpha`` away from zero, and the init value has its
own cases (the identity, and the APM UNet equal to the same weights without
APM).  Tolerances: 1e-4 relative to max |reference| for the modules, 5e-4
max-abs on the [-1, 1] stage-1 video (those of
``tests/test_torch_port_models.py`` and ``test_torch_port_stage1.py``)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import (
    Stage1Draws, assert_close, jax_stage1_draws, jax_variables, port_module, random_flat,
    stage1_pair, t)
from streamingt2v_tpu import config as jcfg
from streamingt2v_tpu.models import clip as jclip
from streamingt2v_tpu.models import conditioner as jcond
from streamingt2v_tpu.models import unet_blocks as jub
from streamingt2v_tpu.models import video_unet as jvu
from streamingt2v_tpu.utils.checkpoint import flatten_params
from streamingt2v_torch import config as pcfg
from streamingt2v_torch.models import clip as pclip
from streamingt2v_torch.models import conditioner as pcond
from streamingt2v_torch.models import unet_blocks as pub
from streamingt2v_torch.models import video_unet as pvu

TOL = 1e-4
VIDEO_ATOL = 5e-4
ALPHA = 1.3   # silu(1.3) = 1.02: the mixed token weighs as much as the first


def _shapes(jmod, *args):
    return jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), *args))["params"]


def _with_alpha(flat: dict, alpha) -> dict:
    """``flat`` with every ``apm_alpha`` set: a number, or None for a draw
    per mixer of ALPHA plus noise."""
    rng = np.random.RandomState(3)
    out = dict(flat)
    for k in flat:
        if k.endswith("apm_alpha"):
            a = ALPHA + 0.2 * rng.randn() if alpha is None else alpha
            out[k] = np.asarray(a, np.float32)
    return out


@pytest.mark.parametrize("alpha", [None, 0.0], ids=["drawn", "init"])
def test_apm_context_mixer(alpha):
    ctx = np.random.RandomState(0).randn(2, 17, 32).astype(np.float32)
    jm = jub.APMContextMixer()
    flat = _with_alpha(random_flat(_shapes(jm, jnp.asarray(ctx)), 1), alpha)
    ref = jax.jit(jm.apply)(jax_variables(flat), jnp.asarray(ctx))
    pm = port_module(pub.APMContextMixer(17, 32), flat)
    with torch.no_grad():
        got = pm(t(ctx))
        one = pm(t(ctx[:, :1]))
    assert tuple(got.shape) == (2, 1, 32)
    assert_close(got, ref, TOL, "mixer")
    if alpha == 0.0:   # the identity on the first token, as at init
        assert torch.equal(got, t(ctx[:, :1]))
    else:
        assert float((got - t(ctx[:, :1])).abs().max()) > 0.1
    assert torch.equal(one, t(ctx[:, :1]))   # a one-token context passes through


def test_apm_mixer_init_is_the_identity():
    """``init_random_`` gives the mixer the JAX init: lecun conv, unit LN
    scale, zero bias and zero ``apm_alpha``."""
    from streamingt2v_torch.models.layers import init_random_

    pm = init_random_(pub.APMContextMixer(17, 32), torch.Generator().manual_seed(0))
    assert float(pm.apm_alpha) == 0.0 and float(pm.apm_conv.kernel.abs().max()) > 0
    assert tuple(pm.apm_conv.kernel.shape) == (1, 17, 3)
    ctx = torch.randn(2, 17, 32)
    assert torch.equal(pm(ctx), ctx[:, :1])


@pytest.mark.parametrize("alpha", [None, 0.0], ids=["drawn", "init"])
def test_apm_unet_block(alpha):
    """The JAX ``tests/test_aux_components.py`` block case: the mixer runs on
    the 17-token context before both attentions."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 16).astype(np.float32)
    ctx = np.random.RandomState(1).randn(2, 17, 32).astype(np.float32)
    jm = jub.BasicTransformerBlock(heads=2, dim_head=8, context_dim=32, use_apm=True)
    shapes = _shapes(jm, jnp.asarray(x), jnp.asarray(ctx))
    assert "apm" in shapes
    flat = _with_alpha(random_flat(shapes, 2), alpha)
    ref = jax.jit(jm.apply)(jax_variables(flat), jnp.asarray(x), jnp.asarray(ctx))
    pm = port_module(pub.BasicTransformerBlock(16, 2, 8, 32, use_apm=True, apm_tokens=17), flat)
    with torch.no_grad():
        got = pm(t(x), t(ctx))
    assert_close(got, ref, TOL, "apm block")
    if alpha == 0.0:   # the same weights without APM on the first token
        plain = port_module(pub.BasicTransformerBlock(16, 2, 8, 32),
                            {k: v for k, v in flat.items() if not k.startswith("apm/")})
        with torch.no_grad():
            assert torch.equal(got, plain(t(x), t(ctx[:, :1])))


def _tiny_unet_flat(ucfg, n_ctx: int, seed: int):
    jm = jvu.VideoUNet(ucfg)
    return jm, random_flat(_shapes(jm, jnp.zeros((1, 2, 8, 8, ucfg.in_channels)),
                                   jnp.zeros((1,)), jnp.zeros((1, 2, n_ctx, ucfg.context_dim)),
                                   jnp.zeros((1, 2, ucfg.adm_in_channels))), seed)


def _unet_inputs(ucfg, n_ctx: int, seed: int):
    rng = np.random.RandomState(seed)
    return (rng.randn(1, 3, 8, 8, ucfg.in_channels).astype(np.float32),
            np.array([0.7], np.float32),
            rng.randn(1, 3, n_ctx, ucfg.context_dim).astype(np.float32),
            rng.randn(1, 3, ucfg.adm_in_channels).astype(np.float32))


def test_apm_unet_matches_jax():
    """The tiny streaming-UNet config with APM and a 4-token context, drawn
    ``apm_alpha``: the spatial blocks mix the tokens, the temporal blocks
    attend to all four (frame 0's row)."""
    ucfg = dataclasses.replace(jcfg.VideoUNetConfig.tiny(controlnet_mode=False), use_apm=True)
    jm, flat = _tiny_unet_flat(ucfg, 4, seed=4)
    flat = _with_alpha(flat, None)
    args = _unet_inputs(ucfg, 4, seed=5)
    ref = jax.jit(jm.apply)(jax_variables(flat), *(jnp.asarray(a) for a in args))
    pcfg_u = dataclasses.replace(pcfg.VideoUNetConfig.tiny(controlnet_mode=False), use_apm=True)
    pm = port_module(pvu.VideoUNet(pcfg_u, apm_tokens=4), flat)
    with torch.no_grad():
        got = pm(*(t(a) for a in args))
    assert_close(got, ref, TOL, "apm unet")


def test_apm_unet_at_alpha_zero_equals_the_unet_without_apm():
    """With ``apm_alpha`` = 0 every mixer gives the first token, so with the
    temporal cross-attention off (the context then enters through the
    spatial blocks only) the APM UNet on four tokens is the same weights
    without APM on the first token, to the bit."""
    kw = dict(controlnet_mode=False, disable_temporal_crossattention=True)
    ucfg = dataclasses.replace(jcfg.VideoUNetConfig.tiny(), use_apm=True, **kw)
    _, flat = _tiny_unet_flat(ucfg, 4, seed=6)
    flat = _with_alpha(flat, 0.0)
    apm = port_module(pvu.VideoUNet(dataclasses.replace(
        pcfg.VideoUNetConfig.tiny(), use_apm=True, **kw), apm_tokens=4), flat)
    plain = port_module(pvu.VideoUNet(dataclasses.replace(pcfg.VideoUNetConfig.tiny(), **kw)),
                        {k: v for k, v in flat.items() if "/apm/" not in k})
    x, tc, ctx, y = (t(a) for a in _unet_inputs(ucfg, 4, seed=7))
    with torch.no_grad():
        # (the mixer's first token is a contiguous copy: the same layout here)
        assert torch.equal(apm(x, tc, ctx, y), plain(x, tc, ctx[:, :, :1].contiguous(), y))


@pytest.mark.parametrize("use_clip", [False, True])
def test_conditioner_encode_frames(use_clip):
    """The APM tokens, (B, N, H, W, 3) -> (B, N, D): the tiny configs' toy
    CLIP projection and the CLIP tower (with ``clip_preprocess``)."""
    rng = np.random.RandomState(8)
    kw = dict(clip_embed_dim=16, vector_outdim=8, use_clip=use_clip)
    frames = rng.uniform(-1, 1, (2, 3, 32, 32, 3)).astype(np.float32)
    jm = jcond.Conditioner(jcfg.ConditionerConfig(**kw), jcfg.VAEConfig.tiny(),
                           jclip.CLIPVisionConfig.tiny())
    batch = {"cond_frames_without_noise": jnp.zeros((1, 32, 32, 3)),
             "cond_frames": jnp.zeros((1, 32, 32, 3)), "fps_id": jnp.zeros((1,)),
             "motion_bucket_id": jnp.zeros((1,)), "cond_aug": jnp.zeros((1,))}
    flat = random_flat(_shapes(jm, batch), 9)
    ref = jax.jit(functools.partial(jm.apply, method=jcond.Conditioner.encode_frames))(
        jax_variables(flat), jnp.asarray(frames))
    pm = port_module(pcond.Conditioner(pcfg.ConditionerConfig(**kw), pcfg.VAEConfig.tiny(),
                                       pclip.CLIPVisionConfig.tiny()), flat)
    with torch.no_grad():
        got = pm.encode_frames(t(frames))
    assert tuple(got.shape) == (2, 3, ref.shape[-1])
    assert_close(got, ref, TOL, "encode_frames")


# ------------------------------------------------------------- stage 1 ---

FRAMES = 8    # the first chunk of 5 + one generation (2 conditional frames, 3 kept)
SEED = 41


def _apm_cfg(cfg_cls, anchors=(0, 3)):
    cfg = cfg_cls.tiny()
    return dataclasses.replace(
        cfg, unet=dataclasses.replace(cfg.unet, use_apm=True),
        inference=dataclasses.replace(cfg.inference, apm_anchor_frames=anchors,
                                      vae_decode_bf16=False))


@pytest.fixture(scope="module")
def apm_pair():
    """(JAX, port) tiny APM stage 1 on identical weights, every ``apm_alpha``
    drawn near ALPHA."""
    jpipe, pipe = stage1_pair(_apm_cfg(jcfg.PipelineConfig), _apm_cfg(pcfg.PipelineConfig),
                              seed=10)
    unet = pipe.models.unet
    mixers = [m for m in unet.modules() if isinstance(m, pub.APMContextMixer)]
    assert mixers and all(tuple(m.apm_conv.kernel.shape) == (1, 4, 3) for m in mixers)
    flat = {k: np.array(v) for k, v in flatten_params(jpipe.models.unet_params["params"]).items()}
    flat = _with_alpha(flat, None)
    port_module(unet, flat)
    jpipe.models = dataclasses.replace(jpipe.models, unet_params=jax_variables(flat))
    # the first-chunk UNet and the ControlNet take no APM
    for m in (pipe.models.svd_unet, pipe.models.controlnet):
        assert not any(isinstance(x, pub.APMContextMixer) for x in m.modules())
    return jpipe, pipe


def test_stage1_with_apm_matches_jax(apm_pair):
    jpipe, pipe = apm_pair
    cfg = pipe.cfg
    image = (np.random.RandomState(2).rand(cfg.height, cfg.width, 3) * 2 - 1).astype(np.float32)
    n_gen = cfg.n_autoregressions(FRAMES)
    assert n_gen == 1
    ref = np.asarray(jpipe.image_to_video(jnp.asarray(image), num_frames=FRAMES, seed=SEED))
    noise = Stage1Draws(jax_stage1_draws(jpipe.cfg, SEED,
                                         pipe.latent_shape(cfg.inference.chunk_frames),
                                         (1,) + image.shape, n_gen))
    calls = []
    encode = pipe.encode_apm
    pipe.encode_apm = lambda frames: calls.append(tuple(frames.shape)) or encode(frames)
    try:
        video = pipe.image_to_video(t(image), num_frames=FRAMES, seed=SEED, noise=noise)
    finally:
        del pipe.encode_apm
    assert calls == [(1, 3, cfg.height, cfg.width, 3)]
    assert sorted(noise.used) == sorted(noise.draws)
    assert np.mean(np.abs(ref) < 0.999) > 0.5 and ref.std() > 0.05
    err = float(np.abs(video.numpy() - ref).max())
    assert err <= VIDEO_ATOL, f"APM stage-1 video max-abs err {err:.3e} > {VIDEO_ATOL}"


def test_apm_frames_wrap_around(apm_pair):
    """The anchor gather: frame i of [a, b) is frame i % total of the video
    so far, whatever chunk holds it."""
    _, pipe = apm_pair
    p = dataclasses.replace(pipe.cfg, inference=dataclasses.replace(
        pipe.cfg.inference, apm_anchor_frames=(2, 19)))
    chunks = [torch.arange(n, dtype=torch.float32).reshape(1, n, 1, 1, 1) + 10 * j
              for j, n in enumerate((5, 3, 3))]
    video = torch.cat(chunks, dim=1)
    got = type(pipe)(p, pipe.models).apm_frames(chunks)
    assert torch.equal(got, video[:, [i % 11 for i in range(2, 19)]])


def test_stage1_loader_with_apm_raises_as_jax(tmp_path, apm_pair):
    """The reference's ``filter_ckpt`` drops the APM image encoder, so no
    checkpoint map carries the mixers: both packages' strict stage-1 loaders
    refuse a ``use_apm`` configuration, naming an APM parameter."""
    import chip_smoke
    from streamingt2v_tpu.utils import loader as jloader
    from streamingt2v_torch.pipeline.build import build_pipeline
    from streamingt2v_torch.utils import loader

    jpipe, pipe = apm_pair
    plain = build_pipeline(pcfg.PipelineConfig.tiny(), seed=1, device="cpu")
    chip_smoke.write_reference_tree(str(tmp_path), stage1=plain)
    with pytest.raises(KeyError, match="apm"):
        jloader.load_stage1_checkpoints(jpipe, str(tmp_path))
    with pytest.raises(KeyError, match="apm"):
        loader.load_stage1_checkpoints(pipe.cfg, str(tmp_path), device="cpu", bf16=False)
