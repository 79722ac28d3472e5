"""PyTorch port, models and diffusion: each ported module against its JAX
counterpart on the same weights (carried over by ``from_jax_params``) and
the same inputs, in f32.  Tolerance: 1e-4 relative to max |reference|.
Also the weight bridge's strictness."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import (
    assert_close, jax_variables, port_module, random_flat, svd_unet_pair, t)
from streamingt2v_tpu import config as jcfg
from streamingt2v_tpu.diffusion import denoiser as jden
from streamingt2v_tpu.diffusion import guiders as jguiders
from streamingt2v_tpu.diffusion import samplers as jsamplers
from streamingt2v_tpu.models import cam as jcam
from streamingt2v_tpu.models import clip as jclip
from streamingt2v_tpu.models import conditioner as jcond
from streamingt2v_tpu.models import controlnet as jcn
from streamingt2v_tpu.models import unet_blocks as jub
from streamingt2v_tpu.models import vae as jvae
from streamingt2v_tpu.models import video_unet as jvu
from streamingt2v_tpu.models import wrappers as jwrap
from streamingt2v_torch import config as pcfg
from streamingt2v_torch.diffusion import samplers as psamplers
from streamingt2v_torch.diffusion.denoiser import denoise
from streamingt2v_torch.diffusion.guiders import make_guider
from streamingt2v_torch.models import cam as pcam
from streamingt2v_torch.models import clip as pclip
from streamingt2v_torch.models import conditioner as pcond
from streamingt2v_torch.models import controlnet as pcn
from streamingt2v_torch.models import unet_blocks as pub
from streamingt2v_torch.models import vae as pvae
from streamingt2v_torch.models import video_unet as pvu
from streamingt2v_torch.models import wrappers as pwrap
from streamingt2v_torch.utils.weights import from_jax_params, load_jax_params

TOL = 1e-4
B, T, H, W, C = 1, 3, 4, 4, 32
HEADS, DH, CTX, EMB = 2, 16, 24, 40


def _randn(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _jit_apply(jmod, variables, *args, method=None, **kw):
    """The JAX reference, compiled once (faster than op-by-op on the CPU)."""
    fn = functools.partial(jmod.apply, **kw, **({"method": method} if method else {}))
    return jax.jit(fn)(variables, *args)


def _check(jmod, pmod, jargs, pargs=None, *, seed=0, jkw=None, pkw=None, method=None,
           pmethod=None, what=""):
    """Init the JAX module for shapes, draw weights, run both, compare."""
    jkw = jkw or {}
    pkw = pkw or {}
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), *jargs, **jkw,
                                              **({"method": method} if method else {})))
    flat = random_flat(shapes["params"], seed)
    ref = _jit_apply(jmod, jax_variables(flat), *jargs, method=method, **jkw)
    pmod = port_module(pmod, flat)
    call = getattr(pmod, pmethod) if pmethod else pmod
    with torch.no_grad():
        got = call(*(pargs if pargs is not None else [t(a) for a in jargs]), **pkw)
    for g, r in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
        assert_close(g, r, TOL, what)
    return flat


# ------------------------------------------------------- unet blocks ----

def test_feed_forward_ln_residual():
    rng = np.random.RandomState(0)
    x = _randn(rng, 10, C)
    s, b = 1 + _randn(rng, C, scale=0.1), _randn(rng, C, scale=0.1)
    _check(jub.FeedForward(C), pub.FeedForward(C, C), [jnp.asarray(x)], [t(x)],
           jkw=dict(ln=(jnp.asarray(s), jnp.asarray(b)), residual=True),
           pkw=dict(ln=(t(s), t(b)), residual=True), what="ff")


@pytest.mark.parametrize("ctx_len", [None, 5, 1])  # self / multi-token / 1-token fast path
def test_cross_attention(ctx_len):
    rng = np.random.RandomState(1)
    x = _randn(rng, 2, 12, C)
    args = [jnp.asarray(x)]
    if ctx_len is not None:
        args.append(jnp.asarray(_randn(rng, 2, ctx_len, CTX)))
    _check(jub.CrossAttention(HEADS, DH, context_dim=CTX if ctx_len else None),
           pub.CrossAttention(C, HEADS, DH, CTX if ctx_len else None), args, what="xattn")


def test_basic_transformer_block():
    rng = np.random.RandomState(2)
    x, ctx = _randn(rng, 3, 16, C), _randn(rng, 3, 2, CTX)
    _check(jub.BasicTransformerBlock(HEADS, DH, context_dim=CTX),
           pub.BasicTransformerBlock(C, HEADS, DH, CTX), [jnp.asarray(x), jnp.asarray(ctx)],
           what="basic block")


def test_video_transformer_block():
    rng = np.random.RandomState(3)
    x, ctx = _randn(rng, B * T, H * W, C), _randn(rng, B * T, 1, CTX)
    _check(jub.VideoTransformerBlock(HEADS, DH, context_dim=CTX),
           pub.VideoTransformerBlock(C, HEADS, DH, CTX), [jnp.asarray(x), jnp.asarray(ctx)],
           [t(x), t(ctx)], jkw=dict(batch=B, frames=T), pkw=dict(batch=B, frames=T),
           what="video block")


def test_spatial_video_transformer():
    rng = np.random.RandomState(4)
    x, ctx = _randn(rng, 2, T, H, W, C), _randn(rng, 2, T, 1, CTX)
    ind = np.array([[True, False, False], [False, False, False]])
    _check(jub.SpatialVideoTransformer(HEADS, DH, context_dim=CTX),
           pub.SpatialVideoTransformer(C, HEADS, DH, context_dim=CTX),
           [jnp.asarray(x), jnp.asarray(ctx), jnp.asarray(ind)],
           [t(x), t(ctx), torch.from_numpy(ind)], what="spatial video transformer")


def test_unet_res_block():
    rng = np.random.RandomState(5)
    x, emb = _randn(rng, 2, 6, 6, C), _randn(rng, 2, EMB)
    _check(jub.UNetResBlock(64), pub.UNetResBlock(C, 64, EMB),
           [jnp.asarray(x), jnp.asarray(emb)], what="unet resblock")


def test_temporal_unet_res_block():
    rng = np.random.RandomState(6)
    x, emb = _randn(rng, B, 5, H, W, C), _randn(rng, B, 5, EMB)
    bw = rng.rand(B, 5).astype(np.float32)
    _check(jub.TemporalUNetResBlock(C), pub.TemporalUNetResBlock(C, C, EMB),
           [jnp.asarray(x), jnp.asarray(emb), jnp.asarray(bw)], what="temporal resblock")


def test_unet_video_res_block():
    rng = np.random.RandomState(7)
    x, emb = _randn(rng, 2, T, H, W, C), _randn(rng, 2, T, EMB)
    ind = np.array([[False, True, False], [False, False, False]])
    _check(jub.UNetVideoResBlock(64), pub.UNetVideoResBlock(C, 64, EMB),
           [jnp.asarray(x), jnp.asarray(emb), jnp.asarray(ind)],
           [t(x), t(emb), torch.from_numpy(ind)], what="video resblock")


@pytest.mark.parametrize("kind", ["down", "up"])
def test_unet_down_up_sample(kind):
    rng = np.random.RandomState(8)
    x = _randn(rng, 2, 5, 7, C)
    jm, pm = ((jub.Downsample(48), pub.Downsample(C, 48)) if kind == "down"
              else (jub.Upsample(48), pub.Upsample(C, 48)))
    _check(jm, pm, [jnp.asarray(x)], what=kind)


def test_cam_conditional_model():
    rng = np.random.RandomState(9)
    sample, cond = _randn(rng, 2, 5, H, W, C), _randn(rng, 2, 2, H, W, C)
    _check(jcam.CAMConditionalModel(attention_head_dim=DH), pcam.CAMConditionalModel(C, DH),
           [jnp.asarray(sample), jnp.asarray(cond)], what="cam")


# ------------------------------------------------- unet / controlnet ----

def _unet_inputs(rng, ucfg, b=2, frames=5, hw=8):
    x = _randn(rng, b, frames, hw, hw, ucfg.in_channels)
    tc = _randn(rng, b)
    ctx = _randn(rng, b, frames, 1, ucfg.context_dim)
    y = _randn(rng, b, frames, ucfg.adm_in_channels)
    return x, tc, ctx, y


def test_video_unet_svd_mode():
    rng = np.random.RandomState(10)
    ucfg = jcfg.VideoUNetConfig.tiny(controlnet_mode=False)
    args = _unet_inputs(rng, ucfg)
    _check(jvu.VideoUNet(ucfg), pvu.VideoUNet(pcfg.VideoUNetConfig.tiny(controlnet_mode=False)),
           [jnp.asarray(a) for a in args], [t(a) for a in args], what="unet svd")


def test_streaming_wrapper_controlnet_and_cam():
    """VideoUNet in ControlNet mode fed by the ControlNet through
    ``streaming_wrapper`` with shared CFG ctrl frames."""
    rng = np.random.RandomState(11)
    ucfg, ccfg = jcfg.VideoUNetConfig.tiny(), jcfg.ControlNetConfig.tiny()
    f_cond = ccfg.num_conditional_frames
    x, tc, ctx, y = _unet_inputs(rng, ucfg)
    x = x[..., :4]
    concat = _randn(rng, 2, 5, 8, 8, ucfg.in_channels - 4)
    pix = 8 * 2 ** (len(ccfg.conditioning_embedding_out_channels) - 1)
    ctrl = np.repeat(_randn(rng, 1, f_cond, pix, pix, 3), 2, axis=0)
    cond = dict(concat=concat, crossattn=ctx, vector=y, ctrl_frames=ctrl)

    junet, jcnet = jvu.VideoUNet(ucfg), jcn.ControlNet(ucfg, ccfg)
    uflat = random_flat(jax.eval_shape(lambda: junet.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 2, 8, 8, 8)), jnp.zeros((1,)),
        jnp.zeros((1, 2, 1, ucfg.context_dim)), jnp.zeros((1, 2, ucfg.adm_in_channels))))["params"], 1)
    cflat = random_flat(jax.eval_shape(lambda: jcnet.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 2, 8, 8, 8)), jnp.zeros((1,)),
        jnp.zeros((1, 2, 1, ucfg.context_dim)), jnp.zeros((1, 2, ucfg.adm_in_channels)),
        jnp.zeros((1, 2, pix, pix, 3))))["params"], 2)
    jnet = jwrap.streaming_wrapper(junet, jax_variables(uflat), jcnet, jax_variables(cflat),
                                   f_cond, ctrl_cfg_shared=True)
    ref = jax.jit(jnet)(jnp.asarray(x), jnp.asarray(tc),
                        {k: jnp.asarray(v) for k, v in cond.items()})

    punet = port_module(pvu.VideoUNet(pcfg.VideoUNetConfig.tiny()), uflat)
    pcnet = port_module(pcn.ControlNet(pcfg.VideoUNetConfig.tiny(),
                                       pcfg.ControlNetConfig.tiny()), cflat)
    pnet = pwrap.streaming_wrapper(punet, pcnet, f_cond, ctrl_cfg_shared=True)
    with torch.no_grad():
        got = pnet(t(x), t(tc), {k: t(v) for k, v in cond.items()})
    assert_close(got, ref, TOL, "streaming wrapper")


def test_controlnet_features():
    rng = np.random.RandomState(12)
    ucfg, ccfg = jcfg.VideoUNetConfig.tiny(), jcfg.ControlNetConfig.tiny()
    f = ccfg.num_conditional_frames
    x, tc, ctx, y = _unet_inputs(rng, ucfg, frames=f)
    pix = 8 * 2 ** (len(ccfg.conditioning_embedding_out_channels) - 1)
    ctrl = _randn(rng, 2, f, pix, pix, 3)
    args = [x, tc, ctx, y, ctrl]
    _check(jcn.ControlNet(ucfg, ccfg),
           pcn.ControlNet(pcfg.VideoUNetConfig.tiny(), pcfg.ControlNetConfig.tiny()),
           [jnp.asarray(a) for a in args], what="controlnet")


# ----------------------------------------------------------------- vae ----

def _vae_pair(seed):
    vcfg = jcfg.VAEConfig.tiny()
    jm = jvae.AutoencoderKL(vcfg)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 2, 32, 32, 3))))
    flat = random_flat(shapes["params"], seed)
    pm = port_module(pvae.AutoencoderKL(pcfg.VAEConfig.tiny()), flat)
    return jm, jax_variables(flat), pm


def test_vae_encode_decode():
    rng = np.random.RandomState(13)
    jm, jv, pm = _vae_pair(3)
    img = rng.uniform(-1, 1, (3, 32, 24, 3)).astype(np.float32)
    ref = _jit_apply(jm, jv, jnp.asarray(img), method=jvae.AutoencoderKL.encode)
    with torch.no_grad():
        z = pm.encode(t(img))
    assert_close(z, ref, TOL, "vae encode")
    lat = _randn(rng, 1, 5, 6, 4, 4)
    ref = _jit_apply(jm, jv, jnp.asarray(lat), method=jvae.AutoencoderKL.decode)
    with torch.no_grad():
        assert_close(pm.decode(t(lat)), ref, TOL, "vae decode")


# ------------------------------------------------ clip / conditioner ----

def test_clip_preprocess_and_tower():
    rng = np.random.RandomState(14)
    img = rng.uniform(-1, 1, (2, 64, 48, 3)).astype(np.float32)
    ccfg = jclip.CLIPVisionConfig.tiny()
    ref_pix = jclip.clip_preprocess(jnp.asarray(img), ccfg.image_size)
    assert_close(pclip.clip_preprocess(t(img), ccfg.image_size), ref_pix, 1e-5, "preprocess")
    tower = jclip.CLIPVisionTower(ccfg)
    flat = _check(tower, pclip.CLIPVisionTower(pclip.CLIPVisionConfig.tiny()), [ref_pix],
                  seed=4, what="clip tower")
    ref = jax.jit(functools.partial(jclip.encode_image, tower))(jax_variables(flat),
                                                                jnp.asarray(img))
    port = port_module(pclip.CLIPVisionTower(pclip.CLIPVisionConfig.tiny()), flat)
    with torch.no_grad():
        got = pclip.encode_image(port, t(img))
    for g, r in zip(got, ref):
        assert_close(g, r, TOL, "encode_image")


@pytest.mark.parametrize("use_clip", [False, True])
def test_conditioner_pair_and_broadcast(use_clip):
    rng = np.random.RandomState(15)
    ccfg_kw = dict(clip_embed_dim=16, vector_outdim=8, use_clip=use_clip)
    img = rng.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    batch = {"cond_frames_without_noise": img,
             "cond_frames": img + 0.02 * rng.rand(*img.shape).astype(np.float32),
             "fps_id": np.full((1,), 6.0, np.float32),
             "motion_bucket_id": np.full((1,), 127.0, np.float32),
             "cond_aug": np.full((1,), 0.02, np.float32)}
    jm = jcond.Conditioner(jcfg.ConditionerConfig(**ccfg_kw), jcfg.VAEConfig.tiny(),
                           jclip.CLIPVisionConfig.tiny())
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    flat = random_flat(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jb))["params"], 5)
    c, uc = _jit_apply(jm, jax_variables(flat), jb, method=jcond.Conditioner.pair)
    pm = port_module(pcond.Conditioner(pcfg.ConditionerConfig(**ccfg_kw), pcfg.VAEConfig.tiny(),
                                       pclip.CLIPVisionConfig.tiny()), flat)
    with torch.no_grad():
        pc, puc = pm.pair({k: t(v) for k, v in batch.items()})
    for ref, got in ((c, pc), (uc, puc)):
        assert sorted(ref) == sorted(got)
        jb5, pb5 = jcond.broadcast_cond(ref, 5), pcond.broadcast_cond(got, 5)
        for k in ref:
            if float(np.abs(np.asarray(ref[k])).max()) == 0.0:
                assert float(got[k].abs().max()) == 0.0, k
            else:
                assert_close(got[k], ref[k], TOL, f"cond {k}")
                assert_close(pb5[k], jb5[k], TOL, f"broadcast {k}")


# ----------------------------------------------------------- diffusion ----

@pytest.fixture(scope="module")
def svd_pair():
    return svd_unet_pair()


def _cond_pair(rng, ucfg, b=1, frames=5):
    mk = lambda: dict(concat=_randn(rng, b, frames, 8, 8, ucfg.in_channels - 4),  # noqa: E731
                      crossattn=_randn(rng, b, frames, 1, ucfg.context_dim),
                      vector=_randn(rng, b, frames, ucfg.adm_in_channels))
    return mk(), mk()


def test_denoise(svd_pair):
    jnet, pnet, ucfg = svd_pair
    rng = np.random.RandomState(16)
    x = _randn(rng, 2, 5, 8, 8, 4)
    sigma = np.array([700.0, 0.03], np.float32)
    c, _ = _cond_pair(rng, ucfg, b=2)
    ref = jax.jit(functools.partial(jden.denoise, jnet))(
        jnp.asarray(x), jnp.asarray(sigma), {k: jnp.asarray(v) for k, v in c.items()})
    with torch.no_grad():
        got = denoise(pnet, t(x), t(sigma), {k: t(v) for k, v in c.items()})
    assert_close(got, ref, TOL, "denoise")


@pytest.mark.parametrize("kind,disc", [("linear_prediction", "align_your_steps"),
                                       ("vanilla", "edm")])
def test_euler_edm_sampler(svd_pair, kind, disc):
    """Two guided EulerEDM steps (CFG order [uc, c]) from the same noise."""
    jnet, pnet, ucfg = svd_pair
    rng = np.random.RandomState(17)
    scfg_kw = dict(num_steps=2, discretization=disc, sigma_max=80.0)
    gkw = dict(kind=kind, min_scale=1.0, max_scale=2.5, num_frames=5)
    jsc = jcfg.SamplerConfig(**scfg_kw, guider=jcfg.GuiderConfig(**gkw))
    psc = pcfg.SamplerConfig(**scfg_kw, guider=pcfg.GuiderConfig(**gkw))
    noise = _randn(rng, 1, 5, 8, 8, 4)
    c, uc = _cond_pair(rng, ucfg)
    jc, juc = ({k: jnp.asarray(v) for k, v in d.items()} for d in (c, uc))
    jsample = jsamplers.make_sampler(jsc)
    ref = jax.jit(lambda n, cc, uu: jsample(lambda x, s, k: jden.denoise(jnet, x, s, k),
                                            n, cc, uu))(jnp.asarray(noise), jc, juc)
    pc, puc = ({k: t(v) for k, v in d.items()} for d in (c, uc))
    with torch.no_grad():
        got = psamplers.make_sampler(psc)(lambda x, s, cc: denoise(pnet, x, s, cc),
                                          t(noise), pc, puc)
    assert_close(got, ref, TOL, "sampler")
    # one combine of the guider on its own
    den = _randn(rng, 2, 5, 3, 3, 4)
    assert_close(make_guider(psc.guider).combine(t(den)),
                 jguiders.make_guider(jsc.guider).combine(jnp.asarray(den)), 1e-6, "combine")


def test_unported_samplers_raise():
    """Every sampler, churn, guider and APM is ported; only an unknown kind
    raises, as in the JAX package: a sampler KeyError, a guider ValueError."""
    for kind in ("euler_edm", "heun_edm", "euler_ancestral", "dpmpp2s", "dpmpp2m", "lms"):
        psamplers.make_sampler(pcfg.SamplerConfig(kind=kind, s_churn=1.0))
    for kind in ("vanilla", "identity", "linear_prediction", "triangle_prediction"):
        make_guider(pcfg.GuiderConfig(kind=kind))
    pub.BasicTransformerBlock(C, HEADS, DH, CTX, use_apm=True, apm_tokens=17)
    for cfg_mod, make in ((jcfg, jsamplers.make_sampler), (pcfg, psamplers.make_sampler)):
        with pytest.raises(KeyError):
            make(cfg_mod.SamplerConfig(kind="ddim"))
    for cfg_mod, make in ((jcfg, jguiders.make_guider), (pcfg, make_guider)):
        with pytest.raises(ValueError):
            make(cfg_mod.GuiderConfig(kind="cfg++"))


# ------------------------------------------------------- weight bridge ----

def test_from_jax_params_layouts():
    flat = {"a/kernel": np.zeros((3, 5), np.float32),
            "b/kernel": np.zeros((3, 3, 4, 6), np.float32),
            "c/kernel": np.zeros((3, 1, 1, 4, 6), np.float32),
            "c/bias": np.zeros((6,), np.float32),
            "d/kernel": np.arange(60, dtype=np.float32).reshape(3, 4, 5),
            "norm_scale": np.ones((4,), np.float32), "alpha": np.float32(0.5)}
    sd = from_jax_params(flat)
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        "a.kernel": (5, 3), "b.kernel": (6, 4, 3, 3), "c.kernel": (3, 4, 6), "c.bias": (6,),
        "d.kernel": (5, 4, 3), "norm_scale": (4,), "alpha": ()}
    # a flax 1-D Conv kernel (k, in, out) is torch's Conv1d (out, in, k)
    assert torch.equal(sd["d.kernel"], torch.from_numpy(flat["d/kernel"]).permute(2, 1, 0))
    with pytest.raises(ValueError):
        from_jax_params({"e/kernel": np.zeros((3, 3, 3, 4, 5), np.float32)})


def test_load_jax_params_is_strict():
    jm = jub.UNetResBlock(64)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 4, C)),
                                            jnp.zeros((1, EMB))))
    flat = random_flat(shapes["params"], 0)
    load_jax_params(pub.UNetResBlock(C, 64, EMB), flat)  # exact match loads
    missing = dict(flat)
    missing.pop("emb_proj/bias")
    with pytest.raises(KeyError):
        load_jax_params(pub.UNetResBlock(C, 64, EMB), missing)
    extra = dict(flat, **{"extra/kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(KeyError):
        load_jax_params(pub.UNetResBlock(C, 64, EMB), extra)
    with pytest.raises(ValueError):
        load_jax_params(pub.UNetResBlock(C, 96, EMB), flat)  # every shape differs
    # a module with the same names and another structure is refused too
    with pytest.raises(KeyError):
        load_jax_params(pub.UNetResBlock(C, C, EMB), flat)  # no skip conv
