"""Shared pieces of the PyTorch-port parity tests (tests/test_torch_port_*.py).

Both packages get the same inputs and weights, made with numpy from a seed.
Weight trees take their paths and shapes from the JAX module's own init;
their values are drawn here (lecun-scaled kernels, perturbed norms and
non-zero biases, blend factors and zero-initialised output layers), so
that no branch of either model is silenced by a zero initialiser.
"""

from __future__ import annotations

import numpy as np
import torch

from streamingt2v_tpu.utils.checkpoint import flatten_params, unflatten_params
from streamingt2v_torch.utils.weights import load_jax_params

# xdist runs several workers on one machine
torch.set_num_threads(2)


def random_flat(params, seed: int) -> dict:
    """Numpy f32 values for every leaf of a flax ``params`` tree, keyed by
    its flattened path."""
    rng = np.random.RandomState(seed)
    out = {}
    for path, leaf in sorted(flatten_params(params).items()):
        shape = tuple(leaf.shape)
        name = path.rsplit("/", 1)[-1]
        if name in ("kernel", "proj") and len(shape) >= 2:
            a = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif name.endswith("_scale"):
            a = 1.0 + 0.1 * rng.randn(*shape)
        else:
            a = 0.1 * rng.randn(*shape)
        out[path] = np.asarray(a, dtype=np.float32)   # a 0-d leaf draws a float
    return out


def jax_variables(flat: dict) -> dict:
    import jax.numpy as jnp

    return {"params": unflatten_params({k: jnp.asarray(v) for k, v in flat.items()})}


def port_module(module: torch.nn.Module, flat: dict) -> torch.nn.Module:
    return load_jax_params(module, flat).eval()


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def assert_close(got, ref, rel: float, what: str = "") -> float:
    """max |got - ref| <= rel * max |ref|; returns the relative error."""
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor) else got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    assert np.all(np.isfinite(got)), what
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got - ref).max()) / scale
    assert err <= rel, f"{what}: max abs err {err * scale:.3e} = {err:.3e} of max|ref| > {rel}"
    return err


# ------------------------------------------------- pipelines and draws ---

def svd_unet_pair(seed: int = 6):
    """(JAX openai_wrapper, port openai_wrapper, JAX UNet config): the tiny
    first-chunk VideoUNet on identical ``random_flat`` weights."""
    import jax
    import jax.numpy as jnp

    from streamingt2v_tpu import config as jcfg
    from streamingt2v_tpu.models import video_unet as jvu
    from streamingt2v_tpu.models import wrappers as jwrap
    from streamingt2v_torch import config as pcfg
    from streamingt2v_torch.models import video_unet as pvu
    from streamingt2v_torch.models import wrappers as pwrap

    ucfg = jcfg.VideoUNetConfig.tiny(controlnet_mode=False)
    jm = jvu.VideoUNet(ucfg)
    flat = random_flat(jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 2, 8, 8, 8)), jnp.zeros((1,)),
        jnp.zeros((1, 2, 1, ucfg.context_dim)),
        jnp.zeros((1, 2, ucfg.adm_in_channels))))["params"], seed)
    pm = port_module(pvu.VideoUNet(pcfg.VideoUNetConfig.tiny(controlnet_mode=False)), flat)
    return jwrap.openai_wrapper(jm, jax_variables(flat)), pwrap.openai_wrapper(pm), ucfg


def stage1_pair(jcfg, pcfg, seed: int = 0):
    """(JAX ``Stage1Pipeline``, port ``Stage1Pipeline``) on identical
    weights, one ``random_flat`` tree per model from ``seed``."""
    import dataclasses

    import jax

    from streamingt2v_tpu.pipeline.build import build_pipeline as jax_build_pipeline
    from streamingt2v_tpu.pipeline.build import stage1_param_factory
    from streamingt2v_torch.pipeline.build import build_pipeline

    fields = ("unet", "controlnet", "svd_unet", "vae", "conditioner")
    jpipe = jax_build_pipeline(jcfg, seed=0, lazy=True)
    thunks = stage1_param_factory(jcfg, jax.random.PRNGKey(0), jpipe.models)
    flats = {f: random_flat(jax.eval_shape(thunks[f + "_params"])["params"], seed=seed + i)
             for i, f in enumerate(fields)}
    jpipe.models = dataclasses.replace(
        jpipe.models, **{f + "_params": jax_variables(flats[f]) for f in fields})
    pipe = build_pipeline(pcfg, device="cpu", init=False)
    for f in fields:
        load_jax_params(getattr(pipe.models, f), flats[f])
    return jpipe, pipe


def jax_stage1_draws(cfg, seed: int, shape_latent, image_shape, n_gen: int,
                     sampler_steps=None) -> dict:
    """The JAX stage-1 pipeline's noise, rebuilt from its own key splits
    (pipeline/streaming.py: generation_key -> (k_cond, k_sample); uniform
    augmentation noise from k_cond; latent noise from split(k_sample)[0]);
    with ``sampler_steps`` ({generation: steps}) also a stochastic sampler's
    draw of each step i, normal(fold_in(split(k_sample)[1], i)), as stream
    "sampler/<i>"."""
    import jax
    import jax.numpy as jnp

    from streamingt2v_tpu.utils.rng import generation_key

    draws = {}
    for g in range(n_gen + 1):
        k_cond, k_sample = jax.random.split(
            generation_key(seed, g, cfg.inference.reset_seed_per_generation))
        draws[g, "cond_aug"] = np.asarray(jax.random.uniform(k_cond, image_shape, jnp.float32))
        k_init, k_loop = jax.random.split(k_sample)
        draws[g, "latent"] = np.asarray(jax.random.normal(k_init, shape_latent, jnp.float32))
        for i in range((sampler_steps or {}).get(g, 0)):
            draws[g, f"sampler/{i}"] = np.asarray(jax.random.normal(
                jax.random.fold_in(k_loop, i), shape_latent, jnp.float32))
    return draws


class Stage1Draws:
    """A port stage-1 noise function serving ``jax_stage1_draws``; records
    each (generation, stream) it served."""

    def __init__(self, draws: dict):
        self.draws = draws
        self.used = []

    def __call__(self, g, stream, shape):
        a = self.draws[g, stream]
        assert tuple(a.shape) == tuple(shape), (g, stream, a.shape, shape)
        self.used.append((g, stream))
        return t(a)


class JaxEnhanceDraws:
    """The JAX stage-2 pipeline's draws, rebuilt from its own keys
    (pipeline/enhance.py: RngStream(seed, 'enhance'); key images at
    key(10000 + i), the video encode at fold_in(key(1), start), the SDEdit
    noise at key(2), the blending offsets at fold_in(fold_in(key(3), step),
    chunk)), as a port ``EnhanceNoise``."""

    def __init__(self, seed: int):
        from streamingt2v_tpu.utils.rng import RngStream

        self.stream = RngStream(seed, "enhance")
        self.used = []

    def normal(self, stream, index, shape):
        import jax
        import jax.numpy as jnp

        key = {"key_image": lambda: self.stream.key(10_000 + index),
               "encode": lambda: jax.random.fold_in(self.stream.key(1), index),
               "latent": lambda: self.stream.key(2)}[stream]()
        self.used.append((stream, index, tuple(shape)))
        return t(jax.random.normal(key, tuple(shape), jnp.float32))

    def offset(self, step, chunk, high):
        import jax

        k = jax.random.fold_in(jax.random.fold_in(self.stream.key(3), step), chunk)
        self.used.append(("offset", step, chunk))
        return int(jax.random.randint(k, (), 0, high))


# the synthetic tokenizer's ids reach 513 (start/end of text)
TEXT_TINY = dict(vocab_size=514, width=32, layers=2, heads=2, max_length=8)


def flat_for(jmod, *args, seed=0, **kw) -> dict:
    """``random_flat`` of a flax module's parameter shapes (no init run)."""
    import jax

    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), *args, **kw))
    return random_flat(shapes["params"], seed)


def enhance_pair(enh: dict):
    """(JAX ``EnhancePipeline``, port ``EnhancePipeline``) on identical
    weights at the tiny widths of tests/test_enhance.py, with a 514-token
    text tower so that the synthetic tokenizer's ids fit; ``enh`` are the
    ``EnhanceConfig`` fields of both."""
    import dataclasses

    import jax.numpy as jnp

    from streamingt2v_tpu.config import EnhanceConfig as JaxEnhanceConfig
    from streamingt2v_tpu.config import VAEConfig as JaxVAEConfig
    from streamingt2v_tpu.diffusion import ddim as jddim
    from streamingt2v_tpu.models import clip as jclip
    from streamingt2v_tpu.models import clip_text as jtext
    from streamingt2v_tpu.models import vae as jvae
    from streamingt2v_tpu.models.enhance import unet as junet
    from streamingt2v_tpu.pipeline import enhance as jenh
    from streamingt2v_torch import config as pcfg
    from streamingt2v_torch.models import clip as pclip
    from streamingt2v_torch.models import clip_text as ptext
    from streamingt2v_torch.models.enhance import unet as punet
    from streamingt2v_torch.pipeline import enhance as penh
    from streamingt2v_torch.pipeline.build import build_enhance_models

    ucfg = junet.I2VGenXLUNetConfig.tiny()
    vcfg = dataclasses.replace(JaxVAEConfig.tiny(), temporal_decoder=False)
    ccfg = jclip.CLIPVisionConfig.tiny()
    tcfg = jtext.CLIPTextConfig(**TEXT_TINY)
    jm = dict(unet=junet.I2VGenXLUNet(ucfg), vae=jvae.AutoencoderKL(vcfg, use_quant_conv=True),
              clip_vision=jclip.CLIPVisionTower(ccfg), text_encoder=jtext.CLIPTextTower(tcfg))
    hw = enh["height"] // vcfg.downsample_factor
    init_args = {
        "unet": (jnp.zeros((1, 4, hw, hw, 4)), jnp.zeros((1,), jnp.int32), jnp.zeros((1,)),
                 jnp.zeros((1, 4, hw, hw, 4)), jnp.zeros((1, ccfg.output_dim)),
                 jnp.zeros((1, 5, ucfg.cross_attention_dim))),
        "vae": (jnp.zeros((1, 32, 32, 3)),),
        "clip_vision": (jnp.zeros((1, ccfg.image_size, ccfg.image_size, 3)),),
        "text_encoder": (jnp.zeros((1, tcfg.max_length), jnp.int32),),
    }
    flats = {name: flat_for(jm[name], *init_args[name], seed=i) for i, name in enumerate(jm)}
    jmodels = jenh.EnhanceModels(
        unet=jm["unet"], unet_params=jax_variables(flats["unet"]),
        vae=jm["vae"], vae_params=jax_variables(flats["vae"]),
        clip_vision=jm["clip_vision"], clip_vision_params=jax_variables(flats["clip_vision"]),
        text_encoder=jm["text_encoder"], text_params=jax_variables(flats["text_encoder"]),
        scheduler=jddim.DDIMScheduler(), tokenizer=jtext.CLIPTokenizer.synthetic(8))
    jpipe = jenh.EnhancePipeline(JaxEnhanceConfig(**enh), jmodels)
    pmodels = build_enhance_models(
        device="cpu", init=False, bf16=False, unet=punet.I2VGenXLUNetConfig.tiny(),
        vae=dataclasses.replace(pcfg.VAEConfig.tiny(), temporal_decoder=False),
        clip_vision=pclip.CLIPVisionConfig.tiny(), text=ptext.CLIPTextConfig(**TEXT_TINY),
        tokenizer_length=8)
    for name in jm:
        load_jax_params(getattr(pmodels, name), flats[name])
    return jpipe, penh.EnhancePipeline(pcfg.EnhanceConfig(**enh), pmodels)


# the tiny product's stage 2: the tiny enhance with randomized blending
TINY_ENHANCE = dict(num_steps=3, height=32, width=32, chunk_size=4, overlap_size=2,
                    use_randomized_blending=True, vae_bf16=False)


def tiny_product_cfg(config_cls, vfi_cls, enhance_cls):
    """``PipelineConfig.tiny()`` of either package with ``TINY_ENHANCE``,
    randomized blending, the f32 stage-1 decode and the tiny VFI with
    flip-TTA."""
    import dataclasses

    cfg = config_cls.tiny()
    return dataclasses.replace(
        cfg, use_randomized_blending=True, enhance=enhance_cls(**TINY_ENHANCE),
        inference=dataclasses.replace(cfg.inference, vae_decode_bf16=False),
        vfi=dataclasses.replace(vfi_cls.tiny(), tta=True))


def tiny_product_pair():
    """(JAX product, port product, (JAX VFI module, its variables)) on
    identical weights: the tiny stage 1, the tiny enhance of
    test_torch_port_enhance.py with randomized blending, and the tiny VFI
    with flip-TTA."""
    import jax
    import jax.numpy as jnp

    from streamingt2v_tpu.config import EnhanceConfig as JaxEnhanceConfig
    from streamingt2v_tpu.config import PipelineConfig as JaxPipelineConfig
    from streamingt2v_tpu.config import VFIConfig as JaxVFIConfig
    from streamingt2v_tpu.models import vfi as jvfi
    from streamingt2v_tpu.pipeline.full import StreamingT2VPipeline as JaxProduct
    from streamingt2v_tpu.pipeline.interpolate import InterpolatePipeline as JaxInterpolate
    from streamingt2v_torch.config import EnhanceConfig, PipelineConfig, VFIConfig
    from streamingt2v_torch.models.vfi import MultiScaleFlow
    from streamingt2v_torch.pipeline.full import StreamingT2VPipeline
    from streamingt2v_torch.pipeline.interpolate import InterpolatePipeline

    jcfg = tiny_product_cfg(JaxPipelineConfig, JaxVFIConfig, JaxEnhanceConfig)
    cfg = tiny_product_cfg(PipelineConfig, VFIConfig, EnhanceConfig)
    jstage1, stage1 = stage1_pair(jcfg, cfg, seed=10)
    jenhance, enhance = enhance_pair(TINY_ENHANCE)
    jvfi_mod = jvfi.MultiScaleFlow(jcfg.vfi)
    img = jnp.zeros((1, 32, 32, 3))
    flat = random_flat(jax.eval_shape(lambda: jvfi_mod.init(jax.random.PRNGKey(0), img, img))
                       ["params"], 20)
    jinterp = JaxInterpolate(jvfi_mod, jax_variables(flat), tta=True)
    interp = InterpolatePipeline(port_module(MultiScaleFlow(cfg.vfi), flat), tta=True)
    jpipe = JaxProduct(jcfg, jstage1, jenhance, jinterp, offload_between_stages=False)
    return (jpipe, StreamingT2VPipeline(cfg, stage1, enhance, interp),
            (jvfi_mod, jax_variables(flat)))
