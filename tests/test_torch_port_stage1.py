"""PyTorch port, the stage-1 slice end to end: ``PipelineConfig.tiny()``
image-to-video over a first chunk plus one autoregressive chunk, against
``streamingt2v_tpu.pipeline.build.build_pipeline(...).image_to_video`` on
the same weights, with the JAX draws injected as the port's noise.

Tolerance: 5e-4 max-abs on the [-1, 1] video, f32 on both sides (measured
1.4e-4 on the CPU: the sampler's 1/sigma steps amplify summation-order
differences; the budget allowed for this slice is 2e-3)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import jax_variables, random_flat, t
from streamingt2v_tpu.config import PipelineConfig as JaxPipelineConfig
from streamingt2v_tpu.pipeline.build import build_pipeline as jax_build_pipeline
from streamingt2v_tpu.pipeline.build import stage1_param_factory
from streamingt2v_tpu.utils.rng import generation_key
from streamingt2v_torch.config import PipelineConfig
from streamingt2v_torch.pipeline.build import build_pipeline
from streamingt2v_torch.utils.weights import load_jax_params

FIELDS = ("unet", "controlnet", "svd_unet", "vae", "conditioner")
FRAMES = 8   # chunk 5 + one generation of 5 - 2 kept frames
SEED = 33
VIDEO_ATOL = 5e-4


def _no_bf16_decode(cfg):
    return dataclasses.replace(cfg, inference=dataclasses.replace(
        cfg.inference, vae_decode_bf16=False))


def _jax_draws(cfg, shape_latent, image_shape, n_gen):
    """The JAX pipeline's noise, rebuilt from its own key splits
    (pipeline/streaming.py: generation_key -> (k_cond, k_sample); uniform
    augmentation noise from k_cond; latent noise from split(k_sample)[0])."""
    draws = {}
    for g in range(n_gen + 1):
        k_cond, k_sample = jax.random.split(
            generation_key(SEED, g, cfg.inference.reset_seed_per_generation))
        draws[g, "cond_aug"] = np.asarray(jax.random.uniform(k_cond, image_shape, jnp.float32))
        k_init, _ = jax.random.split(k_sample)
        draws[g, "latent"] = np.asarray(jax.random.normal(k_init, shape_latent, jnp.float32))
    return draws


@pytest.fixture(scope="module")
def slice_pair():
    """(jax pipeline, port pipeline, flat weights) on identical weights."""
    jcfg = _no_bf16_decode(JaxPipelineConfig.tiny())
    jpipe = jax_build_pipeline(jcfg, seed=0, lazy=True)
    thunks = stage1_param_factory(jcfg, jax.random.PRNGKey(0), jpipe.models)
    flats = {f: random_flat(jax.eval_shape(thunks[f + "_params"])["params"], seed=i)
             for i, f in enumerate(FIELDS)}
    jpipe.models = dataclasses.replace(
        jpipe.models, **{f + "_params": jax_variables(flats[f]) for f in FIELDS})
    pipe = build_pipeline(_no_bf16_decode(PipelineConfig.tiny()), device="cpu", init=False)
    for f in FIELDS:
        load_jax_params(getattr(pipe.models, f), flats[f])
    return jpipe, pipe


def test_stage1_slice_matches_jax(slice_pair):
    jpipe, pipe = slice_pair
    cfg = pipe.cfg
    rng = np.random.RandomState(0)
    image = (rng.rand(cfg.height, cfg.width, 3) * 2 - 1).astype(np.float32)
    n_gen = cfg.n_autoregressions(FRAMES)
    assert n_gen == 1

    ref = np.asarray(jpipe.image_to_video(jnp.asarray(image), num_frames=FRAMES, seed=SEED))

    draws = _jax_draws(jpipe.cfg, pipe.latent_shape(cfg.inference.chunk_frames),
                       (1,) + image.shape, n_gen)
    used = []

    def noise(g, stream, shape):
        a = draws[g, stream]
        assert tuple(a.shape) == tuple(shape), (g, stream, a.shape, shape)
        used.append((g, stream))
        return t(a)

    video = pipe.image_to_video(t(image), num_frames=FRAMES, seed=SEED, noise=noise)
    assert sorted(used) == sorted(draws)
    assert tuple(video.shape) == (FRAMES, cfg.height, cfg.width, 3)
    v = video.numpy()
    # the comparison means something only if the video is not clipped flat
    assert np.mean(np.abs(ref) < 0.999) > 0.5 and ref.std() > 0.05
    err = float(np.abs(v - ref).max())
    assert err <= VIDEO_ATOL, f"stage-1 video max-abs err {err:.3e} > {VIDEO_ATOL}"


def test_stage1_default_noise_is_seeded(slice_pair):
    """Without injected noise the port draws from per-generation seeded
    generators: the same seed repeats, another seed differs."""
    _, pipe = slice_pair
    cfg = pipe.cfg
    image = torch.linspace(-1, 1, cfg.height * cfg.width * 3).reshape(cfg.height, cfg.width, 3)
    v1 = pipe.image_to_video(image, num_frames=5, seed=7)
    v2 = pipe.image_to_video(image, num_frames=5, seed=7)
    v3 = pipe.image_to_video(image, num_frames=5, seed=8)
    assert torch.equal(v1, v2)
    assert not torch.allclose(v1, v3)
    assert v1.shape == (5, cfg.height, cfg.width, 3)
