"""PyTorch port, the stage-1 slice end to end: ``PipelineConfig.tiny()``
image-to-video over a first chunk plus one autoregressive chunk, against
``streamingt2v_tpu.pipeline.build.build_pipeline(...).image_to_video`` on
the same weights, with the JAX draws injected as the port's noise.

Tolerance: 5e-4 max-abs on the [-1, 1] video, f32 on both sides (measured
1.4e-4 on the CPU: the sampler's 1/sigma steps amplify summation-order
differences; the budget allowed for this slice is 2e-3)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import Stage1Draws, jax_stage1_draws, stage1_pair, t
from streamingt2v_tpu.config import PipelineConfig as JaxPipelineConfig
from streamingt2v_torch.config import PipelineConfig

FRAMES = 8   # chunk 5 + one generation of 5 - 2 kept frames
SEED = 33
VIDEO_ATOL = 5e-4


def _no_bf16_decode(cfg):
    return dataclasses.replace(cfg, inference=dataclasses.replace(
        cfg.inference, vae_decode_bf16=False))


@pytest.fixture(scope="module")
def slice_pair():
    """(jax pipeline, port pipeline) on identical weights."""
    return stage1_pair(_no_bf16_decode(JaxPipelineConfig.tiny()),
                       _no_bf16_decode(PipelineConfig.tiny()))


def test_stage1_slice_matches_jax(slice_pair):
    jpipe, pipe = slice_pair
    cfg = pipe.cfg
    rng = np.random.RandomState(0)
    image = (rng.rand(cfg.height, cfg.width, 3) * 2 - 1).astype(np.float32)
    n_gen = cfg.n_autoregressions(FRAMES)
    assert n_gen == 1

    ref = np.asarray(jpipe.image_to_video(jnp.asarray(image), num_frames=FRAMES, seed=SEED))

    noise = Stage1Draws(jax_stage1_draws(jpipe.cfg, SEED,
                                         pipe.latent_shape(cfg.inference.chunk_frames),
                                         (1,) + image.shape, n_gen))
    video = pipe.image_to_video(t(image), num_frames=FRAMES, seed=SEED, noise=noise)
    assert sorted(noise.used) == sorted(noise.draws)
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
