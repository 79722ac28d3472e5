"""PyTorch port, the samplers and guiders beyond EulerEDM: Heun, Euler
ancestral, DPM++ 2S ancestral, DPM++ 2M, LMS and EulerEDM with churn, each
at 3 steps on the tiny SVD UNet under both CFG guiders, and the identity and
triangle-prediction guiders, against the JAX package on the same weights,
the same initial noise and the JAX per-step draws
(``normal(fold_in(key, i))``) injected as the port's ``step_noise``; in f32.
Also the LMS coefficients, the network-call count of each sampler, the
default EulerEDM path against the parent's loop (bit for bit), and a tiny
stage 1 under the stochastic samplers with the JAX pipeline's own draws.

Tolerances: 1e-4 relative to max |reference| (``test_euler_edm_sampler``'s),
1e-6 on the LMS coefficients, 5e-4 max-abs on the [-1, 1] stage-1 video."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import (
    Stage1Draws, assert_close, jax_stage1_draws, stage1_pair, svd_unet_pair, t)
from streamingt2v_tpu import config as jcfg
from streamingt2v_tpu.diffusion import denoiser as jden
from streamingt2v_tpu.diffusion import guiders as jguiders
from streamingt2v_tpu.diffusion import samplers as jsamplers
from streamingt2v_torch import config as pcfg
from streamingt2v_torch.diffusion import guiders as pguiders
from streamingt2v_torch.diffusion import samplers as psamplers
from streamingt2v_torch.diffusion.denoiser import denoise
from streamingt2v_torch.diffusion.discretization import get_sigmas

TOL = 1e-4
VIDEO_ATOL = 5e-4
KEY = jax.random.PRNGKey(5)
# EulerEDM with churn: gamma = min(1/3, sqrt(2) - 1); of the 3-step grids
# (80 or 700, 2.5 or 1.8, 0.002, 0) only the middle sigma is in [s_tmin, s_tmax]
CHURN = dict(s_churn=1.0, s_tmin=0.01, s_tmax=10.0, s_noise=0.9)
SAMPLERS = {"heun_edm": {}, "euler_ancestral": {}, "dpmpp2s": {}, "dpmpp2m": {}, "lms": {},
            "euler_edm_churn": dict(kind="euler_edm", **CHURN)}
# (guider kind, discretization) pairs of test_euler_edm_sampler
GUIDED = [("linear_prediction", "align_your_steps"), ("vanilla", "edm")]


@pytest.fixture(scope="module")
def svd_pair():
    return svd_unet_pair()


def _randn(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _cond_pair(rng, ucfg, frames=5):
    mk = lambda: dict(concat=_randn(rng, 1, frames, 8, 8, ucfg.in_channels - 4),  # noqa: E731
                      crossattn=_randn(rng, 1, frames, 1, ucfg.context_dim),
                      vector=_randn(rng, 1, frames, ucfg.adm_in_channels))
    return mk(), mk()


def _jax_step_noise(key):
    """The JAX samplers' draw of step i, as a port ``step_noise``."""
    used = []

    def draw(i, shape):
        used.append(i)
        return t(jax.random.normal(jax.random.fold_in(key, i), shape, jnp.float32))

    draw.used = used
    return draw


def _run_both(svd_pair, sampler_kw: dict, guider_kw: dict, seed: int):
    """(port latents, JAX latents, steps whose draws the port took)."""
    jnet, pnet, ucfg = svd_pair
    rng = np.random.RandomState(seed)
    scfg = dict(num_steps=3, sigma_max=80.0, **sampler_kw)
    jsc = jcfg.SamplerConfig(**scfg, guider=jcfg.GuiderConfig(**guider_kw))
    psc = pcfg.SamplerConfig(**scfg, guider=pcfg.GuiderConfig(**guider_kw))
    noise = _randn(rng, 1, 5, 8, 8, 4)
    c, uc = _cond_pair(rng, ucfg)
    jc, juc = ({k: jnp.asarray(v) for k, v in d.items()} for d in (c, uc))
    jsample = jsamplers.make_sampler(jsc)
    ref = jax.jit(lambda n, cc, uu: jsample(lambda x, s, k: jden.denoise(jnet, x, s, k),
                                            n, cc, uu, key=KEY))(jnp.asarray(noise), jc, juc)
    step_noise = _jax_step_noise(KEY)
    pc, puc = ({k: t(v) for k, v in d.items()} for d in (c, uc))
    with torch.no_grad():
        got = psamplers.make_sampler(psc)(lambda x, s, cc: denoise(pnet, x, s, cc),
                                          t(noise), pc, puc, step_noise)
    return got, ref, step_noise.used


@pytest.mark.parametrize("guider,disc", GUIDED)
@pytest.mark.parametrize("name", list(SAMPLERS))
def test_sampler_matches_jax(svd_pair, name, guider, disc):
    kw = dict(kind=name, discretization=disc)
    kw.update(SAMPLERS[name])
    got, ref, used = _run_both(svd_pair, kw, dict(kind=guider, min_scale=1.0, max_scale=2.5,
                                                  num_frames=5), seed=18)
    assert_close(got, ref, TOL, name)
    # the stochastic samplers draw where the JAX package's draw counts: every
    # step with a next sigma > 0 (churn: the steps inside [s_tmin, s_tmax])
    want = {"euler_ancestral": [0, 1], "dpmpp2s": [0, 1], "euler_edm_churn": [1]}.get(name, [])
    assert used == want


@pytest.mark.parametrize("guider", ["identity", "triangle_prediction"])
def test_guided_euler_edm_matches_jax(svd_pair, guider):
    """EulerEDM under the identity guider (the conditional half alone) and
    the triangle-wave per-frame scale."""
    got, ref, _ = _run_both(svd_pair, dict(discretization="edm"),
                            dict(kind=guider, min_scale=1.0, max_scale=3.0, num_frames=5),
                            seed=19)
    assert_close(got, ref, TOL, guider)


@pytest.mark.parametrize("kind", ["vanilla", "identity", "linear_prediction",
                                  "triangle_prediction"])
def test_guider_prepare_and_combine(kind):
    """Each guider's batch, conditioning and combine against JAX's."""
    rng = np.random.RandomState(20)
    gkw = dict(kind=kind, min_scale=1.2, max_scale=2.8, num_frames=7)
    jg, pg = jguiders.make_guider(jcfg.GuiderConfig(**gkw)), pguiders.make_guider(
        pcfg.GuiderConfig(**gkw))
    assert pg.batch_multiplier == jg.batch_multiplier == (1 if kind == "identity" else 2)
    x = _randn(rng, 1, 7, 3, 3, 4)
    sigma = np.array([3.0], np.float32)
    c = {"crossattn": _randn(rng, 1, 7, 2, 8), "vector": _randn(rng, 1, 7, 6),
         "ctrl_frames": _randn(rng, 1, 2, 8, 8, 3), "other": _randn(rng, 1, 3)}
    uc = {k: np.zeros_like(v) for k, v in c.items()}
    jx, js, jcond = jg.prepare(jnp.asarray(x), jnp.asarray(sigma),
                               {k: jnp.asarray(v) for k, v in c.items()},
                               {k: jnp.asarray(v) for k, v in uc.items()})
    px, ps, pcond = pg.prepare(t(x), t(sigma), {k: t(v) for k, v in c.items()},
                               {k: t(v) for k, v in uc.items()})
    assert tuple(px.shape) == tuple(jx.shape) and px.shape[0] == pg.batch_multiplier
    assert torch.equal(px, t(jx)) and torch.equal(ps, t(js))
    assert sorted(pcond) == sorted(jcond)
    for k in jcond:
        assert torch.equal(pcond[k], t(jcond[k])), k
    den = _randn(rng, *px.shape)
    assert_close(pg.combine(t(den)), jg.combine(jnp.asarray(den)), 1e-6, kind)


@pytest.mark.parametrize("disc,n", [("edm", 3), ("edm", 10), ("align_your_steps", 30),
                                    ("legacy_ddpm", 7)])
@pytest.mark.parametrize("order", [1, 2, 4])
def test_lms_coefficients_match_jax(disc, n, order):
    sigmas = get_sigmas(disc, n, sigma_max=80.0)
    got = psamplers._lms_coeff_matrix(sigmas, order)
    ref = jsamplers._lms_coeff_matrix(sigmas, order)
    assert got.shape == ref.shape == (n, order) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    # each row integrates the constant 1: the coefficients sum to the step
    np.testing.assert_allclose(got.sum(axis=1), np.diff(sigmas), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("kind,calls", [("euler_edm", 4), ("heun_edm", 7),
                                        ("euler_ancestral", 4), ("dpmpp2s", 7),
                                        ("dpmpp2m", 4), ("lms", 4)])
@pytest.mark.parametrize("guider", ["vanilla", "identity"])
def test_network_calls(kind, calls, guider):
    """n guided denoises a sampler, 2n - 1 for Heun and DPM++ 2S (their last
    step has no correction); each of batch 2 under CFG, 1 under identity."""
    batches = []

    def denoise_fn(x, sigma, cond):
        batches.append((x.shape[0], sigma.shape[0], cond["crossattn"].shape[0]))
        return 0.5 * x

    sc = pcfg.SamplerConfig(kind=kind, num_steps=4, discretization="edm", sigma_max=80.0,
                            guider=pcfg.GuiderConfig(kind=guider, num_frames=2))
    c = {"crossattn": torch.ones(1, 2, 1, 3)}
    out = psamplers.make_sampler(sc)(denoise_fn, torch.randn(1, 2, 3, 3, 4), c,
                                     {"crossattn": torch.zeros(1, 2, 1, 3)})
    b = 1 if guider == "identity" else 2
    assert len(batches) == calls and set(batches) == {(b, b, b)}
    assert torch.isfinite(out).all()


def _parent_euler_edm(cfg, denoise_fn, noise, cond, uc):
    """The EulerEDM loop as the port ran it before the other samplers came."""
    sigmas = get_sigmas(cfg.discretization, cfg.num_steps, sigma_min=cfg.sigma_min,
                        sigma_max=cfg.sigma_max, rho=cfg.rho)
    guider = pguiders.make_guider(cfg.guider)
    x = noise * float(np.sqrt(1.0 + float(sigmas[0]) ** 2))
    for i in range(len(sigmas) - 1):
        sigma, next_sigma = sigmas[i], sigmas[i + 1]
        sigma_vec = torch.full((x.shape[0],), float(sigma), dtype=torch.float32)
        x_in, s_in, c_in = guider.prepare(x, sigma_vec, cond, uc)
        denoised = guider.combine(denoise_fn(x_in, s_in, c_in))
        d = (x - denoised) / max(float(sigma), 1e-12)
        x = x + float(np.float32(next_sigma - sigma)) * d
    return x


@pytest.mark.parametrize("disc", ["align_your_steps", "edm"])
def test_default_euler_edm_is_bit_identical_to_the_parent(svd_pair, disc):
    _, pnet, ucfg = svd_pair
    rng = np.random.RandomState(21)
    cfg = pcfg.SamplerConfig(num_steps=3, discretization=disc, sigma_max=80.0,
                             guider=pcfg.GuiderConfig(num_frames=5))
    noise = t(_randn(rng, 1, 5, 8, 8, 4))
    c, uc = ({k: t(v) for k, v in d.items()} for d in _cond_pair(rng, ucfg))
    fn = lambda x, s, cc: denoise(pnet, x, s, cc)  # noqa: E731
    with torch.no_grad():
        got = psamplers.make_sampler(cfg)(fn, noise, c, uc)
        want = _parent_euler_edm(cfg, fn, noise, c, uc)
    assert torch.equal(got, want)


# ------------------------------------------------------------- stage 1 ---

FRAMES = 8
SEED = 43


def _stochastic_cfg(cfg_cls):
    """The tiny stage 1 with a DPM++ 2S first chunk and Euler-ancestral AR
    chunks under the triangle guider, f32 decode."""
    cfg = cfg_cls.tiny()
    return dataclasses.replace(
        cfg, first_chunk_sampler=dataclasses.replace(cfg.first_chunk_sampler, kind="dpmpp2s"),
        sampler=dataclasses.replace(cfg.sampler, kind="euler_ancestral",
                                    guider=dataclasses.replace(cfg.sampler.guider,
                                                               kind="triangle_prediction")),
        inference=dataclasses.replace(cfg.inference, vae_decode_bf16=False))


def test_stage1_stochastic_samplers_match_jax():
    """The JAX pipeline draws step i of generation g from fold_in(k_loop, i),
    k_loop = split(k_sample)[1]; the port serves them as noise streams
    "sampler/<i>" of generation g."""
    jpipe, pipe = stage1_pair(_stochastic_cfg(jcfg.PipelineConfig),
                              _stochastic_cfg(pcfg.PipelineConfig), seed=30)
    cfg = pipe.cfg
    image = (np.random.RandomState(4).rand(cfg.height, cfg.width, 3) * 2 - 1).astype(np.float32)
    n_gen = cfg.n_autoregressions(FRAMES)
    ref = np.asarray(jpipe.image_to_video(jnp.asarray(image), num_frames=FRAMES, seed=SEED))
    steps = {0: cfg.first_chunk_sampler.num_steps, 1: cfg.sampler.num_steps}
    noise = Stage1Draws(jax_stage1_draws(jpipe.cfg, SEED,
                                         pipe.latent_shape(cfg.inference.chunk_frames),
                                         (1,) + image.shape, n_gen, sampler_steps=steps))
    video = pipe.image_to_video(t(image), num_frames=FRAMES, seed=SEED, noise=noise)
    # every step but each sampler's last (whose next sigma is 0) drew
    assert sorted(noise.used) == sorted(
        [(g, s) for g in (0, 1) for s in ("cond_aug", "latent")]
        + [(g, f"sampler/{i}") for g in (0, 1) for i in range(steps[g] - 1)])
    assert np.mean(np.abs(ref) < 0.999) > 0.5 and ref.std() > 0.05
    err = float(np.abs(video.numpy() - ref).max())
    assert err <= VIDEO_ATOL, f"stochastic stage-1 video max-abs err {err:.3e} > {VIDEO_ATOL}"


def test_generator_noise_sampler_streams():
    """The default noise serves "sampler/<i>" as standard normals at their
    own addresses: the "cond_aug" and "latent" draws are those of a noise
    that never served a sampler draw."""
    from streamingt2v_torch.utils.rng import GeneratorNoise, generation_seed, step_stream

    a, b = GeneratorNoise(3, "cpu"), GeneratorNoise(3, "cpu")
    s0 = step_stream(a, 1)(0, (4, 5))
    s1 = step_stream(a, 1)(1, (4, 5))
    assert not torch.equal(s0, s1) and abs(float(s0.mean())) < 1.0
    gen = torch.Generator().manual_seed(generation_seed(3, 1, "latent"))
    assert torch.equal(a(1, "latent", (2, 3)), torch.randn((2, 3), generator=gen))
    assert torch.equal(a(1, "latent", (2, 3)), b(1, "latent", (2, 3)))
    assert torch.equal(step_stream(b, 1)(1, (4, 5)), s1)
