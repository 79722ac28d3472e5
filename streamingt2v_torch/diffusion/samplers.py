"""k-diffusion samplers (counterpart of ``streamingt2v_tpu/diffusion/
samplers.py``) as Python loops: EulerEDM (with churn), Heun, Euler
ancestral, DPM++ 2S ancestral, DPM++ 2M and LMS.

A sampler takes ``denoise_fn(x, sigma, cond) -> denoised`` (cond is the
guider-prepared dict) plus the raw (c, uc) pair, the initial noise and,
for the stochastic ones (ancestral, DPM++ 2S, EulerEDM with ``s_churn > 0``),
``step_noise(i, shape)``: the standard normal draw of step ``i``
(``utils/rng.py``), so that a caller can inject another implementation's
draws.  Sigma schedules are host numpy constants, and every scalar of a
step is computed from them in float32 on the host, as the JAX package's
traced f32 scalars are; its ``lax.cond``/``jnp.where`` branches on them
are host branches here.  All samplers share the EDM pre-scaling
x *= sqrt(1 + sigma_0^2).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch

from streamingt2v_torch.config import SamplerConfig
from streamingt2v_torch.diffusion.discretization import get_sigmas
from streamingt2v_torch.diffusion.guiders import Guider, make_guider
from streamingt2v_torch.utils.profiling import count, span
from streamingt2v_torch.utils.rng import StepNoiseFn, default_step_noise

DenoiseFn = Callable[[torch.Tensor, torch.Tensor, Dict[str, Any]], torch.Tensor]
f32 = np.float32


def _steps(sigmas) -> Iterator[int]:
    """The step indices of a sigma grid; each step's loop body runs inside
    the span ``st2v.step`` and counts in ``steps``."""
    for i in range(len(sigmas) - 1):
        with span("st2v.step"):
            count("steps")
            yield i


def _guided(denoise_fn: DenoiseFn, guider: Guider, x, sigma: float, cond, uc):
    """One guided denoise at a scalar sigma."""
    sigma_vec = torch.full((x.shape[0],), sigma, dtype=torch.float32, device=x.device)
    x_in, s_in, c_in = guider.prepare(x, sigma_vec, cond, uc)
    return guider.combine(denoise_fn(x_in, s_in, c_in))


def _to_d(x, sigma, denoised):
    return (x - denoised) / max(float(sigma), 1e-12)


def _euler_edm(cfg, guider, denoise_fn, x, cond, uc, step_noise, sigmas, heun: bool):
    """EulerEDM, x_{i+1} = x + (sigma_{i+1} - sigma_i) * (x - D(x, sigma_i)) /
    sigma_i (``heun``: Heun's correction on every step but the last), with
    churn when ``s_churn > 0``: sigma raised to sigma * (1 + gamma) on the
    steps inside [s_tmin, s_tmax], by fresh noise of the matching scale."""
    n = len(sigmas) - 1
    churn_gamma = min(cfg.s_churn / max(n, 1), 2**0.5 - 1) if cfg.s_churn > 0 else 0.0
    for i in _steps(sigmas):
        sigma, next_sigma = sigmas[i], sigmas[i + 1]
        sigma_hat = sigma
        if churn_gamma > 0.0 and cfg.s_tmin <= sigma <= cfg.s_tmax:
            sigma_hat = sigma * (f32(churn_gamma) + f32(1.0))
            scale = np.sqrt(np.maximum(sigma_hat**2 - sigma**2, f32(0.0)))
            x = x + step_noise(i, tuple(x.shape)).to(x) * cfg.s_noise * float(scale)
        denoised = _guided(denoise_fn, guider, x, float(sigma_hat), cond, uc)
        d = _to_d(x, sigma_hat, denoised)
        dt = next_sigma - sigma_hat
        euler = x + float(dt) * d
        if heun and next_sigma > 1e-14:
            den2 = _guided(denoise_fn, guider, euler, float(next_sigma), cond, uc)
            d2 = _to_d(euler, next_sigma, den2)
            x = x + float(dt * f32(0.5)) * (d + d2)
        else:
            x = euler
    return x


def _ancestral_sigmas(sigma_from, sigma_to, eta: float = 1.0):
    """(sigma_down, sigma_up) in f32.  sigma_to^2 - sigma_up^2 cancels
    (sigma_up is within 1e-5 relative of sigma_to), so sigma_down takes the
    rounding of the JAX package's compiled program, which forms it as one
    fused multiply-add, fma(sigma_to, sigma_to, -sigma_up^2): here the f32
    product is exact in f64.  Unfused f32 lands 0.3% away at the grids' first
    step, the exact sigma_to^2 / sigma_from 1.2% away from both."""
    sigma_up = np.minimum(sigma_to, f32(eta) * np.sqrt(
        sigma_to**2 * (sigma_from**2 - sigma_to**2) / np.maximum(sigma_from**2, f32(1e-20))))
    diff = f32(np.float64(sigma_to) * np.float64(sigma_to) - np.float64(sigma_up**2))
    return np.sqrt(np.maximum(diff, f32(0.0))), sigma_up


def _add_ancestral_noise(cfg, x, i, next_sigma, sigma_up, step_noise):
    if next_sigma > 0.0:
        x = x + step_noise(i, tuple(x.shape)).to(x) * cfg.s_noise * float(sigma_up)
    return x


def _euler_ancestral(cfg, guider, denoise_fn, x, cond, uc, step_noise, sigmas):
    for i in _steps(sigmas):
        sigma, next_sigma = sigmas[i], sigmas[i + 1]
        sigma_down, sigma_up = _ancestral_sigmas(sigma, next_sigma)
        denoised = _guided(denoise_fn, guider, x, float(sigma), cond, uc)
        x = x + float(sigma_down - sigma) * _to_d(x, sigma, denoised)
        x = _add_ancestral_noise(cfg, x, i, next_sigma, sigma_up, step_noise)
    return x


def _neg_log(sigma):
    return -np.log(np.maximum(sigma, f32(1e-12)))


def _dpmpp2s(cfg, guider, denoise_fn, x, cond, uc, step_noise, sigmas):
    """DPM++ 2S ancestral: a midpoint denoise in log-sigma; the step whose
    sigma_down is 0 (the last) takes the Euler step."""
    for i in _steps(sigmas):
        sigma, next_sigma = sigmas[i], sigmas[i + 1]
        sigma_down, sigma_up = _ancestral_sigmas(sigma, next_sigma)
        denoised = _guided(denoise_fn, guider, x, float(sigma), cond, uc)
        if sigma_down > 1e-14:
            t, t_next = _neg_log(sigma), _neg_log(sigma_down)
            h = t_next - t
            s = t + f32(0.5) * h
            x2 = float(np.exp(-s + t)) * x - float(np.expm1(f32(-0.5) * h)) * denoised
            den2 = _guided(denoise_fn, guider, x2, float(np.exp(-s)), cond, uc)
            x = float(np.exp(-t_next + t)) * x - float(np.expm1(-h)) * den2
        else:
            x = x + float(sigma_down - sigma) * _to_d(x, sigma, denoised)
        x = _add_ancestral_noise(cfg, x, i, next_sigma, sigma_up, step_noise)
    return x


def _dpmpp2m(cfg, guider, denoise_fn, x, cond, uc, step_noise, sigmas):
    """DPM++ 2M: the first and the last step take the first-order update."""
    old_denoised = None
    for i in _steps(sigmas):
        prev_sigma, sigma, next_sigma = sigmas[max(i - 1, 0)], sigmas[i], sigmas[i + 1]
        denoised = _guided(denoise_fn, guider, x, float(sigma), cond, uc)
        t, t_next = _neg_log(sigma), _neg_log(next_sigma)
        h = t_next - t
        mult1, mult2 = float(np.exp(-h)), float(np.expm1(-h))
        if i > 0 and next_sigma > 1e-14:
            r = (t - _neg_log(prev_sigma)) / h
            k = f32(1) / (f32(2) * r)
            denoised_d = float(f32(1) + k) * denoised - float(k) * old_denoised
            x_new = mult1 * x - mult2 * denoised_d
        else:
            x_new = mult1 * x - mult2 * denoised
        x, old_denoised = x_new, denoised
    return x


def _lms_coeff_matrix(sigmas: np.ndarray, order: int) -> np.ndarray:
    """Adams-Bashforth-style coefficients over the sigma grid, (n, order):
    each Lagrange basis polynomial integrated exactly by Gauss-Legendre."""
    n = len(sigmas) - 1
    coeffs = np.zeros((n, order), dtype=np.float64)
    nodes, weights = np.polynomial.legendre.leggauss(max(2, order))
    for i in range(n):
        cur_order = min(i + 1, order)
        a, b = sigmas[i], sigmas[i + 1]
        taus = 0.5 * (b - a) * nodes + 0.5 * (b + a)
        for j in range(cur_order):
            prod = np.ones_like(taus)
            for k in range(cur_order):
                if j != k:
                    prod *= (taus - sigmas[i - k]) / (sigmas[i - j] - sigmas[i - k])
            coeffs[i, j] = 0.5 * (b - a) * np.sum(weights * prod)
    return coeffs.astype(np.float32)


def _lms(cfg, guider, denoise_fn, x, cond, uc, step_noise, sigmas, order: int = 4):
    coeffs = _lms_coeff_matrix(sigmas, order)
    ds = []  # newest first
    for i in _steps(sigmas):
        denoised = _guided(denoise_fn, guider, x, float(sigmas[i]), cond, uc)
        ds = [_to_d(x, sigmas[i], denoised)] + ds[:order - 1]
        x = x + sum(float(coeffs[i, j]) * dj for j, dj in enumerate(ds))
    return x


_SAMPLERS = {
    "euler_edm": lambda *a: _euler_edm(*a, heun=False),
    "heun_edm": lambda *a: _euler_edm(*a, heun=True),
    "euler_ancestral": _euler_ancestral,
    "dpmpp2s": _dpmpp2s,
    "dpmpp2m": _dpmpp2m,
    "lms": _lms,
}


def make_sampler(cfg: SamplerConfig):
    """Build ``sample(denoise_fn, noise, cond, uc, step_noise=None) -> latents``;
    an unknown ``cfg.kind`` raises ``KeyError``, as in the JAX package."""
    step = _SAMPLERS[cfg.kind]
    sigmas = get_sigmas(cfg.discretization, cfg.num_steps, sigma_min=cfg.sigma_min,
                        sigma_max=cfg.sigma_max, rho=cfg.rho)
    guider = make_guider(cfg.guider)

    def sample_fn(denoise_fn: DenoiseFn, noise: torch.Tensor, cond, uc,
                  step_noise: Optional[StepNoiseFn] = None) -> torch.Tensor:
        x = noise * float(np.sqrt(1.0 + float(sigmas[0]) ** 2))
        if step_noise is None:
            step_noise = default_step_noise(noise.device)
        return step(cfg, guider, denoise_fn, x, cond, uc, step_noise, sigmas)

    return sample_fn
