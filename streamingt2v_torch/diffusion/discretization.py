"""Sigma schedules (host-side, static).

Schedules are computed in numpy at trace time — they are tiny, static
vectors, so the sampler scan sees them as constants and XLA folds them.

- EDM rho-schedule (reference discretizer.py:28-39)
- Legacy DDPM linear-beta schedule (reference discretizer.py:42-70)
- AlignYourSteps (arXiv 2404.14507): 10 hand-tuned knots for SVD,
  log-linearly resampled (reference models/diffusion/discretizer.py:8-33,
  configured with sigma_max=700, config.yaml:146-149).
"""

from __future__ import annotations

import numpy as np

# Published AYS sampling schedule for SVD (arXiv 2404.14507, Table 3).
AYS_SVD_KNOTS = (
    700.00, 54.5, 15.886, 7.977, 4.248, 1.789, 0.981, 0.403, 0.173, 0.034, 0.002
)


def _append_zero(sigmas: np.ndarray) -> np.ndarray:
    return np.concatenate([sigmas, np.zeros((1,), sigmas.dtype)])


def loglinear_interp(decreasing_knots: np.ndarray, num_steps: int) -> np.ndarray:
    """Log-linear resampling of a decreasing schedule to `num_steps` points."""
    knots = np.asarray(decreasing_knots, dtype=np.float64)
    xs = np.linspace(0.0, 1.0, len(knots))
    ys = np.log(knots[::-1])
    new_xs = np.linspace(0.0, 1.0, num_steps)
    new_ys = np.interp(new_xs, xs, ys)
    return np.exp(new_ys)[::-1].copy()


def align_your_steps_sigmas(n: int, *, append_zero: bool = True) -> np.ndarray:
    sigmas = loglinear_interp(np.asarray(AYS_SVD_KNOTS), n).astype(np.float32)
    return _append_zero(sigmas) if append_zero else sigmas


def edm_sigmas(
    n: int, *, sigma_min: float = 0.002, sigma_max: float = 80.0, rho: float = 7.0,
    append_zero: bool = True,
) -> np.ndarray:
    ramp = np.linspace(0.0, 1.0, n)
    min_inv_rho = sigma_min ** (1.0 / rho)
    max_inv_rho = sigma_max ** (1.0 / rho)
    sigmas = ((max_inv_rho + ramp * (min_inv_rho - max_inv_rho)) ** rho).astype(np.float32)
    return _append_zero(sigmas) if append_zero else sigmas


def legacy_ddpm_sigmas(
    n: int, *, linear_start: float = 0.00085, linear_end: float = 0.0120,
    num_timesteps: int = 1000, append_zero: bool = True,
) -> np.ndarray:
    # linear *sqrt* beta schedule (sgm make_beta_schedule 'linear')
    betas = (
        np.linspace(linear_start**0.5, linear_end**0.5, num_timesteps, dtype=np.float64) ** 2
    )
    alphas_cumprod = np.cumprod(1.0 - betas)
    if n < num_timesteps:
        timesteps = np.linspace(num_timesteps - 1, 0, n, endpoint=False).astype(int)[::-1]
        alphas_cumprod = alphas_cumprod[timesteps]
    elif n != num_timesteps:
        raise ValueError(f"n={n} > num_timesteps={num_timesteps}")
    sigmas = np.sqrt((1 - alphas_cumprod) / alphas_cumprod).astype(np.float32)[::-1].copy()
    return _append_zero(sigmas) if append_zero else sigmas


def get_sigmas(kind: str, n: int, *, sigma_min: float = 0.002, sigma_max: float = 80.0,
               rho: float = 7.0, append_zero: bool = True) -> np.ndarray:
    if kind == "align_your_steps":
        return align_your_steps_sigmas(n, append_zero=append_zero)
    if kind == "edm":
        return edm_sigmas(n, sigma_min=sigma_min, sigma_max=sigma_max, rho=rho,
                          append_zero=append_zero)
    if kind == "legacy_ddpm":
        return legacy_ddpm_sigmas(n, append_zero=append_zero)
    raise ValueError(kind)
