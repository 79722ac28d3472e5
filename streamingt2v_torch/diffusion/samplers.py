"""The EulerEDM sampler (counterpart of ``_euler_edm_scan``,
``streamingt2v_tpu/diffusion/samplers.py:56``) as a Python loop.

A sampler takes ``denoise_fn(x, sigma, cond) -> denoised`` (cond is the
guider-doubled dict) plus the raw (c, uc) pair and the initial noise, and
returns the final latents.  Sigma schedules are host numpy constants.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch

from streamingt2v_torch.config import SamplerConfig
from streamingt2v_torch.diffusion.discretization import get_sigmas
from streamingt2v_torch.diffusion.guiders import Guider, make_guider

DenoiseFn = Callable[[torch.Tensor, torch.Tensor, Dict[str, Any]], torch.Tensor]


def _guided(denoise_fn: DenoiseFn, guider: Guider, x, sigma: float, cond, uc):
    """One guided denoise at a scalar sigma."""
    sigma_vec = torch.full((x.shape[0],), sigma, dtype=torch.float32, device=x.device)
    x_in, s_in, c_in = guider.prepare(x, sigma_vec, cond, uc)
    return guider.combine(denoise_fn(x_in, s_in, c_in))


def euler_edm_step(denoise_fn: DenoiseFn, guider: Guider, x: torch.Tensor,
                   sigma: np.float32, next_sigma: np.float32, cond, uc) -> torch.Tensor:
    """x_{i+1} = x + (sigma_{i+1} - sigma_i) * (x - D(x, sigma_i)) / sigma_i."""
    denoised = _guided(denoise_fn, guider, x, float(sigma), cond, uc)
    d = (x - denoised) / max(float(sigma), 1e-12)
    return x + float(np.float32(next_sigma - sigma)) * d


def make_sampler(cfg: SamplerConfig):
    """Build ``sample(denoise_fn, noise, cond, uc) -> latents``."""
    if cfg.kind != "euler_edm":
        raise NotImplementedError(f"sampler {cfg.kind!r} is not ported yet")
    if cfg.s_churn > 0:
        raise NotImplementedError("EulerEDM with s_churn > 0 is not ported yet")
    sigmas = get_sigmas(cfg.discretization, cfg.num_steps, sigma_min=cfg.sigma_min,
                        sigma_max=cfg.sigma_max, rho=cfg.rho)
    guider = make_guider(cfg.guider)

    def sample_fn(denoise_fn: DenoiseFn, noise: torch.Tensor, cond, uc) -> torch.Tensor:
        x = noise * float(np.sqrt(1.0 + float(sigmas[0]) ** 2))
        for i in range(len(sigmas) - 1):
            x = euler_edm_step(denoise_fn, guider, x, sigmas[i], sigmas[i + 1], cond, uc)
        return x

    return sample_fn
