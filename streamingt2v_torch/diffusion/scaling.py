"""The denoiser preconditionings (counterpart of
``streamingt2v_tpu/diffusion/scaling.py``): pure functions of sigma
returning (c_skip, c_out, c_in, c_noise).  SVD's is
``v_scaling_with_edm_cnoise``, v-prediction scalings with the EDM noise
conditioning 0.25 * log(sigma); the others serve the training loss's
``scaling`` setting."""

from __future__ import annotations

from typing import Callable, Tuple

import torch

ScalingFn = Callable[[torch.Tensor], Tuple[torch.Tensor, ...]]


def edm_scaling(sigma: torch.Tensor, sigma_data: float = 0.5) -> Tuple[torch.Tensor, ...]:
    c_skip = sigma_data ** 2 / (sigma ** 2 + sigma_data ** 2)
    c_out = sigma * sigma_data * torch.rsqrt(sigma ** 2 + sigma_data ** 2)
    c_in = torch.rsqrt(sigma ** 2 + sigma_data ** 2)
    return c_skip, c_out, c_in, 0.25 * torch.log(sigma)


def eps_scaling(sigma: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    return torch.ones_like(sigma), -sigma, torch.rsqrt(sigma ** 2 + 1.0), sigma


def v_scaling(sigma: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    c_skip = 1.0 / (sigma ** 2 + 1.0)
    c_out = -sigma * torch.rsqrt(sigma ** 2 + 1.0)
    c_in = torch.rsqrt(sigma ** 2 + 1.0)
    return c_skip, c_out, c_in, sigma


def v_scaling_with_edm_cnoise(sigma: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """sigma -> (c_skip, c_out, c_in, c_noise)."""
    c_skip, c_out, c_in, _ = v_scaling(sigma)
    return c_skip, c_out, c_in, 0.25 * torch.log(sigma)


_SCALINGS = {
    "edm": edm_scaling,
    "eps": eps_scaling,
    "v": v_scaling,
    "v_edm_cnoise": v_scaling_with_edm_cnoise,
}


def get_scaling(name: str) -> ScalingFn:
    return _SCALINGS[name]
