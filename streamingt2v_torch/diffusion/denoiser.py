"""EDM-preconditioned denoiser (counterpart of
``streamingt2v_tpu/diffusion/denoiser.py``):
D(x, sigma) = network(x * c_in, c_noise, cond) * c_out + x * c_skip,
with sigma per batch row (B,) and the scalings of ``scaling``."""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from streamingt2v_torch.diffusion.scaling import get_scaling

NetworkFn = Callable[[torch.Tensor, torch.Tensor, Dict[str, Any]], torch.Tensor]


def _bdims(v: torch.Tensor, ndim: int) -> torch.Tensor:
    return v.reshape(v.shape + (1,) * (ndim - v.ndim))


def denoise(network_fn: NetworkFn, x: torch.Tensor, sigma: torch.Tensor,
            cond: Dict[str, Any], *, scaling: str = "v_edm_cnoise") -> torch.Tensor:
    sigma = sigma.float().clamp_min(1e-12)  # log-safe at sigma = 0
    c_skip, c_out, c_in, c_noise = get_scaling(scaling)(sigma)
    out = network_fn(x * _bdims(c_in, x.ndim).to(x.dtype), c_noise, cond)
    return out.float() * _bdims(c_out, x.ndim) + x.float() * _bdims(c_skip, x.ndim)
