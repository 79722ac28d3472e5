"""Training loss (counterpart of ``streamingt2v_tpu/diffusion/loss.py``):
the reference's StandardDiffusionLoss with its sigma samplers and loss
weightings.

Draws come from an explicit ``torch.Generator`` in the order sigmas, noise,
offset; each can be injected instead (``sigmas``, ``noise``, ``offset``), so
that a test feeds both packages the same draws.  The loss is taken in f32.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from streamingt2v_torch.diffusion.denoiser import NetworkFn, denoise
from streamingt2v_torch.diffusion.discretization import get_sigmas


def edm_sigma_sampler(n: int, generator: Optional[torch.Generator] = None, p_mean: float = -1.2,
                      p_std: float = 1.2, device=None) -> torch.Tensor:
    """Log-normal sigmas (EDMSampling), f32 (n,)."""
    return torch.exp(p_mean + p_std * torch.randn((n,), generator=generator, device=device))


def discrete_sigma_sampler(n: int, generator: Optional[torch.Generator] = None, *,
                           discretization: str = "legacy_ddpm", num_idx: int = 1000,
                           device=None) -> torch.Tensor:
    """A uniform index into the increasing discretization (DiscreteSampling)."""
    sigmas = torch.from_numpy(get_sigmas(discretization, num_idx, append_zero=False)[::-1].copy())
    idx = torch.randint(0, num_idx, (n,), generator=generator, device=device)
    return sigmas.to(idx.device)[idx]


def loss_weighting(kind: str, sigma: torch.Tensor, sigma_data: float = 0.5) -> torch.Tensor:
    if kind == "unit":
        return torch.ones_like(sigma)
    if kind == "edm":
        return (sigma ** 2 + sigma_data ** 2) / (sigma * sigma_data) ** 2
    if kind == "v":
        return (sigma ** 2 + 1.0) / sigma ** 2
    if kind == "eps":
        return sigma ** -2.0
    raise ValueError(kind)


@dataclasses.dataclass(frozen=True)
class DiffusionLossConfig:
    loss_type: str = "l2"  # l2 | l1
    weighting: str = "v"
    sigma_sampler: str = "edm"  # edm | discrete
    p_mean: float = -1.2
    p_std: float = 1.2
    num_idx: int = 1000
    offset_noise_level: float = 0.0
    scaling: str = "v_edm_cnoise"


def draw_loss_noise(cfg: DiffusionLossConfig, x0: torch.Tensor,
                    generator: Optional[torch.Generator] = None, *,
                    sigmas: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None,
                    offset: Optional[torch.Tensor] = None) -> tuple:
    """(sigmas (B,), noise (x0's shape), offset ((B, 1, ..., 1, C), or None
    without ``offset_noise_level``) for the batch x0: each one given, else
    drawn from ``generator`` in that order."""
    b, dev = x0.shape[0], x0.device
    if sigmas is None:
        if cfg.sigma_sampler == "edm":
            sigmas = edm_sigma_sampler(b, generator, cfg.p_mean, cfg.p_std, device=dev)
        else:
            sigmas = discrete_sigma_sampler(b, generator, num_idx=cfg.num_idx, device=dev)
    if noise is None:
        noise = torch.randn(x0.shape, generator=generator, device=dev, dtype=x0.dtype)
    if cfg.offset_noise_level <= 0.0:
        return sigmas, noise, None
    # per-(batch, channel) offset noise, broadcast over space and time
    if offset is None:
        offset = torch.randn((b,) + (1,) * (x0.ndim - 2) + (x0.shape[-1],),
                             generator=generator, device=dev, dtype=x0.dtype)
    return sigmas, noise, offset


def diffusion_loss(cfg: DiffusionLossConfig, network_fn: NetworkFn, x0: torch.Tensor,
                   cond: Dict[str, Any], generator: Optional[torch.Generator] = None, *,
                   sigmas: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None,
                   offset: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-example loss, mean-reduced to an f32 scalar.  x0: clean latents
    (B, ...); cond: conditioner outputs.  ``sigmas`` (B,), ``noise`` (x0's
    shape) and ``offset`` ((B, 1, ..., 1, C), with ``offset_noise_level``)
    replace the generator's draws where given."""
    b = x0.shape[0]
    sigmas, noise, offset = draw_loss_noise(cfg, x0, generator, sigmas=sigmas, noise=noise,
                                            offset=offset)
    if offset is not None:
        noise = noise + cfg.offset_noise_level * offset
    sigmas_bc = sigmas.reshape((b,) + (1,) * (x0.ndim - 1))
    pred = denoise(network_fn, x0 + noise * sigmas_bc, sigmas, cond, scaling=cfg.scaling)
    w = loss_weighting(cfg.weighting, sigmas.float()).reshape(sigmas_bc.shape)
    diff = pred - x0.float()
    if cfg.loss_type == "l2":
        per_ex = (w * diff ** 2).reshape(b, -1).mean(dim=1)
    elif cfg.loss_type == "l1":
        per_ex = (w * diff).abs().reshape(b, -1).mean(dim=1)
    else:
        raise ValueError(cfg.loss_type)
    return per_ex.mean()
