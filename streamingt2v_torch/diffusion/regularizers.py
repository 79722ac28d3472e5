"""Autoencoder regularizers (counterpart of
``streamingt2v_tpu/diffusion/regularizers.py``): the diagonal Gaussian of
the KL autoencoder and the vector quantizer.  Latents are channel-last, as
the port's VAE holds them.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from streamingt2v_torch.models.layers import _param


def diagonal_gaussian(moments: torch.Tensor, generator: Optional[torch.Generator] = None,
                      noise: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """moments (..., 2C) -> (z, {'kl_loss'}).  Samples with ``noise`` (a
    standard normal draw of the mean's shape) or, without it, a draw from
    ``generator``; with neither, z is the mode.  logvar is clipped to
    [-30, 20]; the KL is summed over all but the batch axis and averaged."""
    mean, logvar = moments.chunk(2, dim=-1)
    logvar = logvar.clamp(-30.0, 20.0)
    if noise is None and generator is not None:
        noise = torch.randn(mean.shape, generator=generator, device=mean.device,
                            dtype=mean.dtype)
    z = mean if noise is None else mean + torch.exp(0.5 * logvar) * noise.to(mean.dtype)
    kl = 0.5 * (mean.square() + logvar.exp() - 1.0 - logvar).sum(dim=tuple(range(1, mean.ndim)))
    return z, {"kl_loss": kl.mean()}


class VectorQuantizer(nn.Module):
    """Nearest-codebook quantization with the straight-through estimator and
    the commitment loss: ``embed`` moves the codebook towards z (z
    detached), ``commit`` z towards the codebook (the code detached)."""

    def __init__(self, codebook_size: int, dim: int, beta: float = 0.25, *,
                 device=None, dtype=None):
        super().__init__()
        self.codebook_size, self.dim, self.beta = codebook_size, dim, beta
        self.codebook = _param((codebook_size, dim), device, dtype)

    @torch.no_grad()
    def init_extra_(self, generator: torch.Generator) -> None:
        """uniform [0, 2 / codebook_size), flax's ``uniform(scale)``."""
        cb = self.codebook
        cb.copy_(torch.rand(cb.shape, generator=generator, device=cb.device)
                 * (2.0 / self.codebook_size))

    def forward(self, z: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """z (..., dim) -> (z_q with straight-through gradients,
        {'vq_loss', 'indices' (...)})."""
        cb = self.codebook
        flat = z.reshape(-1, self.dim)
        d = (flat.square().sum(dim=1, keepdim=True) - 2.0 * flat @ cb.t()
             + cb.square().sum(dim=1)[None])
        idx = d.argmin(dim=1)
        zq = cb[idx].reshape(z.shape)
        commit = (zq.detach() - z).square().mean()
        embed = (zq - z.detach()).square().mean()
        return z + (zq - z).detach(), {"vq_loss": embed + self.beta * commit,
                                       "indices": idx.reshape(z.shape[:-1])}
