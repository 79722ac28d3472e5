"""Adversarial autoencoder losses (counterpart of
``streamingt2v_tpu/diffusion/gan_loss.py``): the PatchGAN (NLayer)
discriminator, the hinge and vanilla discriminator losses, the generator
loss and the adaptive generator weight.  The perceptual term is
``diffusion/lpips.py``.  Images are NCHW (torch's layout, as the
reference's discriminator takes them).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from streamingt2v_torch.diffusion.lpips import conv_nchw
from streamingt2v_torch.models.layers import Conv, norm_pair, norm_params

# flax nn.GroupNorm's default epsilon
_GN_EPS = 1e-6


class PatchDiscriminator(nn.Module):
    """NLayerDiscriminator: 4x4 convs (stride 2, then 1; symmetric padding
    1), each but the first and the last followed by a per-channel GroupNorm
    with an affine (flax ``GroupNorm(num_groups=None, group_size=1)``, i.e.
    ``nn.GroupNorm(C, C)``) and leaky-ReLU(0.2)."""

    def __init__(self, in_channels: int = 3, ndf: int = 64, n_layers: int = 3, *,
                 device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self.n_layers = n_layers
        self.conv0 = Conv(in_channels, ndf, 4, stride=2, padding=1, **fk)
        nf = ndf
        for i in range(1, n_layers):
            nf_next = min(ndf * 2 ** i, ndf * 8)
            self.add_module(f"conv{i}", Conv(nf, nf_next, 4, stride=2, padding=1, bias=False,
                                             **fk))
            norm_params(self, f"norm{i}", nf_next, **fk)
            nf = nf_next
        nf_last = min(ndf * 2 ** n_layers, ndf * 8)
        self.conv_last = Conv(nf, nf_last, 4, stride=1, padding=1, bias=False, **fk)
        norm_params(self, "norm_last", nf_last, **fk)
        self.conv_out = Conv(nf_last, 1, 4, stride=1, padding=1, **fk)

    def _norm_act(self, h: torch.Tensor, name: str) -> torch.Tensor:
        scale, bias = norm_pair(self, name)
        h = F.group_norm(h, h.shape[1], scale.to(h.dtype), bias.to(h.dtype), eps=_GN_EPS)
        return F.leaky_relu(h, 0.2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (N, C, H, W) -> patch logits (N, 1, H', W')."""
        h = F.leaky_relu(conv_nchw(self.conv0, x), 0.2)
        for i in range(1, self.n_layers):
            h = self._norm_act(conv_nchw(getattr(self, f"conv{i}"), h), f"norm{i}")
        h = self._norm_act(conv_nchw(self.conv_last, h), "norm_last")
        return conv_nchw(self.conv_out, h)


def hinge_d_loss(logits_real: torch.Tensor, logits_fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (F.relu(1.0 - logits_real).mean() + F.relu(1.0 + logits_fake).mean())


def vanilla_d_loss(logits_real: torch.Tensor, logits_fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (F.softplus(-logits_real).mean() + F.softplus(logits_fake).mean())


def generator_loss(logits_fake: torch.Tensor) -> torch.Tensor:
    return -logits_fake.mean()


def adaptive_weight(nll_grad_norm: torch.Tensor, g_grad_norm: torch.Tensor,
                    clip: float = 1e4) -> torch.Tensor:
    """||d nll|| / ||d g_loss|| on the decoder's last layer, clipped to
    [0, clip]."""
    return (nll_grad_norm / (g_grad_norm + 1e-4)).clamp(0.0, clip)
