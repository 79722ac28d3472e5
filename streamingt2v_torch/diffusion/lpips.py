"""LPIPS perceptual loss on a VGG16 backbone (counterpart of
``streamingt2v_tpu/diffusion/lpips.py``).

VGG16 features at the five relu stages, each unit-normalised over its
channels, squared differences, a 1x1 linear head per stage, the spatial
mean, summed over the stages.  Images are NCHW in [-1, 1] (torch's layout,
as the reference's LPIPS takes them; the JAX package runs NHWC, so the
channel axis of the normalisation is dim 1 here and the spatial mean is
over dims 2 and 3).  Weights load from a torchvision VGG16 state dict plus
the LPIPS ``vgg.pth`` heads through ``lpips_map`` (``utils/checkpoint.py``);
no weights ship with the repository.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from streamingt2v_torch.models.layers import Conv
from streamingt2v_torch.utils.checkpoint import lpips_map  # noqa: F401  (the map's home)

# VGG16 conv layers per stage (torchvision ``features`` indices)
_VGG_STAGES: Tuple[Tuple[int, ...], ...] = (
    (0, 2), (5, 7), (10, 12, 14), (17, 19, 21), (24, 26, 28))
_VGG_WIDTHS = (64, 128, 256, 512, 512)

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def conv_nchw(conv: Conv, x: torch.Tensor) -> torch.Tensor:
    """A port ``Conv`` (kernel (out, in, kh, kw)) applied to NCHW input."""
    return F.conv2d(x, conv.kernel.to(x.dtype),
                    None if conv.bias is None else conv.bias.to(x.dtype),
                    stride=conv.stride, padding=conv.padding)


class VGG16Features(nn.Module):
    def __init__(self, *, device=None, dtype=None):
        super().__init__()
        c_in = 3
        for idxs, width in zip(_VGG_STAGES, _VGG_WIDTHS):
            for li in idxs:
                self.add_module(f"conv_{li}", Conv(c_in, width, 3, device=device, dtype=dtype))
                c_in = width

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x: (N, 3, H, W) in [-1, 1] -> the five stages' relu features, NCHW.
        The LPIPS input scaling is applied here; a 2x2 max pool follows
        stages 0-3."""
        shift = torch.tensor(_SHIFT, dtype=x.dtype, device=x.device).reshape(1, 3, 1, 1)
        scale = torch.tensor(_SCALE, dtype=x.dtype, device=x.device).reshape(1, 3, 1, 1)
        x = (x - shift) / scale
        feats = []
        for si, idxs in enumerate(_VGG_STAGES):
            for li in idxs:
                x = F.relu(conv_nchw(getattr(self, f"conv_{li}"), x))
            feats.append(x)
            if si < len(_VGG_STAGES) - 1:
                x = F.max_pool2d(x, 2, 2)
        return feats


class LPIPS(nn.Module):
    def __init__(self, *, device=None, dtype=None):
        super().__init__()
        self.vgg = VGG16Features(device=device, dtype=dtype)
        for i, width in enumerate(_VGG_WIDTHS):
            self.add_module(f"lin_{i}", Conv(width, 1, 1, bias=False, device=device, dtype=dtype))

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """x, y: (N, 3, H, W) in [-1, 1] -> (N,) distances."""
        total = 0.0
        for i, (a, b) in enumerate(zip(self.vgg(x), self.vgg(y))):
            a = a * torch.rsqrt(a.square().sum(dim=1, keepdim=True) + 1e-10)
            b = b * torch.rsqrt(b.square().sum(dim=1, keepdim=True) + 1e-10)
            lin = conv_nchw(getattr(self, f"lin_{i}"), (a - b).square())
            total = total + lin.mean(dim=(1, 2, 3))
        return total
