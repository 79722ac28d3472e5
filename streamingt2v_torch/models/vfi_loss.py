"""EMA-VFI training losses (counterpart of
``streamingt2v_tpu/models/vfi_loss.py``): the Laplacian-pyramid L1
(``lap_loss``) and the ternary census loss.  Images are NCHW (torch's
layout, as the reference's losses take them; the JAX package runs NHWC).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

_GAUSS = np.asarray(
    [[1, 4, 6, 4, 1], [4, 16, 24, 16, 4], [6, 24, 36, 24, 6],
     [4, 16, 24, 16, 4], [1, 4, 6, 4, 1]], np.float32) / 256.0


def _reflect_index(n: int, pad: int, device) -> torch.Tensor:
    """Source rows of a ``pad``-wide reflect pad of n rows (the edge not
    repeated, folded again where pad >= n, as ``jnp.pad(mode="reflect")``;
    torch's reflect pad needs pad < n)."""
    i = torch.arange(-pad, n + pad, device=device).abs()
    if n == 1:
        return torch.zeros_like(i)
    i = i % (2 * (n - 1))
    return torch.where(i >= n, 2 * (n - 1) - i, i)


def _conv_gauss(img: torch.Tensor, gain: float = 1.0) -> torch.Tensor:
    """The 5x5 Gaussian per channel after a 2-pixel reflect pad."""
    n, c, h, w = img.shape
    k = torch.from_numpy(_GAUSS * gain).to(img.device, img.dtype)
    k = k[None, None].expand(c, 1, 5, 5)
    img = img.index_select(2, _reflect_index(h, 2, img.device))
    img = img.index_select(3, _reflect_index(w, 2, img.device))
    return F.conv2d(img, k, groups=c)


def _upsample(x: torch.Tensor) -> torch.Tensor:
    n, c, h, w = x.shape
    up = x.new_zeros((n, c, h * 2, w * 2))
    up[:, :, ::2, ::2] = x
    return _conv_gauss(up, gain=4.0)


def laplacian_pyramid(img: torch.Tensor, max_levels: int = 5) -> list:
    """The ``max_levels`` band-pass levels of (N, C, H, W); H and W must
    divide by 2**max_levels, as each level's 2x upsample must give back its
    size (the JAX package fails there on a shape mismatch)."""
    if img.shape[2] % 2 ** max_levels or img.shape[3] % 2 ** max_levels:
        raise ValueError(f"laplacian_pyramid: {tuple(img.shape[2:])} does not divide by "
                         f"2**{max_levels}")
    pyr = []
    current = img
    for _ in range(max_levels):
        down = _conv_gauss(current)[:, :, ::2, ::2]
        pyr.append(current - _upsample(down))
        current = down
    return pyr


def lap_loss(pred: torch.Tensor, target: torch.Tensor, max_levels: int = 5) -> torch.Tensor:
    return sum((a - b).abs().mean()
               for a, b in zip(laplacian_pyramid(pred, max_levels),
                               laplacian_pyramid(target, max_levels)))


def _census_transform(gray: torch.Tensor, patch: int = 7) -> torch.Tensor:
    """(N, 1, H, W) -> (N, patch², H, W): each neighbour minus the centre
    (a patch x patch identity bank, zero padding), soft-signed."""
    eye = torch.eye(patch * patch, dtype=gray.dtype, device=gray.device)
    patches = F.conv2d(gray, eye.reshape(patch * patch, 1, patch, patch), padding=patch // 2)
    t = patches - gray
    return t / torch.sqrt(0.81 + t.square())


def ternary_loss(img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
    """Census-transform soft Hamming distance (N, 1, H, W), zero on the
    1-pixel border."""
    def gray(x):
        return 0.2989 * x[:, 0:1] + 0.587 * x[:, 1:2] + 0.114 * x[:, 2:3]

    dist = (_census_transform(gray(img0)) - _census_transform(gray(img1))).square()
    dist = (dist / (0.1 + dist)).mean(dim=1, keepdim=True)
    mask = torch.zeros_like(dist[:1])
    mask[:, :, 1:-1, 1:-1] = 1.0
    return dist * mask
