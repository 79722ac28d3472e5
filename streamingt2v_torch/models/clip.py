"""OpenCLIP ViT-H/14 visual tower (counterpart of
``streamingt2v_tpu/models/clip.py``): patch conv (no bias), class token,
positional embedding, pre-LN transformer, ln_post and projection.
Returns (pooled, tokens).

Preprocessing: [-1, 1] input -> antialiased bicubic resize -> CLIP
mean/std.  The resize is the separable linear map that
``jax.image.resize(..., antialias=True)`` computes (Keys cubic with
a = -0.5, or the triangle kernel for 'bilinear', widened by the downscale
factor, weights renormalised), built as two small matrices so both packages
resample identically.  ``resize`` is the same map for other callers (stage
2's key-frame conditioning resizes bilinearly).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from streamingt2v_torch.models.layers import Conv, Dense, _param, norm_pair, norm_params
from streamingt2v_torch.ops import attention, layer_norm

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    width: int = 1280
    layers: int = 32
    heads: int = 16
    mlp_ratio: float = 4.0
    output_dim: int = 1024

    @classmethod
    def tiny(cls) -> "CLIPVisionConfig":
        return cls(image_size=28, patch_size=14, width=32, layers=2, heads=2, output_dim=16)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    x = x.abs()
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0,
                      ((1.5 * x - 2.5) * x) * x + 1.0)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return (1.0 - x.abs()).clamp_min(0.0)


_KERNELS = {"bicubic": _keys_cubic, "bilinear": _triangle}


def _resize_matrix(in_size: int, out_size: int, device, method: str = "bicubic") -> torch.Tensor:
    """(out, in) antialiased resampling weights for ``method``."""
    scale = out_size / in_size
    inv = 1.0 / scale
    kernel_scale = max(inv, 1.0)
    sample = (torch.arange(out_size, dtype=torch.float64, device=device) + 0.5) * inv - 0.5
    src = torch.arange(in_size, dtype=torch.float64, device=device)
    w = _KERNELS[method]((sample[None, :] - src[:, None]).abs() / kernel_scale)
    total = w.sum(dim=0, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    w = torch.where(total.abs() > eps, w / torch.where(total != 0, total, 1.0),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).T.float()


def resize(x: torch.Tensor, height: int, width: int, method: str = "bicubic") -> torch.Tensor:
    """(N, H, W, C) -> f32 (N, height, width, C), antialiased, as
    ``jax.image.resize`` computes it."""
    ry = _resize_matrix(x.shape[1], height, x.device, method)
    rx = _resize_matrix(x.shape[2], width, x.device, method)
    return torch.einsum("yh,nhwc,xw->nyxc", ry, x.float(), rx)


def clip_preprocess(x: torch.Tensor, image_size: int = 224) -> torch.Tensor:
    """(N, H, W, 3) in [-1, 1] -> normalised (N, S, S, 3)."""
    x = (resize(x, image_size, image_size) + 1.0) / 2.0
    mean = torch.tensor(CLIP_MEAN, device=x.device)
    std = torch.tensor(CLIP_STD, device=x.device)
    return (x - mean) / std


class CLIPAttention(nn.Module):
    def __init__(self, width: int, heads: int, *, device=None, dtype=None):
        super().__init__()
        self.heads = heads
        self.in_proj = Dense(width, 3 * width, device=device, dtype=dtype)
        self.out_proj = Dense(width, width, device=device, dtype=dtype)

    def forward(self, x):
        q, k, v = self.in_proj(x).chunk(3, dim=-1)
        return self.out_proj(attention(q, k, v, num_heads=self.heads))


class CLIPBlock(nn.Module):
    def __init__(self, width: int, heads: int, mlp_dim: int, *, device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        norm_params(self, "ln_1", width, **fk)
        self.attn = CLIPAttention(width, heads, **fk)
        norm_params(self, "ln_2", width, **fk)
        self.mlp_fc = Dense(width, mlp_dim, **fk)
        self.mlp_proj = Dense(mlp_dim, width, **fk)

    def forward(self, x):
        x = x + self.attn(layer_norm(x, *norm_pair(self, "ln_1")))
        h = self.mlp_fc(layer_norm(x, *norm_pair(self, "ln_2")))
        h = F.gelu(h.float()).to(h.dtype)
        return x + self.mlp_proj(h)


class CLIPVisionTower(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, *, device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self.cfg = cfg
        grid = cfg.image_size // cfg.patch_size
        self.conv1 = Conv(3, cfg.width, cfg.patch_size, stride=cfg.patch_size,
                          padding="VALID", bias=False, **fk)
        self.class_embedding = _param((cfg.width,), device, dtype)
        self.positional_embedding = _param((grid * grid + 1, cfg.width), device, dtype)
        norm_params(self, "ln_pre", cfg.width, **fk)
        for i in range(cfg.layers):
            self.add_module(f"resblock_{i}", CLIPBlock(
                cfg.width, cfg.heads, int(cfg.width * cfg.mlp_ratio), **fk))
        norm_params(self, "ln_post", cfg.width, **fk)
        self.proj = _param((cfg.width, cfg.output_dim), device, dtype)

    @torch.no_grad()
    def init_extra_(self, generator: torch.Generator) -> None:
        """normal(0.02) for the embeddings and the projection."""
        for p in (self.class_embedding, self.positional_embedding, self.proj):
            p.copy_(torch.randn(p.shape, generator=generator, device=p.device) * 0.02)

    def forward(self, pixels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """pixels (N, S, S, 3) preprocessed -> (pooled (N, out), tokens)."""
        x = self.conv1(pixels)
        n = x.shape[0]
        x = x.reshape(n, -1, x.shape[-1])
        cls = self.class_embedding.to(x.dtype).expand(n, 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(x.dtype)
        x = layer_norm(x, *norm_pair(self, "ln_pre"))
        for i in range(self.cfg.layers):
            x = getattr(self, f"resblock_{i}")(x)
        x = layer_norm(x, *norm_pair(self, "ln_post"))
        pooled = x[:, 0] @ self.proj.to(x.dtype)
        return pooled, x[:, 1:]


def encode_image(tower: CLIPVisionTower, image: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """image (N, H, W, 3) in [-1, 1] -> (pooled, tokens)."""
    return tower(clip_preprocess(image, tower.cfg.image_size))
