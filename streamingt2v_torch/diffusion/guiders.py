"""Classifier-free-guidance guiders (counterpart of
``streamingt2v_tpu/diffusion/guiders.py``).

A guider is ``prepare(x, sigma, c, uc) -> (x_in, sigma_in, cond_in)`` (the
CFG doubling, batch order [uncond, cond]) and ``combine(denoised)``; the
``identity`` guider runs the conditional half alone (``batch_multiplier``
1).  Latents are (B, T, H, W, C); the per-frame scales of the linear- and
triangle-prediction guiders broadcast over axis 1.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from streamingt2v_torch.config import GuiderConfig

CondDict = Dict[str, Any]
_CFG_KEYS = ("vector", "crossattn", "concat", "ctrl_frames")


def _double(x, sigma, c: CondDict, uc: CondDict):
    c_out = {k: torch.cat([uc[k], c[k]], dim=0) if k in _CFG_KEYS else c[k] for k in c}
    return torch.cat([x, x], dim=0), torch.cat([sigma, sigma], dim=0), c_out


@dataclasses.dataclass(frozen=True)
class Guider:
    prepare: Callable[..., Tuple[torch.Tensor, torch.Tensor, CondDict]]
    combine: Callable[[torch.Tensor], torch.Tensor]
    batch_multiplier: int  # 2 for the CFG guiders, 1 for identity


def make_guider(cfg: GuiderConfig) -> Guider:
    """An unknown ``cfg.kind`` raises ``ValueError``, as in the JAX package."""
    if cfg.kind == "identity":
        return Guider(prepare=lambda x, s, c, uc: (x, s, dict(c)), combine=lambda d: d,
                      batch_multiplier=1)

    if cfg.kind == "vanilla":
        scale = cfg.max_scale

        def combine_vanilla(denoised):
            x_u, x_c = denoised.chunk(2, dim=0)
            return x_u + scale * (x_c - x_u)

        return Guider(prepare=_double, combine=combine_vanilla, batch_multiplier=2)

    if cfg.kind in ("linear_prediction", "triangle_prediction"):
        if cfg.kind == "linear_prediction":
            scales = np.linspace(cfg.min_scale, cfg.max_scale, cfg.num_frames)
        else:   # a triangle wave of period 1 over [0, 1]
            values = np.linspace(0.0, 1.0, cfg.num_frames)
            tri = 2.0 * np.abs(values - np.floor(values + 0.5))
            scales = tri * (cfg.max_scale - cfg.min_scale) + cfg.min_scale
        scales = scales.astype(np.float32)

        def combine_per_frame(denoised):
            x_u, x_c = denoised.chunk(2, dim=0)
            s = torch.as_tensor(scales, device=x_u.device).reshape(
                (1, -1) + (1,) * (x_u.ndim - 2)).to(x_u.dtype)
            return x_u + s * (x_c - x_u)

        return Guider(prepare=_double, combine=combine_per_frame, batch_multiplier=2)

    raise ValueError(cfg.kind)
