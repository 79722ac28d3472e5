"""Sinusoidal timestep/position embeddings (counterpart of
``streamingt2v_tpu/ops/embedding.py``): half cos / half sin, frequencies
exp(-log(max_period) * i / half)."""

from __future__ import annotations

import math

import torch

from streamingt2v_torch.utils.profiling import span


@span("st2v.embed")
def timestep_embedding(timesteps: torch.Tensor, dim: int, *,
                       max_period: float = 10000.0) -> torch.Tensor:
    """timesteps: (N,) -> f32 (N, dim)."""
    timesteps = timesteps.float().reshape(-1)
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=timesteps.device) / half)
    args = timesteps[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb
