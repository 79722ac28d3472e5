"""Backward warping for the optical-flow models (counterpart of
``streamingt2v_tpu/ops/warp.py``).

Bilinear sampling at (x + flow_x, y + flow_y) with border clamping, the
pixel-space form of the reference's ``grid_sample`` warp (normalized grid,
``align_corners=True``, ``padding_mode="border"``).  The four taps are
gathered in pixel space with the JAX function's arithmetic, so the two agree
to the bit on the same inputs; ``grid_sample`` would first round the
normalized coordinate 2·sx/(W−1)−1 in f32.
"""

from __future__ import annotations

import torch


def backward_warp(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """x: (B, H, W, C); flow: (B, H, W, 2) pixel displacements (dx, dy).
    Returns x sampled at (col + dx, row + dy), bilinear, border-clamped."""
    b, h, w, c = x.shape
    rows = torch.arange(h, dtype=torch.float32, device=x.device)[None, :, None]
    cols = torch.arange(w, dtype=torch.float32, device=x.device)[None, None, :]
    sx = (cols + flow[..., 0]).clamp(0.0, w - 1.0)
    sy = (rows + flow[..., 1]).clamp(0.0, h - 1.0)

    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    fx = (sx - x0)[..., None]
    fy = (sy - y0)[..., None]
    x0 = x0.long()
    y0 = y0.long()
    x1 = (x0 + 1).clamp_max(w - 1)
    y1 = (y0 + 1).clamp_max(h - 1)
    bi = torch.arange(b, device=x.device)[:, None, None]
    v00, v01 = x[bi, y0, x0], x[bi, y0, x1]
    v10, v11 = x[bi, y1, x0], x[bi, y1, x1]
    top = v00 * (1 - fx) + v01 * fx
    bot = v10 * (1 - fx) + v11 * fx
    return top * (1 - fy) + bot * fy
