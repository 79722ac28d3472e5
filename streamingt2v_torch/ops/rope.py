"""3-D rotary position embedding over (frame, row, column) video tokens, as
CogVideoX applies it (diffusers ``get_3d_rotary_pos_embed`` and
``apply_rotary_emb``, ``use_real=True``).

A head's channels split into t, h and w groups (16 / 24 / 24 of 64 in
CogVideoX-5B).  A group of width d rotates its d / 2 interleaved channel
pairs (2i, 2i + 1) by the angle pos * theta^(-2i / d), pos being the
token's integer frame, row or column; the tokens run in (f, h, w) order.
The tables hold each angle's cos and sin repeated for its pair, (L, 64) in
f32; each build counts in ``rope_tables`` (the model keeps them per
geometry and device, so a second count for one geometry is a cache miss).
"""

from __future__ import annotations

from typing import Tuple

import torch

from streamingt2v_torch.utils.profiling import count, span


def _angles(n: int, dim: int, theta: float) -> torch.Tensor:
    """(n, dim) f64: position p's angle p * theta^(-2i / dim), each repeated
    for its channel pair."""
    freqs = theta ** (-torch.arange(0, dim, 2, dtype=torch.float64) / dim)
    return torch.outer(torch.arange(n, dtype=torch.float64), freqs).repeat_interleave(2, dim=1)


def rope_3d(t: int, h: int, w: int, dims: Tuple[int, int, int] = (16, 24, 24),
            theta: float = 1e4, device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """cos and sin, each (t * h * w, sum(dims)) in f32 on ``device``, of the
    tokens of a t x h x w grid in (f, h, w) order."""
    count("rope_tables")
    dt, dh, dw = dims
    ang = torch.cat([
        _angles(t, dt, theta)[:, None, None].expand(t, h, w, dt),
        _angles(h, dh, theta)[None, :, None].expand(t, h, w, dh),
        _angles(w, dw, theta)[None, None, :].expand(t, h, w, dw)], dim=-1).reshape(t * h * w, -1)
    return ang.cos().float().to(device), ang.sin().float().to(device)


@span("st2v.rope")
def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (B, L, H, D) rotated by the (L, D) tables: x cos + rot(x) sin with
    rot(x)_2i = -x_2i+1 and rot(x)_2i+1 = x_2i, in f32, returned in x's
    dtype."""
    pairs = x.unflatten(-1, (-1, 2))
    rot = torch.stack([-pairs[..., 1], pairs[..., 0]], dim=-1).flatten(-2)
    return (x.float() * cos[:, None] + rot.float() * sin[:, None]).to(x.dtype)
