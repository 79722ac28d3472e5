"""The denoiser preconditioning of SVD (counterpart of
``VScalingWithEDMcNoise`` in ``streamingt2v_tpu/diffusion/scaling.py``):
v-prediction scalings with the EDM noise conditioning 0.25 * log(sigma).
The other scalings of the JAX package wait for the stages that use them."""

from __future__ import annotations

from typing import Tuple

import torch


def v_scaling_with_edm_cnoise(sigma: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """sigma -> (c_skip, c_out, c_in, c_noise)."""
    c_skip = 1.0 / (sigma ** 2 + 1.0)
    c_out = -sigma * torch.rsqrt(sigma ** 2 + 1.0)
    c_in = torch.rsqrt(sigma ** 2 + 1.0)
    return c_skip, c_out, c_in, 0.25 * torch.log(sigma)
