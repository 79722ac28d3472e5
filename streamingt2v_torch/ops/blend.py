"""AlphaBlender: a sigmoid-gated mix of the spatial and temporal branches
(counterpart of ``streamingt2v_tpu/ops/blend.py``).

The strategies ``fixed``, ``learned`` and ``learned_with_images``: in the
last, rows flagged as still images take the spatial branch (alpha = 1) and
video rows sigmoid(mix_factor).  ``out = alpha * spatial + (1 - alpha) *
temporal``, alpha rounded to the branches' dtype first.  The sigmoid is
taken in f32.
"""

from __future__ import annotations

from typing import Optional

import torch


def blend_weight(mix_factor: torch.Tensor, *, strategy: str,
                 image_indicator: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Alpha in [0, 1]: ``mix_factor`` itself (``fixed``), or its sigmoid in
    f32, per row of ``image_indicator`` for ``learned_with_images``."""
    if strategy == "fixed":
        return mix_factor
    if strategy == "learned":
        return torch.sigmoid(mix_factor.float())
    if strategy == "learned_with_images":
        if image_indicator is None:
            raise ValueError("learned_with_images needs image_indicator")
        alpha = torch.sigmoid(mix_factor.float())
        return torch.where(image_indicator, torch.ones_like(alpha), alpha)
    raise ValueError(strategy)


def alpha_blend(spatial: torch.Tensor, temporal: torch.Tensor, mix_factor: torch.Tensor, *,
                strategy: str = "learned_with_images",
                image_indicator: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The blend of two branches of one shape; alpha (a scalar, or leading
    dims such as the (B, T) indicator's) broadcasts over the trailing dims."""
    alpha = blend_weight(mix_factor, strategy=strategy, image_indicator=image_indicator)
    alpha = alpha.to(spatial.dtype)
    alpha = alpha.reshape(alpha.shape + (1,) * (spatial.ndim - alpha.ndim))
    return alpha * spatial + (1.0 - alpha) * temporal
