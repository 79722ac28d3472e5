"""Exponential moving average of a model's parameters (counterpart of
``streamingt2v_tpu/utils/ema.py``, the reference's LitEma): shadow copies
with the warm-up decay min(decay, (1 + n) / (10 + n)), kept in the
parameters' dtypes and updated in place."""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch


@dataclasses.dataclass
class EmaState:
    shadow: Dict[str, torch.Tensor]
    num_updates: int = 0


def ema_init(params: Dict[str, torch.Tensor]) -> EmaState:
    """``params``: name -> tensor (e.g. ``dict(module.named_parameters())``)."""
    return EmaState({name: p.detach().clone() for name, p in params.items()})


@torch.no_grad()
def ema_update(state: EmaState, params: Dict[str, torch.Tensor], decay: float = 0.9999,
               use_num_updates: bool = True) -> EmaState:
    """shadow <- shadow - (1 - d) * (shadow - param), d in f32 and (1 - d)
    rounded to each shadow's dtype, as the JAX package computes it."""
    n = state.num_updates + 1
    d = np.float32(decay)
    if use_num_updates:
        d = min(d, np.float32(1.0 + n) / np.float32(10.0 + n))
    one_minus = np.float32(1.0) - d
    groups: Dict[torch.dtype, tuple] = {}
    for name, s in state.shadow.items():
        shadows, values = groups.setdefault(s.dtype, ([], []))
        shadows.append(s)
        values.append(params[name].detach().to(s.dtype))
    for dtype, (shadows, values) in groups.items():
        scale = torch.tensor(float(one_minus), dtype=dtype).item()
        diffs = torch._foreach_sub(shadows, values)
        torch._foreach_mul_(diffs, scale)
        torch._foreach_sub_(shadows, diffs)
    state.num_updates = n
    return state


def ema_params(state: EmaState) -> Dict[str, torch.Tensor]:
    """The averaged parameters (``copy_to`` in the reference)."""
    return state.shadow
