"""Learning-rate schedules (counterpart of
``streamingt2v_tpu/diffusion/lr_scheduler.py``): the reference's
LambdaWarmUpCosineScheduler, its cycled form and LambdaLinearScheduler as
plain functions of the step count, giving a multiplier of a base rate of
1.0; use them as ``torch.optim.lr_scheduler.LambdaLR(optimizer, schedule)``
multipliers.
"""

from __future__ import annotations

import bisect
import math
from typing import Callable, Sequence

Schedule = Callable[[int], float]


def warmup_cosine(warm_up_steps: int, lr_min: float, lr_max: float, lr_start: float,
                  max_decay_steps: int) -> Schedule:
    def schedule(n: int) -> float:
        if n < warm_up_steps:
            return (lr_max - lr_start) / warm_up_steps * n + lr_start
        t = min(max((n - warm_up_steps) / max(max_decay_steps - warm_up_steps, 1), 0.0), 1.0)
        return lr_min + 0.5 * (lr_max - lr_min) * (1 + math.cos(t * math.pi))

    return schedule


def _cycle(n: int, cycle_lengths: Sequence[int]) -> tuple:
    """(cycle index, steps into it): the last cycle runs on past its end."""
    cum = [0]
    for length in cycle_lengths:
        cum.append(cum[-1] + length)
    c = min(max(bisect.bisect_right(cum[1:], n), 0), len(cycle_lengths) - 1)
    return c, n - cum[c]


def warmup_cosine_cycles(warm_up_steps: Sequence[int], f_min: Sequence[float],
                         f_max: Sequence[float], f_start: Sequence[float],
                         cycle_lengths: Sequence[int]) -> Schedule:
    """LambdaWarmUpCosineScheduler2: repeated warm-up + cosine cycles."""
    def schedule(n: int) -> float:
        c, nc = _cycle(n, cycle_lengths)
        if nc < warm_up_steps[c]:
            return (f_max[c] - f_start[c]) / warm_up_steps[c] * nc + f_start[c]
        t = min(max((nc - warm_up_steps[c]) / max(cycle_lengths[c] - warm_up_steps[c], 1.0),
                    0.0), 1.0)
        return f_min[c] + 0.5 * (f_max[c] - f_min[c]) * (1 + math.cos(t * math.pi))

    return schedule


def warmup_linear_cycles(warm_up_steps: Sequence[int], f_min: Sequence[float],
                         f_max: Sequence[float], f_start: Sequence[float],
                         cycle_lengths: Sequence[int]) -> Schedule:
    """LambdaLinearScheduler: warm-up, then a linear decay to f_min per cycle."""
    def schedule(n: int) -> float:
        c, nc = _cycle(n, cycle_lengths)
        if nc < warm_up_steps[c]:
            return (f_max[c] - f_start[c]) / warm_up_steps[c] * nc + f_start[c]
        return f_min[c] + (f_max[c] - f_min[c]) * (cycle_lengths[c] - nc) / cycle_lengths[c]

    return schedule
