"""Flow-matching UniPC (Wan2.1's ``FlowUniPCMultistepScheduler``,
``wan/utils/fm_solvers_unipc.py``, as ``wan/image2video.py`` sets it up):
the multistep UniPC predictor-corrector of diffusers'
``UniPCMultistepScheduler`` on a rectified-flow path x_s = (1 - s) x0 + s n.

- Sigmas: ``n`` points of linspace(sigma_max, 0, n + 1), sigma_max the
  training table's first sigma 1 - 1/1000 (as f32), then shifted by
  shift s / (1 + (shift - 1) s); a final sigma of 0.  The model is fed the
  timestep int(1000 s) (the scheduler's int64 cast).
- Each step converts the flow prediction v to the data prediction
  x0 = x - s v (``predict_x0``, alpha = 1 - s), corrects the sample the last
  step predicted with the new x0 (UniC, from the step before on), then
  predicts the next sample (UniP) with the ``bh2`` weights B(h) = e^-h - 1,
  h the step in lambda = log(alpha / sigma).  The order is 2 from the second
  step, 1 on the first and, ``lower_order_final``, on the last, whose
  sigma 0 makes the update the data prediction itself.

The scheduler is a pure function of its state (``UniPCState``: the last
sample and the data predictions of the last ``solver_order`` steps), so a
step can be replayed from a recorded state.  Its coefficients are worked out
in f64 from the f32 sigmas; the latents stay f32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class FlowUniPCConfig:
    """Wan's scheduler as ``image2video.py`` makes it: 1000 training
    timesteps, order 2, flow prediction through x0, ``bh2``, the lower
    order on the last step, every corrector on; ``shift`` is the sampling
    shift (``generate.py``: 3.0 for 480p image-to-video)."""

    num_train_timesteps: int = 1000
    solver_order: int = 2
    shift: float = 3.0


@dataclass(frozen=True)
class UniPCState:
    """What a step carries to the next: the sample the last step started
    from (after its correction) and the data predictions of the last steps,
    oldest first."""

    last_sample: Optional[torch.Tensor] = None
    outputs: Tuple[torch.Tensor, ...] = ()


def _lam(sigma: float) -> float:
    """lambda = log(alpha / sigma) at alpha = 1 - sigma."""
    return math.log(1.0 - sigma) - math.log(sigma)


class FlowUniPCScheduler:
    def __init__(self, cfg: FlowUniPCConfig, num_steps: int):
        if cfg.solver_order not in (1, 2):
            raise ValueError(f"solver_order {cfg.solver_order}: the port runs orders 1 and 2")
        self.cfg = cfg
        self.num_steps = num_steps
        total = cfg.num_train_timesteps
        sigma_max = float(np.float32(1.0 - 1.0 / total))
        s = np.linspace(sigma_max, 0.0, num_steps + 1)[:-1]
        s = cfg.shift * s / (1 + (cfg.shift - 1) * s)
        self.timesteps = [int(t) for t in (s * total).astype(np.int64)]
        self.sigmas = [float(x) for x in np.append(s, 0.0).astype(np.float32)]

    def order(self, i: int) -> int:
        """The predictor's order at step i (and the corrector's at i + 1)."""
        return min(self.cfg.solver_order, self.num_steps - i, min(i, self.cfg.solver_order) + 1)

    def _predict(self, x: torch.Tensor, i: int, outputs: tuple, order: int) -> torch.Tensor:
        """UniP from sigma_i to sigma_{i+1}: x is the (corrected) sample at
        step i, outputs[-1] its data prediction."""
        s0, st = self.sigmas[i], self.sigmas[i + 1]
        m0 = outputs[-1]
        if st == 0.0:       # lambda = inf: the update is the data prediction
            return m0.clone()
        h = _lam(st) - _lam(s0)
        b_h = math.expm1(-h)
        x_t = (st / s0) * x - ((1.0 - st) * b_h) * m0
        if order == 2:
            rk = (_lam(self.sigmas[i - 1]) - _lam(s0)) / h
            x_t = x_t - ((1.0 - st) * b_h * 0.5 / rk) * (outputs[-2] - m0)
        return x_t

    def _correct(self, x_t: torch.Tensor, m_t: torch.Tensor, i: int, state: UniPCState,
                 order: int) -> torch.Tensor:
        """UniC of step i - 1's update: the sample x_t at sigma_i with its data
        prediction m_t, from the last sample at sigma_{i-1}."""
        s0, st = self.sigmas[i - 1], self.sigmas[i]
        m0 = state.outputs[-1]
        h = _lam(st) - _lam(s0)
        hh = -h
        b_h = math.expm1(hh)
        x = (st / s0) * state.last_sample - ((1.0 - st) * b_h) * m0
        if order == 1:
            return x - ((1.0 - st) * b_h * 0.5) * (m_t - m0)
        rk = (_lam(self.sigmas[i - 2]) - _lam(s0)) / h
        # rho solves [[1, 1], [rk, 1]] rho = b, b_k = k! phi_(k+1)(hh) / B(h)
        phi = b_h / hh - 1.0
        b1 = phi / b_h
        b2 = (phi / hh - 0.5) * 2.0 / b_h
        rho0 = (b1 - b2) / (1.0 - rk)
        rho1 = b1 - rho0
        c = (1.0 - st) * b_h
        return x - (c * rho0 / rk) * (state.outputs[-2] - m0) - (c * rho1) * (m_t - m0)

    def step(self, v: torch.Tensor, i: int, x: torch.Tensor,
             state: UniPCState) -> Tuple[torch.Tensor, UniPCState]:
        """Step i from sample x with the flow prediction v: (the sample at
        sigma_{i+1}, the state for step i + 1).  f32 throughout."""
        x = x.float()
        m = x - self.sigmas[i] * v.float()
        if i > 0 and state.last_sample is not None:
            x = self._correct(x, m, i, state, self.order(i - 1))
        outputs = (state.outputs + (m,))[-self.cfg.solver_order:]
        nxt = self._predict(x, i, outputs, self.order(i))
        return nxt, UniPCState(last_sample=x, outputs=outputs)
