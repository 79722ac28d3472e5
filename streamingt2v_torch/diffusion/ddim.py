"""DDIM scheduler (diffusers semantics) for the I2VGen-XL enhancement pass
(counterpart of ``streamingt2v_tpu/diffusion/ddim.py``).

The schedule is computed in numpy float64 and kept as f32, as the JAX
package keeps it; ``add_noise`` and ``step`` run on torch tensors with
``t`` a Python int.  Deterministic (eta = 0) steps, epsilon or v
prediction, leading/trailing/linspace spacing, the zero-terminal-SNR
rescale.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DDIMConfig:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"  # linear | scaled_linear | squaredcos_cap_v2
    steps_offset: int = 1
    timestep_spacing: str = "leading"  # leading | trailing | linspace
    prediction_type: str = "epsilon"  # epsilon | v_prediction
    set_alpha_to_one: bool = False
    clip_sample: bool = False
    rescale_betas_zero_snr: bool = False


def _make_betas(cfg: DDIMConfig) -> np.ndarray:
    n = cfg.num_train_timesteps
    if cfg.beta_schedule == "linear":
        return np.linspace(cfg.beta_start, cfg.beta_end, n, dtype=np.float64)
    if cfg.beta_schedule == "scaled_linear":
        return np.linspace(cfg.beta_start ** 0.5, cfg.beta_end ** 0.5, n, dtype=np.float64) ** 2
    if cfg.beta_schedule == "squaredcos_cap_v2":
        def alpha_bar(t):
            return np.cos((t + 0.008) / 1.008 * np.pi / 2) ** 2
        ts = np.arange(n, dtype=np.float64)
        return np.minimum(1 - alpha_bar((ts + 1) / n) / alpha_bar(ts / n), 0.999)
    raise ValueError(cfg.beta_schedule)


def _rescale_zero_snr(alphas_cumprod: np.ndarray) -> np.ndarray:
    """Shift the sqrt-alpha-bar schedule so the last step has zero SNR
    (arXiv 2305.08891)."""
    s = np.sqrt(alphas_cumprod)
    s0, s_last = s[0], s[-1]
    return ((s - s_last) * s0 / (s0 - s_last)) ** 2


class DDIMScheduler:
    def __init__(self, cfg: DDIMConfig = DDIMConfig()):
        self.cfg = cfg
        acp = np.cumprod(1.0 - _make_betas(cfg))
        if cfg.rescale_betas_zero_snr:
            acp = _rescale_zero_snr(acp)
        self.alphas_cumprod = acp.astype(np.float32)
        self.final_alpha_cumprod = 1.0 if cfg.set_alpha_to_one else float(acp[0])

    @classmethod
    def from_config(cls, config: dict) -> "DDIMScheduler":
        known = {f.name for f in dataclasses.fields(DDIMConfig)}
        return cls(DDIMConfig(**{k: v for k, v in config.items() if k in known}))

    def timesteps(self, num_inference_steps: int) -> np.ndarray:
        cfg = self.cfg
        n, total = num_inference_steps, cfg.num_train_timesteps
        if cfg.timestep_spacing == "leading":
            step = total // n
            return (np.arange(n) * step).round()[::-1].astype(np.int64) + cfg.steps_offset
        if cfg.timestep_spacing == "trailing":
            return np.round(np.arange(total, 0, -total / n)).astype(np.int64) - 1
        if cfg.timestep_spacing == "linspace":
            return np.linspace(0, total - 1, n).round()[::-1].astype(np.int64)
        raise ValueError(cfg.timestep_spacing)

    def sdedit_timesteps(self, num_inference_steps: int, strength: float) -> np.ndarray:
        """Strength-truncated schedule (pipeline get_timesteps,
        pipeline_i2vgen_xl.py:541-551)."""
        init = min(int(num_inference_steps * strength), num_inference_steps)
        return self.timesteps(num_inference_steps)[max(num_inference_steps - init, 0):]

    def _acp(self, t: int) -> torch.Tensor:
        return torch.tensor(self.alphas_cumprod[int(t)], dtype=torch.float32)

    def add_noise(self, x0: torch.Tensor, noise: torch.Tensor, t: int) -> torch.Tensor:
        acp = self._acp(t)
        return torch.sqrt(acp).to(x0.dtype) * x0 + torch.sqrt(1.0 - acp).to(x0.dtype) * noise

    def step(self, model_output: torch.Tensor, t: int, sample: torch.Tensor,
             num_inference_steps: int) -> torch.Tensor:
        """One deterministic (eta=0) DDIM step x_t -> x_{t-dt}."""
        cfg = self.cfg
        prev_t = int(t) - cfg.num_train_timesteps // num_inference_steps
        a_t = self._acp(t)
        a_prev = (self._acp(prev_t) if prev_t >= 0
                  else torch.tensor(self.final_alpha_cumprod, dtype=torch.float32))
        sqrt_at, sqrt_1mat = torch.sqrt(a_t), torch.sqrt(1.0 - a_t)
        if cfg.prediction_type == "epsilon":
            pred_x0 = (sample - sqrt_1mat * model_output) / sqrt_at
            eps = model_output
        elif cfg.prediction_type == "v_prediction":
            pred_x0 = sqrt_at * sample - sqrt_1mat * model_output
            eps = sqrt_at * model_output + sqrt_1mat * sample
        else:
            raise ValueError(cfg.prediction_type)
        if cfg.clip_sample:
            pred_x0 = pred_x0.clamp(-1.0, 1.0)
            eps = (sample - sqrt_at * pred_x0) / sqrt_1mat
        return torch.sqrt(a_prev) * pred_x0 + torch.sqrt(1.0 - a_prev) * eps
