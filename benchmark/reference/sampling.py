"""Plain reference of the two samplers the cells drive.

Stage 1 (StreamingSVD ``code/config.yaml:140-156``): EulerEDM without churn
on the AlignYourSteps sigmas for SVD (arXiv 2404.14507, Table 3; the knots
log-linearly resampled to the step count, then 0), the
LinearPredictionGuider (per-frame scales linear from ``min_scale`` to
``max_scale``; batch order [uncond, cond]) and the EDM denoiser with SVD's
v-prediction scalings and c_noise = log(sigma) / 4.

Stage 2 (diffusers DDIM as I2VGen-XL's pipeline runs it): eta = 0,
epsilon prediction, scaled-linear betas 0.00085 -> 0.012 over 1000
timesteps, leading spacing with offset 1, the final alpha_cumprod
alphas_cumprod[0]; SDEdit keeps the last int(steps * strength) timesteps.
Classifier-free guidance eps_u + g (eps_c - eps_u).  Randomized blending
writes the chunks back in order, chunk c > 0 keeping the frames of the
chunks before it below its random offset.
"""

from __future__ import annotations

import numpy as np
import torch

AYS_SVD_KNOTS = (700.00, 54.5, 15.886, 7.977, 4.248, 1.789, 0.981, 0.403, 0.173, 0.034, 0.002)


def ays_sigmas(n: int) -> np.ndarray:
    """n sigmas from the AYS knots, log-linearly resampled, and a final 0 (f32)."""
    knots = np.log(np.asarray(AYS_SVD_KNOTS, dtype=np.float64)[::-1])
    xs = np.linspace(0.0, 1.0, len(knots))
    sig = np.exp(np.interp(np.linspace(0.0, 1.0, n), xs, knots))[::-1]
    return np.concatenate([sig.astype(np.float32), np.zeros(1, np.float32)])


def frame_scales(cfg: dict) -> torch.Tensor:
    g = cfg["guider"]
    return torch.from_numpy(np.linspace(g["min_scale"], g["max_scale"],
                                        g["num_frames"]).astype(np.float32))


def v_scalings(sigma: torch.Tensor):
    """(c_skip, c_out, c_in, c_noise) of SVD's v-prediction EDM denoiser."""
    sigma = sigma.float().clamp_min(1e-12)
    c_in = torch.rsqrt(sigma ** 2 + 1.0)
    return 1.0 / (sigma ** 2 + 1.0), -sigma * c_in, c_in, 0.25 * torch.log(sigma)


def guided_denoise(network, x: torch.Tensor, sigma: float, c: dict, uc: dict,
                   scales: torch.Tensor) -> torch.Tensor:
    """The guided denoised latents at one sigma: the network on [uc; c]."""
    b = x.shape[0]
    x2 = torch.cat([x, x]).float()
    cond = {k: torch.cat([uc[k], c[k]]) if k in ("vector", "crossattn", "concat", "ctrl_frames")
            else c[k] for k in c}
    s = torch.full((2 * b,), sigma, dtype=torch.float32, device=x.device)
    c_skip, c_out, c_in, c_noise = (v.reshape(-1, 1, 1, 1, 1) if v.ndim else v
                                    for v in v_scalings(s))
    out = network(x2 * c_in, c_noise.reshape(-1), cond).float()
    den = out * c_out + x2 * c_skip
    d_u, d_c = den.chunk(2)
    return d_u + scales.to(x.device).reshape(1, -1, 1, 1, 1) * (d_c - d_u)


def euler_step(network, x: torch.Tensor, i: int, sigmas: np.ndarray, c: dict, uc: dict,
               scales: torch.Tensor) -> torch.Tensor:
    """x_{i+1} = x + (sigma_{i+1} - sigma_i) (x - D(x, sigma_i)) / sigma_i."""
    sigma, nxt = sigmas[i], sigmas[i + 1]
    den = guided_denoise(network, x, float(sigma), c, uc, scales)
    return x.float() + float(nxt - sigma) * ((x.float() - den) / max(float(sigma), 1e-12))


def euler_base(x: torch.Tensor, i: int, sigmas: np.ndarray) -> torch.Tensor:
    """The same step with the network's output at zero (D = c_skip x in both
    halves, which the guidance leaves as it is): what the network moves."""
    sigma, nxt = sigmas[i], sigmas[i + 1]
    c_skip = v_scalings(torch.tensor([float(sigma)]))[0].to(x.device)
    return x.float() + float(nxt - sigma) * ((x.float() - c_skip * x.float())
                                            / max(float(sigma), 1e-12))


def initial_latents(noise: torch.Tensor, sigmas: np.ndarray) -> torch.Tensor:
    """The sampler's start: noise * sqrt(1 + sigma_0^2)."""
    return noise.float() * float(np.sqrt(1.0 + float(sigmas[0]) ** 2))


class DDIM:
    def __init__(self, num_train_timesteps: int = 1000, beta_start: float = 0.00085,
                 beta_end: float = 0.012, steps_offset: int = 1):
        betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5, num_train_timesteps,
                            dtype=np.float64) ** 2
        acp = np.cumprod(1.0 - betas)
        self.total = num_train_timesteps
        self.offset = steps_offset
        self.acp = acp.astype(np.float32)
        self.final = float(acp[0])

    def timesteps(self, n: int, strength: float) -> list:
        """The SDEdit timesteps: leading spacing, the last int(n * strength)."""
        ts = (np.arange(n) * (self.total // n)).round()[::-1].astype(np.int64) + self.offset
        keep = min(int(n * strength), n)
        return [int(t) for t in ts[n - keep:]]

    def add_noise(self, x0: torch.Tensor, noise: torch.Tensor, t: int) -> torch.Tensor:
        a = torch.tensor(self.acp[t])
        return torch.sqrt(a) * x0 + torch.sqrt(1.0 - a) * noise

    def step(self, eps: torch.Tensor, t: int, x: torch.Tensor, n: int) -> torch.Tensor:
        prev = t - self.total // n
        a_t = torch.tensor(self.acp[t])
        a_prev = torch.tensor(self.acp[prev] if prev >= 0 else self.final, dtype=torch.float32)
        x0 = (x - torch.sqrt(1.0 - a_t) * eps) / torch.sqrt(a_t)
        return torch.sqrt(a_prev) * x0 + torch.sqrt(1.0 - a_prev) * eps


def chunk_frames(c: int, n_chunks: int, stride: int, size: int, offsets: dict) -> range:
    """The frames of the written-back video that come from chunk c: from its
    start plus its offset to the next chunk's start plus that one's."""
    lo = c * stride + (offsets[c] if c > 0 else 0)
    hi = (c + 1) * stride + offsets[c + 1] if c + 1 < n_chunks else (n_chunks - 1) * stride + size
    return range(lo, hi)
