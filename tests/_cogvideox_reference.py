"""Plain float32 reference of CogVideoX text-to-video, written from the
published model (diffusers ``CogVideoXTransformer3DModel``,
``CogVideoXDDIMScheduler``, ``CogVideoXPipeline``) and independent of the
port: it imports nothing of ``streamingt2v_torch``, of JAX or of the
benchmark.  The weights are a state dict under the port's parameter names.

``forward(w, cfg, latents, text, t)`` is the transformer; ``Scheduler``
the DDIM schedule in diffusers' own form (the eta = 0 update through
(a_t, b_t) on the predicted x0); ``guided_step`` one step of the pipeline.
``cfg`` is a dict of the published hyperparameters (``config(...)``).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def config(layers: int, heads: int, head_dim: int = 64, text_dim: int = 4096,
           time_dim: int = 512, channels: int = 16, patch: int = 2) -> dict:
    return dict(layers=layers, heads=heads, head_dim=head_dim, dim=heads * head_dim,
                text_dim=text_dim, time_dim=time_dim, channels=channels, patch=patch,
                eps=1e-5, qk_eps=1e-6, rope_dims=(16, 24, 24), theta=10000.0)


def linear(w: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    return x @ w[name + ".kernel"].float().T + w[name + ".bias"].float()


def ln(w: dict, name: str, x: torch.Tensor, eps: float) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * w[name + "_scale"].float() \
        + w[name + "_bias"].float()


def sinusoid(t: torch.Tensor, dim: int) -> torch.Tensor:
    """[cos, sin] of t * 10000^(-i / half) (flip_sin_to_cos, shift 0)."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32) / half)
    a = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(a), torch.sin(a)], dim=-1)


def rope_tables(f: int, h: int, w: int, dims, theta: float) -> tuple:
    """cos and sin (f h w, sum(dims)) evaluated token by token: channel pair
    i of a group of width d rotates by pos * theta^(-2i / d)."""
    rows_c, rows_s = [], []
    for ti in range(f):
        for hi in range(h):
            for wi in range(w):
                ang = []
                for pos, d in zip((ti, hi, wi), dims):
                    for i in range(d // 2):
                        a = pos * theta ** (-2.0 * i / d)
                        ang += [a, a]
                rows_c.append([math.cos(a) for a in ang])
                rows_s.append([math.sin(a) for a in ang])
    return torch.tensor(rows_c), torch.tensor(rows_s)


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (B, H, L, D): x cos + rot(x) sin, rot(x)_2i = -x_2i+1,
    rot(x)_2i+1 = x_2i."""
    rot = torch.empty_like(x)
    rot[..., 0::2] = -x[..., 1::2]
    rot[..., 1::2] = x[..., 0::2]
    return x * cos + rot * sin


def attention(w: dict, p: str, cfg: dict, x: torch.Tensor, n_text: int, cos, sin,
              rope: bool = True, qk_norm: bool = True) -> torch.Tensor:
    b, l, _ = x.shape
    heads, hd = cfg["heads"], cfg["head_dim"]

    def split(z):
        return z.reshape(b, l, heads, hd).transpose(1, 2)

    q, k, v = (split(linear(w, f"{p}.to_{n}", x)) for n in ("q", "k", "v"))
    if qk_norm:
        q = ln(w, f"{p}.norm_q", q, cfg["qk_eps"])
        k = ln(w, f"{p}.norm_k", k, cfg["qk_eps"])
    if rope:
        q = torch.cat([q[:, :, :n_text], rotate(q[:, :, n_text:], cos, sin)], dim=2)
        k = torch.cat([k[:, :, :n_text], rotate(k[:, :, n_text:], cos, sin)], dim=2)
    s = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(hd), dim=-1)
    o = (s @ v).transpose(1, 2).reshape(b, l, heads * hd)
    return linear(w, f"{p}.to_out", o)


def forward(w: dict, cfg: dict, latents: torch.Tensor, text: torch.Tensor, t: torch.Tensor,
            rope: bool = True, qk_norm: bool = True) -> torch.Tensor:
    """The v-prediction (B, F, C, H, W) in f32 of latents (B, F, C, H, W),
    text (B, T, text_dim) and timesteps (B,)."""
    b, f, c, hh, ww = latents.shape
    p, dim, eps = cfg["patch"], cfg["dim"], cfg["eps"]
    n_text = text.shape[1]
    hp, wp = hh // p, ww // p
    patches = latents.float().reshape(b, f, c, hp, p, wp, p).permute(0, 1, 3, 5, 2, 4, 6)
    kernel = w["patch_embed.kernel"].float().reshape(dim, c * p * p)
    video = patches.reshape(b, f * hp * wp, c * p * p) @ kernel.T + w["patch_embed.bias"].float()
    hs = torch.cat([linear(w, "text_proj", text.float()), video], dim=1)
    temb = linear(w, "time_linear_2", F.silu(linear(w, "time_linear_1", sinusoid(t, dim))))
    act = F.silu(temb)
    cos, sin = rope_tables(f, hp, wp, cfg["rope_dims"], cfg["theta"])
    for i in range(cfg["layers"]):
        blk = f"transformer_blocks.{i}"
        for norm, branch in (("norm1", "attn1"), ("norm2", "ff")):
            mod = linear(w, f"{blk}.{norm}.linear", act)[:, None]
            shift, scale, gate, e_shift, e_scale, e_gate = mod.chunk(6, dim=-1)
            n = ln(w, f"{blk}.{norm}.norm", hs, eps)
            m = torch.cat([n[:, :n_text] * (1 + e_scale) + e_shift,
                           n[:, n_text:] * (1 + scale) + shift], dim=1)
            if branch == "attn1":
                y = attention(w, f"{blk}.attn1", cfg, m, n_text, cos, sin, rope, qk_norm)
            else:
                y = linear(w, f"{blk}.ff.out",
                           F.gelu(linear(w, f"{blk}.ff.proj", m), approximate="tanh"))
            hs = torch.cat([hs[:, :n_text] + e_gate * y[:, :n_text],
                            hs[:, n_text:] + gate * y[:, n_text:]], dim=1)
    hs = ln(w, "norm_final", hs, eps)[:, n_text:]
    shift, scale = linear(w, "norm_out.linear", act)[:, None].chunk(2, dim=-1)
    hs = ln(w, "norm_out.norm", hs, eps) * (1 + scale) + shift
    out = linear(w, "proj_out", hs).reshape(b, f, hp, wp, -1, p, p)
    return out.permute(0, 1, 4, 2, 5, 3, 6).reshape(b, f, -1, hh, ww)


class Scheduler:
    """CogVideoX-5b's ``scheduler_config.json``: scaled-linear betas
    0.00085 -> 0.012 over 1000, the zero-terminal-SNR rescale, trailing
    spacing, v-prediction, set_alpha_to_one (its SNR shift is 1.0, the
    identity)."""

    def __init__(self, total: int = 1000):
        betas = np.linspace(0.00085 ** 0.5, 0.012 ** 0.5, total, dtype=np.float64) ** 2
        s = np.sqrt(np.cumprod(1.0 - betas))
        s = (s - s[-1]) * s[0] / (s[0] - s[-1])
        self.acp = s ** 2
        self.total = total

    def timesteps(self, n: int) -> list:
        return [int(t) - 1 for t in np.round(np.arange(self.total, 0, -self.total / n))]

    def step(self, v: torch.Tensor, t: int, x: torch.Tensor, n: int) -> torch.Tensor:
        prev = t - self.total // n
        a_t = float(self.acp[t])
        a_prev = float(self.acp[prev]) if prev >= 0 else 1.0
        x0 = a_t ** 0.5 * x - (1 - a_t) ** 0.5 * v
        coef = ((1 - a_prev) / (1 - a_t)) ** 0.5
        return coef * x + (a_prev ** 0.5 - a_t ** 0.5 * coef) * x0


def guided_step(w: dict, cfg: dict, sched: Scheduler, x: torch.Tensor, t: int, n_steps: int,
                prompt: torch.Tensor, negative: torch.Tensor, guidance: float) -> torch.Tensor:
    """One pipeline step: the transformer on [negative; positive], guidance,
    the DDIM update."""
    b = x.shape[0]
    tt = torch.full((2 * b,), float(t))
    v_u, v_c = forward(w, cfg, torch.cat([x, x]), torch.cat([negative, prompt]), tt).chunk(2)
    return sched.step(v_u + guidance * (v_c - v_u), t, x.float(), n_steps)
