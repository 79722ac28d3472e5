"""Plain reference of CogVideoX-5B text-to-video (THUDM/CogVideoX-5b
``transformer/config.json`` and ``scheduler/scheduler_config.json``; the
diffusers ``CogVideoXTransformer3DModel`` with rotary embeddings,
``CogVideoXDDIMScheduler`` and ``CogVideoXPipeline``), float32 through
``benchmark.reference.ops``.

- Embedding: per frame a 2 x 2 stride-2 convolution of the (F, C, H, W)
  latents into video tokens in (f, h, w) order; the T5 embeddings through
  ``text_proj``; the sequence [text; video].  temb = Linear(SiLU(Linear(
  [cos, sin] sinusoid of the width))).
- Block: LayerNormZero (one affine LayerNorm; shift, scale, gate for the
  video and for the text from a linear of SiLU(temb)), attention over
  [text; video] with biased q, k, v, a per-head affine LayerNorm on q and k
  (eps 1e-6), 3-D RoPE on the video tokens (head channels 16 / 24 / 24 for
  t / h / w, theta 1e4, interleaved pairs), softmax at 1 / sqrt(64), a
  biased output projection; gated residuals per kind; the same again with
  a tanh-GELU feed-forward of 4x the width.
- Out: the final affine LayerNorm, the video tokens, AdaLayerNorm (its own
  affine LayerNorm; shift, scale in that order), ``proj_out`` to the 2 x 2
  x 16 values of a patch, unpatchified.
- Scheduler: scaled-linear betas 0.00085 -> 0.012 over 1000, the SNR shift
  (1.0), the zero-terminal-SNR rescale, trailing spacing, v-prediction,
  the final alpha_cumprod 1; the eta = 0 update through the predicted x0:
  x_prev = a x + b x0, a = sqrt((1 - ab_prev) / (1 - ab_t)),
  b = sqrt(ab_prev) - sqrt(ab_t) a.
- Pipeline: the transformer once on [negative; positive], guidance
  v_u + g (v_c - v_u).

The parameter names are those under which ``benchmark/weights.py`` makes
the weights and the program loads them.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference import ops
from benchmark.reference.layers import Conv, Dense, norm, norm_of


def rope_tables(f: int, h: int, w: int, head_dim: int, theta: float, device) -> tuple:
    """cos and sin (f h w, head_dim) in f32: the t, h, w groups of widths
    head_dim / 4, 3 head_dim / 8, 3 head_dim / 8; channel pair i of a group
    of width d at position p turns by p theta^(-2i / d)."""
    dims = (head_dim // 4, head_dim // 8 * 3, head_dim // 8 * 3)
    grids = torch.meshgrid(*(torch.arange(n, dtype=torch.float64) for n in (f, h, w)),
                           indexing="ij")
    parts = []
    for pos, d in zip(grids, dims):
        freqs = theta ** (-torch.arange(0, d, 2, dtype=torch.float64) / d)
        parts.append((pos.reshape(-1, 1) * freqs).repeat_interleave(2, dim=1))
    ang = torch.cat(parts, dim=1)
    return ang.cos().float().to(device), ang.sin().float().to(device)


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (B, L, H, D): x cos + rot(x) sin, rot(x)_2i = -x_2i+1,
    rot(x)_2i+1 = x_2i."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    rot = torch.stack([-x2, x1], dim=-1).reshape(x.shape)
    return x * cos[:, None] + rot * sin[:, None]


class LayerNormZero(nn.Module):
    def __init__(self, cond: int, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.linear = Dense(cond, 6 * dim)
        norm(self, "norm", dim)

    def forward(self, h, act, n_text: int):
        shift, scale, gate, e_shift, e_scale, e_gate = self.linear(act)[:, None].chunk(6, dim=-1)
        n = ops.layer_norm(h, *norm_of(self, "norm"), eps=self.eps)
        m = torch.cat([n[:, :n_text] * (1 + e_scale) + e_shift,
                       n[:, n_text:] * (1 + scale) + shift], dim=1)
        return m, gate, e_gate


class JointAttention(nn.Module):
    def __init__(self, dim: int, heads: int, head_dim: int, eps: float):
        super().__init__()
        self.heads, self.head_dim, self.eps = heads, head_dim, eps
        for name in ("to_q", "to_k", "to_v"):
            self.add_module(name, Dense(dim, heads * head_dim))
        self.to_out = Dense(heads * head_dim, dim)
        norm(self, "norm_q", head_dim)
        norm(self, "norm_k", head_dim)

    def forward(self, x, n_text: int, cos, sin):
        b, l, _ = x.shape

        def qk(z, name):
            z = ops.layer_norm(z.reshape(b, l, self.heads, self.head_dim),
                               *norm_of(self, name), eps=self.eps)
            z = torch.cat([z[:, :n_text], rotate(z[:, n_text:], cos, sin)], dim=1)
            return z.reshape(b, l, -1)

        q, k = qk(self.to_q(x), "norm_q"), qk(self.to_k(x), "norm_k")
        return self.to_out(ops.multihead(q, k, self.to_v(x), self.heads))


class FeedForward(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = Dense(dim, inner)
        self.out = Dense(inner, dim)

    def forward(self, x):
        return self.out(F.gelu(self.proj(x), approximate="tanh"))


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, head_dim: int, cond: int, eps: float):
        super().__init__()
        self.norm1 = LayerNormZero(cond, dim, eps)
        self.attn1 = JointAttention(dim, heads, head_dim, 1e-6)
        self.norm2 = LayerNormZero(cond, dim, eps)
        self.ff = FeedForward(dim, 4 * dim)

    def forward(self, h, act, n_text: int, cos, sin):
        for norm_, branch in ((self.norm1, lambda m: self.attn1(m, n_text, cos, sin)),
                              (self.norm2, self.ff)):
            m, gate, e_gate = norm_(h, act, n_text)
            y = branch(m)
            h = torch.cat([h[:, :n_text] + e_gate * y[:, :n_text],
                           h[:, n_text:] + gate * y[:, n_text:]], dim=1)
        return h


class AdaLayerNormOut(nn.Module):
    def __init__(self, cond: int, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.linear = Dense(cond, 2 * dim)
        norm(self, "norm", dim)

    def forward(self, x, act):
        shift, scale = self.linear(act)[:, None].chunk(2, dim=-1)
        return ops.layer_norm(x, *norm_of(self, "norm"), eps=self.eps) * (1 + scale) + shift


class CogVideoXTransformer3D(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        heads, hd = cfg["num_attention_heads"], cfg["attention_head_dim"]
        dim, p, eps = heads * hd, cfg["patch_size"], cfg["norm_eps"]
        cond = cfg["time_embed_dim"]
        self.patch_embed = Conv(cfg["in_channels"], dim, p, stride=p, padding=0)
        self.text_proj = Dense(cfg["text_embed_dim"], dim)
        self.time_linear_1 = Dense(dim, cond)
        self.time_linear_2 = Dense(cond, cond)
        self.transformer_blocks = nn.ModuleList(
            Block(dim, heads, hd, cond, eps) for _ in range(cfg["num_layers"]))
        norm(self, "norm_final", dim)
        self.norm_out = AdaLayerNormOut(cond, dim, eps)
        self.proj_out = Dense(dim, p * p * cfg["out_channels"])

    def forward(self, latents, text, t):
        """latents (B, F, C, H, W), text (B, T, D_text), t (B,) -> the
        v-prediction (B, F, C_out, H, W), f32."""
        cfg = self.cfg
        b, f, _, hh, ww = latents.shape
        p, n_text = cfg["patch_size"], text.shape[1]
        dim = cfg["num_attention_heads"] * cfg["attention_head_dim"]
        act = F.silu(self.time_linear_2(F.silu(self.time_linear_1(
            ops.timestep_embedding(t, dim)))))
        video = self.patch_embed(latents.float().permute(0, 1, 3, 4, 2))
        h = torch.cat([self.text_proj(text.float()), video.reshape(b, -1, dim)], dim=1)
        cos, sin = rope_tables(f, hh // p, ww // p, cfg["attention_head_dim"], 10000.0,
                               latents.device)
        for block in self.transformer_blocks:
            h = block(h, act, n_text, cos, sin)
        h = ops.layer_norm(h, *norm_of(self, "norm_final"), eps=cfg["norm_eps"])[:, n_text:]
        out = self.proj_out(self.norm_out(h, act)).reshape(b, f, hh // p, ww // p, -1, p, p)
        return out.permute(0, 1, 4, 2, 5, 3, 6).reshape(b, f, -1, hh, ww)


class Scheduler:
    def __init__(self, cfg: dict):
        n = cfg["num_train_timesteps"]
        betas = np.linspace(cfg["beta_start"] ** 0.5, cfg["beta_end"] ** 0.5, n,
                            dtype=np.float64) ** 2
        ab = np.cumprod(1.0 - betas)
        s = cfg["snr_shift_scale"]
        ab = ab / (s + (1 - s) * ab)
        r = np.sqrt(ab)
        r = (r - r[-1]) * r[0] / (r[0] - r[-1])
        self.ab = r ** 2
        self.total = n

    def timesteps(self, n: int) -> list:
        return [int(t) - 1 for t in np.round(np.arange(self.total, 0, -self.total / n))]

    def coefficients(self, t: int, n: int) -> tuple:
        """(a, b, ab_t) of x_prev = a x + b x0 from timestep t of n steps."""
        prev = t - self.total // n
        ab_t = float(self.ab[t])
        ab_prev = float(self.ab[prev]) if prev >= 0 else 1.0
        a = ((1 - ab_prev) / (1 - ab_t)) ** 0.5
        return a, ab_prev ** 0.5 - ab_t ** 0.5 * a, ab_t

    def step(self, v: torch.Tensor, t: int, x: torch.Tensor, n: int) -> torch.Tensor:
        a, b, ab_t = self.coefficients(t, n)
        x0 = ab_t ** 0.5 * x - (1 - ab_t) ** 0.5 * v
        return a * x + b * x0


def guided_step(model: CogVideoXTransformer3D, sched: Scheduler, x: torch.Tensor, t: int,
                n: int, prompt: torch.Tensor, negative: torch.Tensor,
                guidance: float) -> torch.Tensor:
    """One step of the pipeline from latents x (B, F, C, H, W)."""
    b = x.shape[0]
    tt = torch.full((2 * b,), float(t), device=x.device)
    v_u, v_c = model(torch.cat([x, x]), torch.cat([negative, prompt]), tt).float().chunk(2)
    return sched.step(v_u + guidance * (v_c - v_u), t, x.float(), n)
