"""Plain reference of Wan2.1-I2V-14B-480P image-to-video (Wan-AI/
Wan2.1-I2V-14B-480P ``config.json``; github.com/Wan-Video/Wan2.1
``wan/modules/model.py`` ``WanModel``, ``wan/utils/fm_solvers_unipc.py``
``FlowUniPCMultistepScheduler``, ``wan/image2video.py``), float32 through
``benchmark.reference.ops``.

- Embedding: per latent frame a 2 x 2 stride-2 convolution of [latents; y]
  (36 channels) into tokens in (f, h, w) order; the umT5 rows zero-padded
  to ``text_len`` through Linear -> tanh-GELU -> Linear; the CLIP tokens
  through LayerNorm -> Linear -> GELU -> Linear -> LayerNorm (affine, eps
  1e-5).  e = Linear(SiLU(Linear([cos, sin] sinusoid of t))) over
  ``freq_dim``; e0 = Linear(SiLU(e)) split into six.
- Block, e_i the chunks of the block's (1, 6, dim) table + e0:
  x += e2 SelfAttn(LN(x) (1 + e1) + e0), LN without affine at eps 1e-6;
  SelfAttn: q and k RMS-normalised over all ``dim`` channels times their
  weights, 3-D RoPE (44 / 42 / 42 channels for t / h / w at head dim 128,
  theta 1e4, interleaved pairs), softmax at 1 / sqrt(128), ``o``;
  x += CrossAttn(LN3(x)) (affine LN): one RMS-normalised q against the text
  keys and the image keys apart, the outputs added before ``o``;
  x += e5 FFN(LN(x) (1 + e4) + e3), FFN Linear -> tanh-GELU -> Linear.
- Head: Linear(LN(x) (1 + e'1) + e'0), e' the head's (1, 2, dim) table +
  e; unpatchified in Wan's ``fhwpqrc -> cfphqwr`` order.
- Scheduler: UniPC on the flow path, as ``image2video.py`` sets it up (see
  ``Scheduler``); the pipeline's guidance v_u + g (v_c - v_u).

Departures from Wan: RoPE's tables are f32 here (Wan applies them as
complex128); the patch embedding is a per-frame 2-D convolution (Wan's
(1, 2, 2) Conv3d, the same product); the modulation tables are named
``modulation_bias``; the weights may be held in bf16 and each product
up-casts its operands to f32 as it runs (``ops.operand``), so the model
needs no f32 copy of its 16.4 B parameters.

The parameter names are those under which ``benchmark/weights.py`` makes
the weights and the program loads them.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference import ops
from benchmark.reference.layers import Conv, Dense, norm, norm_of, param


def rope_tables(f: int, h: int, w: int, dims: tuple, theta: float, device) -> tuple:
    """cos and sin (f h w, sum(dims)) in f32: channel pair i of a group of
    width d at position p turns by p theta^(-2i / d)."""
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


def plain_ln(x: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm without affine, f32."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    return (xf - mean) * torch.rsqrt(var + eps)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm over all of a token's channels, times its weight."""
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * scale.float()


class SelfAttention(nn.Module):
    def __init__(self, dim: int, heads: int, eps: float):
        super().__init__()
        self.heads, self.eps = heads, eps
        for name in ("q", "k", "v", "o"):
            self.add_module(name, Dense(dim, dim))
        self.norm_q_scale = param(dim)
        self.norm_k_scale = param(dim)

    def heads_out(self, m, cos, sin):
        """The heads' output before ``o`` (B, L, dim), and v."""
        b, l, c = m.shape

        def qk(z, scale):
            z = rms_norm(z, scale, self.eps).reshape(b, l, self.heads, c // self.heads)
            return rotate(z, cos, sin).reshape(b, l, c)

        q, k, v = qk(self.q(m), self.norm_q_scale), qk(self.k(m), self.norm_k_scale), self.v(m)
        return ops.multihead(q, k, v, self.heads), v

    def forward(self, m, cos, sin):
        return self.o(self.heads_out(m, cos, sin)[0])


class CrossAttention(nn.Module):
    def __init__(self, dim: int, heads: int, eps: float):
        super().__init__()
        self.heads, self.eps = heads, eps
        for name in ("q", "k", "v", "o", "k_img", "v_img"):
            self.add_module(name, Dense(dim, dim))
        for name in ("norm_q_scale", "norm_k_scale", "norm_k_img_scale"):
            setattr(self, name, param(dim))

    def forward(self, m, txt, img):
        q = rms_norm(self.q(m), self.norm_q_scale, self.eps)
        k = rms_norm(self.k(txt), self.norm_k_scale, self.eps)
        k_img = rms_norm(self.k_img(img), self.norm_k_img_scale, self.eps)
        o = ops.multihead(q, k, self.v(txt), self.heads)
        return self.o(o + ops.multihead(q, k_img, self.v_img(img), self.heads))


class FeedForward(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = Dense(dim, inner)
        self.out = Dense(inner, dim)

    def forward(self, x):
        return self.out(F.gelu(self.proj(x), approximate="tanh"))


class Block(nn.Module):
    def __init__(self, dim: int, ffn: int, heads: int, eps: float):
        super().__init__()
        self.eps = eps
        self.self_attn = SelfAttention(dim, heads, eps)
        norm(self, "norm3", dim)
        self.cross_attn = CrossAttention(dim, heads, eps)
        self.ffn = FeedForward(dim, ffn)
        self.modulation_bias = param(1, 6, dim)

    def chunks(self, e0):
        return (self.modulation_bias.float() + e0).chunk(6, dim=1)

    def attn_input(self, h, e: tuple):
        """The self-attention's input: the modulated LayerNorm of h."""
        return plain_ln(h, self.eps) * (1 + e[1]) + e[0]

    def forward(self, h, e0, txt, img, cos, sin):
        e = self.chunks(e0)
        h = h + self.self_attn(self.attn_input(h, e), cos, sin) * e[2]
        h = h + self.cross_attn(ops.layer_norm(h, *norm_of(self, "norm3"), eps=self.eps),
                                txt, img)
        return h + self.ffn(plain_ln(h, self.eps) * (1 + e[4]) + e[3]) * e[5]


class ImageProjector(nn.Module):
    def __init__(self, clip_dim: int, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        norm(self, "norm1", clip_dim)
        self.proj_1 = Dense(clip_dim, clip_dim)
        self.proj_2 = Dense(clip_dim, dim)
        norm(self, "norm2", dim)

    def forward(self, clip):
        z = ops.layer_norm(clip, *norm_of(self, "norm1"), eps=self.eps)
        z = self.proj_2(ops.gelu(self.proj_1(z)))
        return ops.layer_norm(z, *norm_of(self, "norm2"), eps=self.eps)


class Head(nn.Module):
    def __init__(self, dim: int, out: int, eps: float):
        super().__init__()
        self.eps = eps
        self.head = Dense(dim, out)
        self.modulation_bias = param(1, 2, dim)

    def forward(self, h, e):
        shift, scale = (self.modulation_bias.float() + e[:, None]).chunk(2, dim=1)
        return self.head(plain_ln(h, self.eps) * (1 + scale) + shift)


class WanTransformer3D(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        dim, eps, p = cfg["dim"], cfg["eps"], cfg["patch_size"]
        if p[0] != 1 or p[1] != p[2]:
            raise ValueError(f"patch {p}: (1, p, p) only")
        self.patch_embedding = Conv(cfg["in_dim"], dim, p[1], stride=p[1], padding=0)
        self.text_embedding_1 = Dense(cfg["text_dim"], dim)
        self.text_embedding_2 = Dense(dim, dim)
        self.time_embedding_1 = Dense(cfg["freq_dim"], dim)
        self.time_embedding_2 = Dense(dim, dim)
        self.time_projection = Dense(dim, 6 * dim)
        self.img_emb = ImageProjector(cfg["clip_dim"], dim, cfg["image_eps"])
        self.blocks = nn.ModuleList(Block(dim, cfg["ffn_dim"], cfg["num_heads"], eps)
                                    for _ in range(cfg["num_layers"]))
        self.head = Head(dim, p[0] * p[1] * p[2] * cfg["out_dim"], eps)

    def embed(self, x, t, y) -> tuple:
        """The video tokens h (B, L, dim), e, e0 and RoPE's cos and sin of
        latents x and y (B, C, F, H, W) at t (B,)."""
        cfg = self.cfg
        dim, p = cfg["dim"], cfg["patch_size"][1]
        b, _, f, hh, ww = x.shape
        u = self.patch_embedding(torch.cat([x.float(), y.float()], dim=1).permute(0, 2, 3, 4, 1))
        h = u.reshape(b, -1, dim)
        e = self.time_embedding_2(F.silu(self.time_embedding_1(
            ops.timestep_embedding(t, cfg["freq_dim"]))))
        e0 = self.time_projection(F.silu(e)).unflatten(1, (6, dim))
        d = dim // cfg["num_heads"]
        dims = (d - 4 * (d // 6), 2 * (d // 6), 2 * (d // 6))
        cos, sin = rope_tables(f, hh // p, ww // p, dims, 10000.0, x.device)
        return h, e, e0, cos, sin

    def first_attention(self, x, t, y) -> tuple:
        """The first block's self-attention of latents x and y at t (no text
        enters it): its heads' output before ``o`` (B, L, dim) and what the
        same attention gives with every key weighed alike, the mean of v
        over the keys (B, 1, dim)."""
        h, _, e0, cos, sin = self.embed(x, t, y)
        block = self.blocks[0]
        out, v = block.self_attn.heads_out(block.attn_input(h, block.chunks(e0)), cos, sin)
        return out, v.mean(dim=1, keepdim=True)

    def forward(self, x, t, text, clip, y):
        """latents x and y (B, C, F, H, W), t (B,), text (B, T, text_dim),
        clip (B, tokens, clip_dim) -> the flow prediction (B, out_dim, F, H,
        W), f32."""
        cfg = self.cfg
        p = cfg["patch_size"][1]
        b, _, f, hh, ww = x.shape
        h, e, e0, cos, sin = self.embed(x, t, y)
        text = F.pad(text.float(), (0, 0, 0, cfg["text_len"] - text.shape[1]))
        txt = self.text_embedding_2(F.gelu(self.text_embedding_1(text), approximate="tanh"))
        img = self.img_emb(clip.float())
        for block in self.blocks:
            h = block(h, e0, txt, img, cos, sin)
        out = self.head(h, e).reshape(b, f, hh // p, ww // p, p, p, -1)
        return out.permute(0, 6, 1, 2, 4, 3, 5).reshape(b, -1, f, hh, ww)


class Scheduler:
    """``FlowUniPCMultistepScheduler(num_train_timesteps, shift=1)`` then
    ``set_timesteps(n, shift=shift)`` (``image2video.py``): sigmas
    linspace(1 - 1/N as f32, 0, n + 1)[:-1] shifted by s sigma / (1 + (s -
    1) sigma), a final 0, timesteps int64(1000 sigma); flow prediction
    through x0 = x - sigma v, alpha = 1 - sigma, lambda = log(alpha /
    sigma); order 2 with the lower order on the first and last steps,
    ``bh2`` (B(h) = expm1(-h)), the corrector (UniC) on from the second
    step.  A step is a pure function of the recorded state: the last
    sample and the last two data predictions."""

    def __init__(self, cfg: dict, n: int):
        total = cfg["num_train_timesteps"]
        if cfg["solver_order"] != 2 or cfg["prediction_type"] != "flow_prediction" \
                or cfg["solver_type"] != "bh2" or not cfg["predict_x0"] \
                or not cfg["lower_order_final"]:
            raise ValueError("the reference runs Wan's published UniPC settings")
        sigma_max = float(np.float32(1.0 - 1.0 / total))
        s = np.linspace(sigma_max, 0.0, n + 1)[:-1]
        s = cfg["shift"] * s / (1 + (cfg["shift"] - 1) * s)
        self.timesteps = [int(t) for t in (s * total).astype(np.int64)]
        self.sigmas = [float(x) for x in np.append(s, 0.0).astype(np.float32)]
        self.n = n

    def order(self, i: int) -> int:
        return min(2, self.n - i, min(i, 2) + 1)

    def lam(self, i: int) -> float:
        s = self.sigmas[i]
        return math.inf if s == 0.0 else math.log(1.0 - s) - math.log(s)

    def step(self, v, i: int, x, last_sample, outputs: list):
        """The sample at sigma_{i+1} from x at step i, the flow prediction v,
        the previous step's (corrected) sample and the data predictions of
        the last steps (oldest first)."""
        x = x.float()
        m = x - self.sigmas[i] * v.float()
        if i > 0:                             # UniC of step i - 1's update
            s0, st = self.sigmas[i - 1], self.sigmas[i]
            h = self.lam(i) - self.lam(i - 1)
            b_h = math.expm1(-h)
            m0 = outputs[-1]
            base = (st / s0) * last_sample - ((1 - st) * b_h) * m0
            if self.order(i - 1) == 1:
                x = base - ((1 - st) * b_h * 0.5) * (m - m0)
            else:
                rk = (self.lam(i - 2) - self.lam(i - 1)) / h
                phi = b_h / -h - 1.0
                b1, b2 = phi / b_h, (phi / -h - 0.5) * 2.0 / b_h
                rho0 = (b1 - b2) / (1.0 - rk)
                rho1 = b1 - rho0
                x = base - ((1 - st) * b_h) * (rho0 * (outputs[-2] - m0) / rk + rho1 * (m - m0))
        outputs = list(outputs[-1:]) + [m]
        st, s0 = self.sigmas[i + 1], self.sigmas[i]
        if st == 0.0:                         # the last step: the data prediction
            return m
        h = self.lam(i + 1) - self.lam(i)
        b_h = math.expm1(-h)
        out = (st / s0) * x - ((1 - st) * b_h) * m
        if self.order(i) == 2:
            rk = (self.lam(i - 1) - self.lam(i)) / h
            out = out - ((1 - st) * b_h * 0.5 / rk) * (outputs[-2] - m)
        return out


def guided_step(model: WanTransformer3D, sched: Scheduler, x, i: int, last_sample,
                outputs: list, prompt, negative, clip, y, guidance: float):
    """One step of the pipeline at step index i from latents x (B, C, F, H,
    W): both halves in one batch, the guidance, the UniPC step."""
    b = x.shape[0]
    n = model.cfg["text_len"]
    text = torch.cat([F.pad(negative, (0, 0, 0, n - negative.shape[1])),
                      F.pad(prompt, (0, 0, 0, n - prompt.shape[1]))])
    t = torch.full((2 * b,), float(sched.timesteps[i]), device=x.device)
    v_u, v_c = model(torch.cat([x, x]), t, text, torch.cat([clip, clip]),
                     torch.cat([y, y])).float().chunk(2)
    return sched.step(v_u + guidance * (v_c - v_u), i, x, last_sample, outputs)
