"""Plain float32 reference of Wan2.1 image-to-video, written from the
published code (github.com/Wan-Video/Wan2.1: ``wan/modules/model.py``
``WanModel``, ``wan/utils/fm_solvers_unipc.py``
``FlowUniPCMultistepScheduler``, ``wan/image2video.py``) and independent of
the port: it imports nothing of ``streamingt2v_torch``, of JAX or of the
benchmark.  The weights are a state dict under the port's parameter names.
TF32 is off while it runs.

``forward(w, cfg, x, t, text, clip, y)`` is the transformer; ``rope_params``
and ``rope_apply`` Wan's rotary embedding in its complex form;
``first_frame_mask`` ``image2video.py``'s mask; ``Scheduler`` the UniPC
scheduler with Wan's own state (its model outputs, last sample, order and
warm-up count); ``guided_step`` one step of the pipeline.

Departures from Wan: the RoPE angles are f64 and applied in f64 as Wan does,
but the model is f32 throughout (Wan's linears run under bf16 autocast);
the patch embedding is a 2-D convolution per frame (Wan's (1, 2, 2)
Conv3d); the modulation tables are named ``modulation_bias``.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F


@contextlib.contextmanager
def no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def config(layers: int, heads: int, head_dim: int = 128, ffn: int = 13824, freq: int = 256,
           text_dim: int = 4096, text_len: int = 512, clip_dim: int = 1280) -> dict:
    return dict(layers=layers, heads=heads, dim=heads * head_dim, ffn=ffn, freq=freq,
                text_dim=text_dim, text_len=text_len, clip_dim=clip_dim, out=16, patch=2,
                eps=1e-6, theta=10000.0)


def linear(w: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    return x @ w[name + ".kernel"].float().T + w[name + ".bias"].float()


def layer_norm(x: torch.Tensor, eps: float, w: dict = None, name: str = None) -> torch.Tensor:
    weight = None if w is None else w[name + "_scale"].float()
    bias = None if w is None else w[name + "_bias"].float()
    return F.layer_norm(x.float(), x.shape[-1:], weight, bias, eps)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """``WanRMSNorm``: over all of a token's channels."""
    return x * torch.rsqrt(x.pow(2).mean(dim=-1, keepdim=True) + eps) * weight.float()


def sinusoidal_embedding_1d(dim: int, position: torch.Tensor) -> torch.Tensor:
    half = dim // 2
    position = position.type(torch.float64)
    sinusoid = torch.outer(position, torch.pow(10000, -torch.arange(half).to(position).div(half)))
    return torch.cat([torch.cos(sinusoid), torch.sin(sinusoid)], dim=1)


def rope_params(max_seq_len: int, dim: int, theta: float = 10000) -> torch.Tensor:
    freqs = torch.outer(torch.arange(max_seq_len),
                        1.0 / torch.pow(theta, torch.arange(0, dim, 2).to(torch.float64).div(dim)))
    return torch.polar(torch.ones_like(freqs), freqs)


def model_freqs(head_dim: int, theta: float) -> torch.Tensor:
    d = head_dim
    return torch.cat([rope_params(1024, d - 4 * (d // 6), theta),
                      rope_params(1024, 2 * (d // 6), theta),
                      rope_params(1024, 2 * (d // 6), theta)], dim=1)


def rope_apply(x: torch.Tensor, grid: tuple, freqs: torch.Tensor) -> torch.Tensor:
    """x (B, L, N, D), the tokens of an f x h x w grid in (f, h, w) order."""
    n, c = x.size(2), x.size(3) // 2
    freqs = freqs.split([c - 2 * (c // 3), c // 3, c // 3], dim=1)
    f, h, w = grid
    seq_len = f * h * w
    out = []
    for i in range(x.shape[0]):
        x_i = torch.view_as_complex(x[i, :seq_len].to(torch.float64).reshape(seq_len, n, -1, 2))
        freqs_i = torch.cat([freqs[0][:f].view(f, 1, 1, -1).expand(f, h, w, -1),
                             freqs[1][:h].view(1, h, 1, -1).expand(f, h, w, -1),
                             freqs[2][:w].view(1, 1, w, -1).expand(f, h, w, -1)],
                            dim=-1).reshape(seq_len, 1, -1)
        out.append(torch.view_as_real(x_i * freqs_i).flatten(2))
    return torch.stack(out).float()


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int) -> torch.Tensor:
    b, lq, c = q.shape
    d = c // heads
    qh, kh, vh = (z.reshape(b, -1, heads, d).transpose(1, 2) for z in (q, k, v))
    p = torch.softmax(qh @ kh.transpose(-1, -2) / math.sqrt(d), dim=-1)
    return (p @ vh).transpose(1, 2).reshape(b, lq, c)


def first_frame_mask(frames: int, lat_h: int, lat_w: int) -> torch.Tensor:
    """``image2video.py``'s msk, (4, latent frames, lat_h, lat_w)."""
    msk = torch.ones(1, frames, lat_h, lat_w)
    msk[:, 1:] = 0
    msk = torch.concat([torch.repeat_interleave(msk[:, 0:1], repeats=4, dim=1), msk[:, 1:]],
                       dim=1)
    msk = msk.view(1, msk.shape[1] // 4, 4, lat_h, lat_w)
    return msk.transpose(1, 2)[0]


@no_tf32()
def forward(w: dict, cfg: dict, x: torch.Tensor, t: torch.Tensor, text: torch.Tensor,
            clip: torch.Tensor, y: torch.Tensor, *, image: bool = True,
            rope: bool = True) -> torch.Tensor:
    """The flow prediction (B, C, F, H, W) in f32 of latents x and y
    (B, C, F, H, W), timesteps t (B,), text (B, T, text_dim) and CLIP
    tokens (B, 257, clip_dim); ``image`` False leaves the image keys out,
    ``rope`` False the rotary embedding."""
    heads, dim, eps, p = cfg["heads"], cfg["dim"], cfg["eps"], cfg["patch"]
    b, _, f, hh, ww = x.shape
    hp, wp = hh // p, ww // p
    u = torch.cat([x, y], dim=1).float()
    patches = u.reshape(b, -1, f, hp, p, wp, p).permute(0, 2, 3, 5, 1, 4, 6)
    kernel = w["patch_embedding.kernel"].float().reshape(dim, -1)
    h = patches.reshape(b, f * hp * wp, -1) @ kernel.T + w["patch_embedding.bias"].float()
    e = linear(w, "time_embedding_2", F.silu(linear(
        w, "time_embedding_1", sinusoidal_embedding_1d(cfg["freq"], t).float())))
    e0 = linear(w, "time_projection", F.silu(e)).unflatten(1, (6, dim))
    text = torch.cat([text.float(), text.new_zeros(b, cfg["text_len"] - text.shape[1],
                                                   text.shape[2]).float()], dim=1)
    context = linear(w, "text_embedding_2",
                     F.gelu(linear(w, "text_embedding_1", text), approximate="tanh"))
    z = layer_norm(clip.float(), 1e-5, w, "img_emb.norm1")
    z = linear(w, "img_emb.proj_2", F.gelu(linear(w, "img_emb.proj_1", z)))
    context_img = layer_norm(z, 1e-5, w, "img_emb.norm2")
    freqs = model_freqs(dim // heads, cfg["theta"])
    grid = (f, hp, wp)
    for i in range(cfg["layers"]):
        blk = f"blocks.{i}"
        em = (w[f"{blk}.modulation_bias"].float() + e0).chunk(6, dim=1)
        m = layer_norm(h, eps) * (1 + em[1]) + em[0]
        sa = f"{blk}.self_attn"
        q = rms_norm(linear(w, f"{sa}.q", m), w[f"{sa}.norm_q_scale"], eps)
        k = rms_norm(linear(w, f"{sa}.k", m), w[f"{sa}.norm_k_scale"], eps)
        if rope:
            q, k = (rope_apply(z.view(b, -1, heads, dim // heads), grid, freqs).flatten(2)
                    for z in (q, k))
        y_ = linear(w, f"{sa}.o", attention(q, k, linear(w, f"{sa}.v", m), heads))
        h = h + y_ * em[2]
        ca = f"{blk}.cross_attn"
        m = layer_norm(h, eps, w, f"{blk}.norm3")
        q = rms_norm(linear(w, f"{ca}.q", m), w[f"{ca}.norm_q_scale"], eps)
        k = rms_norm(linear(w, f"{ca}.k", context), w[f"{ca}.norm_k_scale"], eps)
        o = attention(q, k, linear(w, f"{ca}.v", context), heads)
        if image:
            k_img = rms_norm(linear(w, f"{ca}.k_img", context_img),
                             w[f"{ca}.norm_k_img_scale"], eps)
            o = o + attention(q, k_img, linear(w, f"{ca}.v_img", context_img), heads)
        h = h + linear(w, f"{ca}.o", o)
        m = layer_norm(h, eps) * (1 + em[4]) + em[3]
        ff = linear(w, f"{blk}.ffn.out", F.gelu(linear(w, f"{blk}.ffn.proj", m),
                                                 approximate="tanh"))
        h = h + ff * em[5]
    eh = (w["head.modulation_bias"].float() + e.unsqueeze(1)).chunk(2, dim=1)
    out = linear(w, "head.head", layer_norm(h, eps) * (1 + eh[1]) + eh[0])
    c = cfg["out"]
    out = out.view(b, f, hp, wp, 1, p, p, c)
    out = torch.einsum("bfhwpqrc->bcfphqwr", out)
    return out.reshape(b, c, f, hh, ww)


class Scheduler:
    """``FlowUniPCMultistepScheduler(num_train_timesteps=1000, shift=1,
    use_dynamic_shifting=False)`` then ``set_timesteps(n, shift=shift)``,
    as ``image2video.py`` makes it: order 2, ``flow_prediction``,
    ``predict_x0``, ``bh2``, ``lower_order_final``, no corrector disabled."""

    def __init__(self, n: int, shift: float = 3.0, total: int = 1000, order: int = 2):
        alphas = np.linspace(1, 1 / total, total)[::-1].copy()
        sigmas = torch.from_numpy(1.0 - alphas).to(dtype=torch.float32)
        sigma_max, sigma_min = sigmas[0].item(), sigmas[-1].item()
        s = np.linspace(sigma_max, sigma_min, n + 1).copy()[:-1]
        s = shift * s / (1 + (shift - 1) * s)
        self.timesteps = torch.from_numpy(s * total).to(dtype=torch.int64)
        self.sigmas = torch.from_numpy(np.concatenate([s, [0]]).astype(np.float32))
        self.order = order
        self.model_outputs = [None] * order
        self.lower_order_nums = 0
        self.last_sample = None
        self.this_order = None
        self.step_index = 0

    @staticmethod
    def _alpha_sigma(sigma):
        return 1 - sigma, sigma

    def _lambda(self, i):
        alpha, sigma = self._alpha_sigma(self.sigmas[i])
        return torch.log(alpha) - torch.log(sigma)

    def _coefficients(self, h, rks):
        hh = -h
        h_phi_1 = torch.expm1(hh)
        h_phi_k = h_phi_1 / hh - 1
        factorial_i = 1
        b_h = torch.expm1(hh)
        r, b = [], []
        for i in range(1, len(rks) + 1):
            r.append(torch.pow(rks, i - 1))
            b.append(h_phi_k * factorial_i / b_h)
            factorial_i *= i + 1
            h_phi_k = h_phi_k / hh - 1 / factorial_i
        return h_phi_1, b_h, torch.stack(r), torch.tensor(b)

    def _predictor(self, x, order):
        m0 = self.model_outputs[-1]
        i = self.step_index
        alpha_t, sigma_t = self._alpha_sigma(self.sigmas[i + 1])
        sigma_s0 = self.sigmas[i]
        h = self._lambda(i + 1) - self._lambda(i)     # inf at the final sigma 0
        rks, d1s = [], []
        for k in range(1, order):
            rk = (self._lambda(i - k) - self._lambda(i)) / h
            rks.append(rk)
            d1s.append((self.model_outputs[-(k + 1)] - m0) / rk)
        rks.append(1.0)
        h_phi_1, b_h, _, _ = self._coefficients(h, torch.tensor(rks))
        x_t = sigma_t / sigma_s0 * x - alpha_t * h_phi_1 * m0
        if d1s:
            x_t = x_t - alpha_t * b_h * 0.5 * d1s[0]      # order 2: rhos_p = [0.5]
        return x_t.to(x.dtype)

    def _corrector(self, model_t, x, x_t, order):
        m0 = self.model_outputs[-1]
        i = self.step_index
        alpha_t, sigma_t = self._alpha_sigma(self.sigmas[i])
        sigma_s0 = self.sigmas[i - 1]
        h = self._lambda(i) - self._lambda(i - 1)
        rks, d1s = [], []
        for k in range(1, order):
            rk = (self._lambda(i - (k + 1)) - self._lambda(i - 1)) / h
            rks.append(rk)
            d1s.append((self.model_outputs[-(k + 1)] - m0) / rk)
        rks.append(1.0)
        h_phi_1, b_h, r, b = self._coefficients(h, torch.tensor(rks))
        rhos_c = torch.tensor([0.5]) if order == 1 else torch.linalg.solve(r, b)
        x_t_ = sigma_t / sigma_s0 * x - alpha_t * h_phi_1 * m0
        corr = sum(rho * d for rho, d in zip(rhos_c[:-1], d1s)) if d1s else 0
        return (x_t_ - alpha_t * b_h * (corr + rhos_c[-1] * (model_t - m0))).to(x.dtype)

    def step(self, v: torch.Tensor, sample: torch.Tensor) -> torch.Tensor:
        i = self.step_index
        converted = sample - self.sigmas[i] * v
        if i > 0 and self.last_sample is not None:
            sample = self._corrector(converted, self.last_sample, sample, self.this_order)
        self.model_outputs = self.model_outputs[1:] + [converted]
        this_order = min(self.order, len(self.timesteps) - i)
        self.this_order = min(this_order, self.lower_order_nums + 1)
        self.last_sample = sample
        prev = self._predictor(sample, self.this_order)
        self.lower_order_nums = min(self.lower_order_nums + 1, self.order)
        self.step_index += 1
        return prev


def guided_step(w: dict, cfg: dict, sched: Scheduler, x: torch.Tensor, prompt: torch.Tensor,
                negative: torch.Tensor, clip: torch.Tensor, y: torch.Tensor,
                guidance: float) -> torch.Tensor:
    """One pipeline step at the scheduler's step index: the two halves as
    two calls (Wan's), guidance, the UniPC step."""
    t = sched.timesteps[sched.step_index].reshape(1).expand(x.shape[0])
    v_c = forward(w, cfg, x, t, prompt, clip, y)
    v_u = forward(w, cfg, x, t, negative, clip, y)
    return sched.step(v_u + guidance * (v_c - v_u), x.float())
