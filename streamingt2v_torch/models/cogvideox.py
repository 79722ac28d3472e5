"""CogVideoX's video transformer (THUDM/CogVideoX-5b, diffusers
``CogVideoXTransformer3DModel`` with rotary position embeddings): text and
video tokens in one sequence through expert-AdaLN-zero blocks of joint
attention.

- Embedding: each latent frame is patchified by a 2 x 2 stride-2
  convolution into video tokens in (f, h, w) order, the T5 prompt
  embeddings are projected to the width, and the sequence is [text; video].
  The time embedding is Linear -> SiLU -> Linear over the [cos, sin]
  sinusoid of the width.
- Block: one affine LayerNorm serves both kinds of token, and a linear of
  SiLU(temb) gives each its own shift, scale and gate (expert AdaLN):
  m(x) = LN(x) (1 + scale) + shift.  Attention over [m_text; m_video]:
  biased q, k, v projections, a per-head affine LayerNorm on q and k, 3-D
  RoPE on the video tokens' q and k, softmax at 1 / sqrt(64) on the
  flash path (``ops/attention.attention``), a biased output projection.
  Each kind adds its part back through its gate; the feed-forward
  (tanh-GELU, 4x) follows the same pattern with the block's second norm.
- Out: the final affine LayerNorm (per token, so over the video tokens
  alone), then AdaLN (its own affine LayerNorm, shift and scale from
  SiLU(temb)), a linear to the patch's 2 x 2 x 16 values, unpatchified.

The residual stream stays in f32 and is updated in place (inference
only): each block's output is added with its gate in f32, so the 84 adds
round nothing; each LayerNorm reads it directly, and its modulated output
is rounded once to the compute dtype for the products.  diffusers keeps
the stream in bf16, 2.7 times as far from an f32 model's step.  Parameter names
are those of the benchmark's reference (``benchmark/reference/
cogvideox.py``), so its state dicts load by name.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from streamingt2v_torch.config import CogVideoXConfig
from streamingt2v_torch.models.layers import Conv, Dense, norm_pair, norm_params
from streamingt2v_torch.ops.attention import attention
from streamingt2v_torch.ops.embedding import timestep_embedding
from streamingt2v_torch.ops.norms import layer_norm
from streamingt2v_torch.ops.rope import apply_rope, rope_3d
from streamingt2v_torch.utils.profiling import count, span

# diffusers' fixed choices: the q/k LayerNorm's eps, the FF's width factor
# and RoPE's theta
QK_NORM_EPS = 1e-6
FF_MULT = 4
ROPE_THETA = 10000.0


class LayerNormZero(nn.Module):
    """CogVideoX's expert AdaLN: one affine LayerNorm, then per kind of
    token its own shift and scale; the gates are returned for the
    residual adds."""

    def __init__(self, cond_dim: int, dim: int, eps: float, *, device=None, dtype=None):
        super().__init__()
        self.eps = eps
        self.linear = Dense(cond_dim, 6 * dim, device=device, dtype=dtype)
        norm_params(self, "norm", dim, device=device, dtype=dtype)

    def forward(self, h: torch.Tensor, temb_act: torch.Tensor, text_len: int) -> tuple:
        """(m, (gate, enc_gate)) of the f32 stream h (B, L, C) whose first
        ``text_len`` tokens are text; ``temb_act`` is SiLU(temb).  m is in
        temb's dtype, modulated in f32 and rounded once."""
        with span("st2v.modulate"):
            shift, scale, gate, enc_shift, enc_scale, enc_gate = \
                self.linear(temb_act)[:, None].chunk(6, dim=-1)
        m = layer_norm(h, *norm_pair(self, "norm"), eps=self.eps)
        with span("st2v.modulate"):
            m[:, :text_len].mul_(1 + enc_scale.float()).add_(enc_shift)
            m[:, text_len:].mul_(1 + scale.float()).add_(shift)
            return m.to(temb_act.dtype), (gate, enc_gate)


@span("st2v.modulate")
def gated_add_(h: torch.Tensor, y: torch.Tensor, gates: tuple, text_len: int) -> torch.Tensor:
    """h += gate y, the video tokens by ``gates[0]`` and the text tokens by
    ``gates[1]``, in place."""
    gate, enc_gate = gates
    h[:, :text_len].addcmul_(y[:, :text_len], enc_gate)
    h[:, text_len:].addcmul_(y[:, text_len:], gate)
    return h


class JointAttention(nn.Module):
    """Self-attention over [text; video] with per-head q/k LayerNorm and
    RoPE on the video tokens."""

    def __init__(self, dim: int, heads: int, dim_head: int, eps: float, *, device=None,
                 dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self.heads, self.dim_head, self.eps = heads, dim_head, eps
        self.to_q = Dense(dim, heads * dim_head, **fk)
        self.to_k = Dense(dim, heads * dim_head, **fk)
        self.to_v = Dense(dim, heads * dim_head, **fk)
        self.to_out = Dense(heads * dim_head, dim, **fk)
        norm_params(self, "norm_q", dim_head, **fk)
        norm_params(self, "norm_k", dim_head, **fk)

    def _heads(self, z: torch.Tensor, name: str, text_len: int, cos, sin) -> torch.Tensor:
        b, l, _ = z.shape
        z = layer_norm(z.view(b, l, self.heads, self.dim_head), *norm_pair(self, name),
                       eps=self.eps)
        z[:, text_len:] = apply_rope(z[:, text_len:], cos, sin)
        return z.view(b, l, -1)

    @span("st2v.attention")
    def forward(self, x: torch.Tensor, text_len: int, cos: torch.Tensor,
                sin: torch.Tensor) -> torch.Tensor:
        q = self._heads(self.to_q(x), "norm_q", text_len, cos, sin)
        k = self._heads(self.to_k(x), "norm_k", text_len, cos, sin)
        return self.to_out(attention(q, k, self.to_v(x), num_heads=self.heads))


class GeluFeedForward(nn.Module):
    """Linear -> tanh-GELU -> Linear."""

    def __init__(self, dim: int, inner: int, *, device=None, dtype=None):
        super().__init__()
        self.proj = Dense(dim, inner, device=device, dtype=dtype)
        self.out = Dense(inner, dim, device=device, dtype=dtype)

    @span("st2v.ff")
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.out(F.gelu(self.proj(x), approximate="tanh"))


class CogVideoXBlock(nn.Module):
    def __init__(self, cfg: CogVideoXConfig, *, device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        dim = cfg.inner_dim
        self.norm1 = LayerNormZero(cfg.time_embed_dim, dim, cfg.norm_eps, **fk)
        self.attn1 = JointAttention(dim, cfg.num_attention_heads, cfg.attention_head_dim,
                                    QK_NORM_EPS, **fk)
        self.norm2 = LayerNormZero(cfg.time_embed_dim, dim, cfg.norm_eps, **fk)
        self.ff = GeluFeedForward(dim, FF_MULT * dim, **fk)

    @span("st2v.transformer")
    def forward(self, h: torch.Tensor, temb_act: torch.Tensor, text_len: int, cos: torch.Tensor,
                sin: torch.Tensor) -> torch.Tensor:
        m, gates = self.norm1(h, temb_act, text_len)
        gated_add_(h, self.attn1(m, text_len, cos, sin), gates, text_len)
        m, gates = self.norm2(h, temb_act, text_len)
        return gated_add_(h, self.ff(m), gates, text_len)


class AdaLayerNormOut(nn.Module):
    """The output AdaLN: an affine LayerNorm, then (1 + scale) and shift
    from SiLU(temb), in the order (shift, scale)."""

    def __init__(self, cond_dim: int, dim: int, eps: float, *, device=None, dtype=None):
        super().__init__()
        self.eps = eps
        self.linear = Dense(cond_dim, 2 * dim, device=device, dtype=dtype)
        norm_params(self, "norm", dim, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor, temb_act: torch.Tensor) -> torch.Tensor:
        with span("st2v.embed"):
            shift, scale = self.linear(temb_act)[:, None].chunk(2, dim=-1)
        m = layer_norm(x, *norm_pair(self, "norm"), eps=self.eps)
        with span("st2v.modulate"):
            return m.mul_(1 + scale.float()).add_(shift).to(temb_act.dtype)


class CogVideoXTransformer3D(nn.Module):
    def __init__(self, cfg: CogVideoXConfig, *, device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self.cfg = cfg
        dim, p = cfg.inner_dim, cfg.patch_size
        self.patch_embed = Conv(cfg.in_channels, dim, p, stride=p, padding="VALID", **fk)
        self.text_proj = Dense(cfg.text_embed_dim, dim, **fk)
        self.time_linear_1 = Dense(dim, cfg.time_embed_dim, **fk)
        self.time_linear_2 = Dense(cfg.time_embed_dim, cfg.time_embed_dim, **fk)
        self.transformer_blocks = nn.ModuleList(
            CogVideoXBlock(cfg, **fk) for _ in range(cfg.num_layers))
        norm_params(self, "norm_final", dim, **fk)
        self.norm_out = AdaLayerNormOut(cfg.time_embed_dim, dim, cfg.norm_eps, **fk)
        self.proj_out = Dense(dim, p * p * cfg.out_channels, **fk)
        self._rope = {}     # (frames, rows, columns, device) -> RoPE's (cos, sin)

    def rope(self, f: int, h: int, w: int, device) -> tuple:
        """RoPE's tables for an f x h x w token grid, built once per grid and
        device: the head's channels split t / h / w as d / 4, 3 d / 8,
        3 d / 8."""
        key = (f, h, w, torch.device(device))
        if key not in self._rope:
            d = self.cfg.attention_head_dim
            self._rope[key] = rope_3d(f, h, w, (d // 4, d // 8 * 3, d // 8 * 3), ROPE_THETA,
                                      device=device)
        return self._rope[key]

    @span("st2v.embed")
    def _embed(self, latents: torch.Tensor, text: torch.Tensor, timestep: torch.Tensor) -> tuple:
        """The f32 stream [text; video] (B, L, C) and temb (B, time_embed_dim)."""
        dt = self.cfg.dtypes.compute_dtype
        b = latents.shape[0]
        temb = self.time_linear_2(F.silu(self.time_linear_1(
            timestep_embedding(timestep, self.cfg.inner_dim).to(dt))))
        video = self.patch_embed(latents.to(dt).permute(0, 1, 3, 4, 2))
        return torch.cat([self.text_proj(text.to(dt)), video.reshape(b, -1, video.shape[-1])],
                         dim=1).float(), temb

    @span("st2v.dit")
    def forward(self, latents: torch.Tensor, text: torch.Tensor,
                timestep: torch.Tensor) -> torch.Tensor:
        """latents (B, F, C, H, W), text (B, T, text_embed_dim), timestep
        (B,) -> f32 (B, F, C_out, H, W): the v-prediction."""
        count("dit_calls")
        cfg = self.cfg
        b, f, _, hh, ww = latents.shape
        p = cfg.patch_size
        h, temb = self._embed(latents, text, timestep)
        temb_act = F.silu(temb)
        text_len = text.shape[1]
        cos, sin = self.rope(f, hh // p, ww // p, h.device)
        for block in self.transformer_blocks:
            h = block(h, temb_act, text_len, cos, sin)
        # LayerNorm is per token: over [text; video], keeping the video rows
        x = layer_norm(h[:, text_len:], *norm_pair(self, "norm_final"), eps=cfg.norm_eps)
        x = self.proj_out(self.norm_out(x, temb_act))
        x = x.reshape(b, f, hh // p, ww // p, -1, p, p).permute(0, 1, 4, 2, 5, 3, 6)
        return x.reshape(b, f, -1, hh, ww).float()
