"""Wan2.1's image-to-video transformer (Wan-AI/Wan2.1-I2V-14B-480P,
``wan/modules/model.py`` ``WanModel`` with ``model_type`` "i2v"): video
tokens through blocks of self-attention, a cross-attention decoupled into
text and image keys, and a feed-forward, each modulated from the time
embedding.

- Embedding: the noisy latents and the conditioning y = [first-frame mask;
  image latent] are concatenated on channels (16 + 4 + 16 = 36) and each
  latent frame is patchified by a 2 x 2 stride-2 convolution (Wan's
  (1, 2, 2) Conv3d) into tokens in (f, h, w) order.  The umT5 rows are
  zero-padded to ``text_len`` and projected (Linear -> tanh-GELU ->
  Linear); the CLIP image tokens pass the projector (LayerNorm -> Linear ->
  GELU -> Linear -> LayerNorm).  e = Linear -> SiLU -> Linear over the
  [cos, sin] sinusoid of t, and e0 = Linear(SiLU(e)), six widths' worth,
  both in f32 (Wan's float32 autocast region).
- Block, with e_i the six chunks of (the block's table + e0), in f32:
  x += e2 SelfAttn(LN(x) (1 + e1) + e0); x += CrossAttn(LN3(x));
  x += e5 FFN(LN(x) (1 + e4) + e3).  The self-attention's q and k are
  RMS-normalised across all heads' channels, then turned by 3-D RoPE
  (44 / 42 / 42 channels for t / h / w); the cross-attention's one q
  attends to the text keys and to the image keys apart, and the two
  outputs are added before the output projection.
- Head: Linear(LN(x) (1 + e'1) + e'0) in f32, e' the head's table + e, then
  unpatchified in Wan's ``fhwpqrc -> cfphqwr`` order.

The residual stream stays in f32 and is updated in place (inference only),
as Wan's float32 autocast regions keep it; each norm's modulated output is
rounded once to the compute dtype for the products.  Parameter names are
those of the benchmark's reference (``benchmark/reference/wan.py``), so its
state dicts load by name.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from streamingt2v_torch.config import WanConfig
from streamingt2v_torch.models.cogvideox import GeluFeedForward
from streamingt2v_torch.models.layers import Conv, Dense, _param, norm_pair, norm_params
from streamingt2v_torch.ops.attention import attention
from streamingt2v_torch.ops.embedding import timestep_embedding
from streamingt2v_torch.ops.norms import layer_norm, rms_norm
from streamingt2v_torch.ops.rope import apply_rope, rope_3d
from streamingt2v_torch.utils.profiling import count, span

ROPE_THETA = 10000.0


@span("st2v.modulate")
def modulate(m: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
             dtype: torch.dtype) -> torch.Tensor:
    """m (1 + scale) + shift in f32, in place on the f32 norm output m,
    rounded once to ``dtype``."""
    return m.mul_(1 + scale).add_(shift).to(dtype)


@span("st2v.modulate")
def gated_add_(h: torch.Tensor, y: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """h += gate y on the f32 stream, in place."""
    return h.addcmul_(y, gate)


class _Table(nn.Module):
    """A learned (1, n, dim) modulation table, Wan's randn / sqrt(dim) at
    initialisation."""

    def _table(self, n: int, dim: int, device, dtype) -> None:
        self.modulation_bias = _param((1, n, dim), device, dtype)

    @torch.no_grad()
    def init_extra_(self, generator: torch.Generator) -> None:
        t = self.modulation_bias
        t.copy_(torch.randn(t.shape, generator=generator, device=t.device) * t.shape[-1] ** -0.5)


class WanSelfAttention(nn.Module):
    """Self-attention over the video tokens: q and k RMS-normalised across
    heads, then rotated."""

    def __init__(self, dim: int, heads: int, eps: float, *, device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self.heads, self.eps = heads, eps
        for name in ("q", "k", "v", "o"):
            self.add_module(name, Dense(dim, dim, **fk))
        self.norm_q_scale = _param((dim,), device, dtype)
        self.norm_k_scale = _param((dim,), device, dtype)

    def _rotated(self, z: torch.Tensor, scale: torch.Tensor, cos, sin) -> torch.Tensor:
        b, l, c = z.shape
        z = rms_norm(z, scale, eps=self.eps)
        return apply_rope(z.view(b, l, self.heads, c // self.heads), cos, sin).view(b, l, c)

    @span("st2v.attention")
    def forward(self, m: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
        q = self._rotated(self.q(m), self.norm_q_scale, cos, sin)
        k = self._rotated(self.k(m), self.norm_k_scale, cos, sin)
        return self.o(attention(q, k, self.v(m), num_heads=self.heads))


class WanI2VCrossAttention(nn.Module):
    """One q from the video tokens, attending to the text keys and to the
    image keys apart; the two outputs are added before ``o``."""

    def __init__(self, dim: int, heads: int, eps: float, *, device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self.heads, self.eps = heads, eps
        for name in ("q", "k", "v", "o", "k_img", "v_img"):
            self.add_module(name, Dense(dim, dim, **fk))
        for name in ("norm_q_scale", "norm_k_scale", "norm_k_img_scale"):
            setattr(self, name, _param((dim,), device, dtype))

    @span("st2v.cross_attention")
    def forward(self, h: torch.Tensor, m: torch.Tensor, txt: torch.Tensor,
                img: torch.Tensor) -> torch.Tensor:
        """h += the cross-attention of the norm output m (f32) to the text
        rows ``txt`` and the image tokens ``img``, in place."""
        q = rms_norm(self.q(m.to(txt.dtype)), self.norm_q_scale, eps=self.eps)
        k = rms_norm(self.k(txt), self.norm_k_scale, eps=self.eps)
        k_img = rms_norm(self.k_img(img), self.norm_k_img_scale, eps=self.eps)
        o = attention(q, k, self.v(txt), num_heads=self.heads)
        o += attention(q, k_img, self.v_img(img), num_heads=self.heads)
        return h.add_(self.o(o))


class WanBlock(_Table):
    def __init__(self, cfg: WanConfig, *, device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self.eps = cfg.eps
        self.self_attn = WanSelfAttention(cfg.dim, cfg.num_heads, cfg.eps, **fk)
        norm_params(self, "norm3", cfg.dim, **fk)
        self.cross_attn = WanI2VCrossAttention(cfg.dim, cfg.num_heads, cfg.eps, **fk)
        self.ffn = GeluFeedForward(cfg.dim, cfg.ffn_dim, **fk)
        self._table(6, cfg.dim, device, dtype)

    @span("st2v.transformer")
    def forward(self, h: torch.Tensor, e0: torch.Tensor, txt: torch.Tensor, img: torch.Tensor,
                cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
        dt = txt.dtype
        with span("st2v.modulate"):
            e = (self.modulation_bias.float() + e0).chunk(6, dim=1)
        m = modulate(layer_norm(h, eps=self.eps), e[1], e[0], dt)
        gated_add_(h, self.self_attn(m, cos, sin), e[2])
        self.cross_attn(h, layer_norm(h, *norm_pair(self, "norm3"), eps=self.eps), txt, img)
        m = modulate(layer_norm(h, eps=self.eps), e[4], e[3], dt)
        return gated_add_(h, self.ffn(m), e[5])


class WanImageProjector(nn.Module):
    """Wan's ``MLPProj``: LayerNorm -> Linear -> GELU -> Linear -> LayerNorm
    over the CLIP tokens, both norms affine."""

    def __init__(self, cfg: WanConfig, *, device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self.eps = cfg.image_eps
        norm_params(self, "norm1", cfg.clip_dim, **fk)
        self.proj_1 = Dense(cfg.clip_dim, cfg.clip_dim, **fk)
        self.proj_2 = Dense(cfg.clip_dim, cfg.dim, **fk)
        norm_params(self, "norm2", cfg.dim, **fk)

    def forward(self, clip: torch.Tensor) -> torch.Tensor:
        z = layer_norm(clip, *norm_pair(self, "norm1"), eps=self.eps)
        z = self.proj_2(F.gelu(self.proj_1(z)))
        return layer_norm(z, *norm_pair(self, "norm2"), eps=self.eps)


class WanHead(_Table):
    def __init__(self, cfg: WanConfig, *, device=None, dtype=None):
        super().__init__()
        self.eps = cfg.eps
        p = cfg.patch_size
        self.head = Dense(cfg.dim, p[0] * p[1] * p[2] * cfg.out_dim, device=device, dtype=dtype)
        self._table(2, cfg.dim, device, dtype)

    def forward(self, h: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
        """The f32 patch values (B, L, prod(patch) out_dim) of the stream."""
        with span("st2v.embed"):
            shift, scale = (self.modulation_bias.float() + e[:, None]).chunk(2, dim=1)
        return self.head(modulate(layer_norm(h, eps=self.eps), scale, shift, torch.float32))


class WanTransformer3D(nn.Module):
    def __init__(self, cfg: WanConfig, *, device=None, dtype=None):
        super().__init__()
        if cfg.patch_size[0] != 1 or cfg.patch_size[1] != cfg.patch_size[2]:
            raise ValueError(f"patch {cfg.patch_size}: the port runs (1, p, p)")
        fk = dict(device=device, dtype=dtype)
        self.cfg = cfg
        dim, p = cfg.dim, cfg.patch_size[1]
        self.patch_embedding = Conv(cfg.in_dim, dim, p, stride=p, padding="VALID", **fk)
        self.text_embedding_1 = Dense(cfg.text_dim, dim, **fk)
        self.text_embedding_2 = Dense(dim, dim, **fk)
        self.time_embedding_1 = Dense(cfg.freq_dim, dim, **fk)
        self.time_embedding_2 = Dense(dim, dim, **fk)
        self.time_projection = Dense(dim, 6 * dim, **fk)
        self.img_emb = WanImageProjector(cfg, **fk)
        self.blocks = nn.ModuleList(WanBlock(cfg, **fk) for _ in range(cfg.num_layers))
        self.head = WanHead(cfg, **fk)
        self._rope = {}     # (frames, rows, columns, device) -> RoPE's (cos, sin)

    def rope(self, f: int, h: int, w: int, device) -> tuple:
        """RoPE's tables for an f x h x w token grid, built once per grid and
        device."""
        key = (f, h, w, torch.device(device))
        if key not in self._rope:
            self._rope[key] = rope_3d(f, h, w, self.cfg.rope_dims, ROPE_THETA, device=device)
        return self._rope[key]

    @span("st2v.embed")
    def _embed(self, latents: torch.Tensor, y: torch.Tensor, t: torch.Tensor,
               text: torch.Tensor, clip: torch.Tensor) -> tuple:
        """The f32 stream (B, L, dim), e (B, dim) and e0 (B, 6, dim) in f32,
        and the text and image keys' sources in the compute dtype."""
        cfg = self.cfg
        dt = cfg.dtypes.compute_dtype
        b = latents.shape[0]
        x = self.patch_embedding(torch.cat([latents.to(dt), y.to(dt)], dim=1)
                                 .permute(0, 2, 3, 4, 1))
        h = x.reshape(b, -1, cfg.dim).float()
        e = self.time_embedding_2(F.silu(self.time_embedding_1(
            timestep_embedding(t, cfg.freq_dim))))
        e0 = self.time_projection(F.silu(e)).unflatten(1, (6, cfg.dim))
        text = F.pad(text.to(dt), (0, 0, 0, cfg.text_len - text.shape[1]))
        txt = self.text_embedding_2(F.gelu(self.text_embedding_1(text), approximate="tanh"))
        return h, e, e0, txt, self.img_emb(clip.to(dt))

    @span("st2v.dit")
    def forward(self, latents: torch.Tensor, t: torch.Tensor, text: torch.Tensor,
                clip: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """latents (B, C, F, H, W), t (B,), text (B, T <= text_len, text_dim),
        clip (B, clip_tokens, clip_dim), y (B, in_dim - C, F, H, W) -> f32
        (B, out_dim, F, H, W): the flow prediction."""
        count("dit_calls")
        cfg = self.cfg
        b, _, f, hh, ww = latents.shape
        p = cfg.patch_size[1]
        h, e, e0, txt, img = self._embed(latents, y, t, text, clip)
        cos, sin = self.rope(f, hh // p, ww // p, h.device)
        for block in self.blocks:
            h = block(h, e0, txt, img, cos, sin)
        x = self.head(h, e).view(b, f, hh // p, ww // p, p, p, cfg.out_dim)
        return x.permute(0, 6, 1, 2, 4, 3, 5).reshape(b, cfg.out_dim, f, hh, ww)
