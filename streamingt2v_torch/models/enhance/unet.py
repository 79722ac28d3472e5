"""I2VGen-XL UNet, the stage-2 enhancement model (counterpart of
``streamingt2v_tpu/models/enhance/unet.py``).

Per level: ResnetBlock2D -> TemporalConvLayer -> Transformer2D ->
TransformerTemporal; context = text tokens + first-frame VAE-latent context
tokens + the projected CLIP image embedding; the image latents also enter
channel-concatenated after a per-pixel temporal encoder.

Layout: (B, T, H, W, C) channel-last; spatial modules fold T into the batch,
temporal modules keep the spatial-major (B*T, H*W, C) layout.  Kernels on
the card: K5 in every per-frame GroupNorm, K4 in every TemporalConvLayer, K3
in every transformer feed-forward, K2 (or K1) in the spatial self- and
cross-attentions and K6 in the temporal self-attentions, as the pipeline's
``KernelRouting`` says.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from streamingt2v_torch.config import DTypePolicy
from streamingt2v_torch.models.layers import (
    Conv, Dense, TimeConv, norm_pair, norm_params, per_frame, silu_f32)
from streamingt2v_torch.models.unet_blocks import BasicTransformerBlock, _time_conv
from streamingt2v_torch.ops import attention, group_norm, layer_norm, timestep_embedding
from streamingt2v_torch.utils.profiling import count, span


@dataclasses.dataclass(frozen=True)
class I2VGenXLUNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    cross_attention_dim: int = 1024
    attention_head_dim: int = 64
    # width of the CLIP image embedding (CLIPVisionConfig.output_dim)
    image_embed_dim: int = 1024
    dtypes: DTypePolicy = dataclasses.field(default_factory=DTypePolicy)

    @classmethod
    def tiny(cls) -> "I2VGenXLUNetConfig":
        return cls(
            block_out_channels=(16, 32),
            layers_per_block=1,
            norm_num_groups=8,
            cross_attention_dim=32,
            attention_head_dim=8,
            image_embed_dim=16,
            dtypes=DTypePolicy.fp32(),
        )


class ResnetBlock2D(nn.Module):
    """GN(1e-5)+SiLU+conv, + time embedding, GN+SiLU+conv, 1x1 shortcut.
    Input (N, H, W, C), temb (N, D)."""

    def __init__(self, in_channels: int, out_channels: int, emb_dim: int, groups: int = 32,
                 *, device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self.groups = groups
        norm_params(self, "norm1", in_channels, **fk)
        self.conv1 = Conv(in_channels, out_channels, 3, **fk)
        self.time_emb_proj = Dense(emb_dim, out_channels, **fk)
        norm_params(self, "norm2", out_channels, **fk)
        self.conv2 = Conv(out_channels, out_channels, 3, **fk)
        self.conv_shortcut = (Conv(in_channels, out_channels, 1, **fk)
                              if in_channels != out_channels else None)

    @span("st2v.resblock")
    def forward(self, x, temb):
        h = group_norm(x, *norm_pair(self, "norm1"), num_groups=self.groups, eps=1e-5,
                       act="silu")
        h = self.conv1(h) + self.time_emb_proj(silu_f32(temb))[:, None, None, :]
        h = group_norm(h, *norm_pair(self, "norm2"), num_groups=self.groups, eps=1e-5,
                       act="silu")
        h = self.conv2(h)
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class TemporalConvLayer(nn.Module):
    """4x (GN+SiLU + (3,1,1) conv), zero-initialised conv4, residual.
    Input (B, T, H, W, C); on the card each conv is one K4 launch with the
    GroupNorm+SiLU as its prologue and the residual as its epilogue."""

    def __init__(self, channels: int, out_channels: int, groups: int = 32, *,
                 device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self.groups = groups
        specs = [("conv1", channels, out_channels), ("conv2", out_channels, channels),
                 ("conv3", channels, channels), ("conv4", channels, channels)]
        for name, c_in, c_out in specs:
            norm_params(self, f"{name}_norm", c_in, **fk)
            self.add_module(name, TimeConv(c_in, c_out, (3, 1, 1), zero_init=name == "conv4",
                                           **fk))

    @span("st2v.resblock")
    def forward(self, x):
        h = x
        for i, name in enumerate(("conv1", "conv2", "conv3", "conv4")):
            last = i == 3
            gn = norm_pair(self, f"{name}_norm") + (self.groups,)
            h = _time_conv(h, getattr(self, name), gn=gn, res=x if last else None,
                           res_w=torch.ones(x.shape[:2], device=x.device) if last else None)
        return h


class Transformer2D(nn.Module):
    """GN(1e-6) -> 1x1 conv in -> BasicTransformerBlock -> 1x1 conv out,
    residual.  Input (N, H, W, C), context (N, L, D)."""

    def __init__(self, channels: int, heads: int, dim_head: int, context_dim: int,
                 groups: int = 32, depth: int = 1, *, device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        inner = heads * dim_head
        self.groups, self.depth = groups, depth
        norm_params(self, "norm", channels, **fk)
        self.proj_in = Conv(channels, inner, 1, **fk)
        for d in range(depth):
            self.add_module(f"block_{d}", BasicTransformerBlock(inner, heads, dim_head,
                                                                context_dim, **fk))
        self.proj_out = Conv(inner, channels, 1, **fk)

    @span("st2v.transformer")
    def forward(self, x, context):
        n, hh, ww, _ = x.shape
        h = group_norm(x, *norm_pair(self, "norm"), num_groups=self.groups, eps=1e-6)
        h = self.proj_in(h)
        inner = h.shape[-1]
        h = h.reshape(n, hh * ww, inner)
        for d in range(self.depth):
            h = getattr(self, f"block_{d}")(h, context)
        return x + self.proj_out(h.reshape(n, hh, ww, inner))


class TransformerTemporal(nn.Module):
    """GN(1e-6, statistics over T, H, W) -> linear in -> temporal
    BasicTransformerBlock (two self-attentions over frames) -> linear out,
    residual.  Input (B, T, H, W, C).  The block runs in the spatial-major
    (B*T, H*W, C) layout; only its attentions see the frame axis, through
    ``ops.temporal_attention`` on that layout."""

    def __init__(self, channels: int, heads: int, dim_head: int, groups: int = 32,
                 depth: int = 1, *, device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        inner = heads * dim_head
        self.groups, self.depth = groups, depth
        norm_params(self, "norm", channels, **fk)
        self.proj_in = Dense(channels, inner, **fk)
        for d in range(depth):
            self.add_module(f"block_{d}", BasicTransformerBlock(inner, heads, dim_head, **fk))
        self.proj_out = Dense(inner, channels, **fk)

    @span("st2v.transformer")
    def forward(self, x):
        b, t, hh, ww, c = x.shape
        h = group_norm(x, *norm_pair(self, "norm"), num_groups=self.groups, eps=1e-6)
        h = self.proj_in(h.reshape(b * t, hh * ww, c))
        for d in range(self.depth):
            h = getattr(self, f"block_{d}")(h, None, frames=(b, t))
        return x + self.proj_out(h).reshape(b, t, hh, ww, c)


class TemporalEncoder(nn.Module):
    """LN -> self-attention (no q/k/v bias) -> plain-GELU FF, residuals.
    Input (N, T, C)."""

    def __init__(self, channels: int, heads: int, dim_head: int, ff_inner: int, *,
                 device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        inner = heads * dim_head
        self.heads = heads
        norm_params(self, "norm1", channels, **fk)
        self.to_q = Dense(channels, inner, bias=False, **fk)
        self.to_k = Dense(channels, inner, bias=False, **fk)
        self.to_v = Dense(channels, inner, bias=False, **fk)
        self.to_out = Dense(inner, channels, **fk)
        self.ff_fc = Dense(channels, ff_inner, **fk)
        self.ff_out = Dense(ff_inner, channels, **fk)

    @span("st2v.transformer")
    def forward(self, x):
        h = layer_norm(x, *norm_pair(self, "norm1"))
        o = attention(self.to_q(h), self.to_k(h), self.to_v(h), num_heads=self.heads)
        x = x + self.to_out(o)
        h = self.ff_fc(x)
        h = F.gelu(h.float()).to(h.dtype)
        return x + self.ff_out(h)


def adaptive_avg_pool_matrix(in_size: int, out_size: int, device=None) -> torch.Tensor:
    """(out, in) averaging matrix with torch AdaptiveAvgPool1d windows
    [floor(i*I/O), ceil((i+1)*I/O))."""
    mat = torch.zeros((out_size, in_size), dtype=torch.float32, device=device)
    for i in range(out_size):
        lo = (i * in_size) // out_size
        hi = -(-((i + 1) * in_size) // out_size)
        mat[i, lo:hi] = 1.0 / (hi - lo)
    return mat


def adaptive_avg_pool_2d(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """(N, H, W, C) -> (N, oh, ow, C) via two averaging matrix products."""
    _, h, w, _ = x.shape
    ph = adaptive_avg_pool_matrix(h, out_hw[0], x.device).to(x.dtype)
    pw = adaptive_avg_pool_matrix(w, out_hw[1], x.device).to(x.dtype)
    out = torch.einsum("oh,nhwc->nowc", ph, x)
    return torch.einsum("pw,nowc->nopc", pw, out)


def _nearest(x: torch.Tensor, th: int, tw: int) -> torch.Tensor:
    """Nearest resize of (N, H, W, C) to (th, tw) with floor indices
    (``F.interpolate(size=..., mode='nearest')``), so odd skip sizes
    round-trip (23 -> 12 -> 23 at 720p)."""
    ih, iw = x.shape[1], x.shape[2]
    rows = torch.arange(th, device=x.device) * ih // th
    cols = torch.arange(tw, device=x.device) * iw // tw
    return x.index_select(1, rows).index_select(2, cols)


class I2VGenXLUNet(nn.Module):
    def __init__(self, cfg: I2VGenXLUNetConfig, *, device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self.cfg = cfg
        cin, ch0, dh = cfg.in_channels, cfg.block_out_channels[0], cfg.attention_head_dim
        emb_dim, cross, groups = ch0 * 4, cfg.cross_attention_dim, cfg.norm_num_groups
        self.time_embedding_1 = Dense(ch0, emb_dim, **fk)
        self.time_embedding_2 = Dense(emb_dim, emb_dim, **fk)
        self.fps_embedding_1 = Dense(ch0, emb_dim, **fk)
        self.fps_embedding_2 = Dense(emb_dim, emb_dim, **fk)
        self.ilce_conv1 = Conv(cin, cin * 8, 3, **fk)
        self.ilce_conv2 = Conv(cin * 8, cin * 16, 3, stride=2, padding=1, **fk)
        self.ilce_conv3 = Conv(cin * 16, cross, 3, stride=2, padding=1, **fk)
        self.context_embedding_1 = Dense(cfg.image_embed_dim, emb_dim, **fk)
        self.context_embedding_2 = Dense(emb_dim, cross * cin, **fk)
        self.ilp_conv1 = Conv(cin, cin * 4, 3, **fk)
        self.ilp_conv2 = Conv(cin * 4, cin * 4, 3, **fk)
        self.ilp_conv3 = Conv(cin * 4, cin, 3, **fk)
        self.image_latents_temporal_encoder = TemporalEncoder(cin, 2, cin, cin * 4, **fk)
        self.conv_in = Conv(2 * cin, ch0, 3, **fk)
        self.transformer_in = TransformerTemporal(ch0, 8, dh, groups, **fk)

        n_blocks = len(cfg.block_out_channels)
        skips = [ch0]
        ch = ch0
        for i, c_out in enumerate(cfg.block_out_channels):
            for j in range(cfg.layers_per_block):
                self._add_layer(f"down_{i}", j, ch, c_out, i < n_blocks - 1, fk)
                ch = c_out
                skips.append(ch)
            if i < n_blocks - 1:
                self.add_module(f"down_{i}_downsample",
                                Conv(c_out, c_out, 3, stride=2, padding=1, **fk))
                skips.append(ch)
        c_mid = cfg.block_out_channels[-1]
        self.mid_res_0 = ResnetBlock2D(ch, c_mid, emb_dim, groups, **fk)
        self.mid_tconv_0 = TemporalConvLayer(c_mid, c_mid, groups, **fk)
        self.mid_attn = Transformer2D(c_mid, c_mid // dh, dh, cross, groups, **fk)
        self.mid_tattn = TransformerTemporal(c_mid, c_mid // dh, dh, groups, **fk)
        self.mid_res_1 = ResnetBlock2D(c_mid, c_mid, emb_dim, groups, **fk)
        self.mid_tconv_1 = TemporalConvLayer(c_mid, c_mid, groups, **fk)
        ch = c_mid
        for i, c_out in enumerate(reversed(cfg.block_out_channels)):
            for j in range(cfg.layers_per_block + 1):
                self._add_layer(f"up_{i}", j, ch + skips.pop(), c_out, i > 0, fk)
                ch = c_out
            if i < n_blocks - 1:
                self.add_module(f"up_{i}_upsample", Conv(c_out, c_out, 3, **fk))
        norm_params(self, "conv_norm_out", ch, **fk)
        self.conv_out = Conv(ch, cfg.out_channels, 3, **fk)

    def _add_layer(self, prefix: str, j: int, c_in: int, c_out: int, cross: bool,
                   fk: dict) -> None:
        cfg = self.cfg
        emb_dim, groups, dh = cfg.block_out_channels[0] * 4, cfg.norm_num_groups, \
            cfg.attention_head_dim
        self.add_module(f"{prefix}_res_{j}", ResnetBlock2D(c_in, c_out, emb_dim, groups, **fk))
        self.add_module(f"{prefix}_tconv_{j}", TemporalConvLayer(c_out, c_out, groups, **fk))
        if cross:
            self.add_module(f"{prefix}_attn_{j}", Transformer2D(
                c_out, c_out // dh, dh, cfg.cross_attention_dim, groups, **fk))
            self.add_module(f"{prefix}_tattn_{j}", TransformerTemporal(
                c_out, c_out // dh, dh, groups, **fk))

    def _layer(self, prefix: str, j: int, h, emb_bt, context_bt):
        h = per_frame(h, lambda x: getattr(self, f"{prefix}_res_{j}")(x, emb_bt))
        h = getattr(self, f"{prefix}_tconv_{j}")(h)
        attn = getattr(self, f"{prefix}_attn_{j}", None)
        if attn is not None:
            h = per_frame(h, lambda x: attn(x, context_bt))
            h = getattr(self, f"{prefix}_tattn_{j}")(h)
        return h

    @span("st2v.unet")
    def forward(self, sample, timestep, fps, image_latents, image_embeddings,
                encoder_hidden_states) -> torch.Tensor:
        """sample, image_latents (B, T, h, w, 4); timestep, fps (B,);
        image_embeddings (B, D_img); encoder_hidden_states (B, L, D) ->
        f32 noise prediction (B, T, h, w, 4)."""
        count("unet_calls")
        cfg = self.cfg
        dtype = cfg.dtypes.compute_dtype
        sample, image_latents, image_embeddings, encoder_hidden_states = (
            z.to(dtype) for z in (sample, image_latents, image_embeddings, encoder_hidden_states))
        emb_bt, context_bt, il = self._embed(timestep, fps, image_latents, image_embeddings,
                                             encoder_hidden_states)

        # 5. pre-process
        h = self.conv_in(torch.cat([sample, il], dim=-1))
        h = self.transformer_in(h)

        # 6. down
        n_blocks = len(cfg.block_out_channels)
        hs = [h]
        for i in range(n_blocks):
            for j in range(cfg.layers_per_block):
                h = self._layer(f"down_{i}", j, h, emb_bt, context_bt)
                hs.append(h)
            if i < n_blocks - 1:
                h = getattr(self, f"down_{i}_downsample")(h)
                hs.append(h)

        # 7. mid
        h = per_frame(h, lambda x: self.mid_res_0(x, emb_bt))
        h = self.mid_tconv_0(h)
        h = per_frame(h, lambda x: self.mid_attn(x, context_bt))
        h = self.mid_tattn(h)
        h = per_frame(h, lambda x: self.mid_res_1(x, emb_bt))
        h = self.mid_tconv_1(h)

        # 8. up
        for i in range(n_blocks):
            for j in range(cfg.layers_per_block + 1):
                h = torch.cat([h, hs.pop()], dim=-1)
                h = self._layer(f"up_{i}", j, h, emb_bt, context_bt)
            if i < n_blocks - 1:
                th, tw = hs[-1].shape[2], hs[-1].shape[3]
                up = getattr(self, f"up_{i}_upsample")
                h = per_frame(h, lambda x, up=up, th=th, tw=tw: up(_nearest(x, th, tw)))

        # 9. out: per-frame GroupNorm statistics (conv_norm_out on B*T frames)
        h = per_frame(h, lambda x: group_norm(x, *norm_pair(self, "conv_norm_out"),
                                              num_groups=cfg.norm_num_groups, eps=1e-5,
                                              act="silu"))
        return self.conv_out(h).float()

    @span("st2v.embed")
    def _embed(self, timestep, fps, image_latents, image_embeddings,
               encoder_hidden_states) -> tuple:
        """The conditioning, in the compute dtype: the time + fps embedding
        per frame (B*T, emb_dim), the context per frame (B*T, L', D) and the
        image-latent channel stream (B, T, h, w, 4)."""
        cfg = self.cfg
        b, t, hh, ww, _ = image_latents.shape
        dtype = cfg.dtypes.compute_dtype
        ch0, cin = cfg.block_out_channels[0], cfg.in_channels

        # 1-3. time + fps embeddings
        emb = self.time_embedding_2(F.silu(self.time_embedding_1(
            timestep_embedding(timestep.float(), ch0).to(dtype))))
        fe = self.fps_embedding_2(F.silu(self.fps_embedding_1(
            timestep_embedding(fps.float(), ch0).to(dtype))))
        emb_bt = (emb + fe).repeat_interleave(t, dim=0)  # (B*T, emb_dim)

        # 4. context: text tokens, first-frame latent context, CLIP image
        h_ctx = adaptive_avg_pool_2d(F.silu(self.ilce_conv1(image_latents[:, 0])), (32, 32))
        h_ctx = self.ilce_conv3(F.silu(self.ilce_conv2(h_ctx)))
        img_ctx = self.context_embedding_2(F.silu(self.context_embedding_1(image_embeddings)))
        context = torch.cat([encoder_hidden_states,
                             h_ctx.reshape(b, -1, cfg.cross_attention_dim),
                             img_ctx.reshape(b, cin, cfg.cross_attention_dim)], dim=1)
        context_bt = context.repeat_interleave(t, dim=0)

        # image-latent channel stream: 3-conv projection + per-pixel temporal encoder
        il = self.ilp_conv1(image_latents)
        il = self.ilp_conv3(F.silu(self.ilp_conv2(F.silu(il))))
        il_t = il.permute(0, 2, 3, 1, 4).reshape(b * hh * ww, t, cin)
        il_t = self.image_latents_temporal_encoder(il_t)
        il = il_t.reshape(b, hh, ww, t, cin).permute(0, 3, 1, 2, 4)
        return emb_bt, context_bt, il
