"""Plain reference of the I2VGen-XL UNet, the stage-2 enhancer
(ali-vilab/i2vgen-xl ``unet/config.json``; the diffusers
``I2VGenXLUNet``), channel-last (B, T, H, W, C), float32 through
``benchmark.reference.ops``.

Per level: ResnetBlock2D, TemporalConvLayer (four GN+SiLU+(3,1,1) convs,
residual), Transformer2D (self-attn, cross-attn to the text, first-frame
latent and CLIP image tokens, GEGLU FF) and TransformerTemporal (two
self-attentions over the frames, GEGLU FF).  The image latents enter as
extra input channels after a 3-conv projection and a per-pixel temporal
encoder.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference import ops
from benchmark.reference.layers import Conv, Dense, TimeConv, norm, norm_of
from benchmark.reference.svd import Attention, FeedForward


def _nearest(x, th: int, tw: int):
    """Nearest resize of (N, H, W, C): output row i takes input row
    floor(i * H / th), in integers."""
    rows = torch.arange(th, device=x.device) * x.shape[1] // th
    cols = torch.arange(tw, device=x.device) * x.shape[2] // tw
    return x.index_select(1, rows).index_select(2, cols)


class ResnetBlock2D(nn.Module):
    def __init__(self, cin: int, cout: int, emb_dim: int, groups: int):
        super().__init__()
        self.groups = groups
        norm(self, "norm1", cin)
        self.conv1 = Conv(cin, cout, 3)
        self.time_emb_proj = Dense(emb_dim, cout)
        norm(self, "norm2", cout)
        self.conv2 = Conv(cout, cout, 3)
        self.conv_shortcut = Conv(cin, cout, 1) if cin != cout else None

    def forward(self, x, temb):
        g = self.groups
        h = self.conv1(ops.group_norm(x, *norm_of(self, "norm1"), groups=g, eps=1e-5, silu=True))
        h = h + self.time_emb_proj(F.silu(temb.float()))[:, None, None, :]
        h = self.conv2(ops.group_norm(h, *norm_of(self, "norm2"), groups=g, eps=1e-5, silu=True))
        return (x if self.conv_shortcut is None else self.conv_shortcut(x)) + h


class TemporalConvLayer(nn.Module):
    def __init__(self, c: int, groups: int):
        super().__init__()
        self.groups = groups
        for name in ("conv1", "conv2", "conv3", "conv4"):
            norm(self, f"{name}_norm", c)
            self.add_module(name, TimeConv(c, c, 3, zero_init=name == "conv4"))

    def forward(self, x):
        h = x
        for name in ("conv1", "conv2", "conv3", "conv4"):
            h = getattr(self, name)(ops.group_norm(h, *norm_of(self, f"{name}_norm"),
                                                   groups=self.groups, eps=1e-5, silu=True),
                                    residual=name == "conv4")
        return x + h


class Block(nn.Module):
    """Self-attn, then cross-attn (or a second self-attn), then the GEGLU FF."""

    def __init__(self, dim: int, heads: int, dim_head: int, context_dim=None):
        super().__init__()
        for n in ("norm1", "norm2", "norm3"):
            norm(self, n, dim)
        self.attn1 = Attention(dim, heads, dim_head)
        self.attn2 = Attention(dim, heads, dim_head, context_dim)
        self.ff = FeedForward(dim)


class Transformer2D(nn.Module):
    def __init__(self, c: int, heads: int, dim_head: int, context_dim: int, groups: int):
        super().__init__()
        self.groups = groups
        norm(self, "norm", c)
        self.proj_in = Conv(c, heads * dim_head, 1)
        self.block_0 = Block(heads * dim_head, heads, dim_head, context_dim)
        self.proj_out = Conv(heads * dim_head, c, 1)

    def forward(self, x, context):
        n, hh, ww, _ = x.shape
        h = self.proj_in(ops.group_norm(x, *norm_of(self, "norm"), groups=self.groups, eps=1e-6))
        h = h.reshape(n, hh * ww, -1)
        blk = self.block_0
        h = h + blk.attn1(ops.layer_norm(h, *norm_of(blk, "norm1")))
        h = h + blk.attn2(ops.layer_norm(h, *norm_of(blk, "norm2")), context)
        h = blk.ff(h, norm_of(blk, "norm3"))
        return x + self.proj_out(h.reshape(n, hh, ww, -1))


class TransformerTemporal(nn.Module):
    def __init__(self, c: int, heads: int, dim_head: int, groups: int):
        super().__init__()
        self.groups = groups
        norm(self, "norm", c)
        self.proj_in = Dense(c, heads * dim_head)
        self.block_0 = Block(heads * dim_head, heads, dim_head)
        self.proj_out = Dense(heads * dim_head, c)

    def forward(self, x):
        b, t, hh, ww, c = x.shape
        h = ops.group_norm(x, *norm_of(self, "norm"), groups=self.groups, eps=1e-6)
        h = self.proj_in(h.reshape(b * t, hh * ww, c))
        blk = self.block_0
        h = h + blk.attn1.over_frames(ops.layer_norm(h, *norm_of(blk, "norm1")), b, t)
        h = h + blk.attn2.over_frames(ops.layer_norm(h, *norm_of(blk, "norm2")), b, t)
        h = blk.ff(h, norm_of(blk, "norm3"))
        return x + self.proj_out(h).reshape(x.shape)


class TemporalEncoder(nn.Module):
    """LN, self-attention over the frames (no q/k/v bias), plain-GELU FF."""

    def __init__(self, c: int, heads: int, dim_head: int, ff_inner: int):
        super().__init__()
        self.heads = heads
        norm(self, "norm1", c)
        self.to_q = Dense(c, heads * dim_head, bias=False)
        self.to_k = Dense(c, heads * dim_head, bias=False)
        self.to_v = Dense(c, heads * dim_head, bias=False)
        self.to_out = Dense(heads * dim_head, c)
        self.ff_fc = Dense(c, ff_inner)
        self.ff_out = Dense(ff_inner, c)

    def forward(self, x):
        h = ops.layer_norm(x, *norm_of(self, "norm1"))
        x = x + self.to_out(ops.multihead(self.to_q(h), self.to_k(h), self.to_v(h), self.heads))
        return x + self.ff_out(ops.gelu(self.ff_fc(x)))


class I2VGenXLUNet(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        cin, widths = cfg["in_channels"], cfg["block_out_channels"]
        ch0, dh, cross, g = widths[0], cfg["attention_head_dim"], cfg["cross_attention_dim"], \
            cfg["norm_num_groups"]
        emb = ch0 * 4
        self.time_embedding_1 = Dense(ch0, emb)
        self.time_embedding_2 = Dense(emb, emb)
        self.fps_embedding_1 = Dense(ch0, emb)
        self.fps_embedding_2 = Dense(emb, emb)
        self.ilce_conv1 = Conv(cin, cin * 8, 3)
        self.ilce_conv2 = Conv(cin * 8, cin * 16, 3, stride=2, padding=1)
        self.ilce_conv3 = Conv(cin * 16, cross, 3, stride=2, padding=1)
        self.context_embedding_1 = Dense(cfg["image_embed_dim"], emb)
        self.context_embedding_2 = Dense(emb, cross * cin)
        self.ilp_conv1 = Conv(cin, cin * 4, 3)
        self.ilp_conv2 = Conv(cin * 4, cin * 4, 3)
        self.ilp_conv3 = Conv(cin * 4, cin, 3)
        self.image_latents_temporal_encoder = TemporalEncoder(cin, 2, cin, cin * 4)
        self.conv_in = Conv(2 * cin, ch0, 3)
        self.transformer_in = TransformerTemporal(ch0, 8, dh, g)
        n = len(widths)
        skips, ch = [ch0], ch0
        for i, c in enumerate(widths):
            for j in range(cfg["layers_per_block"]):
                self._layer(f"down_{i}", j, ch, c, i < n - 1)
                ch = c
                skips.append(ch)
            if i < n - 1:
                self.add_module(f"down_{i}_downsample", Conv(c, c, 3, stride=2, padding=1))
                skips.append(ch)
        self.mid_res_0 = ResnetBlock2D(ch, widths[-1], emb, g)
        self.mid_tconv_0 = TemporalConvLayer(widths[-1], g)
        self.mid_attn = Transformer2D(widths[-1], widths[-1] // dh, dh, cross, g)
        self.mid_tattn = TransformerTemporal(widths[-1], widths[-1] // dh, dh, g)
        self.mid_res_1 = ResnetBlock2D(widths[-1], widths[-1], emb, g)
        self.mid_tconv_1 = TemporalConvLayer(widths[-1], g)
        ch = widths[-1]
        for i, c in enumerate(reversed(widths)):
            for j in range(cfg["layers_per_block"] + 1):
                self._layer(f"up_{i}", j, ch + skips.pop(), c, i > 0)
                ch = c
            if i < n - 1:
                self.add_module(f"up_{i}_upsample", Conv(c, c, 3))
        norm(self, "conv_norm_out", ch)
        self.conv_out = Conv(ch, cfg["out_channels"], 3)

    def _layer(self, prefix: str, j: int, cin: int, c: int, attn: bool) -> None:
        cfg = self.cfg
        dh, g = cfg["attention_head_dim"], cfg["norm_num_groups"]
        self.add_module(f"{prefix}_res_{j}", ResnetBlock2D(cin, c, cfg["block_out_channels"][0] * 4,
                                                           g))
        self.add_module(f"{prefix}_tconv_{j}", TemporalConvLayer(c, g))
        if attn:
            self.add_module(f"{prefix}_attn_{j}",
                            Transformer2D(c, c // dh, dh, cfg["cross_attention_dim"], g))
            self.add_module(f"{prefix}_tattn_{j}", TransformerTemporal(c, c // dh, dh, g))

    def _run_layer(self, prefix: str, j: int, h, emb, context):
        h = ops.per_frame(h, lambda x: getattr(self, f"{prefix}_res_{j}")(x, emb))
        h = getattr(self, f"{prefix}_tconv_{j}")(h)
        attn = getattr(self, f"{prefix}_attn_{j}", None)
        if attn is not None:
            h = getattr(self, f"{prefix}_tattn_{j}")(ops.per_frame(h, lambda x: attn(x, context)))
        return h

    def forward(self, sample, timestep, fps, image_latents, image_embeddings, text):
        """sample, image_latents (B, T, h, w, 4); timestep, fps (B,);
        image_embeddings (B, D); text (B, L, D) -> noise prediction."""
        cfg = self.cfg
        b, t, hh, ww, cin = sample.shape
        ch0, cross = cfg["block_out_channels"][0], cfg["cross_attention_dim"]
        emb = self.time_embedding_2(F.silu(self.time_embedding_1(
            ops.timestep_embedding(timestep, ch0))))
        emb = emb + self.fps_embedding_2(F.silu(self.fps_embedding_1(
            ops.timestep_embedding(fps, ch0))))
        emb = emb.repeat_interleave(t, dim=0)
        first = F.silu(self.ilce_conv1(image_latents[:, 0]))
        first = F.adaptive_avg_pool2d(first.permute(0, 3, 1, 2), (32, 32)).permute(0, 2, 3, 1)
        first = self.ilce_conv3(F.silu(self.ilce_conv2(first)))
        img = self.context_embedding_2(F.silu(self.context_embedding_1(image_embeddings)))
        context = torch.cat([text.float(), first.reshape(b, -1, cross), img.reshape(b, cin, cross)],
                            dim=1).repeat_interleave(t, dim=0)
        il = self.ilp_conv3(F.silu(self.ilp_conv2(F.silu(self.ilp_conv1(image_latents)))))
        il = il.permute(0, 2, 3, 1, 4).reshape(b * hh * ww, t, cin)
        il = self.image_latents_temporal_encoder(il).reshape(b, hh, ww, t, cin)
        il = il.permute(0, 3, 1, 2, 4)
        h = self.transformer_in(ops.per_frame(torch.cat([sample.float(), il], dim=-1),
                                              self.conv_in))
        n = len(cfg["block_out_channels"])
        hs = [h]
        for i in range(n):
            for j in range(cfg["layers_per_block"]):
                h = self._run_layer(f"down_{i}", j, h, emb, context)
                hs.append(h)
            if i < n - 1:
                h = ops.per_frame(h, getattr(self, f"down_{i}_downsample"))
                hs.append(h)
        h = ops.per_frame(h, lambda x: self.mid_res_0(x, emb))
        h = self.mid_tconv_0(h)
        h = self.mid_tattn(ops.per_frame(h, lambda x: self.mid_attn(x, context)))
        h = self.mid_tconv_1(ops.per_frame(h, lambda x: self.mid_res_1(x, emb)))
        for i in range(n):
            for j in range(cfg["layers_per_block"] + 1):
                h = self._run_layer(f"up_{i}", j, torch.cat([h, hs.pop()], dim=-1), emb, context)
            if i < n - 1:
                size = hs[-1].shape[2:4]
                up = getattr(self, f"up_{i}_upsample")
                h = ops.per_frame(h, lambda x, up=up: up(_nearest(x, *size)))
        h = ops.per_frame(h, lambda x: ops.group_norm(x, *norm_of(self, "conv_norm_out"),
                                                      groups=cfg["norm_num_groups"], eps=1e-5,
                                                      silu=True))
        return ops.per_frame(h, self.conv_out)
