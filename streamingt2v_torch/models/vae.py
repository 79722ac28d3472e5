"""Variational autoencoder (counterpart of ``streamingt2v_tpu/models/vae.py``):
spatial encoder + temporal video decoder (stage 1) or spatial decoder (the
SD VAE of stage 2), channel-last.

Spatial modules take (N, H, W, C) with frames folded into N; temporal
modules take (B, T, H, W, C).  The decoder's VideoResBlock blends
``sigmoid(mix) * temporal + (1 - sigmoid(mix)) * spatial``, the opposite
orientation of the UNet's AlphaBlender, as the scaled residual
``h + sigmoid(mix) * conv`` of its time stack (K4's epilogue on the card).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from streamingt2v_torch.config import VAEConfig
from streamingt2v_torch.models.layers import (
    Conv, TimeConv, _param, norm_pair, norm_params, per_frame)
from streamingt2v_torch.models.unet_blocks import _time_conv
from streamingt2v_torch.ops import attention, group_norm
from streamingt2v_torch.utils.profiling import span


class ResnetBlock(nn.Module):
    """GN(eps 1e-6)+SiLU+conv twice, 1x1 nin_shortcut on channel change."""

    def __init__(self, in_channels: int, out_channels: int, *, device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        norm_params(self, "norm1", in_channels, **fk)
        self.conv1 = Conv(in_channels, out_channels, 3, **fk)
        norm_params(self, "norm2", out_channels, **fk)
        self.conv2 = Conv(out_channels, out_channels, 3, **fk)
        self.nin_shortcut = (Conv(in_channels, out_channels, 1, **fk)
                             if in_channels != out_channels else None)

    @span("st2v.resblock")
    def forward(self, x):
        h = self.conv1(group_norm(x, *norm_pair(self, "norm1"), eps=1e-6, act="silu"))
        h = self.conv2(group_norm(h, *norm_pair(self, "norm2"), eps=1e-6, act="silu"))
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head self-attention at the bottleneck (9216 tokens x 512 at
    576x1024: K1's D=512 geometry on the card)."""

    def __init__(self, channels: int, *, device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        norm_params(self, "norm", channels, **fk)
        self.q = Conv(channels, channels, 1, **fk)
        self.k = Conv(channels, channels, 1, **fk)
        self.v = Conv(channels, channels, 1, **fk)
        self.proj_out = Conv(channels, channels, 1, **fk)

    @span("st2v.attention")
    def forward(self, x):
        n, h, w, c = x.shape
        hn = group_norm(x, *norm_pair(self, "norm"), eps=1e-6)
        q, k, v = (conv(hn).reshape(n, h * w, c) for conv in (self.q, self.k, self.v))
        o = attention(q, k, v, num_heads=1)
        return x + self.proj_out(o.reshape(n, h, w, c))


class Downsample(nn.Module):
    """Strided conv after the reference's asymmetric (0, 1, 0, 1) pad."""

    def __init__(self, channels: int, *, device=None, dtype=None):
        super().__init__()
        self.conv = Conv(channels, channels, 3, stride=2, padding="VALID",
                         device=device, dtype=dtype)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 0, 0, 1, 0, 1)))


class Upsample(nn.Module):
    """Nearest 2x + 3x3 conv."""

    def __init__(self, channels: int, *, device=None, dtype=None):
        super().__init__()
        self.conv = Conv(channels, channels, 3, device=device, dtype=dtype)

    def forward(self, x):
        return self.conv(x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2))


class Encoder(nn.Module):
    """(N, H, W, 3) in [-1, 1] -> (N, H/f, W/f, 2z) moments when double_z."""

    def __init__(self, cfg: VAEConfig, *, device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.conv_in = Conv(cfg.in_channels, cfg.ch, 3, **fk)
        c = cfg.ch
        for i, mult in enumerate(cfg.ch_mult):
            for j in range(cfg.num_res_blocks):
                self.add_module(f"down_{i}_block_{j}", ResnetBlock(c, cfg.ch * mult, **fk))
                c = cfg.ch * mult
            if i != len(cfg.ch_mult) - 1:
                self.add_module(f"down_{i}_downsample", Downsample(c, **fk))
        self.mid_block_1 = ResnetBlock(c, c, **fk)
        self.mid_attn_1 = AttnBlock(c, **fk)
        self.mid_block_2 = ResnetBlock(c, c, **fk)
        norm_params(self, "norm_out", c, **fk)
        out_c = 2 * cfg.z_channels if cfg.double_z else cfg.z_channels
        self.conv_out = Conv(c, out_c, 3, **fk)

    def forward(self, x):
        cfg = self.cfg
        h = self.conv_in(x)
        for i in range(len(cfg.ch_mult)):
            for j in range(cfg.num_res_blocks):
                h = getattr(self, f"down_{i}_block_{j}")(h)
            if i != len(cfg.ch_mult) - 1:
                h = getattr(self, f"down_{i}_downsample")(h)
        h = self.mid_block_2(self.mid_attn_1(self.mid_block_1(h)))
        h = group_norm(h, *norm_pair(self, "norm_out"), eps=1e-6, act="silu")
        return self.conv_out(h)


class TemporalResStack(nn.Module):
    """The VideoResBlock's time stack: GN(1e-5)+SiLU+(3,1,1) conv twice,
    zero-initialised output conv.  Input (B, T, H, W, C)."""

    def __init__(self, channels: int, kernel: Tuple[int, int, int] = (3, 1, 1), *,
                 device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        norm_params(self, "in_norm", channels, **fk)
        self.in_conv = TimeConv(channels, channels, kernel, **fk)
        norm_params(self, "out_norm", channels, **fk)
        self.out_conv = TimeConv(channels, channels, kernel, zero_init=True, **fk)

    @span("st2v.resblock")
    def forward(self, x, blend_weight=None):
        """Returns x + blend_weight * out_conv(...) (blend_weight (B, T) f32)."""
        h = _time_conv(x, self.in_conv, gn=norm_pair(self, "in_norm"))
        if blend_weight is None:
            blend_weight = torch.ones(x.shape[:2], dtype=torch.float32, device=x.device)
        return _time_conv(h, self.out_conv, res=x, res_w=blend_weight,
                          gn=norm_pair(self, "out_norm"))


class VideoResBlock(nn.Module):
    """Spatial ResnetBlock + temporal stack, learned-alpha blended."""

    def __init__(self, in_channels: int, out_channels: int,
                 video_kernel_size: Tuple[int, int, int] = (3, 1, 1), *, device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self.spatial = ResnetBlock(in_channels, out_channels, **fk)
        self.mix_factor = _param((1,), device, dtype)
        self.time_stack = TemporalResStack(out_channels, video_kernel_size, **fk)

    @span("st2v.resblock")
    def forward(self, x):
        h = per_frame(x, self.spatial)
        alpha = torch.sigmoid(self.mix_factor.float())
        bw = alpha.expand(x.shape[:2]).contiguous()
        return self.time_stack(h, blend_weight=bw)


class AE3DConv(nn.Module):
    """3x3 conv followed by the (3,1,1) time-mix conv.  Input (B, T, H, W, C)."""

    def __init__(self, in_channels: int, out_channels: int,
                 video_kernel_size: Tuple[int, int, int] = (3, 1, 1), *, device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self.conv = Conv(in_channels, out_channels, 3, **fk)
        self.time_mix_conv = TimeConv(out_channels, out_channels, video_kernel_size, **fk)

    def forward(self, x):
        return _time_conv(per_frame(x, self.conv), self.time_mix_conv)


class VideoDecoder(nn.Module):
    """Temporal decoder: (B, T, h, w, z) -> (B, T, f*h, f*w, 3)."""

    def __init__(self, cfg: VAEConfig, *, device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self.cfg = cfg
        vks = cfg.video_kernel_size
        c = cfg.ch * cfg.ch_mult[-1]
        self.conv_in = Conv(cfg.z_channels, c, 3, **fk)
        self.mid_block_1 = VideoResBlock(c, c, vks, **fk)
        self.mid_attn_1 = AttnBlock(c, **fk)
        self.mid_block_2 = VideoResBlock(c, c, vks, **fk)
        for i in reversed(range(len(cfg.ch_mult))):
            block_out = cfg.ch * cfg.ch_mult[i]
            for j in range(cfg.num_res_blocks + 1):
                self.add_module(f"up_{i}_block_{j}", VideoResBlock(c, block_out, vks, **fk))
                c = block_out
            if i != 0:
                self.add_module(f"up_{i}_upsample", Upsample(c, **fk))
        norm_params(self, "norm_out", c, **fk)
        self.conv_out = AE3DConv(c, cfg.out_ch, vks, **fk)

    def forward(self, z):
        cfg = self.cfg
        h = per_frame(z, self.conv_in)
        h = self.mid_block_1(h)
        h = per_frame(h, self.mid_attn_1)
        h = self.mid_block_2(h)
        for i in reversed(range(len(cfg.ch_mult))):
            for j in range(cfg.num_res_blocks + 1):
                h = getattr(self, f"up_{i}_block_{j}")(h)
            if i != 0:
                h = per_frame(h, getattr(self, f"up_{i}_upsample"))
        # per-frame statistics
        h = per_frame(h, lambda x: group_norm(x, *norm_pair(self, "norm_out"), eps=1e-6,
                                             act="silu"))
        return self.conv_out(h)


class SpatialDecoder(nn.Module):
    """Pure-spatial decoder (the KL / SD VAE): (N, h, w, z) -> (N, f*h, f*w, 3)."""

    def __init__(self, cfg: VAEConfig, *, device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self.cfg = cfg
        c = cfg.ch * cfg.ch_mult[-1]
        self.conv_in = Conv(cfg.z_channels, c, 3, **fk)
        self.mid_block_1 = ResnetBlock(c, c, **fk)
        self.mid_attn_1 = AttnBlock(c, **fk)
        self.mid_block_2 = ResnetBlock(c, c, **fk)
        for i in reversed(range(len(cfg.ch_mult))):
            block_out = cfg.ch * cfg.ch_mult[i]
            for j in range(cfg.num_res_blocks + 1):
                self.add_module(f"up_{i}_block_{j}", ResnetBlock(c, block_out, **fk))
                c = block_out
            if i != 0:
                self.add_module(f"up_{i}_upsample", Upsample(c, **fk))
        norm_params(self, "norm_out", c, **fk)
        self.conv_out = Conv(c, cfg.out_ch, 3, **fk)

    def forward(self, z):
        cfg = self.cfg
        h = self.conv_in(z)
        h = self.mid_block_2(self.mid_attn_1(self.mid_block_1(h)))
        for i in reversed(range(len(cfg.ch_mult))):
            for j in range(cfg.num_res_blocks + 1):
                h = getattr(self, f"up_{i}_block_{j}")(h)
            if i != 0:
                h = getattr(self, f"up_{i}_upsample")(h)
        h = group_norm(h, *norm_pair(self, "norm_out"), eps=1e-6, act="silu")
        return self.conv_out(h)


class AutoencoderKL(nn.Module):
    """Encoder + decoder: the temporal ``VideoDecoder`` when
    ``cfg.temporal_decoder``, else the ``SpatialDecoder``.
    ``use_quant_conv`` selects the legacy-KL layout (quant and post-quant
    1x1 convs); ``encode_only`` builds just the encoder side (the stage-1
    conditioner uses nothing else)."""

    def __init__(self, cfg: VAEConfig, use_quant_conv: bool = False, encode_only: bool = False,
                 *, device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.use_quant_conv = use_quant_conv
        self.encoder = Encoder(cfg, **fk)
        if use_quant_conv:
            self.quant_conv = Conv(2 * cfg.embed_dim, 2 * cfg.embed_dim, 1, **fk)
        if not encode_only:
            self.decoder = (VideoDecoder(cfg, **fk) if cfg.temporal_decoder
                            else SpatialDecoder(cfg, **fk))
            if use_quant_conv:
                self.post_quant_conv = Conv(cfg.embed_dim, cfg.z_channels, 1, **fk)

    def moments(self, x: torch.Tensor) -> tuple:
        """x: (N, H, W, 3) -> (mean, logvar), each (N, H/f, W/f, z)."""
        m = self.encoder(x)
        if self.use_quant_conv:
            m = self.quant_conv(m)
        mean, logvar = m.chunk(2, dim=-1)
        return mean, logvar.clamp(-30.0, 20.0)

    def encode(self, x: torch.Tensor, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Mode encode, or with ``noise`` (standard normal of the latent
        shape) the sample mean + exp(logvar / 2) * noise; returns
        scale_factor * z."""
        mean, logvar = self.moments(x)
        z = mean
        if noise is not None:
            z = mean + torch.exp(0.5 * logvar) * noise.to(mean.dtype)
        return self.cfg.scale_factor * z

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Scaled latents -> frames: (B, T, h, w, z) -> (B, T, H, W, 3) with
        the temporal decoder, (N, h, w, z) -> (N, H, W, 3) with the spatial."""
        z = z / self.cfg.scale_factor
        if self.use_quant_conv:
            z = self.post_quant_conv(z)
        return self.decoder(z)
