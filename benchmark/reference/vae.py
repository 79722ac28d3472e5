"""Plain reference of the SVD temporal VAE decoder (StreamingSVD
``code/config.yaml:219-281``; sgm's ``VideoDecoder`` in
``modules/autoencoding/temporal_ae.py``), channel-last (B, T, h, w, z) ->
(B, T, 8h, 8w, 3), float32 through ``benchmark.reference.ops``.

A VideoResBlock is the spatial ResnetBlock (GN eps 1e-6) followed by the
temporal stack (GN eps 1e-5 + SiLU + (3, 1, 1) conv, twice), blended in by
``sigmoid(mix)``; the bottleneck attention is one 512-wide head over each
frame's pixels; the output conv is a 3x3 conv and a (3, 1, 1) time-mix conv.
"""

from __future__ import annotations

import torch
from torch import nn

from benchmark.reference import ops
from benchmark.reference.layers import Conv, TimeConv, norm, norm_of, param
from benchmark.reference.svd import Sampling


class ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        norm(self, "norm1", cin)
        self.conv1 = Conv(cin, cout, 3)
        norm(self, "norm2", cout)
        self.conv2 = Conv(cout, cout, 3)
        self.nin_shortcut = Conv(cin, cout, 1) if cin != cout else None

    def forward(self, x):
        h = self.conv1(ops.group_norm(x, *norm_of(self, "norm1"), eps=1e-6, silu=True))
        h = self.conv2(ops.group_norm(h, *norm_of(self, "norm2"), eps=1e-6, silu=True))
        return (x if self.nin_shortcut is None else self.nin_shortcut(x)) + h


class TemporalResStack(nn.Module):
    def __init__(self, c: int, kt: int):
        super().__init__()
        norm(self, "in_norm", c)
        self.in_conv = TimeConv(c, c, kt)
        norm(self, "out_norm", c)
        self.out_conv = TimeConv(c, c, kt, zero_init=True)

    def forward(self, x, weight):
        h = self.in_conv(ops.group_norm(x, *norm_of(self, "in_norm"), eps=1e-5, silu=True))
        h = self.out_conv(ops.group_norm(h, *norm_of(self, "out_norm"), eps=1e-5, silu=True),
                          residual=True)
        return x + weight * h


class VideoResBlock(nn.Module):
    def __init__(self, cin: int, cout: int, kt: int):
        super().__init__()
        self.spatial = ResnetBlock(cin, cout)
        self.mix_factor = param(1)
        self.time_stack = TemporalResStack(cout, kt)

    def forward(self, x):
        return self.time_stack(ops.per_frame(x, self.spatial),
                               torch.sigmoid(self.mix_factor.float()))


class AttnBlock(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        norm(self, "norm", c)
        self.q = Conv(c, c, 1)
        self.k = Conv(c, c, 1)
        self.v = Conv(c, c, 1)
        self.proj_out = Conv(c, c, 1)

    def forward(self, x):
        n, hh, ww, c = x.shape
        hn = ops.group_norm(x, *norm_of(self, "norm"), eps=1e-6)
        q, k, v = (conv(hn).reshape(n, hh * ww, c) for conv in (self.q, self.k, self.v))
        return x + self.proj_out(ops.multihead(q, k, v, 1).reshape(n, hh, ww, c))


class AE3DConv(nn.Module):
    def __init__(self, cin: int, cout: int, kt: int):
        super().__init__()
        self.conv = Conv(cin, cout, 3)
        self.time_mix_conv = TimeConv(cout, cout, kt)

    def forward(self, x):
        return self.time_mix_conv(ops.per_frame(x, self.conv))


class VideoDecoder(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        kt, mults, ch = cfg["video_kernel_size"][0], cfg["ch_mult"], cfg["ch"]
        c = ch * mults[-1]
        self.conv_in = Conv(cfg["z_channels"], c, 3)
        self.mid_block_1 = VideoResBlock(c, c, kt)
        self.mid_attn_1 = AttnBlock(c)
        self.mid_block_2 = VideoResBlock(c, c, kt)
        for i in reversed(range(len(mults))):
            for j in range(cfg["num_res_blocks"] + 1):
                self.add_module(f"up_{i}_block_{j}", VideoResBlock(c, ch * mults[i], kt))
                c = ch * mults[i]
            if i != 0:
                self.add_module(f"up_{i}_upsample", Sampling(c, up=True))
        norm(self, "norm_out", c)
        self.conv_out = AE3DConv(c, cfg["out_ch"], kt)

    def forward(self, z):
        cfg = self.cfg
        h = self.mid_block_1(ops.per_frame(z, self.conv_in))
        h = self.mid_block_2(ops.per_frame(h, self.mid_attn_1))
        for i in reversed(range(len(cfg["ch_mult"]))):
            for j in range(cfg["num_res_blocks"] + 1):
                h = getattr(self, f"up_{i}_block_{j}")(h)
            if i != 0:
                h = getattr(self, f"up_{i}_upsample")(h)
        h = ops.per_frame(h, lambda x: ops.group_norm(x, *norm_of(self, "norm_out"), eps=1e-6,
                                                      silu=True))
        return self.conv_out(h)


def decode(decoder: VideoDecoder, z: torch.Tensor, scale_factor: float) -> torch.Tensor:
    """Scaled latents (B, T, h, w, z) -> frames clamped to [-1, 1]."""
    return decoder(z.float() / scale_factor).clamp(-1.0, 1.0)
