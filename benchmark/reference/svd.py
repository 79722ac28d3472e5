"""Plain reference of the StreamingSVD stage-1 networks: the SVD-XT
VideoUNet in ControlNet mode (a CAM merger after every input block and the
mid block) and the ControlNet with its pixel-space conditioning embedder.

Channel-last activations (B, T, H, W, C).  Everything runs in float32
through ``benchmark.reference.ops``; attention is exact softmax attention,
computed in blocks of queries.  The equations follow the published models
(Picsart-AI-Research/StreamingT2V, StreamingSVD branch, ``code/config.yaml``
and its ``models/svd`` and ``models/control`` modules; SVD-XT's
``video_model.py``):

- ResBlock: x + conv(SiLU(GN(conv(SiLU(GN(x))) + emb))), then the
  temporal ResBlock with (3, 1, 1) convolutions, blended in by
  ``1 - sigmoid(mix)`` (learned_with_images, no image rows);
- spatial transformer: GN, proj_in, [self-attn, cross-attn, GEGLU FF] and
  the temporal block [GEGLU ff_in, frame self-attn, cross-attn to frame 0's
  context, GEGLU FF] on the frame-embedded activations, blended by
  ``sigmoid(mix)``, proj_out, residual;
- CAM: per pixel, the UNet's frames attend over the ControlNet's
  conditional frames.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference import ops
from benchmark.reference.layers import Conv, Dense, TimeConv, norm, norm_of, param


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: Optional[int] = None):
        super().__init__()
        inner = heads * dim_head
        ctx = dim if context_dim is None else context_dim
        self.heads = heads
        self.to_q = Dense(dim, inner, bias=False)
        self.to_k = Dense(ctx, inner, bias=False)
        self.to_v = Dense(ctx, inner, bias=False)
        self.to_out = Dense(inner, dim)

    def forward(self, x, context=None):
        """Over the token axis of (N, L, C); cross-attention with context."""
        ctx = x if context is None else context
        return self.to_out(ops.multihead(self.to_q(x), self.to_k(ctx), self.to_v(ctx),
                                         self.heads))

    def over_frames(self, x, b: int, t: int):
        """Self-attention over the frames of spatial-major (B*T, S, C)."""
        s, c = x.shape[1], x.shape[2]

        def to_time(z):
            return z.reshape(b, t, s, c).transpose(1, 2).reshape(b * s, t, c)

        o = ops.multihead(to_time(self.to_q(x)), to_time(self.to_k(x)), to_time(self.to_v(x)),
                          self.heads)
        return self.to_out(o.reshape(b, s, t, c).transpose(1, 2).reshape(b * t, s, c))


class FeedForward(nn.Module):
    """Pre-LN GEGLU: x + out(a * gelu(b)), [a, b] = proj(LN(x))."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.proj = Dense(dim, dim * mult * 2)
        self.out = Dense(dim * mult, dim)

    def forward(self, x, ln):
        m = x.numel() // x.shape[-1]
        ops.record("geglu_ff", m=m, c=x.shape[-1], inner=self.out.kernel.shape[1])
        a, b = self.proj(ops.layer_norm(x, *ln)).chunk(2, dim=-1)
        return x + self.out(a * ops.gelu(b))


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: Optional[int]):
        super().__init__()
        for n in ("norm1", "norm2", "norm3"):
            norm(self, n, dim)
        self.attn1 = Attention(dim, heads, dim_head)
        self.attn2 = Attention(dim, heads, dim_head, context_dim)
        self.ff = FeedForward(dim)

    def forward(self, x, context):
        x = x + self.attn1(ops.layer_norm(x, *norm_of(self, "norm1")))
        x = x + self.attn2(ops.layer_norm(x, *norm_of(self, "norm2")), context)
        return self.ff(x, norm_of(self, "norm3"))


class TemporalTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: int):
        super().__init__()
        norm(self, "norm_in", dim)
        self.ff_in = FeedForward(dim)
        norm(self, "norm1", dim)
        self.attn1 = Attention(dim, heads, dim_head)
        norm(self, "norm2", dim)
        self.attn2 = Attention(dim, heads, dim_head, context_dim)
        norm(self, "norm3", dim)
        self.ff = FeedForward(dim)

    def forward(self, x, context, b: int, t: int):
        x = self.ff_in(x, norm_of(self, "norm_in"))
        x = x + self.attn1.over_frames(ops.layer_norm(x, *norm_of(self, "norm1")), b, t)
        x = x + self.attn2(ops.layer_norm(x, *norm_of(self, "norm2")), context)
        return self.ff(x, norm_of(self, "norm3"))


class SpatialVideoTransformer(nn.Module):
    def __init__(self, c: int, heads: int, dim_head: int, context_dim: int,
                 max_period: float):
        super().__init__()
        inner = heads * dim_head
        self.max_period = max_period
        norm(self, "norm", c)
        self.proj_in = Dense(c, inner)
        self.time_pos_embed_0 = Dense(c, c * 4)
        self.time_pos_embed_2 = Dense(c * 4, c)
        self.time_mixer_mix_factor = param(1)
        self.block_0 = TransformerBlock(inner, heads, dim_head, context_dim)
        self.time_block_0 = TemporalTransformerBlock(inner, heads, dim_head, context_dim)
        self.proj_out = Dense(inner, c, zero_init=True)

    def forward(self, x, context):
        b, t, hh, ww, c = x.shape
        h = ops.group_norm(x.reshape(b * t, hh, ww, c), *norm_of(self, "norm"), eps=1e-6)
        h = self.proj_in(h).reshape(b * t, hh * ww, -1)
        frames = torch.arange(t, dtype=torch.float32, device=x.device)
        pos = self.time_pos_embed_2(F.silu(self.time_pos_embed_0(
            ops.timestep_embedding(frames, c, self.max_period))))
        ctx = context.reshape((b * t,) + context.shape[2:])
        ctx_time = context[:, :1].expand(context.shape).reshape(ctx.shape)
        h = self.block_0(h, ctx)
        h_time = self.time_block_0(h + pos.repeat(b, 1)[:, None, :], ctx_time, b, t)
        alpha = torch.sigmoid(self.time_mixer_mix_factor.float())
        h = alpha * h + (1.0 - alpha) * h_time
        return x + self.proj_out(h).reshape(x.shape)


class ResBlock(nn.Module):
    """The spatial ResBlock and its temporal stack (the UNet's VideoResBlock)."""

    def __init__(self, cin: int, cout: int, emb_dim: int, kt: int):
        super().__init__()
        self.spatial = _SpatialRes(cin, cout, emb_dim)
        self.time_mixer_mix_factor = param(1)
        self.time_stack = _TemporalRes(cout, emb_dim, kt)

    def forward(self, x, emb):
        b, t = x.shape[:2]
        h = self.spatial(x.reshape((b * t,) + x.shape[2:]), emb.reshape(b * t, -1))
        h = h.reshape((b, t) + h.shape[1:])
        weight = 1.0 - torch.sigmoid(self.time_mixer_mix_factor.float())
        return self.time_stack(h, emb, weight)


class _SpatialRes(nn.Module):
    def __init__(self, cin: int, cout: int, emb_dim: int):
        super().__init__()
        norm(self, "in_norm", cin)
        self.in_conv = Conv(cin, cout, 3)
        self.emb_proj = Dense(emb_dim, cout)
        norm(self, "out_norm", cout)
        self.out_conv = Conv(cout, cout, 3, zero_init=True)
        self.skip = Conv(cin, cout, 1) if cin != cout else None

    def forward(self, x, emb):
        h = self.in_conv(ops.group_norm(x, *norm_of(self, "in_norm"), eps=1e-5, silu=True))
        h = h + self.emb_proj(F.silu(emb.float()))[:, None, None, :]
        h = self.out_conv(ops.group_norm(h, *norm_of(self, "out_norm"), eps=1e-5, silu=True))
        return (x if self.skip is None else self.skip(x)) + h


class _TemporalRes(nn.Module):
    def __init__(self, c: int, emb_dim: int, kt: int):
        super().__init__()
        norm(self, "in_norm", c)
        self.in_conv = TimeConv(c, c, kt)
        self.emb_proj = Dense(emb_dim, c)
        norm(self, "out_norm", c)
        self.out_conv = TimeConv(c, c, kt, zero_init=True)

    def forward(self, x, emb, weight):
        h = self.in_conv(ops.group_norm(x, *norm_of(self, "in_norm"), eps=1e-5, silu=True))
        h = h + self.emb_proj(F.silu(emb.float()))[:, :, None, None, :]
        h = self.out_conv(ops.group_norm(h, *norm_of(self, "out_norm"), eps=1e-5, silu=True),
                          residual=True)
        return x + weight * h


class CAM(nn.Module):
    """Per-pixel attention of the UNet's frames over the ControlNet's."""

    def __init__(self, c: int, dim_head: int):
        super().__init__()
        self.heads = c // dim_head
        norm(self, "norm", c)
        self.proj_in = Dense(c, c)
        self.to_q = Dense(c, c, bias=False)
        self.to_k = Dense(c, c, bias=False)
        self.to_v = Dense(c, c, bias=False)
        self.to_out = Dense(c, c)
        self.proj_out = Dense(c, c, zero_init=True)

    def forward(self, sample, cond):
        b, f, hh, ww, c = sample.shape
        fc, s = cond.shape[1], hh * ww
        hn = self.proj_in(ops.group_norm(sample, *norm_of(self, "norm"), eps=1e-6))

        def per_pixel(z, n):
            return z.reshape(b, n, s, c).transpose(1, 2).reshape(b * s, n, c)

        o = ops.multihead(per_pixel(self.to_q(hn), f), per_pixel(self.to_k(cond), fc),
                          per_pixel(self.to_v(cond), fc), self.heads)
        o = o.reshape(b, s, f, c).transpose(1, 2)
        return sample + self.proj_out(self.to_out(o)).reshape(sample.shape)


class Sampling(nn.Module):
    """A 2x resampling convolution: strided (down) or after nearest 2x (up)."""

    def __init__(self, c: int, up: bool):
        super().__init__()
        self.up = up
        self.conv = Conv(c, c, 3) if up else Conv(c, c, 3, stride=2, padding=1)

    def forward(self, x):
        if self.up:
            x = x.repeat_interleave(2, dim=-3).repeat_interleave(2, dim=-2)
        return ops.per_frame(x, self.conv)


def _embedding(m: nn.Module, cfg: dict) -> None:
    mc = cfg["model_channels"]
    m.time_embed_0 = Dense(mc, mc * 4)
    m.time_embed_2 = Dense(mc * 4, mc * 4)
    m.label_emb_0 = Dense(cfg["adm_in_channels"], mc * 4)
    m.label_emb_2 = Dense(mc * 4, mc * 4)


def _embed(m: nn.Module, cfg: dict, t_cont, y, t: int):
    """(B, T, 4 mc): the noise level's MLP embedding plus the vector's."""
    e = ops.timestep_embedding(t_cont, cfg["model_channels"], cfg["max_period"])
    emb = m.time_embed_2(F.silu(m.time_embed_0(e)))
    emb = emb[:, None, :].expand(emb.shape[0], t, emb.shape[-1])
    return emb + m.label_emb_2(F.silu(m.label_emb_0(y)))


def _transformer(cfg: dict, c: int) -> SpatialVideoTransformer:
    dh = cfg["num_head_channels"]
    return SpatialVideoTransformer(c, c // dh, dh, cfg["context_dim"], cfg["max_period"])


def _encoder(m: nn.Module, cfg: dict) -> List[int]:
    """The input blocks and the middle; returns the skip widths."""
    mc, kt = cfg["model_channels"], cfg["video_kernel_size"][0]
    chans, ch, ds, blk = [mc], mc, 1, 0
    mults = cfg["channel_mult"]
    for level, mult in enumerate(mults):
        for _ in range(cfg["num_res_blocks"]):
            m.add_module(f"input_{blk}_res", ResBlock(ch, mult * mc, mc * 4, kt))
            ch = mult * mc
            if ds in cfg["attention_resolutions"]:
                m.add_module(f"input_{blk}_attn", _transformer(cfg, ch))
            chans.append(ch)
            blk += 1
        if level != len(mults) - 1:
            ds *= 2
            m.add_module(f"input_{blk}_down", Sampling(ch, up=False))
            chans.append(ch)
            blk += 1
    m.middle_res_0 = ResBlock(ch, ch, mc * 4, kt)
    m.middle_attn = _transformer(cfg, ch)
    m.middle_res_1 = ResBlock(ch, ch, mc * 4, kt)
    return chans


def _run_encoder(m: nn.Module, cfg: dict, h, emb, context):
    hs, ds, blk = [h], 1, 0
    mults = cfg["channel_mult"]
    for level in range(len(mults)):
        for _ in range(cfg["num_res_blocks"]):
            h = getattr(m, f"input_{blk}_res")(h, emb)
            if ds in cfg["attention_resolutions"]:
                h = getattr(m, f"input_{blk}_attn")(h, context)
            hs.append(h)
            blk += 1
        if level != len(mults) - 1:
            ds *= 2
            h = getattr(m, f"input_{blk}_down")(h)
            hs.append(h)
            blk += 1
    h = m.middle_res_1(m.middle_attn(m.middle_res_0(h, emb), context), emb)
    return hs, h


class VideoUNet(nn.Module):
    """The SVD-XT VideoUNet with CAM mergers (controlnet_mode)."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        mc, kt = cfg["model_channels"], cfg["video_kernel_size"][0]
        _embedding(self, cfg)
        self.in_conv = Conv(cfg["in_channels"], mc, 3)
        chans = _encoder(self, cfg)
        for i, c in enumerate(chans):
            self.add_module(f"cam_merger_input_{i}", CAM(c, min(64, c)))
        self.cam_merger_mid = CAM(chans[-1], min(64, chans[-1]))
        ch, blk = chans[-1], 0
        ds = 2 ** (len(cfg["channel_mult"]) - 1)
        for level, mult in reversed(list(enumerate(cfg["channel_mult"]))):
            for i in range(cfg["num_res_blocks"] + 1):
                self.add_module(f"output_{blk}_res", ResBlock(ch + chans.pop(), mc * mult,
                                                              mc * 4, kt))
                ch = mc * mult
                if ds in cfg["attention_resolutions"]:
                    self.add_module(f"output_{blk}_attn", _transformer(cfg, ch))
                if level and i == cfg["num_res_blocks"]:
                    ds //= 2
                    self.add_module(f"output_{blk}_up", Sampling(ch, up=True))
                blk += 1
        norm(self, "out_norm", ch)
        self.out_conv = Conv(ch, cfg["out_channels"], 3, zero_init=True)

    def forward(self, x, t_cont, context, y, hs_control, h_control_mid):
        cfg = self.cfg
        emb = _embed(self, cfg, t_cont, y, x.shape[1])
        hs, h = _run_encoder(self, cfg, self.in_conv(x), emb, context)
        hs = [getattr(self, f"cam_merger_input_{i}")(hk, hc)
              for i, (hk, hc) in enumerate(zip(hs, hs_control))]
        h = self.cam_merger_mid(h, h_control_mid)
        blk = 0
        ds = 2 ** (len(cfg["channel_mult"]) - 1)
        for level in reversed(range(len(cfg["channel_mult"]))):
            for i in range(cfg["num_res_blocks"] + 1):
                h = getattr(self, f"output_{blk}_res")(torch.cat([h, hs.pop()], dim=-1), emb)
                if ds in cfg["attention_resolutions"]:
                    h = getattr(self, f"output_{blk}_attn")(h, context)
                if level and i == cfg["num_res_blocks"]:
                    ds //= 2
                    h = getattr(self, f"output_{blk}_up")(h)
                blk += 1
        h = ops.per_frame(h, lambda z: ops.group_norm(z, *norm_of(self, "out_norm"), eps=1e-5,
                                                      silu=True))
        return ops.per_frame(h, self.out_conv)


class CondEmbedding(nn.Module):
    """The ControlNet's pixel-space encoder: (N, H, W, 3) -> (N, H/8, W/8, C)."""

    def __init__(self, c: int, widths):
        super().__init__()
        self.stages = len(widths) - 1
        self.conv_in = Conv(3, widths[0], 3)
        k = 0
        for i in range(self.stages):
            self.add_module(f"block_{2 * i}", Conv(widths[i], widths[i], 3))
            self.add_module(f"block_{2 * i + 1}", Conv(widths[i], widths[i + 1], 3, stride=2,
                                                       padding=1))
            norm(self, f"norm_{k}", widths[i])
            norm(self, f"norm_{k + 1}", widths[i + 1])
            k += 2
        self.conv_out = Conv(widths[-1], c, 3, zero_init=True)

    def forward(self, x):
        h = F.silu(self.conv_in(x))
        for j in range(2 * self.stages):
            h = F.silu(ops.layer_norm(getattr(self, f"block_{j}")(h), *norm_of(self, f"norm_{j}")))
        return self.conv_out(h)


class ControlNet(nn.Module):
    def __init__(self, cfg: dict, ctrl: dict):
        super().__init__()
        self.cfg = cfg
        mc = cfg["model_channels"]
        _embedding(self, cfg)
        self.cond_embedding = CondEmbedding(mc, ctrl["conditioning_embedding_out_channels"])
        self.in_conv = Conv(cfg["in_channels"], mc, 3)
        _encoder(self, cfg)

    def forward(self, x, t_cont, context, y, frames):
        """x (B, F, h, w, C_in); frames (B', F, H, W, 3), B' dividing B."""
        emb = _embed(self, self.cfg, t_cont, y, x.shape[1])
        e = ops.per_frame(frames, self.cond_embedding)
        e = e.repeat((x.shape[0] // e.shape[0],) + (1,) * (e.ndim - 1))
        return _run_encoder(self, self.cfg, self.in_conv(x) + e, emb, context)


def streaming_network(unet: VideoUNet, controlnet: ControlNet, f_cond: int):
    """The denoiser's network: the ControlNet on the first ``f_cond`` frames
    (the CFG halves share the control frames: one copy embedded), CAM, the
    UNet.  x carries the concat channels."""

    def net(x, t_cont, cond):
        x = torch.cat([x, cond["concat"].float()], dim=-1)
        context, y = cond["crossattn"].float(), cond["vector"].float()
        hs, mid = controlnet(x[:, :f_cond], t_cont, context[:, :f_cond, :1], y[:, :f_cond],
                             cond["ctrl_frames"][:1].float())
        return unet(x, t_cont, context, y, hs, mid)

    return net
