"""VideoUNet (counterpart of ``streamingt2v_tpu/models/video_unet.py``): the
SVD spatio-temporal UNet with a CAM merger after every input block and the
mid block when ``controlnet_mode``.

Forward contract (channel-last, batch and time separate):
  x:        (B, T, H, W, C_in)   latent + concat conditioning channels
  t_cont:   (B,)                 continuous noise conditioning (c_noise)
  context:  (B, T, L, D)         CLIP image tokens
  y:        (B, T, adm)          vector conditioning
  image_only_indicator: (B, T) bool
  hs_control / h_control_mid: ControlNet features per input block / mid.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from streamingt2v_torch.config import VideoUNetConfig
from streamingt2v_torch.models.cam import CAMConditionalModel
from streamingt2v_torch.models.layers import Conv, Dense, norm_pair, norm_params, per_frame
from streamingt2v_torch.models.unet_blocks import (
    Downsample, SpatialVideoTransformer, UNetVideoResBlock, Upsample)
from streamingt2v_torch.ops import group_norm, timestep_embedding
from streamingt2v_torch.utils.profiling import count, span


def make_transformer(cfg: VideoUNetConfig, ch: int, *, use_apm: bool, apm_tokens: int,
                     fk: dict):
    return SpatialVideoTransformer(
        ch, heads=ch // cfg.num_head_channels, dim_head=cfg.num_head_channels,
        depth=cfg.transformer_depth, context_dim=cfg.context_dim, use_apm=use_apm,
        apm_tokens=apm_tokens,
        disable_temporal_crossattention=cfg.disable_temporal_crossattention,
        max_time_embed_period=cfg.max_period, use_checkpoint=cfg.use_checkpoint, **fk)


@span("st2v.embed")
def embed(m: nn.Module, cfg: VideoUNetConfig, t_cont, y, b: int, t: int, dtype) -> torch.Tensor:
    """emb (B, T, 4*mc) from the module's time/label MLP parameters."""
    t_emb = timestep_embedding(t_cont, cfg.model_channels, max_period=cfg.max_period)
    emb = m.time_embed_2(F.silu(m.time_embed_0(t_emb.to(dtype))))
    emb = emb[:, None, :].expand(b, t, emb.shape[-1])
    if y is not None:
        emb = emb + m.label_emb_2(F.silu(m.label_emb_0(y.to(dtype))))
    return emb


def add_embedding_params(m: nn.Module, cfg: VideoUNetConfig, fk: dict) -> None:
    mc = cfg.model_channels
    m.time_embed_0 = Dense(mc, mc * 4, **fk)
    m.time_embed_2 = Dense(mc * 4, mc * 4, **fk)
    m.label_emb_0 = Dense(cfg.adm_in_channels, mc * 4, **fk)
    m.label_emb_2 = Dense(mc * 4, mc * 4, **fk)


def add_encoder(m: nn.Module, cfg: VideoUNetConfig, emb_dim: int, *, use_apm: bool,
                fk: dict, apm_tokens: int = 1) -> List[int]:
    """Input blocks (``input_{i}_res/attn/down``); returns the skip channels.
    ``apm_tokens``: the APM mixers' context length (with ``use_apm``)."""
    mc = cfg.model_channels
    chans = [mc]
    ch, ds, blk = mc, 1, 0
    for level, mult in enumerate(cfg.channel_mult):
        for _ in range(cfg.num_res_blocks):
            in_ch, ch = ch, mult * mc
            m.add_module(f"input_{blk}_res",
                         UNetVideoResBlock(in_ch, ch, emb_dim, cfg.video_kernel_size,
                                           cfg.use_checkpoint, **fk))
            if ds in cfg.attention_resolutions:
                m.add_module(f"input_{blk}_attn", make_transformer(
                    cfg, ch, use_apm=use_apm, apm_tokens=apm_tokens, fk=fk))
            chans.append(ch)
            blk += 1
        if level != len(cfg.channel_mult) - 1:
            ds *= 2
            m.add_module(f"input_{blk}_down", Downsample(ch, ch, **fk))
            chans.append(ch)
            blk += 1
    m.add_module("middle_res_0", UNetVideoResBlock(ch, ch, emb_dim, cfg.video_kernel_size,
                                                   cfg.use_checkpoint, **fk))
    m.add_module("middle_attn", make_transformer(cfg, ch, use_apm=use_apm,
                                                 apm_tokens=apm_tokens, fk=fk))
    m.add_module("middle_res_1", UNetVideoResBlock(ch, ch, emb_dim, cfg.video_kernel_size,
                                                   cfg.use_checkpoint, **fk))
    return chans


def run_encoder(m: nn.Module, cfg: VideoUNetConfig, h, emb, context, ind) -> tuple:
    """Input blocks + middle; returns (skips, mid activation)."""
    hs = [h]
    ds, blk = 1, 0
    for level, _ in enumerate(cfg.channel_mult):
        for _ in range(cfg.num_res_blocks):
            h = getattr(m, f"input_{blk}_res")(h, emb, ind)
            if ds in cfg.attention_resolutions:
                h = getattr(m, f"input_{blk}_attn")(h, context, ind)
            hs.append(h)
            blk += 1
        if level != len(cfg.channel_mult) - 1:
            ds *= 2
            h = per_frame(h, getattr(m, f"input_{blk}_down"))
            hs.append(h)
            blk += 1
    h = m.middle_res_0(h, emb, ind)
    h = m.middle_attn(h, context, ind)
    h = m.middle_res_1(h, emb, ind)
    return hs, h


class VideoUNet(nn.Module):
    """``apm_tokens``: with ``cfg.use_apm``, the context length the APM mixers
    take (1 + the anchor frames of ``InferenceConfig.apm_anchor_frames``); the
    mixers' conv has one in-channel per token."""

    def __init__(self, cfg: VideoUNetConfig, *, apm_tokens: int = 17, device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self.cfg = cfg
        mc = cfg.model_channels
        emb_dim = mc * 4
        add_embedding_params(self, cfg, fk)
        self.in_conv = Conv(cfg.in_channels, mc, 3, **fk)
        chans = add_encoder(self, cfg, emb_dim, use_apm=cfg.use_apm, apm_tokens=apm_tokens, fk=fk)
        if cfg.controlnet_mode:
            for i, c in enumerate(chans):
                self.add_module(f"cam_merger_input_{i}", CAMConditionalModel(c, min(64, c), **fk))
            self.cam_merger_mid = CAMConditionalModel(chans[-1], min(64, chans[-1]), **fk)
        ch = chans[-1]
        blk = 0
        ds_out = 2 ** (len(cfg.channel_mult) - 1)
        for level, mult in reversed(list(enumerate(cfg.channel_mult))):
            for i in range(cfg.num_res_blocks + 1):
                in_ch, ch = ch + chans.pop(), mc * mult
                self.add_module(f"output_{blk}_res", UNetVideoResBlock(
                    in_ch, ch, emb_dim, cfg.video_kernel_size, cfg.use_checkpoint, **fk))
                if ds_out in cfg.attention_resolutions:
                    self.add_module(f"output_{blk}_attn",
                                    make_transformer(cfg, ch, use_apm=cfg.use_apm,
                                                     apm_tokens=apm_tokens, fk=fk))
                if level and i == cfg.num_res_blocks:
                    ds_out //= 2
                    self.add_module(f"output_{blk}_up", Upsample(ch, ch, **fk))
                blk += 1
        norm_params(self, "out_norm", ch, **fk)
        self.out_conv = Conv(ch, cfg.out_channels, 3, zero_init=True, **fk)

    @span("st2v.unet")
    def forward(self, x: torch.Tensor, t_cont: torch.Tensor, context: Optional[torch.Tensor],
                y: Optional[torch.Tensor], image_only_indicator: Optional[torch.Tensor] = None,
                hs_control: Optional[Sequence[torch.Tensor]] = None,
                h_control_mid: Optional[torch.Tensor] = None) -> torch.Tensor:
        count("unet_calls")
        cfg = self.cfg
        b, t = x.shape[:2]
        dtype = cfg.dtypes.compute_dtype
        x = x.to(dtype)
        if image_only_indicator is None:
            image_only_indicator = torch.zeros((b, t), dtype=torch.bool, device=x.device)
        emb = embed(self, cfg, t_cont, y, b, t, dtype)
        if context is not None:
            context = context.to(dtype)

        hs, h = run_encoder(self, cfg, self.in_conv(x), emb, context, image_only_indicator)
        # CAM fusion of the ControlNet features (none for the first chunk)
        if cfg.controlnet_mode and hs_control is not None:
            hs = [getattr(self, f"cam_merger_input_{i}")(hk, hc)
                  for i, (hk, hc) in enumerate(zip(hs, hs_control))]
        if cfg.controlnet_mode and h_control_mid is not None:
            h = self.cam_merger_mid(h, h_control_mid)

        blk = 0
        ds_out = 2 ** (len(cfg.channel_mult) - 1)
        for level, _ in reversed(list(enumerate(cfg.channel_mult))):
            for i in range(cfg.num_res_blocks + 1):
                h = torch.cat([h, hs.pop()], dim=-1)
                h = getattr(self, f"output_{blk}_res")(h, emb, image_only_indicator)
                if ds_out in cfg.attention_resolutions:
                    h = getattr(self, f"output_{blk}_attn")(h, context, image_only_indicator)
                if level and i == cfg.num_res_blocks:
                    ds_out //= 2
                    h = per_frame(h, getattr(self, f"output_{blk}_up"))
                blk += 1

        # per-frame GroupNorm statistics
        h = per_frame(h, lambda z: group_norm(z, *norm_pair(self, "out_norm"), eps=1e-5, act="silu"))
        h = per_frame(h, self.out_conv)
        return h.float()
