"""ControlNet, the CAM encoder branch (counterpart of
``streamingt2v_tpu/models/controlnet.py``): a copy of the VideoUNet
encoder + mid run on the conditional frames, with a pixel-space
conditioning embedder whose output is added after the input conv.
Returns every encoder skip activation plus the mid activation."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from streamingt2v_torch.config import ControlNetConfig, VideoUNetConfig
from streamingt2v_torch.models.layers import Conv, norm_pair, norm_params, per_frame
from streamingt2v_torch.models.video_unet import (
    add_embedding_params, add_encoder, embed, run_encoder)
from streamingt2v_torch.ops import layer_norm
from streamingt2v_torch.utils.profiling import count, span


class ControlNetConditioningEmbedding(nn.Module):
    """Pixel-space control-frame encoder: (N, H, W, 3) -> (N, H/8, W/8, C)."""

    def __init__(self, embed_channels: int,
                 block_out_channels: Tuple[int, ...] = (32, 96, 256, 512),
                 downsample: bool = True, use_normalization: bool = True, *,
                 device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self.n_stages = len(block_out_channels) - 1
        self.use_normalization = use_normalization
        stride = 2 if downsample else 1
        self.conv_in = Conv(3, block_out_channels[0], 3, **fk)
        k = 0
        for i in range(self.n_stages):
            c_in, c_out = block_out_channels[i], block_out_channels[i + 1]
            self.add_module(f"block_{2 * i}", Conv(c_in, c_in, 3, **fk))
            # symmetric padding 1 on the strided conv, as torch pads
            self.add_module(f"block_{2 * i + 1}",
                            Conv(c_in, c_out, 3, stride=stride, padding=1, **fk))
            if use_normalization:
                norm_params(self, f"norm_{k}", c_in, **fk)
                norm_params(self, f"norm_{k + 1}", c_out, **fk)
                k += 2
        self.conv_out = Conv(block_out_channels[-1], embed_channels, 3, zero_init=True, **fk)

    @span("st2v.embed")
    def forward(self, x):
        h = F.silu(self.conv_in(x))
        k = 0
        for i in range(self.n_stages):
            for j in (2 * i, 2 * i + 1):
                h = getattr(self, f"block_{j}")(h)
                if self.use_normalization:
                    h = layer_norm(h, *norm_pair(self, f"norm_{k}"))
                    k += 1
                h = F.silu(h)
        return self.conv_out(h)


class ControlNet(nn.Module):
    """Encoder + mid copy of the VideoUNet; ``unet_cfg`` is the base UNet's."""

    def __init__(self, unet_cfg: VideoUNetConfig, cfg: ControlNetConfig, *,
                 device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self.unet_cfg = unet_cfg
        mc = unet_cfg.model_channels
        add_embedding_params(self, unet_cfg, fk)
        self.cond_embedding = ControlNetConditioningEmbedding(
            mc, cfg.conditioning_embedding_out_channels, cfg.downsample_controlnet_cond,
            cfg.use_image_encoder_normalization, **fk)
        self.in_conv = Conv(unet_cfg.in_channels, mc, 3, **fk)
        add_encoder(self, unet_cfg, mc * 4, use_apm=False, fk=fk)

    @span("st2v.controlnet")
    def forward(self, x: torch.Tensor, t_cont: torch.Tensor, context: Optional[torch.Tensor],
                y: Optional[torch.Tensor], controlnet_cond: torch.Tensor,
                image_only_indicator: Optional[torch.Tensor] = None):
        """x (B, F_cond, h, w, C_in); controlnet_cond (B', F_cond, H, W, 3)
        pixel frames, where B' may be 1 when the CFG halves share them (the
        embedding is then repeated up to B)."""
        count("controlnet_calls")
        ucfg = self.unet_cfg
        b, t = x.shape[:2]
        dtype = ucfg.dtypes.compute_dtype
        x = x.to(dtype)
        if image_only_indicator is None:
            image_only_indicator = torch.zeros((b, t), dtype=torch.bool, device=x.device)
        emb = embed(self, ucfg, t_cont, y, b, t, dtype)
        if context is not None:
            context = context.to(dtype)
        cond_embed = per_frame(controlnet_cond.to(dtype), self.cond_embedding)
        if cond_embed.shape[0] != b:
            if b % cond_embed.shape[0]:
                raise ValueError(f"ctrl frames batch {cond_embed.shape[0]} does not divide {b}")
            cond_embed = cond_embed.repeat((b // cond_embed.shape[0],) + (1,) * (cond_embed.ndim - 1))
        h = self.in_conv(x) + cond_embed  # Merger, merge_mode 'addition'
        return run_encoder(self, ucfg, h, emb, context, image_only_indicator)
