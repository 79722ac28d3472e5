"""CAM fusion (counterpart of ``streamingt2v_tpu/models/cam.py``): per-pixel
temporal cross-attention merging ControlNet features into the base UNet's
skips.  Query = the UNet activation, every pixel attending over frames;
key/value = the ControlNet activation over the F_cond conditional frames
at the same pixel; zero-initialised proj_out."""

from __future__ import annotations

import torch
from torch import nn

from streamingt2v_torch.models.layers import Dense, norm_pair, norm_params
from streamingt2v_torch.ops import group_norm
from streamingt2v_torch.ops.attention import attention_pre_split


class CAMConditionalModel(nn.Module):
    """Fuse ``sample`` (B, F, H, W, C) with ``conditioning`` (B, F_cond, H, W, C)."""

    def __init__(self, channels: int, attention_head_dim: int = 64, *, device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        c = channels
        self.attention_head_dim = attention_head_dim
        norm_params(self, "norm", c, **fk)
        self.proj_in = Dense(c, c, **fk)
        self.to_q = Dense(c, c, bias=False, **fk)
        self.to_k = Dense(c, c, bias=False, **fk)
        self.to_v = Dense(c, c, bias=False, **fk)
        self.to_out = Dense(c, c, **fk)
        self.proj_out = Dense(c, c, zero_init=True, **fk)

    def forward(self, sample: torch.Tensor, conditioning: torch.Tensor) -> torch.Tensor:
        b, f, h, w, c = sample.shape
        f_cond = conditioning.shape[1]
        d = self.attention_head_dim
        heads = c // d
        s = h * w

        def fold(z, fz):  # (b f) s (h d) -> (b s h) f d
            return z.reshape(b, fz, s, heads, d).permute(0, 2, 3, 1, 4).reshape(b * s * heads, fz, d)

        # GroupNorm over (F, H, W) per channel group
        hn = group_norm(sample, *norm_pair(self, "norm"), eps=1e-6)
        hn = self.proj_in(hn.reshape(b, f, s, c))
        kv = conditioning.reshape(b, f_cond, s, c)
        o = attention_pre_split(fold(self.to_q(hn), f), fold(self.to_k(kv), f_cond),
                                fold(self.to_v(kv), f_cond))
        o = o.reshape(b, s, heads, f, d).permute(0, 3, 1, 2, 4).reshape(b, f, s, c)
        residual = self.proj_out(self.to_out(o))
        return sample + residual.reshape(b, f, h, w, c)
