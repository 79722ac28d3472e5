"""The SVD conditioning stack (counterpart of
``streamingt2v_tpu/models/conditioner.py``):

  cond_frames_without_noise -> CLIP pooled embedding      -> crossattn
  fps_id / motion_bucket_id / cond_aug -> sinusoidal embeds -> vector
  cond_frames (noise-augmented anchor) -> KL-VAE mode encode -> concat

Outputs carry no frame axis; ``broadcast_cond`` expands them to (B, T, ...).
The unconditional half zeroes crossattn and concat.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
from torch import nn

from streamingt2v_torch.config import ConditionerConfig, VAEConfig
from streamingt2v_torch.models.clip import CLIPVisionConfig, CLIPVisionTower, encode_image
from streamingt2v_torch.models.layers import Dense
from streamingt2v_torch.models.vae import AutoencoderKL
from streamingt2v_torch.ops import timestep_embedding


def concat_timestep_embed(x: torch.Tensor, outdim: int) -> torch.Tensor:
    """Embed each scalar column independently and concatenate:
    (B,) or (B, D) -> (B, D*outdim)."""
    if x.ndim == 1:
        x = x[:, None]
    b, d = x.shape
    return timestep_embedding(x.reshape(-1), outdim).reshape(b, d * outdim)


class Conditioner(nn.Module):
    """CLIP tower (or the tiny configs' ``toy_clip`` projection) and the
    conditioning KL-VAE encoder.  Batch keys, all (B, ...):
    cond_frames_without_noise and cond_frames (B, H, W, 3) in [-1, 1];
    fps_id, motion_bucket_id, cond_aug (B,)."""

    def __init__(self, cfg: ConditionerConfig, vae_cfg: VAEConfig,
                 clip_cfg: CLIPVisionConfig = CLIPVisionConfig(), *, device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self.cfg = cfg
        if cfg.use_clip:
            self.clip = CLIPVisionTower(clip_cfg, **fk)
        else:
            self.toy_clip = Dense(3, cfg.clip_embed_dim, **fk)
        vcfg = dataclasses.replace(vae_cfg, temporal_decoder=False, scale_factor=1.0)
        self.cond_encoder = AutoencoderKL(vcfg, use_quant_conv=True, encode_only=True, **fk)

    def _pooled(self, img: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) in [-1, 1] -> the pooled CLIP embedding (N, D)."""
        if self.cfg.use_clip:
            return encode_image(self.clip, img)[0]
        return self.toy_clip(img.mean(dim=(1, 2)))  # tiny configs: mean pixel statistics

    def forward(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        pooled = self._pooled(batch["cond_frames_without_noise"])
        vec = torch.cat([concat_timestep_embed(batch[k], self.cfg.vector_outdim)
                         for k in ("fps_id", "motion_bucket_id", "cond_aug")], dim=-1)
        z = self.cond_encoder.encode(batch["cond_frames"])
        return {"crossattn": pooled[:, None, :], "vector": vec, "concat": z}

    def pair(self, batch: Dict[str, torch.Tensor]) -> Tuple[Dict[str, torch.Tensor], ...]:
        """(c, uc): uc is c with the image inputs' outputs (crossattn and
        concat) zeroed, so the encoders run once."""
        c = self(batch)
        uc = dict(c, crossattn=torch.zeros_like(c["crossattn"]),
                  concat=torch.zeros_like(c["concat"]))
        return c, uc

    def encode_frames(self, frames: torch.Tensor) -> torch.Tensor:
        """The APM tokens: the pooled CLIP embedding of each anchor frame of
        the video so far, (B, N, H, W, 3) -> (B, N, D)."""
        b, n = frames.shape[:2]
        return self._pooled(frames.reshape((b * n,) + frames.shape[2:])).reshape(b, n, -1)


def broadcast_cond(cond: Dict[str, torch.Tensor], num_frames: int) -> Dict[str, torch.Tensor]:
    """crossattn (B,1,D)->(B,T,1,D); vector (B,D)->(B,T,D);
    concat (B,h,w,4)->(B,T,h,w,4)."""
    out = dict(cond)
    for k in ("crossattn", "vector", "concat"):
        v = cond[k]
        out[k] = v[:, None].expand((v.shape[0], num_frames) + v.shape[1:])
    return out
