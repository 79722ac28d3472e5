"""Wan2.1 image-to-video denoising (``wan/image2video.py``
``WanI2V.generate`` with ``FlowUniPCMultistepScheduler``): from the umT5
prompt embeddings, the CLIP image features and the VAE latent of the
conditioning clip to the latents of the video.

The conditioning y is [mask; image latent]: the mask is 1 on the first of
the ``frames`` pixel frames and 0 on the others, the first repeated 4 times
and the 4 + (frames - 1) frames viewed as (latent frames, 4) and put on
channels, so it is 1 on every channel of latent frame 0 and 0 elsewhere.
Each step runs the transformer once on the batch [negative; positive] (the
two CFG halves in one call; only the text differs), guides the flow
prediction v_u + g (v_c - v_u) in f32 and takes the UniPC step
(``diffusion/flow_unipc.py``) with the state the previous step left.  The
latents stay f32 between steps.
"""

from __future__ import annotations

from typing import Tuple

import torch

from streamingt2v_torch.config import WanConfig
from streamingt2v_torch.diffusion.flow_unipc import FlowUniPCScheduler, UniPCState
from streamingt2v_torch.models.wan import WanTransformer3D
from streamingt2v_torch.utils.profiling import count, span


def first_frame_mask(cfg: WanConfig, device=None) -> torch.Tensor:
    """The (1, 4, latent frames, H, W) mask of ``image2video.py``: the
    pixel frames' mask (first frame 1), the first repeated 4 times, viewed
    as (latent frames, 4) and moved to channels."""
    _, _, f, h, w = cfg.latent_shape()
    stride = cfg.vae_stride[0]
    msk = torch.zeros(1, cfg.frames, h, w, device=device)
    msk[:, 0] = 1
    msk = torch.cat([msk[:, :1].repeat_interleave(stride, dim=1), msk[:, 1:]], dim=1)
    return msk.view(1, f, stride, h, w).transpose(1, 2)


class WanI2VPipeline:
    def __init__(self, cfg: WanConfig, transformer: WanTransformer3D):
        self.cfg = cfg
        self.transformer = transformer
        self.scheduler = FlowUniPCScheduler(cfg.scheduler, cfg.num_steps)

    def timesteps(self) -> list:
        return list(self.scheduler.timesteps)

    def condition(self, image_latent: torch.Tensor) -> torch.Tensor:
        """y = [mask; image latent], (B, 4 + C, F, H, W), of the VAE latent
        (B, C, F, H, W) of [image; zero frames]."""
        msk = first_frame_mask(self.cfg, image_latent.device).to(image_latent.dtype)
        return torch.cat([msk.expand(image_latent.shape[0], -1, -1, -1, -1), image_latent], dim=1)

    @span("st2v.step")
    def denoise_step(self, latents: torch.Tensor, state: UniPCState, i: int,
                     prompt_embeds: torch.Tensor, negative_embeds: torch.Tensor,
                     clip_features: torch.Tensor,
                     y: torch.Tensor) -> Tuple[torch.Tensor, UniPCState]:
        """One guided UniPC step of step index ``i``: latents (B, C, F, H, W)
        and the scheduler's state -> f32 latents of the next step and its
        state.  The prompt and negative embeddings may have different
        lengths (the model pads both)."""
        count("steps")
        t = self.scheduler.timesteps[i]
        n = self.cfg.text_len
        pad = torch.nn.functional.pad
        text = torch.cat([pad(negative_embeds, (0, 0, 0, n - negative_embeds.shape[1])),
                          pad(prompt_embeds, (0, 0, 0, n - prompt_embeds.shape[1]))])
        tt = torch.full((2 * latents.shape[0],), t, dtype=torch.int64, device=latents.device)
        v_u, v_c = self.transformer(torch.cat([latents, latents]), tt, text,
                                    torch.cat([clip_features, clip_features]),
                                    torch.cat([y, y])).chunk(2)
        v = v_u + self.cfg.guidance_scale * (v_c - v_u)
        return self.scheduler.step(v, i, latents, state)

    def generate(self, prompt_embeds: torch.Tensor, negative_embeds: torch.Tensor,
                 clip_features: torch.Tensor, image_latent: torch.Tensor,
                 noise: torch.Tensor) -> torch.Tensor:
        """The video's latents (B, C, F, H, W), f32, from ``noise`` of that
        shape over the configuration's steps."""
        latents, state = noise.float(), UniPCState()
        with torch.inference_mode():
            y = self.condition(image_latent)
            for i in range(self.cfg.num_steps):
                latents, state = self.denoise_step(latents, state, i, prompt_embeds,
                                                   negative_embeds, clip_features, y)
        return latents
