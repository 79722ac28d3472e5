"""CogVideoX text-to-video denoising (diffusers ``CogVideoXPipeline`` with
``CogVideoXDDIMScheduler``): from T5 prompt embeddings and initial noise to
the latents of the clip.

Each step runs the transformer once on the batch [negative; positive] (the
two CFG halves in one call), guides the v-prediction v_u + g (v_c - v_u) in
f32 and takes the deterministic DDIM update (``diffusion/ddim.py``, whose
v-prediction step is the CogVideoX scheduler's eta = 0 update written
through eps).  The latents stay f32 between steps.  No chunks, no
conditioning frames, no blending: one clip of the configuration's frames
at once.  Every call runs under the configuration's kernel routing.
"""

from __future__ import annotations

import torch

from streamingt2v_torch.config import CogVideoXConfig
from streamingt2v_torch.diffusion.ddim import DDIMScheduler
from streamingt2v_torch.models.cogvideox import CogVideoXTransformer3D
from streamingt2v_torch.ops.routing import use_routing
from streamingt2v_torch.utils.profiling import count, span


class CogVideoXPipeline:
    def __init__(self, cfg: CogVideoXConfig, transformer: CogVideoXTransformer3D):
        self.cfg = cfg
        self.transformer = transformer
        self.scheduler = DDIMScheduler(cfg.scheduler)

    def timesteps(self) -> list:
        return [int(t) for t in self.scheduler.timesteps(self.cfg.num_steps)]

    @span("st2v.step")
    def denoise_step(self, latents: torch.Tensor, i: int, t: int, prompt_embeds: torch.Tensor,
                     negative_embeds: torch.Tensor) -> torch.Tensor:
        """One guided DDIM step of step index ``i`` at timestep ``t``:
        latents (B, F, C, H, W) -> f32 latents of the next timestep."""
        count("steps")
        b = latents.shape[0]
        x = torch.cat([latents, latents])
        text = torch.cat([negative_embeds, prompt_embeds])
        tt = torch.full((2 * b,), int(t), dtype=torch.int64, device=latents.device)
        v_u, v_c = self.transformer(x, text, tt).chunk(2)
        v = v_u + self.cfg.guidance_scale * (v_c - v_u)
        return self.scheduler.step(v, t, latents.float(), self.cfg.num_steps)

    def generate(self, prompt_embeds: torch.Tensor, negative_embeds: torch.Tensor,
                 noise: torch.Tensor) -> torch.Tensor:
        """The clip's latents (B, F, C, H, W), f32, from ``noise`` of that
        shape (the scheduler's initial sigma is 1) over the configuration's
        steps."""
        latents = noise.float()
        with torch.inference_mode(), use_routing(self.cfg.routing):
            for i, t in enumerate(self.timesteps()):
                latents = self.denoise_step(latents, i, t, prompt_embeds, negative_embeds)
        return latents
