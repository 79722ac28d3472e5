"""Stage 1, streaming image-to-video (counterpart of
``streamingt2v_tpu/pipeline/streaming.py``).

  1. The first chunk from the input image with the SVD-XT UNet
     (``controlnet_mode=False``) under the first-chunk EulerEDM sampler.
  2. Autoregressive chunks, each conditioned on the CLIP + VAE encoding of
     chunk 0's anchor frame and, through the ControlNet/CAM branch, on the
     last ``num_conditional_frames`` frames of the previous chunk; frames
     from ``num_conditional_frames`` on are kept.  With ``unet.use_apm`` the
     cross-attention context also carries one CLIP token per APM anchor
     frame of the video so far (``inference.apm_anchor_frames``): the
     16+1-token context that the UNet's APM mixers reduce to one token.
  3. Every chunk is decoded by the temporal VAE in chunks of
     ``decode_chunk_size`` frames.

All model weights stay resident on the device.  ``image_to_video`` runs
under the configuration's kernel routing (``PipelineConfig.routing``: the
JAX package's default kernels) and without autograd, so its per-frame
GroupNorms take K5.  Noise comes from a
``noise(generation, stream, shape)`` function (``utils/rng.py``), so a
caller can inject the draws of another implementation.

With a ``mesh`` (``build_pipeline(mesh=)``, whose models
``shard_stage1_models`` split over ``model``) the network calls run under
it: the CFG-doubled batch splits over ``data`` and the transformers over
``seq`` and ``model`` (``models/wrappers.py``); everything else, the
conditioning, the sampler and the decode, runs whole on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.func import functional_call

from streamingt2v_torch.config import PipelineConfig, SamplerConfig
from streamingt2v_torch.diffusion.denoiser import denoise
from streamingt2v_torch.diffusion.samplers import make_sampler
from streamingt2v_torch.models.conditioner import Conditioner, broadcast_cond
from streamingt2v_torch.models.controlnet import ControlNet
from streamingt2v_torch.models.vae import AutoencoderKL
from streamingt2v_torch.models.video_unet import VideoUNet
from streamingt2v_torch.models.wrappers import openai_wrapper, streaming_wrapper
from streamingt2v_torch.ops.routing import use_routing
from streamingt2v_torch.utils.profiling import count, span
from streamingt2v_torch.utils.rng import GeneratorNoise, NoiseFn, StepNoiseFn, step_stream

Cond = Dict[str, torch.Tensor]


@dataclasses.dataclass
class StreamingModels:
    """The stage-1 modules, weights included."""

    unet: VideoUNet             # streaming UNet (controlnet_mode=True)
    controlnet: ControlNet
    svd_unet: VideoUNet         # first-chunk SVD-XT (controlnet_mode=False)
    vae: AutoencoderKL          # first stage (temporal decoder)
    conditioner: Conditioner


class Stage1Pipeline:
    def __init__(self, cfg: PipelineConfig, models: StreamingModels, mesh=None):
        self.cfg = cfg
        self.models = models
        self.mesh = mesh

    @property
    def device(self) -> torch.device:
        return self.models.vae.encoder.conv_in.kernel.device

    def latent_shape(self, num_frames: int) -> tuple:
        cfg = self.cfg
        f = cfg.vae.downsample_factor
        return (1, num_frames, cfg.height // f, cfg.width // f, cfg.unet.out_channels)

    # ---------- the stages ----------

    @span("st2v.condition")
    def condition(self, anchor_frame: torch.Tensor, aug_noise: torch.Tensor,
                  apm_tokens: Optional[torch.Tensor] = None) -> tuple:
        """anchor (1, H, W, 3) + uniform noise of its shape -> (c, uc), each
        broadcast to the chunk's frames.  The augmentation is uniform noise,
        as the reference's torch.rand_like.  ``apm_tokens`` (1, N, D) are
        appended to c's crossattn token, zeros of their shape to uc's."""
        inf = self.cfg.inference
        b = anchor_frame.shape[0]
        dev = anchor_frame.device
        batch = {
            "cond_frames_without_noise": anchor_frame,
            "cond_frames": anchor_frame + inf.cond_aug * aug_noise,
            "fps_id": torch.full((b,), float(inf.fps_id), device=dev),
            "motion_bucket_id": torch.full((b,), float(inf.motion_bucket_id), device=dev),
            "cond_aug": torch.full((b,), inf.cond_aug, device=dev),
        }
        c, uc = self.models.conditioner.pair(batch)
        if apm_tokens is not None:
            c["crossattn"] = torch.cat([c["crossattn"], apm_tokens], dim=1)
            uc["crossattn"] = torch.cat([uc["crossattn"], torch.zeros_like(apm_tokens)], dim=1)
        return broadcast_cond(c, inf.chunk_frames), broadcast_cond(uc, inf.chunk_frames)

    def apm_frames(self, chunks: List[torch.Tensor]) -> torch.Tensor:
        """The APM anchor frames of the video so far (the kept frames of every
        chunk), (1, N, H, W, 3): frames ``apm_anchor_frames`` = [a, b), each
        index wrapped around the video's length (a short video repeats)."""
        a, b = self.cfg.inference.apm_anchor_frames
        starts = np.cumsum([0] + [c.shape[1] for c in chunks])
        total = int(starts[-1])
        frames = []
        for i in range(a, b):
            gi = i % total
            ci = int(np.searchsorted(starts, gi, side="right")) - 1
            frames.append(chunks[ci][:, gi - int(starts[ci])])
        return torch.stack(frames, dim=1)

    def encode_apm(self, frames: torch.Tensor) -> torch.Tensor:
        """APM anchor frames (1, N, H, W, 3) -> their CLIP tokens (1, N, D)."""
        return self.models.conditioner.encode_frames(frames)

    def _sample(self, network_fn, noise: torch.Tensor, c: Cond, uc: Cond,
                sampler_cfg: SamplerConfig, step_noise: Optional[StepNoiseFn]) -> torch.Tensor:
        sampler = make_sampler(sampler_cfg)
        return sampler(lambda x, sigma, cond: denoise(network_fn, x, sigma, cond), noise, c, uc,
                       step_noise)

    @span("st2v.chunk")
    def first_chunk(self, c: Cond, uc: Cond, noise: torch.Tensor,
                    step_noise: Optional[StepNoiseFn] = None) -> torch.Tensor:
        """(c, uc) + initial noise -> latents (1, T, h, w, 4); ``step_noise``:
        a stochastic sampler's per-step draws."""
        return self._sample(openai_wrapper(self.models.svd_unet, mesh=self.mesh), noise, c, uc,
                            self.cfg.first_chunk_sampler, step_noise)

    @span("st2v.chunk")
    def stream_chunk(self, c: Cond, uc: Cond, noise: torch.Tensor,
                     step_noise: Optional[StepNoiseFn] = None) -> torch.Tensor:
        """(c, uc) with ctrl_frames + initial noise -> latents (1, T, h, w, 4)."""
        m = self.models
        net = streaming_wrapper(m.unet, m.controlnet, self.cfg.inference.num_conditional_frames,
                                ctrl_cfg_shared=True, mesh=self.mesh)
        return self._sample(net, noise, c, uc, self.cfg.sampler, step_noise)

    def decode_chunk(self, z: torch.Tensor) -> torch.Tensor:
        """z (1, <=cs, h, w, 4) -> frames in [-1, 1], f32.  With
        ``vae_decode_bf16`` the decoder runs on a bf16 cast of its weights."""
        count("decode_pieces")
        vae = self.models.vae
        z = z / vae.cfg.scale_factor
        params = None
        if self.cfg.inference.vae_decode_bf16:
            params = {n: p.to(torch.bfloat16) if p.dtype == torch.float32 else p
                      for n, p in vae.decoder.named_parameters()}
            z = z.to(torch.bfloat16)
        with span("st2v.vae_decoder"):
            count("vae_decoder_calls")
            out = vae.decoder(z) if params is None else functional_call(vae.decoder, params, (z,))
        return out.float().clamp(-1.0, 1.0)

    @span("st2v.decode")
    def decode_video(self, z: torch.Tensor) -> torch.Tensor:
        cs = self.cfg.inference.decode_chunk_size
        return torch.cat([self.decode_chunk(z[:, s:s + cs]) for s in range(0, z.shape[1], cs)],
                         dim=1)

    # ---------- public API ----------

    @torch.inference_mode()
    def image_to_video(self, image: torch.Tensor, num_frames: Optional[int] = None,
                       seed: Optional[int] = None,
                       noise: Optional[NoiseFn] = None) -> torch.Tensor:
        """image (H, W, 3) in [-1, 1] -> video (F, H, W, 3) in [-1, 1].

        ``num_frames`` is the stage-1 target ((num_frames+1)//2 of the
        product); ``noise`` overrides the default generator-backed draws
        (a stochastic sampler's step draws included: streams "sampler/<i>")."""
        with use_routing(self.cfg.routing):
            return self._image_to_video(image, num_frames, seed, noise)

    def _image_to_video(self, image, num_frames, seed, noise) -> torch.Tensor:
        cfg = self.cfg
        inf = cfg.inference
        seed = cfg.seed if seed is None else seed
        target = num_frames if num_frames is not None else cfg.stage1_frames
        n_gen = cfg.n_autoregressions(target)
        if noise is None:
            noise = GeneratorNoise(seed, self.device, inf.reset_seed_per_generation)
        shape = self.latent_shape(inf.chunk_frames)

        image = image[None].to(self.device, torch.float32)
        c, uc = self.condition(image, noise(0, "cond_aug", tuple(image.shape)).to(self.device))
        z0 = self.first_chunk(c, uc, noise(0, "latent", shape).to(self.device),
                              step_stream(noise, 0))
        chunk0 = self.decode_video(z0)
        chunks: List[torch.Tensor] = [chunk0]
        anchor = chunk0[:, inf.anchor_frames]
        for g in range(1, n_gen + 1):
            ctrl = chunks[-1][:, -inf.num_conditional_frames:]
            apm = self.encode_apm(self.apm_frames(chunks)) if cfg.unet.use_apm else None
            c, uc = self.condition(anchor, noise(g, "cond_aug", tuple(anchor.shape)).to(self.device),
                                   apm)
            c["ctrl_frames"] = ctrl
            uc["ctrl_frames"] = ctrl
            z = self.stream_chunk(c, uc, noise(g, "latent", shape).to(self.device),
                                  step_stream(noise, g))
            chunks.append(self.decode_video(z)[:, inf.num_conditional_frames:])
        return torch.cat(chunks, dim=1)[0, :target]
