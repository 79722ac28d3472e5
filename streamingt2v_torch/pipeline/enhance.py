"""Stage 2, I2VGen-XL enhancement by SDEdit with randomized blending
(counterpart of ``streamingt2v_tpu/pipeline/enhance.py``).

  - the video is VAE-encoded (sampled) and noised at the strength-truncated
    first DDIM timestep;
  - every chunk is conditioned on its key frame: the CLIP image embedding
    of a centre crop resized bilinearly to 224, and the key frame's VAE
    latent followed by frame-position masks;
  - each DDIM step denoises the overlapping chunks one after another, each
    with classifier-free guidance over two UNet calls (unconditional, then
    conditional), and writes each chunk back from a random offset inside the
    overlap;
  - ``enhance_with_keyframe_prepass`` first enhances the chunk-start key
    frames as a short video conditioned on the input image.

Draws come from an ``EnhanceNoise`` (``utils/rng.py``), so a caller can
inject those of another implementation.  Every call runs under the
pipeline's kernel routing (``EnhanceConfig.routing``).  All weights stay
resident on the device; the JAX package's residency and offload machinery,
its one-program compile granularity and its out-of-memory ladder around
decode are TPU-platform measures and are not ported.

With a mesh of more than one rank, each DDIM step runs every (chunk, CFG
half) UNet call of the step as one batch split over the ``data`` ranks
(``_denoise_step_dp``); the rest runs whole on every rank.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
from typing import List, Optional, Sequence

import torch

from streamingt2v_torch.config import EnhanceConfig
from streamingt2v_torch.diffusion.ddim import DDIMScheduler
from streamingt2v_torch.models.clip import CLIPVisionTower, clip_preprocess, resize
from streamingt2v_torch.models.clip_text import CLIPTextTower, CLIPTokenizer
from streamingt2v_torch.models.enhance.unet import I2VGenXLUNet
from streamingt2v_torch.models.vae import AutoencoderKL
from streamingt2v_torch.ops.routing import use_routing
from streamingt2v_torch.parallel.sharding import batch_rows, data_parallel, gather
from streamingt2v_torch.utils.profiling import count, span
from streamingt2v_torch.utils.rng import EnhanceNoise, GeneratorEnhanceNoise


@dataclasses.dataclass
class EnhanceModels:
    """The stage-2 modules, weights included."""

    unet: I2VGenXLUNet
    vae: AutoencoderKL            # spatial SD VAE with quant convs
    clip_vision: CLIPVisionTower
    text_encoder: CLIPTextTower
    scheduler: DDIMScheduler
    tokenizer: Optional[CLIPTokenizer] = None


def center_crop_wide(img: torch.Tensor, target_wh) -> torch.Tensor:
    """The reference's ``_center_crop_wide`` for (H, W, C) tensors."""
    tw, th = target_wh
    h, w = img.shape[:2]
    y0 = max(0, (h - th) // 2)
    x0 = max(0, (w - tw) // 2)
    return img[y0:y0 + th, x0:x0 + tw]


def _routed(fn):
    """Run a public method without autograd and under the pipeline's routing."""
    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        with torch.inference_mode(), use_routing(self.cfg.routing):
            return fn(self, *args, **kwargs)
    return wrapper


class EnhancePipeline:
    def __init__(self, cfg: EnhanceConfig, models: EnhanceModels, mesh=None):
        self.cfg = cfg
        self.m = models
        self.mesh = mesh
        # the reference runs the whole i2vgen pipeline, VAE included, in fp16;
        # with vae_bf16 the VAE runs on a bf16 copy of its weights
        self.vae = (copy.deepcopy(models.vae).to(torch.bfloat16) if cfg.vae_bf16
                    else models.vae)

    @property
    def device(self) -> torch.device:
        return self.m.unet.conv_in.kernel.device

    @property
    def _vae_dtype(self) -> torch.dtype:
        return self.vae.encoder.conv_in.kernel.dtype

    # ---------- conditioning ----------

    @_routed
    def encode_prompts(self, prompt: Optional[str] = None,
                       negative_prompt: Optional[str] = None) -> torch.Tensor:
        """-> (2, L, width): negative then positive last hidden states."""
        if self.m.tokenizer is None:
            raise ValueError("no tokenizer: pass precomputed prompt_embeds")
        prompt = self.cfg.prompt if prompt is None else prompt
        negative_prompt = self.cfg.negative_prompt if negative_prompt is None else negative_prompt
        ids = torch.from_numpy(self.m.tokenizer([negative_prompt, prompt]).astype("int64"))
        return self.m.text_encoder(ids.to(self.device))

    def _latent_hw(self, h: int, w: int) -> tuple:
        f = self.vae.cfg.downsample_factor
        return h // f, w // f

    @span("st2v.condition")
    def _key_image_cond(self, image: torch.Tensor, noise: torch.Tensor, num_frames: int):
        """Key frame (H, W, 3) -> CLIP embeddings (2, D) (zeros, then the
        image's) and image latents (2, T, h, w, 4): its sampled VAE latent
        followed by frame-position masks."""
        cfg = self.cfg
        image = image.to(self.device, torch.float32)
        clip_size = self.m.clip_vision.cfg.image_size
        sq = resize(center_crop_wide(image, (cfg.width, cfg.width))[None], clip_size, clip_size,
                    "bilinear")
        pooled, _ = self.m.clip_vision(clip_preprocess(sq, clip_size))
        clip_emb = torch.cat([torch.zeros_like(pooled), pooled], dim=0)
        img = center_crop_wide(image, (cfg.width, cfg.height))[None]
        z = self.vae.encode(img.to(self._vae_dtype), noise).float()
        ramp = torch.arange(1, num_frames, dtype=torch.float32, device=z.device) / (num_frames - 1)
        masks = ramp.reshape(1, -1, 1, 1, 1).expand((1, num_frames - 1) + z.shape[1:])
        il = torch.cat([z[:, None], masks], dim=1)
        return clip_emb, torch.cat([il, il], dim=0)

    # ---------- core denoise ----------

    def _denoise_chunk(self, latents_chunk, t: int, prompt_embeds, clip_emb, image_latents):
        """One CFG-guided DDIM step on one chunk (1, T, h, w, 4); the two
        halves run one after the other."""
        m = self.m
        dev = latents_chunk.device
        t_vec = torch.full((1,), int(t), dtype=torch.int32, device=dev)
        fps_vec = torch.full((1,), float(self.cfg.fps), device=dev)
        eps_u, eps_c = (m.unet(latents_chunk, t_vec, fps_vec, image_latents[i:i + 1],
                               clip_emb[i:i + 1], prompt_embeds[i:i + 1]) for i in (0, 1))
        eps = eps_u + self.cfg.guidance_scale * (eps_c - eps_u)
        return m.scheduler.step(eps, t, latents_chunk, self.cfg.num_steps)

    @span("st2v.step")
    def _denoise_step(self, latents, si: int, t: int, prompt_embeds, clip_embs, image_latents,
                      noise: EnhanceNoise, *, chunk_size: int, stride: int, overlap_size: int):
        """One DDIM step over all chunks, one chunk's two UNet calls after
        another, written back by ``_write_back``."""
        count("steps")
        denoised = torch.cat([
            self._denoise_chunk(latents[:, ci * stride:ci * stride + chunk_size], t,
                                prompt_embeds, clip_embs[ci], image_latents[ci])
            for ci in range(clip_embs.shape[0])])
        return self._write_back(latents, denoised, si, noise, chunk_size=chunk_size,
                                stride=stride, overlap_size=overlap_size)

    @staticmethod
    def _write_back(latents, denoised, si: int, noise: EnhanceNoise, *, chunk_size: int,
                    stride: int, overlap_size: int):
        """``latents`` with each chunk's denoised frames (``denoised``: one
        chunk a row) written in turn; chunk ci > 0 keeps the frames of the
        already written chunk below its random offset."""
        new = latents.clone()
        for ci in range(denoised.shape[0]):
            start = ci * stride
            chunk = denoised[ci:ci + 1].clone()
            if overlap_size > 0 and ci > 0:
                offset = noise.offset(si, ci, overlap_size)
                chunk[:, :offset] = new[:, start:start + offset]
            new[:, start:start + chunk_size] = chunk
        return new

    @span("st2v.step")
    def _denoise_step_dp(self, latents, si: int, t: int, prompt_embeds, clip_embs, image_latents,
                         noise: EnhanceNoise, *, chunk_size: int, stride: int, overlap_size: int):
        """``_denoise_step`` with all 2 * n_chunks UNet calls as one batch,
        split over the mesh's data ranks: the unconditional halves of every
        chunk first, then the conditional ones (the JAX package's order,
        ``streamingt2v_tpu/pipeline/enhance.py:306-360``).  The guided
        results are then written back as the sequential step writes them
        (``_write_back``), so the two steps agree to rounding."""
        count("steps")
        m = self.m
        n = clip_embs.shape[0]
        chunks = torch.cat([latents[:, ci * stride:ci * stride + chunk_size] for ci in range(n)])
        xb = torch.cat([chunks, chunks])
        ce = torch.cat([clip_embs[:, 0], clip_embs[:, 1]])
        il = torch.cat([image_latents[:, 0], image_latents[:, 1]])
        pe = torch.cat([prompt_embeds[i:i + 1].expand((n,) + prompt_embeds.shape[1:])
                        for i in (0, 1)])
        b = 2 * n
        t_vec = torch.full((b,), int(t), dtype=torch.int32, device=xb.device)
        fps_vec = torch.full((b,), float(self.cfg.fps), device=xb.device)
        with data_parallel(self.mesh, b) as split:
            eps_all = m.unet(*(batch_rows(split, b, v) for v in (xb, t_vec, fps_vec, il, ce, pe)))
            if split:
                eps_all = gather(eps_all, "batch")
        eps_u, eps_c = eps_all[:n], eps_all[n:]
        eps = eps_u + self.cfg.guidance_scale * (eps_c - eps_u)
        return self._write_back(latents, m.scheduler.step(eps, t, chunks, self.cfg.num_steps),
                                si, noise, chunk_size=chunk_size, stride=stride,
                                overlap_size=overlap_size)

    # ---------- video latents ----------

    def _vae_chunk_frames(self, h: int, w: int, kind: str = "decode") -> int:
        """Frames per VAE call, as the JAX package sizes them for a 16 GB
        chip: decode needs about 12x and encode about 7x the full-resolution
        128-channel activation per frame in scratch, within 7.5 GiB.  The
        encode noise is drawn per chunk, so the chunking is part of the
        numbers."""
        act = h * w * 128 * torch.finfo(self._vae_dtype).bits // 8
        temp_per_frame = act * (12 if kind == "decode" else 7)
        return max(1, min(16, int(7.5 * (1 << 30)) // temp_per_frame))

    def _encode_video(self, video: torch.Tensor, noise: EnhanceNoise) -> torch.Tensor:
        """(F, H, W, 3) -> sampled, scaled latents (1, F, h, w, 4).  A ragged
        last chunk is padded with its last frame to the chunk size."""
        f, hh, ww = video.shape[:3]
        step = self._vae_chunk_frames(hh, ww, "encode")
        lat = self._latent_hw(hh, ww) + (self.vae.cfg.z_channels,)
        zs = []
        for start in range(0, f, step):
            chunk = video[start:start + step].to(self.device, self._vae_dtype)
            n = chunk.shape[0]
            if n != step:
                chunk = torch.cat([chunk, chunk[-1:].expand((step - n,) + chunk.shape[1:])])
            eps = noise.normal("encode", start, (step,) + lat).to(self.device)
            zs.append(self.vae.encode(chunk, eps).float()[:n])
        return torch.cat(zs, dim=0)[None]

    @span("st2v.decode")
    def _decode_latents(self, latents: torch.Tensor) -> torch.Tensor:
        """(1, F, h, w, 4) -> frames (F, H, W, 3) in [-1, 1], f32."""
        z = latents[0]
        f = self.vae.cfg.downsample_factor
        step = self._vae_chunk_frames(z.shape[1] * f, z.shape[2] * f)
        outs = []
        for start in range(0, z.shape[0], step):
            zc = z[start:start + step].to(self._vae_dtype)
            with span("st2v.vae_decoder"):
                count("vae_decoder_calls")
                out = self.vae.decode(zc)
            outs.append(out.float())
        return torch.cat(outs, dim=0).clamp(-1.0, 1.0)

    # ---------- public API ----------

    @_routed
    def enhance(self, video: torch.Tensor, key_images: Sequence[torch.Tensor],
                prompt_embeds: Optional[torch.Tensor] = None, seed: Optional[int] = None,
                use_randomized_blending: Optional[bool] = None, chunk_size: Optional[int] = None,
                overlap_size: Optional[int] = None,
                noise: Optional[EnhanceNoise] = None) -> torch.Tensor:
        """video (F, H, W, 3) in [-1, 1] at (height, width), one key image per
        chunk -> enhanced video (F, H, W, 3) in [-1, 1], f32."""
        cfg = self.cfg
        seed = cfg.seed if seed is None else seed
        blending = (cfg.use_randomized_blending if use_randomized_blending is None
                    else use_randomized_blending)
        chunk_size = cfg.chunk_size if chunk_size is None else chunk_size
        overlap_size = (overlap_size if overlap_size is not None
                        else cfg.overlap_size if blending else 0)
        if noise is None:
            noise = GeneratorEnhanceNoise(seed, self.device)
        if prompt_embeds is None:
            prompt_embeds = self.encode_prompts()
        prompt_embeds = prompt_embeds.to(self.device)

        f = video.shape[0]
        if not blending:
            chunk_size, overlap_size = f, 0
        stride = max(chunk_size - overlap_size, 1)
        n_chunks = 1 if not blending else (f - chunk_size) // stride + 1
        if (n_chunks - 1) * stride + chunk_size != f:
            raise ValueError(f"video of {f} frames not divisible into chunks of {chunk_size} "
                             f"with overlap {overlap_size}")
        if len(key_images) != n_chunks:
            raise ValueError(f"{len(key_images)} key images for {n_chunks} chunks")

        lat1 = (1,) + self._latent_hw(cfg.height, cfg.width) + (self.vae.cfg.z_channels,)
        conds = [self._key_image_cond(img, noise.normal("key_image", i, lat1).to(self.device),
                                      chunk_size)
                 for i, img in enumerate(key_images)]
        clip_embs = torch.stack([c for c, _ in conds])
        image_latents = torch.stack([il for _, il in conds])

        scheduler = self.m.scheduler
        timesteps = [int(t) for t in scheduler.sdedit_timesteps(cfg.num_steps, cfg.strength)]
        z0 = self._encode_video(video, noise)
        latents = scheduler.add_noise(z0, noise.normal("latent", 0, tuple(z0.shape)).to(z0.device),
                                      timesteps[0])
        step = (self._denoise_step_dp if self.mesh is not None and self.mesh.size > 1
                else self._denoise_step)
        with span("st2v.chunk"):
            for si, t in enumerate(timesteps):
                latents = step(latents, si, t, prompt_embeds, clip_embs, image_latents, noise,
                               chunk_size=chunk_size, stride=stride, overlap_size=overlap_size)
        return self._decode_latents(latents)

    @_routed
    def enhance_with_keyframe_prepass(self, video: torch.Tensor, image: torch.Tensor,
                                      seed: Optional[int] = None,
                                      noise: Optional[EnhanceNoise] = None) -> torch.Tensor:
        """The randomized-blending flow with the key-frame pre-pass: the
        chunk-start frames are enhanced first, as one short video
        conditioned on ``image``, then serve as the chunks' key images.
        Frames past the last whole chunk are dropped."""
        cfg = self.cfg
        seed = cfg.seed if seed is None else seed
        if noise is None:
            noise = GeneratorEnhanceNoise(seed, self.device)
        f = video.shape[0]
        stride = cfg.chunk_size - cfg.overlap_size
        starts = [s for s in range(0, f, stride) if s + cfg.chunk_size <= f]
        if len(starts) <= 1:
            return self.enhance(video, [image], seed=seed, use_randomized_blending=False,
                                noise=noise)
        key_frames = video[starts]
        enhanced_keys: List[torch.Tensor] = list(self.enhance(
            key_frames, [image], seed=seed, use_randomized_blending=False, noise=noise))
        max_idx = stride * (len(starts) - 1) + cfg.chunk_size
        return self.enhance(video[:max_idx], enhanced_keys, seed=seed,
                            use_randomized_blending=True, noise=noise)
