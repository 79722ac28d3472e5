"""Model construction with random weights on the device: stage 1
(counterpart of ``streamingt2v_tpu/pipeline/build.py:93-175``), stage 2
(``build_enhance_random``, ``:190-254``), stage 3
(``build_interpolate_random``, ``:284``) and the three-stage product
(``build_product_random``, ``:257``).

Every module is built directly on ``device`` in its dtype and filled from
its own ``torch.Generator`` seeded from ``seed``; checkpoint loading
replaces the weights afterwards (``utils/weights.py`` for JAX trees).
``device`` defaults to the card: without one the builders raise, and a
caller that wants CPU modules (the parity tests) asks for ``"cpu"``.

``mesh`` (``parallel/mesh.py``) builds a stage for a multi-rank run, every
rank with the same weights from the same seed: stage 1's models keep each
rank's slice of their tensor-parallel weights (``shard_stage1_models``) and
its network calls split over the mesh; stages 2 and 3 split their batches
over ``data`` (the JAX package's ``pipeline/build.py:137-167``).
"""

from __future__ import annotations

import dataclasses

import torch

from streamingt2v_torch.config import EnhanceConfig, PipelineConfig, VAEConfig
from streamingt2v_torch.diffusion.ddim import DDIMScheduler
from streamingt2v_torch.models.clip import CLIPVisionConfig, CLIPVisionTower
from streamingt2v_torch.models.clip_text import CLIPTextConfig, CLIPTextTower, CLIPTokenizer
from streamingt2v_torch.models.conditioner import Conditioner
from streamingt2v_torch.models.controlnet import ControlNet
from streamingt2v_torch.models.enhance.unet import I2VGenXLUNet, I2VGenXLUNetConfig
from streamingt2v_torch.models.layers import init_random_
from streamingt2v_torch.models.vae import AutoencoderKL
from streamingt2v_torch.models.vfi import MultiScaleFlow
from streamingt2v_torch.models.video_unet import VideoUNet
from streamingt2v_torch.parallel.sharding import shard_params
from streamingt2v_torch.pipeline.enhance import EnhanceModels, EnhancePipeline
from streamingt2v_torch.pipeline.full import StreamingT2VPipeline
from streamingt2v_torch.pipeline.interpolate import InterpolatePipeline
from streamingt2v_torch.pipeline.streaming import Stage1Pipeline, StreamingModels


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to build on the CPU")
    return device


def build_models(cfg: PipelineConfig, seed: int = 0, *, device="cuda", bf16: bool = False,
                 init: bool = True) -> StreamingModels:
    """All stage-1 modules on ``device``.  ``bf16`` stores every tree but
    the VAE in bfloat16 (the production weight dtype); the VAE keeps its
    config's dtype.  ``init=False`` leaves the weights uninitialised, for
    a caller that loads them."""
    device = _device(device)
    dtype = torch.bfloat16 if bf16 else cfg.unet.dtypes.param_dtype
    fk = dict(device=device, dtype=dtype)
    # the first chunk is plain SVD-XT: no CAM fusion, no APM
    svd_cfg = dataclasses.replace(cfg.unet, controlnet_mode=False, use_apm=False)
    # APM's context: the SVD pooled token plus one per anchor frame
    a, b = cfg.inference.apm_anchor_frames
    models = StreamingModels(
        unet=VideoUNet(cfg.unet, apm_tokens=1 + (b - a), **fk),
        controlnet=ControlNet(cfg.unet, cfg.controlnet, **fk),
        svd_unet=VideoUNet(svd_cfg, **fk),
        vae=AutoencoderKL(cfg.vae, device=device, dtype=cfg.vae.dtypes.vae_compute_dtype),
        conditioner=Conditioner(cfg.conditioner, cfg.vae, **fk),
    )
    for i, field in enumerate(dataclasses.fields(models)):
        module = getattr(models, field.name).eval()
        if init:
            init_random_(module, torch.Generator(device).manual_seed(seed * 1000 + i))
    return models


def shard_stage1_models(models: StreamingModels, mesh) -> StreamingModels:
    """Keep this rank's slice of every tensor-parallel weight of the stage-1
    models (the transformers' projections and FFs, CAM's; the rest stays
    whole), in place.  The identity without a model axis."""
    for field in dataclasses.fields(models):
        shard_params(getattr(models, field.name), mesh)
    return models


def build_pipeline(cfg: PipelineConfig, seed: int = 0, *, device="cuda", bf16: bool = False,
                   init: bool = True, mesh=None) -> Stage1Pipeline:
    models = build_models(cfg, seed, device=device, bf16=bf16, init=init)
    return Stage1Pipeline(cfg, shard_stage1_models(models, mesh), mesh=mesh)


def build_enhance_models(seed: int = 0, *, device="cuda", bf16: bool = True, init: bool = True,
                         unet: I2VGenXLUNetConfig = I2VGenXLUNetConfig(),
                         vae: VAEConfig = dataclasses.replace(VAEConfig(),
                                                              temporal_decoder=False),
                         clip_vision: CLIPVisionConfig = CLIPVisionConfig(),
                         text: CLIPTextConfig = CLIPTextConfig(),
                         tokenizer_length: int = 77) -> EnhanceModels:
    """The stage-2 modules on ``device``, at the I2VGen-XL release's widths
    unless given: the UNet, OpenCLIP ViT-H vision and text towers (bfloat16
    when ``bf16``) and the SD VAE with quant convs (its config's dtype, f32;
    ``EnhanceConfig.vae_bf16`` casts it), with the synthetic tokenizer."""
    device = _device(device)
    fk = dict(device=device, dtype=torch.bfloat16 if bf16 else torch.float32)
    models = EnhanceModels(
        unet=I2VGenXLUNet(unet, **fk),
        vae=AutoencoderKL(vae, use_quant_conv=True, device=device,
                          dtype=vae.dtypes.vae_compute_dtype),
        clip_vision=CLIPVisionTower(clip_vision, **fk),
        text_encoder=CLIPTextTower(text, **fk),
        scheduler=DDIMScheduler(),
        tokenizer=CLIPTokenizer.synthetic(tokenizer_length),
    )
    for i, name in enumerate(("unet", "vae", "clip_vision", "text_encoder")):
        module = getattr(models, name).eval()
        if init:
            init_random_(module, torch.Generator(device).manual_seed(seed * 1000 + 100 + i))
    return models


def build_enhance(cfg: EnhanceConfig, seed: int = 0, mesh=None, **kw) -> EnhancePipeline:
    """``EnhancePipeline`` over ``build_enhance_models(seed, **kw)``."""
    return EnhancePipeline(cfg, build_enhance_models(seed, **kw), mesh=mesh)


def build_interpolate(cfg: PipelineConfig, seed: int = 0, *, device="cuda",
                      init: bool = True, mesh=None) -> InterpolatePipeline:
    """Stage 3: the EMA-VFI network of ``cfg.vfi`` in f32 on ``device``, with
    flip-TTA as ``cfg.vfi.tta`` says."""
    device = _device(device)
    model = MultiScaleFlow(cfg.vfi, device=device).eval()
    if init:
        init_random_(model, torch.Generator(device).manual_seed(seed * 1000 + 200))
    return InterpolatePipeline(model, tta=cfg.vfi.tta, mesh=mesh)


def build_product(cfg: PipelineConfig, seed: int = 0, *, device="cuda") -> StreamingT2VPipeline:
    """The three-stage product at the configuration's widths with random
    weights, all resident on ``device``: stage 1 in bf16 but its f32 VAE,
    stage 2 in bf16 (its VAE as ``cfg.enhance.vae_bf16`` says), stage 3 in
    f32."""
    return StreamingT2VPipeline(cfg, build_pipeline(cfg, seed, device=device, bf16=True),
                                build_enhance(cfg.enhance, seed, device=device),
                                build_interpolate(cfg, seed, device=device))
