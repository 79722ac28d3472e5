"""Stage-1 model construction with random weights on the device
(counterpart of ``streamingt2v_tpu/pipeline/build.py:93-175``).

Every module is built directly on ``device`` in its dtype and filled from
its own ``torch.Generator`` seeded from ``seed``; checkpoint loading
replaces the weights afterwards (``utils/weights.py`` for JAX trees).
"""

from __future__ import annotations

import dataclasses

import torch

from streamingt2v_torch.config import PipelineConfig
from streamingt2v_torch.models.conditioner import Conditioner
from streamingt2v_torch.models.controlnet import ControlNet
from streamingt2v_torch.models.layers import init_random_
from streamingt2v_torch.models.vae import AutoencoderKL
from streamingt2v_torch.models.video_unet import VideoUNet
from streamingt2v_torch.pipeline.streaming import Stage1Pipeline, StreamingModels


def build_models(cfg: PipelineConfig, seed: int = 0, *, device="cpu", bf16: bool = False,
                 init: bool = True) -> StreamingModels:
    """All stage-1 modules on ``device``.  ``bf16`` stores every tree but
    the VAE in bfloat16 (the production weight dtype); the VAE keeps its
    config's dtype.  ``init=False`` leaves the weights uninitialised, for
    a caller that loads them."""
    device = torch.device(device)
    dtype = torch.bfloat16 if bf16 else cfg.unet.dtypes.param_dtype
    fk = dict(device=device, dtype=dtype)
    # the first chunk is plain SVD-XT: no CAM fusion
    svd_cfg = dataclasses.replace(cfg.unet, controlnet_mode=False, use_apm=False)
    models = StreamingModels(
        unet=VideoUNet(cfg.unet, **fk),
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


def build_pipeline(cfg: PipelineConfig, seed: int = 0, *, device="cpu", bf16: bool = False,
                   init: bool = True) -> Stage1Pipeline:
    return Stage1Pipeline(cfg, build_models(cfg, seed, device=device, bf16=bf16, init=init))
