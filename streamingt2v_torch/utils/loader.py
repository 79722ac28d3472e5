"""Checkpoint locating and pipeline assembly from the published weights
(counterpart of ``streamingt2v_tpu/utils/loader.py``).

Resolution is local-only, with errors that state the expected layout:

  ckpt_dir/
    streamingsvd/model.safetensors   # PAIR/StreamingSVD whole-trainer dict
    svd_xt/unet/...                  # diffusers SVD-XT (first chunk)
    i2vgen-xl/{unet,vae,text_encoder,image_encoder,scheduler,tokenizer}/
    vfi/ours.pkl                     # EMA-VFI

Each entry point builds its modules uninitialised on ``device`` (the card
unless the caller passes ``"cpu"``) in the dtypes ``build_product`` gives
them, then copies each reference tensor into its parameter as it is read:
the card holds the resident weights plus one tensor in flight, the host one
tensor plus the page cache of the memory-mapped files.  Each source's
seconds go to the stage timers (``load_<source>``).
"""

from __future__ import annotations

import dataclasses
import glob
import itertools
import json
import os
from typing import Dict, List, Tuple

import torch
from torch import nn

from streamingt2v_torch.config import PipelineConfig, VAEConfig
from streamingt2v_torch.diffusion.ddim import DDIMScheduler
from streamingt2v_torch.models.clip import CLIPVisionConfig
from streamingt2v_torch.models.clip_text import CLIPTextConfig, CLIPTokenizer
from streamingt2v_torch.models.enhance.unet import I2VGenXLUNetConfig
from streamingt2v_torch.pipeline.build import build_enhance_models, build_interpolate, build_pipeline
from streamingt2v_torch.pipeline.enhance import EnhanceModels, EnhancePipeline
from streamingt2v_torch.pipeline.interpolate import InterpolatePipeline
from streamingt2v_torch.pipeline.streaming import Stage1Pipeline, StreamingModels
from streamingt2v_torch.utils import checkpoint as ck
from streamingt2v_torch.utils import checkpoint_diffusers as ckd
from streamingt2v_torch.utils.checkpoint_vfi import strip_ddp_keys, vfi_map
from streamingt2v_torch.utils.profiling import stage_timer

STREAMINGSVD = "streamingsvd/model.safetensors"
SVD_XT_UNET = "svd_xt/unet"
I2VGEN = "i2vgen-xl"
VFI = "vfi/ours.pkl"
_HINTS = {STREAMINGSVD: "PAIR/StreamingSVD/resolve/main/model.safetensors",
          VFI: "EMA-VFI ours.pkl (Google Drive, see reference README)"}

# (source under ckpt_dir: a file or a diffusers component folder, module, map)
Conversion = Tuple[str, nn.Module, ck.MapDict]


def resolve_ckpt(local_path: str, global_hint: str = "") -> str:
    """``local_path`` if it exists, else FileNotFoundError naming the
    reference's source.  Nothing is fetched."""
    if os.path.exists(local_path):
        return local_path
    raise FileNotFoundError(
        f"checkpoint not found at {local_path}. Download it out-of-band"
        + (f" (reference source: {global_hint})" if global_hint else ""))


def _load_component_sd(root: str, sub: str) -> Dict[str, torch.Tensor]:
    """A diffusers component folder's weights (safetensors or .bin)."""
    cand = sorted(glob.glob(os.path.join(root, sub, "*.safetensors"))
                  + glob.glob(os.path.join(root, sub, "*.bin")))
    if not cand:
        raise FileNotFoundError(f"no weights found under {os.path.join(root, sub)}")
    sd = {}
    for path in cand:
        sd.update(ck.load_torch_file(path))
    return sd


def _read_source(ckpt_dir: str, source: str) -> Dict[str, torch.Tensor]:
    """The reference state dict of one source of the tree."""
    if source.endswith((".safetensors", ".pkl")):
        sd = ck.load_torch_file(resolve_ckpt(os.path.join(ckpt_dir, source),
                                             _HINTS.get(source, "")))
        return strip_ddp_keys(sd) if source == VFI else sd
    root, sub = os.path.split(source)
    return _load_component_sd(os.path.join(ckpt_dir, root), sub)


def _convert_sources(ckpt_dir: str, conversions: List[Conversion]) -> None:
    """Read each source once and convert its modules, timing each under
    ``load_<first path component>``."""
    for source, group in itertools.groupby(conversions, key=lambda c: c[0]):
        with stage_timer("load_" + source.split("/")[0]):
            sd = _read_source(ckpt_dir, source)
            for _, module, mapping in group:
                ck.convert_state_dict(sd, mapping, module)
            del sd


# ---------------------------------------------------------------- stage 1 ---

def stage1_conversions(cfg: PipelineConfig, models: StreamingModels,
                       svd_xt: bool) -> List[Conversion]:
    """The StreamingSVD whole-trainer file into the UNet+CAM, ControlNet,
    temporal VAE, CLIP tower (embedder 0) and conditioning VAE encoder
    (embedder 3); with ``svd_xt`` the diffusers SVD-XT UNet into the
    first-chunk UNet."""
    cond = models.conditioner
    out = [(STREAMINGSVD, models.unet, ck.unet_map(cfg.unet)),
           (STREAMINGSVD, models.controlnet, ck.controlnet_map(cfg.unet, cfg.controlnet)),
           (STREAMINGSVD, models.vae, ck.vae_map(cfg.vae, torch_prefix="first_stage_model"))]
    if cfg.conditioner.use_clip:
        out.append((STREAMINGSVD, cond.clip, ck.clip_visual_map(
            cond.clip.cfg, "conditioner.embedders.0.open_clip.model.visual")))
    vcfg = dataclasses.replace(cfg.vae, temporal_decoder=False, scale_factor=1.0)
    out.append((STREAMINGSVD, cond.cond_encoder, ck.vae_map(
        vcfg, torch_prefix="conditioner.embedders.3.encoder", use_quant_conv=True)))
    if svd_xt:
        svd_cfg = dataclasses.replace(cfg.unet, controlnet_mode=False)
        out.append((SVD_XT_UNET, models.svd_unet, ckd.svd_unet_map(svd_cfg)))
    return out


@torch.no_grad()
def _copy_without_cam_mergers(unet: nn.Module, svd_unet: nn.Module) -> None:
    """The streaming UNet's weights minus the CAM mergers are the first-chunk
    UNet's (controlnet_mode=False)."""
    src = unet.state_dict()
    for name, p in svd_unet.state_dict(keep_vars=True).items():
        p.copy_(src[name])


def load_stage1_checkpoints(cfg: PipelineConfig, ckpt_dir: str, *, seed: int = 0,
                            device="cuda", bf16: bool = True) -> Stage1Pipeline:
    """Stage 1 from the StreamingSVD checkpoint, in ``build_pipeline``'s
    dtypes (``bf16``: all but the f32 VAE in bfloat16).  The first-chunk UNet
    takes the diffusers SVD-XT weights under ``svd_xt/unet/`` when present
    (the reference runs the genuine SVD pipeline for chunk 0,
    streaming_svd.py:388-390), else the StreamingSVD-finetuned base weights.
    The tiny configs' toy CLIP projection has no reference weights: those
    configs are built drawn from ``seed`` first, as ``build_pipeline`` does."""
    pipe = build_pipeline(cfg, seed, device=device, bf16=bf16,
                          init=not cfg.conditioner.use_clip)
    svd_xt = os.path.isdir(os.path.join(ckpt_dir, SVD_XT_UNET))
    _convert_sources(ckpt_dir, stage1_conversions(cfg, pipe.models, svd_xt))
    if not svd_xt:
        _copy_without_cam_mergers(pipe.models.unet, pipe.models.svd_unet)
    return pipe


# ---------------------------------------------------------------- stage 2 ---

def enhance_conversions(models: EnhanceModels) -> List[Conversion]:
    """The ali-vilab/i2vgen-xl component folders into the stage-2 modules."""
    return [(f"{I2VGEN}/unet", models.unet, ckd.i2vgen_unet_map(models.unet.cfg)),
            (f"{I2VGEN}/vae", models.vae, ckd.diffusers_vae_map(models.vae.cfg)),
            (f"{I2VGEN}/image_encoder", models.clip_vision,
             ckd.hf_clip_vision_map(models.clip_vision.cfg)),
            (f"{I2VGEN}/text_encoder", models.text_encoder,
             ckd.hf_clip_text_map(models.text_encoder.cfg))]


def load_enhance_pipeline(cfg: PipelineConfig, ckpt_dir: str, *, device="cuda",
                          bf16: bool = True,
                          unet: I2VGenXLUNetConfig = I2VGenXLUNetConfig(),
                          vae: VAEConfig = dataclasses.replace(VAEConfig(),
                                                               temporal_decoder=False),
                          clip_vision: CLIPVisionConfig = CLIPVisionConfig(),
                          text: CLIPTextConfig = CLIPTextConfig()) -> EnhancePipeline:
    """Stage 2 from a local ali-vilab/i2vgen-xl tree (diffusers layout), at
    the release's widths unless given, in ``build_enhance_models``' dtypes,
    with the tree's scheduler config and BPE tokenizer files where present
    (without a tokenizer the pipeline needs precomputed prompt embeddings)."""
    models = build_enhance_models(device=device, bf16=bf16, init=False, unet=unet, vae=vae,
                                  clip_vision=clip_vision, text=text,
                                  tokenizer_length=text.max_length)
    _convert_sources(ckpt_dir, enhance_conversions(models))
    root = os.path.join(ckpt_dir, I2VGEN)
    sched_path = os.path.join(root, "scheduler", "scheduler_config.json")
    scheduler = DDIMScheduler()
    if os.path.exists(sched_path):
        with open(sched_path) as f:
            scheduler = DDIMScheduler.from_config(json.load(f))
    tok_dir = os.path.join(root, "tokenizer")
    tokenizer = None
    if os.path.exists(os.path.join(tok_dir, "vocab.json")):
        tokenizer = CLIPTokenizer.from_files(os.path.join(tok_dir, "vocab.json"),
                                             os.path.join(tok_dir, "merges.txt"),
                                             max_length=text.max_length)
    models = dataclasses.replace(models, scheduler=scheduler, tokenizer=tokenizer)
    return EnhancePipeline(cfg.enhance, models)


# ---------------------------------------------------------------- stage 3 ---

def interpolate_conversions(model: nn.Module) -> List[Conversion]:
    return [(VFI, model, vfi_map(model.cfg))]


def load_interpolate_pipeline(cfg: PipelineConfig, ckpt_dir: str, *,
                              device="cuda") -> InterpolatePipeline:
    """Stage 3 (f32, flip-TTA as ``cfg.vfi.tta`` says) from the EMA-VFI .pkl."""
    pipe = build_interpolate(cfg, device=device, init=False)
    _convert_sources(ckpt_dir, interpolate_conversions(pipe.model))
    return pipe
