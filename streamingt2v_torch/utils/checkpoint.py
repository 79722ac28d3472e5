"""Checkpoint ingestion: the reference's torch state dicts -> the port's
modules (counterpart of ``streamingt2v_tpu/utils/checkpoint.py``).

The reference loads a whole-trainer state dict (safetensors) with keys
prefixed by trainer attribute names (inference_i2v.py:133-141):
  model.diffusion_model.*      VideoUNet (via OpenAIWrapper)
  controlnet.*                 ControlNet
  conditioner.embedders.{i}.*  CLIP tower / cond VAE encoder
  first_stage_model.*          temporal VAE

A map is ``{port key: (reference key or tuple of keys, transform)}``; the
port's keys are the JAX package's flax paths with ``/`` replaced by ``.``
(``utils/weights.py``), and each map function here carries the name of its
JAX counterpart.  The port keeps PyTorch's layouts, so most transforms are
the identity (Linear, Conv2d, ConvTranspose, norms, embeddings); the rest:
  conv3d (O, I, kt, 1, 1)   -> the temporal-conv kernel (kt, I, O)
  Linear where a 1x1 conv   -> (O, I, 1, 1)
  q/k/v -> fused in_proj    -> concatenated along the output dim

``load_torch_file`` reads ``.safetensors`` itself (the card's machine has no
``safetensors`` package): the tensors are views of a private ``mmap`` of the
file, so nothing is copied on the host until a tensor is moved.  Other
files go through ``torch.load(weights_only=True)``.
``convert_state_dict`` copies each mapped tensor into the module's own
parameter (its device and dtype) as it goes.
"""

from __future__ import annotations

import json
import math
import mmap
import os
import pickle
import struct
import zipfile
from typing import Callable, Dict, List, Tuple

import torch
from torch import nn

Transform = Callable[..., torch.Tensor]


def t_id(w: torch.Tensor) -> torch.Tensor:
    return w


def t_transpose(w: torch.Tensor) -> torch.Tensor:
    """A Linear weight (O, I) stored where the port holds (I, O)."""
    if w.dim() != 2:
        raise ValueError(f"a 2-d weight, not {tuple(w.shape)}")
    return w.t()


def t_conv3d(w: torch.Tensor) -> torch.Tensor:
    """conv3d (O, I, kt, 1, 1) -> the temporal-conv kernel (kt, I, O)."""
    if w.dim() != 5 or tuple(w.shape[3:]) != (1, 1):
        raise ValueError(f"a (kt, 1, 1) conv3d weight, not {tuple(w.shape)}")
    return w[:, :, :, 0, 0].permute(2, 1, 0)


def t_linear_to_conv1x1(w: torch.Tensor) -> torch.Tensor:
    """torch Linear used where the port has a 1x1 conv: (O, I) -> (O, I, 1, 1)."""
    if w.dim() != 2:
        raise ValueError(f"a 2-d weight, not {tuple(w.shape)}")
    return w[:, :, None, None]


def t_cat(ws: List[torch.Tensor]) -> torch.Tensor:
    """Projections fused along the output dim (HF q/k/v -> in_proj): the
    weights' and the biases' rule alike (``t_cat_linear``/``t_cat_bias``)."""
    return torch.cat(list(ws), dim=0)


# ---------------------------------------------------------------- reading ---

SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32, "I16": torch.int16,
    "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """The tensors of a ``.safetensors`` file (an 8-byte little-endian header
    length, the JSON header, then each tensor's bytes at its offsets),
    each a view of a copy-on-write ``mmap`` of the file."""
    with open(path, "rb") as f:
        size = os.fstat(f.fileno()).st_size
        if size < 8:
            raise ValueError(f"{path}: {size} bytes, too short for a safetensors header")
        (n,) = struct.unpack("<Q", f.read(8))
        if 8 + n > size:
            raise ValueError(f"{path}: a header of {n} bytes runs past the end of the "
                             f"file ({size} bytes)")
        header = json.loads(f.read(n))
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = SAFETENSORS_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name} has dtype {info['dtype']}, "
                             f"not one of {sorted(SAFETENSORS_DTYPES)}")
        shape = [int(d) for d in info["shape"]]
        begin, end = (int(o) for o in info["data_offsets"])
        count = math.prod(shape)
        nbytes = count * torch.empty((), dtype=dtype).element_size()
        if end - begin != nbytes or 8 + n + end > size:
            raise ValueError(f"{path}: tensor {name} {info['dtype']}{shape} has bytes "
                             f"[{begin}, {end}) of a {size - 8 - n}-byte data section "
                             f"({nbytes} bytes expected)")
        if count == 0:
            out[name] = torch.empty(shape, dtype=dtype)
        else:
            out[name] = torch.frombuffer(buf, dtype=dtype, count=count,
                                         offset=8 + n + begin).view(shape)
    return out


def load_torch_file(path: str) -> Dict[str, torch.Tensor]:
    """A ``.safetensors`` file through ``read_safetensors``; a torch pickle
    (``.bin``, ``.pkl``, ``.ckpt``) through ``torch.load(weights_only=True)``,
    memory-mapped when it is a zip archive, with a ``state_dict`` entry
    unwrapped.  A file that holds anything but tensors raises."""
    if path.endswith(".safetensors"):
        return read_safetensors(path)
    try:
        sd = torch.load(path, map_location="cpu", weights_only=True,
                        mmap=zipfile.is_zipfile(path))
    except pickle.UnpicklingError as e:
        raise ValueError(f"{path}: holds objects other than tensors ({e})") from e
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    if not isinstance(sd, dict):
        raise ValueError(f"{path}: holds a {type(sd).__name__}, not a dict of tensors")
    bad = [k for k, v in sd.items() if not isinstance(v, torch.Tensor)]
    if bad:
        raise ValueError(f"{path}: entries that are not tensors: {bad[:8]}")
    return sd


# --------------------------------------------------------------------------
# Mapping primitives.  A mapping is {port key ("a.b.c"): (torch_key, T)}.
# --------------------------------------------------------------------------

MapDict = Dict[str, Tuple[object, Transform]]


def _norm(m: MapDict, fx: str, tk: str) -> None:
    m[f"{fx}_scale"] = (f"{tk}.weight", t_id)
    m[f"{fx}_bias"] = (f"{tk}.bias", t_id)


def _linear(m: MapDict, fx: str, tk: str, bias: bool = True) -> None:
    m[f"{fx}.kernel"] = (f"{tk}.weight", t_id)
    if bias:
        m[f"{fx}.bias"] = (f"{tk}.bias", t_id)


def _conv(m: MapDict, fx: str, tk: str, dims: int = 2) -> None:
    m[f"{fx}.kernel"] = (f"{tk}.weight", t_conv3d if dims == 3 else t_id)
    m[f"{fx}.bias"] = (f"{tk}.bias", t_id)


# --------------------------------------------------------------------------
# VAE
# --------------------------------------------------------------------------

def _map_resnet_block(m: MapDict, fx: str, tk: str, channel_change: bool) -> None:
    _norm(m, f"{fx}.norm1", f"{tk}.norm1")
    _conv(m, f"{fx}.conv1", f"{tk}.conv1")
    _norm(m, f"{fx}.norm2", f"{tk}.norm2")
    _conv(m, f"{fx}.conv2", f"{tk}.conv2")
    if channel_change:
        _conv(m, f"{fx}.nin_shortcut", f"{tk}.nin_shortcut")


def _map_attn_block(m: MapDict, fx: str, tk: str) -> None:
    _norm(m, f"{fx}.norm", f"{tk}.norm")
    for p in ("q", "k", "v", "proj_out"):
        _conv(m, f"{fx}.{p}", f"{tk}.{p}")


def _map_temporal_res_stack(m: MapDict, fx: str, tk: str) -> None:
    """openaimodel ResBlock (dims=3, skip_t_emb): in_layers / out_layers."""
    _norm(m, f"{fx}.in_norm", f"{tk}.in_layers.0")
    _conv(m, f"{fx}.in_conv", f"{tk}.in_layers.2", dims=3)
    _norm(m, f"{fx}.out_norm", f"{tk}.out_layers.0")
    _conv(m, f"{fx}.out_conv", f"{tk}.out_layers.3", dims=3)


def vae_encoder_map(cfg, prefix_fx: str = "encoder", prefix_tk: str = "encoder") -> MapDict:
    m: MapDict = {}
    _conv(m, f"{prefix_fx}.conv_in", f"{prefix_tk}.conv_in")
    ch_prev = cfg.ch
    for i, mult in enumerate(cfg.ch_mult):
        ch_out = cfg.ch * mult
        for j in range(cfg.num_res_blocks):
            _map_resnet_block(
                m, f"{prefix_fx}.down_{i}_block_{j}", f"{prefix_tk}.down.{i}.block.{j}",
                channel_change=(ch_prev != ch_out),
            )
            ch_prev = ch_out
        if i != len(cfg.ch_mult) - 1:
            _conv(m, f"{prefix_fx}.down_{i}_downsample.conv",
                  f"{prefix_tk}.down.{i}.downsample.conv")
    _map_resnet_block(m, f"{prefix_fx}.mid_block_1", f"{prefix_tk}.mid.block_1", False)
    _map_attn_block(m, f"{prefix_fx}.mid_attn_1", f"{prefix_tk}.mid.attn_1")
    _map_resnet_block(m, f"{prefix_fx}.mid_block_2", f"{prefix_tk}.mid.block_2", False)
    _norm(m, f"{prefix_fx}.norm_out", f"{prefix_tk}.norm_out")
    _conv(m, f"{prefix_fx}.conv_out", f"{prefix_tk}.conv_out")
    return m


def _map_video_res_block_vae(m: MapDict, fx: str, tk: str, channel_change: bool) -> None:
    """temporal_ae VideoResBlock: spatial ResnetBlock fields live on the
    block itself; time_stack is the 3D ResBlock; learned mix_factor."""
    _map_resnet_block(m, f"{fx}.spatial", tk, channel_change)
    _map_temporal_res_stack(m, f"{fx}.time_stack", f"{tk}.time_stack")
    m[f"{fx}.mix_factor"] = (f"{tk}.mix_factor", t_id)


def vae_video_decoder_map(cfg, prefix_fx: str = "decoder", prefix_tk: str = "decoder") -> MapDict:
    m: MapDict = {}
    _conv(m, f"{prefix_fx}.conv_in", f"{prefix_tk}.conv_in")
    block_in = cfg.ch * cfg.ch_mult[-1]
    _map_video_res_block_vae(m, f"{prefix_fx}.mid_block_1", f"{prefix_tk}.mid.block_1", False)
    _map_attn_block(m, f"{prefix_fx}.mid_attn_1", f"{prefix_tk}.mid.attn_1")
    _map_video_res_block_vae(m, f"{prefix_fx}.mid_block_2", f"{prefix_tk}.mid.block_2", False)
    ch_prev = block_in
    for i in reversed(range(len(cfg.ch_mult))):
        ch_out = cfg.ch * cfg.ch_mult[i]
        for j in range(cfg.num_res_blocks + 1):
            _map_video_res_block_vae(
                m, f"{prefix_fx}.up_{i}_block_{j}", f"{prefix_tk}.up.{i}.block.{j}",
                channel_change=(ch_prev != ch_out),
            )
            ch_prev = ch_out
        if i != 0:
            _conv(m, f"{prefix_fx}.up_{i}_upsample.conv", f"{prefix_tk}.up.{i}.upsample.conv")
    _norm(m, f"{prefix_fx}.norm_out", f"{prefix_tk}.norm_out")
    _conv(m, f"{prefix_fx}.conv_out.conv", f"{prefix_tk}.conv_out")
    _conv(m, f"{prefix_fx}.conv_out.time_mix_conv", f"{prefix_tk}.conv_out.time_mix_conv", dims=3)
    return m


def vae_map(cfg, torch_prefix: str = "first_stage_model", use_quant_conv: bool = False) -> MapDict:
    m: MapDict = {}
    m.update(vae_encoder_map(cfg, "encoder", f"{torch_prefix}.encoder"))
    if cfg.temporal_decoder:
        m.update(vae_video_decoder_map(cfg, "decoder", f"{torch_prefix}.decoder"))
    else:
        # spatial decoder: plain ResnetBlocks, conv2d conv_out
        _conv(m, "decoder.conv_in", f"{torch_prefix}.decoder.conv_in")
        block_in = cfg.ch * cfg.ch_mult[-1]
        _map_resnet_block(m, "decoder.mid_block_1", f"{torch_prefix}.decoder.mid.block_1", False)
        _map_attn_block(m, "decoder.mid_attn_1", f"{torch_prefix}.decoder.mid.attn_1")
        _map_resnet_block(m, "decoder.mid_block_2", f"{torch_prefix}.decoder.mid.block_2", False)
        ch_prev = block_in
        for i in reversed(range(len(cfg.ch_mult))):
            ch_out = cfg.ch * cfg.ch_mult[i]
            for j in range(cfg.num_res_blocks + 1):
                _map_resnet_block(
                    m, f"decoder.up_{i}_block_{j}", f"{torch_prefix}.decoder.up.{i}.block.{j}",
                    channel_change=(ch_prev != ch_out),
                )
                ch_prev = ch_out
            if i != 0:
                _conv(m, f"decoder.up_{i}_upsample.conv",
                      f"{torch_prefix}.decoder.up.{i}.upsample.conv")
        _norm(m, "decoder.norm_out", f"{torch_prefix}.decoder.norm_out")
        _conv(m, "decoder.conv_out", f"{torch_prefix}.decoder.conv_out")
    if use_quant_conv:
        _conv(m, "quant_conv", f"{torch_prefix}.quant_conv")
        _conv(m, "post_quant_conv", f"{torch_prefix}.post_quant_conv")
    return m


# --------------------------------------------------------------------------
# UNet / ControlNet
# --------------------------------------------------------------------------

def _map_unet_res_block(m: MapDict, fx: str, tk: str, channel_change: bool) -> None:
    """openaimodel ResBlock (spatial)."""
    _norm(m, f"{fx}.in_norm", f"{tk}.in_layers.0")
    _conv(m, f"{fx}.in_conv", f"{tk}.in_layers.2")
    _linear(m, f"{fx}.emb_proj", f"{tk}.emb_layers.1")
    _norm(m, f"{fx}.out_norm", f"{tk}.out_layers.0")
    _conv(m, f"{fx}.out_conv", f"{tk}.out_layers.3")
    if channel_change:
        _conv(m, f"{fx}.skip", f"{tk}.skip_connection")


def _map_unet_temporal_res_block(m: MapDict, fx: str, tk: str, channel_change: bool) -> None:
    _norm(m, f"{fx}.in_norm", f"{tk}.in_layers.0")
    _conv(m, f"{fx}.in_conv", f"{tk}.in_layers.2", dims=3)
    _linear(m, f"{fx}.emb_proj", f"{tk}.emb_layers.1")
    _norm(m, f"{fx}.out_norm", f"{tk}.out_layers.0")
    _conv(m, f"{fx}.out_conv", f"{tk}.out_layers.3", dims=3)
    if channel_change:
        _conv(m, f"{fx}.skip", f"{tk}.skip_connection")


def _map_unet_video_res_block(m: MapDict, fx: str, tk: str, channel_change: bool) -> None:
    _map_unet_res_block(m, f"{fx}.spatial", tk, channel_change)
    _map_unet_temporal_res_block(m, f"{fx}.time_stack", f"{tk}.time_stack", False)
    m[f"{fx}.time_mixer_mix_factor"] = (f"{tk}.time_mixer.mix_factor", t_id)


def _map_cross_attention(m: MapDict, fx: str, tk: str) -> None:
    _linear(m, f"{fx}.to_q", f"{tk}.to_q", bias=False)
    _linear(m, f"{fx}.to_k", f"{tk}.to_k", bias=False)
    _linear(m, f"{fx}.to_v", f"{tk}.to_v", bias=False)
    _linear(m, f"{fx}.to_out", f"{tk}.to_out.0")


def _map_feed_forward(m: MapDict, fx: str, tk: str) -> None:
    _linear(m, f"{fx}.proj", f"{tk}.net.0.proj")
    _linear(m, f"{fx}.out", f"{tk}.net.2")


def _map_basic_transformer_block(m: MapDict, fx: str, tk: str) -> None:
    _map_cross_attention(m, f"{fx}.attn1", f"{tk}.attn1")
    _map_cross_attention(m, f"{fx}.attn2", f"{tk}.attn2")
    _map_feed_forward(m, f"{fx}.ff", f"{tk}.ff")
    for i in (1, 2, 3):
        _norm(m, f"{fx}.norm{i}", f"{tk}.norm{i}")


def _map_video_transformer_block(m: MapDict, fx: str, tk: str) -> None:
    _norm(m, f"{fx}.norm_in", f"{tk}.norm_in")
    _map_feed_forward(m, f"{fx}.ff_in", f"{tk}.ff_in")
    _map_basic_transformer_block(m, fx, tk)


def _map_spatial_video_transformer(m: MapDict, fx: str, tk: str, depth: int) -> None:
    _norm(m, f"{fx}.norm", f"{tk}.norm")
    _linear(m, f"{fx}.proj_in", f"{tk}.proj_in")
    for d in range(depth):
        _map_basic_transformer_block(m, f"{fx}.block_{d}", f"{tk}.transformer_blocks.{d}")
        _map_video_transformer_block(m, f"{fx}.time_block_{d}", f"{tk}.time_stack.{d}")
    _linear(m, f"{fx}.time_pos_embed_0", f"{tk}.time_pos_embed.0")
    _linear(m, f"{fx}.time_pos_embed_2", f"{tk}.time_pos_embed.2")
    m[f"{fx}.time_mixer_mix_factor"] = (f"{tk}.time_mixer.mix_factor", t_id)
    _linear(m, f"{fx}.proj_out", f"{tk}.proj_out")


def _map_cam_merger(m: MapDict, fx: str, tk: str) -> None:
    """ConditionalModel.temporal_transformer (models/cam/conditioning.py)."""
    t = f"{tk}.temporal_transformer"
    _norm(m, f"{fx}.norm", f"{t}.norm")
    _linear(m, f"{fx}.proj_in", f"{t}.proj_in")
    _map_cross_attention(m, fx, f"{t}.attention")
    _linear(m, f"{fx}.proj_out", f"{t}.proj_out")


def _unet_encoder_blocks(cfg) -> List[dict]:
    """(kind, port name, torch input_blocks index, channels, has_attn,
    channel_change) for each input block after conv_in."""
    out = []
    ch = cfg.model_channels
    ds = 1
    blk = 0
    tidx = 1
    for level, mult in enumerate(cfg.channel_mult):
        for _ in range(cfg.num_res_blocks):
            ch_out = mult * cfg.model_channels
            out.append(dict(kind="res", fx=f"input_{blk}", tidx=tidx, ch=ch_out,
                            attn=ds in cfg.attention_resolutions, change=(ch != ch_out)))
            ch = ch_out
            blk += 1
            tidx += 1
        if level != len(cfg.channel_mult) - 1:
            ds *= 2
            out.append(dict(kind="down", fx=f"input_{blk}", tidx=tidx, ch=ch,
                            attn=False, change=False))
            blk += 1
            tidx += 1
    return out


def unet_map(cfg, torch_prefix: str = "model.diffusion_model") -> MapDict:
    m: MapDict = {}
    p = torch_prefix
    _linear(m, "time_embed_0", f"{p}.time_embed.0")
    _linear(m, "time_embed_2", f"{p}.time_embed.2")
    _linear(m, "label_emb_0", f"{p}.label_emb.0.0")
    _linear(m, "label_emb_2", f"{p}.label_emb.0.2")
    _conv(m, "in_conv", f"{p}.input_blocks.0.0")

    blocks = _unet_encoder_blocks(cfg)
    for b in blocks:
        tk = f"{p}.input_blocks.{b['tidx']}"
        if b["kind"] == "res":
            _map_unet_video_res_block(m, f"{b['fx']}_res", f"{tk}.0", b["change"])
            if b["attn"]:
                _map_spatial_video_transformer(
                    m, f"{b['fx']}_attn", f"{tk}.1", cfg.transformer_depth
                )
        else:
            _conv(m, f"{b['fx']}_down.conv", f"{tk}.0.op")

    _map_unet_video_res_block(m, "middle_res_0", f"{p}.middle_block.0", False)
    _map_spatial_video_transformer(m, "middle_attn", f"{p}.middle_block.1", cfg.transformer_depth)
    _map_unet_video_res_block(m, "middle_res_1", f"{p}.middle_block.2", False)

    if cfg.controlnet_mode:
        # CAM mergers: one per input block (incl. conv_in) + mid, indexed in
        # append order (video_model.py:234-237,335-337,371-373)
        n_mergers = 1 + len(blocks)
        # torch prefix is on the trainer, not inside diffusion_model
        root = torch_prefix.split(".")[0]
        cam_p = f"{root}.diffusion_model" if torch_prefix.endswith("diffusion_model") else torch_prefix
        for i in range(n_mergers):
            _map_cam_merger(m, f"cam_merger_input_{i}",
                            f"{cam_p}.cross_attention_merger_input_blocks.{i}")
        _map_cam_merger(m, "cam_merger_mid", f"{cam_p}.cross_attention_merger_mid_block")

    # output blocks
    input_chans = [cfg.model_channels] + [b["ch"] for b in blocks]
    ch = blocks[-1]["ch"]
    ds = 2 ** (len(cfg.channel_mult) - 1)
    blk = 0
    for level, mult in reversed(list(enumerate(cfg.channel_mult))):
        for i in range(cfg.num_res_blocks + 1):
            ich = input_chans.pop()
            tk = f"{p}.output_blocks.{blk}"
            ch_out = cfg.model_channels * mult
            _map_unet_video_res_block(m, f"output_{blk}_res", f"{tk}.0",
                                      channel_change=(ch + ich != ch_out))
            ch = ch_out
            nxt = 1
            if ds in cfg.attention_resolutions:
                _map_spatial_video_transformer(m, f"output_{blk}_attn", f"{tk}.{nxt}",
                                               cfg.transformer_depth)
                nxt += 1
            if level and i == cfg.num_res_blocks:
                ds //= 2
                _conv(m, f"output_{blk}_up.conv", f"{tk}.{nxt}.conv")
            blk += 1

    _norm(m, "out_norm", f"{p}.out.0")
    _conv(m, "out_conv", f"{p}.out.2")
    return m


def controlnet_map(unet_cfg, cn_cfg, torch_prefix: str = "controlnet") -> MapDict:
    m: MapDict = {}
    p = torch_prefix
    _linear(m, "time_embed_0", f"{p}.time_embed.0")
    _linear(m, "time_embed_2", f"{p}.time_embed.2")
    _linear(m, "label_emb_0", f"{p}.label_emb.0.0")
    _linear(m, "label_emb_2", f"{p}.label_emb.0.2")
    _conv(m, "in_conv", f"{p}.input_blocks.0.0")
    for b in _unet_encoder_blocks(unet_cfg):
        tk = f"{p}.input_blocks.{b['tidx']}"
        if b["kind"] == "res":
            _map_unet_video_res_block(m, f"{b['fx']}_res", f"{tk}.0", b["change"])
            if b["attn"]:
                _map_spatial_video_transformer(m, f"{b['fx']}_attn", f"{tk}.1",
                                               unet_cfg.transformer_depth)
        else:
            _conv(m, f"{b['fx']}_down.conv", f"{tk}.0.op")
    _map_unet_video_res_block(m, "middle_res_0", f"{p}.middle_block.0", False)
    _map_spatial_video_transformer(m, "middle_attn", f"{p}.middle_block.1",
                                   unet_cfg.transformer_depth)
    _map_unet_video_res_block(m, "middle_res_1", f"{p}.middle_block.2", False)

    ce = f"{p}.controlnet_cond_embedding"
    _conv(m, "cond_embedding.conv_in", f"{ce}.conv_in")
    nb = 2 * (len(cn_cfg.conditioning_embedding_out_channels) - 1)
    for j in range(nb):
        _conv(m, f"cond_embedding.block_{j}", f"{ce}.blocks.{j}")
        if cn_cfg.use_image_encoder_normalization:
            _norm(m, f"cond_embedding.norm_{j}", f"{ce}.norms.{j}")
    _conv(m, "cond_embedding.conv_out", f"{ce}.conv_out")
    return m


# --------------------------------------------------------------------------
# CLIP visual tower (open_clip naming)
# --------------------------------------------------------------------------

def clip_visual_map(cfg, torch_prefix: str) -> MapDict:
    """torch_prefix e.g. 'conditioner.embedders.0.open_clip.model.visual'."""
    m: MapDict = {}
    p = torch_prefix
    m["conv1.kernel"] = (f"{p}.conv1.weight", t_id)
    m["class_embedding"] = (f"{p}.class_embedding", t_id)
    m["positional_embedding"] = (f"{p}.positional_embedding", t_id)
    _norm(m, "ln_pre", f"{p}.ln_pre")
    for i in range(cfg.layers):
        b = f"{p}.transformer.resblocks.{i}"
        fx = f"resblock_{i}"
        _norm(m, f"{fx}.ln_1", f"{b}.ln_1")
        m[f"{fx}.attn.in_proj.kernel"] = (f"{b}.attn.in_proj_weight", t_id)
        m[f"{fx}.attn.in_proj.bias"] = (f"{b}.attn.in_proj_bias", t_id)
        _linear(m, f"{fx}.attn.out_proj", f"{b}.attn.out_proj")
        _norm(m, f"{fx}.ln_2", f"{b}.ln_2")
        _linear(m, f"{fx}.mlp_fc", f"{b}.mlp.c_fc")
        _linear(m, f"{fx}.mlp_proj", f"{b}.mlp.c_proj")
    _norm(m, "ln_post", f"{p}.ln_post")
    m["proj"] = (f"{p}.proj", t_id)
    return m


# --------------------------------------------------------------------------
# Conversion
# --------------------------------------------------------------------------

# --------------------------------------------------------------------------
# LPIPS (diffusion/lpips.py)
# --------------------------------------------------------------------------

def lpips_map(vgg_prefix: str = "net", lin_prefix: str = "") -> MapDict:
    """torchvision VGG16 + LPIPS lin heads -> ``LPIPS`` (the JAX package's
    ``diffusion/lpips.lpips_map``).  The LPIPS release stores the VGG
    weights as ``net.slice{s}.{i}.weight`` and the heads as
    ``lin{i}.model.1.weight``; all are torch conv layouts already."""
    from streamingt2v_torch.diffusion.lpips import _VGG_STAGES

    m: MapDict = {}
    for si, idxs in enumerate(_VGG_STAGES):
        for li in idxs:
            _conv(m, f"vgg.conv_{li}", f"{vgg_prefix}.slice{si + 1}.{li}")
    p = f"{lin_prefix}." if lin_prefix else ""
    for i in range(len(_VGG_STAGES)):
        m[f"lin_{i}.kernel"] = (f"{p}lin{i}.model.1.weight", t_id)
    return m


def _keys(tk) -> tuple:
    return tk if isinstance(tk, tuple) else (tk,)


@torch.no_grad()
def convert_state_dict(state_dict: Dict[str, torch.Tensor], mapping: MapDict,
                       module: nn.Module) -> List[str]:
    """Copy ``mapping`` of ``state_dict`` into every parameter of ``module``,
    each tensor cast to its parameter's dtype and device as it is read.
    Strict on the module's side: a parameter without a mapping, a
    reference key absent from ``state_dict`` or a shape that differs raises,
    naming the key.  Returns the keys of ``state_dict`` that nothing
    consumed (real files carry extras)."""
    used = set()
    for name, target in module.state_dict(keep_vars=True).items():
        if name not in mapping:
            raise KeyError(f"no mapping for parameter {name}")
        tk, transform = mapping[name]
        keys = _keys(tk)
        absent = [k for k in keys if k not in state_dict]
        if absent:
            raise KeyError(f"reference key(s) {absent} (for {name}) not in the checkpoint")
        ws = [state_dict[k] for k in keys]
        try:
            w = transform(ws) if isinstance(tk, tuple) else transform(ws[0])
        except Exception as e:
            raise ValueError(f"cannot transform {list(keys)} (shapes "
                             f"{[tuple(x.shape) for x in ws]}) for {name} (expected "
                             f"{tuple(target.shape)}): {e}") from e
        if tuple(w.shape) != tuple(target.shape):
            raise ValueError(f"shape mismatch for {name} <- {tk}: {tuple(w.shape)} vs "
                             f"{tuple(target.shape)}")
        target.copy_(w)
        used.update(keys)
    return sorted(set(state_dict) - used)


def coverage_report(mapping: MapDict, module: nn.Module) -> Tuple[List[str], List[str]]:
    """(parameters without a mapping, mapped keys absent from the module);
    works on modules built on ``device="meta"``."""
    names = set(module.state_dict().keys())
    mapped = set(mapping.keys())
    return sorted(names - mapped), sorted(mapped - names)
