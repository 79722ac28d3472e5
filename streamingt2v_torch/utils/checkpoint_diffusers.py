"""Diffusers/HF-layout checkpoint maps (counterpart of
``streamingt2v_tpu/utils/checkpoint_diffusers.py``).

The reference pulls three published model trees in diffusers/HF naming:
  - ali-vilab/i2vgen-xl: unet (I2VGenXLUNet), vae (AutoencoderKL),
    text_encoder (CLIPTextModel), image_encoder
    (CLIPVisionModelWithProjection)  [config.yaml:19-22]
  - stabilityai/stable-video-diffusion-img2vid-xt: the first-chunk UNet
    (UNetSpatioTemporalConditionModel)  [config.yaml:283-300]

This module maps those names onto the port's modules, keyed by the port's
parameter names; ``convert_state_dict`` checks every shape as it copies.
"""

from __future__ import annotations

from streamingt2v_torch.config import VAEConfig, VideoUNetConfig
from streamingt2v_torch.models.clip import CLIPVisionConfig
from streamingt2v_torch.models.clip_text import CLIPTextConfig
from streamingt2v_torch.models.enhance.unet import I2VGenXLUNetConfig
from streamingt2v_torch.utils.checkpoint import (
    MapDict,
    _conv,
    _linear,
    _norm,
    t_cat,
    t_id,
    t_linear_to_conv1x1,
    t_transpose,
)


# ---------------------------------------------------------------------------
# diffusers AutoencoderKL (the i2vgen-xl / SD VAE)
# ---------------------------------------------------------------------------

def _d_resnet(m: MapDict, fx: str, tk: str, channel_change: bool) -> None:
    _norm(m, f"{fx}.norm1", f"{tk}.norm1")
    _conv(m, f"{fx}.conv1", f"{tk}.conv1")
    _norm(m, f"{fx}.norm2", f"{tk}.norm2")
    _conv(m, f"{fx}.conv2", f"{tk}.conv2")
    if channel_change:
        _conv(m, f"{fx}.nin_shortcut", f"{tk}.conv_shortcut")


def _d_vae_attn(m: MapDict, fx: str, tk: str) -> None:
    """diffusers VAE mid attention: GroupNorm + LINEAR q/k/v/out -> the
    port's 1x1-conv AttnBlock."""
    _norm(m, f"{fx}.norm", f"{tk}.group_norm")
    for ours, theirs in (("q", "to_q"), ("k", "to_k"), ("v", "to_v"), ("proj_out", "to_out.0")):
        m[f"{fx}.{ours}.kernel"] = (f"{tk}.{theirs}.weight", t_linear_to_conv1x1)
        m[f"{fx}.{ours}.bias"] = (f"{tk}.{theirs}.bias", t_id)


def diffusers_vae_map(cfg: VAEConfig, torch_prefix: str = "") -> MapDict:
    """Spatial AutoencoderKL with quant convs (the enhance-stage VAE)."""
    p = f"{torch_prefix}." if torch_prefix else ""
    m: MapDict = {}
    # encoder
    _conv(m, "encoder.conv_in", f"{p}encoder.conv_in")
    ch_prev = cfg.ch
    for i, mult in enumerate(cfg.ch_mult):
        ch_out = cfg.ch * mult
        for j in range(cfg.num_res_blocks):
            _d_resnet(m, f"encoder.down_{i}_block_{j}",
                      f"{p}encoder.down_blocks.{i}.resnets.{j}", ch_prev != ch_out)
            ch_prev = ch_out
        if i != len(cfg.ch_mult) - 1:
            _conv(m, f"encoder.down_{i}_downsample.conv",
                  f"{p}encoder.down_blocks.{i}.downsamplers.0.conv")
    _d_resnet(m, "encoder.mid_block_1", f"{p}encoder.mid_block.resnets.0", False)
    _d_vae_attn(m, "encoder.mid_attn_1", f"{p}encoder.mid_block.attentions.0")
    _d_resnet(m, "encoder.mid_block_2", f"{p}encoder.mid_block.resnets.1", False)
    _norm(m, "encoder.norm_out", f"{p}encoder.conv_norm_out")
    _conv(m, "encoder.conv_out", f"{p}encoder.conv_out")
    # decoder: diffusers up_blocks run deepest-first (index 0 = deepest)
    _conv(m, "decoder.conv_in", f"{p}decoder.conv_in")
    _d_resnet(m, "decoder.mid_block_1", f"{p}decoder.mid_block.resnets.0", False)
    _d_vae_attn(m, "decoder.mid_attn_1", f"{p}decoder.mid_block.attentions.0")
    _d_resnet(m, "decoder.mid_block_2", f"{p}decoder.mid_block.resnets.1", False)
    n = len(cfg.ch_mult)
    ch_prev = cfg.ch * cfg.ch_mult[-1]
    for bi, i in enumerate(reversed(range(n))):  # bi: diffusers index
        ch_out = cfg.ch * cfg.ch_mult[i]
        for j in range(cfg.num_res_blocks + 1):
            _d_resnet(m, f"decoder.up_{i}_block_{j}",
                      f"{p}decoder.up_blocks.{bi}.resnets.{j}", ch_prev != ch_out)
            ch_prev = ch_out
        if i != 0:
            _conv(m, f"decoder.up_{i}_upsample.conv",
                  f"{p}decoder.up_blocks.{bi}.upsamplers.0.conv")
    _norm(m, "decoder.norm_out", f"{p}decoder.conv_norm_out")
    _conv(m, "decoder.conv_out", f"{p}decoder.conv_out")
    _conv(m, "quant_conv", f"{p}quant_conv")
    _conv(m, "post_quant_conv", f"{p}post_quant_conv")
    return m


# ---------------------------------------------------------------------------
# HF CLIP text + vision
# ---------------------------------------------------------------------------

def hf_clip_text_map(cfg: CLIPTextConfig, torch_prefix: str = "text_model") -> MapDict:
    p = torch_prefix
    m: MapDict = {}
    m["token_embedding.embedding"] = (f"{p}.embeddings.token_embedding.weight", t_id)
    m["position_embedding"] = (f"{p}.embeddings.position_embedding.weight", t_id)
    for i in range(cfg.layers):
        b = f"{p}.encoder.layers.{i}"
        fx = f"layer_{i}"
        _norm(m, f"{fx}.ln1", f"{b}.layer_norm1")
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _linear(m, f"{fx}.{proj}", f"{b}.self_attn.{proj}")
        _norm(m, f"{fx}.ln2", f"{b}.layer_norm2")
        _linear(m, f"{fx}.fc1", f"{b}.mlp.fc1")
        _linear(m, f"{fx}.fc2", f"{b}.mlp.fc2")
    _norm(m, "final_ln", f"{p}.final_layer_norm")
    return m


def hf_clip_vision_map(cfg: CLIPVisionConfig,
                       torch_prefix: str = "vision_model") -> MapDict:
    """HF CLIPVisionModelWithProjection -> CLIPVisionTower.  HF stores
    separate q/k/v projections; the tower uses a fused in_proj."""
    p = torch_prefix
    m: MapDict = {}
    m["conv1.kernel"] = (f"{p}.embeddings.patch_embedding.weight", t_id)
    m["class_embedding"] = (f"{p}.embeddings.class_embedding", t_id)
    m["positional_embedding"] = (f"{p}.embeddings.position_embedding.weight", t_id)
    _norm(m, "ln_pre", f"{p}.pre_layrnorm")  # (sic) HF attribute name
    for i in range(cfg.layers):
        b = f"{p}.encoder.layers.{i}"
        fx = f"resblock_{i}"
        _norm(m, f"{fx}.ln_1", f"{b}.layer_norm1")
        m[f"{fx}.attn.in_proj.kernel"] = (
            (f"{b}.self_attn.q_proj.weight", f"{b}.self_attn.k_proj.weight",
             f"{b}.self_attn.v_proj.weight"),
            t_cat,
        )
        m[f"{fx}.attn.in_proj.bias"] = (
            (f"{b}.self_attn.q_proj.bias", f"{b}.self_attn.k_proj.bias",
             f"{b}.self_attn.v_proj.bias"),
            t_cat,
        )
        _linear(m, f"{fx}.attn.out_proj", f"{b}.self_attn.out_proj")
        _norm(m, f"{fx}.ln_2", f"{b}.layer_norm2")
        _linear(m, f"{fx}.mlp_fc", f"{b}.mlp.fc1")
        _linear(m, f"{fx}.mlp_proj", f"{b}.mlp.fc2")
    _norm(m, "ln_post", f"{p}.post_layernorm")
    # the tower holds its projection as (width, output_dim)
    m["proj"] = ("visual_projection.weight", t_transpose)
    return m


# ---------------------------------------------------------------------------
# diffusers I2VGenXLUNet
# ---------------------------------------------------------------------------

def _d_resnet2d(m: MapDict, fx: str, tk: str, channel_change: bool) -> None:
    _norm(m, f"{fx}.norm1", f"{tk}.norm1")
    _conv(m, f"{fx}.conv1", f"{tk}.conv1")
    _linear(m, f"{fx}.time_emb_proj", f"{tk}.time_emb_proj")
    _norm(m, f"{fx}.norm2", f"{tk}.norm2")
    _conv(m, f"{fx}.conv2", f"{tk}.conv2")
    if channel_change:
        _conv(m, f"{fx}.conv_shortcut", f"{tk}.conv_shortcut")


def _d_temporal_conv(m: MapDict, fx: str, tk: str) -> None:
    # diffusers TemporalConvLayer: conv1 = Sequential(GN, SiLU, Conv3d)
    # but conv2-4 insert a Dropout, shifting the conv to index 3
    # (diffusers models/resnet.py, mirrored at the reference's pinned
    # version).
    for name, ci in (("conv1", 2), ("conv2", 3), ("conv3", 3), ("conv4", 3)):
        _norm(m, f"{fx}.{name}_norm", f"{tk}.{name}.0")
        _conv(m, f"{fx}.{name}", f"{tk}.{name}.{ci}", dims=3)


def _d_basic_block(m: MapDict, fx: str, tk: str) -> None:
    for i in (1, 2, 3):
        _norm(m, f"{fx}.norm{i}", f"{tk}.norm{i}")
    for attn in ("attn1", "attn2"):
        _linear(m, f"{fx}.{attn}.to_q", f"{tk}.{attn}.to_q", bias=False)
        _linear(m, f"{fx}.{attn}.to_k", f"{tk}.{attn}.to_k", bias=False)
        _linear(m, f"{fx}.{attn}.to_v", f"{tk}.{attn}.to_v", bias=False)
        _linear(m, f"{fx}.{attn}.to_out", f"{tk}.{attn}.to_out.0")
    _linear(m, f"{fx}.ff.proj", f"{tk}.ff.net.0.proj")
    _linear(m, f"{fx}.ff.out", f"{tk}.ff.net.2")


def _d_transformer2d(m: MapDict, fx: str, tk: str) -> None:
    """use_linear_projection=True throughout (get_down_block/get_up_block
    defaults, unet_3d_blocks.py:96,189): the shipped i2vgen-xl checkpoint
    stores 2D Linear proj_in/proj_out weights where the port's Transformer2D
    has a 1x1 conv (identical math)."""
    _norm(m, f"{fx}.norm", f"{tk}.norm")
    m[f"{fx}.proj_in.kernel"] = (f"{tk}.proj_in.weight", t_linear_to_conv1x1)
    m[f"{fx}.proj_in.bias"] = (f"{tk}.proj_in.bias", t_id)
    _d_basic_block(m, f"{fx}.block_0", f"{tk}.transformer_blocks.0")
    m[f"{fx}.proj_out.kernel"] = (f"{tk}.proj_out.weight", t_linear_to_conv1x1)
    m[f"{fx}.proj_out.bias"] = (f"{tk}.proj_out.bias", t_id)


def _d_transformer_temporal(m: MapDict, fx: str, tk: str) -> None:
    _norm(m, f"{fx}.norm", f"{tk}.norm")
    _linear(m, f"{fx}.proj_in", f"{tk}.proj_in")
    _d_basic_block(m, f"{fx}.block_0", f"{tk}.transformer_blocks.0")
    _linear(m, f"{fx}.proj_out", f"{tk}.proj_out")


def i2vgen_unet_map(cfg: I2VGenXLUNetConfig, torch_prefix: str = "") -> MapDict:
    p = f"{torch_prefix}." if torch_prefix else ""
    m: MapDict = {}
    _conv(m, "conv_in", f"{p}conv_in")
    _d_transformer_temporal(m, "transformer_in", f"{p}transformer_in")
    # image latent projections (Sequential conv indices 0,2,4)
    for fx, idx in (("ilp_conv1", 0), ("ilp_conv2", 2), ("ilp_conv3", 4)):
        _conv(m, fx, f"{p}image_latents_proj_in.{idx}")
    te = f"{p}image_latents_temporal_encoder"
    _norm(m, "image_latents_temporal_encoder.norm1", f"{te}.norm1")
    _linear(m, "image_latents_temporal_encoder.to_q", f"{te}.attn1.to_q", bias=False)
    _linear(m, "image_latents_temporal_encoder.to_k", f"{te}.attn1.to_k", bias=False)
    _linear(m, "image_latents_temporal_encoder.to_v", f"{te}.attn1.to_v", bias=False)
    _linear(m, "image_latents_temporal_encoder.to_out", f"{te}.attn1.to_out.0")
    # diffusers FeedForward('gelu'): net.0 is a GELU module holding .proj
    _linear(m, "image_latents_temporal_encoder.ff_fc", f"{te}.ff.net.0.proj")
    _linear(m, "image_latents_temporal_encoder.ff_out", f"{te}.ff.net.2")
    # context embedding convs (Sequential [conv, silu, pool, conv, silu, conv])
    for fx, idx in (("ilce_conv1", 0), ("ilce_conv2", 3), ("ilce_conv3", 5)):
        _conv(m, fx, f"{p}image_latents_context_embedding.{idx}")
    _linear(m, "time_embedding_1", f"{p}time_embedding.linear_1")
    _linear(m, "time_embedding_2", f"{p}time_embedding.linear_2")
    _linear(m, "fps_embedding_1", f"{p}fps_embedding.0")
    _linear(m, "fps_embedding_2", f"{p}fps_embedding.2")
    _linear(m, "context_embedding_1", f"{p}context_embedding.0")
    _linear(m, "context_embedding_2", f"{p}context_embedding.2")

    n = len(cfg.block_out_channels)
    ch_prev = cfg.block_out_channels[0]
    for i, c_out in enumerate(cfg.block_out_channels):
        cross = i < n - 1
        tb = f"{p}down_blocks.{i}"
        for j in range(cfg.layers_per_block):
            _d_resnet2d(m, f"down_{i}_res_{j}", f"{tb}.resnets.{j}", ch_prev != c_out)
            _d_temporal_conv(m, f"down_{i}_tconv_{j}", f"{tb}.temp_convs.{j}")
            if cross:
                _d_transformer2d(m, f"down_{i}_attn_{j}", f"{tb}.attentions.{j}")
                _d_transformer_temporal(m, f"down_{i}_tattn_{j}", f"{tb}.temp_attentions.{j}")
            ch_prev = c_out
        if i < n - 1:
            # diffusers Downsample2D(name="op") stores under .op
            # (unet_3d_blocks.py:495-501)
            _conv(m, f"down_{i}_downsample", f"{tb}.downsamplers.0.op")

    mb = f"{p}mid_block"
    _d_resnet2d(m, "mid_res_0", f"{mb}.resnets.0", False)
    _d_temporal_conv(m, "mid_tconv_0", f"{mb}.temp_convs.0")
    _d_transformer2d(m, "mid_attn", f"{mb}.attentions.0")
    _d_transformer_temporal(m, "mid_tattn", f"{mb}.temp_attentions.0")
    _d_resnet2d(m, "mid_res_1", f"{mb}.resnets.1", False)
    _d_temporal_conv(m, "mid_tconv_1", f"{mb}.temp_convs.1")

    rev = list(reversed(cfg.block_out_channels))
    skips = [cfg.block_out_channels[0]]
    ch = cfg.block_out_channels[0]
    for i, c_out in enumerate(cfg.block_out_channels):
        for j in range(cfg.layers_per_block):
            ch = c_out
            skips.append(ch)
        if i < n - 1:
            skips.append(ch)
    ch = rev[0]
    for i in range(n):
        c_out = rev[i]
        cross = i > 0
        tb = f"{p}up_blocks.{i}"
        for j in range(cfg.layers_per_block + 1):
            skip_ch = skips.pop()
            _d_resnet2d(m, f"up_{i}_res_{j}", f"{tb}.resnets.{j}",
                        channel_change=(ch + skip_ch != c_out))
            ch = c_out
            _d_temporal_conv(m, f"up_{i}_tconv_{j}", f"{tb}.temp_convs.{j}")
            if cross:
                _d_transformer2d(m, f"up_{i}_attn_{j}", f"{tb}.attentions.{j}")
                _d_transformer_temporal(m, f"up_{i}_tattn_{j}", f"{tb}.temp_attentions.{j}")
        if i < n - 1:
            _conv(m, f"up_{i}_upsample", f"{tb}.upsamplers.0.conv")

    _norm(m, "conv_norm_out", f"{p}conv_norm_out")
    _conv(m, "conv_out", f"{p}conv_out")
    return m


# ---------------------------------------------------------------------------
# diffusers UNetSpatioTemporalConditionModel (SVD-XT, the first-chunk UNet)
# ---------------------------------------------------------------------------

def _d_st_res_block(m: MapDict, fx: str, tk: str, channel_change: bool) -> None:
    """SpatioTemporalResBlock -> UNetVideoResBlock."""
    sp = f"{tk}.spatial_res_block"
    _norm(m, f"{fx}.spatial.in_norm", f"{sp}.norm1")
    _conv(m, f"{fx}.spatial.in_conv", f"{sp}.conv1")
    _linear(m, f"{fx}.spatial.emb_proj", f"{sp}.time_emb_proj")
    _norm(m, f"{fx}.spatial.out_norm", f"{sp}.norm2")
    _conv(m, f"{fx}.spatial.out_conv", f"{sp}.conv2")
    if channel_change:
        _conv(m, f"{fx}.spatial.skip", f"{sp}.conv_shortcut")
    tp = f"{tk}.temporal_res_block"
    _norm(m, f"{fx}.time_stack.in_norm", f"{tp}.norm1")
    _conv(m, f"{fx}.time_stack.in_conv", f"{tp}.conv1", dims=3)
    _linear(m, f"{fx}.time_stack.emb_proj", f"{tp}.time_emb_proj")
    _norm(m, f"{fx}.time_stack.out_norm", f"{tp}.norm2")
    _conv(m, f"{fx}.time_stack.out_conv", f"{tp}.conv2", dims=3)
    m[f"{fx}.time_mixer_mix_factor"] = (f"{tk}.time_mixer.mix_factor", t_id)


def _d_st_attention(m: MapDict, fx: str, tk: str, depth: int) -> None:
    """TransformerSpatioTemporalModel -> SpatialVideoTransformer."""
    _norm(m, f"{fx}.norm", f"{tk}.norm")
    _linear(m, f"{fx}.proj_in", f"{tk}.proj_in")
    for d in range(depth):
        _d_basic_block(m, f"{fx}.block_{d}", f"{tk}.transformer_blocks.{d}")
        tb = f"{tk}.temporal_transformer_blocks.{d}"
        fb = f"{fx}.time_block_{d}"
        _norm(m, f"{fb}.norm_in", f"{tb}.norm_in")
        _linear(m, f"{fb}.ff_in.proj", f"{tb}.ff_in.net.0.proj")
        _linear(m, f"{fb}.ff_in.out", f"{tb}.ff_in.net.2")
        _d_basic_block(m, fb, tb)
    _linear(m, f"{fx}.time_pos_embed_0", f"{tk}.time_pos_embed.linear_1")
    _linear(m, f"{fx}.time_pos_embed_2", f"{tk}.time_pos_embed.linear_2")
    m[f"{fx}.time_mixer_mix_factor"] = (f"{tk}.time_mixer.mix_factor", t_id)
    _linear(m, f"{fx}.proj_out", f"{tk}.proj_out")


def svd_unet_map(cfg: VideoUNetConfig, torch_prefix: str = "") -> MapDict:
    """diffusers SVD-XT UNet names -> the port's VideoUNet
    (controlnet_mode=False).  Block indices: down_blocks.{level}.resnets/
    attentions.{j}; up_blocks run deepest-first."""
    if cfg.controlnet_mode:
        raise ValueError("svd_unet_map is for the first-chunk UNet (controlnet_mode=False)")
    p = f"{torch_prefix}." if torch_prefix else ""
    m: MapDict = {}
    _conv(m, "in_conv", f"{p}conv_in")
    _linear(m, "time_embed_0", f"{p}time_embedding.linear_1")
    _linear(m, "time_embed_2", f"{p}time_embedding.linear_2")
    _linear(m, "label_emb_0", f"{p}add_embedding.linear_1")
    _linear(m, "label_emb_2", f"{p}add_embedding.linear_2")

    blk = 0
    ch = cfg.model_channels
    ds = 1
    for level, mult in enumerate(cfg.channel_mult):
        tb = f"{p}down_blocks.{level}"
        for j in range(cfg.num_res_blocks):
            ch_out = mult * cfg.model_channels
            _d_st_res_block(m, f"input_{blk}_res", f"{tb}.resnets.{j}", ch != ch_out)
            if ds in cfg.attention_resolutions:
                _d_st_attention(m, f"input_{blk}_attn", f"{tb}.attentions.{j}",
                                cfg.transformer_depth)
            ch = ch_out
            blk += 1
        if level != len(cfg.channel_mult) - 1:
            ds *= 2
            _conv(m, f"input_{blk}_down.conv", f"{tb}.downsamplers.0.conv")
            blk += 1

    mb = f"{p}mid_block"
    _d_st_res_block(m, "middle_res_0", f"{mb}.resnets.0", False)
    _d_st_attention(m, "middle_attn", f"{mb}.attentions.0", cfg.transformer_depth)
    _d_st_res_block(m, "middle_res_1", f"{mb}.resnets.1", False)

    input_chans = [cfg.model_channels]
    ch2 = cfg.model_channels
    for level, mult in enumerate(cfg.channel_mult):
        for _ in range(cfg.num_res_blocks):
            ch2 = mult * cfg.model_channels
            input_chans.append(ch2)
        if level != len(cfg.channel_mult) - 1:
            input_chans.append(ch2)

    blk = 0
    for ui, (level, mult) in enumerate(reversed(list(enumerate(cfg.channel_mult)))):
        tb = f"{p}up_blocks.{ui}"
        for j in range(cfg.num_res_blocks + 1):
            ich = input_chans.pop()
            ch_out = cfg.model_channels * mult
            _d_st_res_block(m, f"output_{blk}_res", f"{tb}.resnets.{j}",
                            channel_change=(ch + ich != ch_out))
            ch = ch_out
            if ds in cfg.attention_resolutions:
                _d_st_attention(m, f"output_{blk}_attn", f"{tb}.attentions.{j}",
                                cfg.transformer_depth)
            if level and j == cfg.num_res_blocks:
                ds //= 2
                _conv(m, f"output_{blk}_up.conv", f"{tb}.upsamplers.0.conv")
            blk += 1

    _norm(m, "out_norm", f"{p}conv_norm_out")
    _conv(m, "out_conv", f"{p}conv_out")
    return m
