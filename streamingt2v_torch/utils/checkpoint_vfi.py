"""EMA-VFI checkpoint map (counterpart of
``streamingt2v_tpu/utils/checkpoint_vfi.py``).

Maps the reference's MultiScaleFlow state dict
(i2v_enhance/thirdparty/VFI/, keys under feature_bone./block./unet.)
onto ``streamingt2v_torch.models.vfi``.  torch Sequential(conv, PReLU)
pairs become ``{name}.conv`` + ``{name}.prelu``.  Every weight keeps its
torch layout: a depthwise conv is (C, 1, 3, 3) and a ConvTranspose2d
(in, out, kh, kw) on both sides.
"""

from __future__ import annotations

from typing import Dict

import torch

from streamingt2v_torch.config import VFIConfig
from streamingt2v_torch.utils.checkpoint import MapDict, _conv, _linear, _norm, t_id


def strip_ddp_keys(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The published checkpoint prefixes its keys with ``module.`` (a DDP
    artifact, reference Trainer.py:36-47) and carries the Swin blocks'
    ``attn_mask``/``HW`` buffers, which the port computes: drop both."""
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in sd.items()
            if "attn_mask" not in k and "HW" not in k}


def _conv_prelu(m: MapDict, fx: str, tk_conv: str, tk_prelu: str) -> None:
    _conv(m, f"{fx}.conv", tk_conv)
    m[f"{fx}.prelu"] = (f"{tk_prelu}.weight", t_id)


def vfi_map(cfg: VFIConfig, torch_prefix: str = "") -> MapDict:
    m: MapDict = {}
    p = f"{torch_prefix}." if torch_prefix else ""
    fb = f"{p}feature_bone"
    num_stages = len(cfg.embed_dims)
    conv_stages = num_stages - len(cfg.num_heads)

    for i in range(num_stages):
        fbx = f"feature_bone.block_{i}"
        if i < conv_stages:
            if i > 0:
                m[f"feature_bone.patch_embed_{i}_conv.kernel"] = (
                    f"{fb}.patch_embed{i+1}.0.weight", t_id)
                m[f"feature_bone.patch_embed_{i}_conv.bias"] = (
                    f"{fb}.patch_embed{i+1}.0.bias", t_id)
                m[f"feature_bone.patch_embed_{i}_prelu"] = (
                    f"{fb}.patch_embed{i+1}.1.weight", t_id)
            for j in range(cfg.depths[i]):
                _conv_prelu(m, f"{fbx}.layer_{j}",
                            f"{fb}.block{i+1}.conv.{2*j}", f"{fb}.block{i+1}.conv.{2*j+1}")
        else:
            pe = f"{fb}.patch_embed{i+1}"
            pex = f"feature_bone.patch_embed_{i}"
            if i == conv_stages:
                n_layers = sum(2**k for k in range(conv_stages))
                for k in range(n_layers):
                    _conv(m, f"{pex}.layer_{k}", f"{pe}.layers.{k}")
            _conv(m, f"{pex}.proj", f"{pe}.proj")
            _norm(m, f"{pex}.norm", f"{pe}.norm")
            for j in range(cfg.depths[i]):
                bx = f"feature_bone.block_{i}_{j}"
                bt = f"{fb}.block{i+1}.{j}"
                _norm(m, f"{bx}.norm1", f"{bt}.norm1")
                _norm(m, f"{bx}.norm2", f"{bt}.norm2")
                _linear(m, f"{bx}.attn.q", f"{bt}.attn.q")
                _linear(m, f"{bx}.attn.kv", f"{bt}.attn.kv")
                _linear(m, f"{bx}.attn.cor_embed", f"{bt}.attn.cor_embed")
                _linear(m, f"{bx}.attn.proj", f"{bt}.attn.proj")
                _linear(m, f"{bx}.attn.motion_proj", f"{bt}.attn.motion_proj")
                _linear(m, f"{bx}.mlp_fc1", f"{bt}.mlp.fc1")
                _conv(m, f"{bx}.mlp_dwconv", f"{bt}.mlp.dwconv.dwconv")
                _linear(m, f"{bx}.mlp_fc2", f"{bt}.mlp.fc2")
            _norm(m, f"feature_bone.norm_{i}", f"{fb}.norm{i+1}")

    # flow heads (reference self.block.{i})
    for i in range(len(cfg.hidden_dims)):
        for j in range(3):
            _conv_prelu(m, f"head_{i}.conv_{j}",
                        f"{p}block.{i}.conv.{j}.0", f"{p}block.{i}.conv.{j}.1")

    # refine unet
    for k in range(4):
        _conv_prelu(m, f"unet.down{k}_0",
                    f"{p}unet.down{k}.conv1.0", f"{p}unet.down{k}.conv1.1")
        _conv_prelu(m, f"unet.down{k}_1",
                    f"{p}unet.down{k}.conv2.0", f"{p}unet.down{k}.conv2.1")
        # ConvTranspose2d (in, out, kh, kw): the port's layout
        _conv(m, f"unet.up{k}_deconv", f"{p}unet.up{k}.0")
        m[f"unet.up{k}_prelu"] = (f"{p}unet.up{k}.1.weight", t_id)
    _conv(m, "unet.conv", f"{p}unet.conv")
    return m
