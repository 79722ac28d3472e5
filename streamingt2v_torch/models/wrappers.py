"""Denoiser-facing model wrappers (counterpart of
``streamingt2v_tpu/models/wrappers.py``).  Each builder returns
``network_fn(x, t_cont, cond) -> prediction``, the function the EDM
denoiser wraps."""

from __future__ import annotations

from typing import Any, Dict

import torch


def openai_wrapper(unet):
    """Plain SVD wrapper (the first chunk): concat c['concat'] to x
    channel-wise and call the UNet."""

    def network_fn(x: torch.Tensor, t_cont: torch.Tensor, cond: Dict[str, Any]) -> torch.Tensor:
        concat = cond.get("concat")
        if concat is not None:
            x = torch.cat([x, concat.to(x.dtype)], dim=-1)
        return unet(x, t_cont, cond.get("crossattn"), cond.get("vector"))

    return network_fn


def streaming_wrapper(unet, controlnet, num_frame_conditioning: int,
                      ctrl_cfg_shared: bool = False):
    """StreamingSVD wrapper: the ControlNet on the first
    ``num_frame_conditioning`` frames, its features fused by CAM.

    ``ctrl_cfg_shared``: the CFG halves carry identical ctrl pixel frames
    (the inference pipeline sets one tensor on c and uc), so the
    conditioning embedder runs on one copy."""
    f_cond = num_frame_conditioning

    def network_fn(x: torch.Tensor, t_cont: torch.Tensor, cond: Dict[str, Any]) -> torch.Tensor:
        concat = cond.get("concat")
        if concat is not None:
            x = torch.cat([x, concat.to(x.dtype)], dim=-1)
        context = cond.get("crossattn")
        y = cond.get("vector")
        ctrl_frames = cond["ctrl_frames"]  # (B', F_cond, H, W, 3)
        if ctrl_cfg_shared and ctrl_frames.shape[0] > 1:
            ctrl_frames = ctrl_frames[:1]
        # the ControlNet sees only the conditional frames and the first
        # context token
        hs_control, h_control_mid = controlnet(
            x[:, :f_cond], t_cont,
            context[:, :f_cond, :1] if context is not None else None,
            y[:, :f_cond] if y is not None else None,
            ctrl_frames)
        return unet(x, t_cont, context, y, hs_control=hs_control, h_control_mid=h_control_mid)

    return network_fn
