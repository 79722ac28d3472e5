"""Denoiser-facing model wrappers (counterpart of
``streamingt2v_tpu/models/wrappers.py``).  Each builder returns
``network_fn(x, t_cont, cond) -> prediction``, the function the EDM
denoiser wraps.

With a ``mesh`` (``parallel/mesh.py``) the call runs under it: the batch
(the CFG-doubled one, in the pipeline) is split over the ``data`` ranks
where they divide it, each rank runs the networks on its rows, and the
predictions are gathered, so every rank returns the whole batch.  The
networks split their own work over ``seq`` and ``model`` (``shard_params``
and the active mesh).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from streamingt2v_torch.parallel.sharding import batch_rows, data_parallel, gather


def openai_wrapper(unet, mesh=None):
    """Plain SVD wrapper (the first chunk): concat c['concat'] to x
    channel-wise and call the UNet."""

    def network_fn(x: torch.Tensor, t_cont: torch.Tensor, cond: Dict[str, Any]) -> torch.Tensor:
        concat = cond.get("concat")
        if concat is not None:
            x = torch.cat([x, concat.to(x.dtype)], dim=-1)
        b = x.shape[0]
        with data_parallel(mesh, b) as split:
            out = unet(*(batch_rows(split, b, v) for v in (x, t_cont, cond.get("crossattn"),
                                                      cond.get("vector"))))
            return gather(out, "batch") if split else out

    return network_fn


def streaming_wrapper(unet, controlnet, num_frame_conditioning: int,
                      ctrl_cfg_shared: bool = False, mesh=None):
    """StreamingSVD wrapper: the ControlNet on the first
    ``num_frame_conditioning`` frames, its features fused by CAM.

    ``ctrl_cfg_shared``: the CFG halves carry identical ctrl pixel frames
    (the inference pipeline sets one tensor on c and uc), so the
    conditioning embedder runs on one copy (on each data rank)."""
    f_cond = num_frame_conditioning

    def network_fn(x: torch.Tensor, t_cont: torch.Tensor, cond: Dict[str, Any]) -> torch.Tensor:
        concat = cond.get("concat")
        if concat is not None:
            x = torch.cat([x, concat.to(x.dtype)], dim=-1)
        ctrl_frames = cond["ctrl_frames"]  # (B', F_cond, H, W, 3)
        if ctrl_cfg_shared and ctrl_frames.shape[0] > 1:
            ctrl_frames = ctrl_frames[:1]
        b = x.shape[0]
        with data_parallel(mesh, b) as split:
            x, t_cont, context, y, ctrl_frames = (
                batch_rows(split, b, v) for v in (x, t_cont, cond.get("crossattn"), cond.get("vector"),
                                             ctrl_frames))
            # the ControlNet sees only the conditional frames and the first
            # context token
            hs_control, h_control_mid = controlnet(
                x[:, :f_cond], t_cont,
                context[:, :f_cond, :1] if context is not None else None,
                y[:, :f_cond] if y is not None else None,
                ctrl_frames)
            out = unet(x, t_cont, context, y, hs_control=hs_control,
                       h_control_mid=h_control_mid)
            return gather(out, "batch") if split else out

    return network_fn
