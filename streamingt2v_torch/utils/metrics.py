"""Video quality metrics (counterpart of ``streamingt2v_tpu/utils/metrics.py``).

MAWE (Motion-Aware Warp Error), the metric the reference README cites for
StreamingT2V: low warp error relative to the amount of motion, penalising
both flicker (high warp error) and stagnation (low motion).

    MAWE(V) = W(V) / (c * OFS(V))

W is the mean squared backward-warp error between consecutive frames under
the estimated optical flow, OFS the mean flow magnitude, and ``c``
calibrates the two scales (the paper uses c ~= 9.5).  The flow estimator is
pluggable; ``vfi_flow_fn`` adapts the port's EMA-VFI network.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from streamingt2v_torch.models.vfi import MultiScaleFlow
from streamingt2v_torch.ops.warp import backward_warp

FlowFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]  # (B,H,W,3)x2 -> (B,H,W,2)


def warp_error_and_ofs(video: torch.Tensor, flow_fn: FlowFn):
    """video: (F, H, W, 3) in [0, 1] -> (mean warp MSE, mean |flow|)."""
    f0, f1 = video[:-1], video[1:]
    flow = flow_fn(f0, f1)  # where each pixel of frame t is found in frame t+1
    w = torch.mean((backward_warp(f1, flow) - f0) ** 2)
    ofs = torch.mean(torch.sqrt(torch.sum(flow ** 2, dim=-1) + 1e-12))
    return w, ofs


def mawe(video: torch.Tensor, flow_fn: FlowFn, c: float = 9.5) -> torch.Tensor:
    w, ofs = warp_error_and_ofs(video, flow_fn)
    return w / (c * ofs.clamp_min(1e-6))


def mawe_chunked(video01_host: np.ndarray, flow_fn: FlowFn, c: float = 9.5,
                 pairs_per_call: int = 8, device="cuda") -> float:
    """MAWE of a host [0, 1] float video too long to hold on the device with
    its flows at once: frame pairs go to ``device`` in chunks, and the
    pair-weighted means reproduce ``mawe`` on the whole video."""
    f = int(video01_host.shape[0])
    w_sum = ofs_sum = 0.0
    n_pairs = 0
    for i in range(0, f - 1, pairs_per_call):
        n = min(pairs_per_call, f - 1 - i)
        chunk = torch.from_numpy(np.asarray(video01_host[i:i + n + 1], np.float32)).to(device)
        w, ofs = warp_error_and_ofs(chunk, flow_fn)
        w_sum += float(w) * n
        ofs_sum += float(ofs) * n
        n_pairs += n
    return float(w_sum / max(n_pairs, 1) / (c * max(ofs_sum / max(n_pairs, 1), 1e-6)))


def vfi_flow_fn(model: MultiScaleFlow) -> FlowFn:
    """The full-timestep flow of the first frame's branch as the t -> t+1
    optical flow estimate."""
    @torch.inference_mode()
    def flow_fn(img0, img1):
        flow, _ = model.calculate_flow(img0, img1, 1.0)
        return flow[..., 0:2]

    return flow_fn
