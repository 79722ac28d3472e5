"""Stage 3, EMA-VFI 2x frame interpolation over a whole video (counterpart
of ``streamingt2v_tpu/pipeline/interpolate.py``).

Keeps the first ``target_len//2+1`` frames, interpolates the midpoint of
every consecutive pair (flip-TTA as the configuration says), interleaves
them, and repeats the last frame when the target length is even.  Pairs go
through the network ``pair_batch`` at a time; a short last batch runs at
its own size.  The weights stay resident on the device.  With a ``mesh``
each pair batch is split over its ``data`` ranks (pairs do not interact:
the only collective is the gather of the midpoints); a batch they do not
divide runs whole on every rank.
"""

from __future__ import annotations

from typing import Optional

import torch

from streamingt2v_torch.models.vfi import MultiScaleFlow, interpolate_pair
from streamingt2v_torch.parallel.sharding import batch_rows, data_parallel, gather

# Pairs per network call at 720p with flip-TTA (each pair runs as two).  On
# an H100 80GB a pair took 0.166, 0.159, 0.155 and 0.154 s at batches 1, 2, 4
# and 8, with peaks of 5.5, 9.9, 18.7 and 36.2 GiB (PERF.md, stage 3): 4 is
# within 1% of the fastest at half its memory.
PAIR_BATCH = 4


class InterpolatePipeline:
    def __init__(self, model: MultiScaleFlow, tta: bool = True, pair_batch: int = PAIR_BATCH,
                 mesh=None):
        self.model = model
        self.tta = tta
        self.pair_batch = pair_batch
        self.mesh = mesh

    @property
    def device(self) -> torch.device:
        return self.model.unet.conv.kernel.device

    @torch.inference_mode()
    def interpolate_video(self, video: torch.Tensor, target_len: Optional[int] = None
                          ) -> torch.Tensor:
        """video (F, H, W, 3) in [0, 1] -> (target_len, H, W, 3) in [0, 1], f32,
        on the model's device; ``target_len`` defaults to 2F-1."""
        video = video.to(self.device, torch.float32)
        if target_len is not None:
            video = video[:target_len // 2 + 1]
        n = video.shape[0] - 1
        mids = torch.cat([self._pairs(video[s:min(s + self.pair_batch, n)],
                                      video[s + 1:min(s + self.pair_batch, n) + 1])
                          for s in range(0, n, self.pair_batch)])
        out = torch.stack([video[:-1], mids], dim=1).reshape((-1,) + video.shape[1:])
        out = torch.cat([out, video[-1:]])
        if target_len is not None:
            if target_len % 2 == 0:
                out = torch.cat([out, video[-1:]])
            out = out[:target_len]
        return out

    def _pairs(self, i0: torch.Tensor, i1: torch.Tensor) -> torch.Tensor:
        b = i0.shape[0]
        with data_parallel(self.mesh, b) as split:
            out = interpolate_pair(self.model, batch_rows(split, b, i0), batch_rows(split, b, i1),
                                   tta=self.tta)
            return gather(out, "batch") if split else out
