"""The three-stage product: image -> stage 1 -> stage 2 -> stage 3 -> file
(counterpart of ``streamingt2v_tpu/pipeline/full.py``).

Per input image, stage 1 generates (num_frames+1)//2 frames at 576x1024,
stage 2 SDEdit-enhances them at 720p (with the key-frame pre-pass and
randomized blending when ``use_randomized_blending``), stage 3
2x-interpolates them to num_frames, and the video is written at out_fps.
Frames cross each stage boundary as uint8, as in the reference.

All three model sets stay resident on the device; the JAX package's
between-stage offload and out-of-memory ladder are measures for a 16 GB
chip and are not ported.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from streamingt2v_torch.config import PipelineConfig
from streamingt2v_torch.pipeline.enhance import EnhancePipeline
from streamingt2v_torch.pipeline.interpolate import InterpolatePipeline
from streamingt2v_torch.pipeline.streaming import Stage1Pipeline
from streamingt2v_torch.utils import media
from streamingt2v_torch.utils.profiling import stage_timer
from streamingt2v_torch.utils.rng import EnhanceNoise, NoiseFn


def _finite(x: torch.Tensor) -> bool:
    return bool(torch.isfinite(x).all())


class StreamingT2VPipeline:
    """End-to-end pipeline.  Stages 2 and 3 may be None to run a prefix."""

    def __init__(self, cfg: PipelineConfig, stage1: Stage1Pipeline,
                 enhance: Optional[EnhancePipeline] = None,
                 interpolate: Optional[InterpolatePipeline] = None):
        self.cfg = cfg
        self.stage1 = stage1
        self.enhance = enhance
        self.interpolate = interpolate
        # whether each stage's float output of the last run was finite: the
        # uint8 conversion would hide NaNs
        self.stage_finite: dict = {}

    @torch.inference_mode()
    def image_to_video(self, image_u8: np.ndarray, seed: Optional[int] = None,
                       noise: Optional[NoiseFn] = None) -> np.ndarray:
        """uint8 (H, W, 3) -> uint8 stage-1 video ((num_frames+1)//2, 576, 1024, 3)."""
        cfg = self.cfg
        img = media.resize_to_stage1(image_u8, cfg.height, cfg.width)
        x = torch.from_numpy(media.to_model_range(img)).to(self.stage1.device)
        with stage_timer("stage1_i2v"):
            video = self.stage1.image_to_video(x, cfg.stage1_frames, seed, noise)
            self.stage_finite["stage1"] = _finite(video)
            return media.fetch_uint8(video)

    @torch.inference_mode()
    def enhance_video(self, video_u8: np.ndarray, image_u8: np.ndarray,
                      seed: Optional[int] = None,
                      noise: Optional[EnhanceNoise] = None) -> np.ndarray:
        """Stage 2: resize to (enhance.height, enhance.width) on the device,
        then SDEdit."""
        cfg = self.cfg.enhance
        dev = self.enhance.device
        video = media.resize_video(torch.tensor(video_u8, device=dev), cfg.height, cfg.width)
        image = media.resize_video(torch.tensor(image_u8[None], device=dev),
                                   cfg.height, cfg.width)[0]
        video_f = media.to_model_range(video)
        image_f = media.to_model_range(image)
        with stage_timer("stage2_enhance"):
            if self.cfg.use_randomized_blending:
                out = self.enhance.enhance_with_keyframe_prepass(video_f, image_f, seed,
                                                                 noise=noise)
            else:
                out = self.enhance.enhance(video_f, [image_f], seed=seed,
                                           use_randomized_blending=False, noise=noise)
            self.stage_finite["enhance"] = _finite(out)
            return media.fetch_uint8(out)

    @torch.inference_mode()
    def interpolate_video(self, video_u8: np.ndarray) -> np.ndarray:
        """Stage 3: 2x interpolation to num_frames."""
        video = media.put_unit_range(video_u8, self.interpolate.device)
        with stage_timer("stage3_vfi"):
            out = self.interpolate.interpolate_video(video, self.cfg.num_frames)
            self.stage_finite["vfi"] = _finite(out)
            return media.fetch_uint8(out, input_range=(0.0, 1.0))

    def run(self, image: Union[str, np.ndarray], output_path: Optional[str],
            seed: Optional[int] = None) -> np.ndarray:
        """The product from an image file or a uint8 (H, W, 3) array: writes
        the video (mp4 or y4m by the path's suffix; not with ``output_path``
        None, as the other ranks of a mesh run) and returns its uint8 frames
        (F, H, W, 3)."""
        image_u8 = media.load_image(image) if isinstance(image, str) else image
        video = self.image_to_video(image_u8, seed)
        if self.enhance is not None:
            video = self.enhance_video(video, image_u8, seed)
        if self.interpolate is not None:
            video = self.interpolate_video(video)
        if output_path is not None:
            media.save_video(output_path, video, fps=self.cfg.out_fps)
        return video

    def __call__(self, image: Union[str, np.ndarray], output_path: str,
                 seed: Optional[int] = None) -> str:
        self.run(image, output_path, seed)
        return output_path
