"""The three-stage StreamingT2V product, end to end, at tiny widths, on the
PyTorch port.

Stage 1 (streaming image-to-video autoregression) -> stage 2 (SDEdit
enhance with randomized blending) -> stage 3 (VFI 2x interpolation) -> a
.y4m video.  Random weights from a seed, tiny widths: this shows the
wiring, not the quality.  For real output, load the published checkpoints
with the CLI's ``--ckpt_dir`` (``python -m streamingt2v_torch.pipeline.cli``).

    python examples/torch/tiny_image_to_video.py                # on the card
    python examples/torch/tiny_image_to_video.py --device cpu   # without one
"""

import argparse
import dataclasses
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from streamingt2v_torch.config import EnhanceConfig, PipelineConfig, VAEConfig, VFIConfig
from streamingt2v_torch.models.clip import CLIPVisionConfig
from streamingt2v_torch.models.clip_text import CLIPTextConfig
from streamingt2v_torch.models.enhance.unet import I2VGenXLUNetConfig
from streamingt2v_torch.pipeline.build import build_enhance, build_interpolate, build_pipeline
from streamingt2v_torch.pipeline.full import StreamingT2VPipeline


def tiny_product(device: str, seed: int = 0) -> StreamingT2VPipeline:
    """The three stages at toy widths (the production config tree's
    ``tiny()`` forms), all in f32 on ``device``."""
    cfg = PipelineConfig.tiny()
    cfg = dataclasses.replace(
        cfg, use_randomized_blending=True,
        enhance=EnhanceConfig(num_steps=3, height=32, width=32, chunk_size=4, overlap_size=2,
                              use_randomized_blending=True, vae_bf16=False),
        inference=dataclasses.replace(cfg.inference, vae_decode_bf16=False),
        vfi=dataclasses.replace(VFIConfig.tiny(), tta=True))
    # the byte-level synthetic tokenizer needs a 514-token vocabulary
    text = CLIPTextConfig(vocab_size=514, width=32, layers=2, heads=2, max_length=8)
    enhance = build_enhance(
        cfg.enhance, seed, device=device, bf16=False, unet=I2VGenXLUNetConfig.tiny(),
        vae=dataclasses.replace(VAEConfig.tiny(), temporal_decoder=False),
        clip_vision=CLIPVisionConfig.tiny(), text=text, tokenizer_length=8)
    return StreamingT2VPipeline(cfg, build_pipeline(cfg, seed, device=device), enhance,
                                build_interpolate(cfg, seed, device=device))


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda", help="torch device (cpu without a card)")
    parser.add_argument("--output", default="tiny_demo.y4m", help="the .y4m file to write")
    parser.add_argument("--seed", type=int, default=33, help="the sampling seed")
    args = parser.parse_args(argv)

    pipe = tiny_product(args.device)
    image = (np.random.RandomState(0).rand(48, 48, 3) * 255).astype(np.uint8)
    video = pipe.run(image, args.output, seed=args.seed)     # uint8 (F, H, W, 3)
    print(f"wrote {args.output}: {video.shape[0]} frames {video.shape[1]}x{video.shape[2]}, "
          f"stages finite {pipe.stage_finite}")


if __name__ == "__main__":
    main()
