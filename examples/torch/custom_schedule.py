"""Every sampler x discretization x guider on one denoiser, on the PyTorch
port.

``make_sampler(SamplerConfig)`` builds the whole sampling loop for any
combination of
  kind           euler_edm | heun_edm | euler_ancestral | dpmpp2s | dpmpp2m | lms
  discretization edm | legacy_ddpm | align_your_steps
  guider         vanilla | linear_prediction | triangle_prediction | identity
(reference: sgm sampling.py / discretizer.py / guiders.py), here around
the tiny first-chunk VideoUNet with random weights from a seed.

    python examples/torch/custom_schedule.py                # on the card
    python examples/torch/custom_schedule.py --device cpu   # without one
"""

import argparse
import itertools
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from streamingt2v_torch.config import GuiderConfig, SamplerConfig, VideoUNetConfig
from streamingt2v_torch.diffusion.denoiser import denoise
from streamingt2v_torch.diffusion.samplers import make_sampler
from streamingt2v_torch.models.layers import init_random_
from streamingt2v_torch.models.video_unet import VideoUNet
from streamingt2v_torch.models.wrappers import openai_wrapper

KINDS = ("euler_edm", "heun_edm", "euler_ancestral", "dpmpp2s", "dpmpp2m", "lms")
DISCRETIZATIONS = ("edm", "legacy_ddpm", "align_your_steps")
GUIDERS = ("vanilla", "linear_prediction", "triangle_prediction", "identity")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda", help="torch device (cpu without a card)")
    parser.add_argument("--steps", type=int, default=4, help="sampler steps")
    args = parser.parse_args(argv)
    dev = torch.device(args.device)

    ucfg = VideoUNetConfig.tiny(controlnet_mode=False)
    unet = init_random_(VideoUNet(ucfg).eval(), torch.Generator().manual_seed(0)).to(dev)
    net = openai_wrapper(unet)

    b, t, h, w = 1, 2, 16, 16
    rng = np.random.RandomState(0)

    def draw(*shape, std=0.1):
        return torch.from_numpy((rng.randn(*shape) * std).astype(np.float32)).to(dev)

    cond = {"concat": torch.zeros(b, t, h, w, 4, device=dev),
            "crossattn": draw(b, t, 1, ucfg.context_dim),
            "vector": draw(b, t, ucfg.adm_in_channels)}
    # the unconditional branch: the embeddings zeroed, as a CFG pipeline passes them
    uc = {k: v if k == "concat" else torch.zeros_like(v) for k, v in cond.items()}
    noise = draw(b, t, h, w, 4, std=1.0)

    def denoise_fn(x, sigma, c):
        return denoise(net, x, sigma, c)

    with torch.inference_mode():
        for kind, disc, guider in itertools.product(KINDS, DISCRETIZATIONS, GUIDERS):
            cfg = SamplerConfig(kind=kind, discretization=disc, num_steps=args.steps,
                                guider=GuiderConfig(kind=guider, max_scale=2.5, num_frames=t))
            out = make_sampler(cfg)(denoise_fn, noise, cond, uc)
            print(f"{kind:16s} + {disc:16s} + {guider:19s} -> {tuple(out.shape)}, "
                  f"std {float(out.std()):.3f}, finite={bool(torch.isfinite(out).all())}")


if __name__ == "__main__":
    main()
