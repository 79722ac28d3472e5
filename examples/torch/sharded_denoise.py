"""A guided streaming denoise step over a (data, seq, model) mesh, on the
PyTorch port.

The tiny streaming pair (the CAM-fused VideoUNet and its ControlNet) with
random weights from a seed, one process per rank: ``shard_params`` keeps
each rank's slice of the tensor-parallel weights (attention heads, FF
inner widths) on ``model``, the wrapper splits the CFG batch over
``data``, and the spatial transformers split their tokens over ``seq``
(ring attention).  Every rank ends with the whole denoised batch.

    torchrun --nproc_per_node=8 examples/torch/sharded_denoise.py --device cpu   # gloo
    torchrun --nproc_per_node=8 examples/torch/sharded_denoise.py                # NCCL, a card a rank

Without torchrun it runs in one process at ``--mesh 1,1,1``.  ``--output
FILE`` saves rank 0's result (``torch.save``).
"""

import argparse
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from streamingt2v_torch.config import ControlNetConfig, GuiderConfig, MeshConfig, VideoUNetConfig
from streamingt2v_torch.diffusion.denoiser import denoise
from streamingt2v_torch.diffusion.guiders import make_guider
from streamingt2v_torch.models.controlnet import ControlNet
from streamingt2v_torch.models.layers import init_random_
from streamingt2v_torch.models.video_unet import VideoUNet
from streamingt2v_torch.models.wrappers import streaming_wrapper
from streamingt2v_torch.parallel import multihost
from streamingt2v_torch.parallel.mesh import create_mesh
from streamingt2v_torch.parallel.sharding import shard_params


def random_weights(module: torch.nn.Module, gen: torch.Generator) -> torch.nn.Module:
    """The flax initialisers (``init_random_``), then every parameter they
    leave constant drawn as well: the zero-initialised output layers
    (``proj_out``, CAM's) would otherwise keep the transformers and the CAM
    fusion out of the result."""
    init_random_(module, gen)
    with torch.no_grad():
        for p in module.parameters():
            if p.numel() and bool(p.min() == p.max()):
                p.add_(0.1 * torch.randn(p.shape, generator=gen))
    return module


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--mesh", default=None,
                        help="D,S,M (default 2,2,2 under torchrun, else 1,1,1)")
    parser.add_argument("--device", default="cuda", help="cuda (NCCL) or cpu (gloo)")
    parser.add_argument("--output", default=None, help="save rank 0's result here")
    args = parser.parse_args(argv)
    mesh_arg = args.mesh or ("2,2,2" if os.environ.get("WORLD_SIZE") else "1,1,1")
    multihost.initialize(backend="gloo" if args.device == "cpu" else None)
    mesh = create_mesh(MeshConfig(*(int(v) for v in mesh_arg.split(","))))
    dev = torch.device("cpu") if args.device == "cpu" else mesh.device

    ucfg, ccfg = VideoUNetConfig.tiny(controlnet_mode=True), ControlNetConfig.tiny()
    gen = torch.Generator().manual_seed(0)     # the same weights on every rank
    unet = random_weights(VideoUNet(ucfg).eval(), gen).to(dev)
    cn = random_weights(ControlNet(ucfg, ccfg).eval(), gen).to(dev)
    shard_params(unet, mesh)
    shard_params(cn, mesh)

    b, t, fc, h, w = 1, 4, 2, 16, 16
    scale = 2 ** (len(ccfg.conditioning_embedding_out_channels) - 1)
    rng = np.random.RandomState(0)

    def draw(*shape):
        return torch.from_numpy((rng.randn(*shape) * 0.1).astype(np.float32)).to(dev)

    x = draw(b, t, h, w, 4)
    cond = {"concat": draw(b, t, h, w, 4), "crossattn": draw(b, t, 1, ucfg.context_dim),
            "vector": draw(b, t, ucfg.adm_in_channels),
            "ctrl_frames": draw(b, fc, h * scale, w * scale, 3)}
    uc = {k: v if k == "ctrl_frames" else torch.zeros_like(v) for k, v in cond.items()}
    guider = make_guider(GuiderConfig(kind="linear_prediction", max_scale=2.5, num_frames=t))
    net = streaming_wrapper(unet, cn, fc, mesh=mesh)
    with torch.inference_mode():
        # the CFG batch of two: unconditional and conditional, split over data
        x_in, s_in, c_in = guider.prepare(x, torch.full((b,), 2.0, device=dev), cond, uc)
        out = guider.combine(denoise(net, x_in, s_in, c_in))

    if dist.get_rank() == 0:
        print(f"mesh {mesh.shape} on {dist.get_backend()}: denoised {tuple(out.shape)} "
              f"{out.dtype}, finite={bool(torch.isfinite(out).all())}, std {float(out.std()):.4f}")
        if args.output:
            torch.save(out.cpu(), args.output)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
