"""Command line of the port, with the flags of the JAX package's CLI
(``streamingt2v_tpu/pipeline/cli.py``, after the reference's
inference_i2v.py):

    python -m streamingt2v_torch.pipeline.cli --input IMAGE_OR_DIR --output DIR \\
        [--ckpt_dir DIR | --random_weights] [--num_frames 200] [--container y4m] \\
        [--set PATH=VALUE]

Models are built on the card (``--device cuda``).  With ``--ckpt_dir`` every
stage loads the published weights from a local tree laid out as
``utils/loader.py`` describes; without it stage 1 takes random weights from
``--seed``, and stages 2 and 3 are built at production width with random
weights under ``--random_weights`` and skipped otherwise.  ``--tiny`` runs the
tiny stage-1 configuration only (loaded from ``--ckpt_dir`` when given).
``--use_memopt`` is accepted and does nothing: the three model sets stay
resident on an 80 GB card.  The per-stage timing report, the loads included,
is printed as JSON at the end.

``--mesh D,S,M`` runs on a (data, seq, model) mesh of D*S*M ranks, one
process (and one card) each, started by torchrun:

    torchrun --nproc_per_node=D*S*M -m streamingt2v_torch.pipeline.cli --mesh D,S,M ...

The world's size must equal the mesh's.  ``--mesh 1,1,1`` runs in one
plain process, in a world of one rank.  Every rank builds the same
weights and runs the product; rank 0 alone writes the file and prints the
timing report.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import sys
from typing import Optional


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("streamingt2v_torch")
    p.add_argument("--input", required=True, help="input image file or directory")
    p.add_argument("--output", default="results", help="output directory")
    p.add_argument("--num_frames", type=int, default=200)
    p.add_argument("--out_fps", type=int, default=24)
    p.add_argument("--chunk_size", type=int, default=38)
    p.add_argument("--overlap_size", type=int, default=12)
    p.add_argument("--use_randomized_blending", action="store_true")
    p.add_argument("--use_memopt", action="store_true",
                   help="accepted for reference CLI compatibility; no-op")
    p.add_argument("--seed", type=int, default=33)
    p.add_argument("--container", choices=["mp4", "y4m"], default="mp4",
                   help="mp4 needs OpenCV; y4m is written without it")
    p.add_argument("--ckpt_dir", default=None,
                   help="local checkpoint tree (layout in streamingt2v_torch/utils/loader.py)")
    p.add_argument("--mesh", default=None, metavar="DATA,SEQ,MODEL",
                   help="device mesh for multi-device runs (e.g. 2,1,1) under torchrun with "
                        "one process per rank: stage 1 splits its CFG batch over data, its "
                        "transformers' tokens over seq and their heads/FF over model; "
                        "stages 2 and 3 split their batches over data")
    p.add_argument("--tiny", action="store_true",
                   help="tiny random-weight stage-1 config (smoke testing)")
    p.add_argument("--random_weights", action="store_true",
                   help="build stages 2+3 at production width with random weights "
                        "when no --ckpt_dir is given (full product geometry without "
                        "the published checkpoints)")
    p.add_argument("--skip_enhance", action="store_true")
    p.add_argument("--skip_interpolation", action="store_true")
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   metavar="PATH=VALUE",
                   help="nested config override, e.g. --set sampler.num_steps=25")
    p.add_argument("--device", default="cuda",
                   help="torch device the models are built on (cpu for --tiny without a card)")
    return p


def build_config(args):
    """The ``PipelineConfig`` the flags describe."""
    from streamingt2v_torch.config import PipelineConfig
    from streamingt2v_torch.utils.overrides import apply_overrides

    if args.tiny:
        cfg = dataclasses.replace(PipelineConfig.tiny(), num_frames=min(args.num_frames, 16),
                                  out_fps=args.out_fps, seed=args.seed)
    else:
        cfg = PipelineConfig(
            num_frames=args.num_frames, out_fps=args.out_fps, seed=args.seed,
            use_randomized_blending=args.use_randomized_blending,
            chunk_size=args.chunk_size, overlap_size=args.overlap_size)
        # the blending geometry lives on the stage-2 config
        cfg = dataclasses.replace(cfg, enhance=dataclasses.replace(
            cfg.enhance, chunk_size=args.chunk_size, overlap_size=args.overlap_size,
            use_randomized_blending=args.use_randomized_blending))
    return apply_overrides(cfg, args.overrides)


def build_product_pipeline(args):
    """The ``StreamingT2VPipeline`` the flags describe: stage 1 loaded from
    ``--ckpt_dir`` or random; stages 2 and 3 loaded from ``--ckpt_dir``,
    random under ``--random_weights``, skipped otherwise (always with
    ``--tiny``, and each on its ``--skip_*`` flag)."""
    from streamingt2v_torch.pipeline.build import (
        build_enhance, build_interpolate, build_pipeline, shard_stage1_models)
    from streamingt2v_torch.pipeline.full import StreamingT2VPipeline
    from streamingt2v_torch.utils import loader

    mesh = make_mesh(args.mesh)
    cfg = build_config(args)
    # production runs hold the weights in bf16, except the f32 VAE
    bf16 = not args.tiny
    if args.ckpt_dir:
        stage1 = loader.load_stage1_checkpoints(cfg, args.ckpt_dir, seed=args.seed,
                                                device=args.device, bf16=bf16)
        shard_stage1_models(stage1.models, mesh)
        stage1.mesh = mesh
    else:
        stage1 = build_pipeline(cfg, seed=args.seed, device=args.device, bf16=bf16, mesh=mesh)
    enhance = interp = None
    if args.tiny or not (args.ckpt_dir or args.random_weights):
        print("[streamingt2v_torch] stages 2 and 3 skipped: no checkpoints "
              "(--ckpt_dir loads them, --random_weights builds them)")
    elif args.ckpt_dir:
        if not args.skip_enhance:
            enhance = loader.load_enhance_pipeline(cfg, args.ckpt_dir, device=args.device)
            enhance.mesh = mesh
        if not args.skip_interpolation:
            interp = loader.load_interpolate_pipeline(cfg, args.ckpt_dir, device=args.device)
            interp.mesh = mesh
    else:
        if not args.skip_enhance:
            enhance = build_enhance(cfg.enhance, seed=args.seed, device=args.device, mesh=mesh)
        if not args.skip_interpolation:
            interp = build_interpolate(cfg, seed=args.seed, device=args.device, mesh=mesh)
    return StreamingT2VPipeline(cfg, stage1, enhance, interp)


def make_mesh(spec: Optional[str]):
    """The mesh ``--mesh D,S,M`` names, over the world torchrun started (a
    world of one rank for 1,1,1 in a plain process), or None without the
    flag.  A world of another size raises; so does a process group that
    cannot be formed."""
    if not spec:
        return None
    import torch.distributed as dist

    from streamingt2v_torch.config import MeshConfig
    from streamingt2v_torch.parallel import multihost
    from streamingt2v_torch.parallel.mesh import create_mesh

    try:
        d, s, m = (int(v) for v in spec.split(","))
    except ValueError:
        raise ValueError(f"--mesh {spec!r}: expected DATA,SEQ,MODEL, e.g. 2,1,1") from None
    cfg = MeshConfig(data=d, seq=s, model=m)
    multihost.initialize()
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != cfg.num_devices:
        raise ValueError(f"--mesh {spec} is a multi-device mesh of {cfg.num_devices} ranks, but "
                         f"this world has {world}: run it under torchrun "
                         f"--nproc_per_node={cfg.num_devices}")
    return create_mesh(cfg)


def main(argv=None) -> int:
    import torch.distributed as dist

    from streamingt2v_torch.utils.profiling import timing_report

    args = build_parser().parse_args(argv)
    if args.use_memopt:
        print("[streamingt2v_torch] --use_memopt is a no-op: all stages stay resident")
    owned = bool(args.mesh) and not dist.is_initialized()   # the group this run forms
    pipe = build_product_pipeline(args)
    lead = not dist.is_initialized() or dist.get_rank() == 0
    try:
        inputs = (sorted(glob.glob(os.path.join(args.input, "*")))
                  if os.path.isdir(args.input) else [args.input])
        os.makedirs(args.output, exist_ok=True)
        for path in inputs:
            name = os.path.splitext(os.path.basename(path))[0]
            out_path = os.path.join(args.output, f"{name}.{args.container}")
            if lead:
                print(f"[streamingt2v_torch] {path} -> {out_path}")
            pipe.run(path, out_path if lead else None, seed=args.seed)
        if lead:
            print(json.dumps(timing_report(), indent=2))
    finally:
        if owned and dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
