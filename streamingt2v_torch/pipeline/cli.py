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
resident on an 80 GB card.  Running on several devices (``--mesh``) is not
ported yet and raises.  The per-stage timing report, the loads included, is
printed as JSON at the end.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import sys


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
                   help="not ported yet: raises")
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
    from streamingt2v_torch.pipeline.build import build_enhance, build_interpolate, build_pipeline
    from streamingt2v_torch.pipeline.full import StreamingT2VPipeline
    from streamingt2v_torch.utils import loader

    if args.mesh:
        raise NotImplementedError("--mesh: multi-device runs are not ported yet "
                                  "(ROADMAP.md, A12)")
    cfg = build_config(args)
    # production runs hold the weights in bf16, except the f32 VAE
    bf16 = not args.tiny
    if args.ckpt_dir:
        stage1 = loader.load_stage1_checkpoints(cfg, args.ckpt_dir, seed=args.seed,
                                                device=args.device, bf16=bf16)
    else:
        stage1 = build_pipeline(cfg, seed=args.seed, device=args.device, bf16=bf16)
    enhance = interp = None
    if args.tiny or not (args.ckpt_dir or args.random_weights):
        print("[streamingt2v_torch] stages 2 and 3 skipped: no checkpoints "
              "(--ckpt_dir loads them, --random_weights builds them)")
    elif args.ckpt_dir:
        if not args.skip_enhance:
            enhance = loader.load_enhance_pipeline(cfg, args.ckpt_dir, device=args.device)
        if not args.skip_interpolation:
            interp = loader.load_interpolate_pipeline(cfg, args.ckpt_dir, device=args.device)
    else:
        if not args.skip_enhance:
            enhance = build_enhance(cfg.enhance, seed=args.seed, device=args.device)
        if not args.skip_interpolation:
            interp = build_interpolate(cfg, seed=args.seed, device=args.device)
    return StreamingT2VPipeline(cfg, stage1, enhance, interp)


def main(argv=None) -> int:
    from streamingt2v_torch.utils.profiling import timing_report

    args = build_parser().parse_args(argv)
    if args.use_memopt:
        print("[streamingt2v_torch] --use_memopt is a no-op: all stages stay resident")
    pipe = build_product_pipeline(args)

    inputs = (sorted(glob.glob(os.path.join(args.input, "*")))
              if os.path.isdir(args.input) else [args.input])
    os.makedirs(args.output, exist_ok=True)
    for path in inputs:
        name = os.path.splitext(os.path.basename(path))[0]
        out_path = os.path.join(args.output, f"{name}.{args.container}")
        print(f"[streamingt2v_torch] {path} -> {out_path}")
        pipe(path, out_path, seed=args.seed)
    print(json.dumps(timing_report(), indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
