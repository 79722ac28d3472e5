#!/usr/bin/env python3
"""Device time by kernel class of one stage-1 autoregressive guided step,
one stage-2 38-frame chunk step (two UNet calls, the CFG halves), one
stage-2 VAE decode and encode call and one stage-3 pair batch of the
PyTorch port, at full width with random weights (bf16; the VFI in f32), on
one NVIDIA GPU.

    python3 scripts/profile_torch_steps.py            # stages 1 and 2
    python3 scripts/profile_torch_steps.py --stages 2,vae,vfi
    python3 scripts/profile_torch_steps.py --stages 1 --stage1-routing shipped,on
    python3 scripts/profile_torch_steps.py --stages vae --root DIR   # another checkout
    python3 scripts/profile_torch_steps.py --stages train    # one training step

Stage 1 runs ``image_to_video`` for 43 frames (the first chunk with one
sampler step, then one AR chunk with two) and profiles the AR chunk's last
guided denoiser call, once per ``--stage1-routing`` entry: "shipped" is
``PipelineConfig.routing`` (K2 and K6 off), "on" is
``KernelRouting.all_on()`` (K2 and K6 where their gates allow); under
either the per-frame GroupNorms take K5, as everywhere without grad.
Stage 2 runs ``enhance_with_keyframe_prepass`` on a
synthetic 64-frame 720p video with 3 DDIM steps (2 run) and profiles the
last 38-frame chunk step.  "vae" builds stage 2 and profiles one call of
its SD VAE (the bf16 copy, under the enhance routing) at the chunk sizes
``_vae_chunk_frames`` gives at 720p: a 2-frame decode and a 4-frame
encode.  "vfi" builds stage 3 and profiles one ``interpolate_pair`` call
(flip-TTA) of the pipeline's pair batch at 720p, with cuDNN's TF32 off (as
``chip_smoke.py`` runs) and on (PyTorch's default).  "train" profiles one
training step of the full-width SVD-XT UNet as ``chip_smoke.py``'s train
phase takes it, split into the forward, the blocks' remat recompute, each
kernel's backward, the rest of autograd's backward and the optimizer and
EMA update (``record_function`` ranges; a kernel counts under the range
of the op that launched it).  Earlier calls warm the kernels and libraries
up.  ``--root``
imports the port from another checkout (e.g. an unpacked parent commit).
``torch.profiler`` (CUPTI) gives each kernel's device time; the classes
are the port's six kernels, indexing gathers (the VFI's warp), cuBLAS
GEMMs, cuDNN convolutions, softmax and reductions, and the rest (elementwise
ops and copies).  Needs the card.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys
import time
from collections import defaultdict

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

# (class, substrings of the kernel name), first match wins
CLASSES = (
    ("K1/K2 flash attention", ("flash_kernel",)),
    ("K3 GEGLU FF", ("geglu_",)),
    ("K4 temporal conv", ("temporal_conv",)),
    ("K5 fused GroupNorm", ("gn_stats_kernel", "gn_apply_kernel")),
    ("K6 temporal attention", ("temporal_attention",)),
    ("index / gather", ("index_elementwise", "gather_kernel", "index_kernel")),
    ("cuDNN conv", ("conv", "fprop", "dgrad", "implicit")),
    ("GEMM", ("gemm", "nvjet", "cublas", "xmma", "cutlass", "sm90_")),
    ("softmax / reductions", ("softmax", "reduce", "norm")),
)
OTHER = "elementwise / copies"


def classify(name: str) -> str:
    low = name.lower()
    for label, keys in CLASSES:
        if any(k.lower() in low for k in keys):
            return label
    return OTHER


def profiled(fn):
    """Runs fn under torch.profiler; returns (result, {kernel: ms}, wall ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    return out, device_ms(prof), wall


def device_ms(prof) -> dict:
    """{kernel: ms} of the device events, without the device spans of
    ``record_function`` ranges (user annotations: no kernels of their own)."""
    import torch

    by_name = defaultdict(float)
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA and not evt.is_user_annotation:
            by_name[evt.key] += evt.self_device_time_total / 1e3
    return dict(by_name)


def report(title: str, by_name: dict, wall: float) -> None:
    """Device time by class, then the largest kernels of the unnamed rest."""
    by_class = defaultdict(float)
    for name, ms in by_name.items():
        by_class[classify(name)] += ms
    busy = sum(by_class.values())
    print(f"{title}: device busy {busy:.1f} ms of {wall:.1f} ms wall "
          f"({100 * busy / wall:.1f}%)", flush=True)
    if busy <= 0:
        raise RuntimeError("the profiler saw no device time")
    for label, ms in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"  {label}: {ms:.1f} ms ({100 * ms / busy:.1f}%)", flush=True)
    rest = sorted(((ms, n) for n, ms in by_name.items() if classify(n) == OTHER), reverse=True)
    for ms, name in rest[:5]:
        print(f"    {OTHER}: {ms:.1f} ms {name[:100]}", flush=True)


ROUTINGS = ("shipped", "on")


def profile_stage1(routing: str) -> None:
    import torch

    from chip_smoke import _smooth_image
    from streamingt2v_torch.config import KernelRouting, PipelineConfig
    from streamingt2v_torch.pipeline import streaming
    from streamingt2v_torch.pipeline.build import build_pipeline

    cfg = PipelineConfig()
    cfg = dataclasses.replace(
        cfg, first_chunk_sampler=dataclasses.replace(cfg.first_chunk_sampler, num_steps=1),
        sampler=dataclasses.replace(cfg.sampler, num_steps=2),
        routing=KernelRouting.all_on() if routing == "on" else cfg.routing)
    pipe = build_pipeline(cfg, seed=0, bf16=True)
    calls, result = [], {}
    denoise = streaming.denoise

    def wrapped(*args, **kwargs):
        calls.append(None)
        if len(calls) < 3:   # the first chunk's step, then the AR chunk's first
            return denoise(*args, **kwargs)
        out, result["by_name"], result["wall"] = profiled(lambda: denoise(*args, **kwargs))
        return out

    streaming.denoise = wrapped
    try:
        pipe.image_to_video(_smooth_image(cfg.height, cfg.width).cuda(), num_frames=43)
    finally:
        streaming.denoise = denoise
    report(f"stage 1, one AR guided step (UNet + ControlNet, CFG-doubled batch), routing "
           f"{routing} {cfg.routing}", result["by_name"], result["wall"])
    del pipe
    torch.cuda.empty_cache()


def profile_stage2() -> None:
    import torch

    from chip_smoke import ENHANCE_FRAMES, _smooth_image, _smooth_video
    from streamingt2v_torch.config import EnhanceConfig
    from streamingt2v_torch.pipeline.build import build_enhance

    cfg = dataclasses.replace(EnhanceConfig(), num_steps=3)
    pipe = build_enhance(cfg, seed=0, bf16=True)
    chunk, frames, result = pipe._denoise_chunk, [], {}

    def wrapped(latents_chunk, *args):
        frames.append(latents_chunk.shape[1])
        if frames.count(cfg.chunk_size) < 4:  # main steps: 2 chunks x 2 steps
            return chunk(latents_chunk, *args)
        out, result["by_name"], result["wall"] = profiled(lambda: chunk(latents_chunk, *args))
        return out

    pipe._denoise_chunk = wrapped
    video = _smooth_video(ENHANCE_FRAMES, cfg.height, cfg.width, device="cuda")
    image = _smooth_image(cfg.height, cfg.width, seed=4).cuda()
    pipe.enhance_with_keyframe_prepass(video, image)
    report(f"stage 2, one {cfg.chunk_size}-frame chunk step (2 UNet calls); chunk frames "
           f"seen {frames}", result["by_name"], result["wall"])
    del pipe
    torch.cuda.empty_cache()


def profile_stage2_vae() -> None:
    import torch

    from chip_smoke import _smooth_video
    from streamingt2v_torch.config import EnhanceConfig
    from streamingt2v_torch.ops.routing import use_routing
    from streamingt2v_torch.pipeline.build import build_enhance

    cfg = EnhanceConfig()
    pipe = build_enhance(cfg, seed=0, bf16=True)
    vae, dtype, dev = pipe.vae, pipe._vae_dtype, torch.device("cuda")
    h, w = cfg.height, cfg.width
    lat = (h // vae.cfg.downsample_factor, w // vae.cfg.downsample_factor, vae.cfg.z_channels)
    gen = torch.Generator(dev).manual_seed(0)
    for kind in ("decode", "encode"):
        frames = pipe._vae_chunk_frames(h, w, kind)
        if kind == "decode":
            z = torch.randn((frames,) + lat, generator=gen, device=dev).to(dtype)
            call = lambda: vae.decode(z)  # noqa: E731
        else:
            video = _smooth_video(frames, h, w, device=dev).to(dtype)
            eps = torch.randn((frames,) + lat, generator=gen, device=dev)
            call = lambda: vae.encode(video, eps)  # noqa: E731
        with torch.inference_mode(), use_routing(cfg.routing):
            call()
            _, by_name, wall = profiled(call)
        report(f"stage 2, one SD VAE {kind} call of {frames} frames at {h}x{w} "
               f"({dtype}, routing {cfg.routing})", by_name, wall)
    del pipe
    torch.cuda.empty_cache()


def profile_stage3() -> None:
    import torch

    from chip_smoke import SHIFT_PX, _translated_video
    from streamingt2v_torch.config import PipelineConfig
    from streamingt2v_torch.models.vfi import interpolate_pair
    from streamingt2v_torch.pipeline.build import build_interpolate

    cfg = PipelineConfig()
    pipe = build_interpolate(cfg, seed=0)
    n = pipe.pair_batch
    video = _translated_video(n + 1, cfg.enhance.height, cfg.enhance.width, SHIFT_PX, "cuda")
    call = lambda: interpolate_pair(pipe.model, video[:-1], video[1:], tta=pipe.tta)  # noqa: E731
    # the network is f32: its cuDNN convolutions take TF32 under PyTorch's
    # default (cudnn.allow_tf32) and not under chip_smoke.py's setting
    default = torch.backends.cudnn.allow_tf32
    for tf32 in (False, True):
        torch.backends.cudnn.allow_tf32 = tf32
        with torch.inference_mode():
            call()
            _, by_name, wall = profiled(call)
        report(f"stage 3, one interpolate_pair call of {n} pairs at {cfg.enhance.height}x"
               f"{cfg.enhance.width} (f32, TTA {pipe.tta}, cudnn.allow_tf32 {tf32}, "
               f"matmul.allow_tf32 {torch.backends.cuda.matmul.allow_tf32})", by_name, wall)
    torch.backends.cudnn.allow_tf32 = default
    del pipe
    torch.cuda.empty_cache()


BACKWARD_OTHER = "backward, other ops"


def _attributed(prof, labels: tuple) -> dict:
    """{label: {kernel: ms}}: each kernel under the innermost of ``labels``
    (``record_function`` ranges) around the CPU op that launched it, else
    under BACKWARD_OTHER (autograd runs the backward's ops on a thread of
    its own, outside the main thread's ranges)."""
    import torch

    out = defaultdict(lambda: defaultdict(float))
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CPU or not evt.kernels:
            continue
        node, label = evt, BACKWARD_OTHER
        while node is not None:
            if node.name in labels:
                label = node.name
                break
            node = node.cpu_parent
        for k in evt.kernels:
            if not (evt.is_user_annotation and k.name == evt.name):   # the range's span
                out[label][k.name] += k.duration / 1e3
    return out


def profile_train() -> None:
    """One training step of the full-width SVD-XT UNet (remat on, bf16,
    batch 1 of 25 frames at 576x1024), as ``chip_smoke.py``'s train phase
    takes it (TF32 off), after one step unprofiled, in three profiled
    windows: the forward (the loss); the backward, split into the blocks'
    remat recompute and each kernel's backward (the chunked VJP of its
    plain version), ``record_function`` ranges whose kernels count under
    the range around the op that launched them, and the rest of the
    window's device time (autograd's other backward ops); then the
    optimizer and EMA update."""
    import torch

    from chip_smoke import TRAIN_EMA_DECAY, TRAIN_FRAMES, _train_batch
    from streamingt2v_torch.config import PipelineConfig
    from streamingt2v_torch.diffusion.engine import DiffusionEngine
    from streamingt2v_torch.diffusion.loss import DiffusionLossConfig, diffusion_loss
    from streamingt2v_torch.models import unet_blocks
    from streamingt2v_torch.models.layers import init_random_
    from streamingt2v_torch.models.video_unet import VideoUNet
    from streamingt2v_torch.models.wrappers import openai_wrapper
    from streamingt2v_torch.ops import flash_attention, fused_ff, temporal_conv
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    base = PipelineConfig()
    ucfg = dataclasses.replace(base.unet, controlnet_mode=False, use_apm=False,
                               use_checkpoint=True)
    unet = VideoUNet(ucfg, device=dev, dtype=torch.bfloat16)
    init_random_(unet, torch.Generator(dev).manual_seed(0))
    engine = DiffusionEngine(unet, openai_wrapper, ema_decay=TRAIN_EMA_DECAY)
    batch = _train_batch(TRAIN_FRAMES, base.height // 8, base.width // 8, ucfg.context_dim,
                         ucfg.adm_in_channels, dev)
    engine.train_step(batch, torch.Generator(dev).manual_seed(1))

    recompute = "remat recompute"
    labels = {flash_attention: ("flash_attention_backward", "K1 backward"),
              fused_ff: ("geglu_ff_backward", "K3 backward"),
              temporal_conv: ("temporal_conv_backward", "K4 backward")}
    saved = [(mod, fn, getattr(mod, fn)) for mod, (fn, _) in labels.items()]
    saved += [(cls, "_forward", cls._forward) for cls in (unet_blocks.UNetVideoResBlock,
                                                          unet_blocks.SpatialVideoTransformer)]
    in_backward = [False]

    def ranged(label, fn, when=lambda: True):
        def wrapper(*args, **kwargs):
            if not when():
                return fn(*args, **kwargs)
            with record_function(label):
                return fn(*args, **kwargs)
        return wrapper

    for mod, (fn, label) in labels.items():
        setattr(mod, fn, ranged(label, getattr(mod, fn)))
    for cls in (unet_blocks.UNetVideoResBlock, unet_blocks.SpatialVideoTransformer):
        cls._forward = ranged(recompute, cls._forward, lambda: in_backward[0])
    gen = torch.Generator(dev).manual_seed(1)
    parts, totals = {}, {}
    try:
        engine.optimizer.zero_grad(set_to_none=True)
        loss, parts["forward"], totals["forward"] = profiled(lambda: diffusion_loss(
            DiffusionLossConfig(), openai_wrapper(unet), batch["latents"], batch["cond"], gen))
        in_backward[0] = True
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            loss.backward()
            torch.cuda.synchronize()
            totals["backward"] = (time.perf_counter() - t0) * 1e3
        in_backward[0] = False
        _, parts["optimizer + EMA"], totals["optimizer + EMA"] = profiled(engine.apply_updates)
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)
    # the backward window: the labelled ranges' kernels, and the rest of the
    # window's device time (key_averages) as autograd's other backward ops
    labelled = _attributed(prof, (recompute,) + tuple(label for _, label in labels.values()))
    labelled.pop(BACKWARD_OTHER, None)
    rest = device_ms(prof)
    for by_name in labelled.values():
        for name, ms in by_name.items():
            rest[name] = rest.get(name, 0.0) - ms
    if min(rest.values(), default=0.0) < -1.0:
        raise RuntimeError("the backward's ranges hold more device time than its window")
    parts.update(labelled)
    parts[BACKWARD_OTHER] = rest
    wall = sum(totals.values())
    total = sum(sum(v.values()) for v in parts.values())
    print(f"train, one step of the SVD-XT UNet (bf16, remat, 1 x {TRAIN_FRAMES} x "
          f"{base.height // 8} x {base.width // 8}; loss {loss.item():.6f}): device busy "
          f"{total:.1f} ms of {wall:.1f} ms wall ({100 * total / wall:.1f}%: forward "
          f"{totals['forward']:.1f}, backward {totals['backward']:.1f}, optimizer + EMA "
          f"{totals['optimizer + EMA']:.1f} ms, each between syncs)", flush=True)
    if total <= 0:
        raise RuntimeError("the profiler saw no device time")
    for label, by_name in sorted(parts.items(), key=lambda kv: -sum(kv[1].values())):
        ms = sum(by_name.values())
        print(f"  {label}: {ms:.1f} ms ({100 * ms / total:.1f}%)", flush=True)
        by_class = defaultdict(float)
        for name, t in by_name.items():
            by_class[classify(name)] += t
        for cls, t in sorted(by_class.items(), key=lambda kv: -kv[1]):
            print(f"    {cls}: {t:.1f} ms ({100 * t / ms:.1f}%)", flush=True)
        for t, name in sorted(((t, n) for n, t in by_name.items()), reverse=True)[:3]:
            print(f"      {t:.1f} ms {name[:100]}", flush=True)
    del engine, unet
    torch.cuda.empty_cache()


STAGES = ("1", "2", "vae", "vfi", "train")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--stages", default="1,2",
                        help="comma-separated subset of " + ",".join(STAGES))
    parser.add_argument("--stage1-routing", default="shipped",
                        help="comma-separated subset of " + ",".join(ROUTINGS))
    parser.add_argument("--root", default=HERE, help="checkout whose port is profiled")
    args = parser.parse_args()
    stages = args.stages.split(",")
    if not set(stages) <= set(STAGES):
        parser.error(f"--stages takes {STAGES}, got {stages}")
    routings = args.stage1_routing.split(",")
    if not set(routings) <= set(ROUTINGS):
        parser.error(f"--stage1-routing takes {ROUTINGS}, got {routings}")
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_steps: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()
    sys.path.insert(0, os.path.abspath(args.root))
    for name in [m for m in sys.modules if m.startswith("streamingt2v_torch")]:
        del sys.modules[name]
    print(f"card: {card}; port from {os.path.abspath(args.root)}", flush=True)
    if "1" in stages:
        for routing in routings:
            profile_stage1(routing)
    if "2" in stages:
        profile_stage2()
    if "vae" in stages:
        profile_stage2_vae()
    if "vfi" in stages:
        profile_stage3()
    if "train" in stages:
        profile_train()
    return 0


if __name__ == "__main__":
    sys.exit(main())
