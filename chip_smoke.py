#!/usr/bin/env python3
"""Run the PyTorch port's stage-1 main path once on one NVIDIA GPU.

    python3 chip_smoke.py                  # every phase (the check)
    python3 chip_smoke.py --phases card,build,kernels   # skip the slice

Phases, one line each:
  1. card: nvidia-smi name and power limit, torch and CUDA versions;
  2. build: nvcc of ``streamingt2v_torch/csrc`` into one library (seconds);
  3. kernels: each hand-written kernel (K1 flash attention, K3 GEGLU FF,
     K4 temporal conv) at the stage-1 main-path shapes in bf16 plus one f32
     case, against its plain PyTorch version on the same inputs, with both
     times (CUDA events, median of a few runs);
  4. reference: stage 1 end to end on a small input (the tiny config at
     96x192, f32) on the card, through all three kernels, against the same
     pipeline on the CPU (plain versions) with the same weights and noise;
  5. slice: ``build_pipeline`` at the full-width default ``PipelineConfig``
     with random bf16 weights on the card, then ``image_to_video`` for 43
     frames (first chunk plus one autoregressive chunk), with per-phase
     seconds, peak memory and the launch counts of the three kernels.
Then one JSON line with the kernel records and, last, the result line.

There is no CPU path: without CUDA the script exits non-zero before any
result.  Every failed phase raises.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time

ALL_PHASES = ("card", "build", "kernels", "reference", "slice")
SLICE_FRAMES = 43
# Sampler step cuts for the slice phase (full: 25 first-chunk, 30 AR).
FIRST_CHUNK_STEPS = 25
AR_STEPS = 30
# Tolerances on max |kernel - plain| / max |plain|: bf16 rounds the kernels'
# on-chip intermediates (probabilities, LN output, GEGLU product, prologue
# output) to 8 mantissa bits, f32 differs only in summation order.
TOL = {"bf16": 2e-2, "f32": 1e-4}
# Small-input reference: max-abs on the [-1, 1] video, f32 on both devices
# (measured 5.3e-5 on an H100; the sampler's 1/sigma steps amplify
# summation-order differences).
REFERENCE_ATOL = 5e-4


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, reps: int = 5) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _compare(name: str, got, ref, tol: float) -> float:
    import torch

    err = (got.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    rel = err / max(scale, 1e-30)
    ok = math.isfinite(err) and rel <= tol
    print(f"  {name}: max_abs_err={err:.3e} rel={rel:.3e} tol={tol:g} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: kernel disagrees with its plain version "
                             f"(rel {rel:.3e} > {tol:g})")
    return err


def check_kernels() -> dict:
    """Phase 3: returns {kernel: record} with max error and both times."""
    import torch

    from streamingt2v_torch.ops.flash_attention import (
        flash_attention, flash_attention_reference)
    from streamingt2v_torch.ops.fused_ff import geglu_ff, geglu_ff_reference
    from streamingt2v_torch.ops.temporal_conv import (
        temporal_conv, temporal_conv_reference)

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32

    def randn(*shape, dtype=bf16, std=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)

    rec = {}

    # ---- K1 flash attention ----
    errs = []
    for bh, length, d, dtype, label in [
            (250, 9216, 64, bf16, "unet level0 self-attn"),
            (500, 2304, 64, bf16, "unet level1 self-attn"),
            (70, 9216, 64, bf16, "controlnet level0 self-attn"),
            (8, 9216, 512, bf16, "vae decoder mid attn"),
            (1, 9216, 512, f32, "vae encoder mid attn (f32)")]:
        q, k, v = (randn(bh, length, d, dtype=dtype) for _ in range(3))
        out = flash_attention(q, k, v)
        rows = min(bh, 4)
        ref = flash_attention_reference(q[:rows], k[:rows], v[:rows])
        tol = TOL["f32" if dtype == f32 else "bf16"]
        errs.append(_compare(f"K1 {label} {(bh, length, d)} {dtype}", out[:rows], ref, tol))
        if (bh, length, d) == (250, 9216, 64):
            chunk = 16

            def plain_full():
                for i in range(0, bh, chunk):
                    flash_attention_reference(q[i:i + chunk], k[i:i + chunk], v[i:i + chunk])

            ms = _time_ms(lambda: flash_attention(q, k, v))
            plain_ms = _time_ms(plain_full, reps=3)
            rec["flash_attention"] = dict(ms=ms, plain_ms=plain_ms, shape=[bh, length, d])
            print(f"  K1 time {(bh, length, d)} bf16: kernel {ms:.3f} ms, plain "
                  f"(in {chunk}-row chunks) {plain_ms:.3f} ms", flush=True)
        del q, k, v, out, ref
    rec["flash_attention"]["max_abs_err"] = max(errs)

    # ---- K3 GEGLU feed-forward ----
    errs = []
    for n, c, dtype, label in [(460800, 320, bf16, "unet level0"),
                               (115200, 640, bf16, "unet level1"),
                               (28800, 1280, bf16, "unet level2"),
                               (4096, 320, f32, "f32")]:
        inner = 4 * c
        x = randn(n, c, dtype=dtype)
        w1 = randn(2 * inner, c, dtype=dtype, std=c ** -0.5)
        b1 = randn(2 * inner, dtype=f32, std=0.1)
        w2 = randn(c, inner, dtype=dtype, std=inner ** -0.5)
        b2 = randn(c, dtype=f32, std=0.1)
        lns = 1.0 + randn(c, dtype=f32, std=0.1)
        lnb = randn(c, dtype=f32, std=0.1)
        args = (x, w1, b1, w2, b2)
        kw = dict(ln_scale=lns, ln_bias=lnb, residual=True)
        out = geglu_ff(*args, **kw)
        ref = geglu_ff_reference(*args, lns, lnb, True)
        tol = TOL["f32" if dtype == f32 else "bf16"]
        errs.append(_compare(f"K3 {label} x{(n, c)} inner {inner} {dtype}", out, ref, tol))
        if dtype == f32:
            plain = geglu_ff_reference(*args)
            errs.append(_compare(f"K3 {label} no LN/residual", geglu_ff(*args), plain, tol))
        if (n, c) == (460800, 320):
            ms = _time_ms(lambda: geglu_ff(*args, **kw))
            plain_ms = _time_ms(lambda: geglu_ff_reference(*args, lns, lnb, True), reps=3)
            rec["geglu_ff"] = dict(ms=ms, plain_ms=plain_ms, shape=[n, c, inner])
            print(f"  K3 time {(n, c, inner)} bf16: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms",
                  flush=True)
        del x, out, ref
    rec["geglu_ff"]["max_abs_err"] = max(errs)

    # ---- K4 temporal conv ----
    errs = []
    for b, t, s, c, co, pre, res, dtype, label in [
            (2, 25, 9216, 320, 320, True, True, bf16, "unet level0 out_conv"),
            (2, 25, 2304, 640, 640, True, False, bf16, "unet level1 in_conv"),
            (2, 7, 576, 1280, 1280, True, True, bf16, "controlnet level2"),
            (1, 8, 589824, 128, 128, True, True, bf16, "vae decoder top level"),
            (1, 8, 589824, 3, 3, False, False, bf16, "vae AE3DConv time mix C=3"),
            (2, 25, 576, 64, 96, False, True, f32, "f32 res only"),
            (1, 7, 1024, 48, 32, True, False, f32, "f32 prologue only")]:
        x = randn(b, t, s, c, dtype=dtype)
        w = randn(3, c, co, dtype=dtype, std=(3 * c) ** -0.5)
        bias = randn(co, dtype=f32, std=0.1)
        pa = (1.0 + randn(b, c, dtype=f32, std=0.1)) if pre else None
        pb = randn(b, c, dtype=f32, std=0.1) if pre else None
        r = randn(b, t, s, co, dtype=dtype) if res else None
        rw = torch.rand((b, t), generator=gen, device=dev) if res else None
        args = (x, w, bias, r, rw, pa, pb)
        out = temporal_conv(*args)
        ref = temporal_conv_reference(*args)
        tol = TOL["f32" if dtype == f32 else "bf16"]
        errs.append(_compare(f"K4 {label} x{(b, t, s, c)}->{co} {dtype}", out, ref, tol))
        if label == "unet level0 out_conv":
            ms = _time_ms(lambda: temporal_conv(*args))
            plain_ms = _time_ms(lambda: temporal_conv_reference(*args), reps=3)
            rec["temporal_conv"] = dict(ms=ms, plain_ms=plain_ms, shape=[b, t, s, c, co])
            print(f"  K4 time {(b, t, s, c, co)} bf16 pre+res: kernel {ms:.3f} ms, "
                  f"plain {plain_ms:.3f} ms", flush=True)
        del x, out, ref, r
    rec["temporal_conv"]["max_abs_err"] = max(errs)
    torch.cuda.empty_cache()
    return rec


def _smooth_image(height: int, width: int, seed: int = 0):
    """A fixed [-1, 1] test image: low-frequency colour fields from a seed."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, height), np.linspace(0, 1, width), indexing="ij")
    chans = []
    for _ in range(3):
        fy, fx, ph = rng.uniform(0.5, 3.0), rng.uniform(0.5, 3.0), rng.uniform(0, 6.28)
        chans.append(np.sin(2 * np.pi * (fy * yy + fx * xx) + ph))
    img = 0.8 * np.stack(chans, axis=-1) + 0.05 * rng.randn(height, width, 3)
    return torch.from_numpy(np.clip(img, -1, 1).astype(np.float32))


def check_reference() -> float:
    """Phase 4: the kernel path on the card agrees with the plain path."""
    import dataclasses

    import torch

    from streamingt2v_torch.config import PipelineConfig
    from streamingt2v_torch.ops.flash_attention import flash_attention
    from streamingt2v_torch.ops.fused_ff import geglu_ff
    from streamingt2v_torch.ops.temporal_conv import temporal_conv
    from streamingt2v_torch.pipeline.build import build_pipeline

    tiny = PipelineConfig.tiny()
    cfg = dataclasses.replace(tiny, height=96, width=192, inference=dataclasses.replace(
        tiny.inference, vae_decode_bf16=False))
    frames = tiny.inference.chunk_frames + 1   # the first chunk plus one AR chunk
    gpu = build_pipeline(cfg, seed=0, device="cuda")
    cpu = build_pipeline(cfg, seed=0, device="cpu", init=False)
    for name in ("unet", "controlnet", "svd_unet", "vae", "conditioner"):
        getattr(cpu.models, name).load_state_dict(getattr(gpu.models, name).state_dict())
    draws = {}

    def noise(g, stream, shape):
        if (g, stream) not in draws:
            gen = torch.Generator().manual_seed(1000 * g + len(stream))
            fn = torch.rand if stream == "cond_aug" else torch.randn
            draws[g, stream] = fn(shape, generator=gen)
        return draws[g, stream]

    image = _smooth_image(cfg.height, cfg.width, seed=1)
    kernels = (flash_attention, geglu_ff, temporal_conv)
    for fn in kernels:
        fn.launches = 0
    got = gpu.image_to_video(image.cuda(), num_frames=frames, noise=noise).cpu()
    launches = {fn.__name__: fn.launches for fn in kernels}
    ref = cpu.image_to_video(image, num_frames=frames, noise=noise)
    err = (got - ref).abs().max().item()
    print(f"  small stage 1 {tuple(ref.shape)} f32, card vs CPU: max_abs_err={err:.3e} "
          f"tol={REFERENCE_ATOL:g}; launches {launches}; ref std {ref.std().item():.3f}",
          flush=True)
    if not torch.isfinite(got).all() or err > REFERENCE_ATOL:
        raise AssertionError(f"small-input stage 1 disagrees with the plain path ({err:.3e})")
    if min(launches.values()) <= 0:
        raise AssertionError(f"the small-input run skipped a kernel: {launches}")
    return err


def run_slice(first_steps: int, ar_steps: int) -> dict:
    """Phase 4: the full-width stage-1 slice through every kernel."""
    import dataclasses

    import torch

    from streamingt2v_torch.config import PipelineConfig
    from streamingt2v_torch.ops.flash_attention import flash_attention
    from streamingt2v_torch.ops.fused_ff import geglu_ff
    from streamingt2v_torch.ops.temporal_conv import temporal_conv
    from streamingt2v_torch.pipeline.build import build_pipeline

    dev = torch.device("cuda")
    cfg = PipelineConfig()
    if first_steps != cfg.first_chunk_sampler.num_steps:
        print(f"  cut: first-chunk sampler steps {cfg.first_chunk_sampler.num_steps} -> "
              f"{first_steps}", flush=True)
    if ar_steps != cfg.sampler.num_steps:
        print(f"  cut: autoregressive sampler steps {cfg.sampler.num_steps} -> {ar_steps}",
              flush=True)
    cfg = dataclasses.replace(
        cfg,
        first_chunk_sampler=dataclasses.replace(cfg.first_chunk_sampler, num_steps=first_steps),
        sampler=dataclasses.replace(cfg.sampler, num_steps=ar_steps))
    if cfg.n_autoregressions(SLICE_FRAMES) != 1:
        raise AssertionError("43 frames must be the first chunk plus one AR chunk")

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pipe = build_pipeline(cfg, seed=0, device=dev, bf16=True)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    print(f"  build_pipeline: {time.perf_counter() - t0:.1f} s, resident weights "
          f"{resident / 2**30:.2f} GiB", flush=True)

    # per-phase seconds: wrap the pipeline's stage methods with synchronised timers
    phase_s = {"condition": 0.0, "first_chunk": 0.0, "stream_chunk": 0.0, "decode_video": 0.0}

    def timed(name, fn):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            start = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            phase_s[name] += time.perf_counter() - start
            return out
        return wrapper

    for name in phase_s:
        setattr(pipe, name, timed(name, getattr(pipe, name)))

    image = _smooth_image(cfg.height, cfg.width).to(dev)
    kernels = (flash_attention, geglu_ff, temporal_conv)
    for fn in kernels:
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    video = pipe.image_to_video(image, num_frames=SLICE_FRAMES, seed=cfg.seed)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in kernels}
    peak = torch.cuda.max_memory_allocated()
    print("  seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items())
          + f", image_to_video total {total:.1f}", flush=True)
    print(f"  peak memory {peak / 2**30:.2f} GiB; launches {launches}", flush=True)

    want = (SLICE_FRAMES, cfg.height, cfg.width, 3)
    if tuple(video.shape) != want:
        raise AssertionError(f"video shape {tuple(video.shape)} != {want}")
    if not torch.isfinite(video).all():
        raise AssertionError("video has non-finite values")
    lo, hi = video.min().item(), video.max().item()
    if lo < -1.0 or hi > 1.0:
        raise AssertionError(f"video outside [-1, 1]: [{lo}, {hi}]")
    dead = [k for k, v in launches.items() if v <= 0]
    if dead:
        raise AssertionError(f"the slice never launched: {dead}")
    print(f"  video {want} finite in [{lo:.3f}, {hi:.3f}], std {video.std().item():.4f}",
          flush=True)
    return launches


KERNEL_META = {
    "flash_attention": ("streamingt2v_torch/csrc/flash_attention.cu",
                        "streamingt2v_tpu/ops/flash_attention.py:38"),
    "geglu_ff": ("streamingt2v_torch/csrc/geglu_ff.cu", "streamingt2v_tpu/ops/fused_ff.py:65"),
    "temporal_conv": ("streamingt2v_torch/csrc/temporal_conv.cu",
                      "streamingt2v_tpu/ops/temporal_conv.py:49"),
}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--phases", default=",".join(ALL_PHASES),
                        help="comma-separated subset of " + ",".join(ALL_PHASES))
    parser.add_argument("--first-steps", type=int, default=FIRST_CHUNK_STEPS,
                        help="first-chunk sampler steps in the slice phase")
    parser.add_argument("--ar-steps", type=int, default=AR_STEPS,
                        help="autoregressive sampler steps in the slice phase")
    args = parser.parse_args(argv)
    phases = set(args.phases.split(","))
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU", file=sys.stderr)
        return 2
    try:
        from streamingt2v_torch.ops import _native
    except ImportError:
        print("chip_smoke: run from the root of a repository checkout", file=sys.stderr)
        return 2

    # f32 comparisons must be full f32: no TF32 in cuDNN convs or matmuls.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    card = _card_line()
    print(f"card: {card}", flush=True)
    print(f"phase card: torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}", flush=True)

    t0 = time.perf_counter()
    path, build_s, log = _native.build()
    _native.library()
    print(f"phase build: {build_s:.1f} s nvcc ({time.perf_counter() - t0:.1f} s with load) "
          f"-> {path.name}", flush=True)
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas: " + line.strip(), flush=True)

    records = {}
    if "kernels" in phases:
        t0 = time.perf_counter()
        records = check_kernels()
        print(f"phase kernels: ok ({time.perf_counter() - t0:.1f} s)", flush=True)
    if "reference" in phases:
        t0 = time.perf_counter()
        check_reference()
        print(f"phase reference: ok ({time.perf_counter() - t0:.1f} s)", flush=True)
    launches = {}
    if "slice" in phases:
        t0 = time.perf_counter()
        launches = run_slice(args.first_steps, args.ar_steps)
        print(f"phase slice: ok ({time.perf_counter() - t0:.1f} s)", flush=True)

    kernels = []
    for name, (source, replaces) in KERNEL_META.items():
        r = records.get(name, {})
        kernels.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                            launches=launches.get(name, 0), max_abs_err=r.get("max_abs_err"),
                            ms=r.get("ms"), plain_ms=r.get("plain_ms")))
    print(json.dumps({"kernels": kernels}), flush=True)
    if phases != set(ALL_PHASES) or (args.first_steps, args.ar_steps) != (FIRST_CHUNK_STEPS,
                                                                          AR_STEPS):
        print("chip_smoke: not the default run; no result", file=sys.stderr)
        return 3
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
