#!/usr/bin/env python3
"""Run the PyTorch port's main paths once on one NVIDIA GPU: stage 1
(streaming image-to-video, also with APM and under every other sampler and
guider), training of the full-width SVD-XT UNet, stage 2 (I2VGen-XL
enhancement), stage 3 (EMA-VFI 2x interpolation), the three-stage product
that joins them, the checkpoint loader that fills it from the published
weights' names, and a guided step of CogVideoX-5B text-to-video.

    python3 chip_smoke.py                  # every phase (the check)
    python3 chip_smoke.py --phases card,build,kernels   # skip the pipelines

Phases, one line each:
  1. card: nvidia-smi name and power limit, torch and CUDA versions, and
     whether OpenCV and Pillow are installed (the product's path needs
     neither);
  2. build: nvcc of ``streamingt2v_torch/csrc`` (one nvcc per source, run
     together) into one library (seconds), and g++ of the native y4m feeder
     (``streamingt2v_torch/native``);
  3. kernels: each hand-written kernel (K1 flash attention, K2 packed flash
     attention, K3 GEGLU FF, K4 temporal conv, K5 fused GroupNorm, K6
     temporal attention) at the main paths' shapes in bf16 plus f32 cases,
     against its plain PyTorch version on the same inputs, with both times
     (CUDA events, median of a few runs, each call queued behind a device
     sleep so that the host's work before it is not timed) at one timed
     main-path shape each;
     there also its bound and its library yardstick (below); K5 also at
     every geometry stage 1 sends it (``stage1_k5_geometries``), and its
     affine entry (the statistics of K4's prologue) at every geometry the
     UNets and the VAE decoder send it (``k4_prologue_geometries``).  The build
     phase fails if ptxas serialized any kernel's ``wgmma``;
  4. reference: stage 1 end to end on a small input (the tiny config at
     96x192, f32), the same with APM (a 3+1-token context, ``apm_alpha``
     drawn non-zero), the tiny first chunk at 64x128 under each other sampler
     and guider (3 steps, the same per-step draws on both devices), stage 2
     end to end on a small input (a narrow I2VGen-XL at 64x128, f32, the
     enhance routing) and stage 3 (the tiny VFI at 64x64, f32, flip-TTA) on
     the card, stages 1 and 2 through their kernels, against the same
     pipelines on the CPU (plain versions) with the same weights and noise;
     then training: each kernel's ``torch.autograd.Function`` (K1, K2, K3
     with and without LN, K4 bare, pre, res and pre+res) against autograd
     through its plain version at a training shape in bf16 (its backward
     timed: ``bwd_ms``, ``bwd_chunks``) and in f32, K5 and K6 refusing
     inputs that require grad, and the tiny first-chunk VideoUNet (f32,
     remat, every constant drawn) trained 2 AdamW steps on the card and on
     the CPU with the same weights and draws (loss, every gradient, the
     parameters after each step);
  5. slice: ``build_pipeline`` at the full-width default ``PipelineConfig``
     with random bf16 weights on the card, then ``image_to_video`` for 43
     frames (first chunk plus one autoregressive chunk), with per-phase
     seconds, peak memory and the launch counts of its kernels;
  6. bench: the port's bench (``streamingt2v_torch/bench.py``) in its
     functions' production configs, not recorded: ``bench_denoise`` (config
     #2: three chained guided denoise steps of the ControlNet-mode VideoUNet
     and the ControlNet at 2 x 25 frames of 72x128 latents, bf16, a warm-up
     call and 5 timed calls) and ``bench_vae`` (config #1: the f32 temporal
     VAE's round trip of a 16-frame 576x1024 chunk, 8-frame encode and
     4-frame decode pieces, a warm-up call and 5 timed calls), each record
     checked: a finite value above 0, ``peak_hbm_gb`` above 0, and launches
     of K1, K3 and K4 (denoise) and of K1 and K4 in f32 (vae);
  7. apm: the same with ``unet.use_apm`` and ``apm_anchor_frames`` (0, 16)
     (a 17-token context: the SVD token and 16 anchor frames' CLIP tokens),
     every ``apm_alpha`` drawn non-zero, samplers cut to 5 + 5 steps: phase
     seconds with the APM CLIP encode on its own, resident and peak memory,
     ``stage_finite`` and the launches (K1, K3, K4 and the D=512 body must
     launch);
  8. samplers: one full-width first chunk (the SVD-XT UNet, 25 frames, 4
     steps) under each of Heun, Euler ancestral, DPM++ 2S, DPM++ 2M, LMS,
     EulerEDM with churn, and EulerEDM under the identity and the
     triangle-prediction guiders: seconds per guided denoise, finite latents,
     the network calls against the sampler's rule (n; 2n - 1 for Heun and
     DPM++ 2S) and K1/K3/K4 launches in proportion to them;
  9. train: the earlier models freed, the full-width SVD-XT UNet alone
     (``use_checkpoint`` on, bf16, random weights from seed 0) through
     ``openai_wrapper`` and ``DiffusionEngine`` (AdamW 1e-4, weight decay
     1e-4, EMA 0.9999), 4 steps on one 25-frame 576x1024 clip of latents
     with one generator seed: the parameter count, seconds per step
     (forward+backward, optimizer+EMA; the first step apart), resident and
     peak memory, each step's loss (finite, the last below the first), the
     gradients at step 3 of a level-0 attention's ``to_q`` and a level-0
     temporal conv (non-zero: they crossed K1 and K4; the zero-initialised
     output layers hold them at zero in steps 1 and 2), K1/K3/K4 launches per
     step (the forward's plus the remat recompute's: twice a no-grad
     forward's when every call sits in a remat'd block), the backward's
     chunks and the share of parameters each update changed;
  10. enhance: the stage-1 models freed, ``build_enhance`` at full I2VGen-XL
     width (random bf16 weights), then ``enhance_with_keyframe_prepass`` on
     a synthetic 64-frame 720p video (a 2-frame pre-pass, then 2 blended
     38-frame chunks) with ``--enhance-steps`` DDIM steps, with per-phase
     seconds, resident and peak memory and the launch counts of its kernels;
  11. interpolate: ``build_interpolate`` at full EMA-VFI width (f32, flip-TTA)
     on a synthetic 720p video whose content moves 3 pixels a frame: seconds
     per pair and peak memory at pair batches 1, 2, 4 and 8 over 16 pairs,
     then the 64-frame video to 127 frames at the pipeline's pair batch,
     checked for shape, range and kept input frames, and the warp checked
     against the known motion (the half-shift warps of both neighbours land
     closer to the true midpoint than either neighbour; a wrong sign would
     land farther);
  12. product: ``build_product`` at full width (stage 1 bf16 but its f32 VAE,
     stage 2 bf16, stage 3 f32), then ``StreamingT2VPipeline.run`` on a
     synthetic 576x1024 uint8 image held in memory, for ``--product-frames``
     (85: 43 stage-1 frames, full sampler steps; stage 2 at
     ``--enhance-steps``) written as y4m into a temporary directory, with the
     per-stage seconds, resident and peak memory, ``stage_finite``, the
     launch counts of every kernel row, and the file checked (header, frame
     count, 1280x720) and written by the native feeder;
  13. loader: ``build_product`` at full width again (every constant tensor
     given a small draw of its own), written as a checkpoint tree in the
     reference's names and layouts (``write_reference_tree``: the
     StreamingSVD safetensors, the SVD-XT UNet, the i2vgen-xl folders with
     a scheduler config and a BPE tokenizer, EMA-VFI's pickle; about 14 GiB)
     into a temporary directory after a check of its free space, loaded
     back through ``utils/loader.py`` and compared bit for bit, with the
     seconds and GB/s per source and the card's peak during the load; then
     the CLI's product from the tree (``--ckpt_dir``, 85 frames, samplers
     cut to 5 steps, ``--enhance-steps`` DDIM steps) on a 576x1024 PNG into
     a y4m file, with its stage seconds, ``stage_finite``, the launches of
     every kernel row and the file checked (header, frame count, 1280x720)
     and written by the native feeder;
  14. mesh: the multi-device layer on the one card.  The CLI's product at
     the loader phase's cut with random weights (``--random_weights``) under
     ``--mesh 1,1,1`` (a world of one NCCL rank: its launches are the
     phase's ``mesh_launches``, every kernel row must launch) and without
     ``--mesh``, with no cuDNN flag set by this script: the two files
     byte-equal (a same-seed two-run check of the product); stage 3 of the
     plain run twice more on its 43 stage-2 frames with every module's
     output on one pair batch compared, 0 uint8 values apart, and the same
     with ``ConvTranspose`` as ``F.conv_transpose2d`` measured beside it
     (the op whose cuDNN algorithm varied); then under that mesh, stage 2's
     ``_denoise_step_dp`` at full width (64 frames at 720p, the 2 x 2 UNet
     calls of a DDIM step as one batch) against the sequential step, and a
     full-width SVD-XT training step against the same step without the mesh
     (seconds and peaks); then each rank's share of the split kernels, one
     simulated rank after another (``_sim_rank``): K3 split over model = 2
     and 4 at the three UNet widths (``shard_params`` and the
     FeedForward's tensor-parallel forward; the partials summed), K1's rows
     over 2 and 4 ranks (``_flash_rows``, gathered) and the ring's blocks
     over seq = 4 (``ring_fold``), each against the unsplit kernel; the
     same K3 and K1 splits under grad, each rank's input gradients summed
     over the ranks against the unsplit Function's (``_mesh_split_grads``:
     the world-1 steps above run none of the model-side split code); the
     token split under grad at the training shape (125, 9216, 64) bf16 over
     simulated seq = 2 and 4 against K1's Function backward on the whole
     call: the ring's backward through its per-hop functions
     (``ring_bwd_fold``; ms a rank and chunks) and the gathered path (each
     rank's queries through K1, the ranks' dk/dv summed); the training
     losses (LPIPS, the discriminator with the hinge loss, the Laplacian and
     census losses, the KL, the vector quantizer) on the card against the
     CPU at a small size, and LPIPS and the discriminator timed on 25 frames
     at 576x1024 and the VFI losses on 720p pairs; last the two
     single-process examples of ``examples/torch/`` at their tiny widths;
  15. cogvideox: ``build_cogvideox`` at the published CogVideoX-5B widths
     (random bf16 weights), then one guided DDIM step
     (``CogVideoXPipeline.denoise_step`` under the configuration's routing)
     of 49 frames at 480x720 from latent noise and prompt embeddings drawn
     from seed 0: its seconds (the first step, cold), resident and peak
     memory, finite latents that moved, and its launches: K1 once a block
     at (96, 17776, 64) (42) and no other kernel (``cogvideox_launches``).
Then one JSON line with the kernel records and, last, the result line.

Each kernel record: ``ms`` the kernel, ``plain_ms`` its plain version (which
repeats the kernel's arithmetic step by step in f32: a check, no yardstick of
speed), ``library_ms`` one PyTorch call that computes the same function on
the same inputs, checked against the plain version at the kernel's
tolerance: ``F.scaled_dot_product_attention`` on a view for K1, K2 and K6,
``F.conv3d`` on the channels-last-3d view for K4's bare variant (no
prologue, no epilogue; the kernel's own bare time is ``bare_ms``),
``F.group_norm`` for K5's act=None function; K3 has none (LayerNorm, two
GEMMs, GEGLU and the residual take four calls or more), so null.  These
library calls are yardsticks only: the port never makes them.  TF32 is off
for them as for everything here.  ``bound_ms`` is the least time the card
could take for the same work, computed from the shape (``work_*``: the
matrix products' flops over 989 TFLOP/s bf16, each input read and each
output written once over 3.35 TB/s, the larger), ``bound_by`` which of the
two, ``share`` = bound_ms / ms, and ``launches`` the count from the slice,
bench, apm, samplers, train, enhance, product, loader, mesh and cogvideox
phases (``product_launches``, ``bench_launches``, ``apm_launches``,
``samplers_launches``, ``train_launches``, ``mesh_launches`` and
``cogvideox_launches`` those phases' alone; the bench's in its timed
calls).
K3's record adds ``ms_level0/1/2`` and ``share_level0/1/2`` at the three
stage-1 UNet widths and ``scratch_mb_level0/1/2``, the peak
memory one call adds beyond its output (its G and LN(x) scratch), and its
f32 body at the FP32 rate: ``f32_*`` at level 0, ``f32_ms_level0/1/2``,
``f32_share_level0/1/2``, ``f32_plain_ms_level0/1/2`` (and
``f32_bound_ms_level*``) at the three widths, ``f32_stage2_ms``,
``f32_stage2_share``, ``f32_stage2_plain_ms`` at stage 2's level 0; K6's adds
``stage1_ms``, ``stage1_library_ms`` and ``stage1_share`` at the stage-1
level-0 geometry.  The flash D=512 instances (the VAE mid-block attention)
have records of their own, ``flash_attention_d512`` at (8, 9216, 512) and
``flash_attention_packed_d512`` at (2, 14400, 1x512) with ``b4_*`` at the
4-frame encode chunk; their ``library_ms`` is the first SDPA backend that
takes D=512 (``sdpa_backend``), and their ``launches`` are the wrappers'
``launches_d512``.  K5's record adds ``vae_ms``, ``vae_bound_ms`` and
``vae_share`` at the SD VAE's (2, 921600, 128).  K1-K4 carry their backward
(the VJP of the plain version in chunks, from the reference phase):
``bwd_ms`` at a training shape (``bwd_shape``; K1 and K4 the SVD UNet's
level 0, K3 level 0 with LN and residual, K2 stage 2's level 1),
``bwd_chunks`` there and ``bwd_max_abs_err`` against autograd through the
plain version; K5 and K6 have none (null).  ``train_launches`` are the
train phase's.  K2 adds ``cross_*`` at stage 2's level-0 cross-attention (145 keys), K4 ``t38_*``
at stage 2's level 0; K1, K2, K4 and K6 add ``f32_*``, their f32 instances
against their one-call equivalent in f32 (SDPA, ``F.conv3d``; TF32 off) with
their bounds at the FP32 rate (67 TFLOP/s): K1 at D=512 and at (10, 9216,
64) (``f32_d64_*``), K2 at stage 2's level-0 self-attention cut to 2 rows,
K6 at stage 2's and stage 1's level 0 (``f32_stage1_*``); K6 adds
``bf16_d32_*``, its FMA body in bf16 at stage 2's level-0 width as 10 heads
of 32, against SDPA in bf16.

There is no CPU path: without CUDA the script exits non-zero before any
result.  Every failed phase raises.
"""

from __future__ import annotations

import argparse
import collections
import importlib.util
import json
import math
import re
import statistics
import subprocess
import sys
import time
from typing import Optional

ALL_PHASES = ("card", "build", "kernels", "reference", "slice", "bench", "apm", "samplers",
              "train", "enhance", "interpolate", "product", "loader", "mesh", "cogvideox")
SLICE_FRAMES = 43
# Sampler step cuts for the slice phase (full: 25 first-chunk, 30 AR).
FIRST_CHUNK_STEPS = 25
AR_STEPS = 30
# The apm phase's sampler steps (first chunk and AR chunk, as the loader
# phase's CLI), and the samplers phase's steps per sampler.
APM_STEPS = 5
SAMPLER_STEPS = 4
# Stage-2 DDIM steps in the enhance phase (full: 30); at strength 0.97, 3
# steps leave 2 to run.
ENHANCE_STEPS = 3
ENHANCE_FRAMES = 64
# Stage 3: the enhance phase's 64 frames to 127; the pair-batch sweep over 16
# pairs; content moving 3 pixels a frame.
INTERP_FRAMES = 64
PAIR_BATCHES = (1, 2, 4, 8)
SWEEP_PAIRS = 16
SHIFT_PX = 3.0
# The product's frames (stage 1 makes (n + 1) // 2 = 43, the slice's cut).
PRODUCT_FRAMES = 85
# The loader phase's CLI run from the tree: the product's frames (so that the
# ControlNet and the CAM mergers run), its samplers cut to a few steps.
LOADER_FRAMES = 85
LOADER_SAMPLER_STEPS = 5
# Tolerances on max |kernel - plain| / max |plain|: bf16 rounds the kernels'
# on-chip intermediates (probabilities, LN output, GEGLU product, prologue
# output) to 8 mantissa bits, f32 differs only in summation order.
TOL = {"bf16": 2e-2, "f32": 1e-4}
# The card's published peaks (H100 SXM data sheet, dense, at 700 W) for the
# kernels' bounds: bf16 tensor cores and HBM3.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
# the FP32 rate outside the tensor cores (the f32 instances: no TF32)
PEAK_F32_FLOPS = 67e12
# Small-input references: max-abs on the [-1, 1] video, f32 on both devices
# (stage 1 measured 5.3e-5 on an H100; the sampler's 1/sigma steps and stage
# 2's guidance scale of 9 amplify summation-order differences).
REFERENCE_ATOL = 5e-4


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# A device sleep queued before each timed call (about 1 ms on an H100), long
# enough for the host to enqueue the call behind it.
SLEEP_CYCLES = 2_000_000


def _time_ms(fn, reps: int = 5) -> float:
    """Median device time of one call of fn (CUDA events around it), after one
    warm-up call.  Each call is queued behind a device sleep, so the events
    time its kernels back to back, not the host's checks, allocations and
    launches before them (in the pipelines the host runs ahead of the card)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# Work of each kernel at a shape, as (flops, bytes): flops are the matrix
# products' multiply-adds times two (softmax, prologue and epilogue arithmetic
# is left out: it runs beside the products, not on the tensor cores); bytes
# read each input once and write each output once, whatever a kernel re-reads.

def work_flash(batch: int, heads: int, lq: int, lk: int, d: int, elem: int = 2) -> tuple:
    """K1 (heads=1, batch = B*H) and K2: S = QK^T and O = PV."""
    return 4 * batch * heads * lq * lk * d, elem * batch * heads * d * (2 * lq + 2 * lk)


def work_geglu(n: int, c: int, inner: int, elem: int = 2) -> tuple:
    """K3: x (n, c) @ W1 (c, 2*inner), GEGLU, @ W2 (inner, c), residual; the
    weights in ``elem`` bytes, the biases and LN parameters in f32."""
    flops = 2 * n * c * 2 * inner + 2 * n * inner * c
    return flops, elem * (2 * n * c + 3 * inner * c) + 4 * (2 * inner + 3 * c)


def work_temporal_conv(b: int, t: int, s: int, c: int, co: int, kt: int = 3, *,
                       res: bool = True, pre: bool = True, elem: int = 2) -> tuple:
    """K4: kt taps of (B*T*S, C) @ (C, C_out); reads x, W (and res), writes out."""
    rows = b * t * s
    nbytes = elem * (rows * c + kt * c * co + rows * co * (2 if res else 1)) + 4 * (
        co + (2 * b * c if pre else 0) + (b * t if res else 0))
    return 2 * rows * c * co * kt, nbytes


def work_group_norm(n: int, l: int, c: int, elem: int = 2) -> tuple:
    """K5: reads x once and writes the output once (no matrix products)."""
    return 0, 2 * elem * n * l * c + 4 * 2 * c


def work_group_norm_affine(n: int, l: int, c: int, elem: int = 2) -> tuple:
    """K5's affine entry: reads x once, writes the f32 affine (a, b)."""
    return 0, elem * n * l * c + 4 * (2 * c + 2 * n * c)


def work_temporal_attention(b: int, tq: int, tkv: int, s: int, heads: int, d: int,
                            elem: int = 2) -> tuple:
    """K6: per (batch, pixel, head), (tq, d) x (tkv, d) scores and P V."""
    return (4 * b * s * heads * tq * tkv * d,
            elem * b * s * heads * d * (2 * tq + 2 * tkv))


def bound(work: tuple, peak_flops: float = PEAK_BF16_FLOPS) -> dict:
    """The least time the card could take for (flops, bytes): the larger of
    flops over the peak rate for their type (bf16 on the tensor cores unless
    given) and bytes over HBM's rate."""
    flops, nbytes = work
    ops_ms = flops / peak_flops * 1e3
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    return dict(bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes")


def _yardstick(rec: dict, work: tuple, peak_flops: float = PEAK_BF16_FLOPS) -> dict:
    """Adds bound_ms, bound_by and share (bound over kernel time) to rec."""
    rec.update(bound(work, peak_flops))
    rec["share"] = rec["bound_ms"] / rec["ms"]
    return rec


def _ptxas_summary(log: str) -> list:
    """One line per kernel from nvcc's ``-Xptxas -v`` log: its name (with the
    template arguments as mangled), registers and spills; and, as they are,
    ptxas's numbered notes on a kernel's code (``(C7...)``: serialized or
    fenced ``wgmma``)."""
    out, name, spill = [], "?", ""
    for line in log.splitlines():
        if re.search(r"\(C\d+\)", line):
            out.append(line.strip())
            continue
        entry = re.search(r"Compiling entry function '_ZN4st2v(\d+)(\w+)'", line)
        if entry:
            n = int(entry.group(1))
            rest = entry.group(2)
            args = re.match(r"I(\w*?)EEv", rest[n:])
            name = rest[:n] + (f"<{args.group(1)}>" if args else "")
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line:
            used = re.search(r"Used (\d+) registers", line)
            out.append(f"{name}: {used.group(1) if used else '?'} registers, {spill}")
    return out


def check_wgmma_notes(lines: list) -> None:
    """Fails on ptxas's note that it serialized a kernel's ``wgmma`` (C7510 to
    C7515: "wgmma.mma_async instructions are serialized"); other numbered
    notes pass."""
    bad = [line for line in lines if "serialized" in line and re.search(r"\(C\d+\)", line)]
    if bad:
        raise AssertionError("ptxas serialized wgmma:\n" + "\n".join(bad))


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


def _randn_factory(seed: int = 0):
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(seed)

    def randn(*shape, dtype=None, std=1.0, mean=0.0):
        return (torch.randn(shape, generator=gen, device=dev) * std + mean).to(
            dtype or torch.bfloat16)

    return randn, gen


def _tol(dtype) -> float:
    import torch

    return TOL["f32" if dtype == torch.float32 else "bf16"]


def _f32_record(kernel, library, work: tuple, prefix: str = "f32_", plain=None) -> dict:
    """An f32 instance (FMA units, full f32) timed beside its one-call
    equivalent (TF32 off for the whole run; none: null) and its plain
    version where given, its bound at the FP32 rate: ``<prefix>*`` keys of
    its kernel's record."""
    rec = _yardstick(dict(ms=_time_ms(kernel),
                          library_ms=None if library is None else _time_ms(library)), work,
                     PEAK_F32_FLOPS)
    if plain is not None:
        rec["plain_ms"] = _time_ms(plain, reps=3)
    return {f"{prefix}{key}": value for key, value in rec.items()}


def _f32_line(name: str, rec: dict, prefix: str, library: str) -> None:
    lib, plain = rec[f"{prefix}library_ms"], rec.get(f"{prefix}plain_ms")
    print(f"  {name}: kernel {rec[f'{prefix}ms']:.3f} ms, "
          + (f"{library} {lib:.3f} ms, " if lib is not None else "no one-call yardstick, ")
          + (f"plain {plain:.3f} ms, " if plain is not None else "")
          + f"bound {rec[f'{prefix}bound_ms']:.3f} ms at the FP32 rate "
          f"({rec[f'{prefix}bound_by']}), share {rec[f'{prefix}share']:.3f}", flush=True)


def _sdpa_backend(qh, kh, vh) -> tuple:
    """The first SDPA backend (flash, cuDNN, memory-efficient, math) that takes
    these (B, H, L, D) views, restricted with ``sdpa_kernel``: (call, name)."""
    import warnings

    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        def call(backend=backend):
            with sdpa_kernel(backend):
                return F.scaled_dot_product_attention(qh, kh, vh)
        try:
            with warnings.catch_warnings():   # each refusal warns why
                warnings.simplefilter("ignore")
                call()
            torch.cuda.synchronize()
        except RuntimeError:
            continue
        return call, backend.name
    raise RuntimeError("no SDPA backend takes these inputs")


def _d512_record(name: str, kernel, plain, views: tuple, ref, unview, work: tuple) -> dict:
    """A flash D=512 instance timed beside its plain version and SDPA (the
    first backend that takes D=512, checked against the plain version)."""
    library, backend = _sdpa_backend(*views)
    _compare(f"{name} yardstick SDPA ({backend})", unview(library()), ref, TOL["bf16"])
    rec = _yardstick(dict(ms=_time_ms(kernel), plain_ms=_time_ms(plain, reps=3),
                          library_ms=_time_ms(library), sdpa_backend=backend), work)
    print(f"  {name} time bf16: kernel {rec['ms']:.3f} ms, SDPA ({backend}) "
          f"{rec['library_ms']:.3f} ms, plain {rec['plain_ms']:.3f} ms, bound "
          f"{rec['bound_ms']:.3f} ms ({rec['bound_by']}), share {rec['share']:.3f}", flush=True)
    return rec


# f32 K1 rows that are timed beside SDPA f32: (B*H, L, D) -> key prefix of
# K1's record: the stage-1 VAE encoder's mid attention (once a video; the
# row's ``f32_*`` keys), the temporal decoder's (one 8-frame chunk under the
# f32 decode) and the f32 D=64 body
K1_F32_PREFIX = {(1, 9216, 512): "f32_", (8, 9216, 512): "f32_b8_",
                 (10, 9216, 64): "f32_d64_"}
# (B*H, L) of the D=512 ones
K1_F32_TIMED = tuple((bh, length) for bh, length, d in K1_F32_PREFIX if d == 512)


def check_k1(randn) -> dict:
    """K1 at the stage-1 geometries, the ragged cases and a zero-padded head
    dim; the D=512 instance (the VAE mid-block attention) gets a record of its
    own; the f32 instances (the stage-1 VAE's attention, the f32 D=64 body)
    ``f32_*`` keys in K1's (``K1_F32_PREFIX``), each timed beside SDPA f32."""
    import torch
    import torch.nn.functional as F

    from streamingt2v_torch.ops import flash_attention as fa

    bf16, f32 = torch.bfloat16, torch.float32
    rec, errs, rec512, errs512, f32_rec = {}, [], {}, [], {}
    for bh, length, d, dtype, label in [
            (250, 9216, 64, bf16, "unet level0 self-attn"),
            (500, 2304, 64, bf16, "unet level1 self-attn"),
            (70, 9216, 64, bf16, "controlnet level0 self-attn"),
            (96, 17776, 64, bf16, "cogvideox joint self-attn, ragged last tile"),
            (8, 9216, 512, bf16, "vae decoder mid attn"),
            (3, 1000, 512, bf16, "D=512 ragged L=1000"),
            (2, 40, 512, bf16, "D=512 L=40, one ragged tile"),
            (1, 9216, 512, f32, "vae encoder mid attn (f32)"),
            (8, 9216, 512, f32, "vae decoder mid attn, f32 decode chunk"),
            (2, 1000, 512, f32, "f32 D=512 ragged L=1000"),
            (3, 40, 512, f32, "f32 D=512 L=40, one ragged tile"),
            (1, 4111, 512, f32, "f32 D=512 ragged L=4111"),
            (24, 1000, 512, f32, "f32 D=512 ragged L=1000, keys not split"),
            (10, 9216, 64, f32, "f32 D=64, two frames of level-0 self-attn"),
            (3, 1000, 64, f32, "f32 D=64 ragged L=1000"),
            (5, 77, 32, f32, "f32 head dim 32, zero-padded, ragged L=77"),
            (6, 77, 64, bf16, "ragged L=77"),
            (4, 1000, 64, bf16, "ragged L=1000"),
            (5, 130, 32, bf16, "head dim 32, zero-padded")]:
        q, k, v = (randn(bh, length, d, dtype=dtype) for _ in range(3))
        out = fa.flash_attention(q, k, v)
        rows = min(bh, 4)
        ref = fa.flash_attention_reference(q[:rows], k[:rows], v[:rows])
        err = _compare(f"K1 {label} {(bh, length, d)} {dtype}", out[:rows], ref, _tol(dtype))
        errs.append(err)
        if d == 512 and dtype == bf16:
            errs512.append(err)
        if dtype == f32 and (bh, length, d) in K1_F32_PREFIX:
            prefix = K1_F32_PREFIX[(bh, length, d)]
            library, backend = _sdpa_backend(q[:, None], k[:, None], v[:, None])
            _compare(f"K1 yardstick SDPA ({backend}) f32", library()[:rows, 0], ref, _tol(dtype))
            r = _f32_record(lambda: fa.flash_attention(q, k, v), library,
                            work_flash(bh, 1, length, length, d, elem=4), prefix,
                            lambda: fa.flash_attention_reference(q, k, v))
            r.update({f"{prefix}shape": [bh, length, d], f"{prefix}sdpa_backend": backend})
            f32_rec.update(r)
            _f32_line(f"K1 time {(bh, length, d)} f32", r, prefix, f"SDPA ({backend})")
        if (bh, length, d) == (8, 9216, 512) and dtype == bf16:
            rec512 = _d512_record(
                f"K1 {(bh, length, d)}", lambda: fa.flash_attention(q, k, v),
                lambda: fa.flash_attention_reference(q, k, v), (q[:, None], k[:, None], v[:, None]),
                ref, lambda o: o[:rows, 0], work_flash(bh, 1, length, length, d))
            rec512["shape"] = [bh, length, d]
        if (bh, length, d) == (250, 9216, 64):
            chunk = 16

            def plain_full():
                for i in range(0, bh, chunk):
                    fa.flash_attention_reference(q[i:i + chunk], k[i:i + chunk], v[i:i + chunk])

            def library():
                return F.scaled_dot_product_attention(q[:, None], k[:, None], v[:, None])

            _compare("K1 yardstick SDPA on (B*H, 1, L, D)", library()[:rows, 0], ref,
                     _tol(dtype))
            rec = _yardstick(dict(ms=_time_ms(lambda: fa.flash_attention(q, k, v)),
                                  plain_ms=_time_ms(plain_full, reps=3),
                                  library_ms=_time_ms(library), shape=[bh, length, d]),
                             work_flash(bh, 1, length, length, d))
            print(f"  K1 time {(bh, length, d)} bf16: kernel {rec['ms']:.3f} ms, "
                  f"SDPA {rec['library_ms']:.3f} ms, "
                  f"plain (in {chunk}-row chunks) {rec['plain_ms']:.3f} ms, bound "
                  f"{rec['bound_ms']:.3f} ms ({rec['bound_by']}), share {rec['share']:.3f}",
                  flush=True)
        del q, k, v, out, ref
    rec.update(f32_rec, max_abs_err=max(errs))
    rec512["max_abs_err"] = max(errs512)
    return {"flash_attention": rec, "flash_attention_d512": rec512}


def check_k2(randn) -> dict:
    """K2 at the stage-2 geometries and a ragged one; timed against SDPA, K1 with its head-fold transposes and the plain
    version at the level-0 self-attention, and against SDPA at the level-0
    cross-attention (145 keys: ``cross_*``).  The D=512 instance (the SD
    VAE's mid-block attention, one head) gets a record of its own, timed at
    the 2-frame decode and 4-frame encode chunks."""
    import torch
    import torch.nn.functional as F

    from streamingt2v_torch.ops import flash_attention as fa

    bf16, f32 = torch.bfloat16, torch.float32
    rec, errs, rec512, errs512, cross, f32_rec = {}, [], {}, [], {}, {}
    for b, lq, lk, heads, d, dtype, label in [
            (38, 14400, 14400, 5, 64, bf16, "i2vgen level0 self-attn"),
            (38, 3600, 3600, 10, 64, bf16, "i2vgen level1 self-attn"),
            (38, 14400, 145, 5, 64, bf16, "i2vgen level0 cross-attn"),
            (3, 1001, 145, 5, 64, bf16, "ragged q 1001, kv 145"),
            (2, 14400, 14400, 1, 512, bf16, "sd-vae mid attn, decode chunk"),
            (4, 14400, 14400, 1, 512, bf16, "sd-vae mid attn, encode chunk"),
            (2, 777, 130, 1, 512, bf16, "D=512 ragged q 777, kv 130"),
            (1, 500, 500, 2, 512, bf16, "D=512 two heads"),
            (2, 2048, 2048, 2, 64, f32, "f32"),
            (2, 14400, 14400, 5, 64, f32, "f32 i2vgen level0 self-attn, 2 rows"),
            (3, 1001, 145, 5, 64, f32, "f32 ragged q 1001, kv 145")]:
        q = randn(b, lq, heads * d, dtype=dtype)
        k, v = (randn(b, lk, heads * d, dtype=dtype) for _ in range(2))
        out = fa.flash_attention_packed(q, k, v, num_heads=heads)
        ref = fa.flash_attention_packed_reference(q[:1], k[:1], v[:1], heads)
        name = f"K2 {label} q{(b, lq, heads * d)} kv{(b, lk)} {heads} heads {dtype}"
        err = _compare(name, out[:1], ref, _tol(dtype))
        errs.append(err)
        if d == 512 and dtype == bf16:
            errs512.append(err)
        if dtype == f32 and lq == 14400:
            # against the first SDPA backend that takes f32 on the (B, H, L, D)
            # strided view, its bound at the FP32 rate
            views = tuple(z.view(b, -1, heads, d).transpose(1, 2) for z in (q, k, v))
            library, backend = _sdpa_backend(*views)
            _compare(f"K2 yardstick SDPA ({backend}) f32",
                     library()[:1].transpose(1, 2).reshape(1, lq, heads * d), ref, _tol(dtype))
            f32_rec = _f32_record(lambda: fa.flash_attention_packed(q, k, v, num_heads=heads),
                                  library, work_flash(b, heads, lq, lk, d, elem=4),
                                  plain=lambda: fa.flash_attention_packed_reference(q, k, v,
                                                                                    heads))
            f32_rec.update(f32_shape=[b, lq, heads * d], f32_sdpa_backend=backend)
            _f32_line(f"K2 time {(b, lq, heads * d)} f32", f32_rec, "f32_", f"SDPA ({backend})")
        if d == 512 and lq == 14400:
            r = _d512_record(
                f"K2 {(b, lq, heads * d)}",
                lambda: fa.flash_attention_packed(q, k, v, num_heads=heads),
                lambda: fa.flash_attention_packed_reference(q, k, v, heads),
                tuple(t.view(b, -1, 1, d).transpose(1, 2) for t in (q, k, v)), ref,
                lambda o: o[:1].transpose(1, 2).reshape(1, lq, d), work_flash(b, 1, lq, lk, d))
            if b == 2:
                rec512 = dict(r, shape=[b, lq, heads * d])
            else:   # the encode chunk
                rec512.update({f"b{b}_{key}": r[key] for key in (
                    "ms", "plain_ms", "library_ms", "bound_ms", "share")})
        if label in ("i2vgen level0 self-attn", "i2vgen level0 cross-attn"):
            qh, kh, vh = (t.view(b, -1, heads, d).transpose(1, 2) for t in (q, k, v))

            def library():
                return F.scaled_dot_product_attention(qh, kh, vh)

            _compare(f"K2 yardstick SDPA on the (B, H, L, D) strided view, {label}",
                     library()[:1].transpose(1, 2).reshape(1, lq, heads * d), ref, _tol(dtype))
            r = _yardstick(
                dict(ms=_time_ms(lambda: fa.flash_attention_packed(q, k, v, num_heads=heads)),
                     library_ms=_time_ms(library), shape=[b, lq, heads * d]),
                work_flash(b, heads, lq, lk, d))
            line = (f"  K2 time {(b, lq, heads * d)} kv {lk} bf16: kernel {r['ms']:.3f} ms, "
                    f"SDPA {r['library_ms']:.3f} ms")
            if lk == lq:
                def folded():
                    fold = [t.reshape(b, -1, heads, d).transpose(1, 2)
                            .reshape(b * heads, -1, d).contiguous() for t in (q, k, v)]
                    o = fa.flash_attention(*fold)
                    return o.reshape(b, heads, lq, d).transpose(1, 2).reshape(
                        b, lq, heads * d).contiguous()

                def plain_full():
                    for i in range(b):
                        fa.flash_attention_packed_reference(q[i:i + 1], k[i:i + 1],
                                                            v[i:i + 1], heads)

                r.update(k1_ms=_time_ms(folded), plain_ms=_time_ms(plain_full, reps=3))
                line += (f", K1 with head-fold transposes {r['k1_ms']:.3f} ms, plain (one "
                         f"batch row at a time) {r['plain_ms']:.3f} ms")
                rec = r
            else:
                cross = {f"cross_{key}": value for key, value in r.items()}
            print(line + f", bound {r['bound_ms']:.3f} ms ({r['bound_by']}), share "
                  f"{r['share']:.3f}", flush=True)
        del q, k, v, out, ref
    rec.update(cross, **f32_rec, max_abs_err=max(errs))
    rec512["max_abs_err"] = max(errs512)
    return {"flash_attention_packed": rec, "flash_attention_packed_d512": rec512}


K3_LEVELS = ((460800, 320), (115200, 640), (28800, 1280))   # the stage-1 UNet widths
K3_STAGE2 = (547200, 320)                                    # stage 2's level 0


def _k3_operands(randn, n: int, c: int, dtype, ln: bool, res: bool) -> tuple:
    """K3's operands at x (n, c), inner 4c, C_out = c: (args, kw, plain),
    ``plain`` the plain version's call on them."""
    import torch

    from streamingt2v_torch.ops.fused_ff import geglu_ff_reference

    f32, inner = torch.float32, 4 * c
    x = randn(n, c, dtype=dtype)
    w1 = randn(2 * inner, c, dtype=dtype, std=c ** -0.5)
    b1 = randn(2 * inner, dtype=f32, std=0.1)
    w2 = randn(c, inner, dtype=dtype, std=inner ** -0.5)
    b2 = randn(c, dtype=f32, std=0.1)
    lns = 1.0 + randn(c, dtype=f32, std=0.1) if ln else None
    lnb = randn(c, dtype=f32, std=0.1) if ln else None
    args = (x, w1, b1, w2, b2)
    return (args, dict(ln_scale=lns, ln_bias=lnb, residual=res),
            lambda: geglu_ff_reference(*args, lns, lnb, res))


def check_k3(randn) -> dict:
    """K3 at the UNet widths (each timed beside its bound, with the peak
    memory a call adds beyond its output: G and LN(x) of one chunk), at
    ragged shapes and without LN or residual; in f32 at the three stage-1
    widths and stage 2's level 0, each timed beside its bound at the FP32
    rate and its plain version, at ragged shapes, without LN or residual
    and at a C_out above 1280."""
    import torch

    from streamingt2v_torch.ops.fused_ff import chunk_size, geglu_ff

    bf16, f32 = torch.bfloat16, torch.float32
    rec, errs, f32_rec = {}, [], {}
    for n, c, dtype, ln, res, label in [
            (460800, 320, bf16, True, True, "unet level0"),
            (115200, 640, bf16, True, True, "unet level1"),
            (28800, 1280, bf16, True, True, "unet level2"),
            (547200, 320, bf16, True, True, "i2vgen level0"),
            (7200, 48, bf16, True, True, "ragged rows and width"),
            (7200, 48, bf16, False, False, "ragged, no LN/residual"),
            (115200, 640, bf16, False, False, "level1 no LN/residual"),
            (4096, 320, f32, True, True, "f32"),
            (4096, 320, f32, False, False, "f32 no LN/residual"),
            (4099, 48, f32, True, True, "f32 ragged rows and width"),
            (4099, 48, f32, False, True, "f32 ragged, residual without LN"),
            (2050, 1536, f32, True, False, "f32 C_out 1536, LN without residual"),
            *((n, c, f32, True, True, "f32 timed") for n, c in K3_LEVELS + (K3_STAGE2,))]:
        inner = 4 * c
        args, kw, plain = _k3_operands(randn, n, c, dtype, ln, res)
        out = geglu_ff(*args, **kw)
        errs.append(_compare(f"K3 {label} x{(n, c)} inner {inner} {dtype}", out, plain(),
                             _tol(dtype)))
        if label == "f32 timed":
            r = _f32_record(lambda: geglu_ff(*args, **kw), None, work_geglu(n, c, inner, elem=4),
                            prefix="", plain=plain)
            key = "stage2" if (n, c) == K3_STAGE2 else f"level{K3_LEVELS.index((n, c))}"
            for k in ("ms", "share", "plain_ms", "bound_ms"):
                f32_rec["f32_stage2_" + k if key == "stage2" else f"f32_{k}_{key}"] = r[k]
            if key == "level0":   # the f32 row's own keys
                f32_rec.update({f"f32_{k}": v for k, v in r.items()}, f32_shape=[n, c, inner])
            _f32_line(f"K3 time {(n, c, inner)} f32 ({key})", r, "", "")
        elif ln and (n, c) in K3_LEVELS:
            level = K3_LEVELS.index((n, c))
            del out
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out = geglu_ff(*args, **kw)
            torch.cuda.synchronize()
            extra = torch.cuda.max_memory_allocated() - base - out.numel() * out.element_size()
            r = _yardstick(dict(ms=_time_ms(lambda: geglu_ff(*args, **kw))),
                           work_geglu(n, c, inner))
            rec[f"ms_level{level}"], rec[f"share_level{level}"] = r["ms"], r["share"]
            rec[f"scratch_mb_level{level}"] = extra / 2**20
            line = (f"  K3 time {(n, c, inner)} bf16 level {level}: kernel {r['ms']:.3f} ms, "
                    f"bound {r['bound_ms']:.3f} ms ({r['bound_by']}), share {r['share']:.3f}; "
                    f"chunk {chunk_size(n, inner, c)} rows, scratch {extra / 2**20:.1f} MiB")
            if level == 0:
                r["plain_ms"] = _time_ms(plain, reps=3)
                rec.update(r, library_ms=None, shape=[n, c, inner])
                line += f", plain {r['plain_ms']:.3f} ms, no one-call yardstick"
            print(line, flush=True)
        del args, kw, plain, out
    rec.update(f32_rec, max_abs_err=max(errs))
    return rec


def _conv_args(randn, gen, b, t, s, c, co, kt, pre, res, dtype):
    import torch

    x = randn(b, t, s, c, dtype=dtype)
    w = randn(kt, c, co, dtype=dtype, std=(kt * c) ** -0.5)
    bias = randn(co, dtype=torch.float32, std=0.1)
    pa = (1.0 + randn(b, c, dtype=torch.float32, std=0.1)) if pre else None
    pb = randn(b, c, dtype=torch.float32, std=0.1) if pre else None
    r = randn(b, t, s, co, dtype=dtype) if res else None
    rw = torch.rand((b, t), generator=gen, device=x.device) if res else None
    return x, w, bias, r, rw, pa, pb


def _conv3d_view(x, w, bias):
    """The bare variant as one ``F.conv3d`` on the (B, C, T, S, 1)
    channels-last-3d view of x, with the bias in x's dtype as conv3d wants it:
    (call, the bias it used)."""
    import torch
    import torch.nn.functional as F

    xv = x.permute(0, 3, 1, 2).unsqueeze(-1)
    wv = w.permute(2, 1, 0)[..., None, None].contiguous(memory_format=torch.channels_last_3d)
    bias_lo = bias.to(x.dtype)
    pad = w.shape[0] // 2
    return (lambda: F.conv3d(xv, wv, bias_lo, padding=(pad, 0, 0)).squeeze(-1).permute(0, 2, 3, 1),
            bias_lo)


# K4's variants: (prologue, epilogue)
K4_VARIANTS = ((False, False), (True, False), (False, True), (True, True))
# (B, T, S, C, C_out) of the stage-1 temporal VAE decoder's time convs on one
# 8-frame chunk at 576x1024, its four levels (the f32 decode)
K4_F32_DECODER = ((1, 8, 9216, 512, 512), (1, 8, 36864, 512, 512), (1, 8, 147456, 256, 256),
                  (1, 8, 589824, 128, 128))


def check_k4(randn, gen) -> dict:
    """K4 at the main paths' geometries, the ragged cases in each of the four variants (the VAE's 3 -> 128 and 128 -> 3, T =
    1 and 2, kt 1 and 5), timed at stage 1's and stage 2's level 0 (pre+res,
    as the UNets call it, and bare against ``F.conv3d``: ``t38_*`` the
    latter); in f32 at the temporal VAE decoder's four widths (``K4_F32_DECODER``:
    ``f32_s<S>_*`` keys, pre+res and bare, the bare one against ``F.conv3d``
    f32; the top level's bare numbers also as ``f32_*``) and at ragged
    shapes in each variant."""
    import torch

    from streamingt2v_torch.ops import temporal_conv as tc

    bf16, f32 = torch.bfloat16, torch.float32
    rec, errs, t38, f32_rec = {}, [], {}, {}
    cases = [(2, 25, 9216, 320, 320, 3, True, True, bf16, "unet level0 out_conv"),
             (2, 25, 2304, 640, 640, 3, True, False, bf16, "unet level1 in_conv"),
             (2, 7, 576, 1280, 1280, 3, True, True, bf16, "controlnet level2"),
             (1, 8, 589824, 128, 128, 3, True, True, bf16, "vae decoder top level"),
             (1, 8, 589824, 3, 3, 3, False, False, bf16, "vae AE3DConv time mix C=3"),
             (1, 38, 14400, 320, 320, 3, True, True, bf16, "i2vgen level0 T=38"),
             (1, 38, 240, 1280, 1280, 3, True, True, bf16, "i2vgen level3 T=38"),
             (1, 64, 3600, 640, 640, 3, True, True, bf16, "T=64"),
             (2, 25, 576, 64, 96, 3, False, True, f32, "f32 res only"),
             (1, 40, 1024, 48, 32, 3, True, False, f32, "f32 prologue only T=40"),
             (1, 8, 589824, 3, 3, 3, False, False, f32, "f32 vae conv_out time mix C=3")]
    cases += [(b, t, s, c, co, 3, True, True, f32, "f32 vae decoder")
              for b, t, s, c, co in K4_F32_DECODER]
    for (b, t, s, c, co, kt), label in [((1, 8, 1000, 128, 128, 3), "f32 S ragged"),
                                        ((2, 5, 777, 68, 36, 3), "f32 S, C, C_out ragged"),
                                        ((1, 3, 300, 130, 201, 3), "f32 C, C_out odd"),
                                        ((1, 8, 9216, 3, 128, 3), "f32 vae 3->128"),
                                        ((1, 8, 9216, 128, 3, 3), "f32 vae 128->3"),
                                        ((1, 1, 4100, 64, 96, 3), "f32 T=1"),
                                        ((1, 2, 5000, 256, 256, 3), "f32 T=2"),
                                        ((2, 11, 777, 32, 64, 5), "f32 kt=5"),
                                        ((1, 9, 1000, 64, 96, 1), "f32 kt=1")]:
        cases += [(b, t, s, c, co, kt, pre, res, f32, f"{label} pre={pre} res={res}")
                  for pre, res in K4_VARIANTS]
    for (b, t, s, c, co, kt), label in [((1, 8, 9216, 3, 128, 3), "vae 3->128"),
                                        ((1, 8, 9216, 128, 3, 3), "vae 128->3"),
                                        ((1, 1, 4100, 320, 320, 3), "T=1"),
                                        ((1, 2, 14400, 320, 320, 3), "i2vgen pre-pass T=2"),
                                        ((1, 9, 1000, 64, 96, 1), "kt=1"),
                                        ((2, 11, 777, 128, 64, 5), "kt=5")]:
        cases += [(b, t, s, c, co, kt, pre, res, bf16, f"{label} pre={pre} res={res}")
                  for pre, res in K4_VARIANTS]
    for b, t, s, c, co, kt, pre, res, dtype, label in cases:
        args = _conv_args(randn, gen, b, t, s, c, co, kt, pre, res, dtype)
        x, w, bias = args[:3]
        out = tc.temporal_conv(*args)
        ref = tc.temporal_conv_reference(*args)
        name = f"K4 {label} x{(b, t, s, c)}->{co} kt {kt} {dtype}"
        errs.append(_compare(name, out, ref, _tol(dtype)))
        if label in ("unet level0 out_conv", "i2vgen level0 T=38"):
            library, bias_lo = _conv3d_view(x, w, bias)
            _compare(f"K4 yardstick conv3d {(b, t, s, c, co)} bare", library(),
                     tc.temporal_conv_reference(x, w, bias_lo.float()), _tol(dtype))
            r = _yardstick(dict(ms=_time_ms(lambda: tc.temporal_conv(*args)),
                                plain_ms=_time_ms(lambda: tc.temporal_conv_reference(*args),
                                                  reps=3),
                                bare_ms=_time_ms(lambda: tc.temporal_conv(x, w, bias)),
                                library_ms=_time_ms(library), shape=[b, t, s, c, co]),
                           work_temporal_conv(b, t, s, c, co))
            r["bare_share"] = bound(work_temporal_conv(b, t, s, c, co, res=False, pre=False))[
                "bound_ms"] / r["bare_ms"]
            print(f"  K4 time {(b, t, s, c, co)} bf16 pre+res: kernel "
                  f"{r['ms']:.3f} ms, plain "
                  f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms ({r['bound_by']}), "
                  f"share {r['share']:.3f}; bare: kernel {r['bare_ms']:.3f} ms, conv3d {r['library_ms']:.3f} ms, share "
                  f"{r['bare_share']:.3f}", flush=True)
            if not rec:
                rec = r
            else:
                t38 = {f"t38_{key}": value for key, value in r.items()}
        if dtype == f32 and (b, t, s, c, co) in K4_F32_DECODER and kt == 3:
            library, bias_lo = _conv3d_view(x, w, bias)
            _compare(f"K4 yardstick conv3d {(b, t, s, c, co)} f32", library(),
                     tc.temporal_conv_reference(x, w, bias_lo), _tol(dtype))
            prefix = f"f32_s{s}_"
            bare = _f32_record(lambda: tc.temporal_conv(x, w, bias), library,
                               work_temporal_conv(b, t, s, c, co, res=False, pre=False, elem=4),
                               prefix)
            _f32_line(f"K4 time {(b, t, s, c, co)} f32 bare", bare, prefix, "conv3d")
            full = _f32_record(lambda: tc.temporal_conv(*args), None,
                               work_temporal_conv(b, t, s, c, co, elem=4), prefix + "pre_res_",
                               lambda: tc.temporal_conv_reference(*args))
            _f32_line(f"K4 time {(b, t, s, c, co)} f32 pre+res", full, prefix + "pre_res_", "")
            f32_rec.update(bare, **{k: v for k, v in full.items() if "library" not in k})
            if s == 589824:   # the row's f32 numbers: the top level, bare
                f32_rec.update({"f32_" + k[len(prefix):]: v for k, v in bare.items()},
                               f32_shape=[b, t, s, c, co])
        del args, x, w, bias, out, ref
    rec.update(t38, **f32_rec, max_abs_err=max(errs))
    return rec


def stage1_k5_geometries(bf16, f32) -> list:
    """Every geometry at which stage 1 sends K5, as (N, L, C, act, eps,
    dtype, label); each gives K5 a launch plan of its own (``launch_plan``).
    The VideoUNet runs 2 x 25 frames and the ControlNet 2 x 7: their
    ResBlocks SiLU at eps 1e-5, their transformers' input norms act=None at
    1e-6.  The VAE decoder runs pieces of 8 frames and a last one of 1, the
    conditioning's f32 encoder one frame: SiLU at 1e-6, the mid attention's
    norm act=None."""
    unet = ((9216, 320), (9216, 640), (9216, 960), (2304, 320), (2304, 640), (2304, 960),
            (2304, 1280), (2304, 1920), (576, 640), (576, 1280), (576, 1920), (576, 2560),
            (144, 1280), (144, 2560))
    controlnet = ((9216, 320), (2304, 320), (2304, 640), (576, 640), (576, 1280), (144, 1280))
    transformers = ((9216, 320), (2304, 640), (576, 1280), (144, 1280))
    decoder = ((589824, 128), (589824, 256), (147456, 256), (147456, 512), (36864, 512),
               (9216, 512))
    encoder = ((589824, 128), (147456, 128), (147456, 256), (36864, 256), (36864, 512),
               (9216, 512))
    rows = []
    for n, name, resblocks in ((50, "VideoUNet", unet), (14, "ControlNet", controlnet)):
        rows += [(n, l, c, "silu", 1e-5, bf16, f"stage-1 {name} ResBlock") for l, c in resblocks]
        rows += [(n, l, c, None, 1e-6, bf16, f"stage-1 {name} transformer")
                 for l, c in transformers]
    for n in (8, 1):
        rows += [(n, l, c, "silu", 1e-6, bf16, "stage-1 VAE decoder") for l, c in decoder]
        rows.append((n, 9216, 512, None, 1e-6, bf16, "stage-1 VAE decoder mid attention"))
    rows += [(1, l, c, "silu", 1e-6, f32, "stage-1 f32 conditioning encoder")
             for l, c in encoder]
    rows.append((1, 9216, 512, None, 1e-6, f32, "stage-1 f32 conditioning encoder mid attention"))
    return rows


def check_k5(randn) -> dict:
    """K5 at the stage-2 geometries, timed against its plain version
    (``fused_group_norm_reference``, the plain path of ``norms.group_norm``),
    and against that plain version at every geometry stage 1 sends it."""
    import torch
    import torch.nn.functional as F

    from streamingt2v_torch.ops.fused_group_norm import (
        fused_group_norm, fused_group_norm_reference)

    bf16, f32 = torch.bfloat16, torch.float32
    rec, errs, f32_rec = {}, [], {}
    for n, l, c, act, eps, dtype, label in [
            (38, 14400, 320, "silu", 1e-5, bf16, "ResnetBlock2D level0"),
            (38, 3600, 640, "silu", 1e-5, bf16, "ResnetBlock2D level1"),
            (38, 14400, 320, None, 1e-6, bf16, "Transformer2D level0"),
            (2, 921600, 128, "silu", 1e-6, bf16, "sd-vae top level"),
            (4, 4096, 256, "silu", 1e-6, f32, "f32"),
            (38, 14400, 320, None, 1e-5, f32, "f32 ResnetBlock2D level0 width"),
            *stage1_k5_geometries(bf16, f32)]:
        x = randn(n, l, c, dtype=dtype, std=2.0, mean=0.5)
        scale = 1.0 + randn(c, dtype=f32, std=0.1)
        bias = randn(c, dtype=f32, std=0.1)
        kw = dict(num_groups=32, eps=eps, act=act)
        out = fused_group_norm(x, scale, bias, **kw)
        ref = fused_group_norm_reference(x, scale, bias, **kw)
        errs.append(_compare(f"K5 {label} {(n, l, c)} act={act} {dtype}", out, ref,
                             _tol(dtype)))
        if label == "ResnetBlock2D level0":
            # the yardstick F.group_norm computes the act=None function, on the
            # (N, C, L) view, with the affine in x's dtype
            scale_lo, bias_lo = scale.to(dtype), bias.to(dtype)
            xt = x.transpose(1, 2)
            bare = dict(num_groups=32, eps=eps, act=None)

            def library():
                return F.group_norm(xt, 32, scale_lo, bias_lo, eps)

            _compare("K5 yardstick F.group_norm on (N, C, L), act=None",
                     library().transpose(1, 2),
                     fused_group_norm_reference(x, scale_lo.float(), bias_lo.float(), **bare),
                     _tol(dtype))
            rec = _yardstick(
                dict(ms=_time_ms(lambda: fused_group_norm(x, scale, bias, **kw)),
                     plain_ms=_time_ms(lambda: fused_group_norm_reference(x, scale, bias, **kw),
                                       reps=3),
                     no_act_ms=_time_ms(lambda: fused_group_norm(x, scale, bias, **bare)),
                     library_ms=_time_ms(library), shape=[n, l, c]),
                work_group_norm(n, l, c))
            print(f"  K5 time {(n, l, c)} bf16 silu: kernel {rec['ms']:.3f} ms, plain "
                  f"version {rec['plain_ms']:.3f} ms, bound {rec['bound_ms']:.3f} ms "
                  f"({rec['bound_by']}), share {rec['share']:.3f}; act=None: kernel "
                  f"{rec['no_act_ms']:.3f} ms, F.group_norm {rec['library_ms']:.3f} ms",
                  flush=True)
        if dtype == f32 and n == 38:
            # act=None: the function F.group_norm computes, on the (N, C, L) view
            xt = x.transpose(1, 2)
            f32_rec = _f32_record(
                lambda: fused_group_norm(x, scale, bias, **kw),
                lambda: F.group_norm(xt, 32, scale, bias, eps), work_group_norm(n, l, c, elem=4),
                plain=lambda: fused_group_norm_reference(x, scale, bias, **kw))
            f32_rec["f32_shape"] = [n, l, c]
            _compare("K5 yardstick F.group_norm f32 on (N, C, L)",
                     F.group_norm(xt, 32, scale, bias, eps).transpose(1, 2), ref, _tol(dtype))
            _f32_line(f"K5 time {(n, l, c)} f32 act=None", f32_rec, "f32_", "F.group_norm")
        if label == "sd-vae top level":
            r = _yardstick(dict(ms=_time_ms(lambda: fused_group_norm(x, scale, bias, **kw))),
                           work_group_norm(n, l, c))
            vae = {f"vae_{key}": r[key] for key in ("ms", "bound_ms", "share")}
            print(f"  K5 time {(n, l, c)} bf16 silu: kernel {r['ms']:.3f} ms, bound "
                  f"{r['bound_ms']:.3f} ms ({r['bound_by']}), share {r['share']:.3f}", flush=True)
        del x, out, ref
    # a large common offset with a small spread: against f64 statistics
    x = randn(2, 4096, 128, dtype=f32, std=1e-3, mean=100.0)
    ones, zeros = torch.ones(128, device=x.device), torch.zeros(128, device=x.device)
    out = fused_group_norm(x, ones, zeros, num_groups=32, eps=1e-6)
    xg = x.double().reshape(2, 4096, 32, 4)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = xg.var(dim=(1, 3), unbiased=False, keepdim=True)
    ref = ((xg - mean) / torch.sqrt(var + 1e-6)).reshape(x.shape)
    err = (out.double() - ref).abs().max().item()
    print(f"  K5 offset 100, std 1e-3 (2, 4096, 128) f32 vs f64 statistics: "
          f"max_abs_err={err:.3e} tol=5e-2 {'ok' if err <= 5e-2 else 'FAIL'}", flush=True)
    if not err <= 5e-2:
        raise AssertionError(f"K5 loses the variance at a large offset ({err:.3e})")
    rec.update(vae, **f32_rec, max_abs_err=max(errs))
    return rec


def k4_prologue_geometries() -> list:
    """Every geometry at which ``_time_conv`` sends the statistics of K4's
    GroupNorm+SiLU prologue to ``fused_group_norm_affine`` on the card (32
    groups, eps 1e-5), as (N, L, C, network, launches a network call): stage
    1's VideoUNet (the first chunk's and the AR one's) on 2 x 25 frames and
    its ControlNet on 2 x 7, two norms in each TemporalUNetResBlock; the
    temporal VAE decoder's TemporalResStacks on pieces of 8 frames and a last
    one of 1, two norms each; stage 2's UNet on one 38-frame chunk of one CFG
    half, four norms in each TemporalConvLayer."""
    unet = ((9216, 320, 10), (2304, 640, 10), (576, 1280, 10), (144, 1280, 14))
    controlnet = ((9216, 320, 4), (2304, 640, 4), (576, 1280, 4), (144, 1280, 8))
    decoder = ((589824, 128, 6), (147456, 256, 6), (36864, 512, 6), (9216, 512, 10))
    stage2 = ((14400, 320, 20), (3600, 640, 20), (920, 1280, 20), (240, 1280, 28))
    rows = [(2, 25 * s, c, "stage-1 VideoUNet", k) for s, c, k in unet]
    rows += [(2, 7 * s, c, "stage-1 ControlNet", k) for s, c, k in controlnet]
    rows += [(1, t * s, c, f"stage-1 VAE decoder {t}-frame piece", k)
             for t in (8, 1) for s, c, k in decoder]
    rows += [(1, 38 * s, c, "stage-2 UNet", k) for s, c, k in stage2]
    return rows


def k4_prologue_launches() -> dict:
    """``fused_group_norm_affine`` launches a unit, from
    ``k4_prologue_geometries``: an AR step (one VideoUNet and one ControlNet
    call), a stage-2 step as ``step_ms`` counts it (one chunk's 2 CFG halves;
    a DDIM step over 3 chunks is 3 of them) and a 25-frame decode call
    (pieces of 8, 8, 8, 1)."""
    per_call = collections.Counter()
    for *_, network, k in k4_prologue_geometries():
        per_call[network] += k
    return {"ar_step": per_call["stage-1 VideoUNet"] + per_call["stage-1 ControlNet"],
            "stage2_step": 2 * per_call["stage-2 UNet"],
            "decode_call": 3 * per_call["stage-1 VAE decoder 8-frame piece"]
            + per_call["stage-1 VAE decoder 1-frame piece"]}


# the affine entry's timed cases, (N, L, C), dtype and record-key prefix:
# the decode's level-0 piece (also in f32, the f32 decode's) and stage 2's
K5_AFFINE_TIMED = (((1, 8 * 589824, 128), "bfloat16", ""),
                   ((1, 38 * 14400, 320), "bfloat16", "stage2_"),
                   ((1, 8 * 589824, 128), "float32", "f32_"))


def check_k5_affine(randn) -> dict:
    """K5's affine entry (``fused_group_norm_affine``: pass 1 and the merge)
    against the plain chain (``group_norm_affine_reference``, the plain path
    of ``norms.group_norm_affine``)
    at every geometry of ``k4_prologue_geometries`` in bf16 and f32, within
    TOL["f32"] of max |a| and of max |b| (only the f32 summation order
    differs), and at a large common offset against f64 statistics; timed at
    ``K5_AFFINE_TIMED`` beside the plain chain, against its bound (x read
    once)."""
    import torch

    from streamingt2v_torch.ops.fused_group_norm import (
        fused_group_norm_affine, group_norm_affine_reference)

    bf16, f32 = torch.bfloat16, torch.float32
    timed = {(shape, getattr(torch, dtype)): key for shape, dtype, key in K5_AFFINE_TIMED}
    rec, errs = {}, []
    for n, l, c, network, _ in k4_prologue_geometries():
        for dtype in (bf16, f32):
            x = randn(n, l, c, dtype=dtype, std=2.0, mean=0.5)
            scale = 1.0 + randn(c, dtype=f32, std=0.1)
            bias = randn(c, dtype=f32, std=0.1)
            kw = dict(num_groups=32, eps=1e-5)
            a, b = fused_group_norm_affine(x, scale, bias, **kw)
            ra, rb = group_norm_affine_reference(x, scale, bias, **kw)
            for name, got, ref in (("a", a, ra), ("b", b, rb)):
                errs.append(_compare(f"K5 affine {network} {(n, l, c)} {dtype} {name}", got, ref,
                                     TOL["f32"]))
            key = timed.get(((n, l, c), dtype))
            if key is not None:
                r = _yardstick(
                    dict(ms=_time_ms(lambda: fused_group_norm_affine(x, scale, bias, **kw)),
                         plain_ms=_time_ms(
                             lambda: group_norm_affine_reference(x, scale, bias, **kw), reps=3)),
                    work_group_norm_affine(n, l, c, x.element_size()))
                rec.update({f"{key}{k}": v for k, v in r.items()}, **{f"{key}shape": [n, l, c]})
                print(f"  K5 affine time {(n, l, c)} {dtype}: kernel {r['ms']:.3f} ms, plain "
                      f"chain {r['plain_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms "
                      f"({r['bound_by']}), share {r['share']:.3f}", flush=True)
            del x, a, b, ra, rb
    # a large common offset with a small spread: against f64 statistics
    x = randn(2, 4096, 128, dtype=f32, std=1e-3, mean=100.0)
    ones, zeros = torch.ones(128, device=x.device), torch.zeros(128, device=x.device)
    a, b = fused_group_norm_affine(x, ones, zeros, num_groups=32, eps=1e-6)
    xg = x.double().reshape(2, 4096, 32, 4)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = xg.var(dim=(1, 3), unbiased=False, keepdim=True)
    ref = ((xg - mean) / torch.sqrt(var + 1e-6)).reshape(x.shape)
    err = (x.double() * a.double()[:, None] + b.double()[:, None] - ref).abs().max().item()
    print(f"  K5 affine offset 100, std 1e-3 (2, 4096, 128) f32 vs f64 statistics: "
          f"max_abs_err={err:.3e} tol=5e-2 {'ok' if err <= 5e-2 else 'FAIL'}", flush=True)
    if not err <= 5e-2:
        raise AssertionError(f"K5's affine entry loses the variance at a large offset ({err:.3e})")
    print(f"  K5 affine launches predicted from the geometries: {k4_prologue_launches()}",
          flush=True)
    rec["max_abs_err"] = max(errs)
    return rec


# K6's timed geometries, (batch, frames, pixels, heads) at head dim 64:
# stage 2's level 0, then stage 1's
K6_TIMED = ((1, 38, 14400, 5), (2, 25, 9216, 5))
# the f32 instance at the same geometries -> key prefix of K6's record
K6_F32_PREFIX = dict(zip(K6_TIMED, ("f32_", "f32_stage1_")))
# the FMA body in bf16 (a head dim other than 64), timed at stage 2's level-0
# width as 10 heads of 32 (B, Tq, Tkv, S, H, d): K6's ``bf16_d32_*`` keys
K6_BF16_FMA_TIMED = (1, 38, 38, 14400, 10, 32)


def _k6_views(q, k, v, b: int, s: int, heads: int, d: int) -> tuple:
    """K6's operands as SDPA's (batch, heads, L, D) strided views, no copy:
    (S, H, T, D) for one batch row, else (B, S*H, T, D), each (pixel, head)
    pair a head of SDPA; with the view's name and the map of SDPA's output
    back to (B*T, S, H*D)."""
    if b == 1:
        views = tuple(z.view(-1, s, heads, d).permute(1, 2, 0, 3) for z in (q, k, v))
        return views, "(S, H, T, D)", lambda o: o.permute(2, 0, 1, 3).reshape(-1, s, heads * d)
    views = tuple(z.view(b, -1, s * heads, d).transpose(1, 2) for z in (q, k, v))
    return views, "(B, S*H, T, D)", lambda o: o.transpose(1, 2).reshape(-1, s, heads * d)


def check_k6(randn) -> dict:
    """K6 at the stage-2 and stage-1 geometries and at its edges (T = 1 and
    64, ragged pairs, Tq != Tkv, head dims other than 64 in bf16 and f32),
    timed at stage 2's and stage 1's level 0 against SDPA and the transposes
    + grouped-attention plain version, in bf16 and in f32."""
    import torch
    import torch.nn.functional as F

    from streamingt2v_torch.ops.temporal_attention import (
        fused_temporal_attention, temporal_attention_reference)

    bf16, f32 = torch.bfloat16, torch.float32
    rec, errs, f32_rec = {}, [], {}
    for b, tq, tkv, s, heads, d, dtype, label in [
            (1, 38, 38, 14400, 5, 64, bf16, "i2vgen level0"),
            (1, 38, 38, 3600, 10, 64, bf16, "i2vgen level1"),
            (1, 38, 38, 920, 20, 64, bf16, "i2vgen level2"),
            (1, 38, 38, 240, 20, 64, bf16, "i2vgen level3"),
            (1, 38, 38, 14400, 8, 64, bf16, "i2vgen transformer_in"),
            (2, 25, 25, 9216, 5, 64, bf16, "stage-1 level0 T=25"),
            (2, 25, 7, 9216, 5, 64, bf16, "CAM-like 25x7"),
            (1, 1, 1, 4000, 5, 64, bf16, "T=1"),
            (1, 64, 64, 3600, 5, 64, bf16, "T=64"),
            (3, 20, 9, 1001, 3, 64, bf16, "ragged pairs 20x9"),
            (1, 38, 38, 3600, 10, 32, bf16, "bf16 d=32"),
            (1, 38, 38, 14400, 10, 32, bf16, "bf16 d=32 at level 0's width"),
            (2, 25, 7, 1000, 4, 128, bf16, "bf16 d=128 25x7"),
            (1, 64, 64, 333, 2, 96, bf16, "bf16 d=96 T=64"),
            (1, 12, 12, 300, 2, 20, bf16, "bf16 d=20, 4-byte copies"),
            (1, 9, 13, 300, 2, 17, bf16, "bf16 d=17, plain copies"),
            (2, 16, 16, 1000, 2, 128, f32, "f32 d=128"),
            (1, 64, 64, 333, 3, 32, f32, "f32 T=64 ragged"),
            (1, 1, 1, 4000, 5, 64, f32, "f32 T=1"),
            (1, 64, 41, 500, 2, 96, f32, "f32 d=96 64x41"),
            (1, 9, 13, 300, 3, 30, f32, "f32 d=30, 4-byte copies"),
            (1, 38, 38, 14400, 5, 64, f32, "f32 i2vgen level0"),
            (2, 25, 25, 9216, 5, 64, f32, "f32 stage-1 level0 T=25")]:
        q = randn(b * tq, s, heads * d, dtype=dtype)
        k, v = (randn(b * tkv, s, heads * d, dtype=dtype) for _ in range(2))
        kw = dict(batch=b, frames_q=tq, frames_kv=tkv, num_heads=heads)
        out = fused_temporal_attention(q, k, v, **kw)
        ref = temporal_attention_reference(q, k, v, **kw)
        errs.append(_compare(f"K6 {label} T {tq}x{tkv} S {s} {heads}x{d} {dtype}", out, ref,
                             _tol(dtype)))
        timed = tq == tkv and d == 64 and (b, tq, s, heads) in K6_TIMED
        if dtype == f32 and timed:
            # against the first SDPA backend that takes f32 on the strided
            # view, its bound at the FP32 rate
            prefix = K6_F32_PREFIX[(b, tq, s, heads)]
            views, view, unview = _k6_views(q, k, v, b, s, heads, d)
            library, backend = _sdpa_backend(*views)
            _compare(f"K6 yardstick SDPA ({backend}) f32 on the {view} strided view",
                     unview(library()), ref, _tol(dtype))
            r = _f32_record(lambda: fused_temporal_attention(q, k, v, **kw), library,
                            work_temporal_attention(b, tq, tkv, s, heads, d, elem=4), prefix,
                            plain=lambda: temporal_attention_reference(q, k, v, **kw))
            r.update({f"{prefix}shape": [b * tq, s, heads * d], f"{prefix}sdpa_backend": backend})
            f32_rec.update(r)
            _f32_line(f"K6 time {(b * tq, s, heads * d)} T={tq} f32", r, prefix,
                      f"SDPA ({backend})")
        if dtype == bf16 and (b, tq, tkv, s, heads, d) == K6_BF16_FMA_TIMED:
            # the FMA body in bf16 (head dims other than 64) against SDPA on
            # the strided view, its bound at HBM's rate
            views, view, unview = _k6_views(q, k, v, b, s, heads, d)
            library, backend = _sdpa_backend(*views)
            _compare(f"K6 yardstick SDPA ({backend}) bf16 d={d} on the {view} strided view",
                     unview(library()), ref, _tol(dtype))
            r = _yardstick(
                dict(ms=_time_ms(lambda: fused_temporal_attention(q, k, v, **kw)),
                     plain_ms=_time_ms(lambda: temporal_attention_reference(q, k, v, **kw),
                                       reps=3),
                     library_ms=_time_ms(library), shape=[b * tq, s, heads * d],
                     sdpa_backend=backend),
                work_temporal_attention(b, tq, tkv, s, heads, d))
            print(f"  K6 time {(b * tq, s, heads * d)} T={tq} bf16 d={d}: kernel {r['ms']:.3f} "
                  f"ms, SDPA ({backend}) {r['library_ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, "
                  f"bound {r['bound_ms']:.3f} ms ({r['bound_by']}), share {r['share']:.3f}",
                  flush=True)
            f32_rec.update({f"bf16_d{d}_{key}": value for key, value in r.items()})
        if dtype == bf16 and timed:
            (qh, kh, vh), view, unview = _k6_views(q, k, v, b, s, heads, d)

            def library():
                return F.scaled_dot_product_attention(qh, kh, vh)

            _compare(f"K6 yardstick SDPA on the {view} strided view, {label}",
                     unview(library()), ref, _tol(dtype))
            r = _yardstick(
                dict(ms=_time_ms(lambda: fused_temporal_attention(q, k, v, **kw)),
                     plain_ms=_time_ms(lambda: temporal_attention_reference(q, k, v, **kw),
                                       reps=3),
                     library_ms=_time_ms(library), shape=[b * tq, s, heads * d]),
                work_temporal_attention(b, tq, tkv, s, heads, d))
            print(f"  K6 time {(b * tq, s, heads * d)} T={tq} bf16: kernel {r['ms']:.3f} ms, "
                  f"SDPA {r['library_ms']:.3f} ms, transposes + grouped attention "
                  f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms "
                  f"({r['bound_by']}), share {r['share']:.3f}", flush=True)
            if not rec:
                rec = r
            else:
                rec["stage1"] = r
        del q, k, v, out, ref
    rec.update(f32_rec, max_abs_err=max(errs))
    return rec


def check_kernels() -> dict:
    """Phase 3: returns {kernel: record} with max error and both times."""
    import torch

    randn, gen = _randn_factory(0)
    rec = {**check_k1(randn), **check_k2(randn),
           "geglu_ff": check_k3(randn),
           "temporal_conv": check_k4(randn, gen),
           "fused_group_norm": check_k5(randn),
           "fused_temporal_attention": check_k6(randn),
           "fused_group_norm_affine": check_k5_affine(randn)}
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


def _smooth_video(frames: int, height: int, width: int, seed: int = 0, device="cpu"):
    """A fixed [-1, 1] test video: drifting low-frequency colour fields."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    yy = torch.linspace(0, 1, height, device=device)[:, None]
    xx = torch.linspace(0, 1, width, device=device)[None, :]
    tt = torch.arange(frames, device=device, dtype=torch.float32)[:, None, None]
    chans = []
    for _ in range(3):
        fy, fx, ph, speed = (float(v) for v in rng.uniform([0.5, 0.5, 0, 0.02],
                                                           [3.0, 3.0, 6.28, 0.1]))
        chans.append(0.8 * torch.sin(2 * math.pi * (fy * yy + fx * xx) + ph + speed * tt))
    return torch.stack(chans, dim=-1)


def _reset_launches() -> None:
    from streamingt2v_torch.utils.profiling import reset_launches

    reset_launches()


def _read_launches(f32: bool = False) -> dict:
    """``utils/profiling.read_launches``: launches per wrapper, the flash
    wrappers' bf16 D=512 launches apart (``<name>_d512``) and, with ``f32``,
    the f32 launches of K1, K2, K4, K6 and K5's affine entry (``<name>_f32``)."""
    from streamingt2v_torch.utils.profiling import read_launches

    return read_launches(f32)


def _small_enhance_configs():
    """A narrow stage 2 in which K2-K6 all launch: head dim 64, 2048 latent
    tokens at level 0 (64x128 frames, a 2x VAE), channels multiples of 32."""
    import dataclasses

    import torch

    from streamingt2v_torch.config import DTypePolicy, EnhanceConfig, VAEConfig
    from streamingt2v_torch.models.clip import CLIPVisionConfig
    from streamingt2v_torch.models.clip_text import CLIPTextConfig
    from streamingt2v_torch.models.enhance.unet import I2VGenXLUNetConfig

    f32 = DTypePolicy(compute_dtype=torch.float32)
    cfg = EnhanceConfig(num_steps=3, height=64, width=128, chunk_size=4, overlap_size=2,
                        vae_bf16=False)
    models = dict(
        unet=I2VGenXLUNetConfig(block_out_channels=(64, 128), layers_per_block=1,
                                cross_attention_dim=64, image_embed_dim=32, dtypes=f32),
        vae=dataclasses.replace(VAEConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1, dtypes=f32),
                                temporal_decoder=False),
        clip_vision=CLIPVisionConfig(image_size=28, patch_size=14, width=64, layers=2, heads=2,
                                     output_dim=32),
        text=CLIPTextConfig(vocab_size=514, width=64, layers=2, heads=2, max_length=16),
        tokenizer_length=16)
    return cfg, models


def check_enhance_reference() -> float:
    """Phase 4, stage 2: the kernel path on the card agrees with the plain path."""
    import torch

    from streamingt2v_torch.pipeline.build import build_enhance
    from streamingt2v_torch.utils.rng import GeneratorEnhanceNoise

    cfg, models = _small_enhance_configs()
    gpu = build_enhance(cfg, seed=0, device="cuda", bf16=False, **models)
    cpu = build_enhance(cfg, seed=0, device="cpu", bf16=False, init=False, **models)
    for name in ("unet", "vae", "clip_vision", "text_encoder"):
        getattr(cpu.m, name).load_state_dict(getattr(gpu.m, name).state_dict())
    video = _smooth_video(6, cfg.height, cfg.width, seed=2)
    image = _smooth_image(cfg.height, cfg.width, seed=3)
    _reset_launches()
    got = gpu.enhance_with_keyframe_prepass(video.cuda(), image.cuda(),
                                            noise=GeneratorEnhanceNoise(7, "cpu")).cpu()
    launches = _read_launches()
    ref = cpu.enhance_with_keyframe_prepass(video, image, noise=GeneratorEnhanceNoise(7, "cpu"))
    err = (got - ref).abs().max().item()
    print(f"  small stage 2 {tuple(ref.shape)} f32, card vs CPU: max_abs_err={err:.3e} "
          f"tol={REFERENCE_ATOL:g}; launches {launches}; ref std {ref.std().item():.3f}",
          flush=True)
    if not torch.isfinite(got).all() or err > REFERENCE_ATOL:
        raise AssertionError(f"small-input stage 2 disagrees with the plain path ({err:.3e})")
    # stage 2 runs K2, not K1, and the narrow VAE's attention has head dim 64
    dead = [k for k, v in launches.items() if v <= 0 and k not in (
        "flash_attention", "flash_attention_d512", "flash_attention_packed_d512")]
    if dead:
        raise AssertionError(f"the small-input stage 2 skipped kernels: {dead}")
    return err


def _live_weights_(module, seed: int = 0) -> None:
    """Draw what a random build leaves constant, as the CPU parity tests'
    weights do: zero-initialised kernels (the UNets' output layers, the
    transformers' ``proj_out``) lecun-normal, every other constant parameter
    (biases, norm scales, blend factors) plus N(0, 0.1^2).  At their init
    values the output layers are zero, so a UNet adds nothing to the video
    and a comparison through it proves nothing about its kernels."""
    import torch

    from streamingt2v_torch.models.layers import Conv, Conv1D, ConvTranspose, Dense, TimeConv

    dev = next(module.parameters()).device
    gen = torch.Generator(dev).manual_seed(seed)

    def randn(p):
        return torch.randn(p.shape, generator=gen, device=dev, dtype=torch.float32).to(p.dtype)

    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (Dense, Conv, Conv1D, ConvTranspose, TimeConv)) and not m.kernel.any():
                m.kernel.copy_(randn(m.kernel) * m.fan_in() ** -0.5)
        for p in module.parameters():
            if p.numel() and bool(p.min() == p.max()):
                p.add_(0.1 * randn(p))


def _tiny_pair(cfg):
    """Stage 1 at ``cfg`` on the card with its seed-0 weights, every
    constant of them drawn (``_live_weights_``), and the same weights on the
    CPU."""
    from streamingt2v_torch.pipeline.build import build_pipeline

    gpu = build_pipeline(cfg, seed=0, device="cuda")
    cpu = build_pipeline(cfg, seed=0, device="cpu", init=False)
    for i, name in enumerate(("unet", "controlnet", "svd_unet", "vae", "conditioner")):
        _live_weights_(getattr(gpu.models, name), seed=i)
        getattr(cpu.models, name).load_state_dict(getattr(gpu.models, name).state_dict())
    return gpu, cpu


def _tiny_stage1_config(height: int = 96, width: int = 192, **inference):
    """The tiny stage 1 at 96x192 (its kernels' gates admit the level-0
    geometry; 64x128 is the least size at which K1 still takes its 2048
    tokens) with the f32 decode."""
    import dataclasses

    from streamingt2v_torch.config import PipelineConfig

    tiny = PipelineConfig.tiny()
    return dataclasses.replace(tiny, height=height, width=width, inference=dataclasses.replace(
        tiny.inference, vae_decode_bf16=False, **inference))


class _CachedDraws:
    """Stage-1 noise drawn once on the CPU from fixed seeds and served to
    both devices: a ``noise(generation, stream, shape)``."""

    def __init__(self):
        self.draws = {}

    def __call__(self, g, stream, shape):
        import torch

        if (g, stream) not in self.draws:
            gen = torch.Generator().manual_seed(1000 * g + len(stream))
            fn = torch.rand if stream == "cond_aug" else torch.randn
            self.draws[g, stream] = fn(shape, generator=gen)
        return self.draws[g, stream]


def _draw_apm_alphas_(unet, seed: int = 0) -> int:
    """Set every APM mixer's ``apm_alpha`` to 1.3 plus a small draw: at its
    init value of 0 a mixer is the identity on the first token.  Returns the
    number of mixers."""
    import torch

    from streamingt2v_torch.models.unet_blocks import APMContextMixer

    gen = torch.Generator().manual_seed(seed)
    mixers = [m for m in unet.modules() if isinstance(m, APMContextMixer)]
    with torch.no_grad():
        for m in mixers:
            m.apm_alpha.fill_(1.3 + 0.2 * float(torch.randn((), generator=gen)))
    return len(mixers)


def _reference_run(what: str, got, ref, launches: dict) -> float:
    import torch

    err = (got - ref).abs().max().item()
    print(f"  {what} {tuple(ref.shape)} f32, card vs CPU: max_abs_err={err:.3e} "
          f"tol={REFERENCE_ATOL:g}; launches {launches}; ref std {ref.std().item():.3f}",
          flush=True)
    if not torch.isfinite(got).all() or err > REFERENCE_ATOL:
        raise AssertionError(f"{what} disagrees with the plain path ({err:.3e})")
    if min(launches.values()) <= 0:
        raise AssertionError(f"{what} skipped a kernel: {launches}")
    return err


def _stage1_launches() -> dict:
    return {k: v for k, v in _read_launches().items()
            if k in ("flash_attention", "geglu_ff", "temporal_conv")}


def check_reference() -> float:
    """Phase 4: the kernel path on the card agrees with the plain path."""
    cfg = _tiny_stage1_config()
    frames = cfg.inference.chunk_frames + 1   # the first chunk plus one AR chunk
    gpu, cpu = _tiny_pair(cfg)
    noise = _CachedDraws()
    image = _smooth_image(cfg.height, cfg.width, seed=1)
    _reset_launches()
    got = gpu.image_to_video(image.cuda(), num_frames=frames, noise=noise).cpu()
    launches = _stage1_launches()
    ref = cpu.image_to_video(image, num_frames=frames, noise=noise)
    return _reference_run("small stage 1", got, ref, launches)


def check_apm_reference() -> float:
    """Phase 4, APM: the tiny stage 1 with a 3+1-token APM context and drawn
    ``apm_alpha``s, card against CPU."""
    import dataclasses

    cfg = _tiny_stage1_config(apm_anchor_frames=(0, 3))
    cfg = dataclasses.replace(cfg, unet=dataclasses.replace(cfg.unet, use_apm=True))
    frames = cfg.inference.chunk_frames + 1
    gpu, cpu = _tiny_pair(cfg)
    n = _draw_apm_alphas_(gpu.models.unet)
    cpu.models.unet.load_state_dict(gpu.models.unet.state_dict())
    noise = _CachedDraws()
    image = _smooth_image(cfg.height, cfg.width, seed=4)
    _reset_launches()
    got = gpu.image_to_video(image.cuda(), num_frames=frames, noise=noise).cpu()
    launches = _stage1_launches()
    ref = cpu.image_to_video(image, num_frames=frames, noise=noise)
    return _reference_run(f"small stage 1 with APM ({n} mixers, 4 tokens)", got, ref, launches)


# The sampler and guider variants of the samplers phase and of its small
# reference: (label, SamplerConfig fields, guider kind or None for the config's).
SAMPLER_CASES = (
    ("heun_edm", dict(kind="heun_edm"), None),
    ("euler_ancestral", dict(kind="euler_ancestral"), None),
    ("dpmpp2s", dict(kind="dpmpp2s"), None),
    ("dpmpp2m", dict(kind="dpmpp2m"), None),
    ("lms", dict(kind="lms"), None),
    ("euler_edm churn", dict(kind="euler_edm", s_churn=1.0), None),
    ("euler_edm identity", dict(kind="euler_edm"), "identity"),
    ("euler_edm triangle", dict(kind="euler_edm"), "triangle_prediction"),
)


def sampler_config(base, steps: int, fields: dict, guider):
    """``base`` (a SamplerConfig) at ``steps`` with a case's fields."""
    import dataclasses

    cfg = dataclasses.replace(base, num_steps=steps, **fields)
    if guider is not None:
        cfg = dataclasses.replace(cfg, guider=dataclasses.replace(cfg.guider, kind=guider))
    return cfg


def _step_draws():
    """A stochastic sampler's per-step draws, made once on the CPU (seeded by
    step) and served to both devices."""
    import torch

    cache = {}

    def draw(i, shp):
        if i not in cache:
            cache[i] = torch.randn(tuple(shp), generator=torch.Generator().manual_seed(500 + i))
        return cache[i]

    return draw


def check_sampler_references() -> float:
    """Phase 4, samplers: the tiny first chunk at 64x128 under every other
    sampler and guider (3 steps on the EDM grid from sigma 80, the CPU
    parity tests' grid), card against CPU on the same weights, conditioning
    and per-step draws; each chunk decoded and compared as video.  (From the
    first-chunk sampler's sigma 700, Heun's correction amplifies the f32
    rounding of the kernels five times more: 3.96e-4 of the 5e-4 once.)"""
    import dataclasses

    import torch

    cfg = _tiny_stage1_config(height=64, width=128)
    gpu, cpu = _tiny_pair(cfg)
    noise = _CachedDraws()
    image = _smooth_image(cfg.height, cfg.width, seed=5)[None]
    shape = gpu.latent_shape(cfg.inference.chunk_frames)
    with torch.inference_mode():
        cond_cpu = cpu.condition(image, noise(0, "cond_aug", tuple(image.shape)))
        cond_gpu = gpu.condition(image.cuda(), noise(0, "cond_aug", tuple(image.shape)).cuda())
    worst = 0.0
    for label, fields, guider in SAMPLER_CASES:
        scfg = sampler_config(dataclasses.replace(cfg.first_chunk_sampler, sigma_max=80.0), 3,
                              fields, guider)
        for pipe in (gpu, cpu):
            pipe.cfg = dataclasses.replace(cfg, first_chunk_sampler=scfg)
        draws = _step_draws()
        with torch.inference_mode():
            ref = cpu.decode_video(cpu.first_chunk(*cond_cpu, noise(0, "latent", shape), draws))
            _reset_launches()
            z = gpu.first_chunk(*cond_gpu, noise(0, "latent", shape).cuda(), draws)
            launches = _stage1_launches()
            got = gpu.decode_video(z).cpu()
        worst = max(worst, _reference_run(f"small first chunk, {label}", got, ref, launches))
    return worst


def _release_earlier_phases() -> None:
    """Free what earlier phases left on the card before a pipeline phase
    builds its models: a phase's pipeline sits in a reference cycle (its
    timing wrappers hold its bound methods), which only the cycle collector
    frees, and its weights would count in the next phase's memory."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def run_slice(first_steps: int, ar_steps: int) -> dict:
    """Phase 5: the full-width stage-1 slice through every kernel."""
    import dataclasses

    import torch

    from streamingt2v_torch.config import PipelineConfig
    from streamingt2v_torch.pipeline.build import build_pipeline

    dev = torch.device("cuda")
    _release_earlier_phases()
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

    # per-phase seconds: the pipeline's stage methods with synchronised timers;
    # decode_video also keeps the latents it takes and the frames it gives
    phase_s = {"condition": 0.0, "first_chunk": 0.0, "stream_chunk": 0.0, "decode_video": 0.0}
    decode, decodes = pipe.decode_video, []

    def recording_decode(z):
        frames = decode(z)
        decodes.append((z.clone(), frames))
        return frames

    pipe.decode_video = recording_decode
    _timed_methods(pipe, phase_s, phase_s)

    image = _smooth_image(cfg.height, cfg.width).to(dev)
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    video = pipe.image_to_video(image, num_frames=SLICE_FRAMES, seed=cfg.seed)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = _read_launches(f32=True)
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
    print(f"  video {want} finite in [{lo:.3f}, {hi:.3f}], std {video.std().item():.4f}",
          flush=True)
    for name, n in _slice_f32_decode(pipe, decode, decodes).items():
        launches[name] += n
    dead = [k for k in ("flash_attention", "flash_attention_d512", "flash_attention_f32",
                        "geglu_ff", "temporal_conv", "temporal_conv_f32") if launches[k] <= 0]
    if dead:
        raise AssertionError(f"the slice never launched: {dead}")
    return launches


# The f32 decode held against itself with K1, K4 and K5 on their plain versions:
# max |difference| on the [-1, 1] frames (0.13 of a uint8 level).  Both runs
# are full f32 (TF32 off) and differ only in summation order: the kernels sum
# each output over up to 3 x 512 products and 9216 keys in another order than
# torch.matmul, about 1e-7 relative an output, which the decoder's GroupNorms
# rescale but do not grow by more than a few hundred times over its ~40
# layers (the small f32 references, whole pipelines, hold 5e-4 card against
# CPU: REFERENCE_ATOL).
DECODE_F32_ATOL = 1e-3


def _plain_kernels():
    """A context in which the models' K1, K2, K4 and K5 calls (K5's affine
    entry too) take their plain versions: the wrappers' names in the modules
    that call them, patched for the measurement only (as
    ``_unpinned_conv_transpose`` is)."""
    import contextlib
    import importlib

    from streamingt2v_torch.ops import flash_attention as fa, fused_group_norm as gn, norms
    from streamingt2v_torch.ops import temporal_conv as tc

    attention = importlib.import_module("streamingt2v_torch.ops.attention")
    blocks = importlib.import_module("streamingt2v_torch.models.unet_blocks")
    patches = [(attention, "flash_attention", fa.flash_attention_reference),
               (attention, "flash_attention_packed",
                lambda q, k, v, *, num_heads: fa.flash_attention_packed_reference(
                    q, k, v, num_heads)),
               (blocks, "temporal_conv", tc.temporal_conv_reference),
               (norms, "fused_group_norm", gn.fused_group_norm_reference),
               (norms, "fused_group_norm_affine", gn.group_norm_affine_reference)]

    @contextlib.contextmanager
    def patched():
        saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
        try:
            for mod, name, fn in patches:
                setattr(mod, name, fn)
            yield
        finally:
            for mod, name, fn in saved:
                setattr(mod, name, fn)

    return patched()


def _slice_f32_decode(pipe, decode, decodes: list) -> dict:
    """The slice's latents decoded again under the reference's precision
    (``vae_decode_bf16=False``: f32 weights and activations, K4 and K1 in
    f32): the seconds (``decode_video_f32``), the launches (returned, f32 apart),
    the largest difference from the slice's bf16 decode, and the first 8-frame
    chunk decoded once more with K1, K4 and K5 on their plain versions, held
    within ``DECODE_F32_ATOL``.  ``decode`` is the pipeline's own
    ``decode_video``; ``decodes`` the (latents, bf16 frames) of its calls."""
    import dataclasses

    import torch

    from streamingt2v_torch.ops.routing import use_routing

    cfg = pipe.cfg
    pipe.cfg = dataclasses.replace(
        cfg, inference=dataclasses.replace(cfg.inference, vae_decode_bf16=False))
    try:
        with torch.inference_mode(), use_routing(cfg.routing):
            _reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            f32 = [decode(z) for z, _ in decodes]
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = _read_launches(f32=True)
            frames = sum(z.shape[1] for z, _ in decodes)
            diff = max((a - b).abs().max().item() for a, (_, b) in zip(f32, decodes))
            finite = all(bool(torch.isfinite(a).all()) for a in f32)
            print(f"  decode_video_f32: {seconds:.1f} s for the slice's {frames} latent frames "
                  f"({len(decodes)} calls); f32 launches: K4 {launches['temporal_conv_f32']}, "
                  f"K1 {launches['flash_attention_f32']}; largest |bf16 - f32| decode "
                  f"difference {diff:.4f} ({diff * 127.5:.2f} uint8 levels), finite {finite}",
                  flush=True)
            if not finite or launches["temporal_conv_f32"] <= 0 \
                    or launches["flash_attention_f32"] <= 0:
                raise AssertionError("the f32 decode is not finite or missed K4/K1 in f32")
            cs = cfg.inference.decode_chunk_size
            z = decodes[0][0][:, :cs]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with _plain_kernels():
                plain = pipe.decode_chunk(z)
            torch.cuda.synchronize()
            err = (f32[0][:, :cs] - plain).abs().max().item()
            print(f"  one {cs}-frame chunk in f32, kernels against K1, K4 and K5 plain "
                  f"({time.perf_counter() - t0:.1f} s): max_abs_err={err:.3e} "
                  f"tol={DECODE_F32_ATOL:g}", flush=True)
            if not err <= DECODE_F32_ATOL:
                raise AssertionError(f"the f32 decode's kernels disagree with their plain "
                                     f"versions ({err:.3e})")
    finally:
        pipe.cfg = cfg
    return launches


def _timed_methods(obj, names, seconds: dict) -> None:
    """Wrap ``obj``'s methods ``names`` with synchronised timers adding to
    ``seconds[name]``."""
    import torch

    def timed(name, fn):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            start = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            seconds[name] += time.perf_counter() - start
            return out
        return wrapper

    for name in names:
        setattr(obj, name, timed(name, getattr(obj, name)))


# The kernels each bench mode must launch (the wrappers' counters).
BENCH_KERNELS = {"denoise": ("flash_attention", "geglu_ff", "temporal_conv"),
                 "vae": ("flash_attention_f32", "temporal_conv_f32")}


def run_bench() -> dict:
    """Phase: the port's bench (``streamingt2v_torch/bench.py``), configs #2
    (denoise) and #1 (vae) at production width through its functions, not
    recorded; each record checked (a finite value above 0, the peak memory,
    launches of the mode's kernels in its timed calls).  Their metric lines
    go to stderr, so that this script's stdout keeps its own lines."""
    import contextlib

    from streamingt2v_torch import bench

    launches = {}
    for mode, fn in (("denoise", bench.bench_denoise), ("vae", bench.bench_vae)):
        _release_earlier_phases()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            rec = fn(records=None)
        value, peak, counts = rec["value"], rec.get("peak_hbm_gb", 0.0), rec["launches"]
        print(f"  {mode}: {rec['metric']} {value} {rec['unit']} (median {rec['median_s']} s, "
              f"spread {rec['spread']:.2%}, calls {rec['seconds']}), peak {peak} GiB, "
              f"{time.perf_counter() - t0:.1f} s with the build; launches {counts}", flush=True)
        if not (math.isfinite(value) and value > 0) or not peak > 0:
            raise AssertionError(f"bench {mode}: value {value}, peak_hbm_gb {peak}")
        dead = [k for k in BENCH_KERNELS[mode] if counts.get(k, 0) <= 0]
        if dead:
            raise AssertionError(f"bench {mode} never launched: {dead}")
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n
    return launches


def run_apm(steps: int) -> dict:
    """Phase 6: the full-width stage 1 with APM: a 17-token context (the SVD
    token and 16 anchor frames' CLIP tokens) mixed by every spatial block,
    seen whole by every temporal block, ``apm_alpha`` drawn non-zero and the
    streaming UNet's output layers live (``_live_weights_``)."""
    import dataclasses

    import torch

    from streamingt2v_torch.config import PipelineConfig
    from streamingt2v_torch.pipeline.build import build_pipeline

    dev = torch.device("cuda")
    _release_earlier_phases()
    cfg = PipelineConfig()
    cfg = dataclasses.replace(
        cfg, unet=dataclasses.replace(cfg.unet, use_apm=True),
        inference=dataclasses.replace(cfg.inference, apm_anchor_frames=(0, 16)),
        first_chunk_sampler=dataclasses.replace(cfg.first_chunk_sampler, num_steps=steps),
        sampler=dataclasses.replace(cfg.sampler, num_steps=steps))
    print(f"  cut: sampler steps {PipelineConfig().first_chunk_sampler.num_steps} + "
          f"{PipelineConfig().sampler.num_steps} -> {steps} + {steps}", flush=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pipe = build_pipeline(cfg, seed=0, device=dev, bf16=True)
    # live output layers, so that what the mixers change reaches the video
    for i, module in enumerate((pipe.models.unet, pipe.models.controlnet)):
        _live_weights_(module, seed=i)
    mixers = _draw_apm_alphas_(pipe.models.unet)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    print(f"  build_pipeline: {time.perf_counter() - t0:.1f} s, resident weights "
          f"{resident / 2**30:.2f} GiB; {mixers} APM mixers, apm_alpha drawn, the "
          f"streaming UNet's and ControlNet's constants drawn", flush=True)

    # the mixers must change the context: record the largest |mixed - first token|
    moved = []

    def hook(module, args, out):
        moved.append((out - args[0][:, :1]).abs().max().item())

    from streamingt2v_torch.models.unet_blocks import APMContextMixer
    handle = next(m for m in pipe.models.unet.modules()
                  if isinstance(m, APMContextMixer)).register_forward_hook(hook)
    phase_s = dict.fromkeys(("condition", "encode_apm", "first_chunk", "stream_chunk",
                             "decode_video"), 0.0)
    _timed_methods(pipe, phase_s, phase_s)
    tokens = []
    encode = pipe.encode_apm
    pipe.encode_apm = lambda frames: tokens.append(tuple(frames.shape)) or encode(frames)

    image = _smooth_image(cfg.height, cfg.width, seed=7).to(dev)
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    video = pipe.image_to_video(image, num_frames=SLICE_FRAMES, seed=cfg.seed)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = _read_launches(f32=True)
    handle.remove()
    peak = torch.cuda.max_memory_allocated()
    finite = {"stage1": bool(torch.isfinite(video).all())}
    print("  seconds: " + ", ".join(f"{k} {v:.2f}" for k, v in phase_s.items())
          + f", image_to_video total {total:.1f}", flush=True)
    print(f"  resident {resident / 2**30:.2f} GiB, peak {peak / 2**30:.2f} GiB; stage_finite "
          f"{finite}; video std {video.std().item():.4f}, AR frames' std "
          f"{video[cfg.inference.chunk_frames:].std().item():.4f}; APM encodes {tokens}; "
          f"a mixer moved its token by up to "
          f"{max(moved or [0.0]):.3f} over {len(moved)} calls; launches {launches}", flush=True)
    want = (SLICE_FRAMES, cfg.height, cfg.width, 3)
    if tuple(video.shape) != want or not finite["stage1"]:
        raise AssertionError(f"video {tuple(video.shape)} (want {want}), finite {finite}")
    if tokens != [(1, 16, cfg.height, cfg.width, 3)]:
        raise AssertionError(f"the APM anchor frames were not encoded once: {tokens}")
    if not moved or max(moved) <= 0.0:
        raise AssertionError("the APM mixers left the context as it was")
    dead = [k for k in ("flash_attention", "flash_attention_d512", "geglu_ff", "temporal_conv")
            if launches[k] <= 0]
    if dead:
        raise AssertionError(f"the APM phase never launched: {dead}")
    return launches


def run_samplers(steps: int) -> dict:
    """Phase 7: each other sampler and guider on one full-width first chunk
    (the SVD-XT UNet, 25 frames): seconds per guided denoise, finite latents,
    the network calls against the sampler's rule, and K1/K3/K4 launches in
    proportion to those calls."""
    import dataclasses

    import torch

    from streamingt2v_torch.config import PipelineConfig
    from streamingt2v_torch.pipeline.build import build_pipeline
    from streamingt2v_torch.utils.rng import GeneratorNoise, step_stream

    dev = torch.device("cuda")
    _release_earlier_phases()
    cfg = PipelineConfig()
    t0 = time.perf_counter()
    pipe = build_pipeline(cfg, seed=0, device=dev, bf16=True)
    torch.cuda.synchronize()
    print(f"  build_pipeline: {time.perf_counter() - t0:.1f} s; {steps} steps per sampler",
          flush=True)
    calls = [0]
    unet = pipe.models.svd_unet
    forward = unet.forward

    def counted(*a, **k):
        calls[0] += 1
        return forward(*a, **k)

    unet.forward = counted
    noise = GeneratorNoise(cfg.seed, dev)
    image = _smooth_image(cfg.height, cfg.width, seed=8).to(dev)[None]
    shape = pipe.latent_shape(cfg.inference.chunk_frames)
    kernels = ("flash_attention", "geglu_ff", "temporal_conv")
    totals = dict.fromkeys(KERNEL_META, 0)
    per_call = {}
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        c, uc = pipe.condition(image, noise(0, "cond_aug", tuple(image.shape)))
        for label, fields, guider in SAMPLER_CASES:
            scfg = sampler_config(cfg.first_chunk_sampler, steps, fields, guider)
            pipe.cfg = dataclasses.replace(cfg, first_chunk_sampler=scfg)
            want = 2 * steps - 1 if scfg.kind in ("heun_edm", "dpmpp2s") else steps
            calls[0] = 0
            torch.cuda.synchronize()
            _reset_launches()
            t0 = time.perf_counter()
            z = pipe.first_chunk(c, uc, noise(0, "latent", shape), step_stream(noise, 0))
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launches = _read_launches()   # the first chunk runs no f32 kernel
            finite = bool(torch.isfinite(z).all())
            per = {k: launches[k] / max(calls[0], 1) for k in kernels}
            print(f"  {label}: {calls[0]} network calls (rule {want}), "
                  f"{dt / max(calls[0], 1):.3f} s per guided denoise ({dt:.2f} s), latents "
                  f"finite {finite}, |z| max {z.abs().max().item():.3f}; launches per call "
                  f"{per}", flush=True)
            if calls[0] != want or not finite:
                raise AssertionError(f"{label}: {calls[0]} calls (want {want}), finite {finite}")
            if any(launches[k] <= 0 or launches[k] % calls[0] for k in kernels):
                raise AssertionError(f"{label}: launches {launches} not a multiple of the calls")
            group = "identity" if guider == "identity" else "cfg"
            if per_call.setdefault(group, per) != per:
                raise AssertionError(f"{label}: launches per call {per} differ from "
                                     f"{per_call[group]} ({group} guidance)")
            for k, n in launches.items():
                totals[k] += n
    unet.forward = forward
    print(f"  peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {totals}",
          flush=True)
    return totals


# ------------------------------------------------------------- training ---

# The train phase: the full-width SVD-XT UNet (the first chunk's network)
# with remat, batch 1 of 25 frames of 72x128x4 latents, TRAIN_STEPS AdamW
# steps on one batch with one generator seed, so that the sigmas and noise
# repeat (the JAX package's descent check, tests/test_training.py).
TRAIN_FRAMES = 25
TRAIN_STEPS = 4
TRAIN_EMA_DECAY = 0.9999
TRAIN_KERNELS = ("flash_attention", "geglu_ff", "temporal_conv")
# The tiny card-against-CPU training reference (f32, remat on): the loss
# relative to |loss|; each gradient leaf relative to its own max |CPU
# gradient|, or to REF_GRAD_FLOOR times the network's largest where that is
# more (a bias that a one-channel GroupNorm removes has a gradient of f32
# noise); the parameters after each AdamW step, the CPU's AdamW fed the
# card's gradients, in learning rates beyond both sides' f32 rounding.
REF_LOSS_TOL = 1e-4
REF_GRAD_TOL = 1e-3
REF_GRAD_FLOOR = 1e-5
REF_ADAM_TOL = 1e-3
REF_LR = 1e-3


def _backward_of(fn, leaves, g):
    """(gradients of fn(*leaves) for the cotangent g, the output, the graph
    kept for more backward calls)."""
    import torch

    out = fn(*leaves)
    live = [x for x in leaves if x is not None and x.requires_grad]
    return torch.autograd.grad(out, live, g, retain_graph=True), out, live


def _check_backward(name: str, fn, plain, leaves, g, tol: float, counter, *, rows=None,
                    timed: bool = False) -> dict:
    """fn (a kernel's autograd.Function on the card) against autograd through
    its plain version on the same leaves: each gradient's max error relative
    to its max |plain gradient|.  ``rows``: compare the first rows only (the
    plain version's f32 scores at a full training shape would not fit), the
    leaves being independent along their first axis.  ``timed``: also the
    backward's device time and its chunks."""
    import torch

    before = counter.bwd_chunks
    grads, out, live = _backward_of(fn, leaves, g)
    chunks = counter.bwd_chunks - before
    if rows is not None:
        sub = [None if x is None else x[:rows].detach().requires_grad_(x.requires_grad)
               for x in leaves]
        ref, _, _ = _backward_of(plain, sub, g[:rows])
        grads = [gr[:rows] for gr in grads]
    else:
        sub = [None if x is None else x.detach().requires_grad_(x.requires_grad) for x in leaves]
        ref, _, _ = _backward_of(plain, sub, g)
    err = max(_compare(f"{name} grad {i} {tuple(r.shape)} {r.dtype}", gr, r, tol)
              for i, (gr, r) in enumerate(zip(grads, ref)))
    rec = dict(bwd_max_abs_err=err, bwd_chunks=chunks)
    if timed:
        rec["bwd_ms"] = _time_ms(lambda: torch.autograd.grad(out, live, g, retain_graph=True),
                                 reps=3)
        rec["bwd_shape"] = list(leaves[0].shape)
        print(f"  {name} backward time: {rec['bwd_ms']:.3f} ms in {chunks} chunks", flush=True)
    return rec


def check_backward() -> dict:
    """Phase 4, training: each kernel's autograd.Function (K1, K2, K3 with and
    without LN, K4 bare, pre, res and pre+res) against autograd through its
    plain version, at a training shape in bf16 (timed: ``bwd_ms``,
    ``bwd_chunks``) and in f32; K5 and K6 refuse inputs that require grad."""
    import torch

    from streamingt2v_torch.ops.flash_attention import (
        flash_attention, flash_attention_packed, flash_attention_packed_reference,
        flash_attention_reference)
    from streamingt2v_torch.ops.fused_ff import geglu_ff, geglu_ff_reference
    from streamingt2v_torch.ops.fused_group_norm import fused_group_norm, fused_group_norm_affine
    from streamingt2v_torch.ops.temporal_attention import fused_temporal_attention
    from streamingt2v_torch.ops.temporal_conv import temporal_conv, temporal_conv_reference

    randn, gen = _randn_factory(1)
    bf16, f32 = torch.bfloat16, torch.float32
    recs = {}

    def leaf(*shape, dtype=bf16, std=1.0, mean=0.0):
        return randn(*shape, dtype=dtype, std=std, mean=mean).requires_grad_()

    # K1: the SVD UNet's level-0 self-attention (25 frames, 5 heads), f32 smaller
    for shape, dtype in (((125, 9216, 64), bf16), ((8, 2048, 64), f32)):
        qkv = [leaf(*shape, dtype=dtype) for _ in range(3)]
        rec = _check_backward(f"K1 {shape}", flash_attention, flash_attention_reference, qkv,
                              randn(*shape, dtype=dtype), _tol(dtype), flash_attention,
                              rows=4 if dtype == bf16 else None, timed=dtype == bf16)
        recs.setdefault("flash_attention", rec)
        del qkv
    # K2: stage 2's level-1 geometry, 4 frames, 10 heads; f32 smaller
    for (b, length, heads), dtype in (((4, 3600, 10), bf16), ((2, 1024, 2), f32)):
        qkv = [leaf(b, length, heads * 64, dtype=dtype) for _ in range(3)]
        rec = _check_backward(
            f"K2 {(b, length, heads * 64)} {heads} heads",
            lambda q, k, v: flash_attention_packed(q, k, v, num_heads=heads),
            lambda q, k, v: flash_attention_packed_reference(q, k, v, heads), qkv,
            randn(b, length, heads * 64, dtype=dtype), _tol(dtype), flash_attention_packed,
            timed=dtype == bf16)
        recs.setdefault("flash_attention_packed", rec)
        del qkv
    # K3: level 0 with LN and residual (the transformer blocks), level 1
    # without (the kernel's other mode), f32 smaller
    for n, c, ln, dtype in ((230400, 320, True, bf16), (57600, 640, False, bf16),
                            (4096, 320, True, f32)):
        inner = 4 * c
        ops = [leaf(n, c, dtype=dtype), leaf(2 * inner, c, dtype=dtype, std=c ** -0.5),
               leaf(2 * inner, dtype=f32, std=0.1), leaf(c, inner, dtype=dtype, std=inner ** -0.5),
               leaf(c, dtype=f32, std=0.1),
               leaf(c, dtype=f32, std=0.1, mean=1.0) if ln else None,
               leaf(c, dtype=f32, std=0.1) if ln else None]
        rec = _check_backward(
            f"K3 {(n, c)} inner {inner} {'LN+residual' if ln else 'no LN/residual'}",
            lambda x, w1, b1, w2, b2, s, sb: geglu_ff(x, w1, b1, w2, b2, ln_scale=s, ln_bias=sb,
                                                      residual=ln),
            lambda *a: geglu_ff_reference(*a, ln), ops, randn(n, c, dtype=dtype), _tol(dtype),
            geglu_ff, timed=(n, ln, dtype) == (230400, True, bf16))
        recs.setdefault("geglu_ff", rec)
        del ops
    # K4: the UNet's level-0 temporal conv (1 clip of 25 frames) in its four
    # variants, the timed one pre+res as the VideoResBlock's out_conv; f32 smaller
    for (b, t, s, c), pre, res, dtype in (((1, 25, 9216, 320), True, True, bf16),
                                          ((1, 25, 9216, 320), False, False, bf16),
                                          ((1, 25, 9216, 320), True, False, bf16),
                                          ((1, 25, 9216, 320), False, True, bf16),
                                          ((2, 8, 576, 64), True, True, f32)):
        ops = [leaf(b, t, s, c, dtype=dtype), leaf(3, c, c, dtype=dtype, std=(3 * c) ** -0.5),
               leaf(c, dtype=f32, std=0.1),
               leaf(b, t, s, c, dtype=dtype) if res else None,
               torch.rand((b, t), generator=gen, device="cuda").requires_grad_() if res else None,
               leaf(b, c, dtype=f32, std=0.1, mean=1.0) if pre else None,
               leaf(b, c, dtype=f32, std=0.1) if pre else None]
        rec = _check_backward(
            f"K4 {(b, t, s, c)} {'pre' if pre else ''}{'+' if pre and res else ''}"
            f"{'res' if res else ''}{'' if pre or res else 'bare'}",
            temporal_conv, temporal_conv_reference, ops, randn(b, t, s, c, dtype=dtype),
            _tol(dtype), temporal_conv, timed=(pre, res, dtype) == (True, True, bf16))
        recs.setdefault("temporal_conv", rec)
        del ops
    # K5 and K6 have no backward: under grad they refuse, without it they run
    x = leaf(2, 4096, 64)
    scale, bias = torch.ones(64, device="cuda"), torch.zeros(64, device="cuda")
    qkv = [leaf(2 * 8, 64, 128) for _ in range(3)]
    for name, call in (("K5", lambda: fused_group_norm(x, scale, bias, num_groups=32)),
                       ("K5 affine", lambda: torch.cat(fused_group_norm_affine(
                           x, scale, bias, num_groups=32))),
                       ("K6", lambda: fused_temporal_attention(*qkv, batch=2, frames_q=8,
                                                               frames_kv=8, num_heads=2))):
        try:
            call()
        except RuntimeError as e:
            print(f"  {name} under grad refuses: {e}", flush=True)
        else:
            raise AssertionError(f"{name} returned an output under grad (it has no backward)")
        with torch.no_grad():
            if not torch.isfinite(call()).all():
                raise AssertionError(f"{name} without grad gave non-finite values")
    torch.cuda.empty_cache()
    return recs


def _train_batch(frames: int, height: int, width: int, context_dim: int, adm: int, device,
                 seed: int = 0) -> dict:
    """Latents and conditioning drawn with numpy from ``seed``, in the order
    tests/test_training.py draws them: latents, concat, crossattn, vector."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    shape = (1, frames, height, width, 4)

    def draw(*s):
        return torch.from_numpy(rng.randn(*s).astype(np.float32)).to(device)

    latents = draw(*shape)
    cond = {"concat": draw(*shape), "crossattn": draw(1, frames, 1, context_dim),
            "vector": draw(1, frames, adm)}
    return {"latents": latents, "cond": cond}


def _grad_errors(got: dict, ref: dict) -> float:
    """The largest gradient error over the leaves, each against its bound
    (REF_GRAD_TOL of its own max, or REF_GRAD_FLOOR of the largest); raises
    past it.  ``got`` on the card, ``ref`` on the CPU."""
    top = max(float(g.abs().max()) for g in ref.values() if g is not None)
    worst = 0.0
    for name, r in ref.items():
        bound = max(REF_GRAD_TOL * float(r.abs().max()), REF_GRAD_FLOOR * top)
        err = float((got[name].cpu() - r).abs().max())
        if not err <= bound:
            raise AssertionError(f"gradient of {name}: card vs CPU {err:.3e} > {bound:.3e}")
        worst = max(worst, err / max(bound, 1e-30))
    return worst


def check_train_reference() -> float:
    """Phase 4, training: the tiny first-chunk VideoUNet (remat on, f32,
    every constant drawn by ``_live_weights_``) at 32x64 latents, where K1,
    K3 and K4 launch, trained for 2 AdamW steps on the card and on the CPU
    with the same weights and draws: the loss and every parameter's gradient
    of each step, and the parameters after each step (the CPU's AdamW fed
    the card's gradients)."""
    import dataclasses

    import numpy as np
    import torch

    from streamingt2v_torch.config import VideoUNetConfig
    from streamingt2v_torch.diffusion.loss import DiffusionLossConfig
    from streamingt2v_torch.models.layers import init_random_
    from streamingt2v_torch.models.video_unet import VideoUNet
    from streamingt2v_torch.models.wrappers import openai_wrapper
    from streamingt2v_torch.ops.flash_attention import flash_attention
    from streamingt2v_torch.ops.fused_ff import geglu_ff
    from streamingt2v_torch.ops.temporal_conv import temporal_conv
    from streamingt2v_torch.parallel.train import make_train_step

    cfg = dataclasses.replace(VideoUNetConfig.tiny(controlnet_mode=False), use_checkpoint=True)
    gpu = VideoUNet(cfg, device="cuda")
    init_random_(gpu, torch.Generator("cuda").manual_seed(0))
    _live_weights_(gpu, seed=3)
    cpu = VideoUNet(cfg)
    cpu.load_state_dict(gpu.state_dict())
    loss_cfg = DiffusionLossConfig(offset_noise_level=0.05)
    steps = {}
    for side, m in (("card", gpu), ("host", cpu)):
        m.requires_grad_(True)
        steps[side] = make_train_step(lambda m=m: openai_wrapper(m), loss_cfg,
                                     torch.optim.AdamW(m.parameters(), lr=REF_LR,
                                                       weight_decay=1e-4))
    frames, height, width = 5, 32, 64
    batch = _train_batch(frames, height, width, cfg.context_dim, cfg.adm_in_channels, "cpu",
                         seed=5)
    to_gpu = {"latents": batch["latents"].cuda(),
              "cond": {k: v.cuda() for k, v in batch["cond"].items()}}
    rng = np.random.RandomState(6)
    worst = 0.0
    chunks = {fn.__name__: fn.bwd_chunks for fn in (flash_attention, geglu_ff, temporal_conv)}
    _reset_launches()
    for i in range(2):
        draws = dict(sigmas=torch.from_numpy(np.exp(-1.2 + 1.2 * rng.randn(1)).astype(np.float32)),
                     noise=torch.from_numpy(rng.randn(*batch["latents"].shape).astype(np.float32)),
                     offset=torch.from_numpy(rng.randn(1, 1, 1, 1, 4).astype(np.float32)))
        got = steps["card"].backward(to_gpu, **{k: v.cuda() for k, v in draws.items()})
        ref = steps["host"].backward(batch, **draws)
        rel = abs(got.item() - ref.item()) / abs(ref.item())
        if not (math.isfinite(got.item()) and rel <= REF_LOSS_TOL):
            raise AssertionError(f"tiny training step {i}: loss {got.item()} vs {ref.item()}")
        grad_ratio = _grad_errors({n: p.grad for n, p in gpu.named_parameters()},
                                  {n: p.grad for n, p in cpu.named_parameters()})
        for pc, pg in zip(cpu.parameters(), gpu.parameters()):
            pc.grad.copy_(pg.grad.cpu())
        steps["card"].update()
        steps["host"].update()
        adam = 0.0
        for (name, pc), pg in zip(cpu.named_parameters(), gpu.parameters()):
            a, b = pg.detach().cpu().double(), pc.detach().double()
            err = float(((a - b).abs() - 2 * np.spacing(b.abs().float().numpy())).max()) / REF_LR
            if not err <= REF_ADAM_TOL:
                raise AssertionError(f"tiny training step {i}, {name}: AdamW differs by "
                                     f"{err:.3e} learning rates")
            adam = max(adam, err)
        worst = max(worst, grad_ratio)
        print(f"  tiny training step {i} (f32, remat, 1x{frames}x{height}x{width}), card vs "
              f"CPU: loss {got.item():.6f} vs {ref.item():.6f} (rel {rel:.2e}, tol "
              f"{REF_LOSS_TOL:g}); worst gradient leaf at {grad_ratio:.3f} of its bound; "
              f"AdamW within {max(adam, 0.0):.2e} learning rates", flush=True)
    launches = _stage1_launches()
    bwd = {fn.__name__: fn.bwd_chunks - chunks[fn.__name__]
           for fn in (flash_attention, geglu_ff, temporal_conv)}
    print(f"  tiny training launches {launches}, backward chunks {bwd}", flush=True)
    if min(launches.values()) <= 0 or min(bwd.values()) <= 0:
        raise AssertionError(f"the tiny training steps skipped a kernel or a backward: "
                             f"{launches} {bwd}")
    return worst


def _count_remat_launches():
    """Patch ``unet_blocks._remat`` to add up the launches of TRAIN_KERNELS
    made inside remat'd blocks (``inside``, during the forward; the backward's
    recompute calls the blocks without it); returns (inside, restore)."""
    from streamingt2v_torch.models import unet_blocks

    inside = dict.fromkeys(TRAIN_KERNELS, 0)
    remat = unet_blocks._remat

    def counted(block, forward, *args):
        before = _stage1_launches()
        out = remat(block, forward, *args)
        for k, n in _stage1_launches().items():
            inside[k] += n - before[k]
        return out

    unet_blocks._remat = counted
    return inside, lambda: setattr(unet_blocks, "_remat", remat)


def run_train(steps: int) -> dict:
    """Phase 8: the full-width SVD-XT UNet (``controlnet_mode`` and APM off,
    ``use_checkpoint`` on, bf16, random weights from seed 0) through
    ``openai_wrapper`` and ``DiffusionEngine`` (AdamW 1e-4, weight decay
    1e-4, EMA 0.9999) for ``steps`` steps on one 25-frame 576x1024 clip with
    one generator seed: per-step seconds (forward+backward, then
    optimizer+EMA, between device syncs), loss, peak memory, K1/K3/K4
    launches against a no-grad forward's, backward chunks, and the share of
    parameters each update changed."""
    import dataclasses

    import torch

    from streamingt2v_torch.config import PipelineConfig
    from streamingt2v_torch.diffusion.denoiser import denoise
    from streamingt2v_torch.diffusion.engine import DiffusionEngine
    from streamingt2v_torch.models.layers import init_random_
    from streamingt2v_torch.models.video_unet import VideoUNet
    from streamingt2v_torch.models.wrappers import openai_wrapper
    from streamingt2v_torch.ops.flash_attention import flash_attention
    from streamingt2v_torch.ops.fused_ff import geglu_ff
    from streamingt2v_torch.ops.temporal_conv import temporal_conv

    dev = torch.device("cuda")
    _release_earlier_phases()
    base = PipelineConfig()
    ucfg = dataclasses.replace(base.unet, controlnet_mode=False, use_apm=False,
                               use_checkpoint=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    unet = VideoUNet(ucfg, device=dev, dtype=torch.bfloat16)
    init_random_(unet, torch.Generator(dev).manual_seed(0))
    n_params = sum(p.numel() for p in unet.parameters())
    engine = DiffusionEngine(unet, openai_wrapper, ema_decay=TRAIN_EMA_DECAY)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    h, w = base.height // 8, base.width // 8
    batch = _train_batch(TRAIN_FRAMES, h, w, ucfg.context_dim, ucfg.adm_in_channels, dev)
    print(f"  SVD-XT UNet: {n_params} parameters ({n_params * 2 / 2**30:.2f} GiB bf16), built "
          f"with its EMA in {time.perf_counter() - t0:.1f} s, resident {resident / 2**30:.2f} "
          f"GiB; batch 1 x {TRAIN_FRAMES} x {h} x {w} x 4 latents, AdamW lr 1e-4 wd 1e-4, EMA "
          f"{TRAIN_EMA_DECAY}, {steps} steps on one batch and one generator seed", flush=True)

    # one no-grad forward of the same UNet: the launches a training step doubles
    _reset_launches()
    with torch.inference_mode():
        sigma = torch.ones(1, device=dev)
        denoise(openai_wrapper(unet), batch["latents"], sigma, batch["cond"])
    forward = _stage1_launches()
    print(f"  one no-grad forward launches {forward}", flush=True)

    inside, restore = _count_remat_launches()
    to_q = unet.input_0_attn.block_0.attn1.to_q.kernel
    conv = unet.input_0_res.time_stack.in_conv.kernel
    counters = (flash_attention, geglu_ff, temporal_conv)
    losses, records = [], []
    try:
        for step in range(steps):
            gen = torch.Generator(dev).manual_seed(1)
            chunks = {fn.__name__: fn.bwd_chunks for fn in counters}
            for k in inside:
                inside[k] = 0
            _reset_launches()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = engine.backward(batch, gen)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            peak = torch.cuda.max_memory_allocated()
            launches = _stage1_launches()
            grads = {"to_q": float(to_q.grad.abs().max()), "conv": float(conv.grad.abs().max())}
            before = [p.detach().clone() for p in unet.parameters()]
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t2 = time.perf_counter()
            engine.apply_updates()
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            opt_extra = torch.cuda.max_memory_allocated() - base
            changed = sum(int((p.detach() != b).sum()) for p, b in zip(unet.parameters(), before))
            del before
            losses.append(loss.item())
            rec = dict(loss=losses[-1], fwd_bwd_s=t1 - t0, opt_ema_s=t3 - t2,
                       peak_gib=peak / 2**30, opt_extra_gib=opt_extra / 2**30, launches=launches,
                       inside=dict(inside), changed=changed / n_params, grads=grads,
                       bwd_chunks={fn.__name__: fn.bwd_chunks - chunks[fn.__name__]
                                   for fn in counters})
            records.append(rec)
            print(f"  step {step + 1}: loss {rec['loss']:.6f}; forward+backward "
                  f"{rec['fwd_bwd_s']:.3f} s, optimizer+EMA {rec['opt_ema_s']:.3f} s; peak "
                  f"{rec['peak_gib']:.2f} GiB in the forward+backward, the update "
                  f"{rec['opt_extra_gib']:.2f} GiB above its start; resident "
                  f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB; launches {launches} (inside remat'd blocks "
                  f"{rec['inside']}); backward chunks {rec['bwd_chunks']}; max |grad| level-0 "
                  f"to_q {grads['to_q']:.3e}, temporal conv {grads['conv']:.3e}; parameters "
                  f"changed {100 * rec['changed']:.4f}%", flush=True)
    finally:
        restore()
    later = records[1:]
    print(f"  seconds per step: first {records[0]['fwd_bwd_s'] + records[0]['opt_ema_s']:.3f}, "
          f"then {statistics.mean(r['fwd_bwd_s'] + r['opt_ema_s'] for r in later):.3f} "
          f"(forward+backward {statistics.mean(r['fwd_bwd_s'] for r in later):.3f}, "
          f"optimizer+EMA {statistics.mean(r['opt_ema_s'] for r in later):.3f}); resident "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB, peak "
          f"{max(r['peak_gib'] for r in records):.2f} GiB; losses {losses}", flush=True)

    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"the training loss is not finite and descending: {losses}")
    # zero-initialised output layers hold every gradient upstream of them at
    # zero until they move: the UNet's out_conv in step 1, the transformers'
    # proj_out and the time stacks' out_conv (behind it) in step 2; from step
    # 3 the gradients reach to_q through K1 and the time stack's in_conv
    # through K4 (its out_conv's dx, its in_conv's dw)
    if not (records[2]["grads"]["to_q"] > 0 and records[2]["grads"]["conv"] > 0):
        raise AssertionError(f"step 3 gave no gradient across K1 or K4: {records[2]['grads']}")
    for step, rec in enumerate(records):
        outside = {k: forward[k] - rec["inside"][k] for k in TRAIN_KERNELS}
        if any(outside.values()):
            print(f"  step {step + 1}: launched outside remat'd blocks (counted once): "
                  f"{outside}", flush=True)
        want = {k: forward[k] + rec["inside"][k] for k in TRAIN_KERNELS}
        if rec["launches"] != want or min(want.values()) <= 0:
            raise AssertionError(f"step {step + 1}: launches {rec['launches']}, want the "
                                 f"forward's plus the recompute's {want}")
        if min(rec["bwd_chunks"].values()) <= 0:
            raise AssertionError(f"step {step + 1}: a kernel's backward did not run: "
                                 f"{rec['bwd_chunks']}")
    totals = dict.fromkeys(KERNEL_META, 0)
    for rec in records:
        for k, n in rec["launches"].items():
            totals[k] += n
    return totals


def run_enhance(steps: int) -> dict:
    """Phase 8: full-width stage 2 through every kernel of its path."""
    import dataclasses

    import torch

    from streamingt2v_torch.config import EnhanceConfig
    from streamingt2v_torch.pipeline.build import build_enhance

    dev = torch.device("cuda")
    _release_earlier_phases()
    cfg = EnhanceConfig()
    if steps != cfg.num_steps:
        print(f"  cut: DDIM steps {cfg.num_steps} -> {steps} "
              f"({min(int(steps * cfg.strength), steps)} run after strength {cfg.strength})",
              flush=True)
    cfg = dataclasses.replace(cfg, num_steps=steps)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pipe = build_enhance(cfg, seed=0, device=dev, bf16=True)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    print(f"  build_enhance: {time.perf_counter() - t0:.1f} s, resident weights "
          f"{resident / 2**30:.2f} GiB (VAE f32 + its bf16 copy)", flush=True)

    spans = {"encode_prompts": [], "_key_image_cond": [], "_encode_video": [],
             "_denoise_step": [], "_decode_latents": []}

    def timed(name, fn):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            start = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            spans[name].append(time.perf_counter() - start)
            return out
        return wrapper

    for name in spans:
        setattr(pipe, name, timed(name, getattr(pipe, name)))

    video = _smooth_video(ENHANCE_FRAMES, cfg.height, cfg.width, device=dev)
    image = _smooth_image(cfg.height, cfg.width, seed=4).to(dev)
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    out = pipe.enhance_with_keyframe_prepass(video, image)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = _read_launches(f32=True)
    peak = torch.cuda.max_memory_allocated()
    fmt = lambda xs: "[" + ", ".join(f"{x:.1f}" for x in xs) + "]"  # noqa: E731
    print("  seconds: text " + fmt(spans["encode_prompts"])
          + ", key-frame conditioning " + fmt(spans["_key_image_cond"])
          + ", encode " + fmt(spans["_encode_video"])
          + ", denoise steps (pre-pass, then main) " + fmt(spans["_denoise_step"])
          + ", decode " + fmt(spans["_decode_latents"])
          + f"; enhance_with_keyframe_prepass total {total:.1f}", flush=True)
    print(f"  peak memory {peak / 2**30:.2f} GiB; launches {launches}", flush=True)

    want = (ENHANCE_FRAMES, cfg.height, cfg.width, 3)
    if tuple(out.shape) != want:
        raise AssertionError(f"enhanced video shape {tuple(out.shape)} != {want}")
    if not torch.isfinite(out).all():
        raise AssertionError("enhanced video has non-finite values")
    lo, hi = out.min().item(), out.max().item()
    if lo < -1.0 or hi > 1.0:
        raise AssertionError(f"enhanced video outside [-1, 1]: [{lo}, {hi}]")
    dead = [k for k in ("flash_attention_packed", "flash_attention_packed_d512", "geglu_ff",
                        "temporal_conv", "fused_group_norm", "fused_temporal_attention",
                        "fused_group_norm_affine")
            if launches[k] <= 0]
    if dead:
        raise AssertionError(f"the enhance phase never launched: {dead}")
    print(f"  video {want} finite in [{lo:.3f}, {hi:.3f}], std {out.std().item():.4f}",
          flush=True)
    return launches


def _translated_video(frames: int, height: int, width: int, shift: float, device="cpu",
                      offset: float = 0.0):
    """A [0, 1] video whose content moves left by ``shift`` pixels a frame:
    frame k is a fixed smooth field sampled at columns x + shift * (k + offset)."""
    import torch

    yy = torch.arange(height, device=device, dtype=torch.float32)[None, :, None]
    xx = torch.arange(width, device=device, dtype=torch.float32)[None, None, :]
    xs = xx + shift * (torch.arange(frames, device=device, dtype=torch.float32)[:, None, None]
                       + offset)
    chans = [0.5 + 0.2 * torch.sin(2 * math.pi * (fy * yy / height + fx * xs / width) + ph)
             + 0.15 * torch.sin(2 * math.pi * gx * xs / width + gy * yy / height)
             for fy, fx, ph, gx, gy in ((1.3, 2.1, 0.3, 7.0, 2.0), (2.2, 1.4, 1.9, 5.0, 3.0),
                                        (0.7, 3.1, 4.0, 9.0, 1.0))]
    return torch.stack(chans, dim=-1)


def check_vfi_reference() -> float:
    """Phase 4, stage 3: the tiny VFI with flip-TTA on the card agrees with
    the same network on the CPU."""
    import dataclasses

    import torch

    from streamingt2v_torch.config import PipelineConfig, VFIConfig
    from streamingt2v_torch.pipeline.build import build_interpolate

    cfg = dataclasses.replace(PipelineConfig.tiny(),
                              vfi=dataclasses.replace(VFIConfig.tiny(), tta=True))
    gpu = build_interpolate(cfg, seed=0, device="cuda")
    cpu = build_interpolate(cfg, seed=0, device="cpu", init=False)
    cpu.model.load_state_dict(gpu.model.state_dict())
    video = _translated_video(5, 64, 64, SHIFT_PX)
    got = gpu.interpolate_video(video.cuda()).cpu()
    ref = cpu.interpolate_video(video)
    err = (got - ref).abs().max().item()
    print(f"  small stage 3 {tuple(ref.shape)} f32 TTA, card vs CPU: max_abs_err={err:.3e} "
          f"tol={REFERENCE_ATOL:g}; ref std {ref.std().item():.3f}", flush=True)
    if not torch.isfinite(got).all() or err > REFERENCE_ATOL:
        raise AssertionError(f"small-input stage 3 disagrees with the CPU ({err:.3e})")
    return err


def _check_warp_motion(video, dev) -> None:
    """The warp the network runs, against the video's known motion: frame k
    warped by +shift/2 and frame k+1 by -shift/2 both land on the true
    midpoint (the field sampled half a frame on), closer than either frame."""
    import torch

    from streamingt2v_torch.ops.warp import backward_warp

    n = 4
    f0, f1 = video[:n], video[1:n + 1]
    truth = _translated_video(n, video.shape[1], video.shape[2], SHIFT_PX, dev, offset=0.5)
    flow = torch.zeros(f0.shape[:3] + (2,), device=dev)
    flow[..., 0] = SHIFT_PX / 2
    inner = (slice(None), slice(None), slice(8, -8))     # away from the clamped borders
    dist = lambda a: (a - truth)[inner].abs().mean().item()  # noqa: E731
    d = {"frame k": dist(f0), "frame k+1": dist(f1),
         "warp(k, +s/2)": dist(backward_warp(f0, flow)),
         "warp(k+1, -s/2)": dist(backward_warp(f1, -flow)),
         "warp(k, -s/2)": dist(backward_warp(f0, -flow))}
    print("  warp against the known motion, mean |x - true midpoint|: "
          + ", ".join(f"{k} {v:.5f}" for k, v in d.items()), flush=True)
    ends = min(d["frame k"], d["frame k+1"])
    if not (d["warp(k, +s/2)"] < 0.25 * ends and d["warp(k+1, -s/2)"] < 0.25 * ends
            and d["warp(k, -s/2)"] > ends):
        raise AssertionError(f"the warp does not follow the motion: {d}")


def run_interpolate() -> None:
    """Phase 9: full-width stage 3 on a 720p video with known motion."""
    import torch

    from streamingt2v_torch.config import PipelineConfig
    from streamingt2v_torch.pipeline.build import build_interpolate

    dev = torch.device("cuda")
    _release_earlier_phases()
    cfg = PipelineConfig()
    h, w = cfg.enhance.height, cfg.enhance.width
    t0 = time.perf_counter()
    pipe = build_interpolate(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    n_params = sum(p.numel() for p in pipe.model.parameters())
    print(f"  build_interpolate: {time.perf_counter() - t0:.1f} s, {n_params / 1e6:.2f} M "
          f"parameters f32, resident {resident / 2**30:.2f} GiB; TTA {pipe.tta}", flush=True)
    video = _translated_video(INTERP_FRAMES, h, w, SHIFT_PX, dev)
    _check_warp_motion(video, dev)

    default_batch = pipe.pair_batch
    pipe.pair_batch = 1
    pipe.interpolate_video(video[:2])    # warm-up: cuDNN and allocator
    sweep = []
    for batch in PAIR_BATCHES:
        pipe.pair_batch = batch
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = time.perf_counter()
        pipe.interpolate_video(video[:SWEEP_PAIRS + 1])
        torch.cuda.synchronize()
        per_pair = (time.perf_counter() - start) / SWEEP_PAIRS
        peak = torch.cuda.max_memory_allocated()
        sweep.append((batch, per_pair, peak))
        print(f"  pair_batch {batch} ({2 * batch} network rows with TTA): {per_pair:.4f} s "
              f"per pair over {SWEEP_PAIRS} pairs, peak {peak / 2**30:.2f} GiB", flush=True)
    best = min(sweep, key=lambda r: r[1])
    print(f"  fastest pair_batch {best[0]} ({best[1]:.4f} s per pair); the pipeline's "
          f"default is {default_batch}", flush=True)

    pipe.pair_batch = default_batch
    torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    out = pipe.interpolate_video(video)
    torch.cuda.synchronize()
    total = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated()
    want = (2 * INTERP_FRAMES - 1, h, w, 3)
    print(f"  interpolate_video {INTERP_FRAMES} -> {out.shape[0]} frames: {total:.2f} s "
          f"({total / (INTERP_FRAMES - 1):.4f} s per pair), peak {peak / 2**30:.2f} GiB",
          flush=True)
    if tuple(out.shape) != want:
        raise AssertionError(f"interpolated video shape {tuple(out.shape)} != {want}")
    if not torch.isfinite(out).all():
        raise AssertionError("interpolated video has non-finite values")
    lo, hi = out.min().item(), out.max().item()
    if lo < 0.0 or hi > 1.0:
        raise AssertionError(f"interpolated video outside [0, 1]: [{lo}, {hi}]")
    if not torch.equal(out[::2], video):
        raise AssertionError("the input frames are not kept at the even indices")
    print(f"  video {want} finite in [{lo:.3f}, {hi:.3f}], input frames kept", flush=True)


def run_product(enhance_steps: int, frames: int) -> dict:
    """Phase 10: the three-stage product at full width through ``StreamingT2VPipeline``."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch

    from streamingt2v_torch.config import PipelineConfig
    from streamingt2v_torch.pipeline.build import build_product
    from streamingt2v_torch.utils import media
    from streamingt2v_torch.utils.profiling import reset_timers, stage_seconds

    dev = torch.device("cuda")
    _release_earlier_phases()
    cfg = PipelineConfig(num_frames=frames)
    cfg = dataclasses.replace(cfg, enhance=dataclasses.replace(cfg.enhance,
                                                               num_steps=enhance_steps))
    print(f"  {frames} frames: stage 1 makes {cfg.stage1_frames} at {cfg.height}x{cfg.width} "
          f"({cfg.n_autoregressions(cfg.stage1_frames)} AR chunks, sampler steps "
          f"{cfg.first_chunk_sampler.num_steps} + {cfg.sampler.num_steps}), stage 2 "
          f"{enhance_steps} DDIM steps at {cfg.enhance.height}x{cfg.enhance.width}, "
          f"randomized blending {cfg.use_randomized_blending}", flush=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pipe = build_product(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    print(f"  build_product: {time.perf_counter() - t0:.1f} s, resident weights "
          f"{resident / 2**30:.2f} GiB", flush=True)

    image = ((_smooth_image(cfg.height, cfg.width, seed=5).numpy() + 1.0) * 127.5).round()
    image = image.clip(0, 255).astype(np.uint8)
    reset_timers()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/product.y4m"
        t0 = time.perf_counter()
        out = pipe.run(image, path, seed=cfg.seed)
        total = time.perf_counter() - t0
        info = media.y4m_info(path)
    launches = _read_launches(f32=True)
    peak = torch.cuda.max_memory_allocated()
    stages = stage_seconds()
    print(f"  seconds: {stages}; run total {total:.1f} (with the file)", flush=True)
    print(f"  resident {resident / 2**30:.2f} GiB, peak {peak / 2**30:.2f} GiB; stage_finite "
          f"{pipe.stage_finite}; launches {launches}", flush=True)
    print(f"  file: {info}", flush=True)

    want = {"width": cfg.enhance.width, "height": cfg.enhance.height,
            "fps": float(cfg.out_fps), "frames": frames}
    if info != want:
        raise AssertionError(f"the y4m file is {info}, not {want}")
    if out.shape != (frames, cfg.enhance.height, cfg.enhance.width, 3):
        raise AssertionError(f"product frames {out.shape}")
    if pipe.stage_finite != {"stage1": True, "enhance": True, "vfi": True}:
        raise AssertionError(f"a stage gave non-finite values: {pipe.stage_finite}")
    _check_native_writer(stages, "the product")
    _check_product_launches(cfg, launches, "the product")
    print(f"  video {out.shape} uint8, mean {out.mean():.2f}, std {out.std():.2f}", flush=True)
    return launches


def _check_native_writer(stages: dict, what: str) -> None:
    """The y4m was written by the port's native feeder: ``utils/media.py``
    times the write as ``save_y4m_native`` (``save_y4m_python`` without it)."""
    if "save_y4m_native" not in stages or "save_y4m_python" in stages:
        raise AssertionError(f"{what}: the y4m was not written by the native feeder "
                             f"(timed stages {sorted(stages)})")
    print(f"  y4m written by the native feeder in {stages['save_y4m_native']:.3f} s",
          flush=True)


def _check_product_launches(cfg, launches: dict, what: str) -> None:
    """Every kernel row launched in a product run, K6 where its gate admits
    stage 2's chunk."""
    from streamingt2v_torch.ops.temporal_attention import MAX_FRAMES, fits_temporal_attention

    # K6 takes temporal attention over at most MAX_FRAMES frames: stage 2's
    # chunk is the whole video without blending (100 frames in the product)
    chunk = cfg.enhance.chunk_size if cfg.use_randomized_blending else cfg.stage1_frames
    expected = [k for k in KERNEL_META if k != "fused_temporal_attention"
                or fits_temporal_attention(chunk, chunk, 64)]
    if expected != list(KERNEL_META):
        print(f"  stage 2's {chunk}-frame chunk is past K6's {MAX_FRAMES} frames: its "
              f"temporal attention takes the plain path", flush=True)
    dead = [k for k in expected if launches[k] <= 0]
    if dead:
        raise AssertionError(f"{what} never launched: {dead}")



# ------------------------------------------------------------- the tree ---
# A checkpoint tree in the reference's names, written from the port's modules
# by inverting each entry of the loader's maps (``utils/loader.py``'s
# ``*_conversions``), every tensor in the dtype it has in memory.  The loader
# phase writes one at full width and loads it back; the CPU tests write tiny
# ones.  The JAX package has no exporter: this is test tooling.

# A few merges over the synthetic byte-level vocabulary: the tree's tokenizer
# is a BPE, with ids far below the text tower's 49408.
TREE_MERGES = ("h i", "hi g", "hig h</w>", "q u", "qu a", "e d</w>", "i l", "a i")


def write_safetensors(path: str, tensors: dict) -> int:
    """Write ``{name: tensor}`` as a ``.safetensors`` file, widest dtypes first
    (each tensor's offset then aligned to its element size), one tensor on the
    host at a time; returns the file's bytes."""
    import os
    import struct

    import torch

    from streamingt2v_torch.utils.checkpoint import SAFETENSORS_DTYPES

    names = {dtype: name for name, dtype in SAFETENSORS_DTYPES.items()}
    keys = sorted(tensors, key=lambda k: -tensors[k].element_size())
    header, offset = {}, 0
    for k in keys:
        t = tensors[k]
        n = t.numel() * t.element_size()
        header[k] = {"dtype": names[t.dtype], "shape": list(t.shape),
                     "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for k in keys:
            f.write(tensors[k].detach().contiguous().cpu().reshape(-1).view(torch.uint8).numpy())
    return 8 + len(raw) + offset


def reference_tensors(keys: tuple, transform, value) -> dict:
    """The reference tensors that ``transform`` maps onto ``value`` (views)."""
    from streamingt2v_torch.utils import checkpoint as ck

    inverse = {ck.t_id: lambda w: [w], ck.t_transpose: lambda w: [w.t()],
               ck.t_conv3d: lambda w: [w.permute(2, 1, 0)[..., None, None]],
               ck.t_linear_to_conv1x1: lambda w: [w[:, :, 0, 0]],
               ck.t_cat: lambda w: list(w.chunk(len(keys)))}
    return dict(zip(keys, inverse[transform](value)))


def reference_state_dicts(conversions) -> dict:
    """{source: {reference key: tensor}} for the loader's conversions."""
    out = {}
    for source, module, mapping in conversions:
        sd = out.setdefault(source, {})
        for name, value in module.state_dict().items():
            tk, transform = mapping[name]
            sd.update(reference_tensors(tk if isinstance(tk, tuple) else (tk,), transform, value))
    return out


def write_tokenizer(directory: str, tokenizer, merges=TREE_MERGES) -> None:
    """``vocab.json`` and ``merges.txt``: ``tokenizer``'s vocabulary with a
    token for each merge added."""
    import os

    vocab = dict(tokenizer.encoder)
    for m in merges:
        vocab.setdefault("".join(m.split()), len(vocab))
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(directory, "merges.txt"), "w") as f:
        f.write("\n".join(("#version: 0.2",) + tuple(merges)) + "\n")


def write_reference_tree(root: str, stage1=None, enhance=None, interpolate=None,
                         svd_xt: bool = True) -> dict:
    """Write the checkpoint tree of the given stage pipelines under ``root`` in
    the layout of ``utils/loader.py``: for stage 1 the StreamingSVD
    whole-trainer safetensors and (with ``svd_xt``) the diffusers SVD-XT UNet,
    for stage 2 the i2vgen-xl component folders with the scheduler config and
    BPE tokenizer files, for stage 3 EMA-VFI's ``module.``-prefixed torch
    pickle.  Returns the bytes written per source (the first path component)."""
    import dataclasses
    import os

    import torch

    from streamingt2v_torch.utils import loader

    conversions = []
    if stage1 is not None:
        conversions += loader.stage1_conversions(stage1.cfg, stage1.models, svd_xt)
    if enhance is not None:
        conversions += loader.enhance_conversions(enhance.m)
    if interpolate is not None:
        conversions += loader.interpolate_conversions(interpolate.model)
    sizes = {}
    for source, tensors in reference_state_dicts(conversions).items():
        path = os.path.join(root, source)
        if source.endswith(".pkl"):
            os.makedirs(os.path.dirname(path), exist_ok=True)
            torch.save({f"module.{k}": v.detach().cpu() for k, v in tensors.items()}, path)
            n = os.path.getsize(path)
        else:
            if not source.endswith(".safetensors"):     # a diffusers/HF component folder
                name = ("model.safetensors" if source.endswith("_encoder")
                        else "diffusion_pytorch_model.safetensors")
                path = os.path.join(path, name)
            n = write_safetensors(path, tensors)
        top = source.split("/")[0]
        sizes[top] = sizes.get(top, 0) + n
    if enhance is not None:
        sched = os.path.join(root, loader.I2VGEN, "scheduler")
        os.makedirs(sched, exist_ok=True)
        with open(os.path.join(sched, "scheduler_config.json"), "w") as f:
            json.dump(dataclasses.asdict(enhance.m.scheduler.cfg), f)
        write_tokenizer(os.path.join(root, loader.I2VGEN, "tokenizer"), enhance.m.tokenizer)
    return sizes


def product_modules(pipe) -> dict:
    """{name: module} of every weight-holding module of a product."""
    import dataclasses

    out = {f"stage1.{f.name}": getattr(pipe.stage1.models, f.name)
           for f in dataclasses.fields(pipe.stage1.models)}
    if pipe.enhance is not None:
        out.update({f"enhance.{k}": getattr(pipe.enhance.m, k)
                    for k in ("unet", "vae", "clip_vision", "text_encoder")})
    if pipe.interpolate is not None:
        out["vfi"] = pipe.interpolate.model
    return out


def assert_same_weights(built, loaded) -> int:
    """Every parameter of ``loaded``'s modules equals ``built``'s bit for bit,
    dtype and shape included; returns the number of tensors compared."""
    import torch

    a, b = product_modules(built), product_modules(loaded)
    if a.keys() != b.keys():
        raise AssertionError(f"module sets differ: {sorted(a)} vs {sorted(b)}")
    n = 0
    for name in a:
        sa, sb = a[name].state_dict(), b[name].state_dict()
        if sa.keys() != sb.keys():
            raise AssertionError(f"{name}: parameter names differ")
        for k in sa:
            x, y = sa[k], sb[k]
            if x.dtype != y.dtype or x.shape != y.shape or x.device != y.device:
                raise AssertionError(f"{name}.{k}: {x.dtype}{tuple(x.shape)} on {x.device} "
                                     f"vs {y.dtype}{tuple(y.shape)} on {y.device}")
            if not torch.equal(x.view(-1).view(torch.uint8), y.view(-1).view(torch.uint8)):
                raise AssertionError(f"{name}.{k}: the loaded weights differ from the built")
            n += 1
    return n


def _distinct_constants_(pipe, seed: int = 0) -> None:
    """Give every constant tensor of a random-weight product (zero biases,
    unit norm scales, zero blend factors, zero-initialised output layers) a
    small draw of its own, so that the tree's equality check tells any two
    parameters apart."""
    import torch

    for i, module in enumerate(product_modules(pipe).values()):
        gen = torch.Generator(next(module.parameters()).device).manual_seed(seed * 100 + i)
        with torch.no_grad():
            for p in module.parameters():
                if p.numel() and bool(p.min() == p.max()):
                    p.add_(torch.randn(p.shape, generator=gen, device=p.device,
                                       dtype=torch.float32).to(p.dtype) * 0.01)


def run_loader(enhance_steps: int, frames: int, first_steps: int, ar_steps: int) -> dict:
    """Phase 11: the checkpoint loader at full width.  A reference-named tree is
    written from ``build_product``'s random weights, loaded back through
    ``utils/loader.py`` and compared bit for bit; then the CLI runs the product
    from the tree (``--ckpt_dir``) on a 576x1024 PNG into a y4m file."""
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch
    from PIL import Image

    from streamingt2v_torch.config import PipelineConfig
    from streamingt2v_torch.pipeline import cli
    from streamingt2v_torch.pipeline.build import build_product
    from streamingt2v_torch.pipeline.full import StreamingT2VPipeline
    from streamingt2v_torch.utils import loader, media
    from streamingt2v_torch.utils.profiling import reset_timers, stage_seconds, timing_report

    dev = torch.device("cuda")
    _release_earlier_phases()
    cfg = PipelineConfig()
    t0 = time.perf_counter()
    built = build_product(cfg, seed=0, device=dev)
    _distinct_constants_(built)
    torch.cuda.synchronize()
    nbytes = sum(p.numel() * p.element_size() for m in product_modules(built).values()
                 for p in m.parameters())
    nparams = {name: sum(p.numel() for p in m.parameters())
               for name, m in product_modules(built).items()}
    print(f"  build_product: {time.perf_counter() - t0:.1f} s, {nbytes / 2**30:.2f} GiB of "
          f"weights; parameters (M): "
          + ", ".join(f"{k} {v / 1e6:.1f}" for k, v in nparams.items()), flush=True)

    with tempfile.TemporaryDirectory(prefix="st2v_tree_") as tmp:
        free = shutil.disk_usage(tmp).free
        need = int(nbytes * 1.05) + 2**30
        print(f"  tree directory {tmp}: {free / 2**30:.1f} GiB free, {need / 2**30:.1f} GiB "
              f"needed", flush=True)
        if free < need:
            raise RuntimeError(f"{tmp} has {free / 2**30:.1f} GiB free; the tree needs "
                               f"{need / 2**30:.1f} GiB (set TMPDIR to a larger disk)")
        tree = os.path.join(tmp, "ckpt")
        t0 = time.perf_counter()
        sizes = write_reference_tree(tree, built.stage1, built.enhance, built.interpolate)
        write_s = time.perf_counter() - t0
        print(f"  wrote the tree in {write_s:.1f} s: "
              + ", ".join(f"{k} {v / 2**30:.3f} GiB" for k, v in sizes.items())
              + f"; {sum(sizes.values()) / 2**30:.2f} GiB, "
                f"{sum(sizes.values()) / write_s / 1e9:.2f} GB/s", flush=True)

        reset_timers()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        loaded = StreamingT2VPipeline(
            cfg, loader.load_stage1_checkpoints(cfg, tree, device=dev),
            loader.load_enhance_pipeline(cfg, tree, device=dev),
            loader.load_interpolate_pipeline(cfg, tree, device=dev))
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        added = torch.cuda.memory_allocated() - base
        peak = torch.cuda.max_memory_allocated() - base
        report = timing_report()
        for src, n in sizes.items():
            s = report[f"load_{src}"]["total_s"]
            print(f"  load {src}: {n / 2**30:.3f} GiB in {s:.2f} s, {n / s / 1e9:.2f} GB/s",
                  flush=True)
        print(f"  loaded in {load_s:.1f} s: {added / 2**30:.2f} GiB resident after the load, "
              f"card peak during the load {peak / 2**30:.2f} GiB above what was resident "
              f"before ({(peak - added) / 2**20:.0f} MiB beyond the loaded weights)", flush=True)
        n = assert_same_weights(built, loaded)
        tok = loaded.enhance.m.tokenizer
        ids = tok(["High Quality, HQ, detailed."])
        if not tok.bpe_ranks or ids.max() >= loaded.enhance.m.text_encoder.cfg.vocab_size:
            raise AssertionError(f"the tree's tokenizer did not load: {ids}")
        if loaded.enhance.m.scheduler.cfg != built.enhance.m.scheduler.cfg:
            raise AssertionError("the scheduler config did not load")
        print(f"  {n} tensors equal bit for bit; tokenizer {len(tok.encoder)} tokens, "
              f"{len(tok.bpe_ranks)} merges; scheduler {loaded.enhance.m.scheduler.cfg}",
              flush=True)
        del built, loaded
        _release_earlier_phases()

        image = ((_smooth_image(cfg.height, cfg.width, seed=6).numpy() + 1.0) * 127.5).round()
        png = os.path.join(tmp, "input.png")
        Image.fromarray(image.clip(0, 255).astype(np.uint8)).save(png)
        out_dir = os.path.join(tmp, "results")
        args = cli.build_parser().parse_args([
            "--input", png, "--output", out_dir, "--ckpt_dir", tree, "--container", "y4m",
            "--num_frames", str(frames),
            "--set", f"first_chunk_sampler.num_steps={first_steps}",
            "--set", f"sampler.num_steps={ar_steps}",
            "--set", f"enhance.num_steps={enhance_steps}"])
        print(f"  CLI: --ckpt_dir, {frames} frames, sampler steps {first_steps} + {ar_steps}, "
              f"{enhance_steps} DDIM steps", flush=True)
        reset_timers()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        pipe = cli.build_product_pipeline(args)
        _reset_launches()
        os.makedirs(out_dir)
        path = os.path.join(out_dir, "input.y4m")
        pipe(png, path, seed=args.seed)
        launches = _read_launches(f32=True)
        total = time.perf_counter() - t0
        info = media.y4m_info(path)
    run_cfg = pipe.cfg
    stages = stage_seconds()
    print(f"  seconds: {stages}; CLI total {total:.1f} (loads, run and file)", flush=True)
    print(f"  peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; stage_finite "
          f"{pipe.stage_finite}; launches {launches}; file: {info}", flush=True)
    want = {"width": run_cfg.enhance.width, "height": run_cfg.enhance.height,
            "fps": float(run_cfg.out_fps), "frames": frames}
    if info != want:
        raise AssertionError(f"the y4m file is {info}, not {want}")
    if pipe.stage_finite != {"stage1": True, "enhance": True, "vfi": True}:
        raise AssertionError(f"a stage gave non-finite values: {pipe.stage_finite}")
    _check_native_writer(stages, "the CLI run from the tree")
    _check_product_launches(run_cfg, launches, "the CLI run from the tree")
    return launches

# ------------------------------------------------------------ the mesh ---
# The multi-device layer on the one card: the CLI under a world of one rank
# (NCCL), stage 2's data-parallel step and a training step under that mesh,
# each rank's share of a split K3, K1 and ring attention run one rank after
# another (``_sim_rank``), forward and backward, and the training losses.

MESH_K3_SPLITS = (2, 4)
MESH_FLASH_SPLITS = (2, 4)
MESH_RING_SEQ = 4
MESH_RING_GRAD_SEQS = (2, 4)
TRAIN_RING_ROWS = 125   # batch 1 x 25 frames x 5 heads at level 0 (the train phase's clip)
MESH_LOSS_FRAMES = 25
MESH_VFI_PAIRS = 4
MESH_VFI_LEVELS = 4     # 720 = 16 x 45: five halvings do not divide 720p
LOSS_TOL = 1e-4         # f32, card against CPU (summation order; no TF32)


def _sim_rank(model: int, rank: int):
    """Model rank ``rank`` of a (1, 1, model) mesh simulated in this
    process: the mesh's index math (``MeshLayout``) with an all-reduce
    that hands back this rank's own tensor, so that a unit split by
    ``shard_params`` returns its partial result (and the replicated inputs
    their partial gradients); the phase sums the ranks' results itself."""
    from streamingt2v_torch.config import MeshConfig
    from streamingt2v_torch.parallel.mesh import MeshLayout

    class SimRank(MeshLayout):
        def all_reduce(self, x, axes, op=None):
            return x

    return SimRank(MeshConfig(data=1, seq=1, model=model),
                   {"data": 0, "seq": 0, "model": rank})


def _mesh_cli(png: str, out_dir: str, enhance_steps: int, mesh: bool):
    """The CLI's product pipeline at the loader phase's cut (random weights
    at production width), under ``--mesh 1,1,1`` or without it."""
    from streamingt2v_torch.pipeline import cli

    argv = ["--input", png, "--output", out_dir, "--random_weights", "--container", "y4m",
            "--num_frames", str(LOADER_FRAMES),
            "--set", f"first_chunk_sampler.num_steps={LOADER_SAMPLER_STEPS}",
            "--set", f"sampler.num_steps={LOADER_SAMPLER_STEPS}",
            "--set", f"enhance.num_steps={enhance_steps}"] + (["--mesh", "1,1,1"] if mesh else [])
    args = cli.build_parser().parse_args(argv)
    return args, cli.build_product_pipeline(args)


def _stage3_divergence(model, img0, img1) -> list:
    """One pair batch through stage 3's network (``interpolate_pair`` with
    flip-TTA) twice on the same input, with a forward hook on every module
    of ``model`` that keeps a fingerprint of each output (the sum of its
    f32 bit patterns as integers): the names of the module calls whose
    output differs between the two runs, in the order the hooks fire (the
    first is the op where the runs part; the rest carry its difference)."""
    import torch

    from streamingt2v_torch.models.vfi import interpolate_pair

    names = {m: n or type(m).__name__ for n, m in model.named_modules()}
    prints = [[], []]
    run = [0]

    def fingerprint(x):
        if x.dtype == torch.float32:
            return int(x.contiguous().view(torch.int32).sum(dtype=torch.int64))
        return float(x.double().sum())

    def hook(module, args, out):
        outs = out if isinstance(out, (tuple, list)) else (out,)
        prints[run[0]].append((names[module], tuple(fingerprint(o) for o in outs
                                                   if torch.is_tensor(o))))

    handles = [m.register_forward_hook(hook) for m in model.modules()]
    try:
        with torch.inference_mode():
            for run[0] in (0, 1):
                interpolate_pair(model, img0, img1, tta=True)
    finally:
        for h in handles:
            h.remove()
    return [a[0] for a, b in zip(*prints) if a != b]


def _unpinned_conv_transpose(self, x):
    """``ConvTranspose``'s forward as ``F.conv_transpose2d``, which cuDNN runs
    as a backward-data algorithm: stage 3 as it was before the layer became
    ``conv_transpose_subpixel``, for the measurement only."""
    import torch.nn.functional as F

    from streamingt2v_torch.models.layers import _common

    dt = _common(x, self.kernel)
    y = F.conv_transpose2d(x.to(dt).permute(0, 3, 1, 2), self.kernel.to(dt), self.bias.to(dt),
                           stride=self.stride, padding=self.padding)
    return y.permute(0, 2, 3, 1)


def _deconv_timings(model, img0, img1) -> None:
    """Each ``ConvTranspose`` of stage 3's network at the input it takes on
    one pair batch (flip-TTA): device ms of ``conv_transpose_subpixel`` (the
    port), of ``F.conv_transpose2d`` on cuDNN's default algorithms, and of
    the same under ``cudnn.deterministic`` (the flag restored), each run
    twice and checked for equal bits (printed, not a check)."""
    import torch
    import torch.nn.functional as F

    from streamingt2v_torch.models.layers import ConvTranspose, conv_transpose_subpixel
    from streamingt2v_torch.models.vfi import interpolate_pair

    inputs = {}

    def keep_shape(module, args, out):
        inputs.setdefault(module, args[0].shape)

    mods = [(n, m) for n, m in model.named_modules() if isinstance(m, ConvTranspose)]
    hooks = [m.register_forward_hook(keep_shape) for _, m in mods]
    try:
        with torch.inference_mode():
            interpolate_pair(model, img0, img1, tta=True)
    finally:
        for h in hooks:
            h.remove()

    def deterministic(fn):
        def call(*a):
            was = torch.backends.cudnn.deterministic
            torch.backends.cudnn.deterministic = True
            try:
                return fn(*a)
            finally:
                torch.backends.cudnn.deterministic = was
        return call

    randn, _ = _randn_factory(17)
    with torch.inference_mode():
        for name, m in mods:
            n, h, w, c = inputs[m]
            x = randn(n, c, h, w, dtype=torch.float32)
            plain = lambda x, m=m: F.conv_transpose2d(x, m.kernel, m.bias,   # noqa: E731
                                                      stride=m.stride, padding=m.padding)
            cells = []
            for label, fn in (("subpixel", lambda x, m=m: conv_transpose_subpixel(
                    x, m.kernel, m.bias, m.stride, m.padding)),
                              ("conv_transpose2d", plain),
                              ("deterministic", deterministic(plain))):
                same = torch.equal(fn(x), fn(x))
                cells.append(f"{label} {_time_ms(lambda: fn(x), reps=5):.3f} ms"
                             f"{'' if same else ' (runs differ)'}")
            print(f"  {name} on ({n}, {c}, {h}, {w}) -> {m.kernel.shape[1]} channels: "
                  + ", ".join(cells), flush=True)


def _stage3_determinism(pipe, video) -> None:
    """Stage 3 of the product ``pipe`` on ``video`` (uint8) with no cuDNN flag
    set by this script: one pair batch through the network twice with every
    module's output compared (``_stage3_divergence``), then the whole stage
    twice; any module or uint8 value apart fails the phase.  Then, as a
    measurement, the same with ``ConvTranspose`` run as
    ``F.conv_transpose2d`` (``_unpinned_conv_transpose``): the modules that
    part, the values apart and the seconds, beside the pinned ones."""
    import numpy as np
    import torch

    from streamingt2v_torch.models.layers import ConvTranspose
    from streamingt2v_torch.utils import media

    frames = media.put_unit_range(video[:pipe.interpolate.pair_batch + 1],
                                  pipe.interpolate.device)
    i0, i1 = frames[:-1], frames[1:]
    label = (f"{video.shape[0]} -> {pipe.cfg.num_frames} frames at "
             f"{video.shape[2]}x{video.shape[1]}")
    results = {}
    pinned = ConvTranspose.forward
    try:
        for name in ("pinned", "unpinned"):
            ConvTranspose.forward = pinned if name == "pinned" else _unpinned_conv_transpose
            parted = _stage3_divergence(pipe.interpolate.model, i0, i1)
            outs, secs = [], []
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                outs.append(pipe.interpolate_video(video).astype(np.int16))
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
            diff = outs[0] != outs[1]
            results[name] = (parted, int(diff.sum()))
            print(f"  stage 3 twice, {label}, ConvTranspose "
                  f"{'as conv_transpose_subpixel (the port)' if name == 'pinned' else 'as F.conv_transpose2d'}: "
                  f"{secs[0]:.3f} s and {secs[1]:.3f} s; {int(diff.sum())} of {diff.size} uint8 "
                  f"values differ (max {int(np.abs(outs[0] - outs[1]).max())} levels); one "
                  f"{i0.shape[0]}-pair batch: {len(parted)} module outputs differ"
                  + (f", first {parted[:4]}" if parted else ""), flush=True)
    finally:
        ConvTranspose.forward = pinned
    _deconv_timings(pipe.interpolate.model, i0, i1)
    if results["pinned"] != ([], 0):
        raise AssertionError(f"stage 3 is not the same from run to run: {results['pinned']}")


def _mesh_dp_step(mesh) -> None:
    """Stage 2 at full I2VGen-XL width: one DDIM step of a 64-frame 720p
    video in two blended 38-frame chunks, its 2 x 2 UNet calls as one batch
    (``_denoise_step_dp``) against the sequential step."""
    import torch

    from streamingt2v_torch.config import PipelineConfig
    from streamingt2v_torch.ops.routing import use_routing
    from streamingt2v_torch.pipeline.build import build_enhance
    from streamingt2v_torch.utils.rng import GeneratorEnhanceNoise

    dev = torch.device("cuda")
    _release_earlier_phases()
    ecfg = PipelineConfig().enhance
    pipe = build_enhance(ecfg, seed=0, device=dev, mesh=mesh)
    cs, ov = ecfg.chunk_size, ecfg.overlap_size
    stride = cs - ov
    n = (ENHANCE_FRAMES - cs) // stride + 1
    h, w = ecfg.height // 8, ecfg.width // 8
    gen = torch.Generator(dev).manual_seed(3)
    randn = lambda *s: torch.randn(s, generator=gen, device=dev)   # noqa: E731
    latents = randn(1, ENHANCE_FRAMES, h, w, 4)
    clip_embs = randn(n, 2, pipe.m.clip_vision.cfg.output_dim)
    image_latents = randn(n, 2, cs, h, w, 4)
    t = int(pipe.m.scheduler.sdedit_timesteps(ecfg.num_steps, ecfg.strength)[0])
    noise = GeneratorEnhanceNoise(0, dev)
    kw = dict(chunk_size=cs, stride=stride, overlap_size=ov)
    out, sec, peak = {}, {}, {}
    with torch.inference_mode(), use_routing(ecfg.routing):
        pe = pipe.encode_prompts()
        for name, fn in (("sequential", pipe._denoise_step), ("dp", pipe._denoise_step_dp)):
            args = (latents, 0, t, pe, clip_embs, image_latents, noise)
            fn(*args, **kw)                                 # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out[name] = fn(*args, **kw)
            torch.cuda.synchronize()
            sec[name] = time.perf_counter() - t0
            peak[name] = torch.cuda.max_memory_allocated() / 2**30
    print(f"  stage-2 DDIM step at 720p, {ENHANCE_FRAMES} frames in {n} chunks of {cs}: "
          f"sequential ({2 * n} UNet calls of batch 1) {sec['sequential']:.3f} s, peak "
          f"{peak['sequential']:.2f} GiB; _denoise_step_dp (one batch of {2 * n}) "
          f"{sec['dp']:.3f} s, peak {peak['dp']:.2f} GiB", flush=True)
    _compare("stage-2 _denoise_step_dp against the sequential step", out["dp"],
             out["sequential"], TOL["bf16"])


def _mesh_train_step(mesh) -> None:
    """One full-width SVD-XT training step (the train phase's model, batch
    and draws) under the world-1 mesh against the same step without it."""
    import dataclasses

    import torch

    from streamingt2v_torch.config import PipelineConfig
    from streamingt2v_torch.diffusion.loss import DiffusionLossConfig
    from streamingt2v_torch.models.layers import init_random_
    from streamingt2v_torch.models.video_unet import VideoUNet
    from streamingt2v_torch.models.wrappers import openai_wrapper
    from streamingt2v_torch.parallel.train import init_sharded_state, make_train_step

    dev = torch.device("cuda")
    _release_earlier_phases()
    base = PipelineConfig()
    ucfg = dataclasses.replace(base.unet, controlnet_mode=False, use_apm=False,
                               use_checkpoint=True)
    unet = VideoUNet(ucfg, device=dev, dtype=torch.bfloat16)
    init_random_(unet, torch.Generator(dev).manual_seed(0))
    unet.requires_grad_(True)
    unet, opt = init_sharded_state(unet, lambda ps: torch.optim.AdamW(ps, lr=1e-4,
                                                                      weight_decay=1e-4), mesh)
    batch = _train_batch(TRAIN_FRAMES, base.height // 8, base.width // 8, ucfg.context_dim,
                         ucfg.adm_in_channels, dev)
    loss_cfg = DiffusionLossConfig()
    results = {}
    for name, m in (("no mesh", None), ("world-1 mesh", mesh)):
        step = make_train_step(lambda: openai_wrapper(unet, mesh=m), loss_cfg, opt, mesh=m)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step.backward(batch, torch.Generator(dev).manual_seed(1))
        torch.cuda.synchronize()
        results[name] = (loss.item(), [p.grad.clone() for p in unet.parameters()],
                         time.perf_counter() - t0)
    (la, ga, sa), (lb, gb, sb) = results["no mesh"], results["world-1 mesh"]
    same = sum(int(torch.equal(a, b)) for a, b in zip(ga, gb))
    worst = max(float((a.float() - b.float()).abs().max()) / max(float(a.float().abs().max()),
                                                                  1e-30)
                for a, b in zip(ga, gb))
    print(f"  SVD-XT training step at batch 1 x {TRAIN_FRAMES} x 576x1024: loss {la!r} "
          f"without the mesh ({sa:.3f} s forward+backward), {lb!r} under the world-1 mesh "
          f"({sb:.3f} s); {same} of {len(ga)} gradients equal bit for bit, the worst leaf "
          f"{worst:.3e} of its max", flush=True)
    # the forward is deterministic; cuDNN's weight-gradient algorithms may sum
    # in another order from run to run
    if la != lb or not math.isfinite(la) or worst > TOL["bf16"]:
        raise AssertionError("the training step under the world-1 mesh is not the step "
                             "without it")
    t0 = time.perf_counter()
    step.update()
    torch.cuda.synchronize()
    print(f"  AdamW update under the mesh: {time.perf_counter() - t0:.3f} s", flush=True)


def _mesh_splits() -> dict:
    """Each rank's share of the split kernels at full width, one simulated
    rank after another, against the unsplit call: K3 over model = 2 and 4
    at the three stage-1 UNet widths (``shard_params`` on a FeedForward and
    its tensor-parallel forward), K1 over the batch*heads rows
    (``_flash_rows``, the rank's part of ``_flash_sharded``) and ring
    attention over seq = 4 (``ring_fold``, the ring's per-hop update)."""
    import copy

    import torch

    from streamingt2v_torch.models.layers import init_random_
    from streamingt2v_torch.models.unet_blocks import FeedForward
    from streamingt2v_torch.ops.attention import _flash_rows
    from streamingt2v_torch.ops.flash_attention import flash_attention
    from streamingt2v_torch.parallel.ring_attention import ring_finish, ring_fold, ring_start
    from streamingt2v_torch.parallel.sharding import shard_params

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    randn, gen = _randn_factory(7)
    counts = {"geglu_ff": 0, "flash_attention": 0}
    errs = []
    with torch.inference_mode():
        for level, (n, c) in enumerate(K3_LEVELS):
            ff = init_random_(FeedForward(c, c, device=dev, dtype=bf16), gen)
            ff.proj.bias.copy_(randn(2 * 4 * c, dtype=bf16, std=0.1))
            ff.out.bias.copy_(randn(c, dtype=bf16, std=0.1))
            ln = (1.0 + randn(c, dtype=torch.float32, std=0.1), randn(c, dtype=torch.float32,
                                                                      std=0.1))
            x = randn(n, c, dtype=bf16)
            whole = ff(x, ln=ln, residual=True)
            for m in MESH_K3_SPLITS:
                # shard_params reads the FF's name (``ff``) as the JAX rules do
                parts = [shard_params(torch.nn.ModuleDict({"ff": copy.deepcopy(ff)}),
                                      _sim_rank(m, r))["ff"] for r in range(m)]
                if any(p.tp is None for p in parts):
                    raise AssertionError(f"K3 level {level}: the FF did not split over {m}")
                before = _read_launches()["geglu_ff"]
                total = sum(p(x, ln=ln, residual=True).float() for p in parts)
                launched = _read_launches()["geglu_ff"] - before
                counts["geglu_ff"] += launched
                if launched != m:
                    raise AssertionError(f"K3 split {m} at level {level}: {launched} launches")
                ms = _time_ms(lambda: parts[1](x, ln=ln, residual=True), reps=3)
                errs.append(_compare(
                    f"K3 split over model={m}, level {level} ({n}, {c}), inner {4 * c // m} a "
                    f"rank ({ms:.3f} ms a rank), summed", total, whole, TOL["bf16"]))
            del ff, parts, x, whole, total

        q, k, v = (randn(250, 9216, 64, dtype=bf16) for _ in range(3))
        whole = flash_attention(q, k, v)
        for m in MESH_FLASH_SPLITS:
            before = _read_launches()["flash_attention"]
            rows = [_flash_rows(q, k, v, m, i) for i in range(m)]
            counts["flash_attention"] += _read_launches()["flash_attention"] - before
            ms = _time_ms(lambda: _flash_rows(q, k, v, m, 0), reps=3)
            errs.append(_compare(f"K1 over {m} ranks, {rows[0].shape[0]} of 250 rows a rank "
                                 f"({ms:.3f} ms a rank), gathered",
                                 torch.cat(rows)[:250], whole, TOL["bf16"]))
            del rows
        s = MESH_RING_SEQ
        blk = 9216 // s
        kb = [k[:, j * blk:(j + 1) * blk] for j in range(s)]
        vb = [v[:, j * blk:(j + 1) * blk] for j in range(s)]
        outs = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for r in range(s):
            state = ring_start(q[:, r * blk:(r + 1) * blk])
            for j in range(s):
                state = ring_fold(state, kb[(r - j) % s], vb[(r - j) % s])
            outs.append(ring_finish(state, q.dtype))
        torch.cuda.synchronize()
        ring_s = time.perf_counter() - t0
        errs.append(_compare(f"ring attention over seq={s} at (250, 9216, 64), {s} blocks of "
                             f"{blk} tokens a rank ({ring_s / s * 1e3:.1f} ms a rank), against "
                             f"the unsplit K1", torch.cat(outs, dim=1), whole, TOL["bf16"]))
    print(f"  split launches (comparisons, not counted as the path's): {counts}; worst "
          f"max_abs_err {max(errs):.3e}", flush=True)
    return counts


def _mesh_split_grads() -> None:
    """The split kernels' backward at full width, one simulated rank after
    another: each rank's gradient of a replicated input is its partial one
    (K3: of x and the LN affine, through ``copy_to_model``; K1: of its own
    q/k/v rows, ``_flash_rows``), and the ranks' sum must be the unsplit
    Function's gradient, as the all-reduce of ``copy_to`` makes it on a
    real mesh."""
    import copy

    import torch
    import torch.nn.functional as F

    from streamingt2v_torch.models.layers import init_random_
    from streamingt2v_torch.models.unet_blocks import FeedForward
    from streamingt2v_torch.ops.attention import _flash_rows
    from streamingt2v_torch.parallel.sharding import shard_params

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    randn, gen = _randn_factory(9)
    errs = []

    def timed_grads(fn, inputs, g):
        """The gradients of ``fn(*inputs)`` against ``g`` to fresh copies of
        ``inputs`` in f32, and the seconds of forward + backward."""
        xs = [t.detach().clone().requires_grad_(True) for t in inputs]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(*xs).backward(g)
        torch.cuda.synchronize()
        return [t.grad.float() for t in xs], time.perf_counter() - t0

    for level, (n, c) in enumerate(K3_LEVELS):
        ff = init_random_(FeedForward(c, c, device=dev, dtype=bf16), gen)
        inputs = (randn(n, c, dtype=bf16), 1.0 + randn(c, dtype=torch.float32, std=0.1),
                  randn(c, dtype=torch.float32, std=0.1))
        g = randn(n, c, dtype=bf16)
        whole, _ = timed_grads(lambda x, s, b: ff(x, ln=(s, b), residual=True), inputs, g)
        for m in MESH_K3_SPLITS:
            parts = [shard_params(torch.nn.ModuleDict({"ff": copy.deepcopy(ff)}),
                                  _sim_rank(m, r))["ff"] for r in range(m)]
            ranks = [timed_grads(lambda x, s, b, p=p: p(x, ln=(s, b), residual=True), inputs, g)
                     for p in parts]
            for i, what in enumerate(("x", "LN scale", "LN bias")):
                errs.append(_compare(
                    f"K3 backward split over model={m}, level {level} ({n}, {c}) "
                    f"({ranks[1][1] * 1e3:.1f} ms forward+backward a rank): d{what} summed "
                    f"over the ranks", sum(r[0][i] for r in ranks), whole[i], TOL["bf16"]))
            del parts, ranks
        del ff, inputs, g, whole

    rows = 250
    inputs = tuple(randn(rows, 9216, 64, dtype=bf16) for _ in range(3))
    g = randn(rows, 9216, 64, dtype=bf16)
    whole, _ = timed_grads(lambda q, k, v: _flash_rows(q, k, v, 1, 0), inputs, g)
    for m in MESH_FLASH_SPLITS:
        gp = F.pad(g, (0, 0, 0, 0, 0, (-rows) % m))
        per = gp.shape[0] // m
        ranks = [timed_grads(lambda q, k, v, i=i: _flash_rows(q, k, v, m, i), inputs,
                             gp[i * per:(i + 1) * per]) for i in range(m)]
        for i, what in enumerate("qkv"):
            errs.append(_compare(
                f"K1 backward over {m} ranks, {per} of {rows} rows a rank "
                f"({ranks[0][1] * 1e3:.1f} ms forward+backward a rank): d{what} summed over "
                f"the ranks", sum(r[0][i] for r in ranks), whole[i], TOL["bf16"]))
        del ranks
    print(f"  split backward: worst max_abs_err {max(errs):.3e}", flush=True)


def _mesh_losses() -> None:
    """The training losses (``diffusion/lpips.py``, ``gan_loss.py``,
    ``regularizers.py``, ``models/vfi_loss.py``; plain torch ops) on the card
    against the CPU at a small size, then forward + backward timed at full
    size: LPIPS and the discriminator on 25 frames at 576x1024, the VFI
    losses on 720p pairs."""
    import torch

    from streamingt2v_torch.diffusion.gan_loss import PatchDiscriminator, hinge_d_loss
    from streamingt2v_torch.diffusion.lpips import LPIPS
    from streamingt2v_torch.diffusion.regularizers import VectorQuantizer, diagonal_gaussian
    from streamingt2v_torch.models.layers import init_random_
    from streamingt2v_torch.models.vfi_loss import lap_loss, ternary_loss

    dev = torch.device("cuda")
    _release_earlier_phases()
    gen = torch.Generator().manual_seed(11)
    lpips = init_random_(LPIPS(), gen)
    disc = init_random_(PatchDiscriminator(), gen)
    vq = init_random_(VectorQuantizer(512, 4), gen)

    def small(fn, *inputs):
        """fn's value and its gradients to the inputs on each device."""
        res = []
        for d in ("cpu", "cuda"):
            xs = [x.detach().to(d).clone().requires_grad_(True) for x in inputs]
            val = fn(d, *xs)
            val.backward()
            res.append((val.detach().cpu(), [x.grad.cpu() for x in xs]))
        return res

    img = lambda *s: torch.rand(s, generator=gen) * 2 - 1   # noqa: E731
    cases = {
        "lpips": (lambda d, x, y: lpips.to(d)(x, y).sum(), img(2, 3, 64, 64), img(2, 3, 64, 64)),
        "discriminator + hinge": (lambda d, x, y: hinge_d_loss(disc.to(d)(x), disc.to(d)(y)),
                                  img(2, 3, 64, 64), img(2, 3, 64, 64)),
        "lap_loss": (lambda d, x, y: lap_loss(x, y), img(2, 3, 64, 64), img(2, 3, 64, 64)),
        "ternary_loss": (lambda d, x, y: ternary_loss(x, y).sum(), img(2, 3, 64, 64),
                         img(2, 3, 64, 64)),
        "diagonal_gaussian": (lambda d, m, e: sum(v.sum() for v in (
            diagonal_gaussian(m, noise=e)[0], diagonal_gaussian(m, noise=e)[1]["kl_loss"])),
                              img(2, 8, 8, 8), img(2, 8, 8, 4)),
        "vector quantizer": (lambda d, z: (lambda o: o[0].sum() + o[1]["vq_loss"])(
            vq.to(d)(z)), img(2, 8, 8, 4) * 0.02),
    }
    for name, (fn, *inputs) in cases.items():
        (vc, gc), (vg, gg) = small(fn, *inputs)
        _compare(f"{name} on the card against the CPU", vg, vc, LOSS_TOL)
        for i, (a, b) in enumerate(zip(gg, gc)):
            _compare(f"{name} d input {i}", a, b, LOSS_TOL)

    def timed(name, fn, shapes, grads, params=None):
        """fn's forward + backward at ``shapes``, gradients to the inputs
        marked in ``grads`` (and to ``params``' parameters)."""
        xs = [(torch.rand(s, device=dev) * 2 - 1).requires_grad_(g) for s, g in zip(shapes, grads)]
        if params is not None:
            params.requires_grad_(True)
        fn(*xs).backward()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        val = fn(*xs)
        val.backward()
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        got = [x.grad for x in xs if x.requires_grad]
        got += [] if params is None else [p.grad for p in params.parameters()]
        if not (torch.isfinite(val) and all(torch.isfinite(g).all() for g in got)):
            raise AssertionError(f"{name}: non-finite loss or gradient")
        print(f"  {name}: forward + backward {sec:.3f} s, peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
        if params is not None:
            params.requires_grad_(False)

    lp, ds = lpips.to(dev), disc.to(dev)
    frames = (MESH_LOSS_FRAMES, 3, 576, 1024)
    timed(f"LPIPS on {MESH_LOSS_FRAMES} frames at 576x1024 (f32; gradient to the "
          f"reconstruction)", lambda x, y: lp(x, y).sum(), (frames, frames), (True, False))
    timed(f"discriminator + hinge on {MESH_LOSS_FRAMES} real and {MESH_LOSS_FRAMES} fake frames "
          f"at 576x1024 (f32; gradient to its parameters)",
          lambda x, y: hinge_d_loss(ds(x), ds(y)), (frames, frames), (False, False), ds)
    pairs = (MESH_VFI_PAIRS, 3, 720, 1280)
    timed(f"lap_loss ({MESH_VFI_LEVELS} levels) + ternary_loss on {MESH_VFI_PAIRS} 720p pairs "
          f"(gradient to the prediction)",
          lambda x, y: lap_loss(x, y, MESH_VFI_LEVELS) + ternary_loss(x, y).mean(),
          (pairs, pairs), (True, False))
    del lp, ds, lpips, disc, vq


def _stage_digests(pipe) -> dict:
    """Wrap the product's three stage methods so that each records the
    SHA-256 of its uint8 output in the returned dict (by method name)."""
    import hashlib

    digests = {}

    def recorded(name, fn):
        def wrapper(*a, **k):
            out = fn(*a, **k)
            digests[name] = hashlib.sha256(out.tobytes()).hexdigest()
            return out
        return wrapper

    for name in ("image_to_video", "enhance_video", "interpolate_video"):
        setattr(pipe, name, recorded(name, getattr(pipe, name)))
    return digests


def _mesh_token_split_grads(rows: int = TRAIN_RING_ROWS, length: int = 9216) -> None:
    """The token split under grad at the training shape (125, 9216, 64)
    bf16, stage 1's level-0 spatial self-attention at batch 1 x 25 frames x
    5 heads, over simulated seq = 2 and 4, one rank after another, against
    K1's Function backward on the whole call (``flash_attention_backward``):
    the ring's backward through its per-hop functions (the forward's
    log-sum-exp from ``ring_fold``/``ring_lse``, then ``ring_bwd_fold`` at
    every hop: each rank's dq, each owner's dk/dv summed in the order its
    accumulator travels), and the gathered path (each rank's q block through
    K1's Function against the whole k/v, the ranks' dk/dv summed as the
    reduce-scatter sums them)."""
    import torch

    from streamingt2v_torch.ops.flash_attention import (
        backward_chunk_rows, flash_attention, flash_attention_backward)
    from streamingt2v_torch.parallel.ring_attention import (
        ring_bwd_fold, ring_delta, ring_finish, ring_fold, ring_lse, ring_start)

    bf16, f32 = torch.bfloat16, torch.float32
    randn, _ = _randn_factory(13)
    q, k, v, g = (randn(rows, length, 64, dtype=bf16) for _ in range(4))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    whole = flash_attention_backward(q, k, v, g)
    torch.cuda.synchronize()
    print(f"  K1's Function backward on the whole ({rows}, {length}, 64) bf16: "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms, {whole[3]} chunks", flush=True)
    errs = []
    for n in MESH_RING_GRAD_SEQS:
        blk = length // n
        qb, kb, vb, gb = ([x[:, j * blk:(j + 1) * blk].contiguous() for j in range(n)]
                          for x in (q, k, v, g))
        fwd = []
        for r in range(n):
            state = ring_start(qb[r])
            for j in range(n):
                state = ring_fold(state, kb[(r - j) % n], vb[(r - j) % n])
            fwd.append((ring_lse(state), ring_delta(ring_finish(state, bf16), gb[r])))
        dq = [torch.zeros(qb[r].shape, dtype=f32, device=q.device) for r in range(n)]
        dk, dv, rank_s = [None] * n, [None] * n, [0.0] * n
        for j in range(n):          # hop j: rank r holds block (r - j) % n
            for r in range(n):
                b = (r - j) % n
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                dq_p, dk_p, dv_p = ring_bwd_fold(qb[r], kb[b], vb[b], gb[r], *fwd[r])
                dq[r] += dq_p
                if j:
                    dk_p += dk[b]
                    dv_p += dv[b]
                dk[b], dv[b] = dk_p, dv_p
                torch.cuda.synchronize()
                rank_s[r] += time.perf_counter() - t0
        chunks = n * -(-rows // backward_chunk_rows(blk, blk))
        label = (f"ring backward over seq={n} at ({rows}, {length}, 64), {blk} tokens a rank "
                 f"({sum(rank_s) / n * 1e3:.1f} ms a rank, {chunks} chunks a rank)")
        for name, got, want in zip("qkv", (dq, dk, dv), whole):
            errs.append(_compare(f"{label}: d{name} against K1's Function backward",
                                 torch.cat([x.to(bf16) for x in got], dim=1), want,
                                 TOL["bf16"]))
        del fwd, dq, dk, dv

        dqs, dk_sum, dv_sum, rank_s = [], 0, 0, []
        for r in range(n):
            qr, kw, vw = (x.detach().clone().requires_grad_(True) for x in (qb[r], k, v))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            flash_attention(qr, kw, vw).backward(gb[r])
            torch.cuda.synchronize()
            rank_s.append(time.perf_counter() - t0)
            dqs.append(qr.grad)
            dk_sum = dk_sum + kw.grad.float()
            dv_sum = dv_sum + vw.grad.float()
        label = (f"gathered path over seq={n}: a rank's {blk} queries through K1 against the "
                 f"whole k/v ({sum(rank_s) / n * 1e3:.1f} ms forward + backward a rank)")
        for name, got, want in zip("qkv", (torch.cat(dqs, dim=1), dk_sum, dv_sum), whole):
            errs.append(_compare(f"{label}: d{name}" + (" summed over the ranks" if name != "q"
                                                        else ""), got, want, TOL["bf16"]))
        del qb, kb, vb, gb, dqs, dk_sum, dv_sum
    print(f"  token split under grad: worst max_abs_err {max(errs):.3e}", flush=True)


def _mesh_examples() -> None:
    """The port's two single-process examples (``examples/torch/``) on the
    card at their tiny widths: the three-stage product to a y4m file, and
    every sampler x discretization x guider on one denoiser."""
    import contextlib
    import io
    import os
    import tempfile

    from streamingt2v_torch.utils import media

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples", "torch")

    def example(name):
        spec = importlib.util.spec_from_file_location(name, os.path.join(root, name + ".py"))
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module

    with tempfile.TemporaryDirectory(prefix="st2v_examples_") as tmp:
        path = os.path.join(tmp, "tiny.y4m")
        t0 = time.perf_counter()
        example("tiny_image_to_video").main(["--device", "cuda", "--output", path])
        info = media.y4m_info(path)
        print(f"  examples/torch/tiny_image_to_video.py on the card: "
              f"{time.perf_counter() - t0:.1f} s, {info}", flush=True)
        if info["frames"] < 2 or (info["width"], info["height"]) != (32, 32):
            raise AssertionError(f"tiny_image_to_video wrote {info}")
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        example("custom_schedule").main(["--device", "cuda"])
    lines = [ln for ln in log.getvalue().splitlines() if "->" in ln]
    print(f"  examples/torch/custom_schedule.py on the card: {time.perf_counter() - t0:.1f} s, "
          f"{len(lines)} sampler x discretization x guider runs, "
          f"{sum('finite=True' in ln for ln in lines)} finite", flush=True)
    if len(lines) != 72 or not all("finite=True" in ln for ln in lines):
        raise AssertionError("custom_schedule: " + log.getvalue()[-2000:])


def run_mesh(enhance_steps: int) -> dict:
    """Phase 13: the multi-device layer on the one card.  The CLI's product
    under ``--mesh 1,1,1`` (a world of one rank, NCCL) at the loader phase's
    cut, its file byte-equal to the same CLI's without ``--mesh``; stage 2's
    data-parallel step and a training step under that mesh at full width;
    stage 3 twice with every module's output compared
    (``_stage3_determinism``); each simulated rank's share of the split
    kernels, forward and under grad, and of the ring's backward and the
    gathered path's; the training losses; the single-process examples."""
    import os
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist
    from PIL import Image

    from streamingt2v_torch.config import PipelineConfig
    from streamingt2v_torch.utils import media
    from streamingt2v_torch.utils.profiling import reset_timers, stage_seconds

    _release_earlier_phases()
    cfg = PipelineConfig()
    files, digests, launches, mesh = {}, {}, None, None
    with tempfile.TemporaryDirectory(prefix="st2v_mesh_") as tmp:
        image = ((_smooth_image(cfg.height, cfg.width, seed=8).numpy() + 1.0) * 127.5).round()
        png = os.path.join(tmp, "input.png")
        Image.fromarray(image.clip(0, 255).astype(np.uint8)).save(png)
        for name, use_mesh in (("mesh", True), ("plain", False)):
            out_dir = os.path.join(tmp, name)
            reset_timers()
            t0 = time.perf_counter()
            args, pipe = _mesh_cli(png, out_dir, enhance_steps, use_mesh)
            if use_mesh:
                mesh = pipe.stage1.mesh
                if (mesh is None or not dist.is_initialized() or dist.get_world_size() != 1
                        or dist.get_backend() != "nccl" or pipe.enhance.mesh is not mesh):
                    raise AssertionError(f"--mesh 1,1,1 did not form a world of one NCCL rank: "
                                         f"{mesh}")
                _reset_launches()
            os.makedirs(out_dir)
            path = os.path.join(out_dir, "input.y4m")
            recorded = _stage_digests(pipe)
            frames = pipe.run(png, path, seed=args.seed)
            digests[name] = dict(recorded)
            if use_mesh:
                launches = _read_launches(f32=True)
            total = time.perf_counter() - t0
            stages = {k: round(v, 3) for k, v in stage_seconds().items()}
            print(f"  CLI {'--mesh 1,1,1 (NCCL, world of 1)' if use_mesh else 'without --mesh'}: "
                  f"{LOADER_FRAMES} frames, sampler steps {LOADER_SAMPLER_STEPS} + "
                  f"{LOADER_SAMPLER_STEPS}, {enhance_steps} DDIM steps; {total:.1f} s with the "
                  f"build; stages {stages}; stage_finite {pipe.stage_finite}; file "
                  f"{media.y4m_info(path)}", flush=True)
            if pipe.stage_finite != {"stage1": True, "enhance": True, "vfi": True}:
                raise AssertionError(f"a stage gave non-finite values: {pipe.stage_finite}")
            if use_mesh:
                print(f"  the mesh run's launches: {launches}", flush=True)
                _check_product_launches(pipe.cfg, launches, "the CLI under --mesh 1,1,1")
            with open(path, "rb") as f:
                files[name] = f.read()
            if not use_mesh:
                _stage3_determinism(pipe, frames[::2])
            del pipe, frames
            _release_earlier_phases()
    if files["mesh"] != files["plain"]:
        a, b = (np.frombuffer(files[k], np.uint8) for k in ("mesh", "plain"))
        diff = int(np.abs(a.astype(int) - b.astype(int)).max()) if a.shape == b.shape else None
        stages = [k for k in digests["mesh"] if digests["mesh"][k] != digests["plain"][k]]
        raise AssertionError(f"the --mesh 1,1,1 file differs from the plain run's (max byte "
                             f"difference {diff}; stages whose output differs: {stages})")
    print(f"  the two files are byte-equal ({len(files['mesh'])} bytes)", flush=True)
    try:
        _mesh_dp_step(mesh)
        _mesh_train_step(mesh)
    finally:
        dist.destroy_process_group()
    _mesh_splits()
    _mesh_split_grads()
    _mesh_token_split_grads()
    _mesh_losses()
    _mesh_examples()
    return launches


KERNEL_META = {
    "flash_attention": ("streamingt2v_torch/csrc/flash_attention.cu",
                        "streamingt2v_tpu/ops/flash_attention.py:38"),
    "flash_attention_packed": ("streamingt2v_torch/csrc/flash_attention.cu",
                               "streamingt2v_tpu/ops/flash_attention.py:201"),
    # the D=512 instances (the VAE mid-block attention), counted apart
    "flash_attention_d512": ("streamingt2v_torch/csrc/flash_attention.cu",
                             "streamingt2v_tpu/ops/flash_attention.py:38"),
    "flash_attention_packed_d512": ("streamingt2v_torch/csrc/flash_attention.cu",
                                    "streamingt2v_tpu/ops/flash_attention.py:201"),
    "geglu_ff": ("streamingt2v_torch/csrc/geglu_ff.cu", "streamingt2v_tpu/ops/fused_ff.py:65"),
    "temporal_conv": ("streamingt2v_torch/csrc/temporal_conv.cu",
                      "streamingt2v_tpu/ops/temporal_conv.py:49"),
    "fused_group_norm": ("streamingt2v_torch/csrc/fused_group_norm.cu",
                         "streamingt2v_tpu/ops/fused_group_norm.py:30"),
    "fused_temporal_attention": ("streamingt2v_torch/csrc/temporal_attention.cu",
                                 "streamingt2v_tpu/ops/temporal_attention.py:43"),
    # K5's statistics alone, for K4's prologue: the JAX package computes them
    # in XLA (``group_norm_affine`` through ``_group_stats_bf16``), no Pallas
    "fused_group_norm_affine": ("streamingt2v_torch/csrc/fused_group_norm.cu",
                                "streamingt2v_tpu/ops/norms.py:29"),
}


# the rows whose wrappers count their f32 launches apart (``launches_f32``)
F32_COUNTED = ("flash_attention_f32", "flash_attention_packed_f32", "temporal_conv_f32",
               "fused_temporal_attention_f32", "fused_group_norm_affine_f32")


def run_cogvideox() -> dict:
    """Phase 15: one guided step of CogVideoX-5B at the published widths."""
    import torch

    from streamingt2v_torch.config import CogVideoXConfig
    from streamingt2v_torch.ops.routing import use_routing
    from streamingt2v_torch.pipeline.build import build_cogvideox

    dev = torch.device("cuda")
    _release_earlier_phases()
    cfg = CogVideoXConfig()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pipe = build_cogvideox(cfg, seed=0, device=dev, bf16=True)
    torch.cuda.synchronize()
    print(f"  build_cogvideox: {time.perf_counter() - t0:.1f} s, resident weights "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
    g = torch.Generator(dev).manual_seed(0)
    text = (1, cfg.max_text_seq_length, cfg.text_embed_dim)
    noise = torch.randn(cfg.latent_shape(1), generator=g, device=dev)
    prompt, negative = (torch.randn(text, generator=g, device=dev) for _ in range(2))
    t = pipe.timesteps()[0]
    _reset_launches()
    t0 = time.perf_counter()
    with torch.inference_mode(), use_routing(cfg.routing):
        out = pipe.denoise_step(noise, 0, t, prompt, negative)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    launches = _read_launches(f32=True)
    peak = torch.cuda.max_memory_allocated()
    print(f"  one guided step at t={t} (cold): {step_s:.2f} s; peak memory "
          f"{peak / 2**30:.2f} GiB; launches {launches}", flush=True)
    if tuple(out.shape) != cfg.latent_shape(1) or out.dtype != torch.float32:
        raise AssertionError(f"latents {tuple(out.shape)} {out.dtype}")
    if not torch.isfinite(out).all():
        raise AssertionError("CogVideoX's step left non-finite latents")
    moved = ((out - noise).norm() / noise.norm()).item()
    if not moved > 0:
        raise AssertionError("CogVideoX's step left the latents as they were")
    want = dict.fromkeys(launches, 0)
    want["flash_attention"] = cfg.num_layers
    if launches != want:
        raise AssertionError(f"launches {launches}, want K1 once a block and nothing else")
    print(f"  latents {tuple(out.shape)} finite, moved {moved:.4f} of the noise", flush=True)
    return launches


def kernel_lines(records: dict, launches: dict, product_launches: dict,
                 phase_launches: Optional[dict] = None) -> list:
    """The kernels JSON line's entries: one per KERNEL_META row, with the
    kernels and reference phases' records (absent keys null), the launches of every
    pipeline phase, the product's alone and, as ``<phase>_launches``, those
    of each phase in ``phase_launches`` ({phase: {kernel: launches}}); K1, K2,
    K4, K6 and K5's affine entry also their f32 launches over every pipeline
    phase (``launches_f32``, from ``launches["<name>_f32"]``)."""
    kernels = []
    for name, (source, replaces) in KERNEL_META.items():
        r = records.get(name, {})
        extra = {k: v for k, v in r.items()
                 if k in ("bare_ms", "bare_share", "sdpa_backend", "k1_ms")
                 or k in ("bwd_max_abs_err", "bwd_shape")
                 or k.startswith(("ms_level", "share_level", "scratch_mb", "vae_", "b4_",
                                  "stage2_", "cross_", "t38_", "f32_", "bf16_d"))}
        if "stage1" in r:   # K6 at the stage-1 geometry
            extra.update({f"stage1_{k}": r["stage1"][k] for k in ("ms", "library_ms", "share")})
        if name + "_f32" in F32_COUNTED:
            extra["launches_f32"] = launches.get(name + "_f32", 0)
        kernels.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                            launches=launches[name], max_abs_err=r.get("max_abs_err"),
                            ms=r.get("ms"), plain_ms=r.get("plain_ms"),
                            bound_ms=r.get("bound_ms"), bound_by=r.get("bound_by"),
                            library_ms=r.get("library_ms"), share=r.get("share"),
                            bwd_ms=r.get("bwd_ms"), bwd_chunks=r.get("bwd_chunks"),
                            product_launches=product_launches[name],
                            **{f"{p}_launches": n[name]
                               for p, n in (phase_launches or {}).items()},
                            **extra))
    return kernels


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--phases", default=",".join(ALL_PHASES),
                        help="comma-separated subset of " + ",".join(ALL_PHASES))
    parser.add_argument("--first-steps", type=int, default=FIRST_CHUNK_STEPS,
                        help="first-chunk sampler steps in the slice phase")
    parser.add_argument("--ar-steps", type=int, default=AR_STEPS,
                        help="autoregressive sampler steps in the slice phase")
    parser.add_argument("--enhance-steps", type=int, default=ENHANCE_STEPS,
                        help="DDIM steps in the enhance and product phases (before the "
                             "strength cut)")
    parser.add_argument("--product-frames", type=int, default=PRODUCT_FRAMES,
                        help="frames of the product phase's video (the product: 200)")
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
        from streamingt2v_torch import native
        from streamingt2v_torch.ops import _native
    except ImportError:
        print("chip_smoke: run from the root of a repository checkout", file=sys.stderr)
        return 2

    # f32 comparisons must be full f32, and the library yardsticks (conv3d,
    # group_norm, SDPA) are timed under the same flags: no TF32 in cuDNN
    # convs or matmuls, for the whole run.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    card = _card_line()
    print(f"card: {card}", flush=True)
    print(f"phase card: torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}", flush=True)
    found = {m: importlib.util.find_spec(m) is not None for m in ("cv2", "PIL")}
    print(f"  installed here: OpenCV {found['cv2']}, Pillow {found['PIL']}", flush=True)

    t0 = time.perf_counter()
    path, build_s, log = _native.build()
    _native.library()
    print(f"phase build: {build_s:.1f} s nvcc ({time.perf_counter() - t0:.1f} s with load) "
          f"-> {path.name}", flush=True)
    t0 = time.perf_counter()
    feeder = native.build()     # raises if g++ fails: the product phases write through it
    native.load_library()
    print(f"  y4m feeder: g++ -> {feeder.parent.name}/{feeder.name} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    ptxas = _ptxas_summary(log)
    for line in ptxas:
        print("  ptxas: " + line, flush=True)
    check_wgmma_notes(ptxas)

    records = {}
    if "kernels" in phases:
        t0 = time.perf_counter()
        records = check_kernels()
        print(f"phase kernels: ok ({time.perf_counter() - t0:.1f} s)", flush=True)
    if "reference" in phases:
        t0 = time.perf_counter()
        check_reference()
        check_apm_reference()
        check_sampler_references()
        check_enhance_reference()
        check_vfi_reference()
        for name, rec in check_backward().items():
            records.setdefault(name, {}).update(rec)
        check_train_reference()
        print(f"phase reference: ok ({time.perf_counter() - t0:.1f} s)", flush=True)
    launches = dict.fromkeys(KERNEL_META, 0)
    phase_launches = {p: dict.fromkeys(KERNEL_META, 0)
                      for p in ("product", "bench", "apm", "samplers", "train", "mesh",
                                "cogvideox")}
    runs = [("slice", lambda: run_slice(args.first_steps, args.ar_steps)),
            ("bench", run_bench),
            ("apm", lambda: run_apm(APM_STEPS)),
            ("samplers", lambda: run_samplers(SAMPLER_STEPS)),
            ("train", lambda: run_train(TRAIN_STEPS)),
            ("enhance", lambda: run_enhance(args.enhance_steps)),
            ("interpolate", lambda: run_interpolate() or {}),
            ("product", lambda: run_product(args.enhance_steps, args.product_frames)),
            ("loader", lambda: run_loader(args.enhance_steps, LOADER_FRAMES,
                                          LOADER_SAMPLER_STEPS, LOADER_SAMPLER_STEPS)),
            ("mesh", lambda: run_mesh(args.enhance_steps)),
            ("cogvideox", run_cogvideox)]
    for phase, run in runs:
        if phase not in phases:
            continue
        t0 = time.perf_counter()
        counts = run()
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n
        if phase in phase_launches:
            phase_launches[phase] = counts
        print(f"phase {phase}: ok ({time.perf_counter() - t0:.1f} s)", flush=True)

    product = phase_launches.pop("product")
    print(json.dumps({"kernels": kernel_lines(records, launches, product, phase_launches)}),
          flush=True)
    if phases != set(ALL_PHASES) or (args.first_steps, args.ar_steps, args.enhance_steps,
                                     args.product_frames) != (
            FIRST_CHUNK_STEPS, AR_STEPS, ENHANCE_STEPS, PRODUCT_FRAMES):
        print("chip_smoke: not the default run; no result", file=sys.stderr)
        return 3
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
