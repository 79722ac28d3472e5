"""The port's bench: the five BASELINE.md configs on one GPU (counterpart of
the JAX package's ``bench.py``).

    python -m streamingt2v_torch.bench --mode {denoise,vae,stage1,enhance,full}

Each mode prints ONE metric line as its last stdout line:
  {"metric": "...", "value": N, "unit": "...", "vs_baseline": N,
   "peak_hbm_gb": N, "device": "<name>, <power limit>", ...}
with the timed calls' seconds, their median and spread, and the kernels'
launches in the timed calls beside it; the same seconds, median, spread
((max - min) / median) and launches are logged on stderr.

  denoise  (#2, default) one guided StreamingSVD denoise step at the
           production geometry: B=2 (CFG), 25 frames of 72x128 latents, 7
           ControlNet frames; three chained steps a timed call
  vae      (#1) temporal-VAE round trip of a 16-frame 576x1024 chunk (f32):
           encode in 8-frame pieces, temporal decode in 4-frame pieces
  stage1   (#3) stage 1 for the 200-frame product (100 frames: the first
           chunk, five streaming chunks, conditioning and decode included)
  enhance  (#4) I2VGen-XL enhancement of 64 frames at 720p, randomized
           blending (two 38-frame chunks, overlap 12)
  full     (#5) the product: one image -> stage 1 -> enhance -> VFI 2x ->
           y4m, three passes (seed 33, seed 33 again: bitwise equal, seed
           34: different), MAWE on the first pass's frames

vs_baseline: the reference publishes no throughput (SURVEY.md §6); the
baselines are the JAX bench's estimated A100 fp16 figures for the same
computation (BASELINE.md).

Timing: the device is synchronised before and after each timed call and
the host's wall clock read around it; one warm-up call first, never timed
(the kernels build at their first use inside it).  Weights are random from
seed 0 (no checkpoint is needed) and inputs come from
``np.random.RandomState(0)``, as in the JAX bench.

Each mode is a function whose arguments default to the card and the
production configs; without a card it raises.  The tests call the same
functions on the CPU with tiny configs.  ``denoise`` first replays the
other modes' recorded results (``docs/bench_records_torch.json``) marked
``"recorded": true``, flagged ``code_changed_since_record`` where the
port's sources changed since; its live metric stays the last line.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from streamingt2v_torch.config import (
    ControlNetConfig,
    EnhanceConfig,
    PipelineConfig,
    VAEConfig,
    VideoUNetConfig,
)
from streamingt2v_torch.diffusion.denoiser import denoise
from streamingt2v_torch.models.controlnet import ControlNet
from streamingt2v_torch.models.layers import init_random_
from streamingt2v_torch.models.vae import AutoencoderKL
from streamingt2v_torch.models.video_unet import VideoUNet
from streamingt2v_torch.models.wrappers import streaming_wrapper
from streamingt2v_torch.ops.routing import use_routing
from streamingt2v_torch.pipeline.build import (
    _device,
    build_enhance,
    build_pipeline,
    build_product,
)
from streamingt2v_torch.pipeline.full import StreamingT2VPipeline
from streamingt2v_torch.utils.metrics import mawe_chunked, vfi_flow_fn
from streamingt2v_torch.utils.profiling import (
    read_launches,
    reset_launches,
    reset_timers,
    stage_seconds,
)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECORDS_PATH = os.path.join(REPO_ROOT, "docs", "bench_records_torch.json")
# the full mode's videos: gitignored, about 0.25 GB a 180-frame 720p file
OUT_DIR = os.path.join(REPO_ROOT, "chiprun_out", "bench")

STEPS_PER_CHUNK = 30  # config.yaml:150
CHAINED_STEPS = 3     # denoise steps a timed call
TIMED_CALLS = 5       # denoise and vae
ENCODE_FRAMES, DECODE_FRAMES = 8, 4   # the vae mode's pieces
SEEDS = (33, 34)      # stage1 and full: warm-up / first pass, other seed

# Estimated A100 fp16 reference throughputs (frames/s) per config: the JAX
# bench's constants (BASELINE.md).
BASELINES = {
    # 25-frame SVD-XT+ControlNet forward x 30 EDM steps ~= 60 s/chunk.
    "denoise": 0.42,
    # SD-VAE encode+temporal decode, ~40ms+90ms per 576x1024 frame.
    "vae": 7.7,
    # stage-1 = first chunk (25 steps) + ceil((100-25)/18)=5 AR chunks:
    # ~6 chunks x ~60s -> 100 frames / 360s.
    "stage1": 0.28,
    # I2VGen-XL 720p: 30 DDIM steps x CFG-doubled 38-frame UNet ~= 110s
    # per chunk on A100 -> 0.35 frames/s.
    "enhance": 0.35,
    # full pipeline: ~8 min for 200 frames at 720p24 on A100 (~0.4 f/s).
    "full": 0.4,
}

# single-chip stage 1: the reference's use_memopt decode chunk of 4
# (streaming_svd.py:127), as the JAX bench builds it
STAGE1_CFG = dataclasses.replace(PipelineConfig(num_frames=200), inference=dataclasses.replace(
    PipelineConfig().inference, decode_chunk_size=4))
FULL_CFG = PipelineConfig(num_frames=200, use_randomized_blending=True)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _start(device: torch.device) -> None:
    """The mode's start: its peak memory is counted from here."""
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def card_line(device: torch.device) -> str:
    """``nvidia-smi``'s name and power limit of the card, or ``"cpu"``."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[device.index or 0]


def timed_calls(fn: Callable[[int], object], calls: int, device: torch.device,
                what: str) -> dict:
    """Seconds of ``fn(i)`` for i < calls, each between two device
    synchronisations, with their median and spread, logged on stderr."""
    seconds = []
    for i in range(calls):
        _sync(device)
        t0 = time.perf_counter()
        fn(i)
        _sync(device)
        seconds.append(time.perf_counter() - t0)
    median = statistics.median(seconds)
    spread = (max(seconds) - min(seconds)) / median
    log(f"{what}: timed calls " + " ".join(f"{s:.3f}" for s in seconds)
        + f" s; median {median:.3f} s; spread {spread:.2%}")
    return {"seconds": [round(s, 4) for s in seconds], "median_s": round(median, 4),
            "spread": round(spread, 4)}


def _launches(what: str) -> dict:
    counts = read_launches(f32=True)
    log(f"{what}: kernel launches {json.dumps(counts)}")
    return counts


# ---------------------------------------------------------------- records ---

def src_hash() -> str:
    """Hash of the port's sources (``streamingt2v_torch/**/*.{py,cu,cuh}``),
    stamped into each record: a replayed record whose code changed since it
    was measured is flagged (documentation commits do not invalidate)."""
    root = os.path.dirname(os.path.abspath(__file__))
    h = hashlib.sha256()
    paths = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames if d not in ("__pycache__", "_build"))
        paths.extend(os.path.join(dirpath, f) for f in filenames
                     if f.endswith((".py", ".cu", ".cuh")))
    for p in sorted(paths):
        h.update(os.path.relpath(p, root).encode())
        with open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:12]


def _record(rec: dict, path: str) -> None:
    """Keep the latest result per metric in ``path``, so that the default
    mode can replay every config's recorded number."""
    try:
        recs = {}
        if os.path.exists(path):
            with open(path) as f:
                recs = json.load(f)
        rec["recorded_at"] = time.strftime("%Y-%m-%d")
        rec["src"] = src_hash()
        recs[rec["metric"]] = rec
        with open(path, "w") as f:
            json.dump(recs, f, indent=1, sort_keys=True)
            f.write("\n")
    except (OSError, ValueError) as e:   # recording never fails the bench
        log(f"record skip: {e}")


def replay_records(exclude: str, path: str) -> None:
    """Print the recorded results of ``path`` but ``exclude``, one JSON line
    each, marked ``"recorded": true``."""
    try:
        with open(path) as f:
            recs = json.load(f)
    except (OSError, ValueError):
        return
    cur = src_hash()
    for metric in sorted(recs):
        if metric == exclude:
            continue
        rec = dict(recs[metric])
        rec["recorded"] = True
        if rec.get("src") != cur:
            rec["code_changed_since_record"] = True
        print(json.dumps(rec), flush=True)


def _publish(rec: dict, device: torch.device, records: Optional[str]) -> dict:
    """Add the device's peak memory and name, record (``records`` None:
    not), print the line and return it."""
    if device.type == "cuda":
        rec["peak_hbm_gb"] = round(torch.cuda.max_memory_allocated(device) / 2**30, 3)
    rec["device"] = card_line(device)
    rec["allow_tf32"] = {"cudnn": torch.backends.cudnn.allow_tf32,
                         "matmul": torch.backends.cuda.matmul.allow_tf32}
    if records is not None:
        _record(dict(rec), records)
    print(json.dumps(rec), flush=True)
    return rec


def emit(metric: str, value: float, unit: str, baseline: float, device: torch.device,
         records: Optional[str], **extra) -> dict:
    """The JAX bench's metric line, with the timing and launches in
    ``extra``."""
    rec = {"metric": metric, "value": round(value, 3), "unit": unit,
           "vs_baseline": round(value / baseline, 2), **extra}
    return _publish(rec, device, records)


# ----------------------------------------------- config #2: denoise step ---

def denoise_inputs(unet_cfg: VideoUNetConfig, ctrl_cfg: ControlNetConfig, frames: int,
                   height: int, width: int, batch: int = 2) -> dict:
    """The denoise mode's host inputs from ``RandomState(0)``, drawn as the
    JAX bench draws them: the latent x (1, T, h, w, 4), the concat latents,
    the context, the vector and the ControlNet's pixel frames."""
    rng = np.random.RandomState(0)
    pix = 2 ** (len(ctrl_cfg.conditioning_embedding_out_channels) - 1)
    f32 = lambda a: a.astype(np.float32)  # noqa: E731
    return {
        "x": f32(rng.randn(1, frames, height, width, 4)),
        "concat": f32(rng.randn(batch, frames, height, width, unet_cfg.in_channels - 4)),
        "crossattn": f32(rng.randn(batch, frames, 1, unet_cfg.context_dim)),
        "vector": f32(rng.randn(batch, frames, unet_cfg.adm_in_channels)),
        "ctrl_frames": f32(rng.randn(batch, ctrl_cfg.num_conditional_frames, height * pix,
                                     width * pix, 3)),
    }


def denoise_chain(net, x: torch.Tensor, cond: dict, steps: int = CHAINED_STEPS) -> torch.Tensor:
    """``steps`` chained guided denoise steps (the JAX bench's ``k_steps``):
    sigma = 2 / (1 + 0.1 i) on both CFG rows, x <- 0.05 den[:1] + 0.95 x."""
    b = cond["concat"].shape[0]
    sigmas = 2.0 / (1.0 + 0.1 * torch.arange(steps, dtype=torch.float32, device=x.device))
    for i in range(steps):
        den = denoise(net, torch.cat([x] * b), sigmas[i].expand(b), cond)
        x = den[:1] * 0.05 + x * 0.95
    return x


def bench_denoise(device="cuda", unet_cfg: VideoUNetConfig = VideoUNetConfig(),
                  ctrl_cfg: ControlNetConfig = ControlNetConfig(), *, frames: int = 25,
                  height: int = 72, width: int = 128, dtype: torch.dtype = torch.bfloat16,
                  records: Optional[str] = RECORDS_PATH) -> dict:
    """Config #2: the VideoUNet in ControlNet mode and the ControlNet in
    ``dtype`` from seed 0 through ``streaming_wrapper(ctrl_cfg_shared=True)``
    under stage 1's routing; a warm-up call, then ``TIMED_CALLS`` calls of
    ``CHAINED_STEPS`` steps.  frames/s = T / (median step x 30)."""
    device = _device(device)
    _start(device)
    t0 = time.perf_counter()
    fk = dict(device=device, dtype=dtype)
    unet = init_random_(VideoUNet(unet_cfg, **fk).eval(), torch.Generator(device).manual_seed(0))
    cn = init_random_(ControlNet(unet_cfg, ctrl_cfg, **fk).eval(),
                      torch.Generator(device).manual_seed(1))
    host = denoise_inputs(unet_cfg, ctrl_cfg, frames, height, width)
    x = torch.from_numpy(host.pop("x")).to(device)
    cond = {k: torch.from_numpy(v).to(device, dtype) for k, v in host.items()}
    net = streaming_wrapper(unet, cn, ctrl_cfg.num_conditional_frames, ctrl_cfg_shared=True)
    _sync(device)
    log(f"denoise: build {time.perf_counter() - t0:.1f} s on {card_line(device)}")

    with torch.inference_mode(), use_routing(PipelineConfig().routing):
        t0 = time.perf_counter()
        denoise_chain(net, x, cond)
        _sync(device)
        log(f"denoise: warm-up call (kernel build included) {time.perf_counter() - t0:.1f} s")
        reset_launches()
        timing = timed_calls(lambda i: denoise_chain(net, x + 0.001 * i, cond), TIMED_CALLS,
                             device, f"denoise ({CHAINED_STEPS} chained steps a call)")
        launches = _launches("denoise")
    per_step = timing["median_s"] / CHAINED_STEPS
    chunk = per_step * STEPS_PER_CHUNK
    log(f"denoise: per step {per_step * 1000:.1f} ms, chunk ({STEPS_PER_CHUNK} steps) "
        f"{chunk:.1f} s")
    return emit("stage1_denoise_frames_per_sec_per_chip", frames / chunk, "frames/s",
                BASELINES["denoise"], device, records, chained_steps=CHAINED_STEPS, **timing,
                launches=launches)


# --------------------------------------------- config #1: VAE round trip ---

def vae_roundtrip(vae, x: torch.Tensor, noise: Callable[[tuple], torch.Tensor]) -> torch.Tensor:
    """(1, T, H, W, 3) -> (1, T, H, W, 3): encode in ``ENCODE_FRAMES``-frame
    pieces, each sampled with ``noise(latent shape)``, then temporal-decode
    in ``DECODE_FRAMES``-frame pieces (the reference pipeline's chunking,
    streaming_svd.py:123-151)."""
    cfg = vae.cfg
    t, h, w = x.shape[1:4]
    f = cfg.downsample_factor
    zs = []
    for i in range(0, t, ENCODE_FRAMES):
        xe = x[0, i:i + ENCODE_FRAMES]
        zs.append(vae.encode(xe, noise((xe.shape[0], h // f, w // f, cfg.z_channels)))[None])
    z = torch.cat(zs, dim=1)
    return torch.cat([vae.decode(z[:, i:i + DECODE_FRAMES]) for i in range(0, t, DECODE_FRAMES)],
                     dim=1)


def bench_vae(device="cuda", cfg: VAEConfig = VAEConfig(), *, frames: int = 16,
              height: int = 576, width: int = 1024,
              records: Optional[str] = RECORDS_PATH) -> dict:
    """Config #1: ``AutoencoderKL(cfg)`` in its compute dtype (f32) from seed
    0; the round trip of a ``frames``-frame chunk, the encode noise drawn
    from a ``torch.Generator`` seeded per call; a warm-up call, then
    ``TIMED_CALLS`` calls."""
    device = _device(device)
    _start(device)
    t0 = time.perf_counter()
    vae = init_random_(AutoencoderKL(cfg, device=device, dtype=cfg.dtypes.vae_compute_dtype).eval(),
                       torch.Generator(device).manual_seed(0))
    rng = np.random.RandomState(0)
    rng.rand(1, 2, 64, 64, 3)   # the JAX bench's init input: the chunk is its next draw
    chunk = torch.from_numpy((rng.rand(1, frames, height, width, 3) * 2 - 1).astype(np.float32))
    chunk = chunk.to(device, cfg.dtypes.vae_compute_dtype)
    _sync(device)
    log(f"vae: build {time.perf_counter() - t0:.1f} s on {card_line(device)}")

    def call(x, seed):
        gen = torch.Generator(device).manual_seed(seed)
        return vae_roundtrip(vae, x, lambda shape: torch.randn(
            shape, generator=gen, device=device, dtype=x.dtype))

    with torch.inference_mode():
        t0 = time.perf_counter()
        call(chunk, 1)
        _sync(device)
        log(f"vae: warm-up call (kernel build included) {time.perf_counter() - t0:.1f} s")
        reset_launches()
        timing = timed_calls(lambda i: call(chunk + 0.001 * i, i), TIMED_CALLS, device,
                             f"vae (round trip, {frames} frames at {height}x{width})")
        launches = _launches("vae")
    return emit("vae_roundtrip_frames_per_sec_per_chip", frames / timing["median_s"],
                "frames/s", BASELINES["vae"], device, records, **timing, launches=launches)


# ------------------------------------------- config #3: stage 1, 100 frames ---

def bench_stage1(device="cuda", cfg: PipelineConfig = STAGE1_CFG, *,
                 records: Optional[str] = RECORDS_PATH) -> dict:
    """Config #3: ``build_pipeline(cfg, 0, bf16=True)`` resident on the card
    behind ``StreamingT2VPipeline``'s stage-1 entry (resize in, uint8 frames
    out) on a 720x1280 random image; a warm-up run at seed 33, a timed run
    at seed 34."""
    device = _device(device)
    _start(device)
    t0 = time.perf_counter()
    product = StreamingT2VPipeline(cfg, stage1=build_pipeline(cfg, 0, device=device, bf16=True))
    _sync(device)
    log(f"stage1: build {time.perf_counter() - t0:.1f} s on {card_line(device)}")
    image = (np.random.RandomState(0).rand(720, 1280, 3) * 255).astype(np.uint8)
    target = cfg.stage1_frames

    def run(seed: int) -> None:
        video = product.image_to_video(image, seed=seed)
        if video.shape[0] != target:
            raise AssertionError(f"stage 1 gave {video.shape[0]} frames, not {target}")

    t0 = time.perf_counter()
    run(SEEDS[0])
    log(f"stage1: warm-up run (kernel build included) {time.perf_counter() - t0:.1f} s")
    reset_launches()
    timing = timed_calls(lambda i: run(SEEDS[1]), 1, device, f"stage1 ({target} frames)")
    launches = _launches("stage1")
    return emit("stage1_autoregressive_frames_per_sec_per_chip", target / timing["median_s"],
                "frames/s", BASELINES["stage1"], device, records, **timing, launches=launches,
                stage_finite=product.stage_finite["stage1"])


# ------------------------------------------------ config #4: enhancement ---

def bench_enhance(device="cuda", cfg: EnhanceConfig = EnhanceConfig(), *,
                  records: Optional[str] = RECORDS_PATH, **widths) -> dict:
    """Config #4: ``build_enhance(cfg, 0, **widths)`` on a random f32 video
    of two blended chunks (64 frames at 720p by default) with its frames 0
    and chunk - overlap as key images and random prompt embeddings; a
    warm-up run, then a timed run on the video times 0.99."""
    device = _device(device)
    _start(device)
    t0 = time.perf_counter()
    pipe = build_enhance(cfg, 0, device=device, **widths)
    _sync(device)
    log(f"enhance: build {time.perf_counter() - t0:.1f} s on {card_line(device)}")
    rng = np.random.RandomState(0)
    stride = cfg.chunk_size - cfg.overlap_size
    n = 2 * stride + cfg.overlap_size
    # on the host: the pipeline moves one VAE chunk at a time to the card
    video = torch.from_numpy((rng.rand(n, cfg.height, cfg.width, 3) * 2 - 1).astype(np.float32))
    keys = [video[0], video[stride]]
    pe = torch.from_numpy(rng.randn(2, pipe.m.tokenizer.max_length,
                                    pipe.m.unet.cfg.cross_attention_dim).astype(np.float32))
    pe = pe.to(device, pipe.m.unet.conv_in.kernel.dtype)

    def run(v) -> None:
        pipe.enhance(v, keys, prompt_embeds=pe, use_randomized_blending=True)

    t0 = time.perf_counter()
    run(video)
    log(f"enhance: warm-up run (kernel build included) {time.perf_counter() - t0:.1f} s")
    reset_launches()
    timing = timed_calls(lambda i: run(video * 0.99), 1, device,
                         f"enhance ({n} frames at {cfg.height}x{cfg.width})")
    launches = _launches("enhance")
    return emit("enhance_frames_per_sec_per_chip", n / timing["median_s"], "frames/s",
                BASELINES["enhance"], device, records, **timing, launches=launches)


# ---------------------------------------------------- config #5: product ---

def gradient_image(height: int = 720, width: int = 1280) -> np.ndarray:
    """The JAX bench's synthetic 16:9 input (bench.py:423-427)."""
    yy, xx = np.mgrid[0:height, 0:width]
    return np.stack([xx * 255 / (width - 1), yy * 255 / (height - 1),
                     (xx + yy) * 255 / (width - 1 + height - 1)], axis=-1).astype(np.uint8)


def bench_full(device="cuda", cfg: PipelineConfig = FULL_CFG, *, pipe=None,
               out_dir: str = OUT_DIR, records: Optional[str] = RECORDS_PATH) -> List[dict]:
    """Config #5, the product (reference inference_i2v.py:227-259):
    ``build_product(cfg, 0)`` unless ``pipe`` is given, ``run`` on the
    gradient image into y4m files under ``out_dir``.  Pass 1 (seed 33)
    builds the kernels; pass 2 repeats seed 33 and must give the same bytes;
    pass 3 (seed 34) must differ.  200 requested frames -> 100 stage-1 -> 90
    enhanced (the frames past the last whole blending chunk are dropped,
    i2v_enhance_interface.py:115-118) -> 180.  Emits stage 1's frames/s of
    pass 2, the determinism record (with MAWE on pass 1's frames, random
    weights: a sanity anchor, no quality claim) and the product's frames/s
    over the faster of passes 2 and 3; returns the three records."""
    device = _device(device)
    _start(device)
    if pipe is None:
        t0 = time.perf_counter()
        pipe = build_product(cfg, 0, device=device)
        _sync(device)
        log(f"full: build (3 stages, production width) {time.perf_counter() - t0:.1f} s on "
            f"{card_line(device)}")
    img = gradient_image()
    n = cfg.num_frames
    paths = [os.path.join(out_dir, f"bench_full_{n}f{s}.y4m") for s in ("", "_pass2", "_seed34")]
    finite = []

    def run(k: int, seed: int, what: str):
        t0 = time.perf_counter()
        frames = pipe.run(img, paths[k], seed=seed)
        seconds = time.perf_counter() - t0
        finite.append(dict(pipe.stage_finite))
        stages = stage_seconds("last_s")
        log(f"full: pass {k + 1} ({what}) {seconds:.1f} s, stages {json.dumps(stages)}; "
            f"{paths[k]}; finite {finite[-1]}")
        return frames, seconds

    reset_timers()
    frames1, pass1 = run(0, SEEDS[0], "seed 33, kernel build included")
    reset_timers()
    reset_launches()
    frames2, pass2 = run(1, SEEDS[0], "seed 33 again")
    rep = stage_seconds("last_s")
    launches = _launches("full (pass 2)")
    bitwise = bool(np.array_equal(frames1, frames2))
    frames3, pass3 = run(2, SEEDS[1], "seed 34")
    differ = not np.array_equal(frames1, frames3)
    log(f"full: same seed bitwise identical {bitwise}, other seed differs {differ}")
    steady = [pass2, pass3]
    median = statistics.median(steady)
    timing = {"seconds": [round(s, 4) for s in steady], "median_s": round(median, 4),
              "spread": round((max(steady) - min(steady)) / median, 4),
              "first_pass_s": round(pass1, 4)}
    log(f"full: passes 2 and 3 {pass2:.3f} {pass3:.3f} s; median {median:.3f} s; "
        f"spread {timing['spread']:.2%}")

    mawe = mawe_chunked(frames1.astype(np.float32) / 255.0, vfi_flow_fn(pipe.interpolate.model),
                        device=device)
    log(f"full: MAWE (random weights) {mawe:.6g}")
    s1 = rep["stage1_i2v"]
    out = [emit("stage1_autoregressive_frames_per_sec_per_chip", cfg.stage1_frames / s1,
                "frames/s", BASELINES["stage1"], device, records, seconds=[s1],
                source="full, pass 2")]
    n_out = int(frames1.shape[0])
    finite_all = all(all(f.values()) for f in finite)
    out.append(_publish({
        "metric": "product_run_determinism",
        "value": float(bitwise and differ and finite_all),
        "unit": "bool",
        "vs_baseline": 1.0,
        "frames": n_out,
        "same_seed_bitwise_identical": bitwise,
        "different_seed_differs": differ,
        "all_stage_outputs_finite": finite_all,
        "mawe_random_weights": mawe,
    }, device, records))
    log(f"full: {n_out} frames at {frames1.shape[2]}x{frames1.shape[1]} in {min(steady):.1f} s "
        f"steady state ({pass1:.1f} s with the kernel build)")
    out.append(emit("full_pipeline_frames_per_sec_per_chip", n_out / min(steady), "frames/s",
                    BASELINES["full"], device, records, **timing,
                    stages=rep, launches=launches))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mode", default="denoise",
                    choices=["denoise", "vae", "stage1", "enhance", "full"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("streamingt2v_torch.bench: no CUDA device; the bench runs only on the "
                         "GPU")
    if args.mode == "denoise":
        # replay every recorded config first; the last line stays the live
        # config-#2 metric
        replay_records("stage1_denoise_frames_per_sec_per_chip", RECORDS_PATH)
    mode = {"denoise": bench_denoise, "vae": bench_vae, "stage1": bench_stage1,
            "enhance": bench_enhance, "full": bench_full}[args.mode]
    mode(records=RECORDS_PATH)


if __name__ == "__main__":
    main()
