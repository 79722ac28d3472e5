#!/usr/bin/env python3
"""Time the port's kernels at the main path's shapes through their public
wrappers only, on one NVIDIA GPU.

    python3 scripts/time_kernels.py                       # every kernel below
    python3 scripts/time_kernels.py --kernels d512,k5     # a selection
    python3 scripts/time_kernels.py --root DIR            # another checkout of the port
    python3 scripts/time_kernels.py --budgets-mib 48,96,192,384,0   # K3's row chunk
    python3 scripts/time_kernels.py --root DIR --kernels fma --no-check   # an ablated copy

It imports ``streamingt2v_torch`` from ``--root`` (default: this script's
checkout) and calls nothing but the kernel wrappers in ``ops``, so the same
script times any revision of the port, e.g. an unpacked parent commit beside
this one (run parent, change, change, parent in one call).  Kernels
(``--kernels``, comma-separated):

  d64   flash attention at D=64 in bf16: K1 at stage 1's (250, 9216, 64), K2
        at stage 2's level-0 self-attention (38, 14400, 5x64) and
        cross-attention (145 keys), each beside SDPA;
  k4    temporal conv in bf16 at stage 1's (2, 25, 9216, 320) and stage 2's
        (1, 38, 14400, 320) level 0, pre+res (as the UNets call it) and bare,
        the bare one beside ``F.conv3d``;
  k3    GEGLU FF, x (n, C), inner 4C, LN and residual on, at ``chip_smoke``'s
        three stage-1 UNet widths and stage 2's level 0;
  k3f32 the same in f32 (full f32, TF32 off), each beside its bound at the
        FP32 rate and its plain version, then the device time of each kernel
        of one call (``torch.profiler``: the LN statistics, up, down);
  k6    temporal attention at ``chip_smoke``'s timed geometries;
  d512  flash attention at D=512 (the VAE mid-block attention): K1 at
        (8, 9216, 512), K2 at (2, 14400, 1x512) and (4, 14400, 1x512);
  k5    fused GroupNorm at (38, 14400, 320) with SiLU and without, and at
        the SD VAE's (2, 921600, 128) with SiLU;
  k5a   K5's affine entry (the statistics of K4's prologue) at the stage-1
        decode's level-0 piece (1, 8x589824, 128) and stage 2's level 0
        (1, 38x14400, 320) in bf16, the decode's also in f32, beside the
        plain chain;
  f32   the f32 instances of the stage-1 VAE (full f32, TF32 off): K1 at
        (1, 9216, 512) (the encoder's mid attention) and (8, 9216, 512) (the
        temporal decoder's, one 8-frame chunk) beside SDPA f32, and K4 bare and
        pre+res at the temporal decoder's four widths, the bare one beside
        ``F.conv3d`` f32; bounds at the FP32 rate; then the fma shapes;
  fma   the f32 D=64 flash body and K6's FMA body (full f32, TF32 off): K1
        at (10, 9216, 64), K2 at stage 2's level-0 self-attention cut to 2
        rows (2, 14400, 5x64), K6 at stage 2's (38, 14400, 5x64) and stage
        1's (50, 9216, 5x64) level 0, each beside SDPA f32 (on the strided
        views) and its bound at the FP32 rate; and K6's FMA body in bf16 at
        (38, 14400, 10x32) beside SDPA and its bound at HBM's rate.

Inputs from seed 0; ``chip_smoke``'s timer (CUDA events, median of
``--reps`` after one warm-up) and tolerances; each time beside its bound.
The first call at each d64, k4, d512, k5, f32, fma and k3f32 shape is checked
against the plain version; k5 also prints the device time of each of its two
passes (``torch.profiler``).  ``--no-check`` skips the fma and k3f32 shapes'
checks, for timing a copy of the port whose kernels were cut down on purpose
(an ablation: a phase of a body removed).

``--budgets-mib`` times K3 instead for each G budget of its row chunk
(``fused_ff.G_CHUNK_BYTES``, set for the run; 0 = all rows in one chunk),
with the rows per chunk and the memory a call adds beyond its output, each
budget's first call checked against the plain version; then the device time
of each of K3's kernels in one call at the shipped budget
(``torch.profiler``).  Needs the card.
"""

from __future__ import annotations

import argparse
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def sweep_budgets(chip_smoke, randn, shapes, budgets, reps: int) -> None:
    import torch

    from streamingt2v_torch.ops import _native, fused_ff

    shipped = fused_ff.G_CHUNK_BYTES
    for n, c in shapes:
        args, kw, plain = chip_smoke._k3_operands(randn, n, c, torch.bfloat16, True, True)
        inner = 4 * c
        ref = plain()
        b = chip_smoke.bound(chip_smoke.work_geglu(n, c, inner))
        for mib in budgets:
            fused_ff.G_CHUNK_BYTES = (mib << 20) if mib else 2 * n * inner
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out = fused_ff.geglu_ff(*args, **kw)
            torch.cuda.synchronize()
            extra = torch.cuda.max_memory_allocated() - base - out.numel() * out.element_size()
            chip_smoke._compare(f"K3 {(n, c)} budget {mib} MiB", out, ref, chip_smoke.TOL["bf16"])
            del out
            ms = chip_smoke._time_ms(lambda: fused_ff.geglu_ff(*args, **kw), reps=reps)
            print(f"  K3 x{(n, c)} inner {inner} budget {mib or 'all'} MiB: chunk "
                  f"{fused_ff.chunk_size(n, inner, c, _native.sm_count(args[0].device))} "
                  f"rows, {ms:.3f} ms, share {b['bound_ms'] / ms:.3f}, scratch "
                  f"{extra / 2**20:.1f} MiB", flush=True)
        fused_ff.G_CHUNK_BYTES = shipped
        device_times(lambda: fused_ff.geglu_ff(*args, **kw), "shipped budget")
        del args, kw, plain, ref
        torch.cuda.empty_cache()


KERNELS = ("d64", "k4", "k3", "k6", "d512", "k5", "k5a", "f32", "fma", "k3f32")
CHECK = True   # --no-check clears it


def _timed(chip_smoke, name: str, call, library, work: tuple, reps: int) -> None:
    ms, lib = chip_smoke._time_ms(call, reps=reps), chip_smoke._time_ms(library, reps=reps)
    bd = chip_smoke.bound(work)
    print(f"  {name} bf16: {ms:.3f} ms, library {lib:.3f} ms, bound {bd['bound_ms']:.3f} ms, "
          f"share {bd['bound_ms'] / ms:.3f}", flush=True)


def time_d64(chip_smoke, randn, reps: int) -> None:
    import torch.nn.functional as F

    from streamingt2v_torch.ops import flash_attention as fa

    tol = chip_smoke.TOL["bf16"]
    q, k, v = (randn(250, 9216, 64) for _ in range(3))
    chip_smoke._compare("D64 K1", fa.flash_attention(q, k, v)[:2],
                        fa.flash_attention_reference(q[:2], k[:2], v[:2]), tol)
    _timed(chip_smoke, "D64 K1 (250, 9216, 64)", lambda: fa.flash_attention(q, k, v),
           lambda: F.scaled_dot_product_attention(q[:, None], k[:, None], v[:, None]),
           chip_smoke.work_flash(250, 1, 9216, 9216, 64), reps)
    del q, k, v
    for lk in (14400, 145):
        q = randn(38, 14400, 320)
        k, v = (randn(38, lk, 320) for _ in range(2))
        chip_smoke._compare(f"D64 K2 kv {lk}", fa.flash_attention_packed(q, k, v, num_heads=5)[:1],
                            fa.flash_attention_packed_reference(q[:1], k[:1], v[:1], 5), tol)
        qh, kh, vh = (t.view(38, -1, 5, 64).transpose(1, 2) for t in (q, k, v))
        _timed(chip_smoke, f"D64 K2 (38, 14400, 5x64) kv {lk}",
               lambda: fa.flash_attention_packed(q, k, v, num_heads=5),
               lambda: F.scaled_dot_product_attention(qh, kh, vh),
               chip_smoke.work_flash(38, 5, 14400, lk, 64), reps)
        del q, k, v, qh, kh, vh


def time_k4(chip_smoke, randn, reps: int) -> None:
    import torch

    from streamingt2v_torch.ops.temporal_conv import temporal_conv, temporal_conv_reference

    gen = torch.Generator(device="cuda").manual_seed(0)
    tol = chip_smoke.TOL["bf16"]
    for shape in ((2, 25, 9216, 320, 320), (1, 38, 14400, 320, 320)):
        args = chip_smoke._conv_args(randn, gen, *shape, 3, True, True, torch.bfloat16)
        x, w, bias = args[:3]
        x1, r1, rw1, pa1, pb1 = (a[:1] for a in (x, *args[3:]))   # the first batch row
        chip_smoke._compare(f"K4 {shape} pre+res", temporal_conv(*args)[:1],
                            temporal_conv_reference(x1, w, bias, r1, rw1, pa1, pb1), tol)
        ms = chip_smoke._time_ms(lambda: temporal_conv(*args), reps=reps)
        bd = chip_smoke.bound(chip_smoke.work_temporal_conv(*shape))
        print(f"  K4 {shape} pre+res bf16: {ms:.3f} ms, bound {bd['bound_ms']:.3f} ms, share "
              f"{bd['bound_ms'] / ms:.3f}", flush=True)
        library, _ = chip_smoke._conv3d_view(x, w, bias)
        _timed(chip_smoke, f"K4 {shape} bare", lambda: temporal_conv(x, w, bias), library,
               chip_smoke.work_temporal_conv(*shape, res=False, pre=False), reps)
        del args, x, w, bias


def time_k3(chip_smoke, randn, reps: int) -> None:
    import torch

    from streamingt2v_torch.ops.fused_ff import geglu_ff

    for n, c in chip_smoke.K3_LEVELS + (chip_smoke.K3_STAGE2,):
        operands, kw, _ = chip_smoke._k3_operands(randn, n, c, torch.bfloat16, True, True)
        ms = chip_smoke._time_ms(lambda: geglu_ff(*operands, **kw), reps=reps)
        b = chip_smoke.bound(chip_smoke.work_geglu(n, c, 4 * c))
        print(f"  K3 x{(n, c)} inner {4 * c} bf16: {ms:.3f} ms, bound {b['bound_ms']:.3f} ms, "
              f"share {b['bound_ms'] / ms:.3f}", flush=True)
        del operands, kw


def time_k3f32(chip_smoke, randn, reps: int) -> None:
    import torch

    from streamingt2v_torch.ops.fused_ff import geglu_ff

    for n, c in chip_smoke.K3_LEVELS + (chip_smoke.K3_STAGE2,):
        operands, kw, plain = chip_smoke._k3_operands(randn, n, c, torch.float32, True, True)
        call = lambda: geglu_ff(*operands, **kw)  # noqa: E731
        if CHECK:
            chip_smoke._compare(f"f32 K3 {(n, c)}", call(), plain(), chip_smoke.TOL["f32"])
        ms, plain_ms = chip_smoke._time_ms(call, reps=reps), chip_smoke._time_ms(plain, reps=3)
        b = chip_smoke.bound(chip_smoke.work_geglu(n, c, 4 * c, elem=4), chip_smoke.PEAK_F32_FLOPS)
        print(f"  f32 K3 x{(n, c)} inner {4 * c}: {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
              f"{b['bound_ms']:.3f} ms ({b['bound_by']}), share {b['bound_ms'] / ms:.3f}",
              flush=True)
        device_times(call, f"f32 K3 x{(n, c)}")
        del operands, kw, plain


def time_k6(chip_smoke, randn, reps: int) -> None:
    from streamingt2v_torch.ops.temporal_attention import fused_temporal_attention

    for batch, t, s, heads in chip_smoke.K6_TIMED:
        q, k, v = (randn(batch * t, s, heads * 64) for _ in range(3))
        kw = dict(batch=batch, frames_q=t, frames_kv=t, num_heads=heads)
        ms = chip_smoke._time_ms(lambda: fused_temporal_attention(q, k, v, **kw), reps=reps)
        b = chip_smoke.bound(chip_smoke.work_temporal_attention(batch, t, t, s, heads, 64))
        print(f"  K6 {(batch * t, s, heads * 64)} T={t} bf16: {ms:.3f} ms, bound "
              f"{b['bound_ms']:.3f} ms, share {b['bound_ms'] / ms:.3f}", flush=True)
        del q, k, v


def time_d512(chip_smoke, randn, reps: int) -> None:
    from streamingt2v_torch.ops import flash_attention as fa

    tol = chip_smoke.TOL["bf16"]
    for name, b, length in (("K1", 8, 9216), ("K2", 2, 14400), ("K2", 4, 14400)):
        q, k, v = (randn(b, length, 512) for _ in range(3))
        if name == "K1":
            call = lambda: fa.flash_attention(q, k, v)  # noqa: E731
            ref = fa.flash_attention_reference(q[:1], k[:1], v[:1])
        else:
            call = lambda: fa.flash_attention_packed(q, k, v, num_heads=1)  # noqa: E731
            ref = fa.flash_attention_packed_reference(q[:1], k[:1], v[:1], 1)
        chip_smoke._compare(f"D512 {name} {(b, length, 512)}", call()[:1], ref, tol)
        ms = chip_smoke._time_ms(call, reps=reps)
        bd = chip_smoke.bound(chip_smoke.work_flash(b, 1, length, length, 512))
        print(f"  D512 {name} {(b, length, 512)} bf16: {ms:.3f} ms, bound {bd['bound_ms']:.3f} ms, "
              f"share {bd['bound_ms'] / ms:.3f}", flush=True)
        del q, k, v, ref


def time_f32(chip_smoke, randn, reps: int) -> None:
    import torch

    from streamingt2v_torch.ops import flash_attention as fa
    from streamingt2v_torch.ops.temporal_conv import temporal_conv, temporal_conv_reference

    f32, tol = torch.float32, chip_smoke.TOL["f32"]
    peak = chip_smoke.PEAK_F32_FLOPS
    for b, length in chip_smoke.K1_F32_TIMED:
        q, k, v = (randn(b, length, 512, dtype=f32) for _ in range(3))
        chip_smoke._compare(f"f32 K1 {(b, length, 512)}", fa.flash_attention(q, k, v)[:1],
                            fa.flash_attention_reference(q[:1], k[:1], v[:1]), tol)
        library, backend = chip_smoke._sdpa_backend(q[:, None], k[:, None], v[:, None])
        ms = chip_smoke._time_ms(lambda: fa.flash_attention(q, k, v), reps=reps)
        lib = chip_smoke._time_ms(library, reps=reps)
        bd = chip_smoke.bound(chip_smoke.work_flash(b, 1, length, length, 512, elem=4), peak)
        print(f"  f32 K1 {(b, length, 512)}: {ms:.3f} ms, SDPA ({backend}) {lib:.3f} ms, bound "
              f"{bd['bound_ms']:.3f} ms, share {bd['bound_ms'] / ms:.3f}", flush=True)
        del q, k, v
    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape in chip_smoke.K4_F32_DECODER:
        args = chip_smoke._conv_args(randn, gen, *shape, 3, True, True, f32)
        x, w, bias = args[:3]
        chip_smoke._compare(f"f32 K4 {shape} pre+res", temporal_conv(*args),
                            temporal_conv_reference(*args), tol)
        ms = chip_smoke._time_ms(lambda: temporal_conv(*args), reps=reps)
        bd = chip_smoke.bound(chip_smoke.work_temporal_conv(*shape, elem=4), peak)
        print(f"  f32 K4 {shape} pre+res: {ms:.3f} ms, bound {bd['bound_ms']:.3f} ms, share "
              f"{bd['bound_ms'] / ms:.3f}", flush=True)
        library, _ = chip_smoke._conv3d_view(x, w, bias)
        ms, lib = (chip_smoke._time_ms(fn, reps=reps)
                   for fn in (lambda: temporal_conv(x, w, bias), library))
        bd = chip_smoke.bound(chip_smoke.work_temporal_conv(*shape, res=False, pre=False,
                                                           elem=4), peak)
        print(f"  f32 K4 {shape} bare: {ms:.3f} ms, conv3d {lib:.3f} ms, bound "
              f"{bd['bound_ms']:.3f} ms, share {bd['bound_ms'] / ms:.3f}", flush=True)
        del args, x, w, bias
    time_fma(chip_smoke, randn, reps)


def _f32_timed(chip_smoke, name: str, call, ref, library, backend: str, work: tuple,
               reps: int) -> None:
    """An f32 call checked against its plain version (unless ``--no-check``),
    then timed beside its SDPA f32 yardstick and its bound at the FP32 rate."""
    if CHECK:
        chip_smoke._compare(f"f32 {name}", call(), ref, chip_smoke.TOL["f32"])
    ms, lib = (chip_smoke._time_ms(fn, reps=reps) for fn in (call, library))
    bd = chip_smoke.bound(work, chip_smoke.PEAK_F32_FLOPS)
    print(f"  f32 {name}: {ms:.3f} ms, SDPA ({backend}) {lib:.3f} ms, bound "
          f"{bd['bound_ms']:.3f} ms ({bd['bound_by']}), share {bd['bound_ms'] / ms:.3f}",
          flush=True)


def time_fma(chip_smoke, randn, reps: int) -> None:
    import torch

    from streamingt2v_torch.ops import flash_attention as fa
    from streamingt2v_torch.ops.temporal_attention import (
        fused_temporal_attention, temporal_attention_reference)

    f32 = torch.float32
    q, k, v = (randn(10, 9216, 64, dtype=f32) for _ in range(3))
    library, backend = chip_smoke._sdpa_backend(q[:, None], k[:, None], v[:, None])
    _f32_timed(chip_smoke, "K1 (10, 9216, 64)", lambda: fa.flash_attention(q, k, v),
               fa.flash_attention_reference(q, k, v), library, backend,
               chip_smoke.work_flash(10, 1, 9216, 9216, 64, elem=4), reps)
    del q, k, v
    q, k, v = (randn(2, 14400, 320, dtype=f32) for _ in range(3))
    views = tuple(z.view(2, -1, 5, 64).transpose(1, 2) for z in (q, k, v))
    library, backend = chip_smoke._sdpa_backend(*views)
    _f32_timed(chip_smoke, "K2 (2, 14400, 5x64)",
               lambda: fa.flash_attention_packed(q, k, v, num_heads=5),
               fa.flash_attention_packed_reference(q, k, v, 5), library, backend,
               chip_smoke.work_flash(2, 5, 14400, 14400, 64, elem=4), reps)
    del q, k, v, views
    for batch, t, s, heads in chip_smoke.K6_TIMED:
        q, k, v = (randn(batch * t, s, heads * 64, dtype=f32) for _ in range(3))
        kw = dict(batch=batch, frames_q=t, frames_kv=t, num_heads=heads)
        views, _, _ = chip_smoke._k6_views(q, k, v, batch, s, heads, 64)
        library, backend = chip_smoke._sdpa_backend(*views)
        _f32_timed(chip_smoke, f"K6 {(batch * t, s, heads * 64)} T={t}",
                   lambda: fused_temporal_attention(q, k, v, **kw),
                   temporal_attention_reference(q, k, v, **kw), library, backend,
                   chip_smoke.work_temporal_attention(batch, t, t, s, heads, 64, elem=4), reps)
        del q, k, v, views
    b, t, s, heads, d = (chip_smoke.K6_BF16_FMA_TIMED[i] for i in (0, 1, 3, 4, 5))
    q, k, v = (randn(b * t, s, heads * d) for _ in range(3))
    kw = dict(batch=b, frames_q=t, frames_kv=t, num_heads=heads)
    if CHECK:
        chip_smoke._compare(f"bf16 K6 d={d}", fused_temporal_attention(q, k, v, **kw),
                            temporal_attention_reference(q, k, v, **kw), chip_smoke.TOL["bf16"])
    views, _, _ = chip_smoke._k6_views(q, k, v, b, s, heads, d)
    library, _ = chip_smoke._sdpa_backend(*views)
    _timed(chip_smoke, f"K6 {(b * t, s, heads * d)} T={t} d={d}",
           lambda: fused_temporal_attention(q, k, v, **kw), library,
           chip_smoke.work_temporal_attention(b, t, t, s, heads, d), reps)


def device_times(fn, what: str) -> None:
    """Prints the device time of each kernel one call of ``fn`` launches
    (``torch.profiler``), after a warm-up call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            print(f"    {what}, by kernel: {evt.self_device_time_total / 1e3:.3f} ms in "
                  f"{evt.count} launches of {evt.key[:90]}", flush=True)


def time_k5(chip_smoke, randn, reps: int) -> None:
    import torch

    from streamingt2v_torch.ops.fused_group_norm import (
        fused_group_norm, fused_group_norm_reference)

    f32 = torch.float32
    for n, l, c, act, eps in ((38, 14400, 320, "silu", 1e-5), (38, 14400, 320, None, 1e-6),
                              (2, 921600, 128, "silu", 1e-6)):
        x = randn(n, l, c, std=2.0, mean=0.5)
        scale, bias = 1.0 + randn(c, dtype=f32, std=0.1), randn(c, dtype=f32, std=0.1)
        kw = dict(num_groups=32, eps=eps, act=act)
        chip_smoke._compare(f"K5 {(n, l, c)} act={act}", fused_group_norm(x, scale, bias, **kw),
                            fused_group_norm_reference(x, scale, bias, **kw),
                            chip_smoke.TOL["bf16"])
        ms = chip_smoke._time_ms(lambda: fused_group_norm(x, scale, bias, **kw), reps=reps)
        bd = chip_smoke.bound(chip_smoke.work_group_norm(n, l, c))
        print(f"  K5 {(n, l, c)} act={act} bf16: {ms:.3f} ms, bound {bd['bound_ms']:.3f} ms, "
              f"share {bd['bound_ms'] / ms:.3f}", flush=True)
        device_times(lambda: fused_group_norm(x, scale, bias, **kw), "K5's two passes")
        del x


def time_k5a(chip_smoke, randn, reps: int) -> None:
    import torch

    from streamingt2v_torch.ops import fused_group_norm as gn
    from streamingt2v_torch.ops.norms import group_norm_affine

    f32 = torch.float32
    for (n, l, c), dtype, _ in chip_smoke.K5_AFFINE_TIMED:
        dtype = getattr(torch, dtype)
        x = randn(n, l, c, dtype=dtype, std=2.0, mean=0.5)
        scale, bias = 1.0 + randn(c, dtype=f32, std=0.1), randn(c, dtype=f32, std=0.1)
        kw = dict(num_groups=32, eps=1e-5)
        bd = chip_smoke.bound(chip_smoke.work_group_norm_affine(n, l, c, x.element_size()))
        plain_ms = chip_smoke._time_ms(lambda: group_norm_affine(x, scale, bias, **kw), reps=3)
        ref = group_norm_affine(x, scale, bias, **kw)
        plan = gn.affine_launch_plan(n, l, c, x.element_size())
        call = lambda: gn.fused_group_norm_affine(x, scale, bias, **kw)  # noqa: E731
        for name, got, want in zip("ab", call(), ref):
            chip_smoke._compare(f"K5 affine {(n, l, c)} {dtype} {name}", got, want,
                                chip_smoke.TOL["f32"])
        ms = chip_smoke._time_ms(call, reps=reps)
        print(f"  K5 affine {(n, l, c)} {dtype} chunks {plan.chunks}, {plan.threads} threads: "
              f"{ms:.3f} ms, plain chain {plain_ms:.3f} ms, bound {bd['bound_ms']:.3f} ms, "
              f"share {bd['bound_ms'] / ms:.3f}", flush=True)
        device_times(call, "K5's affine entry")
        del x, ref


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=HERE, help="checkout whose port is timed")
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--kernels", default=",".join(KERNELS),
                        help="comma-separated subset of " + ",".join(KERNELS))
    parser.add_argument("--no-check", action="store_true",
                        help="skip the fma and k3f32 shapes' checks against the plain "
                             "versions")
    parser.add_argument("--budgets-mib", default="",
                        help="comma-separated K3 G budgets to sweep (this checkout's port)")
    args = parser.parse_args()
    kernels = args.kernels.split(",")
    global CHECK
    CHECK = not args.no_check
    if not set(kernels) <= set(KERNELS):
        parser.error(f"--kernels: choose from {','.join(KERNELS)}")
    import torch

    if not torch.cuda.is_available():
        print("time_kernels: no CUDA device", file=sys.stderr)
        return 2
    # f32 is full f32 for the kernels, the plain versions and the yardsticks
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, HERE)
    import chip_smoke   # the shapes, timer, bounds and work counts of this checkout

    sys.path.insert(0, os.path.abspath(args.root))
    for name in [m for m in sys.modules if m.startswith("streamingt2v_torch")]:
        del sys.modules[name]

    print(f"card: {chip_smoke._card_line()}; port from {os.path.abspath(args.root)}", flush=True)
    randn, _ = chip_smoke._randn_factory(0)
    if args.budgets_mib:
        sweep_budgets(chip_smoke, randn, chip_smoke.K3_LEVELS + ((547200, 320),),
                      [int(b) for b in args.budgets_mib.split(",")], args.reps)
        return 0
    timers = dict(d64=time_d64, k4=time_k4, k3=time_k3, k6=time_k6, d512=time_d512, k5=time_k5,
                  k5a=time_k5a, f32=time_f32, fma=time_fma, k3f32=time_k3f32)
    for name in kernels:
        timers[name](chip_smoke, randn, args.reps)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
