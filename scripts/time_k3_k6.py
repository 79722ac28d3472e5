#!/usr/bin/env python3
"""Time K3 (GEGLU feed-forward) and K6 (temporal attention) at the main
path's shapes through their public wrappers only, on one NVIDIA GPU.

    python3 scripts/time_k3_k6.py            # the checkout this script is in
    python3 scripts/time_k3_k6.py --root DIR # another checkout of the port
    python3 scripts/time_k3_k6.py --budgets-mib 48,96,192,384,0   # K3's row chunk

It imports ``streamingt2v_torch`` from ``--root`` (default: this script's
checkout) and calls nothing but ``ops.fused_ff.geglu_ff`` and
``ops.temporal_attention.fused_temporal_attention``, so the same script
times any revision of the port, e.g. an unpacked parent commit beside this
one.  K3: x (n, C), inner 4C, LN and residual on, at ``chip_smoke``'s three
stage-1 UNet widths and stage 2's level 0; K6: ``chip_smoke``'s timed
geometries.  Inputs from seed 0; ``chip_smoke``'s timer (CUDA events, median
of ``--reps`` after one warm-up); each time beside its bound.

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


def k3_operands(randn, n: int, c: int) -> tuple:
    import torch

    inner, f32 = 4 * c, torch.float32
    x = randn(n, c)
    w1, b1 = randn(2 * inner, c, std=c ** -0.5), randn(2 * inner, dtype=f32, std=0.1)
    w2, b2 = randn(c, inner, std=inner ** -0.5), randn(c, dtype=f32, std=0.1)
    lns, lnb = 1.0 + randn(c, dtype=f32, std=0.1), randn(c, dtype=f32, std=0.1)
    return (x, w1, b1, w2, b2), dict(ln_scale=lns, ln_bias=lnb, residual=True)


def sweep_budgets(chip_smoke, randn, shapes, budgets, reps: int) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from streamingt2v_torch.ops import fused_ff

    shipped = fused_ff.G_CHUNK_BYTES
    for n, c in shapes:
        args, kw = k3_operands(randn, n, c)
        inner = 4 * c
        ref = fused_ff.geglu_ff_reference(*args, kw["ln_scale"], kw["ln_bias"], True)
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
                  f"{fused_ff.chunk_size(n, inner, c, fused_ff._sm_count(args[0].device))} "
                  f"rows, {ms:.3f} ms, share {b['bound_ms'] / ms:.3f}, scratch "
                  f"{extra / 2**20:.1f} MiB", flush=True)
        fused_ff.G_CHUNK_BYTES = shipped
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fused_ff.geglu_ff(*args, **kw)
            torch.cuda.synchronize()
        for evt in prof.key_averages():
            if evt.device_type == torch.autograd.DeviceType.CUDA:
                print(f"    shipped budget, by kernel: {evt.self_device_time_total / 1e3:.3f} ms "
                      f"in {evt.count} launches of {evt.key[:90]}", flush=True)
        del args, ref
        torch.cuda.empty_cache()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=HERE, help="checkout whose port is timed")
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--budgets-mib", default="",
                        help="comma-separated K3 G budgets to sweep (this checkout's port)")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("time_k3_k6: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke   # the shapes, timer, bounds and work counts of this checkout

    sys.path.insert(0, os.path.abspath(args.root))
    for name in [m for m in sys.modules if m.startswith("streamingt2v_torch")]:
        del sys.modules[name]
    from streamingt2v_torch.ops.fused_ff import geglu_ff
    from streamingt2v_torch.ops.temporal_attention import fused_temporal_attention

    print(f"card: {chip_smoke._card_line()}; port from {os.path.abspath(args.root)}", flush=True)
    randn, _ = chip_smoke._randn_factory(0)
    k3_shapes = chip_smoke.K3_LEVELS + ((547200, 320),)   # + stage 2's level 0
    if args.budgets_mib:
        sweep_budgets(chip_smoke, randn, k3_shapes,
                      [int(b) for b in args.budgets_mib.split(",")], args.reps)
        return 0
    for n, c in k3_shapes:
        operands, kw = k3_operands(randn, n, c)
        ms = chip_smoke._time_ms(lambda: geglu_ff(*operands, **kw), reps=args.reps)
        b = chip_smoke.bound(chip_smoke.work_geglu(n, c, 4 * c))
        print(f"  K3 x{(n, c)} inner {4 * c} bf16: {ms:.3f} ms, bound {b['bound_ms']:.3f} ms, "
              f"share {b['bound_ms'] / ms:.3f}", flush=True)
        del operands
    for batch, t, s, heads in chip_smoke.K6_TIMED:
        q, k, v = (randn(batch * t, s, heads * 64) for _ in range(3))
        kw = dict(batch=batch, frames_q=t, frames_kv=t, num_heads=heads)
        ms = chip_smoke._time_ms(lambda: fused_temporal_attention(q, k, v, **kw),
                                 reps=args.reps)
        b = chip_smoke.bound(chip_smoke.work_temporal_attention(batch, t, t, s, heads, 64))
        print(f"  K6 {(batch * t, s, heads * 64)} T={t} bf16: {ms:.3f} ms, bound "
              f"{b['bound_ms']:.3f} ms, share {b['bound_ms'] / ms:.3f}", flush=True)
        del q, k, v
    return 0


if __name__ == "__main__":
    sys.exit(main())
