#!/usr/bin/env python3
"""Device time of a benchmark cell's traced units by the program's
innermost ``st2v.*`` span, with the class "elementwise / copies" of
``benchmark/kernel_classes.py`` split the same way, on one NVIDIA GPU.

    python3 scripts/span_breakdown.py --workload streamingsvd.ar_chunk --seed 7
    python3 scripts/span_breakdown.py --workload streamingsvd.vae_decode --seed 7 \\
        --out spans.vae_decode.json
    python3 scripts/span_breakdown.py --cost      # the off cost of one span() on this host

A cell runs as ``python -m benchmark.run --trace 1`` runs it (its window of
``--seconds``, its reference check), and the same trace is read again here:
per innermost span its device seconds, elementwise seconds, share of the
traced device time and operation count; the device seconds by the two
innermost spans (a norm inside a ResBlock apart from one inside a
transformer block); the spans the program opened per traced unit by name;
the operations named like a span (device mirrors of the ranges, which the
trace must leave out); and the cell's result line.
``--cost`` times ``span()`` entered and left with no profiler running,
against an empty ``with`` and a bare ``record_function``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from collections import Counter

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def span_cost(n: int = 200_000) -> dict:
    """Microseconds per enter and exit, no profiler running."""
    import contextlib

    import torch

    from streamingt2v_torch.utils.profiling import span

    def per(make) -> float:
        best = float("inf")
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(n):
                with make():
                    pass
            best = min(best, (time.perf_counter() - t0) / n * 1e6)
        return best

    null = contextlib.nullcontext()
    return {"span_us": per(lambda: span("st2v.norm")), "empty_with_us": per(lambda: null),
            "record_function_us": per(lambda: torch.profiler.record_function("st2v.norm")),
            "calls": n}


def breakdown(workload: str, seed: int, seconds: float) -> dict:
    from benchmark import program_spans, run

    manifest = run.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    spec = run.resolve(manifest, workload)
    run.use_caches()
    seen = {}

    class Grab:
        @staticmethod
        def read(ctx):
            seen["ctx"] = ctx

    spec["per_layer"].append(({"name": "_grab", "unit": "-"}, Grab))
    result = run.run_cell(spec, seed, seconds, True, "cuda")
    ctx = seen["ctx"]
    tr = ctx.trace
    total = tr.device_s()
    rows = program_spans.breakdown(tr) or {}
    opened = program_spans.open_spans(tr) or [()] * len(tr.ops)
    ops = Counter(program_spans.innermost(names) for names in opened)
    table = sorted(({"span": name, "device_s": r["device_s"], "elementwise_s": r["elementwise_s"],
                     "share": 100.0 * r["device_s"] / total, "ops": ops[name]}
                    for name, r in rows.items()), key=lambda r: -r["device_s"])
    pairs = Counter()
    for o, names in zip(tr.ops, opened):
        pairs[" > ".join(names[-2:]) or program_spans.NONE] += o.dur_ns / 1e9
    by_pair = [{"spans": k, "device_s": v, "share": 100.0 * v / total}
               for k, v in pairs.most_common(20)]
    counts = Counter(n for n, _, _ in program_spans.spans(tr))
    return {"workload": workload, "seed": seed, "units": tr.units, "steps": ctx.steps,
            "device_s": total, "busy_s": tr.busy_s, "window_s": tr.window_s,
            "ops": len(tr.ops), "launch_found": tr.launch_found,
            "span_named_ops": sum(o.name.startswith(program_spans.PREFIX) for o in tr.ops),
            "by_innermost_span": table, "by_two_innermost_spans": by_pair,
            "spans_per_unit": {n: c / tr.units for n, c in sorted(counts.items())},
            "result": result}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload")
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--cost", action="store_true")
    p.add_argument("--out")
    args = p.parse_args(argv)
    out = {}
    if args.cost:
        out["span_cost"] = span_cost()
    if args.workload:
        out.update(breakdown(args.workload, args.seed, args.seconds))
    text = json.dumps(out, indent=1)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    for row in out.get("by_innermost_span", []):
        print(f"{row['span']:<20} {1e3 * row['device_s']:10.3f} ms {row['share']:6.2f}% "
              f"elementwise {1e3 * row['elementwise_s']:10.3f} ms  ops {row['ops']}")
    for row in out.get("by_two_innermost_spans", []):
        print(f"{row['spans']:<40} {1e3 * row['device_s']:10.3f} ms {row['share']:6.2f}%")
    print(json.dumps({k: v for k, v in out.items() if not k.startswith("by_")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
