"""The readings that the limits of ``correct`` are set from, for one cell, in
one process on the card:

    python -m benchmark.control --workload <cell> --seeds 1,2,3,... [--control 3]

For each seed: the cell built from that seed, warmed up, one window of the
cell's ``run_seconds`` (the load and the answers a run has), the program's
state freed, then the comparison of the answer the run would check: the
program's reading.  For the first ``--control`` seeds also the control's
reading: the reference computed in fp8 (one precision below the
configuration's bf16) put in the program's place and judged by the same
comparison.  One JSON line a seed; the benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

from benchmark import run


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m benchmark.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--control", type=int, default=3, help="seeds that also read the control")
    args = p.parse_args(argv)
    manifest = run.load_json(os.path.join(run.ROOT, "BENCHMARK.json"))
    spec = run.resolve(manifest, args.workload)
    run.use_caches()
    import torch

    from benchmark import common

    if not torch.cuda.is_available():
        run.log("needs a CUDA device")
        return 3
    device = torch.device("cuda")
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        cell = spec["entry"].Cell(spec["config"], spec["traffic"], seed, device)
        cell.warm_up()
        window = common.Window(manifest["run_seconds"], device)
        cell.run(window)
        cell.release()
        gc.collect()
        torch.cuda.empty_cache()
        plan = cell.plan_check()
        line = {"workload": args.workload, "seed": seed, "units": window.units,
                "checked": {k: v for k, v in plan.items() if isinstance(v, int)},
                "program": dict(cell.compare(plan))}
        if i < args.control:
            line["control"] = dict(cell.compare(plan, control=True))
        line["seconds"] = round(time.time() - t0, 1)
        print(json.dumps(line), flush=True)
        del cell
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
