"""The benchmark of the PyTorch and CUDA port, one cell a run:

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with as many CUDA devices as the
cell asks for (it exits non-zero, printing no result, without them).

A cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``benchmark/configs/<config>.json``) and a traffic mix
(``benchmark/traffic/<traffic>.json``), whose ``entry`` names the code that
drives one of the program's entry points (``benchmark/entries/<entry>.py``); the limits
of the comparison that decides ``correct`` are ``benchmark/limits/<cell>.json``
and each per-layer metric is read by ``benchmark/metrics/<metric>.py``.  All
are found by name, so a new cell, configuration or metric is new files.

A run: build the program's modules with weights made from the seed on the
device, make the inputs, warm every shape up (``setup_s`` is the process's
start to here), then the window: the entry's units until the first unit
boundary after ``--seconds``, between two device synchronisations.  With
``--trace 1`` the profiler records the window's first ``trace_units`` units
and the per-layer metrics are read from that; without, the end-to-end
metrics.  The peak memory is read, the program's state freed, and the
reference checks what the window produced: the numbers it compares, each
with its limit, are the last lines on standard error and the result's
``checks``.  The last line of standard output is the result.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# modules that may not be loaded in a run (compared by top-level name)
FORBIDDEN = ("jax", "jaxlib", "flax", "streamingt2v_tpu")
# the fixed cache directories of every kernel compiler the program may use
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions",
          "CUDA_CACHE_PATH": "cuda"}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m benchmark.run", description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    p.add_argument("--seed", required=True, type=int)
    p.add_argument("--seconds", required=True, type=float, help="length of the measured window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_file(path: str, name: str):
    """A module from its file, whatever its name (metric names hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def resolve(manifest: dict, workload: str, root: str = ROOT) -> dict:
    """Everything a cell's run reads, found by name."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no cell {workload!r} in BENCHMARK.json: {sorted(cells)}")
    cell = cells[workload]
    config = {c["name"]: c for c in manifest["configs"]}[cell["config"]]
    traffic = load_json(os.path.join(root, "benchmark", "traffic", f"{cell['traffic']}.json"))
    metrics = [m for m in manifest["per_layer"] if workload in m.get("workloads", [workload])]
    return {
        "cell": cell,
        "config": load_json(os.path.join(root, config["file"])),
        "traffic": traffic,
        "limits": load_json(os.path.join(root, "benchmark", "limits", f"{workload}.json")),
        "entry": load_file(os.path.join(root, "benchmark", "entries", f"{traffic['entry']}.py"),
                           f"benchmark_entry_{traffic['entry']}"),
        "end_to_end": [m for m in manifest["end_to_end"]
                       if workload in m.get("workloads", [workload])],
        "per_layer": [(m, load_file(os.path.join(root, "benchmark", "metrics", f"{m['name']}.py"),
                                    "benchmark_metric_" + m["name"].replace(".", "_")))
                      for m in metrics],
    }


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def use_caches(root: str = ROOT) -> None:
    for var, sub in CACHES.items():
        path = os.path.join(root, ".bench_cache", sub)
        os.makedirs(path, exist_ok=True)
        os.environ[var] = path


def device_info(device, count: int) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device) -> dict:
    """One run of a resolved cell on ``device``; returns the result object."""
    import torch

    from benchmark import common
    from benchmark.flops import model_flops
    from benchmark.readers import Context
    from benchmark.trace import Tracer, idle_gaps, top_ops

    device = torch.device(device)
    traffic, limits = spec["traffic"], spec["limits"]
    t_import = time.time()
    cell = spec["entry"].Cell(spec["config"], traffic, seed, device)
    common.sync(device)
    t_built = time.time()
    cell.warm_up()
    common.sync(device)
    setup_s = time.time() - T_START
    log(f"set-up: {t_import - T_START:.3f} s to import, {t_built - t_import:.3f} s to build the "
        f"modules, weights and inputs, {T_START + setup_s - t_built:.3f} s to warm up")
    tracer = Tracer(traffic["trace_units"], device) if trace else None
    window = common.Window(seconds, device, tracer.boundary if tracer else None)
    cell.run(window)
    work = cell.work(window.units)
    dev = device_info(device, spec["cell"]["chips"])
    log(f"window: {window.units} {cell.unit}s, {work}, {window.elapsed:.4f} s; set-up "
        f"{setup_s:.3f} s; peak {dev['memory_peak_bytes'] / 2**30:.3f} GiB")
    result = {"correct": False, "attempted": window.units, "failed": 0, "metrics": {},
              "device": dev}
    if trace:
        tr = tracer.result()
        if tr is None:
            raise RuntimeError(f"the window ended before {traffic['trace_units']} traced units")
        unit_flops, unit_log = model_flops(cell.meta_unit())
        traced = cell.work(tr.units)
        ctx = Context(trace=tr, units=tr.units, steps=traced.get("steps", 0),
                      frames=traced.get("frames", 0), unit_flops=unit_flops, unit_log=unit_log)
        for m, mod in spec["per_layer"]:
            value = mod.read(ctx)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
        result["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = {"device_ops": top_ops(tr), "idle_gaps": idle_gaps(tr)}
        log(f"trace: {tr.units} units, {len(tr.ops)} device operations ({tr.launch_found} with "
            f"their launch), busy {tr.busy_s:.4f} of {tr.window_s:.4f} s; "
            f"{unit_flops / 1e12:.3f} TFLOP a unit")
    else:
        values = {"setup_s": setup_s,
                  "peak_gib": dev["memory_peak_bytes"] / 2**30,
                  "step_ms": 1e3 * window.elapsed / max(work.get("steps", 0), 1),
                  "frames_per_s": work.get("frames", 0) / window.elapsed}
        for m in spec["end_to_end"]:
            result["metrics"][m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    cell.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.time()
    readings = cell.compare(cell.plan_check())
    checks = {name: {"value": value, "limit": limits[name]} for name, value in readings}
    result["correct"] = all(c["value"] <= c["limit"] for c in checks.values())
    result["failed"] = 0 if result["correct"] else 1
    result["checks"] = checks
    log(f"reference: {time.time() - t0:.1f} s")
    return result


def main(argv=None) -> int:
    args = parse_args(argv)
    manifest = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    spec = resolve(manifest, args.workload)
    use_caches()
    import torch

    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"needs {chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    result = run_cell(spec, args.seed, args.seconds, bool(args.trace), "cuda")
    found = forbidden_modules()
    if found:
        log(f"loaded in this process: {', '.join(found)}")
        return 4
    checks = result.pop("checks")
    result["checks"] = checks       # the compared numbers come last
    for name, c in checks.items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
