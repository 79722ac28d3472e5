"""Configurations, traffic mixes, entries, limits, per-layer metrics and the
tiny variants of the tests are found by name: a copy of the benchmark gains
a cell, a configuration and a metric by new files and additions to
``BENCHMARK.json`` alone, and the parametrised runner, control, FLOPs and
import tests, run on the copy, take the new cell by its name and pass, no
existing file edited."""

from __future__ import annotations

import copy
import hashlib
import json
import os
import shutil
import subprocess
import sys
import xml.etree.ElementTree as ET

import pytest

from benchmark import run
from benchmark.tests import tiny

CELL = "dummy_model.dummy_mix"
# the manifest's lists of named entries
NAMED = ("configs", "workloads", "end_to_end", "per_layer")
# the test files whose cases are parametrised over every cell
PARAMETRISED = ("runner", "control", "flops", "imports")


def digest(root: str) -> dict:
    out = {}
    for d, _, files in os.walk(os.path.join(root, "benchmark")):
        for f in files:
            if f.endswith((".py", ".json")):
                p = os.path.join(d, f)
                with open(p, "rb") as fh:
                    out[os.path.relpath(p, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def write(path: str, content) -> None:
    with open(path, "w") as f:
        if isinstance(content, str):
            f.write(content)
        else:
            json.dump(content, f)


def add_dummy_cell(root: str, manifest: dict) -> dict:
    """The dummy cell's new files under ``root`` (a step cell that drives
    stage 1's chunks, named anew) and the manifest with the additions:
    the cell, its configuration, its metric, and the cell appended to
    ``step_ms``'s and ``idle_share.step``'s cells."""
    b = os.path.join(root, "benchmark")
    cfg, traffic = tiny.cell("streamingsvd.ar_chunk")
    traffic = dict(traffic, entry="dummy_entry")
    write(os.path.join(b, "configs", "dummy_model.json"), cfg)
    write(os.path.join(b, "traffic", "dummy_mix.json"), traffic)
    write(os.path.join(b, "entries", "dummy_entry.py"),
          "from benchmark.entries.stage1_stream_chunk import Cell  # noqa: F401\n")
    write(os.path.join(b, "limits", f"{CELL}.json"),
          run.load_json(os.path.join(run.ROOT, "benchmark", "limits",
                                     "streamingsvd.ar_chunk.json")))
    write(os.path.join(b, "metrics", "dummy.metric.py"), "def read(ctx):\n    return 42.0\n")
    write(os.path.join(b, "tests", "tiny", "configs", "dummy_model.json"), cfg)
    write(os.path.join(b, "tests", "tiny", "traffic", "dummy_mix.json"), traffic)
    manifest = copy.deepcopy(manifest)
    manifest["configs"].append({"name": "dummy_model", "source": "tiny",
                                "file": "benchmark/configs/dummy_model.json", "reduced": [],
                                "why": "test"})
    manifest["workloads"].append({"name": CELL, "config": "dummy_model", "traffic": "dummy_mix",
                                  "chips": 1, "why": "test"})
    manifest["per_layer"].append({"name": "dummy.metric", "unit": "%", "better": "higher",
                                  "source": "device_trace", "layer": "device",
                                  "moves": "step_ms", "workloads": [CELL]})
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if m["name"] in ("step_ms", "idle_share.step"):
            m["workloads"].append(CELL)
    write(os.path.join(root, "BENCHMARK.json"), manifest)
    return manifest


def only_additions(before: dict, after: dict) -> bool:
    """Every entry of ``before`` is in ``after`` as it was, but for cells
    appended to its ``workloads``."""
    for key, old in before.items():
        if key not in NAMED:
            if after[key] != old:
                return False
            continue
        new = {e["name"]: e for e in after[key]}
        for e in old:
            kept = e.get("workloads", [])
            n = new.get(e["name"])
            if n is None or dict(n, workloads=n.get("workloads", [])[:len(kept)]) != dict(
                    e, workloads=kept):
                return False
    return True


def test_a_new_cell_is_new_files(tmp_path):
    root = str(tmp_path)
    shutil.copytree(os.path.join(run.ROOT, "benchmark"), os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(os.path.join(run.ROOT, "streamingt2v_torch"),
               os.path.join(root, "streamingt2v_torch"))
    before = digest(root)
    original = run.load_json(os.path.join(run.ROOT, "BENCHMARK.json"))
    manifest = add_dummy_cell(root, original)
    assert only_additions(original, manifest)

    spec = run.resolve(manifest, CELL, root=root)
    assert spec["traffic"]["entry"] == "dummy_entry"
    assert [m["name"] for m, _ in spec["per_layer"]][-1] == "dummy.metric"
    assert [m["name"] for m in spec["end_to_end"]] == ["step_ms", "peak_gib", "setup_s"]
    small = dict(zip(("config", "traffic"), tiny.cell(CELL, manifest, root)))
    res = run.run_cell(dict(spec, **small), 3, 1.0, True, "cpu")
    assert res["metrics"]["dummy.metric"]["value"] == 42.0
    # the parametrised tests of every cell, run on the copy, take it by name
    report = os.path.join(root, "report.xml")
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", "-p", "no:xdist",
         "-p", "no:randomly", f"--junitxml={report}", "-k", "dummy_model or loads_no_jax",
         *(os.path.join("benchmark", "tests", f"test_bench_{m}.py") for m in PARAMETRISED)],
        cwd=root, env=dict(os.environ, PYTHONPATH=root), capture_output=True, text=True,
        timeout=900)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-2000:]
    cases = ET.parse(report).getroot().iter("testcase")
    ran = {(c.get("classname").rsplit(".", 1)[-1], c.get("name").split("[")[0]) for c in cases}
    assert ran == {("test_bench_runner", "test_result_keys"),
                   ("test_bench_runner", "test_stop_rule_and_work"),
                   ("test_bench_runner", "test_window_closes_on_time"),
                   ("test_bench_control", "test_the_control_fails"),
                   ("test_bench_flops", "test_counted_total_is_the_sum_of_the_parts"),
                   ("test_bench_imports", "test_a_run_loads_no_jax")}, ran
    os.remove(report)

    after = digest(root)
    assert {k: v for k, v in after.items() if k in before} == before
    assert len(after) == len(before) + 7


def test_a_cell_without_its_tiny_variant_names_the_file():
    manifest = run.load_json(os.path.join(run.ROOT, "BENCHMARK.json"))
    manifest["workloads"].append({"name": CELL, "config": "streamingsvd", "traffic": "dummy_mix",
                                  "chips": 1, "why": "test"})
    with pytest.raises(FileNotFoundError, match="tiny/traffic/dummy_mix.json"):
        tiny.cell(CELL, manifest)
