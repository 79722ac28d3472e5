"""Configurations, traffic mixes, entries, limits and per-layer metrics are
found by name: a copy of the benchmark gains a cell, a configuration and a
metric by new files and new manifest entries alone, no existing file edited."""

from __future__ import annotations

import hashlib
import json
import os
import shutil

from benchmark import run
from benchmark.tests import tiny


def digest(root: str) -> dict:
    out = {}
    for d, _, files in os.walk(os.path.join(root, "benchmark")):
        for f in files:
            if f.endswith((".py", ".json")):
                p = os.path.join(d, f)
                with open(p, "rb") as fh:
                    out[os.path.relpath(p, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_a_new_cell_is_new_files(tmp_path):
    root = str(tmp_path)
    shutil.copytree(os.path.join(run.ROOT, "benchmark"), os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = digest(root)
    manifest = run.load_json(os.path.join(run.ROOT, "BENCHMARK.json"))
    cfg, traffic = tiny.cell("streamingsvd.vae_decode")
    b = os.path.join(root, "benchmark")
    with open(os.path.join(b, "configs", "dummy_model.json"), "w") as f:
        json.dump(cfg, f)
    traffic = dict(traffic, entry="dummy_entry")
    with open(os.path.join(b, "traffic", "dummy_mix.json"), "w") as f:
        json.dump(traffic, f)
    with open(os.path.join(b, "entries", "dummy_entry.py"), "w") as f:
        f.write("from benchmark.entries.stage1_decode_video import Cell  # noqa: F401\n")
    with open(os.path.join(b, "limits", "dummy_model.dummy_mix.json"), "w") as f:
        json.dump({"frames_err": 1.0}, f)
    with open(os.path.join(b, "metrics", "dummy.metric.py"), "w") as f:
        f.write("def read(ctx):\n    return 42.0\n")
    manifest["configs"].append({"name": "dummy_model", "source": "tiny",
                                "file": "benchmark/configs/dummy_model.json", "reduced": [],
                                "why": "test"})
    manifest["workloads"].append({"name": "dummy_model.dummy_mix", "config": "dummy_model",
                                  "traffic": "dummy_mix", "chips": 1, "why": "test"})
    manifest["per_layer"].append({"name": "dummy.metric", "unit": "%", "better": "higher",
                                  "source": "device_trace", "layer": "device",
                                  "moves": "frames_per_s",
                                  "workloads": ["dummy_model.dummy_mix"]})
    spec = run.resolve(manifest, "dummy_model.dummy_mix", root=root)
    assert spec["config"] == cfg and spec["traffic"] == traffic
    assert [m["name"] for m, _ in spec["per_layer"]] == ["dummy.metric"]
    res = run.run_cell(spec, 3, 1.0, True, "cpu")
    assert res["metrics"]["dummy.metric"]["value"] == 42.0
    after = digest(root)
    assert {k: v for k, v in after.items() if k in before} == before
    assert len(after) == len(before) + 5
