"""``BENCHMARK.json`` keeps to the rules of a benchmark manifest: its keys,
names, units, bounds and sources, every file it names under its paths, and
every cell with a configuration, a traffic mix, an entry, limits and readers."""

from __future__ import annotations

import json
import os
import re

import pytest

from benchmark import run

ROOT = run.ROOT
M = run.load_json(os.path.join(ROOT, "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert 1 <= len(M["paths"]) <= 16 and all(PATH.match(p) and ".." not in p
                                              for p in M["paths"])
    assert 1 <= len(M["command"]) <= 32 and all(line(w) for w in M["command"])
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51
    assert len(json.dumps(M)) <= 64 * 1024
    # a full check of 24 cells fits its time
    assert 2 + 14 * 24 * (M["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_configs():
    assert 1 <= len(M["configs"]) <= 24
    used = {w["config"] for w in M["workloads"]}
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in M["paths"])
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert run.load_json(os.path.join(ROOT, c["file"]))["reduced"] == c["reduced"]
    assert len({c["file"] for c in M["configs"]}) == len(M["configs"])


def test_workloads():
    assert 1 <= len(M["workloads"]) <= 24
    pairs = set()
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and line(w["why"])
        assert w["chips"] in (1, 4)
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(M["workloads"])
    assert sum(w["chips"] == 4 for w in M["workloads"]) <= max(1, len(M["workloads"]) // 4)


def test_metrics():
    names = [m["name"] for m in M["end_to_end"] + M["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in M["end_to_end"]}
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16
    for m in M["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    layers = {}
    for m in M["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") and line(m["layer"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", [cell])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("cell", [w["name"] for w in M["workloads"]])
def test_every_cell_resolves_and_reports(cell):
    spec = run.resolve(M, cell)
    assert hasattr(spec["entry"], "Cell")
    names = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert spec["per_layer"] and all(hasattr(mod, "read") for _, mod in spec["per_layer"])
    assert spec["limits"] and all(v > 0 for v in spec["limits"].values())


def test_the_command_names_only_files_under_paths():
    for word in M["command"]:
        assert not word.startswith("/") and ".." not in word
        if word.endswith(".py"):
            assert any(word.startswith(p + "/") for p in M["paths"])
    assert M["command"][-1].replace(".", "/") + ".py" in (
        os.path.relpath(os.path.join(ROOT, "benchmark", "run.py"), ROOT),)
