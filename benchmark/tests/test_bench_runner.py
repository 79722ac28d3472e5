"""The runner: its arguments, the result's keys, the stop rule of the
window and each cell's work at the tiny size on the CPU."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark import common, run
from benchmark.tests import tiny

ROOT = run.ROOT
MANIFEST = run.load_json(os.path.join(ROOT, "BENCHMARK.json"))
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def tiny_spec(name: str) -> dict:
    spec = run.resolve(MANIFEST, name)
    spec["config"], spec["traffic"] = tiny.cell(name)
    return spec


def test_arguments():
    a = run.parse_args(["--workload", "x", "--seed", "3000000000", "--seconds", "10",
                        "--trace", "1"])
    assert (a.workload, a.seed, a.seconds, a.trace) == ("x", 3000000000, 10.0, 1)
    assert run.parse_args(["--workload", "x", "--seed", "1", "--seconds", "2"]).trace == 0
    with pytest.raises(SystemExit):
        run.parse_args(["--workload", "x", "--seed", "1", "--seconds", "2", "--trace", "2"])
    with pytest.raises(SystemExit):
        run.parse_args(["--seed", "1", "--seconds", "2"])


def test_unknown_cell_raises():
    with pytest.raises(KeyError):
        run.resolve(MANIFEST, "no.such_cell")


def test_without_a_card_exits_nonzero_and_prints_nothing():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", CELLS[0],
                          "--seed", "5", "--seconds", "1"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout == ""


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_result_keys(name, trace):
    res = run.run_cell(tiny_spec(name), 2**31 + 12345, 1.0, trace, "cpu")
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(res)
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    cell = next(w for w in MANIFEST["workloads"] if w["name"] == name)
    assert res["device"]["count"] == cell["chips"]
    if trace:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        wanted = {m["name"] for m in MANIFEST["end_to_end"]
                  if name in m.get("workloads", [name])}
        assert set(res["metrics"]) == wanted
        assert all(m["value"] > 0 for k, m in res["metrics"].items() if k != "peak_gib")
    assert set(res["checks"]) == set(run.load_json(
        os.path.join(ROOT, "benchmark", "limits", f"{name}.json")))
    json.dumps(res)


@pytest.mark.parametrize("name", CELLS)
def test_stop_rule_and_work(name):
    """A window of n units runs exactly n; the work counts them."""
    spec = tiny_spec(name)
    cell = spec["entry"].Cell(spec["config"], spec["traffic"], 99, "cpu")
    for n in (1, 3):
        window = common.Unbounded(n, "cpu")
        cell.run(window)
        assert window.units == n
    work = cell.work(3)
    if cell.unit == "step":
        assert work == {"steps": 3}
    elif "frames" in work:
        assert work["frames"] == 3 * spec["config"]["inference"]["chunk_frames"]
    else:
        assert work["steps"] == 3 * cell.steps_per_unit


@pytest.mark.parametrize("name", CELLS)
def test_window_closes_on_time(name):
    """The window closes at the first unit boundary after its seconds."""
    spec = tiny_spec(name)
    cell = spec["entry"].Cell(spec["config"], spec["traffic"], 7, "cpu")
    window = common.Window(0.5, "cpu")
    cell.run(window)
    assert window.elapsed >= 0.5 and window.units >= 1


def test_stage1_chunks_follow_each_other():
    """A window longer than a chunk starts the next chunk from its own noise:
    steps are counted over chunks and every chunk's output is kept."""
    spec = tiny_spec("streamingsvd.ar_chunk")
    cell = spec["entry"].Cell(spec["config"], spec["traffic"], 3, "cpu")
    steps = spec["config"]["sampler"]["num_steps"]
    cell.run(common.Unbounded(2 * steps + 1, "cpu"))
    assert sorted(cell.outputs) == [0, 1]
    assert len(cell.records) == 2 * steps + 1
    assert len(cell._pairs()) == 2 * steps


def test_stage2_restarts_after_the_last_timestep(monkeypatch):
    spec = tiny_spec("i2vgen_xl.enhance_chunk")
    monkeypatch.setattr(spec["entry"], "RECORD_CALLS", 40)   # more calls than a window holds
    cell = spec["entry"].Cell(spec["config"], spec["traffic"], 3, "cpu")
    n = len(cell.inputs["timesteps"])
    cell.run(common.Unbounded(n + 1, "cpu"))
    assert len(cell.states) == n + 2
    cell.release()
    # the call after the last timestep starts again from the first
    (name, value), = cell.compare({"call": n, "chunk": 0})
    assert value < 0.5
