"""On the card: each cell at its own size for a short window, correct, with
every per-layer metric it lists read from its trace, and the control
failing its limits.  Skipped without a CUDA device.

    python -m pytest benchmark/tests/test_bench_card.py -q -m card
"""

from __future__ import annotations

import os

import pytest

from benchmark import run

M = run.load_json(os.path.join(run.ROOT, "BENCHMARK.json"))


@pytest.mark.card
@pytest.mark.parametrize("name", [w["name"] for w in M["workloads"]])
def test_a_short_traced_run_is_correct(card, name):
    spec = run.resolve(M, name)
    run.use_caches()
    res = run.run_cell(spec, 2**31 + 4242, 3.0, True, card)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {m["name"] for m, _ in spec["per_layer"]}
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
    for m in res["metrics"]:
        if m.endswith("_roofline") or "mfu" in m:
            assert 0 < res["metrics"][m]["value"] <= 100


@pytest.mark.card
@pytest.mark.parametrize("name", [w["name"] for w in M["workloads"]])
def test_the_control_fails_at_the_cells_size(card, name):
    import gc

    import torch

    from benchmark import common

    spec = run.resolve(M, name)
    cell = spec["entry"].Cell(spec["config"], spec["traffic"], 2**31 + 4343, card)
    cell.run(common.Unbounded(3, card))     # the checked decode call is one of three
    cell.release()
    gc.collect()
    torch.cuda.empty_cache()
    plan = cell.plan_check()
    limits = spec["limits"]
    assert all(v <= limits[n] for n, v in cell.compare(plan))
    assert any(v > limits[n] for n, v in cell.compare(plan, control=True))
