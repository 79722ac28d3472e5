"""Tiny variants of the cells for the CPU tests, found by name as the runner
finds the cells' own files: ``benchmark/tests/tiny/configs/<config>.json``
and ``benchmark/tests/tiny/traffic/<traffic>.json``, each with the keys of
the cell's file at widths a CPU runs in seconds.  A new cell brings its
tiny traffic, and a new configuration its tiny configuration, as new
files."""

from __future__ import annotations

import os

from benchmark import run


def cell(name: str, manifest: dict = None, root: str = run.ROOT) -> tuple:
    """(config, traffic) of a cell at the tiny size, fresh copies, resolved
    through ``manifest`` (``root``'s ``BENCHMARK.json`` by default)."""
    if manifest is None:
        manifest = run.load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json: {sorted(cells)}")
    out = []
    for kind, key in (("configs", "config"), ("traffic", "traffic")):
        rel = os.path.join("benchmark", "tests", "tiny", kind, f"{cells[name][key]}.json")
        path = os.path.join(root, rel)
        if not os.path.isfile(path):
            raise FileNotFoundError(f"cell {name!r} has no tiny {key}: add {rel}")
        out.append(run.load_json(path))
    return tuple(out)
