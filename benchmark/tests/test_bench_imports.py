"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the port: checked in fresh processes by the
top-level name of every loaded module, compared whole (the port's name
begins with the JAX package's)."""

from __future__ import annotations

import json
import subprocess
import sys

from benchmark import run

RUN_TINY = """
import json, sys, os, glob
from benchmark import run
from benchmark.tests import tiny
man = run.load_json(os.path.join(run.ROOT, "BENCHMARK.json"))
for name in [w["name"] for w in man["workloads"]]:
    spec = run.resolve(man, name)
    spec["config"], spec["traffic"] = tiny.cell(name)
    run.run_cell(spec, 1, 1.0, True, "cpu")
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

IMPORT_REFERENCE = """
import json, sys, pkgutil, importlib
import benchmark.reference
for m in pkgutil.iter_modules(benchmark.reference.__path__):
    importlib.import_module("benchmark.reference." + m.name)
import benchmark.weights, benchmark.flops, benchmark.kernel_classes
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    names = loaded(RUN_TINY)
    assert "streamingt2v_torch" in names      # the program ran
    assert not names & {"jax", "jaxlib", "flax", "streamingt2v_tpu"}


def test_the_reference_loads_nothing_of_the_program():
    names = loaded(IMPORT_REFERENCE)
    assert "torch" in names
    assert not names & {"streamingt2v_torch", "streamingt2v_tpu", "jax", "jaxlib", "flax"}


def test_forbidden_names_compare_whole():
    sys.modules.setdefault("streamingt2v_torch_not_jax", sys)
    try:
        assert "streamingt2v_torch_not_jax" not in run.forbidden_modules()
    finally:
        del sys.modules["streamingt2v_torch_not_jax"]
