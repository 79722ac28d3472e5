"""The cell ``cogvideox_5b.t2v_step`` at the tiny size on the CPU: the plain
reference (``benchmark/reference/cogvideox.py``) against the program in
f32 through the cell's own comparison, the benchmark's weights loading by
name into the program with no layer left at zero, and the faults that the
comparison must catch, each planted in the program under a whole run:
RoPE left out, the q/k LayerNorm left out, and the text tokens modulated
and gated with the video's shift, scale and gate."""

from __future__ import annotations

import os

import pytest
import torch

from benchmark import common, run
from benchmark.entries import cogvideox_denoise_step as entry
from benchmark.tests import tiny

CELL = "cogvideox_5b.t2v_step"
MANIFEST = run.load_json(os.path.join(run.ROOT, "BENCHMARK.json"))
# f32 on both sides: what is left is the order of the sums
F32_AGREE = 1e-4


def spec_of() -> dict:
    spec = run.resolve(MANIFEST, CELL)
    spec["config"], spec["traffic"] = tiny.cell(CELL)
    return spec


def f32_cell(seed: int) -> entry.Cell:
    cfg, traffic = tiny.cell(CELL)
    cfg["dtype"] = "float32"
    return entry.Cell(cfg, traffic, seed, "cpu")


@pytest.mark.parametrize("seed", [3, 2**31 + 77])
def test_reference_agrees_with_the_program_in_f32(seed):
    cell = f32_cell(seed)
    cell.run(common.Unbounded(6, "cpu"))       # past the tiny schedule's 4 steps
    cell.release()
    for step in range(6):
        (name, value), = cell.compare({"step": step})
        assert value < F32_AGREE, (step, value)


def test_weights_load_by_name_and_no_layer_is_zero():
    cell = f32_cell(5)
    names = {n for n, _ in cell.transformer.named_parameters()}
    assert names == set(entry.reference_model(cell.cfg).state_dict())
    for name, p in cell.transformer.named_parameters():
        assert p.device.type == "cpu" and p.abs().max() > 0, name


def no_rope(mp):
    from streamingt2v_torch.models import cogvideox
    mp.setattr(cogvideox, "apply_rope", lambda x, cos, sin: x)


def no_qk_norm(mp):
    from streamingt2v_torch.models import cogvideox
    real = cogvideox.layer_norm

    def layer_norm(x, *a, **k):
        return x.clone() if x.ndim == 4 else real(x, *a, **k)
    mp.setattr(cogvideox, "layer_norm", layer_norm)


def text_takes_the_videos_modulation(mp):
    from streamingt2v_torch.models import cogvideox
    real_norm = cogvideox.LayerNormZero.forward
    real_add = cogvideox.gated_add_

    def forward(self, h, temb_act, text_len):
        return real_norm(self, h, temb_act, 0)

    mp.setattr(cogvideox.LayerNormZero, "forward", forward)
    mp.setattr(cogvideox, "gated_add_", lambda h, y, gates, text_len: real_add(h, y, gates, 0))


FAULTS = [no_rope, no_qk_norm, text_takes_the_videos_modulation]


@pytest.mark.parametrize("fault", FAULTS, ids=[f.__name__ for f in FAULTS])
def test_a_fault_makes_the_run_incorrect(fault, monkeypatch):
    fault(monkeypatch)
    res = run.run_cell(spec_of(), 2**31 + 99, 1.0, False, "cpu")
    assert res["correct"] is False and res["failed"] == 1
