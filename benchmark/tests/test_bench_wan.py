"""The cell ``wan21_i2v_14b.i2v_step`` at the tiny size on the CPU: the plain
reference (``benchmark/reference/wan.py``) against the program in f32
through the cell's own comparison, the benchmark's weights loading by name
into the program with no layer left at zero, and the faults that the
comparison must catch, each planted in the program under a whole run: RoPE
left out, the image cross-attention left out, the q/k RMSNorm taken per head
instead of across heads, and the first-frame mask zeroed.  RoPE left out
moves the step by about 1% of the model's part (with random weights the
self-attention is close to a uniform average); the reading of the first
block's self-attention (``self_attn_err``) is what catches it."""

from __future__ import annotations

import os

import pytest
import torch

from benchmark import common, run
from benchmark.entries import wan_i2v_denoise_step as entry
from benchmark.tests import tiny

CELL = "wan21_i2v_14b.i2v_step"
MANIFEST = run.load_json(os.path.join(run.ROOT, "BENCHMARK.json"))
TINY = tiny.cell(CELL)[0]
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
        readings = dict(cell.compare({"step": step}))
        assert set(readings) == {"step_err", "self_attn_err"}
        assert max(readings.values()) < F32_AGREE, (step, readings)


def test_weights_load_by_name_and_no_layer_is_zero():
    cell = f32_cell(5)
    names = {n for n, _ in cell.transformer.named_parameters()}
    assert names == set(entry.reference_model(cell.cfg).state_dict())
    for name, p in cell.transformer.named_parameters():
        assert p.device.type == "cpu" and p.abs().max() > 0, name


def test_the_mask_is_the_pipelines():
    cell = f32_cell(6)
    assert torch.equal(cell.y, entry.mask_and_latent(TINY, cell.inputs["image_latent"]))


def no_rope(mp):
    from streamingt2v_torch.models import wan
    mp.setattr(wan, "apply_rope", lambda x, cos, sin: x)


def no_image_cross_attention(mp):
    from streamingt2v_torch.models import wan
    real = wan.attention

    def attention(q, k, v, *, num_heads):
        out = real(q, k, v, num_heads=num_heads)
        # the image keys' call: as many keys as the CLIP tokens
        return torch.zeros_like(out) if k.shape[1] == TINY["pipeline"]["clip_tokens"] else out
    mp.setattr(wan, "attention", attention)


def rms_norm_per_head(mp):
    from streamingt2v_torch.models import wan
    real = wan.rms_norm

    def rms_norm(x, scale, *, eps):
        xs = x.unflatten(-1, (TINY["transformer"]["num_heads"], -1))
        out = real(xs, torch.ones(xs.shape[-1], dtype=scale.dtype), eps=eps)
        return (out.flatten(-2) * scale).to(x.dtype)
    mp.setattr(wan, "rms_norm", rms_norm)


def mask_zeroed(mp):
    from streamingt2v_torch.pipeline import wan
    real = wan.first_frame_mask
    mp.setattr(wan, "first_frame_mask", lambda cfg, device=None: torch.zeros_like(
        real(cfg, device)))


FAULTS = [no_rope, no_image_cross_attention, rms_norm_per_head, mask_zeroed]


@pytest.mark.parametrize("fault", FAULTS, ids=[f.__name__ for f in FAULTS])
def test_a_fault_makes_the_run_incorrect(fault, monkeypatch):
    fault(monkeypatch)
    res = run.run_cell(spec_of(), 2**31 + 99, 1.0, False, "cpu")
    assert res["correct"] is False and res["failed"] == 1
