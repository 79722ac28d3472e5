"""The comparison that decides ``correct`` fails what it must, at the tiny
size on the CPU, with each cell's own limits:

- the control, the reference computed in fp8 (one precision below the
  configurations' bf16) in the program's place;
- each fault that a cell can have, planted in the program under a whole
  run (the look for a card skipped): a step that returns its state
  unchanged, half of the batch left out, an answer altered where it is
  produced.  One chip holds no exchange between chips to leave out.

A cell added later brings its planted faults in a test file of its own.
"""

from __future__ import annotations

import os

import pytest
import torch

from benchmark import common, run
from benchmark.tests import tiny

MANIFEST = run.load_json(os.path.join(run.ROOT, "BENCHMARK.json"))
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def spec_of(name: str) -> dict:
    spec = run.resolve(MANIFEST, name)
    spec["config"], spec["traffic"] = tiny.cell(name)
    return spec


def failed(readings, limits) -> list:
    return [n for n, v in readings if not v <= limits[n]]


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [1, 2**31 + 5, 3000000019])
def test_the_control_fails(name, seed):
    spec = spec_of(name)
    cell = spec["entry"].Cell(spec["config"], spec["traffic"], seed, "cpu")
    cell.run(common.Unbounded(3, "cpu"))
    cell.release()
    plan = cell.plan_check()
    assert not failed(cell.compare(plan), spec["limits"])
    assert failed(cell.compare(plan, control=True), spec["limits"])


# ---- faults planted in the program ----

def stage1_state_unchanged(mp):
    from streamingt2v_torch.diffusion import samplers
    mp.setattr(samplers, "_to_d", lambda x, sigma, den: torch.zeros_like(x))


def stage1_half_batch(mp):
    """The guidance sees the conditional half twice: the unconditional
    half's network call left out."""
    from streamingt2v_torch.pipeline import streaming
    real = streaming.streaming_wrapper

    def wrapper(*a, **k):
        net = real(*a, **k)
        return lambda x, t, cond: net(x, t, cond)[1:].repeat(2, 1, 1, 1, 1)
    mp.setattr(streaming, "streaming_wrapper", wrapper)


def stage1_answer_altered(mp):
    from streamingt2v_torch.diffusion import samplers
    real = samplers._to_d

    def to_d(x, sigma, den):
        d = real(x, sigma, den)
        d[:, 0] += 1.0
        return d
    mp.setattr(samplers, "_to_d", to_d)


def stage2_state_unchanged(mp):
    from streamingt2v_torch.pipeline.enhance import EnhancePipeline
    mp.setattr(EnhancePipeline, "_write_back",
               staticmethod(lambda latents, denoised, si, noise, **k: latents.clone()))


def stage2_half_batch(mp):
    """Each chunk's conditional UNet call left out: its unconditional output
    stands for both."""
    from streamingt2v_torch.pipeline.enhance import EnhancePipeline
    real = EnhancePipeline._denoise_chunk

    def chunk(self, x, t, prompt, clip, il):
        return real(self, x, t, prompt[:1].repeat(2, 1, 1), clip[:1].repeat(2, 1),
                    il[:1].repeat(2, 1, 1, 1, 1))
    mp.setattr(EnhancePipeline, "_denoise_chunk", chunk)


def stage2_answer_altered(mp):
    from streamingt2v_torch.diffusion.ddim import DDIMScheduler
    real = DDIMScheduler.step

    def step(self, *a, **k):
        out = real(self, *a, **k)
        out[:, 1] += 1.0
        return out
    mp.setattr(DDIMScheduler, "step", step)


def decode_half_batch(mp):
    """Half of each piece's frames decoded, the rest their mean."""
    from streamingt2v_torch.pipeline.streaming import Stage1Pipeline
    real = Stage1Pipeline.decode_chunk

    def decode(self, z):
        n = max(1, z.shape[1] // 2)
        out = real(self, z[:, :n])
        rest = out.mean(dim=1, keepdim=True).expand((1, z.shape[1] - n) + out.shape[2:])
        return torch.cat([out, rest], dim=1)
    mp.setattr(Stage1Pipeline, "decode_chunk", decode)


def decode_answer_altered(mp):
    from streamingt2v_torch.pipeline.streaming import Stage1Pipeline
    real = Stage1Pipeline.decode_chunk

    def decode(self, z):
        out = real(self, z)
        out[:, 0] = -out[:, 0]
        return out
    mp.setattr(Stage1Pipeline, "decode_chunk", decode)


FAULTS = [
    ("streamingsvd.ar_chunk", stage1_state_unchanged),
    ("streamingsvd.ar_chunk", stage1_half_batch),
    ("streamingsvd.ar_chunk", stage1_answer_altered),
    ("i2vgen_xl.enhance_chunk", stage2_state_unchanged),
    ("i2vgen_xl.enhance_chunk", stage2_half_batch),
    ("i2vgen_xl.enhance_chunk", stage2_answer_altered),
    ("streamingsvd.vae_decode", decode_half_batch),
    ("streamingsvd.vae_decode", decode_answer_altered),
]


@pytest.mark.parametrize("name,fault", FAULTS, ids=[f.__name__ for _, f in FAULTS])
def test_a_fault_makes_the_run_incorrect(name, fault, monkeypatch):
    fault(monkeypatch)
    res = run.run_cell(spec_of(name), 2**31 + 99, 1.0, False, "cpu")
    assert res["correct"] is False and res["failed"] == 1
