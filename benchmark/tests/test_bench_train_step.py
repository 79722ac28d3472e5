"""The training cell, ``streamingsvd.train_step``, at the tiny size on the
CPU: its reference against the port with both in f32 (the same losses,
gradients, changes and EMA shadows, to the order of the sums) and its
weights; and each fault that a training step can have, planted in the
program under a whole run (the look for a card skipped), turning
``correct`` false with the cell's own limits:

- a step that returns its state unchanged (the optimizer's update left out);
- half of the clip left out, the loss's mean taken over the other frames;
- an answer altered where it is produced (the network's prediction of one
  frame);
- one parameter's gradient dropped (level 0's first ``to_q``, K1's input);
- the loss taken at twice the drawn sigma;
- a step run on the conditioning of the clip before it (the first on zeros);
- the EMA's update left out (its shadow left unchanged);
- the EMA at its final decay from the first step (no warm-up).

One chip holds no exchange between chips to leave out.  On the card
(``-m card``) the faults are read at the cell's own size, on three seeds,
each reading printed beside the sound program's and the control's.  The
cell's counted operations are ``test_bench_flops.py``'s, as every cell's.
"""

from __future__ import annotations

import gc
import json
import os

import pytest
import torch

from benchmark import common, run
from benchmark.tests import tiny

NAME = "streamingsvd.train_step"
MANIFEST = run.load_json(os.path.join(run.ROOT, "BENCHMARK.json"))
TO_Q = "input_0_attn.block_0.attn1.to_q.kernel"
# f32 on both sides: what is left is the order of the sums
F32_AGREE = 1e-4


def spec_of(dtype: str = None) -> dict:
    spec = run.resolve(MANIFEST, NAME)
    spec["config"], spec["traffic"] = tiny.cell(NAME)
    if dtype is not None:
        spec["config"]["dtype"] = dtype
    return spec


# ---- faults planted in the program ----

def state_unchanged(mp):
    from streamingt2v_torch.parallel.train import TrainStep
    mp.setattr(TrainStep, "update", lambda self: True)


def half_the_clip(mp):
    """The loss of the first half of the frames only: the network sees them
    alone and the mean runs over them."""
    from streamingt2v_torch.parallel import train
    real = train.diffusion_loss

    def loss(cfg, net, x0, cond, generator=None, *, sigmas=None, noise=None, offset=None):
        h = x0.shape[1] // 2
        return real(cfg, net, x0[:, :h], {k: v[:, :h] for k, v in cond.items()}, generator,
                    sigmas=sigmas, noise=noise[:, :h], offset=offset)
    mp.setattr(train, "diffusion_loss", loss)


def answer_altered(mp):
    from streamingt2v_torch.models import wrappers
    real = wrappers.openai_wrapper

    def wrapper(unet, mesh=None):
        net = real(unet, mesh)

        def altered(x, t, cond):
            out = net(x, t, cond)
            return torch.cat([out[:, :1] + 1.0, out[:, 1:]], dim=1)
        return altered
    mp.setattr(wrappers, "openai_wrapper", wrapper)


def gradient_dropped(mp):
    from streamingt2v_torch.diffusion.engine import DiffusionEngine
    real = DiffusionEngine.backward

    def backward(self, *a, **k):
        loss = real(self, *a, **k)
        self.model.get_parameter(TO_Q).grad.zero_()
        return loss
    mp.setattr(DiffusionEngine, "backward", backward)


def sigma_moved(mp):
    from streamingt2v_torch.parallel import train
    real = train.diffusion_loss

    def loss(*a, sigmas=None, **k):
        return real(*a, sigmas=sigmas * 2.0, **k)
    mp.setattr(train, "diffusion_loss", loss)


def stale_conditioning(mp):
    """Each step on the conditioning of the step before's clip, the first on
    zeros: a conditioning buffer filled one step late."""
    from streamingt2v_torch.diffusion.engine import DiffusionEngine
    real = DiffusionEngine.backward
    seen = []

    def backward(self, batch, *a, **k):
        cond = seen[-1] if seen else {n: torch.zeros_like(v) for n, v in batch["cond"].items()}
        seen.append(batch["cond"])
        return real(self, dict(batch, cond=cond), *a, **k)
    mp.setattr(DiffusionEngine, "backward", backward)


def ema_skipped(mp):
    from streamingt2v_torch.diffusion import engine
    mp.setattr(engine, "ema_update", lambda state, *a, **k: state)


def ema_without_warm_up(mp):
    from streamingt2v_torch.diffusion import engine
    real = engine.ema_update
    mp.setattr(engine, "ema_update",
               lambda state, params, decay: real(state, params, decay, use_num_updates=False))


FAULTS = [state_unchanged, half_the_clip, answer_altered, gradient_dropped, sigma_moved,
          stale_conditioning, ema_skipped, ema_without_warm_up]


@pytest.mark.parametrize("fault", FAULTS, ids=[f.__name__ for f in FAULTS])
def test_a_fault_makes_the_train_step_incorrect(fault, monkeypatch):
    fault(monkeypatch)
    res = run.run_cell(spec_of(), 2**31 + 99, 1.0, False, "cpu")
    assert res["correct"] is False and res["failed"] == 1, res["checks"]


# ---- the reference and the yardstick ----

def test_reference_agrees_with_the_port_in_f32():
    spec = spec_of("float32")
    cell = spec["entry"].Cell(spec["config"], spec["traffic"], 2**31 + 77, "cpu")
    cell.warm_up()
    cell.release()
    for check, value in cell.compare(cell.plan_check()):
        assert value < F32_AGREE, (check, value)


def test_weights_load_strictly_and_no_layer_is_zero():
    spec = spec_of()
    cell = spec["entry"].Cell(spec["config"], spec["traffic"], 5, "cpu")
    ref = spec["entry"].reference_unet(spec["config"])
    assert cell.names == [n for n, _ in ref.named_parameters()]
    for pname, p in cell.unet.named_parameters():
        assert p.requires_grad and p.abs().max() > 0, pname


def test_the_checked_steps_are_set_up_on_distinct_clips():
    spec = spec_of()
    cell = spec["entry"].Cell(spec["config"], spec["traffic"], 11, "cpu")
    cell.warm_up()
    assert cell.taken == spec["traffic"]["checked_steps"]
    plan = cell.plan_check()
    assert plan["losses"].shape == (cell.taken,)
    clips = [b["latents"] for b in cell.batches]
    assert all(not torch.equal(a, b) for i, a in enumerate(clips) for b in clips[i + 1:])
    cell.run(common.Unbounded(2, "cpu"))      # the window goes on from the same engine
    assert cell.taken == spec["traffic"]["checked_steps"] + 2
    later = cell.plan_check()
    assert all(torch.equal(later[k], plan[k]) for k in ("change_norms", "ema_norms"))


# ---- on the card, at the cell's own size ----

@pytest.mark.card
def test_faults_fail_at_the_cells_size(card):
    """For three seeds: the sound program's readings, the control's and each
    fault's but the state left unchanged (which reads 1 by construction),
    one JSON line each; the sound runs pass the limits, the control and
    every fault but ``sigma_moved`` fail them.  With the clean latents and
    the noise both standard normal, the network's input and the loss's
    target are standard normal at every sigma: a sigma twice the drawn one
    changes only the time embedding and reads like a sound run at this
    size (it is caught at the tiny size only)."""
    spec = run.resolve(MANIFEST, NAME)
    run.use_caches()
    limits = spec["limits"]
    rows = []
    for seed in (2**31 + 4545, 2**31 + 4546, 2**31 + 4547):
        for fault in [None] + FAULTS[1:]:
            with pytest.MonkeyPatch.context() as mp:
                if fault is not None:
                    fault(mp)
                cell = spec["entry"].Cell(spec["config"], spec["traffic"], seed, card)
                cell.warm_up()
                cell.release()
                gc.collect()
                torch.cuda.empty_cache()
            plan = cell.plan_check()
            runs = [(fault.__name__ if fault else "program", False)]
            if fault is None:
                runs.append(("control", True))
            for name, control in runs:
                rows.append((seed, name, dict(cell.compare(plan, control=control))))
                print(json.dumps({"seed": seed, "run": name, **rows[-1][2]}), flush=True)
            del cell
            gc.collect()
            torch.cuda.empty_cache()
    for seed, name, readings in rows:
        broken = any(v > limits[n] for n, v in readings.items())
        if name == "program":
            assert not broken, (seed, readings)
        elif name != "sigma_moved":
            assert broken, (seed, name, readings)
