"""The port's small public pieces against the JAX package on the CPU: the
AlphaBlender op (``streamingt2v_torch/ops/blend.py``), the lazy top-level
API, and the examples of ``examples/torch/`` run at their tiny widths.

Tolerances: the blend in f32 within 1e-6, in bf16 within 1e-2 of max |JAX
value| (one bf16 rounding of alpha apart at most: the port takes the
sigmoid in f32); the sharded example's output within 1e-5 of max |the
one-process output| (the ring and the tensor-parallel sums add in another
order)."""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import assert_close
from streamingt2v_tpu.ops import blend as jblend
from streamingt2v_torch.ops import alpha_blend, blend_weight

REPO = Path(__file__).resolve().parents[1]
EXAMPLES = REPO / "examples" / "torch"
STRATEGIES = ("fixed", "learned", "learned_with_images")
DTYPES = {"f32": (torch.float32, jnp.float32, 1e-6), "bf16": (torch.bfloat16, jnp.bfloat16, 1e-2)}


# ------------------------------------------------------------- the blend ---

def test_alpha_blender_strategies():
    """``tests/test_ops.py``'s cases on the port's op."""
    spatial, temporal = torch.ones(2, 3, 4), torch.zeros(2, 3, 4)
    out = alpha_blend(spatial, temporal, torch.tensor(0.25), strategy="fixed")
    torch.testing.assert_close(out, torch.full((2, 3, 4), 0.25))
    out = alpha_blend(spatial, temporal, torch.tensor(0.0), strategy="learned")
    torch.testing.assert_close(out, torch.full((2, 3, 4), 0.5))
    w = blend_weight(torch.tensor(0.0), strategy="learned_with_images",
                     image_indicator=torch.tensor([True, False]))
    torch.testing.assert_close(w, torch.tensor([1.0, 0.5]))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_alpha_blend_matches_jax(strategy, dtype):
    """Branches (B, T, S, C) in ``dtype``, a (1,) mix factor in the same
    dtype and a (B, T) image indicator: alpha and the blend against the
    JAX ops."""
    tdt, jdt, tol = DTYPES[dtype]
    rng = np.random.RandomState(STRATEGIES.index(strategy))
    spatial, temporal = (rng.randn(2, 3, 5, 8).astype(np.float32) for _ in range(2))
    mix = (rng.rand(1).astype(np.float32) if strategy == "fixed"
           else rng.randn(1).astype(np.float32))
    ind = np.array([[True, False, True], [False, False, True]])
    kw = {"image_indicator": ind} if strategy == "learned_with_images" else {}

    def port(x):
        return torch.from_numpy(x).to(tdt)

    jw = jblend.blend_weight(jnp.asarray(mix, jdt), strategy=strategy,
                             **{k: jnp.asarray(v) for k, v in kw.items()})
    pw = blend_weight(port(mix), strategy=strategy,
                      **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert_close(pw, np.asarray(jw, np.float32), tol, f"{strategy} alpha")
    ref = jblend.alpha_blend(jnp.asarray(spatial, jdt), jnp.asarray(temporal, jdt),
                             jnp.asarray(mix, jdt), strategy=strategy,
                             **{k: jnp.asarray(v) for k, v in kw.items()})
    got = alpha_blend(port(spatial), port(temporal), port(mix), strategy=strategy,
                      **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert got.dtype == tdt and got.shape == ref.shape
    assert_close(got, np.asarray(ref, np.float32), tol, f"{strategy} blend")


def test_unknown_blend_strategy_raises():
    with pytest.raises(ValueError, match="mystery"):
        blend_weight(torch.tensor(0.0), strategy="mystery")
    with pytest.raises(ValueError, match="mystery"):
        alpha_blend(torch.ones(2), torch.zeros(2), torch.tensor(0.0), strategy="mystery")
    with pytest.raises(ValueError, match="image_indicator"):
        blend_weight(torch.tensor(0.0), strategy="learned_with_images")


def test_unet_blender_is_alpha_blend():
    """The UNet's ``blend_with_images`` is ``alpha_blend``'s
    ``learned_with_images``, bit for bit."""
    from streamingt2v_torch.models.unet_blocks import blend_with_images

    g = torch.Generator().manual_seed(0)
    spatial, temporal = (torch.randn(2, 3, 6, 4, generator=g) for _ in range(2))
    mix, ind = torch.randn(1, generator=g), torch.tensor([[True, False, False]] * 2)
    assert torch.equal(blend_with_images(mix, spatial, temporal, ind),
                       alpha_blend(spatial, temporal, mix, image_indicator=ind))


# ---------------------------------------------------------- the lazy API ---

def test_lazy_top_level_api():
    """The JAX package's three top-level names resolve to the port's
    objects; another name raises ``AttributeError``."""
    import streamingt2v_torch as pkg
    from streamingt2v_torch.config import PipelineConfig
    from streamingt2v_torch.pipeline.build import build_pipeline
    from streamingt2v_torch.pipeline.full import StreamingT2VPipeline

    assert pkg.PipelineConfig is PipelineConfig
    assert pkg.build_pipeline is build_pipeline
    assert pkg.StreamingT2VPipeline is StreamingT2VPipeline
    with pytest.raises(AttributeError):
        pkg.NoSuchName    # noqa: B018
    assert not hasattr(pkg, "make_sampler")


# ---------------------------------------------------------- the examples ---

def _run(args, timeout: float, cwd) -> str:
    proc = subprocess.run([sys.executable] + [str(a) for a in args], cwd=cwd,
                          capture_output=True, text=True, timeout=timeout,
                          env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def test_tiny_image_to_video_example(tmp_path):
    from streamingt2v_torch.utils import media

    out = tmp_path / "tiny.y4m"
    log = _run([EXAMPLES / "tiny_image_to_video.py", "--device", "cpu", "--output", out], 240,
               tmp_path)
    info = media.y4m_info(str(out))
    assert info["frames"] > 1 and (info["width"], info["height"]) == (32, 32), info
    assert "'stage1': True, 'enhance': True, 'vfi': True" in log, log


def test_custom_schedule_example(tmp_path):
    """Every sampler x discretization x guider: 72 finite samples (2 steps
    here, to keep the test short)."""
    log = _run([EXAMPLES / "custom_schedule.py", "--device", "cpu", "--steps", "2"], 240,
               tmp_path)
    lines = [ln for ln in log.splitlines() if "->" in ln]
    assert len(lines) == 72 and all("finite=True" in ln for ln in lines), log


def test_sharded_denoise_example_matches_one_process(tmp_path):
    """``torch.distributed.run --standalone`` with four gloo ranks at (1, 2,
    2) (the tokens over seq, the heads and FF widths over model) against
    the example in one process."""
    one, four = tmp_path / "one.pt", tmp_path / "four.pt"
    _run([EXAMPLES / "sharded_denoise.py", "--device", "cpu", "--output", one], 120, tmp_path)
    log = _run(["-m", "torch.distributed.run", "--standalone", "--nproc_per_node=4",
                EXAMPLES / "sharded_denoise.py", "--device", "cpu", "--mesh", "1,2,2",
                "--output", four], 180, tmp_path)
    assert "'seq': 2, 'model': 2" in log and "finite=True" in log, log
    ref, got = torch.load(one), torch.load(four)
    assert ref.shape == got.shape == (1, 4, 16, 16, 4)
    assert_close(got, ref.numpy(), 1e-5, "sharded denoise")
