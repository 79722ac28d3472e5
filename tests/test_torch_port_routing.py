"""PyTorch port, stage 1's kernel routing on the CPU: which GroupNorms take
the K5 wrapper (``ops/fused_group_norm.fused_group_norm``, its plain version
on the CPU) under ``PipelineConfig``'s default routing, and which stay on
the plain path of ``ops/norms.py``.

The tiny stage-1 pipeline runs ``image_to_video`` once with both ends
counted: the wrapper's calls and the plain path's (``norms._grouped``, by
the norm that calls it and the input's rank), each under the network whose
forward is open (forward hooks).  The full-width pipeline, built on the meta
device, gives the geometries at which ``chip_smoke.check_k5`` must hold K5
on the card."""

import collections
import dataclasses
import sys

import pytest
import torch

import chip_smoke
from streamingt2v_torch.config import PipelineConfig, VideoUNetConfig
from streamingt2v_torch.diffusion.engine import DiffusionEngine
from streamingt2v_torch.models.layers import init_random_
from streamingt2v_torch.models.video_unet import VideoUNet
from streamingt2v_torch.ops import norms
from streamingt2v_torch.ops.routing import use_routing
from streamingt2v_torch.pipeline.build import build_pipeline

NETWORKS = ("svd_unet", "unet", "controlnet", "vae.decoder", "cond_encoder")


class NormCalls:
    """Counts of K5 wrapper calls, keyed (network, rank), and of plain-path
    calls, keyed (network, norm, rank), while ``patch`` is in force."""

    def __init__(self):
        self.k5 = collections.Counter()
        self.plain = collections.Counter()
        self.open = []

    def patch(self, mp: pytest.MonkeyPatch) -> None:
        fused, grouped = norms.fused_group_norm, norms._grouped

        def counted_fused(x, *args, **kw):
            self.k5[self.where(), x.ndim] += 1
            return fused(x, *args, **kw)

        def counted_grouped(x, num_groups):
            caller = sys._getframe(1).f_code.co_name
            self.plain[self.where(), caller, x.ndim] += 1
            return grouped(x, num_groups)

        mp.setattr(norms, "fused_group_norm", counted_fused)
        mp.setattr(norms, "_grouped", counted_grouped)

    def where(self):
        return self.open[-1] if self.open else None

    def watch(self, name: str, module: torch.nn.Module) -> None:
        def enter(mod, args):
            self.open.append(name)

        def leave(mod, args, out):
            self.open.pop()

        module.register_forward_pre_hook(enter)
        module.register_forward_hook(leave)


@pytest.fixture(scope="module")
def stage1_calls():
    """The tiny stage-1 product (a first chunk, one AR chunk, the bf16
    decode) under its configuration's default routing."""
    cfg = PipelineConfig.tiny()
    pipe = build_pipeline(cfg, device="cpu")
    calls = NormCalls()
    m = pipe.models
    for name, module in (("svd_unet", m.svd_unet), ("unet", m.unet),
                         ("controlnet", m.controlnet), ("vae.decoder", m.vae.decoder),
                         ("cond_encoder", m.conditioner.cond_encoder.encoder)):
        calls.watch(name, module)
    image = torch.linspace(-1, 1, cfg.height * cfg.width * 3).reshape(cfg.height, cfg.width, 3)
    with pytest.MonkeyPatch.context() as mp:
        calls.patch(mp)
        video = pipe.image_to_video(image, num_frames=8, seed=7)
    assert tuple(video.shape) == (8, cfg.height, cfg.width, 3)
    assert torch.isfinite(video).all()
    return calls


@pytest.mark.parametrize("network", NETWORKS)
def test_every_per_frame_group_norm_takes_k5(stage1_calls, network):
    """Each network's 4-D GroupNorms reach the K5 wrapper as (N, L, C),
    none the plain path."""
    k5 = {key: n for key, n in stage1_calls.k5.items() if key[0] == network}
    assert k5 and set(k5) == {(network, 3)}, stage1_calls.k5
    assert stage1_calls.plain[network, "group_norm", 4] == 0, stage1_calls.plain


@pytest.mark.parametrize("network", ("svd_unet", "unet", "controlnet", "vae.decoder"))
def test_the_5d_group_norms_stay_plain(stage1_calls, network):
    """CAM's norm and the time stacks' norms over (T, H, W) keep the plain
    path: K5 normalises each (N, L, C) row, never a 5-D input."""
    assert stage1_calls.plain[network, "group_norm", 5] > 0, stage1_calls.plain
    assert all(rank == 3 for _, rank in stage1_calls.k5)


@pytest.mark.parametrize("shape", [(2, 3, 4, 4, 32), (6, 4, 4, 32)])
def test_group_norm_affine_stays_plain(monkeypatch, shape):
    """The statistics K4's prologue applies take the plain path under the
    stage-1 routing, whatever the input's rank, and give the affine of the
    GroupNorm that the routing computes."""
    calls = NormCalls()
    calls.patch(monkeypatch)
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(shape, generator=gen) * 2 + 0.5
    scale = 1 + 0.1 * torch.randn(shape[-1], generator=gen)
    bias = 0.1 * torch.randn(shape[-1], generator=gen)
    with use_routing(PipelineConfig().routing):
        a, b = norms.group_norm_affine(x, scale, bias, num_groups=8, eps=1e-5)
        want = norms.group_norm(x, scale, bias, num_groups=8, eps=1e-5)
    assert calls.plain[None, "group_norm_affine", len(shape)] == 1
    assert sum(calls.k5.values()) == (1 if len(shape) == 4 else 0)
    n, c = shape[0], shape[-1]
    got = x * a.reshape((n,) + (1,) * (len(shape) - 2) + (c,)) \
        + b.reshape((n,) + (1,) * (len(shape) - 2) + (c,))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_training_takes_no_k5(monkeypatch):
    """A tiny training step runs outside every pipeline's routing: its 4-D
    GroupNorms take the plain path (K5 has no backward)."""
    calls = NormCalls()
    calls.patch(monkeypatch)
    ucfg = VideoUNetConfig.tiny(controlnet_mode=False)
    model = init_random_(VideoUNet(ucfg, device="cpu"), torch.Generator().manual_seed(0))
    engine = DiffusionEngine(model)
    gen = torch.Generator().manual_seed(1)
    b, t, h, w = 2, 3, 8, 8
    batch = {"latents": torch.randn(b, t, h, w, 4, generator=gen),
             "cond": {"concat": torch.randn(b, t, h, w, 4, generator=gen),
                      "crossattn": torch.randn(b, t, 1, ucfg.context_dim, generator=gen),
                      "vector": torch.randn(b, t, ucfg.adm_in_channels, generator=gen)}}
    loss = engine.train_step(batch, torch.Generator().manual_seed(2))
    assert torch.isfinite(loss)
    assert sum(calls.k5.values()) == 0, calls.k5
    assert calls.plain[None, "group_norm", 4] > 0, calls.plain


def test_chip_smoke_holds_k5_at_every_stage1_geometry(monkeypatch):
    """``chip_smoke.check_k5`` holds K5 against its plain version on the card
    at exactly the geometries that full-width stage 1 sends it: the
    pipeline built on the meta device (shapes only) and run for 43 frames,
    one sampler step a chunk, the wrapper's calls recorded."""
    seen = set()

    def record(x, scale, bias, *, num_groups, eps, act=None):
        assert num_groups == 32
        seen.add((*x.shape, act, eps, x.dtype))
        return torch.empty_like(x)

    monkeypatch.setattr(norms, "fused_group_norm", record)
    cfg = PipelineConfig()
    cfg = dataclasses.replace(
        cfg, sampler=dataclasses.replace(cfg.sampler, num_steps=1),
        first_chunk_sampler=dataclasses.replace(cfg.first_chunk_sampler, num_steps=1))
    pipe = build_pipeline(cfg, device="meta", bf16=True, init=False)
    image = torch.zeros(cfg.height, cfg.width, 3, device="meta")
    with torch.inference_mode():
        video = pipe.image_to_video(
            image, num_frames=43, seed=7,
            noise=lambda generation, stream, shape: torch.zeros(shape, device="meta"))
    assert tuple(video.shape) == (43, cfg.height, cfg.width, 3)
    rows = chip_smoke.stage1_k5_geometries(torch.bfloat16, torch.float32)
    assert len(rows) == len({row[:6] for row in rows})
    assert seen == {row[:6] for row in rows}
