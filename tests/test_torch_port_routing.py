"""PyTorch port, stage 1's kernel routes on the CPU: which GroupNorms take
the K5 wrapper (``ops/fused_group_norm.fused_group_norm``, its plain version
on the CPU) where autograd records no graph, which statistics of K4's
prologue take K5's affine entry (``fused_group_norm_affine``), which stay on
the plain version of ``ops/norms.py``, and that the temporal
self-attentions reach ``ops.temporal_attention`` under every routing.

The tiny stage-1 pipeline runs ``image_to_video`` once with both ends
counted: the wrapper's calls and the plain version's
(``fused_group_norm_reference``, by the norm that calls it and the norm's
input rank), each under the network whose forward is open (forward hooks).  The full-width pipeline and stage 2's UNet,
built on the meta device, give the geometries at which ``chip_smoke.check_k5``
and ``chip_smoke.check_k5_affine`` must hold K5 on the card."""

import collections
import dataclasses
import functools
import sys

import pytest
import torch

import chip_smoke
from streamingt2v_torch.config import (
    ControlNetConfig, KernelRouting, PipelineConfig, VideoUNetConfig)
from streamingt2v_torch.diffusion.engine import DiffusionEngine
from streamingt2v_torch.models import unet_blocks, vae
from streamingt2v_torch.models.enhance import unet as enhance_unet
from streamingt2v_torch.models.enhance.unet import I2VGenXLUNet, I2VGenXLUNetConfig
from streamingt2v_torch.models.controlnet import ControlNet
from streamingt2v_torch.models.layers import init_random_
from streamingt2v_torch.models.video_unet import VideoUNet
from streamingt2v_torch.ops import norms
from streamingt2v_torch.ops.routing import use_routing
from streamingt2v_torch.pipeline.build import build_pipeline

NETWORKS = ("svd_unet", "unet", "controlnet", "vae.decoder", "cond_encoder")


class NormCalls:
    """Counts of K5 wrapper calls, keyed (network, rank), of K5's affine
    entry's, keyed (network, rank), and of plain-version calls (each on
    (N, L, C)), keyed (network, norm, the norm's input rank), while
    ``patch`` is in force."""

    def __init__(self):
        self.k5 = collections.Counter()
        self.k5_affine = collections.Counter()
        self.plain = collections.Counter()
        self.open = []

    def patch(self, mp: pytest.MonkeyPatch) -> None:
        fused, plain = norms.fused_group_norm, norms.fused_group_norm_reference
        affine, affine_plain = norms.fused_group_norm_affine, norms.group_norm_affine_reference

        def counted_fused(x, *args, **kw):
            self.k5[self.where(), x.ndim] += 1
            return fused(x, *args, **kw)

        def counted_affine(x, *args, **kw):
            self.k5_affine[self.where(), x.ndim] += 1
            return affine(x, *args, **kw)

        def counted(version):
            def call(x, *args, **kw):
                caller = sys._getframe(1)
                self.plain[self.where(), caller.f_code.co_name,
                           caller.f_locals["x"].ndim] += 1
                return version(x, *args, **kw)
            return call

        mp.setattr(norms, "fused_group_norm", counted_fused)
        mp.setattr(norms, "fused_group_norm_affine", counted_affine)
        mp.setattr(norms, "fused_group_norm_reference", counted(plain))
        mp.setattr(norms, "group_norm_affine_reference", counted(affine_plain))

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
    decode), without autograd as the pipeline runs it."""
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
    none the plain version."""
    k5 = {key: n for key, n in stage1_calls.k5.items() if key[0] == network}
    assert k5 and set(k5) == {(network, 3)}, stage1_calls.k5
    assert stage1_calls.plain[network, "group_norm", 4] == 0, stage1_calls.plain


@pytest.mark.parametrize("network", ("svd_unet", "unet", "controlnet", "vae.decoder"))
def test_the_5d_group_norms_stay_plain(stage1_calls, network):
    """CAM's norm and the time stacks' norms over (T, H, W) keep the plain
    version: K5 normalises each (N, L, C) row, never a 5-D input."""
    assert stage1_calls.plain[network, "group_norm", 5] > 0, stage1_calls.plain
    assert all(rank == 3 for _, rank in stage1_calls.k5)


def _affine_case(shape, requires_grad: bool = False):
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(shape, generator=gen) * 2 + 0.5
    scale = 1 + 0.1 * torch.randn(shape[-1], generator=gen)
    bias = 0.1 * torch.randn(shape[-1], generator=gen)
    return tuple(v.requires_grad_(requires_grad) for v in (x, scale, bias))


def _assert_affine_form(x, a, b, want):
    """x * a + b, broadcast over the rows' non-channel axes, is ``want``."""
    n, c = x.shape[0], x.shape[-1]
    lead = (n,) + (1,) * (x.ndim - 2) + (c,)
    torch.testing.assert_close(x * a.reshape(lead) + b.reshape(lead), want, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("shape", [(2, 3, 4, 4, 32), (6, 4, 4, 32)])
def test_group_norm_affine_takes_k5_affine(monkeypatch, shape):
    """Without a graph to record, the statistics K4's prologue applies reach
    K5's affine entry as (N, L, C), whatever the input's rank, none the
    plain version, and give the affine of the GroupNorm."""
    calls = NormCalls()
    calls.patch(monkeypatch)
    x, scale, bias = _affine_case(shape)
    a, b = norms.group_norm_affine(x, scale, bias, num_groups=8, eps=1e-5)
    want = norms.group_norm(x, scale, bias, num_groups=8, eps=1e-5)
    assert calls.k5_affine == {(None, 3): 1}, calls.k5_affine
    assert calls.plain[None, "group_norm_affine", len(shape)] == 0, calls.plain
    assert sum(calls.k5.values()) == (1 if len(shape) == 4 else 0)
    assert a.dtype == b.dtype == torch.float32 and a.shape == b.shape == (shape[0], shape[-1])
    _assert_affine_form(x, a, b, want)


@pytest.mark.parametrize("shape", [(2, 3, 4, 4, 32), (6, 4, 4, 32)])
def test_group_norm_affine_stays_plain(monkeypatch, shape):
    """Under grad, for inputs that require grad (training's), the statistics
    K4's prologue applies keep the plain version, on (N, L, C) whatever the
    input's rank: (a, b) keep their autograd graph, give the GroupNorm's
    affine and the plain GroupNorm's gradients."""
    calls = NormCalls()
    calls.patch(monkeypatch)
    x, scale, bias = _affine_case(shape, requires_grad=True)
    a, b = norms.group_norm_affine(x, scale, bias, num_groups=8, eps=1e-5)
    assert calls.plain[None, "group_norm_affine", len(shape)] == 1, calls.plain
    assert not calls.k5_affine, calls.k5_affine
    assert a.grad_fn is not None and b.grad_fn is not None
    with torch.no_grad():
        _assert_affine_form(x, a, b, norms.group_norm(x, scale, bias, num_groups=8, eps=1e-5))
    n, c = shape[0], shape[-1]
    lead = (n,) + (1,) * (len(shape) - 2) + (c,)
    got = torch.autograd.grad((x * a.reshape(lead) + b.reshape(lead)).square().sum(),
                              (x, scale, bias))
    xr, sr, br = (v.detach().clone().requires_grad_(True) for v in (x, scale, bias))
    want = torch.autograd.grad(norms.group_norm(xr, sr, br, num_groups=8, eps=1e-5)
                               .square().sum(), (xr, sr, br))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape", [(2, 3, 4, 4, 32), (6, 4, 4, 32)])
def test_group_norm_affine_refuses_grad_under_routing(monkeypatch, shape):
    """``group_norm_affine`` keeps grad away from K5's affine entry, which
    raises under grad for an input that requires grad (no VJP): the same
    inputs take the entry under ``no_grad`` and the plain version under
    ``enable_grad``, with the same affine, whatever the routing."""
    calls = NormCalls()
    calls.patch(monkeypatch)
    x, scale, bias = _affine_case(shape, requires_grad=True)
    with use_routing(KernelRouting.all_on()):
        with torch.no_grad():
            a, b = norms.group_norm_affine(x, scale, bias, num_groups=8, eps=1e-5)
        assert calls.k5_affine == {(None, 3): 1}, calls.k5_affine
        assert calls.plain[None, "group_norm_affine", len(shape)] == 0, calls.plain
        with torch.enable_grad():
            ga, gb = norms.group_norm_affine(x, scale, bias, num_groups=8, eps=1e-5)
        assert calls.k5_affine == {(None, 3): 1}, calls.k5_affine
        assert calls.plain[None, "group_norm_affine", len(shape)] == 1, calls.plain
        with pytest.raises(RuntimeError, match="no backward"):
            norms.fused_group_norm_affine(x.reshape(shape[0], -1, shape[-1]), scale, bias,
                                          num_groups=8, eps=1e-5)
    assert ga.grad_fn is not None and a.grad_fn is None
    torch.testing.assert_close((ga.detach(), gb.detach()), (a, b), rtol=1e-6, atol=1e-6)
    with torch.no_grad():
        _assert_affine_form(x, a, b, norms.group_norm(x, scale, bias, num_groups=8, eps=1e-5))


def test_training_takes_no_k5(monkeypatch):
    """A tiny training step records a graph through parameters that require
    grad: its 4-D GroupNorms take the plain version (K5 has no backward)."""
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
    assert sum(calls.k5_affine.values()) == 0, calls.k5_affine
    assert calls.plain[None, "group_norm", 4] > 0, calls.plain


@pytest.mark.parametrize("controlnet_mode", [False, True])
def test_stage1_temporal_attention_takes_the_op_under_every_routing(monkeypatch,
                                                                    controlnet_mode):
    """The tiny VideoUNet (the first-chunk one, or the streaming one fed the
    ControlNet's features through CAM): every temporal self-attention hands
    ``ops.temporal_attention`` its spatial-major (B*T, S, H*D) q/k/v, under
    the default routing and under ``KernelRouting.all_on()``, and the two
    routings compute the same output on the CPU."""
    ucfg = VideoUNetConfig.tiny(controlnet_mode=controlnet_mode)
    gen = torch.Generator().manual_seed(3)
    unet = init_random_(VideoUNet(ucfg, device="cpu"), gen).eval()
    b, t, h, w = 2, 3, 8, 8
    x = torch.randn(b, t, h, w, ucfg.in_channels, generator=gen)
    t_cont = torch.tensor([0.7, 0.3])
    ctx = torch.randn(b, t, 1, ucfg.context_dim, generator=gen)
    y = torch.randn(b, t, ucfg.adm_in_channels, generator=gen)
    control = {}
    if controlnet_mode:
        ccfg = ControlNetConfig.tiny()
        cnet = init_random_(ControlNet(ucfg, ccfg, device="cpu"), gen).eval()
        scale = 2 ** (len(ccfg.conditioning_embedding_out_channels) - 1)
        pix = torch.randn(b, 2, h * scale, w * scale, 3, generator=gen)
        with torch.no_grad():
            hs, mid = cnet(x[:, :2], t_cont, ctx[:, :2], y[:, :2], pix)
        control = dict(hs_control=hs, h_control_mid=mid)

    blocks, seen = [], []
    for module in unet.modules():
        if isinstance(module, unet_blocks.VideoTransformerBlock):
            module.register_forward_pre_hook(
                lambda mod, args, kw: blocks.append((tuple(args[0].shape), kw["batch"],
                                                     kw["frames"])), with_kwargs=True)
    real = unet_blocks.temporal_attention

    def spy(q, k, v, **kw):
        assert q.shape == k.shape == v.shape
        seen.append((tuple(q.shape), kw["batch"], kw["frames_q"]))
        assert kw["frames_kv"] == kw["frames_q"]
        return real(q, k, v, **kw)

    monkeypatch.setattr(unet_blocks, "temporal_attention", spy)
    outs = []
    for routing in (KernelRouting(), KernelRouting.all_on()):
        blocks.clear()
        seen.clear()
        with torch.no_grad(), use_routing(routing):
            outs.append(unet(x, t_cont, ctx, y, **control))
        # a temporal transformer in each of the 2 + 4 attention levels' blocks
        # and one in the middle
        assert len(blocks) == 7 and seen == blocks, (blocks, seen)
        assert all(shape[0] == b * t == bb * tt for shape, bb, tt in seen)
    torch.testing.assert_close(outs[1], outs[0], rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def meta_stage1():
    """The full-width stage-1 pipeline built on the meta device (shapes only)
    and run for 43 frames, one sampler step a chunk: the K5 wrapper's calls
    as (N, L, C, act, eps, dtype), and the K4 prologues ``_time_conv`` sends
    its affine entry on the card (``unet_blocks._k4_geometry`` with a
    GroupNorm) as (network, N, L, C, groups, dtype) -> calls, with the
    networks' calls."""
    seen, prologues = set(), collections.Counter()
    calls = NormCalls()

    def record(x, scale, bias, *, num_groups, eps, act=None):
        assert num_groups == 32
        seen.add((*x.shape, act, eps, x.dtype))
        return torch.empty_like(x)

    cfg = PipelineConfig()
    cfg = dataclasses.replace(
        cfg, sampler=dataclasses.replace(cfg.sampler, num_steps=1),
        first_chunk_sampler=dataclasses.replace(cfg.first_chunk_sampler, num_steps=1))
    pipe = build_pipeline(cfg, device="meta", bf16=True, init=False)
    m = pipe.models
    networks = collections.Counter()
    for name, module in (("svd_unet", m.svd_unet), ("unet", m.unet),
                         ("controlnet", m.controlnet), ("vae.decoder", m.vae.decoder)):
        calls.watch(name, module)
        module.register_forward_pre_hook(lambda mod, args, name=name: networks.update([name]))
    image = torch.zeros(cfg.height, cfg.width, 3, device="meta")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(norms, "fused_group_norm", record)
        _record_prologues(mp, calls, prologues)
        with torch.inference_mode():
            video = pipe.image_to_video(
                image, num_frames=43, seed=7,
                noise=lambda generation, stream, shape: torch.zeros(shape, device="meta"))
    assert tuple(video.shape) == (43, cfg.height, cfg.width, 3)
    return seen, prologues, networks


def _record_prologues(mp: pytest.MonkeyPatch, calls: NormCalls, prologues) -> None:
    """``_time_conv``, in every module that calls it, counting the calls
    whose GroupNorm statistics the card sends K5's affine entry."""
    time_conv = unet_blocks._time_conv

    def counted(h, conv, *, res=None, res_w=None, gn=None):
        if gn is not None and unet_blocks._k4_geometry(h, conv):
            b, t, hh, ww, c = h.shape
            groups = gn[2] if len(gn) > 2 else 32
            prologues[calls.where(), b, t * hh * ww, c, groups, h.dtype] += 1
        return time_conv(h, conv, res=res, res_w=res_w, gn=gn)

    for module in (unet_blocks, vae, enhance_unet):
        mp.setattr(module, "_time_conv", counted)


def test_chip_smoke_holds_k5_at_every_stage1_geometry(meta_stage1):
    """``chip_smoke.check_k5`` holds K5 against its plain version on the card
    at exactly the geometries that full-width stage 1 sends it: the
    pipeline built on the meta device (shapes only) and run for 43 frames,
    one sampler step a chunk, the wrapper's calls recorded."""
    seen = meta_stage1[0]
    rows = chip_smoke.stage1_k5_geometries(torch.bfloat16, torch.float32)
    assert len(rows) == len({row[:6] for row in rows})
    assert seen == {row[:6] for row in rows}


def test_chip_smoke_holds_k5_affine_at_every_k4_prologue_geometry(meta_stage1):
    """``chip_smoke.check_k5_affine`` holds K5's affine entry at exactly the
    geometries of K4's prologues: full-width stage 1 on the meta device (as
    above) and one call of stage 2's full-width UNet on a 38-frame chunk of
    90 x 160 latents (its K5 wrapper stubbed); each network's launches a call are
    ``k4_prologue_geometries``' counts, and so the launches a unit are
    ``k4_prologue_launches``'."""
    _, prologues, networks = meta_stage1
    prologues = collections.Counter(prologues)
    calls = NormCalls()
    unet = I2VGenXLUNet(I2VGenXLUNetConfig(), device="meta", dtype=torch.bfloat16).eval()
    calls.watch("stage-2 UNet", unet)
    z = functools.partial(torch.zeros, device="meta")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(norms, "fused_group_norm", lambda x, *args, **kw: torch.empty_like(x))
        _record_prologues(mp, calls, prologues)
        with torch.inference_mode():
            unet(z(1, 38, 90, 160, 4), z(1, dtype=torch.int32), z(1), z(1, 38, 90, 160, 4),
                 z(1, 1024), z(1, 77, 1024))
    assert networks == {"svd_unet": 1, "unet": 1, "controlnet": 1, "vae.decoder": 8}
    # the 43 frames decode as two 25-frame chunks of 8-frame pieces and a 1-frame one
    per_call = {"svd_unet": ("stage-1 VideoUNet", 1), "unet": ("stage-1 VideoUNet", 1),
                "controlnet": ("stage-1 ControlNet", 1), "stage-2 UNet": ("stage-2 UNet", 1)}
    got = collections.Counter()
    for (network, n, l, c, groups, dtype), k in prologues.items():
        assert (groups, dtype) == (32, torch.bfloat16)
        if network == "vae.decoder":
            frames = 8 if l in {8 * s for s in (589824, 147456, 36864, 9216)} else 1
            label, times = f"stage-1 VAE decoder {frames}-frame piece", 2 * (3 if frames == 8 else 1)
        else:
            label, times = per_call[network]
        assert k % times == 0, (network, n, l, c, k)
        got[n, l, c, label, k // times] += 1
    for key in [key for key in got if key[3] == "stage-1 VideoUNet"]:
        assert got[key] == 2   # the first chunk's and the AR UNet alike
        got[key] = 1
    want = chip_smoke.k4_prologue_geometries()
    assert len(want) == len({row[:4] for row in want})
    assert got == collections.Counter(want)
    assert chip_smoke.k4_prologue_launches() == {
        "ar_step": 44 + 20, "stage2_step": 2 * 88, "decode_call": 3 * 28 + 28}
