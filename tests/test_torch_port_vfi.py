"""PyTorch port, stage 3 (EMA-VFI 2x interpolation): the backward warp, the
VFI building blocks, the layers and weight rule it adds (dilated and grouped
convs, the flax ConvTranspose), the tiny ``MultiScaleFlow`` and
``InterpolatePipeline`` against the JAX package on the same weights, in f32
on the CPU.

Tolerance: 2e-5 max-abs on the [0, 1] frames and on the flows (f32 on both
sides with a different summation order; measured up to 3.1e-6 on the CPU).
The warp gathers the same four taps with the same arithmetic as the JAX
function and is held to 1e-6; the index and mask helpers are equal."""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_port_helpers import jax_variables, port_module, random_flat, t
from streamingt2v_tpu.config import VFIConfig as JaxVFIConfig
from streamingt2v_tpu.models import vfi as jvfi
from streamingt2v_tpu.ops.warp import backward_warp as jax_backward_warp
from streamingt2v_tpu.pipeline.interpolate import InterpolatePipeline as JaxInterpolatePipeline
from streamingt2v_torch.config import PipelineConfig, VFIConfig
from streamingt2v_torch.models import vfi as pvfi
from streamingt2v_torch.models.layers import Conv, ConvTranspose
from streamingt2v_torch.ops.warp import backward_warp
from streamingt2v_torch.pipeline.build import build_interpolate
from streamingt2v_torch.pipeline.interpolate import InterpolatePipeline
from streamingt2v_torch.utils.weights import from_jax_params, load_jax_params

ATOL = 2e-5
WARP_ATOL = 1e-6


def _max_err(got, ref) -> float:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert np.all(np.isfinite(got))
    return float(np.abs(got.astype(np.float64) - ref).max())


# ------------------------------------------------------------------ warp ---

def _flow(dx, dy, h, w):
    return np.stack([np.full((1, h, w), dx), np.full((1, h, w), dy)], -1).astype(np.float32)


@pytest.mark.parametrize("x,flow,want", [
    # zero flow: identity
    (np.arange(30, dtype=np.float32).reshape(1, 5, 6, 1), _flow(0, 0, 5, 6),
     np.arange(30, dtype=np.float32).reshape(1, 5, 6, 1)),
    # dx = 1 samples column j + 1; the last column clamps
    (np.arange(8, dtype=np.float32).reshape(1, 1, 8, 1), _flow(1, 0, 1, 8),
     np.array([1, 2, 3, 4, 5, 6, 7, 7], np.float32).reshape(1, 1, 8, 1)),
    # half a pixel: the mean of two neighbours
    (np.array([0.0, 2.0, 4.0], np.float32).reshape(1, 1, 3, 1), _flow(0.5, 0, 1, 3),
     np.array([1.0, 3.0, 4.0], np.float32).reshape(1, 1, 3, 1)),
    # far outside: the border pixel
    (np.array([1.0, 2.0], np.float32).reshape(1, 1, 2, 1), _flow(10, 0, 1, 2),
     np.array([2.0, 2.0], np.float32).reshape(1, 1, 2, 1)),
    # dy = -1 samples row i - 1; the first row clamps
    (np.arange(4, dtype=np.float32).reshape(1, 4, 1, 1), _flow(0, -1, 4, 1),
     np.array([0, 0, 1, 2], np.float32).reshape(1, 4, 1, 1)),
])
def test_backward_warp_cases(x, flow, want):
    got = backward_warp(t(x), t(flow))
    assert _max_err(got, want) <= WARP_ATOL
    assert _max_err(got, jax_backward_warp(jnp.asarray(x), jnp.asarray(flow))) <= WARP_ATOL


@pytest.mark.parametrize("shape,scale", [((2, 9, 13, 3), 3.0), ((1, 16, 20, 5), 25.0)])
def test_backward_warp_random_flows_match_jax(shape, scale):
    rng = np.random.RandomState(int(scale))
    x = rng.rand(*shape).astype(np.float32)
    flow = (rng.randn(*shape[:3], 2) * scale).astype(np.float32)
    ref = jax_backward_warp(jnp.asarray(x), jnp.asarray(flow))
    assert _max_err(backward_warp(t(x), t(flow)), ref) <= WARP_ATOL


def test_backward_warp_agrees_with_grid_sample():
    """The pixel-space form is the reference's grid_sample warp (normalized
    grid, align_corners=True, border padding)."""
    rng = np.random.RandomState(3)
    x = rng.rand(2, 12, 17, 3).astype(np.float32)
    flow = (rng.randn(2, 12, 17, 2) * 4).astype(np.float32)
    h, w = x.shape[1:3]
    gx = (np.arange(w)[None, None] + flow[..., 0]) * 2 / (w - 1) - 1
    gy = (np.arange(h)[None, :, None] + flow[..., 1]) * 2 / (h - 1) - 1
    grid = torch.from_numpy(np.stack([gx, gy], -1).astype(np.float32))
    ref = F.grid_sample(t(x).permute(0, 3, 1, 2), grid, mode="bilinear",
                        padding_mode="border", align_corners=True).permute(0, 2, 3, 1)
    assert _max_err(backward_warp(t(x), t(flow)), ref.numpy()) <= 1e-5


# ------------------------------------------------------- building blocks ---

def test_pixel_shuffle_matches_jax_and_torch():
    x = np.random.RandomState(0).rand(2, 3, 5, 32).astype(np.float32)
    got = pvfi.pixel_shuffle(t(x), 2)
    assert _max_err(got, jvfi.pixel_shuffle(jnp.asarray(x), 2)) == 0.0
    ref = F.pixel_shuffle(t(x).permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
    assert torch.equal(got, ref)


def test_window_partition_and_reverse_match_jax():
    x = np.random.RandomState(1).rand(2, 8, 12, 5).astype(np.float32)
    win = pvfi.window_partition(t(x), (4, 4))
    assert _max_err(win, jvfi.window_partition(jnp.asarray(x), (4, 4))) == 0.0
    assert _max_err(pvfi.window_reverse(win, (4, 4), 8, 12), x) == 0.0


@pytest.mark.parametrize("h,w,ws,shift", [
    (4, 6, (4, 4), (0, 0)), (4, 6, (4, 4), (2, 2)), (8, 8, (4, 4), (2, 2)),
    (8, 8, (4, 4), (0, 0)), (90, 160, (7, 7), (3, 3)), (45, 80, (7, 7), (0, 0)),
])
def test_window_masks_equal_jax(h, w, ws, shift):
    pad = pvfi._center_pad_hw(h, w, ws)
    assert pad == jvfi._center_pad_hw(h, w, ws)
    got = pvfi._window_masks(h, w, ws, shift, pad)
    ref = jvfi._window_masks(h, w, ws, shift, pad)
    if ref is None:
        assert got is None
    else:
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("shape,scale", [
    ((1, 33, 47, 3), 0.5), ((2, 45, 80, 4), 0.25), ((1, 17, 23, 2), 2.0), ((1, 9, 10, 5), 4.0),
])
def test_resize_bilinear_matches_jax(shape, scale):
    x = np.random.RandomState(2).rand(*shape).astype(np.float32)
    ref = jvfi.resize_bilinear(jnp.asarray(x), scale)
    assert _max_err(pvfi.resize_bilinear(t(x), scale), ref) <= 1e-6


# ---------------------------------------------------------------- layers ---

@pytest.mark.parametrize("cin,cout", [(5, 3), (4, 4)])
def test_conv_transpose_matches_flax(cin, cout):
    """flax ConvTranspose(4, stride 2, SAME) against the port's layer through
    the weight bridge; in == out is the case a wrong layout would load
    without complaint."""
    rng = np.random.RandomState(cin)
    x = rng.randn(2, 5, 7, cin).astype(np.float32)
    flat = {"up0_deconv/kernel": rng.randn(4, 4, cin, cout).astype(np.float32),
            "up0_deconv/bias": rng.randn(cout).astype(np.float32)}
    jmod = fnn.ConvTranspose(cout, (4, 4), strides=(2, 2), padding="SAME")
    ref = jmod.apply({"params": {"kernel": jnp.asarray(flat["up0_deconv/kernel"]),
                                 "bias": jnp.asarray(flat["up0_deconv/bias"])}}, jnp.asarray(x))

    class Holder(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.up0_deconv = ConvTranspose(cin, cout, 4, stride=2)

    mod = load_jax_params(Holder(), flat).up0_deconv
    with torch.no_grad():
        got = mod(t(x))
    assert got.shape == (2, 10, 14, cout)
    assert _max_err(got, ref) <= 1e-5
    # under the Conv rule the kernel would load only when in == out, and wrong
    conv_rule = from_jax_params({"proj/kernel": flat["up0_deconv/kernel"]})["proj.kernel"]
    if cin == cout:
        assert conv_rule.shape == mod.kernel.shape and not torch.equal(conv_rule, mod.kernel)
    else:
        assert conv_rule.shape != mod.kernel.shape


@pytest.mark.parametrize("stride,padding,dilation,groups", [
    (2, 2, 2, 1), (4, 3, 3, 1), (1, 1, 1, 6),
])
def test_conv_dilation_and_groups_match_flax(stride, padding, dilation, groups):
    rng = np.random.RandomState(stride + dilation)
    x = rng.randn(2, 13, 11, 6).astype(np.float32)
    cout = 6 if groups > 1 else 5
    jmod = fnn.Conv(cout, (3, 3), strides=(stride,) * 2, padding=padding,
                    kernel_dilation=(dilation,) * 2, feature_group_count=groups)
    kernel = rng.randn(3, 3, 6 // groups, cout).astype(np.float32)
    bias = rng.randn(cout).astype(np.float32)
    ref = jmod.apply({"params": {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)}},
                     jnp.asarray(x))
    mod = Conv(6, cout, 3, stride=stride, padding=padding, dilation=dilation, groups=groups)
    state = from_jax_params({"kernel": kernel, "bias": bias})
    mod.load_state_dict(state)
    with torch.no_grad():
        assert _max_err(mod(t(x)), ref) <= 1e-5


# ------------------------------------------------------------- the model ---

SIZE = (32, 48)   # stage 3 at 4x6, stage 4 at 2x3: the 4x4 windows pad both


@pytest.fixture(scope="module")
def vfi_pair():
    """The port module, a JAX pipeline and the JAX references on the same
    weights; each JAX reference is computed once here."""
    jmod = jvfi.MultiScaleFlow(JaxVFIConfig.tiny())
    img = jnp.zeros((1,) + SIZE + (3,))
    flat = random_flat(jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), img, img))
                       ["params"], 0)
    variables = jax_variables(flat)
    pmod = port_module(pvfi.MultiScaleFlow(VFIConfig.tiny()), flat)
    rng = np.random.RandomState(0)
    a, b = (rng.rand(2, *SIZE, 3).astype(np.float32) for _ in range(2))
    a64, b64 = (rng.rand(1, 64, 64, 3).astype(np.float32) for _ in range(2))
    def ref(fn, *args):
        return np.asarray(jax.jit(lambda v, *xs: fn(v, *xs))(variables, *args))

    refs = {
        "plain": ref(jmod.apply, a, b),
        "tta": ref(lambda v, x0, x1: jvfi.interpolate_pair(jmod, v, x0, x1, tta=True), a, b),
        "flow": ref(lambda v, x0, x1: jmod.apply(
            v, x0, x1, method=jvfi.MultiScaleFlow.calculate_flow)[0], a, b),
        "hr": ref(lambda v, x0, x1: jmod.apply(
            v, x0, x1, method=jvfi.MultiScaleFlow.hr_forward), a64, b64),
    }
    # one JAX pipeline, so that its jitted pair batch compiles once
    jpipe = JaxInterpolatePipeline(jmod, variables, tta=False, pair_batch=2)
    return dict(flat=flat, jpipe=jpipe, pmod=pmod, inputs=(a, b, a64, b64), refs=refs)


def _check(got, ref, what):
    assert np.asarray(ref).std() > 0.05, what    # not a flat output
    err = _max_err(got, ref)
    assert err <= ATOL, f"{what}: max-abs err {err:.3e} > {ATOL}"


def test_tiny_vfi_has_the_flax_parameter_tree(vfi_pair):
    pmod, flat = vfi_pair["pmod"], vfi_pair["flat"]
    assert len(flat) == len(pmod.state_dict()) == 137
    assert "unet.up0_deconv.kernel" in pmod.state_dict()
    assert "feature_bone.block_3_0.attn.q.kernel" in pmod.state_dict()


@pytest.mark.parametrize("tta", [False, True])
def test_tiny_vfi_interpolate_pair_matches_jax(vfi_pair, tta):
    a, b = vfi_pair["inputs"][:2]
    with torch.no_grad():
        got = pvfi.interpolate_pair(vfi_pair["pmod"], t(a), t(b), tta=tta)
    _check(got, vfi_pair["refs"]["tta" if tta else "plain"], f"interpolate_pair tta={tta}")


def test_tiny_vfi_flow_and_hr_forward_match_jax(vfi_pair):
    pmod, refs = vfi_pair["pmod"], vfi_pair["refs"]
    a, b, a64, b64 = vfi_pair["inputs"]
    with torch.no_grad():
        flow, _ = pmod.calculate_flow(t(a), t(b))
        hr = pmod.hr_forward(t(a64), t(b64))
        multi = pmod.multi_forward(t(a), t(b), (0.25, 0.5))
    _check(flow, refs["flow"], "calculate_flow")
    _check(hr, refs["hr"], "hr_forward")
    # one backbone pass, several timesteps: t=0.5 is the plain forward
    _check(multi[1], refs["plain"], "multi_forward t=0.5")
    assert not torch.allclose(multi[0], multi[1])


@pytest.mark.parametrize("frames,target_len", [(5, None), (7, 8), (7, 7)])
def test_interpolate_pipeline_matches_jax(vfi_pair, frames, target_len):
    """Odd and even targets; pair batch 2, so the port runs a short last
    batch where the JAX pipeline pads it."""
    video = np.random.RandomState(frames).rand(frames, *SIZE, 3).astype(np.float32)
    ref = np.asarray(vfi_pair["jpipe"].interpolate_video(jnp.asarray(video), target_len))
    pipe = InterpolatePipeline(vfi_pair["pmod"], tta=False, pair_batch=2)
    got = pipe.interpolate_video(t(video), target_len)
    want_len = 2 * frames - 1 if target_len is None else target_len
    assert ref.shape == (want_len,) + SIZE + (3,)
    _check(got, ref, f"interpolate_video {frames} -> {target_len}")
    kept = got[::2]     # the input frames, as they were
    assert torch.equal(kept, t(video[:kept.shape[0]]))


def test_build_interpolate_random_weights():
    """``build_interpolate``'s random weights: flax-style kernels, PReLU slopes 0.25,
    the configuration's TTA; the full width is EMA-VFI's 65.66 M parameters."""
    cfg = dataclasses.replace(PipelineConfig.tiny(), vfi=dataclasses.replace(
        VFIConfig.tiny(), tta=True))
    pipe = build_interpolate(cfg, seed=1, device="cpu")
    assert pipe.tta and pipe.device.type == "cpu"
    params = dict(pipe.model.named_parameters())
    slopes = [p for n, p in params.items() if n.endswith("prelu")]
    assert len(slopes) == 23 and all(torch.all(p == 0.25) for p in slopes)
    assert params["unet.up0_deconv.kernel"].std() > 0
    video = torch.rand(3, 32, 32, 3, generator=torch.Generator().manual_seed(0))
    out = pipe.interpolate_video(video)
    assert out.shape == (5, 32, 32, 3) and 0.0 <= out.min() and out.max() <= 1.0
    full = pvfi.MultiScaleFlow(VFIConfig(), device="meta")
    assert sum(p.numel() for p in full.parameters()) == 65_662_359
