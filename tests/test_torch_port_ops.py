"""PyTorch port, ops layer: each kernel's plain version (K1-K6) against the
JAX package's Pallas kernel in interpret mode, the other ops against their
JAX counterparts, the kernels' gates against the JAX gates, the dispatcher's
routing, and the import boundary.

Tolerances are stated relative to max |reference|: 1e-5 for the kernels'
plain versions and the norms (f32 with a different summation order on
each side), 1e-4 where the JAX side takes one-pass statistics."""

import ast
import functools
import importlib
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import assert_close, t
from streamingt2v_tpu.ops import norms as jax_norms
from streamingt2v_tpu.ops.embedding import timestep_embedding as jax_timestep_embedding
from streamingt2v_tpu.ops import flash_attention as jax_flash_mod
from streamingt2v_tpu.ops.flash_attention import flash_attention as jax_flash
from streamingt2v_tpu.ops.fused_ff import geglu_ff as jax_geglu
from streamingt2v_tpu.ops.fused_group_norm import fused_group_norm as jax_fused_gn
from streamingt2v_tpu.ops.temporal_attention import temporal_attention as jax_temporal_attention
from streamingt2v_tpu.ops.temporal_conv import fits_temporal_conv as jax_fits_temporal_conv
from streamingt2v_tpu.ops.temporal_conv import temporal_conv as jax_temporal_conv
from streamingt2v_torch.config import KernelRouting
from streamingt2v_torch.ops import norms as port_norms
from streamingt2v_torch.ops.embedding import timestep_embedding
from streamingt2v_torch.ops.flash_attention import (
    _kernel_head_dim, flash_attention, flash_attention_packed, packed_applicable)
from streamingt2v_torch.ops.fused_ff import (
    G_CHUNK_BYTES, ROW_TILE, chunk_plan, chunk_size, down_cols, geglu_ff, geglu_ff_reference)
from streamingt2v_torch.ops.fused_group_norm import fused_group_norm
from streamingt2v_torch.ops.routing import current_routing, use_routing
from streamingt2v_torch.ops.temporal_attention import (
    fused_temporal_attention, temporal_attention)
from streamingt2v_torch.ops.temporal_conv import fits_temporal_conv, temporal_conv

# the ops packages re-export the function ``attention``; take the modules
jax_attention_mod = importlib.import_module("streamingt2v_tpu.ops.attention")
port_attention_mod = importlib.import_module("streamingt2v_torch.ops.attention")
KERNEL_TOL = 1e-5
REPO = pathlib.Path(__file__).resolve().parent.parent


# ---------------------------------------------------------------- K1 -----

@pytest.mark.parametrize("b,lq,lk,d", [
    (2, 64, 64, 64),      # square, one tile
    (1, 300, 145, 64),    # ragged q and kv lengths
    (3, 25, 7, 32),       # head dim below 64 (the kernel pads it)
    (1, 200, 130, 512),   # the VAE bottleneck head dim
    (2, 130, 97, 512),    # D=512, B > 1, q and kv off the 64-row tiles and the 32-key halves
])
def test_flash_attention_plain_matches_pallas(b, lq, lk, d):
    rng = np.random.RandomState(0)
    q, k, v = (rng.randn(b, n, d).astype(np.float32) for n in (lq, lk, lk))
    ref = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True)
    assert_close(flash_attention(t(q), t(k), t(v)), ref, KERNEL_TOL, "flash")


def test_flash_head_dims():
    assert _kernel_head_dim(32) == 64 and _kernel_head_dim(64) == 64
    assert _kernel_head_dim(512) == 512
    with pytest.raises(ValueError):
        _kernel_head_dim(80)


# ---------------------------------------------------------------- K2 -----

@pytest.mark.parametrize("b,lq,lk,h,d", [
    (2, 300, 145, 10, 64),   # ragged q and kv lengths (the cross-attention's 145)
    (1, 200, 200, 2, 128),   # D=128 lane slices
    (2, 130, 7, 2, 64),
    (2, 77, 130, 1, 512),    # the SD VAE's one D=512 head, ragged q and kv lengths
])
def test_flash_attention_packed_plain_matches_pallas(b, lq, lk, h, d):
    rng = np.random.RandomState(8)
    q = rng.randn(b, lq, h * d).astype(np.float32)
    k, v = (rng.randn(b, lk, h * d).astype(np.float32) for _ in range(2))
    ref = jax_flash_mod.flash_attention_packed(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                               num_heads=h, interpret=True)
    got = flash_attention_packed(t(q), t(k), t(v), num_heads=h)
    assert_close(got, ref, KERNEL_TOL, "flash packed")


@pytest.mark.parametrize("heads,d", [(5, 64), (10, 64), (20, 64), (1, 512), (2, 512),
                                     (8, 128), (4, 32), (3, 96)])
def test_packed_gate_narrows_the_jax_gate_to_kernel_head_dims(heads, d):
    want = jax_flash_mod.packed_applicable(heads, d) and d in (64, 512)
    assert packed_applicable(heads, d) == want


# ---------------------------------------------------------------- K3 -----

@pytest.mark.parametrize("ln", [False, True])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("n,c,inner", [(70, 48, 128), (300, 32, 160)])
def test_geglu_ff_plain_matches_pallas(n, c, inner, ln, residual):
    rng = np.random.RandomState(1)
    x = rng.randn(n, c).astype(np.float32)
    w1 = (rng.randn(c, 2 * inner) * 0.1).astype(np.float32)
    b1 = (rng.randn(2 * inner) * 0.1).astype(np.float32)
    w2 = (rng.randn(inner, c) * 0.1).astype(np.float32)
    b2 = (rng.randn(c) * 0.1).astype(np.float32)
    lns = (rng.randn(c) * 0.2 + 1.0).astype(np.float32) if ln else None
    lnb = (rng.randn(c) * 0.1).astype(np.float32) if ln else None
    ref = jax_geglu(jnp.asarray(x), jnp.asarray(w1), jnp.asarray(b1), jnp.asarray(w2),
                    jnp.asarray(b2), ln_scale=None if lns is None else jnp.asarray(lns),
                    ln_bias=None if lnb is None else jnp.asarray(lnb), residual=residual,
                    block_n=64, block_i=128, interpret=True)
    got = geglu_ff(t(x), t(w1.T), t(b1), t(w2.T), t(b2),
                   ln_scale=None if lns is None else t(lns),
                   ln_bias=None if lnb is None else t(lnb), residual=residual)
    assert_close(got, ref, KERNEL_TOL, "geglu_ff")


@pytest.mark.parametrize("ln", [False, True])
@pytest.mark.parametrize("residual", [False, True])
def test_geglu_ff_split_passes_match_pallas(ln, residual):
    """The plain version, written as the bf16 kernels' two passes (pass "up"
    to G, pass "down" from it), gives the Pallas kernel's function in f32 at
    a ragged n and inner, and stays within the bf16 tolerance with G rounded
    to bf16 between the passes, as the kernels store it."""
    rng = np.random.RandomState(15)
    n, c, inner = 333, 48, 192
    x = rng.randn(n, c).astype(np.float32)
    w1 = (rng.randn(c, 2 * inner) * 0.1).astype(np.float32)
    b1 = (rng.randn(2 * inner) * 0.1).astype(np.float32)
    w2 = (rng.randn(inner, c) * 0.1).astype(np.float32)
    b2 = (rng.randn(c) * 0.1).astype(np.float32)
    lns = (rng.randn(c) * 0.2 + 1.0).astype(np.float32) if ln else None
    lnb = (rng.randn(c) * 0.1).astype(np.float32) if ln else None
    ref = jax_geglu(jnp.asarray(x), jnp.asarray(w1), jnp.asarray(b1), jnp.asarray(w2),
                    jnp.asarray(b2), ln_scale=None if lns is None else jnp.asarray(lns),
                    ln_bias=None if lnb is None else jnp.asarray(lnb), residual=residual,
                    block_n=64, block_i=128, interpret=True)
    args = (t(x), t(w1.T), t(b1), t(w2.T), t(b2), None if lns is None else t(lns),
            None if lnb is None else t(lnb), residual)
    assert_close(geglu_ff_reference(*args), ref, KERNEL_TOL, "geglu_ff split")
    rounded = geglu_ff_reference(*args, g_dtype=torch.bfloat16)
    assert_close(rounded, ref, 2e-2, "geglu_ff split, bf16 G")


@pytest.mark.parametrize("n,c", [(460800, 320), (115200, 640), (28800, 1280),   # the UNet widths
                                 (547200, 320), (7200, 48), (100, 320), (1, 1280)])
def test_geglu_chunk_plan_covers_every_row_once_within_budget(n, c):
    inner = 4 * c
    rows = chunk_size(n, inner, c)
    plan = chunk_plan(n, rows)
    seen = np.zeros(n, np.int64)
    for start, count in plan:
        assert 0 < count <= rows
        seen[start:start + count] += 1
    assert (seen == 1).all()
    assert [s for s, _ in plan] == sorted(s for s, _ in plan)
    assert rows == n or rows % ROW_TILE == 0
    # one wave of the down pass: 132 SMs over its 320-column blocks
    wave = 132 // -(-c // down_cols(c)) * ROW_TILE
    assert rows * inner * 2 <= max(G_CHUNK_BYTES, wave * inner * 2)
    assert rows == n or rows % wave == 0
    if n <= wave:   # n below one chunk: one chunk of n rows
        assert plan == [(0, n)]


# ---------------------------------------------------------------- K4 -----

@pytest.mark.parametrize("pre", [False, True])
@pytest.mark.parametrize("res", [False, True])
@pytest.mark.parametrize("b,t_len,s,c,co", [
    (2, 5, 16, 24, 24),
    (1, 7, 64, 3, 3),     # the VAE AE3DConv time mix
    (1, 25, 20, 16, 8),   # the UNet's 25 frames
])
def test_temporal_conv_plain_matches_pallas(b, t_len, s, c, co, pre, res):
    rng = np.random.RandomState(2)
    x = rng.randn(b, t_len, s, c).astype(np.float32)
    w = (rng.randn(3, c, co) / np.sqrt(3 * c)).astype(np.float32)
    bias = (rng.randn(co) * 0.1).astype(np.float32)
    r = rng.randn(b, t_len, s, co).astype(np.float32) if res else None
    rw = rng.rand(b, t_len).astype(np.float32) if res else None
    pa = (1.0 + 0.2 * rng.randn(b, c)).astype(np.float32) if pre else None
    pb = (0.2 * rng.randn(b, c)).astype(np.float32) if pre else None
    opt = [r, rw, pa, pb]
    ref = jax_temporal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias),
                            *[None if a is None else jnp.asarray(a) for a in opt],
                            interpret=True)
    got = temporal_conv(t(x), t(w), t(bias), *[None if a is None else t(a) for a in opt])
    assert_close(got, ref, KERNEL_TOL, "temporal_conv")


def test_temporal_conv_gate():
    assert fits_temporal_conv(25, 320, 320, 3, s=9216, batch=2)
    assert fits_temporal_conv(8, 128, 128, 3, s=1024 * 576, batch=1)
    assert fits_temporal_conv(38, 1280, 1280, 3, s=240)      # more than 32 frames
    assert fits_temporal_conv(189, 1280, 1280, 3)            # the JAX budget's edge
    assert not fits_temporal_conv(190, 1280, 1280, 3)
    assert not fits_temporal_conv(25, 64, 64, 2)             # even taps
    assert not fits_temporal_conv(25, 64, 64, 7)
    assert not fits_temporal_conv(8, 128, 128, 3, s=16 * 65536)   # grid y limit
    assert not fits_temporal_conv(8, 128, 128, 3, batch=65536)    # grid z limit


@pytest.mark.parametrize("c", [3, 128, 320, 640, 1280])
@pytest.mark.parametrize("kt", [1, 3, 5])
def test_temporal_conv_gate_admits_what_jax_admits(c, kt):
    for t_len in range(1, 65):
        assert fits_temporal_conv(t_len, c, c, kt, s=14400) == \
            jax_fits_temporal_conv(t_len, c, c, kt), (t_len, c, kt)


@pytest.mark.parametrize("fn,args", [
    (flash_attention, lambda: [torch.empty(2, 64, 64, device="meta")] * 3),
    (geglu_ff, lambda: [torch.empty(8, 32, device="meta"), torch.empty(256, 32, device="meta"),
                        torch.empty(256), torch.empty(32, 128, device="meta"),
                        torch.empty(32)]),
    (temporal_conv, lambda: [torch.empty(1, 5, 16, 8, device="meta"),
                             torch.empty(3, 8, 8, device="meta"), torch.empty(8)]),
    (functools.partial(flash_attention_packed, num_heads=2),
     lambda: [torch.empty(1, 64, 128, device="meta")] * 3),
    (functools.partial(fused_group_norm, num_groups=8),
     lambda: [torch.empty(2, 16, 64, device="meta"), torch.empty(64), torch.empty(64)]),
    (functools.partial(fused_temporal_attention, batch=1, frames_q=4, frames_kv=4, num_heads=2),
     lambda: [torch.empty(4, 16, 128, device="meta")] * 3),
])
def test_wrappers_take_plain_version_only_on_cpu(fn, args):
    """A tensor that is neither on the CPU nor on CUDA is refused, not
    quietly computed by the plain version."""
    wrapper = getattr(fn, "func", fn)
    before = wrapper.launches
    with pytest.raises(ValueError):
        fn(*args())
    assert wrapper.launches == before


# ---------------------------------------------------------------- K5 -----

@pytest.mark.parametrize("n,l,c,groups", [
    (3, 48, 64, 8),       # tests/test_ops.py's geometry
    (2, 4100, 64, 32),    # L not a multiple of the Pallas kernel's 4096-row blocks
    (1, 30, 320, 32),     # 10 channels per group
    (2, 300, 128, 32),    # the SD VAE's widths: 4, 8 and 16 channels per group
    (1, 130, 256, 32),
    (1, 70, 512, 32),
])
@pytest.mark.parametrize("act", [None, "silu"])
def test_fused_group_norm_plain_matches_pallas(n, l, c, groups, act):
    """1e-4: the Pallas kernel takes one-pass E[x^2] - E[x]^2 statistics."""
    rng = np.random.RandomState(9)
    x = rng.randn(n, l, c).astype(np.float32)
    s = rng.randn(c).astype(np.float32)
    b = rng.randn(c).astype(np.float32)
    ref = jax_fused_gn(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b), num_groups=groups,
                       eps=1e-5, act=act or "none", interpret=True)
    got = fused_group_norm(t(x), t(s), t(b), num_groups=groups, eps=1e-5, act=act)
    assert_close(got, ref, 1e-4, "fused group norm")


def test_fused_group_norm_plain_keeps_a_large_offset():
    """The plain version against the port's group_norm and against f64
    statistics where a group sits at offset 100 with spread 1e-3 (the regime
    of tests/test_ops.py::test_group_norm_large_offset_low_variance; the
    absolute 5e-2 on the unit-scale output separates two-pass statistics from
    cancelled one-pass ones)."""
    rng = np.random.RandomState(11)
    x = (100.0 + rng.randn(2, 16, 32) * 1e-3).astype(np.float32)
    ones, zeros = np.ones(32, np.float32), np.zeros(32, np.float32)
    got = fused_group_norm(t(x), t(ones), t(zeros), num_groups=4).numpy()
    plain = port_norms.group_norm(t(x).reshape(2, 4, 4, 32), t(ones), t(zeros),
                                  num_groups=4).numpy().reshape(x.shape)
    xr = x.astype(np.float64).reshape(2, 16, 4, 8)
    ref = ((xr - xr.mean(axis=(1, 3), keepdims=True))
           / np.sqrt(xr.var(axis=(1, 3), keepdims=True) + 1e-6)).reshape(x.shape)
    np.testing.assert_allclose(got, ref, atol=5e-2, rtol=0)
    np.testing.assert_allclose(got, plain, atol=1e-5, rtol=0)


@pytest.mark.parametrize("shape,groups,act", [
    ((2, 6, 6, 64), 32, "silu"), ((3, 4, 5, 16), 8, None), ((2, 4, 4, 12), 4, "silu"),
])
def test_group_norm_fused_route_matches_plain(shape, groups, act):
    """Under the fused_group_norm routing a 4-D GroupNorm takes the K5
    wrapper (its plain version on the CPU) where the kernel's gate allows,
    and gives what the plain path gives."""
    rng = np.random.RandomState(12)
    x = (rng.randn(*shape) * 2 + 0.5).astype(np.float32)
    s = (1 + 0.1 * rng.randn(shape[-1])).astype(np.float32)
    b = (0.1 * rng.randn(shape[-1])).astype(np.float32)
    off = port_norms.group_norm(t(x), t(s), t(b), num_groups=groups, eps=1e-5, act=act)
    with use_routing(KernelRouting(fused_group_norm=True)):
        on = port_norms.group_norm(t(x), t(s), t(b), num_groups=groups, eps=1e-5, act=act)
    assert_close(on, off.numpy(), KERNEL_TOL, "fused route")


# ---------------------------------------------------------------- K6 -----

@pytest.mark.parametrize("b,tq,tkv,s,h,d", [
    (2, 25, 25, 256, 5, 64),   # tests/test_ops.py's geometries
    (2, 25, 7, 256, 5, 64),    # frames_q != frames_kv (the CAM 25 x 7 contract)
    (2, 38, 38, 96, 8, 64),    # stage 2's 38 frames
    (2, 1, 1, 30, 5, 64),      # one frame
    (1, 64, 64, 20, 3, 64),    # the gate's 64 frames
    (3, 20, 9, 37, 3, 64),     # frames_kv not a multiple of 16, pairs not of 4
])
def test_temporal_attention_plain_matches_pallas(b, tq, tkv, s, h, d):
    rng = np.random.RandomState(13)
    q = rng.randn(b * tq, s, h * d).astype(np.float32)
    k, v = (rng.randn(b * tkv, s, h * d).astype(np.float32) for _ in range(2))
    kw = dict(batch=b, frames_q=tq, frames_kv=tkv, num_heads=h)
    ref = jax_temporal_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw,
                                 interpret=True)
    assert_close(fused_temporal_attention(t(q), t(k), t(v), **kw), ref, KERNEL_TOL, "K6 plain")
    assert_close(temporal_attention(t(q), t(k), t(v), **kw), ref, KERNEL_TOL, "dispatcher")


def test_temporal_attention_outside_the_gate_takes_the_plain_version():
    rng = np.random.RandomState(14)
    q = t(rng.randn(70, 4, 16).astype(np.float32))   # 70 frames > 64
    before = fused_temporal_attention.launches
    out = temporal_attention(q, q, q, batch=1, frames_q=70, frames_kv=70, num_heads=2)
    assert out.shape == q.shape and fused_temporal_attention.launches == before


# ------------------------------------------------------------- routing ---

def test_routing_defaults_to_the_jax_switches_and_resets():
    from streamingt2v_torch.config import EnhanceConfig, PipelineConfig

    assert current_routing() == KernelRouting()
    assert PipelineConfig().routing == KernelRouting()
    assert EnhanceConfig().routing == KernelRouting(True, True, True)
    with use_routing(KernelRouting(flash_packed=True)):
        assert current_routing().flash_packed
        with pytest.raises(RuntimeError):
            with use_routing(KernelRouting(temporal_attention=True)):
                assert current_routing().temporal_attention
                raise RuntimeError
        assert current_routing() == KernelRouting(flash_packed=True)
    assert current_routing() == KernelRouting()


# --------------------------------------------------------------- norms ---

@pytest.mark.parametrize("shape,groups", [
    ((3, 48, 64), 8),            # 3-D (N, L, C)
    ((2, 6, 6, 32), 4),
    ((2, 3, 4, 4, 64), 32),      # 5-D temporal span: stats over T*H*W
    ((2, 4, 4, 8), 32),          # groups clamped to C
])
@pytest.mark.parametrize("act", [None, "silu"])
def test_group_norm_matches_jax(shape, groups, act):
    rng = np.random.RandomState(3)
    x = (rng.randn(*shape) * 2 + 0.5).astype(np.float32)
    s = (1 + 0.1 * rng.randn(shape[-1])).astype(np.float32)
    b = (0.1 * rng.randn(shape[-1])).astype(np.float32)
    ref = jax_norms.group_norm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b),
                               num_groups=groups, eps=1e-5, act=act)
    got = port_norms.group_norm(t(x), t(s), t(b), num_groups=groups, eps=1e-5, act=act)
    assert_close(got, ref, KERNEL_TOL, "group_norm")


@pytest.mark.parametrize("shape", [(2, 3, 4, 4, 64), (3, 16, 8)])
def test_group_norm_affine_matches_jax(shape):
    rng = np.random.RandomState(4)
    x = rng.randn(*shape).astype(np.float32)
    s = (1 + 0.1 * rng.randn(shape[-1])).astype(np.float32)
    b = (0.1 * rng.randn(shape[-1])).astype(np.float32)
    ra, rb = jax_norms.group_norm_affine(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b), eps=1e-5)
    ga, gb = port_norms.group_norm_affine(t(x), t(s), t(b), eps=1e-5)
    assert_close(ga, ra, 1e-4, "affine a")
    assert_close(gb, rb, 1e-4, "affine b")
    # and the affine reproduces group_norm
    gn = port_norms.group_norm(t(x), t(s), t(b), eps=1e-5)
    lead = (x.shape[0],) + (1,) * (x.ndim - 2) + (x.shape[-1],)
    assert_close(t(x) * ga.reshape(lead) + gb.reshape(lead), gn.numpy(), 1e-5, "affine form")


def test_layer_norm_matches_jax():
    rng = np.random.RandomState(5)
    x = (rng.randn(3, 7, 16) + 1.0).astype(np.float32)
    s = (1 + 0.1 * rng.randn(16)).astype(np.float32)
    b = (0.1 * rng.randn(16)).astype(np.float32)
    ref = jax_norms.layer_norm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b))
    assert_close(port_norms.layer_norm(t(x), t(s), t(b)), ref, KERNEL_TOL, "layer_norm")
    assert_close(port_norms.layer_norm(t(x)), jax_norms.layer_norm(jnp.asarray(x)),
                 KERNEL_TOL, "layer_norm no affine")


@pytest.mark.parametrize("dim", [8, 9, 320])
def test_timestep_embedding_matches_jax(dim):
    """1e-4: at t ~ 1000 one f32 ulp of a frequency moves sin/cos by ~6e-5."""
    ts = np.array([0.0, 1.0, -3.5, 127.0, 999.0], np.float32)
    assert_close(timestep_embedding(t(ts), dim), jax_timestep_embedding(jnp.asarray(ts), dim),
                 1e-4, "timestep_embedding")


# ----------------------------------------------------------- attention ---

@pytest.mark.parametrize("b,lq,lk,heads,hd", [
    (2, 40, 9, 4, 64),     # plain path
    (64, 25, 25, 5, 320),  # b*heads >= 256 with tiny L: the grouped path
    (80, 25, 7, 4, 128),   # CAM-like 25 x 7, grouped
    (2, 257, 257, 2, 32),  # CLIP-like length, plain
])
def test_attention_dispatcher_matches_jax(b, lq, lk, heads, hd):
    rng = np.random.RandomState(6)
    q = rng.randn(b, lq, hd).astype(np.float32)
    k = rng.randn(b, lk, hd).astype(np.float32)
    v = rng.randn(b, lk, hd).astype(np.float32)
    ref = jax_attention_mod.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      num_heads=heads)
    got = port_attention_mod.attention(t(q), t(k), t(v), num_heads=heads)
    assert_close(got, ref, 1e-5, "attention")


@pytest.mark.parametrize("bh,lq,lk,d", [(300, 25, 25, 64), (257, 3, 5, 32), (40, 30, 30, 16)])
def test_attention_pre_split_and_grouped_match_jax(bh, lq, lk, d):
    rng = np.random.RandomState(7)
    q, k, v = (rng.randn(bh, n, d).astype(np.float32) for n in (lq, lk, lk))
    ref = jax_attention_mod.attention_pre_split(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    assert_close(port_attention_mod.attention_pre_split(t(q), t(k), t(v)), ref, 1e-5, "pre_split")
    ref_g = jax_attention_mod._grouped_tiny_attention(jnp.asarray(q), jnp.asarray(k),
                                                      jnp.asarray(v))
    assert_close(port_attention_mod._grouped_tiny_attention(t(q), t(k), t(v)), ref_g, 1e-5,
                 "grouped")


@pytest.mark.parametrize("bh,lq,lk", [
    (250, 9216, 9216), (500, 2304, 2304), (70, 9216, 9216), (8, 9216, 9216),
    (92160, 25, 25), (2 * 9216 * 5, 25, 7), (32, 257, 257), (190, 14400, 145),
    (4, 4096, 64), (2, 2048, 2048), (2, 2047, 2048),
])
def test_flash_gate_matches_jax_on_an_accelerator(bh, lq, lk, monkeypatch):
    """The port sends to K1 exactly the geometries the JAX package sends to
    its Pallas kernel on a TPU, and none while the tensors are on the CPU."""
    monkeypatch.setattr(jax_attention_mod, "_on_tpu", lambda: True)
    want = jax_attention_mod._use_flash(bh, lq, lk)
    assert port_attention_mod._use_flash(bh, lq, lk, torch.device("cuda")) == want
    assert not port_attention_mod._use_flash(bh, lq, lk, torch.device("cpu"))


# ------------------------------------------------------- import boundary ---

def test_port_imports_without_jax():
    """Every module of the port, and each of its examples
    (``examples/torch/``), imports in a process where JAX cannot, nor
    OpenCV, Pillow or safetensors (the product's path needs none of them;
    the card's machine has no safetensors)."""
    code = ("import importlib, importlib.util, pathlib, pkgutil, sys\n"
            "for m in ('jax', 'flax', 'jaxlib', 'streamingt2v_tpu', 'cv2', 'PIL',\n"
            "          'safetensors'):\n"
            "    sys.modules[m] = None\n"
            "import streamingt2v_torch as pkg\n"
            "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
            "for name in names:\n"
            "    importlib.import_module(name)\n"
            "examples = sorted(pathlib.Path('examples/torch').glob('*.py'))\n"
            "for path in examples:\n"
            "    spec = importlib.util.spec_from_file_location(path.stem, path)\n"
            "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
            "print(len(names), len(examples))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    modules, examples = (int(v) for v in proc.stdout.split())
    assert modules >= 52 and examples == 3, proc.stdout


def test_port_sources_name_no_jax():
    banned = ("jax", "flax", "jaxlib", "streamingt2v_tpu")
    files = list((REPO / "streamingt2v_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    files += list((REPO / "examples" / "torch").glob("*.py"))
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for name in names:
                assert name.split(".")[0] not in banned, f"{path}: imports {name}"
