"""PyTorch port, the training side of the ops: each kernel's backward
(K1-K4) against ``jax.vjp`` through the JAX op in interpret mode (its
``custom_vjp``, whose backward differentiates the plain math), on the same
numpy inputs and cotangent.

Checked for each: the port's backward function (the one its
``torch.autograd.Function`` runs on the card), the same with a forced small
chunk against the unchunked one, autograd through the port's CPU path, and
the Function itself with its kernel launch replaced by the plain version.

Tolerances, relative to max |JAX gradient|: 1e-5 (f32 on both sides, a
different summation order); chunked against unchunked 1e-6 (the same
arithmetic per row; only K3's and K4's summed weight gradients add in
another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import assert_close, t
from streamingt2v_tpu.ops import flash_attention as jax_flash_mod
from streamingt2v_tpu.ops.fused_ff import geglu_ff as jax_geglu
from streamingt2v_tpu.ops.temporal_conv import temporal_conv as jax_temporal_conv
from streamingt2v_torch.ops import flash_attention as port_flash_mod
from streamingt2v_torch.ops import fused_ff as port_ff_mod
from streamingt2v_torch.ops import temporal_conv as port_tc_mod
from streamingt2v_torch.ops.flash_attention import (
    backward_chunk_rows, flash_attention, flash_attention_backward, flash_attention_packed,
    flash_attention_packed_backward, flash_attention_packed_reference, flash_attention_reference)
from streamingt2v_torch.ops.fused_ff import geglu_ff, geglu_ff_backward, geglu_ff_reference
from streamingt2v_torch.ops.temporal_conv import (
    temporal_conv, temporal_conv_backward, temporal_conv_reference)

TOL = 1e-5
CHUNK_TOL = 1e-6


def _jax_vjp(fn, args, g):
    """jax.vjp of fn at the numpy args (None stays None) for cotangent g."""
    live = [i for i, a in enumerate(args) if a is not None]

    def f(*diff):
        full = [None if a is None else jnp.asarray(a) for a in args]
        for i, a in zip(live, diff):
            full[i] = a
        return fn(*full)

    _, vjp = jax.vjp(f, *[jnp.asarray(args[i]) for i in live])
    out = [None] * len(args)
    for i, gr in zip(live, vjp(jnp.asarray(g))):
        out[i] = np.asarray(gr)
    return out


def _autograd(fn, args, g):
    """Gradients of fn at torch copies of the numpy args through autograd."""
    leaves = [None if a is None else t(a).requires_grad_() for a in args]
    fn(*leaves).backward(t(g))
    return [None if a is None else a.grad for a in leaves]


def _close_all(got, ref, tol, what):
    for i, (a, b) in enumerate(zip(got, ref)):
        assert (a is None) == (b is None), (what, i)
        if b is not None:
            assert_close(a, b, tol, f"{what} grad {i}")


# ---------------------------------------------------------------- K1 -----

@pytest.mark.parametrize("bh,lq,lk,d", [
    (3, 64, 64, 64),
    (2, 130, 97, 64),     # ragged q and kv lengths
    (3, 25, 7, 32),       # head dim below the kernel's 64
    (1, 40, 33, 512),     # the VAE bottleneck head dim
])
def test_flash_backward_matches_jax_custom_vjp(bh, lq, lk, d):
    rng = np.random.RandomState(0)
    q, k, v = (rng.randn(bh, n, d).astype(np.float32) for n in (lq, lk, lk))
    g = rng.randn(bh, lq, d).astype(np.float32)
    ref = _jax_vjp(lambda *a: jax_flash_mod.flash_attention(*a, interpret=True), (q, k, v), g)
    *got, chunks = flash_attention_backward(t(q), t(k), t(v), t(g))
    assert chunks == 1
    _close_all(got, ref, TOL, "flash backward")
    *small, chunks = flash_attention_backward(t(q), t(k), t(v), t(g), chunk=2)
    assert chunks == -(-bh // 2)
    _close_all(small, got, CHUNK_TOL, "flash backward, 2-row chunks")
    _close_all(_autograd(flash_attention, (q, k, v), g), ref, TOL, "flash CPU autograd")


@pytest.mark.parametrize("b,lq,lk,h,d", [
    (2, 70, 45, 3, 64),
    (1, 33, 40, 1, 512),   # the SD VAE's one 512-wide head
])
def test_flash_packed_backward_matches_jax_custom_vjp(b, lq, lk, h, d):
    rng = np.random.RandomState(1)
    q = rng.randn(b, lq, h * d).astype(np.float32)
    k, v = (rng.randn(b, lk, h * d).astype(np.float32) for _ in range(2))
    g = rng.randn(b, lq, h * d).astype(np.float32)
    ref = _jax_vjp(lambda *a: jax_flash_mod.flash_attention_packed(*a, num_heads=h,
                                                                   interpret=True), (q, k, v), g)
    *got, chunks = flash_attention_packed_backward(t(q), t(k), t(v), t(g), h)
    assert chunks == 1
    _close_all(got, ref, TOL, "packed backward")
    *small, chunks = flash_attention_packed_backward(t(q), t(k), t(v), t(g), h, chunk=1)
    assert chunks == b * h
    _close_all(small, got, CHUNK_TOL, "packed backward, 1-row chunks")
    _close_all(_autograd(lambda *a: flash_attention_packed(*a, num_heads=h), (q, k, v), g), ref,
               TOL, "packed CPU autograd")


def test_flash_backward_chunk_rows_keep_the_budget():
    """Level 0 of the SVD UNet: two f32 (9216, 9216) matrices a row."""
    rows = backward_chunk_rows(9216, 9216)
    assert rows >= 1 and 2 * 4 * rows * 9216 ** 2 <= port_flash_mod.BWD_CHUNK_BYTES
    assert 2 * 4 * (rows + 1) * 9216 ** 2 > port_flash_mod.BWD_CHUNK_BYTES
    assert backward_chunk_rows(10 ** 6, 10 ** 6) == 1


# ---------------------------------------------------------------- K3 -----

def _geglu_operands(n, c, inner, ln, seed=2):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, c).astype(np.float32)
    w1 = (rng.randn(c, 2 * inner) * 0.1).astype(np.float32)   # the JAX layout
    b1 = (rng.randn(2 * inner) * 0.1).astype(np.float32)
    w2 = (rng.randn(inner, c) * 0.1).astype(np.float32)
    b2 = (rng.randn(c) * 0.1).astype(np.float32)
    lns = (rng.randn(c) * 0.2 + 1.0).astype(np.float32) if ln else None
    lnb = (rng.randn(c) * 0.1).astype(np.float32) if ln else None
    g = rng.randn(n, c).astype(np.float32)
    return (x, w1, b1, w2, b2, lns, lnb), g


def _to_port_layout(grads):
    """JAX w1 (C, 2I) and w2 (I, C) gradients in the port's (out, in)."""
    out = list(grads)
    for i in (1, 3):
        out[i] = out[i].T
    return out


@pytest.mark.parametrize("ln", [False, True])
@pytest.mark.parametrize("residual", [False, True])
def test_geglu_backward_matches_jax_custom_vjp(ln, residual):
    (x, w1, b1, w2, b2, lns, lnb), g = _geglu_operands(70, 48, 128, ln)

    def jax_fn(x_, w1_, b1_, w2_, b2_, lns_, lnb_):
        return jax_geglu(x_, w1_, b1_, w2_, b2_, ln_scale=lns_, ln_bias=lnb_, residual=residual,
                         block_n=64, block_i=128, interpret=True)

    ref = _to_port_layout(_jax_vjp(jax_fn, (x, w1, b1, w2, b2, lns, lnb), g))
    port_args = (t(x), t(w1.T), t(b1), t(w2.T), t(b2), None if lns is None else t(lns),
                 None if lnb is None else t(lnb))
    got, chunks = geglu_ff_backward(*port_args, residual, t(g))
    assert chunks == 1
    _close_all(got, ref, TOL, "geglu backward")
    small, chunks = geglu_ff_backward(*port_args, residual, t(g), chunk=16)
    assert chunks == 5
    _close_all(small, got, CHUNK_TOL, "geglu backward, 16-row chunks")

    def port_fn(x_, w1_, b1_, w2_, b2_, lns_, lnb_):
        return geglu_ff(x_, w1_, b1_, w2_, b2_, ln_scale=lns_, ln_bias=lnb_, residual=residual)

    auto = _autograd(port_fn, (x, w1.T.copy(), b1, w2.T.copy(), b2, lns, lnb), g)
    _close_all(auto, ref, TOL, "geglu CPU autograd")


def test_geglu_backward_keeps_a_leading_shape_and_its_chunk_budget():
    """x (B, L, C) comes back as (B, L, C); a chunk's estimated f32 working
    set stays within the budget at the SVD UNet's level-0 width."""
    (x, w1, b1, w2, b2, _, _), g = _geglu_operands(60, 48, 128, False, seed=3)
    got, _ = geglu_ff_backward(t(x).reshape(3, 20, 48), t(w1.T), t(b1), t(w2.T), t(b2), None,
                               None, True, t(g).reshape(3, 20, 48), chunk=7)
    flat, _ = geglu_ff_backward(t(x), t(w1.T), t(b1), t(w2.T), t(b2), None, None, True, t(g))
    assert got[0].shape == (3, 20, 48)
    assert_close(got[0].reshape(60, 48), flat[0], CHUNK_TOL, "dx")
    rows = port_ff_mod.backward_chunk_rows(320, 1280, 320)
    assert 0 < rows < 230400
    assert 4 * rows * (4 * 320 + 8 * 1280 + 2 * 320) <= port_ff_mod.BWD_CHUNK_BYTES


# ---------------------------------------------------------------- K4 -----

@pytest.mark.parametrize("pre", [False, True])
@pytest.mark.parametrize("res", [False, True])
def test_temporal_conv_backward_matches_jax_custom_vjp(pre, res):
    rng = np.random.RandomState(4)
    b, tt, s, c, co = 2, 7, 12, 16, 24
    x = rng.randn(b, tt, s, c).astype(np.float32)
    w = (rng.randn(3, c, co) / np.sqrt(3 * c)).astype(np.float32)
    bias = (rng.randn(co) * 0.1).astype(np.float32)
    r = rng.randn(b, tt, s, co).astype(np.float32) if res else None
    rw = rng.rand(b, tt).astype(np.float32) if res else None
    pa = (1.0 + 0.2 * rng.randn(b, c)).astype(np.float32) if pre else None
    pb = (0.2 * rng.randn(b, c)).astype(np.float32) if pre else None
    g = rng.randn(b, tt, s, co).astype(np.float32)
    args = (x, w, bias, r, rw, pa, pb)
    ref = _jax_vjp(lambda *a: jax_temporal_conv(*a, interpret=True), args, g)
    torch_args = [None if a is None else t(a) for a in args]
    got, chunks = temporal_conv_backward(*torch_args, t(g))
    assert chunks == 1
    _close_all(got, ref, TOL, "temporal conv backward")
    small, chunks = temporal_conv_backward(*torch_args, t(g), chunk=5)
    assert chunks == 3
    _close_all(small, got, CHUNK_TOL, "temporal conv backward, 5-position chunks")
    _close_all(_autograd(temporal_conv, args, g), ref, TOL, "temporal conv CPU autograd")


# ------------------------------------------------- the Functions' plumbing ---

def _plain_launches(monkeypatch):
    """Each Function's kernel launch replaced by the plain version, so that
    the Functions run on the CPU as they do on the card."""
    monkeypatch.setattr(port_flash_mod, "_launch_flash", flash_attention_reference)
    monkeypatch.setattr(port_flash_mod, "_launch_flash_packed", flash_attention_packed_reference)
    monkeypatch.setattr(port_ff_mod, "_launch_geglu", geglu_ff_reference)
    monkeypatch.setattr(port_tc_mod, "_launch_temporal_conv", temporal_conv_reference)


@pytest.mark.parametrize("case", ["k1", "k2", "k3", "k3_ln", "k4", "k4_pre_res"])
def test_functions_give_autograd_of_the_plain_version(case, monkeypatch):
    """Each ``torch.autograd.Function`` returns, for every operand that
    requires grad, the gradient autograd takes through the plain version
    (in the operand's dtype), ``None`` for absent operands, and counts the
    chunks its backward ran."""
    _plain_launches(monkeypatch)
    rng = np.random.RandomState(5)
    if case in ("k1", "k2"):
        q, k, v = (rng.randn(2, 40, 128).astype(np.float32) for _ in range(3))
        ops = [q, k, v]
        fn = port_flash_mod._FlashAttention.apply if case == "k1" else (
            lambda *a: port_flash_mod._FlashAttentionPacked.apply(*a, 2))
        plain = flash_attention_reference if case == "k1" else (
            lambda *a: flash_attention_packed_reference(*a, 2))
        counter = flash_attention if case == "k1" else flash_attention_packed
        gshape = q.shape
    elif case.startswith("k3"):
        ops = list(_geglu_operands(30, 32, 64, case == "k3_ln")[0])
        ops[1], ops[3] = ops[1].T.copy(), ops[3].T.copy()
        fn = lambda *a: port_ff_mod._GegluFF.apply(*a, True)   # noqa: E731
        plain = lambda *a: geglu_ff_reference(*a, True)   # noqa: E731
        counter = geglu_ff
        gshape = (30, 32)
    else:
        full = case == "k4_pre_res"
        b, tt, s, c = 2, 5, 6, 8
        ops = [rng.randn(b, tt, s, c).astype(np.float32),
               (rng.randn(3, c, c) * 0.2).astype(np.float32),
               (rng.randn(c) * 0.1).astype(np.float32),
               rng.randn(b, tt, s, c).astype(np.float32) if full else None,
               rng.rand(b, tt).astype(np.float32) if full else None,
               (1 + 0.2 * rng.randn(b, c)).astype(np.float32) if full else None,
               (0.2 * rng.randn(b, c)).astype(np.float32) if full else None]
        fn, plain, counter = port_tc_mod._TemporalConv.apply, temporal_conv_reference, \
            temporal_conv
        gshape = (b, tt, s, c)
    g = rng.randn(*gshape).astype(np.float32)
    before = counter.bwd_chunks
    got = _autograd(fn, ops, g)
    assert counter.bwd_chunks == before + 1
    _close_all(got, _autograd(plain, ops, g), CHUNK_TOL, case)
