"""The port's training with seq > 1 on gloo ranks on the CPU: the ring's
backward (``parallel/ring_attention.py``), the gathered path's summing
gather (``ops/attention._seq_split_attention``) and the train step's sum of
the token-split blocks' gradients over seq (``parallel/train.py``), held
against the JAX package's single-device ``jax.vjp`` and ``jax.grad``.

One world of four spawned ranks (``_torch_port_dist.seq_rank``) runs the
ring at (1, 4, 1) and the tiny SVD UNet's training step, remat on, at
(2, 2, 1) and (1, 2, 2).  Tolerances: dq/dk/dv within 1e-5 of max |JAX
gradient| (f32; the ring folds its blocks in another order); the UNet's
loss within 1e-5 and every gradient leaf by ``_check_grads``
(``test_torch_port_training.py``); AdamW's parameters after two steps as
in ``test_torch_port_parallel.py``'s (2, 1, 2) test.
"""

from __future__ import annotations

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port_dist as rd
from _torch_port_helpers import assert_close, t
from test_torch_port_parallel import _jax_loss_and_grads, close
from test_torch_port_training import (
    ADAM_TOL, LR, WD, _batch_np, _check_grads, _port_batch, jax_draws, unet_pair)

GRAD_TOL = 1e-5
SEQ = 4
MESHES = ((2, 2, 1), (1, 2, 2))


@pytest.fixture(scope="module")
def seq_results(tmp_path_factory):
    from streamingt2v_torch.diffusion.loss import DiffusionLossConfig
    from streamingt2v_torch.models.wrappers import openai_wrapper
    from streamingt2v_torch.parallel.train import make_train_step

    rng = np.random.RandomState(2)
    qkvg = tuple(t(rng.randn(3, 128, 32).astype(np.float32)) for _ in range(4))
    jm, flat, tm = unet_pair(True, seed=9)
    x0, cond = _batch_np(6)
    batch = dict(zip(("latents", "cond"), _port_batch(x0, cond)))
    keys = [jax.random.PRNGKey(40 + i) for i in range(2)]
    loss_cfg = DiffusionLossConfig()
    draws = [jax_draws(loss_cfg, k, x0.shape) for k in keys]
    init = {n: p.detach().clone() for n, p in tm.named_parameters()}
    one = copy.deepcopy(tm).requires_grad_(True)
    step = make_train_step(lambda: openai_wrapper(one), loss_cfg,
                           torch.optim.AdamW(one.parameters(), lr=LR, weight_decay=WD))
    one_losses, one_grads = [], []
    for d in draws:
        one_losses.append(step.backward(batch, **d))
        one_grads.append({n: p.grad.clone() for n, p in one.named_parameters()})
        step.update()
    payload = dict(qkvg=qkvg, train_unet=tm, batch=batch, draws=draws, lr_wd=(LR, WD))
    results = rd.run_ranks(rd.seq_rank, 4, tmp_path_factory.mktemp("seq"), payload,
                           timeout=240)
    ref_loss, ref_grads = _jax_loss_and_grads(jm, flat, x0, cond, keys[0])
    return dict(results=results, qkvg=qkvg, init=init, one_losses=one_losses,
                one_grads=one_grads, ref_loss=ref_loss, ref_grads=ref_grads)


def _jax_attention_vjp(qkvg):
    from streamingt2v_tpu.ops.attention import dot_product_attention

    q, k, v, g = (jnp.asarray(a.numpy()) for a in qkvg)
    out, vjp = jax.vjp(dot_product_attention, q, k, v)
    return np.asarray(out), [np.asarray(x) for x in vjp(g)]


@pytest.mark.parametrize("path", ["ring", "gathered"])
def test_token_split_attention_gradients_match_jax_vjp(seq_results, path):
    """The ring (its backward around the ring a second time) and the
    gathered path (k/v gathered, their gradients reduce-scattered) at
    seq = 4: each rank's output and its block of dq, dk and dv against
    ``jax.vjp`` of the JAX package's single-device attention."""
    ref_out, ref = _jax_attention_vjp(seq_results["qkvg"])
    blk = ref_out.shape[1] // SEQ
    for r, res in enumerate(seq_results["results"]):
        got = res[path]
        rows = slice(blk * r, blk * (r + 1))
        close(got["out"], ref_out[:, rows], f"{path} rank {r} out", 2e-5)
        for name, g, want in zip("qkv", got["grads"], ref):
            close(g, want[:, rows], f"{path} rank {r} d{name}",
                  GRAD_TOL * float(np.abs(want).max()))
    if path == "ring":
        assert [res["ring"]["blocks"] for res in seq_results["results"]] == [
            [(r - j) % SEQ for j in range(SEQ)] for r in range(SEQ)]


def test_ring_per_hop_functions_equal_the_p2p_ring(seq_results):
    """``ring_start``/``ring_fold``/``ring_lse`` and ``ring_bwd_fold``
    driven one simulated rank after another in this process, each dk/dv
    block summed in the order its accumulator travels: each rank's dq and
    each owner's dk/dv equal the P2P ring's."""
    from streamingt2v_torch.parallel.ring_attention import (
        ring_bwd_fold, ring_delta, ring_finish, ring_fold, ring_lse, ring_start)

    q, k, v, g = (x.reshape(x.shape[0], SEQ, -1, x.shape[-1]).unbind(1)
                  for x in seq_results["qkvg"])
    dk, dv = [None] * SEQ, [None] * SEQ
    for hop in range(SEQ):      # hop j: rank r holds block (r - j) % SEQ
        for r in range(SEQ):
            state = ring_start(q[r])
            for j in range(SEQ):
                state = ring_fold(state, k[(r - j) % SEQ], v[(r - j) % SEQ])
            out = ring_finish(state, q[r].dtype)
            b = (r - hop) % SEQ
            parts = ring_bwd_fold(q[r], k[b], v[b], g[r], ring_lse(state), ring_delta(out, g[r]))
            if hop == 0:
                dk[b], dv[b] = parts[1], parts[2]
            else:
                dk[b], dv[b] = parts[1] + dk[b], parts[2] + dv[b]
    for r, res in enumerate(seq_results["results"]):
        state = ring_start(q[r])
        for j in range(SEQ):
            state = ring_fold(state, k[(r - j) % SEQ], v[(r - j) % SEQ])
        out = ring_finish(state, q[r].dtype)
        lse, delta = ring_lse(state), ring_delta(out, g[r])
        dq = sum(ring_bwd_fold(q[r], k[(r - j) % SEQ], v[(r - j) % SEQ], g[r], lse, delta)[0]
                 for j in range(SEQ))
        got = res["ring"]["grads"]
        close(got[0], dq.numpy(), f"rank {r} dq", 1e-6)
        close(got[1], dk[r].numpy(), f"rank {r} dk", 1e-6)
        close(got[2], dv[r].numpy(), f"rank {r} dv", 1e-6)


@pytest.mark.parametrize("cfg", MESHES, ids=lambda c: "x".join(map(str, c)))
def test_seq_training_matches_jax(seq_results, cfg):
    """The tiny SVD UNet's loss and every gradient leaf under the mesh
    (ring attention, the seq sum; at (1, 2, 2) also the tensor-parallel
    units inside the token split) against ``jax.value_and_grad`` of the JAX
    loss on one device, on every rank."""
    for r, res in enumerate(seq_results["results"]):
        got = res[cfg]
        if cfg[2] > 1:
            assert got["tp_units"] > 0
        assert_close(got["losses"][0], seq_results["ref_loss"], 1e-5, f"rank {r} loss")
        _check_grads(got["grads"][0], seq_results["ref_grads"])


def test_seq_training_needs_the_seq_sum(seq_results):
    """The same backward at (2, 2, 1) with the sum over seq taken out: each
    rank keeps its tokens' part of the split blocks' gradients, and the
    gradient check fails."""
    for res in seq_results["results"]:
        with pytest.raises(AssertionError):
            _check_grads(res[(2, 2, 1)]["unsummed"], seq_results["ref_grads"])


def test_seq_training_adamw_steps_match_the_one_process_step(seq_results):
    """Two AdamW steps at (2, 2, 1): both losses and both steps' gradients
    against the port's one-process step, and each rank's parameters after
    the two steps those AdamW makes from its gathered gradients (within
    ADAM_TOL learning rates)."""
    s = seq_results
    for r, res in enumerate(s["results"]):
        got = res[(2, 2, 1)]
        for i in range(2):
            close(got["losses"][i], s["one_losses"][i].numpy(), f"rank {r} loss {i}")
            for name, g in s["one_grads"][i].items():
                close(got["grads"][i][name], g.numpy(), f"rank {r} step {i} d{name}")
        whole = {n: torch.nn.Parameter(p.clone()) for n, p in s["init"].items()}
        opt = torch.optim.AdamW(whole.values(), lr=LR, weight_decay=WD)
        for i in range(2):
            for n, p in whole.items():
                p.grad = got["grads"][i][n].clone()
            opt.step()
        for name, p in whole.items():
            have, want = got["params"][name].numpy(), p.detach().numpy()
            err = float((np.abs(have - want) - 2 * np.spacing(np.abs(want))).max()) / LR
            assert err <= ADAM_TOL, f"rank {r} {name}: {err:.3e} learning rates"
        moved = max(float((got["params"][n] - p).abs().max()) for n, p in s["init"].items())
        assert moved > LR
