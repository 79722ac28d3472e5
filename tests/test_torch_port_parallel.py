"""The port's multi-device layer (``streamingt2v_torch/parallel``) on gloo
ranks on the CPU, held against the JAX package's single-device results
(and its own mesh tests' cases, ``tests/test_parallel.py``).

The ranks are spawned processes in one gloo group over a ``FileStore``
(``_torch_port_dist.run_ranks``), one thread each, at tiny widths; they
import only torch and the port, and return their outputs to this process,
which holds them against the JAX references on the same weights
(``random_flat``) and inputs (numpy seeds), in f32, at the JAX mesh tests'
2e-4.  Each group of ranks runs once per module (a fixture) and several
tests read its results.
"""

from __future__ import annotations

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_port_dist as rd
from _torch_port_helpers import (
    JaxEnhanceDraws, enhance_pair, jax_variables, port_module, random_flat, t)
from streamingt2v_torch.config import MeshConfig
from streamingt2v_torch.parallel import mesh as pmesh
from streamingt2v_torch.parallel import multihost, sharding

TOL = 2e-4
# score elements from which the split-flash training case sends an
# attention to flash attention: the tiny UNet's spatial self-attention
# (8x8 and 4x4 tokens), not its 3-frame or 1-token attentions
FLASH_MIN = 16 * 16


def close(got, ref, what, tol=TOL):
    got = np.asarray(got.detach().float() if torch.is_tensor(got) else got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    assert np.isfinite(got).all(), what
    np.testing.assert_allclose(got, ref, atol=tol, rtol=tol, err_msg=what)


# --------------------------------------------------- without processes ---

def test_mesh_shape_for():
    cfg = pmesh.mesh_shape_for(8, prefer_model=2)
    assert (cfg.num_devices, cfg.data, cfg.seq, cfg.model) == (8, 4, 1, 2)
    assert pmesh.mesh_shape_for(6, prefer_model=4) == MeshConfig(data=3, seq=1, model=2)


def test_rank_grid_is_data_major_and_refuses_a_larger_mesh():
    grid = pmesh.rank_grid(MeshConfig(4, 1, 2), range(8))
    assert grid.shape == (4, 1, 2) and grid[1, 0, 0] == 2 and grid[3, 0, 1] == 7
    with pytest.raises(ValueError, match="needs 8 ranks, have 4"):
        pmesh.rank_grid(MeshConfig(4, 1, 2), range(4))


def test_create_mesh_without_a_group_refuses_several_ranks():
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="needs 2 ranks"):
        pmesh.create_mesh(MeshConfig(2, 1, 1))


def test_logical_spec():
    assert sharding.spec_for(("batch", "frames", "tokens", "heads")) == (
        "data", None, "seq", "model")


def test_param_logical_axes_on_the_port_names():
    """The JAX package's column- and row-parallel rules, matched on the
    port's state-dict names, in its (out, in) layouts."""
    from streamingt2v_torch.models.cam import CAMConditionalModel
    from streamingt2v_torch.models.unet_blocks import SpatialVideoTransformer

    names = set(SpatialVideoTransformer(64, 2, 32, context_dim=32, device="meta").state_dict())
    names |= {"cam." + n for n in CAMConditionalModel(64, 32, device="meta").state_dict()}
    col, row = ("channels_out", "channels"), ("channels", "channels_out")
    want = {
        "proj_in.kernel": col, "proj_in.bias": ("channels_out",),
        "block_0.attn1.to_q.kernel": col, "block_0.attn2.to_v.kernel": col,
        "block_0.attn1.to_out.kernel": row, "block_0.attn1.to_out.bias": (None,),
        "block_0.ff.proj.kernel": col, "block_0.ff.proj.bias": ("channels_out",),
        "block_0.ff.out.kernel": row, "block_0.ff.out.bias": (None,),
        "time_block_0.ff_in.proj.kernel": col, "time_block_0.ff_in.out.kernel": row,
        "proj_out.kernel": (None, "channels"), "time_pos_embed_0.kernel": (None, "channels"),
        "norm_scale": (None,), "cam.proj_in.kernel": col, "cam.to_k.kernel": col,
        "cam.to_out.kernel": row, "cam.proj_out.kernel": (None, "channels"),
    }
    assert set(want) <= names
    for name, axes in want.items():
        assert sharding._param_logical_axes(tuple(name.split(".")), len(axes)) == axes, name
    assert sharding._param_logical_axes(("x", "conv", "kernel"), 4) == (None,) * 4


def test_multihost_grid_is_granule_major_and_refuses_model_over_dcn():
    cfg = MeshConfig(data=4, seq=1, model=2)
    one = multihost.multihost_rank_grid(cfg, range(8), [0] * 8)
    assert np.array_equal(one, pmesh.rank_grid(cfg, range(8)))
    # two granules listed interleaved: granule-major all the same
    ranks = [0, 4, 1, 5, 2, 6, 3, 7]
    granule_of = [0 if r < 4 else 1 for r in ranks]
    grid = multihost.multihost_rank_grid(cfg, ranks, granule_of)
    rows = [0 if r < 4 else 1 for r in grid[:, 0, 0]]
    assert rows == sorted(rows) == [0, 0, 1, 1]
    for i in range(4):      # each model line inside one granule
        assert len({0 if r < 4 else 1 for r in grid[i].flat}) == 1
    with pytest.raises(ValueError, match="DCN granule"):
        multihost.multihost_rank_grid(MeshConfig(1, 1, 8), range(8), [r // 4 for r in range(8)])
    with pytest.raises(ValueError, match="evenly"):
        multihost.multihost_rank_grid(MeshConfig(2, 1, 3), range(6), [0, 0, 0, 0, 1, 1])


def test_multihost_initialize_single_process_noop(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    multihost.initialize()
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="need an address"):
        multihost.initialize(num_processes=2)


def test_training_refuses_a_seq_axis():
    """The token split's attention (the ring, or k/v gathered over seq) has
    no backward: ``make_train_step`` refuses a mesh with seq > 1."""
    from streamingt2v_torch.parallel.train import make_train_step

    class SeqMesh(pmesh.Mesh):      # the layout of rank 0 of (1, 2, 1), no groups
        def __init__(self):
            pmesh.MeshLayout.__init__(self, MeshConfig(1, 2, 1),
                                      {"data": 0, "seq": 0, "model": 0})

    with pytest.raises(ValueError, match="seq > 1"):
        make_train_step(lambda: None, None, None, mesh=SeqMesh())


def test_without_an_active_mesh_nothing_splits():
    x = torch.ones(4, 6)
    assert sharding.shard(x, "batch", "tokens") is x and sharding.gather(x, "batch") is x
    assert sharding.get_active_mesh() is None and not sharding.is_split("seq")


# ------------------------------------------ world 8: meshes and the SVT ---

@pytest.fixture(scope="module")
def mesh_results(tmp_path_factory):
    """(2, 2, 2) at 36x64 = 2304 tokens, the JAX mesh test's geometry."""
    from streamingt2v_tpu.models.unet_blocks import SpatialVideoTransformer as JaxSVT
    from streamingt2v_torch.models.unet_blocks import SpatialVideoTransformer

    B, T, H, W, C = 2, 2, 36, 64, 64
    jm = JaxSVT(heads=2, dim_head=32, depth=1, context_dim=32)
    rng = np.random.RandomState(0)
    x = rng.randn(B, T, H, W, C).astype(np.float32)
    ctx = rng.randn(B, T, 1, 32).astype(np.float32)
    ioi = np.zeros((B, T), bool)
    flat = random_flat(jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(ctx), jnp.asarray(ioi)))["params"], 1)
    ref = np.asarray(jax.jit(jm.apply)(jax_variables(flat), x, ctx, ioi))
    svt = port_module(SpatialVideoTransformer(C, 2, 32, depth=1, context_dim=32), flat)
    payload = dict(svt=svt, svt_inputs=(t(x), t(ctx), torch.from_numpy(ioi)))
    results = rd.run_ranks(rd.mesh_rank, 8, tmp_path_factory.mktemp("mesh"), payload,
                           timeout=150)
    return dict(results=results, ref=ref)


def test_create_mesh_shapes_and_coords(mesh_results):
    res = mesh_results["results"]
    assert all(r["shape412"] == {"data": 4, "seq": 1, "model": 2} for r in res)
    assert [tuple(r["coords412"].values()) for r in res] == [
        (d, 0, m) for d in range(4) for m in range(2)]
    assert [tuple(r["coords222"].values()) for r in res] == [
        (d, s, m) for d in range(2) for s in range(2) for m in range(2)]


def test_compound_fold_shard_uses_all_axes(mesh_results):
    """The (batch, tokens, heads) fold is split by all three axes, major to
    minor: rank r holds rows [2r, 2r + 2) of 16; an indivisible fold stays
    whole; without an active mesh nothing moves."""
    x = torch.arange(16 * 4 * 8, dtype=torch.float32).reshape(16, 4, 8)
    for r, res in enumerate(mesh_results["results"]):
        assert torch.equal(res["fold"], x[2 * r:2 * r + 2])
        assert torch.equal(res["fold_back"], x)
        assert res["indivisible"] == (6, 4, 8)
        d, s = res["coords222"]["data"], res["coords222"]["seq"]
        assert torch.equal(res["tokens"], x[8 * d:8 * d + 8, 2 * s:2 * s + 2])
        assert res["no_mesh"]


def test_process_batch_slice_and_global_batch_from_local(mesh_results):
    data = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    for r, res in enumerate(mesh_results["results"]):
        d = r // 2
        assert res["batch_slice"] == (4 * d, 4 * d + 4)     # model ranks feed the same rows
        assert np.array_equal(res["global_batch"].numpy(), data)


def test_shard_params_keeps_each_ranks_slice(mesh_results):
    """Two heads over model = 2: q/k/v keep half their rows, to_out half its
    columns, the GEGLU up-projection half of a and half of b, the FF's down
    projection half its columns; biases of row-parallel layers and the
    norms stay whole.  Three heads do not split: the attentions stay whole
    while the FF (384 hidden units) splits.  ``gather_params`` gives back
    the whole weights on every rank."""
    for res in mesh_results["results"]:
        two, three = res["blocks"][2], res["blocks"][3]
        s = two["shapes"]
        assert s["attn1.to_q.kernel"] == (32, 64) and s["attn2.to_v.kernel"] == (32, 64)
        assert s["attn1.to_out.kernel"] == (64, 32) and s["attn1.to_out.bias"] == (64,)
        assert s["ff.proj.kernel"] == (256, 64) and s["ff.proj.bias"] == (256,)
        assert s["ff.out.kernel"] == (64, 128) and s["ff.out.bias"] == (64,)
        assert s["norm1_scale"] == (64,)
        assert two["units"] == ["attn1", "attn2", "ff"] and two["gathered"]
        s = three["shapes"]
        assert s["attn1.to_q.kernel"] == (96, 96) and s["ff.out.kernel"] == (96, 192)
        assert three["units"] == ["ff"] and three["gathered"]


def test_seq_sharded_transformer_matches_jax(mesh_results):
    """SpatialVideoTransformer at data 2, seq 2, model 2 against the JAX
    single-device forward: every rank returns the whole output."""
    for r, res in enumerate(mesh_results["results"]):
        assert res["svt_split"]
        close(res["svt"], mesh_results["ref"], f"rank {r}")


# ----------------------------------------------------- world 4: the ring ---

@pytest.fixture(scope="module")
def ring_results(tmp_path_factory):
    rng = np.random.RandomState(0)
    qkv = tuple(t(rng.randn(4, 512, 64).astype(np.float32)) for _ in range(3))
    rows6 = tuple(t(rng.randn(6, 256, 32).astype(np.float32)) for _ in range(3))
    results = rd.run_ranks(rd.ring_rank, 4, tmp_path_factory.mktemp("ring"),
                           dict(qkv=qkv, rows6=rows6), timeout=90)
    return dict(results=results, qkv=qkv, rows6=rows6)


def test_ring_attention_matches_gathered(ring_results):
    """Ring attention at seq = 4: each rank's query block against every
    rank's k/v, equal to the whole attention (the JAX package's reference
    ``dot_product_attention``) within 2e-5; each rank folds the four blocks,
    its own first."""
    from streamingt2v_tpu.ops.attention import dot_product_attention

    q, k, v = (jnp.asarray(a.numpy()) for a in ring_results["qkv"])
    ref = np.asarray(dot_product_attention(q, k, v))
    for r, res in enumerate(ring_results["results"]):
        close(res["ring"], ref[:, 128 * r:128 * (r + 1)], f"ring rank {r}", 2e-5)
        assert res["blocks"] == [(r - j) % 4 for j in range(4)]


def test_ring_opt_out_gathers_kv(ring_results):
    """With the routing's ring off, ``_maybe_ring`` declines and the
    token-split attention gathers k/v instead: the same result.  Neither
    has a backward: both raise under grad."""
    for res in ring_results["results"]:
        assert res["maybe_ring_off"] is None
        close(res["gathered"], res["ring"], "gathered", 2e-5)
        assert "no backward" in res["grad_refused"]
        assert "no backward" in res["gathered_grad_refused"]


def test_flash_sharded_splits_padded_rows(ring_results):
    """Six rows whole on four ranks: padded to eight, two a rank, each
    rank's slice through flash attention (its plain version on the CPU),
    gathered back: the unsplit result on every rank."""
    from streamingt2v_torch.ops.flash_attention import flash_attention

    ref = flash_attention(*ring_results["rows6"])
    for res in ring_results["results"]:
        close(res["flash_sharded"], ref.numpy(), "flash sharded", 1e-6)


# ---------------------------- world 4, (2, 1, 2): stage 1 and training ---

@pytest.fixture(scope="module")
def stage1_results(tmp_path_factory):
    from streamingt2v_tpu.config import ControlNetConfig as JCN
    from streamingt2v_tpu.config import VideoUNetConfig as JVU
    from streamingt2v_tpu.diffusion import denoise as jdenoise
    from streamingt2v_tpu.models.controlnet import ControlNet as JControlNet
    from streamingt2v_tpu.models.video_unet import VideoUNet as JVideoUNet
    from streamingt2v_tpu.models.wrappers import streaming_wrapper as jstreaming
    from streamingt2v_torch import config as pcfg
    from streamingt2v_torch.diffusion.denoiser import denoise
    from streamingt2v_torch.diffusion.loss import DiffusionLossConfig
    from streamingt2v_torch.models.controlnet import ControlNet
    from streamingt2v_torch.models.video_unet import VideoUNet
    from streamingt2v_torch.models.wrappers import openai_wrapper, streaming_wrapper
    from streamingt2v_torch.parallel.train import make_train_step
    from test_torch_port_training import (
        LR, WD, _batch_np, _port_batch, jax_draws, unet_pair)

    # the streaming denoise step of tests/test_parallel.py:137
    ucfg, ccfg = JVU.tiny(controlnet_mode=True), JCN.tiny()
    unet, cn = JVideoUNet(ucfg), JControlNet(ucfg, ccfg)
    rng = np.random.RandomState(0)
    B, T, FC, H, W = 2, 4, 2, 8, 8
    scale = 2 ** (len(ccfg.conditioning_embedding_out_channels) - 1)
    x = rng.randn(B, T, H, W, 4).astype(np.float32)
    cond = {
        "concat": rng.randn(B, T, H, W, 4).astype(np.float32),
        "crossattn": rng.randn(B, T, 1, ucfg.context_dim).astype(np.float32),
        "vector": rng.randn(B, T, ucfg.adm_in_channels).astype(np.float32),
        "ctrl_frames": rng.randn(B, FC, H * scale, W * scale, 3).astype(np.float32),
    }
    sigma = np.full((B,), 2.0, np.float32)
    xc = jnp.concatenate([x, cond["concat"]], axis=-1)
    uflat = random_flat(jax.eval_shape(lambda: unet.init(
        jax.random.PRNGKey(0), xc, sigma, cond["crossattn"], cond["vector"]))["params"], 2)
    cflat = random_flat(jax.eval_shape(lambda: cn.init(
        jax.random.PRNGKey(1), xc[:, :FC], sigma, cond["crossattn"][:, :FC, :1],
        cond["vector"][:, :FC], cond["ctrl_frames"]))["params"], 3)
    ref = np.asarray(jax.jit(lambda xx, s, c: jdenoise(
        jstreaming(unet, jax_variables(uflat), cn, jax_variables(cflat), FC), xx, s, c))(
            x, sigma, cond))
    pu = port_module(VideoUNet(pcfg.VideoUNetConfig.tiny(controlnet_mode=True)), uflat)
    pc = port_module(ControlNet(pcfg.VideoUNetConfig.tiny(controlnet_mode=True),
                                pcfg.ControlNetConfig.tiny()), cflat)
    inputs = (t(x), t(sigma), {k: t(v) for k, v in cond.items()})
    with torch.no_grad():
        single = denoise(streaming_wrapper(pu, pc, FC), *inputs)

    # two training steps on the global batch of two clips
    jm, tflat, tm = unet_pair(False, seed=7)
    x0, tcond = _batch_np(5)
    batch = dict(zip(("latents", "cond"), _port_batch(x0, tcond)))
    keys = [jax.random.PRNGKey(30 + i) for i in range(2)]
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
    # a level-0 head of 32 channels: one head, which model = 2 does not split
    fjm, fflat, fm = unet_pair(False, seed=8, num_head_channels=32)
    payload = dict(unet=pu, cn=pc, denoise_inputs=inputs, f_cond=FC, lr_wd=(LR, WD),
                   train_unet=tm, batch=batch, draws=draws, flash_unet=fm,
                   flash_min=FLASH_MIN)
    results = rd.run_ranks(rd.stage1_rank, 4, tmp_path_factory.mktemp("stage1"), payload,
                           timeout=150)
    return dict(results=results, ref=ref, single=single, jm=jm, tflat=tflat, x0=x0,
                tcond=tcond, keys=keys, one_losses=one_losses, one_grads=one_grads, init=init,
                fjm=fjm, fflat=fflat)


def _jax_loss_and_grads(jm, flat, x0, cond, key):
    """The JAX loss of the JAX UNet ``jm`` on ``flat`` and every gradient
    leaf, by the port's parameter names."""
    from streamingt2v_tpu.diffusion import loss as jloss
    from streamingt2v_tpu.models import wrappers as jwrap
    from streamingt2v_tpu.utils.checkpoint import flatten_params
    from streamingt2v_torch.utils.weights import from_jax_params
    from test_torch_port_training import _jax_batch

    jx0, jcond = _jax_batch(x0, cond)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jloss.diffusion_loss(jloss.DiffusionLossConfig(),
                                       jwrap.openai_wrapper(jm, {"params": p}), jx0, jcond,
                                       key)))(jax_variables(flat)["params"])
    return loss, from_jax_params(flatten_params(grads))


def test_sharded_streaming_step_matches_jax(stage1_results):
    """The streaming denoise step (VideoUNet + ControlNet with CAM) at data
    2, model 2: every rank's whole output equals the JAX single-device
    step, as does the port's one-process step."""
    close(stage1_results["single"], stage1_results["ref"], "one process")
    for r, res in enumerate(stage1_results["results"]):
        assert res["tp_units"] > 0
        close(res["denoise"], stage1_results["ref"], f"rank {r}")


def test_sharded_training_matches_jax_and_the_one_process_step(stage1_results):
    """Two AdamW steps at data 2, model 2 on the global batch: the first
    loss and every gradient leaf against ``jax.value_and_grad`` of the JAX
    loss; both losses and both steps' gradients against the port's
    one-process step; and each rank's parameters after the two steps are
    those AdamW makes on the whole parameters from the gathered gradients,
    within 1e-4 learning rates (from one process's gradients Adam would
    amplify their f32 rounding where |g| is small, as
    ``test_torch_port_training.test_adamw_steps_match_optax`` explains)."""
    from test_torch_port_training import ADAM_TOL, LR, WD, _check_grads

    s = stage1_results
    ref_loss, ref_grads = _jax_loss_and_grads(s["jm"], s["tflat"], s["x0"], s["tcond"],
                                              s["keys"][0])
    for r, res in enumerate(s["results"]):
        close(res["losses"][0], np.asarray(ref_loss), f"rank {r} loss vs JAX")
        _check_grads(res["grads"][0], ref_grads)
        for i in range(2):
            close(res["losses"][i], s["one_losses"][i].numpy(), f"rank {r} loss {i}")
            for name, g in s["one_grads"][i].items():
                close(res["grads"][i][name], g.numpy(), f"rank {r} step {i} d{name}")
        whole = {n: torch.nn.Parameter(p.clone()) for n, p in s["init"].items()}
        opt = torch.optim.AdamW(whole.values(), lr=LR, weight_decay=WD)
        for i in range(2):
            for n, p in whole.items():
                p.grad = res["grads"][i][n].clone()
            opt.step()
        for name, p in whole.items():
            got, want = res["params"][name].numpy(), p.detach().numpy()
            err = float((np.abs(got - want) - 2 * np.spacing(np.abs(want))).max()) / LR
            assert err <= ADAM_TOL, f"rank {r} {name}: {err:.3e} learning rates"
        moved = max(float((res["params"][n] - p).abs().max()) for n, p in s["init"].items())
        assert moved > LR


def test_sharded_training_through_split_flash_rows_matches_jax(stage1_results):
    """At data 2, model 2, a UNet whose level-0 attention has one head (it
    stays whole on both model ranks) with the spatial self-attention sent to
    flash attention: its batch*heads rows split over the model ranks
    (``_flash_sharded``) under grad, and the loss and every gradient leaf
    still equal ``jax.value_and_grad`` of the JAX loss.  Each rank's K1
    gradient covers its own rows only, so every leaf upstream of to_q/k/v
    depends on their sum over the ranks."""
    from test_torch_port_training import _check_grads

    s = stage1_results
    ref_loss, ref_grads = _jax_loss_and_grads(s["fjm"], s["fflat"], s["x0"], s["tcond"],
                                              s["keys"][0])
    for r, res in enumerate(s["results"]):
        assert res["flash_sharded_axes"] and set(res["flash_sharded_axes"]) == {("model",)}
        assert any(".attn1" in n for n in res["flash_tp_units"])       # level 1 splits
        close(res["flash_loss"], np.asarray(ref_loss), f"rank {r} loss vs JAX")
        _check_grads(res["flash_grads"], ref_grads)


# ------------------ world 2, (2, 1, 1): stages 2 and 3, and the CLI ------

class _Recording:
    """Wraps an ``EnhanceNoise`` and keeps every draw it hands out."""

    def __init__(self, inner):
        self.inner, self.draws = inner, {}

    def normal(self, stream, index, shape):
        out = self.draws[stream, index] = self.inner.normal(stream, index, shape)
        return out.clone()

    def offset(self, step, chunk, high):
        out = self.draws["offset", step, chunk] = self.inner.offset(step, chunk, high)
        return out


@pytest.fixture(scope="module")
def dp_results(tmp_path_factory):
    from PIL import Image

    from streamingt2v_tpu.config import VFIConfig as JaxVFIConfig
    from streamingt2v_tpu.models import vfi as jvfi
    from streamingt2v_tpu.pipeline.interpolate import InterpolatePipeline as JaxInterpolate
    from streamingt2v_torch.config import VFIConfig
    from streamingt2v_torch.models import vfi as pvfi
    from streamingt2v_torch.pipeline import cli
    from streamingt2v_torch.pipeline.interpolate import InterpolatePipeline

    tmp = tmp_path_factory.mktemp("dp")
    enh = dict(num_steps=3, height=32, width=32, chunk_size=4, overlap_size=2,
               use_randomized_blending=True, vae_bf16=False)
    jpipe, pipe = enhance_pair(enh)
    rng = np.random.RandomState(0)
    video = rng.uniform(-1, 1, (8, 32, 32, 3)).astype(np.float32)
    keys = [rng.uniform(-1, 1, (32, 32, 3)).astype(np.float32) for _ in range(3)]
    enh_ref = np.asarray(jpipe.enhance(jnp.asarray(video), [jnp.asarray(k) for k in keys],
                                       use_randomized_blending=True))
    rec = _Recording(JaxEnhanceDraws(8888))
    enh_single = pipe.enhance(t(video), [t(k) for k in keys], use_randomized_blending=True,
                              noise=rec)
    n, h = 3, 32 // 8
    d_clip = pipe.m.clip_vision.cfg.output_dim
    step_args = (t(rng.randn(1, 8, h, h, 4).astype(np.float32)), 0, 500,
                 pipe.encode_prompts(), t(rng.randn(n, 2, d_clip).astype(np.float32)),
                 t(rng.randn(n, 2, 4, h, h, 4).astype(np.float32)))
    step_kw = dict(chunk_size=4, stride=2, overlap_size=2)

    jmod = jvfi.MultiScaleFlow(JaxVFIConfig.tiny())
    size = (32, 48)
    img = jnp.zeros((1,) + size + (3,))
    vflat = random_flat(jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), img, img))
                        ["params"], 0)
    vvideo = np.random.RandomState(5).rand(5, *size, 3).astype(np.float32)
    vfi_ref = np.asarray(JaxInterpolate(jmod, jax_variables(vflat), tta=False, pair_batch=2)
                         .interpolate_video(jnp.asarray(vvideo), 8))
    interp = InterpolatePipeline(port_module(pvfi.MultiScaleFlow(VFIConfig.tiny()), vflat),
                                 tta=False, pair_batch=2)

    png = str(tmp / "input.png")
    Image.fromarray((np.random.RandomState(0).rand(90, 160, 3) * 255).astype(np.uint8)).save(png)
    argv = ["--input", png, "--tiny", "--num_frames", "8", "--device", "cpu",
            "--container", "y4m", "--seed", "5"]
    cli.main(argv + ["--output", str(tmp / "one")])
    payload = dict(enhance=pipe, enhance_draws=rec.draws,
                   enhance_inputs=(t(video), [t(k) for k in keys]),
                   step_inputs=(step_args, step_kw), interp=interp,
                   vfi_inputs=(t(vvideo), 8), cli_out=str(tmp / "mesh"),
                   cli_argv=argv + ["--output", str(tmp / "mesh"), "--mesh", "2,1,1"])
    results = rd.run_ranks(rd.dp_rank, 2, tmp, payload, timeout=150)
    return dict(results=results, enh_ref=enh_ref, enh_single=enh_single, vfi_ref=vfi_ref,
                tmp=tmp)


def test_enhance_dp_step_matches_the_sequential_step_and_jax(dp_results):
    """Stage 2 at data 2: ``_denoise_step_dp`` (the 2 * n_chunks UNet calls
    as one batch split over the data ranks) equals ``_denoise_step`` on the
    same inputs, and a whole blended enhance under the mesh equals the JAX
    package's (and the port's one-process run)."""
    for r, res in enumerate(dp_results["results"]):
        close(res["step_dp"], res["step_seq"].numpy(), f"rank {r} step")
        assert not torch.equal(res["step_dp"], dp_results["results"][r]["step_seq"] * 0)
        close(res["enhance"], dp_results["enh_ref"], f"rank {r} enhance vs JAX")
        close(res["enhance"], dp_results["enh_single"].numpy(), f"rank {r} enhance")


def test_interpolate_dp_matches_jax(dp_results):
    for r, res in enumerate(dp_results["results"]):
        close(res["vfi"], dp_results["vfi_ref"], f"rank {r} vfi")


def test_cli_mesh_video_equals_the_one_process_run(dp_results):
    """``--mesh 2,1,1`` on two ranks: rank 0 alone writes the file, and its
    video is the run's without ``--mesh`` within one uint8 level (of the
    y4m planes)."""
    tmp = dp_results["tmp"]
    assert dp_results["results"][0]["cli_files"] == ["input.y4m"]
    one = np.frombuffer(open(tmp / "one" / "input.y4m", "rb").read(), np.uint8)
    mesh = np.frombuffer(open(tmp / "mesh" / "input.y4m", "rb").read(), np.uint8)
    assert one.shape == mesh.shape and one.size > 1000
    assert int(np.abs(one.astype(int) - mesh.astype(int)).max()) <= 1
