"""Spawned gloo ranks for tests/test_torch_port_parallel.py.

``run_ranks(fn, world, tmp_dir, payload)`` starts ``world`` CPU processes
(``spawn``), joins them in one gloo process group over a ``FileStore`` in
``tmp_dir`` (no TCP port: xdist runs several workers on one machine), runs
``fn(rank, world, payload)`` in each with one thread, and returns each
rank's result.  A rank that raises fails the call with its traceback; the
call has its own time limit.  The ranks import only torch and the port:
the JAX references are computed by the test process and compared there.
"""

from __future__ import annotations

import os
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _entry(rank: int, world: int, store: str, fn, payload_path: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                world_size=world)
        payload = torch.load(payload_path, weights_only=False) if payload_path else None
        result = fn(rank, world, payload)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, world: int, tmp_dir, payload=None, timeout: float = 120.0) -> list:
    out_dir = os.path.join(str(tmp_dir), f"ranks-{fn.__name__}-{time.monotonic_ns()}")
    os.makedirs(out_dir)
    payload_path = ""
    if payload is not None:
        payload_path = os.path.join(out_dir, "payload.pt")
        torch.save(payload, payload_path)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(r, world, os.path.join(out_dir, "store"), fn,
                                               payload_path, out_dir))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.terminate()
            p.join(10)
    errors = {r: open(os.path.join(out_dir, f"rank{r}.err")).read()
              for r in range(world) if os.path.exists(os.path.join(out_dir, f"rank{r}.err"))}
    if hung or errors or any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"ranks {hung} still running after {timeout} s; exit codes "
                             f"{[p.exitcode for p in procs]}; "
                             + "\n".join(f"rank {r}:\n{e}" for r, e in errors.items()))
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


# --------------------------------------------------------- rank bodies ---
# Each takes (rank, world, payload) and returns what the test compares.

def _mesh(cfg):
    from streamingt2v_torch.config import MeshConfig
    from streamingt2v_torch.parallel.mesh import create_mesh

    return create_mesh(MeshConfig(*cfg))


class RecordedEnhanceNoise:
    """An ``EnhanceNoise`` that replays recorded draws ({(stream, index):
    tensor, ("offset", step, chunk): int})."""

    def __init__(self, draws: dict):
        self.draws = draws

    def normal(self, stream, index, shape):
        out = self.draws[stream, index]
        assert tuple(out.shape) == tuple(shape), (stream, index, out.shape, shape)
        return out.clone()

    def offset(self, step, chunk, high):
        return self.draws["offset", step, chunk]


def mesh_rank(rank, world, payload):
    """World 8: meshes (4, 1, 2) and (2, 2, 2), the compound-fold shard,
    process_batch_slice / global_batch_from_local, shard_params on
    transformer blocks, and the SpatialVideoTransformer at (2, 2, 2)."""
    import numpy as np

    from streamingt2v_torch.models.layers import init_random_
    from streamingt2v_torch.models.unet_blocks import BasicTransformerBlock
    from streamingt2v_torch.parallel import multihost, sharding

    out = {}
    m412 = _mesh((4, 1, 2))
    out["shape412"], out["coords412"] = m412.shape, m412.coords
    sl = multihost.process_batch_slice(m412, 16)
    out["batch_slice"] = (sl.start, sl.stop)
    data = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    out["global_batch"] = multihost.global_batch_from_local(m412, data[sl], 16)

    m222 = _mesh((2, 2, 2))
    out["coords222"] = m222.coords
    x = torch.arange(16 * 4 * 8, dtype=torch.float32).reshape(16, 4, 8)
    fold = (("batch", "tokens", "heads"), None, None)
    with sharding.active_mesh(m222):
        y = sharding.shard(x, *fold)
        out["fold"], out["fold_back"] = y, sharding.gather(y, *fold)
        out["indivisible"] = tuple(sharding.shard(torch.ones(6, 4, 8), *fold).shape)
        out["tokens"] = sharding.shard(x, "batch", "tokens")
    out["no_mesh"] = sharding.shard(x, *fold) is x

    blocks = {}
    for heads in (2, 3):
        blk = init_random_(BasicTransformerBlock(32 * heads, heads, 32),
                           torch.Generator().manual_seed(heads))
        whole = {n: p.clone() for n, p in blk.named_parameters()}
        sharding.shard_params(blk, m222)
        back = sharding.gather_params(blk, dict(blk.named_parameters()))
        blocks[heads] = dict(
            shapes={n: tuple(p.shape) for n, p in blk.named_parameters()},
            units=sorted(n for n, _ in sharding.tp_units(blk)),
            gathered=all(torch.equal(back[n], whole[n]) for n in whole))
    out["blocks"] = blocks

    svt = payload["svt"]
    sharding.shard_params(svt, m222)
    x, ctx, ioi = payload["svt_inputs"]
    b = x.shape[0]
    with torch.no_grad(), sharding.data_parallel(m222, b) as split:
        o = svt(*(sharding.batch_rows(split, b, v) for v in (x, ctx, ioi)))
        out["svt"] = sharding.gather(o, "batch") if split else o
    out["svt_split"] = split
    return out


def ring_rank(rank, world, payload):
    """World 4, mesh (1, 4, 1): the ring against whole attention, the
    gathered fallback, and the flash rows split over the seq ranks."""
    from streamingt2v_torch.config import KernelRouting
    from streamingt2v_torch.ops.attention import _flash_sharded, _maybe_ring, _seq_split_attention
    from streamingt2v_torch.ops.routing import use_routing
    from streamingt2v_torch.parallel.ring_attention import ring_attention

    mesh = _mesh((1, 4, 1))
    q, k, v = payload["qkv"]
    local = [mesh.local_slice(t, "seq", 1) for t in (q, k, v)]
    blocks = []
    out = {"ring": ring_attention(*local, mesh, blocks=blocks), "blocks": blocks}
    with use_routing(KernelRouting(ring_attention=False)):
        out["maybe_ring_off"] = _maybe_ring(*local, mesh)
        out["gathered"] = _seq_split_attention(*local, mesh)
    out["flash_sharded"] = _flash_sharded(*payload["rows6"], mesh, ("seq",))
    grads = [t.clone().requires_grad_(True) for t in local]
    try:
        ring_attention(*grads, mesh)
    except RuntimeError as e:
        out["grad_refused"] = str(e)
    with use_routing(KernelRouting(ring_attention=False)):
        try:
            _seq_split_attention(*grads, mesh)
        except RuntimeError as e:
            out["gathered_grad_refused"] = str(e)
    return out


def stage1_rank(rank, world, payload):
    """World 4, mesh (2, 1, 2): the streaming denoise step, two training
    steps of the tiny SVD UNet on the global batch, then one backward of a
    UNet whose level-0 head does not split over model, with its spatial
    self-attention sent to flash attention (``payload['flash_min']`` score
    elements and up), so that its rows split over the model ranks
    (``_flash_sharded``) under grad."""
    from streamingt2v_torch.diffusion.denoiser import denoise
    from streamingt2v_torch.diffusion.loss import DiffusionLossConfig
    from streamingt2v_torch.models.wrappers import openai_wrapper, streaming_wrapper
    from streamingt2v_torch.parallel.sharding import gather_params, shard_params, tp_units
    from streamingt2v_torch.parallel.train import init_sharded_state, make_train_step

    mesh = _mesh((2, 1, 2))
    unet, cn = payload["unet"], payload["cn"]
    shard_params(unet, mesh)
    shard_params(cn, mesh)
    x, sigma, cond = payload["denoise_inputs"]
    net = streaming_wrapper(unet, cn, payload["f_cond"], mesh=mesh)
    with torch.no_grad():
        out = {"denoise": denoise(net, x, sigma, cond),
               "tp_units": len(tp_units(unet)) + len(tp_units(cn))}

    lr, wd = payload["lr_wd"]
    tm, opt = init_sharded_state(payload["train_unet"].requires_grad_(True),
                                 lambda ps: torch.optim.AdamW(ps, lr=lr, weight_decay=wd), mesh)
    step = make_train_step(lambda: openai_wrapper(tm), DiffusionLossConfig(), opt, mesh=mesh)
    out["losses"], out["grads"] = [], []
    for draws in payload["draws"]:
        out["losses"].append(step.backward(payload["batch"], **draws))
        out["grads"].append(gather_params(tm, {n: p.grad for n, p in tm.named_parameters()}))
        step.update()
    out["params"] = gather_params(tm, {n: p.detach() for n, p in tm.named_parameters()})

    import importlib

    patt = importlib.import_module("streamingt2v_torch.ops.attention")

    real, axes = patt._flash_sharded, []

    def counted(qf, kf, vf, mesh, ax):
        axes.append(ax)
        return real(qf, kf, vf, mesh, ax)

    patt._use_flash = lambda bh, lq, lk, device: lq * lk >= payload["flash_min"]
    patt._flash_sharded = counted
    fm, fopt = init_sharded_state(payload["flash_unet"].requires_grad_(True),
                                  lambda ps: torch.optim.AdamW(ps, lr=lr), mesh)
    fstep = make_train_step(lambda: openai_wrapper(fm), DiffusionLossConfig(), fopt, mesh=mesh)
    out["flash_loss"] = fstep.backward(payload["batch"], **payload["draws"][0])
    out["flash_grads"] = gather_params(fm, {n: p.grad for n, p in fm.named_parameters()})
    out["flash_sharded_axes"] = axes
    out["flash_tp_units"] = sorted(n for n, _ in tp_units(fm))
    return out


def dp_rank(rank, world, payload):
    """World 2, mesh (2, 1, 1): stage 2's data-parallel step and a whole
    enhance call, stage 3, and the CLI with --mesh 2,1,1."""
    from streamingt2v_torch.pipeline import cli

    mesh = _mesh((2, 1, 1))
    out = {}
    pipe = payload["enhance"]
    pipe.mesh = mesh
    noise = RecordedEnhanceNoise(payload["enhance_draws"])
    video, keys = payload["enhance_inputs"]
    out["enhance"] = pipe.enhance(video, keys, use_randomized_blending=True, noise=noise)
    args, kw = payload["step_inputs"]
    with torch.inference_mode():
        out["step_seq"] = pipe._denoise_step(*args, noise, **kw)
        out["step_dp"] = pipe._denoise_step_dp(*args, noise, **kw)

    interp = payload["interp"]
    interp.mesh = mesh
    out["vfi"] = interp.interpolate_video(*payload["vfi_inputs"])

    cli.main(payload["cli_argv"])
    out["cli_files"] = sorted(os.listdir(payload["cli_out"])) if rank == 0 else None
    return out
