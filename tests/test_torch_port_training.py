"""PyTorch port, the diffusion training path against the JAX package on the
CPU: the loss with the JAX draws injected, the tiny SVD UNet's loss and
every parameter gradient (remat off and on), AdamW steps against
``optax.adamw``, the EMA, the learning-rate schedules, the datasets, the
non-finite guard, resume and the engine's sampler.

Tolerances, relative to max |JAX value| unless stated: the loss with the
same draws 1e-6 (f32, the same arithmetic); the tiny UNet's loss 1e-5 and
each gradient leaf 1e-4 of its own max, or 1e-6 of the network's largest
gradient where that is more (f32 through a UNet, a different summation
order on each side; ``_check_grads``); AdamW's updates against
``optax.adamw``'s on the same gradients 1e-4 learning rates beyond the
parameters' own f32 rounding (the same formula with its divisions in
another order); the EMA and the schedules 1e-6; remat on
against off, resume and the guard bit for bit (the same arithmetic in the
same order on one device)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_port_helpers import assert_close, jax_variables, port_module, random_flat, t
from streamingt2v_tpu import config as jcfg
from streamingt2v_tpu.data import datasets as jdata
from streamingt2v_tpu.diffusion import loss as jloss
from streamingt2v_tpu.diffusion import lr_scheduler as jlr
from streamingt2v_tpu.diffusion.discretization import get_sigmas as jax_get_sigmas
from streamingt2v_tpu.models import video_unet as jvu
from streamingt2v_tpu.models import wrappers as jwrap
from streamingt2v_tpu.parallel import train as jtrain
from streamingt2v_tpu.utils import ema as jema
from streamingt2v_tpu.utils.checkpoint import flatten_params
from streamingt2v_torch import config as pcfg
from streamingt2v_torch.data import datasets as pdata
from streamingt2v_torch.diffusion import loss as ploss
from streamingt2v_torch.diffusion import lr_scheduler as plr
from streamingt2v_torch.diffusion.engine import DiffusionEngine
from streamingt2v_torch.models import video_unet as pvu
from streamingt2v_torch.models import wrappers as pwrap
from streamingt2v_torch.parallel.train import make_train_step
from streamingt2v_torch.utils import ema as pema
from streamingt2v_torch.utils.resilience import (
    NonFiniteError, check_finite, nonfinite_guard, tree_all_finite)
from streamingt2v_torch.utils.state_io import load_pytree, save_pytree
from streamingt2v_torch.utils.weights import from_jax_params

B, T, H, W = 2, 3, 8, 8
LR = 1e-3
WD = 1e-4
GRAD_TOL = 1e-4
GRAD_FLOOR = 1e-6
ADAM_TOL = 1e-4


def _batch_np(seed: int = 0, context_dim: int = 32, adm: int = 24) -> tuple:
    rng = np.random.RandomState(seed)
    x0 = rng.randn(B, T, H, W, 4).astype(np.float32)
    cond = {"concat": rng.randn(B, T, H, W, 4).astype(np.float32),
            "crossattn": rng.randn(B, T, 1, context_dim).astype(np.float32),
            "vector": rng.randn(B, T, adm).astype(np.float32)}
    return x0, cond


def _jax_batch(x0, cond):
    return jnp.asarray(x0), {k: jnp.asarray(v) for k, v in cond.items()}


def _port_batch(x0, cond):
    return t(x0), {k: t(v) for k, v in cond.items()}


def jax_draws(cfg, key, shape) -> dict:
    """The draws ``diffusion_loss`` makes from ``key`` in the JAX package,
    as the port's injectable ``sigmas``, ``noise`` and ``offset``."""
    k_sigma, k_noise, k_offset = jax.random.split(key, 3)
    b = shape[0]
    if cfg.sigma_sampler == "edm":
        sigmas = jloss.edm_sigma_sampler(k_sigma, b, cfg.p_mean, cfg.p_std)
    else:
        sigmas = jloss.discrete_sigma_sampler(k_sigma, b, num_idx=cfg.num_idx)
    noise = jax.random.normal(k_noise, shape, jnp.float32)
    offset = jax.random.normal(k_offset, (b,) + (1,) * (len(shape) - 2) + (shape[-1],),
                               jnp.float32)
    return dict(sigmas=t(sigmas), noise=t(noise), offset=t(offset))


def unet_pair(remat: bool, seed: int = 6, **cfg):
    """(JAX UNet, its flat weights, the port's UNet on them): the tiny
    first-chunk VideoUNet, ``use_checkpoint`` = remat on both sides, and
    ``cfg``'s other fields."""
    jc = dataclasses.replace(jcfg.VideoUNetConfig.tiny(controlnet_mode=False),
                             use_checkpoint=remat, **cfg)
    jm = jvu.VideoUNet(jc)
    flat = random_flat(jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 2, 8, 8, 8)), jnp.zeros((1,)),
        jnp.zeros((1, 2, 1, jc.context_dim)), jnp.zeros((1, 2, jc.adm_in_channels))))["params"],
        seed)
    pc = dataclasses.replace(pcfg.VideoUNetConfig.tiny(controlnet_mode=False),
                             use_checkpoint=remat, **cfg)
    return jm, flat, port_module(pvu.VideoUNet(pc), flat)


# ---------------------------------------------------------------- loss ---

def test_edm_sigma_sampler_is_lognormal():
    sig = ploss.edm_sigma_sampler(20000, torch.Generator().manual_seed(0))
    logs = torch.log(sig).double()
    assert abs(logs.mean().item() + 1.2) < 0.05 and abs(logs.std().item() - 1.2) < 0.05


def test_discrete_sigma_sampler_draws_schedule_values():
    sig = ploss.discrete_sigma_sampler(200, torch.Generator().manual_seed(0), num_idx=50)
    sched = jax_get_sigmas("legacy_ddpm", 50, append_zero=False)
    assert np.isin(np.round(sig.numpy(), 5), np.round(sched, 5)).all()
    assert len(np.unique(sig.numpy())) > 25


@pytest.mark.parametrize("kind", ["unit", "edm", "v", "eps"])
def test_loss_weightings_match_jax(kind):
    s = np.asarray([0.05, 0.5, 2.0, 40.0], np.float32)
    assert_close(ploss.loss_weighting(kind, t(s)), jloss.loss_weighting(kind, jnp.asarray(s)),
                 1e-6, kind)
    with pytest.raises(ValueError):
        ploss.loss_weighting("nope", t(s))


@pytest.mark.parametrize("name", ["edm", "eps", "v", "v_edm_cnoise"])
def test_scalings_match_jax(name):
    """The preconditionings ``DiffusionLossConfig.scaling`` selects."""
    from streamingt2v_tpu.diffusion.scaling import get_scaling as jax_get_scaling
    from streamingt2v_torch.diffusion.scaling import get_scaling

    s = np.asarray([0.002, 0.3, 1.0, 14.6, 700.0], np.float32)
    for got, ref in zip(get_scaling(name)(t(s)), jax_get_scaling(name)(jnp.asarray(s))):
        assert_close(got, np.broadcast_to(np.asarray(ref), s.shape), 1e-6, name)


def _toy_networks():
    """The same small network in both packages: it reads x, c_noise and
    the conditioning, so that the loss depends on all of them."""
    def jnet(x, c_noise, cond):
        return jnp.tanh(x) * 0.5 + c_noise.reshape(-1, 1, 1, 1, 1) + 0.1 * cond["concat"]

    def pnet(x, c_noise, cond):
        return torch.tanh(x) * 0.5 + c_noise.reshape(-1, 1, 1, 1, 1) + 0.1 * cond["concat"]

    return jnet, pnet


@pytest.mark.parametrize("sampler", ["edm", "discrete"])
@pytest.mark.parametrize("loss_type", ["l2", "l1"])
@pytest.mark.parametrize("weighting,offset,scaling", [("v", 0.1, "v_edm_cnoise"),
                                                     ("edm", 0.0, "edm")])
def test_diffusion_loss_matches_jax_with_its_draws(sampler, loss_type, weighting, offset,
                                                   scaling):
    cfg_kw = dict(sigma_sampler=sampler, loss_type=loss_type, weighting=weighting,
                  offset_noise_level=offset, num_idx=100, scaling=scaling)
    x0, cond = _batch_np(1)
    key = jax.random.PRNGKey(3)
    jnet, pnet = _toy_networks()
    ref = jloss.diffusion_loss(jloss.DiffusionLossConfig(**cfg_kw), jnet, *_jax_batch(x0, cond),
                               key)
    cfg = ploss.DiffusionLossConfig(**cfg_kw)
    got = ploss.diffusion_loss(cfg, pnet, *_port_batch(x0, cond),
                               **jax_draws(cfg, key, x0.shape))
    assert got.dtype == torch.float32 and got.ndim == 0
    assert_close(got, ref, 1e-6, "loss")


def test_diffusion_loss_draws_from_its_generator():
    """Without injected draws the loss draws sigmas, noise and offset from
    the generator: the same seed gives the same loss, another seed another."""
    x0, cond = _batch_np(2)
    cfg = ploss.DiffusionLossConfig(offset_noise_level=0.1)
    _, pnet = _toy_networks()

    def loss(seed):
        return ploss.diffusion_loss(cfg, pnet, *_port_batch(x0, cond),
                                    torch.Generator().manual_seed(seed)).item()

    assert loss(5) == loss(5) and loss(5) != loss(6)


def test_perfect_denoiser_gives_zero_loss():
    """A network that inverts the v-preconditioning exactly."""
    x0 = torch.from_numpy(np.random.RandomState(0).randn(4, 2, 4, 4, 3).astype(np.float32))

    def network(xin, c_noise, cond):
        sigma = torch.exp(4.0 * c_noise).reshape(-1, 1, 1, 1, 1)
        x_orig = xin * torch.sqrt(sigma ** 2 + 1.0)
        return (x0 - x_orig / (sigma ** 2 + 1.0)) * (-torch.sqrt(sigma ** 2 + 1.0) / sigma)

    loss = ploss.diffusion_loss(ploss.DiffusionLossConfig(), network, x0, {},
                                torch.Generator().manual_seed(0))
    assert float(loss) < 1e-8


# ----------------------------------------------------- the tiny UNet -----

def _port_grads(module) -> dict:
    return {name: p.grad for name, p in module.named_parameters()}


def _check_grads(got: dict, ref: dict) -> None:
    """Each leaf within GRAD_TOL of its own max |JAX gradient|, or of
    GRAD_FLOOR times the largest gradient of the network where that is more:
    a leaf whose gradient is zero up to rounding (a bias that a one-channel
    GroupNorm removes) holds only f32 noise.  A leaf the port leaves unused
    (a one-token context's keys) has no gradient; JAX's is zero."""
    assert set(got) == set(ref)
    top = max(float(g.abs().max()) for g in ref.values())
    for name in sorted(ref):
        r = ref[name].double()
        if got[name] is None:
            assert not r.any(), name
            continue
        err = float((got[name].double() - r).abs().max())
        bound = max(GRAD_TOL * float(r.abs().max()), GRAD_FLOOR * top)
        assert err <= bound, f"{name}: max abs err {err:.3e} > {bound:.3e}"


@pytest.mark.parametrize("remat", [False, True])
def test_unet_loss_and_every_gradient_match_jax(remat):
    jm, flat, pm = unet_pair(remat)
    x0, cond = _batch_np(3)
    cfg = ploss.DiffusionLossConfig(offset_noise_level=0.05)
    jcfg_loss = jloss.DiffusionLossConfig(offset_noise_level=0.05)
    key = jax.random.PRNGKey(11)
    jx0, jcond = _jax_batch(x0, cond)

    def jax_loss(params):
        return jloss.diffusion_loss(jcfg_loss, jwrap.openai_wrapper(jm, {"params": params}), jx0,
                                    jcond, key)

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(jax_loss))(jax_variables(flat)["params"])
    pm.requires_grad_(True)
    loss = ploss.diffusion_loss(cfg, pwrap.openai_wrapper(pm), *_port_batch(x0, cond),
                                **jax_draws(cfg, key, x0.shape))
    loss.backward()
    assert_close(loss, ref_loss, 1e-5, "loss")
    _check_grads(_port_grads(pm), from_jax_params(flatten_params(ref_grads)))


def test_remat_gives_the_same_gradients():
    """``use_checkpoint`` recomputes the blocks in the backward: the same
    loss and gradients, bit for bit, and no remat without grad."""
    _, flat, plain = unet_pair(False)
    _, _, remat = unet_pair(True)
    x0, cond = _batch_np(4)
    cfg = ploss.DiffusionLossConfig()
    draws = jax_draws(cfg, jax.random.PRNGKey(2), x0.shape)
    grads = []
    for m in (plain, remat):
        m.requires_grad_(True)
        ploss.diffusion_loss(cfg, pwrap.openai_wrapper(m), *_port_batch(x0, cond),
                             **draws).backward()
        grads.append(_port_grads(m))
    for name, g in grads[0].items():
        assert (g is None and grads[1][name] is None) or torch.equal(g, grads[1][name]), name
    with torch.no_grad():
        out = pwrap.openai_wrapper(remat)(*_port_batch(x0, cond)[:1],
                                          torch.zeros(B), _port_batch(x0, cond)[1])
    assert out.grad_fn is None


# ------------------------------------------------------------ training ---

def test_adamw_steps_match_optax():
    """Three ``make_train_step`` steps with AdamW against the JAX package's
    step with ``optax.adamw`` at the same hyper-parameters and draws: the
    losses agree, and each step's update, in units of the learning rate,
    is the one ``optax.adamw`` makes from the port's own gradients (on the
    JAX side's gradients Adam would amplify their f32 differences where
    |g| is small: a bias that a GroupNorm removes has a gradient of f32
    noise, which Adam scales up to about one learning rate)."""
    jm, flat, pm = unet_pair(False, seed=7)
    x0, cond = _batch_np(5)
    cfg = ploss.DiffusionLossConfig()
    opt = optax.adamw(LR, weight_decay=WD)
    jstep = jtrain.make_train_step(lambda p: jwrap.openai_wrapper(jm, {"params": p}),
                                   jloss.DiffusionLossConfig(), opt)
    jparams = jax_variables(flat)["params"]
    jstate = opt.init(jparams)
    jbatch = dict(zip(("latents", "cond"), _jax_batch(x0, cond)))
    pm.requires_grad_(True)
    step = make_train_step(lambda: pwrap.openai_wrapper(pm), cfg,
                           torch.optim.AdamW(pm.parameters(), lr=LR, weight_decay=WD))
    pbatch = dict(zip(("latents", "cond"), _port_batch(x0, cond)))
    # copies: jnp.asarray may alias a numpy view of the torch storage
    mirror = {n: jnp.array(p.detach().numpy()) for n, p in pm.named_parameters()}
    mirror_state = opt.init(mirror)
    first = {n: p.detach().clone() for n, p in pm.named_parameters()}
    for i in range(3):
        key = jax.random.PRNGKey(20 + i)
        jparams, jstate, ref_loss = jstep(jparams, jstate, jbatch, key)
        loss = step(pbatch, **jax_draws(cfg, key, x0.shape))
        assert_close(loss, ref_loss, 1e-5, f"loss {i}")
        grads = {n: jnp.array(p.grad.numpy()) for n, p in pm.named_parameters()}
        updates, mirror_state = opt.update(grads, mirror_state, mirror)
        want_params = optax.apply_updates(mirror, updates)
        for name, p in pm.named_parameters():
            got, want = p.detach().numpy(), np.asarray(want_params[name])
            # beyond the two sides' f32 rounding of the parameter itself
            err = float((np.abs(got - want) - 2 * np.spacing(np.abs(want))).max()) / LR
            assert err <= ADAM_TOL, f"step {i} {name}: update differs by {err:.3e} learning rates"
        # the next step from the port's parameters: one step's rounding at a time
        mirror = {n: jnp.array(p.detach().numpy()) for n, p in pm.named_parameters()}
    moved = max(float((p.detach() - first[n]).abs().max()) for n, p in pm.named_parameters())
    assert moved > LR   # three Adam steps move some weight by more than one learning rate


def test_train_step_refuses_a_mesh():
    """Anything but a ``parallel.mesh.Mesh`` is refused as the mesh (the
    multi-rank step itself: tests/test_torch_port_parallel.py)."""
    _, _, pm = unet_pair(False)
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        make_train_step(lambda: pwrap.openai_wrapper(pm), ploss.DiffusionLossConfig(),
                        torch.optim.AdamW(pm.parameters()), mesh=object())


def test_nonfinite_step_changes_nothing():
    """Under ``skip_nonfinite`` a NaN gradient leaves the parameters and
    AdamW's moments and step count as they were, and the NaN loss is
    returned."""
    _, _, pm = unet_pair(False)
    pm.requires_grad_(True)
    opt = torch.optim.AdamW(pm.parameters(), lr=LR, weight_decay=WD)
    cfg = ploss.DiffusionLossConfig()
    step = make_train_step(lambda: pwrap.openai_wrapper(pm), cfg, opt, skip_nonfinite=True)
    x0, cond = _batch_np(6)
    batch = dict(zip(("latents", "cond"), _port_batch(x0, cond)))
    step(batch, torch.Generator().manual_seed(0))
    params = {k: v.clone() for k, v in pm.state_dict().items()}
    moments = {i: {k: v.clone() for k, v in s.items()} for i, s in enumerate(opt.state.values())}
    noise = torch.randn(x0.shape, generator=torch.Generator().manual_seed(1))
    noise[0, 0, 0, 0, 0] = float("nan")
    loss = step(batch, torch.Generator().manual_seed(2), noise=noise)
    assert torch.isnan(loss)
    for k, v in pm.state_dict().items():
        assert torch.equal(v, params[k]), k
    for i, s in enumerate(opt.state.values()):
        for k, v in s.items():
            assert torch.equal(v, moments[i][k]), (i, k)


def test_resilience_helpers():
    good = {"a": torch.ones(3), "b": [torch.zeros(2), torch.arange(3)]}
    bad = {"a": torch.ones(3), "b": [torch.tensor([1.0, float("inf")])]}
    check_finite(good)
    with pytest.raises(NonFiniteError, match=r"\['b'\]\[0\]"):
        check_finite(bad, "grads")
    assert bool(tree_all_finite(good)) and not bool(tree_all_finite(bad))
    guarded, ok = nonfinite_guard(bad)
    assert not bool(ok) and torch.equal(guarded["b"][0], torch.zeros(2))
    kept, ok = nonfinite_guard(good)
    assert bool(ok) and torch.equal(kept["a"], good["a"])


# ------------------------------------------------- EMA, schedules, data ---

def test_ema_matches_jax_over_steps():
    rng = np.random.RandomState(8)
    shapes = {"a": (4, 5), "b": (7,), "c": ()}
    params = {k: np.asarray(rng.randn(*s), np.float32) for k, s in shapes.items()}
    jstate = jema.ema_init({k: jnp.asarray(v) for k, v in params.items()})
    pstate = pema.ema_init({k: t(v) for k, v in params.items()})
    for _ in range(6):
        params = {k: v + np.asarray(rng.randn(*v.shape), np.float32) for k, v in params.items()}
        jstate = jema.ema_update(jstate, {k: jnp.asarray(v) for k, v in params.items()}, 0.99)
        pema.ema_update(pstate, {k: t(v) for k, v in params.items()}, 0.99)
    assert pstate.num_updates == int(jstate.num_updates) == 6
    for k in shapes:
        assert_close(pema.ema_params(pstate)[k], jema.ema_params(jstate)[k], 1e-6, k)


def test_ema_keeps_the_parameter_dtype():
    p = {"w": torch.randn(8, dtype=torch.bfloat16)}
    state = pema.ema_init(p)
    pema.ema_update(state, {"w": p["w"] + 1})
    assert state.shadow["w"].dtype == torch.bfloat16


@pytest.mark.parametrize("name,args", [
    ("warmup_cosine", (10, 0.1, 1.0, 0.01, 50)),
    ("warmup_cosine_cycles", ([5, 3], [0.1, 0.2], [1.0, 0.8], [0.0, 0.1], [20, 15])),
    ("warmup_linear_cycles", ([5, 3], [0.1, 0.2], [1.0, 0.8], [0.0, 0.1], [20, 15])),
])
def test_lr_schedules_match_jax(name, args):
    jfn, pfn = getattr(jlr, name)(*args), getattr(plr, name)(*args)
    steps = list(range(0, 60)) + [100, 1000]
    got = np.asarray([pfn(n) for n in steps])
    ref = np.asarray([float(jfn(n)) for n in steps])
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


def test_lr_schedule_drives_lambda_lr():
    p = torch.nn.Parameter(torch.zeros(1))
    opt = torch.optim.AdamW([p], lr=2.0)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, plr.warmup_cosine(4, 0.1, 1.0, 0.0, 10))
    lrs = []
    for _ in range(6):
        lrs.append(opt.param_groups[0]["lr"])
        opt.step()
        sched.step()
    assert lrs == pytest.approx([0.0, 0.5, 1.0, 1.5, 2.0, 2.0 * plr.warmup_cosine(
        4, 0.1, 1.0, 0.0, 10)(5)])


def test_datasets_match_jax(tmp_path):
    from PIL import Image

    jd, pd = jdata.SyntheticVideoDataset(5, 4, 16, 3), pdata.SyntheticVideoDataset(5, 4, 16, 3)
    assert len(pd) == len(jd) == 5
    for i in range(5):
        for k in ("video", "sample_id"):
            np.testing.assert_array_equal(pd[i][k], jd[i][k])
    jb = list(jdata.batch_iterator(jd, 2, shuffle=True, seed=4))
    pb = list(pdata.batch_iterator(pd, 2, shuffle=True, seed=4))
    assert len(pb) == len(jb) == 2
    for a, b in zip(pb, jb):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    assert len(list(pdata.batch_iterator(pd, 2, drop_last=False))) == 3
    rng = np.random.RandomState(0)
    for name in ("b.png", "a.png", "skip.txt"):
        if name.endswith(".png"):
            Image.fromarray(rng.randint(0, 255, (6, 9, 3), np.uint8)).save(tmp_path / name)
        else:
            (tmp_path / name).write_text("x")
    jf, pf = jdata.ImageFolderDataset(str(tmp_path)), pdata.ImageFolderDataset(str(tmp_path))
    assert [f.rsplit("/", 1)[-1] for f in pf.files] == ["a.png", "b.png"]
    for i in range(2):
        np.testing.assert_array_equal(pf[i]["image"], jf[i]["image"])
    single = pdata.SingleImageDataset([pf[0]["image"]])
    assert len(single) == 1 and int(single[0]["sample_id"]) == 0


# ------------------------------------------------------ engine, resume ---

def _engine(seed: int = 6) -> DiffusionEngine:
    _, _, pm = unet_pair(False, seed=seed)
    sampler = pcfg.SamplerConfig(num_steps=2, discretization="edm", sigma_max=80.0,
                                 guider=pcfg.GuiderConfig(num_frames=T))
    return DiffusionEngine(pm, sampler_cfg=sampler, ema_decay=0.9)


def _batch_dict(seed: int) -> dict:
    return dict(zip(("latents", "cond"), _port_batch(*_batch_np(seed))))


def test_resume_is_bit_for_bit(tmp_path):
    """Two steps in one go, or one step, a save, a load into a fresh engine
    built from other weights, and the second step: the same parameters,
    AdamW state, EMA and step count, bit for bit."""
    batch = _batch_dict(7)
    straight = _engine()
    for seed in (1, 2):
        straight.train_step(batch, torch.Generator().manual_seed(seed))
    first = _engine()
    first.train_step(batch, torch.Generator().manual_seed(1))
    path = save_pytree(str(tmp_path / "state" / "engine.pt"), first.state_dict())
    resumed = _engine(seed=9)
    resumed.load_state_dict(load_pytree(path, template=first.state_dict()))
    resumed.train_step(batch, torch.Generator().manual_seed(2))
    assert resumed.step == straight.step == 2
    for name, p in straight.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[name], p), name
    for name, s in straight.ema.shadow.items():
        assert torch.equal(resumed.ema.shadow[name], s), name
    want, got = straight.optimizer.state_dict(), resumed.optimizer.state_dict()
    assert want["param_groups"] == got["param_groups"]
    for i, s in want["state"].items():
        for k, v in s.items():
            assert torch.equal(got["state"][i][k], v), (i, k)
    with pytest.raises(ValueError):
        load_pytree(path, template={"params": {}})


def test_engine_sample_uses_the_ema_and_restores_the_live_weights():
    engine = _engine()
    batch = _batch_dict(8)
    for seed in range(2):
        engine.train_step(batch, torch.Generator().manual_seed(seed))
    live = {k: v.clone() for k, v in engine.model.state_dict().items()}
    cond = {k: v[:1] for k, v in batch["cond"].items()}
    shape = (1, T, H, W, 4)
    out = engine.sample(shape, cond, cond, torch.Generator().manual_seed(3))
    assert out.shape == shape and torch.isfinite(out).all()
    for k, v in engine.model.state_dict().items():
        assert torch.equal(v, live[k]), k
    assert not all(torch.equal(engine.ema.shadow[k], live[k]) for k in engine.ema.shadow)
    plain = engine.sample(shape, cond, cond, torch.Generator().manual_seed(3), use_ema=False)
    assert not torch.equal(out, plain)
    with engine.ema_weights():
        ema_model = engine.model
        shadowed = engine.sample(shape, cond, cond, torch.Generator().manual_seed(3),
                                 use_ema=False)
    assert ema_model is engine.model and torch.equal(shadowed, out)
