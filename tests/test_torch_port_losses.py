"""Parity of the port's training losses with the JAX package's (CPU, f32):
LPIPS, the PatchGAN discriminator and the adversarial losses, the KL and
vector-quantizer regularizers, and the EMA-VFI Laplacian and census
losses.  Both sides get the same weights (``random_flat``) and inputs from
a numpy seed; each forward and each gradient (``jax.grad`` against torch's
autograd) agrees within 1e-5 of its largest value.  The JAX losses run
NHWC, the port's image losses NCHW: inputs and gradients are transposed
between the two."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import assert_close, jax_variables, port_module, random_flat, t
from streamingt2v_tpu.diffusion import gan_loss as jgan
from streamingt2v_tpu.diffusion import lpips as jlpips
from streamingt2v_tpu.diffusion import regularizers as jreg
from streamingt2v_tpu.models import vfi_loss as jvfi
from streamingt2v_tpu.utils import checkpoint as jck
from streamingt2v_torch.diffusion import gan_loss as pgan
from streamingt2v_torch.diffusion import lpips as plpips
from streamingt2v_torch.diffusion import regularizers as preg
from streamingt2v_torch.models import vfi_loss as pvfi
from streamingt2v_torch.utils import checkpoint as ck
from streamingt2v_torch.utils.weights import from_jax_params

TOL = 1e-5


def nchw(a: np.ndarray) -> torch.Tensor:
    return t(np.transpose(a, (0, 3, 1, 2))).requires_grad_(True)


def nhwc(x: torch.Tensor) -> np.ndarray:
    return x.detach().permute(0, 2, 3, 1).numpy()


def _module_pair(jmodule, pmodule, seed, *inputs):
    flat = random_flat(jax.eval_shape(lambda: jmodule.init(
        jax.random.PRNGKey(0), *[jnp.asarray(a) for a in inputs]))["params"], seed)
    return jax_variables(flat), port_module(pmodule, flat).requires_grad_(True), flat


def _check_param_grads(pmodule, jgrads, what):
    """Each parameter's gradient within TOL of its own largest value, or of
    the network's largest gradient where that is more (the rule of
    ``test_torch_port_training._check_grads``): LPIPS's deepest head sees
    features after 13 f32 convolutions, whose rounding alone is 2e-5 of
    that head's 1e-5-sized gradient."""
    want = from_jax_params(jck.flatten_params(jgrads))
    got = {n: p.grad for n, p in pmodule.named_parameters()}
    assert set(got) == set(want), what
    top = max(float(g.abs().max()) for g in want.values())
    for name in sorted(want):
        err = float((got[name].double() - want[name].double()).abs().max())
        bound = TOL * max(float(want[name].abs().max()), top)
        assert err <= bound, f"{what} d{name}: max abs err {err:.3e} > {bound:.3e}"


def test_lpips_matches_jax_forward_and_gradient():
    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    y = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    jm = jlpips.LPIPS()
    jvars, pm, _ = _module_pair(jm, plpips.LPIPS(), 1, x, y)
    ref, (gx, gp) = jax.value_and_grad(
        lambda a, v: jm.apply(v, a, jnp.asarray(y)).sum(), argnums=(0, 1))(jnp.asarray(x), jvars)
    xp = nchw(x)
    out = pm(xp, nchw(y))
    assert out.shape == (2,)
    assert_close(out.sum(), ref, TOL, "lpips")
    out.sum().backward()
    assert_close(nhwc(xp.grad), gx, TOL, "lpips dx")
    _check_param_grads(pm, gp["params"], "lpips")


def test_lpips_map_matches_jax_on_a_reference_state_dict():
    """A reference-named (torchvision + LPIPS heads) state dict through
    both maps: the JAX converter's params in the port's layouts equal the
    port's conversion, and both are the values written."""
    jm = jlpips.LPIPS()
    tmpl = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                                          jnp.zeros((1, 32, 32, 3))))["params"]
    flat = random_flat(tmpl, seed=3)
    module = port_module(plpips.LPIPS(), flat)
    pmap = ck.lpips_map()
    assert sorted(pmap) == sorted(module.state_dict())
    sd = {tk: module.state_dict()[name].clone() for name, (tk, _) in pmap.items()}
    jvars, missing = jck.convert_state_dict({k: v.numpy().copy() for k, v in sd.items()},
                                            jlpips.lpips_map(), {"params": tmpl})
    assert not missing
    fresh = plpips.LPIPS()
    assert ck.convert_state_dict(sd, pmap, fresh) == []
    want = from_jax_params(jck.flatten_params(jvars["params"]))
    for name, value in fresh.state_dict().items():
        assert torch.equal(value, want[name]), name
        assert torch.equal(value, module.state_dict()[name]), name


def test_patch_discriminator_matches_jax_forward_and_gradient():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 32, 32, 3).astype(np.float32)
    jm = jgan.PatchDiscriminator(ndf=8, n_layers=3)
    jvars, pm, flat = _module_pair(jm, pgan.PatchDiscriminator(3, ndf=8, n_layers=3), 2, x)
    assert any(k.endswith("norm1/scale") for k in flat)   # the renamed norm affine
    w = rng.randn(*jax.eval_shape(lambda: jm.apply(jvars, jnp.asarray(x))).shape)
    ref, (gx, gp) = jax.value_and_grad(
        lambda a, v: (jm.apply(v, a) * w).sum(), argnums=(0, 1))(jnp.asarray(x), jvars)
    xp = nchw(x)
    logits = pm(xp)
    assert_close(logits.permute(0, 2, 3, 1), jm.apply(jvars, jnp.asarray(x)), TOL, "logits")
    (logits * nchw(w.astype(np.float32)).detach()).sum().backward()
    assert_close(nhwc(xp.grad), gx, TOL, "disc dx")
    _check_param_grads(pm, gp["params"], "disc")


@pytest.mark.parametrize("name", ["hinge_d_loss", "vanilla_d_loss"])
def test_discriminator_losses_match_jax(name):
    rng = np.random.RandomState(2)
    real, fake = rng.randn(2, 1, 6, 6).astype(np.float32), rng.randn(2, 1, 6, 6).astype(np.float32)
    ref, grads = jax.value_and_grad(getattr(jgan, name), argnums=(0, 1))(jnp.asarray(real),
                                                                         jnp.asarray(fake))
    r, f = t(real).requires_grad_(True), t(fake).requires_grad_(True)
    out = getattr(pgan, name)(r, f)
    out.backward()
    assert_close(out, ref, TOL, name)
    assert_close(r.grad, grads[0], TOL, name + " d_real")
    assert_close(f.grad, grads[1], TOL, name + " d_fake")


def test_generator_loss_and_adaptive_weight_match_jax():
    rng = np.random.RandomState(3)
    fake = rng.randn(2, 1, 6, 6).astype(np.float32)
    ref, gref = jax.value_and_grad(jgan.generator_loss)(jnp.asarray(fake))
    f = t(fake).requires_grad_(True)
    out = pgan.generator_loss(f)
    out.backward()
    assert_close(out, ref, TOL, "g loss")
    assert_close(f.grad, gref, TOL, "g loss grad")
    for nll, g in [(3.0, 0.5), (1e-9, 1e-9), (1e9, 1e-6)]:   # inside, and both clip edges
        want = jgan.adaptive_weight(jnp.float32(nll), jnp.float32(g))
        assert_close(pgan.adaptive_weight(torch.tensor(nll), torch.tensor(g)), want, TOL,
                     f"adaptive weight {nll}/{g}")


def test_diagonal_gaussian_matches_jax_with_its_draw():
    rng = np.random.RandomState(4)
    moments = (rng.randn(2, 4, 4, 8) * np.r_[np.ones(4), 12 * np.ones(4)]).astype(np.float32)
    key = jax.random.PRNGKey(5)
    draw = jax.random.normal(key, (2, 4, 4, 4), jnp.float32)
    w = rng.randn(2, 4, 4, 4).astype(np.float32)

    def jloss(m, k):
        z, aux = jreg.diagonal_gaussian(m, k)
        return (z * w).sum() + aux["kl_loss"], (z, aux["kl_loss"])

    for k in (key, None):       # the sample, then the mode
        (ref, (zr, klr)), gref = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(moments), k)
        m = t(moments).requires_grad_(True)
        z, aux = preg.diagonal_gaussian(m, noise=None if k is None else t(draw))
        loss = (z * t(w)).sum() + aux["kl_loss"]
        loss.backward()
        assert_close(z, zr, TOL, "z")
        assert_close(aux["kl_loss"], klr, TOL, "kl")
        assert_close(m.grad, gref, TOL, "d moments")
    # a generator draws the sample itself
    z1, _ = preg.diagonal_gaussian(t(moments), torch.Generator().manual_seed(0))
    z2, _ = preg.diagonal_gaussian(t(moments), torch.Generator().manual_seed(0))
    assert torch.equal(z1, z2) and not torch.equal(z1, preg.diagonal_gaussian(t(moments))[0])


def test_vector_quantizer_matches_jax_with_straight_through_gradients():
    rng = np.random.RandomState(6)
    z = rng.randn(2, 5, 5, 8).astype(np.float32) * 0.3
    jm = jreg.VectorQuantizer(codebook_size=16, dim=8)
    jvars, pm, _ = _module_pair(jm, preg.VectorQuantizer(16, 8), 7, z)
    w = rng.randn(*z.shape).astype(np.float32)

    def jloss(a, v):
        zq, aux = jm.apply(v, a)
        return (zq * w).sum() + 3.0 * aux["vq_loss"], (zq, aux)

    (ref, (zq_ref, aux_ref)), (gz, gp) = jax.value_and_grad(jloss, argnums=(0, 1),
                                                             has_aux=True)(jnp.asarray(z), jvars)
    zp = t(z).requires_grad_(True)
    zq, aux = pm(zp)
    loss = (zq * t(w)).sum() + 3.0 * aux["vq_loss"]
    loss.backward()
    assert np.array_equal(aux["indices"].numpy(), np.asarray(aux_ref["indices"]))
    assert_close(zq, zq_ref, TOL, "zq")
    assert_close(aux["vq_loss"], aux_ref["vq_loss"], TOL, "vq loss")
    assert_close(loss, ref, TOL, "loss")
    # straight through: dz = w + beta * d commit, the codebook's only from embed
    assert_close(zp.grad, gz, TOL, "dz")
    _check_param_grads(pm, gp["params"], "vq")
    assert not torch.equal(zp.grad, t(w))


@pytest.mark.parametrize("hw", [(64, 96), (40, 56)])
def test_vfi_losses_match_jax(hw):
    """At 64x96 every level of the 5-level pyramid halves exactly; at
    40x56 the fourth does not, and both packages refuse the Laplacian loss
    (the JAX one on the shape mismatch) while the census loss runs."""
    rng = np.random.RandomState(8)
    a = rng.rand(2, *hw, 3).astype(np.float32)
    b = np.clip(a + 0.1 * rng.randn(*a.shape), 0, 1).astype(np.float32)
    w = rng.randn(2, *hw, 1).astype(np.float32)

    def jtern(x, y):
        return (jvfi.ternary_loss(x, y) * w).sum()

    ref, gref = jax.value_and_grad(jtern)(jnp.asarray(a), jnp.asarray(b))
    x = nchw(a)
    out = pvfi.ternary_loss(x, nchw(b))
    assert out.shape == (2, 1) + hw
    edge = out.detach()
    assert float(edge[..., 0, :].abs().max()) == 0.0 and float(edge[..., -1].abs().max()) == 0.0
    (out * nchw(w).detach()).sum().backward()
    assert_close(out.permute(0, 2, 3, 1), jvfi.ternary_loss(jnp.asarray(a), jnp.asarray(b)), TOL,
                 "ternary")
    assert_close(nhwc(x.grad), gref, TOL, "ternary dx")

    if hw[0] % 32 or hw[1] % 32:
        with pytest.raises(TypeError):
            jvfi.lap_loss(jnp.asarray(a), jnp.asarray(b))
        with pytest.raises(ValueError, match="does not divide"):
            pvfi.lap_loss(nchw(a), nchw(b))
        return
    ref, gref = jax.value_and_grad(jvfi.lap_loss)(jnp.asarray(a), jnp.asarray(b))
    x = nchw(a)
    out = pvfi.lap_loss(x, nchw(b))
    out.backward()
    assert_close(out, ref, TOL, "lap")
    assert_close(nhwc(x.grad), gref, TOL, "lap dx")
    levels = pvfi.laplacian_pyramid(nchw(a).detach())
    assert [tuple(lv.shape[2:]) for lv in levels] == [(hw[0] >> i, hw[1] >> i) for i in range(5)]


def test_reflect_pad_folds_like_numpy_on_small_levels():
    """A 2-pixel reflect pad of a level narrower than 3 (a 32-pixel image's
    last pyramid level) folds again, as ``jnp.pad(mode="reflect")`` does."""
    for n in (1, 2, 3, 7):
        got = pvfi._reflect_index(n, 2, "cpu").numpy()
        assert np.array_equal(got, np.pad(np.arange(n), 2, mode="reflect")), n
    a = np.random.RandomState(9).rand(1, 32, 32, 3).astype(np.float32)
    assert_close(pvfi.lap_loss(nchw(a), nchw(a[:, ::-1].copy())),
                 jvfi.lap_loss(jnp.asarray(a), jnp.asarray(a[:, ::-1])), TOL, "lap 32")
