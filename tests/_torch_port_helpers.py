"""Shared pieces of the PyTorch-port parity tests (tests/test_torch_port_*.py).

Both packages get the same inputs and weights, made with numpy from a seed.
Weight trees take their paths and shapes from the JAX module's own init;
their values are drawn here (lecun-scaled kernels, perturbed norms and
non-zero biases, blend factors and zero-initialised output layers), so
that no branch of either model is silenced by a zero initialiser.
"""

from __future__ import annotations

import numpy as np
import torch

from streamingt2v_tpu.utils.checkpoint import flatten_params, unflatten_params
from streamingt2v_torch.utils.weights import load_jax_params

# xdist runs several workers on one machine
torch.set_num_threads(2)


def random_flat(params, seed: int) -> dict:
    """Numpy f32 values for every leaf of a flax ``params`` tree, keyed by
    its flattened path."""
    rng = np.random.RandomState(seed)
    out = {}
    for path, leaf in sorted(flatten_params(params).items()):
        shape = tuple(leaf.shape)
        name = path.rsplit("/", 1)[-1]
        if name in ("kernel", "proj") and len(shape) >= 2:
            a = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif name.endswith("_scale"):
            a = 1.0 + 0.1 * rng.randn(*shape)
        else:
            a = 0.1 * rng.randn(*shape)
        out[path] = a.astype(np.float32)
    return out


def jax_variables(flat: dict) -> dict:
    import jax.numpy as jnp

    return {"params": unflatten_params({k: jnp.asarray(v) for k, v in flat.items()})}


def port_module(module: torch.nn.Module, flat: dict) -> torch.nn.Module:
    return load_jax_params(module, flat).eval()


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def assert_close(got, ref, rel: float, what: str = "") -> float:
    """max |got - ref| <= rel * max |ref|; returns the relative error."""
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor) else got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    assert np.all(np.isfinite(got)), what
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got - ref).max()) / scale
    assert err <= rel, f"{what}: max abs err {err * scale:.3e} = {err:.3e} of max|ref| > {rel}"
    return err
