"""Weight bridge from the JAX package's flax variables to the port's modules.

A port module's state-dict keys are the flax parameter paths with ``/``
replaced by ``.``.  The layout transforms are mechanical:

  Dense kernel          (in, out)            -> (out, in)
  Conv kernel           (kh, kw, in, out)    -> (out, in, kh, kw)
  ConvTranspose kernel  (kh, kw, in, out)    -> (in, out, kh, kw), flipped
                        in kh and kw; told from a Conv kernel by its path
                        (``<name>_deconv/kernel``)
  time conv             (kt, 1, 1, in, out)  -> (kt, in, out)   (the K4 weight)
  1-D Conv kernel       (k, in, out)         -> (out, in, k)    (torch Conv1d; APM's
                        ``apm_conv``, told from the others by its three axes)
  everything else (biases, norms, embeddings, projections, the VQ codebook)
  unchanged.

A flax norm submodule (``nn.GroupNorm``/``nn.LayerNorm``: the
discriminator's ``norm{i}``) holds ``<name>/scale`` and ``<name>/bias``; the
port keeps a norm's affine as ``<name>_scale``/``<name>_bias`` on the
owning module (``models/layers.norm_params``), so those two are renamed.

A depthwise Conv kernel (kh, kw, 1, C) takes the Conv rule: (C, 1, kh, kw)
is torch's grouped layout.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn


def from_jax_params(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """{'a/b/kernel': array} (``utils/checkpoint.py`` ``flatten_params`` of a
    flax ``params`` tree) -> a state dict in the port's names and layouts."""
    norms = {p[:-len("/scale")] for p in flat if p.endswith("/scale")}
    out = {}
    for path, value in flat.items():
        a = np.asarray(value)
        if a.dtype.name == "bfloat16":
            a = a.astype(np.float32)
        if path.rsplit("/", 1)[-1] == "kernel":
            if a.ndim == 2:
                a = a.T
            elif a.ndim == 4 and path.endswith("_deconv/kernel"):
                a = a[::-1, ::-1].transpose(2, 3, 0, 1)
            elif a.ndim == 4:
                a = a.transpose(3, 2, 0, 1)
            elif a.ndim == 3:
                a = a.transpose(2, 1, 0)
            elif a.ndim == 5 and a.shape[1:3] == (1, 1):
                a = a.reshape(a.shape[0], a.shape[3], a.shape[4])
            else:
                raise ValueError(f"{path}: no port layout for a kernel of shape {a.shape}")
        head, _, leaf = path.rpartition("/")
        if head in norms and leaf in ("scale", "bias"):
            path = f"{head}_{leaf}"
        # (ascontiguousarray makes a 0-d array 1-d: APM's scalar apm_alpha)
        out[path.replace("/", ".")] = torch.from_numpy(np.ascontiguousarray(a).reshape(a.shape))
    return out


@torch.no_grad()
def load_jax_params(module: nn.Module, flat: Dict[str, np.ndarray]) -> nn.Module:
    """Fill every parameter of ``module`` from ``flat``, strictly: a key
    missing on either side or a shape mismatch raises; values are cast to
    each parameter's dtype and device."""
    state = from_jax_params(flat)
    own = module.state_dict()
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    if missing or extra:
        raise KeyError(f"parameter names differ: missing {missing[:8]} (of {len(missing)}), "
                       f"unused {extra[:8]} (of {len(extra)})")
    for name, target in own.items():
        if tuple(state[name].shape) != tuple(target.shape):
            raise ValueError(f"{name}: shape {tuple(state[name].shape)} != {tuple(target.shape)}")
        target.copy_(state[name])
    return module
