"""Seeding for the port (counterpart of ``streamingt2v_tpu/utils/rng.py``).

JAX's threefry keys cannot be reproduced with PyTorch's Philox, so the
port derives one integer seed per (seed, generation, stream) address and
draws from a ``torch.Generator`` on the device.  The addressing mirrors
``generation_key``: with ``reset_per_generation`` every autoregressive
generation re-seeds from the global seed and its index.
"""

from __future__ import annotations

import hashlib
from typing import Callable, Tuple

import torch

# noise(generation, stream, shape) -> tensor; streams: "cond_aug"
# (uniform [0, 1)) and "latent" (standard normal)
NoiseFn = Callable[[int, str, Tuple[int, ...]], torch.Tensor]


def generation_seed(seed: int, generation_idx: int, stream: str,
                    reset_per_generation: bool = True) -> int:
    """A 63-bit seed that is a pure function of its address."""
    g = generation_idx if reset_per_generation else 0
    digest = hashlib.sha256(f"{int(seed)}/generation/{g}/{stream}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


class GeneratorNoise:
    """The default noise source: each draw from its own seeded generator
    on ``device``, so a draw depends only on its address."""

    _DRAW = {"cond_aug": torch.rand, "latent": torch.randn}

    def __init__(self, seed: int, device, reset_per_generation: bool = True):
        self.seed = seed
        self.device = torch.device(device)
        self.reset_per_generation = reset_per_generation

    def __call__(self, generation: int, stream: str, shape: Tuple[int, ...]) -> torch.Tensor:
        gen = torch.Generator(self.device).manual_seed(
            generation_seed(self.seed, generation, stream, self.reset_per_generation))
        return self._DRAW[stream](shape, generator=gen, device=self.device,
                                  dtype=torch.float32)
