"""Seeding for the port (counterpart of ``streamingt2v_tpu/utils/rng.py``).

JAX's threefry keys cannot be reproduced with PyTorch's Philox, so the
port derives one integer seed per address and draws from a
``torch.Generator`` on the device.  Stage 1 addresses (seed, generation,
stream), as ``generation_key`` does (a stochastic sampler's step ``i`` is
stream "sampler/<i>"): with ``reset_per_generation`` every
autoregressive generation re-seeds from the global seed and its index.
Stage 2 addresses the draws of ``RngStream(seed, "enhance")``: one normal
draw per (stream, index) and one blending offset per (DDIM step, chunk).
"""

from __future__ import annotations

import hashlib
from typing import Callable, Protocol, Tuple

import torch

# noise(generation, stream, shape) -> tensor; streams: "cond_aug"
# (uniform [0, 1)), "latent" (standard normal) and "sampler/<i>" (standard
# normal: the draw of a stochastic sampler's step i)
NoiseFn = Callable[[int, str, Tuple[int, ...]], torch.Tensor]
# step_noise(i, shape) -> the standard normal draw of sampler step i
StepNoiseFn = Callable[[int, Tuple[int, ...]], torch.Tensor]


def _address_seed(*parts) -> int:
    """A 63-bit seed that is a pure function of its address."""
    digest = hashlib.sha256("/".join(str(p) for p in parts).encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def generation_seed(seed: int, generation_idx: int, stream: str,
                    reset_per_generation: bool = True) -> int:
    g = generation_idx if reset_per_generation else 0
    return _address_seed(int(seed), "generation", g, stream)


class GeneratorNoise:
    """The default noise source: each draw from its own seeded generator
    on ``device``, so a draw depends only on its address."""

    _DRAW = {"cond_aug": torch.rand, "latent": torch.randn, "sampler": torch.randn}

    def __init__(self, seed: int, device, reset_per_generation: bool = True):
        self.seed = seed
        self.device = torch.device(device)
        self.reset_per_generation = reset_per_generation

    def __call__(self, generation: int, stream: str, shape: Tuple[int, ...]) -> torch.Tensor:
        gen = torch.Generator(self.device).manual_seed(
            generation_seed(self.seed, generation, stream, self.reset_per_generation))
        return self._DRAW[stream.split("/")[0]](shape, generator=gen, device=self.device,
                                                dtype=torch.float32)


def step_stream(noise: NoiseFn, generation: int) -> StepNoiseFn:
    """A sampler's per-step draws as streams "sampler/<i>" of a ``NoiseFn``:
    their own addresses, so they shift no "cond_aug" or "latent" draw."""
    return lambda i, shape: noise(generation, f"sampler/{i}", shape)


def default_step_noise(device) -> StepNoiseFn:
    """The per-step draws of a sampler called without any: each from a
    generator seeded by its step's address."""
    def draw(i: int, shape) -> torch.Tensor:
        gen = torch.Generator(device).manual_seed(_address_seed(0, "sampler", i))
        return torch.randn(shape, generator=gen, device=device, dtype=torch.float32)

    return draw


class EnhanceNoise(Protocol):
    """The draws of one stage-2 ``enhance`` call.  Streams of ``normal``:
    "key_image" (index = chunk: the key frame's sampled VAE encode),
    "encode" (index = first frame of the VAE chunk: the video's sampled
    encode, drawn at the padded chunk shape) and "latent" (index 0: the
    SDEdit noise); ``offset`` is the randomized-blending write-back offset
    in [0, high) of chunk ``chunk`` at DDIM step ``step``."""

    def normal(self, stream: str, index: int, shape: Tuple[int, ...]) -> torch.Tensor: ...

    def offset(self, step: int, chunk: int, high: int) -> int: ...


class GeneratorEnhanceNoise:
    """The default stage-2 draws: each from its own generator seeded by its
    address, so a draw depends only on (seed, stream, index) or
    (seed, step, chunk)."""

    def __init__(self, seed: int, device):
        self.seed = seed
        self.device = torch.device(device)

    def normal(self, stream: str, index: int, shape: Tuple[int, ...]) -> torch.Tensor:
        gen = torch.Generator(self.device).manual_seed(
            _address_seed(self.seed, "enhance", stream, index))
        return torch.randn(shape, generator=gen, device=self.device, dtype=torch.float32)

    def offset(self, step: int, chunk: int, high: int) -> int:
        gen = torch.Generator().manual_seed(_address_seed(self.seed, "enhance/offset", step,
                                                          chunk))
        return int(torch.randint(0, high, (), generator=gen))
