"""DiffusionEngine: the training-capable top-level model (counterpart of
``streamingt2v_tpu/diffusion/engine.py``, the reference's sgm
DiffusionEngine): a network with its loss, optimizer, EMA and sampler.

The JAX engine threads its state (params, optimizer state, EMA, step)
through pure functions; here the module holds its parameters, the
optimizer its moments, and the engine the EMA and the step count.
``state_dict``/``load_state_dict`` carry all of them for
``utils/state_io.py``, so that a run resumes where it stopped.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Optional

import torch
from torch import nn

from streamingt2v_torch.config import SamplerConfig
from streamingt2v_torch.diffusion.denoiser import NetworkFn, denoise
from streamingt2v_torch.diffusion.loss import DiffusionLossConfig
from streamingt2v_torch.diffusion.samplers import make_sampler
from streamingt2v_torch.models.wrappers import openai_wrapper
from streamingt2v_torch.parallel.train import make_train_step
from streamingt2v_torch.utils.ema import EmaState, ema_init, ema_update


class DiffusionEngine:
    """``model``'s parameters are made trainable.  ``optimizer`` defaults to
    the JAX engine's ``optax.adamw(1e-4)``: AdamW at 1e-4 with optax's
    weight decay of 1e-4 (torch's default is 1e-2).  ``ema_decay`` None
    keeps no EMA."""

    def __init__(self, model: nn.Module,
                 network_builder: Callable[[nn.Module], NetworkFn] = openai_wrapper,
                 loss_cfg: DiffusionLossConfig = DiffusionLossConfig(),
                 sampler_cfg: SamplerConfig = SamplerConfig(),
                 optimizer: Optional[torch.optim.Optimizer] = None,
                 ema_decay: Optional[float] = None, scaling: str = "v_edm_cnoise"):
        self.model = model.requires_grad_(True)
        self.network_builder = network_builder
        self.sampler_cfg = sampler_cfg
        self.optimizer = optimizer or torch.optim.AdamW(model.parameters(), lr=1e-4,
                                                        weight_decay=1e-4)
        self.ema_decay = ema_decay
        self.scaling = scaling
        self.ema: Optional[EmaState] = (
            ema_init(dict(model.named_parameters())) if ema_decay is not None else None)
        self.step = 0
        self._train_step = make_train_step(lambda: network_builder(self.model), loss_cfg,
                                           self.optimizer)

    def backward(self, batch: Dict[str, Any], generator: Optional[torch.Generator] = None,
                 **draws) -> torch.Tensor:
        """The loss of ``batch`` and every parameter's gradient (the first
        half of ``train_step``)."""
        return self._train_step.backward(batch, generator, **draws)

    def apply_updates(self) -> None:
        """The optimizer's update, the EMA's and the step count (the second
        half of ``train_step``)."""
        self._train_step.update()
        if self.ema is not None:
            ema_update(self.ema, dict(self.model.named_parameters()), self.ema_decay)
        self.step += 1

    def train_step(self, batch: Dict[str, Any], generator: Optional[torch.Generator] = None,
                   **draws) -> torch.Tensor:
        """One step on ``batch`` = {'latents', 'cond'}; returns the loss."""
        loss = self.backward(batch, generator, **draws)
        self.apply_updates()
        return loss

    @contextlib.contextmanager
    def ema_weights(self, use_ema: bool = True):
        """The model carries the EMA weights inside the block (when there is
        an EMA and ``use_ema``) and its live ones again after it: the two
        swap storage, nothing is copied."""
        swap = use_ema and self.ema is not None
        if swap:
            self._swap_ema()
        try:
            yield self.model
        finally:
            if swap:
                self._swap_ema()

    @torch.no_grad()
    def _swap_ema(self) -> None:
        shadow = self.ema.shadow
        for name, p in self.model.named_parameters():
            p.data, shadow[name] = shadow[name], p.data

    def sample(self, shape, cond, uc, generator: Optional[torch.Generator] = None, *,
               noise: Optional[torch.Tensor] = None, step_noise=None,
               use_ema: bool = True) -> torch.Tensor:
        """Latents of ``shape`` from the configured sampler and guider,
        with the EMA weights unless ``use_ema`` is false.  ``noise`` (the
        initial draw) and ``step_noise`` (a stochastic sampler's per-step
        draws) come from ``generator`` unless given."""
        device = next(self.model.parameters()).device
        if noise is None:
            noise = torch.randn(shape, generator=generator, device=device)
        if step_noise is None and generator is not None:
            def step_noise(i, shp):
                return torch.randn(shp, generator=generator, device=device)
        sampler = make_sampler(self.sampler_cfg)
        with self.ema_weights(use_ema), torch.inference_mode():
            net = self.network_builder(self.model)
            return sampler(lambda x, sigma, c: denoise(net, x, sigma, c, scaling=self.scaling),
                           noise, cond, uc, step_noise)

    def state_dict(self) -> Dict[str, Any]:
        """Parameters, optimizer state, EMA and step: what a resume needs."""
        return {
            "params": {k: v.detach() for k, v in self.model.state_dict().items()},
            "optimizer": self.optimizer.state_dict(),
            "ema": None if self.ema is None else {"shadow": self.ema.shadow,
                                                  "num_updates": self.ema.num_updates},
            "step": self.step,
        }

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.model.load_state_dict(state["params"])
        self.optimizer.load_state_dict(state["optimizer"])
        if (state["ema"] is None) != (self.ema is None):
            raise ValueError("the saved state and this engine differ in keeping an EMA")
        if self.ema is not None:
            for name, s in self.ema.shadow.items():
                s.copy_(state["ema"]["shadow"][name])
            self.ema.num_updates = state["ema"]["num_updates"]
        self.step = state["step"]
