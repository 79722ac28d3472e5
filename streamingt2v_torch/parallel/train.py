"""The training step (counterpart of ``streamingt2v_tpu/parallel/train.py``),
on one device: the JAX package's step is a pjit'd function over a mesh, and
the port's multi-device path is not written yet (ROADMAP A12), so a mesh
raises, as the CLI's ``--mesh`` does."""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from streamingt2v_torch.diffusion.denoiser import NetworkFn
from streamingt2v_torch.diffusion.loss import DiffusionLossConfig, diffusion_loss
from streamingt2v_torch.utils.resilience import tree_all_finite


class TrainStep:
    """``step(batch, generator=None, **draws) -> loss``: the loss's backward,
    then the optimizer's update.  The halves are methods of their own
    (``backward``, ``update``) so that a caller can time them apart."""

    def __init__(self, network_builder: Callable[[], NetworkFn], loss_cfg: DiffusionLossConfig,
                 optimizer: torch.optim.Optimizer, skip_nonfinite: bool = False):
        self.network_builder = network_builder
        self.loss_cfg = loss_cfg
        self.optimizer = optimizer
        self.skip_nonfinite = skip_nonfinite

    def params(self) -> list:
        return [p for group in self.optimizer.param_groups for p in group["params"]]

    def backward(self, batch: Dict[str, Any], generator: Optional[torch.Generator] = None,
                 **draws) -> torch.Tensor:
        """The loss (detached) with every parameter's gradient set.  ``draws``:
        ``sigmas``, ``noise``, ``offset`` for ``diffusion_loss``.  A parameter
        that the loss does not reach gets a zero gradient, as ``jax.grad``
        gives it, so that the optimizer's weight decay reaches it as optax's
        does (torch's optimizers skip a parameter without a gradient)."""
        self.optimizer.zero_grad(set_to_none=True)
        loss = diffusion_loss(self.loss_cfg, self.network_builder(), batch["latents"],
                              batch["cond"], generator, **draws)
        loss.backward()
        for p in self.params():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        return loss.detach()

    def update(self) -> bool:
        """Apply the optimizer.  Under ``skip_nonfinite`` a step whose
        gradients are not all finite leaves the parameters and the optimizer
        state (moments, step count) as they were and returns False; this
        waits for the device once per step."""
        if self.skip_nonfinite:
            if not bool(tree_all_finite([p.grad for p in self.params()])):
                return False
        self.optimizer.step()
        return True

    def __call__(self, batch: Dict[str, Any], generator: Optional[torch.Generator] = None,
                 **draws) -> torch.Tensor:
        loss = self.backward(batch, generator, **draws)
        self.update()
        return loss


def make_train_step(network_builder: Callable[[], NetworkFn], loss_cfg: DiffusionLossConfig,
                    optimizer: torch.optim.Optimizer, mesh: Optional[Any] = None,
                    skip_nonfinite: bool = False) -> TrainStep:
    """``network_builder()`` returns the denoiser-facing network fn (e.g.
    ``openai_wrapper(unet)``) over modules whose parameters ``optimizer``
    updates.  A batch is {'latents': (B, T, H, W, C), 'cond': {...}}.
    ``skip_nonfinite`` arms the guard of ``TrainStep.update``: a step with a
    NaN or Inf gradient changes nothing, and its loss is returned as it
    is, so that monitoring sees the event."""
    if mesh is not None:
        raise NotImplementedError("multi-device training is not ported: run on one device")
    return TrainStep(network_builder, loss_cfg, optimizer, skip_nonfinite)
