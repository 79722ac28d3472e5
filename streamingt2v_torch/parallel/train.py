"""The training step (counterpart of ``streamingt2v_tpu/parallel/train.py``).

On one device the step is the loss's backward and the optimizer's update.
Under a mesh (``make_train_step(mesh=)``), every rank is given the whole
global batch and the same generator: the sigmas and the noise are drawn for
the global batch on every rank, so each rank's draws are the one-process
step's, and each rank keeps the rows of its ``data`` index.  The loss runs
under the mesh (the model's tensor-parallel units, split by
``init_sharded_state``, reduce over ``model``), and the gradients are
averaged over ``data``: the step is the one-process step on the global
batch.  The non-finite guard decides on the reduced gradients of every
rank, so all ranks skip a step together.  A mesh with seq > 1 is refused:
the attention over tokens split by seq (the ring, or k/v gathered) has no
backward.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch
import torch.distributed as dist

from streamingt2v_torch.diffusion.denoiser import NetworkFn
from streamingt2v_torch.diffusion.loss import DiffusionLossConfig, diffusion_loss, draw_loss_noise
from streamingt2v_torch.parallel.mesh import AXIS_DATA, AXIS_NAMES, AXIS_SEQ, Mesh
from streamingt2v_torch.parallel.multihost import process_batch_slice
from streamingt2v_torch.parallel.sharding import active_mesh, shard_params, split_over
from streamingt2v_torch.utils.resilience import tree_all_finite


class TrainStep:
    """``step(batch, generator=None, **draws) -> loss``: the loss's backward,
    then the optimizer's update.  The halves are methods of their own
    (``backward``, ``update``) so that a caller can time them apart."""

    def __init__(self, network_builder: Callable[[], NetworkFn], loss_cfg: DiffusionLossConfig,
                 optimizer: torch.optim.Optimizer, skip_nonfinite: bool = False,
                 mesh: Optional[Mesh] = None):
        self.network_builder = network_builder
        self.loss_cfg = loss_cfg
        self.optimizer = optimizer
        self.skip_nonfinite = skip_nonfinite
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None

    def params(self) -> list:
        return [p for group in self.optimizer.param_groups for p in group["params"]]

    def backward(self, batch: Dict[str, Any], generator: Optional[torch.Generator] = None,
                 **draws) -> torch.Tensor:
        """The loss (detached) with every parameter's gradient set.  ``draws``:
        ``sigmas``, ``noise``, ``offset`` for ``diffusion_loss`` (for the
        global batch under a mesh).  A parameter that the loss does not
        reach gets a zero gradient, as ``jax.grad`` gives it, so that the
        optimizer's weight decay reaches it as optax's does (torch's
        optimizers skip a parameter without a gradient)."""
        self.optimizer.zero_grad(set_to_none=True)
        latents, cond = batch["latents"], batch["cond"]
        mesh = self.mesh
        if mesh is None:
            loss = diffusion_loss(self.loss_cfg, self.network_builder(), latents, cond,
                                  generator, **draws)
            loss.backward()
        else:
            b = latents.shape[0]
            sigmas, noise, offset = draw_loss_noise(self.loss_cfg, latents, generator, **draws)
            rows = process_batch_slice(mesh, b)

            def local(x):
                return x[rows] if torch.is_tensor(x) and x.ndim and x.shape[0] == b else x

            # the backward inside the scope too: remat'd blocks recompute there
            with active_mesh(mesh), split_over(AXIS_DATA):
                loss = diffusion_loss(self.loss_cfg, self.network_builder(), local(latents),
                                      {k: local(v) for k, v in cond.items()}, None,
                                      sigmas=local(sigmas), noise=local(noise),
                                      offset=local(offset))
                loss.backward()
        for p in self.params():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if mesh is None:
            return loss.detach()
        d = mesh.shape[AXIS_DATA]
        for p in self.params():
            p.grad = mesh.all_reduce(p.grad, AXIS_DATA).div_(d)
        return mesh.all_reduce(loss.detach().clone(), AXIS_DATA) / d

    def update(self) -> bool:
        """Apply the optimizer.  Under ``skip_nonfinite`` a step whose
        gradients are not all finite (on any rank of the mesh) leaves the
        parameters and the optimizer state (moments, step count) as they
        were and returns False; this waits for the device once per step."""
        if self.skip_nonfinite:
            ok = tree_all_finite([p.grad for p in self.params()]).to(torch.int32)
            if self.mesh is not None:
                ok = self.mesh.all_reduce(ok.reshape(1), AXIS_NAMES, op=dist.ReduceOp.MIN)
            if not bool(ok.all()):
                return False
        self.optimizer.step()
        return True

    def __call__(self, batch: Dict[str, Any], generator: Optional[torch.Generator] = None,
                 **draws) -> torch.Tensor:
        loss = self.backward(batch, generator, **draws)
        self.update()
        return loss


def make_train_step(network_builder: Callable[[], NetworkFn], loss_cfg: DiffusionLossConfig,
                    optimizer: torch.optim.Optimizer, mesh: Optional[Mesh] = None,
                    skip_nonfinite: bool = False) -> TrainStep:
    """``network_builder()`` returns the denoiser-facing network fn (e.g.
    ``openai_wrapper(unet)``) over modules whose parameters ``optimizer``
    updates (split by ``init_sharded_state`` under a ``mesh``).  A batch is
    {'latents': (B, T, H, W, C), 'cond': {...}}, the global one under a
    mesh.  ``skip_nonfinite`` arms the guard of ``TrainStep.update``: a
    step with a NaN or Inf gradient changes nothing, and its loss is
    returned as it is, so that monitoring sees the event."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.mesh.Mesh, got {type(mesh).__name__}")
    if mesh is not None and mesh.shape[AXIS_SEQ] > 1:
        raise ValueError("training with seq > 1 is not supported: attention over tokens "
                         "split by seq has no backward")
    return TrainStep(network_builder, loss_cfg, optimizer, skip_nonfinite, mesh)


def init_sharded_state(module: torch.nn.Module,
                       make_optimizer: Callable[[Any], torch.optim.Optimizer],
                       mesh: Optional[Mesh]) -> tuple:
    """(module, optimizer): the module's tensor-parallel weights split over
    the mesh (``shard_params``), then the optimizer made over the parameters
    this rank holds, so its state matches their placement."""
    shard_params(module, mesh)
    return module, make_optimizer(module.parameters())
