"""Stage 1's training step: ``DiffusionEngine.backward`` then
``apply_updates`` on the SVD-XT VideoUNet, step after step, with grad on
and outside any pipeline's routing (K1, K3 and K4 through their autograd
Functions; K5 and K6 off), as ``chip_smoke.py``'s ``run_train`` builds it:
the UNet without the ControlNet's features or APM, blocks recomputed in the
backward (``use_checkpoint``), in the configuration's dtype, through
``openai_wrapper``; AdamW at the traffic's ``recipe`` lr and weight decay,
the EMA at its decay.  A unit is one step: the loss's forward and backward,
the optimizer's update and the EMA's.

Inputs from the seed: ``distinct_batches`` clips, used in turn, each one
clip of ``chunk_frames`` latents at the configuration's size with its
conditioning as ``Stage1Pipeline.condition`` shapes it (one latent and one
CLIP token of the anchor frame broadcast over the frames, the vector of
fps_id, motion_bucket_id and cond_aug); each step's loss draws (sigma from
the EDM log-normal, the noise) from a generator seeded from the seed and
the step's number, handed to the program as ``diffusion_loss``'s injected
draws.

The check follows the first ``checked_steps`` steps, which set-up drives
through the window's own call on clips that all differ before it hands
the same engine to the window: each step's loss, each parameter's first
gradient as the optimizer holds it after one step (AdamW's first moment
over 1 - beta1), and each parameter's change and its EMA shadow's change
after the last checked step, against the f32 reference trained from the
same weights, clips and draws (``benchmark/reference/svd_train.py``).
Each number is the worst over the steps or the parameters: |L_p - L_r| /
|L_r|, and for the three norms |n_p - n_r| / max(n_r, the median
parameter's n_r).  Parameters whose reference gradient is under a
thousandth of the median parameter's (zero to rounding) are left out of
the two changes.
"""

from __future__ import annotations

import dataclasses
import json

import torch

from benchmark import common
from benchmark.entries.stage1_stream_chunk import latent_shape, port_config, vector
from benchmark.reference import ops as ref_ops
from benchmark.reference import svd_train
from benchmark.weights import make_weights

# a parameter whose reference gradient is under this share of the median
# parameter's is left out of the change
NOUGHT = 1e-3
# the reference's readings by (seed, configuration, traffic, control), so
# that one process reads the program's several runs against one reference
_REFERENCE = {}


def reference_unet(cfg: dict, device="meta") -> svd_train.VideoUNet:
    with torch.device(device):
        return svd_train.VideoUNet(cfg["unet"]).train()


def make_batch(cfg: dict, seed: int, index: int, device) -> dict:
    """Clip ``index``: clean latents and the anchor frame's conditioning."""
    meta = torch.device(device).type == "meta"
    gen = None if meta else common.generator(seed, device, "train_batch", index)
    shape = latent_shape(cfg)
    t = shape[1]
    latents = torch.randn(shape, generator=gen, device=device)
    anchor = torch.randn((1,) + shape[2:4] + (cfg["unet"]["in_channels"] - shape[-1],),
                         generator=gen, device=device)
    token = torch.randn((1, 1, cfg["unet"]["context_dim"]), generator=gen, device=device)

    def frames(v):
        return v[:, None].expand((1, t) + v.shape[1:])

    return {"latents": latents, "cond": {"concat": frames(anchor), "crossattn": frames(token),
                                         "vector": frames(vector(cfg, device))}}


def loss_draws(cfg: dict, recipe: dict, seed: int, step: int, device) -> tuple:
    """Step ``step``'s (sigma (1,), noise): sigma = exp(p_mean + p_std z)."""
    gen = common.generator(seed, device, "train_draws", step)
    z = torch.randn((1,), generator=gen, device=device)
    noise = torch.randn(latent_shape(cfg), generator=gen, device=device)
    return torch.exp(recipe["p_mean"] + recipe["p_std"] * z), noise


def loss_gap(prog, ref) -> float:
    """The worst |L_p - L_r| / |L_r| over the steps."""
    prog, ref = (torch.as_tensor(v, dtype=torch.float64) for v in (prog, ref))
    if not torch.isfinite(prog).all():
        return common.NOT_FINITE
    return float(((prog - ref).abs() / ref.abs().clamp_min(1e-300)).max())


def gap(prog: torch.Tensor, ref: torch.Tensor, keep=None) -> float:
    """The worst |n_p - n_r| / max(n_r, median n_r) over the kept leaves."""
    if not torch.isfinite(prog).all():
        return common.NOT_FINITE
    worst = (prog - ref).abs() / ref.clamp_min(float(ref.median())).clamp_min(1e-300)
    return float(worst[keep].max() if keep is not None else worst.max())


class Cell:
    unit = "step"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        from streamingt2v_torch.diffusion.engine import DiffusionEngine
        from streamingt2v_torch.diffusion.loss import DiffusionLossConfig
        from streamingt2v_torch.models.video_unet import VideoUNet
        from streamingt2v_torch.models.wrappers import openai_wrapper

        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.recipe = traffic["recipe"]
        self.checked = traffic["checked_steps"]
        if traffic["distinct_batches"] < self.checked:
            raise ValueError("the checked steps need a clip each")
        ucfg = dataclasses.replace(port_config(cfg).unet, controlnet_mode=False, use_apm=False,
                                   use_checkpoint=True)
        self.unet = VideoUNet(ucfg, device="meta", dtype=getattr(torch, cfg["dtype"]))
        self.unet.load_state_dict(self.weights(), assign=True)
        self.unet.train()
        self.names = [n for n, _ in self.unet.named_parameters()]
        optimizer = torch.optim.AdamW(self.unet.parameters(), lr=self.recipe["lr"],
                                      weight_decay=self.recipe["weight_decay"])
        self.engine = DiffusionEngine(
            self.unet, openai_wrapper, optimizer=optimizer, ema_decay=self.recipe["ema_decay"],
            loss_cfg=DiffusionLossConfig(p_mean=self.recipe["p_mean"],
                                         p_std=self.recipe["p_std"]))
        self.batches = [make_batch(cfg, seed, i, self.device)
                        for i in range(traffic["distinct_batches"])]
        self.taken = 0          # steps since the engine was built
        self.losses = []        # the checked steps' losses (device scalars)
        self.grad_norms = self.change_norms = self.ema_norms = None
        self.handles = common.span_hooks(self.unet, self.unet)

    def weights(self):
        return make_weights(reference_unet(self.cfg), common.sub_seed(self.seed, "weights", "unet"),
                            self.device, getattr(torch, self.cfg["dtype"]))

    def _step(self) -> torch.Tensor:
        i = self.taken
        sigma, noise = loss_draws(self.cfg, self.recipe, self.seed, i, self.device)
        loss = self.engine.backward(self.batches[i % len(self.batches)], sigmas=sigma,
                                    noise=noise)
        self.engine.apply_updates()
        self.taken += 1
        return loss

    def run(self, window: common.Window) -> None:
        window.start()
        for done in range(1 << 30):
            if window.boundary(done):
                return
            loss = self._step()
            if self.taken <= self.checked:
                self._record(loss)

    def _record(self, loss: torch.Tensor) -> None:
        """After each checked step: its loss; after the first, the
        gradient the optimizer holds; after the last, the parameters' change
        and the EMA shadows'."""
        self.losses.append(loss.detach().float())
        with torch.no_grad():
            if self.taken == 1:
                opt = self.engine.optimizer
                beta1 = opt.param_groups[0]["betas"][0]
                self.grad_norms = torch.stack([
                    torch.linalg.vector_norm(opt.state[p]["exp_avg"], dtype=torch.float32)
                    if p in opt.state else torch.zeros((), device=self.device)
                    for p in self.unet.parameters()]) / (1.0 - beta1)
            if self.taken == self.checked:
                start = self.weights()
                self.change_norms = torch.stack([
                    torch.linalg.vector_norm(p.float() - start[n].float())
                    for n, p in self.unet.named_parameters()])
                shadow = self.engine.ema.shadow
                self.ema_norms = torch.stack([
                    torch.linalg.vector_norm(shadow[n].float() - start[n].float())
                    for n in self.names])
                del start

    def warm_up(self) -> None:
        self.run(common.Unbounded(self.checked, self.device))

    def work(self, units: int) -> dict:
        return {"steps": units}

    def release(self) -> None:
        common.remove(self.handles)
        common.sync(self.device)
        self.engine = self.unet = None

    # ---- the check ----
    def plan_check(self) -> dict:
        if self.change_norms is None:
            raise RuntimeError(f"the run made fewer than {self.checked} steps")
        return {"steps": self.checked,
                "losses": torch.stack(self.losses).double().cpu(),
                "grad_norms": self.grad_norms.double().cpu(),
                "change_norms": self.change_norms.double().cpu(),
                "ema_norms": self.ema_norms.double().cpu()}

    def reference(self, control: bool = False) -> dict:
        """The reference's readings (with ``control``, computed in fp8)."""
        key = (self.seed, json.dumps(self.cfg, sort_keys=True),
               json.dumps(self.traffic, sort_keys=True), control, self.device.type)
        if key not in _REFERENCE:
            unet = reference_unet(self.cfg)
            unet.load_state_dict({k: v.float() for k, v in self.weights().items()}, assign=True)
            batches = [make_batch(self.cfg, self.seed, i % len(self.batches), self.device)
                       for i in range(self.checked)]
            draws = [loss_draws(self.cfg, self.recipe, self.seed, i, self.device)
                     for i in range(self.checked)]
            with common.full_f32(), ref_ops.precision("fp8" if control else "f32"):
                out = svd_train.train(unet, batches, draws, self.recipe,
                                      getattr(torch, self.cfg["dtype"]))
            if out["names"] != self.names:
                raise RuntimeError("the reference's parameters are not the program's")
            _REFERENCE[key] = out
            del unet
        return _REFERENCE[key]

    def compare(self, plan: dict, control: bool = False) -> list:
        """[(name, reading)]: the program's (or, with ``control``, the
        reference's in fp8 in its place) against the f32 reference."""
        ref = self.reference()
        prog = self.reference(control=True) if control else plan
        moved = ref["grad_norms"] >= NOUGHT * ref["grad_norms"].median()
        return [("loss_err", loss_gap(prog["losses"], ref["losses"])),
                ("grad_err", gap(prog["grad_norms"], ref["grad_norms"])),
                ("change_err", gap(prog["change_norms"], ref["change_norms"], moved)),
                ("ema_err", gap(prog["ema_norms"], ref["ema_norms"], moved))]

    # ---- the work, counted on the reference ----
    def meta_unit(self):
        """One forward of the loss on the meta device (its FLOPs and op log);
        ``mfu.train`` counts a step as three of these."""
        unet = reference_unet(self.cfg)
        batch = make_batch(self.cfg, 0, 0, "meta")
        sigma = torch.ones(1, device="meta")
        noise = torch.empty(latent_shape(self.cfg), device="meta")
        return lambda: svd_train.loss(unet, batch, sigma, noise)
