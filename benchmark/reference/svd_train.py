"""Plain reference of stage 1's training step: the SVD-XT VideoUNet without
the CAM mergers (the UNet that the first chunk runs and that fine-tuning
trains), its loss and AdamW, in float32 through ``benchmark.reference.ops``.

- UNet: ``svd.VideoUNet``'s blocks and equations, run as the plain SVD
  UNet: the input blocks, the middle and the output blocks with their
  skips, no ControlNet features.
- Loss (sgm's StandardDiffusionLoss as SVD trains): x_n = x_0 + sigma n,
  D = c_out F(c_in x_n, c_noise) + c_skip x_n with SVD's v-prediction
  scalings and c_noise = log(sigma) / 4, the loss mean((sigma^2 + 1) /
  sigma^2 (D - x_0)^2) over every latent of the clip.
- AdamW (Loshchilov and Hutter; torch's and optax's update): moments in
  f32, bias-corrected, weight decay lr wd p before the step.  The
  parameters are held in the dtype the configuration serves them in: each
  step's f32 result is rounded to it, so that in bfloat16 an update under
  half a bf16 step of its parameter leaves it where it is, on this side as
  in the program.
- EMA (sgm's LitEma): after each step n = 1, 2, ... every shadow moves
  shadow <- shadow - (1 - d)(shadow - p) with the warm-up decay
  d = min(decay, (1 + n) / (10 + n)), held and computed in the dtype the
  parameters are served in, (1 - d) rounded to it.
- Memory: autograd at the full width would keep every activation of the
  clip.  Every ResBlock, transformer block and temporal transformer block is
  recomputed in the backward (``torch.utils.checkpoint``), and attention
  keeps no scores: each block of query rows is recomputed too.
- ``ops.precision("fp8")`` under autograd: the forward's product operands
  are rounded to fp8 as ``ops.operand`` rounds them, the gradient passed
  straight through, so the backward's products take the rounded operands
  in f32.

The two operations that change under autograd (``ops.attention`` and
``ops.operand``) are swapped for the forms above only inside
``autograd_ops()``; everything else is ``ops`` and ``svd`` as they are.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from benchmark.reference import ops, sampling, svd

CHECKPOINTED = (svd.ResBlock, svd.TransformerBlock, svd.TemporalTransformerBlock)


def _recomputed(module: torch.nn.Module) -> None:
    forward = module.forward

    def run(*args):
        if torch.is_grad_enabled():
            return checkpoint(forward, *args, use_reentrant=False, preserve_rng_state=False)
        return forward(*args)

    module.forward = run


class VideoUNet(svd.VideoUNet):
    """The SVD-XT VideoUNet of ``svd`` without its CAM mergers."""

    def __init__(self, cfg: dict):
        super().__init__(cfg)
        for name in [n for n, _ in self.named_children() if n.startswith("cam_merger_")]:
            delattr(self, name)
        for m in self.modules():
            if isinstance(m, CHECKPOINTED):
                _recomputed(m)

    def forward(self, x, t_cont, context, y):
        cfg = self.cfg
        emb = svd._embed(self, cfg, t_cont, y, x.shape[1])
        hs, h = svd._run_encoder(self, cfg, self.in_conv(x), emb, context)
        blk = 0
        ds = 2 ** (len(cfg["channel_mult"]) - 1)
        for level in reversed(range(len(cfg["channel_mult"]))):
            for i in range(cfg["num_res_blocks"] + 1):
                h = getattr(self, f"output_{blk}_res")(torch.cat([h, hs.pop()], dim=-1), emb)
                if ds in cfg["attention_resolutions"]:
                    h = getattr(self, f"output_{blk}_attn")(h, context)
                if level and i == cfg["num_res_blocks"]:
                    ds //= 2
                    h = getattr(self, f"output_{blk}_up")(h)
                blk += 1
        h = ops.per_frame(h, lambda z: ops.group_norm(z, *svd.norm_of(self, "out_norm"),
                                                      eps=1e-5, silu=True))
        return ops.per_frame(h, self.out_conv)


_PLAIN_OPERAND = ops.operand


def _operand(x: torch.Tensor) -> torch.Tensor:
    if ops._PRECISION.get() == "f32" or x.device.type == "meta":
        return x.float()
    x = x.float()
    with torch.no_grad():
        q = _PLAIN_OPERAND(x)
    return x + (q - x).detach()


def _attend(q, k, v, scale: float):
    return ops.matmul(torch.softmax(ops.matmul(q, k.transpose(1, 2)) * scale, dim=-1), v)


def _attention(q, k, v):
    """``ops.attention`` with each block of query rows recomputed in the
    backward."""
    n, lq, d = q.shape
    rows = max(1, ops.ATTN_BLOCK_BYTES // (4 * n * k.shape[1]))
    scale = 1.0 / math.sqrt(d)
    outs = []
    for s in range(0, lq, rows):
        if torch.is_grad_enabled():
            outs.append(checkpoint(_attend, q[:, s:s + rows], k, v, scale, use_reentrant=False,
                                   preserve_rng_state=False))
        else:
            outs.append(_attend(q[:, s:s + rows], k, v, scale))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


@contextlib.contextmanager
def autograd_ops():
    saved = ops.attention, ops.operand
    ops.attention, ops.operand = _attention, _operand
    try:
        yield
    finally:
        ops.attention, ops.operand = saved


def loss(unet: VideoUNet, batch: dict, sigma: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """The v-weighted denoising loss of one batch at the drawn sigma (B,)
    and noise (the latents' shape)."""
    x0 = batch["latents"].float()
    bc = (-1,) + (1,) * (x0.ndim - 1)
    c_skip, c_out, c_in, c_noise = (v.reshape(bc) for v in sampling.v_scalings(sigma))
    s = sigma.float().reshape(bc)
    xn = x0 + noise.float() * s
    cond = batch["cond"]
    out = unet(torch.cat([xn * c_in, cond["concat"].float()], dim=-1), c_noise.reshape(-1),
               cond["crossattn"].float(), cond["vector"].float())
    den = out * c_out + xn * c_skip
    w = (s ** 2 + 1.0) / s ** 2
    return (w * (den - x0) ** 2).mean()


class AdamW:
    """AdamW over f32 tensors that hold values of ``dtype``: moments in f32,
    each updated parameter rounded to ``dtype``."""

    def __init__(self, params: Sequence[torch.Tensor], lr: float, weight_decay: float,
                 dtype: torch.dtype, betas=(0.9, 0.999), eps: float = 1e-8):
        self.params = list(params)
        self.dtype = dtype
        self.lr, self.wd, self.betas, self.eps = lr, weight_decay, betas, eps
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.t = 0

    @torch.no_grad()
    def step(self) -> None:
        self.t += 1
        b1, b2 = self.betas
        c1, c2 = 1.0 - b1 ** self.t, 1.0 - b2 ** self.t
        for p, m, v in zip(self.params, self.m, self.v):
            g = p.grad
            m.mul_(b1).add_(g, alpha=1.0 - b1)
            v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
            new = p * (1.0 - self.lr * self.wd) - (self.lr / c1) * m / (
                (v / c2).sqrt() + self.eps)
            p.copy_(new.to(self.dtype).float())


@torch.no_grad()
def ema_step(shadow: Sequence[torch.Tensor], params: Sequence[torch.Tensor], decay: float,
             n: int) -> None:
    """The EMA's update after step ``n`` (from 1), in the shadows' dtype."""
    d = min(decay, (1.0 + n) / (10.0 + n))
    one_minus = torch.tensor(1.0 - d, dtype=torch.float32).to(shadow[0].dtype)
    for s, p in zip(shadow, params):
        s.sub_(one_minus.to(s.device) * (s - p.to(s.dtype)))


def train(unet: VideoUNet, batches: List[dict], draws: List[tuple], recipe: dict,
          dtype: torch.dtype) -> Dict:
    """``len(draws)`` steps from ``unet``'s parameters (f32 tensors holding
    values of ``dtype``), step i on ``batches[i]`` with draws (sigma,
    noise): each step's loss, each parameter's first gradient norm, its
    change after the last step and its EMA shadow's, in
    ``named_parameters`` order, on the host in f64."""
    names, params = zip(*[(n, p.requires_grad_(True)) for n, p in unet.named_parameters()])
    start = [p.detach().to(dtype, copy=True) for p in params]
    shadow = [s.clone() for s in start]
    opt = AdamW(params, recipe["lr"], recipe["weight_decay"], dtype)
    losses, first = [], None
    with autograd_ops():
        for batch, (sigma, noise) in zip(batches, draws):
            for p in params:
                p.grad = None
            value = loss(unet, batch, sigma, noise)
            value.backward()
            losses.append(float(value.detach()))
            if first is None:
                first = torch.stack([torch.linalg.vector_norm(p.grad) for p in params])
            opt.step()
            ema_step(shadow, params, recipe["ema_decay"], opt.t)
    with torch.no_grad():
        change = torch.stack([torch.linalg.vector_norm(p - s.float())
                              for p, s in zip(params, start)])
        ema = torch.stack([torch.linalg.vector_norm(e.float() - s.float())
                           for e, s in zip(shadow, start)])
    for p in params:
        p.grad = None
    return {"names": list(names), "losses": losses, "grad_norms": first.double().cpu(),
            "change_norms": change.double().cpu(), "ema_norms": ema.double().cpu()}
