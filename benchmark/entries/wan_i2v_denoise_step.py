"""Wan2.1-I2V-14B-480P image-to-video steps: ``WanI2VPipeline.denoise_step``
over the pipeline's 40 UniPC steps, step after step, under
``torch.inference_mode()`` (as ``generate`` runs it), starting over from the
first step, the initial noise and an empty solver state when the window
outlasts them.

One step is one guided UniPC step of the whole clip: the transformer once
on the CFG batch [negative; positive] of the (1, 16, 21, 60, 104) latents
(32,760 tokens a sequence at 81 frames of 480x832), with the conditioning
y = [first-frame mask; image latent] and the CLIP features on both halves,
the guidance and the UniPC update.  A unit is one step.

Inputs from the seed: the initial noise, the image latent (the VAE latent of
[image; zero frames]), the CLIP image tokens and the prompt and negative
umT5 embeddings (real rows only; the model pads them).

The check takes one step drawn from the seed.  From the program's own state
before it (the latents, the last sample and the previous data predictions,
recorded in the window), the reference runs the transformer on both halves,
the guidance and the UniPC update, and compares the program's latents after
the step, relative to what the guided prediction moves in them:
||x_p - x_r|| / ||x_r - x_0||, x_0 the same update with the prediction at
zero.  The reference holds the weights in bf16 as made and up-casts each
product's operands to f32 as it runs.

The same step is also checked at the first block's self-attention, which
the step's reading sees only coarsely: with random weights the attention
over 32,760 keys is close to a uniform average, so what its structure (the
RoPE turns, the q/k norms) adds is about 1% of the step.  The window
records the program's heads' output before ``o`` of the first block (the
input of its ``o``; one CFG half, since no text enters it) and the
reference computes it from the step's latents:
||a_p - a_r|| / ||a_r - a_u||, a_u the same attention with every key
weighed alike (the mean of v over the keys).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import common
from benchmark.reference import ops as ref_ops
from benchmark.reference import wan as ref
from benchmark.weights import make_weights

# host slots for the solver state before each step: a window of 10 s holds
# two or three steps
RECORD_STEPS = 8
# what a slot holds: the latents, the last sample, the last and the one
# before the last data predictions (zeros where the state has none yet)
SLOT_PARTS = 4


def reference_model(cfg: dict, device="meta") -> ref.WanTransformer3D:
    with torch.device(device):
        return ref.WanTransformer3D(cfg["transformer"]).eval()


def latent_shape(cfg: dict) -> tuple:
    p = cfg["pipeline"]
    s = p["vae_stride"]
    return (1, p["z_dim"], (p["frames"] - 1) // s[0] + 1, p["height"] // s[1], p["width"] // s[2])


def port_config(cfg: dict):
    from streamingt2v_torch.config import DTypePolicy, WanConfig
    from streamingt2v_torch.diffusion.flow_unipc import FlowUniPCConfig

    t, s, p = cfg["transformer"], cfg["scheduler"], cfg["pipeline"]
    if t["model_type"] != "i2v" or t["window_size"] != [-1, -1] or not t["qk_norm"] \
            or not t["cross_attn_norm"]:
        raise ValueError("the port runs Wan's i2v model with global attention, q/k norm and "
                         "the affine cross-attention norm")
    return WanConfig(
        dim=t["dim"], ffn_dim=t["ffn_dim"], num_heads=t["num_heads"], num_layers=t["num_layers"],
        in_dim=t["in_dim"], out_dim=t["out_dim"], freq_dim=t["freq_dim"],
        text_dim=t["text_dim"], text_len=t["text_len"], eps=t["eps"],
        patch_size=tuple(t["patch_size"]), clip_dim=t["clip_dim"],
        clip_tokens=p["clip_tokens"], image_eps=t["image_eps"], frames=p["frames"],
        height=p["height"], width=p["width"], vae_stride=tuple(p["vae_stride"]),
        num_steps=p["num_inference_steps"], guidance_scale=p["guidance_scale"],
        scheduler=FlowUniPCConfig(num_train_timesteps=s["num_train_timesteps"],
                                  solver_order=s["solver_order"], shift=s["shift"]),
        dtypes=DTypePolicy(compute_dtype=getattr(torch, cfg["dtype"])))


def make_inputs(cfg: dict, seed: int, device) -> dict:
    t, p = cfg["transformer"], cfg["pipeline"]
    meta = torch.device(device).type == "meta"
    gen = None if meta else common.generator(seed, device, "wan_inputs")

    def draw(*shape):
        return torch.randn(shape, generator=gen, device=device)

    return {"noise": draw(*latent_shape(cfg)), "image_latent": draw(*latent_shape(cfg)),
            "clip": draw(1, p["clip_tokens"], t["clip_dim"]),
            "prompt": draw(1, p["prompt_rows"], t["text_dim"]),
            "negative": draw(1, p["negative_rows"], t["text_dim"])}


def mask_and_latent(cfg: dict, image_latent: torch.Tensor) -> torch.Tensor:
    """y = [mask; image latent], the mask written out as ``image2video.py``
    builds it: the pixel frames' mask (first frame 1) with the first
    repeated 4 times, viewed as (latent frames, 4) on channels."""
    p = cfg["pipeline"]
    _, _, f, h, w = image_latent.shape
    msk = torch.ones(1, p["frames"], h, w, device=image_latent.device)
    msk[:, 1:] = 0
    msk = torch.cat([msk[:, :1].repeat_interleave(4, dim=1), msk[:, 1:]], dim=1)
    msk = msk.view(1, f, 4, h, w).transpose(1, 2)
    return torch.cat([msk, image_latent], dim=1)


class Cell:
    unit = "step"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        from streamingt2v_torch.models.wan import WanTransformer3D
        from streamingt2v_torch.pipeline.wan import WanI2VPipeline

        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.pcfg = port_config(cfg)
        dtype = getattr(torch, cfg["dtype"])
        self.transformer = WanTransformer3D(self.pcfg, device="meta", dtype=dtype).eval()
        self.transformer.load_state_dict(self.weights(), assign=True)
        self.pipe = WanI2VPipeline(self.pcfg, self.transformer)
        self.inputs = make_inputs(cfg, seed, self.device)
        self.y = self.pipe.condition(self.inputs["image_latent"])
        self.sched = ref.Scheduler(cfg["scheduler"], cfg["pipeline"]["num_inference_steps"])
        self.states = []        # host solver states before each step, then after the last
        self.slots = common.HostSlots(RECORD_STEPS, (SLOT_PARTS,) + latent_shape(cfg),
                                      torch.float32, device)
        self.zero = torch.zeros(latent_shape(cfg), device=self.device)
        # host: the first block's heads' output of each step (335 MB a slot at
        # the cell's size)
        self.attention = []
        _, _, f, h, w = latent_shape(cfg)
        p = cfg["transformer"]["patch_size"]
        self.attention_slots = common.HostSlots(
            RECORD_STEPS, (f * h * w // (p[1] * p[2]), cfg["transformer"]["dim"]), dtype,
            device)
        self.handles = common.span_hooks(self.transformer, self.transformer)

    def weights(self):
        return make_weights(reference_model(self.cfg),
                            common.sub_seed(self.seed, "weights", "transformer"), self.device,
                            getattr(torch, self.cfg["dtype"]))

    def _record(self, latents: torch.Tensor, state) -> None:
        outs = list(state.outputs)[::-1] + [self.zero] * 2
        last = self.zero if state.last_sample is None else state.last_sample
        host = self.slots.put(torch.stack([latents, last, outs[0], outs[1]]))
        if host is not None:
            self.states.append(host)

    def _record_attention(self, module, args) -> None:
        host = self.attention_slots.put(args[0][0])
        if host is not None:
            self.attention.append(host)

    def run(self, window: common.Window, record: bool = True) -> None:
        from streamingt2v_torch.diffusion.flow_unipc import UniPCState

        inp, n = self.inputs, len(self.sched.timesteps)
        latents, state = inp["noise"], UniPCState()
        hooks = [self.transformer.blocks[0].self_attn.o.register_forward_pre_hook(
            self._record_attention)] if record else []
        window.start()
        try:
            with torch.inference_mode():
                for step in range(1 << 30):
                    if record:
                        self._record(latents, state)
                    if window.boundary(step):
                        return
                    si = step % n
                    if si == 0:
                        latents, state = inp["noise"], UniPCState()
                    latents, state = self.pipe.denoise_step(latents, state, si, inp["prompt"],
                                                            inp["negative"], inp["clip"], self.y)
        finally:
            common.remove(hooks)

    def warm_up(self) -> None:
        self.run(common.Unbounded(1, self.device), record=False)

    def work(self, units: int) -> dict:
        return {"steps": units}

    def release(self) -> None:
        common.remove(self.handles)
        common.sync(self.device)
        self.pipe = self.transformer = None

    def plan_check(self) -> dict:
        steps = min(len(self.states) - 1, len(self.attention))
        if steps < 1:
            raise RuntimeError("the window finished no step")
        rng = np.random.default_rng(common.sub_seed(self.seed, "check"))
        return {"step": int(rng.integers(steps))}

    def step(self, model, x, si: int, last, outputs: list, inp: dict, y) -> torch.Tensor:
        """The reference's guided step at step index ``si`` from x and the
        solver state (last sample, data predictions oldest first)."""
        p = self.cfg["pipeline"]
        return ref.guided_step(model, self.sched, x, si, last, outputs, inp["prompt"],
                               inp["negative"], inp["clip"], y, p["guidance_scale"])

    def reference(self) -> ref.WanTransformer3D:
        model = reference_model(self.cfg)
        model.load_state_dict(self.weights(), assign=True)
        return model

    def _latents(self, step: int) -> torch.Tensor:
        """The latents that step ``step`` of the window started from."""
        if step % len(self.sched.timesteps) == 0:
            return self.inputs["noise"].float()
        return self.states[step][0].to(self.device).float()

    def compare_attention(self, plan: dict, model, control: bool = False) -> tuple:
        """``self_attn_err`` of the first block's self-attention at the
        planned step."""
        step = plan["step"]
        x = self._latents(step)
        t = torch.full((1,), float(self.sched.timesteps[step % len(self.sched.timesteps)]),
                       device=self.device)
        y = mask_and_latent(self.cfg, self.inputs["image_latent"])
        with torch.no_grad(), common.full_f32():
            ref_out, uniform = model.first_attention(x, t, y)
            if control:
                with ref_ops.precision("fp8"):
                    out = model.first_attention(x, t, y)[0]
            else:
                out = self.attention[step].to(self.device)[None]
        return ("self_attn_err", common.rel_err(out, ref_out, uniform))

    def compare(self, plan: dict, control: bool = False) -> list:
        step = plan["step"]
        si = step % len(self.sched.timesteps)
        out = self.states[step + 1][0].to(self.device)
        x, last, outputs = self._latents(step), None, []
        if si > 0:
            rec = self.states[step].to(self.device)
            last = rec[1]
            outputs = [rec[2]] if si == 1 else [rec[3], rec[2]]
        model = self.reference()
        y = mask_and_latent(self.cfg, self.inputs["image_latent"])
        with torch.no_grad(), common.full_f32():
            ref_out = self.step(model, x, si, last, outputs, self.inputs, y)
            if control:
                with ref_ops.precision("fp8"):
                    out = self.step(model, x, si, last, outputs, self.inputs, y)
            base = self.sched.step(torch.zeros_like(x), si, x, last, outputs)
        return [("step_err", common.rel_err(out, ref_out, base)),
                self.compare_attention(plan, model, control)]

    def meta_unit(self):
        model = reference_model(self.cfg)
        x = torch.empty(latent_shape(self.cfg), device="meta")
        inp = make_inputs(self.cfg, 0, "meta")
        y = torch.empty((1, 4) + latent_shape(self.cfg)[2:], device="meta")
        y = torch.cat([y, inp["image_latent"]], dim=1)
        return lambda: self.step(model, x, 0, None, [], inp, y)
