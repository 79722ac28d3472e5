"""CogVideoX-5B text-to-video steps: ``CogVideoXPipeline.denoise_step`` over
the pipeline's DDIM timesteps, step after step, under
``torch.inference_mode()`` and the configuration's routing (as
``generate`` runs it), starting over from the first timestep and the
initial noise when the window outlasts them.

One step is one guided DDIM step of the whole clip: the transformer once on
the CFG batch [negative; positive] of the (1, F, C, H, W) latents (17,776
tokens a sequence at 49 frames of 480x720), the guidance and the DDIM
update.  A unit is one step.

Inputs from the seed: the initial noise and the positive and negative
prompt embeddings (T5-XXL's shape, in place of the text encoder).

The check takes one step drawn from the seed: from the program's latents
before it, the reference runs the transformer on both halves, the guidance
and the DDIM update, and compares the program's latents after the step,
relative to what the guided v-prediction moves in them: ||x_p - x_r|| /
||x_r - x_0||, x_0 the same update with the prediction at zero.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import common
from benchmark.reference import cogvideox as ref
from benchmark.reference import ops as ref_ops
from benchmark.weights import make_weights

# host slots for the latents between steps: a window of 51 s holds about 40
RECORD_STEPS = 48


def reference_model(cfg: dict, device="meta") -> ref.CogVideoXTransformer3D:
    with torch.device(device):
        return ref.CogVideoXTransformer3D(cfg["transformer"]).eval()


def latent_shape(cfg: dict) -> tuple:
    t, p = cfg["transformer"], cfg["pipeline"]
    s = p["vae_scale_factor_spatial"]
    frames = (p["num_frames"] - 1) // p["vae_scale_factor_temporal"] + 1
    return (1, frames, t["in_channels"], p["height"] // s, p["width"] // s)


def port_config(cfg: dict):
    from streamingt2v_torch.config import CogVideoXConfig, DTypePolicy
    from streamingt2v_torch.diffusion.ddim import DDIMConfig

    t, s, p = cfg["transformer"], cfg["scheduler"], cfg["pipeline"]
    if s["snr_shift_scale"] != 1.0:
        raise ValueError(f"snr_shift_scale {s['snr_shift_scale']}: the port runs the "
                         "published 1.0, the identity")
    return CogVideoXConfig(
        num_layers=t["num_layers"], num_attention_heads=t["num_attention_heads"],
        attention_head_dim=t["attention_head_dim"], in_channels=t["in_channels"], out_channels=t["out_channels"],
        patch_size=t["patch_size"], text_embed_dim=t["text_embed_dim"],
        max_text_seq_length=t["max_text_seq_length"], time_embed_dim=t["time_embed_dim"],
        norm_eps=t["norm_eps"], frames=p["num_frames"], height=p["height"], width=p["width"],
        vae_scale_factor_spatial=p["vae_scale_factor_spatial"],
        vae_scale_factor_temporal=p["vae_scale_factor_temporal"],
        num_steps=p["num_inference_steps"], guidance_scale=p["guidance_scale"],
        scheduler=DDIMConfig(**{k: s[k] for k in (
            "num_train_timesteps", "beta_start", "beta_end", "beta_schedule", "steps_offset",
            "timestep_spacing", "prediction_type", "set_alpha_to_one", "clip_sample",
            "rescale_betas_zero_snr")}),
        dtypes=DTypePolicy(compute_dtype=getattr(torch, cfg["dtype"])))


def make_inputs(cfg: dict, seed: int, device) -> dict:
    t = cfg["transformer"]
    meta = torch.device(device).type == "meta"
    gen = None if meta else common.generator(seed, device, "cogvideox_inputs")
    text = (1, t["max_text_seq_length"], t["text_embed_dim"])
    return {"noise": torch.randn(latent_shape(cfg), generator=gen, device=device),
            "prompt": torch.randn(text, generator=gen, device=device),
            "negative": torch.randn(text, generator=gen, device=device)}


class Cell:
    unit = "step"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        from streamingt2v_torch.models.cogvideox import CogVideoXTransformer3D
        from streamingt2v_torch.pipeline.cogvideox import CogVideoXPipeline

        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.pcfg = port_config(cfg)
        dtype = getattr(torch, cfg["dtype"])
        self.transformer = CogVideoXTransformer3D(self.pcfg, device="meta", dtype=dtype).eval()
        self.transformer.load_state_dict(self.weights(), assign=True)
        self.pipe = CogVideoXPipeline(self.pcfg, self.transformer)
        self.inputs = make_inputs(cfg, seed, self.device)
        self.timesteps = ref.Scheduler(cfg["scheduler"]).timesteps(
            cfg["pipeline"]["num_inference_steps"])
        self.states = []        # host latents before each step, then after the last
        self.slots = common.HostSlots(RECORD_STEPS, latent_shape(cfg), torch.float32, device)
        self.handles = common.span_hooks(self.transformer, self.transformer)

    def weights(self):
        return make_weights(reference_model(self.cfg),
                            common.sub_seed(self.seed, "weights", "transformer"), self.device,
                            getattr(torch, self.cfg["dtype"]))

    def run(self, window: common.Window, record: bool = True) -> None:
        from streamingt2v_torch.ops.routing import use_routing

        inp, ts = self.inputs, self.timesteps
        latents = inp["noise"]
        window.start()
        with torch.inference_mode(), use_routing(self.pcfg.routing):
            for step in range(1 << 30):
                host = self.slots.put(latents) if record else None
                if host is not None:
                    self.states.append(host)
                if window.boundary(step):
                    return
                si = step % len(ts)
                if si == 0:
                    latents = inp["noise"]
                latents = self.pipe.denoise_step(latents, si, ts[si], inp["prompt"],
                                                 inp["negative"])

    def warm_up(self) -> None:
        self.run(common.Unbounded(1, self.device), record=False)

    def work(self, units: int) -> dict:
        return {"steps": units}

    def release(self) -> None:
        common.remove(self.handles)
        common.sync(self.device)
        self.pipe = self.transformer = None

    def plan_check(self) -> dict:
        steps = len(self.states) - 1
        if steps < 1:
            raise RuntimeError("the window finished no step")
        rng = np.random.default_rng(common.sub_seed(self.seed, "check"))
        return {"step": int(rng.integers(steps))}

    def step(self, model, x, si: int, inp: dict) -> torch.Tensor:
        """The reference's guided step at timestep index ``si`` from x."""
        p = self.cfg["pipeline"]
        return ref.guided_step(model, ref.Scheduler(self.cfg["scheduler"]), x,
                               self.timesteps[si], p["num_inference_steps"], inp["prompt"],
                               inp["negative"], p["guidance_scale"])

    def compare(self, plan: dict, control: bool = False) -> list:
        step = plan["step"]
        si = step % len(self.timesteps)
        pre = self.inputs["noise"] if si == 0 else self.states[step].to(self.device)
        out = self.states[step + 1].to(self.device)
        model = reference_model(self.cfg)
        model.load_state_dict({k: v.float() for k, v in self.weights().items()}, assign=True)
        x = pre.float()
        with torch.no_grad(), common.full_f32():
            ref_out = self.step(model, x, si, self.inputs)
            if control:
                with ref_ops.precision("fp8"):
                    out = self.step(model, x, si, self.inputs)
            sched = ref.Scheduler(self.cfg["scheduler"])
            base = sched.step(torch.zeros_like(x), self.timesteps[si], x,
                              self.cfg["pipeline"]["num_inference_steps"])
        return [("step_err", common.rel_err(out, ref_out, base))]

    def meta_unit(self):
        model = reference_model(self.cfg)
        x = torch.empty(latent_shape(self.cfg), device="meta")
        inp = make_inputs(self.cfg, 0, "meta")
        return lambda: self.step(model, x, 0, inp)
