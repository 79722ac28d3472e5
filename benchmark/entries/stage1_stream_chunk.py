"""Stage 1's autoregressive chunks: ``Stage1Pipeline.stream_chunk``, chunk
after chunk, under ``torch.inference_mode()`` and stage 1's kernel routing.

A chunk is the sampler's steps (EulerEDM on the AYS sigmas, the linear
prediction guider), each one guided denoise of the CFG-doubled batch of the
chunk's frames: the ControlNet on the conditional frames, CAM, the
VideoUNet.  A unit is one step.  The harness sees the steps through
forward hooks on the two networks (public PyTorch API): the ControlNet's
pre-hook is the step boundary (the window's stop rule, the traced run's
edges), the VideoUNet's pre-hook copies the step's input latents to the
host (x c_in in the conditional half), and the span ``bench.network`` runs
from the ControlNet's call to the end of the VideoUNet's.

Inputs from the seed, as ``Stage1Pipeline.condition`` shapes them: per
chunk the initial noise, one CLIP token and one VAE latent broadcast over
the frames (zeroed in the unconditional half), the vector embedding of
fps_id, motion_bucket_id and cond_aug, and the control frames in [-1, 1]
shared by both halves.

The check follows one step drawn from the seed, from the program's own
input latents of that step (the reference cannot afford a whole chunk),
and compares the program's next latents (the next step's input, or the
chunk's output) with one reference step; the start, noise scaled by
sqrt(1 + sigma_0^2), is checked apart on the window's first chunk.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark import common
from benchmark.reference import ops as ref_ops
from benchmark.reference import sampling
from benchmark.reference.svd import ControlNet as RefControlNet
from benchmark.reference.svd import VideoUNet as RefVideoUNet
from benchmark.reference.svd import streaming_network
from benchmark.weights import make_weights

# host slots for the steps' input latents and the chunks' outputs: a window
# of 51 s holds about 54 steps of 950 ms, two chunks
RECORD_STEPS, RECORD_CHUNKS = 64, 4

def reference_models(cfg: dict, device="meta"):
    with torch.device(device):
        return (RefVideoUNet(cfg["unet"]).eval(),
                RefControlNet(cfg["unet"], cfg["controlnet"]).eval())


def port_config(cfg: dict):
    from streamingt2v_torch.config import (
        ControlNetConfig, DTypePolicy, GuiderConfig, InferenceParams, PipelineConfig,
        SamplerConfig, VAEConfig, VideoUNetConfig)

    u, inf, s, v = cfg["unet"], cfg["inference"], cfg["sampler"], cfg["vae"]
    dtypes = DTypePolicy(compute_dtype=getattr(torch, cfg["dtype"]))
    unet = VideoUNetConfig(
        in_channels=u["in_channels"], model_channels=u["model_channels"],
        out_channels=u["out_channels"], num_res_blocks=u["num_res_blocks"],
        attention_resolutions=tuple(u["attention_resolutions"]),
        channel_mult=tuple(u["channel_mult"]), num_head_channels=u["num_head_channels"],
        transformer_depth=u["transformer_depth"], context_dim=u["context_dim"],
        adm_in_channels=u["adm_in_channels"], video_kernel_size=tuple(u["video_kernel_size"]),
        max_period=u["max_period"], controlnet_mode=True, use_apm=False, dtypes=dtypes)
    ctrl = ControlNetConfig(
        conditioning_embedding_out_channels=tuple(
            cfg["controlnet"]["conditioning_embedding_out_channels"]),
        num_conditional_frames=cfg["controlnet"]["num_conditional_frames"])
    vae = VAEConfig(ch=v["ch"], ch_mult=tuple(v["ch_mult"]), num_res_blocks=v["num_res_blocks"],
                    z_channels=v["z_channels"], out_ch=v["out_ch"],
                    video_kernel_size=tuple(v["video_kernel_size"]),
                    scale_factor=v["scale_factor"])
    g = s["guider"]
    sampler = SamplerConfig(kind=s["kind"], num_steps=s["num_steps"],
                            discretization=s["discretization"],
                            guider=GuiderConfig(kind=g["kind"], min_scale=g["min_scale"],
                                                max_scale=g["max_scale"],
                                                num_frames=g["num_frames"]))
    inference = dataclasses.replace(
        InferenceParams(), num_conditional_frames=ctrl.num_conditional_frames,
        chunk_frames=inf["chunk_frames"], fps_id=inf["fps_id"],
        motion_bucket_id=inf["motion_bucket_id"], cond_aug=inf["cond_aug"],
        decode_chunk_size=inf["decode_chunk_size"], vae_decode_bf16=inf["vae_decode_bf16"])
    return PipelineConfig(height=inf["height"], width=inf["width"], unet=unet, controlnet=ctrl,
                          vae=vae, sampler=sampler, inference=inference)


def latent_shape(cfg: dict) -> tuple:
    inf, v = cfg["inference"], cfg["vae"]
    f = 2 ** (len(v["ch_mult"]) - 1)
    return (1, inf["chunk_frames"], inf["height"] // f, inf["width"] // f,
            cfg["unet"]["out_channels"])


def vector(cfg: dict, device) -> torch.Tensor:
    """The conditioning vector: each of fps_id, motion_bucket_id and cond_aug
    embedded sinusoidally to ``vector_outdim``, concatenated, (1, D)."""
    inf = cfg["inference"]
    vals = torch.tensor([inf["fps_id"], inf["motion_bucket_id"], inf["cond_aug"]],
                        dtype=torch.float32, device=device)
    return ref_ops.timestep_embedding(vals, inf["vector_outdim"]).reshape(1, -1)


def make_inputs(cfg: dict, seed: int, index: int, device) -> dict:
    """Chunk ``index``'s noise and (c, uc) from the seed."""
    meta = torch.device(device).type == "meta"
    gen = None if meta else common.generator(seed, device, "stage1_chunk", index)
    shape = latent_shape(cfg)
    _, t, h, w, _ = shape
    inf = cfg["inference"]
    f_cond = cfg["controlnet"]["num_conditional_frames"]
    noise = torch.randn(shape, generator=gen, device=device)
    token = torch.randn((1, 1, cfg["unet"]["context_dim"]), generator=gen, device=device)
    latent = torch.randn((1, h, w, cfg["unet"]["in_channels"] - shape[-1]), generator=gen,
                         device=device)
    ctrl = torch.rand((1, f_cond, inf["height"], inf["width"], 3), generator=gen,
                      device=device) * 2 - 1
    vec = vector(cfg, device)

    def frames(v):
        return v[:, None].expand((v.shape[0], t) + v.shape[1:])

    c = {"crossattn": frames(token), "vector": frames(vec), "concat": frames(latent),
         "ctrl_frames": ctrl}
    uc = dict(c, crossattn=frames(torch.zeros_like(token)), concat=frames(torch.zeros_like(latent)))
    return {"noise": noise, "c": c, "uc": uc}


class Cell:
    unit = "step"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        from streamingt2v_torch.models.controlnet import ControlNet
        from streamingt2v_torch.models.video_unet import VideoUNet
        from streamingt2v_torch.pipeline.streaming import Stage1Pipeline, StreamingModels

        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.pcfg = port_config(cfg)
        dtype = getattr(torch, cfg["dtype"])
        ref_unet, ref_ctrl = reference_models(cfg)
        self.unet = VideoUNet(self.pcfg.unet, device="meta", dtype=dtype).eval()
        self.controlnet = ControlNet(self.pcfg.unet, self.pcfg.controlnet, device="meta",
                                     dtype=dtype).eval()
        self.unet.load_state_dict(self.weights(ref_unet, "unet", dtype), assign=True)
        self.controlnet.load_state_dict(self.weights(ref_ctrl, "controlnet", dtype), assign=True)
        self.pipe = Stage1Pipeline(self.pcfg, StreamingModels(
            unet=self.unet, controlnet=self.controlnet, svd_unet=None, vae=None,
            conditioner=None))
        self.inputs = [make_inputs(cfg, seed, i, self.device)
                       for i in range(traffic["distinct_chunks"])]
        self.steps = self.pcfg.sampler.num_steps
        self.records = []       # (chunk, step, host x_in of the conditional half)
        self.outputs = {}       # chunk -> host latents it returned
        self.x_slots = common.HostSlots(RECORD_STEPS, latent_shape(cfg), torch.float32, device)
        self.z_slots = common.HostSlots(RECORD_CHUNKS, latent_shape(cfg), torch.float32, device)
        self.window = None
        self.record = False
        self.chunk = self.step = 0
        self.done = 0
        self.handles = [self.controlnet.register_forward_pre_hook(self._step_start),
                        self.unet.register_forward_pre_hook(self._record_input)]
        self.handles += common.span_hooks(self.controlnet, self.unet)

    def weights(self, ref_model, name: str, dtype):
        return make_weights(ref_model, common.sub_seed(self.seed, "weights", name), self.device,
                            dtype)

    # ---- the hooks ----
    def _step_start(self, module, args):
        if self.window is not None and self.window.boundary(self.done):
            raise common.StopWindow

    def _record_input(self, module, args):
        host = self.x_slots.put(args[0][1:, ..., :4]) if self.record else None
        if host is not None:
            self.records.append((self.chunk, self.step, host))
        self.step += 1
        self.done += 1

    def run(self, window: common.Window, record: bool = True) -> None:
        """Chunks until the window closes at a step boundary."""
        from streamingt2v_torch.ops.routing import use_routing

        self.window, self.record = window, record
        self.done = 0
        window.start()
        try:
            with torch.inference_mode(), use_routing(self.pcfg.routing):
                for chunk in range(1 << 30):
                    self.chunk, self.step = chunk, 0
                    inp = self.inputs[chunk % len(self.inputs)]
                    z = self.pipe.stream_chunk(inp["c"], inp["uc"], inp["noise"])
                    host = self.z_slots.put(z) if record else None
                    if host is not None:
                        self.outputs[chunk] = host
        except common.StopWindow:
            pass
        finally:
            self.window = None

    def warm_up(self) -> None:
        self.run(common.Unbounded(2, self.device), record=False)

    def work(self, units: int) -> dict:
        return {"steps": units}

    def release(self) -> None:
        common.remove(self.handles)
        common.sync(self.device)
        self.pipe = self.unet = self.controlnet = self.inputs = None

    # ---- the check ----
    def _pairs(self):
        """(chunk, step, x_in, next latents) of every step the window finished."""
        by_key = {(c, s): x for c, s, x in self.records}
        sig = self.sigmas
        out = []
        for (c, s), x in sorted(by_key.items()):
            nxt = by_key.get((c, s + 1))
            if nxt is not None:
                out.append((c, s, x, ("x_in", nxt, sig[s + 1])))
            elif s == self.steps - 1 and c in self.outputs:
                out.append((c, s, x, ("z", self.outputs[c], None)))
        return out

    @property
    def sigmas(self):
        return sampling.ays_sigmas(self.steps)

    def plan_check(self) -> dict:
        """The step to check, drawn from the seed among the finished ones."""
        pairs = self._pairs()
        if not pairs:
            raise RuntimeError("the window finished no step")
        rng = np.random.default_rng(common.sub_seed(self.seed, "check"))
        pair = pairs[int(rng.integers(len(pairs)))]
        return {"chunk": pair[0], "step": pair[1], "pair": pair}

    def reference(self):
        ref_unet, ref_ctrl = reference_models(self.cfg)
        ref_unet.load_state_dict({k: v.float() for k, v in self.weights(
            ref_unet, "unet", getattr(torch, self.cfg["dtype"])).items()}, assign=True)
        ref_ctrl.load_state_dict({k: v.float() for k, v in self.weights(
            ref_ctrl, "controlnet", getattr(torch, self.cfg["dtype"])).items()}, assign=True)
        return streaming_network(ref_unet, ref_ctrl,
                                 self.cfg["controlnet"]["num_conditional_frames"])

    def compare(self, plan: dict, control: bool = False) -> list:
        """[(name, reading)]: the start and the drawn step, the program's
        (or, with ``control``, the reference's in fp8 in its place) against
        the f32 reference.  A step's gap is taken relative to what the
        network moves in it: ||x_p - x_r|| / ||x_r - x_0||, x_0 the same step
        with the network's output at zero (at sigma 700 the step is nearly
        all x itself, at the last steps nearly all the network)."""
        sig = self.sigmas
        c_in = lambda s: float(sampling.v_scalings(torch.tensor([float(s)]))[2])  # noqa: E731
        chunk, step, x_in, (kind, nxt, nxt_sigma) = plan["pair"]
        inp = make_inputs(self.cfg, self.seed, chunk % self.traffic["distinct_chunks"],
                          self.device)
        x = x_in.to(self.device).float() / c_in(sig[step])
        prog_next = nxt.to(self.device).float()
        if kind == "x_in":
            prog_next = prog_next / c_in(nxt_sigma)
        first = min((c, s) for c, s, _ in self.records)
        x0_prog = [xi for c, s, xi in self.records if (c, s) == first][0].to(self.device).float()
        x0_prog = x0_prog / c_in(sig[0])
        first_inp = make_inputs(self.cfg, self.seed, first[0] % self.traffic["distinct_chunks"],
                                self.device)
        x0_ref = sampling.initial_latents(first_inp["noise"], sig)
        scales = sampling.frame_scales(self.cfg["sampler"])
        with torch.no_grad(), common.full_f32():
            net = self.reference()
            ref_next = sampling.euler_step(net, x, step, sig, inp["c"], inp["uc"], scales)
            if control:
                with ref_ops.precision("fp8"):
                    prog_next = sampling.euler_step(net, x, step, sig, inp["c"], inp["uc"], scales)
                    x0_prog = ref_ops.operand(x0_ref)
        return [("start_err", common.rel_err(x0_prog, x0_ref)),
                ("step_err", common.rel_err(prog_next, ref_next,
                                            sampling.euler_base(x, step, sig)))]

    # ---- the work, counted on the reference ----
    def meta_unit(self):
        """One unit of the reference on the meta device (its FLOPs and op log)."""
        ref_unet, ref_ctrl = reference_models(self.cfg)
        net = streaming_network(ref_unet, ref_ctrl,
                                self.cfg["controlnet"]["num_conditional_frames"])
        inp = make_inputs(self.cfg, 0, 0, "meta")
        x = torch.empty(latent_shape(self.cfg), device="meta")
        return lambda: sampling.euler_step(net, x, 0, self.sigmas, inp["c"], inp["uc"],
                                           sampling.frame_scales(self.cfg["sampler"]).to("meta"))
