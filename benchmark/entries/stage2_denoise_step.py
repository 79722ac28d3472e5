"""Stage 2's enhancement steps: ``EnhancePipeline._denoise_step`` over the
SDEdit timesteps, call after call, under ``torch.inference_mode()`` and the
enhance routing (as ``enhance()`` runs it), starting over from the first
timestep when the window outlasts them.

One call is one DDIM timestep over the whole video: per overlapping chunk
the I2VGen-XL UNet's unconditional and conditional calls, the guidance and
the DDIM update, then the randomized-blending write-back.  A unit is one
call; it makes one step per chunk.

Inputs from the seed, in the shapes ``enhance()`` gives them: the noised
latents of the video at the first SDEdit timestep, the negative and
positive prompt embeddings, per chunk the CLIP image embedding (zeros in
the unconditional half) and the image latents (the key frame's latent,
then the frame-position masks).  The write-back's offsets come from a
table drawn from the seed, handed to the program as its ``EnhanceNoise``.

The check takes one call and one chunk drawn from the seed: from the
program's latents before that call, the reference runs the chunk's two UNet
calls, the guidance and the DDIM update, and compares the frames of the
program's latents after the call that the write-back takes from that chunk,
relative to what the guided noise prediction moves in them:
||x_p - x_r|| / ||x_r - x_0||, x_0 the same update with the prediction at zero.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark import common
from benchmark.reference import ops as ref_ops
from benchmark.reference import sampling
from benchmark.reference.i2vgen import I2VGenXLUNet as RefUNet
from benchmark.weights import make_weights

# host slots for the latents between calls: a window of 51 s holds 9 calls
RECORD_CALLS = 16

def reference_unet(cfg: dict, device="meta") -> RefUNet:
    with torch.device(device):
        return RefUNet(cfg["unet"]).eval()


def geometry(cfg: dict, traffic: dict) -> dict:
    e = cfg["enhance"]
    f, size, overlap = traffic["frames"], e["chunk_size"], e["overlap_size"]
    stride = size - overlap
    n = (f - size) // stride + 1
    if (n - 1) * stride + size != f:
        raise ValueError(f"{f} frames do not split into chunks of {size} with overlap {overlap}")
    d = e["vae_downsample"]
    return {"frames": f, "size": size, "overlap": overlap, "stride": stride, "chunks": n,
            "h": e["height"] // d, "w": e["width"] // d}


class TableNoise:
    """An ``EnhanceNoise`` whose write-back offsets come from a table drawn
    from the seed; ``_denoise_step`` draws nothing else."""

    def __init__(self, table: np.ndarray):
        self.table = table

    def offset(self, step: int, chunk: int, high: int) -> int:
        return int(self.table[step, chunk] % high)

    def normal(self, stream, index, shape):
        raise NotImplementedError("the benchmark makes the latents itself")


def make_inputs(cfg: dict, traffic: dict, seed: int, device) -> dict:
    g = geometry(cfg, traffic)
    u, e = cfg["unet"], cfg["enhance"]
    meta = torch.device(device).type == "meta"
    gen = None if meta else common.generator(seed, device, "stage2_inputs")
    cin, t, h, w = u["in_channels"], g["size"], g["h"], g["w"]
    ddim = sampling.DDIM()
    ts = ddim.timesteps(e["num_steps"], e["strength"])
    z0 = torch.randn((1, g["frames"], h, w, cin), generator=gen, device=device)
    noise = torch.randn(z0.shape, generator=gen, device=device)
    prompt = torch.randn((2, e["text_tokens"], u["cross_attention_dim"]), generator=gen,
                         device=device)
    clip, lat = [], []
    ramp = torch.arange(1, t, dtype=torch.float32, device=device) / (t - 1)
    for _ in range(g["chunks"]):
        emb = torch.randn((1, u["image_embed_dim"]), generator=gen, device=device)
        clip.append(torch.cat([torch.zeros_like(emb), emb]))
        key = torch.randn((1, 1, h, w, cin), generator=gen, device=device)
        il = torch.cat([key, ramp.reshape(1, -1, 1, 1, 1).expand(1, t - 1, h, w, cin)], dim=1)
        lat.append(torch.cat([il, il]))
    table = np.random.default_rng(common.sub_seed(seed, "offsets")).integers(
        0, 1 << 30, size=(len(ts), g["chunks"]))
    return {"latents": ddim.add_noise(z0, noise, ts[0]), "prompt": prompt,
            "clip": torch.stack(clip), "image_latents": torch.stack(lat),
            "noise": TableNoise(table), "timesteps": ts}


class Cell:
    unit = "call"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        from streamingt2v_torch.config import DTypePolicy, EnhanceConfig, VAEConfig
        from streamingt2v_torch.diffusion.ddim import DDIMScheduler
        from streamingt2v_torch.models.enhance.unet import I2VGenXLUNet, I2VGenXLUNetConfig
        from streamingt2v_torch.models.vae import AutoencoderKL
        from streamingt2v_torch.pipeline.enhance import EnhanceModels, EnhancePipeline

        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.geo = geometry(cfg, traffic)
        self.steps_per_unit = self.geo["chunks"]
        u, e = cfg["unet"], cfg["enhance"]
        self.ecfg = dataclasses.replace(
            EnhanceConfig(), num_steps=e["num_steps"], strength=e["strength"],
            guidance_scale=e["guidance_scale"], chunk_size=e["chunk_size"],
            overlap_size=e["overlap_size"], use_randomized_blending=True, height=e["height"],
            width=e["width"], fps=e["fps"])
        ucfg = I2VGenXLUNetConfig(
            in_channels=u["in_channels"], out_channels=u["out_channels"],
            block_out_channels=tuple(u["block_out_channels"]),
            layers_per_block=u["layers_per_block"], norm_num_groups=u["norm_num_groups"],
            cross_attention_dim=u["cross_attention_dim"],
            attention_head_dim=u["attention_head_dim"],
            image_embed_dim=u["image_embed_dim"],
            dtypes=DTypePolicy(compute_dtype=getattr(torch, cfg["dtype"])))
        self.unet = I2VGenXLUNet(ucfg, device="meta", dtype=getattr(torch, cfg["dtype"])).eval()
        self.unet.load_state_dict(self.weights(), assign=True)
        # the window runs no VAE: the pipeline's own is left unmade (meta)
        vae = AutoencoderKL(dataclasses.replace(VAEConfig(), temporal_decoder=False),
                            use_quant_conv=True, device="meta")
        self.pipe = EnhancePipeline(self.ecfg, EnhanceModels(
            unet=self.unet, vae=vae, clip_vision=None, text_encoder=None,
            scheduler=DDIMScheduler()))
        self.inputs = make_inputs(cfg, traffic, seed, self.device)
        self.states = []        # host latents before each call, then after the last
        self.slots = common.HostSlots(RECORD_CALLS, self.inputs["latents"].shape, torch.float32,
                                      device)
        self.handles = common.span_hooks(self.unet, self.unet)

    def weights(self):
        return make_weights(reference_unet(self.cfg), common.sub_seed(self.seed, "weights", "unet"),
                            self.device, getattr(torch, self.cfg["dtype"]))

    def run(self, window: common.Window, record: bool = True) -> None:
        from streamingt2v_torch.ops.routing import use_routing

        inp, g = self.inputs, self.geo
        ts = inp["timesteps"]
        latents = inp["latents"]
        window.start()
        with torch.inference_mode(), use_routing(self.ecfg.routing):
            for call in range(1 << 30):
                host = self.slots.put(latents) if record else None
                if host is not None:
                    self.states.append(host)
                if window.boundary(call):
                    return
                si = call % len(ts)
                if si == 0:
                    latents = inp["latents"]
                latents = self.pipe._denoise_step(
                    latents, si, ts[si], inp["prompt"], inp["clip"], inp["image_latents"],
                    inp["noise"], chunk_size=g["size"], stride=g["stride"],
                    overlap_size=g["overlap"])

    def warm_up(self) -> None:
        self.run(common.Unbounded(1, self.device), record=False)

    def work(self, units: int) -> dict:
        return {"steps": units * self.geo["chunks"]}

    def release(self) -> None:
        common.remove(self.handles)
        common.sync(self.device)
        self.pipe = self.unet = None

    def plan_check(self) -> dict:
        calls = len(self.states) - 1
        if calls < 1:
            raise RuntimeError("the window finished no call")
        rng = np.random.default_rng(common.sub_seed(self.seed, "check"))
        call = int(rng.integers(calls))
        return {"call": call, "chunk": int(rng.integers(self.geo["chunks"]))}

    def chunk_step(self, unet, x, si: int, chunk: int, inp: dict) -> torch.Tensor:
        """The reference's guided DDIM step of one chunk (1, T, h, w, c)."""
        e = self.cfg["enhance"]
        t = inp["timesteps"][si]
        tv = torch.full((1,), float(t), device=x.device)
        fps = torch.full((1,), float(e["fps"]), device=x.device)
        eps_u, eps_c = (unet(x, tv, fps, inp["image_latents"][chunk][i:i + 1],
                             inp["clip"][chunk][i:i + 1], inp["prompt"][i:i + 1]).float()
                        for i in (0, 1))
        eps = eps_u + e["guidance_scale"] * (eps_c - eps_u)
        return sampling.DDIM().step(eps, t, x.float(), e["num_steps"])

    def compare(self, plan: dict, control: bool = False) -> list:
        g, inp = self.geo, self.inputs
        call, chunk = plan["call"], plan["chunk"]
        si = call % len(inp["timesteps"])
        pre = inp["latents"] if si == 0 else self.states[call].to(self.device)
        post = self.states[call + 1].to(self.device)
        start = chunk * g["stride"]
        offsets = {c: inp["noise"].offset(si, c, g["overlap"]) for c in range(1, g["chunks"])}
        frames = list(sampling.chunk_frames(chunk, g["chunks"], g["stride"], g["size"], offsets))
        unet = reference_unet(self.cfg)
        unet.load_state_dict({k: v.float() for k, v in self.weights().items()}, assign=True)
        x = pre[:, start:start + g["size"]].float()
        local = [f - start for f in frames]
        out = post[:, frames]
        with torch.no_grad(), common.full_f32():
            ref = self.chunk_step(unet, x, si, chunk, inp)[:, local]
            if control:
                with ref_ops.precision("fp8"):
                    out = self.chunk_step(unet, x, si, chunk, inp)[:, local]
            base = sampling.DDIM().step(torch.zeros_like(x), inp["timesteps"][si], x,
                                        self.cfg["enhance"]["num_steps"])[:, local]
        return [("chunk_err", common.rel_err(out, ref, base))]

    def meta_unit(self):
        unet = reference_unet(self.cfg)
        g = self.geo
        x = torch.empty((1, g["size"], g["h"], g["w"], self.cfg["unet"]["in_channels"]),
                        device="meta")
        inp = make_inputs(self.cfg, self.traffic, 0, "meta")
        return lambda: [self.chunk_step(unet, x, 0, c, inp) for c in range(g["chunks"])]
