"""Stage 1's VAE decode: ``Stage1Pipeline.decode_video`` on one chunk's
latents, call after call, under ``torch.inference_mode()`` and stage 1's
routing: the temporal decoder in pieces of ``decode_chunk_size`` frames,
in bf16 on a cast of its f32 weights when ``vae_decode_bf16``, then the
clamp to [-1, 1].  A unit is one call; it completes ``chunk_frames``
frames.

Inputs from the seed: ``distinct_latents`` latent chunks (1, T, h, w, z),
standard normal, used in turn.  The decoder's weights are made in f32, as
the pipeline stores them; the encoder is not built (the cell never
encodes).  The check decodes, in the reference, one piece of one call,
both drawn from the seed before the window (the call among the first
``CHECK_CALLS``), and compares the program's
frames of that piece, which the harness copies to the host after that call.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import common
from benchmark.entries.stage1_stream_chunk import latent_shape, port_config
from benchmark.reference import ops as ref_ops
from benchmark.reference.vae import VideoDecoder, decode
from benchmark.weights import make_weights

CHECK_CALLS = 3     # the checked call is one of the window's first three


def reference_decoder(cfg: dict, device="meta") -> VideoDecoder:
    with torch.device(device):
        return VideoDecoder(cfg["vae"]).eval()


class Cell:
    unit = "call"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        from streamingt2v_torch.models.vae import AutoencoderKL
        from streamingt2v_torch.pipeline.streaming import Stage1Pipeline, StreamingModels

        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.pcfg = port_config(cfg)
        self.vae = AutoencoderKL(self.pcfg.vae, device="meta",
                                 dtype=getattr(torch, cfg["vae_dtype"])).eval()
        self.vae.decoder.load_state_dict(self.weights(), assign=True)
        self.pipe = Stage1Pipeline(self.pcfg, StreamingModels(
            unet=None, controlnet=None, svd_unet=None, vae=self.vae, conditioner=None))
        self.latents = [torch.randn(latent_shape(cfg), device=self.device,
                                    generator=common.generator(seed, self.device, "latents", i))
                        for i in range(traffic["distinct_latents"])]
        frames, cs = cfg["inference"]["chunk_frames"], cfg["inference"]["decode_chunk_size"]
        self.pieces = [(s, min(s + cs, frames)) for s in range(0, frames, cs)]
        rng = np.random.default_rng(common.sub_seed(seed, "check"))
        self.check_call = int(rng.integers(CHECK_CALLS))
        self.check_piece = self.pieces[int(rng.integers(len(self.pieces)))]
        self.checked = None     # (call, host frames of the checked piece)
        a, b = self.check_piece
        inf = cfg["inference"]
        self.slot = common.HostSlots(1, (1, b - a, inf["height"], inf["width"], 3), torch.float32,
                                     device)
        self.handles = common.span_hooks(self.vae.decoder, self.vae.decoder)

    def weights(self):
        return make_weights(reference_decoder(self.cfg),
                            common.sub_seed(self.seed, "weights", "vae"), self.device,
                            getattr(torch, self.cfg["vae_dtype"]))

    def run(self, window: common.Window, record: bool = True) -> None:
        from streamingt2v_torch.ops.routing import use_routing

        window.start()
        a, b = self.check_piece
        with torch.inference_mode(), use_routing(self.pcfg.routing):
            for call in range(1 << 30):
                if window.boundary(call):
                    return
                out = self.pipe.decode_video(self.latents[call % len(self.latents)])
                if record and call == self.check_call and self.checked is None:
                    self.checked = (call, self.slot.put(out[:, a:b]))

    def warm_up(self) -> None:
        self.run(common.Unbounded(1, self.device), record=False)

    def work(self, units: int) -> dict:
        return {"frames": units * self.cfg["inference"]["chunk_frames"]}

    def release(self) -> None:
        common.remove(self.handles)
        common.sync(self.device)
        self.pipe = self.vae = None

    def plan_check(self) -> dict:
        if self.checked is None:
            raise RuntimeError("the window finished no call")
        return {"call": self.checked[0], "frames": self.checked[1]}

    def compare(self, plan: dict, control: bool = False) -> list:
        a, b = self.check_piece
        z = self.latents[plan["call"] % len(self.latents)][:, a:b]
        dec = reference_decoder(self.cfg)
        dec.load_state_dict({k: v.float() for k, v in self.weights().items()}, assign=True)
        scale = self.cfg["vae"]["scale_factor"]
        out = plan["frames"].to(self.device)
        with torch.no_grad(), common.full_f32():
            ref = decode(dec, z, scale)
            if control:
                with ref_ops.precision("fp8"):
                    out = decode(dec, z, scale)
        return [("frames_err", common.rel_err(out, ref))]

    def meta_unit(self):
        dec = reference_decoder(self.cfg)
        z = torch.empty(latent_shape(self.cfg), device="meta")
        scale = self.cfg["vae"]["scale_factor"]
        return lambda: [decode(dec, z[:, a:b], scale) for a, b in self.pieces]
