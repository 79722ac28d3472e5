"""The plain reference against the port at the tiny size on the CPU: the
same benchmark-made weights and inputs through the three entries agree in
f32, and every layer that the published models start at zero changes the
compared output under the benchmark's weights (under the port's
``init_random_`` the stage-1 network's output is exactly zero)."""

from __future__ import annotations

import pytest
import torch

from benchmark import common, weights
from benchmark.entries import stage1_decode_video, stage1_stream_chunk, stage2_denoise_step
from benchmark.reference import sampling
from benchmark.tests import tiny

ENTRIES = {"streamingsvd.ar_chunk": stage1_stream_chunk,
           "i2vgen_xl.enhance_chunk": stage2_denoise_step,
           "streamingsvd.vae_decode": stage1_decode_video}
# f32 on both sides: what is left is the order of the sums
F32_AGREE = 1e-4


def f32_cell(name: str):
    cfg, traffic = tiny.cell(name)
    cfg["dtype"] = "float32"
    if "inference" in cfg:
        cfg["inference"]["vae_decode_bf16"] = False
    return ENTRIES[name].Cell(cfg, traffic, 2**31 + 77, "cpu")


@pytest.mark.parametrize("name", sorted(ENTRIES))
def test_reference_agrees_with_the_port_in_f32(name):
    cell = f32_cell(name)
    cell.run(common.Unbounded(4, "cpu"))
    cell.release()
    for check, value in cell.compare(cell.plan_check()):
        assert value < F32_AGREE, (check, value)


@pytest.mark.parametrize("name", sorted(ENTRIES))
def test_weights_load_strictly_and_no_layer_is_zero(name):
    cell = f32_cell(name)
    nets = {"streamingsvd.ar_chunk": lambda: [cell.unet, cell.controlnet],
            "i2vgen_xl.enhance_chunk": lambda: [cell.unet],
            "streamingsvd.vae_decode": lambda: [cell.vae.decoder]}[name]()
    for net in nets:
        for pname, p in net.named_parameters():
            assert p.device.type == "cpu", pname
            assert p.abs().max() > 0, pname


def stage1_step(unet, controlnet, cfg, inp):
    """One guided step of the port's streaming network at sigma_0."""
    from streamingt2v_torch.diffusion.denoiser import denoise
    from streamingt2v_torch.diffusion.guiders import make_guider
    from streamingt2v_torch.models.wrappers import streaming_wrapper

    pcfg = stage1_stream_chunk.port_config(cfg)
    net = streaming_wrapper(unet, controlnet, pcfg.inference.num_conditional_frames,
                            ctrl_cfg_shared=True)
    guider = make_guider(pcfg.sampler.guider)
    sigma = torch.full((1,), 7.0)
    x_in, s_in, c_in = guider.prepare(inp["noise"] * 7.0, sigma, inp["c"], inp["uc"])
    with torch.no_grad():
        return guider.combine(denoise(net, x_in, s_in, c_in))


def zero_layer_changes(model, run_fn, layers):
    base = run_fn()
    moved = {}
    for name in layers:
        k = model.get_submodule(name).kernel
        saved = k.clone()
        with torch.no_grad():
            k.zero_()
            moved[name] = float((run_fn() - base).abs().max())
            k.copy_(saved)
    return moved


def test_every_zero_initialised_layer_of_stage1_changes_the_step():
    cfg, traffic = tiny.cell("streamingsvd.ar_chunk")
    cfg["dtype"] = "float32"
    cell = stage1_stream_chunk.Cell(cfg, traffic, 11, "cpu")
    inp = cell.inputs[0]
    ref_unet, ref_ctrl = stage1_stream_chunk.reference_models(cfg)
    layers = weights.zero_init_layers(ref_unet)
    ctrl_layers = weights.zero_init_layers(ref_ctrl)
    kinds = {n.rsplit(".", 1)[-1] for n in layers + ctrl_layers}
    # ResBlocks' out convs (spatial and temporal), the transformers' and
    # CAM's proj_out, the UNet's out conv, the ControlNet's conv_out
    assert kinds == {"out_conv", "proj_out", "conv_out"}
    assert any(n.startswith("cam_merger") for n in layers)
    run_fn = lambda: stage1_step(cell.unet, cell.controlnet, cfg, inp)  # noqa: E731
    for model, names in ((cell.unet, layers), (cell.controlnet, ctrl_layers)):
        moved = zero_layer_changes(model, run_fn, names)
        assert min(moved.values()) > 1e-6, {n: v for n, v in moved.items() if v <= 1e-6}


def test_every_zero_initialised_layer_of_stage2_changes_the_step():
    cfg, traffic = tiny.cell("i2vgen_xl.enhance_chunk")
    cfg["dtype"] = "float32"
    cell = stage2_denoise_step.Cell(cfg, traffic, 12, "cpu")
    inp, g = cell.inputs, cell.geo
    layers = weights.zero_init_layers(stage2_denoise_step.reference_unet(cfg))
    assert layers and all(n.endswith("conv4") for n in layers)

    def run_fn():
        with torch.no_grad():
            return cell.pipe._denoise_chunk(inp["latents"][:, :g["size"]], inp["timesteps"][0],
                                            inp["prompt"], inp["clip"][0],
                                            inp["image_latents"][0])

    moved = zero_layer_changes(cell.unet, run_fn, layers)
    assert min(moved.values()) > 1e-6, moved


def test_every_zero_initialised_layer_of_the_decoder_changes_the_frames():
    cfg, traffic = tiny.cell("streamingsvd.vae_decode")
    cfg["inference"]["vae_decode_bf16"] = False
    cell = stage1_decode_video.Cell(cfg, traffic, 13, "cpu")
    layers = weights.zero_init_layers(stage1_decode_video.reference_decoder(cfg))
    assert layers and all(n.endswith("time_stack.out_conv") for n in layers)

    def run_fn():
        with torch.no_grad():
            return cell.pipe.decode_video(cell.latents[0])

    moved = zero_layer_changes(cell.vae.decoder, run_fn, layers)
    assert min(moved.values()) > 1e-6, moved


def test_under_the_ports_own_init_the_stage1_network_returns_zero():
    """Why the benchmark makes its own weights: with ``init_random_`` the
    zero-initialised output layers make the streaming network's output
    exactly zero, so a step's denoised latents are c_skip x alone."""
    from streamingt2v_torch.models.controlnet import ControlNet
    from streamingt2v_torch.models.layers import init_random_
    from streamingt2v_torch.models.video_unet import VideoUNet
    from streamingt2v_torch.models.wrappers import streaming_wrapper

    cfg, traffic = tiny.cell("streamingsvd.ar_chunk")
    cfg["dtype"] = "float32"
    pcfg = stage1_stream_chunk.port_config(cfg)
    unet = init_random_(VideoUNet(pcfg.unet).eval(), torch.Generator().manual_seed(0))
    ctrl = init_random_(ControlNet(pcfg.unet, pcfg.controlnet).eval(),
                        torch.Generator().manual_seed(1))
    inp = stage1_stream_chunk.make_inputs(cfg, 5, 0, "cpu")
    net = streaming_wrapper(unet, ctrl, pcfg.inference.num_conditional_frames,
                            ctrl_cfg_shared=True)
    x2 = torch.cat([inp["noise"]] * 2)
    cond = {k: torch.cat([inp["uc"][k], inp["c"][k]]) for k in inp["c"]}
    with torch.no_grad():
        out = net(x2, torch.zeros(2), cond)
    assert float(out.abs().max()) == 0.0


def test_sigmas_and_timesteps_match_the_ports():
    from streamingt2v_torch.diffusion.ddim import DDIMScheduler
    from streamingt2v_torch.diffusion.discretization import get_sigmas

    assert (sampling.ays_sigmas(30) == get_sigmas("align_your_steps", 30)).all()
    assert sampling.DDIM().timesteps(30, 0.97) == [
        int(t) for t in DDIMScheduler().sdedit_timesteps(30, 0.97)]
