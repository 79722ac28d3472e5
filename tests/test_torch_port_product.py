"""PyTorch port, the three-stage product: the media functions, the tiny
image -> stage 1 -> stage 2 -> stage 3 product against the JAX package's
``StreamingT2VPipeline`` on the same weights and the same draws, MAWE, and
the command line.

Tolerances:
  - ``fetch_uint8``/``to_uint8``, the y4m bytes and the uint8
    ``resize_video`` (against OpenCV's ``INTER_LINEAR``, which the JAX
    package calls) are exact; ``put_unit_range`` is ``video / 255`` exactly,
    one f32 ulp from the JAX function (XLA multiplies by 1/255);
  - the product's uint8 frames, each stage from the JAX package's output of
    the stage before, differ by at most 2 levels and in at most 0.5% of the
    values (f32 on both sides: a float difference near a rounding edge moves
    a value by one level; measured on the CPU: stages 1 and 2 at most 1 level
    in 0.03% and 0.04% of the values, stage 3 equal);
  - MAWE within 1e-4 of the JAX value, relative.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import (
    JaxEnhanceDraws,
    Stage1Draws,
    enhance_pair,
    jax_stage1_draws,
    jax_variables,
    port_module,
    random_flat,
    stage1_pair,
    t,
)
from streamingt2v_tpu import native
from streamingt2v_tpu.config import PipelineConfig as JaxPipelineConfig
from streamingt2v_tpu.config import VFIConfig as JaxVFIConfig
from streamingt2v_tpu.models import vfi as jvfi
from streamingt2v_tpu.pipeline.full import StreamingT2VPipeline as JaxProduct
from streamingt2v_tpu.pipeline.interpolate import InterpolatePipeline as JaxInterpolatePipeline
from streamingt2v_tpu.utils import media as jmedia
from streamingt2v_tpu.utils import metrics as jmetrics
from streamingt2v_torch.config import PipelineConfig, VFIConfig
from streamingt2v_torch.models.vfi import MultiScaleFlow
from streamingt2v_torch.pipeline import cli
from streamingt2v_torch.pipeline.full import StreamingT2VPipeline
from streamingt2v_torch.pipeline.interpolate import InterpolatePipeline
from streamingt2v_torch.utils import media, metrics

LEVELS = 2
LEVEL_SHARE = 0.005
MAWE_REL = 1e-4
SEED = 33


# ----------------------------------------------------------------- media ---

def test_fetch_uint8_is_to_uint8():
    rng = np.random.RandomState(0)
    v = rng.uniform(-1.2, 1.2, (3, 7, 9, 3)).astype(np.float32)
    # values on the rounding edges: k + 0.5 levels
    edges = (np.arange(256, dtype=np.float32) + 0.5) / 127.5 - 1.0
    v.reshape(-1)[:256] = edges
    ref = jmedia.to_uint8(v)
    np.testing.assert_array_equal(media.to_uint8(v), ref)
    np.testing.assert_array_equal(media.fetch_uint8(t(v)), ref)
    np.testing.assert_array_equal(media.fetch_uint8(t(v)), jmedia.fetch_uint8(jnp.asarray(v)))
    u = rng.uniform(-0.1, 1.1, (2, 5, 4, 3)).astype(np.float32)
    np.testing.assert_array_equal(media.fetch_uint8(t(u), input_range=(0.0, 1.0)),
                                  jmedia.to_uint8(u, input_range=(0.0, 1.0)))


def test_put_unit_range_and_model_range_match_jax():
    v = np.random.RandomState(1).randint(0, 256, (4, 6, 5, 3)).astype(np.uint8)
    got = media.put_unit_range(v, "cpu")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), v / np.float32(255.0))
    # XLA divides by multiplying with the reciprocal: one ulp of [0, 1] apart
    np.testing.assert_allclose(got.numpy(), np.asarray(jmedia.put_unit_range(v)),
                               rtol=0, atol=6e-8)
    np.testing.assert_array_equal(media.to_model_range(v), jmedia.to_model_range(v))
    np.testing.assert_array_equal(media.to_model_range(torch.from_numpy(v)).numpy(),
                                  jmedia.to_model_range(v))


@pytest.mark.parametrize("src,dst", [
    ((576, 1024), (720, 1280)),   # the product's stage-1 -> stage-2 resize
    ((64, 64), (32, 32)), ((37, 51), (100, 77)), ((100, 160), (64, 96)),
])
def test_resize_video_is_opencv_linear(src, dst):
    rng = np.random.RandomState(src[0])
    noise = rng.randint(0, 256, (1,) + src + (3,)).astype(np.uint8)
    yy, xx = np.meshgrid(np.linspace(0, 6, src[0]), np.linspace(0, 9, src[1]), indexing="ij")
    smooth = np.clip(128 + 100 * np.sin(yy + xx)[..., None] * np.ones(3), 0, 255)
    video = np.concatenate([noise, smooth[None].astype(np.uint8)])
    got = media.resize_video(torch.from_numpy(video), *dst)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), jmedia.resize_video(video, *dst))


def test_y4m_bytes_match_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "available", lambda: False)   # the Python writer
    video = np.random.RandomState(2).randint(0, 256, (3, 8, 12, 3)).astype(np.uint8)
    ours = media.save_video(str(tmp_path / "port.y4m"), video, fps=16)
    ref = jmedia.save_video(str(tmp_path / "jax.y4m"), video, fps=16)
    assert open(ours, "rb").read() == open(ref, "rb").read()
    assert media.y4m_info(ours) == {"width": 12, "height": 8, "fps": 16.0, "frames": 3}
    assert media.video_fps(ours) == 16.0


def test_resize_to_stage1_and_geometry_match_jax():
    rng = np.random.RandomState(3)
    for shape in ((90, 160, 3), (48, 48, 3), (60, 200, 3)):
        img = rng.randint(0, 256, shape).astype(np.uint8)
        np.testing.assert_array_equal(media.resize_to_stage1(img, 64, 96),
                                      jmedia.resize_to_stage1(img, 64, 96))
    img = rng.randint(0, 256, (64, 96, 3)).astype(np.uint8)
    assert media.resize_to_stage1(img, 64, 96) is img     # no resize, no Pillow
    vid = rng.randint(0, 256, (2, 4, 6, 3)).astype(np.uint8)
    for name, args in [("pad", (vid,)), ("crop", (vid, 1, 0, 3, 2)),
                       ("hstack", ([vid, vid],)), ("vstack", ([vid[0], vid[0]],)),
                       ("grid", ([vid[0]] * 3, 2))]:
        kw = dict(top=1, left=2, value=7) if name == "pad" else {}
        np.testing.assert_array_equal(getattr(media, name)(*args, **kw),
                                      getattr(jmedia, name)(*args, **kw))


# --------------------------------------------------------------- product ---

ENH = dict(num_steps=3, height=32, width=32, chunk_size=4, overlap_size=2,
           use_randomized_blending=True, vae_bf16=False)


def _tiny_product_cfg(config_cls, vfi_cls, enhance_cls):
    cfg = config_cls.tiny()
    return dataclasses.replace(
        cfg, use_randomized_blending=True, enhance=enhance_cls(**ENH),
        inference=dataclasses.replace(cfg.inference, vae_decode_bf16=False),
        vfi=dataclasses.replace(vfi_cls.tiny(), tta=True))


@pytest.fixture(scope="module")
def product_pair():
    """(JAX product, port product, JAX stage outputs) on identical weights:
    the tiny stage 1, the tiny enhance of test_torch_port_enhance.py with
    randomized blending, and the tiny VFI with flip-TTA."""
    from streamingt2v_tpu.config import EnhanceConfig as JaxEnhanceConfig
    from streamingt2v_torch.config import EnhanceConfig

    jcfg = _tiny_product_cfg(JaxPipelineConfig, JaxVFIConfig, JaxEnhanceConfig)
    cfg = _tiny_product_cfg(PipelineConfig, VFIConfig, EnhanceConfig)
    jstage1, stage1 = stage1_pair(jcfg, cfg, seed=10)
    jenhance, enhance = enhance_pair(ENH)
    jvfi_mod = jvfi.MultiScaleFlow(jcfg.vfi)
    img = jnp.zeros((1, 32, 32, 3))
    flat = random_flat(jax.eval_shape(lambda: jvfi_mod.init(jax.random.PRNGKey(0), img, img))
                       ["params"], 20)
    jinterp = JaxInterpolatePipeline(jvfi_mod, jax_variables(flat), tta=True)
    interp = InterpolatePipeline(port_module(MultiScaleFlow(cfg.vfi), flat), tta=True)
    jpipe = JaxProduct(jcfg, jstage1, jenhance, jinterp, offload_between_stages=False)
    pipe = StreamingT2VPipeline(cfg, stage1, enhance, interp)

    image = (np.random.RandomState(0).rand(48, 48, 3) * 255).astype(np.uint8)
    ref = {"stage1": jpipe.image_to_video(image, seed=SEED)}
    ref["enhance"] = jpipe.enhance_video(ref["stage1"], image, seed=SEED)
    ref["vfi"] = jpipe.interpolate_video(ref["enhance"])
    return jpipe, pipe, image, ref, (jvfi_mod, jax_variables(flat))


def _levels(got, ref, what):
    assert got.dtype == np.uint8 and got.shape == ref.shape, (what, got.shape, ref.shape)
    d = np.abs(got.astype(np.int16) - ref.astype(np.int16))
    assert ref.std() > 10, what     # not a flat video
    assert d.max() <= LEVELS and np.mean(d > 0) <= LEVEL_SHARE, (
        f"{what}: {d.max()} levels at most, {np.mean(d > 0):.4f} of the values differ")


def test_tiny_product_matches_jax(product_pair, tmp_path):
    """Each stage from the JAX package's uint8 output of the stage before,
    with the JAX draws injected: the stage's own error, not the carried one."""
    jpipe, pipe, image, ref, _ = product_pair
    cfg = pipe.cfg
    assert ref["stage1"].shape == (cfg.stage1_frames, 64, 64, 3)
    n_gen = cfg.n_autoregressions(cfg.stage1_frames)
    noise = Stage1Draws(jax_stage1_draws(
        jpipe.cfg, SEED, pipe.stage1.latent_shape(cfg.inference.chunk_frames),
        (1, cfg.height, cfg.width, 3), n_gen))
    _levels(pipe.image_to_video(image, seed=SEED, noise=noise), ref["stage1"], "stage 1")
    assert sorted(noise.used) == sorted(noise.draws)
    draws = JaxEnhanceDraws(SEED)
    _levels(pipe.enhance_video(ref["stage1"], image, seed=SEED, noise=draws),
            ref["enhance"], "stage 2")
    assert any(u[0] == "offset" for u in draws.used)     # blended chunks ran
    got = pipe.interpolate_video(ref["enhance"])
    assert got.shape == (cfg.num_frames, 32, 32, 3)
    _levels(got, ref["vfi"], "stage 3")
    assert pipe.stage_finite == {"stage1": True, "enhance": True, "vfi": True}


def test_tiny_product_runs_end_to_end(product_pair, tmp_path):
    """``run`` on an image array with the port's own draws: a y4m of
    num_frames frames at the stage-2 size, carried through the stages; the
    same seed gives the same frames."""
    _, pipe, image, ref, _ = product_pair
    out = pipe.run(image, str(tmp_path / "out.y4m"), seed=SEED)
    assert out.shape == ref["vfi"].shape and out.dtype == np.uint8
    assert media.y4m_info(str(tmp_path / "out.y4m")) == {
        "width": 32, "height": 32, "fps": float(pipe.cfg.out_fps), "frames": pipe.cfg.num_frames}
    np.testing.assert_array_equal(pipe.run(image, str(tmp_path / "again.y4m"), seed=SEED), out)
    assert set(pipe.stage_finite) == {"stage1", "enhance", "vfi"}


def _run_all_stages(pipe, image, seed: int) -> np.ndarray:
    video = pipe.image_to_video(image, seed=seed)
    return pipe.interpolate_video(pipe.enhance_video(video, image, seed=seed))


def test_full_three_stage_bitwise_determinism(product_pair):
    """The port's counterpart of ``tests/test_e2e_determinism.py``'s test of
    the same name: the tiny three-stage product twice with one seed gives
    the same uint8 frames, and another seed other frames (the draws are
    live)."""
    _, pipe, image, _, _ = product_pair
    first = _run_all_stages(pipe, image, SEED)
    assert first.shape[0] == pipe.cfg.num_frames and first.dtype == np.uint8
    np.testing.assert_array_equal(_run_all_stages(pipe, image, SEED), first)
    assert not np.array_equal(_run_all_stages(pipe, image, SEED + 1), first)


def test_mawe_matches_jax(product_pair):
    _, pipe, _, ref, (jmod, jvars) = product_pair
    video = ref["vfi"].astype(np.float32) / 255.0
    want = float(jmetrics.mawe(jnp.asarray(video), jmetrics.vfi_flow_fn(jmod, jvars)))
    flow_fn = metrics.vfi_flow_fn(pipe.interpolate.model)
    got = float(metrics.mawe(t(video), flow_fn))
    assert np.isfinite(want) and want > 0
    assert abs(got - want) <= MAWE_REL * want, (got, want)
    chunked = metrics.mawe_chunked(video, flow_fn, pairs_per_call=4, device="cpu")
    assert abs(chunked - want) <= MAWE_REL * want, (chunked, want)


# ------------------------------------------------------------------- CLI ---

@pytest.fixture
def input_png(tmp_path):
    from PIL import Image

    path = str(tmp_path / "input.png")
    Image.fromarray((np.random.RandomState(0).rand(90, 160, 3) * 255).astype(np.uint8)).save(path)
    return path


@pytest.mark.parametrize("container", ["mp4", "y4m"])
def test_cli_tiny_writes_the_stage1_video(tmp_path, input_png, container, capsys):
    out_dir = str(tmp_path / "results")
    rc = cli.main(["--input", input_png, "--output", out_dir, "--tiny", "--num_frames", "8",
                   "--out_fps", "8", "--device", "cpu", "--container", container])
    assert rc == 0
    path = os.path.join(out_dir, f"input.{container}")
    frames = (media.load_video(path).shape[0] if container == "mp4"
              else media.y4m_info(path)["frames"])
    assert frames == (8 + 1) // 2     # stage 1 only
    assert '"stage1_i2v"' in capsys.readouterr().out     # the timing report


def test_cli_set_overrides_the_config():
    args = cli.build_parser().parse_args([
        "--input", "x", "--num_frames", "40", "--use_randomized_blending",
        "--set", "sampler.num_steps=7", "--set", "inference.fps_id=3",
        "--set", "enhance.strength=0.5"])
    cfg = cli.build_config(args)
    assert (cfg.sampler.num_steps, cfg.inference.fps_id, cfg.enhance.strength) == (7, 3, 0.5)
    assert cfg.num_frames == 40 and cfg.enhance.use_randomized_blending
    tiny = cli.build_config(cli.build_parser().parse_args(
        ["--input", "x", "--tiny", "--set", "vfi.tta=true"]))
    assert tiny.height == 64 and tiny.vfi.tta
    with pytest.raises(AttributeError, match="no field 'bogus'"):
        cli.build_config(cli.build_parser().parse_args(["--input", "x", "--set", "bogus=1"]))


@pytest.mark.parametrize("flag,value,what", [("--mesh", "2,1,1", "multi-device")])
def test_cli_unported_flags_raise(input_png, tmp_path, flag, value, what):
    """A multi-device mesh in a world of one process (no torchrun) is
    refused before anything runs (the mesh run itself:
    tests/test_torch_port_parallel.py)."""
    with pytest.raises(ValueError, match=what):
        cli.main(["--input", input_png, "--output", str(tmp_path), "--tiny", "--device", "cpu",
                  flag, value])
    assert not [p for p in os.listdir(tmp_path) if p.endswith((".mp4", ".y4m"))]


def test_cli_ckpt_dir_runs_from_the_tree(input_png, tmp_path, capsys):
    """``--ckpt_dir --tiny``: stage 1 loaded from a reference-named tree
    written from a pipeline built in memory; the file is the one that
    pipeline writes, byte for byte."""
    import chip_smoke
    from streamingt2v_torch.pipeline.build import build_pipeline

    tree, out_dir = str(tmp_path / "ckpt"), str(tmp_path / "results")
    argv = ["--input", input_png, "--output", out_dir, "--tiny", "--num_frames", "8",
            "--device", "cpu", "--container", "y4m", "--seed", "5", "--ckpt_dir", tree]
    cfg = cli.build_config(cli.build_parser().parse_args(argv))
    stage1 = build_pipeline(cfg, seed=9, device="cpu")     # not the weights --seed draws
    # but the tiny config's toy CLIP projection, which no checkpoint holds
    stage1.models.conditioner.toy_clip.load_state_dict(
        build_pipeline(cfg, seed=5, device="cpu").models.conditioner.toy_clip.state_dict())
    chip_smoke.write_reference_tree(tree, stage1=stage1)
    assert cli.main(argv) == 0
    assert '"load_streamingsvd"' in capsys.readouterr().out
    ref = str(tmp_path / "ref.y4m")
    StreamingT2VPipeline(cfg, stage1)(input_png, ref, seed=5)
    got = os.path.join(out_dir, "input.y4m")
    assert media.y4m_info(got)["frames"] == (8 + 1) // 2
    assert open(got, "rb").read() == open(ref, "rb").read()


# --------------------------------------------------------------- timers ---

def test_stage_timer_reports_and_traces(tmp_path, monkeypatch):
    """Each timed stage adds a call to the report; with
    STREAMINGT2V_TRACE_DIR set, each also leaves a Chrome trace there."""
    import json

    from streamingt2v_torch.utils import profiling

    saved = dict(profiling._STAGE_TIMES)
    profiling.reset_timers()
    try:
        with profiling.stage_timer("a"):
            torch.ones(8).sum()
        monkeypatch.setenv("STREAMINGT2V_TRACE_DIR", str(tmp_path))
        with profiling.stage_timer("a"):
            torch.ones(8).cumsum(0)
        report = profiling.timing_report()
        assert report["a"]["calls"] == 2 and report["a"]["total_s"] >= report["a"]["last_s"]
        trace = json.loads((tmp_path / "a.2.json").read_text())
        assert trace["traceEvents"]
        profiling.reset_timers()
        assert profiling.timing_report() == {}
    finally:
        profiling._STAGE_TIMES.update(saved)
