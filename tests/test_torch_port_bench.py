"""PyTorch port, the bench (``streamingt2v_torch/bench.py``) on the CPU at
tiny configs:
  - the denoise mode's three chained guided steps against the same chain
    built from the JAX package's ``streaming_wrapper`` and ``denoise`` (the
    JAX bench's ``k_steps``, bench.py:217-228), on the same weights and
    inputs, f32: within 5e-4 max-abs (the stage-1 slice's tolerance,
    tests/test_torch_port_stage1.py);
  - the vae mode's round trip (8-frame encode pieces, 4-frame temporal
    decode pieces) against the JAX ``AutoencoderKL`` in the JAX bench's
    pieces with the same encode noise, f32: within 1e-4 of max |reference|
    (the models' tolerance, tests/test_torch_port_models.py);
  - each mode end to end on the CPU, the full mode on the tiny product of
    tests/test_torch_port_product.py (same seed bitwise equal, another seed
    different, finite stages, MAWE, the frame count, the y4m files);
  - the records (emit, the replay, the source hash) and the metric line
    last;
  - the default device is the card: without one every mode raises.
"""

import dataclasses
import json
import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import (
    TEXT_TINY,
    TINY_ENHANCE,
    flat_for,
    jax_variables,
    port_module,
    t,
    tiny_product_pair,
)
from streamingt2v_tpu import config as jcfg
from streamingt2v_tpu.diffusion import denoiser as jden
from streamingt2v_tpu.models import controlnet as jcn
from streamingt2v_tpu.models import vae as jvae
from streamingt2v_tpu.models import video_unet as jvu
from streamingt2v_tpu.models import wrappers as jwrap
from streamingt2v_torch import bench
from streamingt2v_torch import config as pcfg
from streamingt2v_torch.models import controlnet as pcn
from streamingt2v_torch.models import vae as pvae
from streamingt2v_torch.models import video_unet as pvu
from streamingt2v_torch.models import wrappers as pwrap
from streamingt2v_torch.utils import media

DENOISE_ATOL = 5e-4
VAE_REL = 1e-4
FRAMES, LATENT = 5, 8        # the tiny denoise geometry: 5 frames of 8x8 latents
CPU = torch.device("cpu")


def _lines(capsys) -> list:
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()]


# ------------------------------------------------------- against the JAX bench ---

def test_denoise_chain_matches_jax():
    ucfg, ccfg = jcfg.VideoUNetConfig.tiny(), jcfg.ControlNetConfig.tiny()
    pucfg, pccfg = pcfg.VideoUNetConfig.tiny(), pcfg.ControlNetConfig.tiny()
    host = bench.denoise_inputs(pucfg, pccfg, FRAMES, LATENT, LATENT)
    b, fc = host["concat"].shape[0], ccfg.num_conditional_frames
    assert host["ctrl_frames"].shape == (b, fc, 2 * LATENT, 2 * LATENT, 3)

    junet, jcnet = jvu.VideoUNet(ucfg), jcn.ControlNet(ucfg, ccfg)
    x0 = jnp.zeros((1, 2, LATENT, LATENT, ucfg.in_channels))
    args = (jnp.zeros((1,)), jnp.zeros((1, 2, 1, ucfg.context_dim)),
            jnp.zeros((1, 2, ucfg.adm_in_channels)))
    uflat = flat_for(junet, x0, *args, seed=1)
    cflat = flat_for(jcnet, x0, *args, jnp.zeros((1, 2, 2 * LATENT, 2 * LATENT, 3)), seed=2)

    @jax.jit
    def k_steps(x, cond):
        net = jwrap.streaming_wrapper(junet, jax_variables(uflat), jcnet, jax_variables(cflat),
                                      fc, ctrl_cfg_shared=True)

        def body(xc, i):
            sigma = jnp.full((b,), 2.0) / (1.0 + 0.1 * i)
            den = jden.denoise(net, jnp.concatenate([xc, xc], 0), sigma, cond)
            return den[:1] * 0.05 + xc * 0.95, None

        out, _ = jax.lax.scan(body, x, jnp.arange(bench.CHAINED_STEPS))
        return out

    cond = {k: v for k, v in host.items() if k != "x"}
    ref = np.asarray(k_steps(jnp.asarray(host["x"]), {k: jnp.asarray(v) for k, v in cond.items()}))

    net = pwrap.streaming_wrapper(port_module(pvu.VideoUNet(pucfg), uflat),
                                  port_module(pcn.ControlNet(pucfg, pccfg), cflat), fc,
                                  ctrl_cfg_shared=True)
    with torch.inference_mode():
        got = bench.denoise_chain(net, t(host["x"]), {k: t(v) for k, v in cond.items()})
    assert got.shape == ref.shape and got.dtype == torch.float32
    assert np.abs(ref - host["x"]).max() > 100 * DENOISE_ATOL     # the steps moved x
    err = float(np.abs(got.numpy() - ref).max())
    assert err <= DENOISE_ATOL, f"denoise chain max-abs err {err:.3e} > {DENOISE_ATOL}"


def test_vae_roundtrip_matches_jax():
    vcfg = jcfg.VAEConfig.tiny()
    jm = jvae.AutoencoderKL(vcfg)
    flat = flat_for(jm, jnp.zeros((1, 2, 32, 32, 3)), seed=3)
    frames, hw = 16, 32
    chunk = (np.random.RandomState(0).rand(1, frames, hw, hw, 3) * 2 - 1).astype(np.float32)
    key = jax.random.PRNGKey(1)

    # the JAX bench's round trip (bench.py:269-281): one key for every piece
    @jax.jit
    def roundtrip(params, x, key):
        zs = []
        for i in range(0, frames, 8):
            xe = x[:, i:i + 8].reshape((-1,) + x.shape[2:])
            zi = jm.apply(params, xe, key, method="encode")
            zs.append(zi.reshape((1, -1) + zi.shape[1:]))
        z = jnp.concatenate(zs, axis=1)
        return jnp.concatenate([jm.apply(params, z[:, i:i + 4], method="decode")
                                for i in range(0, frames, 4)], axis=1)

    ref = np.asarray(roundtrip(jax_variables(flat), jnp.asarray(chunk), key))
    shapes = []

    def noise(shape):
        shapes.append(shape)
        return t(jax.random.normal(key, shape, jnp.float32))

    vae = port_module(pvae.AutoencoderKL(pcfg.VAEConfig.tiny()), flat)
    with torch.inference_mode():
        got = bench.vae_roundtrip(vae, t(chunk), noise)
        mode = bench.vae_roundtrip(vae, t(chunk), lambda shape: None)
    f = vcfg.downsample_factor
    assert shapes == [(8, hw // f, hw // f, vcfg.z_channels)] * 2
    assert got.shape == chunk.shape
    assert float((got - mode).abs().max()) > 1e-2      # the noise reached the latents
    scale = float(np.abs(ref).max())
    err = float(np.abs(got.numpy() - ref).max())
    assert err <= VAE_REL * scale, f"vae round trip max-abs err {err:.3e} > {VAE_REL} x {scale}"


# --------------------------------------------------- each mode on the CPU ---

def _check_record(rec: dict, metric: str, lines: list, calls: int) -> None:
    assert rec["metric"] == metric and lines[-1] == rec
    assert math.isfinite(rec["value"]) and rec["value"] > 0 and rec["unit"] == "frames/s"
    baseline = bench.BASELINES[{"stage1_denoise_frames_per_sec_per_chip": "denoise",
                                "vae_roundtrip_frames_per_sec_per_chip": "vae",
                                "stage1_autoregressive_frames_per_sec_per_chip": "stage1",
                                "enhance_frames_per_sec_per_chip": "enhance"}[metric]]
    # both rounded from the unrounded value: 3 and 2 decimals
    assert abs(rec["vs_baseline"] - rec["value"] / baseline) <= 0.005 + 0.0005 / baseline
    assert len(rec["seconds"]) == calls and rec["median_s"] > 0 and rec["spread"] >= 0
    # the CPU takes the plain versions: no kernel launches, no device memory
    assert rec["device"] == "cpu" and "peak_hbm_gb" not in rec
    assert set(rec["launches"]) >= {"flash_attention", "geglu_ff", "temporal_conv"}
    assert not any(rec["launches"].values())


def test_bench_denoise_runs_on_the_cpu(tmp_path, capsys):
    rec = bench.bench_denoise("cpu", pcfg.VideoUNetConfig.tiny(), pcfg.ControlNetConfig.tiny(),
                              frames=FRAMES, height=LATENT, width=LATENT, dtype=torch.float32,
                              records=str(tmp_path / "records.json"))
    _check_record(rec, "stage1_denoise_frames_per_sec_per_chip", _lines(capsys),
                  bench.TIMED_CALLS)
    assert rec["chained_steps"] == bench.CHAINED_STEPS
    # frames / (median step x 30)
    step = rec["median_s"] / bench.CHAINED_STEPS
    assert abs(rec["value"] - FRAMES / (step * bench.STEPS_PER_CHUNK)) <= 1e-3 * rec["value"] + 1e-3


def test_bench_vae_runs_on_the_cpu(tmp_path, capsys):
    rec = bench.bench_vae("cpu", pcfg.VAEConfig.tiny(), frames=16, height=32, width=32,
                          records=str(tmp_path / "records.json"))
    _check_record(rec, "vae_roundtrip_frames_per_sec_per_chip", _lines(capsys),
                  bench.TIMED_CALLS)


def test_bench_stage1_runs_on_the_cpu(tmp_path, capsys):
    cfg = pcfg.PipelineConfig.tiny()
    rec = bench.bench_stage1("cpu", cfg, records=str(tmp_path / "records.json"))
    _check_record(rec, "stage1_autoregressive_frames_per_sec_per_chip", _lines(capsys), 1)
    assert rec["stage_finite"] is True
    assert abs(rec["value"] - cfg.stage1_frames / rec["median_s"]) <= 1e-3 * rec["value"] + 1e-3


def test_bench_enhance_runs_on_the_cpu(tmp_path, capsys):
    from streamingt2v_torch.models.clip import CLIPVisionConfig
    from streamingt2v_torch.models.clip_text import CLIPTextConfig
    from streamingt2v_torch.models.enhance.unet import I2VGenXLUNetConfig

    cfg = pcfg.EnhanceConfig(**TINY_ENHANCE)
    rec = bench.bench_enhance(
        "cpu", cfg, records=str(tmp_path / "records.json"), bf16=False,
        unet=I2VGenXLUNetConfig.tiny(),
        vae=dataclasses.replace(pcfg.VAEConfig.tiny(), temporal_decoder=False),
        clip_vision=CLIPVisionConfig.tiny(), text=CLIPTextConfig(**TEXT_TINY), tokenizer_length=8)
    _check_record(rec, "enhance_frames_per_sec_per_chip", _lines(capsys), 1)
    frames = 2 * (cfg.chunk_size - cfg.overlap_size) + cfg.overlap_size
    assert abs(rec["value"] - frames / rec["median_s"]) <= 1e-3 * rec["value"] + 1e-3


def test_bench_full_on_the_tiny_product(tmp_path, capsys):
    _, pipe, _ = tiny_product_pair()
    records = tmp_path / "records.json"
    out = bench.bench_full("cpu", pipe.cfg, pipe=pipe, out_dir=str(tmp_path / "bench"),
                           records=str(records))
    lines = _lines(capsys)
    assert lines == out
    stage1, det, full = out
    assert stage1["metric"] == "stage1_autoregressive_frames_per_sec_per_chip"
    assert det["metric"] == "product_run_determinism" and det["value"] == 1.0
    assert det["same_seed_bitwise_identical"] is True
    assert det["different_seed_differs"] is True
    assert det["all_stage_outputs_finite"] is True
    assert math.isfinite(det["mawe_random_weights"]) and det["mawe_random_weights"] > 0
    n = pipe.cfg.num_frames
    assert det["frames"] == n == 12
    assert full["metric"] == "full_pipeline_frames_per_sec_per_chip" and lines[-1] == full
    assert abs(full["value"] - n / min(full["seconds"])) <= 1e-3 * full["value"] + 1e-3
    assert set(full["stages"]) >= {"stage1_i2v", "stage2_enhance", "stage3_vfi"}
    files = sorted((tmp_path / "bench").glob("*.y4m"))
    assert [f.name for f in files] == [f"bench_full_{n}f{s}.y4m"
                                       for s in ("", "_pass2", "_seed34")]
    for f in files:
        assert media.y4m_info(str(f)) == {"width": 32, "height": 32,
                                          "fps": float(pipe.cfg.out_fps), "frames": n}
    assert files[0].read_bytes() == files[1].read_bytes() != files[2].read_bytes()
    assert set(json.loads(records.read_text())) == {m["metric"] for m in out}


# ------------------------------------------------------------- records ---

def test_emit_replay_and_the_live_metric_last(tmp_path, monkeypatch, capsys):
    path = tmp_path / "records.json"
    rec = bench.emit("vae_roundtrip_frames_per_sec_per_chip", 3.0, "frames/s",
                     bench.BASELINES["vae"], CPU, str(path), median_s=1.0)
    assert _lines(capsys) == [rec]
    assert rec["vs_baseline"] == round(3.0 / 7.7, 2) and rec["device"] == "cpu"
    stored = json.loads(path.read_text())
    assert stored[rec["metric"]]["src"] == bench.src_hash()
    assert stored[rec["metric"]]["median_s"] == 1.0 and "recorded_at" in stored[rec["metric"]]
    # a record measured on other code, and an old record of the live metric
    stored["enhance_frames_per_sec_per_chip"] = dict(metric="enhance_frames_per_sec_per_chip",
                                                     value=0.5, src="0" * 12)
    stored["stage1_denoise_frames_per_sec_per_chip"] = dict(
        metric="stage1_denoise_frames_per_sec_per_chip", value=0.1, src="0" * 12)
    path.write_text(json.dumps(stored))

    def live(records):
        return bench.emit("stage1_denoise_frames_per_sec_per_chip", 0.9, "frames/s",
                          bench.BASELINES["denoise"], CPU, records)

    monkeypatch.setattr(bench, "RECORDS_PATH", str(path))
    monkeypatch.setattr(bench, "bench_denoise", live)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    bench.main([])
    lines = _lines(capsys)
    assert lines[-1]["metric"] == "stage1_denoise_frames_per_sec_per_chip"
    assert lines[-1]["value"] == 0.9 and "recorded" not in lines[-1]
    replayed = {r["metric"]: r for r in lines[:-1]}
    assert set(replayed) == {"vae_roundtrip_frames_per_sec_per_chip",
                             "enhance_frames_per_sec_per_chip"}
    assert all(r["recorded"] is True for r in replayed.values())
    assert replayed["enhance_frames_per_sec_per_chip"]["code_changed_since_record"] is True
    assert "code_changed_since_record" not in replayed["vae_roundtrip_frames_per_sec_per_chip"]
    assert json.loads(path.read_text())["stage1_denoise_frames_per_sec_per_chip"]["value"] == 0.9


def test_src_hash_covers_the_port_sources_only(tmp_path, monkeypatch):
    pkg = tmp_path / "pkg"
    (pkg / "csrc").mkdir(parents=True)
    (pkg / "_build").mkdir()
    for name, text in (("bench.py", "a"), ("csrc/k.cu", "b"), ("csrc/k.cuh", "c"),
                       ("notes.md", "d"), ("_build/k.cu", "e")):
        (pkg / name).write_text(text)
    monkeypatch.setattr(bench, "__file__", str(pkg / "bench.py"))
    first = bench.src_hash()
    for name in ("notes.md", "_build/k.cu"):
        (pkg / name).write_text("changed")
        assert bench.src_hash() == first, name
    for name in ("csrc/k.cu", "csrc/k.cuh", "bench.py"):
        (pkg / name).write_text(pathlib.Path(pkg / name).read_text() + "changed")
        assert bench.src_hash() != first, name
        first = bench.src_hash()


# ------------------------------------------------------- device default ---

@pytest.mark.parametrize("mode", ["bench_denoise", "bench_vae", "bench_stage1", "bench_enhance",
                                  "bench_full"])
def test_the_default_device_is_the_card(mode, monkeypatch):
    """Without a card each mode raises before it builds anything; it does
    not fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    started = []
    monkeypatch.setattr(bench, "_start", started.append)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(bench, mode)(records=None)
    assert started == []


def test_the_command_line_needs_the_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        bench.main(["--mode", "vae"])
    assert capsys.readouterr().out == ""
