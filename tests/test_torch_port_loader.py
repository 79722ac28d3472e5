"""PyTorch port, the checkpoint loader: the safetensors reader against the
``safetensors`` package, every map against the JAX package's on a
reference-named tree at tiny width, each map's coverage at production width
on ``device="meta"``, the loader entry points of stages 1 and 3 through both
packages, stage 2's tree (weights, scheduler config, BPE tokenizer) and the
errors that name the key at fault.

The trees are written by ``chip_smoke.write_reference_tree`` (each map
entry inverted onto the port's tensors).  Every weight here is f32 and every
transform moves values without arithmetic, so every comparison is exact:
bit for bit.
"""

import argparse
import dataclasses
import inspect
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from _torch_port_helpers import TEXT_TINY, enhance_pair, random_flat, stage1_pair
from streamingt2v_tpu.utils import checkpoint as jck
from streamingt2v_tpu.utils import checkpoint_diffusers as jckd
from streamingt2v_tpu.utils import checkpoint_vfi as jckv
from streamingt2v_tpu.utils import loader as jloader
from streamingt2v_torch.utils import checkpoint as ck
from streamingt2v_torch.utils import checkpoint_diffusers as ckd
from streamingt2v_torch.utils import checkpoint_vfi as ckv
from streamingt2v_torch.utils import loader
from streamingt2v_torch.utils.weights import from_jax_params, load_jax_params


def _keys(tk) -> tuple:
    return tk if isinstance(tk, tuple) else (tk,)


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.contiguous().view(-1).view(torch.uint8),
                            b.contiguous().view(-1).view(torch.uint8)))


def _assert_state_equal(got: dict, want: dict, what: str, skip: tuple = ()) -> None:
    """Same keys (but those starting with ``skip``), each the same bits."""
    keys = {k for k in want if not k.startswith(skip)}
    assert {k for k in got if not k.startswith(skip)} == keys, what
    for k in sorted(keys):
        assert _bits_equal(got[k], want[k]), f"{what}: {k}"


# ----------------------------------------------------------- the reader ---

def _tensor(dtype: torch.dtype, shape, seed: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    if dtype == torch.int64:
        return torch.randint(-2**40, 2**40, shape, generator=g, dtype=dtype)
    return torch.randn(shape, generator=g).to(dtype)


@pytest.mark.parametrize("dtype,shape", [
    (torch.float32, (3, 5)), (torch.float16, (7,)), (torch.bfloat16, (2, 3, 4)),
    (torch.int64, (4, 2)), (torch.float32, (0, 3))])
def test_read_safetensors_matches_the_package(tmp_path, dtype, shape):
    """Files written by ``safetensors`` (its numpy writer; its torch writer for
    BF16, which numpy lacks) read back equal, beside tensors of other dtypes
    and an odd byte count; the tree writer's files read back equal through
    ``safetensors``."""
    import safetensors.numpy
    import safetensors.torch

    tensors = {"x.weight": _tensor(dtype, shape, 0), "odd": _tensor(torch.float16, (3,), 1),
               "step": _tensor(torch.int64, (), 2)}
    path = str(tmp_path / "ref.safetensors")
    if dtype == torch.bfloat16:
        safetensors.torch.save_file(tensors, path)
    else:
        safetensors.numpy.save_file({k: v.numpy() for k, v in tensors.items()}, path)
    got = ck.read_safetensors(path)
    assert set(got) == set(tensors)
    for k, v in tensors.items():
        assert _bits_equal(got[k], v), k
    ours = str(tmp_path / "ours.safetensors")
    assert chip_smoke.write_safetensors(ours, tensors) == os.path.getsize(ours)
    back = safetensors.torch.load_file(ours)
    for k, v in tensors.items():
        assert _bits_equal(back[k], v), k
    if dtype != torch.bfloat16:
        np.testing.assert_array_equal(safetensors.numpy.load_file(ours)["x.weight"],
                                      tensors["x.weight"].numpy())


def test_reader_errors_name_the_file_and_key(tmp_path):
    path = str(tmp_path / "cut.safetensors")
    n = chip_smoke.write_safetensors(path, {"a.weight": torch.ones(4, 4),
                                            "z.bias": torch.ones(100)})
    with open(path, "r+b") as f:
        f.truncate(n - 8)       # the last tensor loses its end
    with pytest.raises(ValueError, match="tensor z.bias"):
        ck.read_safetensors(path)
    (tmp_path / "head.safetensors").write_bytes((1000).to_bytes(8, "little") + b"{}")
    with pytest.raises(ValueError, match="runs past the end"):
        ck.read_safetensors(str(tmp_path / "head.safetensors"))
    (tmp_path / "tiny.safetensors").write_bytes(b"abc")
    with pytest.raises(ValueError, match="too short"):
        ck.read_safetensors(str(tmp_path / "tiny.safetensors"))


def test_load_torch_file_pickles(tmp_path):
    """``state_dict`` unwrapped; zip and legacy archives; anything but
    tensors raises."""
    sd = {"a.weight": _tensor(torch.float32, (2, 3), 0), "b": _tensor(torch.bfloat16, (5,), 1)}
    torch.save({"state_dict": sd}, tmp_path / "zip.ckpt")
    torch.save(sd, tmp_path / "legacy.pkl", _use_new_zipfile_serialization=False)
    for name in ("zip.ckpt", "legacy.pkl"):
        got = ck.load_torch_file(str(tmp_path / name))
        assert set(got) == set(sd)
        for k in sd:
            assert _bits_equal(got[k], sd[k]), (name, k)
    torch.save(dict(sd, step=3), tmp_path / "step.bin")
    with pytest.raises(ValueError, match="not tensors: \\['step'\\]"):
        ck.load_torch_file(str(tmp_path / "step.bin"))
    torch.save(dict(sd, args=argparse.Namespace(lr=1.0)), tmp_path / "obj.bin")
    with pytest.raises(ValueError, match="other than tensors"):
        ck.load_torch_file(str(tmp_path / "obj.bin"))


def test_convert_state_dict_errors_name_the_key():
    from streamingt2v_torch.models.layers import Dense

    mapping = {"kernel": ("fc.weight", ck.t_id), "bias": ("fc.bias", ck.t_id)}
    good = {"fc.weight": torch.ones(4, 3), "fc.bias": torch.ones(4), "extra.x": torch.ones(1)}
    dense = Dense(3, 4, device="cpu")
    assert ck.convert_state_dict(good, mapping, dense) == ["extra.x"]
    with pytest.raises(ValueError, match="shape mismatch for kernel <- fc.weight"):
        ck.convert_state_dict(dict(good, **{"fc.weight": torch.ones(3, 4)}), mapping, dense)
    with pytest.raises(KeyError, match="'fc.bias'.*for bias"):
        ck.convert_state_dict({"fc.weight": torch.ones(4, 3)}, mapping, dense)
    with pytest.raises(KeyError, match="no mapping for parameter bias"):
        ck.convert_state_dict(good, {"kernel": mapping["kernel"]}, dense)
    with pytest.raises(ValueError, match="cannot transform.*for kernel"):
        ck.convert_state_dict(good, dict(mapping, kernel=("fc.weight", ck.t_conv3d)), dense)


def test_resolve_ckpt_local_and_missing(tmp_path):
    f = tmp_path / "x.safetensors"
    f.write_bytes(b"")
    assert loader.resolve_ckpt(str(f)) == str(f)
    with pytest.raises(FileNotFoundError, match="Download it out-of-band.*some/source"):
        loader.resolve_ckpt(str(tmp_path / "missing.pkl"), "some/source")


# ----------------------------------------------------------- the maps ---

def _stage1_templates(size: str):
    from streamingt2v_tpu.config import PipelineConfig as JaxPipelineConfig
    from streamingt2v_tpu.pipeline.build import build_pipeline as jax_build_pipeline
    from streamingt2v_tpu.pipeline.build import stage1_param_factory

    jcfg = JaxPipelineConfig.tiny() if size == "tiny" else JaxPipelineConfig()
    jpipe = jax_build_pipeline(jcfg, seed=0, lazy=True)
    return jcfg, stage1_param_factory(jcfg, jax.random.PRNGKey(0), jpipe.models)


def _case(name: str, size: str, device: str):
    """(JAX map, JAX parameter shapes, port map, port module built
    uninitialised on ``device`` in f32) of one map use at ``size``."""
    from streamingt2v_tpu import config as jconf
    from streamingt2v_tpu.models import clip as jclip
    from streamingt2v_tpu.models import clip_text as jtext
    from streamingt2v_tpu.models import vae as jvae
    from streamingt2v_tpu.models import vfi as jvfi
    from streamingt2v_tpu.models.enhance import unet as junet
    from streamingt2v_torch import config as pconf
    from streamingt2v_torch.models import clip as pclip
    from streamingt2v_torch.models import clip_text as ptext
    from streamingt2v_torch.models import vae as pvae
    from streamingt2v_torch.models import vfi as pvfi
    from streamingt2v_torch.models.enhance import unet as punet
    from streamingt2v_torch.pipeline.build import build_models

    tiny = size == "tiny"
    fk = dict(device=device, dtype=torch.float32)
    key = jax.random.PRNGKey(0)

    def shapes(module, *args):
        return jax.eval_shape(lambda: module.init(key, *args))["params"]

    stage1 = {"unet_cam": "unet", "controlnet": "controlnet", "temporal_vae": "vae",
              "cond_encoder": "conditioner", "svd_xt_unet": "svd_unet"}
    if name in stage1:
        jcfg, thunks = _stage1_templates(size)
        pcfg = pconf.PipelineConfig.tiny() if tiny else pconf.PipelineConfig()
        models = build_models(pcfg, device=device, init=False)
        field = stage1[name]
        tmpl = jax.eval_shape(thunks[field + "_params"])["params"]
        module = getattr(models, field)
        if name == "unet_cam":
            return jck.unet_map(jcfg.unet), tmpl, ck.unet_map(pcfg.unet), module
        if name == "controlnet":
            return (jck.controlnet_map(jcfg.unet, jcfg.controlnet), tmpl,
                    ck.controlnet_map(pcfg.unet, pcfg.controlnet), module)
        if name == "temporal_vae":
            return (jck.vae_map(jcfg.vae, torch_prefix="first_stage_model"), tmpl,
                    ck.vae_map(pcfg.vae, torch_prefix="first_stage_model"), module)
        if name == "cond_encoder":
            prefix = "conditioner.embedders.3.encoder"
            jv = dataclasses.replace(jcfg.vae, temporal_decoder=False, scale_factor=1.0)
            pv = dataclasses.replace(pcfg.vae, temporal_decoder=False, scale_factor=1.0)
            return (jck.vae_map(jv, torch_prefix=prefix, use_quant_conv=True),
                    tmpl["cond_encoder"],
                    ck.vae_map(pv, torch_prefix=prefix, use_quant_conv=True),
                    module.cond_encoder)
        return (jckd.svd_unet_map(dataclasses.replace(jcfg.unet, controlnet_mode=False)), tmpl,
                ckd.svd_unet_map(dataclasses.replace(pcfg.unet, controlnet_mode=False)), module)
    if name in ("clip_visual", "hf_clip_vision"):
        jc = jclip.CLIPVisionConfig.tiny() if tiny else jclip.CLIPVisionConfig()
        pc = pclip.CLIPVisionConfig.tiny() if tiny else pclip.CLIPVisionConfig()
        tmpl = shapes(jclip.CLIPVisionTower(jc), jnp.zeros((1, jc.image_size, jc.image_size, 3)))
        if name == "clip_visual":
            prefix = "conditioner.embedders.0.open_clip.model.visual"
            jmap, pmap = jck.clip_visual_map(jc, prefix), ck.clip_visual_map(pc, prefix)
        else:
            jmap, pmap = jckd.hf_clip_vision_map(jc), ckd.hf_clip_vision_map(pc)
        return jmap, tmpl, pmap, pclip.CLIPVisionTower(pc, **fk)
    if name == "i2vgen_unet":
        jc = junet.I2VGenXLUNetConfig.tiny() if tiny else junet.I2VGenXLUNetConfig()
        pc = punet.I2VGenXLUNetConfig.tiny() if tiny else punet.I2VGenXLUNetConfig()
        image_dim = 16 if tiny else 1024
        tmpl = shapes(junet.I2VGenXLUNet(jc), jnp.zeros((1, 2, 8, 8, 4)),
                      jnp.zeros((1,), jnp.int32), jnp.zeros((1,)), jnp.zeros((1, 2, 8, 8, 4)),
                      jnp.zeros((1, image_dim)), jnp.zeros((1, 5, jc.cross_attention_dim)))
        return jckd.i2vgen_unet_map(jc), tmpl, ckd.i2vgen_unet_map(pc), punet.I2VGenXLUNet(pc, **fk)
    if name == "diffusers_vae":
        jc = dataclasses.replace(jconf.VAEConfig.tiny() if tiny else jconf.VAEConfig(),
                                 temporal_decoder=False)
        pc = dataclasses.replace(pconf.VAEConfig.tiny() if tiny else pconf.VAEConfig(),
                                 temporal_decoder=False)
        tmpl = shapes(jvae.AutoencoderKL(jc, use_quant_conv=True), jnp.zeros((1, 32, 32, 3)))
        return (jckd.diffusers_vae_map(jc), tmpl, ckd.diffusers_vae_map(pc),
                pvae.AutoencoderKL(pc, use_quant_conv=True, **fk))
    if name == "hf_clip_text":
        jc = jtext.CLIPTextConfig(**TEXT_TINY) if tiny else jtext.CLIPTextConfig()
        pc = ptext.CLIPTextConfig(**TEXT_TINY) if tiny else ptext.CLIPTextConfig()
        tmpl = shapes(jtext.CLIPTextTower(jc), jnp.zeros((1, jc.max_length), jnp.int32))
        return jckd.hf_clip_text_map(jc), tmpl, ckd.hf_clip_text_map(pc), ptext.CLIPTextTower(pc, **fk)
    assert name == "vfi"
    jc = jconf.VFIConfig.tiny() if tiny else jconf.VFIConfig()
    pc = pconf.VFIConfig.tiny() if tiny else pconf.VFIConfig()
    img = jnp.zeros((1, 64, 64, 3))
    tmpl = shapes(jvfi.MultiScaleFlow(jc), img, img)
    return jckv.vfi_map(jc), tmpl, ckv.vfi_map(pc), pvfi.MultiScaleFlow(pc, device=device)


MAP_USES = ("unet_cam", "controlnet", "temporal_vae", "cond_encoder", "clip_visual",
            "svd_xt_unet", "i2vgen_unet", "diffusers_vae", "hf_clip_text", "hf_clip_vision", "vfi")


@pytest.mark.parametrize("name", MAP_USES)
def test_map_matches_jax_on_a_reference_tree(name):
    """A reference-named state dict written from a port module holding
    random values; the JAX converter's result, in the port's layouts, and
    the port's conversion into a fresh module are the same bits, and both
    are the values written."""
    jmap, tmpl, pmap, module = _case(name, "tiny", "cpu")
    flat = random_flat(tmpl, seed=MAP_USES.index(name))
    load_jax_params(module, flat)
    sd = chip_smoke.reference_state_dicts([("tree", module, pmap)])["tree"]
    jvars, _ = jck.convert_state_dict({k: v.numpy().copy() for k, v in sd.items()}, jmap,
                                      {"params": tmpl})
    want = from_jax_params(jck.flatten_params(jvars["params"]))
    _, _, _, fresh = _case(name, "tiny", "cpu")
    assert ck.convert_state_dict({k: v.clone() for k, v in sd.items()}, pmap, fresh) == []
    _assert_state_equal(fresh.state_dict(), want, name)
    _assert_state_equal(fresh.state_dict(), from_jax_params(flat), name + " (values written)")


def _port_shape(path: str, shape: tuple) -> tuple:
    """The port's layout of a flax leaf's shape (``utils/weights.py``)."""
    if not path.endswith("kernel"):
        return shape
    if len(shape) == 2:
        return shape[::-1]
    if len(shape) == 4:
        if path.endswith("_deconv/kernel"):
            return (shape[2], shape[3], shape[0], shape[1])
        return (shape[3], shape[2], shape[0], shape[1])
    return (shape[0], shape[3], shape[4])


@pytest.mark.parametrize("name", MAP_USES)
def test_map_covers_the_production_modules(name):
    """At production width, on ``device="meta"``: no parameter without a
    mapping, the JAX map's orphans and none else (the conditioning encoder's
    map names a decoder it does not have), the JAX shapes in the port's
    layouts, and the map entries, hence the consumed reference keys, the
    JAX map's."""
    jmap, tmpl, pmap, module = _case(name, "production", "meta")
    missing, orphans = ck.coverage_report(pmap, module)
    jmissing, jorphans = jck.coverage_report(jmap, {"params": tmpl})
    assert missing == [] and jmissing == []
    assert orphans == sorted(k.replace("/", ".") for k in jorphans)
    assert (orphans == []) == (name != "cond_encoder")
    assert {k.replace("/", "."): _keys(v[0]) for k, v in jmap.items()} == {
        k: _keys(v[0]) for k, v in pmap.items()}
    state = module.state_dict()
    jflat = jck.flatten_params(tmpl)
    assert set(state) == {k.replace("/", ".") for k in jflat}
    for path, leaf in jflat.items():
        assert tuple(state[path.replace("/", ".")].shape) == _port_shape(path, tuple(leaf.shape))
    consumed = {k for n in state for k in _keys(pmap[n][0])}
    assert consumed == {k for p in jflat for k in _keys(jmap[p][0])}


# ------------------------------------------------------ entry points ---

@pytest.fixture(scope="module")
def stage1_pipelines():
    """(JAX tiny stage 1, port tiny stage 1 whose every value differs from
    the JAX pipeline's, the port config)."""
    from streamingt2v_tpu.config import PipelineConfig as JaxPipelineConfig
    from streamingt2v_torch.config import PipelineConfig

    pcfg = PipelineConfig.tiny()
    jpipe, src = stage1_pair(JaxPipelineConfig.tiny(), pcfg, seed=0)
    with torch.no_grad():
        for f in dataclasses.fields(src.models):
            for w in getattr(src.models, f.name).parameters():
                w.add_(0.5)
    return jpipe, src, pcfg


@pytest.mark.parametrize("svd_xt", [True, False])
def test_stage1_loader_matches_jax(tmp_path, stage1_pipelines, svd_xt):
    """Both packages' stage-1 loaders on one tree, with and without the
    diffusers SVD-XT UNet (without it the first-chunk UNet is the streaming
    UNet minus its CAM mergers)."""
    jpipe, src, pcfg = stage1_pipelines
    chip_smoke.write_reference_tree(str(tmp_path), stage1=src, svd_xt=svd_xt)
    assert os.path.isdir(tmp_path / "svd_xt") == svd_xt
    jloaded = jloader.load_stage1_checkpoints(jpipe, str(tmp_path))
    loaded = loader.load_stage1_checkpoints(pcfg, str(tmp_path), device="cpu", bf16=False)
    for field in ("unet", "controlnet", "svd_unet", "vae", "conditioner"):
        want = from_jax_params(jck.flatten_params(
            getattr(jloaded.models, field + "_params")["params"]))
        got = getattr(loaded.models, field).state_dict()
        # the tiny configs' toy CLIP projection is in no checkpoint
        skip = ("toy_clip.",) if field == "conditioner" else ()
        _assert_state_equal(got, want, field, skip)
        written = getattr(src.models, field).state_dict()
        if field == "svd_unet" and not svd_xt:
            written = {k: v for k, v in src.models.unet.state_dict().items() if k in got}
        _assert_state_equal(got, written, field + " (values written)", skip)


def test_stage3_loader_matches_jax(tmp_path):
    """Both packages' stage-3 loaders on one ``module.``-prefixed pickle that
    also carries a Swin ``attn_mask`` buffer."""
    from streamingt2v_tpu.config import PipelineConfig as JaxPipelineConfig
    from streamingt2v_tpu.models import vfi as jvfi
    from streamingt2v_torch.config import PipelineConfig
    from streamingt2v_torch.models.vfi import MultiScaleFlow
    from streamingt2v_torch.pipeline.interpolate import InterpolatePipeline

    jcfg, pcfg = JaxPipelineConfig.tiny(), PipelineConfig.tiny()
    img = jnp.zeros((1, 64, 64, 3))
    tmpl = jax.eval_shape(lambda: jvfi.MultiScaleFlow(jcfg.vfi).init(
        jax.random.PRNGKey(0), img, img))["params"]
    flat = random_flat(tmpl, seed=21)
    src = InterpolatePipeline(load_jax_params(MultiScaleFlow(pcfg.vfi), flat))
    chip_smoke.write_reference_tree(str(tmp_path), interpolate=src)
    path = tmp_path / "vfi" / "ours.pkl"
    sd = torch.load(path)
    assert all(k.startswith("module.") for k in sd)
    sd["module.feature_bone.block3.0.attn.attn_mask"] = torch.zeros(4, 49, 49)
    torch.save(sd, path)
    jloaded = jloader.load_interpolate_pipeline(jcfg, str(tmp_path))
    loaded = loader.load_interpolate_pipeline(pcfg, str(tmp_path), device="cpu")
    want = from_jax_params(jck.flatten_params(jloaded.params["params"]))
    _assert_state_equal(loaded.model.state_dict(), want, "vfi")
    _assert_state_equal(loaded.model.state_dict(), from_jax_params(flat), "vfi (values written)")
    assert loaded.tta == pcfg.vfi.tta


def test_stage2_loader_round_trip(tmp_path):
    """Stage 2 at tiny widths: the four modules come back bit for bit, the
    scheduler config and the BPE tokenizer files load as the JAX package
    reads them."""
    from streamingt2v_tpu.diffusion.ddim import DDIMScheduler as JaxDDIMScheduler
    from streamingt2v_tpu.models.clip_text import CLIPTokenizer as JaxCLIPTokenizer
    from streamingt2v_torch.config import EnhanceConfig, PipelineConfig, VAEConfig
    from streamingt2v_torch.models import clip as pclip
    from streamingt2v_torch.models import clip_text as ptext
    from streamingt2v_torch.models.enhance import unet as punet

    enh = dict(num_steps=3, height=32, width=32, chunk_size=4, overlap_size=2, vae_bf16=False)
    _, src = enhance_pair(enh)
    chip_smoke.write_reference_tree(str(tmp_path), enhance=src)
    cfg = dataclasses.replace(PipelineConfig.tiny(), enhance=EnhanceConfig(**enh))
    loaded = loader.load_enhance_pipeline(
        cfg, str(tmp_path), device="cpu", bf16=False, unet=punet.I2VGenXLUNetConfig.tiny(),
        vae=dataclasses.replace(VAEConfig.tiny(), temporal_decoder=False),
        clip_vision=pclip.CLIPVisionConfig.tiny(), text=ptext.CLIPTextConfig(**TEXT_TINY))
    for name in ("unet", "vae", "clip_vision", "text_encoder"):
        _assert_state_equal(getattr(loaded.m, name).state_dict(),
                            getattr(src.m, name).state_dict(), name)
    root = tmp_path / "i2vgen-xl"
    with open(root / "scheduler" / "scheduler_config.json") as f:
        want = dataclasses.asdict(JaxDDIMScheduler.from_config(json.load(f)).cfg)
    assert dataclasses.asdict(loaded.m.scheduler.cfg) == want
    texts = ["High Quality, HQ, detailed.", "quail high"]
    jtok = JaxCLIPTokenizer.from_files(str(root / "tokenizer" / "vocab.json"),
                                       str(root / "tokenizer" / "merges.txt"), max_length=8)
    ids = loaded.m.tokenizer(texts)
    np.testing.assert_array_equal(ids, jtok(texts))
    assert loaded.m.tokenizer.bpe_ranks
    assert not np.array_equal(ids, src.m.tokenizer(texts))     # the merges apply


@pytest.mark.parametrize("entry", ["load_stage1_checkpoints", "load_enhance_pipeline",
                                   "load_interpolate_pipeline"])
def test_loader_defaults_to_the_card(tmp_path, entry):
    """Without ``device`` an entry point builds on the card; without a card
    it raises before it reads anything."""
    from streamingt2v_torch.config import PipelineConfig

    fn = getattr(loader, entry)
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        with pytest.raises(FileNotFoundError):
            fn(PipelineConfig.tiny(), str(tmp_path))
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(PipelineConfig.tiny(), str(tmp_path))
