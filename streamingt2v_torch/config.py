"""Typed configuration tree (the PyTorch port's copy).

The same dataclass tree as ``streamingt2v_tpu/config.py`` with ``torch``
dtypes in ``DTypePolicy``, so the two packages read one configuration.
It replaces the reference's three interlocking config mechanisms (LightningCLI
jsonargparse graphs, sgm ``instantiate_from_config`` reflection, AsDictMixin
param objects — reference ``code/config.yaml``, ``code/modules/params/``)
with one explicit dataclass tree.  Defaults reproduce the shipped
StreamingSVD configuration (reference ``code/config.yaml:1-318``).

Every config class has a ``tiny()`` constructor producing a CPU-runnable
miniature for tests — the disciplined version of the reference's
``fast_dev_run`` affordance (``modules/loader/module_loader_config.py:9``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Tuple

import torch

from streamingt2v_torch.diffusion.ddim import DDIMConfig
from streamingt2v_torch.diffusion.flow_unipc import FlowUniPCConfig


def _replace(cfg, **kw):
    return dataclasses.replace(cfg, **kw)


@dataclass(frozen=True)
class DTypePolicy:
    """Mixed-precision policy: bf16 compute, fp32 params/accumulation.

    The reference runs fp16-mixed autocast (config.yaml:8) with selective
    fp32 (disable_first_stage_autocast, config.yaml:310).  The port runs
    bfloat16 with fp32 accumulation in every matrix product.
    """

    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16
    # VAE runs at higher precision, mirroring disable_first_stage_autocast.
    vae_compute_dtype: Any = torch.float32

    @classmethod
    def fp32(cls) -> "DTypePolicy":
        return cls(compute_dtype=torch.float32)


@dataclass(frozen=True)
class KernelRouting:
    """Which of the optional kernel routes a pipeline takes on a CUDA device.

    The JAX package keeps these behind environment switches that are off by
    default, on the strength of TPU v5e timings
    (``streamingt2v_tpu/ops/attention.py:262-265``,
    ``ops/temporal_attention.py:158-170``).  In the port each pipeline
    carries one of these and applies it around its public calls
    (``ops/routing.py``); off means the JAX default path, which is also
    what runs outside any pipeline call (training among it).  Stage 1 keeps
    the defaults (``PipelineConfig.routing``), stage 2 takes all three
    (``EnhanceConfig.routing``).  K5 is no route: ``ops/norms.py`` takes it
    wherever autograd records no graph.

      flash_packed:       multi-head attention on the flash geometries runs
                          K2 on the packed (B, L, H*D) layout instead of K1
                          on head-folded copies;
      temporal_attention: ``ops.temporal_attention`` gives the spatial-major
                          q/k/v to K6 instead of transposing them;
      ring_attention:     under a mesh with a seq axis, the token-split spatial
                          self-attention rotates k/v around the seq ranks
                          (on, the JAX default) instead of gathering them
                          (off: the JAX package's ``STREAMINGT2V_RING_ATTN=0``).
    """

    flash_packed: bool = False
    temporal_attention: bool = False
    ring_attention: bool = True

    @classmethod
    def all_on(cls) -> "KernelRouting":
        return cls(flash_packed=True, temporal_attention=True)


@dataclass(frozen=True)
class VAEConfig:
    """AutoencodingEngine: spatial Encoder + temporal VideoDecoder.

    Reference: config.yaml:219-281, sgm Encoder/Decoder
    (models/svd/sgm/modules/diffusionmodules/model.py:487,604) and
    VideoDecoder (modules/autoencoding/temporal_ae.py:291).
    """

    ch: int = 128
    ch_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    z_channels: int = 4
    embed_dim: int = 4
    in_channels: int = 3
    out_ch: int = 3
    double_z: bool = True
    # temporal decoder
    video_kernel_size: Tuple[int, int, int] = (3, 1, 1)
    temporal_decoder: bool = True
    # scale factor applied to latents (DiffusionTrainerParams.scale_factor,
    # reference config.yaml:305)
    scale_factor: float = 0.18215
    dtypes: DTypePolicy = field(default_factory=DTypePolicy)

    @property
    def downsample_factor(self) -> int:
        """Spatial pixel->latent factor: one 2x downsample per level but the
        last (8x at the production (1,2,4,4))."""
        return 2 ** (len(self.ch_mult) - 1)

    @classmethod
    def tiny(cls) -> "VAEConfig":
        return cls(ch=16, ch_mult=(1, 2), num_res_blocks=1, dtypes=DTypePolicy.fp32())


@dataclass(frozen=True)
class VideoUNetConfig:
    """SVD VideoUNet hyperparameters (reference config.yaml:69-115,
    models/diffusion/video_model.py:94)."""

    in_channels: int = 8
    model_channels: int = 320
    out_channels: int = 4
    num_res_blocks: int = 2
    attention_resolutions: Tuple[int, ...] = (4, 2, 1)
    channel_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_head_channels: int = 64
    transformer_depth: int = 1
    context_dim: int = 1024
    adm_in_channels: int = 768
    use_spatial_context: bool = True
    use_linear_in_transformer: bool = True
    extra_ff_mix_layer: bool = True
    merge_strategy: str = "learned_with_images"
    merge_factor: float = 0.5
    video_kernel_size: Tuple[int, int, int] = (3, 1, 1)
    disable_temporal_crossattention: bool = False
    max_period: float = 10000.0
    # CAM fusion: 'attention_cross_attention' inserts a ConditionalModel
    # merger after every input block + mid block (video_model.py:134-140).
    merging_mode: str = "attention_cross_attention"
    controlnet_mode: bool = True
    use_apm: bool = False
    # remat: the video res blocks and spatial video transformers recompute their
    # activations in the backward (only under grad: training)
    use_checkpoint: bool = False
    dtypes: DTypePolicy = field(default_factory=DTypePolicy)

    @property
    def num_levels(self) -> int:
        return len(self.channel_mult)

    @classmethod
    def tiny(cls, controlnet_mode: bool = True) -> "VideoUNetConfig":
        return cls(
            model_channels=32,
            channel_mult=(1, 2),
            num_res_blocks=1,
            attention_resolutions=(1, 2),
            num_head_channels=16,
            context_dim=32,
            adm_in_channels=24,
            controlnet_mode=controlnet_mode,
            dtypes=DTypePolicy.fp32(),
        )


@dataclass(frozen=True)
class ControlNetConfig:
    """CAM encoder branch (reference models/control/controlnet.py:124,
    config.yaml:43-66)."""

    conditioning_embedding_out_channels: Tuple[int, ...] = (32, 96, 256, 512)
    merging_mode: str = "addition"
    downsample_controlnet_cond: bool = True
    use_image_encoder_normalization: bool = True
    condition_encoder: str = ""
    num_conditional_frames: int = 7

    @classmethod
    def tiny(cls) -> "ControlNetConfig":
        return cls(conditioning_embedding_out_channels=(8, 16), num_conditional_frames=3)


@dataclass(frozen=True)
class GuiderConfig:
    """LinearPredictionGuider (reference guiders.py:60, config.yaml:152-156)."""

    kind: str = "linear_prediction"  # vanilla | identity | linear_prediction | triangle_prediction
    min_scale: float = 1.5
    max_scale: float = 3.0
    num_frames: int = 25


@dataclass(frozen=True)
class SamplerConfig:
    """EulerEDM + AlignYourSteps (reference config.yaml:140-156)."""

    kind: str = "euler_edm"  # euler_edm | heun_edm | euler_ancestral | dpmpp2m | dpmpp2s | lms
    num_steps: int = 30
    discretization: str = "align_your_steps"  # edm | legacy_ddpm | align_your_steps
    sigma_max: float = 700.0
    sigma_min: float = 0.002
    rho: float = 7.0
    s_churn: float = 0.0
    s_tmin: float = 0.0
    s_tmax: float = float("inf")
    s_noise: float = 1.0
    guider: GuiderConfig = field(default_factory=GuiderConfig)


@dataclass(frozen=True)
class ConditionerConfig:
    """GeneralConditioner embedder set (reference config.yaml:157-218)."""

    clip_embed_dim: int = 1024  # ViT-H/14 visual projection dim
    vector_outdim: int = 256  # ConcatTimestepEmbedderND outdim x3 -> adm 768
    n_cond_frames: int = 1
    use_clip: bool = True


@dataclass(frozen=True)
class InferenceParams:
    """T2VInferenceParams (reference modules/params/diffusion/inference_params.py:14)."""

    n_autoregressive_generations: int = 2
    num_conditional_frames: int = 7
    anchor_frames: int = 6  # 0-based index of the CLIP anchor frame
    # APM: [a, b) range of so-far-video frames whose CLIP embeddings form
    # the 16 appearance tokens (reference extract_anchor_frames range mode,
    # streaming_svd.py:252-256; 16+1 tokens at attention.py:604)
    apm_anchor_frames: Tuple[int, int] = (0, 16)
    reset_seed_per_generation: bool = True
    # conditioning values fed to get_batch_sgm (streaming_svd.py:169-183)
    fps_id: int = 6
    motion_bucket_id: int = 127
    cond_aug: float = 0.02
    chunk_frames: int = 25  # frames per generated chunk
    decode_chunk_size: int = 8
    # Run the temporal-VAE decode in bf16 (params + activations cast inside
    # the decode program; GroupNorm stats keep f32 accumulation).  The
    # reference runs its first stage in fp32 (disable_first_stage_autocast,
    # config.yaml:310) but the enhance stage's fp16 VAE precedent
    # (i2v_enhance_interface.py:69) applies: decoded frames are 8-bit
    # video, and bf16 halves the 576x1024 decoder's HBM traffic and temps
    # (the stage-1 decode is pure-bandwidth-bound — PERF.md round 5).
    vae_decode_bf16: bool = True


@dataclass(frozen=True)
class EnhanceConfig:
    """I2VGen-XL SDEdit enhancement (reference i2v_enhance/, config.yaml:19-22)."""

    num_steps: int = 30
    strength: float = 0.97
    guidance_scale: float = 9.0  # i2v_enhance_interface.py:112,130
    chunk_size: int = 38
    overlap_size: int = 12
    use_randomized_blending: bool = False
    height: int = 720
    width: int = 1280
    fps: int = 16
    seed: int = 8888  # fixed enhancement seed (i2v_enhance_interface.py:66)
    # run the stage-2 VAE in bf16 (the reference loads the ENTIRE i2vgen
    # pipeline incl. VAE in fp16, i2v_enhance_interface.py:69) — halves the
    # 720p decoder's ~1 GB/frame live tensors on a 16 GB chip
    vae_bf16: bool = True
    # fixed quality prompts (i2v_enhance_interface.py:87-88)
    prompt: str = "High Quality, HQ, detailed."
    negative_prompt: str = (
        "Distorted, blurry, discontinuous, Ugly, blurry, low resolution, "
        "motionless, static, disfigured, disconnected limbs, Ugly faces, "
        "incomplete arms"
    )
    # stage 2 takes every optional kernel route (K2, K6)
    routing: KernelRouting = field(default_factory=KernelRouting.all_on)


@dataclass(frozen=True)
class CogVideoXConfig:
    """CogVideoX-5B text-to-video: the transformer (THUDM/CogVideoX-5b
    ``transformer/config.json``, diffusers ``CogVideoXTransformer3DModel``),
    its DDIM scheduler (``scheduler/scheduler_config.json``,
    ``CogVideoXDDIMScheduler``) and ``CogVideoXPipeline``'s defaults: 49
    frames at 480x720, 50 steps, guidance 6.0 with both CFG halves in one
    batch-2 call.  The pipeline takes T5 prompt embeddings and returns
    latents (no text encoder, no VAE).  The scheduler's published
    ``snr_shift_scale`` is 1.0, the identity, and is not carried."""

    num_layers: int = 42
    num_attention_heads: int = 48
    attention_head_dim: int = 64
    in_channels: int = 16
    out_channels: int = 16
    patch_size: int = 2
    text_embed_dim: int = 4096
    max_text_seq_length: int = 226
    time_embed_dim: int = 512
    norm_eps: float = 1e-5
    frames: int = 49
    height: int = 480
    width: int = 720
    vae_scale_factor_spatial: int = 8
    vae_scale_factor_temporal: int = 4
    num_steps: int = 50
    guidance_scale: float = 6.0
    scheduler: DDIMConfig = field(default_factory=lambda: DDIMConfig(
        beta_start=0.00085, beta_end=0.012, beta_schedule="scaled_linear", steps_offset=0,
        timestep_spacing="trailing", prediction_type="v_prediction", set_alpha_to_one=True,
        rescale_betas_zero_snr=True))
    # K2's packed gate refuses 48 x 64 lanes, so attention takes K1 on
    # head-folded copies whatever the routing says
    routing: KernelRouting = field(default_factory=KernelRouting)
    dtypes: DTypePolicy = field(default_factory=DTypePolicy)

    @property
    def inner_dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim

    @property
    def latent_frames(self) -> int:
        return (self.frames - 1) // self.vae_scale_factor_temporal + 1

    def latent_shape(self, batch: int = 1) -> Tuple[int, ...]:
        """(B, F, C, H, W) of the latents, as the diffusers pipeline lays
        them out."""
        s = self.vae_scale_factor_spatial
        return (batch, self.latent_frames, self.in_channels, self.height // s, self.width // s)

    @classmethod
    def tiny(cls) -> "CogVideoXConfig":
        """2 blocks of 128 (2 heads of 64), text 32 wide x 8 tokens, time 32;
        latents of 3 frames, 4 x 6, 16 channels; 3 steps; f32."""
        return cls(num_layers=2, num_attention_heads=2, text_embed_dim=32,
                   max_text_seq_length=8, time_embed_dim=32, frames=9, height=32, width=48,
                   num_steps=3, dtypes=DTypePolicy.fp32())


@dataclass(frozen=True)
class WanConfig:
    """Wan2.1-I2V-14B-480P image-to-video: the transformer (Wan-AI/
    Wan2.1-I2V-14B-480P ``config.json``; ``wan/modules/model.py``
    ``WanModel`` with ``model_type`` "i2v"), its flow-matching UniPC
    scheduler and ``wan/image2video.py``'s defaults at ``generate.py``'s
    480p settings: 81 frames at 480x832, 40 steps, guidance 5.0, shift 3.0,
    both CFG halves in one batch-2 call.  The pipeline takes umT5 prompt
    embeddings, CLIP ViT-H image features and the VAE latent of the
    conditioning clip, and returns latents (no text or image encoder, no
    VAE)."""

    dim: int = 5120
    ffn_dim: int = 13824
    num_heads: int = 40
    num_layers: int = 40
    in_dim: int = 36
    out_dim: int = 16
    freq_dim: int = 256
    text_dim: int = 4096
    text_len: int = 512
    eps: float = 1e-6
    patch_size: Tuple[int, int, int] = (1, 2, 2)
    # the CLIP ViT-H image tokens and their width (``MLPProj(1280, dim)``),
    # and the projector's LayerNorm eps (torch's default)
    clip_dim: int = 1280
    clip_tokens: int = 257
    image_eps: float = 1e-5
    frames: int = 81
    height: int = 480
    width: int = 832
    vae_stride: Tuple[int, int, int] = (4, 8, 8)
    num_steps: int = 40
    guidance_scale: float = 5.0
    scheduler: FlowUniPCConfig = field(default_factory=FlowUniPCConfig)
    dtypes: DTypePolicy = field(default_factory=DTypePolicy)

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads

    @property
    def rope_dims(self) -> Tuple[int, int, int]:
        """The head's RoPE channels for t, h and w (``WanModel``'s
        d - 4 (d // 6), 2 (d // 6), 2 (d // 6): 44, 42, 42 at d = 128)."""
        d = self.head_dim
        return (d - 4 * (d // 6), 2 * (d // 6), 2 * (d // 6))

    @property
    def latent_frames(self) -> int:
        return (self.frames - 1) // self.vae_stride[0] + 1

    def latent_shape(self, batch: int = 1) -> Tuple[int, ...]:
        """(B, C, F, H, W) of the latents, as ``image2video.py`` lays them
        out (without the batch)."""
        return (batch, self.out_dim, self.latent_frames, self.height // self.vae_stride[1],
                self.width // self.vae_stride[2])

    @classmethod
    def tiny(cls) -> "WanConfig":
        """2 blocks of 256 (2 heads of 128), FFN 512, text 32 wide x 8
        tokens, 5 CLIP tokens of 32, time 32; latents of 2 frames, 4 x 6, 16
        channels; 4 steps; f32."""
        return cls(dim=256, ffn_dim=512, num_heads=2, num_layers=2, freq_dim=32, text_dim=32,
                   text_len=8, clip_dim=32, clip_tokens=5, frames=5, height=32, width=48,
                   num_steps=4, dtypes=DTypePolicy.fp32())


@dataclass(frozen=True)
class VFIConfig:
    """EMA-VFI frame interpolation (reference i2v_enhance/thirdparty/VFI/)."""

    # F=32, W=7, depth (2,2,2,4,4): motion_dims = 8F/depth[-2], 16F/depth[-1]
    # (reference thirdparty/VFI/config.py:9-28)
    embed_dims: Tuple[int, ...] = (32, 64, 128, 256, 512)
    motion_dims: Tuple[int, ...] = (0, 0, 0, 64, 128)
    num_heads: Tuple[int, ...] = (8, 16)
    window_sizes: Tuple[int, ...] = (7, 7)
    depths: Tuple[int, ...] = (2, 2, 2, 4, 4)
    scales: Tuple[int, ...] = (8, 16)
    hidden_dims: Tuple[int, ...] = (128, 128)
    tta: bool = True

    @classmethod
    def tiny(cls) -> "VFIConfig":
        # (motion*depth + embed)*2 must divide by 16 (FlowHead PixelShuffle)
        return cls(
            embed_dims=(8, 8, 16, 16, 32),
            motion_dims=(0, 0, 0, 8, 16),
            num_heads=(2, 2),
            window_sizes=(4, 4),
            depths=(1, 1, 1, 1, 1),
            scales=(8, 16),
            hidden_dims=(16, 16),
            tta=False,
        )


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh shape. Axes: data (DP over CFG pair / chunks), seq
    (SP over spatial tokens), model (TP over heads / FF)."""

    data: int = 1
    seq: int = 1
    model: int = 1

    @property
    def num_devices(self) -> int:
        return self.data * self.seq * self.model


@dataclass(frozen=True)
class PipelineConfig:
    """Top-level pipeline config mirroring the CLI surface of
    reference inference_i2v.py:30-47."""

    num_frames: int = 200
    out_fps: int = 24
    height: int = 576
    width: int = 1024
    seed: int = 33
    use_randomized_blending: bool = False
    chunk_size: int = 38
    overlap_size: int = 12
    unet: VideoUNetConfig = field(default_factory=VideoUNetConfig)
    controlnet: ControlNetConfig = field(default_factory=ControlNetConfig)
    vae: VAEConfig = field(default_factory=VAEConfig)
    sampler: SamplerConfig = field(default_factory=SamplerConfig)
    # The first 25-frame chunk runs under the SVD-XT pipeline defaults
    # (diffusers StableVideoDiffusionPipeline: 25 steps, Karras sigmas
    # [0.002, 700] == the EDM rho-7 schedule, per-frame guidance 1.0->3.0),
    # not the streaming sampler (reference streaming_svd.py:388-390).
    first_chunk_sampler: SamplerConfig = field(
        default_factory=lambda: SamplerConfig(
            num_steps=25,
            discretization="edm",
            sigma_min=0.002,
            sigma_max=700.0,
            guider=GuiderConfig(min_scale=1.0, max_scale=3.0, num_frames=25),
        )
    )
    conditioner: ConditionerConfig = field(default_factory=ConditionerConfig)
    inference: InferenceParams = field(default_factory=InferenceParams)
    enhance: EnhanceConfig = field(default_factory=EnhanceConfig)
    vfi: VFIConfig = field(default_factory=VFIConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    # stage 1 keeps the JAX package's default routes (K1 on head-folded
    # copies, transposed temporal attention)
    routing: KernelRouting = field(default_factory=KernelRouting)

    def n_autoregressions(self, stage1_frames: int) -> int:
        """ceil((F_target - 25) / (25 - 7)) — reference inference_i2v.py:179-184."""
        chunk = self.inference.chunk_frames
        cond = self.inference.num_conditional_frames
        return max(0, -(-(stage1_frames - chunk) // (chunk - cond)))

    @property
    def stage1_frames(self) -> int:
        """Stage-1 target frame count: (num_frames+1)//2 (inference_i2v.py:249)."""
        return (self.num_frames + 1) // 2

    @classmethod
    def tiny(cls) -> "PipelineConfig":
        return cls(
            num_frames=12,
            height=64,
            width=64,
            unet=VideoUNetConfig.tiny(),
            controlnet=ControlNetConfig.tiny(),
            vae=VAEConfig.tiny(),
            sampler=_replace(
                SamplerConfig(),
                num_steps=3,
                guider=GuiderConfig(num_frames=5),
            ),
            first_chunk_sampler=SamplerConfig(
                num_steps=3, discretization="edm", sigma_max=700.0,
                guider=GuiderConfig(min_scale=1.0, max_scale=3.0, num_frames=5),
            ),
            conditioner=ConditionerConfig(clip_embed_dim=32, vector_outdim=8, use_clip=False),
            inference=InferenceParams(
                chunk_frames=5, num_conditional_frames=2, anchor_frames=1, decode_chunk_size=4
            ),
            vfi=VFIConfig.tiny(),
        )
