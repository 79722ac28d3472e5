"""PyTorch/CUDA port of streamingt2v_tpu for NVIDIA Hopper (H100).

Mirrors the JAX package's layout (config, ops, models, diffusion, data,
pipeline, parallel, utils): all six of its Pallas kernels are hand-written
CUDA kernels under ``csrc/`` (flash attention K1 and its packed form K2,
the GEGLU feed-forward K3, the temporal conv K4, the fused GroupNorm K5 and
the temporal attention K6), built with nvcc at first use; every stage of
the product (streaming image-to-video, the enhance, the interpolation),
the CLI and the checkpoint loader; training (the diffusion engine, each
kernel's backward, the autoencoder and VFI losses); and the (data, seq,
model) multi-device layer on ``torch.distributed``.

The top-level names ``PipelineConfig``, ``build_pipeline`` and
``StreamingT2VPipeline`` are imported on first use.
"""
from streamingt2v_torch.ops.attention import attention, dot_product_attention  # noqa: F401
from streamingt2v_torch.ops.embedding import timestep_embedding  # noqa: F401
from streamingt2v_torch.ops.norms import group_norm, group_norm_affine, layer_norm  # noqa: F401


def __getattr__(name):
    """The lazy top-level API (the JAX package's three names)."""
    if name == "PipelineConfig":
        from streamingt2v_torch.config import PipelineConfig

        return PipelineConfig
    if name == "build_pipeline":
        from streamingt2v_torch.pipeline.build import build_pipeline

        return build_pipeline
    if name == "StreamingT2VPipeline":
        from streamingt2v_torch.pipeline.full import StreamingT2VPipeline

        return StreamingT2VPipeline
    raise AttributeError(name)
