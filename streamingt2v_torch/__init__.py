"""PyTorch/CUDA port of streamingt2v_tpu for NVIDIA Hopper (H100).

Mirrors the JAX package's layout (config, ops, models, diffusion,
pipeline, utils); the three Pallas kernels on the stage-1 path are
hand-written CUDA kernels under ``csrc/``, built with nvcc at first use.
"""
