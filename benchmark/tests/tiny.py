"""Tiny configurations and traffic for the CPU tests: the same keys as the
cells' files, at widths a CPU runs in seconds."""

from __future__ import annotations

import copy

STREAMINGSVD = {
    "source": "tiny", "model": "streamingsvd", "dtype": "bfloat16", "vae_dtype": "float32",
    "unet": {"in_channels": 8, "model_channels": 32, "out_channels": 4, "num_res_blocks": 1,
             "attention_resolutions": [1, 2], "channel_mult": [1, 2], "num_head_channels": 16,
             "transformer_depth": 1, "context_dim": 32, "adm_in_channels": 24,
             "video_kernel_size": [3, 1, 1], "max_period": 10000.0},
    "controlnet": {"conditioning_embedding_out_channels": [8, 16], "num_conditional_frames": 3},
    "vae": {"ch": 16, "ch_mult": [1, 2], "num_res_blocks": 1, "z_channels": 4, "out_ch": 3,
            "video_kernel_size": [3, 1, 1], "scale_factor": 0.18215},
    "sampler": {"kind": "euler_edm", "discretization": "align_your_steps", "num_steps": 3,
                "guider": {"kind": "linear_prediction", "min_scale": 1.5, "max_scale": 3.0,
                           "num_frames": 5}},
    "inference": {"chunk_frames": 5, "height": 32, "width": 32, "fps_id": 6,
                  "motion_bucket_id": 127, "cond_aug": 0.02, "vector_outdim": 8,
                  "decode_chunk_size": 2, "vae_decode_bf16": True},
    "reduced": [], "assumed": [],
}

I2VGEN_XL = {
    "source": "tiny", "model": "i2vgen_xl", "dtype": "bfloat16",
    "unet": {"in_channels": 4, "out_channels": 4, "block_out_channels": [16, 32],
             "layers_per_block": 1, "norm_num_groups": 8, "cross_attention_dim": 32,
             "attention_head_dim": 8, "image_embed_dim": 16},
    "enhance": {"num_steps": 30, "strength": 0.97, "guidance_scale": 9.0, "chunk_size": 6,
                "overlap_size": 2, "fps": 16, "height": 64, "width": 64, "text_tokens": 7,
                "vae_downsample": 8},
    "reduced": [], "assumed": [],
}

TRAFFIC = {
    "ar_chunk": {"entry": "stage1_stream_chunk", "distinct_chunks": 2, "trace_units": 2},
    "enhance_chunk": {"entry": "stage2_denoise_step", "frames": 14, "trace_units": 1},
    "vae_decode": {"entry": "stage1_decode_video", "distinct_latents": 2, "trace_units": 2},
}

CELLS = {
    "streamingsvd.ar_chunk": (STREAMINGSVD, "ar_chunk"),
    "i2vgen_xl.enhance_chunk": (I2VGEN_XL, "enhance_chunk"),
    "streamingsvd.vae_decode": (STREAMINGSVD, "vae_decode"),
}


def cell(name: str) -> tuple:
    """(config, traffic) of a cell at the tiny size: fresh copies."""
    cfg, traffic = CELLS[name]
    return copy.deepcopy(cfg), copy.deepcopy(TRAFFIC[traffic])
