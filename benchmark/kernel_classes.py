"""The kernel-class table: a frozen copy of ``scripts/profile_torch_steps.py``'s
``CLASSES`` and ``classify``, so that the port cannot move the yardstick.
A device operation belongs to the first class one of whose substrings its
name holds (case-insensitive), else to ``OTHER``."""

from __future__ import annotations

CLASSES = (
    ("K1/K2 flash attention", ("flash_kernel",)),
    ("K3 GEGLU FF", ("geglu_",)),
    ("K4 temporal conv", ("temporal_conv",)),
    ("K5 fused GroupNorm", ("gn_stats_kernel", "gn_apply_kernel")),
    ("K6 temporal attention", ("temporal_attention",)),
    ("index / gather", ("index_elementwise", "gather_kernel", "index_kernel")),
    ("cuDNN conv", ("conv", "fprop", "dgrad", "implicit")),
    ("GEMM", ("gemm", "nvjet", "cublas", "xmma", "cutlass", "sm90_")),
    ("softmax / reductions", ("softmax", "reduce", "norm")),
)
OTHER = "elementwise / copies"


def classify(name: str) -> str:
    low = name.lower()
    for label, keys in CLASSES:
        if any(k.lower() in low for k in keys):
            return label
    return OTHER
