"""flash_attention_roofline: the flash attention D=64 body's share of its
bound in the traced work (K1 in stage 1, K2 in stage 2), in %: the bound of
the attentions on the flash geometries (``flops.flash_d64_calls``:
4 B H Lq Lk D operations each, or q, k, v and o at HBM bandwidth) over the
device time of ``flash_kernel_bf16_d64``."""

from benchmark import flops
from benchmark.readers import roofline


def read(ctx):
    return roofline(ctx, "flash_kernel_bf16_d64", flops.flash_d64_calls)
