"""flash_attention_d128_roofline: K1's bf16 D=128 body's share of its bound
in the traced steps, in %: the bound of the reference's attentions at head
dim 128 on the flash geometries (``flops.attention``: 4 B H Lq Lk D
operations each, or q, k, v and o at HBM bandwidth, whichever is longer;
``flops.flash_geometry``) over the device time of
``flash_kernel_bf16_d128``."""

from benchmark import flops
from benchmark.readers import roofline


def d128_calls(log):
    return [o for o in log if o["kind"] == "attention" and o["d"] == 128
            and flops.flash_geometry(o["bh"], o["lq"], o["lk"])]


def read(ctx):
    return roofline(ctx, "flash_kernel_bf16_d128", d128_calls)
