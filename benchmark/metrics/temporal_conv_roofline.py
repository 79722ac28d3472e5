"""temporal_conv_roofline: K4's share of its bound in the traced decode
calls, in %: the bound of the temporal convolutions it serves
(``flops.k4_calls``: 2 B T S kt C C_out operations each, or x, the output
and the residual at HBM bandwidth) over the device time of
``temporal_conv_bf16``."""

from benchmark import flops
from benchmark.readers import roofline


def read(ctx):
    return roofline(ctx, "temporal_conv_bf16", flops.k4_calls)
