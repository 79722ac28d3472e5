"""geglu_ff_roofline: K3's share of its bound in the traced work, in %: the
bound of the GEGLU feed-forwards it serves (``flops.k3_calls``: 24 M C^2
operations each at the bf16 peak, or its bytes at HBM bandwidth, whichever
is longer) over the device time of its kernels (``geglu_``)."""

from benchmark import flops
from benchmark.readers import roofline


def read(ctx):
    return roofline(ctx, "geglu_", flops.k3_calls)
