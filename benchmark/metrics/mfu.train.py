"""mfu.train: model FLOPs of the traced training steps over their wall time
at the bf16 dense peak, in %.  A step counts three forwards of the loss
(the reference on the meta device, ``Cell.meta_unit``): the usual
convention that the backward costs twice the forward.  The forward that
the recomputed blocks run again in the backward is not counted: it is work
the step chooses to do, not work the model needs."""

from benchmark.readers import mfu


def read(ctx):
    forward = mfu(ctx)
    return None if forward is None else 3.0 * forward
