"""mfu.step: model FLOPs of the traced guided steps (the reference on the
meta device) over their wall time at the bf16 dense peak, in %."""

from benchmark.readers import mfu as read  # noqa: F401
