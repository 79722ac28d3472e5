"""elementwise_share.step: the share of the traced steps' device time in
the class "elementwise / copies" of ``benchmark/kernel_classes.py``, in %."""

from benchmark.readers import elementwise_share as read  # noqa: F401
