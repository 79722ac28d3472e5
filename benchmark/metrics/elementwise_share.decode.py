"""elementwise_share.decode: the share of the traced decode calls' device
time in the class "elementwise / copies" of ``benchmark/kernel_classes.py``, in %."""

from benchmark.readers import elementwise_share as read  # noqa: F401
