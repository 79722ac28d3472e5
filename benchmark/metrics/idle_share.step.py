"""idle_share.step: the share of the traced steps' wall time in which no
operation ran on the device, in %."""

from benchmark.readers import idle_share as read  # noqa: F401
