"""idle_share.decode: the share of the traced decode calls' wall time in
which no operation ran on the device, in %."""

from benchmark.readers import idle_share as read  # noqa: F401
