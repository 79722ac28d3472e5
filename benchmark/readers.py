"""What the per-layer metric readers (``benchmark/metrics/<name>.py``) read:
the traced run reduced to a ``Context``, and the readings that several of
them share.  A reader returns None where its cell gives it nothing to read;
the runner then leaves its metric out."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from benchmark import flops
from benchmark.kernel_classes import OTHER, classify
from benchmark.trace import Trace


@dataclass
class Context:
    trace: Trace
    units: int              # traced units
    steps: int              # guided steps among them (0 in a decode cell)
    frames: int             # frames they completed (0 in a step cell)
    unit_flops: float       # model FLOPs of one unit (the reference on the meta device)
    unit_log: List[dict]    # the reference's op log of one unit

    @property
    def flops(self) -> float:
        return self.unit_flops * self.units

    def bound_s(self, select) -> float:
        return self.units * flops.bound_of(select(self.unit_log))


def mfu(ctx: Context) -> Optional[float]:
    if ctx.flops <= 0 or ctx.trace.window_s <= 0:
        return None
    return 100.0 * ctx.flops / (ctx.trace.window_s * flops.PEAK_BF16_FLOPS)


def idle_share(ctx: Context) -> Optional[float]:
    if not ctx.trace.ops:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)


def elementwise_share(ctx: Context) -> Optional[float]:
    total = ctx.trace.device_s()
    if total <= 0:
        return None
    return 100.0 * ctx.trace.device_s(lambda op: classify(op.name) == OTHER) / total


def roofline(ctx: Context, kernel: str, select) -> Optional[float]:
    """A kernel's share of its bound: the bound of the calls it serves over
    the device time of the operations whose name holds ``kernel``."""
    spent = ctx.trace.device_s(lambda op: kernel in op.name)
    bound = ctx.bound_s(select)
    if spent <= 0 or bound <= 0:
        return None
    return 100.0 * bound / spent
