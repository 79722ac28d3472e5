"""What the entries share: seeds derived from the run's seed, the stop rule of
a window, the harness's spans around the program's network calls, host
copies of what the timed path produced, and the comparison numbers."""

from __future__ import annotations

import contextlib
import hashlib
import time
from typing import Callable, List, Optional

import torch

# the harness's span around each network call of the program
NETWORK_SPAN = "bench.network"
# the reading of an output that is not finite (JSON has no infinity)
NOT_FINITE = 1e30


class StopWindow(Exception):
    """Raised at a unit boundary once the window's time is up."""


def sub_seed(seed: int, *parts) -> int:
    """A 63-bit seed that is a pure function of the run's seed and a name."""
    digest = hashlib.sha256("/".join(str(p) for p in (int(seed),) + parts).encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def generator(seed: int, device, *parts) -> torch.Generator:
    return torch.Generator(torch.device(device)).manual_seed(sub_seed(seed, *parts))


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Window:
    """The measured window: ``boundary(units)`` is called by an entry each time
    ``units`` whole units (steps or calls) have been enqueued.  The first call
    after ``seconds`` of host time synchronises the device, closes the window
    and returns True; ``on_boundary`` (the traced run's profiler) sees every
    boundary first, and the window stays open while it returns True."""

    def __init__(self, seconds: float, device,
                 on_boundary: Optional[Callable[[int], bool]] = None):
        self.seconds = seconds
        self.device = device
        self.on_boundary = on_boundary
        self.t0 = None
        self.elapsed = None
        self.units = 0

    def start(self) -> None:
        sync(self.device)
        self.t0 = time.perf_counter()

    def boundary(self, units: int) -> bool:
        hold = False
        if self.on_boundary is not None:
            hold = self.on_boundary(units)
            if units == 0:      # the window starts once the profiler runs
                self.t0 = time.perf_counter()
        if hold or time.perf_counter() - self.t0 < self.seconds:
            return False
        sync(self.device)
        self.elapsed = time.perf_counter() - self.t0
        self.units = units
        return True


class Unbounded(Window):
    """A window that never closes on time (warm-up and tests): it stops
    after ``units`` units."""

    def __init__(self, units: int, device):
        super().__init__(float("inf"), device)
        self.limit = units

    def boundary(self, units: int) -> bool:
        if units < self.limit:
            return False
        sync(self.device)
        self.units = units
        self.elapsed = time.perf_counter() - self.t0
        return True


def span_hooks(first: torch.nn.Module, last: torch.nn.Module) -> List:
    """A ``record_function`` span from ``first``'s forward to the end of
    ``last``'s: the program's network call.  Returns the hook handles."""
    state = {}

    def enter(module, args):
        rf = torch.profiler.record_function(NETWORK_SPAN)
        rf.__enter__()
        state["rf"] = rf

    def leave(module, args, out):
        rf = state.pop("rf", None)
        if rf is not None:
            rf.__exit__(None, None, None)

    return [first.register_forward_pre_hook(enter), last.register_forward_hook(leave)]


def remove(handles) -> None:
    for h in handles:
        h.remove()


class HostSlots:
    """Host buffers for what the window produces, made before the window
    (pinned on a card: allocating pinned memory inside the window stalls
    the device for milliseconds).  ``put`` copies a tensor of the slots'
    shape into the next free one, asynchronously, and returns it; None once
    all are taken."""

    def __init__(self, n: int, shape, dtype, device):
        pin = torch.device(device).type == "cuda"
        self.free = [torch.empty(tuple(shape), dtype=dtype, pin_memory=pin) for _ in range(n)]

    def put(self, x: torch.Tensor) -> Optional[torch.Tensor]:
        if not self.free:
            return None
        out = self.free.pop(0)
        out.copy_(x, non_blocking=x.device.type == "cuda")
        return out


def rel_err(out: torch.Tensor, ref: torch.Tensor, base: Optional[torch.Tensor] = None) -> float:
    """||out - ref|| / ||ref - base|| (base 0: / ||ref||), in f64;
    ``NOT_FINITE`` where the output is not finite."""
    out, ref = out.double(), ref.double()
    if not torch.isfinite(out).all():
        return NOT_FINITE
    den = ref if base is None else ref - base.double().to(ref.device)
    return float((out.to(ref.device) - ref).norm() / den.norm().clamp_min(1e-300))


@contextlib.contextmanager
def full_f32():
    """Float32 products in full f32 (TF32 off in cuBLAS and cuDNN)."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
