"""What the ``program_span`` metrics read: the program's own spans
(``st2v.*``, ``record_function`` ranges of ``streamingt2v_torch/utils/
profiling.py``), which the traced run keeps among its host events, on the
profiler's clock like the device operations' launch times.

A device operation belongs to the innermost ``st2v.`` span open when it was
launched (``DeviceOp.launch_ns``), and lies inside every span open then.
The spans of one thread nest, so a sweep over the launches in time order
with a stack of open spans finds both.  A trace with no ``st2v.`` span (a
program without them) or with an operation whose launch was not found
gives no attribution: the readers then return None.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from benchmark.kernel_classes import OTHER, classify
from benchmark.trace import Trace

PREFIX = "st2v."
STEP = "st2v.step"
NORM = "st2v.norm"
NETWORKS = ("st2v.unet", "st2v.controlnet", "st2v.vae_decoder")
BLOCKS = ("st2v.norm", "st2v.attention", "st2v.ff", "st2v.conv", "st2v.blend", "st2v.embed",
          "st2v.cam", "st2v.resblock", "st2v.transformer")
NONE = "(no span)"


def spans(tr: Trace) -> List[Tuple[str, int, int]]:
    """The program's spans (name, start, end), outer before inner."""
    return sorted(((n, a, b) for n, a, b in tr.host if n.startswith(PREFIX)),
                  key=lambda s: (s[1], -s[2]))


def open_spans(tr: Trace) -> Optional[List[Tuple[str, ...]]]:
    """For each device operation of ``tr.ops``, the names of the spans open
    at its launch, outermost first; None without spans or launches."""
    sp = spans(tr)
    if not sp or not tr.ops or tr.launch_found < len(tr.ops):
        return None
    order = sorted(range(len(tr.ops)), key=lambda i: tr.ops[i].launch_ns)
    out: List[Tuple[str, ...]] = [()] * len(tr.ops)
    stack: List[Tuple[str, int, int]] = []
    j = 0
    for i in order:
        t = tr.ops[i].launch_ns
        while j < len(sp) and sp[j][1] <= t:
            while stack and stack[-1][2] < sp[j][1]:
                stack.pop()
            stack.append(sp[j])
            j += 1
        while stack and stack[-1][2] < t:
            stack.pop()
        out[i] = tuple(name for name, _, _ in stack)
    return out


def share(tr: Trace, pred) -> Optional[float]:
    """The share of the traced device time, in %, of the operations whose
    open spans (outermost first) satisfy ``pred``."""
    opened = open_spans(tr)
    total = tr.device_s()
    if opened is None or total <= 0:
        return None
    ns = sum(op.dur_ns for op, names in zip(tr.ops, opened) if pred(names))
    return 100.0 * ns / 1e9 / total


def innermost(names: Tuple[str, ...]) -> str:
    return names[-1] if names else NONE


def sampler_ms(tr: Trace, steps: int, harness: str) -> Optional[float]:
    """Device ms a step of the operations launched inside ``st2v.step`` and
    outside the network spans and the harness's ``harness`` span (whose
    hooks copy what the window produced).  Taken over the step spans that
    hold a network call, whose steps the trace holds whole, as their
    share of those spans' device time times the trace's device time a
    step."""
    opened = open_spans(tr)
    total = tr.device_s()
    if opened is None or steps <= 0 or total <= 0:
        return None
    steps_sp = [(a, b) for n, a, b in spans(tr) if n == STEP]
    nets = [a for n, a, b in spans(tr) if n in NETWORKS]
    whole = [(a, b) for a, b in steps_sp if any(a <= x <= b for x in nets)]
    hooks = sorted((a, b) for n, a, b in tr.spans if n == harness)
    inside = sampler = 0
    for op, names in zip(tr.ops, opened):
        t = op.launch_ns
        if STEP not in names or not any(a <= t <= b for a, b in whole):
            continue
        inside += op.dur_ns
        if not any(n in NETWORKS for n in names) and not any(a <= t <= b for a, b in hooks):
            sampler += op.dur_ns
    if inside <= 0:
        return None
    return 1e3 * total / steps * sampler / inside


def breakdown(tr: Trace) -> Optional[Dict[str, Dict[str, float]]]:
    """Device seconds by innermost ``st2v.`` span: in all, and in the
    class "elementwise / copies" of ``benchmark/kernel_classes.py``."""
    opened = open_spans(tr)
    if opened is None:
        return None
    out: Dict[str, Dict[str, float]] = defaultdict(lambda: {"device_s": 0.0, "elementwise_s": 0.0})
    for op, names in zip(tr.ops, opened):
        row = out[innermost(names)]
        row["device_s"] += op.dur_ns / 1e9
        if classify(op.name) == OTHER:
            row["elementwise_s"] += op.dur_ns / 1e9
    return dict(out)
