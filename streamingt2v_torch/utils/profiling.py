"""Per-stage wall-clock timers with a process-wide report (counterpart of
``streamingt2v_tpu/utils/profiling.py``).

``stage_timer`` synchronises the card at the stage's edges, so that a
stage's seconds are its own work and not the queue it inherited or left
behind.  With ``STREAMINGT2V_TRACE_DIR`` set, each timed stage is also
recorded by ``torch.profiler`` and written there as a Chrome trace,
``<name>.<call>.json``.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, List

import torch

_STAGE_TIMES: Dict[str, List[float]] = defaultdict(list)


def _sync() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def stage_timer(name: str):
    trace_dir = os.environ.get("STREAMINGT2V_TRACE_DIR")
    prof = None
    if trace_dir:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
    _sync()
    t0 = time.perf_counter()
    with prof if prof is not None else contextlib.nullcontext():
        yield
        _sync()
    _STAGE_TIMES[name].append(time.perf_counter() - t0)
    if prof is not None:
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir,
                                              f"{name}.{len(_STAGE_TIMES[name])}.json"))


def timing_report() -> Dict[str, Dict[str, float]]:
    out = {}
    for name, times in _STAGE_TIMES.items():
        out[name] = {
            "calls": len(times),
            "total_s": round(sum(times), 3),
            "mean_s": round(sum(times) / len(times), 3),
            "last_s": round(times[-1], 3),
        }
    return out


def reset_timers() -> None:
    _STAGE_TIMES.clear()
