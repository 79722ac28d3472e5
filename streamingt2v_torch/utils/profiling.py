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


def kernel_wrappers() -> tuple:
    """The wrappers of the six hand-written kernels (K1-K6), each with its
    launch counter ``launches``."""
    from streamingt2v_torch.ops.flash_attention import flash_attention, flash_attention_packed
    from streamingt2v_torch.ops.fused_ff import geglu_ff
    from streamingt2v_torch.ops.fused_group_norm import fused_group_norm
    from streamingt2v_torch.ops.temporal_attention import fused_temporal_attention
    from streamingt2v_torch.ops.temporal_conv import temporal_conv

    return (flash_attention, flash_attention_packed, geglu_ff, temporal_conv, fused_group_norm,
            fused_temporal_attention)


def reset_launches() -> None:
    for fn in kernel_wrappers():
        fn.launches = 0
        for apart in ("launches_d512", "launches_f32"):
            if hasattr(fn, apart):
                setattr(fn, apart, 0)


def read_launches(f32: bool = False) -> Dict[str, int]:
    """Launches per wrapper, and the flash wrappers' bf16 D=512 launches apart
    (``<name>_d512``, also counted in ``<name>``); with ``f32``, also the f32
    launches of the wrappers that count them (``<name>_f32``: K1, K2, K4, K6)."""
    out = {}
    for fn in kernel_wrappers():
        out[fn.__name__] = fn.launches
        if hasattr(fn, "launches_d512"):
            out[fn.__name__ + "_d512"] = fn.launches_d512
        if f32 and hasattr(fn, "launches_f32"):
            out[fn.__name__ + "_f32"] = fn.launches_f32
    return out
