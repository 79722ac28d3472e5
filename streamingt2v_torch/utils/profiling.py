"""The port's tracing: per-stage wall-clock timers, named spans and
counters, with one process-wide report (counterpart of
``streamingt2v_tpu/utils/profiling.py``).

``stage_timer`` synchronises the card at the stage's edges, so that a
stage's seconds are its own work and not the queue it inherited or left
behind.  With ``STREAMINGT2V_TRACE_DIR`` set, each timed stage is also
recorded by ``torch.profiler`` and written there as a Chrome trace,
``<name>.<call>.json``.

``span(name)`` marks a region of the program (a sampler step, a network
call, a block) in the profiler's timeline, as a ``record_function`` range
on the profiler's own clock, so that each device operation can be
attributed to the innermost span open when it was launched.  Spans exist
only while a profiler collects: otherwise ``span`` costs one check and
returns a shared no-op.  Every span of the program is named ``st2v.*``:

- call: ``st2v.chunk`` (a sampler run over one chunk's latents; stage 2's
  SDEdit loop), ``st2v.condition``, ``st2v.decode``;
- step: ``st2v.step``, one sampler or DDIM step;
- network: ``st2v.unet``, ``st2v.controlnet``, ``st2v.vae_decoder``,
  ``st2v.dit`` (the CogVideoX transformer);
- block: ``st2v.norm``, ``st2v.attention``, ``st2v.ff``, ``st2v.conv``,
  ``st2v.blend``, ``st2v.embed``, ``st2v.cam``, ``st2v.resblock``,
  ``st2v.transformer``, ``st2v.rope`` (applying the rotary embedding),
  ``st2v.modulate`` (AdaLN's shift, scale and gate arithmetic and the
  gated residual adds);
- set-up: ``st2v.kernel_build``, the CUDA kernels' build or load.

Counters (``count``, ``read_counters``, ``reset_counters``) count what
the program did whether or not a profiler runs: ``steps``, ``unet_calls``,
``controlnet_calls``, ``vae_decoder_calls``, ``dit_calls``, ``decode_pieces``,
``rope_tables`` (rotary tables built), ``kernel_builds`` and
``kernel_build_s``, and the kernels' launches (``launches.<wrapper>``,
read by ``read_launches``).
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from collections import defaultdict
from typing import Dict, List

import torch

_STAGE_TIMES: Dict[str, List[float]] = defaultdict(list)
_COUNTERS: Dict[str, float] = defaultdict(int)

# the kernels' wrappers (K1-K7; K5's statistics alone, for K4's prologue, as
# ``fused_group_norm_affine``; K7's RMS entry as ``rms_norm``), with the bf16
# instances each counts apart (``<name>_d512``, ``<name>_d128``) and whether
# it counts its f32 launches (``<name>_f32``) apart
KERNELS = (("flash_attention", ("d512", "d128"), True),
           ("flash_attention_packed", ("d512",), True), ("geglu_ff", (), False),
           ("temporal_conv", (), True), ("fused_group_norm", (), False),
           ("fused_temporal_attention", (), True), ("fused_group_norm_affine", (), True),
           ("layer_norm", (), True), ("rms_norm", (), True))
LAUNCHES = "launches."


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
    """Per stage its calls and seconds; and, once anything was counted, the
    counters under ``counters``."""
    out = {}
    for name, times in _STAGE_TIMES.items():
        out[name] = {
            "calls": len(times),
            "total_s": round(sum(times), 3),
            "mean_s": round(sum(times) / len(times), 3),
            "last_s": round(times[-1], 3),
        }
    if _COUNTERS:
        out["counters"] = read_counters()
    return out


def stage_seconds(which: str = "total_s") -> Dict[str, float]:
    """Each timed stage's ``total_s`` or ``last_s``."""
    return {name: v[which] for name, v in timing_report().items() if name != "counters"}


def reset_timers() -> None:
    """Clear the stage times and the counters (the report's contents)."""
    _STAGE_TIMES.clear()
    reset_counters()


# ---------------------------------------------------------------- spans ---

def _spanned(name: str, fn):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with span(name):
            return fn(*args, **kwargs)
    return wrapper


class _Recorded(torch.profiler.record_function):
    """A ``record_function`` range; as a decorator, a span on every call."""

    def __call__(self, fn):
        return _spanned(self.name, fn)


class _NoSpan:
    """The no-op a span is while no profiler collects: one per name, shared."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> bool:
        return False

    def __call__(self, fn):
        return _spanned(self.name, fn)


_NO_SPANS: Dict[str, _NoSpan] = {}


def span(name: str):
    """A named region, as a context manager (``with span("st2v.step"):``) or
    a decorator (``@span("st2v.norm")``, decided at each call): while the
    profiler collects, a ``record_function`` range; otherwise the name's
    shared no-op."""
    if torch.autograd._profiler_enabled():
        return _Recorded(name)
    off = _NO_SPANS.get(name)
    if off is None:
        off = _NO_SPANS.setdefault(name, _NoSpan(name))
    return off


# ------------------------------------------------------------- counters ---

def count(name: str, n: float = 1) -> None:
    _COUNTERS[name] += n


def read_counters() -> Dict[str, float]:
    return dict(_COUNTERS)


def reset_counters() -> None:
    _COUNTERS.clear()


def count_launch(name: str, *, d512: bool = False, d128: bool = False,
                 f32: bool = False) -> None:
    """One launch of the kernel behind wrapper ``name``; ``d512``: of its bf16
    D=512 instance, ``d128``: of its bf16 D=128 one, ``f32``: in f32 (each
    also counted apart)."""
    count(LAUNCHES + name)
    if d512:
        count(LAUNCHES + name + "_d512")
    if d128:
        count(LAUNCHES + name + "_d128")
    if f32:
        count(LAUNCHES + name + "_f32")


def reset_launches() -> None:
    for name in [k for k in _COUNTERS if k.startswith(LAUNCHES)]:
        del _COUNTERS[name]


def read_launches(f32: bool = False) -> Dict[str, int]:
    """Launches per wrapper, and the flash wrappers' bf16 D=512 launches and
    K1's bf16 D=128 ones apart (``<name>_d512``, ``<name>_d128``, also counted
    in ``<name>``); with ``f32``, also the f32 launches of the wrappers that
    count them (``<name>_f32``: K1, K2, K4, K6, K5's affine entry and both
    of K7's entries)."""
    out = {}
    for name, instances, counts_f32 in KERNELS:
        keys = ([name] + [f"{name}_{i}" for i in instances]
                + [name + "_f32"] * (f32 and counts_f32))
        for key in keys:
            out[key] = int(_COUNTERS.get(LAUNCHES + key, 0))
    return out
