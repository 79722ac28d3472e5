"""Operations and bytes: the yardstick of the ``mfu.*`` and ``*_roofline``
metrics, worked out from the reference's shapes and never from the
program's code.

- ``model_flops(fn)``: the floating-point operations of ``fn`` (a unit of
  the reference on the meta device), as ``torch.utils.flop_counter``
  counts them: 2 per multiply-add of every matrix product and convolution.
- Each kernel's bound, per call, the larger of its operations at the
  bf16 dense peak and its bytes at HBM bandwidth (each input read once,
  each output written once, bf16):
  * GEGLU feed-forward (K3), inner 4C: up C -> 2 x 4C and down 4C -> C,
    24 M C^2 operations; bytes x, the weights and the output;
  * attention (K1/K2, the D=64 body): QK^T and PV, 4 B H Lq Lk D; bytes
    q, k, v and o;
  * (kt, 1, 1) temporal convolution (K4): 2 B T S kt C C_out; bytes x and
    the output (and the residual it adds, where it takes one).
- Which calls of the reference run on each kernel is the kernel's
  geometry gate, stated here as the published kernels state it: the
  flash geometries (Lq Lk >= 2048^2, or Lq >= 4096 and f32 scores of
  256 MiB or more), GEGLU feed-forwards of 256 rows or more with an inner
  width divisible by 128, temporal convolutions of 64 pixels or more.

Peaks (NVIDIA H100 SXM data sheet, dense): 989 TFLOP/s bf16, 3.35 TB/s HBM3.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import torch

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
BF16 = 2


def model_flops(fn: Callable[[], object]) -> Tuple[int, List[dict]]:
    """(FLOPs, op log) of ``fn()`` run on the meta device."""
    from torch.utils.flop_counter import FlopCounterMode

    from benchmark.reference import ops

    log: List[dict] = []
    with torch.no_grad(), ops.recording(log), FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops(), log


def geglu_ff(m: int, c: int, inner: int) -> Tuple[float, float]:
    """(operations, bytes) of one pre-LN GEGLU feed-forward over m rows."""
    flops = 2.0 * m * c * (2 * inner) + 2.0 * m * inner * c
    nbytes = BF16 * (2.0 * m * c + c * 2 * inner + inner * c)
    return flops, nbytes


def attention(bh: int, lq: int, lk: int, d: int) -> Tuple[float, float]:
    return 4.0 * bh * lq * lk * d, BF16 * float(bh) * d * (2 * lq + 2 * lk)


def time_conv(b: int, t: int, s: int, c: int, c_out: int, kt: int,
              residual: bool = False) -> Tuple[float, float]:
    rows = float(b) * t * s
    return 2.0 * rows * kt * c * c_out, BF16 * rows * (c + c_out * (2 if residual else 1))


def bound_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def flash_geometry(bh: int, lq: int, lk: int) -> bool:
    return lq * lk >= 2048 * 2048 or (lq >= 4096 and bh * lq * lk * 4 >= 256 * 1024 * 1024)


def k3_calls(log: List[dict]) -> List[dict]:
    return [o for o in log if o["kind"] == "geglu_ff" and o["m"] >= 256 and o["inner"] % 128 == 0]


def flash_d64_calls(log: List[dict]) -> List[dict]:
    return [o for o in log if o["kind"] == "attention" and o["d"] <= 64
            and flash_geometry(o["bh"], o["lq"], o["lk"])]


def k4_calls(log: List[dict]) -> List[dict]:
    return [o for o in log if o["kind"] == "time_conv" and o["s"] >= 64]


def bound_of(calls: List[dict]) -> float:
    """Seconds the calls need at least, each bound by operations or bytes."""
    total = 0.0
    for o in calls:
        if o["kind"] == "geglu_ff":
            total += bound_s(*geglu_ff(o["m"], o["c"], o["inner"]))
        elif o["kind"] == "attention":
            total += bound_s(*attention(o["bh"], o["lq"], o["lk"], o["d"]))
        else:
            total += bound_s(*time_conv(o["b"], o["t"], o["s"], o["c"], o["c_out"], o["kt"],
                                        o["residual"]))
    return total
