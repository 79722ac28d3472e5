"""sampler_ms.step: device milliseconds a guided step spends in operations
launched outside the harness's ``bench.network`` spans (the guidance, the
denoiser's scalings, the sampler's or the scheduler's update, the
write-back), from the traced steps."""

from benchmark.common import NETWORK_SPAN


def read(ctx):
    tr = ctx.trace
    if ctx.steps <= 0 or not tr.ops or tr.launch_found < len(tr.ops) or not tr.spans:
        return None
    spans = sorted((a, b) for n, a, b in tr.spans if n == NETWORK_SPAN)
    outside = 0
    for op in tr.ops:
        if not any(a <= op.launch_ns <= b for a, b in spans):
            outside += op.dur_ns
    return outside / 1e6 / ctx.steps
