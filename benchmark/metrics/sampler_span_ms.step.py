"""sampler_span_ms.step: device milliseconds a guided step spends in
operations the program launched inside its ``st2v.step`` span and outside
its network spans (``st2v.unet``, ``st2v.controlnet``): the guidance, the
denoiser's scalings, the sampler's or the scheduler's update, the
write-back.  The harness's copies, made from its hooks inside its
``bench.network`` span, are left out."""

from benchmark import program_spans
from benchmark.common import NETWORK_SPAN


def read(ctx):
    return program_spans.sampler_ms(ctx.trace, ctx.steps, NETWORK_SPAN)
