"""norm_share.step: the share of the traced device time, in %, of the
operations whose innermost program span is ``st2v.norm`` (``ops/norms.py``'s
GroupNorm, its affine form and LayerNorm, on the plain path or K5)."""

from benchmark import program_spans


def read(ctx):
    return program_spans.share(ctx.trace,
                               lambda names: program_spans.innermost(names) == program_spans.NORM)
