"""rope_share.step: the share of the traced device time, in %, of the
operations whose innermost program span is ``st2v.rope``: the rotary
embedding applied to the video tokens' q and k (``ops/rope.apply_rope``)."""

from benchmark import program_spans


def read(ctx):
    return program_spans.share(ctx.trace,
                               lambda names: program_spans.innermost(names) == "st2v.rope")
