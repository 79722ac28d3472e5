"""unspanned_share.dit: the share of the traced device time, in %, of the
operations launched inside the program's ``st2v.dit`` span (the video
transformer's forward) but inside none of its block spans: the device time
that the block spans leave without an owner."""

from benchmark import program_spans


def read(ctx):
    return program_spans.share(ctx.trace,
                               lambda names: program_spans.innermost(names) == "st2v.dit")
