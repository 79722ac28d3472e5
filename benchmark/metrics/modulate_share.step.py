"""modulate_share.step: the share of the traced device time, in %, of the
operations whose innermost program span is ``st2v.modulate``: AdaLN's
shift, scale and gate (their linear of SiLU(temb) and the arithmetic on the
normed tokens) and the gated residual adds."""

from benchmark import program_spans


def read(ctx):
    return program_spans.share(ctx.trace,
                               lambda names: program_spans.innermost(names) == "st2v.modulate")
