"""cross_attention_share.step: the share of the traced device time, in %,
of the operations whose innermost program span is ``st2v.cross_attention``:
the decoupled text and image cross-attention's projections, its two
attentions and the residual add (its RMSNorms are ``st2v.norm``'s)."""

from benchmark import program_spans


def read(ctx):
    return program_spans.share(
        ctx.trace, lambda names: program_spans.innermost(names) == "st2v.cross_attention")
