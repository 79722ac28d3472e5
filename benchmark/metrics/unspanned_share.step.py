"""unspanned_share.step: the share of the traced device time, in %, of the
operations launched inside a network span of the program (``st2v.unet``,
``st2v.controlnet``, ``st2v.vae_decoder``) but inside none of its block
spans: the device time that the block spans leave without an owner."""

from benchmark import program_spans


def read(ctx):
    networks = program_spans.NETWORKS
    return program_spans.share(ctx.trace, lambda names: program_spans.innermost(names) in networks)
