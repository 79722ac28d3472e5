"""The backward passes of K3 and K4: the VJP of a kernel's plain version,
taken in chunks.

The JAX package differentiates its Pallas kernels by ``jax.custom_vjp``s
whose backward recomputes the plain math and takes its VJP
(``streamingt2v_tpu/ops/fused_ff.py:194-222``, ``temporal_conv.py:145-175``).
The port does the same with autograd (K1 and K2 write their VJP out,
``ops/flash_attention.py``), over chunks of one axis of the operands that
carry it (rows of x for K3, positions of x and res for K4), so that the f32
intermediates of one chunk stay within a budget: the gradients of those
operands are written chunk by chunk, those of the others (weights, biases,
per-row affines) summed over the chunks in f32.  Every gradient is returned
in its operand's dtype, and an absent (``None``) operand gets ``None``.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

# One backward chunk's f32 working set (K1's probabilities and their
# gradient; K3's and K4's intermediates under autograd) stays within this
# many bytes: each kernel's ``backward_chunk_*`` sizes its chunks by it.
BWD_CHUNK_BYTES = 4 << 30


def chunked_vjp(fn: Callable, operands: Sequence[Optional[torch.Tensor]], sliced: Sequence[int],
                grad_out: torch.Tensor, axis: int, rows: int) -> tuple:
    """The VJP of ``fn(*operands)`` for the cotangent ``grad_out``, in chunks
    of ``rows`` along ``axis`` of the operands indexed by ``sliced``, of
    ``fn``'s output and of ``grad_out``.  Returns (gradients, chunks run)."""
    live = [i for i, o in enumerate(operands) if o is not None]
    shared = {i: operands[i].detach().float().requires_grad_() for i in live if i not in sliced}
    grads = [None] * len(operands)
    for i in live:
        grads[i] = torch.empty_like(operands[i]) if i in sliced else torch.zeros_like(shared[i])
    n = grad_out.shape[axis]
    chunks = 0
    for start in range(0, n, rows):
        count = min(rows, n - start)
        args = list(operands)
        for i in live:
            args[i] = (operands[i].detach().narrow(axis, start, count).requires_grad_()
                       if i in sliced else shared[i])
        with torch.enable_grad():
            out = fn(*args)
            got = torch.autograd.grad(out, [args[i] for i in live],
                                      grad_out.narrow(axis, start, count), allow_unused=True)
        for i, g in zip(live, got):
            if i in sliced:
                grads[i].narrow(axis, start, count).copy_(g)
            elif g is not None:
                grads[i] += g
        chunks += 1
    return tuple(None if g is None else g.to(operands[i].dtype)
                 for i, g in enumerate(grads)), chunks
