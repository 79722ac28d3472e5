"""The kernel routing in force for the current call (``config.KernelRouting``).

A pipeline sets it around its public calls with ``use_routing``; the ops
that have an optional kernel route read it with ``current_routing``.  It is a
``ContextVar``, so concurrent callers (threads, tasks) each see their own,
and outside any pipeline call it is the JAX package's default: all off.
"""

from __future__ import annotations

import contextlib
from contextvars import ContextVar

from streamingt2v_torch.config import KernelRouting

_ROUTING: ContextVar = ContextVar("kernel_routing", default=KernelRouting())


def current_routing() -> KernelRouting:
    return _ROUTING.get()


@contextlib.contextmanager
def use_routing(routing: KernelRouting):
    token = _ROUTING.set(routing)
    try:
        yield routing
    finally:
        _ROUTING.reset(token)
