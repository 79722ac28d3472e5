"""Numerical-failure detection (counterpart of the non-finite half of
``streamingt2v_tpu/utils/resilience.py``): a host audit that names every
non-finite leaf, an on-device all-finite flag and the training guard that
zeroes an update which is not finite.  A tree is a tensor or a dict, list
or tuple of trees."""

from __future__ import annotations

from typing import Any, Iterable, Iterator, Optional, Tuple

import torch


class NonFiniteError(ValueError):
    def __init__(self, name: str, bad: Iterable[str]):
        self.bad_leaves = list(bad)
        super().__init__(
            f"non-finite values in {name}: {', '.join(self.bad_leaves[:8])}"
            + ("..." if len(self.bad_leaves) > 8 else ""))


def _leaves(tree: Any, path: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """(path, tensor) of every floating leaf."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    elif isinstance(tree, torch.Tensor) and tree.is_floating_point():
        yield path, tree


def _map(fn, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) and tree.is_floating_point() else tree


def check_finite(tree: Any, name: str = "tree") -> None:
    """Host audit: raise ``NonFiniteError`` naming every non-finite leaf.
    Waits for the device: for stage boundaries and tests, not every step."""
    bad = [path for path, leaf in _leaves(tree) if not bool(torch.isfinite(leaf).all())]
    if bad:
        raise NonFiniteError(name, bad)


def tree_all_finite(tree: Any) -> torch.Tensor:
    """A bool scalar on the leaves' device: True iff every floating leaf is
    finite (no host sync)."""
    flags = [torch.isfinite(leaf).all() for _, leaf in _leaves(tree)]
    return torch.stack(flags).all() if flags else torch.tensor(True)


def nonfinite_guard(updates: Any, ok: Optional[torch.Tensor] = None) -> tuple:
    """(updates zeroed unless ``ok``, ok); ``ok`` defaults to
    ``tree_all_finite(updates)``.  On the device, no host sync."""
    if ok is None:
        ok = tree_all_finite(updates)
    return _map(lambda u: torch.where(ok, u, torch.zeros_like(u)), updates), ok
