"""Saving and loading training state (counterpart of
``streamingt2v_tpu/utils/state_io.py``, which uses orbax, a JAX library):
a tree of dicts, lists and tensors (the engine's parameters, optimizer
state, EMA and step) in one ``torch.save`` file, written atomically and
read back with ``torch.load(weights_only=True)``, which unpickles only
tensors and plain containers."""

from __future__ import annotations

import os
from typing import Any, Optional

import torch


def save_pytree(path: str, tree: Any) -> str:
    """Write ``tree`` to ``path`` (a temporary file renamed into place);
    returns the absolute path."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(tree, tmp)
    os.replace(tmp, path)
    return path


def _check_like(tree: Any, template: Any, where: str = "") -> None:
    if isinstance(template, dict):
        if not isinstance(tree, dict) or set(tree) != set(template):
            raise ValueError(f"state{where}: keys differ from the template's")
        for k in template:
            _check_like(tree[k], template[k], f"{where}[{k!r}]")
    elif isinstance(template, (list, tuple)):
        if not isinstance(tree, (list, tuple)) or len(tree) != len(template):
            raise ValueError(f"state{where}: length differs from the template's")
        for i, (a, b) in enumerate(zip(tree, template)):
            _check_like(a, b, f"{where}[{i}]")
    elif isinstance(template, torch.Tensor):
        if not isinstance(tree, torch.Tensor) or tree.shape != template.shape \
                or tree.dtype != template.dtype:
            raise ValueError(f"state{where}: not a {template.dtype} tensor of shape "
                             f"{tuple(template.shape)}")


def load_pytree(path: str, template: Optional[Any] = None, map_location="cpu") -> Any:
    """The tree saved at ``path``, its tensors on ``map_location``; with a
    ``template``, checked to have its structure, shapes and dtypes."""
    tree = torch.load(os.path.abspath(path), map_location=map_location, weights_only=True)
    if template is not None:
        _check_like(tree, template)
    return tree
