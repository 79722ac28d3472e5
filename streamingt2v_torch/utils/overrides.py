"""Dotted-path config overrides (a copy of
``streamingt2v_tpu/utils/overrides.py``, which imports no framework).

The reference lets CLI flags override nested config
(`--model.init_args.inference_params.use_memopt`, inference_i2v.py:62-64).
The equivalent here: `--set inference.fps_id=7 --set sampler.num_steps=25`
applied to the frozen dataclass tree.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence


def _parse_value(raw: str, current: Any) -> Any:
    if isinstance(current, bool):
        return raw.lower() in ("1", "true", "yes", "on")
    if isinstance(current, int) and not isinstance(current, bool):
        return int(raw)
    if isinstance(current, float):
        return float(raw)
    if isinstance(current, tuple):
        elem = current[0] if current else 0
        return tuple(type(elem)(v) for v in raw.split(","))
    return raw


def apply_override(cfg: Any, dotted: str, raw_value: str) -> Any:
    """Return a copy of the dataclass tree with `a.b.c=value` applied."""
    parts = dotted.split(".")

    def rec(node: Any, idx: int) -> Any:
        name = parts[idx]
        if not hasattr(node, name):
            raise AttributeError(
                f"config path '{dotted}': {type(node).__name__} has no field '{name}'"
            )
        current = getattr(node, name)
        if idx == len(parts) - 1:
            return dataclasses.replace(node, **{name: _parse_value(raw_value, current)})
        return dataclasses.replace(node, **{name: rec(current, idx + 1)})

    return rec(cfg, 0)


def apply_overrides(cfg: Any, assignments: Sequence[str]) -> Any:
    for a in assignments:
        if "=" not in a:
            raise ValueError(f"override '{a}' must be key.path=value")
        key, val = a.split("=", 1)
        cfg = apply_override(cfg, key.strip(), val.strip())
    return cfg
