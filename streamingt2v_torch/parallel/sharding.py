"""Logical axes, the active mesh, and where tensors are split and gathered
(counterpart of ``streamingt2v_tpu/parallel/sharding.py``).

The JAX package names the logical axis of each dim and lets GSPMD insert
the collectives.  The port keeps the same names and rules, but each rank
holds only its part of a split tensor, and the code that splits a tensor
(``shard``) or gathers it back (``gather``) is where the collectives are.
Both are ``autograd.Function``s, as are ``copy_to`` (the tensor-parallel
``copy_to_model``) and ``reduce_from_model``, so training differentiates
through them:

  shard       forward: this rank's block      backward: all-gather
  gather      forward: all-gather             backward: this rank's block
  gather sum  forward: all-gather             backward: reduce-scatter (sum)
  copy        forward: identity               backward: all-reduce (sum)
  reduce      forward: all-reduce (sum)       backward: identity

A tensor that is whole on every rank of a line carries the same gradient
on each of them; work split over the line hands each rank a partial
gradient of its input, which ``copy`` sums.  ``gather``'s backward keeps
this rank's block of a gradient that every rank holds whole, so it is
right only where the gathered tensor is used alike on every rank; where
each rank uses the gathered tensor for its own rows (k/v gathered over
seq for this rank's queries), ``gather_dim(..., sum_grads=True)`` sums the
ranks' gradients and keeps this rank's block.

A parameter used inside a block whose activations are split over seq
(``SpatialVideoTransformer._blocks``, CAM's per-pixel attention) gets only
this rank's tokens' part of its gradient: such a block names those
parameters (``seq_partial``), and the training step sums their gradients
over seq (``collect_seq_partial``).

Logical axes:

  batch   - video / CFG batch                 -> data
  tokens  - flattened spatial tokens          -> seq
  height  - spatial rows                      -> seq
  heads   - attention heads                   -> model
  mlp, channels_out - TP'd features           -> model
  frames, width, channels, embed, kernel, time -> replicated

A pipeline makes its mesh the active one (``active_mesh``) around the model
calls; the scope also records which mesh axes the activations are split
over at that point (``split_over``), so that an attention whose rows are
whole on several ranks (``replicated_axes``) splits them across those
ranks (``ops/attention._flash_sharded``).  Without an active mesh of more
than one rank every function here is the identity.
"""

from __future__ import annotations

import contextlib
import dataclasses
from contextvars import ContextVar
from typing import Dict, FrozenSet, Optional, Tuple

import torch
from torch import nn

from streamingt2v_torch.parallel.mesh import AXIS_DATA, AXIS_MODEL, AXIS_NAMES, AXIS_SEQ, Mesh

LOGICAL_RULES: Dict[str, Optional[str]] = {
    "batch": AXIS_DATA,
    "frames": None,
    "tokens": AXIS_SEQ,
    "height": AXIS_SEQ,
    "width": None,
    "heads": AXIS_MODEL,
    "mlp": AXIS_MODEL,
    "channels_out": AXIS_MODEL,
    "channels": None,
    "embed": None,
    "kernel": None,
    "time": None,
}


def spec_for(logical_axes: Tuple) -> Tuple:
    """The mesh axis (or None) of each logical axis: JAX's PartitionSpec."""
    return tuple(LOGICAL_RULES.get(a) if a is not None else None for a in logical_axes)


def _mesh_axes(name) -> Tuple[str, ...]:
    """Mesh axes of a logical name, or of a tuple of names folded into one
    dim (major to minor)."""
    names = name if isinstance(name, tuple) else (name,)
    return tuple(m for n in names if n is not None
                 if (m := LOGICAL_RULES.get(n)) is not None)


# ----------------------------------------------------- the active mesh ---

@dataclasses.dataclass(frozen=True)
class MeshScope:
    mesh: Mesh
    split: FrozenSet[str] = frozenset()

    def replicated(self) -> Tuple[str, ...]:
        """Mesh axes of more than one rank over which the activations are
        whole (every rank of the line holds the same tensor)."""
        return tuple(a for a in AXIS_NAMES if a not in self.split and self.mesh.shape[a] > 1)


_SCOPE: ContextVar[Optional[MeshScope]] = ContextVar("mesh_scope", default=None)


def current_scope() -> Optional[MeshScope]:
    return _SCOPE.get()


def get_active_mesh() -> Optional[Mesh]:
    scope = _SCOPE.get()
    return None if scope is None else scope.mesh


@contextlib.contextmanager
def active_mesh(mesh: Optional[Mesh]):
    """Make ``mesh`` the target of ``shard``/``gather`` (no activations
    split yet); a mesh of one rank, or None, leaves no mesh active."""
    token = _SCOPE.set(MeshScope(mesh) if mesh is not None and mesh.size > 1 else None)
    try:
        yield
    finally:
        _SCOPE.reset(token)


@contextlib.contextmanager
def split_over(*axes: str):
    """Within this block the activations are split over ``axes`` as well
    (each rank holds different rows along them)."""
    scope = _SCOPE.get()
    if scope is None or not axes:
        yield
        return
    token = _SCOPE.set(dataclasses.replace(scope, split=scope.split | frozenset(axes)))
    try:
        yield
    finally:
        _SCOPE.reset(token)


def is_split(axis: str) -> bool:
    scope = _SCOPE.get()
    return scope is not None and axis in scope.split and scope.mesh.shape[axis] > 1


# ------------------------------------------- differentiable collectives ---

class _Shard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return mesh.local_slice(x, axes, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_gather(g, ctx.axes, ctx.dim), None, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return mesh.all_gather(x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.local_slice(g, ctx.axes, ctx.dim).contiguous(), None, None, None


class _GatherSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return mesh.all_gather(x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        g = ctx.mesh.all_reduce(g.clone(), ctx.axes)
        return ctx.mesh.local_slice(g, ctx.axes, ctx.dim).contiguous(), None, None, None


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g.clone(), ctx.axes), None, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return mesh.all_reduce(x.clone(), axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def shard_dim(x: torch.Tensor, mesh: Mesh, axes, dim: int) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` over the mesh ``axes``."""
    return _Shard.apply(x, mesh, axes, dim) if mesh.axis_size(axes) > 1 else x


def gather_dim(x: torch.Tensor, mesh: Mesh, axes, dim: int, *,
               sum_grads: bool = False) -> torch.Tensor:
    """Every rank's block along ``dim`` over the mesh ``axes``, concatenated.
    Its backward keeps this rank's block of the gradient, or with
    ``sum_grads`` of the ranks' summed gradients (a reduce-scatter)."""
    if mesh.axis_size(axes) == 1:
        return x
    return (_GatherSum if sum_grads else _Gather).apply(x, mesh, axes, dim)


def copy_to(x: Optional[torch.Tensor], mesh: Mesh, axes) -> Optional[torch.Tensor]:
    """``x`` as the input of work split over the mesh ``axes``: whole on
    every rank of the line, its gradient the sum of the ranks' partial
    gradients."""
    if x is None or mesh.axis_size(axes) == 1:
        return x
    return _Copy.apply(x, mesh, axes)


def copy_to_model(x: Optional[torch.Tensor], mesh: Mesh) -> Optional[torch.Tensor]:
    """The input of a tensor-parallel unit (``copy_to`` over ``model``)."""
    return copy_to(x, mesh, AXIS_MODEL)


def reduce_from_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of the model ranks' partial outputs of a row-parallel layer."""
    if mesh.shape[AXIS_MODEL] == 1:
        return x
    return _Reduce.apply(x, mesh, AXIS_MODEL)


def shard(x: torch.Tensor, *logical_axes) -> torch.Tensor:
    """Split ``x`` on the active mesh: each dim whose logical axis maps to
    mesh axes that divide it keeps this rank's block (a tuple of names is a
    fold of several axes, split by all of them, major to minor); dims that
    do not divide stay whole, as in JAX.  The identity without an active
    mesh."""
    mesh = get_active_mesh()
    if mesh is None:
        return x
    for dim, name in enumerate(logical_axes):
        axes = _mesh_axes(name)
        if axes and x.shape[dim] % mesh.axis_size(axes) == 0:
            x = shard_dim(x, mesh, axes, dim)
    return x


def gather(x: torch.Tensor, *logical_axes) -> torch.Tensor:
    """The inverse of ``shard`` for a tensor that ``shard`` split along the
    same logical axes: every rank's blocks concatenated."""
    mesh = get_active_mesh()
    if mesh is None:
        return x
    for dim, name in enumerate(logical_axes):
        axes = _mesh_axes(name)
        if axes:
            x = gather_dim(x, mesh, axes, dim)
    return x


@contextlib.contextmanager
def data_parallel(mesh: Optional[Mesh], batch: int):
    """Run under ``mesh`` (made the active one); yields whether its data
    ranks split a batch of ``batch`` rows, and marks the activations split
    over ``data`` when they do.  Without a mesh it changes nothing (a mesh
    made active by the caller stays so)."""
    if mesh is None:
        yield False
        return
    with active_mesh(mesh):
        split = (mesh is not None and mesh.size > 1 and mesh.shape[AXIS_DATA] > 1
                 and batch % mesh.shape[AXIS_DATA] == 0)
        with split_over(AXIS_DATA) if split else contextlib.nullcontext():
            yield split


def batch_rows(split: bool, batch: int, x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """This rank's rows of a batch-leading tensor of ``batch`` rows when the
    batch is split (``data_parallel``); other tensors as they are."""
    if not split or x is None or x.ndim == 0 or x.shape[0] != batch:
        return x
    return shard(x, "batch")


# ------------------------------------- gradients split over the tokens ---

_SEQ_PARTIAL: ContextVar[Optional[dict]] = ContextVar("seq_partial", default=None)


@contextlib.contextmanager
def collect_seq_partial():
    """Yields a dict that collects, by id, the parameters that blocks running
    with their tokens split over seq name (``seq_partial``) while the scope
    is open: each seq rank holds only its tokens' part of their
    gradients."""
    found: dict = {}
    token = _SEQ_PARTIAL.set(found)
    try:
        yield found
    finally:
        _SEQ_PARTIAL.reset(token)


def seq_partial(params) -> None:
    """Name ``params`` as used on this rank's seq block of the tokens."""
    found = _SEQ_PARTIAL.get()
    if found is not None:
        found.update((id(p), p) for p in params)


# ------------------------------------------------ tensor parallelism -----
# Megatron-style TP over the transformer projections:
#   column-parallel (output features on `model`): q/k/v, the GEGLU
#     up-projection, the transformer's (and CAM's) proj_in;
#   row-parallel (input features on `model`, then an all-reduce): the
#     attention output projection and the FF down-projection.
# Everything else (convs, norms, embeddings) is replicated.
_COL_PARALLEL_SEGMENTS = frozenset({"to_q", "to_k", "to_v", "qkv", "proj_in"})
_FF_SEGMENTS = frozenset({"ff", "ff_in"})


def _param_logical_axes(segments: Tuple[str, ...], ndim: int) -> Tuple[Optional[str], ...]:
    """Logical axes of a parameter from its state-dict path segments and
    rank, in the port's layouts (a Dense kernel is (out, in)).  A
    column-parallel layer's bias is split with its kernel's rows; a
    row-parallel layer's bias is added once, after the reduction."""
    segs = tuple(s.lower() for s in segments)
    leaf = segs[-1] if segs else ""
    parent = segs[-2] if len(segs) >= 2 else ""
    grandparent = segs[-3] if len(segs) >= 3 else ""
    col = parent in _COL_PARALLEL_SEGMENTS or (parent == "proj" and grandparent in _FF_SEGMENTS)
    row = parent == "to_out" or (parent == "out" and grandparent in _FF_SEGMENTS)
    if leaf == "kernel" and ndim == 2:
        if col:
            return ("channels_out", "channels")
        if row:
            return ("channels", "channels_out")
        return (None, "channels")
    if leaf == "bias" and ndim == 1 and col:
        return ("channels_out",)
    return (None,) * ndim


def _col_block(w: torch.Tensor, m: int, r: int, halves: int) -> torch.Tensor:
    """Rank r's rows of a column-parallel weight (or bias) whose rows hold
    ``halves`` stacked blocks (the GEGLU [a | b]): block r of each half."""
    parts = w.chunk(halves, dim=0)
    return torch.cat([p.chunk(m, dim=0)[r] for p in parts], dim=0)


@torch.no_grad()
def shard_params(module: nn.Module, mesh: Optional[Mesh]) -> nn.Module:
    """Keep this rank's slice of every column- and row-parallel weight of
    ``module`` (by ``_param_logical_axes``), in place, and mark each unit
    that was split (``unit.tp = mesh``): its forward then computes its
    partial result and reduces it over ``model``.  A unit whose width does
    not divide the model axis at its granularity (a head, a hidden unit)
    stays whole, as the JAX package leaves an indivisible dim whole.  A
    module with such layers but no tensor-parallel forward raises.  The
    identity on a mesh without a model axis."""
    if mesh is None or mesh.shape[AXIS_MODEL] == 1:
        return module
    from streamingt2v_torch.models.layers import Dense

    m, r = mesh.shape[AXIS_MODEL], mesh.axis_index(AXIS_MODEL)
    for name, unit in module.named_modules():
        kinds = {}
        for cname, child in unit.named_children():
            if isinstance(child, Dense):
                segs = tuple(f"{name}.{cname}".split(".")) + ("kernel",) if name else (
                    cname, "kernel")
                axes = _param_logical_axes(segs, 2)
                if "channels_out" in axes:
                    kinds[cname] = axes.index("channels_out")
        if not kinds:
            continue
        if not hasattr(unit, "tp_divides"):
            raise TypeError(f"{name or type(unit).__name__}: column/row-parallel layers "
                            f"{sorted(kinds)} but no tensor-parallel forward")
        if not unit.tp_divides(m):
            continue
        for cname, dim in kinds.items():
            dense = getattr(unit, cname)
            halves = 2 if cname == "proj" else 1     # the GEGLU up-projection's [a | b]
            if dim == 0:
                dense.kernel = nn.Parameter(_col_block(dense.kernel, m, r, halves).contiguous(),
                                            requires_grad=dense.kernel.requires_grad)
                if dense.bias is not None:
                    dense.bias = nn.Parameter(_col_block(dense.bias, m, r, halves).contiguous(),
                                              requires_grad=dense.bias.requires_grad)
            else:
                dense.kernel = nn.Parameter(dense.kernel.chunk(m, dim=1)[r].contiguous(),
                                            requires_grad=dense.kernel.requires_grad)
        unit.tp = mesh
    return module


def tp_units(module: nn.Module):
    """(name, unit) of each tensor-parallel unit that ``shard_params`` split."""
    return [(n, u) for n, u in module.named_modules() if getattr(u, "tp", None) is not None]


@torch.no_grad()
def gather_params(module: nn.Module, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Whole tensors from this rank's slices: ``tensors`` (parameters or
    their gradients, by ``module``'s parameter names) with every slice that
    ``shard_params`` took gathered back over ``model``; the others as they
    are.  Every model rank must call it."""
    out = dict(tensors)
    for name, unit in tp_units(module):
        mesh = unit.tp
        for cname, child in unit.named_children():
            segs = tuple(f"{name}.{cname}".split(".")) if name else (cname,)
            for leaf in ("kernel", "bias"):
                key = ".".join(segs + (leaf,))
                if key not in out or out[key] is None:
                    continue
                axes = _param_logical_axes(segs + (leaf,), out[key].dim())
                if "channels_out" not in axes:
                    continue
                dim = axes.index("channels_out")
                halves = 2 if cname == "proj" else 1
                if dim == 0 and halves == 2:
                    parts = [mesh.all_gather(p.contiguous(), AXIS_MODEL, 0)
                             for p in out[key].chunk(2, dim=0)]
                    out[key] = torch.cat(parts, dim=0)
                else:
                    out[key] = mesh.all_gather(out[key].contiguous(), AXIS_MODEL, dim)
    return out
