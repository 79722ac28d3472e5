"""The (data, seq, model) device mesh on ``torch.distributed`` (counterpart
of ``streamingt2v_tpu/parallel/mesh.py``).

The JAX package lays a ``jax.sharding.Mesh`` over the chips of one program
and lets GSPMD insert the collectives.  The port runs one process per rank
(one card each under NCCL, or a CPU process under gloo) and writes each
collective itself, so its mesh is a grid of ranks with a process group for
every set of axes:

  data  - DP over the CFG (uncond | cond) pair, chunks and pair batches;
  seq   - SP over the spatial tokens inside the spatial transformers;
  model - TP over attention heads and feed-forward hidden units.

Axis order is (data, seq, model), ``data`` outermost, so that across hosts
only ``data`` crosses the slower links (``multihost.py``).
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from streamingt2v_torch.config import MeshConfig

AXIS_DATA = "data"
AXIS_SEQ = "seq"
AXIS_MODEL = "model"
AXIS_NAMES = (AXIS_DATA, AXIS_SEQ, AXIS_MODEL)

Axes = Union[str, Sequence[str]]


def mesh_shape_for(n_devices: int, prefer_model: int = 1) -> MeshConfig:
    """A mesh of ``n_devices`` ranks: all on ``data`` (the CFG pair, the
    chunks and the pair batches give ample batch parallelism), with a
    ``model`` axis of gcd(prefer_model, n) carved out where asked."""
    model = math.gcd(prefer_model, n_devices)
    return MeshConfig(data=n_devices // model, seq=1, model=model)


def canonical_axes(axes: Axes) -> Tuple[str, ...]:
    """A mesh axis or several, in (data, seq, model) order: the order in
    which a folded dim nests them, major to minor."""
    names = (axes,) if isinstance(axes, str) else tuple(axes)
    unknown = set(names) - set(AXIS_NAMES)
    if unknown:
        raise ValueError(f"unknown mesh axes {sorted(unknown)}")
    return tuple(a for a in AXIS_NAMES if a in names)


def rank_grid(cfg: MeshConfig, ranks: Sequence[int]) -> np.ndarray:
    """The first ``cfg.num_devices`` of ``ranks`` as a (data, seq, model)
    grid; raises when there are fewer."""
    if cfg.num_devices > len(ranks):
        raise ValueError(f"mesh {cfg} needs {cfg.num_devices} ranks, have {len(ranks)}")
    return np.asarray(list(ranks)[:cfg.num_devices]).reshape(cfg.data, cfg.seq, cfg.model)


class MeshLayout:
    """A (data, seq, model) shape and one rank's coordinates in it (None
    for a rank outside it): the index math of a mesh, without groups."""

    def __init__(self, cfg: MeshConfig, coords: Optional[Dict[str, int]]):
        self.cfg = cfg
        self.coords = coords

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.cfg.data, "seq": self.cfg.seq, "model": self.cfg.model}

    @property
    def size(self) -> int:
        return self.cfg.num_devices

    def axis_size(self, axes: Axes) -> int:
        return math.prod(self.shape[a] for a in canonical_axes(axes))

    def axis_index(self, axes: Axes) -> int:
        """This rank's linear index along ``axes`` (major to minor)."""
        idx = 0
        for a in canonical_axes(axes):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def local_slice(self, x: torch.Tensor, axes: Axes, dim: int) -> torch.Tensor:
        """This rank's block of ``x`` along ``dim`` (which the line divides)."""
        n = self.axis_size(axes)
        if n == 1:
            return x
        size = x.shape[dim] // n
        return x.narrow(dim, self.axis_index(axes) * size, size)


class Mesh(MeshLayout):
    """A grid of ``torch.distributed`` ranks with one process group for each
    line of ranks along every set of axes (only where that set has more
    than one rank).  Built by every rank of the world alike, as
    ``new_group`` requires; a rank outside the grid has ``coords`` None.
    A mesh is a handle to its groups: copying a module that refers to it
    shares it."""

    def __init__(self, cfg: MeshConfig, grid: np.ndarray, device: torch.device):
        self.grid = grid
        self.device = device
        self.rank = dist.get_rank()
        where = np.argwhere(grid == self.rank)
        super().__init__(cfg, dict(zip(AXIS_NAMES, (int(i) for i in where[0])))
                         if len(where) else None)
        # axes -> (group, the line's ranks in linear-index order)
        self._groups: Dict[Tuple[str, ...], Tuple[object, List[int]]] = {}
        for k in range(1, len(AXIS_NAMES) + 1):
            for axes in itertools.combinations(AXIS_NAMES, k):
                if self.axis_size(axes) == 1:
                    continue
                for line in self._lines(axes):
                    group = dist.new_group(ranks=line)
                    if self.rank in line:
                        self._groups[axes] = (group, line)

    def __deepcopy__(self, memo):
        return self

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank}, coords={self.coords})"

    def _lines(self, axes: Tuple[str, ...]) -> List[List[int]]:
        """Every line of ranks along ``axes``: the other axes fixed, the
        ranks in linear-index order."""
        pos = [AXIS_NAMES.index(a) for a in axes]
        rest = [i for i in range(3) if i not in pos]
        g = self.grid.transpose(rest + pos)
        return [[int(r) for r in g[idx].reshape(-1)] for idx in np.ndindex(*g.shape[:len(rest)])]

    def group(self, axes: Axes) -> Tuple[object, List[int]]:
        """(process group, ranks in linear-index order) of this rank's line
        along ``axes``; only for axes of more than one rank."""
        return self._groups[canonical_axes(axes)]

    # ---- collectives over a line (no-ops on a line of one rank) ----

    def all_gather(self, x: torch.Tensor, axes: Axes, dim: int) -> torch.Tensor:
        """Concatenate every rank's ``x`` of the line along ``dim``, in the
        line's linear-index order."""
        if self.axis_size(axes) == 1:
            return x
        group, line = self.group(axes)
        parts = [torch.empty_like(x) for _ in line]
        dist.all_gather(parts, x.contiguous(), group=group)
        order = sorted(line)    # a group's ranks are its members in rank order
        return torch.cat([parts[order.index(r)] for r in line], dim=dim)

    def all_reduce(self, x: torch.Tensor, axes: Axes, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """The line's sum (or ``op``) of ``x``, in place where ``x`` is
        contiguous; returns the reduced tensor."""
        if self.axis_size(axes) == 1:
            return x
        x = x.contiguous()
        dist.all_reduce(x, op=op, group=self.group(axes)[0])
        return x


def _world_device() -> torch.device:
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def create_mesh(cfg: Optional[MeshConfig] = None, device: Optional[torch.device] = None
                ) -> Optional[Mesh]:
    """A mesh over the first ``cfg.num_devices`` ranks of the world (all of
    them on ``data`` without ``cfg``).  Without a process group, a mesh of
    one rank brings up a world of one (``multihost.init_single_process``);
    a larger one raises, as the JAX package does when the mesh needs more
    devices than it has.  Every rank of the world must call this; a rank
    outside the mesh gets None."""
    from streamingt2v_torch.parallel.multihost import init_single_process

    if not dist.is_initialized():
        if cfg is not None and cfg.num_devices > 1:
            raise ValueError(f"mesh {cfg} needs {cfg.num_devices} ranks, have 1 (no process "
                             "group: start one rank per device, e.g. under torchrun)")
        init_single_process()
    world = dist.get_world_size()
    cfg = mesh_shape_for(world) if cfg is None else cfg
    mesh = Mesh(cfg, rank_grid(cfg, range(world)), device or _world_device())
    return mesh if mesh.coords is not None else None


def local_mesh() -> Optional[Mesh]:
    """A mesh over every rank of the world, all on the data axis."""
    return create_mesh()
