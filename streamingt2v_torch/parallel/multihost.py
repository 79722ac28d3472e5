"""Bringing up the process group, and meshes across hosts (counterpart of
``streamingt2v_tpu/parallel/multihost.py``).

  initialize()              - ``torch.distributed`` bring-up, idempotent;
                              a no-op in a single process with nothing set.
  init_single_process()     - a world of one rank (a ``--mesh 1,1,1`` run
                              in one plain process).
  create_multihost_mesh()   - a (data, seq, model) mesh whose ``data`` axis
                              is factored (hosts, ranks per host) with the
                              host factor outermost, so that only ``data``
                              collectives cross hosts.
  process_batch_slice()     - the global-batch rows this rank feeds.
  global_batch_from_local() - the global batch from every rank's rows.

A "granule" is a group of ranks joined by fast links: the ranks of one
host (torchrun numbers them consecutively, ``LOCAL_WORLD_SIZE`` a host).
"""

from __future__ import annotations

import os
import warnings
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from streamingt2v_torch.config import MeshConfig
from streamingt2v_torch.parallel.mesh import AXIS_DATA, Mesh, _world_device


def _backend() -> str:
    return "nccl" if torch.cuda.is_available() else "gloo"


def _set_local_device(rank: int) -> None:
    if torch.cuda.is_available():
        local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, backend: Optional[str] = None) -> None:
    """Join the process group once; safe to call from every entry point.

    Each field comes from its argument, else from the environment torchrun
    sets (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``), else
    the call is a single-process no-op.  ``coordinator_address`` is
    ``host:port`` or an init-method URL (``tcp://...``, ``file://...``).
    The backend is NCCL where there is a card, gloo otherwise, unless
    given.  A group that cannot be formed raises."""
    if dist.is_initialized():
        if coordinator_address is not None or num_processes is not None:
            warnings.warn("multihost.initialize() called with explicit arguments after the "
                          "process group was formed; the arguments are ignored",
                          RuntimeWarning, stacklevel=2)
        return
    env = os.environ
    if coordinator_address is None and env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None and env.get("WORLD_SIZE"):
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and env.get("RANK"):
        process_id = int(env["RANK"])
    if coordinator_address is None and num_processes is None:
        return
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(f"initialize: need an address, a world size and a rank; got "
                         f"{coordinator_address!r}, {num_processes}, {process_id}")
    url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    backend = backend or _backend()
    if backend == "nccl":
        _set_local_device(process_id)
    dist.init_process_group(backend, init_method=url, world_size=num_processes, rank=process_id)


def init_single_process(backend: Optional[str] = None) -> None:
    """A world of one rank over an in-process store (no address, no port)."""
    if dist.is_initialized():
        return
    backend = backend or _backend()
    if backend == "nccl":
        _set_local_device(0)
    dist.init_process_group(backend, store=dist.HashStore(), world_size=1, rank=0)


def _factor_dcn(data: int, num_granules: int) -> Tuple[int, int]:
    """Split ``data`` into (across-granule, within-granule) factors: the
    whole across-granule dimension must lie on ``data``, or per-layer
    ``seq``/``model`` collectives would cross the slow links."""
    if data % num_granules != 0:
        raise ValueError(f"data axis ({data}) must be a multiple of the DCN granule count "
                         f"({num_granules}) so only data-parallel gradient reductions cross DCN")
    return num_granules, data // num_granules


def multihost_rank_grid(cfg: MeshConfig, ranks: Sequence[int], granule_of: Sequence[int]
                        ) -> np.ndarray:
    """The (data, seq, model) grid of ``ranks`` (granule ``granule_of[i]``
    for ``ranks[i]``): granule-major, so that along ``data`` the granule
    changes only at granule boundaries and every ``seq``/``model`` line
    stays inside one granule."""
    pairs = sorted(zip(granule_of, ranks))[:cfg.num_devices]
    if cfg.num_devices > len(pairs):
        raise ValueError(f"mesh {cfg} needs {cfg.num_devices} ranks, have {len(pairs)}")
    granules = sorted({g for g, _ in pairs})
    dcn, ici_data = _factor_dcn(cfg.data, len(granules))
    per = len(pairs) // len(granules)
    if any(sum(1 for g, _ in pairs if g == k) != per for k in granules):
        raise ValueError(f"{len(pairs)} ranks do not split evenly over {len(granules)} "
                         f"DCN granules")
    arr = np.asarray([r for _, r in pairs]).reshape(dcn, ici_data, cfg.seq, cfg.model)
    return arr.reshape(cfg.data, cfg.seq, cfg.model)


def create_multihost_mesh(cfg: Optional[MeshConfig] = None, *,
                          num_granules: Optional[int] = None) -> Optional[Mesh]:
    """A mesh over the world aware of its hosts: ``num_granules`` (default:
    world size / ``LOCAL_WORLD_SIZE``) groups of consecutive ranks.  With one
    granule this is ``mesh.create_mesh``'s grid.  Every rank calls it; a
    rank outside the mesh gets None."""
    if not dist.is_initialized():
        init_single_process()
    world = dist.get_world_size()
    cfg = MeshConfig(data=world, seq=1, model=1) if cfg is None else cfg
    if num_granules is None:
        per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        num_granules = max(1, world // per_host)
    per = world // num_granules
    grid = multihost_rank_grid(cfg, range(world), [r // per for r in range(world)])
    mesh = Mesh(cfg, grid, _world_device())
    return mesh if mesh.coords is not None else None


def process_batch_slice(mesh: Mesh, global_batch: int) -> slice:
    """The rows of the global batch this rank feeds: its block along
    ``data`` (ranks that differ only in seq or model feed the same rows)."""
    d = mesh.shape[AXIS_DATA]
    if global_batch % d:
        raise ValueError(f"global batch {global_batch} does not split over data={d}")
    per = global_batch // d
    i = mesh.axis_index(AXIS_DATA)
    return slice(i * per, (i + 1) * per)


def global_batch_from_local(mesh: Mesh, local_rows, global_batch: int) -> torch.Tensor:
    """The global batch, on every rank, from each rank's
    ``process_batch_slice`` rows (gathered over ``data``)."""
    rows = torch.as_tensor(np.asarray(local_rows) if not torch.is_tensor(local_rows)
                           else local_rows).to(mesh.device)
    out = mesh.all_gather(rows, AXIS_DATA, 0)
    if out.shape[0] != global_batch:
        raise ValueError(f"gathered {out.shape[0]} rows, expected {global_batch}")
    return out
