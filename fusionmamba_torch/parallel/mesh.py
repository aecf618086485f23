"""Process groups of multi-process training: the rank grid and its axes
(the counterpart of `fusionmamba_tpu/parallel/sharding.py::make_mesh` and of
JAX's ambient mesh).

`init_distributed` joins the process group that torchrun's environment
describes; `make_mesh(n_data, n_model)` lays the ranks out as JAX lays its
devices, `arange(world).reshape(n_data, n_model)`, and builds one group per
row (the "model" axis: tensor parallelism, the sequence-parallel scan) and
one per column (the "data" axis: the batch). `set_mesh` makes a mesh the
ambient one that `scan_impl="sp"` reads, as `jax.sharding.set_mesh` does.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist

AXES = ("data", "model")


@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh axis as this rank sees it: its process group (None when the
    axis has one rank), its size, this rank's index along it, and whether
    collectives must stage CUDA tensors through host memory (gloo, which the
    port does not trust with CUDA tensors: every helper of
    `parallel.collectives` copies them to the host and back explicitly)."""
    name: str
    group: Optional[dist.ProcessGroup]
    size: int
    index: int
    stage_on_host: bool


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The (n_data, n_model) rank grid and this rank's two axes."""
    n_data: int
    n_model: int
    rank: int
    backend: Optional[str]
    data: Axis
    model: Axis

    def axis(self, name: str) -> Axis:
        if name not in AXES:
            raise ValueError(f"mesh {(self.n_data, self.n_model)} has no axis {name!r}")
        return getattr(self, name)

    @property
    def world(self) -> int:
        return self.n_data * self.n_model


@dataclasses.dataclass(frozen=True)
class DistInfo:
    """What `init_distributed` found: the backend (None for one process),
    the world, this rank, the device this rank runs on, and whether it made
    the process group (and so should destroy it)."""
    backend: Optional[str]
    world: int
    rank: int
    device: torch.device
    created: bool = False


def _env_int(name: str, default: int) -> int:
    value = os.environ.get(name)
    return default if value is None else int(value)


def init_distributed(device: torch.device) -> DistInfo:
    """Join the process group of this run, if it has more than one rank.

    A group already initialised (a test's FileStore, say) is used as it is.
    Otherwise torchrun's environment (WORLD_SIZE, RANK, LOCAL_RANK,
    LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT) describes it; without
    WORLD_SIZE, or at 1, the run is one process and no group is made.

    The backend rule: NCCL when the ranks run on CUDA and every rank of the
    host has a card of its own (LOCAL_WORLD_SIZE <= the cards visible);
    otherwise gloo, and ranks on CUDA then share the cards round-robin (two
    ranks on one card share `cuda:0`; NCCL refuses that). Rank r of a host
    runs on `cuda:(LOCAL_RANK % cards)`."""
    if dist.is_available() and dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        backend = dist.get_backend()
    else:
        world, rank, backend = _env_int("WORLD_SIZE", 1), _env_int("RANK", 0), None
    local_rank = _env_int("LOCAL_RANK", rank)
    local_world = _env_int("LOCAL_WORLD_SIZE", world)
    if device.type == "cuda":
        cards = torch.cuda.device_count()
        device = torch.device("cuda", local_rank % cards)
        torch.cuda.set_device(device)
        want = "nccl" if local_world <= cards else "gloo"
    else:
        want = "gloo"
    created = world > 1 and backend is None
    if created:
        dist.init_process_group(want, init_method="env://", world_size=world, rank=rank)
        backend = want
    return DistInfo(backend if world > 1 else None, world, rank, device, created)


def make_mesh(n_data: Optional[int] = None, n_model: int = 1) -> Mesh:
    """The (n_data, n_model) mesh over every rank of the process group (one
    rank without one). n_data defaults to world // n_model. Every rank must
    call this, in the same order as its other group creations. Raises when
    n_data * n_model is not the world size: nothing runs on fewer ranks than
    it was given."""
    up = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if up else 1
    rank = dist.get_rank() if up else 0
    if n_data is None:
        n_data = world // n_model
    if n_data < 1 or n_model < 1 or n_data * n_model != world:
        raise ValueError(f"mesh {n_data},{n_model} needs {n_data * n_model} ranks; this run "
                         f"has {world}")
    backend = dist.get_backend() if up else None
    grid = torch.arange(world).reshape(n_data, n_model).tolist()
    rows, cols = grid, [list(c) for c in zip(*grid)]
    axes = {}
    for name, members in (("data", cols), ("model", rows)):
        mine, group = None, None
        for ranks in members:             # every rank makes every group, in order
            g = dist.new_group(ranks) if up and len(ranks) > 1 else None
            if rank in ranks:
                mine, group = ranks, g
        axes[name] = Axis(name, group, len(mine), mine.index(rank), backend == "gloo")
    return Mesh(n_data, n_model, rank, backend, axes["data"], axes["model"])


_AMBIENT: list = []


@contextlib.contextmanager
def set_mesh(mesh: Mesh):
    """Make `mesh` the ambient mesh inside the block (nestable)."""
    _AMBIENT.append(mesh)
    try:
        yield mesh
    finally:
        _AMBIENT.pop()


def get_mesh() -> Optional[Mesh]:
    """The ambient mesh, or None outside any `set_mesh` block."""
    return _AMBIENT[-1] if _AMBIENT else None
