"""Process meshes for the port (port of skypilot_tpu/parallel/mesh.py).

The JAX package names its parallelism axes on a ``jax.sharding.Mesh``
of devices and lets XLA insert the collectives. The port lays the ranks
of a ``torch.distributed`` world out on the same named axes, in the
same order, and gives each axis larger than 1 its process groups; the
code that needs a collective (ring attention's P2P, the train step's
reductions) asks the mesh for the group of an axis. One rank drives one
card (or the CPU).

``MeshSpec`` is the JAX class's arithmetic, copied: ``-1`` on one axis
fills it with the ranks left over, and its errors are the JAX
package's, word for word.

The backend is the port's own knob, ``SKYTPU_TORCH_DIST_BACKEND``:
unset, NCCL for ranks on cards and gloo on the CPU. NCCL refuses two
ranks on one card, so ranks that share a card ask for gloo; nothing
picks the backend by catching an error.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import math
import os
from typing import Dict, FrozenSet, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from skypilot_tpu_torch.utils import knobs

# Outer → inner, as in the JAX package: 'data' outermost, 'tensor'
# innermost.
MESH_AXES: Tuple[str, ...] = ('data', 'stage', 'fsdp', 'sequence', 'expert',
                              'tensor')


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Sizes of each parallelism axis. -1 on exactly one axis = "fill with
    all remaining devices" (like torch DeviceMesh / MaxText).
    """
    data: int = 1
    stage: int = 1      # pipeline parallelism
    fsdp: int = -1      # fully-sharded data parallel (params sharded)
    sequence: int = 1   # context/sequence parallelism (ring attention)
    expert: int = 1     # expert parallelism (MoE)
    tensor: int = 1     # tensor/megatron parallelism

    def sizes(self, num_devices: int) -> Tuple[int, ...]:
        raw = [getattr(self, ax) for ax in MESH_AXES]
        if raw.count(-1) > 1:
            raise ValueError(f'At most one -1 axis allowed, got {raw}')
        known = math.prod(s for s in raw if s != -1)
        if -1 in raw:
            if num_devices % known != 0:
                raise ValueError(
                    f'{num_devices} devices not divisible by fixed axes '
                    f'{known} in {self}')
            raw[raw.index(-1)] = num_devices // known
        if math.prod(raw) != num_devices:
            raise ValueError(
                f'MeshSpec {tuple(raw)} does not multiply to {num_devices} '
                f'devices')
        return tuple(raw)

    def nontrivial_axes(self, num_devices: int) -> Tuple[str, ...]:
        sizes = self.sizes(num_devices)
        return tuple(ax for ax, s in zip(MESH_AXES, sizes) if s > 1)


def dist_backend(device) -> str:
    """The process-group backend for ranks on ``device``: the knob
    SKYTPU_TORCH_DIST_BACKEND if set, else 'nccl' on a card and 'gloo'
    on the CPU."""
    chosen = knobs.get_enum('SKYTPU_TORCH_DIST_BACKEND')
    if chosen:
        return chosen
    return 'nccl' if torch.device(device).type == 'cuda' else 'gloo'


def rank_device(device) -> torch.device:
    """This rank's device: on the card ``cuda:(LOCAL_RANK or 0) %
    device_count`` (the gang's ranks on one host take a card each, or
    share it), else ``device`` as given."""
    device = torch.device(device)
    if device.type == 'cuda' and device.index is None:
        local = int(os.environ.get('LOCAL_RANK') or 0)
        device = torch.device('cuda', local % torch.cuda.device_count())
    return device


def init_distributed(address: str, world_size: int, rank: int, device,
                     timeout_s: float = 1800.0) -> None:
    """Join the world at ``address`` (host:port, rank 0 listening there)
    as ``rank`` of ``world_size``, with :func:`dist_backend`'s backend.
    A rank on a card first makes ``device`` its current one, so the
    backend's streams and buffers go there."""
    device = torch.device(device)
    if device.type == 'cuda':
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend=dist_backend(device), init_method=f'tcp://{address}',
        world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))


class Mesh:
    """The world's ranks on the MESH_AXES grid (row-major: rank r sits
    at ``np.unravel_index(r, sizes)``), this rank's coordinate on each
    axis, and the process groups of its axes. ``shape`` maps every axis
    to its size, as a JAX mesh's does.

    ``group(*axes)`` is the group of the ranks that share this rank's
    coordinates on every other axis: None where those axes hold one
    rank, the default (world) group where they hold them all. Every
    rank asks for the same groups in the same order (torch's rule for
    ``new_group``); the single axes' groups are made by
    :func:`build_mesh`."""

    def __init__(self, sizes: Sequence[int], rank: int):
        self.sizes = tuple(int(s) for s in sizes)
        self.shape: Dict[str, int] = dict(zip(MESH_AXES, self.sizes))
        self.size = math.prod(self.sizes)
        self.rank = rank
        self.coords: Dict[str, int] = {
            ax: int(c) for ax, c in
            zip(MESH_AXES, np.unravel_index(rank, self.sizes))}
        self._groups: Dict[FrozenSet[str], object] = {}

    def count(self, *axes: str) -> int:
        return math.prod(self.shape[ax] for ax in axes)

    def index(self, *axes: str) -> int:
        """This rank's position in its group along ``axes`` (the first
        axis major)."""
        return int(np.ravel_multi_index(
            tuple(self.coords[ax] for ax in axes),
            tuple(self.shape[ax] for ax in axes))) if axes else 0

    def group(self, *axes: str):
        n = self.count(*axes)
        if n == 1:
            return None
        if n == self.size:
            return dist.group.WORLD
        # Axes of one rank add nothing: ('expert', 'tensor') at expert=1
        # is the 'tensor' group, not a second group over the same ranks.
        axes = tuple(ax for ax in MESH_AXES
                     if ax in axes and self.shape[ax] > 1)
        key = frozenset(axes)
        if key not in self._groups:
            self._groups[key] = _subgroups(self, axes)
        return self._groups[key]

    def __repr__(self) -> str:
        return (f'Mesh({", ".join(f"{a}={s}" for a, s in self.shape.items())}'
                f'; rank {self.rank})')


def _subgroups(mesh: Mesh, axes: Sequence[str]):
    """Every group along ``axes`` (all ranks make all of them), and this
    rank's."""
    grid = np.arange(mesh.size).reshape(mesh.sizes)
    keep = [MESH_AXES.index(ax) for ax in axes]
    rest = [i for i in range(len(MESH_AXES)) if i not in keep]
    lists = np.transpose(grid, rest + keep).reshape(-1, mesh.count(*axes))
    mine, _ = dist.new_subgroups_by_enumeration(
        [[int(r) for r in row] for row in lists])
    return mine


def build_mesh(spec: Optional[MeshSpec] = None) -> Mesh:
    """The mesh of ``spec`` (default ``MeshSpec()``: every rank on
    'fsdp') over the initialised world, or over one rank when there is
    none; the groups of every axis larger than 1 are made here."""
    if spec is None:
        spec = MeshSpec()
    if dist.is_available() and dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
    else:
        world, rank = 1, 0
    mesh = Mesh(spec.sizes(world), rank)
    for ax in spec.nontrivial_axes(world):
        mesh.group(ax)
    return mesh


def single_device_mesh() -> Mesh:
    """One rank, every axis 1: the mesh of a run without a world."""
    return Mesh((1,) * len(MESH_AXES), 0)


_CURRENT: List[Mesh] = []


@contextlib.contextmanager
def use_mesh(mesh: Mesh) -> Iterator[Mesh]:
    """``with use_mesh(mesh):`` makes ``mesh`` the one that ring
    attention reads its 'sequence' group from (the JAX package's
    ambient mesh). A module global, not a context variable: under remat
    the layers' forward runs again in autograd's backward threads."""
    _CURRENT.append(mesh)
    try:
        yield mesh
    finally:
        _CURRENT.pop()


def current_mesh() -> Mesh:
    """The innermost :class:`use_mesh`'s mesh, else one rank."""
    return _CURRENT[-1] if _CURRENT else single_device_mesh()
