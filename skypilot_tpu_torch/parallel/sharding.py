"""Logical-axis sharding rules (port of the JAX-free part of
skypilot_tpu/parallel/sharding.py: ``DEFAULT_RULES`` and ``Rules``).

Model code names tensor dims with logical axes ('batch', 'seq', ...); a
rule maps each to zero or more mesh axes. Where the JAX package hands
the resulting ``PartitionSpec`` to GSPMD, the port cuts this rank's
slice itself (:func:`local_shard`): 'batch' over ('data', 'fsdp') gives
a rank its rows, 'seq' over 'sequence' its sequence slots. Parameters
stay whole on every rank in this port (no 'fsdp' or 'tensor' above 1),
so the parameter rules are carried but not applied.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from skypilot_tpu_torch.parallel.mesh import Mesh

AxisRule = Tuple[str, Union[None, str, Tuple[str, ...]]]

# The JAX package's table, as it is.
DEFAULT_RULES: Tuple[AxisRule, ...] = (
    ('batch', ('data', 'fsdp')),
    ('seq', 'sequence'),
    ('embed', 'fsdp'),
    ('heads', 'tensor'),
    ('kv_heads', 'tensor'),
    ('mlp', 'tensor'),
    ('vocab', 'tensor'),
    ('expert', 'expert'),
    ('layers', None),
    ('stage', 'stage'),
    ('act_embed', None),
    ('act_heads', 'tensor'),
    ('head_dim', None),
    ('norm', None),
)


class Rules:
    """Immutable logical→mesh axis mapping with overrides."""

    def __init__(self, rules: Sequence[AxisRule] = DEFAULT_RULES):
        self._map: Dict[str, Union[None, Tuple[str, ...]]] = {}
        for name, axes in rules:
            if axes is None:
                self._map[name] = None
            elif isinstance(axes, str):
                self._map[name] = (axes,)
            else:
                self._map[name] = tuple(axes)

    def override(self, **kwargs) -> 'Rules':
        new = Rules(())
        new._map = dict(self._map)
        for name, axes in kwargs.items():
            if axes is None or isinstance(axes, tuple):
                new._map[name] = axes
            else:
                new._map[name] = (axes,)
        return new

    def mesh_axes(self, logical: Optional[str]) -> Union[None, Tuple[str, ...]]:
        if logical is None:
            return None
        if logical not in self._map:
            raise KeyError(f'No sharding rule for logical axis {logical!r}; '
                           f'known: {sorted(self._map)}')
        return self._map[logical]


def local_shard(x: torch.Tensor, logical: str, dim: int, mesh: Mesh,
                rules: Optional[Rules] = None) -> torch.Tensor:
    """This rank's slice of ``x`` along ``dim``, which is cut over the
    mesh axes that ``logical`` maps to (the first axis major, as a
    PartitionSpec entry of several axes splits its dim). Raises when the
    axes' ranks do not divide the dim."""
    axes = (rules or Rules()).mesh_axes(logical) or ()
    n = mesh.count(*axes)
    if n == 1:
        return x
    size = x.shape[dim]
    if size % n:
        raise ValueError(f'{logical!r} dim of size {size} does not divide '
                         f'over {"x".join(axes)}={n}')
    part = size // n
    return x.narrow(dim, mesh.index(*axes) * part, part)
