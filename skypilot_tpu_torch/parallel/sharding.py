"""Logical-axis sharding rules (port of the JAX-free part of
skypilot_tpu/parallel/sharding.py: ``DEFAULT_RULES`` and ``Rules``).

Model code names tensor dims with logical axes ('batch', 'seq', ...); a
rule maps each to zero or more mesh axes. Where the JAX package hands
the resulting ``PartitionSpec`` to GSPMD, the port cuts this rank's
slice itself (:func:`local_shard`): 'batch' over ('data', 'fsdp') gives
a rank its rows, 'seq' over 'sequence' its sequence slots, and
:func:`shard_params` gives a rank its slice of every leaf of a param
tree from the leaf's logical axes (models/llama.py ``param_axes``, the
JAX ``param_specs``): a serving gang's 'tensor' shards. Training keeps
its params whole on every rank (no 'fsdp' or 'tensor' above 1 there).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from skypilot_tpu_torch.models.quant import QuantizedWeight
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


def _shard_leaf(x: torch.Tensor, axes: Sequence[Optional[str]], mesh: Mesh,
                rules: Rules) -> torch.Tensor:
    """``x`` cut along every dim whose logical axis maps to mesh axes
    larger than 1, copied out of the whole leaf (so that the whole tree
    can be freed)."""
    if len(axes) != x.dim():
        raise ValueError(f'logical axes {tuple(axes)} for a leaf of shape '
                         f'{tuple(x.shape)}')
    out = x
    for dim, logical in enumerate(axes):
        if logical is not None:
            out = local_shard(out, logical, dim, mesh, rules)
    return out.clone() if out is not x else x


def shard_params(params, axes, mesh: Mesh, rules: Optional[Rules] = None):
    """This rank's shard of the param tree ``params``, leaf by leaf from
    ``axes`` (the same tree holding each leaf's logical axis names, as
    the JAX ``param_specs`` holds its PartitionSpecs). An int8
    :class:`QuantizedWeight` follows the JAX engine's rule: its codes
    take the leaf's axes and its per-channel scale drops the axis of
    every size-1 dim, so a shard dequantizes on its own."""
    rules = rules or Rules()
    if isinstance(params, dict):
        return {k: shard_params(v, axes[k], mesh, rules)
                for k, v in params.items()}
    if isinstance(params, QuantizedWeight):
        scale_axes = [a if params.scale.shape[i] > 1 else None
                      for i, a in enumerate(axes)]
        return QuantizedWeight(q=_shard_leaf(params.q, axes, mesh, rules),
                               scale=_shard_leaf(params.scale, scale_axes,
                                                 mesh, rules))
    return _shard_leaf(params, axes, mesh, rules)
