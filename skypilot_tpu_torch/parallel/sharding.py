"""Logical-axis sharding rules (port of the JAX-free part of
skypilot_tpu/parallel/sharding.py: ``DEFAULT_RULES`` and ``Rules``).

Model code names tensor dims with logical axes ('batch', 'seq', ...); a
rule maps each to zero or more mesh axes. Where the JAX package hands
the resulting ``PartitionSpec`` to GSPMD, the port cuts this rank's
slice itself (:func:`local_shard`): 'batch' over ('data', 'fsdp') gives
a rank its rows, 'seq' over 'sequence' its sequence slots, and
:func:`shard_params` gives a rank its slice of every leaf of a param
tree from the leaf's logical axes (models/llama.py ``param_axes``, the
JAX ``param_specs``): a serving gang's 'tensor' shards, a training
gang's 'fsdp' ones. Where GSPMD inserts the collectives of a leaf
sharded over 'fsdp', the port calls :func:`gather`, whose backward
reduce-scatters.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

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
    larger than 1 (:func:`leaf_box`), copied out of the whole leaf (so
    that the whole tree can be freed)."""
    start, size = leaf_box(x.shape, axes, mesh, rules)
    if size == list(x.shape):
        return x
    return x[tuple(slice(a, a + n) for a, n in zip(start, size))].clone()


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


def leaf_box(shape: Sequence[int], axes: Sequence[Optional[str]], mesh: Mesh,
             rules: Optional[Rules] = None) -> Tuple[List[int], List[int]]:
    """(start, size) on every dim of this rank's slice of a leaf of
    ``shape`` whose dims carry the logical ``axes``: what
    :func:`local_shard` cuts, without the leaf. Raises when a dim does
    not divide over its axes' ranks."""
    rules = rules or Rules()
    if len(axes) != len(shape):
        raise ValueError(f'logical axes {tuple(axes)} for a leaf of shape '
                         f'{tuple(shape)}')
    start, size = [0] * len(shape), [int(d) for d in shape]
    for dim, logical in enumerate(axes):
        mesh_axes = rules.mesh_axes(logical) or ()
        n = mesh.count(*mesh_axes)
        if n == 1:
            continue
        if size[dim] % n:
            raise ValueError(f'{logical!r} dim of size {size[dim]} does not '
                             f'divide over {"x".join(mesh_axes)}={n}')
        size[dim] //= n
        start[dim] = mesh.index(*mesh_axes) * size[dim]
    return start, size


def fsdp_dim(axes: Sequence[Optional[str]],
             rules: Optional[Rules] = None) -> Optional[int]:
    """The dim of a leaf with logical ``axes`` that the rules cut over
    'fsdp' ('embed' by the default rules), or None."""
    rules = rules or Rules()
    for dim, logical in enumerate(axes):
        if 'fsdp' in (rules.mesh_axes(logical) or ()):
            return dim
    return None


def spec_json(axes: Sequence[Optional[str]], rules: Optional[Rules] = None
              ) -> List[Union[None, str, List[str]]]:
    """The JSON PartitionSpec the JAX checkpointer writes for a leaf of
    logical ``axes`` (``Rules.spec`` without a mesh, so axes of one rank
    stay named; trailing unsharded dims dropped)."""
    rules = rules or Rules()
    out: List[Union[None, str, List[str]]] = []
    for logical in axes:
        mesh_axes = rules.mesh_axes(logical)
        if not mesh_axes:
            out.append(None)
        else:
            out.append(mesh_axes[0] if len(mesh_axes) == 1
                       else list(mesh_axes))
    while out and out[-1] is None:
        out.pop()
    return out


def _staged(group) -> bool:
    """Whether a collective over ``group`` goes through host memory:
    gloo's collectives other than all_reduce take CPU tensors (ranks
    sharing a card run gloo)."""
    return dist.get_backend(group) == 'gloo'


def all_gather_flat(flat: torch.Tensor, group, n: int) -> torch.Tensor:
    """Every rank's ``flat`` [m] of ``group`` (``n`` ranks), in rank
    order, as one [n * m] tensor on ``flat``'s device."""
    if _staged(group) and flat.is_cuda:
        return all_gather_flat(flat.cpu(), group, n).to(flat.device)
    out = torch.empty(n * flat.numel(), dtype=flat.dtype, device=flat.device)
    dist.all_gather_into_tensor(out, flat.contiguous(), group=group)
    return out


def reduce_scatter_flat(flat: torch.Tensor, group, n: int) -> torch.Tensor:
    """The sum over ``group``'s ``n`` ranks of ``flat`` [n * m], this
    rank's m-element part of it (its index in the group), on ``flat``'s
    device."""
    if _staged(group) and flat.is_cuda:
        return reduce_scatter_flat(flat.cpu(), group, n).to(flat.device)
    out = torch.empty(flat.numel() // n, dtype=flat.dtype, device=flat.device)
    dist.reduce_scatter_tensor(out, flat.contiguous(), group=group)
    return out


def _gather_whole(shard: torch.Tensor, dim: int, group, n: int
                  ) -> torch.Tensor:
    """The whole leaf from every rank's ``shard``, cut along ``dim``:
    the dim moved first, gathered flat, put back (contiguous)."""
    moved = shard.movedim(dim, 0)
    flat = all_gather_flat(moved.contiguous().reshape(-1), group, n)
    whole = flat.view(n * moved.shape[0], *moved.shape[1:])
    return whole.movedim(0, dim).contiguous()


class _Gather(torch.autograd.Function):
    """Forward: the whole leaf in ``dtype`` from this rank's shard (cast
    first, then gathered), as ``uses`` outputs sharing its memory, so
    the cotangents of separate readers (the tied embedding's lookup and
    unembedding) reach the backward apart and are added in fp32 there.
    Backward: their sum over the group, in fp32, cut to this rank's
    part and returned in the shard's dtype."""

    @staticmethod
    def forward(ctx, shard, dim, group, n, dtype, uses):
        ctx.dim, ctx.group, ctx.n = dim, group, n
        whole = _gather_whole(shard.to(dtype), dim, group, n)
        return tuple([whole] + [whole.view_as(whole)
                                for _ in range(uses - 1)])

    @staticmethod
    def backward(ctx, *grads):
        grads = [g for g in grads if g is not None]
        g = grads[0].float()
        for other in grads[1:]:
            g = g + other.float()
        moved = g.movedim(ctx.dim, 0)
        part = reduce_scatter_flat(moved.contiguous().reshape(-1),
                                   ctx.group, ctx.n)
        part = part.view(moved.shape[0] // ctx.n, *moved.shape[1:])
        return (part.movedim(0, ctx.dim).contiguous(), None, None, None,
                None, None)


def gather(shard: torch.Tensor, dim: int, mesh: Mesh, dtype=None,
           uses: int = 1):
    """The whole leaf from this rank's ``shard``, cut over ``mesh``'s
    'fsdp' group along ``dim``, in ``dtype`` (default the shard's):
    differentiable (the backward reduce-scatters, summing over the
    group). ``shard`` itself where the group holds one rank. With
    ``uses`` > 1 a tuple of that many aliases of the gathered leaf,
    each for one reader."""
    group, n = mesh.group('fsdp'), mesh.shape['fsdp']
    dtype = dtype or shard.dtype
    if group is None:
        out = shard.to(dtype)
        return out if uses == 1 else tuple([out] * uses)
    out = _Gather.apply(shard, dim, group, n, dtype, uses)
    return out[0] if uses == 1 else out


@torch.no_grad()
def gather_whole(shard: torch.Tensor, dim: Optional[int], mesh: Mesh
                 ) -> torch.Tensor:
    """The whole leaf from every rank's ``shard`` (no autograd): the
    checkpointer's and the tests' reassembly. ``shard`` where ``dim`` is
    None or the 'fsdp' group holds one rank."""
    group = mesh.group('fsdp')
    if dim is None or group is None:
        return shard
    return _gather_whole(shard.detach(), dim, group, mesh.shape['fsdp'])
