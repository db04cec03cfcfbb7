"""Block-paged KV cache: the device page pools and the host-side
refcounted allocator (port of skypilot_tpu/models/paging.py:
``PagedKV``, ``PagedLatent``, ``_pools``, ``_SCALE_FIELD``,
``_scale_pools``, ``quantized``, ``pages_for``, ``gather_view``,
``_write_indices``, ``scatter_steps``, ``_pools_of_view``,
``scatter_prefill``, ``gather_prefix``, ``adopt_rows``,
``scatter_suffix``, ``export_pages``, ``import_pages``,
``PageAllocator``).

Two cache families share one page-table contract: ``PagedKV`` pools the
dense/GQA/MoE K/V (models/decode.py), ``PagedLatent`` the MLA latents
(models/mla.py). The helpers reach a family's per-token pools through
:func:`_pools`, so they take either. Page 0 is the TRASH page: never
allocated; writes for inactive rows are routed to it so a freed page
can never be corrupted by a stale step. The pools are updated in place
(the JAX version returns new pytrees).

int8 pools (``SKYTPU_ENGINE_KV_QUANT=int8``): the pools hold int8 codes
and each has an fp32 SIDECAR of its shape minus the last axis, one
scale per vector (:func:`_scale_pools`, named by :data:`_SCALE_FIELD`),
so the scales travel with their pages. The cold paths quantize on the
way in (:func:`scatter_prefill`, :func:`adopt_rows`) and
:func:`gather_prefix` dequantizes to fp32 on the way out;
:func:`export_pages` / :func:`import_pages` move codes and scales byte
for byte.

The gather baseline (``SKYTPU_ENGINE_ATTN=gather``): :func:`gather_view`
materializes the contiguous per-row view of the pool, the family's
contiguous step math runs on it, and :func:`scatter_steps` writes the
stepped positions back; an extend reads its prefix through
:func:`gather_prefix` and writes its suffix with :func:`scatter_suffix`.
The default engine indexes the pages in place instead and never builds
the view. These serve fp pools only, as in JAX.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from skypilot_tpu_torch.ops import paged_attention as pa

TRASH_PAGE = 0


@dataclasses.dataclass
class PagedKV:
    """Paged dense K/V pool + per-slot tables.

    k/v: [L, n_pages, page_size, KH, hd] — page id indexes axis 1.
    table: [B, max_pages] int32 page ids (0 = trash / unassigned).
    length: [B] int32 valid token count per slot.
    k_scale/v_scale: None on fp pools; on int8 pools (k/v hold codes)
    the [L, n_pages, page_size, KH] fp32 per-vector scales."""
    k: torch.Tensor
    v: torch.Tensor
    table: torch.Tensor
    length: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def page_size(self) -> int:
        return self.k.shape[2]

    @property
    def max_pages(self) -> int:
        return self.table.shape[1]


@dataclasses.dataclass
class PagedLatent:
    """Paged MLA latent pool + per-slot tables: c_kv [L, n_pages,
    page_size, r], k_rope [L, n_pages, page_size, dr]; table and length
    as :class:`PagedKV`'s. c_scale/r_scale: None on fp pools; on int8
    pools the [L, n_pages, page_size] fp32 per-token scales."""
    c_kv: torch.Tensor
    k_rope: torch.Tensor
    table: torch.Tensor
    length: torch.Tensor
    c_scale: Optional[torch.Tensor] = None
    r_scale: Optional[torch.Tensor] = None

    @property
    def page_size(self) -> int:
        return self.c_kv.shape[2]

    @property
    def max_pages(self) -> int:
        return self.table.shape[1]


def _pools(pcache) -> Dict[str, torch.Tensor]:
    """The per-token pool tensors of either family, by field name, in
    the order the family's prefill returns its rows."""
    if isinstance(pcache, PagedKV):
        return {'k': pcache.k, 'v': pcache.v}
    return {'c_kv': pcache.c_kv, 'k_rope': pcache.k_rope}


# Pool field -> its scale sidecar's field (the spill/export names too).
_SCALE_FIELD = {'k': 'k_scale', 'v': 'v_scale',
                'c_kv': 'c_scale', 'k_rope': 'r_scale'}


def _scale_pools(pcache) -> Optional[Dict[str, torch.Tensor]]:
    """The scale sidecars keyed like :func:`_pools`, or None on fp
    pools (the two sidecars are always set together)."""
    if isinstance(pcache, PagedKV):
        if pcache.k_scale is None:
            return None
        return {'k': pcache.k_scale, 'v': pcache.v_scale}
    if pcache.c_scale is None:
        return None
    return {'c_kv': pcache.c_scale, 'k_rope': pcache.r_scale}


def quantized(pcache) -> bool:
    """True when the pool holds int8 codes and scale sidecars."""
    return _scale_pools(pcache) is not None


def pool_tensors(pcache) -> Dict[str, torch.Tensor]:
    """Every per-token tensor of the pool by its field name: the value
    pools and, on int8 pools, their sidecars (what a reset zeroes and
    what a page's bytes count)."""
    out = dict(_pools(pcache))
    for name, t in (_scale_pools(pcache) or {}).items():
        out[_SCALE_FIELD[name]] = t
    return out


def pages_for(n_tokens: int, page_size: int) -> int:
    """Pages covering positions [0, n_tokens)."""
    return -(-n_tokens // page_size)


def gather_view(pcache, max_len: int):
    """The contiguous [L, B, max_len, ...] per-row view of the pool:
    position ``p`` of row ``b`` reads ``pool[:, table[b, p // psz],
    p % psz]`` (rows whose entries are 0 read the trash page: such rows
    are inactive and their logits discarded). Returns the family's
    contiguous cache (models/decode.py ``KVCache``, models/mla.py
    ``LatentCache``) holding fresh tensors and the pool's own ``length``
    tensor, so a step on the view advances the pool's lengths in place.
    An int8 pool has no fp view to materialize: NotImplementedError, in
    JAX's words."""
    if quantized(pcache):
        raise NotImplementedError(
            'gather_view of an int8-quantized pool: the gather '
            'baseline serves fp pools only (SKYTPU_ENGINE_KV_QUANT)')
    table = pcache.table.long()

    def g(a):
        v = a[:, table]                          # [L, B, MAXP, psz, ...]
        v = v.reshape(v.shape[0], v.shape[1], -1, *a.shape[3:])
        return v[:, :, :max_len]

    if isinstance(pcache, PagedKV):
        from skypilot_tpu_torch.models import decode
        return decode.KVCache(k=g(pcache.k), v=g(pcache.v),
                              length=pcache.length)
    from skypilot_tpu_torch.models import mla
    return mla.LatentCache(c_kv=g(pcache.c_kv), k_rope=g(pcache.k_rope),
                           length=pcache.length)


def _write_indices(pcache, pos: torch.Tensor,
                   active: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(page_id, offset) for token positions ``pos`` [B, ...]; inactive
    rows route to the trash page."""
    psz, maxp = pcache.page_size, pcache.max_pages
    pos = torch.clamp(pos.long(), max=maxp * psz - 1)
    pid = torch.gather(pcache.table.long(), 1, pos // psz)
    if active is not None:
        pid = torch.where(active[:, None], pid, torch.zeros_like(pid))
    return pid, pos % psz


def scatter_steps(pcache, view, start: torch.Tensor, k: int,
                  active: torch.Tensor):
    """Write the k positions a step call produced on :func:`gather_view`'s
    view back into the pool, in place: positions [start, start + k) of
    each row (``start`` [B], the lengths before the call), read from the
    view; inactive rows (``active`` [B] bool False) write the trash page.
    Writes and reads are clamped as :func:`_write_indices` clamps them:
    a position past the table writes its last slot, and a read past the
    view reads its last position. ``length`` takes the view's.

    Two writes can share a (page, offset) target, and only in two ways:
    inactive rows all write page 0, whose contents nothing reads; and a
    row's positions past the table all collapse onto its last slot, each
    carrying the view's last position, one value. So the order of
    duplicate writes (undefined for ``index_put_``) never shows."""
    if quantized(pcache):
        raise NotImplementedError(
            'scatter_steps into an int8-quantized pool: the gather '
            'baseline serves fp pools only (SKYTPU_ENGINE_KV_QUANT)')
    dev = pcache.table.device
    psz, maxp = pcache.page_size, pcache.max_pages
    pos = start.long()[:, None] + torch.arange(k, device=dev)     # [B, k]
    pid, off = _write_indices(pcache, pos, active)
    pos = torch.clamp(pos, max=maxp * psz - 1)
    views = _pools_of_view(view)
    for name, pool in _pools(pcache).items():
        va = views[name]
        rows = torch.arange(va.shape[1], device=dev)[:, None]
        tok = va[:, rows, torch.clamp(pos, max=va.shape[2] - 1)]
        pool[:, pid, off] = tok.to(pool.dtype)         # [L, B, k, ...]
    if view.length is not pcache.length:
        pcache.length.copy_(view.length)
    return pcache


def _pools_of_view(view) -> Dict[str, torch.Tensor]:
    """The per-token tensors of a contiguous cache (``KVCache`` or
    ``LatentCache``), keyed as :func:`_pools` keys the pool's."""
    if hasattr(view, 'k'):
        return {'k': view.k, 'v': view.v}
    return {'c_kv': view.c_kv, 'k_rope': view.k_rope}


def scatter_prefill(pcache, rows_a: torch.Tensor, rows_b: torch.Tensor,
                    slots: torch.Tensor, s: int, lengths: torch.Tensor):
    """Write a grouped prefill's rows, in place: positions [0, s) of the
    family's two row tensors, as its ``prefill`` returns them (PagedKV:
    k, v [L, N, >=s, KH, hd]; PagedLatent: c_kv [L, N, >=s, r], k_rope
    [L, N, >=s, dr]), land in the pages the admitted slots' table rows
    cover; length[slots] = lengths. int8 pools quantize the rows on the
    way in, their scales landing in the sidecars at the same indices."""
    pos = torch.arange(s, device=pcache.table.device)
    psz = pcache.page_size
    pid = pcache.table.long()[slots.long()][:, pos // psz]     # [N, s]
    off = (pos % psz)[None, :].expand_as(pid)
    scales = _scale_pools(pcache)
    for (name, pool), rows in zip(_pools(pcache).items(), (rows_a, rows_b)):
        tok = rows[:, :, :s]
        if scales is None:
            pool[:, pid, off] = tok
        else:
            pool[:, pid, off], scales[name][:, pid, off] = \
                pa.quantize_values(tok)
    pcache.length[slots.long()] = lengths.to(pcache.length.dtype)
    return pcache


def gather_prefix(pcache, slot: int, p: int) -> Tuple[torch.Tensor, ...]:
    """Row ``slot``'s first ``p`` positions of each of the family's
    pools as contiguous [L, 1, p, ...] tensors — (k, v) for a PagedKV,
    (c_kv, k_rope) for a PagedLatent: the prefix pair the family's
    ``prefill_extend`` takes. A prefix hit's table points at shared
    pages, so this reads what every other holder reads. The engine
    extends in place instead (``paged_prefill_extend``); this is its
    oracle, and the disagg export. int8 pools dequantize on the way out
    to fp32 (the scales' precision), the fp contract either way."""
    psz = pcache.page_size
    pos = torch.arange(p, device=pcache.table.device)
    pid = pcache.table[slot].long()[pos // psz]
    off = pos % psz
    scales = _scale_pools(pcache)
    if scales is None:
        return tuple(pool[:, pid, off][:, None]
                     for pool in _pools(pcache).values())
    return tuple(pa.dequantize_values(pool[:, pid, off][:, None],
                                      scales[name][:, pid, off][:, None],
                                      torch.float32)
                 for name, pool in _pools(pcache).items())


def adopt_rows(pcache, a: torch.Tensor, b: torch.Tensor, slot: int, s: int,
               new_len: int):
    """Write a HANDED-OFF row into ``slot``'s own pages, in place:
    ``(a, b)`` are [L, 1, >=s, ...] contiguous per-token rows in
    :func:`gather_prefix` order, as a prefill replica exported them
    (serve/disagg/handoff.py); positions [0, s) land in the pages the
    slot's table covers (the adopter reserved them through its own
    allocator: page ids never cross the wire, only contents), and
    length[slot] = new_len, so the pad past the prompt is never
    attended. Rows on another device are moved to the pool's. A
    page-aligned ``s`` (export buckets are) scatters whole pages, s /
    page_size indices instead of s. The exact inverse of the export
    gather on fp pools: adopt then gather_prefix round-trips bit for
    bit. An int8 adopter re-quantizes the rows its own way (codes and
    scales in ITS representation, whatever the exporter's)."""
    psz = pcache.page_size
    scales = _scale_pools(pcache)
    table = pcache.table[slot].long()
    for (name, pool), rows in zip(_pools(pcache).items(), (a, b)):
        tok = rows[:, 0, :s].to(pool.device)               # [L, s, ...]
        if s % psz == 0:
            n = s // psz
            idx = (table[:n],)
            tok = tok.reshape(tok.shape[0], n, psz, *tok.shape[2:])
        else:
            pos = torch.arange(s, device=pool.device)
            idx = (table[pos // psz], pos % psz)
        if scales is None:
            pool[(slice(None),) + idx] = tok
        else:
            pool[(slice(None),) + idx], scales[name][(slice(None),) + idx] \
                = pa.quantize_values(tok)
    pcache.length[slot] = new_len
    return pcache


def scatter_suffix(pcache, rows_a: torch.Tensor, rows_b: torch.Tensor,
                   slot: int, p: int, s2: int, new_len):
    """Write an extend's suffix into row ``slot``'s own pages, in place:
    the family's two row tensors as its ``prefill_extend`` returns them
    ([L, 1, >=s2, ...], the suffix alone) land at positions [p, p + s2),
    leaving the (possibly shared) prefix pages untouched; length[slot] =
    new_len. int8 pools quantize the rows on the way in, their scales
    landing in the sidecars at the same indices. A suffix reaching past
    the table raises: the JAX gather would clamp it onto a live page."""
    psz, maxp = pcache.page_size, pcache.max_pages
    if p + s2 > maxp * psz:
        raise ValueError(f'scatter_suffix: prefix ({p}) + suffix ({s2}) '
                         f'exceeds the table\'s {maxp} pages of {psz}')
    pos = p + torch.arange(s2, device=pcache.table.device)
    pid = pcache.table[slot].long()[pos // psz]
    off = pos % psz
    scales = _scale_pools(pcache)
    for (name, pool), rows in zip(_pools(pcache).items(), (rows_a, rows_b)):
        tok = rows[:, 0, :s2]                                # [L, s2, ...]
        if scales is None:
            pool[:, pid, off] = tok.to(pool.dtype)
        else:
            pool[:, pid, off], scales[name][:, pid, off] = \
                pa.quantize_values(tok)
    pcache.length[slot] = new_len
    return pcache


def export_pages(pcache, pids) -> Dict[str, torch.Tensor]:
    """The exact contents of pages ``pids``, one [L, n, psz, ...] tensor
    per pool field, the scale sidecars of an int8 pool included (under
    their :data:`_SCALE_FIELD` names), for the host spill tier: no cast
    and no dequantization, so spill then :func:`import_pages`
    round-trips bit for bit in either representation."""
    idx = torch.as_tensor(pids, dtype=torch.long,
                          device=pcache.table.device)
    return {name: t[:, idx] for name, t in pool_tensors(pcache).items()}


def import_pages(pcache, arrays: Dict[str, torch.Tensor], pids):
    """Inverse of :func:`export_pages`, in place: land spilled page
    contents (tensors, moved to the pool's device), sidecars included,
    in the freshly allocated pages ``pids``. Tables and lengths are
    untouched; the caller re-admits through the normal paths."""
    idx = torch.as_tensor(pids, dtype=torch.long,
                          device=pcache.table.device)
    for name, t in pool_tensors(pcache).items():
        t[:, idx] = torch.as_tensor(arrays[name]).to(t.device)
    return pcache


class PagesExhausted(Exception):
    """Not enough free pages — admission must wait."""


class PageAllocator:
    """Host-side deterministic free-list allocator with refcounts.

    FIFO over a deque seeded 1..n_pages-1 ascending; ``fingerprint()``
    is the (free_count, next_free_id) digest; ``take()`` claims explicit
    ids; refcounts implement read-only sharing and refuse double frees.
    """

    def __init__(self, n_pages: int):
        if n_pages < 2:
            raise ValueError(f'need >= 2 pages (1 data + trash), got '
                             f'{n_pages}')
        self.n_pages = n_pages
        self._free = collections.deque(range(1, n_pages))
        self._free_set = set(self._free)
        self._rc: Dict[int, int] = {}

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def used_count(self) -> int:
        return (self.n_pages - 1) - len(self._free)

    def can_fit(self, n: int) -> bool:
        return n <= len(self._free)

    def fingerprint(self) -> Tuple[int, int]:
        return (len(self._free), self._free[0] if self._free else -1)

    def alloc(self, n: int) -> List[int]:
        if n > len(self._free):
            raise PagesExhausted(f'need {n} pages, {len(self._free)} free')
        out = [self._free.popleft() for _ in range(n)]
        for pid in out:
            self._free_set.discard(pid)
            self._rc[pid] = 1
        return out

    def take(self, pids: Sequence[int]) -> None:
        want = set(pids)
        if len(want) != len(pids):
            raise ValueError(f'duplicate page ids in plan: {pids}')
        missing = want - self._free_set
        if missing:
            raise PagesExhausted(f'plan pages not free: {sorted(missing)}')
        self._free = collections.deque(
            p for p in self._free if p not in want)
        self._free_set -= want
        for pid in pids:
            self._rc[pid] = 1

    def ref(self, pid: int) -> None:
        if pid not in self._rc:
            raise ValueError(f'ref of unallocated page {pid}')
        self._rc[pid] += 1

    def unref(self, pid: int) -> None:
        rc = self._rc.get(pid)
        if rc is None:
            raise ValueError(f'double free of page {pid}')
        if rc == 1:
            del self._rc[pid]
            self._free.append(pid)
            self._free_set.add(pid)
        else:
            self._rc[pid] = rc - 1

    def unref_all(self, pids: Iterable[int]) -> None:
        for pid in pids:
            self.unref(pid)

    def refcount(self, pid: int) -> int:
        return self._rc.get(pid, 0)
