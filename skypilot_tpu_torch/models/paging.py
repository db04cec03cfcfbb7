"""Block-paged KV cache: the device page pools and the host-side
refcounted allocator (port of skypilot_tpu/models/paging.py:
``PagedKV``, ``PagedLatent``, ``_pools``, ``pages_for``,
``_write_indices``, ``scatter_prefill``, ``gather_prefix``,
``adopt_rows``, ``export_pages``, ``import_pages``, ``PageAllocator``).

Two cache families share one page-table contract: ``PagedKV`` pools the
dense/GQA/MoE K/V (models/decode.py), ``PagedLatent`` the MLA latents
(models/mla.py). The helpers reach a family's per-token pools through
:func:`_pools`, so they take either. Page 0 is the TRASH page: never
allocated; writes for inactive rows are routed to it so a freed page
can never be corrupted by a stale step. The pools are updated in place
(the JAX version returns new pytrees).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

TRASH_PAGE = 0


@dataclasses.dataclass
class PagedKV:
    """Paged dense K/V pool + per-slot tables.

    k/v: [L, n_pages, page_size, KH, hd] — page id indexes axis 1.
    table: [B, max_pages] int32 page ids (0 = trash / unassigned).
    length: [B] int32 valid token count per slot."""
    k: torch.Tensor
    v: torch.Tensor
    table: torch.Tensor
    length: torch.Tensor

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
    as :class:`PagedKV`'s. The JAX pool's int8 variant (``c_scale`` /
    ``r_scale`` sidecars) is refused by name: it comes with the dense
    int8 pools."""
    c_kv: torch.Tensor
    k_rope: torch.Tensor
    table: torch.Tensor
    length: torch.Tensor
    c_scale: Optional[torch.Tensor] = None
    r_scale: Optional[torch.Tensor] = None

    def __post_init__(self):
        if self.c_scale is not None or self.r_scale is not None:
            raise NotImplementedError(
                'int8 latent pools (c_scale / r_scale sidecars) are not '
                'ported yet: they wait for ROADMAP Queue 1 item 3 (int8 KV)')

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


def pages_for(n_tokens: int, page_size: int) -> int:
    """Pages covering positions [0, n_tokens)."""
    return -(-n_tokens // page_size)


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


def scatter_prefill(pcache, rows_a: torch.Tensor, rows_b: torch.Tensor,
                    slots: torch.Tensor, s: int, lengths: torch.Tensor):
    """Write a grouped prefill's rows, in place: positions [0, s) of the
    family's two row tensors, as its ``prefill`` returns them (PagedKV:
    k, v [L, N, >=s, KH, hd]; PagedLatent: c_kv [L, N, >=s, r], k_rope
    [L, N, >=s, dr]), land in the pages the admitted slots' table rows
    cover; length[slots] = lengths."""
    pos = torch.arange(s, device=pcache.table.device)
    psz = pcache.page_size
    pid = pcache.table.long()[slots.long()][:, pos // psz]     # [N, s]
    off = (pos % psz)[None, :].expand_as(pid)
    for pool, rows in zip(_pools(pcache).values(), (rows_a, rows_b)):
        pool[:, pid, off] = rows[:, :, :s]
    pcache.length[slots.long()] = lengths.to(pcache.length.dtype)
    return pcache


def gather_prefix(pcache, slot: int, p: int) -> Tuple[torch.Tensor, ...]:
    """Row ``slot``'s first ``p`` positions of each of the family's
    pools as contiguous [L, 1, p, ...] tensors — (k, v) for a PagedKV,
    (c_kv, k_rope) for a PagedLatent: the prefix pair the family's
    ``prefill_extend`` takes. A prefix hit's table points at shared
    pages, so this reads what every other holder reads. The engine
    extends in place instead (``paged_prefill_extend``); this is its
    oracle."""
    psz = pcache.page_size
    pos = torch.arange(p, device=pcache.table.device)
    pid = pcache.table[slot].long()[pos // psz]
    off = pos % psz
    return tuple(pool[:, pid, off][:, None]
                 for pool in _pools(pcache).values())


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
    gather: adopt then gather_prefix round-trips bit for bit."""
    psz = pcache.page_size
    pools = _pools(pcache)
    table = pcache.table[slot].long()
    for pool, rows in zip(pools.values(), (a, b)):
        tok = rows[:, 0, :s].to(pool.device)               # [L, s, ...]
        if s % psz == 0:
            n = s // psz
            pool[:, table[:n]] = tok.reshape(tok.shape[0], n, psz,
                                             *tok.shape[2:])
        else:
            pos = torch.arange(s, device=pool.device)
            pool[:, table[pos // psz], pos % psz] = tok
    pcache.length[slot] = new_len
    return pcache


def export_pages(pcache, pids) -> Dict[str, torch.Tensor]:
    """The exact contents of pages ``pids``, one [L, n, psz, ...] tensor
    per pool field, for the host spill tier: no cast, so spill then
    :func:`import_pages` round-trips bit for bit."""
    pools = _pools(pcache)
    idx = torch.as_tensor(pids, dtype=torch.long,
                          device=pcache.table.device)
    return {name: pool[:, idx] for name, pool in pools.items()}


def import_pages(pcache, arrays: Dict[str, torch.Tensor], pids):
    """Inverse of :func:`export_pages`, in place: land spilled page
    contents (tensors, moved to the pool's device) in the freshly
    allocated pages ``pids``. Tables and lengths are untouched; the
    caller re-admits through the normal paths."""
    pools = _pools(pcache)
    idx = torch.as_tensor(pids, dtype=torch.long,
                          device=pcache.table.device)
    for name, pool in pools.items():
        pool[:, idx] = torch.as_tensor(arrays[name]).to(pool.device)
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
