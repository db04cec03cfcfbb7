"""PyTorch port paging vs the JAX package's paging, on the CPU: the
allocator replays to the same page ids and fingerprints, and the write
indices and the grouped-prefill scatter land on the same pages."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from skypilot_tpu.models import decode as jdecode
from skypilot_tpu.models import paging as jpaging
from skypilot_tpu_torch.models import paging


def _replay(alloc_cls, exhausted_cls):
    """One alloc/ref/unref/take sequence; every observable after each op."""
    a = alloc_cls(12)
    seen = []

    def note(x=None):
        seen.append((x, a.fingerprint(), a.free_count, a.used_count))

    note(a.alloc(3))
    note(a.alloc(2))
    a.ref(2)
    note(a.refcount(2))
    a.unref(2)
    note(a.refcount(2))
    a.unref_all([1, 2, 3])
    note()
    a.take([7, 9])
    note()
    note(a.alloc(4))
    with pytest.raises(exhausted_cls):
        a.alloc(100)
    with pytest.raises(ValueError):
        a.unref(1)                      # on the free list: double free
    with pytest.raises(ValueError):
        a.take([5, 5])
    a.unref_all([7, 9])
    note(a.alloc(5))
    note(a.can_fit(1))
    return seen


def test_allocator_replays_identically():
    assert _replay(paging.PageAllocator, paging.PagesExhausted) == \
        _replay(jpaging.PageAllocator, jpaging.PagesExhausted)


def test_pages_for():
    for n, psz in [(0, 64), (1, 64), (64, 64), (65, 64), (2048, 64)]:
        assert paging.pages_for(n, psz) == jpaging.pages_for(n, psz)


def _caches(seed=0, b=3, maxp=4, psz=8, kh=2, hd=4, layers=2, n_pages=13):
    rng = np.random.default_rng(seed)
    table = np.zeros((b, maxp), np.int32)
    table[0, :2] = [3, 1]
    table[1, :4] = [2, 5, 7, 4]
    table[2, :1] = [9]
    k = rng.standard_normal((layers, n_pages, psz, kh, hd)).astype(np.float32)
    v = rng.standard_normal((layers, n_pages, psz, kh, hd)).astype(np.float32)
    length = np.array([9, 30, 3], np.int32)
    j = jpaging.PagedKV(k=jnp.asarray(k), v=jnp.asarray(v),
                        table=jnp.asarray(table), length=jnp.asarray(length))
    t = paging.PagedKV(k=torch.from_numpy(k.copy()),
                       v=torch.from_numpy(v.copy()),
                       table=torch.from_numpy(table),
                       length=torch.from_numpy(length.copy()))
    return rng, j, t


@pytest.mark.parametrize('with_active', [False, True])
def test_write_indices_match(with_active):
    _, j, t = _caches()
    pos = np.array([[9, 10], [30, 31], [3, 4]], np.int32)
    active = np.array([True, False, True])
    jpid, joff = jpaging._write_indices(
        j, jnp.asarray(pos), jnp.asarray(active) if with_active else None)
    pid, off = paging._write_indices(
        t, torch.from_numpy(pos),
        torch.from_numpy(active) if with_active else None)
    np.testing.assert_array_equal(pid.numpy(), np.asarray(jpid))
    np.testing.assert_array_equal(off.numpy(), np.asarray(joff))


def test_scatter_prefill_matches():
    rng, j, t = _caches(seed=1)
    s = 16
    rows_k = rng.standard_normal((2, 2, s, 2, 4)).astype(np.float32)
    rows_v = rng.standard_normal((2, 2, s, 2, 4)).astype(np.float32)
    slots = np.array([1, 0], np.int32)
    lengths = np.array([16, 11], np.int32)
    rows = jdecode.KVCache(k=jnp.asarray(rows_k), v=jnp.asarray(rows_v),
                           length=jnp.asarray(lengths))
    j2 = jpaging.scatter_prefill(j, rows, jnp.asarray(slots), s,
                                 jnp.asarray(lengths))
    t2 = paging.scatter_prefill(t, torch.from_numpy(rows_k),
                                torch.from_numpy(rows_v),
                                torch.from_numpy(slots), s,
                                torch.from_numpy(lengths))
    assert t2 is t                                  # in place
    np.testing.assert_array_equal(t.k.numpy(), np.asarray(j2.k))
    np.testing.assert_array_equal(t.v.numpy(), np.asarray(j2.v))
    np.testing.assert_array_equal(t.length.numpy(), np.asarray(j2.length))


# ---------------------------------------------------------------------------
# Page moves: export_pages / import_pages (the host spill tier) and
# adopt_rows (the disagg handoff), both families, fp pools.
# ---------------------------------------------------------------------------

PSZ, MAXP, NPAGES = 8, 4, 13


def _family(kind, seed=0, layers=2):
    """The same seeded pool as a JAX and a torch cache of family
    ``kind`` ('kv': PagedKV [L, P, psz, KH, hd]; 'latent': PagedLatent
    c_kv [L, P, psz, r], k_rope [L, P, psz, dr]); slot 1's table covers
    pages 2, 5, 7, 4."""
    rng = np.random.default_rng(seed)
    table = np.zeros((3, MAXP), np.int32)
    table[0, :2] = [3, 1]
    table[1, :4] = [2, 5, 7, 4]
    table[2, :1] = [9]
    length = np.array([9, 30, 3], np.int32)
    shapes = ((2, 4), (2, 4)) if kind == 'kv' else ((6,), (3,))
    a, b = (rng.standard_normal((layers, NPAGES, PSZ, *s)).astype(np.float32)
            for s in shapes)
    jcls, tcls = ((jpaging.PagedKV, paging.PagedKV) if kind == 'kv' else
                  (jpaging.PagedLatent, paging.PagedLatent))
    j = jcls(jnp.asarray(a), jnp.asarray(b), jnp.asarray(table),
             jnp.asarray(length))
    t = tcls(torch.from_numpy(a.copy()), torch.from_numpy(b.copy()),
             torch.from_numpy(table.copy()), torch.from_numpy(length.copy()))
    return rng, j, t


def _same_pools(t, j):
    for name, pool in paging._pools(t).items():
        np.testing.assert_array_equal(pool.numpy(),
                                      np.asarray(jpaging._pools(j)[name]))
    np.testing.assert_array_equal(t.length.numpy(), np.asarray(j.length))


@pytest.mark.parametrize('kind', ['kv', 'latent'])
def test_export_import_pages_bit_identical_and_match_jax(kind):
    _, j, t = _family(kind, seed=2)
    pids = [7, 2, 11]
    out = paging.export_pages(t, pids)
    jout = jpaging.export_pages(j, jnp.asarray(pids, jnp.int32))
    assert set(out) == set(jout) == set(paging._pools(t))
    for name in out:
        assert tuple(out[name].shape) == (2, 3, PSZ) + \
            tuple(paging._pools(t)[name].shape[3:])
        np.testing.assert_array_equal(out[name].numpy(),
                                      np.asarray(jout[name]))
    # Wake into other (fresh) pages: exactly the exported contents there,
    # everything else untouched; the JAX import lands the same.
    before = {n: p.clone() for n, p in paging._pools(t).items()}
    fresh = [12, 6, 10]
    host = {n: a.clone() for n, a in out.items()}
    assert paging.import_pages(t, host, fresh) is t
    j2 = jpaging.import_pages(j, {n: jnp.asarray(a.numpy())
                                  for n, a in host.items()},
                              jnp.asarray(fresh, jnp.int32))
    _same_pools(t, j2)
    for name, pool in paging._pools(t).items():
        assert torch.equal(pool[:, fresh], out[name])
        keep = [p for p in range(NPAGES) if p not in fresh]
        assert torch.equal(pool[:, keep], before[name][:, keep])
    back = paging.export_pages(t, fresh)
    for name in out:
        assert torch.equal(back[name], out[name])


@pytest.mark.parametrize('kind', ['kv', 'latent'])
@pytest.mark.parametrize('s', [32, 21])      # page-aligned, per-token
def test_adopt_rows_round_trips_and_matches_jax(kind, s):
    rng, j, t = _family(kind, seed=3)
    pools = paging._pools(t)
    rows = [rng.standard_normal((p.shape[0], 1, 32, *p.shape[3:]))
            .astype(np.float32) for p in pools.values()]
    assert paging.adopt_rows(t, torch.from_numpy(rows[0]),
                             torch.from_numpy(rows[1]), 1, s, s - 2) is t
    j2 = jpaging.adopt_rows(j, jnp.asarray(rows[0]), jnp.asarray(rows[1]),
                            1, s, s - 2)
    _same_pools(t, j2)
    assert int(t.length[1]) == s - 2
    back = paging.gather_prefix(t, 1, s)
    jback = jpaging.gather_prefix(j2, 1, s)
    for got, want, jwant in zip(back, rows, jback):
        np.testing.assert_array_equal(got.numpy(), want[:, :, :s])
        np.testing.assert_array_equal(got.numpy(), np.asarray(jwant))
    # Only slot 1's pages moved.
    _, _, fresh = _family(kind, seed=3)
    others = [p for p in range(NPAGES) if p not in (2, 5, 7, 4)]
    for name, pool in pools.items():
        assert torch.equal(pool[:, others],
                           paging._pools(fresh)[name][:, others])


def test_adopt_rows_takes_non_contiguous_rows():
    """Rows arrive as CPU tensors in any layout: a strided view adopts
    as its contiguous copy would."""
    rng, _, t = _family('kv', seed=4)
    a = torch.from_numpy(rng.standard_normal((2, 1, 16, 2, 4))
                         .astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((2, 1, 16, 4, 2))
                         .astype(np.float32)).transpose(3, 4)
    assert not b.is_contiguous()
    paging.adopt_rows(t, a, b, 0, 16, 16)
    ka, kb = paging.gather_prefix(t, 0, 16)
    assert torch.equal(ka, a) and torch.equal(kb, b.contiguous())
