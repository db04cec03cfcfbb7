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
