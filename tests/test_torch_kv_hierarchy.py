"""The port's KV memory hierarchy (serve/host_store.py and the engine's
spill tier) against the JAX package's, on the CPU — the assertions of
tests/unit_tests/test_kv_hierarchy.py:

  * HostPageStore: bit-identical round trips (fp32, int8, bf16 tensors),
    byte-budgeted LRU eviction, oversized refusal, duplicate refresh,
    integrity refusal of a corrupted blob, clear/occupancy; and its blobs
    byte-equal to the JAX store's for the same arrays;
  * the allocator's no-double-free discipline when a spilled prefix is
    still shared by a live row;
  * the live engine (llama-debug fp32 on weights bridged from JAX):
    spill → wake over HTTP gives the cold path's tokens (JAX
    ``decode.generate``) and counts as a prefix hit; pressure and LRU
    overflow spill; the idle sweep; a ``kv.wake`` fault resurrected;
    ``kv_spill``, ``kv_wake`` and ``flight_snapshot`` rows read back
    through JAX's ``journal.query``; /health and /metrics.
"""
import dataclasses
import json
import threading
import time
import urllib.error
import urllib.request

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from skypilot_tpu.models import decode as jdecode
from skypilot_tpu.models import llama as jllama
from skypilot_tpu.observe import journal as jjournal
from skypilot_tpu.serve import host_store as jhost_store
from skypilot_tpu_torch import config
from skypilot_tpu_torch.models import decode, paging, weights
from skypilot_tpu_torch.observe import journal
from skypilot_tpu_torch.serve import engine as engine_lib
from skypilot_tpu_torch.serve.host_store import HostPageStore
from skypilot_tpu_torch.utils import failpoints
from skypilot_tpu_torch.utils import framed

MAX_LEN, REF_NEW = 256, 4


def _arrays(seed, shape=(2, 3, 8, 4), with_int8=False):
    rng = np.random.default_rng(seed)
    out = {'k': rng.standard_normal(shape).astype(np.float32)}
    if with_int8:
        out['q'] = rng.integers(-127, 128, shape, dtype=np.int8)
        out['q_scale'] = rng.standard_normal(shape[:-1]).astype(np.float32)
    return out


class TestHostPageStore:

    def test_put_pop_roundtrip_bit_identical(self):
        store = HostPageStore(budget_mb=4)
        arrays = _arrays(0, with_int8=True)
        bf = torch.randn(2, 3, 8, 4, generator=torch.Generator().manual_seed(
            0)).to(torch.bfloat16)
        arrays['b'] = bf
        assert store.put(('a',), arrays, n_pages=3)
        assert ('a',) in store
        back = store.pop(('a',))
        assert set(back) == set(arrays)
        for name in ('k', 'q', 'q_scale'):
            assert back[name].dtype == arrays[name].dtype
            np.testing.assert_array_equal(back[name], arrays[name])
        assert back['b'].dtype == torch.bfloat16
        assert torch.equal(back['b'].view(torch.int16), bf.view(torch.int16))
        assert ('a',) not in store
        assert store.pop(('a',)) is None
        assert len(store) == 0

    def test_blob_byte_equal_to_jax_store(self):
        arrays = _arrays(9, with_int8=True)
        bits = np.random.default_rng(9).standard_normal((2, 8)).astype(
            ml_dtypes.bfloat16)
        port, jax_side = HostPageStore(4), jhost_store.HostPageStore(4)
        port.put(('k',), {**arrays, 'b': torch.from_numpy(
            bits.view(np.int16).copy()).view(torch.bfloat16)}, n_pages=2)
        jax_side.put(('k',), {**arrays, 'b': bits}, n_pages=2)
        assert port._entries[('k',)] == jax_side._entries[('k',)]
        assert port.occupancy() == jax_side.occupancy()

    def test_lru_eviction_respects_byte_budget(self):
        store = HostPageStore(budget_mb=1)
        blob = _arrays(1, shape=(2, 3, 8, 2048))  # ~384 KiB each
        keys = [('k', i) for i in range(4)]
        for key in keys:
            assert store.put(key, blob, n_pages=3)
        occ = store.occupancy()
        assert occ['bytes'] <= occ['budget_bytes']
        assert keys[0] not in store and keys[-1] in store
        assert store.pages_spilled() == 3 * len(store)

    def test_oversized_blob_refused(self):
        store = HostPageStore(budget_mb=1)
        huge = _arrays(2, shape=(2, 3, 8, 8192))  # > 1 MiB alone
        assert not store.put(('big',), huge, n_pages=2)
        assert len(store) == 0 and store.pages_spilled() == 0

    def test_duplicate_key_refreshes(self):
        store = HostPageStore(budget_mb=4)
        store.put(('a',), _arrays(3), n_pages=2)
        second = _arrays(4)
        store.put(('a',), second, n_pages=5)
        assert len(store) == 1
        assert store.pages_spilled() == 5
        np.testing.assert_array_equal(store.pop(('a',))['k'], second['k'])

    def test_corrupted_blob_raises_integrity_error(self):
        store = HostPageStore(budget_mb=4)
        store.put(('a',), _arrays(5), n_pages=1)
        blob, n = store._entries[('a',)]
        flipped = bytearray(blob)
        flipped[-3] ^= 0x40            # damage the npy payload tail
        store._entries[('a',)] = (bytes(flipped), n)
        with pytest.raises(framed.RemoteError) as ei:
            store.pop(('a',))
        assert ei.value.kind == 'integrity'

    def test_clear_and_occupancy(self):
        store = HostPageStore(budget_mb=4)
        store.put(('a',), _arrays(6), n_pages=2)
        store.put(('b',), _arrays(7), n_pages=3)
        occ = store.occupancy()
        assert occ['entries'] == 2 and occ['pages'] == 5
        assert occ['bytes'] > 0
        store.clear()
        assert len(store) == 0
        assert store.occupancy() == {'entries': 0, 'bytes': 0, 'pages': 0,
                                     'budget_bytes': 4 << 20}


def test_shared_prefix_spill_no_double_free():
    """The spill flow at the allocator: the store's refs go back exactly
    ONCE; pages a live slot shares survive until it releases them, and
    a third release raises."""
    alloc = paging.PageAllocator(10)
    pids = alloc.alloc(3)
    for pid in pids:
        alloc.ref(pid)                 # a live slot shares them: rc 2
    before = alloc.fingerprint()
    alloc.unref_all(pids)              # the spill's single unref
    assert alloc.used_count == 3
    alloc.unref_all(pids)              # the slot finishing
    assert alloc.used_count == 0
    assert alloc.fingerprint() != before
    with pytest.raises(ValueError):
        alloc.unref(pids[0])


# ---------------------------------------------------------------------------
# The live engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def bridge():
    jcfg = dataclasses.replace(jllama.PRESETS['llama-debug'],
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(config.PRESETS['llama-debug'],
                               dtype=torch.float32)
    tree = jax.device_get(jllama.init_params(jax.random.PRNGKey(7), jcfg))
    return jax.tree.map(jnp.asarray, tree), jcfg, tree, tcfg


def _engine(bridge, **attrs):
    _, _, tree, tcfg = bridge
    eng = engine_lib.InferenceEngine(
        'llama-debug', cfg=tcfg, device='cpu', max_len=MAX_LEN,
        params=weights.params_from_jax(tree, tcfg, device='cpu'))
    for name, val in attrs.items():
        setattr(eng, name, val)
    return eng


def _serve(eng):
    server = engine_lib.build_app(eng)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    eng.start()
    base = f'http://127.0.0.1:{server.server_address[1]}'
    deadline = time.monotonic() + 60
    while _get(base + '/health')[0] != 200:
        assert time.monotonic() < deadline
        time.sleep(0.02)
    return server, th, base


def _close(eng, server, th):
    server.shutdown()
    server.server_close()
    eng.stop()
    th.join(10)


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=60) as r:
            body = r.read().decode()
            return r.status, (json.loads(body) if body.startswith('{')
                              else body)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b'{}')
    except urllib.error.URLError:
        return None, None


def _generate(base, tokens, n=REF_NEW):
    req = urllib.request.Request(base + '/generate', data=json.dumps({
        'tokens': tokens, 'max_new_tokens': n}).encode(),
        headers={'Content-Type': 'application/json'})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b'{}')


def _cold(bridge, prompt, n=REF_NEW):
    """JAX decode.generate's greedy tokens (the cold path)."""
    jparams, jcfg, _, _ = bridge
    b = decode.bucket_size(len(prompt))
    padded = jnp.asarray([prompt + [0] * (b - len(prompt))], jnp.int32)
    return np.asarray(jdecode.generate(
        jparams, padded, jcfg, n, max_len=MAX_LEN,
        prompt_lengths=jnp.asarray([len(prompt)], jnp.int32)))[0].tolist()


def _prompt(base, tail):
    # A 70-token shared prefix (past the 64-token snapshot minimum) plus
    # a distinct tail.
    return [(i % 240) + base + 1 for i in range(70)] + tail


def _idle(eng):
    deadline = time.monotonic() + 30
    while eng.in_flight() or eng.queue_depth():
        assert time.monotonic() < deadline
        time.sleep(0.01)


@pytest.fixture(scope='module')
def stack(bridge):
    eng = _engine(bridge, spec_k=0, kv_host_mb=64)
    server, th, base = _serve(eng)
    assert eng.host_store is not None
    yield eng, base
    _close(eng, server, th)


@pytest.fixture(autouse=True)
def _clean(tmp_path, monkeypatch):
    failpoints.reset()
    monkeypatch.setenv('SKYTPU_OBSERVE_DB', str(tmp_path / 'observe.db'))
    yield
    failpoints.reset()


def _on_loop(eng, fn):
    """Run ``fn`` at the batch loop's next drained point (the spill tier
    belongs to the loop's thread) and wait for it."""
    done = threading.Event()
    orig = eng._process_cancels

    def hook():
        orig()
        if not done.is_set():
            try:
                fn()
            finally:
                done.set()
    eng._process_cancels = hook
    try:
        assert done.wait(30)
    finally:
        del eng._process_cancels


def test_spill_wake_bit_identical_and_counts_hit(bridge, stack):
    eng, base = stack
    _on_loop(eng, eng._clear_prefix_store)
    prompt_a, prompt_b = _prompt(0, [5, 6, 7]), _prompt(0, [9, 8])
    assert _generate(base, prompt_a)[0] == 200
    _idle(eng)
    _on_loop(eng, lambda: [eng._spill_key(k) for k in
                           list(eng._prefix_store)])
    assert not eng._prefix_store and len(eng.host_store) == 1
    spilled = eng.host_store.pages_spilled()
    hits0 = eng.prefix_hits
    code, doc = _generate(base, prompt_b)
    assert code == 200
    _idle(eng)
    assert eng.prefix_hits - hits0 == 1, 'a host-tier wake is a prefix hit'
    assert spilled > 0
    _, health = _get(base + '/health')
    assert health['kv_host']['budget_bytes'] == 64 << 20
    assert len(eng.host_store) == 0            # woken: back on the device
    assert doc['tokens'] == _cold(bridge, prompt_b)
    kinds = {e['kind'] for e in jjournal.query(since=0)}
    assert 'kv_wake' in kinds
    wake = jjournal.query(kind='kv_wake')[-1]
    assert wake['entity'] == 'engine/llama-debug'
    assert wake['data']['pages'] == spilled and wake['trace_id'] is None
    assert eng._kv_sessions_peak >= 1
    _, text = _get(base + '/metrics')
    for family in ('skytpu_engine_wake_seconds_count 1',
                   'skytpu_engine_kv_pages_spilled 0',
                   'skytpu_engine_kv_sessions_peak'):
        assert family in text


def test_idle_sweep_spills_after_threshold(stack):
    eng, base = stack
    _on_loop(eng, eng._clear_prefix_store)
    assert _generate(base, _prompt(10, [3, 4]), 2)[0] == 200
    _idle(eng)
    assert len(eng._prefix_store) == 1
    assert not eng._sweep_due()
    eng.kv_idle_spill_s = 0.05
    try:
        deadline = time.monotonic() + 10
        while eng._prefix_store:           # the loop's sweep takes it
            assert time.monotonic() < deadline
            time.sleep(0.01)
    finally:
        eng.kv_idle_spill_s = 0.0
    _on_loop(eng, lambda: None)    # the sweep's run, journal included, ended
    assert len(eng.host_store) == 1
    spill_events = jjournal.query(kind='kv_spill')
    assert len(spill_events) == 1
    assert spill_events[0]['data']['entries'] == 1
    assert spill_events[0]['data']['stored'] == 1
    # The port's own reader agrees with JAX's.
    assert [e['event_id'] for e in journal.query(kind='kv_spill')] == \
        [spill_events[0]['event_id']]
    assert journal.tail(1)[0]['kind'] == 'kv_spill'
    _on_loop(eng, eng._clear_prefix_store)


def test_injected_wake_failure_resurrects_request(bridge, stack):
    """An armed ``kv.wake`` fires inside the admission that extends a
    spilled prefix; the request never sampled, so _fail_all resurrects
    it and the client sees 200 and the cold path's tokens; the reset
    snapshots the flight ring into the journal."""
    eng, base = stack
    _on_loop(eng, eng._clear_prefix_store)
    prompt_a, prompt_b = _prompt(20, [5, 6]), _prompt(20, [7, 8])
    before = eng.resurrected_total
    assert _generate(base, prompt_a, 2)[0] == 200
    _idle(eng)
    _on_loop(eng, lambda: [eng._spill_key(k) for k in
                           list(eng._prefix_store)])
    assert len(eng.host_store) == 1
    failpoints.arm('kv.wake', once=True)
    code, body = _generate(base, prompt_b)
    assert code == 200, body
    assert eng.resurrected_total == before + 1
    assert body['tokens'] == _cold(bridge, prompt_b)
    _idle(eng)
    assert all(s is None for s in eng.slots) and eng._hold == []
    snap = jjournal.query(kind='flight_snapshot')
    assert len(snap) == 1 and 'FailpointError' in snap[0]['reason']
    assert snap[0]['data']['columns'] == ['t_ns', 'code', 'slot', 'seq']
    assert snap[0]['data']['events']


@pytest.mark.parametrize('trigger', ['pressure', 'lru'])
def test_evictions_spill_and_wake(bridge, trigger):
    """Page pressure (a pool of 4 pages: a 100-token prompt reserves 3
    and snapshots 1, so the third prompt must evict) or the LRU bound
    (one entry) spills the first prompt's prefix into the host tier; the
    same prefix with another tail wakes as a hit with the cold path's
    tokens, and the pool ends with only the prefix store's pages in
    use."""
    attrs = ({'kv_pages': 5, 'prefix_cache': 4} if trigger == 'pressure'
             else {'prefix_cache': 1})
    eng = _engine(bridge, spec_k=0, kv_host_mb=64, **attrs)
    server, th, base = _serve(eng)
    try:
        prompts = [[(i * 7 + j) % 250 + 1 for i in range(100)]
                   for j in range(3)]
        for p in prompts:
            assert _generate(base, p)[0] == 200
            _idle(eng)
        assert tuple(prompts[0][:64]) in eng.host_store
        spills = jjournal.query(kind='kv_spill')
        assert spills and sum(e['data']['stored'] for e in spills) >= 1
        hits0 = eng.prefix_hits
        again = prompts[0][:64] + [3, 1, 4]
        code, doc = _generate(base, again)
        assert code == 200 and eng.prefix_hits == hits0 + 1
        assert doc['tokens'] == _cold(bridge, again)
        _idle(eng)
        held = {p for pids in eng._prefix_store.values() for p in pids}
        assert eng.alloc.used_count == len(held)
    finally:
        _close(eng, server, th)
