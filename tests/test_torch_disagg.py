"""Disaggregated prefill/decode on the port (the engine's /disagg
endpoints over serve/disagg/handoff.py), on the CPU — the assertions of
tests/unit_tests/test_disagg.py, held against the JAX package:

  * EQUALITY: prefill on one port replica → framed KV handoff → adopt
    on another → greedy tokens equal to a monolithic run (and to JAX
    ``decode.generate``); both allocators back at their free baselines;
  * SSE continue; a request completed at admission; the refusals
    (missing handoff, integrity, spec, duplicate); the ``prefill.flush``,
    ``handoff.send`` and ``handoff.recv`` arcs; /health;
  * the JAX ``LoadBalancer``'s two-stage pipeline and its retries in
    front of port replicas;
  * ACROSS PACKAGES: a JAX prefill replica handing off to a port decode
    replica, and a port prefill replica to a JAX decode replica, each
    giving the JAX monolith's greedy tokens.

llama-debug in fp32 on weights bridged from JAX, max_len 128, 16-token
prefill chunks and no speculation, as the JAX fixtures."""
import asyncio
import concurrent.futures
import dataclasses
import json
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient
from aiohttp.test_utils import TestServer as AioTestServer

import jax
import jax.numpy as jnp

from skypilot_tpu.models import decode as jdecode
from skypilot_tpu.models import llama as jllama
from skypilot_tpu.serve import engine as jengine
from skypilot_tpu_torch import config
from skypilot_tpu_torch.models import decode, weights
from skypilot_tpu_torch.serve import engine as engine_lib
from skypilot_tpu_torch.serve.disagg import handoff
from skypilot_tpu_torch.utils import failpoints
from skypilot_tpu_torch.utils import framed

MAX_LEN = 128
TARGET = 'X-Skytpu-Handoff-Target'


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _port_pair() -> int:
    """A free HTTP port whose + HANDOFF_PORT_OFFSET is free too (the LB
    derives the decode replica's handoff address so)."""
    for _ in range(100):
        p = _free_port()
        if p + handoff.HANDOFF_PORT_OFFSET >= 65536:
            continue
        with socket.socket() as s:
            try:
                s.bind(('127.0.0.1', p + handoff.HANDOFF_PORT_OFFSET))
            except OSError:
                continue
        return p
    raise RuntimeError('no free port pair')


@pytest.fixture(scope='module')
def bridge():
    jcfg = dataclasses.replace(jllama.PRESETS['llama-debug'],
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(config.PRESETS['llama-debug'],
                               dtype=torch.float32)
    tree = jax.device_get(jllama.init_params(jax.random.PRNGKey(7), jcfg))
    return jax.tree.map(jnp.asarray, tree), jcfg, tree, tcfg


def _engine(bridge):
    _, _, tree, tcfg = bridge
    eng = engine_lib.InferenceEngine(
        'llama-debug', cfg=tcfg, device='cpu', max_len=MAX_LEN,
        params=weights.params_from_jax(tree, tcfg, device='cpu'))
    eng.spec_k = 0
    eng.prefill_chunk = 16
    return eng


def _serve(eng, port=0):
    server = engine_lib.build_app(eng, '127.0.0.1', port)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    eng.start()
    base = f'http://127.0.0.1:{server.server_address[1]}'
    deadline = time.monotonic() + 60
    while _http(base + '/health')[0] != 200:
        assert time.monotonic() < deadline
        time.sleep(0.02)
    return server, th, base


@dataclasses.dataclass
class Stack:
    pre: engine_lib.InferenceEngine
    pbase: str
    dec: engine_lib.InferenceEngine
    dbase: str
    target: str


@pytest.fixture(scope='module')
def stack(bridge):
    """A port prefill replica and a port decode replica whose handoff
    receiver sits at its HTTP port + HANDOFF_PORT_OFFSET."""
    pre, dec = _engine(bridge), _engine(bridge)
    dport = _port_pair()
    dec.handoff_port = dport + handoff.HANDOFF_PORT_OFFSET
    ps, pth, pbase = _serve(pre)
    ds, dth, dbase = _serve(dec, dport)
    yield Stack(pre, pbase, dec, dbase, f'127.0.0.1:{dec.handoff_port}')
    for eng, server, th in ((pre, ps, pth), (dec, ds, dth)):
        server.shutdown()
        server.server_close()
        eng.stop()
        th.join(10)


@pytest.fixture(autouse=True)
def _disarmed(tmp_path, monkeypatch):
    monkeypatch.setenv('SKYTPU_OBSERVE_DB', str(tmp_path / 'observe.db'))
    failpoints.reset()
    yield
    failpoints.reset()


def _http(url, doc=None, headers=None):
    data = json.dumps(doc).encode() if doc is not None else None
    req = urllib.request.Request(url, data=data, headers={
        'Content-Type': 'application/json', **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b'{}')
    except urllib.error.URLError:
        return None, None


def _sse(url, doc):
    """(status, content type, the JSON events, whether [DONE] ended it)."""
    req = urllib.request.Request(url, data=json.dumps(doc).encode(),
                                 headers={'Content-Type': 'application/json'})
    with urllib.request.urlopen(req, timeout=120) as r:
        status, ctype = r.status, r.headers['Content-Type']
        events = [e[len('data: '):] for e in r.read().decode().split('\n\n')
                  if e.startswith('data: ')]
    done = bool(events) and events[-1] == '[DONE]'
    return status, ctype, [json.loads(e) for e in events if e != '[DONE]'], \
        done


def _idle(eng):
    deadline = time.monotonic() + 30
    while eng.in_flight() or eng.queue_depth():
        assert time.monotonic() < deadline
        time.sleep(0.01)


def _ref(bridge, prompt, n):
    jparams, jcfg, _, _ = bridge
    b = decode.bucket_size(len(prompt))
    padded = jnp.asarray([prompt + [0] * (b - len(prompt))], jnp.int32)
    return np.asarray(jdecode.generate(
        jparams, padded, jcfg, n, max_len=MAX_LEN,
        prompt_lengths=jnp.asarray([len(prompt)], jnp.int32)))[0].tolist()


def _samples(text, name):
    out = {}
    for line in text.splitlines():
        if line.startswith(name + '{'):
            key, val = line.rsplit(' ', 1)
            out[key[len(name):]] = float(val)
    return out


def _prefill(s, prompt, max_new, orig='/generate', **extra):
    body = ({'tokens': prompt, 'max_new_tokens': max_new}
            if orig == '/generate' else
            {'prompt': prompt, 'max_tokens': max_new, 'temperature': 0.0,
             **extra})
    return _http(f'{s.pbase}/disagg/prefill?orig={orig}', body,
                 {TARGET: s.target})


# ---------------------------------------------------------------------------
# Equality and conservation
# ---------------------------------------------------------------------------

def test_two_stage_matches_monolith_and_conserves_pages(bridge, stack):
    s = stack
    prompt = list(range(1, 40))        # > 16: chunked prefill
    free_p, free_d = s.pre.alloc.free_count, s.dec.alloc.free_count
    code, ref = _http(s.dbase + '/generate', {'tokens': prompt,
                                              'max_new_tokens': 10})
    assert code == 200 and ref['tokens'] == _ref(bridge, prompt, 10)
    _idle(s.dec)
    code, doc1 = _prefill(s, prompt, 10)
    assert code == 200, doc1
    assert doc1['handoff']['first_token'] == ref['tokens'][0]
    assert doc1['handoff']['prompt_tokens'] == len(prompt)
    code, doc2 = _http(s.dbase + '/disagg/continue?orig=/generate',
                       {'handoff_id': doc1['handoff']['id']})
    assert code == 200, doc2
    assert doc2['tokens'] == ref['tokens']
    assert doc2['finish_reason'] == ref['finish_reason']
    np.testing.assert_allclose(doc2['logprobs'], ref['logprobs'], atol=1e-5)
    _idle(s.pre)
    _idle(s.dec)
    assert s.pre.alloc.free_count == free_p
    assert s.dec.alloc.free_count == free_d
    # Handoff telemetry moved on both sides.
    for base, stage in ((s.pbase, 'export'), (s.pbase, 'send'),
                        (s.dbase, 'adopt')):
        with urllib.request.urlopen(base + '/metrics') as r:
            text = r.read().decode()
        got = _samples(text, 'skytpu_engine_handoff_total')
        assert sum(v for k, v in got.items() if f'stage="{stage}"' in k
                   and 'outcome="ok"' in k) >= 1


def test_streaming_continue_emits_sse_and_done(bridge, stack):
    s = stack
    prompt = list(range(2, 40))
    code, doc1 = _prefill(s, prompt, 6, '/v1/completions', stream=True)
    assert code == 200, doc1
    status, ctype, events, done = _sse(
        s.dbase + '/disagg/continue?orig=/v1/completions',
        {'handoff_id': doc1['handoff']['id'], 'stream': True})
    assert status == 200 and ctype.startswith('text/event-stream')
    assert done and events
    assert events[-1]['choices'][0]['finish_reason'] == 'length'
    text = ''.join(e['choices'][0]['text'] for e in events)
    assert text == s.dec.tokenizer.decode(_ref(bridge, prompt, 6))
    _idle(s.dec)


def test_completed_at_admission_returns_done(stack):
    s = stack
    free_p = s.pre.alloc.free_count
    code, doc = _prefill(s, list(range(1, 20)), 1)
    assert code == 200
    assert 'done' in doc and 'handoff' not in doc
    assert doc['done']['finish_reason'] == 'length'
    assert len(doc['done']['tokens']) == 1
    _idle(s.pre)
    assert s.pre.alloc.free_count == free_p


def test_concurrent_handoffs_batch_on_the_decode_side(bridge, stack):
    """Four handoffs continued at once decode together; each equals its
    own monolithic run."""
    s = stack
    prompts = [list(range(3 + i, 25 + 3 * i)) for i in range(4)]
    with concurrent.futures.ThreadPoolExecutor(4) as ex:
        firsts = list(ex.map(lambda p: _prefill(s, p, 8), prompts))
        assert all(c == 200 for c, _ in firsts)
        outs = list(ex.map(lambda d: _http(
            s.dbase + '/disagg/continue?orig=/generate',
            {'handoff_id': d[1]['handoff']['id']}), firsts))
    for p, (code, doc) in zip(prompts, outs):
        assert code == 200 and doc['tokens'] == _ref(bridge, p, 8)
    _idle(s.dec)


def test_handoff_stress_loses_no_marker_or_page(bridge, stack):
    """24 handoffs from 24 threads under a short switch interval: the
    request markers and export blobs that handler threads and the batch
    loop share are all consumed, every answer is its monolith's, and
    every page comes back on both sides."""
    s = stack
    free_p, free_d = s.pre.alloc.free_count, s.dec.alloc.free_count
    prompts = [[(i * 11 + j) % 200 + 1 for i in range(20)] for j in range(24)]
    refs = {tuple(p): _ref(bridge, p, 3) for p in prompts}

    def one(p):
        code, doc = _prefill(s, p, 3)
        assert code == 200, doc
        return _http(s.dbase + '/disagg/continue?orig=/generate',
                     {'handoff_id': doc['handoff']['id']})

    import sys
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with concurrent.futures.ThreadPoolExecutor(24) as ex:
            outs = list(ex.map(one, prompts))
    finally:
        sys.setswitchinterval(old)
    for p, (code, doc) in zip(prompts, outs):
        assert code == 200 and doc['tokens'] == refs[tuple(p)]
    _idle(s.pre)
    _idle(s.dec)
    assert not s.pre._disagg_marks and not s.pre._exports
    assert not s.dec._disagg_marks
    assert s.pre.alloc.free_count == free_p
    assert s.dec.alloc.free_count == free_d


# ---------------------------------------------------------------------------
# Refusals
# ---------------------------------------------------------------------------

def test_missing_handoff_is_structured_retriable_503(stack):
    code, doc = _http(stack.dbase + '/disagg/continue?orig=/generate',
                      {'handoff_id': 'deadbeef'})
    assert code == 503
    assert doc['error']['type'] == 'handoff_missing'
    assert doc['error']['retriable'] is True


def test_bad_prefill_requests(stack):
    s = stack
    code, doc = _http(s.pbase + '/disagg/prefill?orig=/generate',
                      {'tokens': [1, 2], 'max_new_tokens': 2})
    assert code == 400 and TARGET in doc['error']
    code, doc = _http(s.pbase + '/disagg/prefill?orig=/v1/chat/completions',
                      {'messages': []}, {TARGET: s.target})
    assert code == 400 and 'unsupported orig' in doc['error']
    code, doc = _prefill(s, list(range(5)), 2, '/v1/completions', n=2)
    assert code == 400 and 'single-choice' in doc['error']
    # A replica with no receiver cannot continue.
    code, doc = _http(s.pbase + '/disagg/continue', {'handoff_id': 'x'})
    assert code == 501 and doc['error']['type'] == 'handoff_unsupported'


def _meta_for(eng, arrays, tokens, first=5):
    return handoff.build_meta(
        handoff_id=handoff.new_handoff_id(), model=eng.model_name,
        vocab_size=eng.cfg.vocab_size, page_size=eng.page_size,
        family=eng.cache_family(), bucket=decode.bucket_size(len(tokens)),
        tokens=tokens, max_new=4, first_token=first, first_lp=0.0,
        first_tops=[], temperature=0.0, top_k=None, top_p=None,
        presence_penalty=0.0, frequency_penalty=0.0, stop_ids=[],
        want_tops=False, cls='other', kv_sha256=handoff.kv_fingerprint(arrays))


def test_integrity_and_spec_and_duplicate_refusals(stack):
    s = stack
    tokens = list(range(1, 20))
    addr = framed.parse_addr(s.target)
    shp = s.dec.cache.k.shape          # [L, P, psz, KH, hd]
    a = np.zeros((shp[0], 1, 32, shp[3], shp[4]), 'float32')
    arrays = {'a': a, 'b': np.zeros_like(a)}
    free_d, staged = s.dec.alloc.free_count, len(s.dec.handoff_store)
    bad = {'a': a.copy(), 'b': arrays['b']}
    bad['a'][0, 0, 0, 0, 0] = 1.0
    with pytest.raises(handoff.HandoffError) as ei:
        handoff.send(addr, _meta_for(s.dec, arrays, tokens), bad)
    assert ei.value.kind == 'integrity'
    meta2 = _meta_for(s.dec, arrays, tokens)
    meta2['vocab_size'] = 999
    with pytest.raises(handoff.HandoffError) as ei:
        handoff.send(addr, meta2, arrays)
    assert ei.value.kind == 'spec' and ei.value.retriable is False
    meta3 = _meta_for(s.dec, arrays, tokens)
    handoff.send(addr, meta3, arrays)
    with pytest.raises(handoff.HandoffError) as ei:
        handoff.send(addr, meta3, arrays)
    assert ei.value.kind == 'duplicate'
    # Staged but never continued: host memory only.
    assert len(s.dec.handoff_store) == staged + 1
    assert s.dec.handoff_store.sweep() == 0
    assert s.dec.alloc.free_count == free_d
    code, doc = _http(s.dbase + '/health')
    assert doc['handoff_staged'] == staged + 1
    assert s.dec.handoff_store.pop(meta3['handoff_id']) is not None


def test_health_and_validate_surface(stack):
    s = stack
    code, doc = _http(s.dbase + '/health')
    assert code == 200
    assert doc['handoff_port'] == s.dec.handoff_port
    assert doc['handoff_staged'] == len(s.dec.handoff_store)
    code, doc = _http(s.pbase + '/health')
    assert 'handoff_port' not in doc
    meta = {'family': s.dec.cache_family(),
            'vocab_size': s.dec.cfg.vocab_size, 'model': s.dec.model_name,
            'tokens': list(range(100)), 'bucket': decode.bucket_size(100),
            'max_new': 1000}
    assert 'exceeds replica max_len' in s.dec.handoff_validate(meta)
    for field, value, needle in (('family', 'paged_latent', 'family'),
                                 ('model', 'other', 'model'),
                                 ('bucket', 64, 'bucket'),
                                 ('tokens', [], 'empty')):
        assert needle in s.dec.handoff_validate(
            {**meta, 'max_new': 4, field: value})
    fits = {**meta, 'tokens': list(range(50)), 'bucket': 64, 'max_new': 4}
    assert s.dec.handoff_validate(fits) is None


# ---------------------------------------------------------------------------
# Failure arcs
# ---------------------------------------------------------------------------

def test_prefill_flush_failpoint_is_structured_retriable(bridge, stack):
    s = stack
    prompt = list(range(3, 40))
    failpoints.arm('prefill.flush', once=True)
    code, doc = _prefill(s, prompt, 6)
    assert code == 503
    assert doc['error']['type'] == 'engine_reset_error'
    assert doc['error']['retriable'] is True
    # Recovered: the same request round-trips and nothing leaks.
    _idle(s.pre)
    free_p = s.pre.alloc.free_count
    code, doc1 = _prefill(s, prompt, 6)
    assert code == 200, doc1
    code, doc2 = _http(s.dbase + '/disagg/continue?orig=/generate',
                       {'handoff_id': doc1['handoff']['id']})
    assert code == 200 and doc2['tokens'] == _ref(bridge, prompt, 6)
    _idle(s.pre)
    assert s.pre.alloc.free_count == free_p


def test_handoff_send_failpoint_is_structured_retriable(stack):
    s = stack
    free_p = s.pre.alloc.free_count
    failpoints.arm('handoff.send', once=True)
    code, doc = _prefill(s, list(range(4, 40)), 6)
    assert code == 503
    assert doc['error']['type'] == 'handoff_send_error'
    assert doc['error']['retriable'] is True
    _idle(s.pre)
    assert s.pre.alloc.free_count == free_p


def test_handoff_recv_failpoint_refuses_and_decode_pool_clean(stack):
    s = stack
    free_d, staged = s.dec.alloc.free_count, len(s.dec.handoff_store)
    failpoints.arm('handoff.recv', once=True)
    code, doc = _prefill(s, list(range(5, 40)), 6)
    assert code == 503
    assert doc['error']['type'] == 'handoff_send_error'
    assert doc['error']['retriable'] is True
    assert s.dec.alloc.free_count == free_d
    assert len(s.dec.handoff_store) == staged


def test_adopt_fault_resurrects_the_handed_off_request(bridge, stack):
    """An engine.admit fault inside the adoption: the request never
    sampled on this replica, so it is resurrected (its marker and rows
    kept) and decodes to the monolith's tokens."""
    s = stack
    prompt = list(range(6, 40))
    code, doc1 = _prefill(s, prompt, 5)
    assert code == 200
    before = s.dec.resurrected_total
    failpoints.arm('engine.admit', once=True)
    code, doc2 = _http(s.dbase + '/disagg/continue?orig=/generate',
                       {'handoff_id': doc1['handoff']['id']})
    assert code == 200 and doc2['tokens'] == _ref(bridge, prompt, 5)
    assert s.dec.resurrected_total == before + 1
    _idle(s.dec)
    assert s.dec.alloc.free_count == s.dec.n_pages - 1 - len(
        {p for pids in s.dec._prefix_store.values() for p in pids})


# ---------------------------------------------------------------------------
# The JAX LoadBalancer in front of port replicas
# ---------------------------------------------------------------------------

def _run(coro, timeout=120):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(asyncio.wait_for(coro, timeout))
    finally:
        loop.close()


def _run_lb(stack, fn, dead_prefill=False):
    """A real JAX LoadBalancer fronting the port prefill replica
    (optionally after a dead address) and the port decode replica, whose
    handoff receiver sits at the LB's derived fixed-offset port."""
    from skypilot_tpu.serve import load_balancer as lb_lib

    async def inner():
        live, decode_url = stack.pbase, stack.dbase
        dead = f'http://127.0.0.1:{_free_port()}'
        lb = lb_lib.LoadBalancer('prefix_affinity',
                                 service_name='disagg-port-test')
        lb.set_ready_replicas([decode_url])
        lb.set_pool_replicas([dead, live] if dead_prefill else [live],
                             [decode_url])
        lb._pools.min_prompt = 16       # the short test prompts route
        client = TestClient(AioTestServer(lb.build_app()))
        await client.start_server()
        try:
            return await fn(client, lb, live)
        finally:
            await client.close()
    return _run(inner())


def test_lb_retries_prefill_on_dead_replica_then_completes(bridge, stack):
    s = stack
    prompt = list(range(6, 40))
    free_p, free_d = s.pre.alloc.free_count, s.dec.alloc.free_count
    exports = s.pre.metrics.handoff.value(stage='export', outcome='ok')

    async def fn(client, lb, live):
        lb._pools._prefill.request_started(live)   # the dead one first
        r = await client.post('/generate', json={'tokens': prompt,
                                                 'max_new_tokens': 6})
        return r.status, await r.json()

    status, doc = _run_lb(s, fn, dead_prefill=True)
    assert status == 200, doc
    assert doc['tokens'] == _ref(bridge, prompt, 6)
    assert s.pre.metrics.handoff.value(stage='export',
                                       outcome='ok') == exports + 1
    _idle(s.pre)
    _idle(s.dec)
    assert s.pre.alloc.free_count == free_p
    assert s.dec.alloc.free_count == free_d


def test_lb_retry_completes_after_armed_send_failure(bridge, stack):
    s = stack
    prompt = list(range(7, 40))

    async def fn(client, lb, live):
        failpoints.arm('handoff.send', once=True)
        r = await client.post('/generate', json={'tokens': prompt,
                                                 'max_new_tokens': 4})
        return r.status, await r.json()

    status, doc = _run_lb(s, fn)
    assert status == 200, doc
    assert doc['tokens'] == _ref(bridge, prompt, 4)
    _idle(s.pre)
    _idle(s.dec)


def test_lb_exhausted_attempts_is_structured_retriable_502(bridge, stack):
    s = stack
    prompt = list(range(8, 40))
    free_d = s.dec.alloc.free_count

    async def fn(client, lb, live):
        failpoints.arm('handoff.send')
        r = await client.post('/generate', json={'tokens': prompt,
                                                 'max_new_tokens': 4})
        first = (r.status, await r.json())
        failpoints.reset()
        r2 = await client.post('/generate', json={'tokens': prompt,
                                                  'max_new_tokens': 4})
        return first, (r2.status, await r2.json())

    (status, doc), (status2, doc2) = _run_lb(s, fn)
    assert status == 502
    assert doc['retriable'] is True and 'pipeline failed' in doc['error']
    assert status2 == 200 and doc2['tokens'] == _ref(bridge, prompt, 4)
    _idle(s.pre)
    _idle(s.dec)
    assert s.dec.alloc.free_count == free_d


# ---------------------------------------------------------------------------
# Across packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def jax_engine(bridge):
    """A JAX engine on the same bridged fp32 weights, configured as the
    JAX disagg fixtures (max_len 128, 16-token chunks, no speculation)."""
    jparams, jcfg, _, _ = bridge
    eng = jengine.InferenceEngine('llama-debug', max_len=MAX_LEN, seed=0)
    eng.cfg = jcfg
    eng.params = jdecode.cast_params_for_decode(jparams, jcfg)
    eng.spec_k = 0
    eng.paged = True
    eng.prefill_chunk = 16
    eng.warmup()
    return eng


def _run_jax(eng, fn, handoff_port=None):
    async def inner():
        eng.handoff_port = handoff_port
        client = TestClient(AioTestServer(jengine.build_app(eng)))
        await client.start_server()
        try:
            return await fn(client)
        finally:
            await client.close()
            eng.handoff_store = None
    return _run(inner())


def test_jax_prefill_hands_off_to_port_decode(jax_engine, stack):
    s = stack
    prompt = list(range(9, 48))
    free_d = s.dec.alloc.free_count

    async def fn(jc):
        mono = await jc.post('/generate', json={'tokens': prompt,
                                                'max_new_tokens': 8})
        free_j = jax_engine.alloc.free_count
        r1 = await jc.post('/disagg/prefill?orig=/generate',
                           json={'tokens': prompt, 'max_new_tokens': 8},
                           headers={TARGET: s.target})
        doc1 = await r1.json()
        deadline = time.monotonic() + 10
        while jax_engine.in_flight() or jax_engine.queue_depth():
            assert time.monotonic() < deadline
            await asyncio.sleep(0.01)
        return (await mono.json())['tokens'], r1.status, doc1, \
            (free_j, jax_engine.alloc.free_count)

    mono, status, doc1, free_j = _run_jax(jax_engine, fn)
    assert status == 200, doc1
    code, doc2 = _http(s.dbase + '/disagg/continue?orig=/generate',
                       {'handoff_id': doc1['handoff']['id']})
    assert code == 200 and doc2['tokens'] == mono
    _idle(s.dec)
    assert free_j[0] == free_j[1]
    assert s.dec.alloc.free_count == free_d


def test_port_prefill_hands_off_to_jax_decode(jax_engine, stack):
    s = stack
    prompt = list(range(10, 50))
    free_p = s.pre.alloc.free_count
    hport = _free_port()

    async def fn(jc):
        mono = await jc.post('/generate', json={'tokens': prompt,
                                                'max_new_tokens': 8})
        free_j = jax_engine.alloc.free_count
        code, doc1 = await asyncio.to_thread(
            _http, f'{s.pbase}/disagg/prefill?orig=/generate',
            {'tokens': prompt, 'max_new_tokens': 8},
            {TARGET: f'127.0.0.1:{hport}'})
        assert code == 200, doc1
        r2 = await jc.post('/disagg/continue?orig=/generate',
                           json={'handoff_id': doc1['handoff']['id']})
        doc2 = await r2.json()
        deadline = time.monotonic() + 10
        while jax_engine.in_flight() or jax_engine.queue_depth():
            assert time.monotonic() < deadline
            await asyncio.sleep(0.01)
        return (await mono.json())['tokens'], r2.status, doc2, \
            (free_j, jax_engine.alloc.free_count)

    mono, status, doc2, free_j = _run_jax(jax_engine, fn, handoff_port=hport)
    assert status == 200, doc2
    assert doc2['tokens'] == mono
    _idle(s.pre)
    assert free_j[0] == free_j[1]
    assert s.pre.alloc.free_count == free_p
