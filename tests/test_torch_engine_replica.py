"""The PyTorch port's engine as a serve-plane replica, on the CPU, vs the
JAX package.

llama-debug in fp32 on weights bridged from JAX ``init_params``, one
module-scoped engine with speculation off (as the JAX chaos and
pipeline fixtures pin the pipelined path). Held here:
  * the knobs: read under the JAX engine's names with its registry's
    defaults; those whose feature waits refused by name;
  * ``GET /`` answering as ``/health``;
  * the JAX chaos scenarios (tests/chaos/test_scenarios.py, section A)
    on the port: injected step faults, resurrection after an admit
    fault, its budget, the disposition matrix of ``_fail_all`` and a
    streamed reset; resurrected greedy tokens equal JAX
    ``decode.generate`` and no slot or page leaks;
  * ``/metrics`` and ``/debug/flight`` (the metric assertions of the
    JAX engine tests), the families against JAX's ``_ENGINE_METRICS``,
    and the port's copies of the observability modules against their
    originals on the same operations;
  * ``n`` / ``best_of`` / batched prompts (JAX test_engine.py), greedy
    choices equal to ``decode.generate``, no orphan after a 429;
  * JAX's own fleet scraper reading the port replica.
Prompts stay under 64 tokens (no prefix snapshot holds a page), so
"every page back" is ``free_count == n_pages - 1``.
"""
import concurrent.futures
import dataclasses
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from skypilot_tpu.models import decode as jdecode
from skypilot_tpu.models import llama as jllama
from skypilot_tpu_torch import config
from skypilot_tpu_torch.models import decode, weights
from skypilot_tpu_torch.observe import flight as flight_lib
from skypilot_tpu_torch.observe import metrics as metrics_lib
from skypilot_tpu_torch.observe import request_class
from skypilot_tpu_torch.serve import engine as engine_lib
from skypilot_tpu_torch.utils import failpoints
from skypilot_tpu_torch.utils import knobs

MAX_LEN, REF_NEW = 128, 16
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope='module')
def bridge():
    """(JAX params, JAX cfg, host tree, torch cfg): llama-debug fp32."""
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


def _serve(eng, start=True):
    server = engine_lib.build_app(eng)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    base = f'http://127.0.0.1:{server.server_address[1]}'
    if start:
        eng.start()
        deadline = time.monotonic() + 60
        while _http(base + '/health')[0] != 200:
            assert time.monotonic() < deadline
            time.sleep(0.02)
    return server, th, base


def _close(eng, server, th):
    server.shutdown()
    server.server_close()
    eng.stop()
    th.join(10)
    assert not th.is_alive()


@pytest.fixture(scope='module')
def stack(bridge):
    """(engine, base url): the warm module engine behind its server."""
    eng = _engine(bridge, spec_k=0)
    server, th, base = _serve(eng)
    yield eng, base
    _close(eng, server, th)


@pytest.fixture(autouse=True)
def disarmed():
    """Every test starts and ends with no failpoint armed."""
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
        return e.code, json.loads(e.read())


def _text(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return r.status, r.headers['Content-Type'], r.read().decode()


def _stream(url, doc):
    """POST a streaming request: the raw body (read to its end)."""
    req = urllib.request.Request(url, data=json.dumps(doc).encode(),
                                 headers={'Content-Type': 'application/json'})
    with urllib.request.urlopen(req, timeout=120) as r:
        assert r.status == 200
        return r.read().decode()


def _samples(text, name):
    """{label text: value} of one family's samples in an exposition."""
    out = {}
    for line in text.splitlines():
        if line.startswith(name) and not line.startswith('#'):
            key, val = line.rsplit(' ', 1)
            if key == name or key.startswith(name + '{'):
                out[key[len(name):]] = float(val)
    return out


_REFS = {}


def _ref(bridge, prompt, n):
    """JAX decode.generate's greedy tokens, right-padded to the prompt's
    bucket (one compile per bucket)."""
    key = tuple(prompt)
    if key not in _REFS:
        jparams, jcfg, _, _ = bridge
        b = decode.bucket_size(len(prompt))
        padded = jnp.asarray([prompt + [0] * (b - len(prompt))], jnp.int32)
        _REFS[key] = np.asarray(jdecode.generate(
            jparams, padded, jcfg, REF_NEW, max_len=MAX_LEN,
            prompt_lengths=jnp.asarray([len(prompt)], jnp.int32)))[0].tolist()
    assert n <= REF_NEW
    return _REFS[key][:n]


def _idle(eng):
    """Wait for the loop to go idle; then no slot, call or hold is left
    and every page is back in the allocator."""
    deadline = time.monotonic() + 30
    while eng.in_flight() or eng.queue_depth():
        assert time.monotonic() < deadline
        time.sleep(0.01)
    assert all(s is None for s in eng.slots)
    assert eng._inflight == [] and eng._hold == []
    assert eng.alloc.free_count == eng.n_pages - 1


# ---------------------------------------------------------------------------
# Knobs
# ---------------------------------------------------------------------------

def test_port_knobs_have_the_jax_names_types_and_defaults():
    from skypilot_tpu.utils import knobs as jknobs
    port_only = {'SKYTPU_TORCH_DIST_BACKEND'}     # no JAX counterpart
    assert set(knobs.REGISTRY) - port_only == {
        n for n in jknobs.REGISTRY if n.startswith('SKYTPU_ENGINE_')} | {
        'SKYTPU_FLIGHT_CAPACITY', 'SKYTPU_FAILPOINTS',
        'SKYTPU_HANDOFF_TIMEOUT', 'SKYTPU_HANDOFF_TTL',
        'SKYTPU_OBSERVE_DB', 'SKYTPU_DISABLE_JOURNAL',
        'SKYTPU_RING_BWD_CHUNK', 'SKYTPU_RING_BWD_FLASH',
        'SKYTPU_COORDINATOR_ADDRESS', 'SKYTPU_NUM_PROCESSES',
        'SKYTPU_NODE_RANK', 'SKYTPU_JOB_ID', 'SKYTPU_SERVE_PORT'} | {
        n for n in jknobs.REGISTRY if n.startswith('SKYTPU_MH_')} | {
        n for n in jknobs.REGISTRY if n.startswith('SKYTPU_ROLLOUT_')}
    assert not port_only & set(jknobs.REGISTRY)
    for name, knob in knobs.REGISTRY.items():
        if name in port_only:
            continue
        j = jknobs.REGISTRY[name]
        assert (knob.type, knob.default, knob.choices) == \
            (j.type, j.default, j.choices), name
    # The engine's module constants are the registry's defaults here.
    for const, name in (('MAX_BATCH', 'SKYTPU_ENGINE_MAX_BATCH'),
                        ('PAGE_SIZE', 'SKYTPU_ENGINE_PAGE_SIZE'),
                        ('MAX_QUEUE', 'SKYTPU_ENGINE_MAX_QUEUE'),
                        ('RESURRECT_MAX', 'SKYTPU_ENGINE_RESURRECT_MAX')):
        assert getattr(engine_lib, const) == jknobs.default_of(name)


def test_engine_reads_its_knobs_under_the_jax_names(monkeypatch):
    """The four knobs the port hardcoded before, set in a fresh process:
    the module constants and a new engine's pool, queue and budget
    follow them; a malformed value fails by name."""
    code = (
        'from skypilot_tpu_torch.serve import engine as e\n'
        'import dataclasses, torch\n'
        'from skypilot_tpu_torch import config\n'
        "cfg = dataclasses.replace(config.PRESETS['llama-debug'], "
        'dtype=torch.float32)\n'
        "eng = e.InferenceEngine('llama-debug', cfg=cfg, device='cpu', "
        'max_len=64)\n'
        'eng._ensure_state()\n'
        'print(e.MAX_BATCH, e.PAGE_SIZE, e.MAX_QUEUE, e.RESURRECT_MAX, '
        'len(eng.slots), eng.page_size, eng._queue.maxsize, '
        'eng.resurrect_max, eng.n_pages)\n')
    env = dict(os.environ, PYTHONPATH=ROOT, SKYTPU_ENGINE_MAX_BATCH='4',
               SKYTPU_ENGINE_PAGE_SIZE='32', SKYTPU_ENGINE_MAX_QUEUE='5',
               SKYTPU_ENGINE_RESURRECT_MAX='3')
    out = subprocess.run([sys.executable, '-c', code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    # 4 slots + 4 prefix entries, 2 pages of 32 each, + the trash page.
    assert out.stdout.split() == ['4', '32', '5', '3', '4', '32', '5', '3',
                                  '17']
    monkeypatch.setenv('SKYTPU_ENGINE_MAX_BATCH', 'eight')
    with pytest.raises(knobs.KnobError,
                       match="SKYTPU_ENGINE_MAX_BATCH='eight' is not an "
                             'integer'):
        knobs.get_int('SKYTPU_ENGINE_MAX_BATCH')
    monkeypatch.setenv('SKYTPU_ENGINE_ATTN', 'flash')
    with pytest.raises(knobs.KnobError, match='SKYTPU_ENGINE_ATTN'):
        knobs.get_enum('SKYTPU_ENGINE_ATTN')


# The K/V layouts (ROADMAP Queue 1 item 3), refused by name before they
# were ported: each now takes effect, read at construction, and serves
# /generate with the greedy tokens of the default layout.
@pytest.mark.parametrize('name,value,attrs', [
    ('SKYTPU_ENGINE_PAGED', '0', (False, 'fused')),
    ('SKYTPU_ENGINE_ATTN', 'gather', (True, 'gather')),
])
def test_layout_knobs_now_take_effect(bridge, monkeypatch, name, value,
                                      attrs):
    prompt = [3, 1, 4, 1, 5, 9, 2, 6]
    outs = []
    for env in ({}, {name: value}):
        for key, val in env.items():
            monkeypatch.setenv(key, val)
        eng = _engine(bridge, spec_k=0)
        assert (eng.paged, eng.attn_backend) == \
            (attrs if env else (True, 'fused'))
        server, th, base = _serve(eng)
        try:
            status, doc = _http(base + '/generate',
                                {'tokens': prompt, 'max_new_tokens': 8})
            assert status == 200
            outs.append(doc['tokens'])
        finally:
            _close(eng, server, th)
    assert outs[0] == outs[1]


def _fresh_engine(env, expr):
    """``expr`` evaluated on a new llama-debug engine (its state built)
    in a fresh process with ``env`` set: the knobs read at import."""
    code = (
        'from skypilot_tpu_torch.serve import engine as e\n'
        'import dataclasses, torch\n'
        'from skypilot_tpu_torch import config\n'
        "cfg = dataclasses.replace(config.PRESETS['llama-debug'], "
        'dtype=torch.float32)\n'
        "eng = e.InferenceEngine('llama-debug', cfg=cfg, device='cpu', "
        'max_len=64)\n'
        'eng._ensure_state()\n'
        f'print({expr})\n')
    out = subprocess.run([sys.executable, '-c', code],
                         env=dict(os.environ, PYTHONPATH=ROOT, **env),
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    return out.stdout.split()


# The knobs of the KV hierarchy (ROADMAP Queue 1 item 4 (e)) and of
# disaggregated serving (item 4 (f)), refused by name before they were
# ported: each now takes effect.
@pytest.mark.parametrize('name,value', [
    ('SKYTPU_ENGINE_ROLE', 'prefill'),
    ('SKYTPU_ENGINE_ROLE', 'decode'),
    ('SKYTPU_ENGINE_HANDOFF_PORT', '9300'),
    ('SKYTPU_ENGINE_WARM_DISAGG', '1'),
    ('SKYTPU_ENGINE_KV_HOST_MB', '64'),
    ('SKYTPU_ENGINE_KV_IDLE_SPILL_S', '2.5'),
])
def test_kv_and_disagg_knobs_now_work(bridge, monkeypatch, name, value):
    monkeypatch.setenv(name, value)
    if name == 'SKYTPU_ENGINE_ROLE':
        eng = _engine(bridge)
        assert eng.role == value
        server, th, base = _serve(eng)
        try:
            assert _http(base + '/health')[1]['role'] == value
        finally:
            _close(eng, server, th)
    elif name == 'SKYTPU_ENGINE_HANDOFF_PORT':
        args = engine_lib.build_parser().parse_args([])
        assert args.handoff_port == 9300
        assert engine_lib.handoff_port_for(args.handoff_port,
                                           args.port) == 9300
        assert engine_lib.handoff_port_for(-1, 8300) == 9300
        assert engine_lib.handoff_port_for(0, 8300) is None
    elif name == 'SKYTPU_ENGINE_WARM_DISAGG':
        eng = _engine(bridge, spec_k=0)
        seen = []
        orig = engine_lib.paging.adopt_rows

        def adopt(pcache, a, b, slot, s, new_len):
            seen.append(s)
            return orig(pcache, a, b, slot, s, new_len)
        monkeypatch.setattr(engine_lib.paging, 'adopt_rows', adopt)
        eng.warmup()
        # Once per bucket below max_len, and every page back.
        assert seen == [16, 32, 64]
        assert eng.alloc.free_count == eng.n_pages - 1
    elif name == 'SKYTPU_ENGINE_KV_HOST_MB':
        assert _fresh_engine({name: value}, 'e.KV_HOST_MB, eng.kv_host_mb, '
                             'eng.host_store.occupancy()["budget_bytes"]') \
            == ['64', '64', str(64 << 20)]
    else:
        assert _fresh_engine({name: value}, 'e.KV_IDLE_SPILL_S, '
                             'eng.kv_idle_spill_s') == ['2.5', '2.5']


@pytest.mark.parametrize('name,value', [
    ('SKYTPU_ENGINE_ATTN', 'fused'), ('SKYTPU_ENGINE_ATTN', 'pallas'),
    ('SKYTPU_ENGINE_PAGED', '1'), ('SKYTPU_ENGINE_HANDOFF_PORT', '0'),
    ('SKYTPU_ENGINE_HANDOFF_PORT', '-1'), ('SKYTPU_ENGINE_ROLE', ''),
])
def test_knob_values_the_port_serves_are_accepted(bridge, monkeypatch, name,
                                                  value):
    monkeypatch.setenv(name, value)
    assert _engine(bridge).page_size == engine_lib.PAGE_SIZE


# ---------------------------------------------------------------------------
# GET / and the saturation doc
# ---------------------------------------------------------------------------

def test_root_answers_as_health(bridge, stack):
    eng, base = stack
    cold = _engine(bridge)
    server, th, cold_base = _serve(cold, start=False)
    try:
        for path in ('/', '/health'):
            assert _http(cold_base + path) == (503, {'status': 'warming'})
    finally:
        _close(cold, server, th)
    _idle(eng)
    want = {'status': 'ok', 'queue_depth': 0, 'in_flight': 0,
            'kv_pages_free': eng.n_pages - 1}
    assert _http(base + '/') == _http(base + '/health') == (200, want)
    eng.loop_error = RuntimeError('loop died')
    try:
        for path in ('/', '/health'):
            assert _http(base + path) == (500, {'status': 'failed',
                                                'error': 'loop died'})
    finally:
        eng.loop_error = None


# ---------------------------------------------------------------------------
# Fault containment (tests/chaos/test_scenarios.py, section A)
# ---------------------------------------------------------------------------

def test_injected_step_faults_zero_hangs_structured_errors(bridge, stack):
    """Seeded step faults under 8 concurrent requests: each answers 200
    or the structured retriable 503 in time, the engine then serves
    JAX's greedy tokens, nothing leaks and the reset recaptured
    nothing (the CPU has no graphs: the same tensors are reused)."""
    eng, base = stack
    failpoints.arm('engine.step', every=3, max_fires=2)
    resets0, cache0 = eng._resets, eng.cache
    with concurrent.futures.ThreadPoolExecutor(8) as ex:
        answers = list(ex.map(lambda i: _http(base + '/generate', {
            'tokens': [i + 1] * 8, 'max_new_tokens': 6}), range(8)))
    # Disarm explicitly: the burst may not have spent every firing.
    failpoints.reset()
    for code, doc in answers:
        assert code in (200, 503), doc
        if code == 503:
            err = doc['error']
            assert err['type'] == 'engine_reset_error'
            assert err['retriable'] is True
            assert isinstance(err['tokens_emitted'], int)
        else:
            assert len(doc['tokens']) == 6
    assert eng._resets > resets0 and eng.cache is cache0
    code, doc = _http(base + '/generate', {'tokens': [3] * 8,
                                           'max_new_tokens': 6})
    assert code == 200 and doc['tokens'] == _ref(bridge, [3] * 8, 6)
    _idle(eng)


def test_admit_fault_resurrects_request_to_completion(bridge, stack):
    """A request whose admission faults never sampled: it is resubmitted
    and completes with JAX's greedy tokens; the client never sees the
    fault."""
    eng, base = stack
    before = eng.resurrected_total
    metric_before = eng.metrics.resurrected.value()
    failpoints.arm('engine.admit', once=True)
    code, doc = _http(base + '/generate', {'tokens': [5] * 8,
                                           'max_new_tokens': 6})
    assert code == 200 and doc['tokens'] == _ref(bridge, [5] * 8, 6)
    assert eng.resurrected_total == before + 1
    assert eng.metrics.resurrected.value() == metric_before + 1
    _idle(eng)


def test_resurrection_budget_bounds_retries(stack):
    """An admission that faults every time surfaces a bounded,
    structured failure after RESURRECT_MAX resubmissions."""
    eng, base = stack
    before = eng.resurrected_total
    failpoints.arm('engine.admit', every=1)
    code, doc = _http(base + '/generate', {'tokens': [6] * 8,
                                           'max_new_tokens': 4})
    failpoints.reset()
    assert code == 503
    err = doc['error']
    assert err['type'] == 'engine_reset_error' and err['retriable'] is True
    assert err['tokens_emitted'] == 0
    assert eng.resurrected_total == before + engine_lib.RESURRECT_MAX
    _idle(eng)


def test_fail_all_dispositions_each_row_minimally(bridge):
    """The containment matrix, row by row: a finished row resolves with
    its result, a row mid-decode fails with tokens_emitted, a row
    mid-chunked-prefill and a pending admit-group item resurrect, the
    prefilling slot (older) ahead of the group item, both ahead of what
    was held; all after the rebuild (the allocator is new)."""
    eng = _engine(bridge)
    eng._ensure_state()

    def req(tokens):
        fut = concurrent.futures.Future()
        fut.set_running_or_notify_cancel()
        return engine_lib.Request(tokens, 4, future=fut)

    def entry(r, out, finish, prefill=False):
        e = {'req': r, 'out': list(out), 'lps': [0.0] * len(out),
             'tops': [[] for _ in out], 'finish': finish, 'sent': 0,
             'stop': frozenset(), 'ctx': [1] + list(out)}
        if prefill:
            e['prefill'] = {'pos': 0, 't_admit': 0.0}
        else:
            e['t_first'] = time.perf_counter()
        return e

    done, mid, pre, queued, held = (req([k] * 8) for k in (1, 2, 3, 4, 5))
    eng.slots[0] = entry(done, [7, 8], 'length')
    eng.slots[1] = entry(mid, [9, 10], None)
    eng.slots[2] = entry(pre, [], None, prefill=True)
    eng._hold.append(held)
    alloc0 = eng.alloc
    eng._fail_all(RuntimeError('boom'), [queued])
    assert eng.alloc is not alloc0 and eng._resets == 1
    out, finish, _, _ = done.future.result(timeout=0)
    assert (out, finish) == ([7, 8], 'length')
    with pytest.raises(engine_lib.EngineResetError) as ei:
        mid.future.result(timeout=0)
    assert ei.value.tokens_emitted == 2 and ei.value.retriable is True
    assert 'RuntimeError: boom' in str(ei.value)
    assert not pre.future.done() and not queued.future.done()
    assert eng._hold == [pre, queued, held]
    assert (pre.resurrects, queued.resurrects, held.resurrects) == (1, 1, 0)
    assert all(s is None for s in eng.slots)
    assert eng.resurrected_total == 2
    assert eng.metrics.resurrected.value() == 2
    assert [e['event'] for e in eng.flight.dump()] == ['finish', 'reset']


def test_cancel_drops_a_resurrected_request_from_the_hold_queue(bridge):
    """A resurrected request's future is running (admitted once), so a
    handler's fut.cancel() cannot reach it: engine.cancel takes it out
    of the hold queue at the next drained point."""
    eng = _engine(bridge)
    eng._ensure_state()
    fut = concurrent.futures.Future()
    fut.set_running_or_notify_cancel()
    keep = engine_lib.Request([2] * 8, 4, future=concurrent.futures.Future())
    eng._hold[:] = [engine_lib.Request([1] * 8, 4, future=fut), keep]
    assert not fut.cancel()
    eng.cancel(fut)
    eng._process_cancels()
    assert eng._hold == [keep]


def test_streaming_reset_is_structured_and_never_hangs(stack):
    """A stream cut by a device failure ends with the structured
    retriable error event carrying tokens_emitted, never a stall; the
    engine serves the next request."""
    eng, base = stack
    failpoints.arm('engine.step', every=2, max_fires=1)
    body = _stream(base + '/v1/completions', {
        'prompt': [4] * 8, 'max_tokens': 48, 'stream': True,
        'temperature': 0})
    failpoints.reset()
    events = [e[len('data: '):] for e in body.split('\n\n') if e]
    assert events[-1] != '[DONE]'
    err = json.loads(events[-1])['error']
    assert err['type'] == 'engine_reset_error' and err['retriable'] is True
    streamed = sum(1 for e in events[:-1]
                   if json.loads(e)['choices'][0]['text'])
    assert err['tokens_emitted'] >= 1 and streamed <= err['tokens_emitted']
    code, _ = _http(base + '/generate', {'tokens': [2] * 8,
                                         'max_new_tokens': 4})
    assert code == 200
    _idle(eng)


def test_collect_fault_drops_both_calls_in_flight(bridge, stack):
    """A failure at collect with the pipeline full (two calls
    dispatched) drops both handles; the next request is JAX's."""
    eng, base = stack
    depth = []
    orig = engine_lib.InferenceEngine._collect_step

    def spy(self):
        depth.append(len(self._inflight))
        return orig(self)

    eng._collect_step = spy.__get__(eng)
    try:
        failpoints.arm('engine.collect', every=3, max_fires=1)
        code, doc = _http(base + '/generate', {'tokens': [7] * 8,
                                               'max_new_tokens': 40})
    finally:
        del eng._collect_step
    assert max(depth) == engine_lib.MAX_INFLIGHT
    assert code == 503 and doc['error']['type'] == 'engine_reset_error'
    code, doc = _http(base + '/generate', {'tokens': [7] * 8,
                                           'max_new_tokens': 6})
    assert code == 200 and doc['tokens'] == _ref(bridge, [7] * 8, 6)
    _idle(eng)


def test_failpoint_sites_sit_at_the_jax_points():
    sites = failpoints.scan_sites()
    where = sorted((s['name'], s['path']) for s in sites)
    assert where == [('engine.admit', 'serve/engine.py')] * 3 + [
        ('engine.collect', 'serve/engine.py'),
        ('engine.step', 'serve/engine.py'),
        ('handoff.recv', 'serve/disagg/handoff.py'),
        ('handoff.send', 'serve/disagg/handoff.py'),
        ('kv.spill', 'serve/engine.py'),
        ('kv.wake', 'serve/engine.py'),
        ('multihost.recv', 'serve/multihost.py'),
        ('multihost.send', 'serve/multihost.py'),
        ('prefill.flush', 'serve/engine.py'),
        ('rollout.generate', 'train/rollout/worker.py'),
        ('rollout.lease', 'train/rollout/dispatcher.py'),
        ('rollout.publish', 'train/rollout/learner.py'),
        ('rollout.snapshot_fetch', 'train/rollout/worker.py'),
        ('sqlite.commit', 'utils/sqlite_utils.py'),
        ('trainer.preempt', 'train/trainer.py')]


def test_concurrent_submits_lose_no_count(stack):
    """24 clients at once under a short switch interval: every request
    and every token is counted exactly once (the metric families take a
    lock; the engine's own counters are written by the batch loop
    alone)."""
    eng, base = stack
    _idle(eng)
    req0, tok0 = eng.metrics.requests.value(), eng.metrics.tokens.value()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with concurrent.futures.ThreadPoolExecutor(24) as ex:
            answers = list(ex.map(lambda i: _http(base + '/generate', {
                'tokens': [i % 7 + 1] * 4, 'max_new_tokens': 3}),
                range(24)))
    finally:
        sys.setswitchinterval(old)
    assert [c for c, _ in answers] == [200] * 24
    assert eng.metrics.requests.value() == req0 + 24
    assert eng.metrics.tokens.value() == tok0 + 72
    _idle(eng)


# ---------------------------------------------------------------------------
# /metrics and /debug/flight
# ---------------------------------------------------------------------------

def test_registry_metrics_exposed_after_traffic(stack):
    eng, base = stack
    _http(base + '/generate', {'tokens': [2, 4, 6, 8], 'max_new_tokens': 10})
    _idle(eng)
    code, ctype, text = _text(base + '/metrics')
    assert code == 200 and ctype.startswith('text/plain')
    for needle in (
            'skytpu_engine_step_seconds_bucket',
            'skytpu_engine_step_seconds_count{phase="dispatch"}',
            'skytpu_engine_step_seconds_count{phase="collect"}',
            'skytpu_engine_host_sync_seconds_sum',
            'skytpu_engine_admit_seconds_count',
            'skytpu_engine_tokens_total',
            'skytpu_engine_steps_total',
            'skytpu_engine_requests_total',
            'skytpu_engine_queue_depth 0',
            '# TYPE skytpu_engine_step_seconds histogram',
            'skytpu_engine_attn_backend{backend="fused"} 1',
            'skytpu_engine_attn_backend{backend="pallas"} 0',
            'skytpu_engine_kv_pages_quantized 0',
    ):
        assert needle in text, needle


def test_flight_dump_and_latency_histograms(stack):
    """The ring sees a request's whole hot-loop life; TTFT and TPOT are
    observed once per request, tokens counted once each; goodput per
    class from the header (clamped)."""
    eng, base = stack
    _idle(eng)
    eng.flight.clear()
    m = eng.metrics
    ttft0, tok0 = m.ttft._data.get((), [0, 0, 0])[2], m.tokens.value()
    good0 = m.goodput.value(cls='batch', outcome='good')
    other0 = m.goodput.value(cls='other', outcome='good')
    code, doc = _http(base + '/generate', {'tokens': [5] * 8,
                                           'max_new_tokens': 6},
                      headers={'X-Skytpu-Class': ' Batch '})
    assert code == 200 and len(doc['tokens']) == 6
    code, doc = _http(base + '/generate', {'tokens': [5] * 8,
                                           'max_new_tokens': 6},
                      headers={'X-Skytpu-Class': 'vip'})
    assert code == 200
    _idle(eng)
    code, flight = _http(base + '/debug/flight')
    assert code == 200 and flight['capacity'] == 65536
    kinds = {e['event'] for e in flight['events']}
    assert {'admit', 'dispatch', 'collect', 'finish'} <= kinds
    fins = [e for e in flight['events'] if e['event'] == 'finish']
    assert [e['seq'] for e in fins] == [6, 6]
    assert flight['count'] == len(flight['events'])
    assert _http(base + '/debug/flight?limit=2')[1]['count'] == 2
    assert _http(base + '/debug/flight?limit=0')[1]['count'] == \
        flight['count']
    assert _http(base + '/debug/flight?limit=x')[0] == 400
    _, _, text = _text(base + '/metrics')
    assert _samples(text, 'skytpu_engine_ttft_seconds_count')[''] == ttft0 + 2
    assert _samples(text, 'skytpu_engine_tpot_seconds_count')[''] >= 2
    assert m.tokens.value() == tok0 + 12
    assert m.goodput.value(cls='batch', outcome='good') == good0 + 1
    assert m.goodput.value(cls='other', outcome='good') == other0 + 1
    cls_ttft = _samples(text, 'skytpu_engine_class_ttft_seconds_count')
    assert cls_ttft['{cls="batch"}'] >= 1 and cls_ttft['{cls="other"}'] >= 1


def test_gauges_counters_and_wait_histogram_at_metrics(stack):
    """The paged gauges are sampled at scrape and agree with the
    allocator; the page-alloc counter and the admission-wait histogram
    are there."""
    eng, base = stack
    code, _ = _http(base + '/generate', {'tokens': [2, 4, 6, 8],
                                         'max_new_tokens': 4})
    assert code == 200
    _idle(eng)
    _, _, text = _text(base + '/metrics')
    for needle in (
            'skytpu_engine_kv_pages_free',
            'skytpu_engine_kv_pages_used',
            'skytpu_engine_kv_page_alloc_total{outcome="ok"}',
            'skytpu_engine_kv_page_alloc_total{outcome="wait"}',
            'skytpu_engine_admission_wait_seconds_bucket',
            'skytpu_engine_admission_wait_seconds_count',
    ):
        assert needle in text, needle
    assert _samples(text, 'skytpu_engine_kv_pages_free')[''] == \
        eng.alloc.free_count
    assert _samples(text, 'skytpu_engine_kv_pages_used')[''] == \
        eng.alloc.used_count


def test_spec_metrics_exposed(bridge):
    """A speculating engine counts its rounds, proposals and accepted
    drafts at /metrics, as its attributes count them."""
    eng = _engine(bridge, spec_cooldown=0)
    server, th, base = _serve(eng)
    try:
        # A prompt that repeats itself: the model's own greedy
        # continuation after a seed (random weights loop on it).
        prompt = [3, 1, 4] + _ref(bridge, [3, 1, 4], REF_NEW)
        code, doc = _http(base + '/generate', {'tokens': prompt,
                                               'max_new_tokens': 16})
        assert code == 200
        _, _, text = _text(base + '/metrics')
    finally:
        _close(eng, server, th)
    assert eng.spec_rounds > 0 and eng.spec_accepted > 0
    for name, want in (('rounds', eng.spec_rounds),
                       ('proposed', eng.spec_proposed),
                       ('accepted', eng.spec_accepted)):
        assert _samples(text, f'skytpu_engine_spec_{name}_total')[''] == want
    assert 'spec' in {e['event'] for e in eng.flight.dump()}


# The JAX families whose feature waits: none since the disagg and the
# host spill tier families came with their features.
WAITING_FAMILIES = set()


def _family_spec(m):
    return (type(m).__name__, m._labelspec(),
            getattr(m, 'buckets', None))


def test_families_are_the_jax_engines_less_the_waiting_ones():
    from skypilot_tpu.serve import engine as jengine
    jax_fams = {m.name: _family_spec(m) for m in
                (*jengine._ENGINE_METRICS, jengine._M_RESURRECTED)}
    port = {m.name: _family_spec(m)
            for m in engine_lib.EngineMetrics().registry.metrics()}
    assert WAITING_FAMILIES <= set(jax_fams)
    assert port == {n: f for n, f in jax_fams.items()
                    if n not in WAITING_FAMILIES}


def test_copies_agree_with_their_originals():
    """observe/metrics (render byte-equal), observe/request_class,
    observe/flight and utils/failpoints' grammar, on the same
    operations."""
    from skypilot_tpu.observe import flight as jflight
    from skypilot_tpu.observe import metrics as jmetrics
    from skypilot_tpu.observe import request_class as jrc
    from skypilot_tpu.utils import failpoints as jfp

    def exercise(lib):
        reg = lib.Registry()
        c = reg.counter('skytpu_test_ops_total', 'ops "quoted"\nhelp',
                        labels={'kind': ('a', 'b')})
        g = reg.gauge('skytpu_test_depth', 'depth')
        h = reg.histogram('skytpu_test_seconds', 'latency',
                          labels={'phase': ('x',)}, buckets=(0.1, 1.0))
        d = reg.histogram('skytpu_test_default_seconds', 'default buckets')
        c.inc(kind='a')
        c.inc(2.5, kind='b')
        g.set(3)
        g.dec(0.5)
        for v in (0.05, 0.5, 5.0, 1.0):
            h.observe(v, phase='x')
        d.observe(42.0)
        with pytest.raises(ValueError):
            c.inc(kind='c')
        return reg.render()

    assert exercise(metrics_lib) == exercise(jmetrics)
    assert metrics_lib.DEFAULT_BUCKETS == jmetrics.DEFAULT_BUCKETS
    assert request_class.CLASSES == jrc.CLASSES
    assert request_class.OBJECTIVES == {
        k: request_class.ClassObjective(v.ttft_seconds, v.tpot_seconds)
        for k, v in jrc.OBJECTIVES.items()}
    for raw in (None, '', 'batch', ' Interactive ', 'LONG_CONTEXT', 'vip'):
        assert request_class.normalize(raw) == jrc.normalize(raw)
        assert request_class.from_headers({request_class.HEADER: raw}) == \
            jrc.from_headers({jrc.HEADER: raw})
    for cls in (*jrc.CLASSES, 'vip'):
        for ttft, tpot in ((0.1, None), (2.5, 0.25), (2.6, 0.1),
                           (9.0, 0.6), (29.0, 1.0), (31.0, None)):
            assert request_class.is_good(cls, ttft, tpot) == \
                jrc.is_good(cls, ttft, tpot)
    for spec in ('engine.step=once', 'engine.step=every:3,max:2;'
                 'engine.admit=prob:0.5,seed:7', 'engine.collect=delay:0.2',
                 ' a.b = once ; c.d=every:1 '):
        assert failpoints.parse_spec(spec) == jfp.parse_spec(spec)
    for bad in ('engine.step', 'engine.step=', 'engine.step=sometimes',
                'engine.step=every:x'):
        with pytest.raises(ValueError):
            failpoints.parse_spec(bad)
        with pytest.raises(ValueError):
            jfp.parse_spec(bad)
    assert flight_lib.CODE_NAMES == jflight.CODE_NAMES
    rings = []
    for lib in (flight_lib, jflight):
        ring = lib.FlightRecorder(capacity=3)
        for code in (lib.DISPATCH, lib.COLLECT, lib.ADMIT, lib.FINISH):
            ring.record(code, 1, 2)
        rings.append(sorted((e['event'], e['slot'], e['seq'])
                            for e in ring.dump()))
    assert rings[0] == rings[1] == [('admit', 1, 2), ('collect', 1, 2),
                                    ('finish', 1, 2)]


def test_failpoints_arm_fire_and_count():
    failpoints.arm('engine.step', every=2, max_fires=2)
    fired = []
    for _ in range(6):
        try:
            failpoints.fire('engine.step')
            fired.append(0)
        except failpoints.FailpointError as e:
            assert e.failpoint == 'engine.step'
            fired.append(1)
    assert fired == [0, 1, 0, 1, 0, 0] and not failpoints.ACTIVE
    with failpoints.armed('engine.admit', once=True):
        assert failpoints.ACTIVE and failpoints.hits('engine.admit') == 0
        with pytest.raises(failpoints.FailpointError):
            failpoints.fire('engine.admit')
    assert not failpoints.ACTIVE


# ---------------------------------------------------------------------------
# n / best_of / batched prompts (JAX test_engine.py)
# ---------------------------------------------------------------------------

def _choices_by_index(body):
    """(texts, finish reasons) by choice index of a streamed answer."""
    events = [e[len('data: '):] for e in body.split('\n\n') if e]
    assert events[-1] == '[DONE]'
    texts, finishes = {}, {}
    for e in events[:-1]:
        ch = json.loads(e)['choices'][0]
        texts[ch['index']] = texts.get(ch['index'], '') + ch['text']
        if ch['finish_reason'] is not None:
            finishes[ch['index']] = ch['finish_reason']
    return texts, finishes


def test_n_best_of_and_batched_prompts(bridge, stack):
    eng, base = stack
    p1, p2 = [11] * 5, [12] * 9
    # Batched token-id prompts, n = 2: one choice per prompt x n, in
    # order, greedy choices equal to JAX decode.generate.
    code, doc = _http(base + '/v1/completions', {
        'prompt': [p1, p2], 'max_tokens': 4, 'temperature': 0,
        'ignore_eos': True, 'n': 2, 'logprobs': 0})
    assert code == 200, doc
    assert [c['index'] for c in doc['choices']] == [0, 1, 2, 3]
    want = [eng.tokenizer.decode(_ref(bridge, p, 4))
            for p in (p1, p1, p2, p2)]
    assert [c['text'] for c in doc['choices']] == want
    assert doc['usage'] == {'prompt_tokens': 14, 'completion_tokens': 16,
                            'total_tokens': 30}
    # Batched text prompts.
    code, doc = _http(base + '/v1/completions', {
        'prompt': ['aa', 'bb'], 'max_tokens': 2, 'temperature': 0,
        'ignore_eos': True})
    assert code == 200
    assert [c['index'] for c in doc['choices']] == [0, 1]
    assert doc['usage']['completion_tokens'] == 4
    # best_of > n: candidates ranked by mean logprob, n kept; usage
    # counts the discarded candidates too.
    code, doc = _http(base + '/v1/completions', {
        'prompt': 'dd', 'max_tokens': 2, 'temperature': 0.8, 'n': 1,
        'best_of': 3, 'ignore_eos': True, 'logprobs': 0})
    assert code == 200 and len(doc['choices']) == 1
    assert doc['usage']['completion_tokens'] == 6
    # Chat takes n, not best_of.
    msgs = [{'role': 'user', 'content': 'hi'}]
    code, doc = _http(base + '/v1/chat/completions', {
        'messages': msgs, 'max_tokens': 3, 'temperature': 0, 'n': 2,
        'ignore_eos': True})
    assert code == 200
    assert [c['index'] for c in doc['choices']] == [0, 1]
    assert doc['choices'][0]['message'] == doc['choices'][1]['message']
    assert doc['usage']['completion_tokens'] == 6
    code, doc = _http(base + '/v1/chat/completions', {
        'messages': msgs, 'max_tokens': 2, 'best_of': 3})
    assert code == 400 and 'best_of' in doc['error']['message']
    _idle(eng)


def test_streaming_n_and_batched_prompts(stack):
    """n > 1 and batched prompts stream: chunks carry each choice's
    index, every choice finishes, and each index's deltas put together
    are the non-streamed choice's text (greedy); chat streams n roles."""
    eng, base = stack
    body = {'prompt': ['ab', 'cd'], 'max_tokens': 3, 'temperature': 0,
            'ignore_eos': True, 'n': 2}
    code, doc = _http(base + '/v1/completions', body)
    assert code == 200
    want = {c['index']: c['text'] for c in doc['choices']}
    texts, finishes = _choices_by_index(
        _stream(base + '/v1/completions', dict(body, stream=True)))
    assert texts == want and finishes == {i: 'length' for i in range(4)}
    raw = _stream(base + '/v1/chat/completions', {
        'messages': [{'role': 'user', 'content': 'hi'}], 'max_tokens': 2,
        'temperature': 0, 'n': 2, 'stream': True, 'ignore_eos': True})
    events = [json.loads(e[len('data: '):]) for e in raw.split('\n\n')
              if e and e != 'data: [DONE]']
    roles = [e['choices'][0]['index'] for e in events
             if e['choices'][0]['delta'].get('role') == 'assistant']
    ends = [e['choices'][0]['index'] for e in events
            if e['choices'][0]['finish_reason'] == 'length']
    assert sorted(roles) == sorted(ends) == [0, 1]
    _idle(eng)


def test_a_429_in_mid_fan_out_leaves_no_orphan(bridge, monkeypatch):
    """Enqueue is all or nothing: with room for 2, a fan-out of 3 is
    refused with 429 and the 2 enqueued siblings are cancelled, so
    admission drops them (nothing decodes with no consumer); a
    streamed fan-out likewise."""
    monkeypatch.setattr(engine_lib, 'MAX_QUEUE', 2)
    eng = _engine(bridge)
    server, th, base = _serve(eng, start=False)
    try:
        for body in ({'prompt': 'x', 'max_tokens': 2, 'n': 3},
                     {'prompt': ['x', 'y', 'z'], 'max_tokens': 2,
                      'stream': True}):
            code, doc = _http(base + '/v1/completions', body)
            assert code == 429
            assert doc['error']['type'] == 'overloaded_error'
            queued = list(eng._queue.queue)
            assert len(queued) == 2
            assert all(r.future.cancelled() for r in queued)
            eng._ensure_state()
            assert eng._drain_admissible() == []
            assert eng.queue_depth() == 0
        assert eng.metrics.rejected.value() == 2
        assert eng.metrics.requests.value() == 4
    finally:
        _close(eng, server, th)


# ---------------------------------------------------------------------------
# The serve plane reads a port replica
# ---------------------------------------------------------------------------

def test_jax_fleet_scraper_reads_the_port_replica(stack, tmp_path,
                                                  monkeypatch):
    """JAX's own Scraper, pointed at the port engine's HTTP server: one
    round succeeds, its saturation snapshot holds the replica's queue
    depth, in-flight rows and free pages, and its fleet families hold
    every family the serve plane stores."""
    from skypilot_tpu.observe import scrape
    monkeypatch.setenv('SKYTPU_OBSERVE_DB', str(tmp_path / 'observe.db'))
    eng, base = stack
    code, _ = _http(base + '/generate', {'tokens': [9] * 8,
                                         'max_new_tokens': 4})
    assert code == 200
    _idle(eng)
    s = scrape.Scraper(timeout=10.0)
    s.set_targets([scrape.Target('svc/0', base)])
    assert s.scrape_round() == {'svc/0': True}
    sat = s.saturation_snapshot()[base]
    assert (sat.queue_depth, sat.in_flight, sat.kv_pages_free) == \
        (0, 0, eng.n_pages - 1)
    fams = s.fleet_families()
    missing = [f for f in scrape.STORED_FAMILIES if f not in fams]
    assert missing == []
    assert fams['skytpu_engine_tokens_total'].samples[0].value == \
        eng.metrics.tokens.value()
