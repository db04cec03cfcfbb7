"""The PyTorch port's fused k-step decode, pipelined dispatch/collect,
penalties, top logprobs and streaming /v1/completions, on the CPU, vs
the JAX package.

llama-debug in fp32 on weights bridged from JAX ``init_params``. On the
CPU the engine runs its step variants eagerly (the card replays them as
CUDA graphs), through the same dispatch/collect code. Greedy tokens must
equal JAX's exactly: at MAX_STEP_CHUNK 8 and 1, against
``decode.generate``, and with penalties against a loop of JAX
``select_token_per_row(counts=...)`` over its decode step. Sampled rows
compare filtered distributions (JAX threefry and torch Philox draw
different numbers). The pipeline assertions are those of
tests/unit_tests/test_engine_pipeline.py, on the port's engine.
"""
import concurrent.futures
import dataclasses
import http.client
import json
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
from skypilot_tpu_torch.kernels import build
from skypilot_tpu_torch.models import decode, weights
from skypilot_tpu_torch.serve import engine as engine_lib

MAX_LEN = 128


def _engine(tree, tcfg, monkeypatch=None, chunk=None):
    if chunk is not None:
        monkeypatch.setattr(engine_lib, 'MAX_STEP_CHUNK', chunk)
    return engine_lib.InferenceEngine(
        'llama-debug', cfg=tcfg, device='cpu', max_len=MAX_LEN,
        params=weights.params_from_jax(tree, tcfg, device='cpu'))


def _serve(eng):
    server = engine_lib.build_app(eng)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    eng.start()
    base = f'http://127.0.0.1:{server.server_address[1]}'
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
def bridge():
    """(JAX params, JAX cfg, host tree, torch cfg): llama-debug fp32."""
    jcfg = dataclasses.replace(jllama.PRESETS['llama-debug'],
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(config.PRESETS['llama-debug'],
                               dtype=torch.float32)
    tree = jax.device_get(jllama.init_params(jax.random.PRNGKey(7), jcfg))
    return jax.tree.map(jnp.asarray, tree), jcfg, tree, tcfg


@pytest.fixture(scope='module')
def stack(bridge):
    """(engine, base url): a warm engine at MAX_STEP_CHUNK 8 behind its
    HTTP server."""
    _, _, tree, tcfg = bridge
    mp = pytest.MonkeyPatch()
    eng = _engine(tree, tcfg, mp, chunk=8)
    mp.undo()
    assert eng.step_chunk == 8
    server, th, base = _serve(eng)
    yield eng, base
    _close(eng, server, th)


def _http(url, doc=None):
    data = json.dumps(doc).encode() if doc is not None else None
    req = urllib.request.Request(url, data=data,
                                 headers={'Content-Type': 'application/json'})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _sse(url, doc):
    """POST a streaming request; (status, content type, the data fields
    of every event in order)."""
    req = urllib.request.Request(url, data=json.dumps(doc).encode(),
                                 headers={'Content-Type': 'application/json'})
    with urllib.request.urlopen(req, timeout=120) as r:
        raw = r.read().decode()
        ctype = r.headers['Content-Type']
        status = r.status
    events = [e for e in raw.split('\n\n') if e]
    assert all(e.startswith('data: ') for e in events), raw
    return status, ctype, [e[len('data: '):] for e in events]


def _stream_text(events):
    """(text, per-token logprob objects, finish_reason) of a streamed
    completion; the stream must end with [DONE]."""
    assert events[-1] == '[DONE]'
    docs = [json.loads(e) for e in events[:-1]]
    choices = [d['choices'][0] for d in docs]
    assert all(c['finish_reason'] is None for c in choices[:-1])
    text = ''.join(c['text'] for c in choices)
    lps = [c['logprobs'] for c in choices if c['logprobs'] is not None]
    return text, lps, choices[-1]['finish_reason']


# ---------------------------------------------------------------------------
# JAX references
# ---------------------------------------------------------------------------

_JAX_FNS = {}


def _jax_fns(jcfg):
    if not _JAX_FNS:
        _JAX_FNS['prefill'] = jax.jit(
            lambda p, t, n: jdecode.prefill(p, t, jcfg, MAX_LEN, lengths=n))
        _JAX_FNS['step'] = jax.jit(
            lambda p, t, c: jdecode.decode_step(p, t, c, jcfg))
        _JAX_FNS['select'] = jax.jit(jdecode.select_token_per_row)
    return _JAX_FNS


def _jax_greedy(bridge, prompt, max_new, pres=0.0, freq=0.0):
    """Greedy decode on JAX's contiguous cache with the penalties over
    the generated tokens' counts, as the engine applies them (none on
    the first token, sampled at admission): (tokens, per-token fp32
    logits)."""
    jparams, jcfg, _, _ = bridge
    fns = _jax_fns(jcfg)
    b = decode.bucket_size(len(prompt))
    padded = jnp.asarray([prompt + [0] * (b - len(prompt))], jnp.int32)
    logits, cache = fns['prefill'](jparams, padded,
                                   jnp.asarray([len(prompt)], jnp.int32))
    counts = np.zeros((1, jcfg.vocab_size), np.int32)
    zero_f, zero_i = jnp.zeros(1, jnp.float32), jnp.zeros(1, jnp.int32)
    out, all_logits = [], [np.asarray(logits[0])]
    tok = int(jnp.argmax(logits[0]))
    for _ in range(max_new - 1):
        out.append(tok)
        counts[0, tok] += 1
        logits, cache = fns['step'](jparams, jnp.asarray([tok], jnp.int32),
                                    cache)
        all_logits.append(np.asarray(logits[0]))
        tok = int(fns['select'](logits, zero_f, zero_i, zero_f,
                                jax.random.PRNGKey(0), jnp.asarray(counts),
                                jnp.full(1, pres, jnp.float32),
                                jnp.full(1, freq, jnp.float32))[0])
    out.append(tok)
    return out, all_logits


# ---------------------------------------------------------------------------
# The sampler
# ---------------------------------------------------------------------------

def _sampler_inputs(seed, rows=6, v=64):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((rows, v)) * 2.0).astype(np.float32)
    counts = rng.integers(0, 4, (rows, v)).astype(np.int32)
    counts[rng.random((rows, v)) < 0.6] = 0
    pres = rng.uniform(-2, 2, rows).astype(np.float32)
    freq = rng.uniform(-2, 2, rows).astype(np.float32)
    return logits, counts, pres, freq


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_penalized_greedy_tokens_match_jax(seed):
    logits, counts, pres, freq = _sampler_inputs(seed)
    rows = logits.shape[0]
    zf, zi = np.zeros(rows, np.float32), np.zeros(rows, np.int32)
    want = jdecode.select_token_per_row(
        jnp.asarray(logits), jnp.asarray(zf), jnp.asarray(zi),
        jnp.asarray(zf), jax.random.PRNGKey(0), counts=jnp.asarray(counts),
        presence=jnp.asarray(pres), frequency=jnp.asarray(freq))
    got = decode.select_token_per_row(
        torch.from_numpy(logits), torch.from_numpy(zf), torch.from_numpy(zi),
        torch.from_numpy(zf), None, counts=torch.from_numpy(counts),
        presence=torch.from_numpy(pres), frequency=torch.from_numpy(freq))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # The penalty moved the choice somewhere, or this seed tests nothing.
    assert (np.asarray(want) != logits.argmax(-1)).any()


def test_penalized_filtered_distributions_match_jax(monkeypatch):
    """Sampled rows: JAX's filtered logits (what select_token_per_row
    hands jax.random.categorical) and the port's filter_logits give the
    same per-row distributions to 1e-6, penalties, temperature, top-k
    and top-p all on."""
    logits, counts, pres, freq = _sampler_inputs(5)
    temp = np.array([0.7, 1.0, 1.3, 0.5, 1.0, 2.0], np.float32)
    top_k = np.array([5, 0, 20, 0, 64, 3], np.int32)
    top_p = np.array([1.0, 0.9, 0.5, 0.0, 0.3, 0.95], np.float32)
    seen = []

    def categorical(key, lg, axis=-1):
        del key
        seen.append(np.asarray(lg))
        return jnp.argmax(lg, axis=axis)

    monkeypatch.setattr(jax.random, 'categorical', categorical)
    jdecode.select_token_per_row(
        jnp.asarray(logits), jnp.asarray(temp), jnp.asarray(top_k),
        jnp.asarray(top_p), jax.random.PRNGKey(0),
        counts=jnp.asarray(counts), presence=jnp.asarray(pres),
        frequency=jnp.asarray(freq))
    assert len(seen) == 1
    want = torch.softmax(torch.from_numpy(seen[0].copy()), dim=-1).numpy()
    got = torch.softmax(decode.filter_logits(
        torch.from_numpy(logits), torch.from_numpy(temp),
        torch.from_numpy(top_k), torch.from_numpy(top_p),
        counts=torch.from_numpy(counts), presence=torch.from_numpy(pres),
        frequency=torch.from_numpy(freq)), dim=-1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert ((want > 0).sum(-1) < logits.shape[1]).any()   # filters bit


def test_top_k_logprobs_match_jax():
    rng = np.random.default_rng(4)
    logits = (rng.standard_normal((4, 300)) * 3.0).astype(np.float32)
    jv, ji = jdecode.top_k_logprobs(jnp.asarray(logits), 5)
    tv, ti = decode.top_k_logprobs(torch.from_numpy(logits), 5)
    assert tv.dtype == torch.float32 and ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# The fused k-step decode
# ---------------------------------------------------------------------------

PROMPT_LENS = (5, 20, 40)
MAX_NEWS = (13, 21, 30)


def test_fused_steps_match_single_steps_and_jax_generate(bridge, stack,
                                                         monkeypatch):
    """Greedy tokens of concurrent rows whose max_new ends off the chunk
    grid: the engine at MAX_STEP_CHUNK 8 (calls of 8 steps ran) equals
    the engine at MAX_STEP_CHUNK 1 and JAX decode.generate."""
    jparams, jcfg, tree, tcfg = bridge
    eng8, _ = stack
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, 256, n).tolist() for n in PROMPT_LENS]
    eng1 = _engine(tree, tcfg, monkeypatch, chunk=1)
    eng1.start()
    try:
        before = eng8.calls_by_width().get(8, 0)
        outs = {}
        for name, eng in (('k8', eng8), ('k1', eng1)):
            futs = [eng.submit(p, n) for p, n in zip(prompts, MAX_NEWS)]
            outs[name] = [f.result(timeout=120) for f in futs]
        assert eng8.calls_by_width().get(8, 0) > before
        assert set(eng1.calls_by_width()) == {1}
    finally:
        eng1.stop()
    for i, (prompt, n) in enumerate(zip(prompts, MAX_NEWS)):
        want = np.asarray(jdecode.generate(
            jparams, jnp.asarray([prompt], jnp.int32), jcfg, n))[0].tolist()
        for name in ('k8', 'k1'):
            toks, finish, lps, _ = outs[name][i]
            assert toks == want, (name, n)
            assert finish == 'length' and len(lps) == n
        np.testing.assert_allclose(outs['k8'][i][2], outs['k1'][i][2],
                                   atol=1e-5, rtol=0)


def test_stop_id_mid_chunk_and_device_last_matches_mirror(bridge, stack,
                                                          monkeypatch):
    """One 8-step call on two admitted rows: the row that hits its stop
    id inside the call stops there (the call's later tokens for it are
    dropped) while its neighbour takes all 8; ``_fix_last`` re-pins the
    stopped row's device ``last`` to the host mirror."""
    _, _, tree, tcfg = bridge
    prompt = [3, 1, 4, 1, 5, 9, 2, 6]
    full = stack[0].submit(prompt, 24).result(timeout=120)[0]
    idx = next(i for i in range(2, 9) if full[i] not in full[:i])
    eng = _engine(tree, tcfg, monkeypatch, chunk=8)
    reqs = [engine_lib.Request(prompt, 24, stop_ids=(full[idx],)),
            engine_lib.Request([7] * 8, 30)]
    eng._admit_group(reqs)
    eng._step_once(k_force=8)
    stopped, running = eng.slots[0], eng.slots[1]
    assert stopped['finish'] == 'stop' and stopped['out'] == full[:idx]
    assert running['finish'] is None and len(running['out']) == 9
    assert eng.last[0] == full[idx]
    np.testing.assert_array_equal(eng.last_dev.numpy(), eng.last)


@pytest.mark.parametrize('pres,freq', [(0.8, 0.3), (-0.5, 1.2)])
def test_penalized_greedy_tokens_match_jax_reference(bridge, stack, pres,
                                                     freq):
    """Presence and frequency penalties on /generate: greedy tokens
    through the fused (penalized) variants equal JAX's decode loop with
    select_token_per_row(counts=...)."""
    eng, base = stack
    prompt = [10, 20, 30, 10, 20, 30, 10, 20]
    want, _ = _jax_greedy(bridge, prompt, 20, pres, freq)
    plain, _ = _jax_greedy(bridge, prompt, 20)
    assert want != plain                       # the penalties bit
    before = sum(n for (_, pen, _), n in eng.calls.items() if pen)
    code, doc = _http(base + '/generate', {
        'tokens': prompt, 'max_new_tokens': 20, 'presence_penalty': pres,
        'frequency_penalty': freq})
    assert code == 200, doc
    assert doc['tokens'] == want
    assert sum(n for (_, pen, _), n in eng.calls.items() if pen) > before


# ---------------------------------------------------------------------------
# The pipeline (ported from tests/unit_tests/test_engine_pipeline.py)
# ---------------------------------------------------------------------------

def _spy_steps(monkeypatch, events):
    orig_d = engine_lib.InferenceEngine._dispatch_step
    orig_c = engine_lib.InferenceEngine._collect_step

    def spy_d(self, k, want_tops_force=None):
        h = orig_d(self, k, want_tops_force=want_tops_force)
        events.append(('dispatch', k, h))
        return h

    def spy_c(self):
        events.append(('collect', self._inflight[0].k, None))
        return orig_c(self)

    monkeypatch.setattr(engine_lib.InferenceEngine, '_dispatch_step', spy_d)
    monkeypatch.setattr(engine_lib.InferenceEngine, '_collect_step', spy_c)


def test_step_n_plus_1_dispatched_before_step_n_collected(stack,
                                                          monkeypatch):
    """Two consecutive dispatches with no collect between them: the
    lookahead call went out while the previous call's results were
    still uncollected. Every dispatch is collected; 8-wide calls ran."""
    eng, base = stack
    events = []
    _spy_steps(monkeypatch, events)
    code, doc = _http(base + '/generate', {'tokens': [1] * 8,
                                           'max_new_tokens': 40})
    assert code == 200 and len(doc['tokens']) == 40
    kinds = [e[0] for e in events]
    assert any(kinds[i] == kinds[i + 1] == 'dispatch'
               for i in range(len(kinds) - 1)), kinds
    assert kinds.count('dispatch') == kinds.count('collect')
    assert eng._inflight == []
    assert ('dispatch', 8) in [e[:2] for e in events]


def test_collect_always_precedes_buffer_reuse(bridge, stack, monkeypatch):
    """A request arriving mid-generation is admitted only at a drained
    point (no call in flight), and its output equals its solo greedy
    result."""
    jparams, jcfg, _, _ = bridge
    eng, _ = stack
    admits = []
    orig = engine_lib.InferenceEngine._admit_group

    def spy(self, items):
        admits.append(len(self._inflight))
        return orig(self, items)

    monkeypatch.setattr(engine_lib.InferenceEngine, '_admit_group', spy)
    solo = np.asarray(jdecode.generate(
        jparams, jnp.asarray([[5] * 8], jnp.int32), jcfg, 4))[0].tolist()
    f_long = eng.submit([4] * 8, 48)
    deadline = time.monotonic() + 30
    while not eng.in_flight():
        assert time.monotonic() < deadline
        time.sleep(0.001)
    short = eng.submit([5] * 8, 4).result(timeout=120)[0]
    assert short == solo
    assert len(f_long.result(timeout=120)[0]) == 48
    assert admits and all(n == 0 for n in admits)


def test_cancel_while_lookahead_in_flight_drains_cleanly(stack):
    """cancel() while calls are in flight is applied at the next drained
    point: the request resolves with finish 'stop' before its length,
    nothing leaks, and the engine keeps serving."""
    eng, base = stack
    fut = eng.submit([2] * 8, 100)
    deadline = time.monotonic() + 30
    while not eng.in_flight():
        assert time.monotonic() < deadline
        time.sleep(0.001)
    eng.cancel(fut)
    out, finish, _, _ = fut.result(timeout=120)
    assert finish == 'stop' and len(out) < 100
    code, doc = _http(base + '/generate', {'tokens': [3] * 8,
                                           'max_new_tokens': 3})
    assert code == 200 and len(doc['tokens']) == 3
    assert eng._inflight == [] and eng.alloc.free_count == eng.n_pages - 1


def test_failure_while_pipelined_resets_and_recovers(stack, monkeypatch):
    """A failure at collect time fails the request on the device with a
    503, drops the call in flight, resets the device state, and the next
    request is served."""
    eng, base = stack
    orig = engine_lib.InferenceEngine._collect_step
    state = {'arm': True}

    def failing(self):
        if state['arm']:
            state['arm'] = False
            raise RuntimeError('injected device failure')
        return orig(self)

    monkeypatch.setattr(engine_lib.InferenceEngine, '_collect_step', failing)
    code, doc = _http(base + '/generate', {'tokens': [6] * 8,
                                           'max_new_tokens': 24})
    assert code == 503 and 'injected device failure' in doc['error']
    code, doc = _http(base + '/generate', {'tokens': [6] * 8,
                                           'max_new_tokens': 3})
    assert code == 200 and len(doc['tokens']) == 3
    assert eng._inflight == [] and all(s is None for s in eng.slots)
    assert eng.alloc.free_count == eng.n_pages - 1


@pytest.mark.parametrize('logprobs', [None, 0, 2])
def test_topk_variant_selected_iff_some_slot_wants_top_logprobs(
        stack, monkeypatch, logprobs):
    """Without logprobs, or with chosen-token logprobs only, every call
    is a want_tops=False variant whose handle carries no top-k tensors;
    logprobs=N > 0 puts every call on the want_tops variants and the
    answer carries real top-N lists."""
    _, base = stack
    events = []
    _spy_steps(monkeypatch, events)
    body = {'prompt': [1, 2, 3, 4], 'max_tokens': 12, 'temperature': 0,
            'ignore_eos': True}
    if logprobs is not None:
        body['logprobs'] = logprobs
    code, doc = _http(base + '/v1/completions', body)
    assert code == 200, doc
    handles = [e[2] for e in events if e[0] == 'dispatch']
    assert handles
    wants = bool(logprobs)
    assert all(h.want_tops == wants for h in handles)
    assert all((h.tis is not None) == wants and (h.tvs is not None) == wants
               for h in handles)
    lp = doc['choices'][0]['logprobs']
    if logprobs is None:
        assert lp is None
        return
    assert len(lp['token_logprobs']) == 12
    assert all(v < 0 for v in lp['token_logprobs'])
    if wants:
        assert len(lp['top_logprobs']) == 12 and all(lp['top_logprobs'])
    else:
        assert lp['top_logprobs'] is None


def test_admission_seeds_device_last(stack):
    """Admission writes each slot's first token into the device
    ``last``: right after serving, device == mirror on every row."""
    eng, base = stack
    with concurrent.futures.ThreadPoolExecutor(4) as ex:
        answers = list(ex.map(
            lambda i: _http(base + '/generate', {'tokens': [i + 1] * 8,
                                                 'max_new_tokens': 2}),
            range(4)))
    assert all(code == 200 for code, _ in answers)
    np.testing.assert_array_equal(eng.last_dev.numpy(), eng.last)


def test_cpu_engine_captures_no_graph_and_launches_no_kernel(stack):
    eng, _ = stack
    assert eng.warm and eng.graphs == {}
    assert all(k.launches == 0 and k.captured == 0
               for k in build.kernels().values())


# ---------------------------------------------------------------------------
# The HTTP surface
# ---------------------------------------------------------------------------

def test_completions_stream_equals_non_stream_under_greedy(stack):
    eng, base = stack
    body = {'prompt': 'The quick brown f', 'max_tokens': 20,
            'temperature': 0, 'ignore_eos': True, 'logprobs': 0}
    code, doc = _http(base + '/v1/completions', body)
    assert code == 200, doc
    choice = doc['choices'][0]
    assert doc['object'] == 'text_completion' and doc['model'] == 'llama-debug'
    assert doc['usage'] == {'prompt_tokens': 17, 'completion_tokens': 20,
                            'total_tokens': 37}
    status, ctype, events = _sse(base + '/v1/completions',
                                 {**body, 'stream': True})
    assert status == 200 and ctype == 'text/event-stream'
    text, lps, finish = _stream_text(events)
    assert text == choice['text'] and finish == 'length'
    assert [lp['token_logprobs'][0] for lp in lps] == \
        choice['logprobs']['token_logprobs']
    # Pieces carry the text, but for a trailing incomplete UTF-8 tail
    # the decoder flushes at the end without a token of its own.
    assert text.startswith(''.join(lp['tokens'][0] for lp in lps))
    assert eng.alloc.free_count == eng.n_pages - 1


def test_completions_top_logprobs_match_jax(bridge, stack):
    """logprobs=5: the engine's per-token top-5 (ids and values) equal
    JAX top_k_logprobs of JAX's own decode logits to 1e-5; the
    non-stream and the streamed answers carry them keyed by text."""
    eng, base = stack
    prompt = [9, 8, 7, 6, 5, 4, 3, 2]
    out, logits = _jax_greedy(bridge, prompt, 10)
    toks, _, lps, tops = eng.submit(prompt, 10, want_tops=True).result(
        timeout=120)
    assert toks == out
    want = []
    for i, lg in enumerate(logits):
        jv, ji = jdecode.top_k_logprobs(jnp.asarray(lg), 5)
        jv, ji = np.asarray(jv), np.asarray(ji)
        assert [t[0] for t in tops[i]] == ji.tolist()
        np.testing.assert_allclose([t[1] for t in tops[i]], jv, atol=1e-5,
                                   rtol=0)
        np.testing.assert_allclose(lps[i], jv[0] if ji[0] == out[i] else
                                   np.asarray(jax.nn.log_softmax(lg))[out[i]],
                                   atol=1e-5, rtol=0)
        want.append({eng.tokenizer.decode([int(t)]): float(v)
                     for t, v in zip(ji, jv)})
    body = {'prompt': prompt, 'max_tokens': 10, 'temperature': 0,
            'logprobs': 5, 'ignore_eos': True}
    code, doc = _http(base + '/v1/completions', body)
    assert code == 200, doc
    got = doc['choices'][0]['logprobs']['top_logprobs']
    _, _, events = _sse(base + '/v1/completions', {**body, 'stream': True})
    _, stream_lps, _ = _stream_text(events)
    streamed = [lp['top_logprobs'][0] for lp in stream_lps]
    for tops_by_text in (got, streamed):
        assert len(tops_by_text) == len(want)
        for g, w in zip(tops_by_text, want):
            assert g.keys() == w.keys()
            np.testing.assert_allclose([g[k] for k in w],
                                       [w[k] for k in w], atol=1e-5, rtol=0)


def test_stop_strings_never_leak(stack):
    """A stop string cuts the text at its first match, streamed or not;
    the stream holds back enough that no part of it leaks."""
    _, base = stack
    body = {'prompt': [65, 66, 67, 68], 'max_tokens': 40, 'temperature': 0,
            'ignore_eos': True}
    code, doc = _http(base + '/v1/completions', body)
    full = doc['choices'][0]['text']
    stop = next(full[i:i + 3] for i in range(4, len(full) - 3)
                if '�' not in full[i:i + 3])
    cut = full[:full.find(stop)]
    code, doc = _http(base + '/v1/completions', {**body, 'stop': [stop]})
    assert code == 200
    assert doc['choices'][0]['text'] == cut
    assert doc['choices'][0]['finish_reason'] == 'stop'
    _, _, events = _sse(base + '/v1/completions',
                        {**body, 'stop': stop, 'stream': True})
    text, _, finish = _stream_text(events)
    assert text == cut and stop not in text and finish == 'stop'


def test_ignore_eos_disables_stop_token_ids(stack):
    """stop_token_ids end a completion at the first stop token;
    ignore_eos drops every stop id (fixed-length decode), streamed or
    not."""
    _, base = stack
    prompt = [5, 4, 3, 2, 1]
    _, gen = _http(base + '/generate', {'tokens': prompt,
                                        'max_new_tokens': 12})
    toks = gen['tokens']
    idx = next(i for i in range(1, 12) if toks[i] not in toks[:i])
    body = {'prompt': prompt, 'max_tokens': 12, 'temperature': 0,
            'stop_token_ids': [toks[idx]]}
    code, doc = _http(base + '/v1/completions', body)
    assert code == 200 and doc['choices'][0]['finish_reason'] == 'stop'
    assert doc['usage']['completion_tokens'] == idx
    code, doc = _http(base + '/v1/completions', {**body, 'ignore_eos': True})
    assert code == 200 and doc['choices'][0]['finish_reason'] == 'length'
    assert doc['usage']['completion_tokens'] == 12
    status, _, events = _sse(base + '/v1/completions', {
        **body, 'ignore_eos': True, 'stream': True, 'logprobs': 0})
    text, lps, finish = _stream_text(events)
    assert status == 200 and finish == 'length' and len(lps) == 12
    assert text == doc['choices'][0]['text']


def test_disconnected_stream_frees_its_slot(stack):
    """A streaming client that goes away: the failed write cancels its
    request, which ends long before max_tokens, and the slot and its
    pages are freed."""
    eng, base = stack
    host, port = base[len('http://'):].split(':')
    conn = http.client.HTTPConnection(host, int(port), timeout=60)
    conn.request('POST', '/v1/completions', json.dumps({
        'prompt': [1, 2, 3], 'max_tokens': 100, 'temperature': 0,
        'ignore_eos': True, 'logprobs': 0, 'stream': True}),
        {'Content-Type': 'application/json'})
    resp = conn.getresponse()
    assert resp.status == 200
    assert resp.fp.readline()                 # the first chunk's size
    n_before = len(eng.timings)
    conn.sock.shutdown(2)
    conn.close()
    deadline = time.monotonic() + 60
    while len(eng.timings) == n_before or eng.in_flight():
        assert time.monotonic() < deadline
        time.sleep(0.01)
    assert eng.timings[-1][2] < 100
    assert eng.alloc.free_count == eng.n_pages - 1


@pytest.mark.parametrize('path,body,needle', [
    ('/v1/completions', {'prompt': 'hi', 'n': 2}, 'n > 1'),
    ('/v1/completions', {'prompt': 'hi', 'best_of': 3}, 'best_of > 1'),
    ('/v1/completions', {'prompt': ['hi', 'yo']}, 'batched prompts'),
    ('/v1/completions', {'prompt': [[1, 2], [3]]}, 'batched prompts'),
    ('/v1/chat/completions',
     {'messages': [{'role': 'user', 'content': 'hi'}], 'max_tokens': 4,
      'n': 2}, 'n > 1'),
    ('/v1/chat/completions',
     {'messages': [{'role': 'user', 'content': 'hi'}], 'max_tokens': 4,
      'best_of': 1}, 'best_of is not supported'),
    ('/v1/chat/completions',
     {'messages': [{'role': 'hacker', 'content': 'hi'}]}, 'role'),
    ('/v1/chat/completions',
     {'messages': [{'role': 'user', 'content': 'hi'}], 'logprobs': 3},
     'chat logprobs must be a boolean'),
    ('/v1/completions', {'prompt': 'hi', 'logprobs': 6}, 'top logprobs'),
    ('/v1/completions', {'prompt': 'hi', 'presence_penalty': 2.5},
     'presence_penalty'),
    ('/v1/completions', {'prompt': ''}, 'empty prompt'),
])
def test_unsupported_or_bad_completions_answer_400(stack, path, body,
                                                   needle):
    _, base = stack
    code, doc = _http(base + path, body)
    assert code == 400
    assert doc['error']['type'] == 'invalid_request_error'
    assert needle in doc['error']['message']


@pytest.mark.parametrize('field', ['presence_penalty', 'frequency_penalty'])
def test_generate_takes_penalties_in_range(stack, field):
    _, base = stack
    code, doc = _http(base + '/generate', {'tokens': [1, 2, 3],
                                           'max_new_tokens': 4, field: -2.0})
    assert code == 200 and len(doc['tokens']) == 4
    code, doc = _http(base + '/generate', {'tokens': [1, 2, 3],
                                           'max_new_tokens': 4, field: 2.01})
    assert code == 400 and field in doc['error']


def test_models_route(stack):
    _, base = stack
    assert _http(base + '/v1/models') == (200, {'object': 'list', 'data': [
        {'id': 'llama-debug', 'object': 'model', 'owned_by': 'skytpu'}]})
