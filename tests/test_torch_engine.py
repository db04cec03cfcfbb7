"""The PyTorch port's engine on the CPU vs the JAX package.

The port's InferenceEngine serves /generate over its stdlib HTTP server
on llama-debug in fp32, on weights bridged from JAX init_params. Greedy
tokens for three concurrent prompts of different buckets must equal JAX
``decode.generate`` on the same weights. Sampled rows are compared by
distribution: JAX threefry and torch Philox draw different numbers, so
the filtered per-row distributions (temperature, top-k, top-p) are
compared instead of tokens.
"""
import concurrent.futures
import dataclasses
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

MAX_NEW = 8


def _serve(eng):
    server = engine_lib.build_app(eng)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    return server, th, f'http://127.0.0.1:{server.server_address[1]}'


def _close(eng, server, th):
    server.shutdown()
    server.server_close()
    eng.stop()
    th.join(10)
    assert not th.is_alive()


def _wait_healthy(base):
    deadline = time.monotonic() + 60
    while True:
        code, doc = _http(base + '/health')
        if code == 200:
            return doc
        assert code == 503 and time.monotonic() < deadline, (code, doc)
        time.sleep(0.05)


@pytest.fixture(scope='module')
def stack():
    """(engine, base url, JAX params, JAX cfg): a warm engine on
    llama-debug fp32 with weights bridged from JAX init_params."""
    jcfg = dataclasses.replace(jllama.PRESETS['llama-debug'],
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(config.PRESETS['llama-debug'],
                               dtype=torch.float32)
    tree = jax.device_get(jllama.init_params(jax.random.PRNGKey(7), jcfg))
    eng = engine_lib.InferenceEngine(
        'llama-debug', cfg=tcfg, device='cpu',
        params=weights.params_from_jax(tree, tcfg, device='cpu'))
    server, th, base = _serve(eng)
    build.reset_launches()
    eng.start()
    _wait_healthy(base)
    yield eng, base, jax.tree.map(jnp.asarray, tree), jcfg
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


def test_health_answers_503_until_warm_then_200():
    cfg = dataclasses.replace(config.PRESETS['llama-debug'],
                              dtype=torch.float32)
    eng = engine_lib.InferenceEngine('llama-debug', cfg=cfg, device='cpu')
    server, th, base = _serve(eng)
    try:
        assert _http(base + '/health') == (503, {'status': 'warming'})
        eng.start()
        doc = _wait_healthy(base)
        assert doc == {'status': 'ok', 'queue_depth': 0, 'in_flight': 0,
                       'kv_pages_free': eng.n_pages - 1}
    finally:
        _close(eng, server, th)


def test_greedy_tokens_match_jax_generate(stack):
    eng, base, jparams, jcfg = stack

    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, 256, n).tolist() for n in (5, 20, 40)]
    bodies = [{'tokens': p, 'max_new_tokens': MAX_NEW} for p in prompts]
    bodies.append({'text': 'hi there', 'max_new_tokens': MAX_NEW})
    prompts.append(list(b'hi there'))
    with concurrent.futures.ThreadPoolExecutor(len(bodies)) as ex:
        answers = list(ex.map(lambda d: _http(base + '/generate', d),
                              bodies))
    for prompt, body, (code, doc) in zip(prompts, bodies, answers):
        assert code == 200, doc
        want = jdecode.generate(jparams, jnp.asarray([prompt], jnp.int32),
                                jcfg, MAX_NEW)
        assert doc['tokens'] == np.asarray(want)[0].tolist()
        assert doc['finish_reason'] == 'length'
        assert len(doc['logprobs']) == MAX_NEW
        assert all(lp <= 0 for lp in doc['logprobs'])
        if 'text' in body:
            assert doc['text'] == eng.tokenizer.decode(doc['tokens'])
    # Every page went back to the free list; the CPU ran no kernel.
    assert eng.alloc.free_count == eng.n_pages - 1
    assert all(k.launches == 0 for k in build.kernels().values())


def test_stop_token_finishes_early(stack):
    eng, base, _, _ = stack
    code, first = _http(base + '/generate',
                        {'tokens': [3, 1, 4, 1, 5], 'max_new_tokens': 6})
    assert code == 200
    stop = first['tokens'][2]
    code, doc = _http(base + '/generate',
                      {'tokens': [3, 1, 4, 1, 5], 'max_new_tokens': 6,
                       'stop_token_ids': [stop]})
    assert code == 200 and doc['finish_reason'] == 'stop'
    assert doc['tokens'] == first['tokens'][:first['tokens'].index(stop)]
    assert eng.alloc.free_count == eng.n_pages - 1


def test_more_requests_than_slots_queue_and_all_finish(stack):
    """12 concurrent requests on 8 slots, greedy and sampled mixed: the
    overflow waits for a free slot, every request gets its tokens, and
    every page returns to the free list."""
    eng, base, _, _ = stack
    rng = np.random.default_rng(10)
    bodies = []
    for i in range(12):
        body = {'tokens': rng.integers(0, 256, 3 + 4 * i).tolist(),
                'max_new_tokens': 5}
        if i % 2:
            body.update(temperature=0.8, top_k=20, top_p=0.9)
        bodies.append(body)
    with concurrent.futures.ThreadPoolExecutor(len(bodies)) as ex:
        answers = list(ex.map(lambda d: _http(base + '/generate', d),
                              bodies))
    for code, doc in answers:
        assert code == 200, doc
        assert len(doc['tokens']) == 5 and doc['finish_reason'] == 'length'
        assert all(0 <= t < 256 for t in doc['tokens'])
        assert all(np.isfinite(doc['logprobs']))
    assert eng.in_flight() == 0 and eng.queue_depth() == 0
    assert eng.alloc.free_count == eng.n_pages - 1


def test_failed_step_answers_503_and_the_engine_recovers(stack,
                                                        monkeypatch):
    """A decode step that raises fails the requests on the card with a
    503, rebuilds the device state, and the next request is served."""
    eng, base, _, _ = stack
    real = decode.paged_decode_step
    calls = []

    def flaky(*args, **kwargs):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError('injected step fault')
        return real(*args, **kwargs)

    monkeypatch.setattr(decode, 'paged_decode_step', flaky)
    code, doc = _http(base + '/generate',
                      {'tokens': [5, 6, 7], 'max_new_tokens': 4})
    assert code == 503 and 'injected step fault' in doc['error']
    code, doc = _http(base + '/generate',
                      {'tokens': [5, 6, 7], 'max_new_tokens': 4})
    assert code == 200 and len(doc['tokens']) == 4
    assert eng.alloc.free_count == eng.n_pages - 1


def test_full_admission_queue_refuses_with_overloaded():
    cfg = dataclasses.replace(config.PRESETS['llama-debug'],
                              dtype=torch.float32)
    eng = engine_lib.InferenceEngine('llama-debug', cfg=cfg, device='cpu')
    for _ in range(engine_lib.MAX_QUEUE):       # the loop is not running
        eng.submit([1, 2], 1)
    with pytest.raises(engine_lib.EngineOverloaded):
        eng.submit([1, 2], 1)
    assert eng.queue_depth() == engine_lib.MAX_QUEUE


@pytest.mark.parametrize('body,needle', [
    ({'tokens': [], 'max_new_tokens': 4}, 'empty prompt'),
    ({'tokens': [1, 2], 'max_new_tokens': 0}, 'max_new_tokens < 1'),
    ({'tokens': [1] * 100, 'max_new_tokens': 8}, 'exceeds max_len'),
    ({'tokens': [1], 'top_p': 2.0}, 'top_p'),
])
def test_bad_requests_answer_400(stack, body, needle):
    _, base, _, _ = stack
    code, doc = _http(base + '/generate', body)
    assert code == 400 and needle in doc['error']


def test_filtered_distributions_match_jax_sampler():
    """Per-row temperature / top-k / top-p: JAX select_token_per_row's
    samples and the port's sampler's samples both follow the port's
    filtered distribution (softmax of decode.filter_logits), within 5
    binomial standard deviations; greedy rows pick the argmax."""
    rng = np.random.default_rng(9)
    v, n = 64, 4000
    logits = (rng.standard_normal((4, v)) * 2.0).astype(np.float32)
    temp = np.array([0.7, 1.0, 1.3, 0.0], np.float32)
    top_k = np.array([5, 0, 20, 0], np.int32)
    top_p = np.array([1.0, 0.9, 0.5, 0.0], np.float32)
    probs = torch.softmax(decode.filter_logits(
        torch.from_numpy(logits), torch.from_numpy(temp),
        torch.from_numpy(top_k), torch.from_numpy(top_p)), dim=-1).numpy()
    rep = np.repeat(np.arange(4), n)
    jax_draws = np.asarray(jdecode.select_token_per_row(
        jnp.asarray(logits[rep]), jnp.asarray(temp[rep]),
        jnp.asarray(top_k[rep]), jnp.asarray(top_p[rep]),
        jax.random.PRNGKey(0)))
    torch_draws = decode.select_token_per_row(
        torch.from_numpy(logits[rep]), torch.from_numpy(temp[rep]),
        torch.from_numpy(top_k[rep]), torch.from_numpy(top_p[rep]),
        torch.Generator().manual_seed(0)).numpy()
    for draws in (jax_draws, torch_draws):
        draws = draws.reshape(4, n)
        assert (draws[3] == np.argmax(logits[3])).all()
        for r in range(3):
            freq = np.bincount(draws[r], minlength=v) / n
            assert (freq[probs[r] == 0] == 0).all()
            sigma = np.sqrt(probs[r] * (1 - probs[r]) / n)
            assert (np.abs(freq - probs[r]) <= 5 * sigma + 1e-3).all()
    assert (probs[0] > 0).sum() == 5            # top-k kept exactly 5
