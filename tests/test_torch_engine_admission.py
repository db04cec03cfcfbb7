"""The PyTorch port engine's default admission on the CPU vs the JAX
package: chunked prefill, the shared-page prefix cache and prompt-lookup
speculative decoding.

llama-debug in fp32 on weights bridged from JAX ``init_params``, driven
through ``submit`` with the batch loop running. Greedy tokens of prefix
hits, of prompts prefilled in 32-token chunks and of speculative rounds
must equal JAX ``decode.generate`` exactly. The assertions of
tests/unit_tests/test_prefix_cache.py (TestEnginePrefixCache),
test_engine_paged.py (TestChunkedPrefill, TestPageLifecycle,
TestPageGatedAdmission, TestPrefixPageSharing) and test_engine_spec.py
(TestEngineSpeculative, the dense cases) are ported onto the port's
engine; where the JAX test reads a metric the port has no /metrics for,
the port's engine attribute or a spy on its method is read instead.
"""
import collections
import dataclasses
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from skypilot_tpu.models import decode as jdecode
from skypilot_tpu.models import llama as jllama
from skypilot_tpu_torch import config
from skypilot_tpu_torch.models import decode, weights
from skypilot_tpu_torch.serve import engine as engine_lib

MAX_LEN = 512
# Every JAX reference generates this many tokens (one compile per prompt
# bucket); a request's tokens are compared with its first max_new.
REF_NEW = 48
REPEAT = [1, 2, 3, 4, 5, 1, 2, 3, 4, 5, 1, 2, 3]
SEEDS = [REPEAT, [9, 9, 9, 9, 9, 9, 9], [3, 1, 4, 1, 5, 9]]


@pytest.fixture(scope='module')
def bridge():
    """(JAX params, JAX cfg, host tree, torch cfg): llama-debug fp32."""
    jcfg = dataclasses.replace(jllama.PRESETS['llama-debug'],
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(config.PRESETS['llama-debug'],
                               dtype=torch.float32)
    tree = jax.device_get(jllama.init_params(jax.random.PRNGKey(7), jcfg))
    return jax.tree.map(jnp.asarray, tree), jcfg, tree, tcfg


def _engine(bridge, max_len=MAX_LEN, start=True, **knobs):
    """A warm engine with ``knobs`` set as instance attributes before
    warm-up (the batch loop running unless ``start`` is False)."""
    _, _, tree, tcfg = bridge
    eng = engine_lib.InferenceEngine(
        'llama-debug', cfg=tcfg, device='cpu', max_len=max_len,
        params=weights.params_from_jax(tree, tcfg, device='cpu'))
    for name, val in knobs.items():
        setattr(eng, name, val)
    eng.warmup()
    if start:
        eng.start()
    return eng


@pytest.fixture(scope='module')
def eng(bridge):
    """The defaults (prefix cache 4, spec_k 4, cooldown 16) with 32-token
    prefill chunks."""
    e = _engine(bridge, prefill_chunk=32)
    yield e
    e.stop()


_REFS = {}


def _ref(bridge, prompt, n, max_len=MAX_LEN):
    """JAX decode.generate's greedy tokens for one prompt, right-padded
    to its bucket (prompt_lengths: one compile per bucket)."""
    key = (tuple(prompt), max_len)
    if key not in _REFS:
        jparams, jcfg, _, _ = bridge
        b = decode.bucket_size(len(prompt))
        padded = jnp.asarray([prompt + [0] * (b - len(prompt))], jnp.int32)
        _REFS[key] = np.asarray(jdecode.generate(
            jparams, padded, jcfg, REF_NEW, max_len=max_len,
            prompt_lengths=jnp.asarray([len(prompt)], jnp.int32)))[0].tolist()
    assert n <= REF_NEW
    return _REFS[key][:n]


def _run(eng, *jobs):
    """Submit every (tokens, max_new, kwargs) job at once; the results."""
    futs = [eng.submit(t, n, **kw) for t, n, kw in jobs]
    return [f.result(timeout=120) for f in futs]


def _held(eng):
    return sum(len(v) for v in eng._prefix_store.values())


def _spy(monkeypatch, name, before=None, after=None):
    """Wrap InferenceEngine.<name> with hooks (self, args, result)."""
    orig = getattr(engine_lib.InferenceEngine, name)

    def wrapped(self, *args, **kwargs):
        if before is not None:
            before(self, args)
        out = orig(self, *args, **kwargs)
        if after is not None:
            after(self, args, out)
        return out
    monkeypatch.setattr(engine_lib.InferenceEngine, name, wrapped)


# ---------------------------------------------------------------------------
# The knobs
# ---------------------------------------------------------------------------

def test_knobs_have_the_jax_names_and_defaults(bridge, monkeypatch):
    _, _, _, tcfg = bridge
    e = engine_lib.InferenceEngine('llama-debug', cfg=tcfg, device='cpu',
                                   max_len=2048)
    assert (e.prefix_cache, e.spec_k, e.spec_cooldown, e.prefill_chunk,
            e.kv_pages, e.page_size) == (4, 4, 16, 256, 0, 64)
    assert (engine_lib.SPEC_NGRAM, engine_lib.SPEC_LOOKUP_WINDOW,
            engine_lib.SPEC_MIN_ACCEPT, engine_lib.SPEC_NO_DRAFT_COOLDOWN,
            engine_lib.PREFIX_MIN_TOKENS) == (3, 512, 0.25, 4, 64)
    e._ensure_state()
    # (8 slots + 4 prefix entries) x 32 pages of 64 + the trash page.
    assert e.n_pages == 12 * 32 + 1
    for name, val, needle in (('page_size', 48, 'power of two dividing'),
                              ('page_size', 128, 'power of two dividing'),
                              ('prefill_chunk', 8, 'PREFILL_CHUNK'),
                              ('prefill_chunk', 48, 'PREFILL_CHUNK'),
                              ('kv_pages', 20, 'cannot hold one')):
        bad = engine_lib.InferenceEngine('llama-debug', cfg=tcfg,
                                         device='cpu', max_len=2048)
        setattr(bad, name, val)
        with pytest.raises(ValueError, match=needle):
            bad.warmup()
    monkeypatch.setattr(engine_lib, 'PREFILL_CHUNK', 100)
    with pytest.raises(ValueError, match='PREFILL_CHUNK'):
        engine_lib.InferenceEngine('llama-debug', cfg=tcfg, device='cpu')


def test_warmup_leaves_no_page_and_an_empty_store(bridge):
    e = _engine(bridge, start=False, prefill_chunk=32)
    assert e.warm and e.graphs == {}
    assert e.alloc.used_count == 0 and not e._prefix_store
    assert (e.prefix_hits, e.prefill_chunks, e.spec_rounds, e.spec_proposed,
            e.spec_accepted) == (0, 0, 0, 0, 0)
    assert all(s is None for s in e.slots)


# ---------------------------------------------------------------------------
# The prefix cache (TestEnginePrefixCache)
# ---------------------------------------------------------------------------

def test_shared_prefix_hits_and_matches_cold_result(bridge, eng):
    """B shares A's 64-token prefix: B rides the prefix path (one hit)
    and both equal JAX decode.generate."""
    prefix = [(i % 250) + 1 for i in range(70)]
    prompt_a, prompt_b = prefix + [5, 6, 7], prefix + [9, 8]
    (a, _, _, _), = _run(eng, (prompt_a, 4, {}))
    hits0 = eng.prefix_hits
    (b, _, _, _), = _run(eng, (prompt_b, 4, {}))
    assert eng.prefix_hits - hits0 == 1
    assert a == _ref(bridge, prompt_a, 4)
    assert b == _ref(bridge, prompt_b, 4)


def test_growing_history_extends_its_snapshot(bridge):
    """Each turn's prompt starts with the previous turn's: the hit path
    re-captures the longer prefix, so turn 3 matches 256, not 64."""
    e = _engine(bridge, max_len=1024)
    try:
        turn1 = [(i % 250) + 1 for i in range(100)]
        turn2 = turn1 + [(i % 250) + 1 for i in range(100, 300)]
        turn3 = turn2 + [3, 1, 4]
        for toks in (turn1, turn2, turn3):
            out, finish, _, _ = _run(e, (toks, 2, {}))[0]
            assert len(out) == 2 and finish == 'length'
        assert e._prefix_match(turn3) == 256
        assert e.prefix_hits == 2
    finally:
        e.stop()


def test_short_prompts_never_snapshot(eng):
    n0, hits0 = len(eng._prefix_store), eng.prefix_hits
    _run(eng, ([1, 2, 3], 2, {}), ([4] * 63, 2, {}))
    assert len(eng._prefix_store) == n0 and eng.prefix_hits == hits0


def test_concurrent_burst_hits_prefix(bridge, eng):
    """After one request seeds the snapshot, a simultaneous burst of 4
    same-prefix requests gives 4 hits, each equal to JAX's output."""
    prefix = [(i * 3 % 250) + 1 for i in range(70)]
    _run(eng, (prefix + [11], 2, {}))
    hits0 = eng.prefix_hits
    burst = [prefix + [20 + j] for j in range(4)]
    outs = _run(eng, *[(t, 3, {}) for t in burst])
    assert eng.prefix_hits - hits0 == 4
    for t, (got, _, _, _) in zip(burst, outs):
        assert got == _ref(bridge, t, 3)


def test_lru_eviction_bounded(eng):
    for base in range(eng.prefix_cache + 3):
        _run(eng, ([(base * 7 + i) % 250 + 1 for i in range(70)], 2, {}))
    assert len(eng._prefix_store) <= eng.prefix_cache
    assert eng.alloc.used_count == _held(eng)


# ---------------------------------------------------------------------------
# Chunked prefill (TestChunkedPrefill)
# ---------------------------------------------------------------------------

def test_chunked_output_identical_and_decode_interleaves(bridge, eng,
                                                         monkeypatch):
    """A 100-token prompt (32-token chunks: 4 chunk calls, the last of 4
    tokens at bucket 16) admitted with a short request: both equal JAX,
    and decode ran BETWEEN chunk calls; the long request's first token
    came after the short one's."""
    seen, firsts = [], []
    _spy(monkeypatch, '_advance_chunk',
         before=lambda self, args: seen.append(
             (self.step_count, self.slots[args[0]]['prefill']['pos'])))
    _spy(monkeypatch, '_finish_admit',
         before=lambda self, args: firsts.append(len(args[0].tokens)))
    long_p = [(i * 7) % 250 + 1 for i in range(100)]
    short_p = [42, 43, 44, 45]
    chunks0 = eng.prefill_chunks
    (lo, lf, _, _), (so, sf, _, _) = _run(eng, (long_p, 6, {}),
                                          (short_p, 16, {}))
    assert lo == _ref(bridge, long_p, 6) and lf == 'length'
    assert so == _ref(bridge, short_p, 16) and sf == 'length'
    assert eng.prefill_chunks - chunks0 == 4
    assert [pos for _, pos in seen] == [0, 32, 64, 96]
    assert seen[-1][0] > seen[0][0], seen        # decode between chunks
    assert firsts == [len(short_p), len(long_p)]


def test_non_final_chunk_draws_nothing(bridge, monkeypatch):
    """A non-final chunk touches neither the admission generator nor the
    device ``last``: a sampled chunked prompt draws what it would draw
    grouped (same generator state at its only draw)."""
    e = _engine(bridge, start=False, prefill_chunk=32, spec_k=0)
    states = []
    _spy(monkeypatch, '_sample_first',
         before=lambda self, args: states.append(
             self.generator.get_state().clone()))
    req = engine_lib.Request([(i * 5) % 250 + 1 for i in range(100)], 2,
                             temperature=0.9)
    start = e.generator.get_state().clone()
    last0 = e.last_dev.clone()
    e._start_chunked(req)
    for _ in range(3):
        assert torch.equal(e.last_dev, last0)
        assert torch.equal(e.generator.get_state(), start)
        e._advance_chunk(e._pending_chunks()[0])
    assert not e._pending_chunks() and len(states) == 1
    assert torch.equal(states[0], start)


def test_cancel_mid_chunked_prefill_releases_pages(eng, monkeypatch):
    orig = engine_lib.InferenceEngine._advance_chunk

    def slow(self, slot):
        time.sleep(0.02)
        return orig(self, slot)

    monkeypatch.setattr(engine_lib.InferenceEngine, '_advance_chunk', slow)
    free0, held0 = eng.alloc.free_count, _held(eng)
    fut = eng.submit([(i * 11) % 250 + 1 for i in range(300)], 8)
    deadline = time.monotonic() + 30
    while not eng._pending_chunks():
        assert time.monotonic() < deadline, 'prefill never started'
        time.sleep(0.001)
    eng.cancel(fut)
    out, finish, _, _ = fut.result(timeout=60)
    assert finish == 'stop' and out == []
    deadline = time.monotonic() + 30
    while eng.in_flight():
        assert time.monotonic() < deadline
        time.sleep(0.005)
    assert eng.alloc.free_count == free0 and _held(eng) == held0


# ---------------------------------------------------------------------------
# Pages (TestPageLifecycle, TestPageGatedAdmission, TestPrefixPageSharing)
# ---------------------------------------------------------------------------

def test_idle_pool_holds_only_store_pages(eng):
    _run(eng, ([8] * 8, 4, {}), ([(i * 13) % 250 + 1 for i in range(90)],
                                 3, {}))
    assert eng.alloc.used_count == _held(eng)


def test_pages_freed_at_finish_while_pool_still_busy(eng):
    """A short request's pages free while a longer one still decodes."""
    f_long = eng.submit([8] * 8, 48)
    eng.submit([6] * 8, 2).result(timeout=60)
    used = None
    deadline = time.monotonic() + 30
    while not f_long.done() and time.monotonic() < deadline:
        live = [s for s in eng.slots if s is not None]
        if len(live) == 1:
            used = eng.alloc.used_count
            break
        time.sleep(0.001)
    f_long.result(timeout=60)
    long_need = eng._pages_needed(engine_lib.Request([8] * 8, 48))
    assert used is not None
    assert used <= long_need + _held(eng)


def test_oversubscribed_pool_waits_then_serves_fifo(bridge, monkeypatch):
    """Page size 16, 12 pages: 8 requests of 2 pages each cannot all be
    admitted at once. Some wait (held), nobody fails, each output equals
    its solo JAX reference, and every page returns."""
    held = []
    _spy(monkeypatch, '_drain_admissible',
         after=lambda self, args, out: held.append(len(self._hold)))
    e = _engine(bridge, max_len=128, page_size=16, kv_pages=12,
                prefill_chunk=16)
    try:
        jobs = [([i + 1] * 8, 8, {}) for i in range(8)]
        for (tokens, n, _), (out, finish, _, _) in zip(jobs, _run(e, *jobs)):
            assert out == _ref(bridge, tokens, n, max_len=128)
            assert finish == 'length'
        assert max(held) >= 1, 'the pool never made a request wait'
        assert not e._hold and e.alloc.used_count == _held(e)
    finally:
        e.stop()


def test_hit_shares_pages_and_eviction_returns_them(bridge, monkeypatch):
    e = _engine(bridge, start=False)
    e.start()
    try:
        pfx = [(i * 3) % 250 + 1 for i in range(70)]
        _run(e, (pfx + [101, 102, 103], 4, {}))
        key = tuple(pfx[:64])
        pids = e._prefix_store[key]
        assert len(pids) == 1 and e.alloc.refcount(pids[0]) == 1
        during = []

        def note(self, args, out):
            del out
            slot = next(i for i, s in enumerate(self.slots)
                        if s is not None and s['req'] is args[0])
            during.append((self._table_np[slot, :len(pids)].tolist(),
                           [self.alloc.refcount(p) for p in pids]))

        _spy(monkeypatch, '_admit_with_prefix', after=note)
        hits0, free0 = e.prefix_hits, e.alloc.free_count
        (out, _, _, _), = _run(e, (pfx + [104, 105], 4, {}))
        assert e.prefix_hits == hits0 + 1 and len(out) == 4
        assert out == _ref(bridge, pfx + [104, 105], 4)
        # While it ran, its table pointed at the snapshot's page, held by
        # the store and by the hit.
        assert during == [(pids, [2])]
        # It borrowed the shared page and returned its own.
        assert e.alloc.free_count == free0
        assert e.alloc.refcount(pids[0]) == 1
    finally:
        e.stop()
    e._clear_prefix_store()
    assert e.alloc.refcount(pids[0]) == 0
    assert e.alloc.used_count == 0


def test_failure_reset_drops_the_store_without_unref(bridge):
    """A failure reset rebuilds the allocator and empties the store; the
    old ids are not unref'd into the fresh pool."""
    e = _engine(bridge, start=False)
    e._admit_group([engine_lib.Request([(i * 9) % 250 + 1
                                        for i in range(70)], 4)])
    assert e._prefix_store and e.alloc.used_count > 0
    e._fail_all(RuntimeError('injected'))
    assert not e._prefix_store and e.alloc.used_count == 0
    assert all(s is None for s in e.slots)


# ---------------------------------------------------------------------------
# Speculative decoding (TestEngineSpeculative, dense)
# ---------------------------------------------------------------------------

def _repeating(bridge, seed_prompt, n=16):
    """A self-repeating prompt: the seed and the model's own first n
    greedy tokens after it (random weights fall into loops), so that
    prompt lookup drafts from the first round on."""
    return seed_prompt + _ref(bridge, seed_prompt, n)


def test_spec_output_equals_jax_greedy(bridge):
    """Speculation on (cooldown off, as the JAX test sets it): the same
    tokens as JAX decode.generate, speculation demonstrably active."""
    e = _engine(bridge, spec_cooldown=0)
    try:
        prompts = [_repeating(bridge, p) for p in SEEDS]
        outs = _run(e, *[(p, 24, {}) for p in prompts])
        assert e.spec_rounds > 0, 'speculation never fired'
        assert e.spec_accepted > 0
        assert e.spec_proposed >= e.spec_accepted
        for p, (toks, finish, lps, _) in zip(prompts, outs):
            assert toks == _ref(bridge, p, 24) and finish == 'length'
            assert len(lps) == 24 and all(lp <= 0 for lp in lps)
        assert e.alloc.used_count == _held(e)
    finally:
        e.stop()


@pytest.mark.parametrize('kw', [{'temperature': 0.9},
                                {'presence': 0.5}])
def test_spec_declines_on_sampling_or_penalized_rows(bridge, monkeypatch,
                                                     kw):
    """A sampled or a penalized row in the pool suspends speculation (the
    exactness guarantee is greedy-only); everything completes."""
    bad = []

    def check(self, args, ran):
        del args
        if ran and any(self._row_active(s) and (
                self.temp[i] > 0 or self.pres[i] or self.freq[i])
                for i, s in enumerate(self.slots)):
            bad.append(1)

    _spy(monkeypatch, '_spec_once', after=check)
    e = _engine(bridge, spec_cooldown=0)
    try:
        (a, _, _, _), (b, _, _, _) = _run(e, (REPEAT, 8, {}),
                                          ([5, 6, 7], 8, kw))
        assert len(a) == 8 and len(b) == 8 and not bad
        rounds = e.spec_rounds
        _run(e, ([5, 6, 7] * 5, 16, kw))
        assert e.spec_rounds == rounds     # alone in the pool: never
    finally:
        e.stop()


def test_spec_respects_stop_and_want(bridge):
    """A stop token inside an accepted run cuts generation there; a
    run never commits past max_new."""
    e = _engine(bridge, spec_cooldown=0)
    prompt = _repeating(bridge, SEEDS[1], 10)
    try:
        (full, _, _, _), = _run(e, (prompt, 8, {}))
        assert e.spec_rounds > 0 and e.spec_accepted > 0
        assert full == _ref(bridge, prompt, 8)
        stop = next(t for t in full if t != full[0])
        (cut, finish, _, _), = _run(e, (prompt, 8, {'stop_ids': (stop,)}))
        assert cut == full[:full.index(stop)] and finish == 'stop'
        for n in (1, 2, 3, 5):
            (out, finish, _, _), = _run(e, (prompt, n, {}))
            assert out == full[:n] and finish == 'length'
    finally:
        e.stop()


def test_low_accept_triggers_cooldown(bridge, monkeypatch):
    """A round accepting under SPEC_MIN_ACCEPT of its proposals pauses
    speculation for ``spec_cooldown`` collected calls (fused calls run
    meanwhile, one tick each); the output is still JAX's."""
    monkeypatch.setattr(engine_lib, '_lookup_draft',
                        lambda ctx, k: [255] * k)       # always wrong
    rounds = collections.Counter()
    after_round = []

    def note(self, args, ran):
        del args
        rounds[ran] += 1
        if ran:
            after_round.append((self.spec_proposed, self.spec_accepted,
                                self._spec_cool))

    _spy(monkeypatch, '_spec_once', after=note)
    e = _engine(bridge)
    try:
        (out, _, _, _), = _run(e, (REPEAT, 40, {}))
        assert out == _ref(bridge, REPEAT, 40)
        assert after_round and all(cool == e.spec_cooldown
                                   for _, _, cool in after_round)
        # Between rounds the pool ran fused calls for the cooldown.
        assert len(after_round) <= 1 + 40 // e.spec_cooldown
        assert e.calls and e.spec_accepted == 0
    finally:
        e.stop()


def test_no_draft_pauses_speculation(bridge, monkeypatch):
    monkeypatch.setattr(engine_lib, '_lookup_draft', lambda ctx, k: None)
    e = _engine(bridge, start=False)
    e._admit_group([engine_lib.Request(REPEAT, 20)])
    assert not e._spec_once()
    assert e._spec_cool == engine_lib.SPEC_NO_DRAFT_COOLDOWN
    for tick in range(engine_lib.SPEC_NO_DRAFT_COOLDOWN):
        assert not e._spec_precheck()
        e._step_once(k_force=1)
    assert e._spec_cool == 0 and e._spec_precheck()
    assert e.spec_rounds == 0
