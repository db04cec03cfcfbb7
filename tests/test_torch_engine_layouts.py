"""The JAX engine's two other K/V layouts in the port, on the CPU:
``SKYTPU_ENGINE_PAGED=0`` (contiguous slabs, bucket admission) and
``SKYTPU_ENGINE_ATTN=gather`` (the paged pool through
``paging.gather_view`` / ``scatter_steps`` / ``scatter_suffix``).

Inputs are made from numpy seeds; the models are the debug presets in
fp32 on weights bridged from JAX ``init_params`` (models/weights.py).
Ported contracts (tests/unit_tests/test_engine_paged.py, test_paging.py):
  * ``gather_view``, ``scatter_steps`` and ``scatter_suffix`` equal JAX's
    bit for bit on fp32 pools of both families (``scatter_suffix`` on
    int8 pools too); ``gather_view`` and ``scatter_steps`` refuse int8
    pools in JAX's words; the fused verify and extend equal the gather
    formulation bit for bit;
  * the port's engine in each layout gives the JAX engine's greedy
    tokens in the same layout, logprobs at rtol 1e-6 (JAX's bar),
    through grouped prefills, chunks (gather only: the slabs never
    chunk), a prefix hit and speculation; one contiguous case each on
    moe-debug and mla-debug;
  * inside the port, fused, contiguous and gather serve identical
    greedy and sampled tokens on the same seed, gather's logprobs
    array-equal to fused's; a contiguous prefix hit equals the paged
    engine's and its snapshot is a copy, not a view of the slab;
  * the cache-traffic counters follow JAX's formula; the contiguous
    replica refuses disagg in JAX's words, keeps the host tier off,
    publishes no backend gauge and warms every bucket; a serving mesh
    refuses both layouts by name.
The port's engines are driven by hand (``_drive``: admission, chunks and
step rounds as the batch loop runs them, with every job queued first),
so grouping and sampling draws are the same on every engine. The JAX
engines skip their warm-up (its compiles of every variant cost most of
this file's time): ``warm`` is set instead, which turns the prefix cache
and speculation on, and each program compiles at first use.
"""
import asyncio
import dataclasses
import json
import re
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from skypilot_tpu.models import decode as jdecode
from skypilot_tpu.models import mla as jmla
from skypilot_tpu.models import paging as jpaging
from skypilot_tpu.serve import engine as jengine
from skypilot_tpu_torch.models import decode, paging
from skypilot_tpu_torch.serve import engine as engine_lib
from test_torch_kv_int8 import _model

MAX_LEN, CHUNK = 128, 16
LAYOUTS = {'fused': (True, 'fused'), 'contiguous': (False, 'fused'),
           'gather': (True, 'gather')}
PREFIX = [(7 * i + 3) % 250 + 1 for i in range(70)]
# A grouped prefill, a prompt the paged layouts chunk (bucket 64 over
# 16-token chunks), a 70-token prompt and its 64-token prefix again (a
# hit), and a self-repeating prompt (prompt-lookup drafts).
REQS = [([5, 17, 2, 99, 41], 8), ([(13 * i + 1) % 256 for i in range(40)], 8),
        (PREFIX + [9, 8, 7], 8), (PREFIX + [3, 1, 4, 1], 8),
        ([1, 2, 3, 4, 5] * 4, 16)]


# ---------------------------------------------------------------------------
# models/paging.py: the view, the scatters
# ---------------------------------------------------------------------------

L, B, PSZ, MAXP = 2, 4, 8, 4


def _pools(family, seed, quant=False):
    """The same pool in both packages: random contents in fp32 (int8
    codes and fp32 scales when ``quant``), rows on distinct pages, row 3
    on two pages only (its later positions read and write the trash
    page), random lengths."""
    rng = np.random.default_rng(seed)
    n_pages = B * MAXP + 1
    dims = ({'k': (2, 16), 'v': (2, 16)} if family == 'kv'
            else {'c_kv': (32,), 'k_rope': (8,)})
    arrays = {}
    for name, tail in dims.items():
        shape = (L, n_pages, PSZ, *tail)
        if quant:
            arrays[name] = rng.integers(-127, 128, shape).astype(np.int8)
            arrays[paging._SCALE_FIELD[name]] = rng.uniform(
                1e-3, 1e-1, shape[:-1]).astype(np.float32)
        else:
            arrays[name] = rng.standard_normal(shape).astype(np.float32)
    table = 1 + rng.permutation(B * MAXP).reshape(B, MAXP).astype(np.int32)
    table[3, 2:] = 0
    length = rng.integers(1, MAXP * PSZ - 4, B).astype(np.int32)
    tcls, jcls = ((paging.PagedKV, jpaging.PagedKV) if family == 'kv'
                  else (paging.PagedLatent, jpaging.PagedLatent))
    port = tcls(table=torch.from_numpy(table.copy()),
                length=torch.from_numpy(length.copy()),
                **{k: torch.from_numpy(a.copy()) for k, a in arrays.items()})
    jax_pool = jcls(table=jnp.asarray(table), length=jnp.asarray(length),
                    **{k: jnp.asarray(a) for k, a in arrays.items()})
    return port, jax_pool


def _same_pools(port, jax_pool, skip_trash=False):
    """Every per-token tensor bit-equal (page 0 left out where several
    rows may write it: which duplicate wins is undefined in both
    packages, and nothing reads it), and the lengths."""
    lo = 1 if skip_trash else 0
    for name, t in paging.pool_tensors(port).items():
        np.testing.assert_array_equal(t.numpy()[:, lo:],
                                      np.asarray(getattr(jax_pool,
                                                         name))[:, lo:])
    np.testing.assert_array_equal(port.length.numpy(),
                                  np.asarray(jax_pool.length))


@pytest.mark.parametrize('family', ['kv', 'latent'])
def test_gather_view_and_scatter_steps_equal_jax(family):
    """The view of rows of every length (row 3's tail on the trash page)
    at a max_len off the page grid; then k = 8 stepped positions per row
    written into the view, one row inactive and one row running past
    max_len and past the table (both clamps), scattered back."""
    port, jp = _pools(family, 1)
    max_len, k = MAXP * PSZ - 4, 8
    view, jview = paging.gather_view(port, max_len), \
        jpaging.gather_view(jp, max_len)
    assert view.length is port.length
    for name, t in paging._pools_of_view(view).items():
        np.testing.assert_array_equal(
            t.numpy(), np.asarray(jpaging._pools_of_view(jview)[name]))
    rng = np.random.default_rng(2)
    start = np.array([3, 20, max_len - 2, 9], np.int32)
    active = np.array([True, True, True, False])
    port.length.copy_(torch.from_numpy(start))
    jp = dataclasses.replace(jp, length=jnp.asarray(start))
    jv = {}
    for name, t in paging._pools_of_view(view).items():
        new = rng.standard_normal((L, B, k, *t.shape[3:])).astype(np.float32)
        a = np.asarray(jpaging._pools_of_view(jview)[name]).copy()
        for b in range(B):
            for j in range(k):
                if start[b] + j < max_len:
                    t[:, b, start[b] + j] = torch.from_numpy(new[:, b, j])
                    a[:, b, start[b] + j] = new[:, b, j]
        jv[name] = jnp.asarray(a)
    stepped = start + k * active
    port.length.copy_(torch.from_numpy(stepped))
    jview = dataclasses.replace(jview, length=jnp.asarray(stepped), **jv)
    paging.scatter_steps(port, view, torch.from_numpy(start), k,
                         torch.from_numpy(active))
    want = jpaging.scatter_steps(jp, jview, jnp.asarray(start), k,
                                 jnp.asarray(active))
    _same_pools(port, want, skip_trash=True)


@pytest.mark.parametrize('family,quant', [('kv', False), ('latent', False),
                                          ('kv', True), ('latent', True)])
def test_scatter_suffix_equals_jax(family, quant):
    """A suffix of 11 positions (a non-power-of-two) after a 16-token
    prefix, into row 1's own pages; int8 pools quantize it into codes
    and scales bit-equal to JAX's."""
    port, jp = _pools(family, 3, quant=quant)
    slot, p, s2 = 1, 2 * PSZ, 11
    rng = np.random.default_rng(4)
    rows = [rng.standard_normal((L, 1, s2, *t.shape[3:])).astype(np.float32)
            for t in paging._pools(port).values()]
    padded = [np.concatenate([np.zeros((L, 1, p, *r.shape[3:]), np.float32),
                              r], axis=2) for r in rows]
    if family == 'kv':
        jrow = jdecode.KVCache(k=jnp.asarray(padded[0]),
                               v=jnp.asarray(padded[1]),
                               length=jnp.zeros(1, jnp.int32))
    else:
        jrow = jmla.LatentCache(c_kv=jnp.asarray(padded[0]),
                                k_rope=jnp.asarray(padded[1]),
                                length=jnp.zeros(1, jnp.int32))
    paging.scatter_suffix(port, *(torch.from_numpy(r) for r in rows), slot,
                          p, s2, p + 7)
    want = jpaging.scatter_suffix(jp, jrow, slot, p, s2, p + 7)
    _same_pools(port, want)


def test_gather_baseline_refuses_int8_pools_in_jax_words():
    port, jp = _pools('kv', 5, quant=True)
    view_port, _ = _pools('kv', 5)
    view = paging.gather_view(view_port, 16)
    for call, jcall in (
            (lambda: paging.gather_view(port, 16),
             lambda: jpaging.gather_view(jp, 16)),
            (lambda: paging.scatter_steps(port, view, port.length, 1,
                                          torch.ones(B, dtype=torch.bool)),
             lambda: jpaging.scatter_steps(jp, None, jp.length, 1,
                                           jnp.ones(B, bool)))):
        with pytest.raises(NotImplementedError) as jerr:
            jcall()
        with pytest.raises(NotImplementedError,
                           match=re.escape(str(jerr.value))):
            call()


def _family(family):
    name = 'llama-debug' if family == 'kv' else 'mla-debug'
    _, tmod, _, tcfg, _, params, _ = _model(name)
    return tmod, tcfg, params


def _model_pool(tmod, cfg, seed):
    """A pool of the model's shapes (fp32 contents, rows on distinct
    pages, the trash page under row 3's tail) and an active mask."""
    pc = tmod.init_page_pool(cfg, B * MAXP + 1, PSZ, B, MAXP, device='cpu')
    rng = np.random.default_rng(seed)
    for t in paging._pools(pc).values():
        t.copy_(torch.from_numpy(rng.standard_normal(t.shape)
                                 .astype(np.float32)))
    table = 1 + rng.permutation(B * MAXP).reshape(B, MAXP)
    table[3, 2:] = 0
    pc.table.copy_(torch.from_numpy(table.astype(np.int32)))
    pc.length.copy_(torch.from_numpy(
        rng.integers(1, 2 * PSZ - 4, B).astype(np.int32)))
    return pc, torch.tensor([True, True, False, True])


def _clone_pool(pc):
    return dataclasses.replace(pc, **{
        f.name: getattr(pc, f.name).clone() for f in dataclasses.fields(pc)
        if getattr(pc, f.name) is not None})


@pytest.mark.parametrize('family', ['kv', 'latent'])
@pytest.mark.parametrize('k', [1, 4])
def test_fused_verify_bit_equals_gather_formulation(family, k):
    """The paged verify (in place) against gather_view -> the
    contiguous verify_step -> scatter_steps on the same pool: logits and
    pages bit-equal (the JAX contract of test_paging.py)."""
    tmod, cfg, params = _family(family)
    pc, active = _model_pool(tmod, cfg, k)
    ref = _clone_pool(pc)
    toks = torch.from_numpy(np.random.default_rng(100 + k).integers(
        0, cfg.vocab_size, (B, k)).astype(np.int32))
    max_len = MAXP * PSZ
    start = ref.length.clone()
    view = paging.gather_view(ref, max_len)
    logits_ref, view = tmod.verify_step(params, toks, view, cfg)
    paging.scatter_steps(ref, view, start, k, active)
    logits, _ = tmod.paged_verify_step(params, toks, pc, cfg,
                                       max_len=max_len, active=active)
    assert torch.equal(logits, logits_ref)
    for name, t in paging.pool_tensors(pc).items():
        assert torch.equal(t[:, 1:], getattr(ref, name)[:, 1:])
    assert torch.equal(pc.length, ref.length)


@pytest.mark.parametrize('family', ['kv', 'latent'])
def test_fused_extend_bit_equals_gather_formulation(family):
    """The chunk / prefix-hit extend: the suffix over the row's prefix
    pages in place, against gather_prefix -> prefill_extend at max_len
    p + s2 -> scatter_suffix."""
    tmod, cfg, params = _family(family)
    pc, _ = _model_pool(tmod, cfg, 5)
    ref = _clone_pool(pc)
    slot, p, s2, n = 1, 2 * PSZ, 16, 11
    toks = torch.from_numpy(np.random.default_rng(55).integers(
        0, cfg.vocab_size, (1, s2)).astype(np.int32))
    pre = paging.gather_prefix(ref, slot, p)
    logits_ref, ra, rb = tmod.prefill_extend(
        params, toks, cfg, p + s2, *pre,
        lengths=torch.tensor([n], dtype=torch.int32))
    paging.scatter_suffix(ref, ra, rb, slot, p, s2, p + n)
    logits = tmod.paged_prefill_extend(params, toks, pc, cfg, slot=slot,
                                       p=p, lengths=n)
    assert torch.equal(logits, logits_ref)
    for name, t in paging.pool_tensors(pc).items():
        assert torch.equal(t, getattr(ref, name))
    assert torch.equal(pc.length, ref.length)


# ---------------------------------------------------------------------------
# The engine in each layout
# ---------------------------------------------------------------------------

def _port_engine(name, layout, warm=True, **attrs):
    _, _, _, tcfg, _, params, _ = _model(name)
    eng = engine_lib.InferenceEngine(name, cfg=tcfg, device='cpu',
                                     max_len=MAX_LEN, params=params)
    eng.paged, eng.attn_backend = LAYOUTS[layout]
    eng.prefill_chunk = CHUNK
    eng.spec_cooldown = 0
    for key, val in attrs.items():
        setattr(eng, key, val)
    if warm:
        eng.warmup()
    return eng


def _drive(eng, jobs):
    """Queue every (tokens, max_new, kwargs) job, then run the batch
    loop's rounds by hand (admission, one chunk, a step round, each
    followed by a publish) until all resolve: the same admission groups
    and step calls on every engine."""
    futs = [eng.submit(t, n, **kw) for t, n, kw in jobs]
    while not all(f.done() for f in futs):
        eng._admit_pending()
        eng._publish()
        pending = eng._pending_chunks()
        if pending:
            eng._advance_chunk(pending[0])
            eng._publish()
        if any(eng._row_active(s) for s in eng.slots):
            eng._step_round()
            eng._publish()
    return [f.result() for f in futs]


def _one_by_one(eng, reqs):
    return [_drive(eng, [(t, n, {})])[0] for t, n in reqs]


@pytest.fixture(scope='module')
def engines():
    """llama-debug in the three layouts, warm, the loop driven by hand."""
    return {lay: _port_engine('llama-debug', lay) for lay in LAYOUTS}


def _jax_engine_run(name, layout, reqs, warm=True):
    """The JAX engine's (tokens, finish, logprobs) for ``reqs`` submitted
    one at a time, in ``layout``, on the bridged weights."""
    jmod, _, jcfg, _, jparams, _, _ = _model(name)
    eng = jengine.InferenceEngine(name, max_len=MAX_LEN, seed=0)
    eng.cfg = jcfg
    eng.params = (jdecode.cast_params_for_decode(jparams, jcfg)
                  if jmod is jdecode else jparams)
    eng.paged, eng.attn_backend = LAYOUTS[layout]
    eng.prefill_chunk = CHUNK
    eng.spec_cooldown = 0
    eng.warm = warm

    async def main():
        eng._queue = asyncio.Queue(maxsize=jengine.MAX_QUEUE)
        task = asyncio.get_running_loop().create_task(eng.batch_loop())
        try:
            return [await eng.submit_nowait(t, n, 0.0, None, None)
                    for t, n in reqs]
        finally:
            task.cancel()
    loop = asyncio.new_event_loop()
    try:
        out = loop.run_until_complete(main())
    finally:
        loop.close()
    return out, eng.prefix_hits


@pytest.mark.parametrize('layout', ['contiguous', 'gather'])
def test_layout_tokens_equal_jax_engine(engines, layout):
    """Greedy tokens equal the JAX engine's in the same layout, logprobs
    at rtol 1e-6, through the grouped prefill, the chunks (gather; the
    slabs take the 40-token prompt in one bucket prefill), the prefix
    hit and speculation."""
    want, jax_hits = _jax_engine_run('llama-debug', layout, REQS)
    eng = engines[layout]
    c0 = (eng.prefix_hits, eng.prefill_chunks, eng.spec_rounds)
    got = _one_by_one(eng, REQS)
    for (jt, jf, jl, _), (pt, pf, pl, _) in zip(want, got):
        assert list(jt) == pt and jf == pf
        np.testing.assert_allclose(pl, jl, rtol=1e-6)
    hits, chunks, rounds = (eng.prefix_hits - c0[0],
                            eng.prefill_chunks - c0[1],
                            eng.spec_rounds - c0[2])
    assert hits == jax_hits == 1
    assert (chunks > 0) == (layout == 'gather')
    assert rounds > 0
    assert all(s is None for s in eng.slots)


def test_layouts_identical_greedy_and_sampled(engines):
    """Fused, contiguous and gather on the same seed: identical greedy
    tokens (a chunked prompt among them) and identical sampled pools
    (the generators re-pinned: each draws at the same points in every
    layout); gather's logprobs array-equal to fused's."""
    long_p = [(i * 13) % 250 + 1 for i in range(60)]
    greedy = [([1, 2, 3, 4, 5], 12, {}), (long_p, 6, {})]
    sampled = [([11] * 8, 10, dict(temperature=0.9, top_k=40, top_p=0.95)),
               ([12] * 8, 10, dict(temperature=0.7)),
               ([13, 14, 15], 10, dict(temperature=1.2, top_k=20,
                                       top_p=0.8)),
               ([16] * 8, 10, {})]
    for jobs in (greedy, sampled):
        outs = {}
        for lay, eng in engines.items():
            eng.generator.manual_seed(3)
            eng._step_gen.manual_seed(4)
            outs[lay] = _drive(eng, jobs)
        for lay in ('contiguous', 'gather'):
            for (ta, fa, la, _), (tb, fb, lb, _) in zip(outs['fused'],
                                                        outs[lay]):
                assert ta == tb and fa == fb, lay
                if lay == 'gather':
                    np.testing.assert_array_equal(la, lb)


def test_contiguous_prefix_hit_holds_a_copy(engines):
    """Admit a prompt (its 64-token prefix snapshotted from slot 0),
    reuse slot 0 for another 70-token prompt, then hit the first prefix:
    the hit's tokens equal the paged engine's on the same traffic, and
    the snapshot shares no storage with the slab (a view would hold the
    second prompt's K/V by then)."""
    other = [(11 * i + 5) % 250 + 1 for i in range(70)]
    reqs = [(PREFIX + [40, 41], 6), (other, 6), (PREFIX + [42], 6)]
    outs = {}
    for lay in ('fused', 'contiguous'):
        eng = engines[lay]
        eng._clear_prefix_store()
        hits0 = eng.prefix_hits
        outs[lay] = [o[0] for o in _one_by_one(eng, reqs)]
        assert eng.prefix_hits - hits0 == 1
    eng = engines['contiguous']
    slab = {t.untyped_storage().data_ptr()
            for t in eng.kv_tensors().values()}
    snaps = eng._prefix_store[tuple(PREFIX[:64])]
    assert len(snaps) == 2 and all(
        s.untyped_storage().data_ptr() not in slab for s in snaps)
    assert outs['contiguous'] == outs['fused']


def test_cache_traffic_counters_follow_jax(engines):
    """For the same k-step call the gather baseline books the view and
    the scatter back on top of the fused bytes (test_engine_paged.py's
    formula); the slabs book the fused bytes."""
    k = engines['fused'].step_chunk
    deltas = {}
    for lay, eng in engines.items():
        r0 = eng.metrics.cache_read.value()
        w0 = eng.metrics.cache_written.value()
        eng._count_cache_traffic(k, k)
        deltas[lay] = (eng.metrics.cache_read.value() - r0,
                       eng.metrics.cache_written.value() - w0)
    view = engines['fused']._view_bytes
    tok_writes = k * engine_lib.MAX_BATCH * engines['fused']._tok_bytes
    assert deltas['fused'] == deltas['contiguous'] == (k * view, tok_writes)
    assert deltas['gather'] == (k * view + view + tok_writes,
                                tok_writes + view)
    assert engines['contiguous']._view_bytes == view
    assert [e.attn_backend_served() for e in engines.values()] == \
        ['fused', None, 'gather']


@pytest.mark.parametrize('name', ['moe-debug', 'mla-debug'])
def test_family_contiguous_equals_jax_engine(name):
    """A grouped prefill, a 40-token prompt in one bucket prefill and a
    70-token one: the port's slabs give the JAX engine's greedy tokens
    (its warm-up and prefix cache off), and the port's gather baseline
    the same."""
    reqs = [([5, 17, 2, 99, 41], 6), ([(13 * i + 1) % 256 for i in range(40)],
                                      6), (PREFIX + [9], 6)]
    want, _ = _jax_engine_run(name, 'contiguous', reqs, warm=False)
    for layout in ('contiguous', 'gather'):
        got = _one_by_one(_port_engine(name, layout), reqs)
        for (jt, jf, jl, _), (pt, pf, pl, _) in zip(want, got):
            assert list(jt) == pt and jf == pf, layout
            np.testing.assert_allclose(pl, jl, rtol=1e-6)


def test_contiguous_warmup_admits_every_bucket(monkeypatch):
    """Warm-up admits each bucket 16 < b < max_len once: on the slabs
    every one (nothing chunks), on the pool those up to the chunk."""
    seen = {}
    for layout in ('contiguous', 'fused'):
        eng = _port_engine('llama-debug', layout, warm=False)
        seen[layout] = []
        orig = eng._admit_group

        def admit(items, orig=orig, lst=seen[layout]):
            lst.append(decode.bucket_size(len(items[0].tokens)))
            return orig(items)
        monkeypatch.setattr(eng, '_admit_group', admit)
        eng.warmup(eng.all_buckets())
        assert all(s is None for s in eng.slots)
    assert seen['contiguous'] == [16, 32, 64]
    assert seen['fused'] == [16]


def test_contiguous_replica_refuses_disagg_and_the_host_tier():
    """On the slabs: handoffs and /disagg/* answer "requires paged
    mode" (the JAX engine's words), the host tier stays off, /health
    names no free pages and /metrics no backend gauge."""
    eng = _port_engine('llama-debug', 'contiguous', kv_host_mb=64,
                       handoff_port=0)
    assert eng.host_store is None and eng.alloc is None
    meta = {'family': eng.cache_family(), 'vocab_size': 256,
            'model': eng.model_name, 'tokens': [1, 2], 'bucket': 16,
            'max_new': 4}
    assert 'requires SKYTPU_ENGINE_PAGED=1' in eng.handoff_validate(meta)
    server = engine_lib.build_app(eng)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    eng.start()
    base = f'http://127.0.0.1:{server.server_address[1]}'
    try:
        for path in ('/disagg/prefill', '/disagg/continue'):
            req = urllib.request.Request(
                base + path, data=b'{"tokens": [1, 2]}',
                headers={'Content-Type': 'application/json'})
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(req, timeout=30)
            assert err.value.code == 501
            assert 'disagg requires paged mode (SKYTPU_ENGINE_PAGED=1)' in \
                err.value.read().decode()
        with urllib.request.urlopen(base + '/health', timeout=30) as r:
            doc = json.loads(r.read())
        assert doc['status'] == 'ok' and 'kv_pages_free' not in doc
        with urllib.request.urlopen(base + '/metrics', timeout=30) as r:
            text = r.read().decode()
        assert 'skytpu_engine_attn_backend{' not in text
    finally:
        server.shutdown()
        server.server_close()
        eng.stop()
        th.join(10)


@pytest.mark.parametrize('env,value', [('SKYTPU_ENGINE_PAGED', '0'),
                                       ('SKYTPU_ENGINE_ATTN', 'gather')])
def test_layouts_are_refused_on_a_serving_mesh(monkeypatch, env, value):
    """A gang serves the fused pool alone: either layout on a mesh is
    refused by name, before any process group is made."""
    monkeypatch.setenv(env, value)
    _, _, _, tcfg, _, params, _ = _model('llama-debug')
    with pytest.raises(NotImplementedError) as err:
        engine_lib.InferenceEngine('llama-debug', cfg=tcfg, device='cpu',
                                   max_len=MAX_LEN, params=params,
                                   mesh='tensor=2')
    assert f'{env}={value}' in str(err.value)
    assert 'Queue 1 item 8' in str(err.value)


def test_gather_pool_and_int8_keep_jax_refusals(monkeypatch):
    """Set as instance attributes before warm-up, the layouts meet the
    same int8 refusals as from the environment (JAX's words)."""
    eng = _port_engine('llama-debug', 'gather', warm=False, kv_quant='int8')
    with pytest.raises(ValueError, match='incompatible with'):
        eng.warmup()
    eng = _port_engine('llama-debug', 'contiguous', warm=False,
                       kv_quant='int8')
    with pytest.raises(ValueError, match='needs paged mode'):
        eng.warmup()
