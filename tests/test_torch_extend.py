"""The prefill extends of the PyTorch port vs the JAX package, on the CPU.

  - ``decode.paged_prefill_extend`` against JAX
    ``decode.paged_prefill_extend`` on the same pool and table: row 1
    shares row 0's prefix pages, as a prefix hit does, then owns the
    suffix's pages; p ∈ {0, 64, 128} tokens of prefix, a suffix bucket
    s2 ∈ {16, 32} holding s2 - 5 real tokens; on llama-debug and on each
    switch set of tests/test_torch_gemma.py (gemma-7b, gemma2-9b's
    softcaps and a window of 8 under the prefix, gemma3-12b's local and
    global layers, gpt-oss's sinks and window). The logits and every
    page but the trash page agree within 1e-5 (fp32 on both sides,
    summation order only); the lengths exactly.
  - Inside the port: the paged extend equals ``prefill_extend`` over
    ``paging.gather_prefix`` of the same row, and four 16-token chunks
    equal one ``prefill`` (the JAX TestPrefillExtend assertions, within
    1e-5; a decode continued from an extended pool within 2e-4 of the
    teacher-forced forward, as there).
  - ``serve/engine.py::_lookup_draft`` equals the JAX engine's on
    hypothesis-drawn contexts.
"""
import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp

from skypilot_tpu.models import decode as jdecode
from skypilot_tpu.models import llama as jllama
from skypilot_tpu.models import paging as jpaging
from skypilot_tpu.serve import engine as jengine
from skypilot_tpu_torch import config
from skypilot_tpu_torch.models import decode, llama, paging, weights
from skypilot_tpu_torch.serve import engine as engine_lib

ATOL = 1e-5

GEMMA = dict(norm_plus_one=True, mlp_activation='gelu', embed_scale=True,
             tie_embeddings=True)
# The switch sets of tests/test_torch_gemma.py on llama-debug (dim 64,
# 4/2 heads, hd 16, vocab 256): windows of 8 and 6 keys, softcaps of 1.0
# and 2.0, so that each bites on a small random model.
SWITCHES = {
    'llama-debug': {},
    'gemma-7b': GEMMA,
    'gemma2-9b': dict(GEMMA, final_logit_softcap=2.0, attn_logit_softcap=1.0,
                      post_norms=True, sliding_window=8),
    'gemma3-12b': dict(GEMMA, post_norms=True, qk_norm=True, sliding_window=6,
                       sliding_window_pattern=3, local_rope_theta=10000.0,
                       rope_theta=1e6, n_layers=3),
    'gpt-oss': dict(qkv_bias=True, attn_sinks=True, swiglu_limit=7.0,
                    sliding_window=8, sliding_window_pattern=2,
                    rope_scaling=dict(rope_type='yarn', factor=2.0,
                                      original_max_position=64)),
}
# Leaves JAX initialises to zeros (or ones): random here.
_RANDOMISED = ('attn_norm', 'mlp_norm', 'post_attn_norm', 'post_mlp_norm',
               'q_norm', 'k_norm', 'sink', 'bq', 'bk', 'bv')
_MODELS = {}


def _model(name):
    """(JAX cfg, port cfg, JAX params, port params) for a switch set,
    fp32, the zero- or one-initialised leaves randomised."""
    if name not in _MODELS:
        kw = SWITCHES[name]
        jcfg = dataclasses.replace(jllama.PRESETS['llama-debug'],
                                   dtype=jnp.float32, **kw)
        tcfg = dataclasses.replace(config.PRESETS['llama-debug'],
                                   dtype=torch.float32, **kw)
        tree = jax.device_get(jllama.init_params(jax.random.PRNGKey(0),
                                                 jcfg))
        rng = np.random.default_rng(0)
        for key in _RANDOMISED:
            if key in tree['layers']:
                shape = tree['layers'][key].shape
                tree['layers'][key] = 0.3 * rng.standard_normal(
                    shape).astype(np.float32)
        tree['final_norm'] = 0.3 * rng.standard_normal(
            tree['final_norm'].shape).astype(np.float32)
        _MODELS[name] = (jcfg, tcfg, jax.tree.map(jnp.asarray, tree),
                         weights.params_from_jax(tree, tcfg, device='cpu'))
    return _MODELS[name]


PSZ = 16
MAXP = 12          # covers p = 128 plus a 32-token suffix, and more


def _shared_pool(tcfg, p, s2, seed):
    """Random pools [L, 25, 16, KH, hd] and a table whose row 1 points at
    row 0's first p / 16 pages, then at pages of its own for the suffix
    (its tail at the trash page)."""
    rng = np.random.default_rng(seed)
    n_pages = 2 * MAXP + 1
    shape = (tcfg.n_layers, n_pages, PSZ, tcfg.n_kv_heads, tcfg.hd)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    perm = rng.permutation(np.arange(1, n_pages)).astype(np.int32)
    table = np.zeros((2, MAXP), np.int32)
    table[0] = perm[:MAXP]
    table[1, :p // PSZ] = table[0, :p // PSZ]
    own = -(-s2 // PSZ)
    table[1, p // PSZ:p // PSZ + own] = perm[MAXP:MAXP + own]
    length = np.array([MAXP * PSZ - 3, 5], np.int32)
    return k, v, table, length


def _torch_pool(k, v, table, length):
    return paging.PagedKV(k=torch.from_numpy(k.copy()),
                          v=torch.from_numpy(v.copy()),
                          table=torch.from_numpy(table.copy()),
                          length=torch.from_numpy(length.copy()))


@pytest.mark.parametrize('name', list(SWITCHES))
@pytest.mark.parametrize('p,s2', [(0, 16), (0, 32), (64, 16), (64, 32),
                                  (128, 16), (128, 32)])
def test_paged_extend_matches_jax(name, p, s2):
    jcfg, tcfg, jparams, tparams = _model(name)
    k, v, table, length = _shared_pool(tcfg, p, s2, seed=p + s2)
    n = s2 - 5
    tokens = np.random.default_rng(p * 7 + s2).integers(
        0, tcfg.vocab_size, (1, s2)).astype(np.int32)
    jpc = jpaging.PagedKV(k=jnp.asarray(k), v=jnp.asarray(v),
                          table=jnp.asarray(table),
                          length=jnp.asarray(length))
    want, jpc2 = jdecode.paged_prefill_extend(
        jparams, jnp.asarray(tokens), jpc, jcfg, slot=1, p=p,
        lengths=jnp.asarray([n], jnp.int32))
    tpc = _torch_pool(k, v, table, length)
    got = decode.paged_prefill_extend(tparams, torch.from_numpy(tokens), tpc,
                                      tcfg, slot=1, p=p, lengths=n)
    assert got.shape == (1, tcfg.vocab_size) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    for t_pool, j_pool in ((tpc.k, jpc2.k), (tpc.v, jpc2.v)):
        np.testing.assert_allclose(t_pool[:, 1:].numpy(),
                                   np.asarray(j_pool)[:, 1:], atol=ATOL,
                                   rtol=0)
    np.testing.assert_array_equal(tpc.length.numpy(),
                                  np.asarray(jpc2.length))
    assert int(tpc.length[1]) == p + n
    # The shared prefix pages were read, never written.
    shared = table[1, :p // PSZ]
    np.testing.assert_array_equal(tpc.k[:, shared].numpy(), k[:, shared])


@pytest.mark.parametrize('name', ['llama-debug', 'gemma2-9b', 'gpt-oss'])
def test_paged_extend_equals_gather_formulation(name):
    """The in-place extend equals prefill_extend over gather_prefix of
    the same row: logits, and the suffix K/V it wrote into the row's
    pages."""
    _, tcfg, _, tparams = _model(name)
    p, s2, n = 64, 32, 27
    k, v, table, length = _shared_pool(tcfg, p, s2, seed=3)
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, tcfg.vocab_size, (1, s2)).astype(np.int32))
    tpc = _torch_pool(k, v, table, length)
    pre_k, pre_v = paging.gather_prefix(tpc, 1, p)
    assert pre_k.shape == (tcfg.n_layers, 1, p, tcfg.n_kv_heads, tcfg.hd)
    want, ks, vs = decode.prefill_extend(
        tparams, tokens, tcfg, p + s2, pre_k, pre_v,
        lengths=torch.tensor([n], dtype=torch.int32))
    got = decode.paged_prefill_extend(tparams, tokens, tpc, tcfg, slot=1,
                                      p=p, lengths=n)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=0)
    all_k, all_v = paging.gather_prefix(tpc, 1, p + s2)
    np.testing.assert_allclose(all_k[:, :, p:].numpy(), ks.numpy(),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(all_v[:, :, p:].numpy(), vs.numpy(),
                               atol=ATOL, rtol=0)
    np.testing.assert_array_equal(all_k[:, :, :p].numpy(), pre_k.numpy())


def _llama():
    return _model('llama-debug')[1:4:2]


def _tokens(seed, shape):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 256, shape).astype(np.int32))


def test_four_chunks_equal_one_prefill():
    """A 64-token prompt extended in four 16-token chunks over one paged
    row equals its one-shot prefill: logits and the K/V of every
    position."""
    tcfg, tparams = _llama()
    full = _tokens(1, (1, 64))
    want, ks, vs = decode.prefill(tparams, full, tcfg, 64)
    pc = decode.init_page_pool(tcfg, 6, PSZ, 1, 4, device='cpu')
    pc.table[0] = torch.tensor([3, 1, 5, 2], dtype=torch.int32)
    for pos in range(0, 64, 16):
        got = decode.paged_prefill_extend(
            tparams, full[:, pos:pos + 16], pc, tcfg, slot=0, p=pos,
            lengths=16)
        assert int(pc.length[0]) == pos + 16
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=0)
    k_all, v_all = paging.gather_prefix(pc, 0, 64)
    np.testing.assert_allclose(k_all.numpy(), ks.numpy(), atol=ATOL, rtol=0)
    np.testing.assert_allclose(v_all.numpy(), vs.numpy(), atol=ATOL, rtol=0)


def test_extend_equals_full_prefill():
    tcfg, tparams = _llama()
    full = _tokens(2, (1, 24))
    want, ks, vs = decode.prefill(tparams, full, tcfg, 48)
    _, pk, pv = decode.prefill(tparams, full[:, :16], tcfg, 16)
    got, sk, sv = decode.prefill_extend(tparams, full[:, 16:], tcfg, 48, pk,
                                        pv)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=0)
    np.testing.assert_allclose(sk.numpy(), ks[:, :, 16:].numpy(), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(sv.numpy(), vs[:, :, 16:].numpy(), atol=ATOL,
                               rtol=0)


def test_extend_then_decode_matches_forward():
    """Decoding continued from an extended paged row equals the
    teacher-forced forward: the pool holds a real cache."""
    tcfg, tparams = _llama()
    full = _tokens(3, (1, 20))
    pc = decode.init_page_pool(tcfg, 4, PSZ, 1, 3, device='cpu')
    pc.table[0] = torch.tensor([2, 3, 1], dtype=torch.int32)
    decode.paged_prefill_extend(tparams, full[:, :16], pc, tcfg, slot=0, p=0,
                                lengths=16)
    logits = decode.paged_prefill_extend(tparams, full[:, 16:], pc, tcfg,
                                         slot=0, p=16, lengths=4)
    seq = full
    for _ in range(3):
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        seq = torch.cat([seq, nxt[:, None]], dim=1)
        ref = llama.forward(tparams, seq, tcfg)[:, -1]
        logits, pc = decode.paged_decode_step(tparams, nxt, pc, tcfg,
                                              max_len=48)
        np.testing.assert_allclose(logits.numpy(), ref.numpy(), atol=2e-4,
                                   rtol=2e-4)


def test_ragged_suffix_lengths():
    tcfg, tparams = _llama()
    full = _tokens(4, (2, 22))
    _, pk, pv = decode.prefill(tparams, full[:, :16], tcfg, 16)
    got, _, _ = decode.prefill_extend(
        tparams, full[:, 16:], tcfg, 48, pk, pv,
        lengths=torch.tensor([6, 3], dtype=torch.int32))
    want0, _, _ = decode.prefill(tparams, full[:1, :22], tcfg, 48)
    want1, _, _ = decode.prefill(tparams, full[1:, :19], tcfg, 48)
    np.testing.assert_allclose(got[0].numpy(), want0[0].numpy(), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(got[1].numpy(), want1[0].numpy(), atol=ATOL,
                               rtol=0)


def test_budget_overflow_refused():
    tcfg, tparams = _llama()
    pre = torch.zeros((tcfg.n_layers, 1, 16, tcfg.n_kv_heads, tcfg.hd))
    with pytest.raises(ValueError, match='exceeds'):
        decode.prefill_extend(tparams, torch.zeros((1, 16), dtype=torch.int32),
                              tcfg, 24, pre, pre)
    # The paged extend refuses a suffix past the table's coverage by
    # name (the JAX gather would clamp it onto the row's last page).
    pc = decode.init_page_pool(tcfg, 3, PSZ, 1, 2, device='cpu')
    with pytest.raises(ValueError, match="exceeds the table's 2 pages"):
        decode.paged_prefill_extend(
            tparams, torch.zeros((1, 32), dtype=torch.int32), pc, tcfg,
            slot=0, p=16, lengths=20)


@settings(max_examples=300, deadline=None)
@given(ctx=st.lists(st.integers(0, 5), max_size=600),
       k=st.integers(1, 6))
def test_lookup_draft_matches_jax(ctx, k):
    assert engine_lib._lookup_draft(ctx, k) == jengine._lookup_draft(ctx, k)


def test_lookup_draft_cases():
    repeat = [1, 2, 3, 4, 5, 1, 2, 3, 4, 5, 1, 2, 3]
    assert engine_lib._lookup_draft(repeat, 4) == [4, 5, 1, 2]
    assert engine_lib._lookup_draft([1, 2, 3, 4], 4) is None
    # The 2-gram fallback when the 3-gram never repeats.
    assert engine_lib._lookup_draft([7, 8, 1, 9, 7, 8], 2) == [1, 9]
