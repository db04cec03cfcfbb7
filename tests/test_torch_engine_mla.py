"""The PyTorch port's engine serving the MLA/DeepSeek family on the CPU,
in fp32, vs the JAX package's ``mla.generate``.

mla-debug and deepseek-moe-debug (ample capacity: no routed token
drops in any grouping, so a chunked or bucket-padded prefill routes as
generate's one-shot prefill does) on weights bridged from JAX
``mla.init_params``, driven through ``submit`` with the batch loop
running. Greedy tokens must equal JAX's exactly: through grouped
prefills, 32-token chunks and a prefix hit over the snapshot's latent
pages; for mla-debug with speculation on (the same tokens as with it
off), for deepseek-moe-debug with speculation off (``spec_k`` 0, as
the JAX engine sets it). The assertions of
tests/unit_tests/test_engine.py (the MLA engine), test_prefix_cache.py
(the MLA family's prefix hit) and test_engine_spec.py (MLA speculates,
DeepSeekMoE does not) on the port's engine.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from skypilot_tpu.models import mla as jmla
from skypilot_tpu_torch import config
from skypilot_tpu_torch.kernels import build
from skypilot_tpu_torch.models import decode, mla, paging, weights
from skypilot_tpu_torch.serve import engine as engine_lib

MAX_LEN = 256
REF_NEW = 24
_BRIDGES = {}
_REFS = {}


def _bridge(name):
    """(JAX params, JAX cfg, port cfg, port params): preset ``name`` in
    fp32 from JAX init_params at seed 7."""
    if name not in _BRIDGES:
        jcfg = dataclasses.replace(jmla.PRESETS[name], dtype=jnp.float32)
        tcfg = dataclasses.replace(config.MLA_PRESETS[name],
                                   dtype=torch.float32)
        tree = jax.device_get(jmla.init_params(jax.random.PRNGKey(7), jcfg))
        _BRIDGES[name] = (jax.tree.map(jnp.asarray, tree), jcfg, tcfg,
                          weights.params_from_jax(tree, tcfg, device='cpu'))
    return _BRIDGES[name]


def _ref(name, prompt, n):
    """JAX mla.generate's greedy tokens for one prompt, right-padded to
    its bucket (prompt_lengths: one compile per bucket)."""
    key = (name, tuple(prompt))
    if key not in _REFS:
        jparams, jcfg, _, _ = _bridge(name)
        b = decode.bucket_size(len(prompt))
        padded = jnp.asarray([prompt + [0] * (b - len(prompt))], jnp.int32)
        _REFS[key] = np.asarray(jmla.generate(
            jparams, padded, jcfg, REF_NEW, max_len=MAX_LEN,
            prompt_lengths=jnp.asarray([len(prompt)], jnp.int32)))[0].tolist()
    assert n <= REF_NEW
    return _REFS[key][:n]


def _engine(name, **knobs):
    """A warm engine on the bridged weights with ``knobs`` set before
    warm-up and 32-token prefill chunks, its batch loop running."""
    _, _, tcfg, tparams = _bridge(name)
    eng = engine_lib.InferenceEngine(name, cfg=tcfg, device='cpu',
                                     params=tparams, max_len=MAX_LEN)
    eng.prefill_chunk = 32
    for key, val in knobs.items():
        setattr(eng, key, val)
    eng.warmup()
    eng.start()
    return eng


def _run(eng, prompts, n):
    futs = [eng.submit(p, n) for p in prompts]
    return [f.result(timeout=120) for f in futs]


@pytest.mark.parametrize('name', ['mla-debug', 'deepseek-moe-debug'])
def test_engine_greedy_tokens_match_jax_generate(name):
    """Three prompts at once (a 73-token one chunked, two grouped), then
    a prompt sharing the first one's 64-token prefix (a prefix hit over
    its latent pages): greedy tokens equal JAX mla.generate's. No
    kernel launches (the latent family has none), no page leaks."""
    eng = _engine(name)
    build.reset_launches()
    try:
        assert isinstance(eng.cache, paging.PagedLatent)
        assert eng._decode is mla and eng.cache_family() == 'paged_latent'
        rng = np.random.default_rng(8)
        prefix = rng.integers(0, 256, 64).tolist()
        first = [prefix + [5, 6, 7, 8, 9, 10, 11, 12, 13],
                 rng.integers(0, 256, 5).tolist(),
                 rng.integers(0, 256, 40).tolist()]
        hit = prefix + [9, 8, 7]
        for prompts in (first, [hit]):
            for prompt, (toks, reason, lps, _) in zip(
                    prompts, _run(eng, prompts, 8)):
                assert toks == _ref(name, prompt, 8)
                assert reason == 'length' and all(lp <= 0 for lp in lps)
    finally:
        eng.stop()
    assert eng.prefill_chunks >= 3 and eng.prefix_hits == 1
    assert eng.alloc.used_count == sum(len(v) for v in
                                       eng._prefix_store.values())
    assert all(k.launches == 0 for k in build.kernels().values())


def _repeating(name, seed_prompt):
    """A seed prompt followed by the model's own greedy continuation
    (random weights fall into loops), so that prompt lookup drafts."""
    return seed_prompt + _ref(name, seed_prompt, 16)


def test_mla_speculates_with_the_same_tokens():
    """mla-debug speculates (spec_k 4, cooldown off): speculative rounds
    run and accept, and the tokens equal JAX generate's and the same
    engine's with speculation off."""
    name = 'mla-debug'
    prompts = [_repeating(name, p) for p in
               ([1, 2, 3, 4, 5, 1, 2, 3], [9, 9, 9, 9, 9], [3, 1, 4, 1, 5])]
    outs = {}
    for spec_k in (engine_lib.SPEC_K, 0):
        eng = _engine(name, spec_k=spec_k, spec_cooldown=0)
        try:
            assert eng.spec_k == spec_k
            outs[spec_k] = [r[0] for r in _run(eng, prompts, REF_NEW)]
        finally:
            eng.stop()
        assert (eng.spec_rounds > 0) == (spec_k > 0)
        if spec_k:
            assert eng.spec_accepted > 0
            assert eng.verify_calls
    assert outs[engine_lib.SPEC_K] == outs[0]
    for p, toks in zip(prompts, outs[0]):
        assert toks == _ref(name, p, REF_NEW)


@pytest.mark.parametrize('name,want', [
    ('mla-debug', engine_lib.SPEC_K), ('deepseek-moe-debug', 0),
    ('deepseek-v2-lite', engine_lib.SPEC_K), ('deepseek-v2', 0)])
def test_spec_on_for_dense_mla_off_for_deepseek_moe(name, want):
    """As the JAX engine: a DeepSeekMoE verify would route in other
    groups than sequential steps, so it never speculates; dense MLA
    does. cache_family() names the latent pool."""
    cfg = config.get_config(name)
    if cfg.n_layers > 2:          # the engine draws no weights for these
        cfg = dataclasses.replace(cfg, n_layers=1, vocab_size=256,
                                  dim=64, n_heads=4, ffn_dim=64,
                                  kv_lora_rank=32, qk_nope_head_dim=16,
                                  qk_rope_head_dim=8, v_head_dim=16,
                                  **({'n_experts': 8}
                                     if hasattr(cfg, 'n_experts') else {}))
    eng = engine_lib.InferenceEngine(name, cfg=cfg, device='cpu')
    assert eng.spec_k == want
    assert eng.cache_family() == 'paged_latent'
    lay = eng.params['layers']
    assert all(t.dtype == cfg.dtype for t in lay.values())
    assert ('ws_gate' in lay) == (want == 0)
    assert engine_lib.InferenceEngine(
        'llama-debug', device='cpu').cache_family() == 'paged_kv'


def test_deepseek_moe_warmup_captures_no_verify():
    """A DeepSeekMoE engine warms up without a verify variant and its
    failure reset zeroes the latent pools in place."""
    eng = engine_lib.InferenceEngine(
        'deepseek-moe-debug', cfg=_bridge('deepseek-moe-debug')[2],
        params=_bridge('deepseek-moe-debug')[3], device='cpu',
        max_len=MAX_LEN)
    eng.warmup()
    assert eng.spec_k == 0 and not eng.verify_calls
    eng._admit_group([engine_lib.Request([3, 1, 4, 1, 5], 8)])
    pools = paging._pools(eng.cache)
    assert set(pools) == {'c_kv', 'k_rope'}
    assert any(bool(p.abs().sum() > 0) for p in pools.values())
    ids = [id(p) for p in pools.values()]
    eng._reset_device_state()
    assert [id(p) for p in paging._pools(eng.cache).values()] == ids
    assert all(bool((p == 0).all()) for p in pools.values())
    assert eng.alloc.used_count == 0
