"""The contiguous-cache decode family of the PyTorch port vs the JAX
package, on the CPU: ``prefill_cache``, ``verify_step``,
``decode_step``, ``_select_token``, ``generate`` and
``generate_speculative`` of models/decode.py.

JAX ``init_params`` weights bridged into the port (models/weights.py),
prompts made from a seed with numpy, fp32 on both sides. Tolerances:
TOL (2e-4, rtol and atol, JAX's own test_decode bound) wherever logits
are compared, the port against JAX or against its own full forward (a
few layers of products summed in other orders); greedy and speculative
tokens exactly; the sampled distributions' probabilities within
TOL_PROB (1e-6: the same fp32 softmax over the same kept set), never
the sampled tokens (Philox is not threefry). Covered, after JAX's
tests/unit_tests/test_decode.py (but its sharded test) and
test_speculative.py:
  - prefill into the padded cache against the full forward, the cache's
    shape and lengths; each decode step's logits against the forward at
    that position and against JAX's; writes past max_len dropped as
    JAX's scatter drops them; greedy generation against a naive
    re-run-the-prefix loop; EOS padding; ragged rows equal to solo runs;
    sampling with filters;
  - the top-k / top-p masks against JAX's, with JAX's own Gumbel noise;
  - the MoE decode at ample capacity against the MoE forward;
  - a K-wide verify equal to K single steps, speculative output equal
    to greedy for a self-draft and a weak 1-layer draft, with JAX's
    rounds, the EOS fill, the shrink of k near max_len and the fallback;
  - fp32 greedy tokens identical to JAX on llama-debug, llama-debug
    with Gemma-2's switches, moe-debug and gptoss-debug.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from skypilot_tpu.models import decode as jdecode
from skypilot_tpu.models import llama as jllama
from skypilot_tpu.models import moe as jmoe
from skypilot_tpu_torch import config
from skypilot_tpu_torch.models import decode, llama, moe, weights

TOL = 2e-4
TOL_PROB = 1e-6

# Gemma-2's switches on llama-debug, as tests/test_torch_gemma.py sets
# them: (1 + w) norms, the tanh-gelu MLP, the scaled embedding, tied
# head, post norms, both softcaps and a window shorter than the prompts.
GEMMA2 = dict(norm_plus_one=True, mlp_activation='gelu', embed_scale=True,
              tie_embeddings=True, final_logit_softcap=2.0,
              attn_logit_softcap=1.0, post_norms=True, sliding_window=8)
_RANDOMISED = ('attn_norm', 'mlp_norm', 'post_attn_norm', 'post_mlp_norm',
               'moe_norm', 'sink', 'bq', 'bk', 'bv')
_MODELS = {}


def _model(name='llama-debug', seed=0, **kw):
    """(JAX cfg, port cfg, JAX params, port params): preset ``name`` in
    fp32 with ``kw`` replaced; (1 + w) norms, sinks and biases random
    around their init, an MoE router scaled x5 (no route on a near
    tie)."""
    key = (name, seed, repr(sorted(kw.items())))
    if key not in _MODELS:
        if name in jmoe.PRESETS:
            jmod, jcfg0, tcfg0 = (jmoe, jmoe.PRESETS[name],
                                  config.MOE_PRESETS[name])
        else:
            jmod, jcfg0, tcfg0 = (jllama, jllama.PRESETS[name],
                                  config.PRESETS[name])
        jcfg = dataclasses.replace(jcfg0, dtype=jnp.float32, **kw)
        tcfg = dataclasses.replace(tcfg0, dtype=torch.float32, **kw)
        tree = jax.device_get(jmod.init_params(jax.random.PRNGKey(seed),
                                               jcfg))
        rng = np.random.default_rng(seed)
        lay = tree['layers']
        base = 0.0 if jcfg.norm_plus_one else 1.0
        for k in _RANDOMISED:
            if k in lay:
                centre = base if 'norm' in k else 0.0
                lay[k] = centre + 0.3 * rng.standard_normal(
                    lay[k].shape).astype(np.float32)
        if 'router' in lay:
            lay['router'] = 5 * np.asarray(lay['router'])
        tree['final_norm'] = base + 0.3 * rng.standard_normal(
            tree['final_norm'].shape).astype(np.float32)
        _MODELS[key] = (jcfg, tcfg, jax.tree.map(jnp.asarray, tree),
                        weights.params_from_jax(tree, tcfg, device='cpu'))
    return _MODELS[key]


def _dense():
    """llama-debug with rope scaling on, as JAX's test_decode builds it."""
    return _model(rope_scaling=dict(factor=2.0))


def _tokens(seed, *shape, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab,
                                                shape).astype(np.int32)


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=tol,
                               atol=tol)


def _forward(tp, tokens, tcfg):
    mod = moe if isinstance(tcfg, config.MoEConfig) else llama
    return mod.forward(tp, torch.as_tensor(tokens), tcfg)


# ------------------------------------------------------------------ decode

@pytest.mark.parametrize('name', ['llama-debug', 'moe-debug'])
def test_prefill_cache_matches_forward_and_jax(name):
    kw = ({'rope_scaling': dict(factor=2.0)} if name == 'llama-debug' else
          {'capacity_factor': float(config.MOE_PRESETS[name].n_experts)})
    jcfg, tcfg, jp, tp = _model(name, **kw)
    tokens = _tokens(1, 2, 10)
    last, cache = decode.prefill_cache(tp, torch.as_tensor(tokens), tcfg,
                                       max_len=32)
    _close(last, _forward(tp, tokens, tcfg)[:, -1].detach())
    jlast, jcache = jdecode.prefill(jp, jnp.asarray(tokens), jcfg,
                                    max_len=32)
    _close(last, jlast)
    assert cache.length.tolist() == [10, 10]
    assert tuple(cache.k.shape) == (tcfg.n_layers, 2, 32, tcfg.n_kv_heads,
                                    tcfg.hd)
    _close(cache.k, jcache.k)
    _close(cache.v, jcache.v)
    # The unpadded form is the same pass.
    last2, ks, vs = decode.prefill(tp, torch.as_tensor(tokens), tcfg,
                                   max_len=32)
    assert torch.equal(last, last2)
    assert torch.equal(ks, cache.k[:, :, :10])


@pytest.mark.parametrize('name', ['llama-debug', 'moe-debug'])
def test_decode_step_matches_forward_and_jax(name):
    kw = ({'rope_scaling': dict(factor=2.0)} if name == 'llama-debug' else
          {'capacity_factor': float(config.MOE_PRESETS[name].n_experts)})
    jcfg, tcfg, jp, tp = _model(name, **kw)
    tokens = _tokens(2, 2, 6)
    logits, cache = decode.prefill_cache(tp, torch.as_tensor(tokens), tcfg,
                                         max_len=32)
    jlogits, jcache = jdecode.prefill(jp, jnp.asarray(tokens), jcfg,
                                      max_len=32)
    seq = tokens
    for _ in range(5):
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        assert nxt.tolist() == np.asarray(jnp.argmax(jlogits, -1)).tolist()
        seq = np.concatenate([seq, nxt.numpy()[:, None]], axis=1)
        full = _forward(tp, seq, tcfg)[:, -1].detach()
        logits, cache = decode.decode_step(tp, nxt, cache, tcfg)
        jlogits, jcache = jdecode.decode_step(jp, jnp.asarray(nxt.numpy()),
                                              jcache, jcfg)
        _close(logits, full)
        _close(logits, jlogits)
    assert cache.length.tolist() == [11, 11]


@pytest.mark.parametrize('name', ['llama-debug', 'moe-debug'])
def test_steps_drop_writes_past_max_len(name):
    """Positions at or past max_len: JAX's scatter drops those writes,
    so the port's steps must too. A K-wide verify with one row at
    max_len - 2, one at max_len (a finished row) and one inside, then a
    decode step: logits and the whole cache against JAX's."""
    kw = ({'rope_scaling': dict(factor=2.0)} if name == 'llama-debug' else
          {'capacity_factor': float(config.MOE_PRESETS[name].n_experts)})
    jcfg, tcfg, jp, tp = _model(name, **kw)
    max_len = 16
    prompt = _tokens(5, 3, 10)
    _, cache = decode.prefill_cache(tp, torch.as_tensor(prompt), tcfg,
                                    max_len)
    _, jcache = jdecode.prefill(jp, jnp.asarray(prompt), jcfg,
                                max_len=max_len)
    length = np.array([max_len - 2, max_len, 5], np.int32)
    cache.length.copy_(torch.as_tensor(length))
    jcache = jdecode.KVCache(k=jcache.k, v=jcache.v,
                             length=jnp.asarray(length))
    toks = _tokens(6, 3, 4)
    wide, cache = decode.verify_step(tp, torch.as_tensor(toks), cache, tcfg)
    jwide, jcache = jdecode.verify_step(jp, jnp.asarray(toks), jcache, jcfg)
    _close(wide, jwide)
    _close(cache.k, jcache.k)
    _close(cache.v, jcache.v)
    lg, cache = decode.decode_step(tp, torch.as_tensor(toks[:, 0]), cache,
                                   tcfg)
    jlg, jcache = jdecode.decode_step(jp, jnp.asarray(toks[:, 0]), jcache,
                                      jcfg)
    _close(lg, jlg)
    _close(cache.k, jcache.k)
    _close(cache.v, jcache.v)
    assert cache.length.tolist() == np.asarray(jcache.length).tolist()


@pytest.mark.parametrize('name', ['llama-debug', 'moe-debug'])
def test_generate_greedy_matches_naive_loop(name):
    kw = ({'rope_scaling': dict(factor=2.0)} if name == 'llama-debug' else
          {'capacity_factor': float(config.MOE_PRESETS[name].n_experts)})
    _, tcfg, _, tp = _model(name, **kw)
    prompt = _tokens(3, 2, 8)
    got = decode.generate(tp, torch.as_tensor(prompt), tcfg, 6)
    assert tuple(got.shape) == (2, 6) and got.dtype == torch.int32
    seq = prompt
    for _ in range(6):
        nxt = torch.argmax(_forward(tp, seq, tcfg)[:, -1], dim=-1)
        seq = np.concatenate([seq, nxt.numpy()[:, None].astype(np.int32)],
                             axis=1)
    np.testing.assert_array_equal(got.numpy(), seq[:, 8:])


def test_decode_step_inactive_rows_do_not_advance():
    _, tcfg, _, tp = _dense()
    tokens = torch.as_tensor(_tokens(4, 2, 6))
    _, cache = decode.prefill_cache(tp, tokens, tcfg, max_len=16)
    active = torch.tensor([True, False])
    decode.decode_step(tp, tokens[:, 0], cache, tcfg, active=active)
    assert cache.length.tolist() == [7, 6]


def test_generate_eos_padding():
    _, tcfg, _, tp = _dense()
    prompt = torch.zeros((1, 4), dtype=torch.int32)
    out = decode.generate(tp, prompt, tcfg, 8)
    eos = int(out[0, 0])
    out2 = decode.generate(tp, prompt, tcfg, 8, eos_id=eos)
    assert (out2[0] == eos).all()
    # An EOS later in the row fills only from there on.
    eos = int(out[0, 3])
    first = int(np.flatnonzero(out[0].numpy() == eos)[0])
    out3 = decode.generate(tp, prompt, tcfg, 8, eos_id=eos)
    np.testing.assert_array_equal(out3[0, :first + 1].numpy(),
                                  out[0, :first + 1].numpy())
    assert (out3[0, first:] == eos).all()


def test_generate_sampling_runs_and_follows_its_generator():
    _, tcfg, _, tp = _dense()
    prompt = torch.zeros((2, 4), dtype=torch.int32)

    def sample(seed, **kw):
        gen = torch.Generator().manual_seed(seed)
        return decode.generate(tp, prompt, tcfg, 5, temperature=1.0,
                               generator=gen, **kw)
    out = sample(7)
    assert tuple(out.shape) == (2, 5) and int(out.max()) < tcfg.vocab_size
    assert torch.equal(out, sample(7))
    filt = sample(7, top_k=10, top_p=0.9)
    assert tuple(filt.shape) == (2, 5)
    assert int(filt.max()) < tcfg.vocab_size


def test_top_k_and_top_p_filters():
    """JAX's test: top_k=1 and a tiny nucleus degenerate to argmax;
    top-k draws stay in the row's top k, top-p draws in its nucleus."""
    logits = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (64, 256)).astype(np.float32))
    argmax = torch.argmax(logits, dim=-1)
    for kw in ({'top_k': 1}, {'top_p': 1e-6}):
        gen = torch.Generator().manual_seed(0)
        assert torch.equal(decode._select_token(logits, 1.0, gen, **kw),
                           argmax.to(torch.int32))
    top5 = torch.argsort(logits, dim=-1)[:, -5:]
    probs = torch.softmax(logits, dim=-1)
    order = torch.argsort(-logits, dim=-1)
    sp = torch.gather(probs, 1, order)
    nucleus = ((torch.cumsum(sp, -1) - sp) < 0.5).sum(-1) - 1
    for seed in range(5):
        gen = torch.Generator().manual_seed(seed)
        got = decode._select_token(logits, 1.0, gen, top_k=5)
        assert (top5 == got[:, None]).any(-1).all()
        got = decode._select_token(logits, 1.0, gen, top_p=0.5)
        rank = torch.gather(torch.argsort(order, dim=-1), 1,
                            got[:, None].long())[:, 0]
        assert (rank <= nucleus).all()
    # Greedy: temperature 0, or no generator (JAX: rng None).
    assert torch.equal(decode._select_token(logits, 0.0, gen), argmax.int())
    assert torch.equal(decode._select_token(logits, 1.0, None), argmax.int())


class _Captured:
    """Stands in for jax.random.categorical's result: keeps the logits
    JAX would sample from (``.astype`` is its caller's cast)."""

    def __init__(self, logits):
        self.logits = logits

    def astype(self, _):
        return self


@pytest.mark.parametrize('temperature,top_k,top_p', [
    (1.0, 5, None), (0.7, None, 0.5), (1.3, 20, 0.9), (1.0, None, 0.999),
    (0.5, 1, None), (2.0, 300, None)])
def test_select_token_masks_match_jax(monkeypatch, temperature, top_k,
                                      top_p):
    """The distribution _select_token samples (filter_logits with the
    same value on every row): JAX's filtered logits (captured where they
    enter jax.random.categorical) and the port's give the same
    probabilities; drawn with JAX's own Gumbel noise, the port's logits
    pick JAX's tokens."""
    rng = np.random.default_rng(11)
    logits = (2 * rng.standard_normal((16, 256))).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jdecode._select_token(jnp.asarray(logits),
                                            temperature, key, top_k, top_p))
    monkeypatch.setattr(jax.random, 'categorical',
                        lambda rng, lg, axis=-1: _Captured(lg))
    jmasked = np.asarray(jdecode._select_token(
        jnp.asarray(logits), temperature, key, top_k, top_p).logits)
    monkeypatch.undo()
    def rows(value):
        return torch.full((logits.shape[0],), value, dtype=torch.float32)
    tmasked = decode.filter_logits(torch.as_tensor(logits),
                                   rows(temperature), rows(top_k or 0),
                                   rows(1.0 if top_p is None else top_p))
    np.testing.assert_allclose(torch.softmax(tmasked, -1).numpy(),
                               np.asarray(jax.nn.softmax(jmasked, -1)),
                               rtol=0, atol=TOL_PROB)
    noise = np.array(jax.random.gumbel(key, logits.shape, jnp.float32))
    got = torch.argmax(tmasked + torch.as_tensor(noise), dim=-1)
    np.testing.assert_array_equal(got.numpy(), want)


def test_ragged_prefill_and_generate_match_solo():
    _, tcfg, _, tp = _dense()
    prompts = [[5, 6, 7], [1, 2, 3, 4, 5, 6, 7, 8], [9, 8, 7, 6, 5]]
    s = max(len(p) for p in prompts)
    padded = torch.tensor([p + [0] * (s - len(p)) for p in prompts],
                          dtype=torch.int32)
    lengths = torch.tensor([len(p) for p in prompts], dtype=torch.int32)
    ragged, cache = decode.prefill_cache(tp, padded, tcfg, max_len=32,
                                         lengths=lengths)
    assert cache.length.tolist() == [3, 8, 5]
    got = decode.generate(tp, padded, tcfg, 6, max_len=32,
                          prompt_lengths=lengths)
    for i, p in enumerate(prompts):
        solo, _ = decode.prefill_cache(tp, torch.tensor([p]), tcfg,
                                       max_len=32)
        _close(ragged[i], solo[0].numpy())
        want = decode.generate(tp, torch.tensor([p]), tcfg, 6, max_len=32)
        assert got[i].tolist() == want[0].tolist()


def test_generate_refuses_a_budget_past_max_len():
    _, tcfg, _, tp = _dense()
    with pytest.raises(ValueError, match='exceeds max_len'):
        decode.generate(tp, torch.zeros((1, 8), dtype=torch.int32), tcfg,
                        10, max_len=16)


# ------------------------------------------------------- against JAX, tokens

PRESET_CASES = {
    'llama-debug': ('llama-debug', {}),
    'llama-debug+gemma2': ('llama-debug', GEMMA2),
    'moe-debug': ('moe-debug', {}),
    'gptoss-debug': ('gptoss-debug', {}),
}


@pytest.mark.parametrize('case', list(PRESET_CASES))
def test_greedy_tokens_identical_to_jax(case):
    """fp32 greedy generate on ragged prompts longer than Gemma-2's
    window: the port's tokens are JAX's."""
    name, kw = PRESET_CASES[case]
    jcfg, tcfg, jp, tp = _model(name, **kw)
    prompt = _tokens(5, 3, 12)
    lens = np.array([12, 5, 9], np.int32)
    want = jdecode.generate(jp, jnp.asarray(prompt), jcfg, 10, max_len=32,
                            prompt_lengths=jnp.asarray(lens))
    got = decode.generate(tp, torch.as_tensor(prompt), tcfg, 10, max_len=32,
                          prompt_lengths=torch.as_tensor(lens))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------ speculative

def _weak_draft():
    """A different random model, one layer: near-zero agreement."""
    return _model(seed=7, n_layers=1)


def test_k_wide_verify_matches_k_single_steps():
    jcfg, tcfg, jp, tp = _model()
    prompt = torch.as_tensor(_tokens(1, 2, 6))
    toks = torch.as_tensor(_tokens(2, 2, 3))
    _, cache_a = decode.prefill_cache(tp, prompt, tcfg, max_len=32)
    _, cache_b = decode.prefill_cache(tp, prompt, tcfg, max_len=32)
    wide, cache_a = decode.verify_step(tp, toks, cache_a, tcfg)
    for i in range(3):
        lg, cache_b = decode.decode_step(tp, toks[:, i], cache_b, tcfg)
        _close(wide[:, i], lg.numpy())
    # verify_step does not advance length (the caller commits).
    assert cache_a.length.tolist() == [6, 6]
    _, jcache = jdecode.prefill(jp, jnp.asarray(prompt.numpy()), jcfg,
                                max_len=32)
    jwide, _ = jdecode.verify_step(jp, jnp.asarray(toks.numpy()), jcache,
                                   jcfg)
    _close(wide, jwide)


def test_self_draft_exact_with_jax_rounds():
    jcfg, tcfg, jp, tp = _model()
    prompt = _tokens(3, 2, 8)
    want = decode.generate(tp, torch.as_tensor(prompt), tcfg, 12, max_len=64)
    got, stats = decode.generate_speculative(
        tp, tcfg, tp, tcfg, torch.as_tensor(prompt), 12, k=4, max_len=64,
        return_stats=True)
    assert torch.equal(got, want)
    # 100% acceptance: ceil(11/4) = 3 rounds, not 11 single steps.
    assert stats['rounds'] <= 4, stats
    jgot, jstats = jdecode.generate_speculative(
        jp, jcfg, jp, jcfg, jnp.asarray(prompt), 12, k=4, max_len=64,
        return_stats=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jgot))
    assert stats == jstats


def test_weak_draft_still_exact_with_jax_rounds():
    jcfg, tcfg, jp, tp = _model()
    djcfg, dtcfg, djp, dtp = _weak_draft()
    for seed in (4, 5):
        prompt = _tokens(seed, 3, 7)
        want = decode.generate(tp, torch.as_tensor(prompt), tcfg, 10,
                               max_len=64)
        got, stats = decode.generate_speculative(
            tp, tcfg, dtp, dtcfg, torch.as_tensor(prompt), 10, k=3,
            max_len=64, return_stats=True)
        assert torch.equal(got, want)
        jgot, jstats = jdecode.generate_speculative(
            jp, jcfg, djp, djcfg, jnp.asarray(prompt), 10, k=3, max_len=64,
            return_stats=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jgot))
        assert stats == jstats


def test_speculative_eos_fill_matches_generate():
    _, tcfg, _, tp = _model()
    prompt = torch.as_tensor(_tokens(6, 2, 6))
    plain = decode.generate(tp, prompt, tcfg, 10, max_len=64)
    eos = int(plain[0, 3])
    want = decode.generate(tp, prompt, tcfg, 10, max_len=64, eos_id=eos)
    got = decode.generate_speculative(tp, tcfg, tp, tcfg, prompt, 10, k=4,
                                      max_len=64, eos_id=eos)
    assert torch.equal(got, want)


def test_near_limit_shrinks_k_then_falls_back():
    _, tcfg, _, tp = _model()
    prompt = torch.as_tensor(_tokens(8, 1, 8))
    want = decode.generate(tp, prompt, tcfg, 10, max_len=64)
    # budget = 20 - 18 = 2: k shrinks 4 → 1 (still speculative).
    got, stats = decode.generate_speculative(tp, tcfg, tp, tcfg, prompt, 10,
                                             k=4, max_len=20,
                                             return_stats=True)
    assert not stats.get('fallback')
    assert torch.equal(got, want)
    # budget 0: the plain-generate fallback, the same tokens.
    got2, stats2 = decode.generate_speculative(tp, tcfg, tp, tcfg, prompt,
                                               10, k=4, max_len=18,
                                               return_stats=True)
    assert stats2 == {'rounds': 10, 'fallback': True}
    assert torch.equal(got2, want)


def test_speculative_zero_max_new_tokens_and_guards():
    _, tcfg, _, tp = _model()
    _, dtcfg, _, dtp = _weak_draft()
    out = decode.generate_speculative(tp, tcfg, tp, tcfg,
                                      torch.zeros((2, 8), dtype=torch.int32),
                                      0, k=4, max_len=64)
    assert tuple(out.shape) == (2, 0)
    small = dataclasses.replace(dtcfg, vocab_size=64)
    with pytest.raises(ValueError, match='vocab'):
        decode.generate_speculative(tp, tcfg, dtp, small,
                                    torch.zeros((1, 8), dtype=torch.int32),
                                    4, max_len=64)
