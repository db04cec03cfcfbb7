"""The contiguous latent cache of the PyTorch port vs the JAX package,
on the CPU: models/mla.py ``init_cache``, ``prefill_cache``,
``verify_step``, ``decode_step`` and ``generate``.

JAX ``mla.init_params`` weights bridged into the port, norms randomised
and the router scaled x5 as in tests/test_torch_mla.py, prompts made
from a seed with numpy, fp32 on both sides. Tolerance TOL (2e-4, rtol
and atol) on logits and latents, the port against JAX or against its
own full forward (a few layers of products summed in other orders);
greedy tokens exactly. DeepSeekMoE runs at capacity for every choice
where it is held against the full forward (decode routes each token
alone and never drops).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from skypilot_tpu.models import mla as jmla
from skypilot_tpu_torch import config
from skypilot_tpu_torch.models import mla, weights

TOL = 2e-4
NAMES = ['mla-debug', 'deepseek-moe-debug']
_RANDOMISED = ('attn_norm', 'kv_norm', 'mlp_norm', 'moe_norm')
_MODELS = {}


def _model(name, ample=False, seed=0):
    """(JAX cfg, port cfg, JAX params, port params); ``ample``: capacity
    for every routed choice (DeepSeekMoE)."""
    key = (name, ample, seed)
    if key not in _MODELS:
        kw = dict(dtype=jnp.float32)
        if ample and hasattr(jmla.PRESETS[name], 'n_experts'):
            c = jmla.PRESETS[name]
            kw['capacity_factor'] = float(c.n_experts) / c.top_k
        jcfg = dataclasses.replace(jmla.PRESETS[name], **kw)
        tcfg = dataclasses.replace(config.MLA_PRESETS[name],
                                   **dict(kw, dtype=torch.float32))
        tree = jax.device_get(jmla.init_params(jax.random.PRNGKey(seed),
                                               jcfg))
        rng = np.random.default_rng(seed)
        lay = tree['layers']
        for k in _RANDOMISED:
            if k in lay:
                lay[k] = 1.0 + 0.3 * rng.standard_normal(
                    lay[k].shape).astype(np.float32)
        if 'router' in lay:
            lay['router'] = 5 * np.asarray(lay['router'])
        tree['final_norm'] = 1.0 + 0.3 * rng.standard_normal(
            tree['final_norm'].shape).astype(np.float32)
        _MODELS[key] = (jcfg, tcfg, jax.tree.map(jnp.asarray, tree),
                        weights.params_from_jax(tree, tcfg, device='cpu'))
    return _MODELS[key]


def _tokens(seed, *shape):
    return np.random.default_rng(seed).integers(0, 256,
                                                shape).astype(np.int32)


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize('name', NAMES)
def test_prefill_cache_matches_jax(name):
    jcfg, tcfg, jp, tp = _model(name)
    tokens = _tokens(1, 3, 10)
    lens = np.array([10, 4, 7], np.int32)
    logits, cache = mla.prefill_cache(tp, torch.as_tensor(tokens), tcfg, 32,
                                      lengths=torch.as_tensor(lens))
    jlogits, jcache = jmla.prefill(jp, jnp.asarray(tokens), jcfg, 32,
                                   lengths=jnp.asarray(lens))
    _close(logits, jlogits)
    _close(cache.c_kv, jcache.c_kv)
    _close(cache.k_rope, jcache.k_rope)
    assert cache.length.tolist() == [10, 4, 7]
    assert tuple(cache.c_kv.shape) == (tcfg.n_layers, 3, 32,
                                       tcfg.kv_lora_rank)
    # The engine's unpadded form is the same pass.
    logits2, cs, _ = mla.prefill(tp, torch.as_tensor(tokens), tcfg, 32,
                                 lengths=torch.as_tensor(lens))
    assert torch.equal(logits, logits2)
    assert torch.equal(cs, cache.c_kv[:, :, :10])


@pytest.mark.parametrize('name', NAMES)
def test_verify_and_decode_steps_match_jax(name):
    """A K-wide verify against JAX's (logits, written latents, length
    unchanged) and against K single steps; then decode steps against
    JAX's and against the full forward at that position."""
    jcfg, tcfg, jp, tp = _model(name, ample=True)
    prompt = _tokens(2, 2, 6)
    toks = _tokens(3, 2, 3)
    _, cache = mla.prefill_cache(tp, torch.as_tensor(prompt), tcfg, 32)
    _, jcache = jmla.prefill(jp, jnp.asarray(prompt), jcfg, 32)
    wide, cache = mla.verify_step(tp, torch.as_tensor(toks), cache, tcfg)
    jwide, jcache_w = jmla.verify_step(jp, jnp.asarray(toks), jcache, jcfg)
    _close(wide, jwide)
    _close(cache.c_kv, jcache_w.c_kv)
    assert cache.length.tolist() == [6, 6]
    _, single = mla.prefill_cache(tp, torch.as_tensor(prompt), tcfg, 32)
    for i in range(3):
        lg, single = mla.decode_step(tp, torch.as_tensor(toks[:, i]), single,
                                     tcfg)
        _close(wide[:, i], lg.numpy())
    seq = np.concatenate([prompt, toks], axis=1)
    jcache = jmla.LatentCache(c_kv=jcache_w.c_kv, k_rope=jcache_w.k_rope,
                              length=jcache_w.length + 3)
    for _ in range(3):
        nxt = np.array(jnp.argmax(jmla.forward(jp, jnp.asarray(seq),
                                               jcfg)[:, -1], -1), np.int32)
        seq = np.concatenate([seq, nxt[:, None]], axis=1)
        lg, single = mla.decode_step(tp, torch.as_tensor(nxt), single, tcfg)
        jlg, jcache = jmla.decode_step(jp, jnp.asarray(nxt), jcache, jcfg)
        _close(lg, jlg)
        _close(lg, mla.forward(tp, torch.as_tensor(seq), tcfg)[:, -1])
    assert single.length.tolist() == [12, 12]
    active = torch.tensor([False, True])
    mla.decode_step(tp, torch.as_tensor(nxt), single, tcfg, active=active)
    assert single.length.tolist() == [12, 13]


@pytest.mark.parametrize('name', NAMES)
def test_steps_drop_writes_past_max_len(name):
    """Positions at or past max_len: JAX's scatter drops those writes,
    so the port's latent steps must too. A K-wide verify with one row
    at max_len - 2, one at max_len (a finished row) and one inside, then
    a decode step: logits and the whole cache against JAX's."""
    jcfg, tcfg, jp, tp = _model(name, ample=True)
    max_len = 16
    prompt = _tokens(5, 3, 10)
    _, cache = mla.prefill_cache(tp, torch.as_tensor(prompt), tcfg, max_len)
    _, jcache = jmla.prefill(jp, jnp.asarray(prompt), jcfg, max_len)
    length = np.array([max_len - 2, max_len, 5], np.int32)
    cache.length.copy_(torch.as_tensor(length))
    jcache = jmla.LatentCache(c_kv=jcache.c_kv, k_rope=jcache.k_rope,
                              length=jnp.asarray(length))
    toks = _tokens(6, 3, 4)
    wide, cache = mla.verify_step(tp, torch.as_tensor(toks), cache, tcfg)
    jwide, jcache = jmla.verify_step(jp, jnp.asarray(toks), jcache, jcfg)
    _close(wide, jwide)
    _close(cache.c_kv, jcache.c_kv)
    _close(cache.k_rope, jcache.k_rope)
    lg, cache = mla.decode_step(tp, torch.as_tensor(toks[:, 0]), cache, tcfg)
    jlg, jcache = jmla.decode_step(jp, jnp.asarray(toks[:, 0]), jcache, jcfg)
    _close(lg, jlg)
    _close(cache.c_kv, jcache.c_kv)
    _close(cache.k_rope, jcache.k_rope)
    assert cache.length.tolist() == np.asarray(jcache.length).tolist()


@pytest.mark.parametrize('name', NAMES)
def test_greedy_tokens_identical_to_jax(name):
    """fp32 greedy generate on ragged prompts: the port's tokens are
    JAX's (each at the preset's own capacity)."""
    jcfg, tcfg, jp, tp = _model(name)
    prompt = _tokens(5, 3, 12)
    lens = np.array([12, 5, 9], np.int32)
    want = jmla.generate(jp, jnp.asarray(prompt), jcfg, 10, max_len=32,
                         prompt_lengths=jnp.asarray(lens))
    got = mla.generate(tp, torch.as_tensor(prompt), tcfg, 10, max_len=32,
                       prompt_lengths=torch.as_tensor(lens))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_ragged_rows_equal_solo_and_eos_fill():
    _, tcfg, _, tp = _model('mla-debug')
    prompts = [[5, 6, 7], [1, 2, 3, 4, 5, 6, 7, 8], [9, 8, 7, 6, 5]]
    s = max(len(p) for p in prompts)
    padded = torch.tensor([p + [0] * (s - len(p)) for p in prompts],
                          dtype=torch.int32)
    lengths = torch.tensor([len(p) for p in prompts], dtype=torch.int32)
    got = mla.generate(tp, padded, tcfg, 6, max_len=32,
                       prompt_lengths=lengths)
    for i, p in enumerate(prompts):
        want = mla.generate(tp, torch.tensor([p]), tcfg, 6, max_len=32)
        assert got[i].tolist() == want[0].tolist()
    eos = int(got[0, 0])
    filled = mla.generate(tp, padded, tcfg, 6, max_len=32,
                          prompt_lengths=lengths, eos_id=eos)
    assert (filled[0] == eos).all()


def test_sampled_generate_runs_and_follows_its_generator():
    _, tcfg, _, tp = _model('mla-debug')
    prompt = torch.zeros((2, 4), dtype=torch.int32)

    def sample(seed):
        return mla.generate(tp, prompt, tcfg, 5, temperature=0.8, top_k=10,
                            top_p=0.9,
                            generator=torch.Generator().manual_seed(seed))
    out = sample(3)
    assert tuple(out.shape) == (2, 5) and int(out.max()) < tcfg.vocab_size
    assert torch.equal(out, sample(3))
    with pytest.raises(ValueError, match='exceeds max_len'):
        mla.generate(tp, prompt, tcfg, 30, max_len=16)
