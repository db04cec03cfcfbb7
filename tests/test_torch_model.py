"""PyTorch port model path vs the JAX package, on the CPU, on bridged
weights: the dense forward, and prefill + paged decode steps.

Both sides run llama-debug in fp32 (dataclasses.replace of the preset).
Tolerance 1e-4 absolute on logits: fp32 on both sides, two layers of
matrix products summed in different orders.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from skypilot_tpu.models import decode as jdecode
from skypilot_tpu.models import llama as jllama
from skypilot_tpu.models import paging as jpaging
from skypilot_tpu_torch import config
from skypilot_tpu_torch.models import decode, llama, paging, weights

ATOL = 1e-4


def _cfgs(**kw):
    jcfg = dataclasses.replace(jllama.PRESETS['llama-debug'],
                               dtype=jnp.float32, **kw)
    tcfg = dataclasses.replace(config.PRESETS['llama-debug'],
                               dtype=torch.float32, **kw)
    return jcfg, tcfg


def _params(jcfg, tcfg, seed=0):
    """JAX init_params, with random q/k/v biases when the config has
    them (init makes them zero), and their bridge into the port."""
    tree = jax.device_get(jllama.init_params(jax.random.PRNGKey(seed), jcfg))
    if jcfg.qkv_bias:
        rng = np.random.default_rng(seed)
        for key in ('bq', 'bk', 'bv'):
            tree['layers'][key] = rng.standard_normal(
                tree['layers'][key].shape).astype(np.float32)
    jparams = jax.tree.map(jnp.asarray, tree)
    return jparams, weights.params_from_jax(tree, tcfg, device='cpu')


def test_presets_match_jax_field_for_field():
    assert set(config.PRESETS) == set(jllama.PRESETS)
    for name, tcfg in config.PRESETS.items():
        jd = dataclasses.asdict(jllama.PRESETS[name])
        td = dataclasses.asdict(tcfg)
        for d in (jd, td):
            d.pop('dtype')
            d.pop('param_dtype')
        assert td == jd, name
        assert tcfg.hd == jllama.PRESETS[name].hd
        assert tcfg.num_params == jllama.PRESETS[name].num_params


@pytest.mark.parametrize('name', ['gemma-7b', 'gemma2-9b', 'gemma3-12b'])
def test_unported_switches_refused(name):
    cfg = config.PRESETS[name]
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        config.check_supported(cfg)
    with pytest.raises(NotImplementedError):
        llama.init_params(dataclasses.replace(cfg, n_layers=1, dim=8,
                                              vocab_size=8, ffn_dim=8,
                                              n_heads=1, n_kv_heads=1,
                                              head_dim=8),
                          torch.Generator().manual_seed(0), 'cpu')


@pytest.mark.parametrize('qkv_bias', [False, True])
def test_init_params_tree_matches_jax(qkv_bias):
    jcfg, tcfg = _cfgs(qkv_bias=qkv_bias, tie_embeddings=not qkv_bias)
    jshapes = jax.eval_shape(
        lambda k: jllama.init_params(k, jcfg), jax.random.PRNGKey(0))
    tparams = llama.init_params(tcfg, torch.Generator().manual_seed(0),
                                'cpu')
    flat_j = {jax.tree_util.keystr(p): tuple(l.shape) for p, l in
              jax.tree_util.tree_flatten_with_path(jshapes)[0]}
    flat_t = {jax.tree_util.keystr(p): tuple(l.shape) for p, l in
              jax.tree_util.tree_flatten_with_path(tparams)[0]}
    assert flat_t == flat_j


def test_weight_bridge_keeps_orientation_and_checks_depth():
    jcfg, tcfg = _cfgs()
    tree = jax.device_get(jllama.init_params(jax.random.PRNGKey(1), jcfg))
    p = weights.params_from_jax(tree, tcfg, device='cpu',
                                dtype=torch.bfloat16)
    assert p['layers']['wq'].shape == (2, 64, 64)       # [L, in, out]
    assert p['layers']['w_down'].shape == (2, 128, 64)
    assert p['layers']['wq'].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        p['layers']['w_up'].float().numpy(),
        torch.from_numpy(tree['layers']['w_up'].copy()).bfloat16().float()
        .numpy())
    tree['layers']['wq'] = tree['layers']['wq'][:1]
    with pytest.raises(ValueError, match='leading dim'):
        weights.params_from_jax(tree, tcfg, device='cpu')


@pytest.mark.parametrize('qkv_bias', [False, True])
def test_forward_matches_jax(qkv_bias):
    jcfg, tcfg = _cfgs(qkv_bias=qkv_bias)
    jparams, tparams = _params(jcfg, tcfg)
    tokens = np.random.default_rng(2).integers(0, 256, (2, 24)).astype(
        np.int32)
    want = jllama.forward(jparams, jnp.asarray(tokens), jcfg)
    got = llama.forward(tparams, torch.from_numpy(tokens), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    hid = llama.forward(tparams, torch.from_numpy(tokens), tcfg,
                        return_hidden=True)
    jhid = jllama.forward(jparams, jnp.asarray(tokens), jcfg,
                          return_hidden=True)
    np.testing.assert_allclose(hid.numpy(), np.asarray(jhid), atol=ATOL,
                               rtol=0)


def test_prefill_and_paged_decode_match_jax():
    """Ragged grouped prefill scattered into pages, then 6 paged decode
    steps with one row inactive (its writes on the trash page), fed the
    JAX side's greedy tokens: logits agree at every step."""
    jcfg, tcfg = _cfgs(qkv_bias=True)
    jparams, tparams = _params(jcfg, tcfg, seed=3)
    rng = np.random.default_rng(4)
    b, s, psz, max_len = 3, 16, 8, 64
    lengths = np.array([16, 9, 3], np.int32)
    tokens = rng.integers(0, 256, (b, s)).astype(np.int32)
    maxp = max_len // psz
    n_pages = b * maxp + 1
    table = (rng.permutation(np.arange(1, n_pages)).reshape(b, maxp)
             .astype(np.int32))
    slots = np.arange(b, dtype=np.int32)
    active = np.array([True, False, True])

    jl, rows = jdecode.prefill(jparams, jnp.asarray(tokens), jcfg, max_len,
                               lengths=jnp.asarray(lengths))
    jpool = dataclasses.replace(
        jdecode.init_page_pool(jcfg, n_pages, psz, b, maxp),
        table=jnp.asarray(table))
    jpool = jpaging.scatter_prefill(jpool, rows, jnp.asarray(slots), s,
                                    jnp.asarray(lengths))

    tl, ks, vs = decode.prefill(tparams, torch.from_numpy(tokens), tcfg,
                                max_len, lengths=torch.from_numpy(lengths))
    tpool = decode.init_page_pool(tcfg, n_pages, psz, b, maxp, device='cpu')
    tpool.table.copy_(torch.from_numpy(table))
    paging.scatter_prefill(tpool, ks, vs, torch.from_numpy(slots), s,
                           torch.from_numpy(lengths))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)

    for _ in range(6):
        tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
        jl, jpool = jdecode.paged_decode_step(
            jparams, jnp.asarray(tok), jpool, jcfg, max_len=max_len,
            active=jnp.asarray(active))
        tl, tpool = decode.paged_decode_step(
            tparams, torch.from_numpy(tok), tpool, tcfg, max_len=max_len,
            active=torch.from_numpy(active))
        np.testing.assert_allclose(tl.numpy()[active],
                                   np.asarray(jl)[active], atol=ATOL,
                                   rtol=0)
        np.testing.assert_array_equal(tpool.length.numpy(),
                                      np.asarray(jpool.length))
    # Content pages (not the trash page) hold the same K/V.
    np.testing.assert_allclose(tpool.k.numpy()[:, 1:],
                               np.asarray(jpool.k)[:, 1:], atol=ATOL, rtol=0)
