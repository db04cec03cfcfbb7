"""The Gemma-2/3 and gpt-oss switches of the dense forward: the PyTorch
port vs the JAX package, on the CPU.

The same numpy-seeded inputs, or the same JAX-initialised weights
bridged into the port, go through each JAX function and its port
counterpart in fp32:
  - ops: ``rms_norm(scale_plus_one)`` and plain attention with a logit
    softcap, a window (active or not), sinks, segment ids and per-row
    offsets, within 1e-5 (fp32 on both sides, summation order only);
    the fused paged step with the same switches against JAX
    ``paged_attention_step(impl='fused')``; kernels A and B's plain
    versions at head_dim 256 against the JAX kernels in interpret mode;
  - the model: llama-debug ``dataclasses.replace``d with the switch set
    of each of gemma-7b, gemma2-9b (a window shorter than the
    sequence), gemma3-12b (pattern 3 over 3 layers, a local rope base)
    and gpt-oss's dense switches (sinks, clamped SwiGLU, yarn): the
    param tree, the weight and optimizer-state bridges, ``forward`` and
    prefill + paged decode logits within 1e-4 with identical greedy
    tokens (fp32, a few layers of products summed in other orders), and
    the engine's greedy tokens against JAX ``decode.generate``.
The switch values are the presets' but for two sizes cut to the debug
model: windows of 8 and 6 keys (the sequences are 16-48 tokens), and
softcaps of 1.0 (attention) and 2.0 (logits), so that each bites on a
model whose random logits stay small. Norm scales, sinks and biases are
random here (JAX initialises them to 0), so every leaf matters.
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
from skypilot_tpu.ops import norms as jnorms
from skypilot_tpu.ops import paged_attention as jpa
from skypilot_tpu.ops.attention import xla_attention as jxla_attention
from skypilot_tpu.ops.pallas import flash_attention as jflash
from skypilot_tpu.ops.pallas import paged_attention as jpaged
from skypilot_tpu.train import train_lib as jtrain_lib
from skypilot_tpu_torch import config
from skypilot_tpu_torch.kernels import build
from skypilot_tpu_torch.models import decode, llama, paging, weights
from skypilot_tpu_torch.ops import attention, flash_attention, norms
from skypilot_tpu_torch.ops import paged_attention
from skypilot_tpu_torch.serve import engine as engine_lib

ATOL_OPS = 1e-5
ATOL = 1e-4

GEMMA = dict(norm_plus_one=True, mlp_activation='gelu', embed_scale=True,
             tie_embeddings=True)
# Switch sets, each on llama-debug (dim 64, 4/2 heads, hd 16, vocab 256).
SWITCHES = {
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
SETS = list(SWITCHES)


def _np(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(t, j, atol=ATOL_OPS):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               atol=atol, rtol=0)


def _cfgs(name):
    kw = SWITCHES[name]
    jcfg = dataclasses.replace(jllama.PRESETS['llama-debug'],
                               dtype=jnp.float32, **kw)
    tcfg = dataclasses.replace(config.PRESETS['llama-debug'],
                               dtype=torch.float32, **kw)
    return jcfg, tcfg


# Leaves JAX initialises to zeros (or ones): random here.
_RANDOMISED = ('attn_norm', 'mlp_norm', 'post_attn_norm', 'post_mlp_norm',
               'q_norm', 'k_norm', 'sink', 'bq', 'bk', 'bv')


def _params(name, seed=0):
    """JAX init_params for the switch set, its zero- or one-initialised
    leaves replaced by random ones, and the bridge into the port."""
    jcfg, tcfg = _cfgs(name)
    tree = jax.device_get(jllama.init_params(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    for key in _RANDOMISED:
        if key in tree['layers']:
            tree['layers'][key] = 0.3 * _np(rng,
                                            *tree['layers'][key].shape)
    tree['final_norm'] = 0.3 * _np(rng, *tree['final_norm'].shape)
    jparams = jax.tree.map(jnp.asarray, tree)
    return jcfg, tcfg, tree, jparams, weights.params_from_jax(tree, tcfg,
                                                              device='cpu')


# --------------------------------------------------------------------- ops

def test_rms_norm_scale_plus_one():
    rng = np.random.default_rng(0)
    x, scale = _np(rng, 2, 5, 16), _np(rng, 16)
    _close(norms.rms_norm(torch.from_numpy(x), torch.from_numpy(scale),
                          1e-6, scale_plus_one=True),
           jnorms.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6,
                           scale_plus_one=True))


# (softcap, window, window_active, sinks, segment ids, offsets)
ATTN_CASES = {
    'softcap': (1.0, None, None, False, False, 'per_row'),
    'window': (None, 5, None, False, False, 'per_row'),
    'window_on': (None, 5, True, False, False, 'int'),
    'window_off': (None, 5, False, False, False, 'per_row'),
    'sinks': (None, None, None, True, False, 'per_row'),
    'segments': (None, None, None, False, True, 'zero'),
    'all': (2.0, 6, True, True, True, 'per_row'),
}


@pytest.mark.parametrize('case', list(ATTN_CASES))
def test_plain_attention_switches_match_xla_attention(case):
    cap, window, active, with_sinks, with_seg, offset = ATTN_CASES[case]
    rng = np.random.default_rng(3)
    b, s, t, kh, g, d = 3, 4, 24, 2, 2, 16
    q, k, v = (3 * _np(rng, b, s, kh * g, d), _np(rng, b, t, kh, d),
               _np(rng, b, t, kh, d))
    kw_t, kw_j = {}, {}
    if offset == 'per_row':
        off = np.array([0, 7, 20], np.int32)
        kw_t['q_offset'], kw_j['q_offset'] = torch.from_numpy(off), \
            jnp.asarray(off)
    elif offset == 'int':
        kw_t['q_offset'] = kw_j['q_offset'] = 9
    if with_sinks:
        sk = _np(rng, kh * g)
        kw_t['sinks'], kw_j['sinks'] = torch.from_numpy(sk), jnp.asarray(sk)
    if with_seg:
        qs = np.array([[0, 0, 1, 1]] * b, np.int32)
        ks = np.repeat(np.array([[0] * 12 + [1] * 12], np.int32), b, 0)
        kw_t['segment_ids'] = (torch.from_numpy(qs), torch.from_numpy(ks))
        kw_j['segment_ids'] = (jnp.asarray(qs), jnp.asarray(ks))
    for kw in (kw_t, kw_j):
        kw.update(logit_softcap=cap, window=window, window_active=active)
    got = attention.xla_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal=True, **kw_t)
    want = jxla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=True, **kw_j)
    _close(got, want)


def test_attention_takes_the_plain_version_for_any_switch(monkeypatch):
    """A call with a softcap, a window, sinks, segment ids or an offset
    never reaches the flash kernel, even with impl='flash' (the JAX
    gate); a trivial one does."""
    calls = []

    def fake_flash(q, k, v, **kw):
        calls.append(q.shape)
        return attention.xla_attention_lse(q, k, v, **kw)

    monkeypatch.setattr(flash_attention, 'flash_attention_lse', fake_flash)
    rng = np.random.default_rng(4)
    q, k = torch.from_numpy(_np(rng, 1, 8, 4, 16)), \
        torch.from_numpy(_np(rng, 1, 8, 2, 16))
    for kw in (dict(logit_softcap=50.0), dict(window=4),
               dict(window=4, window_active=False),
               dict(sinks=torch.zeros(4)), dict(q_offset=3),
               dict(segment_ids=(torch.zeros(1, 8), torch.zeros(1, 8)))):
        assert not attention.is_trivial(
            **{k_: v for k_, v in kw.items() if k_ != 'window_active'})
        attention.attention(q, k, k, impl='flash', **kw)
    assert calls == []
    attention.attention(q, k, k, impl='flash')
    assert len(calls) == 1


def test_paged_kernel_gate_matches_jax_pallas_ok():
    """Kernel B takes exactly what the JAX kernel's guard takes: no
    softcap, no window (a global layer's inactive one included), no
    sinks."""
    assert paged_attention.kernel_takes()
    for kw in (dict(logit_softcap=50.0), dict(window=4096),
               dict(sinks=torch.zeros(4))):
        assert not paged_attention.kernel_takes(**kw)


def _pool(seed, s, n_pages=12, psz=8, kh=2, hd=16, maxp=4):
    rng = np.random.default_rng(seed)
    kp, vp = _np(rng, n_pages, psz, kh, hd), _np(rng, n_pages, psz, kh, hd)
    length = np.array([13, 0, 27 - s, 5], np.int32)
    perm = rng.permutation(np.arange(1, n_pages))
    table = np.zeros((len(length), maxp), np.int32)
    used = 0
    for r, n in enumerate(length):
        need = min(-(-(int(n) + s) // psz), maxp)
        table[r, :need] = perm[used:used + need]
        used += need
    return rng, kp, vp, table, length


@pytest.mark.parametrize('case', ['softcap', 'window', 'window_off',
                                  'sinks', 'all'])
@pytest.mark.parametrize('s', [1, 4])
def test_paged_step_switches_match_jax_fused(case, s):
    """The port's step with softcap/window/sinks (the fused formulation,
    in place) vs JAX paged_attention_step(impl='fused'): output and
    every content page."""
    cap, window, active, with_sinks, _, _ = ATTN_CASES[case]
    rng, kp, vp, table, length = _pool(9 + s, s)
    b = len(length)
    q = 3 * _np(rng, b, s, 4, 16)
    k_new, v_new = _np(rng, b, s, 2, 16), _np(rng, b, s, 2, 16)
    sk = _np(rng, 4) if with_sinks else None
    active_rows = np.array([True, True, False, True])
    max_len = table.shape[1] * kp.shape[1]
    jcache = jpaging.PagedKV(k=jnp.asarray(kp)[None], v=jnp.asarray(vp)[None],
                             table=jnp.asarray(table),
                             length=jnp.asarray(length))
    jpos = jnp.asarray(length)[:, None] + jnp.arange(s)
    jpid, joff = jpaging._write_indices(jcache, jpos,
                                        jnp.asarray(active_rows))
    jout, jkp, jvp = jpa.paged_attention_step(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(length), jnp.asarray(k_new), jnp.asarray(v_new), jpid,
        joff, max_len=max_len, impl='fused', logit_softcap=cap,
        window=window, window_active=active,
        sinks=None if sk is None else jnp.asarray(sk))
    tkp, tvp = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    tcache = paging.PagedKV(k=tkp[None], v=tvp[None],
                            table=torch.from_numpy(table),
                            length=torch.from_numpy(length))
    tpos = tcache.length[:, None].long() + torch.arange(s)
    pid, off = paging._write_indices(tcache, tpos,
                                     torch.from_numpy(active_rows))
    out, kp2, vp2 = paged_attention.paged_attention_step(
        torch.from_numpy(q), tkp, tvp, tcache.table, tcache.length,
        torch.from_numpy(k_new), torch.from_numpy(v_new), pid, off,
        max_len=max_len, logit_softcap=cap, window=window,
        window_active=active,
        sinks=None if sk is None else torch.from_numpy(sk))
    assert kp2 is tkp and vp2 is tvp
    _close(out, jout)
    np.testing.assert_array_equal(kp2.numpy()[1:], np.asarray(jkp)[1:])
    np.testing.assert_array_equal(vp2.numpy()[1:], np.asarray(jvp)[1:])


@pytest.mark.parametrize('causal', [True, False])
def test_flash_plain_version_matches_jax_kernel_at_256(causal):
    """Kernel A's plain version vs the JAX flash kernel (interpret) at
    gemma's head_dim 256 (the JAX gate takes any multiple of 128)."""
    rng = np.random.default_rng(5)
    b, s, kh, g, d = 1, 128, 2, 1, 256
    q, k, v = (_np(rng, b, s, kh * g, d), _np(rng, b, s, kh, d),
               _np(rng, b, s, kh, d))
    o, lse = flash_attention.flash_attention_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal)
    jo, jlse = jflash.flash_attention_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        interpret=True, block_q=128, block_k=128)
    _close(o, jo)
    _close(lse, jlse)


@pytest.mark.parametrize('g,s', [(1, 1), (2, 4), (2, 8)])
def test_paged_plain_version_matches_jax_kernel_at_256(g, s):
    """Kernel B's plain version vs the JAX paged kernel (interpret) at
    head_dim 256: gemma-7b's g = 1 decode, gemma2-9b's g = 2 verify."""
    rng, kp, vp, table, length = _pool(7 + s, s, hd=256)
    q = _np(rng, len(length), s, 2 * g, 256)
    got = paged_attention.paged_decode_attention_ref(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(table), torch.from_numpy(length))
    want = jpaged.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(table), jnp.asarray(length), interpret=True)
    _close(got, want)


def test_kernel_b_workspace_at_256():
    """A partial at head_dim 256 holds 256 output floats, a max and a
    sum; the split aims at fewer blocks an SM (one fits, not two)."""
    assert paged_attention.workspace_sizes(8, 16, 1, 3, 256) == \
        (8 * 16 * 3 * 4 * 1 * (256 + 2), 8 * 16)
    assert paged_attention.split_pages(8, 16, 32, 132, 256) == (3, 11)
    assert paged_attention.split_pages(8, 16, 32, 132, 128) == (5, 7)


@pytest.mark.parametrize('d,on_card,grad,refused', [
    (256, True, True, False), (256, True, False, False),
    (256, False, True, False), (128, True, True, False),
    (64, True, True, False), (96, True, True, True)])
def test_flash_backward_refused_up_front_at_256(d, on_card, grad, refused):
    """Kernels C and D take head_dim 256 as kernel A does, so a call
    there that wants a gradient runs; on the card a head dim C and D do
    not take is refused before any launch when a gradient is wanted."""
    assert flash_attention.backward_refused(d, on_card, grad) is refused


def test_flash_at_256_with_grad_runs_on_the_cpu():
    """Off the card the backward is the plain version, which takes any
    head_dim: no refusal, and the grads are finite."""
    rng = np.random.default_rng(6)
    q = torch.from_numpy(_np(rng, 1, 6, 2, 256)).requires_grad_()
    k = torch.from_numpy(_np(rng, 1, 6, 2, 256))
    o = flash_attention.flash_attention(q, k, k)
    o.sum().backward()
    assert q.grad.isfinite().all()


# ------------------------------------------------------------------- model

@pytest.mark.parametrize('name', SETS)
def test_init_params_tree_matches_jax(name):
    jcfg, tcfg = _cfgs(name)
    jshapes = jax.eval_shape(
        lambda k: jllama.init_params(k, jcfg), jax.random.PRNGKey(0))
    tparams = llama.init_params(tcfg, torch.Generator().manual_seed(0),
                                'cpu')
    flat_j = {jax.tree_util.keystr(p): tuple(l.shape) for p, l in
              jax.tree_util.tree_flatten_with_path(jshapes)[0]}
    flat_t = {jax.tree_util.keystr(p): tuple(l.shape) for p, l in
              jax.tree_util.tree_flatten_with_path(tparams)[0]}
    assert flat_t == flat_j
    if tcfg.norm_plus_one:     # (1 + w) norms start at w = 0
        assert not tparams['layers']['attn_norm'].any()
        assert not tparams['final_norm'].any()


@pytest.mark.parametrize('name', SETS)
def test_weight_and_optimizer_bridges_carry_every_leaf(name):
    """params_from_jax and opt_state_from_jax carry every leaf of the
    switch set's tree (the new norms, q/k norms and sinks among them)
    exactly, by the JAX checkpoint path."""
    jcfg, tcfg, tree, jparams, tparams = _params(name, seed=1)
    assert [p for p, _ in weights.tree_paths(tparams)] == \
        [jax.tree_util.keystr(p) for p, _ in
         jax.tree_util.tree_flatten_with_path(tree)[0]]
    for (_, t), j in zip(weights.tree_paths(tparams),
                         jax.tree.leaves(tree)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    jtx = jtrain_lib.default_optimizer(warmup_steps=2, total_steps=10)
    rng = np.random.default_rng(2)
    grads = jax.tree.map(lambda a: jnp.asarray(_np(rng, *a.shape)), jparams)
    opt = jtx.init(jparams)
    _, opt = jtx.update(grads, opt, jparams)
    opt = jax.device_get(opt)
    count, mu, nu = weights.opt_state_from_jax(opt, tcfg, 'cpu')
    assert count == 1
    adam = opt[1][0]
    for got, want in ((mu, adam.mu), (nu, adam.nu)):
        for (_, t), j in zip(weights.tree_paths(got),
                             jax.tree.leaves(want)):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize('name', SETS)
def test_forward_matches_jax(name):
    jcfg, tcfg, _, jparams, tparams = _params(name)
    tokens = np.random.default_rng(2).integers(0, 256, (2, 24)).astype(
        np.int32)
    want = jllama.forward(jparams, jnp.asarray(tokens), jcfg)
    got = llama.forward(tparams, torch.from_numpy(tokens), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    np.testing.assert_array_equal(got.argmax(-1).numpy(),
                                  np.asarray(want).argmax(-1))
    hid = llama.forward(tparams, torch.from_numpy(tokens), tcfg,
                        return_hidden=True)
    jhid = jllama.forward(jparams, jnp.asarray(tokens), jcfg,
                          return_hidden=True)
    np.testing.assert_allclose(hid.numpy(), np.asarray(jhid), atol=ATOL,
                               rtol=0)


def test_embed_scale_rounds_the_factor_to_the_compute_dtype():
    """sqrt(3072) = 55.43 becomes 55.5 in bf16 before the multiply, as
    jnp.asarray(dim ** 0.5, cfg.dtype) gives: bf16 embeddings scaled on
    both sides agree bit for bit (a factor left in fp32 would round
    some products differently)."""
    cfg = dataclasses.replace(config.PRESETS['gemma-7b'], n_layers=1,
                              vocab_size=512)
    table = np.random.default_rng(9).standard_normal(
        (512, cfg.dim)).astype(np.float32)
    got = llama.embed({'embed': torch.from_numpy(table)},
                      torch.arange(512)[None], cfg)
    want = jnp.asarray(table).astype(jnp.bfloat16) * jnp.asarray(
        cfg.dim ** 0.5, jnp.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got[0].float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize('name', SETS)
def test_prefill_and_paged_decode_match_jax(name):
    """Ragged grouped prefill scattered into pages, then 6 paged decode
    steps with one row inactive, fed the JAX side's greedy tokens:
    logits agree at every step and so do the greedy tokens."""
    jcfg, tcfg, _, jparams, tparams = _params(name, seed=3)
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
        np.testing.assert_array_equal(tl.argmax(-1).numpy()[active],
                                      tok[active])
        jl, jpool = jdecode.paged_decode_step(
            jparams, jnp.asarray(tok), jpool, jcfg, max_len=max_len,
            active=jnp.asarray(active))
        tl, tpool = decode.paged_decode_step(
            tparams, torch.from_numpy(tok), tpool, tcfg, max_len=max_len,
            active=torch.from_numpy(active))
        np.testing.assert_allclose(tl.numpy()[active],
                                   np.asarray(jl)[active], atol=ATOL,
                                   rtol=0)
    np.testing.assert_allclose(tpool.k.numpy()[:, 1:],
                               np.asarray(jpool.k)[:, 1:], atol=ATOL, rtol=0)


@pytest.mark.parametrize('name', ['gemma2-9b', 'gemma3-12b'])
def test_engine_greedy_tokens_match_jax_generate(name):
    """The port's engine (its batch loop, CPU) on a windowed Gemma
    switch set: greedy tokens for three concurrent prompts of different
    buckets, longer than the window, equal JAX decode.generate's."""
    jcfg, tcfg, _, jparams, tparams = _params(name, seed=7)
    eng = engine_lib.InferenceEngine(name, cfg=tcfg, device='cpu',
                                     params=tparams)
    build.reset_launches()
    eng.start()
    try:
        rng = np.random.default_rng(8)
        prompts = [rng.integers(0, 256, n).tolist() for n in (5, 20, 40)]
        futs = [eng.submit(p, 8) for p in prompts]
        for prompt, fut in zip(prompts, futs):
            toks, reason, _, _ = fut.result(timeout=120)
            want = jdecode.generate(jparams, jnp.asarray([prompt], jnp.int32),
                                    jcfg, 8)
            assert toks == np.asarray(want)[0].tolist()
            assert reason == 'length'
    finally:
        eng.stop()
    assert all(k.launches == 0 for k in build.kernels().values())
