"""The MoE family (Mixtral-class and gpt-oss) of the PyTorch port vs the
JAX package, on the CPU.

JAX ``moe.init_params`` weights bridged into the port
(models/weights.py), inputs made from a seed with numpy, fp32 on both
sides; everything within 2e-4 (rtol and atol: a few layers of products
summed in other orders):
  - the presets, field for field, ``get_config``'s name normalisation
    and the ``qk_norm`` / ``post_norms`` refusals;
  - ``moe_ffn``'s output and aux with capacity binding
    (``capacity_factor`` 0.5: the same choices dropped) and ample, over
    one group, several groups and the one-group fallback; tied router
    probabilities take the lower expert first, as jax.lax.top_k does;
  - ``forward(return_aux=True)`` on moe-debug and on gptoss-debug with
    non-zero sinks;
  - the decode paths: a ragged ``prefill`` scattered into pages, a
    ``paged_prefill_extend`` at an offset with capacity binding, a
    ``paged_verify_step`` and 4 ``paged_decode_step``s;
  - the engine on the CPU: greedy tokens equal JAX ``decode.generate``'s
    through chunked prefill and a prefix hit (ample capacity, as the JAX
    tests use: a bucket-padded or chunked prefill routes in other groups
    than generate's, which only capacity drops could tell apart), and
    no speculation on an MoE engine.
The router is scaled up (x5) and the norms, sinks and biases randomised
(JAX initialises them to 1 or 0), so every leaf matters and no routing
decision rests on a near tie.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from skypilot_tpu import models as jmodels
from skypilot_tpu.models import decode as jdecode
from skypilot_tpu.models import moe as jmoe
from skypilot_tpu.models import paging as jpaging
from skypilot_tpu.parallel import sharding as jsharding
from skypilot_tpu_torch import config
from skypilot_tpu_torch.kernels import build
from skypilot_tpu_torch.models import decode, llama, module_for, moe, paging
from skypilot_tpu_torch.models import weights
from skypilot_tpu_torch.serve import engine as engine_lib

TOL = 2e-4

_RANDOMISED = ('attn_norm', 'moe_norm', 'sink', 'bq', 'bk', 'bv')
_MODELS = {}


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=TOL,
                               atol=TOL)


def _model(name, capacity_factor=None, seed=0):
    """(JAX cfg, port cfg, JAX params, port params, host tree): preset
    ``name`` in fp32, ``capacity_factor`` replaced when given."""
    key = (name, capacity_factor, seed)
    if key not in _MODELS:
        kw = dict(dtype=jnp.float32)
        if capacity_factor is not None:
            kw['capacity_factor'] = capacity_factor
        jcfg = dataclasses.replace(jmoe.PRESETS[name], **kw)
        tcfg = dataclasses.replace(config.MOE_PRESETS[name],
                                   **dict(kw, dtype=torch.float32))
        tree = jax.device_get(jmoe.init_params(jax.random.PRNGKey(seed),
                                               jcfg))
        rng = np.random.default_rng(seed)
        lay = tree['layers']
        for k in _RANDOMISED:
            if k in lay:
                lay[k] = (1.0 if 'norm' in k else 0.0) + 0.3 * \
                    rng.standard_normal(lay[k].shape).astype(np.float32)
        lay['router'] = 5 * np.asarray(lay['router'])
        tree['final_norm'] = 1.0 + 0.3 * rng.standard_normal(
            tree['final_norm'].shape).astype(np.float32)
        _MODELS[key] = (jcfg, tcfg, jax.tree.map(jnp.asarray, tree),
                        weights.params_from_jax(tree, tcfg, device='cpu'),
                        tree)
    return _MODELS[key]


# ------------------------------------------------------------------ config

def test_moe_presets_match_jax_field_for_field():
    assert set(config.MOE_PRESETS) == set(jmoe.PRESETS)
    for name, tcfg in config.MOE_PRESETS.items():
        jc = jmoe.PRESETS[name]
        jd, td = dataclasses.asdict(jc), dataclasses.asdict(tcfg)
        for d in (jd, td):
            d.pop('dtype')
            d.pop('param_dtype')
        assert td == jd, name
        assert (tcfg.hd, tcfg.num_params, tcfg.active_params) == \
            (jc.hd, jc.num_params, jc.active_params), name
        config.check_supported(tcfg)


@pytest.mark.parametrize('name,want', [
    ('gpt-oss-20b', 'gpt-oss-20b'), ('GPT_OSS-20B', 'gpt-oss-20b'),
    ('moe_1b', 'moe-1b'), ('Mixtral-8x7b', 'mixtral-8x7b'),
    ('gptoss_debug', 'gptoss-debug'), ('gpt-oss-120b', 'gpt-oss-120b'),
    ('MOE-DEBUG', 'moe-debug'), ('Llama_1B', 'llama-1b')])
def test_get_config_normalises_names_as_jax(name, want):
    got = config.get_config(name)
    assert got is {**config.PRESETS, **config.MOE_PRESETS}[want]
    assert type(jmodels.get_config(name)).__name__ == type(got).__name__
    assert module_for(got) is (moe if want in config.MOE_PRESETS else llama)


def test_get_config_refuses_an_unknown_name():
    with pytest.raises(ValueError, match='unknown model preset'):
        config.get_config('gpt-oss-7b')


@pytest.mark.parametrize('switch', ['qk_norm', 'post_norms'])
def test_dense_only_norms_refused_on_moe_by_name(switch):
    cfg = dataclasses.replace(config.MOE_PRESETS['moe-debug'],
                              **{switch: True})
    with pytest.raises(NotImplementedError, match=switch):
        config.check_supported(cfg)
    with pytest.raises(NotImplementedError, match=switch):
        moe.forward({}, torch.zeros((1, 4), dtype=torch.int32), cfg)
    config.check_supported(dataclasses.replace(
        config.PRESETS['llama-debug'], **{switch: True}))


# ------------------------------------------------------------------ params

@pytest.mark.parametrize('name', ['moe-debug', 'gptoss-debug'])
def test_init_params_tree_matches_jax(name):
    jcfg = jmoe.PRESETS[name]
    jshapes = jax.eval_shape(lambda k: jmoe.init_params(k, jcfg),
                             jax.random.PRNGKey(0))
    tparams = moe.init_params(config.MOE_PRESETS[name],
                              torch.Generator().manual_seed(0), 'cpu')
    flat_j = {jax.tree_util.keystr(p): tuple(l.shape) for p, l in
              jax.tree_util.tree_flatten_with_path(jshapes)[0]}
    flat_t = {p: tuple(t.shape) for p, t in weights.tree_paths(tparams)}
    assert flat_t == flat_j


@pytest.mark.parametrize('name', ['moe-debug', 'gptoss-debug',
                                  'llama-debug'])
def test_serving_init_is_the_fp32_init_rounded(name):
    """init_params in bf16 (the engine's serving init, drawn a layer
    slice at a time) is the fp32 init cast to bf16, bit for bit."""
    cfg = config.get_config(name)
    mod = module_for(cfg)
    p32 = mod.init_params(cfg, torch.Generator().manual_seed(3), 'cpu')
    p16 = mod.init_params(cfg, torch.Generator().manual_seed(3), 'cpu',
                          dtype=torch.bfloat16)
    want = decode.cast_params_for_decode(p32, cfg)
    for (path, got), (_, ref) in zip(weights.tree_paths(p16),
                                     weights.tree_paths(want)):
        assert got.dtype == torch.bfloat16, path
        assert torch.equal(got, ref), path


@pytest.mark.parametrize('name', ['moe-debug', 'gptoss-debug'])
def test_weight_bridge_carries_every_moe_leaf(name):
    _, tcfg, _, tparams, tree = _model(name, seed=1)
    assert [p for p, _ in weights.tree_paths(tparams)] == \
        [jax.tree_util.keystr(p) for p, _ in
         jax.tree_util.tree_flatten_with_path(tree)[0]]
    for (_, t), j in zip(weights.tree_paths(tparams),
                         jax.tree.leaves(tree)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    bad = dict(tree, layers={k: v[:1] for k, v in tree['layers'].items()})
    with pytest.raises(ValueError, match='leading dim'):
        weights.params_from_jax(bad, tcfg, device='cpu')


# ------------------------------------------------------------------ moe_ffn

@pytest.mark.parametrize('s,group', [(64, 2048), (24, 8), (20, 8)],
                         ids=['one-group', 'three-groups', 'fallback'])
@pytest.mark.parametrize('cf', [0.5, 4.0], ids=['binding', 'ample'])
def test_moe_ffn_matches_jax(cf, s, group):
    jcfg, tcfg, jparams, tparams, _ = _model('moe-debug', cf)
    jcfg = dataclasses.replace(jcfg, router_group_size=group)
    tcfg = dataclasses.replace(tcfg, router_group_size=group)
    x = np.random.default_rng(11).standard_normal(
        (2, s, tcfg.dim)).astype(np.float32)
    jlp = jax.tree.map(lambda a: a[1], jparams['layers'])
    tlp = llama.layer_params(tparams, 1)
    want, jaux = jmoe.moe_ffn(jnp.asarray(x), jlp, jcfg, jsharding.Rules())
    got, aux = moe.moe_ffn(torch.from_numpy(x), tlp, tcfg)
    _close(got, want)
    _close(aux, jaux)
    # Ample capacity drops nothing; one binding group of 64 tokens has
    # 16 slots an expert for 128 choices over 4 experts.
    gs = min(group, s)
    if s % gs:
        gs = s
    c = moe.capacity(tcfg, gs)
    assert c == jmoe.capacity(jcfg, gs)
    xg = torch.from_numpy(x).reshape(2, s // gs, gs, tcfg.dim)
    kept = int(moe.route(xg, tlp['router'], tcfg, c)[3].sum())
    if cf > 1:
        assert kept == 2 * s * tcfg.top_k
    elif gs == 64:
        assert kept <= 2 * tcfg.n_experts * c < 2 * s * tcfg.top_k


def test_tied_router_takes_the_lower_expert_first():
    """Equal probabilities (a zero router): the choices are experts 0,
    1, ..., as jax.lax.top_k orders ties; capacity then fills expert 0
    and 1's slots token by token."""
    cfg = dataclasses.replace(config.MOE_PRESETS['moe-debug'],
                              dtype=torch.float32)
    xg = torch.randn(1, 1, 12, cfg.dim)
    _, gate_w, idx, slot = moe.route(xg, torch.zeros(cfg.dim, 4), cfg, 8)
    jw, jidx = jax.lax.top_k(jnp.full((12, 4), 0.25), 2)
    assert idx[0, 0].tolist() == np.asarray(jidx).tolist()
    assert torch.equal(gate_w, torch.full_like(gate_w, 0.5))
    # Token t's choice k lands at slot t of expert k for t < 8; the
    # last four tokens are dropped from both experts.
    assert slot[0, 0, :8].sum().item() == 16
    assert slot[0, 0, 8:].sum().item() == 0
    assert torch.equal(slot[0, 0, 3, 1, 1], torch.eye(8)[3])


@pytest.mark.parametrize('name', ['moe-debug', 'gptoss-debug'])
def test_forward_with_aux_matches_jax(name):
    jcfg, tcfg, jparams, tparams, _ = _model(name)
    tokens = np.random.default_rng(2).integers(0, 256, (2, 40)).astype(
        np.int32)
    want, jaux = jmoe.forward(jparams, jnp.asarray(tokens), jcfg,
                              return_aux=True)
    got, aux = moe.forward(tparams, torch.from_numpy(tokens), tcfg,
                           return_aux=True)
    _close(got, want)
    _close(aux, jaux)
    assert float(aux) > 0
    np.testing.assert_array_equal(got.argmax(-1).numpy(),
                                  np.asarray(want).argmax(-1))
    _close(moe.forward(tparams, torch.from_numpy(tokens), tcfg), want)


# ------------------------------------------------------------- decode paths

@pytest.mark.parametrize('name,cf', [('moe-debug', 0.5), ('moe-debug', 4.0),
                                     ('gptoss-debug', None)])
def test_prefill_verify_and_paged_decode_match_jax(name, cf):
    """Ragged prefill scattered into pages, a verify of 3 tokens, then 4
    paged decode steps with one row inactive, fed the JAX side's greedy
    tokens: logits at every step and the content pages agree."""
    jcfg, tcfg, jparams, tparams, _ = _model(name, cf, seed=3)
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
    _close(tl, jl)

    ver = rng.integers(0, 256, (b, 3)).astype(np.int32)
    jv, _ = jdecode.paged_verify_step(jparams, jnp.asarray(ver), jpool, jcfg,
                                      max_len=max_len,
                                      active=jnp.asarray(active))
    tv, _ = decode.paged_verify_step(tparams, torch.from_numpy(ver), tpool,
                                     tcfg, max_len=max_len,
                                     active=torch.from_numpy(active))
    _close(tv[active], np.asarray(jv)[active])

    for _ in range(4):
        tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
        np.testing.assert_array_equal(tl.argmax(-1).numpy()[active],
                                      tok[active])
        jl, jpool = jdecode.paged_decode_step(
            jparams, jnp.asarray(tok), jpool, jcfg, max_len=max_len,
            active=jnp.asarray(active))
        tl, tpool = decode.paged_decode_step(
            tparams, torch.from_numpy(tok), tpool, tcfg, max_len=max_len,
            active=torch.from_numpy(active))
        _close(tl[active], np.asarray(jl)[active])
    np.testing.assert_array_equal(tpool.length.numpy(),
                                  np.asarray(jpool.length))
    _close(tpool.k[:, 1:], np.asarray(jpool.k)[:, 1:])
    _close(tpool.v[:, 1:], np.asarray(jpool.v)[:, 1:])


@pytest.mark.parametrize('name,cf', [('moe-debug', 0.5),
                                     ('gptoss-debug', 0.5)])
@pytest.mark.parametrize('p', [0, 32])
def test_paged_extend_at_an_offset_matches_jax(name, cf, p):
    """One row's 32-token suffix (27 real) over a p-token prefix of
    random pages, with capacity binding (8 slots an expert for 64
    choices): the logits and every content page agree, so the same
    choices were dropped."""
    jcfg, tcfg, jparams, tparams, _ = _model(name, cf, seed=5)
    rng = np.random.default_rng(p + 6)
    psz, maxp, s2 = 8, 12, 32
    n_pages = maxp + 1
    shape = (tcfg.n_layers, n_pages, psz, tcfg.n_kv_heads, tcfg.hd)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    table = rng.permutation(np.arange(1, n_pages)).astype(
        np.int32)[None]
    length = np.array([p], np.int32)
    tokens = rng.integers(0, 256, (1, s2)).astype(np.int32)
    jpc = jpaging.PagedKV(k=jnp.asarray(k), v=jnp.asarray(v),
                          table=jnp.asarray(table),
                          length=jnp.asarray(length))
    want, jpc = jdecode.paged_prefill_extend(
        jparams, jnp.asarray(tokens), jpc, jcfg, slot=0, p=p,
        lengths=jnp.asarray([s2 - 5], jnp.int32))
    tpc = paging.PagedKV(k=torch.from_numpy(k.copy()),
                         v=torch.from_numpy(v.copy()),
                         table=torch.from_numpy(table.copy()),
                         length=torch.from_numpy(length.copy()))
    got = decode.paged_prefill_extend(tparams, torch.from_numpy(tokens), tpc,
                                      tcfg, slot=0, p=p, lengths=s2 - 5)
    assert moe.capacity(tcfg, s2) == 8
    _close(got, want)
    _close(tpc.k[:, 1:], np.asarray(jpc.k)[:, 1:])
    _close(tpc.v[:, 1:], np.asarray(jpc.v)[:, 1:])
    assert int(tpc.length[0]) == int(jpc.length[0]) == p + s2 - 5


# ------------------------------------------------------------------ engine

@pytest.mark.parametrize('name', ['moe-debug', 'gptoss-debug'])
def test_engine_greedy_tokens_match_jax_generate(name):
    """The port's engine (batch loop, CPU) with 32-token prefill chunks:
    a 73-token prompt (chunked) beside two short ones, then a prompt
    sharing its 64-token prefix (a prefix hit): greedy tokens equal JAX
    decode.generate's, with ample capacity (n_experts: no drops in any
    grouping). No speculative round: spec_k is 0 on an MoE engine."""
    e = config.MOE_PRESETS[name].n_experts
    jcfg, tcfg, jparams, tparams, _ = _model(name, float(e), seed=7)
    eng = engine_lib.InferenceEngine(name, cfg=tcfg, device='cpu',
                                     params=tparams, max_len=256)
    assert eng.spec_k == 0
    eng.prefill_chunk = 32
    build.reset_launches()
    eng.warmup()
    eng.start()
    try:
        rng = np.random.default_rng(8)
        prefix = rng.integers(0, 256, 64).tolist()
        first = [prefix + [5, 6, 7, 8, 9, 10, 11, 12, 13],
                 rng.integers(0, 256, 5).tolist(),
                 rng.integers(0, 256, 40).tolist()]
        hit = prefix + [9, 8, 7]
        for prompts in (first, [hit]):
            futs = [eng.submit(t, 8) for t in prompts]
            for prompt, fut in zip(prompts, futs):
                toks, reason, _, _ = fut.result(timeout=120)
                want = jdecode.generate(
                    jparams, jnp.asarray([prompt], jnp.int32), jcfg, 8)
                assert toks == np.asarray(want)[0].tolist()
                assert reason == 'length'
    finally:
        eng.stop()
    assert eng.prefill_chunks >= 3 and eng.prefix_hits == 1
    assert eng.spec_rounds == 0 and not eng.verify_calls
    assert all(k.launches == 0 for k in build.kernels().values())


@pytest.mark.parametrize('name,want', [('moe-debug', 0), ('gptoss-debug', 0),
                                       ('llama-debug', engine_lib.SPEC_K)])
def test_spec_off_for_moe_on_for_dense(name, want):
    """As the JAX engine: capacity grouping makes an MoE verify differ
    from sequential steps, so an MoE engine never speculates."""
    eng = engine_lib.InferenceEngine(name, device='cpu')
    assert eng.spec_k == want
    params = eng.params['layers']
    assert all(t.dtype == eng.cfg.dtype for t in params.values())
    assert ('router' in params) == (name != 'llama-debug')
