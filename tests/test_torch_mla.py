"""The MLA/DeepSeek family of the PyTorch port vs the JAX package, on
the CPU.

JAX ``mla.init_params`` weights bridged into the port
(models/weights.py), inputs made from a seed with numpy, fp32 on both
sides. Tolerances: TOL (2e-4, rtol and atol) wherever the two packages
compute the same function (a few layers of products summed in other
orders); TOL_SELF (1e-5) where the port is held against itself (an
extend against a full prefill, the absorbed attention against a naive
one: the same products, other shapes). Covered:
  - the five presets field for field with ``num_params``, ``get_config``
    and ``module_for``, the refusals by name (dense switches);
  - ``init_params``' tree and the weight bridge on mla-debug and
    deepseek-moe-debug;
  - ``_attend_latent`` against a naive per-head attention and JAX's;
  - ``forward`` logits and aux;
  - ``prefill`` and the generic ``scatter_prefill`` / ``gather_prefix``
    over latent pages;
  - ``prefill_extend`` over a stored latent prefix, equal to the full
    prefill;
  - ``paged_verify_step``, ``paged_decode_step`` and
    ``paged_prefill_extend`` on the same pages;
  - a verify whose positions run past ``max_len``: dropped, as JAX's
    scatter drops them.
The norms are randomised and the router scaled up (x5), as in
tests/test_torch_moe.py, so every leaf matters and no route rests on a
near tie.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from skypilot_tpu import models as jmodels
from skypilot_tpu.models import mla as jmla
from skypilot_tpu.models import paging as jpaging
from skypilot_tpu.ops import rotary as jrotary
from skypilot_tpu_torch import config
from skypilot_tpu_torch.models import decode, mla, module_for, paging
from skypilot_tpu_torch.models import weights
from skypilot_tpu_torch.ops import rotary

TOL = 2e-4
TOL_SELF = 1e-5
NAMES = ['mla-debug', 'deepseek-moe-debug']

_RANDOMISED = ('attn_norm', 'kv_norm', 'mlp_norm', 'moe_norm')
_MODELS = {}


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=tol,
                               atol=tol)


def _model(name, seed=0):
    """(JAX cfg, port cfg, JAX params, port params, host tree): preset
    ``name`` in fp32 with randomised norms and a x5 router."""
    key = (name, seed)
    if key not in _MODELS:
        jcfg = dataclasses.replace(jmla.PRESETS[name], dtype=jnp.float32)
        tcfg = dataclasses.replace(config.MLA_PRESETS[name],
                                   dtype=torch.float32)
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
                        weights.params_from_jax(tree, tcfg, device='cpu'),
                        tree)
    return _MODELS[key]


def _tokens(rng, *shape):
    return rng.integers(0, 256, shape).astype(np.int32)


# ------------------------------------------------------------------ config

def test_mla_presets_match_jax_field_for_field():
    assert set(config.MLA_PRESETS) == set(jmla.PRESETS)
    for name, tcfg in config.MLA_PRESETS.items():
        jc = jmla.PRESETS[name]
        assert type(tcfg).__name__ == type(jc).__name__, name
        jd, td = dataclasses.asdict(jc), dataclasses.asdict(tcfg)
        for d in (jd, td):
            d.pop('dtype')
            d.pop('param_dtype')
        assert td == jd, name
        assert tcfg.num_params == jc.num_params, name
        config.check_supported(tcfg)


@pytest.mark.parametrize('name,params_b', [
    ('mla-debug', None), ('deepseek-moe-debug', None),
    ('deepseek-v2-lite', 2.607), ('deepseek-v2', 244.19), ('kimi-k2', None)])
def test_num_params_of_every_preset(name, params_b):
    """num_params equals JAX's on all five presets; deepseek-v2-lite (the
    dense variant) and deepseek-v2 (every layer routed) in billions, as
    PERF.md sizes them."""
    tcfg = config.get_config(name)
    assert tcfg.num_params == jmla.PRESETS[name].num_params
    if params_b is not None:
        assert abs(tcfg.num_params / 1e9 - params_b) < 0.01 * params_b


@pytest.mark.parametrize('name,want', [
    ('deepseek-v2-lite', 'deepseek-v2-lite'), ('DeepSeek_V2', 'deepseek-v2'),
    ('mla_debug', 'mla-debug'), ('KIMI-K2', 'kimi-k2'),
    ('deepseek_moe_debug', 'deepseek-moe-debug')])
def test_get_config_and_module_for(name, want):
    got = config.get_config(name)
    assert got is config.MLA_PRESETS[want]
    assert type(jmodels.get_config(name)).__name__ == type(got).__name__
    # A DeepSeekMoEConfig is an MLAConfig, not an MoEConfig: mla serves it.
    assert module_for(got) is mla
    assert not isinstance(got, config.MoEConfig)


@pytest.mark.parametrize('switch,val', [
    ('qk_norm', True), ('post_norms', True), ('qkv_bias', True),
    ('attn_sinks', True), ('attn_logit_softcap', 50.0),
    ('sliding_window', 32), ('final_logit_softcap', 30.0),
    ('norm_plus_one', True), ('embed_scale', True),
    ('local_rope_theta', 1e4), ('swiglu_limit', 7.0),
    ('attention_impl', 'ring'), ('pipeline_stages', 2)])
def test_dense_switches_refused_on_mla_by_name(switch, val):
    for name in NAMES:
        cfg = dataclasses.replace(config.MLA_PRESETS[name], **{switch: val})
        with pytest.raises(NotImplementedError,
                           match=switch.split('_')[0]):
            config.check_supported(cfg)
        with pytest.raises(NotImplementedError):
            mla.forward({}, torch.zeros((1, 4), dtype=torch.int32), cfg)


# ------------------------------------------------------------------ params

@pytest.mark.parametrize('name', NAMES)
def test_init_params_tree_matches_jax(name):
    jcfg = jmla.PRESETS[name]
    jshapes = jax.eval_shape(lambda k: jmla.init_params(k, jcfg),
                             jax.random.PRNGKey(0))
    tparams = mla.init_params(config.MLA_PRESETS[name],
                              torch.Generator().manual_seed(0), 'cpu')
    flat_j = {jax.tree_util.keystr(p): tuple(l.shape) for p, l in
              jax.tree_util.tree_flatten_with_path(jshapes)[0]}
    flat_t = {p: tuple(t.shape) for p, t in weights.tree_paths(tparams)}
    assert flat_t == flat_j


@pytest.mark.parametrize('name', NAMES)
def test_serving_init_is_the_fp32_init_rounded(name):
    """init_params in bf16 (drawn a layer slice at a time) is the fp32
    init cast to bf16, bit for bit."""
    cfg = config.get_config(name)
    p32 = mla.init_params(cfg, torch.Generator().manual_seed(3), 'cpu')
    p16 = mla.init_params(cfg, torch.Generator().manual_seed(3), 'cpu',
                          dtype=torch.bfloat16)
    want = decode.cast_params_for_decode(p32, cfg)
    for (path, got), (_, ref) in zip(weights.tree_paths(p16),
                                     weights.tree_paths(want)):
        assert got.dtype == torch.bfloat16, path
        assert torch.equal(got, ref), path


@pytest.mark.parametrize('name', NAMES)
def test_weight_bridge_carries_every_mla_leaf(name):
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


# ------------------------------------------------------------- attention

def _naive_attention(x, lp, cfg):
    """Materialise per-head K and V from the latent, then plain causal
    multi-head attention: the math absorption must reproduce."""
    b, s, _ = x.shape
    H, dn, dr = cfg.n_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    r, dv = cfg.kv_lora_rank, cfg.v_head_dim
    sin, cos = rotary.rope_frequencies(dr, torch.arange(s), cfg.rope_theta)
    q_nope, q_rope, c_kv, k_rope = mla._latents(x, lp, cfg, sin, cos)
    k_nope = torch.einsum('btr,rhd->bthd', c_kv, lp['w_uk'].reshape(r, H, dn))
    v = torch.einsum('btr,rhv->bthv', c_kv, lp['w_uv'].reshape(r, H, dv))
    scores = (torch.einsum('bshd,bthd->bhst', q_nope, k_nope) +
              torch.einsum('bshr,btr->bhst', q_rope, k_rope)) * \
        (dn + dr) ** -0.5
    mask = torch.ones(s, s, dtype=torch.bool).tril()
    probs = torch.softmax(scores.masked_fill(~mask, -1e30), -1)
    return torch.einsum('bhst,bthv->bshv', probs, v).reshape(b, s, H * dv)


@pytest.mark.parametrize('name', NAMES)
def test_attend_latent_matches_naive_and_jax(name):
    jcfg, tcfg, jparams, tparams, _ = _model(name)
    x = np.random.default_rng(1).standard_normal(
        (2, 10, tcfg.dim)).astype(np.float32)
    lp = {k: v[0] for k, v in tparams['layers'].items()}
    jlp = jax.tree.map(lambda a: a[0], jparams['layers'])
    sin, cos = rotary.rope_frequencies(tcfg.qk_rope_head_dim,
                                       torch.arange(10), tcfg.rope_theta)
    got = mla._attend_latent(*mla._latents(torch.from_numpy(x), lp, tcfg,
                                           sin, cos), lp, tcfg, 0)
    _close(got, _naive_attention(torch.from_numpy(x), lp, tcfg).numpy(),
           TOL_SELF)
    jsin, jcos = jrotary.rope_frequencies(jcfg.qk_rope_head_dim,
                                          jnp.arange(10), jcfg.rope_theta)
    want = jmla._attend_latent(*jmla._latents(jnp.asarray(x), jlp, jcfg,
                                              jsin, jcos), jlp, jcfg, 0)
    _close(got, want)


@pytest.mark.parametrize('name', NAMES)
def test_forward_with_aux_matches_jax(name):
    jcfg, tcfg, jparams, tparams, _ = _model(name)
    tokens = _tokens(np.random.default_rng(2), 2, 40)
    want, jaux = jmla.forward(jparams, jnp.asarray(tokens), jcfg,
                              return_aux=True)
    got, aux = mla.forward(tparams, torch.from_numpy(tokens), tcfg,
                           return_aux=True)
    _close(got, want)
    _close(aux, jaux)
    assert (float(aux) > 0) == (name == 'deepseek-moe-debug')
    np.testing.assert_array_equal(got.argmax(-1).numpy(),
                                  np.asarray(want).argmax(-1))
    _close(mla.forward(tparams, torch.from_numpy(tokens), tcfg), want)
    assert mla.HAS_AUX


# ------------------------------------------------------------- prefill

@pytest.mark.parametrize('name', NAMES)
def test_prefill_and_latent_scatter_match_jax(name):
    """A ragged prefill: logits, and its latents scattered into pages by
    the family-generic scatter_prefill, page for page; gather_prefix
    reads them back."""
    jcfg, tcfg, jparams, tparams, _ = _model(name, seed=2)
    rng = np.random.default_rng(3)
    b, s, psz, maxp = 3, 16, 8, 4
    n_pages = b * maxp + 1
    lengths = np.array([16, 9, 3], np.int32)
    tokens = _tokens(rng, b, s)
    table = (rng.permutation(np.arange(1, n_pages)).reshape(b, maxp)
             .astype(np.int32))
    slots = np.array([2, 0, 1], np.int32)
    jl, jcache = jmla.prefill(jparams, jnp.asarray(tokens), jcfg, 32,
                              lengths=jnp.asarray(lengths))
    tl, cs, krs = mla.prefill(tparams, torch.from_numpy(tokens), tcfg, 32,
                              lengths=torch.from_numpy(lengths))
    _close(tl, jl)
    _close(cs, np.asarray(jcache.c_kv)[:, :, :s])
    _close(krs, np.asarray(jcache.k_rope)[:, :, :s])
    jpool = dataclasses.replace(
        jmla.init_page_pool(jcfg, n_pages, psz, b, maxp),
        table=jnp.asarray(table))
    jpool = jpaging.scatter_prefill(jpool, jcache, jnp.asarray(slots), s,
                                    jnp.asarray(lengths))
    tpool = mla.init_page_pool(tcfg, n_pages, psz, b, maxp, device='cpu')
    tpool.table.copy_(torch.from_numpy(table))
    assert paging.scatter_prefill(tpool, cs, krs, torch.from_numpy(slots),
                                  s, torch.from_numpy(lengths)) is tpool
    _close(tpool.c_kv, jpool.c_kv)
    _close(tpool.k_rope, jpool.k_rope)
    np.testing.assert_array_equal(tpool.length.numpy(),
                                  np.asarray(jpool.length))
    c_back, kr_back = paging.gather_prefix(tpool, 2, 11)
    assert torch.equal(c_back[:, 0], cs[:, 0, :11])
    assert torch.equal(kr_back[:, 0], krs[:, 0, :11])


@pytest.mark.parametrize('name', NAMES)
def test_prefill_extend_equals_full_prefill_and_jax(name):
    """A suffix over a stored latent prefix is the full prefill's math:
    the port's extend equals its own full prefill (logits and the
    suffix's latents), and JAX's extend."""
    jcfg, tcfg, jparams, tparams, _ = _model(name, seed=4)
    full = _tokens(np.random.default_rng(5), 2, 24)
    p = 16
    want, cs, krs = mla.prefill(tparams, torch.from_numpy(full), tcfg, 48)
    _, pre_c, pre_kr = mla.prefill(tparams, torch.from_numpy(full[:, :p]),
                                   tcfg, p)
    got, c_suf, kr_suf = mla.prefill_extend(
        tparams, torch.from_numpy(full[:, p:]), tcfg, 48, pre_c, pre_kr)
    _close(got, want.numpy(), TOL_SELF)
    _close(c_suf, cs[:, :, p:].numpy(), TOL_SELF)
    _close(kr_suf, krs[:, :, p:].numpy(), TOL_SELF)
    jl, jcache = jmla.prefill_extend(
        jparams, jnp.asarray(full[:, p:]), jcfg, 48,
        jnp.asarray(pre_c.numpy()), jnp.asarray(pre_kr.numpy()))
    _close(got, jl)
    _close(c_suf, np.asarray(jcache.c_kv)[:, :, p:24])
    with pytest.raises(ValueError, match='exceeds'):
        mla.prefill_extend(tparams, torch.from_numpy(full[:, p:]), tcfg,
                           20, pre_c, pre_kr)


# ------------------------------------------------------------ paged paths

def _random_pool(rng, cfg, n_pages, psz, table, length):
    """JAX and port PagedLatent pools holding the same random latents."""
    shape = (cfg.n_layers, n_pages, psz)
    c = rng.standard_normal(shape + (cfg.kv_lora_rank,)).astype(np.float32)
    kr = rng.standard_normal(shape + (cfg.qk_rope_head_dim,)).astype(
        np.float32)
    j = jpaging.PagedLatent(c_kv=jnp.asarray(c), k_rope=jnp.asarray(kr),
                            table=jnp.asarray(table),
                            length=jnp.asarray(length))
    t = paging.PagedLatent(c_kv=torch.from_numpy(c.copy()),
                           k_rope=torch.from_numpy(kr.copy()),
                           table=torch.from_numpy(table.copy()),
                           length=torch.from_numpy(length.copy()))
    return j, t


@pytest.mark.parametrize('name', NAMES)
def test_paged_verify_and_decode_steps_match_jax(name):
    """Over the same random latent pages: a verify of 3 tokens with one
    row inactive (length unmoved), then 4 paged decode steps fed the
    JAX side's greedy tokens: logits, content pages and lengths agree;
    the inactive row wrote only the trash page."""
    jcfg, tcfg, jparams, tparams, _ = _model(name, seed=6)
    rng = np.random.default_rng(7)
    b, psz, maxp, max_len = 3, 8, 6, 48
    n_pages = b * maxp + 1
    table = (rng.permutation(np.arange(1, n_pages)).reshape(b, maxp)
             .astype(np.int32))
    length = np.array([13, 30, 4], np.int32)
    active = np.array([True, False, True])
    jpool, tpool = _random_pool(rng, tcfg, n_pages, psz, table, length)
    c0 = tpool.c_kv.clone()
    ver = _tokens(rng, b, 3)
    jv, jpool = jmla.paged_verify_step(jparams, jnp.asarray(ver), jpool,
                                       jcfg, max_len=max_len,
                                       active=jnp.asarray(active))
    tv, tpool = mla.paged_verify_step(tparams, torch.from_numpy(ver), tpool,
                                      tcfg, max_len=max_len,
                                      active=torch.from_numpy(active))
    _close(tv[active], np.asarray(jv)[active])
    np.testing.assert_array_equal(tpool.length.numpy(), length)
    tok = ver[:, -1]
    for _ in range(4):
        jl, jpool = jmla.paged_decode_step(
            jparams, jnp.asarray(tok), jpool, jcfg, max_len=max_len,
            active=jnp.asarray(active))
        tl, tpool = mla.paged_decode_step(
            tparams, torch.from_numpy(tok), tpool, tcfg, max_len=max_len,
            active=torch.from_numpy(active))
        _close(tl[active], np.asarray(jl)[active])
        tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
        np.testing.assert_array_equal(tl.argmax(-1).numpy()[active],
                                      tok[active])
    np.testing.assert_array_equal(tpool.length.numpy(),
                                  np.asarray(jpool.length))
    np.testing.assert_array_equal(tpool.length.numpy(), length + 4 * active)
    _close(tpool.c_kv[:, 1:], np.asarray(jpool.c_kv)[:, 1:])
    _close(tpool.k_rope[:, 1:], np.asarray(jpool.k_rope)[:, 1:])
    assert torch.equal(tpool.c_kv[:, table[1]], c0[:, table[1]])


@pytest.mark.parametrize('name', NAMES)
@pytest.mark.parametrize('p', [0, 24])
def test_paged_prefill_extend_matches_jax(name, p):
    """One row's 16-token suffix (13 real) over a p-token prefix on
    shuffled pages: logits, every content page and the row's length
    agree with JAX; a suffix past the table raises by name."""
    jcfg, tcfg, jparams, tparams, _ = _model(name, seed=8)
    rng = np.random.default_rng(p + 9)
    psz, maxp, s2 = 8, 6, 16
    n_pages = maxp + 1
    table = rng.permutation(np.arange(1, n_pages)).astype(np.int32)[None]
    length = np.array([p], np.int32)
    tokens = _tokens(rng, 1, s2)
    jpool, tpool = _random_pool(rng, tcfg, n_pages, psz, table, length)
    want, jpool = jmla.paged_prefill_extend(
        jparams, jnp.asarray(tokens), jpool, jcfg, slot=0, p=p,
        lengths=jnp.asarray([s2 - 3], jnp.int32))
    got = mla.paged_prefill_extend(tparams, torch.from_numpy(tokens), tpool,
                                   tcfg, slot=0, p=p, lengths=s2 - 3)
    _close(got, want)
    _close(tpool.c_kv[:, 1:], np.asarray(jpool.c_kv)[:, 1:])
    _close(tpool.k_rope[:, 1:], np.asarray(jpool.k_rope)[:, 1:])
    assert int(tpool.length[0]) == int(jpool.length[0]) == p + s2 - 3
    with pytest.raises(ValueError, match='exceeds the table'):
        mla.paged_prefill_extend(tparams, torch.from_numpy(tokens), tpool,
                                 tcfg, slot=0, p=maxp * psz - 8, lengths=4)


@pytest.mark.parametrize('name', NAMES)
def test_paged_extend_then_steps_equal_forward(name):
    """Inside the port: a paged prefill extend in two chunks, then 3
    paged decode steps, give the full forward's logits at those
    positions."""
    _, tcfg, _, tparams, _ = _model(name, seed=10)
    seq = _tokens(np.random.default_rng(11), 1, 35)
    want = mla.forward(tparams, torch.from_numpy(seq), tcfg)[0]
    pool = mla.init_page_pool(tcfg, 7, 8, 1, 6, device='cpu')
    pool.table[0] = torch.arange(1, 7, dtype=torch.int32)
    mla.paged_prefill_extend(tparams, torch.from_numpy(seq[:, :16]), pool,
                             tcfg, slot=0, p=0, lengths=16)
    got = [mla.paged_prefill_extend(tparams, torch.from_numpy(seq[:, 16:32]),
                                    pool, tcfg, slot=0, p=16, lengths=16)[0]]
    for j in range(32, 35):
        got.append(mla.paged_decode_step(
            tparams, torch.from_numpy(seq[:, j]), pool, tcfg,
            max_len=48)[0][0])
    _close(torch.stack(got), want[31:35].numpy(), TOL_SELF * 10)


@pytest.mark.parametrize('name', NAMES)
def test_verify_drops_positions_past_max_len(name):
    """A row with length + K > max_len: JAX's scatter drops the overlay
    positions at or past max_len (and clamps the page write into the
    row's last slot), so the port's step must too; every row active,
    the output of each and every content page match JAX."""
    jcfg, tcfg, jparams, tparams, _ = _model(name, seed=12)
    rng = np.random.default_rng(13)
    b, psz, maxp, k = 3, 8, 4, 4
    max_len = psz * maxp
    n_pages = b * maxp + 1
    table = np.arange(1, n_pages, dtype=np.int32).reshape(b, maxp)
    length = np.array([13, max_len - 2, 5], np.int32)
    jpool, tpool = _random_pool(rng, tcfg, n_pages, psz, table, length)
    ver = _tokens(rng, b, k)
    jv, jpool = jmla.paged_verify_step(jparams, jnp.asarray(ver), jpool,
                                       jcfg, max_len=max_len)
    tv, tpool = mla.paged_verify_step(tparams, torch.from_numpy(ver), tpool,
                                      tcfg, max_len=max_len)
    _close(tv, jv)
    _close(tpool.c_kv[:, 1:], np.asarray(jpool.c_kv)[:, 1:])
    _close(tpool.k_rope[:, 1:], np.asarray(jpool.k_rope)[:, 1:])
