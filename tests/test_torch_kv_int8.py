"""int8 K/V page pools (``SKYTPU_ENGINE_KV_QUANT=int8``) of the port
against the JAX package, on the CPU.

Inputs are made from numpy seeds; the models are the debug presets in
fp32 on weights bridged from JAX ``init_params``. Covered:

  * ``quantize_values`` / ``dequantize_values``: codes and scales
    bit-equal to JAX's over mixed magnitudes, zero vectors and exact .5
    ties; the round trip within JAX's scale / 2 bound;
  * the pools: shapes and dtypes of both families' sidecars, fp pools
    without them; ``export_pages`` / ``import_pages`` bit-identical in
    both families and both modes (JAX ``TestInt8Quantization``);
  * ``paged_attention_step`` with scales against JAX's: out within
    TOL_STEP, written scales within TOL_SCALE relative, written codes
    equal but for at most CODE_FLIP_SHARE off by one (fp32 K/V rounding
    at a .5 boundary); the route: kernel B is never asked for on an
    int8 pool (JAX's ``k_scale is None`` gate);
  * ``paged_prefill_extend``, ``paged_verify_step`` and
    ``paged_decode_step`` of llama-debug, moe-debug and mla-debug on
    int8 pools: logits within TOL_LOGITS of JAX's;
  * JAX's quality protocol (bench.py ``_quality_family``): the port's
    int8 NLL within TOL_NLL of JAX's int8 NLL and its greedy tokens
    equal; against the port's fp pool, JAX's bands;
  * the engine on int8 pools (llama-debug, moe-debug, mla-debug):
    greedy tokens equal to the JAX engine's int8 tokens through grouped
    prefill, 16-token chunks, a prefix hit and speculation; spill and
    wake bit-identical; a disagg handoff int8→int8, int8→fp and
    fp→int8 equal to JAX's functions, the adopter's pages bit-equal to
    JAX ``adopt_rows``'s; the JAX combination refusals; /health and
    /metrics.
"""
import dataclasses
import json
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from skypilot_tpu.models import decode as jdecode
from skypilot_tpu.models import llama as jllama
from skypilot_tpu.models import mla as jmla
from skypilot_tpu.models import moe as jmoe
from skypilot_tpu.models import paging as jpaging
from skypilot_tpu.ops import paged_attention as jpa
from skypilot_tpu_torch import config
from skypilot_tpu_torch.models import decode, mla, paging, quality, weights
from skypilot_tpu_torch.ops import paged_attention as pa
from test_torch_disagg import TARGET, _http
from test_torch_kv_hierarchy import _idle, _on_loop

TOL_STEP = 1e-5
TOL_SCALE = 1e-6
CODE_FLIP_SHARE = 1e-3
TOL_LOGITS = 1e-4
TOL_NLL = 1e-4
FAMILIES = ['llama-debug', 'moe-debug', 'mla-debug']
_MODELS = {}


def _model(name, seed=0):
    """(JAX module, port module, JAX cfg, port cfg, JAX params, port
    params, host tree) of debug preset ``name`` in fp32; the norms
    randomised and an MoE router scaled x5, as the family tests do, so
    no route rests on a near tie."""
    key = (name, seed)
    if key not in _MODELS:
        if name.startswith('mla'):
            jmod, tmod = jmla, mla
            jcfg, tcfg = jmla.PRESETS[name], config.MLA_PRESETS[name]
            init = jmla.init_params
        elif name.startswith('moe'):
            jmod, tmod = jdecode, decode
            jcfg, tcfg = jmoe.PRESETS[name], config.MOE_PRESETS[name]
            init = jmoe.init_params
        else:
            jmod, tmod = jdecode, decode
            jcfg, tcfg = jllama.PRESETS[name], config.PRESETS[name]
            init = jllama.init_params
        jcfg = dataclasses.replace(jcfg, dtype=jnp.float32)
        tcfg = dataclasses.replace(tcfg, dtype=torch.float32)
        tree = jax.device_get(init(jax.random.PRNGKey(seed), jcfg))
        rng = np.random.default_rng(seed)
        lay = tree['layers']
        for k in lay:
            if 'norm' in k:
                lay[k] = 1.0 + 0.3 * rng.standard_normal(
                    lay[k].shape).astype(np.float32)
        if 'router' in lay:
            lay['router'] = 5 * np.asarray(lay['router'])
        _MODELS[key] = (jmod, tmod, jcfg, tcfg,
                        jax.tree.map(jnp.asarray, tree),
                        weights.params_from_jax(tree, tcfg, device='cpu'),
                        tree)
    return _MODELS[key]


def _close(t, j, tol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=tol,
                               atol=tol)


# ------------------------------------------------------------ quantization

def _mixed(seed):
    """Vectors of mixed magnitudes (1e-3 .. 1e3 a vector): the per-vector
    scale must adapt."""
    rng = np.random.default_rng(seed)
    mags = 10.0 ** rng.uniform(-3, 3, (6, 5, 1))
    return (rng.standard_normal((6, 5, 16)) * mags).astype(np.float32)


def _ties():
    """Exact .5 ties: amax 127 makes the scale exactly 1, so every other
    value sits on a half-way point that rounds half to even."""
    half = np.arange(-126.5, 127.0, 1.0, dtype=np.float32)      # 254 ties
    rows = np.stack([np.concatenate([[127.0], half[i::4]])[:64]
                     for i in range(4)])
    rows[1] = -rows[1]
    return rows.astype(np.float32)


def _zeros():
    x = np.zeros((3, 4, 8), np.float32)
    x[1, 2] = 1e-12                       # below QUANT_EPS: scale is eps
    return x


@pytest.mark.parametrize('case', ['mixed0', 'mixed1', 'mixed2', 'ties',
                                  'zeros', 'bf16'])
def test_quantize_codes_and_scales_bit_equal_to_jax(case):
    if case.startswith('mixed'):
        x = _mixed(int(case[-1]))
    elif case == 'ties':
        x = _ties()
    elif case == 'zeros':
        x = _zeros()
    else:
        x = _mixed(5)
    jx = jnp.asarray(x, jnp.bfloat16 if case == 'bf16' else jnp.float32)
    tx = torch.from_numpy(x)
    if case == 'bf16':
        tx = tx.to(torch.bfloat16)
    jq, js = jpa.quantize_values(jx)
    tq, ts = pa.quantize_values(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert tuple(ts.shape) == x.shape[:-1]
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy().view(np.int32),
                                  np.asarray(js).view(np.int32))
    back = pa.dequantize_values(tq, ts, torch.float32)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jpa.dequantize_values(jq, js, jnp.float32)))
    if case == 'ties':
        # Half to even: 0.5 -> 0, 1.5 -> 2, -2.5 -> -2.
        assert np.all(tq.numpy()[:, 1:] % 2 == 0)
    if case == 'zeros':
        assert not tq.any() and torch.isfinite(ts).all()
        assert not back.any()
    # JAX's bound: scale / 2 an element, with a whisker of fp32 slack.
    ref = tx.float()
    bound = ts[..., None] * (0.5 + 1e-3) + 1e-6
    assert bool(((back - ref).abs() < bound).all())


def test_dequantize_rounds_once_into_bf16():
    q = torch.from_numpy(np.random.default_rng(1).integers(
        -127, 128, (4, 32), dtype=np.int8))
    s = torch.from_numpy(np.random.default_rng(2).uniform(
        1e-3, 1, 4).astype(np.float32))
    got = pa.dequantize_values(q, s, torch.bfloat16)
    want = jpa.dequantize_values(jnp.asarray(q.numpy()), jnp.asarray(
        s.numpy()), jnp.bfloat16)
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(want).view(np.int16))


# ------------------------------------------------------------------- pools

def _pool_cfgs(family):
    name = 'llama-debug' if family == 'kv' else 'mla-debug'
    _, tmod, jcfg, tcfg, *_ = _model(name)
    jmod = jdecode if family == 'kv' else jmla
    return jmod, tmod, jcfg, tcfg


@pytest.mark.parametrize('family', ['kv', 'latent'])
def test_int8_pool_carries_scale_sidecars(family):
    jmod, tmod, jcfg, tcfg = _pool_cfgs(family)
    pool = tmod.init_page_pool(tcfg, 12, 8, 2, 4, 'cpu', quant='int8')
    jpool = jmod.init_page_pool(jcfg, 12, 8, 2, 4, quant='int8')
    assert paging.quantized(pool)
    pools, scales = paging._pools(pool), paging._scale_pools(pool)
    jpools, jscales = jpaging._pools(jpool), jpaging._scale_pools(jpool)
    assert list(pools) == list(jpools) and list(scales) == list(jscales)
    for name, a in pools.items():
        assert a.dtype == torch.int8 and tuple(a.shape) == jpools[name].shape
        s = scales[name]
        assert s.dtype == torch.float32
        assert tuple(s.shape) == tuple(a.shape[:-1]) == jscales[name].shape
        assert getattr(pool, paging._SCALE_FIELD[name]) is s
    a, b = scales.values()
    assert a.data_ptr() != b.data_ptr()      # two distinct tensors
    assert paging._SCALE_FIELD == jpaging._SCALE_FIELD


@pytest.mark.parametrize('family', ['kv', 'latent'])
def test_fp_pool_has_no_sidecars(family):
    _, tmod, _, tcfg = _pool_cfgs(family)
    pool = tmod.init_page_pool(tcfg, 12, 8, 2, 4, 'cpu')
    assert not paging.quantized(pool)
    assert paging._scale_pools(pool) is None
    assert set(paging.pool_tensors(pool)) == set(paging._pools(pool))
    with pytest.raises(ValueError, match="'none' or 'int8'"):
        tmod.init_page_pool(tcfg, 12, 8, 2, 4, 'cpu', quant='fp8')


def _filled(pool, rng):
    for t in paging.pool_tensors(pool).values():
        if t.dtype == torch.int8:
            t.copy_(torch.from_numpy(rng.integers(-127, 128, t.shape,
                                                  dtype=np.int8)))
        else:
            t.copy_(torch.from_numpy(rng.standard_normal(t.shape).astype(
                np.float32)))
    return pool


@pytest.mark.parametrize('family', ['kv', 'latent'])
@pytest.mark.parametrize('quant', ['none', 'int8'])
def test_export_import_roundtrip_bit_identical(family, quant):
    """Spill's device halves: export_pages then import_pages into other
    pages moves every pool field, codes and sidecars alike, bit for bit;
    the exported names are JAX's."""
    _, tmod, _, tcfg = _pool_cfgs(family)
    pool = _filled(tmod.init_page_pool(tcfg, 12, 8, 2, 4, 'cpu',
                                       quant=quant), np.random.default_rng(3))
    out = paging.export_pages(pool, [3, 7, 2])
    expect = ({'k', 'v', 'k_scale', 'v_scale'} if family == 'kv' else
              {'c_kv', 'k_rope', 'c_scale', 'r_scale'})
    if quant == 'none':
        expect = {n for n in expect if not n.endswith('scale')}
    assert set(out) == expect
    fresh = tmod.init_page_pool(tcfg, 12, 8, 2, 4, 'cpu', quant=quant)
    paging.import_pages(fresh, {n: a.numpy() for n, a in out.items()},
                        [5, 1, 9])
    back = paging.export_pages(fresh, [5, 1, 9])
    for name in expect:
        assert back[name].dtype == out[name].dtype
        assert torch.equal(back[name], out[name]), name
    # Nothing else moved: the other pages stay zero.
    for t in paging.pool_tensors(fresh).values():
        assert not t[:, [0, 2, 3, 4, 6, 7, 8, 10, 11]].any()


# ------------------------------------------------------- the attention step

def _step_inputs(seed, b=3, s=2, h=4, kh=2, hd=16, psz=8, maxp=4):
    rng = np.random.default_rng(seed)
    n_pages = b * maxp + 1
    kp = rng.integers(-127, 128, (n_pages, psz, kh, hd), dtype=np.int8)
    vp = rng.integers(-127, 128, (n_pages, psz, kh, hd), dtype=np.int8)
    ks = rng.uniform(1e-3, 2e-2, (n_pages, psz, kh)).astype(np.float32)
    vs = rng.uniform(1e-3, 2e-2, (n_pages, psz, kh)).astype(np.float32)
    table = rng.permutation(np.arange(1, n_pages)).reshape(b, maxp).astype(
        np.int32)
    length = np.array([5, 17, 30], np.int32)[:b]
    pos = length[:, None] + np.arange(s)
    pid = np.take_along_axis(table, np.minimum(pos, maxp * psz - 1) // psz,
                             axis=1)
    pid[1] = 0                                          # an inactive row
    off = pos % psz
    q = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    k_new = rng.standard_normal((b, s, kh, hd)).astype(np.float32)
    v_new = rng.standard_normal((b, s, kh, hd)).astype(np.float32)
    return dict(q=q, kp=kp, vp=vp, table=table, length=length, k_new=k_new,
                v_new=v_new, pid=pid.astype(np.int32),
                off=off.astype(np.int32), k_scale=ks, v_scale=vs,
                max_len=maxp * psz)


def _code_flips(got, want):
    """(entries off by one, entries off by more) between two code
    arrays."""
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    return int((d == 1).sum()), int((d > 1).sum())


@pytest.mark.parametrize('seed', range(3))
def test_paged_attention_step_with_scales_matches_jax(seed):
    inp = _step_inputs(seed)
    max_len = inp.pop('max_len')
    names = ('q', 'kp', 'vp', 'table', 'length', 'k_new', 'v_new', 'pid',
             'off')
    jres = jpa.paged_attention_step(
        *(jnp.asarray(inp[n]) for n in names), max_len=max_len,
        impl='fused', k_scale=jnp.asarray(inp['k_scale']),
        v_scale=jnp.asarray(inp['v_scale']))
    t = {n: torch.from_numpy(a.copy()) for n, a in inp.items()}
    tres = pa.paged_attention_step(*(t[n] for n in names), max_len=max_len,
                                   k_scale=t['k_scale'], v_scale=t['v_scale'])
    assert len(tres) == len(jres) == 5
    out, kp, vp, ks, vs = tres
    assert kp is t['kp'] and ks is t['k_scale']          # in place
    _close(out, jres[0], TOL_STEP)
    for got, want in ((ks, jres[3]), (vs, jres[4])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=TOL_SCALE, atol=0)
    flips = [_code_flips(got.numpy(), np.asarray(want))
             for got, want in ((kp, jres[1]), (vp, jres[2]))]
    n = kp.numel() + vp.numel()
    assert all(more == 0 for _, more in flips), flips
    assert sum(one for one, _ in flips) <= CODE_FLIP_SHARE * n, flips


def test_paged_attention_step_without_scales_keeps_the_3_tuple():
    inp = _step_inputs(4)
    max_len = inp.pop('max_len')
    t = {n: torch.from_numpy(a.copy()) for n, a in inp.items()}
    for name in ('kp', 'vp'):
        t[name] = t[name].float()
    res = pa.paged_attention_step(
        t['q'], t['kp'], t['vp'], t['table'], t['length'], t['k_new'],
        t['v_new'], t['pid'], t['off'], max_len=max_len)
    assert len(res) == 3


@pytest.mark.parametrize('quant', ['none', 'int8', 'fp32'])
def test_kernel_b_declines_int8_pools(monkeypatch, quant):
    """JAX's gate (``impl == 'pallas' and k_scale is None``): with the
    tensors taken for the card's and a shape kernel B takes, a bf16 step
    (the kernel's dtype) asks for the kernel and an int8 step never
    does; it computes the fused formulation instead. So does an fp32
    step: the kernel takes bf16 alone."""
    calls = []

    class Asked(Exception):
        pass

    def spy(*args, **kwargs):
        calls.append(args[0].shape)
        raise Asked
    monkeypatch.setattr(pa, 'kernel_call', spy)
    monkeypatch.setattr(pa, '_on_card', lambda t: True)
    inp = _step_inputs(5, b=2, s=1, h=16, kh=8, hd=64, psz=8, maxp=4)
    max_len = inp.pop('max_len')
    t = {n: torch.from_numpy(a.copy()) for n, a in inp.items()}
    args = [t[n] for n in ('q', 'kp', 'vp', 'table', 'length', 'k_new',
                           'v_new', 'pid', 'off')]
    assert pa.kernel_takes(t['q'].shape, t['kp'].shape)
    if quant == 'none':
        for i in (0, 1, 2, 5, 6):        # q, the pools, the new K/V
            args[i] = args[i].to(torch.bfloat16)
        with pytest.raises(Asked):
            pa.paged_attention_step(*args, max_len=max_len)
        assert len(calls) == 1
        return
    scales = ({} if quant == 'fp32' else
              {'k_scale': t['k_scale'], 'v_scale': t['v_scale']})
    if quant == 'fp32':
        args[1], args[2] = args[1].float(), args[2].float()
    got = pa.paged_attention_step(*args, max_len=max_len, **scales)
    assert calls == []
    t2 = {n: torch.from_numpy(a.copy()) for n, a in inp.items()}
    ref_args = [t2[n] for n in ('q', 'kp', 'vp', 'table', 'length', 'k_new',
                                'v_new', 'pid', 'off')]
    if quant == 'fp32':
        ref_args[1], ref_args[2] = ref_args[1].float(), ref_args[2].float()
        want = pa.paged_attention_step_ref(*ref_args, max_len=max_len)
    else:
        want = pa.paged_attention_step_ref(
            *ref_args, max_len=max_len, k_scale=t2['k_scale'],
            v_scale=t2['v_scale'])
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# --------------------------------------------------------- the model steps

def _jax_rows(jmod, jparams, jcfg, tokens, max_len, lengths):
    return jmod.prefill(jparams, jnp.asarray(tokens), jcfg, max_len,
                        lengths=jnp.asarray(lengths))


@pytest.mark.parametrize('name', FAMILIES)
def test_paged_steps_on_int8_pools_match_jax(name):
    """A ragged prefill scattered (quantized) into int8 pages, a verify
    of 3 tokens, 4 decode steps with one row inactive fed JAX's greedy
    tokens, then a 16-token extend of a fresh row over a 16-token prefix
    copied from row 0: logits within TOL_LOGITS of JAX's at every call,
    and the scales of every written page close to JAX's."""
    jmod, tmod, jcfg, tcfg, jparams, tparams, _ = _model(name)
    rng = np.random.default_rng(7)
    b, s, psz, max_len = 4, 16, 8, 64
    maxp = max_len // psz
    n_pages = b * maxp + 1
    lengths = np.array([16, 9, 3, 0], np.int32)
    tokens = rng.integers(0, 256, (b, s)).astype(np.int32)
    table = rng.permutation(np.arange(1, n_pages)).reshape(b, maxp).astype(
        np.int32)
    active = np.array([True, False, True, False])
    slots = np.arange(3, dtype=np.int32)

    jl, rows = _jax_rows(jmod, jparams, jcfg, tokens[:3], max_len,
                         lengths[:3])
    jpool = dataclasses.replace(
        jmod.init_page_pool(jcfg, n_pages, psz, b, maxp, quant='int8'),
        table=jnp.asarray(table))
    jpool = jpaging.scatter_prefill(jpool, rows, jnp.asarray(slots), s,
                                    jnp.asarray(lengths[:3]))
    tl, ra, rb = tmod.prefill(tparams, torch.from_numpy(tokens[:3]), tcfg,
                              max_len, lengths=torch.from_numpy(lengths[:3]))
    tpool = tmod.init_page_pool(tcfg, n_pages, psz, b, maxp, 'cpu',
                                quant='int8')
    tpool.table.copy_(torch.from_numpy(table))
    paging.scatter_prefill(tpool, ra, rb, torch.from_numpy(slots), s,
                           torch.from_numpy(lengths[:3]))
    _close(tl, jl, TOL_LOGITS)

    def pools_close():
        for (n, got), want in zip(paging.pool_tensors(tpool).items(),
                                  jax.tree.leaves([
                                      *jpaging._pools(jpool).values(),
                                      *jpaging._scale_pools(jpool).values()])):
            if got.dtype == torch.int8:
                one, more = _code_flips(got.numpy(), np.asarray(want))
                assert more == 0 and one <= CODE_FLIP_SHARE * got.numel(), \
                    (n, one, more)
            else:
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=1e-5, atol=1e-7)

    pools_close()
    ver = rng.integers(0, 256, (b, 3)).astype(np.int32)
    jv, jpool = jmod.paged_verify_step(jparams, jnp.asarray(ver), jpool,
                                       jcfg, max_len=max_len,
                                       active=jnp.asarray(active))
    tv, _ = tmod.paged_verify_step(tparams, torch.from_numpy(ver), tpool,
                                   tcfg, max_len=max_len,
                                   active=torch.from_numpy(active))
    _close(tv[active], np.asarray(jv)[active], TOL_LOGITS)
    jl4 = jnp.concatenate([jl, jl[:1]])
    for _ in range(4):
        tok = np.asarray(jnp.argmax(jl4, axis=-1)).astype(np.int32)
        jl4, jpool = jmod.paged_decode_step(
            jparams, jnp.asarray(tok), jpool, jcfg, max_len=max_len,
            active=jnp.asarray(active))
        tl4, tpool = tmod.paged_decode_step(
            tparams, torch.from_numpy(tok), tpool, tcfg, max_len=max_len,
            active=torch.from_numpy(active))
        _close(tl4[active], np.asarray(jl4)[active], TOL_LOGITS)
    np.testing.assert_array_equal(tpool.length.numpy(),
                                  np.asarray(jpool.length))
    pools_close()
    # The extend: row 3 shares row 0's first two pages (a prefix hit).
    table[3, :2] = table[0, :2]
    jpool = dataclasses.replace(jpool, table=jnp.asarray(table))
    tpool.table.copy_(torch.from_numpy(table))
    suffix = rng.integers(0, 256, (1, 16)).astype(np.int32)
    je, jpool = jmod.paged_prefill_extend(
        jparams, jnp.asarray(suffix), jpool, jcfg, slot=3, p=16,
        lengths=jnp.asarray([11], jnp.int32))
    te = tmod.paged_prefill_extend(tparams, torch.from_numpy(suffix), tpool,
                                   tcfg, slot=3, p=16, lengths=11)
    _close(te, je, TOL_LOGITS)
    assert int(tpool.length[3]) == int(jpool.length[3]) == 27
    pools_close()


# ------------------------------------------------------ the quality protocol

_QUALITY = {}


def _quality(family, quant):
    """JAX bench.py ``_quality_family`` and the port's
    models/quality.py on the same weights, prompts and forced tokens:
    (JAX's row, the port's row)."""
    key = (family, quant)
    if key not in _QUALITY:
        import bench
        jrow = bench._quality_family(family, quant)
        name = 'llama-debug' if family == 'llama' else 'mla-debug'
        jcfg = dataclasses.replace(
            (jllama.PRESETS if family == 'llama' else jmla.PRESETS)[name],
            dtype=jnp.float32)
        tcfg = dataclasses.replace(
            (config.PRESETS if family == 'llama' else
             config.MLA_PRESETS)[name], dtype=torch.float32)
        init = jllama.init_params if family == 'llama' else jmla.init_params
        tree = jax.device_get(init(jax.random.PRNGKey(0), jcfg))
        params = weights.params_from_jax(tree, tcfg, device='cpu')
        kp, kf = jax.random.split(jax.random.PRNGKey(19))
        prompts = np.asarray(jax.random.randint(kp, (4, 24), 0,
                                                jcfg.vocab_size))
        forced = np.asarray(jax.random.randint(kf, (4, 16), 0,
                                               jcfg.vocab_size))
        trow = quality.quality_family(
            decode if family == 'llama' else mla, params, tcfg,
            torch.from_numpy(prompts.astype(np.int32)),
            torch.from_numpy(forced.astype(np.int32)), quant, 8, 8)
        _QUALITY[key] = (jrow, trow)
    return _QUALITY[key]


@pytest.mark.parametrize('family', ['llama', 'mla'])
def test_quality_protocol_int8_equals_jax_int8(family):
    jrow, trow = _quality(family, 'int8')
    assert abs(trow['nll'] - jrow['nll']) <= TOL_NLL, (trow['nll'],
                                                       jrow['nll'])
    assert trow['greedy_tokens'] == jrow['greedy_tokens']


@pytest.mark.parametrize('family', ['llama', 'mla'])
def test_quality_protocol_int8_within_jax_bands_of_fp(family):
    """The port's int8 pool against its own fp pool, inside the bands
    the JAX bench holds (NLL drift, greedy agreement); the fp row equals
    JAX's fp row."""
    _, t8 = _quality(family, 'int8')
    jfp, tfp = _quality(family, 'none')
    assert abs(tfp['nll'] - jfp['nll']) <= TOL_NLL
    assert tfp['greedy_tokens'] == jfp['greedy_tokens']
    assert abs(t8['nll'] - tfp['nll']) <= quality.QUALITY_NLL_BAND
    assert quality.greedy_match(t8['greedy_tokens'], tfp['greedy_tokens']) \
        >= quality.QUALITY_GREEDY_MATCH_MIN
    import bench
    assert quality.QUALITY_NLL_BAND == bench.QUALITY_NLL_BAND
    assert quality.QUALITY_GREEDY_MATCH_MIN == bench.QUALITY_GREEDY_MATCH_MIN


# --------------------------------------------------------------- the engine

ENGINE_MAX_LEN = 256
CHUNK = 16
PREFIX = [(7 * i + 3) % 250 + 1 for i in range(70)]


def _engine_requests(name):
    """(tokens, max_new) in order: a grouped prefill, a prompt long
    enough to chunk (bucket 64 over 16-token chunks), a 70-token prompt
    and its prefix again with another tail (a hit on the 64-token
    snapshot) and, where the family speculates, a self-repeating prompt
    (prompt-lookup drafts from the first round)."""
    reqs = [([5, 17, 2, 99, 41], 8),
            ([(13 * i + 1) % 256 for i in range(40)], 8),
            (PREFIX + [9, 8, 7], 8), (PREFIX + [3, 1, 4, 1], 8)]
    if not name.startswith('moe'):
        reqs.append(([1, 2, 3, 4, 5] * 4, 16))
    return reqs


def _jax_engine_tokens(name, reqs, kv_quant):
    """The JAX engine's greedy tokens for ``reqs`` posted one at a time
    to /generate (fp32 on the bridged weights, 16-token chunks, the
    speculation cooldown off)."""
    import asyncio
    from aiohttp.test_utils import TestClient
    from aiohttp.test_utils import TestServer as AioTestServer
    from skypilot_tpu.serve import engine as jengine
    jmod, _, jcfg, _, jparams, _, _ = _model(name)
    eng = jengine.InferenceEngine(name, max_len=ENGINE_MAX_LEN, seed=0)
    eng.cfg = jcfg
    eng.params = (jdecode.cast_params_for_decode(jparams, jcfg)
                  if jmod is jdecode else jparams)
    eng.prefill_chunk = CHUNK
    eng.spec_cooldown = 0
    eng.kv_quant = kv_quant
    eng.warmup()
    assert jpaging.quantized(eng.cache) == (kv_quant == 'int8')

    async def inner():
        client = TestClient(AioTestServer(jengine.build_app(eng)))
        await client.start_server()
        try:
            out = []
            for tokens, n in reqs:
                r = await client.post('/generate', json={
                    'tokens': tokens, 'max_new_tokens': n})
                assert r.status == 200, await r.text()
                out.append((await r.json())['tokens'])
            return out, eng.prefix_hits
        finally:
            await client.close()
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(inner())
    finally:
        loop.close()


def _port_engine(name, kv_quant='int8', **attrs):
    from skypilot_tpu_torch.serve import engine as engine_lib
    _, _, _, tcfg, _, _, tree = _model(name)
    eng = engine_lib.InferenceEngine(
        name, cfg=tcfg, device='cpu', max_len=ENGINE_MAX_LEN,
        params=weights.params_from_jax(tree, tcfg, device='cpu'))
    eng.prefill_chunk = CHUNK
    eng.spec_cooldown = 0
    eng.kv_quant = kv_quant
    for key, val in attrs.items():
        setattr(eng, key, val)
    return eng


@pytest.mark.parametrize('name', FAMILIES)
def test_int8_engine_tokens_equal_jax_int8_engine(name):
    """The port's int8 engine and the JAX engine's at
    SKYTPU_ENGINE_KV_QUANT=int8 on the same weights give the same greedy
    tokens through a grouped prefill, chunks, a prefix hit and (dense
    families) speculation; the port's paths all ran."""
    reqs = _engine_requests(name)
    want, jax_hits = _jax_engine_tokens(name, reqs, 'int8')
    eng = _port_engine(name)
    eng.warmup()
    assert paging.quantized(eng.cache)
    eng.start()
    try:
        got = [eng.submit(t, n).result(timeout=120)[0] for t, n in reqs]
        assert got == want
        assert eng.prefix_hits == jax_hits == 1
        assert eng.prefill_chunks > 0
        if eng.spec_k > 0:
            assert eng.spec_rounds > 0 and eng.spec_accepted > 0
    finally:
        eng.stop()


def test_int8_spill_and_wake_bit_identical(tmp_path, monkeypatch):
    """A 64-token prefix on an int8 pool spilled to the host tier parks
    four arrays, codes and scales; woken into other pages it holds the
    same bits, and the woken hit's tokens and logprobs equal the
    resident hit's."""
    from skypilot_tpu_torch.utils import framed
    monkeypatch.setenv('SKYTPU_OBSERVE_DB', str(tmp_path / 'observe.db'))
    eng = _port_engine('llama-debug', spec_k=0, kv_host_mb=64)
    eng.warmup()
    eng.start()
    try:
        key = tuple(PREFIX[:64])
        eng.submit(PREFIX + [9, 8, 7], 8).result(timeout=120)
        resident = eng.submit(PREFIX + [3, 1, 4, 1], 8).result(timeout=120)
        _idle(eng)
        pids = list(eng._prefix_store[key])
        before = {n: a.clone() for n, a in
                  paging.export_pages(eng.cache, pids).items()}
        _on_loop(eng, lambda: eng._spill_key(key))
        assert key not in eng._prefix_store and key in eng.host_store
        meta, parked = framed._decode_payload(eng.host_store._entries[key][0])
        assert set(parked) == {'k', 'v', 'k_scale', 'v_scale'}
        assert meta['n_pages'] == len(pids) == 64 // eng.page_size
        for name, a in before.items():
            np.testing.assert_array_equal(np.asarray(parked[name]),
                                          a.numpy())
        # Pages the woken entry must not reuse: a resident entry's.
        hits0 = eng.prefix_hits
        woken = eng.submit(PREFIX + [3, 1, 4, 1], 8).result(timeout=120)
        _idle(eng)
        assert eng.prefix_hits == hits0 + 1
        assert woken[0] == resident[0] and woken[2] == resident[2]
        after = paging.export_pages(eng.cache, eng._prefix_store[key])
        for name, a in before.items():
            assert after[name].dtype == a.dtype
            assert torch.equal(after[name], a), name
    finally:
        eng.stop()


# ------------------------------------------------------------------ disagg

def _serve(eng, handoff=False):
    import socket
    from skypilot_tpu_torch.serve import engine as engine_lib
    if handoff:
        with socket.socket() as sock:
            sock.bind(('127.0.0.1', 0))
            eng.handoff_port = sock.getsockname()[1]
    server = engine_lib.build_app(eng, '127.0.0.1', 0)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    eng.start()
    base = f'http://127.0.0.1:{server.server_address[1]}'
    deadline = time.monotonic() + 60
    while _http(base + '/health')[0] != 200:
        assert time.monotonic() < deadline
        time.sleep(0.02)
    return server, th, base


def _jax_handoff_tokens(prompt, n, src, dst):
    """JAX's functions along a handoff: the prefill of the prompt's
    bucket scattered into a pool of ``src``, its rows gathered out
    (gather_prefix: fp32 off an int8 pool), adopted into a pool of
    ``dst`` (adopt_rows: re-quantized there), then greedy decode steps.
    Returns (tokens, the rows, the adopter's pool)."""
    _, _, jcfg, _, jparams, _, _ = _model('llama-debug')
    jparams = jdecode.cast_params_for_decode(jparams, jcfg)
    b = decode.bucket_size(len(prompt))
    psz, maxp = 16, ENGINE_MAX_LEN // 16
    table = jnp.asarray(np.arange(1, maxp + 1, dtype=np.int32)[None])
    logits, rows = jdecode.prefill(
        jparams, jnp.asarray([prompt + [0] * (b - len(prompt))], jnp.int32),
        jcfg, ENGINE_MAX_LEN,
        lengths=jnp.asarray([len(prompt)], jnp.int32))
    pool = dataclasses.replace(
        jdecode.init_page_pool(jcfg, maxp + 1, psz, 1, maxp, quant=src),
        table=table)
    pool = jpaging.scatter_prefill(pool, rows, jnp.asarray([0]), b,
                                   jnp.asarray([len(prompt)], jnp.int32))
    a, bb = jpaging.gather_prefix(pool, 0, b)
    out = dataclasses.replace(
        jdecode.init_page_pool(jcfg, maxp + 1, psz, 1, maxp, quant=dst),
        table=table)
    adopted = jpaging.adopt_rows(out, a, bb, 0, b, len(prompt))
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    toks, pool = [int(tok[0])], adopted
    for _ in range(n - 1):
        logits, pool = jdecode.paged_decode_step(
            jparams, tok, pool, jcfg, max_len=ENGINE_MAX_LEN)
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        toks.append(int(tok[0]))
    return toks, (np.asarray(a), np.asarray(bb)), adopted


@pytest.mark.parametrize('src,dst', [('int8', 'int8'), ('int8', 'none'),
                                     ('none', 'int8')])
def test_disagg_handoff_across_pool_representations(tmp_path, monkeypatch,
                                                    src, dst):
    """A prefill replica on ``src`` pools hands a prompt off to a decode
    replica on ``dst`` pools: the shipped rows are JAX's (fp32 off an
    int8 pool), the greedy tokens equal JAX's functions along the same
    handoff, and the adopter's pages equal JAX ``adopt_rows``'s on the
    same rows bit for bit."""
    monkeypatch.setenv('SKYTPU_OBSERVE_DB', str(tmp_path / 'observe.db'))
    adopted = []
    orig = paging.adopt_rows

    def spy(pcache, a, b, slot, s, new_len):
        out = orig(pcache, a, b, slot, s, new_len)
        pids = pcache.table[slot, :s // pcache.page_size].tolist()
        adopted.append((a.clone(), b.clone(),
                        paging.export_pages(pcache, pids)))
        return out
    monkeypatch.setattr(paging, 'adopt_rows', spy)
    # One grouped prefill (no chunks): the path JAX's functions take.
    knobs = dict(spec_k=0, page_size=16, prefill_chunk=256)
    pre = _port_engine('llama-debug', src, **knobs)
    dec = _port_engine('llama-debug', dst, **knobs)
    servers = [(pre, *_serve(pre)), (dec, *_serve(dec, handoff=True))]
    try:
        pbase, dbase = servers[0][3], servers[1][3]
        prompt = [(11 * i + 5) % 251 + 1 for i in range(40)]
        code, first = _http(f'{pbase}/disagg/prefill?orig=/generate',
                            {'tokens': prompt, 'max_new_tokens': 8},
                            {TARGET: f'127.0.0.1:{dec.handoff_port}'})
        assert code == 200, first
        code, doc = _http(f'{dbase}/disagg/continue?orig=/generate',
                          {'handoff_id': first['handoff']['id']})
        assert code == 200, doc
        want, rows, jpool = _jax_handoff_tokens(prompt, 8, src, dst)
        assert doc['tokens'] == want
        a, b, pages = adopted[-1]
        assert a.dtype == torch.float32
        # The prompt's positions (the pad past it lies on pages the
        # prefill replica did not reserve: the trash page's garbage).
        # Off an int8 pool, a value may sit one code apart from JAX's (a
        # K/V element at a .5 boundary), on at most CODE_FLIP_SHARE.
        n = len(prompt)
        got, want = a.numpy()[:, :, :n], rows[0][:, :, :n]
        diff = np.abs(got - want)
        bad = diff > 1e-5 * np.abs(want) + 1e-6
        step = np.abs(want).max(axis=-1, keepdims=True) / 127
        if src == 'none':
            assert not bad.any()
        assert bad.sum() <= CODE_FLIP_SHARE * bad.size, int(bad.sum())
        assert np.all(diff[bad] <= 1.001 * np.broadcast_to(step,
                                                           diff.shape)[bad])
        # JAX adopt_rows on the very rows the port shipped.
        jad = jpaging.adopt_rows(
            dataclasses.replace(jpool, length=jnp.zeros_like(jpool.length)),
            jnp.asarray(a.numpy()), jnp.asarray(b.numpy()), 0, a.shape[2],
            len(prompt))
        jpages = jpaging.export_pages(jad, jnp.arange(1, a.shape[2] // 16
                                                      + 1))
        assert set(pages) == set(jpages)
        for name, t in pages.items():
            np.testing.assert_array_equal(t.numpy(), np.asarray(jpages[name]))
    finally:
        for eng, server, th, _ in servers:
            server.shutdown()
            server.server_close()
            eng.stop()
            th.join(10)


# --------------------------------------------------- knobs and the surface

def test_int8_refuses_the_jax_combinations(monkeypatch):
    """int8 with SKYTPU_ENGINE_PAGED=0 or SKYTPU_ENGINE_ATTN=gather is the
    JAX engine's ValueError; either knob alone serves its layout."""
    from skypilot_tpu_torch.serve import engine as engine_lib
    _, _, _, tcfg, _, _, _ = _model('llama-debug')

    def build():
        return engine_lib.InferenceEngine('llama-debug', cfg=tcfg,
                                          device='cpu', max_len=64)
    monkeypatch.setattr(engine_lib, 'KV_QUANT', 'int8')
    assert build().kv_quant == 'int8'
    for env, match in (('SKYTPU_ENGINE_PAGED', 'needs paged mode'),
                       ('SKYTPU_ENGINE_ATTN', 'incompatible with')):
        val = '0' if env == 'SKYTPU_ENGINE_PAGED' else 'gather'
        monkeypatch.setenv(env, val)
        monkeypatch.setattr(engine_lib, 'KV_QUANT', 'int8')
        with pytest.raises(ValueError, match=match):
            build()
        # Either knob alone takes effect: its layout on fp pools.
        monkeypatch.setattr(engine_lib, 'KV_QUANT', 'none')
        eng = build()
        assert (eng.paged, eng.attn_backend) == (
            (False, 'fused') if env == 'SKYTPU_ENGINE_PAGED'
            else (True, 'gather'))
        monkeypatch.delenv(env)


def test_int8_health_and_metrics(tmp_path, monkeypatch):
    """/health names kv_quant on an int8 pool (absent on fp pools) and
    skytpu_engine_kv_pages_quantized counts n_pages - 1, as the JAX
    engine reports them; the pool's token bytes count the sidecars."""
    monkeypatch.setenv('SKYTPU_OBSERVE_DB', str(tmp_path / 'observe.db'))
    out = {}
    for quant in ('int8', 'none'):
        eng = _port_engine('llama-debug', quant, spec_k=0)
        server, th, base = _serve(eng)
        try:
            _, health = _http(base + '/health')
            with urllib.request.urlopen(base + '/metrics', timeout=30) as r:
                text = r.read().decode()
            gauge = [line for line in text.splitlines()
                     if line.startswith('skytpu_engine_kv_pages_quantized ')]
            out[quant] = (health, float(gauge[0].split()[1]), eng.n_pages,
                          eng._tok_bytes)
        finally:
            server.shutdown()
            server.server_close()
            eng.stop()
            th.join(10)
    health, gauge, n_pages, tok8 = out['int8']
    assert health['kv_quant'] == 'int8' and gauge == n_pages - 1
    health, gauge, _, tok_fp = out['none']
    assert 'kv_quant' not in health and gauge == 0
    _, _, _, tcfg, _, _, _ = _model('llama-debug')
    per_vec = tcfg.n_layers * tcfg.n_kv_heads * 2          # k and v
    assert tok_fp == per_vec * tcfg.hd * 4                  # fp32 values
    assert tok8 == per_vec * (tcfg.hd + 4)                  # codes + scale


# ---------------------------------------------------------- a tensor gang

GANG_PROMPTS = [([5, 17, 2, 99, 41], 8), (PREFIX + [9, 8], 8),
                (PREFIX + [3, 1], 8), ([1, 2, 3, 4, 5] * 4, 16)]


def test_int8_tensor_gang_equals_one_int8_process(tmp_path):
    """Two ranks of ``--mesh tensor=2`` (tests/torch_mh_worker.py, gloo
    on the CPU) with SKYTPU_ENGINE_KV_QUANT=int8, each holding its kv
    heads' codes and sidecars, answer with the greedy tokens of one
    int8 process on the same checkpoint: a grouped prefill, 32-token
    chunks, a prefix hit and speculation."""
    import os
    import secrets
    import signal
    import subprocess
    import sys
    from test_torch_multihost import (WORKER, _coord_port, _get,
                                      _http_port, _post, _wait_healthy)
    from skypilot_tpu_torch.serve import engine as engine_lib
    from skypilot_tpu_torch.train import checkpoints, train_lib
    _, _, _, tcfg, _, _, tree = _model('llama-debug')
    ckdir = str(tmp_path / 'ck')
    state = train_lib.init_train_state(
        tcfg, train_lib.default_optimizer(), 'cpu',
        params=weights.params_from_jax(tree, tcfg, device='cpu'))
    with checkpoints.Checkpointer(ckdir) as ck:
        ck.save(state, wait=True)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root, OMP_NUM_THREADS='1',
               SKYTPU_MH_TOKEN=secrets.token_hex(16),
               SKYTPU_ENGINE_PREFILL_CHUNK='32',
               SKYTPU_ENGINE_SPEC_COOLDOWN='0',
               SKYTPU_ENGINE_KV_QUANT='int8',
               SKYTPU_OBSERVE_DB=str(tmp_path / 'journal.db'))
    http_port = _http_port(60)
    flags = ['--model', 'llama-debug', '--device', 'cpu', '--max-len',
             str(ENGINE_MAX_LEN), '--ckpt-dir', ckdir, '--mesh', 'tensor=2',
             '--warm-buckets', '16,32', '--num-processes', '2',
             '--coordinator', f'127.0.0.1:{_coord_port(60)}', '--host',
             '127.0.0.1', '--port', str(http_port)]
    procs = []
    for rank in (1, 0):
        log = open(tmp_path / f'rank{rank}.log', 'w')
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, *flags, '--process-id', str(rank)],
            env=env, stdout=log, stderr=subprocess.STDOUT))
    try:
        # The one-process reference while the gang boots.
        one = engine_lib.InferenceEngine(
            'llama-debug', cfg=tcfg, device='cpu', max_len=ENGINE_MAX_LEN,
            ckpt_dir=ckdir)
        one.prefill_chunk, one.spec_cooldown, one.kv_quant = 32, 0, 'int8'
        one.warmup()
        one.start()
        try:
            want = [one.submit(t, n).result(timeout=120)[0]
                    for t, n in GANG_PROMPTS]
            assert one.prefix_hits == 1 and one.spec_rounds > 0
        finally:
            one.stop()
        base = f'http://127.0.0.1:{http_port}'
        _wait_healthy(base, procs, time.monotonic() + 300)
        health = json.loads(_get(base, '/health'))
        assert health['kv_quant'] == 'int8'
        got = []
        for tokens, n in GANG_PROMPTS:
            code, raw = _post(base, '/generate', {'tokens': tokens,
                                                  'max_new_tokens': n})
            assert code == 200, raw
            got.append(json.loads(raw)['tokens'])
        metrics = _get(base, '/metrics')
        assert got == want
        counters = {line.split()[0]: float(line.split()[1])
                    for line in metrics.splitlines()
                    if line and not line.startswith('#')}
        assert counters['skytpu_engine_prefix_hits_total'] == 1
        assert counters['skytpu_engine_spec_rounds_total'] >= 1
        assert counters['skytpu_engine_kv_pages_quantized'] > 0
        procs[1].send_signal(signal.SIGTERM)
        for p in procs:
            p.wait(timeout=60)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    follower = (tmp_path / 'rank1.log').read_text()
    assert 'diverged' not in follower


def test_warm_disagg_grid_holds_on_an_int8_pool(monkeypatch):
    """SKYTPU_ENGINE_WARM_DISAGG's warm-up probe adopts and exports
    every prompt bucket through the real paths: on an int8 pool it
    ships fp32 rows (what an int8 export carries), and leaves every
    page free."""
    monkeypatch.setenv('SKYTPU_ENGINE_WARM_DISAGG', '1')
    adopted = []
    orig = paging.adopt_rows

    def spy(pcache, a, b, slot, s, new_len):
        adopted.append((a.dtype, b.dtype, s))
        return orig(pcache, a, b, slot, s, new_len)
    monkeypatch.setattr(paging, 'adopt_rows', spy)
    eng = _port_engine('llama-debug', spec_k=0)
    eng.warmup()
    assert [s for _, _, s in adopted] == eng.all_buckets()
    assert all(a == b == torch.float32 for a, b, _ in adopted)
    assert eng.alloc.free_count == eng.n_pages - 1
    assert paging.quantized(eng.cache)
