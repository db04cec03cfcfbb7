"""Weight-only int8 in the PyTorch port vs the JAX package, on the CPU:
``QuantizedWeight``, ``_quantize_int8``, ``_d`` and
``cast_params_for_decode(quantize='int8')`` (models/quant.py, re-exported
by models/decode.py), the dense and MLA layer math reading through
``_d``, and the engine's ``quantize``.

The same fp32 weights (JAX ``init_params``, bridged) go through both
packages. Codes and scales are compared bit for bit (the same fp32
arithmetic, round half to even); logits within TOL (2e-4, rtol and
atol: fp32 on both sides, products summed in other orders); greedy
tokens exactly. The int8-against-fp bounds are JAX's own
(tests/unit_tests/test_decode.py ``TestInt8Decode``): a dequantized
weight within one quantization step of the original, prefill logits
within 0.1 of the fp path's largest logit.
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
from skypilot_tpu_torch import config
from skypilot_tpu_torch.models import decode, llama, mla, quant, weights
from skypilot_tpu_torch.serve import engine as engine_lib

TOL = 2e-4
REL_INT8 = 0.1
_MODELS = {}


def _model(name):
    """(JAX cfg, port cfg, JAX fp32 params, port fp32 params)."""
    if name not in _MODELS:
        jmod = jmla if name in jmla.PRESETS else jllama
        presets = (config.MLA_PRESETS if name in jmla.PRESETS
                   else config.PRESETS)
        jcfg = dataclasses.replace(jmod.PRESETS[name], dtype=jnp.float32)
        tcfg = dataclasses.replace(presets[name], dtype=torch.float32)
        tree = jax.device_get(jmod.init_params(jax.random.PRNGKey(0), jcfg))
        _MODELS[name] = (jcfg, tcfg, jax.tree.map(jnp.asarray, tree),
                         weights.params_from_jax(tree, tcfg, device='cpu'))
    return _MODELS[name]


def _tokens(seed, *shape):
    return np.random.default_rng(seed).integers(0, 256,
                                                shape).astype(np.int32)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b))) / (float(np.max(np.abs(b))) + 1e-9)


@pytest.mark.parametrize('name', ['llama-debug', 'mla-debug',
                                  'deepseek-moe-debug'])
def test_codes_and_scales_bit_equal_to_jax(name):
    jcfg, tcfg, jp, tp = _model(name)
    jq = jdecode.cast_params_for_decode(jp, jcfg, quantize='int8')
    tq = decode.cast_params_for_decode(tp, tcfg, quantize='int8')
    assert set(jq['layers']) == set(tq['layers'])
    for k, jw in jq['layers'].items():
        tw = tq['layers'][k]
        assert isinstance(tw, decode.QuantizedWeight) == \
            isinstance(jw, jdecode.QuantizedWeight), k
        if isinstance(tw, decode.QuantizedWeight):
            assert tw.q.dtype == torch.int8 and tw.scale.dtype == \
                torch.float32
            np.testing.assert_array_equal(tw.q.numpy(), np.asarray(jw.q))
            np.testing.assert_array_equal(tw.scale.numpy(),
                                          np.asarray(jw.scale))
            np.testing.assert_array_equal(
                quant._d(tw, torch.float32).numpy(),
                np.asarray(jdecode._d(jw, jnp.float32)))
        else:
            np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))


def test_quantize_rounds_half_to_even_and_clips():
    """Crafted columns: w / scale lands on .5 exactly (ties go to the
    even code), and the absmax entry maps to ±127."""
    w = torch.tensor([[1.27, -2.54], [0.005, 0.01], [0.015, -0.03],
                      [0.0, 0.0]], dtype=torch.float32)
    got = decode._quantize_int8(w)
    want = jdecode._quantize_int8(jnp.asarray(w.numpy()))
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    assert got.q[0].tolist() == [127, -127]
    zero = decode._quantize_int8(torch.zeros((3, 2)))
    assert zero.q.abs().max() == 0 and (zero.scale > 0).all()


def test_quantized_weight_slices_per_layer():
    _, tcfg, _, tp = _model('llama-debug')
    wq = decode.cast_params_for_decode(tp, tcfg,
                                       quantize='int8')['layers']['wq']
    one = wq[1]
    assert torch.equal(one.q, wq.q[1]) and torch.equal(one.scale,
                                                       wq.scale[1])
    assert tuple(wq.scale.shape) == (tcfg.n_layers, 1, wq.q.shape[-1])
    # A plain tensor's _d is its cast, as the bf16 paths read it.
    w = tp['layers']['wq']
    assert torch.equal(quant._d(w, torch.bfloat16), w.to(torch.bfloat16))


def test_int8_quantization_roundtrip_and_generate():
    """JAX's TestInt8Decode on llama-debug: int8 + scale, dequant within
    one step, norms untouched, prefill logits close to fp, greedy
    generation runs; then the port's int8 logits and tokens are JAX's."""
    jcfg, tcfg, jp, tp = _model('llama-debug')
    fp = decode.cast_params_for_decode(tp, tcfg)
    q8 = decode.cast_params_for_decode(tp, tcfg, quantize='int8')
    wq = q8['layers']['wq']
    assert isinstance(wq, decode.QuantizedWeight)
    assert wq.q.dtype == torch.int8
    err = float((decode._d(wq, torch.float32) - fp['layers']['wq'])
                .abs().max())
    assert err <= float(fp['layers']['wq'].abs().max()) / 127.0 + 1e-6
    assert not isinstance(q8['layers']['attn_norm'], decode.QuantizedWeight)
    tokens = _tokens(1, 2, 12)
    lfp, _ = decode.prefill_cache(fp, torch.as_tensor(tokens), tcfg, 32)
    lq8, _ = decode.prefill_cache(q8, torch.as_tensor(tokens), tcfg, 32)
    assert _rel(lq8, lfp) < REL_INT8
    jq8 = jdecode.cast_params_for_decode(jp, jcfg, quantize='int8')
    jl, _ = jdecode.prefill(jq8, jnp.asarray(tokens), jcfg, max_len=32)
    np.testing.assert_allclose(lq8.numpy(), np.asarray(jl), rtol=TOL,
                               atol=TOL)
    out = decode.generate(q8, torch.as_tensor(tokens), tcfg, 8, max_len=32)
    assert tuple(out.shape) == (2, 8)
    assert ((out >= 0) & (out < tcfg.vocab_size)).all()
    want = jdecode.generate(jq8, jnp.asarray(tokens), jcfg, 8, max_len=32)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))


@pytest.mark.parametrize('name', ['mla-debug', 'deepseek-moe-debug'])
def test_int8_mla_generates_close_to_fp_and_as_jax(name):
    """MLA's projections and the absorbed w_uk / w_uv read through _d;
    DeepSeekMoE quantizes its shared experts and keeps the 4-D routed
    stacks dense."""
    jcfg, tcfg, jp, tp = _model(name)
    fp = decode.cast_params_for_decode(tp, tcfg)
    q8 = decode.cast_params_for_decode(tp, tcfg, quantize='int8')
    assert isinstance(q8['layers']['w_uk'], decode.QuantizedWeight)
    if name == 'deepseek-moe-debug':
        assert isinstance(q8['layers']['ws_gate'], decode.QuantizedWeight)
        assert not isinstance(q8['layers']['w_gate'],
                              decode.QuantizedWeight)
    tokens = _tokens(1, 2, 12)
    lfp, _ = mla.prefill_cache(fp, torch.as_tensor(tokens), tcfg, 32)
    lq8, _ = mla.prefill_cache(q8, torch.as_tensor(tokens), tcfg, 32)
    assert _rel(lq8, lfp) < REL_INT8
    jq8 = jdecode.cast_params_for_decode(jp, jcfg, quantize='int8')
    out = mla.generate(q8, torch.as_tensor(tokens), tcfg, 8, max_len=32)
    want = jmla.generate(jq8, jnp.asarray(tokens), jcfg, 8, max_len=32)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))


def test_int8_keeps_the_bf16_path_unchanged():
    """quantize=None casts every leaf as before; the layer math on a
    plain tensor reads what it read."""
    _, tcfg, _, tp = _model('llama-debug')
    cfg = dataclasses.replace(tcfg, dtype=torch.bfloat16)
    cast = decode.cast_params_for_decode(tp, cfg)
    assert all(v.dtype == torch.bfloat16
               for v in cast['layers'].values())
    tokens = torch.as_tensor(_tokens(2, 2, 8))
    a = llama.forward(cast, tokens, cfg)
    b = llama.forward(tp, tokens, cfg)
    assert torch.equal(a, b)


def test_int8_refused_for_moe_and_bad_values():
    for name in ('moe-debug', 'gptoss-debug'):
        cfg = config.get_config(name)
        params = {'layers': {}}
        with pytest.raises(NotImplementedError, match='MoE'):
            decode.cast_params_for_decode(params, cfg, quantize='int8')
    with pytest.raises(ValueError, match='quantize must be'):
        decode.cast_params_for_decode({}, config.get_config('llama-debug'),
                                      quantize='int4')


def test_engine_int8_greedy_equals_int8_generate():
    """The engine's quantize='int8' quantizes the fp32 masters at load;
    a greedy /generate through its paged steps gives the port's int8
    contiguous generate's tokens."""
    _, tcfg, _, tp = _model('llama-debug')
    eng = engine_lib.InferenceEngine('llama-debug', cfg=tcfg, params=tp,
                                     device='cpu', quantize='int8')
    assert isinstance(eng.params['layers']['wq'], decode.QuantizedWeight)
    server = engine_lib.build_app(eng, '127.0.0.1', 0)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    base = f'http://127.0.0.1:{server.server_address[1]}'
    try:
        eng.start()
        deadline = time.monotonic() + 60
        while True:
            try:
                with urllib.request.urlopen(base + '/health', timeout=10):
                    break
            except OSError:
                assert time.monotonic() < deadline
                time.sleep(0.05)
        q8 = decode.cast_params_for_decode(tp, tcfg, quantize='int8')
        for n, seed in ((5, 1), (20, 2)):
            prompt = _tokens(seed, n).tolist()
            req = urllib.request.Request(
                base + '/generate',
                data=json.dumps({'tokens': prompt,
                                 'max_new_tokens': 8}).encode(),
                headers={'Content-Type': 'application/json'})
            with urllib.request.urlopen(req, timeout=120) as r:
                doc = json.loads(r.read())
            want = decode.generate(q8, torch.tensor([prompt]), tcfg, 8)
            assert doc['tokens'] == want[0].tolist()
    finally:
        server.shutdown()
        server.server_close()
        eng.stop()
        th.join(10)


def test_engine_int8_refuses_moe_by_name():
    with pytest.raises(NotImplementedError, match='MoE'):
        engine_lib.InferenceEngine('moe-debug', device='cpu',
                                   quantize='int8')
    parser = engine_lib.build_parser()
    assert parser.parse_args(['--quantize', 'int8']).quantize == 'int8'
