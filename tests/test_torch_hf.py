"""HF checkpoints in the PyTorch port, on the CPU, against the JAX
package and against transformers (the contracts of
tests/unit_tests/test_hf_serving.py, on the port).

Tiny checkpoints are built in-process with transformers
(``save_pretrained``) and a tiny real ``tokenizer.json`` with the
tokenizers library (byte-level BPE with the llama3 or ChatML specials):
nothing is downloaded. Tolerances:
  - imported weights against transformers' logits in fp32: max abs
    < 5e-3 and equal argmax (JAX's TestWeightParity bound: fp32
    accumulation order only);
  - the import, the export's tensors, the codec and the config mapping
    against JAX and against the safetensors library: exact;
  - greedy tokens of the engine and of batch_infer in fp32 against the
    JAX engine and batch_infer: exact;
  - the trainer's first loss from ``--hf-dir`` in fp32 against the JAX
    trainer's: 1e-5 relative (unrounded, read from each step's
    metrics).
"""
import asyncio
import dataclasses
import json
import os
import struct
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient
from aiohttp.test_utils import TestServer as AioTestServer

import jax
import jax.numpy as jnp

from skypilot_tpu.data import tokenizer as jtokenizer
from skypilot_tpu.models import batch_infer as jbatch_infer
from skypilot_tpu.models import hf_export as jhf_export
from skypilot_tpu.models import hf_import as jhf_import
from skypilot_tpu.serve import engine as jengine
from skypilot_tpu.train import train_lib as jtrain_lib
from skypilot_tpu.train import trainer as jtrainer
from skypilot_tpu_torch import config
from skypilot_tpu_torch.data import tokenizer
from skypilot_tpu_torch.models import (batch_infer, hf_export, hf_import,
                                       llama, moe, safetensors_io)
from skypilot_tpu_torch.serve import engine as engine_lib
from skypilot_tpu_torch.train import checkpoints, train_lib, trainer

TOL_LOGITS = 5e-3
TOL_LOSS_REL = 1e-5

_TINY = dict(vocab_size=288, hidden_size=64, intermediate_size=128,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=128,
             rms_norm_eps=1e-5, rope_theta=10000.0,
             tie_word_embeddings=True)
_LLAMA3_SPECIALS = ['<|begin_of_text|>', '<|end_of_text|>',
                    '<|start_header_id|>', '<|end_header_id|>',
                    '<|eot_id|>']
_CHATML_SPECIALS = ['<|endoftext|>', '<|im_start|>', '<|im_end|>']
_LLAMA3_ROPE = {'rope_type': 'llama3', 'factor': 2.0,
                'low_freq_factor': 1.0, 'high_freq_factor': 4.0,
                'original_max_position_embeddings': 64}


def _write_tokenizer_json(path: str, specials) -> None:
    """A real tiny fast tokenizer: byte-level BPE over the 256-char
    ByteLevel alphabet plus the family's special tokens."""
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers
    alphabet = sorted(pre_tokenizers.ByteLevel.alphabet())
    tok = Tokenizer(models.BPE(vocab={c: i for i, c in enumerate(alphabet)},
                               merges=[]))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    tok.add_special_tokens(specials)
    tok.save(path)


def _hf_model(family: str):
    import transformers
    if family == 'mixtral':
        cls, model = transformers.MixtralConfig, \
            transformers.MixtralForCausalLM
        kw = dict(_TINY, num_local_experts=4, num_experts_per_tok=2)
    elif family == 'llama':
        cls, model = transformers.LlamaConfig, transformers.LlamaForCausalLM
        kw = dict(_TINY, rope_scaling=dict(_LLAMA3_ROPE))
    else:
        cls, model = transformers.Qwen2Config, transformers.Qwen2ForCausalLM
        kw = dict(_TINY)
    torch.manual_seed(0)
    return model(cls(**kw)).eval()


def _write_hf_checkpoint(dirpath, family: str):
    """A transformers-built tiny checkpoint with its tokenizer.json and
    generation_config.json (eos 257): (dir, tokens, fp32 logits)."""
    model = _hf_model(family)
    model.save_pretrained(str(dirpath), safe_serialization=True)
    _write_tokenizer_json(os.path.join(str(dirpath), 'tokenizer.json'),
                          _CHATML_SPECIALS if family == 'qwen2'
                          else _LLAMA3_SPECIALS)
    with open(os.path.join(str(dirpath), 'generation_config.json'),
              'w') as f:
        json.dump({'eos_token_id': 257}, f)
    toks = torch.randint(1, 288, (2, 12),
                         generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        logits = model(toks).logits.float().numpy()
    return str(dirpath), toks.numpy(), logits


@pytest.fixture(scope='module')
def llama_hf(tmp_path_factory):
    return _write_hf_checkpoint(tmp_path_factory.mktemp('hf_llama'), 'llama')


@pytest.fixture(scope='module')
def qwen_hf(tmp_path_factory):
    return _write_hf_checkpoint(tmp_path_factory.mktemp('hf_qwen'), 'qwen2')


@pytest.fixture(scope='module')
def mixtral_hf(tmp_path_factory):
    return _write_hf_checkpoint(tmp_path_factory.mktemp('hf_mixtral'),
                                'mixtral')


def _fp32(cfg):
    return dataclasses.replace(cfg, dtype=torch.float32, remat='none')


def _leaves(tree, prefix=''):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f'{prefix}/{k}')
    else:
        yield prefix, tree


def _assert_tree_equals_jax(tree, jtree):
    mine, ref = dict(_leaves(tree)), dict(_leaves(jax.device_get(jtree)))
    assert sorted(mine) == sorted(ref)
    for k, t in mine.items():
        assert t.dtype == torch.float32, k
        np.testing.assert_array_equal(t.numpy(), np.asarray(ref[k]),
                                      err_msg=k)


# ---------------------------------------------------------------- config

_RAW_CONFIGS = {
    'llama3': {'architectures': ['LlamaForCausalLM'], 'vocab_size': 128256,
               'hidden_size': 2048, 'num_hidden_layers': 16,
               'num_attention_heads': 32, 'num_key_value_heads': 8,
               'intermediate_size': 8192, 'rope_theta': 500000.0,
               'rms_norm_eps': 1e-5, 'max_position_embeddings': 131072,
               'tie_word_embeddings': True, 'head_dim': 64,
               'rope_scaling': {'rope_type': 'llama3', 'factor': 32.0,
                                'low_freq_factor': 1.0,
                                'high_freq_factor': 4.0,
                                'original_max_position_embeddings': 8192}},
    'qwen2': {'architectures': ['Qwen2ForCausalLM'], 'vocab_size': 151936,
              'hidden_size': 1536, 'num_hidden_layers': 28,
              'num_attention_heads': 12, 'num_key_value_heads': 2,
              'intermediate_size': 8960, 'rope_theta': 1e6,
              'rms_norm_eps': 1e-6, 'max_position_embeddings': 32768,
              'tie_word_embeddings': True,
              'rope_scaling': {'type': 'default'}},
    'mixtral': {'architectures': ['MixtralForCausalLM'], 'vocab_size': 32000,
                'hidden_size': 4096, 'num_hidden_layers': 32,
                'num_attention_heads': 32, 'num_key_value_heads': 8,
                'intermediate_size': 14336, 'rope_theta': 1e6,
                'rms_norm_eps': 1e-5, 'max_position_embeddings': 32768,
                'num_local_experts': 8, 'num_experts_per_tok': 2,
                'sliding_window': 4096},
}


def _fields(cfg):
    out = dataclasses.asdict(cfg)
    for k in ('dtype', 'param_dtype'):
        out.pop(k)
    return out


@pytest.mark.parametrize('name', sorted(_RAW_CONFIGS))
def test_config_from_hf_equals_jax_field_by_field(name):
    cfg = hf_import.config_from_hf(_RAW_CONFIGS[name])
    ref = jhf_import.config_from_hf(_RAW_CONFIGS[name])
    assert type(cfg).__name__ == type(ref).__name__
    assert _fields(cfg) == _fields(ref)
    if name == 'mixtral':
        assert (cfg.n_experts, cfg.top_k, cfg.capacity_factor) == (8, 2, 2.0)
        assert cfg.sliding_window_pattern == cfg.n_layers + 1
    if name == 'llama3':
        assert cfg.hd == 64 and cfg.rope_scaling.factor == 32.0


@pytest.mark.parametrize('raw', [
    {'architectures': ['GPT2LMHeadModel'], 'vocab_size': 1},
    {'architectures': ['LlamaForCausalLM'], 'vocab_size': 1,
     'hidden_size': 1, 'num_hidden_layers': 1, 'num_attention_heads': 1,
     'intermediate_size': 1,
     'rope_scaling': {'rope_type': 'yarn', 'factor': 2.0}}])
def test_config_from_hf_refuses_as_jax_does(raw):
    with pytest.raises(ValueError) as mine:
        hf_import.config_from_hf(raw)
    with pytest.raises(ValueError) as ref:
        jhf_import.config_from_hf(raw)
    assert str(mine.value) == str(ref.value)


# --------------------------------------------------------------- weights

@pytest.mark.parametrize('family', ['llama', 'qwen2'])
def test_dense_import_matches_transformers_and_jax(family, llama_hf,
                                                   qwen_hf):
    hf_dir, toks, want = llama_hf if family == 'llama' else qwen_hf
    cfg, params = hf_import.load_hf_checkpoint(hf_dir, device='cpu')
    assert cfg.qkv_bias is (family == 'qwen2')
    got = llama.forward(params, torch.from_numpy(toks).long(),
                        _fp32(cfg)).numpy()
    assert np.max(np.abs(got - want)) < TOL_LOGITS
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    _, jparams = jhf_import.load_hf_checkpoint(hf_dir)
    _assert_tree_equals_jax(params, jparams)


def test_mixtral_import_matches_transformers_and_jax(mixtral_hf):
    """Per-expert stacks and the router, with capacity lifted so no
    token drops (capacity_factor 16, as JAX's test sets)."""
    hf_dir, toks, want = mixtral_hf
    cfg, params = hf_import.load_hf_checkpoint(hf_dir, device='cpu')
    assert isinstance(cfg, config.MoEConfig)
    assert (cfg.n_experts, cfg.top_k) == (4, 2)
    cfg = dataclasses.replace(_fp32(cfg), capacity_factor=16.0)
    got = moe.forward(params, torch.from_numpy(toks).long(), cfg).numpy()
    assert np.max(np.abs(got - want)) < TOL_LOGITS
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    _, jparams = jhf_import.load_hf_checkpoint(hf_dir)
    _assert_tree_equals_jax(params, jparams)


def test_import_keeps_bf16_and_casts_on_request(tmp_path):
    model = _hf_model('llama').to(torch.bfloat16)
    model.save_pretrained(str(tmp_path), safe_serialization=True)
    _, params = hf_import.load_hf_checkpoint(str(tmp_path))
    assert {t.dtype for _, t in _leaves(params)} == {torch.bfloat16}
    _, p32 = hf_import.load_hf_checkpoint(str(tmp_path), dtype=torch.float32)
    for (k, a), (_, b) in zip(_leaves(params), _leaves(p32)):
        assert b.dtype == torch.float32 and torch.equal(a.float(), b), k


def test_shape_mismatch_and_missing_tensor_fail_loudly(llama_hf):
    hf_dir = llama_hf[0]
    with open(os.path.join(hf_dir, 'config.json')) as f:
        raw = json.load(f)
    cfg = hf_import.config_from_hf(dict(raw, num_hidden_layers=3))
    with pytest.raises(KeyError, match='layers.2'):
        hf_import.params_from_hf(hf_import._load_tensors(hf_dir), cfg)
    cfg = hf_import.config_from_hf(dict(raw, intermediate_size=96))
    with pytest.raises(ValueError, match='config/weights mismatch'):
        hf_import.params_from_hf(hf_import._load_tensors(hf_dir), cfg)
    with pytest.raises(FileNotFoundError, match='model.safetensors'):
        hf_import._shard_files(os.path.dirname(hf_dir))


def test_hf_eos_ids(llama_hf, tmp_path):
    assert hf_import.hf_eos_ids(llama_hf[0]) == [257] == \
        jhf_import.hf_eos_ids(llama_hf[0])
    (tmp_path / 'config.json').write_text('{"eos_token_id": [1, 2]}')
    assert hf_import.hf_eos_ids(str(tmp_path)) == [1, 2]


# ----------------------------------------------------------------- codec

def test_reader_matches_safetensors_on_sharded_bf16(tmp_path):
    """save_pretrained in bf16, sharded with an index: every tensor of
    every shard bit for bit and dtype for dtype as safe_open reads it."""
    from safetensors import safe_open
    model = _hf_model('qwen2').to(torch.bfloat16)
    model.save_pretrained(str(tmp_path), safe_serialization=True,
                          max_shard_size='40KB')
    shards = hf_import._shard_files(str(tmp_path))
    assert len(shards) > 1
    n = 0
    for path in shards:
        mine = safetensors_io.load_file(path)
        with safe_open(path, framework='pt') as f:
            assert sorted(mine) == sorted(f.keys())
            for key in f.keys():
                ref = f.get_tensor(key)
                assert mine[key].dtype == ref.dtype == torch.bfloat16
                assert torch.equal(mine[key].view(torch.int16),
                                   ref.view(torch.int16)), key
                n += 1
    assert n == len(hf_import._load_tensors(str(tmp_path)))


def test_writer_reads_back_in_safetensors(tmp_path):
    from safetensors.torch import load_file
    gen = torch.Generator().manual_seed(0)
    tensors = {'w': torch.randn(3, 5, generator=gen).bfloat16(),
               'h': torch.randn(7, generator=gen).half(),
               'f': torch.randn(2, 2, generator=gen),
               'i': torch.arange(6, dtype=torch.int64).reshape(2, 3),
               'j': torch.arange(3, dtype=torch.int32),
               'b': torch.tensor([True, False, True]),
               'u': torch.arange(4, dtype=torch.uint8),
               'c': torch.tensor([-1, 2], dtype=torch.int8),
               's': torch.tensor(1.5)}
    path = str(tmp_path / 'w.safetensors')
    safetensors_io.save_file(tensors, path, metadata={'format': 'pt'})
    back = load_file(path)
    assert sorted(back) == sorted(tensors)
    for k, t in tensors.items():
        assert back[k].dtype == t.dtype and torch.equal(back[k], t), k
    mine = safetensors_io.load_file(path)
    for k, t in tensors.items():
        assert mine[k].dtype == t.dtype and torch.equal(mine[k], t), k
    assert safetensors_io.read_header(path)[1] == {'format': 'pt'}


def _rewrite_header(src, dst, edit):
    with open(src, 'rb') as f:
        (n,) = struct.unpack('<Q', f.read(8))
        header = json.loads(f.read(n))
        data = f.read()
    edit(header)
    blob = json.dumps(header).encode()
    with open(dst, 'wb') as f:
        f.write(struct.pack('<Q', len(blob)) + blob + data)


@pytest.mark.parametrize('corruption,needle', [
    ('truncated', 'truncated'), ('short_header', 'truncated'),
    ('overlap', 'overlap'), ('unknown_dtype', 'unknown dtype')])
def test_reader_refuses_corrupt_files_by_name(tmp_path, corruption,
                                              needle):
    src = str(tmp_path / 'ok.safetensors')
    safetensors_io.save_file({'a': torch.ones(4, 4), 'b': torch.zeros(8)},
                             src)
    bad = str(tmp_path / 'bad.safetensors')
    if corruption == 'truncated':
        with open(src, 'rb') as f:
            raw = f.read()
        with open(bad, 'wb') as f:
            f.write(raw[:-5])
    elif corruption == 'short_header':
        with open(bad, 'wb') as f:
            f.write(struct.pack('<Q', 1 << 20) + b'{}')
    elif corruption == 'overlap':
        def edit(h):
            h['b']['data_offsets'] = [32, 64]
        _rewrite_header(src, bad, edit)
    else:
        def edit(h):
            h['b']['dtype'] = 'F8_E9M9'
        _rewrite_header(src, bad, edit)
    with pytest.raises(safetensors_io.SafetensorsError, match=needle):
        safetensors_io.load_file(bad)


# ---------------------------------------------------------------- export

def test_export_serves_in_transformers_and_equals_jax(llama_hf, tmp_path):
    import transformers
    hf_dir, toks, want = llama_hf
    cfg, params = hf_import.load_hf_checkpoint(hf_dir)
    out = hf_export.save_hf_checkpoint(params, cfg, str(tmp_path / 'out'),
                                       source_dir=hf_dir)
    assert sorted(os.listdir(out)) == sorted(
        ['config.json', 'generation_config.json', 'model.safetensors',
         'tokenizer.json'])
    model = transformers.LlamaForCausalLM.from_pretrained(out).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(toks).long()).logits.float().numpy()
    assert np.max(np.abs(got - want)) < TOL_LOGITS
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    mine = hf_export.hf_tensors_from_params(params, cfg)
    _, jparams = jhf_import.load_hf_checkpoint(hf_dir)
    jcfg = jhf_import.load_hf_config(hf_dir)
    ref = jhf_export.hf_tensors_from_params(jparams, jcfg)
    assert sorted(mine) == sorted(ref)
    for k, t in mine.items():
        np.testing.assert_array_equal(t.numpy(), ref[k], err_msg=k)
    # Round trip through the port's own reader, bit for bit.
    cfg2, params2 = hf_import.load_hf_checkpoint(out)
    assert cfg2 == cfg
    for (k, a), (_, b) in zip(_leaves(params), _leaves(params2)):
        assert torch.equal(a, b), k


@pytest.mark.parametrize('name', ['llama3.2-1b', 'qwen2.5-1.5b',
                                  'gpt-oss-20b-dense'])
def test_minimal_hf_config_equals_jax(name):
    from skypilot_tpu.models import llama as jllama
    if name == 'gpt-oss-20b-dense':
        # A dense config with yarn scaling and its attention factor.
        rs = dict(rope_type='yarn', factor=32.0, original_max_position=4096,
                  attention_factor=1.2)
        cfg = dataclasses.replace(config.get_config('llama3.2-1b'),
                                  rope_scaling=config.RopeScaling(**rs))
        jcfg = dataclasses.replace(jllama.PRESETS['llama3.2-1b'],
                                   rope_scaling=rs)
    else:
        cfg, jcfg = config.get_config(name), jllama.PRESETS[name]
    assert hf_export._minimal_hf_config(cfg) == \
        jhf_export._minimal_hf_config(jcfg)
    if name != 'gpt-oss-20b-dense':
        back = hf_import.config_from_hf(hf_export._minimal_hf_config(cfg))
        assert back == dataclasses.replace(cfg, head_dim=cfg.hd)


def test_export_refuses_what_import_cannot_read(tmp_path):
    cfg = config.get_config('moe-debug')
    with pytest.raises(ValueError, match='dense Llama/Qwen2'):
        hf_export.save_hf_checkpoint({}, cfg, str(tmp_path))


# ------------------------------------------------------------- tokenizer

def test_tokenizer_family_eos_and_ids_equal_jax(llama_hf, qwen_hf):
    for hf_dir, family, eos in ((llama_hf[0], 'llama3', {257, 260}),
                                (qwen_hf[0], 'chatml', {256, 257, 258})):
        mine = tokenizer.load_tokenizer(hf_dir, eos_extra=[257])
        ref = jtokenizer.load_tokenizer(hf_dir, eos_extra=[257])
        assert mine.chat_family == ref.chat_family == family
        assert set(mine.eos_ids) == set(ref.eos_ids) == eos
        assert mine.vocab_size == ref.vocab_size
        text = 'héllo wörld… <|eot_id|><|im_end|>'
        for add in (True, False):
            assert mine.encode(text, add_special_tokens=add) == \
                ref.encode(text, add_special_tokens=add)
        ids = mine.encode(text)
        assert mine.decode(ids) == ref.decode(ids)
    t = tokenizer.load_tokenizer(llama_hf[0])
    assert t.encode('<|eot_id|>') == [260]
    assert t.decode([260, *t.encode('hi')]) == 'hi'


def test_chat_templates_equal_jax_exactly():
    msgs = [{'role': 'system', 'content': 'be brief'},
            {'role': 'user', 'content': 'hi'},
            {'role': 'assistant', 'content': 'hello'},
            {'role': 'user', 'content': 'again'}]
    for family in ('llama3', 'chatml', 'plain'):
        assert tokenizer.apply_chat_template(msgs, family) == \
            jtokenizer.apply_chat_template(msgs, family)
    assert tokenizer.apply_chat_template(msgs[:2], 'chatml') == (
        '<|im_start|>system\nbe brief<|im_end|>\n'
        '<|im_start|>user\nhi<|im_end|>\n<|im_start|>assistant\n')
    assert tokenizer.apply_chat_template(msgs[1:2], 'plain') == \
        'user: hi\nassistant:'


@pytest.mark.parametrize('bad', [
    [], [{'role': 'hacker', 'content': 'x'}], [{'role': 'user'}],
    [{'role': 'user', 'content': 3}], 'not a list', ['x']])
def test_chat_template_validation_errors_as_jax(bad):
    with pytest.raises(ValueError) as mine:
        tokenizer.apply_chat_template(bad, 'llama3')
    with pytest.raises(ValueError) as ref:
        jtokenizer.apply_chat_template(bad, 'llama3')
    assert str(mine.value) == str(ref.value)
    with pytest.raises(ValueError, match='unknown chat family'):
        tokenizer.apply_chat_template([{'role': 'user', 'content': 'x'}],
                                      'jinja')


def test_stream_decoder_is_utf8_safe_over_an_hf_tokenizer(llama_hf):
    t = tokenizer.load_tokenizer(llama_hf[0])
    text = 'héllo… 日本'
    for tok in (t, tokenizer.ByteTokenizer()):
        sd, jsd = tokenizer.StreamDecoder(tok), jtokenizer.StreamDecoder(tok)
        ids = tok.encode(text, add_special_tokens=False)
        deltas = [sd.feed([i]) for i in ids]
        assert deltas == [jsd.feed([i]) for i in ids]
        assert '�' not in ''.join(deltas)
        assert ''.join(deltas) + sd.flush() == text


def test_missing_tokenizer_or_library_raises_by_name(tmp_path, llama_hf,
                                                     monkeypatch):
    with pytest.raises(FileNotFoundError, match='tokenizer.json'):
        tokenizer.load_tokenizer(str(tmp_path))
    monkeypatch.setitem(sys.modules, 'tokenizers', None)
    with pytest.raises(ImportError, match='tokenizers library'):
        tokenizer.load_tokenizer(llama_hf[0])


# ---------------------------------------------------------------- engine

def _run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


def _jax_post(eng, path, body):
    """One POST to the JAX engine's aiohttp app: (status, raw body)."""
    async def inner():
        client = TestClient(AioTestServer(jengine.build_app(eng)))
        await client.start_server()
        try:
            r = await client.post(path, json=body)
            return r.status, await r.read()
        finally:
            await client.close()
    return _run(inner())


def _post(base, path, body):
    req = urllib.request.Request(base + path, data=json.dumps(body).encode(),
                                 headers={'Content-Type': 'application/json'})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _events(raw: bytes):
    blocks = [b for b in raw.decode().split('\n\n') if b]
    assert blocks[-1] == 'data: [DONE]'
    return [json.loads(b[len('data: '):]) for b in blocks[:-1]]


class _Served:
    """The port's engine behind its HTTP server on a thread."""

    def __init__(self, eng):
        self.eng = eng
        self.server = engine_lib.build_app(eng)
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()
        eng.start()
        self.base = f'http://127.0.0.1:{self.server.server_address[1]}'
        deadline = time.monotonic() + 120
        while True:
            try:
                with urllib.request.urlopen(self.base + '/health') as r:
                    if r.status == 200:
                        break
            except urllib.error.HTTPError:
                pass
            assert time.monotonic() < deadline
            time.sleep(0.02)

    def post(self, path, body):
        return _post(self.base, path, body)

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.eng.stop()
        self.thread.join(10)


def _port_engine(**kw):
    """The port's engine at fp32 compute, as JAX's test sets its engine
    (the params cast to the checkpoint config's bf16 first, on both
    sides)."""
    eng = engine_lib.InferenceEngine(device='cpu', max_len=128, **kw)
    eng.cfg = dataclasses.replace(eng.cfg, dtype=torch.float32)
    return _Served(eng)


def _jax_engine(model, **kw):
    eng = jengine.InferenceEngine(model, max_len=128, **kw)
    eng.cfg = dataclasses.replace(eng.cfg, dtype=jnp.float32)
    eng.warmup()
    return eng


@pytest.fixture(scope='module')
def hf_engines(llama_hf):
    served = _port_engine(model=None, hf_dir=llama_hf[0])
    yield served, _jax_engine(None, hf_dir=llama_hf[0])
    served.close()


_CHAT = {'messages': [{'role': 'system', 'content': 'be brief'},
                      {'role': 'user', 'content': 'Say hi'}],
         'max_tokens': 8, 'temperature': 0}


def test_hf_engine_names_the_model_and_loads_the_real_tokenizer(
        hf_engines, llama_hf):
    served, jeng = hf_engines
    assert served.eng.model_name == jeng.model_name == \
        os.path.basename(llama_hf[0])
    assert served.eng.tokenizer.chat_family == 'llama3'
    assert served.eng.tokenizer.eos_ids == jeng.tokenizer.eos_ids
    with urllib.request.urlopen(served.base + '/v1/models') as r:
        assert json.loads(r.read())['data'][0]['id'] == \
            served.eng.model_name


def test_chat_nonstream_equals_jax_engine(hf_engines):
    served, jeng = hf_engines
    body = dict(_CHAT, logprobs=True, top_logprobs=2)
    code, raw = served.post('/v1/chat/completions', body)
    jcode, jraw = _jax_post(jeng, '/v1/chat/completions', body)
    assert code == jcode == 200
    doc, ref = json.loads(raw), json.loads(jraw)
    assert doc['object'] == ref['object'] == 'chat.completion'
    c, rc = doc['choices'][0], ref['choices'][0]
    assert c['message'] == rc['message']
    assert c['finish_reason'] == rc['finish_reason']
    assert doc['usage'] == ref['usage']
    assert doc['usage']['prompt_tokens'] > 10        # the template's
    assert [e['token'] for e in c['logprobs']['content']] == \
        [e['token'] for e in rc['logprobs']['content']]
    for e, r in zip(c['logprobs']['content'], rc['logprobs']['content']):
        assert abs(e['logprob'] - r['logprob']) < 1e-3
        assert [t['token'] for t in e['top_logprobs']] == \
            [t['token'] for t in r['top_logprobs']]


def test_chat_greedy_tokens_equal_jax_engine(hf_engines):
    """The greedy tokens behind a chat answer: /generate on the
    templated prompt's ids, port and JAX, with the template encoded
    without the post-processor's specials."""
    served, jeng = hf_engines
    prompt = tokenizer.apply_chat_template(_CHAT['messages'], 'llama3')
    ids = served.eng.tokenizer.encode(prompt, add_special_tokens=False)
    assert ids == jeng.tokenizer.encode(prompt, add_special_tokens=False)
    assert ids.count(served.eng.tokenizer.token_to_id(
        '<|begin_of_text|>')) == 1
    body = {'tokens': ids, 'max_new_tokens': 16}
    code, raw = served.post('/generate', body)
    jcode, jraw = _jax_post(jeng, '/generate', body)
    assert code == jcode == 200
    assert json.loads(raw)['tokens'] == json.loads(jraw)['tokens']


def test_chat_stream_equals_nonstream_and_jax_stream(hf_engines):
    served, jeng = hf_engines
    code, raw = served.post('/v1/chat/completions', _CHAT)
    want = json.loads(raw)['choices'][0]['message']['content']
    code, raw = served.post('/v1/chat/completions', dict(_CHAT, stream=True))
    assert code == 200
    events = _events(raw)
    jcode, jraw = _jax_post(jeng, '/v1/chat/completions',
                            dict(_CHAT, stream=True))
    jevents = _events(jraw)
    assert events[0]['object'] == 'chat.completion.chunk'
    assert events[0]['choices'][0]['delta'] == {'role': 'assistant',
                                                'content': ''}
    text = ''.join(e['choices'][0]['delta'].get('content', '')
                   for e in events[1:])
    assert text == want == ''.join(
        e['choices'][0]['delta'].get('content', '') for e in jevents[1:])
    assert events[-1]['choices'][0]['finish_reason'] == \
        jevents[-1]['choices'][0]['finish_reason']
    assert events[-1]['choices'][0]['delta'] == {}


def test_eos_and_stop_strings_end_generation(hf_engines):
    served, jeng = hf_engines
    code, raw = served.post('/generate', {'tokens': [5, 6, 7],
                                          'max_new_tokens': 8})
    first = json.loads(raw)['tokens'][0]
    code, raw = served.post('/generate', {'tokens': [5, 6, 7],
                                          'max_new_tokens': 8,
                                          'stop_token_ids': [first]})
    assert json.loads(raw)['tokens'] == []
    assert json.loads(raw)['finish_reason'] == 'stop'
    # The tokenizer's eos ids stop /v1 requests: a prompt whose greedy
    # continuation is an eos id ends at once (the engine excludes it).
    served.eng.tokenizer.eos_ids.append(first)
    try:
        body = {'prompt': [5, 6, 7], 'max_tokens': 8, 'temperature': 0}
        code, raw = served.post('/v1/completions', body)
        assert json.loads(raw)['usage']['completion_tokens'] == 0
        assert json.loads(raw)['choices'][0]['finish_reason'] == 'stop'
        code, raw = served.post('/v1/completions',
                                dict(body, ignore_eos=True, max_tokens=5))
        assert json.loads(raw)['usage']['completion_tokens'] == 5
    finally:
        served.eng.tokenizer.eos_ids.remove(first)
    code, raw = served.post('/v1/chat/completions', dict(_CHAT))
    full = json.loads(raw)['choices'][0]['message']['content']
    assert full
    body = dict(_CHAT, stop=[full[1:3]])
    code, raw = served.post('/v1/chat/completions', body)
    jcode, jraw = _jax_post(jeng, '/v1/chat/completions', body)
    c = json.loads(raw)['choices'][0]
    assert c == {**json.loads(jraw)['choices'][0], 'logprobs': None}
    assert c['message']['content'] == full[:full.index(full[1:3])]
    assert c['finish_reason'] == 'stop'
    code, raw = served.post('/v1/chat/completions', dict(body, stream=True))
    events = _events(raw)
    assert ''.join(e['choices'][0]['delta'].get('content', '')
                   for e in events) == c['message']['content']
    assert [e['choices'][0]['finish_reason'] for e in events
            if e['choices'][0]['finish_reason']] == ['stop']


def test_chatml_serving_on_qwen2(qwen_hf):
    served = _port_engine(model=None, hf_dir=qwen_hf[0])
    try:
        assert served.eng.tokenizer.chat_family == 'chatml'
        code, raw = served.post('/v1/chat/completions', {
            'messages': [{'role': 'user', 'content': 'hi'}],
            'max_tokens': 4, 'temperature': 0})
        assert code == 200
        doc = json.loads(raw)
        prompt = '<|im_start|>user\nhi<|im_end|>\n<|im_start|>assistant\n'
        assert doc['usage']['prompt_tokens'] == len(
            served.eng.tokenizer.encode(prompt, add_special_tokens=False))
        assert doc['choices'][0]['finish_reason'] in ('stop', 'length')
    finally:
        served.close()


@pytest.fixture(scope='module')
def trained_ckpt(tmp_path_factory):
    """A port-trainer checkpoint of llama-debug: 2 fp32 steps on the
    CPU."""
    d = str(tmp_path_factory.mktemp('ck'))
    trainer.train(trainer.TrainerConfig(
        model='llama-debug', batch_size=2, seq_len=16, total_steps=2,
        warmup_steps=1, log_every=1, ckpt_dir=d, device='cpu'))
    return d


def test_ckpt_engine_restores_params_only_and_equals_jax(trained_ckpt):
    cfg = config.get_config('llama-debug')
    with checkpoints.Checkpointer(trained_ckpt) as ck:
        params, step = ck.restore_params(cfg, 'cpu')
        state = ck.restore_tree(checkpoints.abstract_train_state(
            cfg, train_lib.default_optimizer()), step, 'cpu')
    assert step == 2
    for (k, a), (_, b) in zip(_leaves(params), _leaves(state.params)):
        assert torch.equal(a, b.detach()), k
    served = _port_engine(model='llama-debug', ckpt_dir=trained_ckpt)
    jeng = _jax_engine('llama-debug', ckpt_dir=trained_ckpt)
    try:
        for prompt in ([5, 6, 7], list(range(1, 40))):
            body = {'tokens': prompt, 'max_new_tokens': 12}
            code, raw = served.post('/generate', body)
            jcode, jraw = _jax_post(jeng, '/generate', body)
            assert code == jcode == 200
            assert json.loads(raw)['tokens'] == json.loads(jraw)['tokens']
    finally:
        served.close()


def test_engine_flags_parse_and_exclusive_dirs_are_refused(tmp_path):
    args = engine_lib.build_parser().parse_args(
        ['--hf-dir', 'h', '--tokenizer', 't.json', '--ckpt-dir', 'c'])
    assert (args.hf_dir, args.tokenizer, args.ckpt_dir, args.model) == \
        ('h', 't.json', 'c', None)
    assert engine_lib.build_parser().parse_args([]).model is None
    with pytest.raises(ValueError, match='exclusive'):
        engine_lib.main(['--hf-dir', 'h', '--ckpt-dir', 'c', '--device',
                         'cpu'])
    with pytest.raises(ValueError, match='exclusive'):
        engine_lib.InferenceEngine('llama-debug', ckpt_dir='c', hf_dir='h',
                                   device='cpu')
    with pytest.raises(FileNotFoundError, match='ckpt-dir'):
        engine_lib.InferenceEngine('llama-debug', ckpt_dir=str(tmp_path / 'x'),
                                   device='cpu')
    with pytest.raises(FileNotFoundError, match='No complete checkpoint'):
        engine_lib.InferenceEngine('llama-debug', ckpt_dir=str(tmp_path),
                                   device='cpu')


def test_hf_dir_without_tokenizer_json_is_refused(llama_hf, tmp_path):
    """No byte fallback for a real vocabulary: an HF dir without its
    tokenizer.json raises, unless --tokenizer names one."""
    for name in ('config.json', 'model.safetensors'):
        os.link(os.path.join(llama_hf[0], name), str(tmp_path / name))
    with pytest.raises(FileNotFoundError, match='tokenizer.json'):
        engine_lib.InferenceEngine(None, hf_dir=str(tmp_path), device='cpu')
    eng = engine_lib.InferenceEngine(
        None, hf_dir=str(tmp_path), device='cpu',
        tokenizer_path=os.path.join(llama_hf[0], 'tokenizer.json'))
    assert eng.tokenizer.chat_family == 'llama3'


# --------------------------------------------------- trainer and batch_infer

def _capture_losses(monkeypatch, module, name='make_train_step'):
    """Wrap ``module.make_train_step`` so each step's unrounded loss is
    recorded."""
    losses = []
    real = getattr(module, name)

    def make(*a, **kw):
        step = real(*a, **kw)

        def wrapped(state, batch, *rest):
            state, metrics = step(state, batch, *rest)
            losses.append(float(metrics['loss']))
            return state, metrics
        return wrapped
    monkeypatch.setattr(module, name, make)
    return losses


def test_trainer_hf_dir_first_loss_equals_jax(llama_hf, monkeypatch):
    common = dict(model='llama-1b', batch_size=8, seq_len=16,
                  total_steps=1, warmup_steps=1, log_every=1,
                  hf_dir=llama_hf[0])
    jlosses = _capture_losses(monkeypatch, jtrain_lib)
    jtrainer.train(jtrainer.TrainerConfig(
        model_overrides={'dtype': jnp.float32}, **common))
    losses = _capture_losses(monkeypatch, train_lib)
    hist = trainer.train(trainer.TrainerConfig(
        model_overrides={'dtype': torch.float32}, device='cpu', **common))
    assert len(losses) == len(jlosses) == 1 and hist[0]['step'] == 1
    assert abs(losses[0] - jlosses[0]) <= TOL_LOSS_REL * abs(jlosses[0])


def test_trainer_hf_dir_resume_never_reads_the_hf_weights(
        llama_hf, tmp_path, monkeypatch):
    reads = []
    real = hf_import.load_hf_checkpoint

    def counted(*a, **kw):
        reads.append(kw.get('dtype'))
        return real(*a, **kw)
    monkeypatch.setattr(hf_import, 'load_hf_checkpoint', counted)
    argv = ['--hf-dir', llama_hf[0], '--batch-size', '2', '--seq-len', '16',
            '--log-every', '1', '--ckpt-dir', str(tmp_path), '--ckpt-every',
            '1', '--device', 'cpu']
    trainer.main(argv + ['--steps', '2'])
    assert reads == [torch.float32]
    monkeypatch.setattr(hf_import, 'load_hf_checkpoint',
                        lambda *a, **kw: pytest.fail('resume read HF weights'))
    trainer.main(argv + ['--steps', '3'])
    assert checkpoints.Checkpointer(str(tmp_path)).latest_step() == 3
    with pytest.raises(NotImplementedError, match='--lora-rank.*ROADMAP'):
        trainer.main(argv + ['--steps', '4', '--lora-rank', '4'])


def _bi_args(**kw):
    import argparse
    base = dict(input=None, output=None, mode='generate', model=None,
                hf_dir=None, tokenizer=None, mesh={}, batch_size=2,
                max_len=128, max_new_tokens=8, temperature=0.0, top_k=None,
                top_p=None, seed=0, pool='mean', num_workers=1, worker_id=0,
                device='cpu')
    base.update(kw)
    return argparse.Namespace(**base)


def _fp32_configs(monkeypatch):
    """Both importers hand out fp32-compute configs (the runners build
    their own from the HF dir)."""
    real, jreal = hf_import.config_from_hf, jhf_import.config_from_hf
    monkeypatch.setattr(hf_import, 'config_from_hf',
                        lambda raw: dataclasses.replace(
                            real(raw), dtype=torch.float32))
    monkeypatch.setattr(jhf_import, 'config_from_hf',
                        lambda raw: dataclasses.replace(
                            jreal(raw), dtype=jnp.float32))


@pytest.mark.parametrize('flag', ['--hf-dir', '--tokenizer'])
def test_batch_infer_hf_records_equal_jax(flag, llama_hf, tmp_path,
                                          monkeypatch):
    """batch_infer over an HF checkpoint (or its tokenizer.json named by
    --tokenizer) writes, record for record, what JAX's writes: greedy,
    fp32 compute on both sides."""
    _fp32_configs(monkeypatch)
    inp = str(tmp_path / 'in.jsonl')
    with open(inp, 'w', encoding='utf-8') as f:
        for i, p in enumerate(['hello', 'héllo wörld', 'a', 'bb ' * 9]):
            f.write(json.dumps({'id': i, 'prompt': p}) + '\n')
    kw = dict(input=inp, hf_dir=llama_hf[0])
    if flag == '--tokenizer':
        kw['tokenizer'] = os.path.join(llama_hf[0], 'tokenizer.json')
    out, jout = str(tmp_path / 'o.jsonl'), str(tmp_path / 'j.jsonl')
    assert batch_infer.run(_bi_args(output=out, **kw))['ran'] == 4
    jbatch_infer.run(_bi_args(output=jout, **kw))
    mine = sorted((json.loads(line) for line in open(out)),
                  key=lambda r: r['id'])
    ref = sorted((json.loads(line) for line in open(jout)),
                 key=lambda r: r['id'])
    assert mine == ref
    assert any(r['tokens'] > 0 for r in mine)


def test_batch_runner_hf_tokenizer_precedence(llama_hf, qwen_hf):
    runner = batch_infer.BatchRunner(hf_dir=llama_hf[0], device='cpu')
    assert runner.tokenizer.chat_family == 'llama3'
    assert 257 in runner.tokenizer.eos_ids
    runner = batch_infer.BatchRunner(
        hf_dir=llama_hf[0], device='cpu',
        tokenizer_path=os.path.join(qwen_hf[0], 'tokenizer.json'))
    assert runner.tokenizer.chat_family == 'chatml'
    assert 257 in runner.tokenizer.eos_ids      # the checkpoint's eos
    with pytest.raises(ValueError, match='need --model or --hf-dir'):
        batch_infer.BatchRunner(device='cpu')
