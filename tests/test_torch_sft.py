"""Chat SFT in the port (data/sft.py, the SFT source of
data_service/spec.py, the loader's --tokenizer and the trainer's
--sft-data) against the JAX package, on the CPU.

The JAX side tokenizes with the tokenizers library (and the loader with
transformers' AutoTokenizer), the port with its own reader, on the
committed fixtures of tests/data (make_torch_tokenizer_fixtures.py) and
on the byte tokenizer. Arrays and batches are held bit for bit; the
trainers' losses (fp32, llama-debug cut to one narrow layer, the same
bridged weights, and for LoRA the JAX trainer's own adapter init
bridged) within 2e-4 absolute, the 4-decimal rounding both trainers log
with (tests/test_torch_trainer.py's bound). The first block repeats
tests/unit_tests/test_sft.py's assertions on the port.
"""
import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), 'data'))
import make_torch_tokenizer_fixtures as fixtures  # noqa: E402
from skypilot_tpu.data import loader as jloader  # noqa: E402
from skypilot_tpu.data import sft as jsft  # noqa: E402
from skypilot_tpu.data import tokenizer as jtokenizer  # noqa: E402
from skypilot_tpu.data_service import spec as jspec  # noqa: E402
from skypilot_tpu.models import llama as jllama  # noqa: E402
from skypilot_tpu.train import lora as jlora  # noqa: E402
from skypilot_tpu.train import trainer as jtrainer  # noqa: E402
from skypilot_tpu_torch import config  # noqa: E402
from skypilot_tpu_torch.data import loader, sft  # noqa: E402
from skypilot_tpu_torch.data import tokenizer as tokenizer_lib  # noqa: E402
from skypilot_tpu_torch.data_service import spec as spec_lib  # noqa: E402
from skypilot_tpu_torch.models import weights  # noqa: E402
from skypilot_tpu_torch.train import lora, trainer  # noqa: E402

_CONVO = [{'role': 'user', 'content': 'hi'},
          {'role': 'assistant', 'content': 'hello!'},
          {'role': 'user', 'content': 'more'},
          {'role': 'assistant', 'content': 'sure'}]
SMALL = {'n_layers': 1, 'dim': 32, 'ffn_dim': 64, 'max_seq_len': 64}
# The fixtures' vocabularies (3009 and 2505 ids) fit in this model vocab.
FIXTURE_VOCAB = 3072
TOL_LOSS = 2e-4


def _write(path, convos):
    with open(path, 'w', encoding='utf-8') as f:
        for c in convos:
            f.write(json.dumps({'messages': c}) + '\n')


# --------------------------------- tests/unit_tests/test_sft.py, ported

def test_llama3_concatenation_matches_chat_template():
    segs = sft.render_segments(_CONVO, 'llama3')
    joined = ''.join(t for t, _ in segs)
    want = tokenizer_lib.apply_chat_template(_CONVO, 'llama3')
    opener = '<|start_header_id|>assistant<|end_header_id|>\n\n'
    assert want == joined + opener
    assert [t for t, is_t in segs if is_t] == ['hello!<|eot_id|>',
                                               'sure<|eot_id|>']
    for family in ('llama3', 'chatml', 'plain'):
        assert sft.render_segments(_CONVO, family) == \
            jsft.render_segments(_CONVO, family)


def test_chatml_and_plain_targets():
    for family, want in (('chatml', ['hello!<|im_end|>\n',
                                     'sure<|im_end|>\n']),
                         ('plain', ['hello!\n', 'sure\n'])):
        segs = sft.render_segments(_CONVO, family)
        assert [t for t, is_t in segs if is_t] == want


def test_bad_family_and_messages_fail():
    with pytest.raises(ValueError, match='family'):
        sft.render_segments(_CONVO, 'nope')
    with pytest.raises(ValueError):
        sft.render_segments([{'role': 'alien', 'content': 'x'}], 'plain')


def test_mask_gates_positions_predicting_assistant_tokens():
    """mask[t] == 1 iff tokens[t+1] is an assistant token (byte
    tokenizer: one character, one token)."""
    tok = tokenizer_lib.ByteTokenizer()
    convo = [{'role': 'user', 'content': 'ab'},
             {'role': 'assistant', 'content': 'XY'}]
    tokens, mask = sft.encode_example(convo, tok, 'plain', 32)
    text = 'user: ab\nassistant: XY\n'
    assert list(tokens[:len(text)]) == tok.encode(text)
    start = len('user: ab\nassistant: ')
    expect = np.zeros(32)
    for p in range(start, start + 3):
        expect[p - 1] = 1.0
    np.testing.assert_array_equal(mask, expect)


def test_truncation_and_padding():
    tok = tokenizer_lib.ByteTokenizer()
    convo = [{'role': 'user', 'content': 'q'},
             {'role': 'assistant', 'content': 'a' * 100}]
    tokens, mask = sft.encode_example(convo, tok, 'plain', 24)
    assert tokens.shape == (25,) and mask.shape == (24,)
    assert mask.sum() > 0
    _, mask_short = sft.encode_example(convo, tok, 'plain', 16)
    assert mask_short.sum() == 0
    short = [{'role': 'user', 'content': 'q'},
             {'role': 'assistant', 'content': 'a'}]
    tokens2, mask2 = sft.encode_example(short, tok, 'plain', 32)
    used = len(tok.encode('user: q\nassistant: a\n'))
    assert (tokens2[used:] == 0).all() and (mask2[used:] == 0).all()


def test_segments_carry_exactly_one_bos():
    """The Llama-3 fixture's post-processor adds BOS to a plain encode;
    SFT segments are encoded without it, so a conversation holds its one
    literal BOS, never a loss target."""
    tok = tokenizer_lib.load_tokenizer(fixtures.LLAMA3)
    bos_id = tok.token_to_id('<|begin_of_text|>')
    assert tok.chat_family == 'llama3'
    assert tok.encode('hi')[0] == bos_id
    assert tok.encode('hi', add_special_tokens=False)[0] != bos_id
    convo = [{'role': 'user', 'content': 'q'},
             {'role': 'assistant', 'content': 'a'}]
    tokens, mask = sft.encode_example(convo, tok, 'llama3', 64)
    assert int((tokens == bos_id).sum()) == 1
    for p in np.flatnonzero(tokens == bos_id):
        if p >= 1:
            assert mask[p - 1] == 0.0


def test_load_skips_untrainable_and_raises_on_empty(tmp_path):
    tok = tokenizer_lib.ByteTokenizer()
    path = str(tmp_path / 'chat.jsonl')
    _write(path, [_CONVO, [{'role': 'user', 'content': 'no reply'}]])
    tokens, _ = sft.load_sft_dataset(path, tok, 'plain', 64)
    assert tokens.shape[0] == 1
    _write(path, [[{'role': 'user', 'content': 'x'}]])
    with pytest.raises(ValueError, match='no trainable'):
        sft.load_sft_dataset(path, tok, 'plain', 64)
    with open(path, 'w') as f:
        f.write('{"turns": []}\n')
    with pytest.raises(ValueError, match='needs "messages"'):
        sft.load_sft_dataset(path, tok, 'plain', 64)


def test_batches_deterministic_and_epoch_shuffled():
    tokens = np.arange(10)[:, None].repeat(5, 1).astype(np.int32)
    masks = np.ones((10, 4), np.float32)
    b1 = sft.batch_at_step(tokens, masks, 3, 4)
    b2 = sft.batch_at_step(tokens, masks, 3, 4)
    np.testing.assert_array_equal(b1['tokens'], b2['tokens'])
    e0 = [sft.batch_at_step(tokens, masks, s, 5)['tokens'][:, 0]
          for s in (0, 1)]
    e1 = [sft.batch_at_step(tokens, masks, s, 5)['tokens'][:, 0]
          for s in (2, 3)]
    assert sorted(np.concatenate(e0)) == sorted(np.concatenate(e1))
    assert not np.array_equal(np.concatenate(e0), np.concatenate(e1))


def test_every_example_served_once_per_epoch_ragged_batch():
    n, bs = 10, 4
    tokens = np.arange(n)[:, None].repeat(3, 1).astype(np.int32)
    masks = np.ones((n, 2), np.float32)
    draws = np.concatenate(
        [sft.batch_at_step(tokens, masks, s, bs)['tokens'][:, 0]
         for s in range(5)])
    np.testing.assert_array_equal(np.bincount(draws, minlength=n), 2)


def test_sft_trains_and_masks_tokens(tmp_path):
    path = str(tmp_path / 'chat.jsonl')
    _write(path, [[{'role': 'user', 'content': f'question {i}'},
                   {'role': 'assistant', 'content': 'the answer'}]
                  for i in range(8)])
    history = trainer.train(trainer.TrainerConfig(
        model='llama-debug', batch_size=8, seq_len=48, total_steps=6,
        learning_rate=5e-3, warmup_steps=1, log_every=3, sft_data_path=path,
        device='cpu'))
    assert history[-1]['step'] == 6
    assert history[-1]['loss'] < history[0]['loss']


def test_sft_and_data_exclusive():
    with pytest.raises(ValueError, match='exclusive'):
        trainer.train(trainer.TrainerConfig(
            model='llama-debug', sft_data_path='a', data_path='b',
            device='cpu'))
    with pytest.raises(ValueError, match='exclusive'):
        spec_lib.DatasetSpec(batch_size=1, seq_len=8, vocab_size=256,
                             data_path='a', sft_data_path='b')
    with pytest.raises(ValueError, match='--sft-data and --data'):
        trainer.main(['--sft-data', 'a', '--data', 'b', '--device', 'cpu'])


# ------------------------------------------------- arrays against JAX

def _tokenizers(name):
    """(the port's, JAX's) tokenizer: 'byte' or a fixture."""
    if name == 'byte':
        return tokenizer_lib.ByteTokenizer(), jtokenizer.ByteTokenizer()
    path = fixtures.FIXTURES[name]
    return (tokenizer_lib.load_tokenizer(path),
            jtokenizer.load_tokenizer(path))


@pytest.mark.parametrize('name', ['byte', 'llama3', 'qwen2'])
def test_dataset_and_batches_bit_equal_jax(name):
    mine, ref = _tokenizers(name)
    family = mine.chat_family
    assert family == ref.chat_family
    for seq_len in (64, 512):
        got = sft.load_sft_dataset(fixtures.SFT_JSONL, mine, family, seq_len)
        want = jsft.load_sft_dataset(fixtures.SFT_JSONL, ref, family,
                                     seq_len)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        for step in (0, 1, 7, 15, 16, 200):
            b = sft.batch_at_step(*got, step, 4)
            jb = jsft.batch_at_step(*want, step, 4)
            assert sorted(b) == sorted(jb) == ['loss_mask', 'tokens']
            for k in b:
                np.testing.assert_array_equal(b[k], jb[k])


@pytest.mark.parametrize('name', sorted(fixtures.FIXTURES))
def test_golden_sft_digests(name):
    """At the sft phase's shapes (seq_len 2048, batch 4): the dataset and
    the first batch digest as the JAX package's, made with the library,
    in the golden file."""
    with open(fixtures.GOLDEN, encoding='utf-8') as f:
        want = json.load(f)['sft'][name]
    tok, _ = _tokenizers(name)
    tokens, masks = sft.load_sft_dataset(fixtures.SFT_JSONL, tok,
                                         tok.chat_family, want['seq_len'])
    first = sft.batch_at_step(tokens, masks, 0, fixtures.SFT_BATCH)
    assert fixtures.digest(tokens, masks) == want['dataset']
    assert fixtures.digest(first['tokens'], first['loss_mask']) == \
        want['first_batch']
    assert tokens.shape[0] == want['rows'] == 63
    # Some conversations are longer than a row: their tail is cut.
    assert int((tokens[:, -1] != 0).sum()) >= 4


@pytest.mark.parametrize('tokenizer,family', [
    (None, None), ('llama3', None), ('qwen2', None), ('llama3', 'plain')])
def test_sft_source_equals_jax(tokenizer, family):
    path = fixtures.FIXTURES.get(tokenizer)
    args = dict(batch_size=4, seq_len=128, vocab_size=FIXTURE_VOCAB,
                sft_data_path=fixtures.SFT_JSONL, tokenizer=path,
                chat_family=family)
    mine = spec_lib.load_source(spec_lib.DatasetSpec(**args))
    ref = jspec.load_source(jspec.DatasetSpec(**args))
    for step in (0, 1, 7, 123):
        got, want = mine.batch_at_step(step), ref.batch_at_step(step)
        assert sorted(got) == sorted(want)
        for k in got:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(ValueError, match='vocab'):
        spec_lib.load_source(spec_lib.DatasetSpec(**dict(args,
                                                         vocab_size=200)))


def test_loader_tokenizer_equals_jax_auto_tokenizer(tmp_path):
    """tokenize_text through a checkpoint directory (and its
    tokenizer.json path) equals the JAX loader's transformers
    AutoTokenizer on the same directory, BOS included; a hub name is
    refused by name."""
    d = tmp_path / 'ck'
    d.mkdir()
    (d / 'tokenizer.json').write_bytes(open(fixtures.LLAMA3, 'rb').read())
    (d / 'tokenizer_config.json').write_text(json.dumps(
        {'tokenizer_class': 'PreTrainedTokenizerFast'}))
    with open(fixtures.SFT_JSONL, encoding='utf-8') as f:
        text = f.read()[:20000] + ' Hopper <|eot_id|>'
    want = jloader.tokenize_text(text, str(d))
    bos = tokenizer_lib.load_tokenizer(str(d)).token_to_id(
        '<|begin_of_text|>')
    assert want[0] == bos
    for ref in (str(d), str(d / 'tokenizer.json')):
        got = loader.tokenize_text(text, ref)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    corpus = tmp_path / 'corpus.txt'
    corpus.write_text(text, encoding='utf-8')
    np.testing.assert_array_equal(loader.load_tokens(str(corpus), str(d)),
                                  want)
    with pytest.raises(ValueError, match='meta-llama/Llama-3.2-1B.*local'):
        loader.tokenize_text('hi', 'meta-llama/Llama-3.2-1B')


# ------------------------------------------------ trainers against JAX

def _port_params(overrides):
    jcfg = dataclasses.replace(jllama.PRESETS['llama-debug'],
                               dtype=jnp.float32, **overrides)
    tcfg = dataclasses.replace(config.PRESETS['llama-debug'],
                               dtype=torch.float32, **overrides)
    init = jax.device_get(jllama.init_params(jax.random.PRNGKey(0), jcfg))
    return init, weights.params_from_jax(init, tcfg, 'cpu')


_TRAIN = dict(model='llama-debug', batch_size=16, seq_len=48, total_steps=3,
              warmup_steps=1, learning_rate=1e-2, log_every=1,
              sft_data_path=fixtures.SFT_JSONL, tokenizer=fixtures.LLAMA3)


@pytest.fixture(scope='module')
def jax_sft_losses():
    """The JAX trainer's losses of _TRAIN (its 8-device CPU mesh) by LoRA
    rank, each run once for the module."""
    runs = {}

    def losses(lora_rank):
        if lora_rank not in runs:
            runs[lora_rank] = jtrainer.train(jtrainer.TrainerConfig(
                model_overrides=dict(SMALL, vocab_size=FIXTURE_VOCAB,
                                     dtype=jnp.float32),
                lora_rank=lora_rank, **_TRAIN))
        return runs[lora_rank]
    return losses


@pytest.mark.parametrize('mode', ['full', 'grad_accum', 'lora'])
def test_trainer_sft_losses_equal_jax(mode, jax_sft_losses, monkeypatch):
    """Three --sft-data steps on the Llama-3 fixture's tokenization, the
    port's trainer against the JAX trainer's from the same weights:
    full, with two microbatches, and LoRA rank 4 from JAX's own adapter
    init. The two microbatches are held against JAX's run of the whole
    batch: their masked token counts summed (not averaged per
    microbatch) give the whole batch's loss and grads."""
    overrides = dict(SMALL, vocab_size=FIXTURE_VOCAB)
    lora_rank = 4 if mode == 'lora' else 0
    ref = jax_sft_losses(lora_rank)
    init, params = _port_params(overrides)
    if mode == 'lora':
        jad = jax.device_get(jlora.init_adapters(
            jax.random.PRNGKey(1), init, jlora.LoRAConfig(rank=4)))
        monkeypatch.setattr(lora, 'init_adapters', lambda *a: (
            weights.adapters_from_jax(jad, 'cpu')))
    got = trainer.train(trainer.TrainerConfig(
        model_overrides=dict(overrides, dtype=torch.float32), device='cpu',
        grad_accum_steps=2 if mode == 'grad_accum' else 1,
        lora_rank=lora_rank, **_TRAIN), params=params)
    assert [r['step'] for r in got] == [r['step'] for r in ref] == [1, 2, 3]
    np.testing.assert_allclose([r['loss'] for r in got],
                               [r['loss'] for r in ref], atol=TOL_LOSS,
                               rtol=0)
    assert got[2]['loss'] != got[0]['loss']


def test_trainer_hf_dir_sft_needs_its_tokenizer_json(tmp_path):
    """--sft-data with --hf-dir and no --tokenizer reads the directory's
    tokenizer.json; without one it raises (no byte fallback), as JAX's
    trainer does."""
    spec = trainer._dataset_spec(trainer.TrainerConfig(
        hf_dir=str(tmp_path), sft_data_path='c.jsonl'), 256)
    assert spec.tokenizer == os.path.join(str(tmp_path), 'tokenizer.json')
    assert trainer._dataset_spec(trainer.TrainerConfig(
        hf_dir=str(tmp_path), sft_data_path='c.jsonl', tokenizer='t'),
        256).tokenizer == 't'
    assert trainer._dataset_spec(trainer.TrainerConfig(
        hf_dir=str(tmp_path)), 256).tokenizer is None
    with pytest.raises(FileNotFoundError, match='tokenizer.json'):
        spec_lib.load_source(spec)
