"""The port's tokenizer.json reader (data/tokenizer_json.py, behind
data/tokenizer.py's HFTokenizer) against the tokenizers library and the
JAX package's HFTokenizer, on the CPU.

Tokenizers: the committed fixtures of tests/data (a Llama-3-style and a
Qwen2/ChatML-style byte-level BPE, made by
make_torch_tokenizer_fixtures.py), a GPT-2-style one trained here
(ByteLevel with GPT-2's regex, with and without add_prefix_space), and
the merge-less byte-level tokenizer tests/test_torch_hf.py builds.
Texts: the fixture maker's TEXTS (non-ASCII letters and digits,
Oniguruma's whitespace, contractions in any case, digit groups, specials
inline and partial, partial UTF-8) and a seeded numpy generator of
mixed-script strings. Everything is held exactly: ids under both
``add_special_tokens`` values, decodes, ``vocab_size`` and
``token_to_id``.
"""
import copy
import json
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), 'data'))
import make_torch_tokenizer_fixtures as fixtures  # noqa: E402
from skypilot_tpu.data import tokenizer as jtokenizer  # noqa: E402
from skypilot_tpu_torch.data import tokenizer, tokenizer_json  # noqa: E402

LLAMA3_SPECIALS = fixtures.LLAMA3_SPECIALS


def _doc(path):
    with open(path, encoding='utf-8') as f:
        return json.load(f)


@pytest.fixture(scope='module')
def golden():
    with open(fixtures.GOLDEN, encoding='utf-8') as f:
        return json.load(f)


def _gpt2_style(add_prefix_space):
    """GPT-2's layout: ByteLevel (its regex) as the only pre-tokenizer,
    BPE trained on the README, <|endoftext|> as a special."""
    from tokenizers import (Tokenizer, decoders, models, pre_tokenizers,
                            trainers)
    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(
        add_prefix_space=add_prefix_space)
    tok.decoder = decoders.ByteLevel()
    with open(os.path.join(fixtures.ROOT, 'README.md'),
              encoding='utf-8') as f:
        text = f.read()
    tok.train_from_iterator([text], trainers.BpeTrainer(
        vocab_size=800, show_progress=False,
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet(),
        special_tokens=['<|endoftext|>']))
    return tok


def _merge_less():
    """tests/test_torch_hf.py's tokenizer: the 256-character byte
    alphabet, no merges, Llama 3's chat specials."""
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers
    alphabet = sorted(pre_tokenizers.ByteLevel.alphabet())
    tok = Tokenizer(models.BPE(vocab={c: i for i, c in enumerate(alphabet)},
                               merges=[]))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    tok.add_special_tokens(LLAMA3_SPECIALS)
    return tok


def _library(name):
    from tokenizers import Tokenizer
    if name in fixtures.FIXTURES:
        return Tokenizer.from_file(fixtures.FIXTURES[name])
    if name == 'merge_less':
        return _merge_less()
    return _gpt2_style(add_prefix_space=name == 'gpt2_prefix')


TOKENIZERS = ['llama3', 'qwen2', 'gpt2', 'gpt2_prefix', 'merge_less']


@pytest.fixture(scope='module', params=TOKENIZERS)
def pair(request):
    """(name, the library's Tokenizer, the port's reader of its json)."""
    lib = _library(request.param)
    return request.param, lib, tokenizer_json.TokenizerJson(
        json.loads(lib.to_str()))


# Characters of the generated strings: ASCII with apostrophes and case,
# Oniguruma's whitespace and the characters str.isspace adds, letters and
# digits of several scripts (fullwidth, Devanagari, Arabic-Indic, Roman
# numerals, math digits), case-folding traps, combining marks, emoji with
# joiners, and fragments of special tokens.
_POOL = (list("abcXYZ '\u2019sStTdDmMlLrReEvV0123456789.,;:!?-_()[]{}<>|/"
              "\\\"#$%&*+=@^`~\t\n\r ") +
         list('\x0b\x0c\x1c\x1d\x1e\x1f\x85\xa0\u1680\u2000\u2009\u200b'
              '\u2028\u2029\u202f\u3000\ufeff') +
         list('\u6771\u4eac\u65e5\u672c\u8a9e\ud55c\uad6d\uc5b4'
              '\u041f\u0440\u0438\u0432\u0435\u0442\u0928\u092e\u0938'
              '\u094d\u0924\u0947\u0661\u0662\u0645\u0631\u062d\u0966'
              '\u0967\uff10\uff11\u216b\u2163\u00bd\u00b2\u017f\u212a'
              '\u0130\u0131\u00df\ufb01\u01c5\u0301\u0308') +
         ['\U0001F44D\U0001F3FD', '\U0001F469\u200d\U0001F467',
          '\U0001F1EF\U0001F1F5', '\U00010400', '\U0001D7D8', '<|eot_id|>',
          '<|im_end|>', '<tool_call>', '<|', '|>', '<|begin_of_text|>'])


def _mixed_strings(seed, n=600):
    rng = np.random.default_rng(seed)
    return [''.join(_POOL[int(i)] for i in rng.integers(
        0, len(_POOL), int(rng.integers(0, 40)))) for _ in range(n)]


def test_golden_file_is_fresh(golden):
    """The library's side of the fixture maker, rerun on the committed
    tokenizers and JSONL, equals the committed golden file: ids,
    decodes, vocab sizes, the chat prompt and the SFT digests."""
    assert fixtures.golden() == golden
    for path in (fixtures.LLAMA3, fixtures.QWEN2, fixtures.SFT_JSONL,
                 fixtures.GOLDEN):
        assert os.path.getsize(path) < 300_000, path


@pytest.mark.parametrize('name', sorted(fixtures.FIXTURES))
def test_fixture_ids_and_decodes_equal_golden_and_jax(name, golden):
    want = golden['fixtures'][name]
    path = fixtures.FIXTURES[name]
    mine = tokenizer.load_tokenizer(path)
    ref = jtokenizer.load_tokenizer(path)
    assert mine.vocab_size == ref.vocab_size == want['vocab_size']
    assert (mine.chat_family, mine.eos_ids) == (ref.chat_family, ref.eos_ids)
    for text, row in zip(golden['texts'], want['rows']):
        assert mine.encode(text) == ref.encode(text) == row['ids'], text
        raw = mine.encode(text, add_special_tokens=False)
        assert raw == row['ids_raw'], text
        assert mine.decode(row['ids']) == ref.decode(row['ids']) == \
            row['decoded'], text


def test_fixture_round_trips_and_families(golden):
    """decode(encode(t)) == t for every golden text without specials;
    the Llama-3 fixture adds one BOS, the Qwen2 one none; the families
    and stop specials are Llama 3's and ChatML's."""
    llama = tokenizer.load_tokenizer(fixtures.LLAMA3)
    qwen = tokenizer.load_tokenizer(fixtures.QWEN2)
    bos = llama.token_to_id('<|begin_of_text|>')
    for text in golden['texts']:
        if '<|' in text:
            continue
        assert llama.decode(llama.encode(text)) == text
        assert llama.encode(text) == [bos] + llama.encode(
            text, add_special_tokens=False)
        assert qwen.encode(text) == qwen.encode(text,
                                                add_special_tokens=False)
    assert llama.chat_family == 'llama3' and qwen.chat_family == 'chatml'
    assert llama.token_to_id('<|eot_id|>') in llama.eos_ids
    assert qwen.token_to_id('<|im_end|>') in qwen.eos_ids


def test_reader_equals_library_on_mixed_script_strings(pair):
    name, lib, mine = pair
    assert mine.vocab_size == lib.get_vocab_size()
    rng = np.random.default_rng(7)
    for text in _mixed_strings(TOKENIZERS.index(name)):
        for special in (True, False):
            assert mine.encode(text, special) == lib.encode(
                text, add_special_tokens=special).ids, (name, text)
        ids = lib.encode(text).ids
        for skip in (True, False):
            assert mine.decode(ids, skip) == lib.decode(
                ids, skip_special_tokens=skip), (name, text)
        # Random ids, some past the vocabulary (no token: nothing).
        ids = [int(i) for i in rng.integers(0, mine.vocab_size + 40, 10)]
        assert mine.decode(ids) == lib.decode(ids, skip_special_tokens=True)


def test_token_to_id_equals_library(pair):
    name, lib, mine = pair
    vocab = lib.get_vocab()
    for token in list(vocab)[::7] + LLAMA3_SPECIALS + [
            '<|endoftext|>', '<tool_call>', 'not a token', '']:
        assert mine.token_to_id(token) == lib.token_to_id(token), token
    for token, i in vocab.items():
        assert mine.id_to_token(i) == lib.id_to_token(i), token


def test_whitespace_and_letter_classes_follow_oniguruma():
    """\\s is Oniguruma's (no U+001C-001F, which str.isspace counts);
    \\p{L} and \\p{N} reach past ASCII and Latin-1."""
    ws = tokenizer_json.compile_pattern(r'\s+')
    for c in '\t\n\x0b\x0c\r \x85\xa0\u1680\u2000\u2009\u2028\u2029' \
             '\u202f\u3000':
        assert ws.fullmatch(c), hex(ord(c))
    for c in '\x1c\x1d\x1e\x1f\u200b\ufeffa':
        assert c.isspace() == (c in '\x1c\x1d\x1e\x1f')
        assert not ws.fullmatch(c), hex(ord(c))
    letters = tokenizer_json.compile_pattern(r'\p{L}+')
    digits = tokenizer_json.compile_pattern(r'\p{N}+')
    assert letters.fullmatch('\u6771\u4eac\u041f\u0930\u06d2\u01c5\u017f'
                             '\u212a\U00010400')
    assert digits.fullmatch('\uff10\uff11\u0968\u0663\u216b\u00bd\u00b2'
                            '\U0001d7d8')
    assert not letters.fullmatch('\u0301') and not digits.fullmatch('a')
    neg = tokenizer_json.compile_pattern(r'[^\r\n\p{L}\p{N}]?\p{L}+')
    assert neg.fullmatch(' \u6771') and not neg.fullmatch('\n\u6771')


def test_ignore_merges_takes_vocabulary_words_whole():
    """The Llama-3-style fixture holds whole words no merge builds: with
    ignore_merges each is one id, without it the merges split it; the
    library agrees both ways."""
    from tokenizers import Tokenizer
    doc = _doc(fixtures.LLAMA3)
    text = 'The Hopper card and the tokenizer on Kubernetes'
    on = tokenizer_json.TokenizerJson(doc)
    doc_off = copy.deepcopy(doc)
    doc_off['model']['ignore_merges'] = False
    off = tokenizer_json.TokenizerJson(doc_off)
    assert on.encode(text) == Tokenizer.from_file(
        fixtures.LLAMA3).encode(text).ids
    assert off.encode(text) == Tokenizer.from_str(
        json.dumps(doc_off)).encode(text).ids
    assert on.token_to_id('ĠHopper') in on.encode(text)
    assert len(off.encode(text)) > len(on.encode(text))


def test_merges_as_strings_or_lists_give_the_same_ids(golden):
    """Llama 3's "a b" strings and the newer [a, b] lists."""
    doc = _doc(fixtures.LLAMA3)
    assert isinstance(doc['model']['merges'][0], str)
    lists = copy.deepcopy(doc)
    lists['model']['merges'] = [m.split(' ')
                                for m in doc['model']['merges']]
    a = tokenizer_json.TokenizerJson(doc)
    b = tokenizer_json.TokenizerJson(lists)
    for text in golden['texts']:
        assert a.encode(text) == b.encode(text)


def test_added_token_ids_follow_the_library_not_the_file():
    """The library assigns added-token ids itself (file order, past the
    vocabulary), whatever ids the file states; an added token already in
    the vocabulary keeps the vocabulary's id, and vocab_size counts
    distinct contents."""
    from tokenizers import Tokenizer
    doc = json.loads(_merge_less().to_str())
    doc['added_tokens'] = doc['added_tokens'][::-1]
    doc['added_tokens'][0]['id'] = 9999
    doc['added_tokens'].append(dict(doc['added_tokens'][0], content='a',
                                    id=5000))
    lib = Tokenizer.from_str(json.dumps(doc))
    mine = tokenizer_json.TokenizerJson(doc)
    assert mine.vocab_size == lib.get_vocab_size() == 261
    for t in LLAMA3_SPECIALS + ['a']:
        assert mine.token_to_id(t) == lib.token_to_id(t), t
    text = 'a<|eot_id|>ba'
    assert mine.encode(text) == lib.encode(text).ids
    assert mine.decode(mine.encode(text)) == lib.decode(
        lib.encode(text).ids) == 'b'


def test_normalized_added_tokens_match_after_the_normalizer():
    """Added tokens marked normalized (GPT-2's own <|endoftext|> is) are
    matched on the NFC text the others left, as the library does."""
    from tokenizers import AddedToken, Tokenizer
    lib = Tokenizer.from_file(fixtures.QWEN2)
    lib.add_tokens([AddedToken('caf\u00e9', normalized=True),
                    AddedToken('<|im', normalized=True),
                    AddedToken('\u00e9 x', normalized=False)])
    mine = tokenizer_json.TokenizerJson(json.loads(lib.to_str()))
    for text in ('a caf\u00e9 b', 'a cafe\u0301 b', '<|im_end|> <|im x',
                 'cafe\u0301 x', '\u00e9 x caf\u00e9', 'e\u0301 x'):
        for special in (True, False):
            assert mine.encode(text, special) == lib.encode(
                text, add_special_tokens=special).ids, text


def test_partial_utf8_decodes_as_rust_lossy_does():
    """Byte tokens of truncated or invalid UTF-8 give as many U+FFFD as
    the library's from_utf8_lossy; StreamDecoder over the reader holds
    them back as JAX's does over the library."""
    from tokenizers import Tokenizer
    lib = Tokenizer.from_file(fixtures.QWEN2)
    mine = tokenizer.load_tokenizer(fixtures.QWEN2)
    for raw in (b'\xe4\xb8', b'\xf0\x80', b'\xf0\x9f\x98', b'\xed\xa0\x80',
                b'\xc0\xaf', b'\xff\xfe', b'a\xe4\xb8\xe4b',
                b'\xf4\x90\x80\x80', b'\xe0\x80\xaf',
                b'\xf0\x9f\x98\x80\x80'):
        ids = [mine.token_to_id(tokenizer_json.BYTE_CHARS[b]) for b in raw]
        assert mine.decode(ids) == lib.decode(ids) == raw.decode(
            'utf-8', 'replace'), raw
    ref = jtokenizer.load_tokenizer(fixtures.QWEN2)
    text = 'héllo 東京 👨‍👩‍👧 ok'
    ids = mine.encode(text)
    ours, theirs = (tokenizer.StreamDecoder(mine),
                    jtokenizer.StreamDecoder(ref))
    deltas = [ours.feed([i]) for i in ids]
    assert deltas == [theirs.feed([i]) for i in ids]
    assert '�' not in ''.join(deltas)
    assert ''.join(deltas) + ours.flush() == text


def _with(doc, path, value):
    doc = copy.deepcopy(doc)
    node = doc
    for key in path[:-1]:
        node = node[key]
    node[path[-1]] = value
    return doc


_QWEN2_DOC = _doc(fixtures.QWEN2)


@pytest.mark.parametrize('path,value,field', [
    (('model', 'dropout'), 0.1, 'model.dropout'),
    (('model', 'byte_fallback'), True, 'model.byte_fallback'),
    (('model', 'unk_token'), '<unk>', 'model.unk_token'),
    (('model', 'continuing_subword_prefix'), '##',
     'model.continuing_subword_prefix'),
    (('model', 'end_of_word_suffix'), '</w>', 'model.end_of_word_suffix'),
    (('model', 'type'), 'WordPiece', 'model.type'),
    (('normalizer',), {'type': 'NFKC'}, 'normalizer.type'),
    (('normalizer',), {'type': 'Sequence', 'normalizers': [
        {'type': 'NFC'}, {'type': 'Lowercase'}]},
     r'normalizer.normalizers\[1\].type'),
    (('pre_tokenizer', 'pretokenizers', 0, 'behavior'), 'Removed',
     r'pre_tokenizer.pretokenizers\[0\].behavior'),
    (('pre_tokenizer', 'pretokenizers', 0, 'invert'), True,
     r'pre_tokenizer.pretokenizers\[0\].invert'),
    (('pre_tokenizer', 'pretokenizers', 0, 'pattern'), {'String': ' '},
     r'pre_tokenizer.pretokenizers\[0\].pattern'),
    (('pre_tokenizer', 'pretokenizers', 0, 'pattern'),
     {'Regex': r'\p{Lu}+'}, 'pattern property'),
    (('pre_tokenizer', 'pretokenizers', 0, 'pattern'), {'Regex': r'\d+'},
     'pattern escape'),
    (('pre_tokenizer',), {'type': 'Metaspace'}, 'pre_tokenizer.type'),
    (('post_processor',), {'type': 'RobertaProcessing'},
     'post_processor.type'),
    (('decoder',), None, 'decoder.type'),
    (('decoder',), {'type': 'WordPiece'}, 'decoder.type'),
    (('added_tokens', 0, 'lstrip'), True, r'added_tokens\[0\].lstrip'),
    (('added_tokens', 0, 'rstrip'), True, r'added_tokens\[0\].rstrip'),
    (('added_tokens', 0, 'single_word'), True,
     r'added_tokens\[0\].single_word'),
    (('truncation',), {'max_length': 8}, 'truncation'),
    (('padding',), {'strategy': 'BatchLongest'}, 'padding'),
    (('extra',), 1, 'tokenizer.json.extra'),
])
def test_unsupported_fields_raise_by_name(path, value, field):
    with pytest.raises(NotImplementedError, match=field):
        tokenizer_json.TokenizerJson(_with(_QWEN2_DOC, path, value))


def test_template_processing_variants_raise_by_name():
    doc = _doc(fixtures.LLAMA3)
    post = doc['post_processor']['processors'][1]
    for single in ([{'Sequence': {'id': 'B', 'type_id': 0}}],
                   [{'SpecialToken': {'id': '<nope>', 'type_id': 0}},
                    {'Sequence': {'id': 'A', 'type_id': 0}}]):
        bad = _with(doc, ('post_processor', 'processors', 1),
                    dict(post, single=single))
        with pytest.raises(NotImplementedError,
                           match=r'post_processor.processors\[1\].single'):
            tokenizer_json.TokenizerJson(bad)


def test_hf_tokenizer_needs_neither_tokenizers_nor_regex(monkeypatch):
    """The card's machine has neither library: with both blocked the
    reader loads and encodes both fixtures as the golden file says."""
    monkeypatch.setitem(sys.modules, 'tokenizers', None)
    monkeypatch.setitem(sys.modules, 'regex', None)
    with open(fixtures.GOLDEN, encoding='utf-8') as f:
        want = json.load(f)
    for name, path in fixtures.FIXTURES.items():
        tok = tokenizer.load_tokenizer(path)
        assert [tok.encode(t) for t in want['texts']] == \
            [r['ids'] for r in want['fixtures'][name]['rows']]
