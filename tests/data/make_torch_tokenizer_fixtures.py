"""Makes the tokenizer and chat-SFT fixtures of the port's tests and of
chip_smoke.py's ``sft`` phase, with the ``tokenizers`` library and the
JAX package (run from the repository root):

    python tests/data/make_torch_tokenizer_fixtures.py            # all
    python tests/data/make_torch_tokenizer_fixtures.py --golden   # ids only

The tokenizers are trained on, and the long SFT replies drawn from, the
project's documentation under docs/. The fixtures are a snapshot: a
change to those files or to the library's trainer gives other
tokenizers, so the four files are remade and committed together.
The tests never retrain; they re-derive the golden ids from the
committed tokenizers and JSONL.

It writes, beside itself:

  - ``torch_tok_llama3.json``: a Llama-3-style tokenizer.json, byte-level
    BPE trained on docs/*.md: Llama 3's Split pattern
    with ByteLevel(use_regex=false), ``ignore_merges`` with a few whole
    words in the vocabulary that no merge reaches, merges as "a b"
    strings, Llama 3's five chat specials after the vocabulary, and
    Sequence[ByteLevel, TemplateProcessing] adding <|begin_of_text|>;
  - ``torch_tok_qwen2.json``: a Qwen2/ChatML-style one: NFC, Qwen2's
    pattern (single digits), merges as [a, b] lists, <|endoftext|>,
    <|im_start|> and <|im_end|> as specials and <tool_call> /
    </tool_call> as non-special added tokens, no BOS;
  - ``torch_sft_chat.jsonl``: 64 conversations of 1-4 turns in several
    scripts, some with a system turn, some past 2049 tokens, one with no
    assistant turn;
  - ``torch_tokenizer_golden.json`` (``golden()``): the library's ids and
    decodes of every text in TEXTS under both fixtures and both
    ``add_special_tokens`` values, SFT_CHAT and its llama3 chat prompt
    ids, and digests (``digest``) of the JAX package's SFT arrays
    (data/sft.py through the library) of the JSONL under both fixtures,
    with the seq_len and batch they were taken at.

tests/test_torch_tokenizer.py reruns ``golden()`` on the committed files
and fails when the committed golden file is stale.
"""
import argparse
import glob
import hashlib
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
LLAMA3 = os.path.join(HERE, 'torch_tok_llama3.json')
QWEN2 = os.path.join(HERE, 'torch_tok_qwen2.json')
SFT_JSONL = os.path.join(HERE, 'torch_sft_chat.jsonl')
GOLDEN = os.path.join(HERE, 'torch_tokenizer_golden.json')
FIXTURES = {'llama3': LLAMA3, 'qwen2': QWEN2}

LLAMA3_PATTERN = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+"
                  r"|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+"
                  r"|\s+(?!\S)|\s+")
QWEN2_PATTERN = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+"
                 r"|\p{N}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)"
                 r"|\s+")
LLAMA3_SPECIALS = ['<|begin_of_text|>', '<|end_of_text|>',
                   '<|start_header_id|>', '<|end_header_id|>', '<|eot_id|>']
QWEN2_SPECIALS = ['<|endoftext|>', '<|im_start|>', '<|im_end|>']
QWEN2_ADDED = ['<tool_call>', '</tool_call>']
# Whole words put in the Llama-3-style vocabulary with no merge that
# builds them: ignore_merges takes them whole, merges would split them.
WHOLE_WORDS = [' Hopper', ' tokenizer', 'ĠKubernetes', ' preemption',
               'Ġweight-only']
VOCAB = {'llama3': 3000, 'qwen2': 2500}

# The SFT digests: seq_len and the first batch the sft phase trains on.
SFT_SEQ_LEN, SFT_BATCH = 2048, 4

# The chat the sft phase sends (its templated prompt ids are golden).
SFT_CHAT = [{'role': 'system', 'content': 'You answer in one line.'},
            {'role': 'user', 'content': 'Wie spät ist es in 東京? 🙂'}]

TEXTS = [
    '',
    'Hello world',
    'hello world!  How are you?\n',
    "I'm sure they'll say it's fine; we've DON'T WE'LL I'M it'S",
    "It'ſ a long s, and 'Re 'VE 'D",
    'Numbers: 1 12 123 1234 12345 1234567 3.14159 -42',
    'Fullwidth digits ０１２３４５ and Devanagari ०१२३ and Arabic ٣٤٥٦',
    'Roman numerals Ⅻ and fractions ½ ¾ and superscripts ²³',
    '东京是日本的首都。机器学习需要大量数据。',
    'こんにちは、世界！カタカナとひらがな。',
    '안녕하세요. 만나서 반갑습니다.',
    'Привет! Как дела? Сегодня мы обучаем модель.',
    'नमस्ते, आप कैसे हैं? यह एक परीक्षण वाक्य है।',
    'مرحبا بالعالم. هذا نص تجريبي.',
    'Καλημέρα κόσμε, שלום עולם, สวัสดีครับ',
    'Combining: e\u0301 a\u0308 n\u0303 versus \u00e9 \u00e4 \u00f1',
    'Emoji: 👍🏽 🎉 👨‍👩‍👧 ❤️ 🇯🇵',
    'tabs\there\tand\r\nwindows\r\nlines\n\n\nand  trailing   \n  spaces   ',
    'whitespace: a\x1cb\x1dc\x1ed\x1fe',
    'next line:\x85after nbsp:\xa0after',
    'line sep:\u2028para sep:\u2029ideographic:\u3000end',
    'thin\u2009space and narrow\u202fnbsp and ogham\u1680mark',
    '   leading spaces and a tail   ',
    '\n\n\n',
    '    def f(x):\n        return x ** 2  # square\n',
    'if (a && b) { return c[0] >>= 1; } // done',
    'https://example.com/path?query=1&x=y#frag',
    'The Hopper card runs the tokenizer on Kubernetes with preemption '
    'and weight-only int8.',
    'Hopper tokenizer Kubernetes preemption',
    '<|begin_of_text|><|start_header_id|>user<|end_header_id|>\n\nhi'
    '<|eot_id|>',
    '<|im_start|>user\nhello<|im_end|>\n<|im_start|>assistant\n',
    'specials inline<|eot_id|>and<|end_of_text|>mid<|endoftext|>word',
    'partial <|eot_id and <|im_end and <| |> and <tool_call> x </tool_call>',
    '<tool_call>{"name": "f", "arguments": {}}</tool_call>',
    'Mixed 中文 and English and русский and हिन्दी123४५६',
    'A' * 300,
    'ab' * 150 + ' ' + 'ÿ' * 40,
    'Zero\u200bwidth and soft\u00adhyphen and bom\ufeffhere',
    'Control chars \x00\x01\x07\x7f and private\ue000use',
    'ﬁ ligature, Ǆ titlecase, ǅ ǆ, ß, İstanbul, ΐ',
]


def _corpus():
    for path in sorted(glob.glob(os.path.join(ROOT, 'docs', '*.md'))):
        with open(path, encoding='utf-8') as f:
            yield f.read()


def _train(pattern, vocab_size, nfc):
    from tokenizers import (Regex, Tokenizer, decoders, models, normalizers,
                            pre_tokenizers, trainers)
    tok = Tokenizer(models.BPE())
    if nfc:
        tok.normalizer = normalizers.NFC()
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(pattern), behavior='isolated'),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)])
    tok.decoder = decoders.ByteLevel()
    tok.train_from_iterator(_corpus(), trainers.BpeTrainer(
        vocab_size=vocab_size, show_progress=False,
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    return json.loads(tok.to_str())


def make_llama3():
    from tokenizers import Tokenizer, processors
    doc = _train(LLAMA3_PATTERN, VOCAB['llama3'], nfc=False)
    vocab = doc['model']['vocab']
    for word in WHOLE_WORDS:
        word = word.replace(' ', 'Ġ')
        if word not in vocab:
            vocab[word] = len(vocab)
    doc['model']['ignore_merges'] = True
    tok = Tokenizer.from_str(json.dumps(doc))
    tok.add_special_tokens(LLAMA3_SPECIALS)
    bos = tok.token_to_id('<|begin_of_text|>')
    tok.post_processor = processors.Sequence([
        processors.ByteLevel(trim_offsets=False),
        processors.TemplateProcessing(
            single='<|begin_of_text|> $A',
            pair='<|begin_of_text|> $A <|begin_of_text|>:1 $B:1',
            special_tokens=[('<|begin_of_text|>', bos)])])
    doc = json.loads(tok.to_str())
    # Llama 3's own file spells merges as "a b" strings.
    doc['model']['merges'] = [' '.join(m) for m in doc['model']['merges']]
    return doc


def make_qwen2():
    from tokenizers import AddedToken, Tokenizer, processors
    doc = _train(QWEN2_PATTERN, VOCAB['qwen2'], nfc=True)
    tok = Tokenizer.from_str(json.dumps(doc))
    tok.add_special_tokens(QWEN2_SPECIALS)
    tok.add_tokens([AddedToken(t, normalized=False, special=False)
                    for t in QWEN2_ADDED])
    tok.post_processor = processors.ByteLevel(trim_offsets=False)
    return json.loads(tok.to_str())


def make_sft_jsonl(seed=0):
    """64 conversations from seeded choices over multi-script sentences;
    conversations 5, 17, 33 and 50 carry a long assistant reply (past
    2049 tokens), conversation 40 has no assistant turn."""
    rng = np.random.default_rng(seed)
    sentences = [t for t in TEXTS[1:] if '<|' not in t and '<tool' not in t]
    questions = ['What is a TPU?', 'Explain LoRA briefly.',
                 'Wie spät ist es in 東京?', 'Что такое трансформер?',
                 'यह कैसे काम करता है?', '这个模型有多大？',
                 'Can you write a haiku about GPUs?',
                 "What's 12345 + 67890?"]
    paragraphs = [p for p in '\n'.join(_corpus()).split('\n\n')
                  if 200 < len(p) < 1200]
    convos = []
    for i in range(64):
        msgs = []
        if rng.random() < 0.4:
            msgs.append({'role': 'system',
                         'content': str(rng.choice(
                             ['You are a helpful assistant.',
                              'Réponds en français.', '简洁地回答。']))})
        turns = int(rng.integers(1, 5))
        for t in range(turns):
            msgs.append({'role': 'user',
                         'content': str(rng.choice(questions))})
            if i == 40:
                break
            n = int(rng.integers(1, 5))
            reply = ' '.join(str(rng.choice(sentences)) for _ in range(n))
            if i in (5, 17, 33, 50) and t == 0:
                picks = rng.choice(len(paragraphs), 16, replace=False)
                reply = '\n\n'.join(paragraphs[int(k)] for k in picks)
            msgs.append({'role': 'assistant', 'content': reply})
        convos.append({'messages': msgs})
    return convos


def digest(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(str((a.dtype.str, a.shape)).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def golden():
    """The library's ids and decodes of TEXTS under both fixtures, the
    llama3 chat prompt ids of SFT_CHAT, and the digests of the JAX
    package's SFT arrays of the JSONL under both fixtures."""
    sys.path.insert(0, ROOT)
    from tokenizers import Tokenizer
    from skypilot_tpu.data import sft
    from skypilot_tpu.data import tokenizer as jtokenizer
    out = {'texts': TEXTS, 'fixtures': {}, 'sft': {}, 'sft_chat': SFT_CHAT,
           'sft_batch': SFT_BATCH}
    for name, path in FIXTURES.items():
        tok = Tokenizer.from_file(path)
        rows = []
        for text in TEXTS:
            row = {}
            for special in (True, False):
                ids = tok.encode(text, add_special_tokens=special).ids
                row['ids' if special else 'ids_raw'] = ids
            row['decoded'] = tok.decode(row['ids'],
                                        skip_special_tokens=True)
            rows.append(row)
        out['fixtures'][name] = {'vocab_size': tok.get_vocab_size(),
                                 'rows': rows}
        jtok = jtokenizer.load_tokenizer(path)
        family = jtok.chat_family
        tokens, masks = sft.load_sft_dataset(SFT_JSONL, jtok, family,
                                             SFT_SEQ_LEN)
        first = sft.batch_at_step(tokens, masks, 0, SFT_BATCH)
        out['sft'][name] = {
            'family': family, 'seq_len': SFT_SEQ_LEN, 'rows': len(tokens),
            'dataset': digest(tokens, masks),
            'first_batch': digest(first['tokens'], first['loss_mask']),
            'masked_share': float(first['loss_mask'].mean())}
    tok = Tokenizer.from_file(LLAMA3)
    prompt = jtokenizer.apply_chat_template(SFT_CHAT, 'llama3')
    out['chat_prompt_ids'] = tok.encode(prompt, add_special_tokens=False).ids
    return out


def _dump(obj, path, **kw):
    with open(path, 'w', encoding='utf-8') as f:
        json.dump(obj, f, ensure_ascii=False, **kw)
        f.write('\n')


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--golden', action='store_true',
                        help='rewrite the golden file only')
    args = parser.parse_args()
    if not args.golden:
        _dump(make_llama3(), LLAMA3)
        _dump(make_qwen2(), QWEN2)
        with open(SFT_JSONL, 'w', encoding='utf-8') as f:
            for c in make_sft_jsonl():
                f.write(json.dumps(c, ensure_ascii=False) + '\n')
    _dump(golden(), GOLDEN, indent=None)
    for path in (LLAMA3, QWEN2, SFT_JSONL, GOLDEN):
        print(f'{os.path.relpath(path, ROOT)}: {os.path.getsize(path)} bytes')


if __name__ == '__main__':
    main()
