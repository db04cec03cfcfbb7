"""A reader of HF ``tokenizer.json`` files, owned by the port: the
byte-level BPE that Llama 3, Qwen2 and GPT-2-style checkpoints ship,
with ids and text equal to the ``tokenizers`` library's, in plain
Python (the card's machine has neither that library nor ``regex``).

Encoding runs the library's pipeline:

  1. added tokens: the text is split on them first (leftmost, then
     longest match), special or not, whatever ``add_special_tokens``
     says; tokens marked ``normalized`` are matched after the
     normalizer, on what the others left;
  2. normalizer: none, ``NFC``, or a ``Sequence`` of those;
  3. pre-tokenizer: ``Split`` (a ``Regex``, behaviour ``Isolated``),
     ``ByteLevel`` (with or without GPT-2's regex, ``add_prefix_space``
     on every piece), or a ``Sequence`` of those;
  4. model ``BPE``: ``ignore_merges`` takes a pre-token that is in the
     vocabulary whole; otherwise its characters merge lowest rank first,
     leftmost first among equals, as the library's heap does. Results
     are cached per pre-token;
  5. post-processor (``add_special_tokens`` only): ``TemplateProcessing``
     of a single sequence, ``ByteLevel`` (a no-op on ids), or a
     ``Sequence`` of those.

Decoding maps ids to tokens (added tokens first, then the vocabulary;
an id with no token gives nothing), drops special tokens when asked,
and runs the ``ByteLevel`` decoder: a token whose characters all lie in
the byte alphabet gives those bytes, any other its UTF-8; the bytes are
decoded with U+FFFD for each maximal invalid subpart, as Rust's
``from_utf8_lossy`` does.

The library's patterns are Oniguruma's. They are translated to Python's
``re``: ``\\p{L}`` and ``\\p{N}`` become classes built from
``unicodedata`` (the Unicode version of this Python), and ``\\s`` /
``\\S`` follow Oniguruma's Unicode whitespace (U+0009-000D, U+0085 and
the Zs, Zl and Zp categories), not ``str.isspace``, which also counts
U+001C-001F.

Added-token ids follow the library, not the file: each added token, in
file order, takes the id of the same content in the vocabulary, else
the next id past the vocabulary and the added tokens so far. The
vocabulary size counts distinct contents of both (``get_vocab_size()``).

Every other setting raises ``NotImplementedError`` naming its field.
"""
from __future__ import annotations

import functools
import heapq
import json
import logging
import re
import sys
import unicodedata
from typing import Any, Dict, List, Optional, Sequence, Tuple

logger = logging.getLogger(__name__)

# GPT-2's pre-tokenizing pattern, which ByteLevel(use_regex=true) runs.
GPT2_PATTERN = (r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+"
                r"| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+")

# Pre-tokens cached per tokenizer before the cache is emptied.
CACHE_SIZE = 1 << 16


def _unsupported(field: str, value: Any) -> NotImplementedError:
    return NotImplementedError(
        f'tokenizer.json: {field} = {value!r} is not supported by the '
        f'port\'s reader (byte-level BPE as Llama 3, Qwen2 and GPT-2 '
        f'ship it)')


def _byte_chars() -> List[str]:
    """GPT-2's bytes_to_unicode: byte b → the printable character that
    stands for it in a byte-level vocabulary."""
    keep = (list(range(ord('!'), ord('~') + 1)) +
            list(range(ord('¡'), ord('¬') + 1)) +
            list(range(ord('®'), ord('ÿ') + 1)))
    chars = [''] * 256
    extra = 0
    for b in range(256):
        if b in keep:
            chars[b] = chr(b)
        else:
            chars[b] = chr(256 + extra)
            extra += 1
    return chars


BYTE_CHARS = _byte_chars()
CHAR_BYTES = {c: b for b, c in enumerate(BYTE_CHARS)}
# str.translate table from a latin-1 decoded byte string to byte chars.
_TO_BYTE_CHARS = {b: c for b, c in enumerate(BYTE_CHARS)}


def byte_level(text: str) -> str:
    """``text``'s UTF-8 bytes as byte-alphabet characters."""
    return text.encode('utf-8').decode('latin-1').translate(_TO_BYTE_CHARS)


# ------------------------------------------------------------- patterns

def _ranges(cps: List[int]) -> str:
    """Sorted code points → a bracket-expression body of ranges."""
    out, i = [], 0
    while i < len(cps):
        j = i
        while j + 1 < len(cps) and cps[j + 1] == cps[j] + 1:
            j += 1
        lo, hi = cps[i], cps[j]
        out.append(f'\\U{lo:08x}' if lo == hi
                   else f'\\U{lo:08x}-\\U{hi:08x}')
        i = j + 1
    return ''.join(out)


@functools.lru_cache(maxsize=None)
def unicode_classes() -> Dict[str, str]:
    """Bracket-expression bodies of ``\\p{L}`` (Lu Ll Lt Lm Lo),
    ``\\p{N}`` (Nd Nl No) and Oniguruma's Unicode ``\\s``."""
    sets: Dict[str, List[int]] = {'L': [], 'N': [], 's': []}
    category = unicodedata.category
    for cp in range(sys.maxunicode + 1):
        if 0xD800 <= cp <= 0xDFFF:
            continue
        cat = category(chr(cp))
        if cat[0] in 'LN':
            sets[cat[0]].append(cp)
        elif cat in ('Zs', 'Zl', 'Zp') or 0x09 <= cp <= 0x0D or \
                cp == 0x85:
            sets['s'].append(cp)
    return {k: _ranges(v) for k, v in sets.items()}


_PROPERTY = re.compile(r'\\[pP](?:\{(\^?)([A-Za-z_]+)\}|([A-Za-z]))')
# Escapes that mean the same in Oniguruma and Python's re.
_SAME_ESCAPES = set('rntfv')


def translate_pattern(pattern: str) -> str:
    """An Oniguruma pattern of a tokenizer.json as a Python ``re``
    pattern: ``\\p{L}``, ``\\p{N}``, ``\\s`` and ``\\S`` expanded
    (inside a class too), escaped punctuation and ``\\r \\n \\t \\f
    \\v`` kept; any other escape, property or nested class raises."""
    cls = unicode_classes()
    out: List[str] = []
    in_class = False
    i = 0
    while i < len(pattern):
        c = pattern[i]
        if c == '\\':
            if i + 1 >= len(pattern):
                raise _unsupported('pre_tokenizer pattern', pattern)
            nxt = pattern[i + 1]
            if nxt in 'pP':
                m = _PROPERTY.match(pattern, i)
                name = m and (m.group(2) or m.group(3))
                if not m or nxt == 'P' or m.group(1) or \
                        name not in ('L', 'N'):
                    raise _unsupported(
                        'pre_tokenizer pattern property',
                        m.group(0) if m else pattern[i:i + 3])
                body = cls[name]
                out.append(body if in_class else f'[{body}]')
                i = m.end()
                continue
            if nxt == 's':
                out.append(cls['s'] if in_class else f'[{cls["s"]}]')
            elif nxt == 'S':
                if in_class:
                    raise _unsupported('pre_tokenizer pattern', pattern)
                out.append(f'[^{cls["s"]}]')
            elif nxt in _SAME_ESCAPES or not nxt.isalnum():
                out.append(pattern[i:i + 2])
            else:
                raise _unsupported('pre_tokenizer pattern escape',
                                   '\\' + nxt)
            i += 2
            continue
        if in_class:
            if c == '[':
                raise _unsupported('pre_tokenizer pattern (nested class)',
                                   pattern)
            if c == ']':
                in_class = False
        elif c == '[':
            in_class = True
            out.append(c)
            i += 1
            # A leading '^' and a ']' right after it are literal parts of
            # the class opener.
            if pattern.startswith('^', i):
                out.append('^')
                i += 1
            if pattern.startswith(']', i):
                out.append('\\]')
                i += 1
            continue
        out.append(c)
        i += 1
    return ''.join(out)


@functools.lru_cache(maxsize=None)
def compile_pattern(pattern: str) -> 're.Pattern':
    try:
        return re.compile(translate_pattern(pattern))
    except re.error as e:
        raise _unsupported('pre_tokenizer pattern', pattern) from e


def split_isolated(regex: 're.Pattern', text: str) -> List[str]:
    """The matches of ``regex`` and the gaps between them, in order,
    empty pieces dropped (the library's ``Isolated`` split)."""
    out, prev = [], 0
    for m in regex.finditer(text):
        s, e = m.span()
        if s > prev:
            out.append(text[prev:s])
        if e > s:
            out.append(text[s:e])
        prev = e
    if prev < len(text):
        out.append(text[prev:])
    return out


# ---------------------------------------------------------------- parts

def _keys(node: Dict[str, Any], field: str, allowed: Sequence[str]) -> None:
    extra = sorted(set(node) - set(allowed))
    if extra:
        raise _unsupported(f'{field}.{extra[0]}', node[extra[0]])


def _normalizer(node: Optional[Dict[str, Any]], field: str = 'normalizer'):
    """A normalizer node → a str → str function (None: identity)."""
    if node is None:
        return None
    kind = node.get('type')
    if kind == 'NFC':
        _keys(node, field, ('type',))
        return functools.partial(unicodedata.normalize, 'NFC')
    if kind == 'Sequence':
        _keys(node, field, ('type', 'normalizers'))
        parts = [_normalizer(n, f'{field}.normalizers[{i}]')
                 for i, n in enumerate(node['normalizers'])]
        parts = [p for p in parts if p is not None]

        def run(text: str) -> str:
            for p in parts:
                text = p(text)
            return text
        return run
    raise _unsupported(f'{field}.type', kind)


def _pre_tokenizer(node: Optional[Dict[str, Any]],
                   field: str = 'pre_tokenizer') -> List[Tuple]:
    """A pre-tokenizer node → its steps: ('split', regex) or
    ('byte_level', add_prefix_space, regex or None)."""
    if node is None:
        return []
    kind = node.get('type')
    if kind == 'Sequence':
        _keys(node, field, ('type', 'pretokenizers'))
        return [step for i, n in enumerate(node['pretokenizers'])
                for step in _pre_tokenizer(n, f'{field}.pretokenizers[{i}]')]
    if kind == 'Split':
        _keys(node, field, ('type', 'pattern', 'behavior', 'invert'))
        if node.get('behavior') != 'Isolated':
            raise _unsupported(f'{field}.behavior', node.get('behavior'))
        if node.get('invert'):
            raise _unsupported(f'{field}.invert', node['invert'])
        pattern = node.get('pattern') or {}
        if set(pattern) != {'Regex'}:
            raise _unsupported(f'{field}.pattern', pattern)
        return [('split', compile_pattern(pattern['Regex']))]
    if kind == 'ByteLevel':
        _keys(node, field, ('type', 'add_prefix_space', 'trim_offsets',
                            'use_regex'))
        regex = (compile_pattern(GPT2_PATTERN)
                 if node.get('use_regex', True) else None)
        return [('byte_level', bool(node.get('add_prefix_space')), regex)]
    raise _unsupported(f'{field}.type', kind)


def _post_processor(node: Optional[Dict[str, Any]],
                    field: str = 'post_processor') -> List[Any]:
    """A post-processor node → the single-sequence template (a list of
    'A' and special-token id lists), or [] when it adds nothing."""
    if node is None:
        return []
    kind = node.get('type')
    if kind == 'ByteLevel':
        _keys(node, field, ('type', 'add_prefix_space', 'trim_offsets',
                            'use_regex'))
        return []
    if kind == 'Sequence':
        _keys(node, field, ('type', 'processors'))
        templates = [t for i, n in enumerate(node['processors'])
                     if (t := _post_processor(
                         n, f'{field}.processors[{i}]'))]
        if len(templates) > 1:
            raise _unsupported(f'{field}.processors',
                               'more than one TemplateProcessing')
        return templates[0] if templates else []
    if kind == 'TemplateProcessing':
        _keys(node, field, ('type', 'single', 'pair', 'special_tokens'))
        specials = node.get('special_tokens') or {}
        template: List[Any] = []
        for item in node['single']:
            if 'Sequence' in item and item['Sequence'].get('id') == 'A':
                template.append('A')
            elif 'SpecialToken' in item:
                name = item['SpecialToken']['id']
                if name not in specials:
                    raise _unsupported(f'{field}.single', item)
                template.append([int(i) for i in specials[name]['ids']])
            else:
                raise _unsupported(f'{field}.single', item)
        if template.count('A') != 1:
            raise _unsupported(f'{field}.single', node['single'])
        return template
    raise _unsupported(f'{field}.type', kind)


def _decoder(node: Optional[Dict[str, Any]]) -> None:
    if node is None or node.get('type') != 'ByteLevel':
        raise _unsupported('decoder.type', node and node.get('type'))
    _keys(node, 'decoder', ('type', 'add_prefix_space', 'trim_offsets',
                            'use_regex'))


_MODEL_FIELDS = ('type', 'dropout', 'unk_token', 'continuing_subword_prefix',
                 'end_of_word_suffix', 'fuse_unk', 'byte_fallback',
                 'ignore_merges', 'vocab', 'merges')


def _merge_pairs(merges: List[Any]) -> List[Tuple[str, str]]:
    """``merges`` in either form: "a b" strings (lines starting
    '#version' skipped, as the library does) or [a, b] lists."""
    pairs = []
    for m in merges:
        if isinstance(m, str):
            if m.startswith('#version'):
                continue
            parts = m.split(' ')
            if len(parts) != 2:
                raise ValueError(f'tokenizer.json: bad merge {m!r} (rank '
                                 f'{len(pairs) + 1})')
            pairs.append((parts[0], parts[1]))
        else:
            a, b = m
            pairs.append((a, b))
    return pairs


# --------------------------------------------------------------- reader

class TokenizerJson:
    """A parsed ``tokenizer.json``: :meth:`encode`, :meth:`decode`,
    :meth:`token_to_id`, :meth:`id_to_token`, ``vocab_size`` (the
    library's ``get_vocab_size()``) and ``special_tokens``."""

    def __init__(self, doc: Dict[str, Any]):
        _keys(doc, 'tokenizer.json', (
            'version', 'truncation', 'padding', 'added_tokens', 'normalizer',
            'pre_tokenizer', 'model', 'post_processor', 'decoder'))
        for field in ('truncation', 'padding'):
            if doc.get(field) is not None:
                raise _unsupported(field, doc[field])
        model = doc.get('model') or {}
        if model.get('type') != 'BPE':
            raise _unsupported('model.type', model.get('type'))
        _keys(model, 'model', _MODEL_FIELDS)
        if model.get('dropout') not in (None, 0.0):
            raise _unsupported('model.dropout', model['dropout'])
        if model.get('byte_fallback'):
            raise _unsupported('model.byte_fallback', model['byte_fallback'])
        if model.get('unk_token') is not None:
            raise _unsupported('model.unk_token', model['unk_token'])
        for field in ('continuing_subword_prefix', 'end_of_word_suffix'):
            if model.get(field):
                raise _unsupported(f'model.{field}', model[field])
        self.vocab: Dict[str, int] = {k: int(v)
                                      for k, v in model['vocab'].items()}
        self.ignore_merges = bool(model.get('ignore_merges', False))
        # (left id, right id) → (rank, merged id); a later duplicate
        # replaces an earlier one, as in the library's map.
        self.merges: Dict[Tuple[int, int], Tuple[int, int]] = {}
        for rank, (a, b) in enumerate(_merge_pairs(model.get('merges', []))):
            try:
                self.merges[(self.vocab[a], self.vocab[b])] = (
                    rank, self.vocab[a + b])
            except KeyError as e:
                raise ValueError(f'tokenizer.json: merge {a!r} {b!r} (rank '
                                 f'{rank}) names {e.args[0]!r}, which is not '
                                 f'in the vocabulary') from None
        self._init_added(doc.get('added_tokens') or [])
        self.normalize = _normalizer(doc.get('normalizer'))
        self.steps = _pre_tokenizer(doc.get('pre_tokenizer'))
        self.template = _post_processor(doc.get('post_processor'))
        _decoder(doc.get('decoder'))
        self._id_to_token = {i: t for t, i in self.vocab.items()}
        self._id_to_token.update((i, t) for t, i in self.added.items())
        self._cache: Dict[str, List[int]] = {}

    def _init_added(self, tokens: List[Dict[str, Any]]) -> None:
        """Added tokens in file order, ids assigned as the library
        assigns them; matchers for the raw and the normalized text."""
        self.added: Dict[str, int] = {}
        self.special_tokens = set()
        raw, normalized = [], []
        model_size = len(self.vocab)
        for i, tok in enumerate(tokens):
            field = f'added_tokens[{i}]'
            _keys(tok, field, ('id', 'content', 'single_word', 'lstrip',
                               'rstrip', 'normalized', 'special'))
            for flag in ('single_word', 'lstrip', 'rstrip'):
                if tok.get(flag):
                    raise _unsupported(f'{field}.{flag}', tok[flag])
            content = tok['content']
            if not content or content in self.added:
                continue
            if content in self.vocab:
                new_id = self.vocab[content]
            elif not self.added:
                new_id = model_size
            else:
                top = max(self.added.values())
                new_id = top + 1 if top >= model_size or model_size == 0 \
                    else model_size
            if new_id != tok.get('id', new_id):
                logger.warning('tokenizer.json: added token %r has id %s in '
                               'the file but takes id %d, as the tokenizers '
                               'library assigns it', content, tok['id'],
                               new_id)
            self.added[content] = new_id
            if tok.get('special'):
                self.special_tokens.add(content)
            (normalized if tok.get('normalized') else raw).append(content)
        self._raw_split = self._matcher(raw)
        self._normalized_split = self._matcher(normalized)

    @staticmethod
    def _matcher(contents: List[str]) -> Optional['re.Pattern']:
        """Leftmost, then longest, match of any of ``contents``."""
        if not contents:
            return None
        alts = sorted(contents, key=len, reverse=True)
        return re.compile('|'.join(map(re.escape, alts)))

    @property
    def vocab_size(self) -> int:
        return len(self.vocab) + sum(t not in self.vocab for t in self.added)

    def token_to_id(self, token: str) -> Optional[int]:
        if token in self.added:
            return self.added[token]
        return self.vocab.get(token)

    def id_to_token(self, i: int) -> Optional[str]:
        return self._id_to_token.get(i)

    # ------------------------------------------------------------ encode

    def _split_added(self, matcher, text: str) -> List[Tuple[str, bool]]:
        """(piece, is an added token) in order, empty pieces dropped."""
        if matcher is None:
            return [(text, False)] if text else []
        out, prev = [], 0
        for m in matcher.finditer(text):
            if m.start() > prev:
                out.append((text[prev:m.start()], False))
            out.append((m.group(), True))
            prev = m.end()
        if prev < len(text):
            out.append((text[prev:], False))
        return out

    def _pre_tokenize(self, text: str) -> List[str]:
        pieces = [text]
        for step in self.steps:
            if step[0] == 'split':
                pieces = [p for piece in pieces
                          for p in split_isolated(step[1], piece)]
            else:
                _, prefix, regex = step
                if prefix:
                    pieces = [p if p.startswith(' ') else ' ' + p
                              for p in pieces]
                if regex is not None:
                    pieces = [p for piece in pieces
                              for p in split_isolated(regex, piece)]
                pieces = [byte_level(p) for p in pieces]
        return pieces

    def _bpe(self, piece: str) -> List[int]:
        """One pre-token → ids, as the library's BPE ``tokenize`` (no
        unk token: a character outside the vocabulary is dropped)."""
        vocab = self.vocab
        if self.ignore_merges and piece in vocab:
            return [vocab[piece]]
        hit = self._cache.get(piece)
        if hit is not None:
            return hit
        sym = [vocab[c] for c in piece if c in vocab]
        n = len(sym)
        merges = self.merges
        nxt = list(range(1, n + 1))
        if n:
            nxt[-1] = -1
        prv = list(range(-1, n - 1))
        alive = [True] * n
        heap = []
        for i in range(n - 1):
            m = merges.get((sym[i], sym[i + 1]))
            if m is not None:
                heap.append((m[0], i, m[1]))
        heapq.heapify(heap)
        while heap:
            _, pos, new_id = heapq.heappop(heap)
            j = nxt[pos]
            if not alive[pos] or j == -1:
                continue
            m = merges.get((sym[pos], sym[j]))
            if m is None or m[1] != new_id:
                continue        # a stale entry
            sym[pos] = new_id
            alive[j] = False
            nxt[pos] = nxt[j]
            if nxt[j] != -1:
                prv[nxt[j]] = pos
            p, q = prv[pos], nxt[pos]
            if p != -1:
                m = merges.get((sym[p], sym[pos]))
                if m is not None:
                    heapq.heappush(heap, (m[0], p, m[1]))
            if q != -1:
                m = merges.get((sym[pos], sym[q]))
                if m is not None:
                    heapq.heappush(heap, (m[0], pos, m[1]))
        ids = [s for s, a in zip(sym, alive) if a]
        if len(self._cache) >= CACHE_SIZE:
            self._cache.clear()
        self._cache[piece] = ids
        return ids

    def encode(self, text: str, add_special_tokens: bool = True
               ) -> List[int]:
        ids: List[int] = []
        for piece, is_added in self._split_added(self._raw_split, text):
            if is_added:
                ids.append(self.added[piece])
                continue
            if self.normalize is not None:
                piece = self.normalize(piece)
            for part, part_added in self._split_added(
                    self._normalized_split, piece):
                if part_added:
                    ids.append(self.added[part])
                    continue
                for pre in self._pre_tokenize(part):
                    ids.extend(self._bpe(pre))
        if add_special_tokens and self.template:
            out: List[int] = []
            for item in self.template:
                out.extend(ids if item == 'A' else item)
            ids = out
        return ids

    # ------------------------------------------------------------ decode

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True
               ) -> str:
        out = bytearray()
        for i in ids:
            tok = self._id_to_token.get(int(i))
            if tok is None or (skip_special_tokens and
                               tok in self.special_tokens):
                continue
            try:
                out += bytes(CHAR_BYTES[c] for c in tok)
            except KeyError:
                out += tok.encode('utf-8')
        return out.decode('utf-8', errors='replace')


def load(path: str) -> TokenizerJson:
    with open(path, 'r', encoding='utf-8') as f:
        return TokenizerJson(json.load(f))
