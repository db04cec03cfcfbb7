"""Tokenizers for the serve plane (port of skypilot_tpu/data/tokenizer.py:
``ByteTokenizer``, ``HFTokenizer``, ``load_tokenizer``, ``_validate``,
``apply_chat_template``, ``StreamDecoder``).

  - ``ByteTokenizer`` (vocab 256) is the hermetic default: an engine
    with no checkpoint directory needs no download.
  - ``HFTokenizer`` loads an HF checkpoint's ``tokenizer.json`` through
    the ``tokenizers`` library, imported inside its constructor and
    nowhere else, so every other module imports without it; a missing
    library raises by name, with no fallback to bytes. It detects the
    chat family (llama3 headers, ChatML) from the special tokens and
    adds the family's stop specials to the checkpoint's eos ids.
  - Chat templates are hand-written per family instead of running the
    checkpoint's Jinja template: a serve replica must not run template
    code from a model directory.
  - ``StreamDecoder`` never emits a dangling UTF-8 replacement char: a
    multi-byte sequence split across SSE chunks is held back until it
    completes.
"""
from __future__ import annotations

import os
from typing import Dict, Iterable, List, Optional, Sequence


class ByteTokenizer:
    """Hermetic byte-level tokenizer (vocab 256) — the engine default."""

    name = 'byte'
    chat_family = 'plain'
    eos_ids: List[int] = []
    vocab_size = 256

    def encode(self, text: str,
               add_special_tokens: bool = True) -> List[int]:
        del add_special_tokens   # bytes have no specials to add
        return list(text.encode('utf-8'))

    def decode(self, ids: Sequence[int]) -> str:
        return bytes(t for t in ids if 0 <= t < 256).decode(
            'utf-8', errors='replace')


class HFTokenizer:
    """A ``tokenizer.json`` (HF fast BPE) loaded by the tokenizers
    library. ``eos_extra``: the checkpoint's eos ids
    (models/hf_import.py ``hf_eos_ids``), merged with the family's stop
    specials."""

    # Family detection and stop specials: a llama-3 tokenizer defines
    # <|eot_id|>; Qwen/ChatML ones define <|im_end|>.
    _FAMILIES = (
        ('llama3', ('<|eot_id|>', '<|end_of_text|>')),
        ('chatml', ('<|im_end|>', '<|endoftext|>')),
    )

    def __init__(self, path: str, eos_extra: Iterable[int] = ()):
        try:
            from tokenizers import Tokenizer
        except ImportError as e:
            raise ImportError(
                f'{path}: reading tokenizer.json needs the tokenizers '
                f'library, which is not installed; there is no byte '
                f'fallback for an HF checkpoint') from e
        self._tok = Tokenizer.from_file(path)
        self.name = path
        self.vocab_size = self._tok.get_vocab_size()
        self.chat_family = 'plain'
        eos = set(int(i) for i in eos_extra)
        for family, specials in self._FAMILIES:
            ids = [self._tok.token_to_id(s) for s in specials]
            if ids[0] is not None:
                self.chat_family = family
                eos.update(i for i in ids if i is not None)
                break
        self.eos_ids = sorted(eos)

    def encode(self, text: str,
               add_special_tokens: bool = True) -> List[int]:
        """``add_special_tokens=False`` skips the post-processor (e.g.
        Llama-3's automatic BOS): needed whenever ``text`` carries its
        specials literally (a chat template), where it would add a
        second BOS."""
        return list(self._tok.encode(
            text, add_special_tokens=add_special_tokens).ids)

    def decode(self, ids: Sequence[int]) -> str:
        # Stop and eos specials never leak into the text.
        return self._tok.decode(list(ids), skip_special_tokens=True)

    def token_to_id(self, token: str) -> Optional[int]:
        return self._tok.token_to_id(token)


def load_tokenizer(path: str, eos_extra: Iterable[int] = ()) -> HFTokenizer:
    """``tokenizer.json`` from a file path or a checkpoint directory."""
    path = os.path.expanduser(path)
    if os.path.isdir(path):
        path = os.path.join(path, 'tokenizer.json')
    if not os.path.exists(path):
        raise FileNotFoundError(
            f'{path} not found. The engine needs the checkpoint\'s '
            f'tokenizer.json (fast tokenizer); sentencepiece .model files '
            f'are not supported — convert with '
            f'transformers.convert_slow_tokenizer.')
    return HFTokenizer(path, eos_extra=eos_extra)


_VALID_ROLES = ('system', 'user', 'assistant')


def _validate(messages: List[Dict[str, str]]) -> None:
    if not isinstance(messages, list) or not messages:
        raise ValueError('messages must be a non-empty list')
    for m in messages:
        if not isinstance(m, dict) or 'role' not in m or 'content' not in m:
            raise ValueError("each message needs 'role' and 'content'")
        if m['role'] not in _VALID_ROLES:
            raise ValueError(f"role {m['role']!r} not in {_VALID_ROLES}")
        if not isinstance(m['content'], str):
            raise ValueError('message content must be a string')


def apply_chat_template(messages: List[Dict[str, str]],
                        family: str) -> str:
    """Messages → the prompt string, ending with the assistant turn's
    opener:
      llama3:  <|begin_of_text|><|start_header_id|>{role}<|end_header_id|>
               \\n\\n{content}<|eot_id|> ... then the assistant header;
      chatml:  <|im_start|>{role}\\n{content}<|im_end|>\\n ... then
               <|im_start|>assistant\\n (Qwen2/2.5);
      plain:   "role: content" lines, then "assistant:" (the byte
               tokenizer and unknown vocabularies).
    """
    _validate(messages)
    if family == 'llama3':
        parts = ['<|begin_of_text|>']
        for m in messages:
            parts.append(f"<|start_header_id|>{m['role']}<|end_header_id|>"
                         f"\n\n{m['content']}<|eot_id|>")
        parts.append('<|start_header_id|>assistant<|end_header_id|>\n\n')
        return ''.join(parts)
    if family == 'chatml':
        parts = []
        for m in messages:
            parts.append(f"<|im_start|>{m['role']}\n{m['content']}"
                         f'<|im_end|>\n')
        parts.append('<|im_start|>assistant\n')
        return ''.join(parts)
    if family == 'plain':
        lines = [f"{m['role']}: {m['content']}" for m in messages]
        return '\n'.join(lines) + '\nassistant:'
    raise ValueError(f'unknown chat family {family!r}')


class StreamDecoder:
    """Incremental detokenizer: feed token ids, get UTF-8-safe text deltas.

    Tokens are not codepoint-aligned (a byte-level tokenizer splits
    multi-byte chars across tokens), so decoding each token on its own
    can emit replacement chars mid-stream. Strategy: decode the WHOLE
    sequence each feed and emit the suffix past what was already
    emitted, holding back a trailing replacement char until the next
    token completes it. O(n) per feed, bounded by max_new_tokens.
    """

    def __init__(self, tokenizer):
        self._tok = tokenizer
        self._ids: List[int] = []
        self._emitted = 0      # chars of the decoded string already sent

    def feed(self, ids: Iterable[int]) -> str:
        self._ids.extend(int(i) for i in ids)
        text = self._tok.decode(self._ids)
        # Hold back an incomplete multi-byte tail (shows up as U+FFFD).
        safe_end = len(text)
        while safe_end > self._emitted and text[safe_end - 1] == '�':
            safe_end -= 1
        delta = text[self._emitted:safe_end]
        self._emitted = safe_end
        return delta

    def flush(self) -> str:
        """Emit whatever remains (end of generation)."""
        text = self._tok.decode(self._ids)
        delta = text[self._emitted:]
        self._emitted = len(text)
        return delta
