"""Hermetic byte-level tokenizer and the incremental (SSE) decoder
(copies of skypilot_tpu/data/tokenizer.py::ByteTokenizer and
::StreamDecoder). HF tokenizers wait for the ``--hf-dir`` slice."""
from __future__ import annotations

from typing import Iterable, List, Sequence


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
