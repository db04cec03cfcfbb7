"""Hermetic byte-level tokenizer (copy of
skypilot_tpu/data/tokenizer.py::ByteTokenizer). HF tokenizers wait for
the ``--hf-dir`` slice."""
from __future__ import annotations

from typing import List, Sequence


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
