"""Tokenized, step-indexed data loader for the port's trainer (port of
skypilot_tpu/data/loader.py).

Batch k is a pure function of (corpus, k), so a run resumed at step k
continues the exact token stream (the checkpoint/resume contract of
train/checkpoints.py), and the stream equals the JAX package's batch
for batch.

Tokenization is byte-level (vocab 256). The JAX loader's
``transformers.AutoTokenizer`` waits for a later slice (the card's
machine has no transformers). ``.bin`` corpora read as a uint16
memmap: the JAX package's native C++ core gives the same batches from
the same file, so it is not ported. ``to_device`` takes the place of ``shard_batch``: one card, no
mesh.
"""
from __future__ import annotations

import os
from typing import Dict, Iterator, Optional

import numpy as np
import torch

BYTE_VOCAB = 256


def tokenize_text(text: str, tokenizer: Optional[str] = None) -> np.ndarray:
    """Text → int32 token ids: raw UTF-8 bytes (vocab 256)."""
    if tokenizer is not None:
        raise NotImplementedError(
            f'tokenizer {tokenizer!r}: the data loader\'s HF tokenizer '
            f'(transformers.AutoTokenizer in the JAX package) is not '
            f'ported; it waits for ROADMAP Queue 1 item 6 (model I/O: the '
            f'loader\'s --tokenizer). The port tokenizes text as bytes.')
    return np.frombuffer(text.encode('utf-8'), dtype=np.uint8).astype(
        np.int32)


def load_tokens(path: str, tokenizer: Optional[str] = None) -> np.ndarray:
    """Load a corpus: .npy (memmap) and .bin (uint16 memmap) are
    pre-tokenized; anything else is text, tokenized as bytes."""
    path = os.path.expanduser(path)
    if path.endswith('.npy'):
        return np.load(path, mmap_mode='r')
    if path.endswith('.bin'):
        # uint16 caps vocab at 65535, which covers every preset.
        return np.memmap(path, dtype=np.uint16, mode='r')
    with open(path, 'r', encoding='utf-8', errors='replace') as f:
        return tokenize_text(f.read(), tokenizer)


def validate_vocab(tokens, vocab_size: int, context: str = 'Corpus') -> None:
    """Refuse a tokenizer/model mismatch before any batch ships."""
    max_id = int(tokens.max())
    if max_id >= vocab_size:
        raise ValueError(
            f'{context} has token id {max_id} but the model vocab is '
            f'{vocab_size} — tokenizer/model mismatch. Pick a '
            f'bigger-vocab preset or a matching tokenizer.')


def batch_at_step(tokens, step: int, batch_size: int,
                  seq_len: int) -> np.ndarray:
    """The deterministic indexer: global batch for `step`, int32 [B, S+1].

    Rows stride through the corpus with wraparound; consecutive steps
    read consecutive windows."""
    n = len(tokens)
    need = seq_len + 1
    if n < need + 1:
        raise ValueError(f'Corpus has {n} tokens; need > {need}.')
    usable = n - need
    starts = (np.arange(batch_size, dtype=np.int64) * usable // batch_size +
              step * seq_len) % usable
    out = np.empty((batch_size, need), dtype=np.int32)
    for i, s in enumerate(starts):
        out[i] = tokens[s:s + need]
    return out


def token_batches(tokens, batch_size: int, seq_len: int,
                  start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite stream of {'tokens': [B, S+1]} starting at `start_step`."""
    step = start_step
    while True:
        yield {'tokens': batch_at_step(tokens, step, batch_size, seq_len)}
        step += 1


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """Host batch → tensors on ``device`` (the one card, or the CPU)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}
