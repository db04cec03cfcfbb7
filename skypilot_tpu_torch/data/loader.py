"""Tokenized, step-indexed data loader for the port's trainer (port of
skypilot_tpu/data/loader.py).

Batch k is a pure function of (corpus, k), so a run resumed at step k
continues the exact token stream (the checkpoint/resume contract of
train/checkpoints.py), and the stream equals the JAX package's batch
for batch.

Tokenization is byte-level (vocab 256) by default; ``--tokenizer``
names a local checkpoint directory or ``tokenizer.json``, read by the
port's own reader (data/tokenizer_json.py) where the JAX loader runs
``transformers.AutoTokenizer``, with the same ids (its post-processor,
Llama 3's BOS say, included). ``.bin`` corpora read as a uint16
memmap: the JAX package's native C++ core gives the same batches from
the same file, so it is not ported. ``to_device`` puts a batch on the
one card (or the CPU); ``shard_batch`` keeps a mesh rank's rows of it.
"""
from __future__ import annotations

import os
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from skypilot_tpu_torch.data import tokenizer as tokenizer_lib

BYTE_VOCAB = 256


def tokenize_text(text: str, tokenizer: Optional[str] = None) -> np.ndarray:
    """Text → int32 token ids: raw UTF-8 bytes (vocab 256), or through
    ``tokenizer``, a checkpoint directory or a ``tokenizer.json`` path,
    with its special tokens added. A hub name is refused: nothing is
    downloaded."""
    if tokenizer is None:
        return np.frombuffer(text.encode('utf-8'), dtype=np.uint8).astype(
            np.int32)
    path = os.path.expanduser(tokenizer)
    if not os.path.exists(path):
        raise ValueError(
            f'tokenizer {tokenizer!r} is not a local directory or '
            f'tokenizer.json: the port reads tokenizer.json from disk and '
            f'downloads nothing (the JAX loader\'s AutoTokenizer can take '
            f'a hub name; the card has no network)')
    return np.asarray(tokenizer_lib.load_tokenizer(path).encode(text),
                      dtype=np.int32)


def load_tokens(path: str, tokenizer: Optional[str] = None) -> np.ndarray:
    """Load a corpus: .npy (memmap) and .bin (uint16 memmap) are
    pre-tokenized; anything else is text (tokenize_text)."""
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


def shard_batch(batch: Dict[str, np.ndarray], mesh, device
                ) -> Dict[str, torch.Tensor]:
    """Every rank of a mesh (parallel/mesh.py) reads the same global
    batch from the deterministic source; this keeps the rows of its
    ('data', 'fsdp') coordinate, the 'batch' rule, at the full length,
    on ``device``. Its sequence slots are cut by the train step after
    the shift (the targets need the next slot's token, and zigzag
    permutes the whole sequence first): train/train_lib.py."""
    from skypilot_tpu_torch.parallel import sharding
    return to_device({k: sharding.local_shard(torch.from_numpy(
        np.ascontiguousarray(v)), 'batch', 0, mesh).numpy()
        for k, v in batch.items()}, device)
