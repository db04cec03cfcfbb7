"""DatasetSpec and the pure step-indexed batch sources: the port's own
copy of the in-process part of skypilot_tpu/data_service/spec.py.

A :class:`DatasetSpec` describes an input pipeline, and
:func:`load_source` builds a pure ``step -> batch`` source from it, so
the batch at step N is a function of (seed, corpus, step) alone: the
same across a checkpoint resume, and the same as the JAX package's
stream bit for bit (``synthetic_tokens`` draws the same numpy stream).

This copy has the synthetic and the plain-corpus sources. SFT
conversations, the tokenizer zoo and the data-service client wait for a
later slice (ROADMAP Queue 1 item 4).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from skypilot_tpu_torch.data import loader


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    """Everything needed to recreate the pipeline. ``seed`` feeds the
    synthetic stream; ``data_path`` the deterministic corpus indexer of
    data/loader.py."""
    batch_size: int
    seq_len: int
    vocab_size: int
    seed: int = 0
    data_path: Optional[str] = None
    tokenizer: Optional[str] = None

    def __post_init__(self):
        if self.batch_size < 1 or self.seq_len < 1:
            raise ValueError(f'batch_size={self.batch_size} and '
                             f'seq_len={self.seq_len} must be >= 1')
        if self.vocab_size < 1:
            raise ValueError(f'vocab_size={self.vocab_size} must be >= 1')


class Source:
    """Contiguous-window LM batches over a token corpus;
    ``batch_at_step`` is pure in ``step``."""

    def __init__(self, spec: DatasetSpec, tokens):
        self.spec = spec
        self._tokens = tokens

    def batch_at_step(self, step: int) -> Dict[str, np.ndarray]:
        return {'tokens': loader.batch_at_step(
            self._tokens, step, self.spec.batch_size, self.spec.seq_len)}


def synthetic_tokens(spec: DatasetSpec) -> np.ndarray:
    """The seeded synthetic corpus (no data path), reproducible from the
    spec alone."""
    rng = np.random.default_rng(spec.seed)
    base = rng.integers(
        0, spec.vocab_size,
        size=(max(4 * spec.batch_size * spec.seq_len, spec.seq_len + 2),),
        dtype=np.int64)
    return base.astype(np.int32)


def load_source(spec: DatasetSpec) -> Source:
    """Materialize the pipeline a spec describes. Raises ``ValueError``
    on a tokenizer/model vocab mismatch before any batch ships."""
    if spec.data_path is not None:
        tokens = loader.load_tokens(spec.data_path, spec.tokenizer)
        loader.validate_vocab(tokens, spec.vocab_size, context='Corpus')
        return Source(spec, tokens)
    return Source(spec, synthetic_tokens(spec))
