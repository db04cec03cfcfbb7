"""Chat SFT datasets: conversations → tokens and assistant-only loss
masks (port of skypilot_tpu/data/sft.py, numpy only).

Input: JSONL, one conversation a line:
    {"messages": [{"role": "user", "content": "..."},
                  {"role": "assistant", "content": "..."}, ...]}

Each assistant message's content and its closing special train; role
headers, openers and every other turn do not. Segments are tokenized
one by one, so target spans are exact by construction. The arrays feed
train/train_lib.py's batch contract: ``tokens`` [B, S+1] and
``loss_mask`` [B, S] over the target positions.
"""
from __future__ import annotations

import functools
import json
import logging
from typing import Any, Dict, List, Tuple

import numpy as np

from skypilot_tpu_torch.data import tokenizer as tokenizer_lib

logger = logging.getLogger(__name__)


def render_segments(messages: List[Dict[str, str]], family: str
                    ) -> List[Tuple[str, bool]]:
    """Conversation → [(text, is_target)] segments, whose concatenation
    is the family's chat format (tokenizer.apply_chat_template without
    the inference-time assistant opener)."""
    tokenizer_lib._validate(messages)
    segs: List[Tuple[str, bool]] = []
    if family == 'llama3':
        segs.append(('<|begin_of_text|>', False))
        for m in messages:
            target = m['role'] == 'assistant'
            segs.append((f"<|start_header_id|>{m['role']}"
                         f'<|end_header_id|>\n\n', False))
            segs.append((f"{m['content']}<|eot_id|>", target))
    elif family == 'chatml':
        for m in messages:
            target = m['role'] == 'assistant'
            segs.append((f"<|im_start|>{m['role']}\n", False))
            segs.append((f"{m['content']}<|im_end|>\n", target))
    elif family == 'plain':
        for m in messages:
            target = m['role'] == 'assistant'
            segs.append((f"{m['role']}: ", False))
            segs.append((f"{m['content']}\n", target))
    else:
        raise ValueError(f'unknown chat family {family!r}')
    return segs


def encode_example(messages: List[Dict[str, str]], tokenizer,
                   family: str, seq_len: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """One conversation → (tokens [seq_len+1], loss_mask [seq_len]).

    loss_mask[t] gates target position t (predicting tokens[t+1]), so a
    target-segment token at position p is marked at p-1: the model
    learns to produce the assistant's tokens. Right-truncated at
    seq_len+1, right-padded with 0s under mask 0."""
    ids: List[int] = []
    is_target: List[bool] = []
    for text, target in render_segments(messages, family):
        # add_special_tokens=False: the segments carry their specials
        # literally, and a post-processor's BOS (Llama 3's) would enter
        # every segment, the loss targets included.
        seg = tokenizer.encode(text, add_special_tokens=False)
        ids.extend(seg)
        is_target.extend([target] * len(seg))
    ids = ids[:seq_len + 1]
    is_target = is_target[:seq_len + 1]
    tokens = np.zeros((seq_len + 1,), np.int32)
    tokens[:len(ids)] = ids
    mask = np.zeros((seq_len,), np.float32)
    for pos in range(1, len(ids)):
        if is_target[pos]:
            mask[pos - 1] = 1.0
    return tokens, mask


def load_sft_dataset(path: str, tokenizer, family: str, seq_len: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """JSONL → (tokens [N, seq_len+1], loss_mask [N, seq_len]).

    Conversations with nothing to train on (no assistant turn, or every
    assistant token truncated away) are skipped with a warning; an empty
    result raises."""
    tokens_rows, mask_rows, skipped = [], [], 0
    with open(path, 'r', encoding='utf-8') as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            messages = json.loads(line).get('messages')
            if messages is None:
                raise ValueError(f'{path}:{lineno}: record needs '
                                 f'"messages"')
            t, m = encode_example(messages, tokenizer, family, seq_len)
            if m.sum() == 0:
                skipped += 1
                continue
            tokens_rows.append(t)
            mask_rows.append(m)
    if skipped:
        logger.warning('%s: skipped %d conversation(s) with no trainable '
                       'assistant tokens (missing assistant turn, or '
                       'truncated away at --seq-len %d).', path, skipped,
                       seq_len)
    if not tokens_rows:
        raise ValueError(f'{path}: no trainable conversations.')
    return np.stack(tokens_rows), np.stack(mask_rows)


@functools.lru_cache(maxsize=4)
def _epoch_perm(n: int, epoch: int) -> np.ndarray:
    return np.random.default_rng(epoch).permutation(n)


def batch_at_step(tokens: np.ndarray, masks: np.ndarray, step: int,
                  batch_size: int) -> Dict[str, Any]:
    """The batch of ``step``, a pure function of it: examples cycle
    under a seeded shuffle per epoch. The epoch is taken per element,
    so a batch across an epoch boundary draws its tail from the next
    epoch's permutation and every epoch serves each example once."""
    n = tokens.shape[0]
    rows = np.empty((batch_size,), np.int64)
    for i in range(batch_size):
        epoch, off = divmod(step * batch_size + i, n)
        rows[i] = _epoch_perm(n, epoch)[off]
    return {'tokens': tokens[rows], 'loss_mask': masks[rows]}
