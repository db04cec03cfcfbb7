"""The teacher-forced quality protocol of the paged decode path (port of
the JAX package's ``bench.py::_quality_family``): the figures that hold
an int8 K/V pool against the fp pool.

One family's prompts are prefilled, their K/V scattered into a fresh
pool (which quantizes them on an int8 pool), then each continuation
position is scored through ``paged_decode_step`` on that pool:

  - ``nll``: the mean teacher-forced negative log-likelihood, nats a
    token, over the forced continuation (the prefill's last-position
    logits score its first token, each step the next);
  - ``greedy_tokens``: the argmax chain from the same prefill, through
    the same steps on a second fresh pool.

The bands the JAX bench holds an int8 run to against the fp run:
``QUALITY_NLL_BAND`` (absolute nats a token) and
``QUALITY_GREEDY_MATCH_MIN`` (share of greedy tokens equal).
"""
from __future__ import annotations

from typing import Dict, List

import torch

from skypilot_tpu_torch.models import paging

QUALITY_NLL_BAND = 0.05
QUALITY_GREEDY_MATCH_MIN = 0.9


def greedy_match(a: List[List[int]], b: List[List[int]]) -> float:
    """Share of positions where two [B, CONT] token lists agree."""
    flat_a = [t for row in a for t in row]
    flat_b = [t for row in b for t in row]
    n = min(len(flat_a), len(flat_b))
    return sum(x == y for x, y in zip(flat_a, flat_b)) / n if n else 0.0


@torch.no_grad()
def quality_family(prog, params, cfg, prompts: torch.Tensor,
                   forced: torch.Tensor, quant: str, page_size: int,
                   max_pages: int) -> Dict:
    """The protocol for prompts [B, P] and forced continuations
    [B, CONT] (int32, on the params' device) through ``prog``
    (models/decode.py or models/mla.py) on a pool of ``quant``: row b
    holds pages 1 + b * pages_per_row onwards, as in the JAX bench.
    Returns {'nll': float, 'greedy_tokens': [B, CONT] list, and
    [CONT, B] tensors of the teacher-forced positions: 'nll_rows', the
    argmax 'tf_argmax' and the top-2 logit margin 'tf_margin'}."""
    b, plen = prompts.shape
    cont = forced.shape[1]
    dev = prompts.device
    max_len = page_size * max_pages
    per_row = paging.pages_for(plen + cont, page_size)
    table = torch.zeros((b, max_pages), dtype=torch.int32)
    for row in range(b):
        table[row, :per_row] = 1 + row * per_row + torch.arange(per_row)
    lengths = torch.full((b,), plen, dtype=torch.int32, device=dev)
    logits0, rows_a, rows_b = prog.prefill(params, prompts, cfg, plen,
                                           lengths=lengths)

    def fresh_pool():
        pool = prog.init_page_pool(cfg, b * per_row + 1, page_size, b,
                                   max_pages, dev, quant=quant)
        pool.table.copy_(table)
        return paging.scatter_prefill(
            pool, rows_a, rows_b, torch.arange(b, device=dev), plen, lengths)

    rows = torch.arange(b, device=dev)
    pool = fresh_pool()
    nll, top2 = [], []

    def score(logits, t):
        lp = torch.log_softmax(logits.float(), dim=-1)
        nll.append(-lp[rows, forced[:, t].long()])
        top2.append(torch.topk(logits.float(), 2, dim=-1))
    score(logits0, 0)
    for t in range(cont - 1):
        logits, pool = prog.paged_decode_step(params, forced[:, t], pool,
                                              cfg, max_len=max_len)
        score(logits, t + 1)
    nll_rows = torch.stack(nll)
    pool = fresh_pool()
    cur = logits0.argmax(-1).to(torch.int32)
    greedy = [cur]
    for _ in range(cont - 1):
        logits, pool = prog.paged_decode_step(params, cur, pool, cfg,
                                              max_len=max_len)
        cur = logits.argmax(-1).to(torch.int32)
        greedy.append(cur)
    return {'nll': float(nll_rows.mean()),
            'greedy_tokens': torch.stack(greedy, 1).cpu().tolist(),
            'nll_rows': nll_rows.cpu(),
            'tf_argmax': torch.stack([t.indices[:, 0] for t in top2]).cpu(),
            'tf_margin': torch.stack([t.values[:, 0] - t.values[:, 1]
                                      for t in top2]).cpu()}
