"""Offline batch inference: JSONL in, JSONL out (port of
skypilot_tpu/models/batch_infer.py: ``_pooled_hidden``, ``read_items``,
``done_ids``, ``BatchRunner`` with ``_pad_batch``, ``generate_batch``
and ``embed_batch``, ``run``, ``main``).

The managed-job workload of the reference's batch-inference recipe:
  - stride partitioning: worker j of N takes the input lines whose index
    is j modulo N, from ``--num-workers`` / ``--worker-id`` or the gang
    environment (SKYPILOT_NUM_NODES / SKYPILOT_NODE_RANK), each writing
    its own ``<output>.part<j>``;
  - resume: ids already in the worker's output are skipped, so a
    preempted job re-runs the same command and continues;
  - length buckets: items sort by token length, and each batch pads to
    its longest row rounded up to a power of two (``prompt_lengths``
    keeps the padding out of the math);
  - ``generate`` (models/decode.py ``generate``, or models/mla.py's for
    the MLA family: kernel A in every bucket's prefill, the steps one
    replayed CUDA graph on the card) and ``embed`` (final-norm hidden
    states pooled over the real tokens, mean or last: the dense family,
    through ``llama.forward``, kernel A in every layer).

Params come from the preset, drawn with a seeded ``torch.Generator``
into the compute dtype, as the engine draws them; the tokenizer is the
byte tokenizer. It runs on the card unless ``--device cpu`` is asked
for. ``--hf-dir`` and ``--tokenizer`` wait for ROADMAP Queue 1 item 6
and ``--mesh`` for item 8; each is refused by name.

    python -m skypilot_tpu_torch.models.batch_infer --input in.jsonl \\
        --output out.jsonl --model llama-1b --mode generate   # or embed
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from skypilot_tpu_torch.config import MLAConfig, check_supported, get_config
from skypilot_tpu_torch.data.tokenizer import ByteTokenizer
from skypilot_tpu_torch.models import decode, llama, mla, module_for

logger = logging.getLogger('skypilot_tpu_torch.models.batch_infer')


def refuse_unported(hf_dir: Optional[str] = None,
                    tokenizer_path: Optional[str] = None,
                    mesh_spec: Optional[Dict[str, int]] = None) -> None:
    """Raise NotImplementedError, naming the flag, for what the port
    does not have yet."""
    for flag, value in (('--hf-dir', hf_dir), ('--tokenizer',
                                               tokenizer_path)):
        if value:
            raise NotImplementedError(
                f'{flag} is not ported yet: HF checkpoints and tokenizers '
                f'wait for ROADMAP Queue 1 item 6 (model I/O)')
    if mesh_spec:
        raise NotImplementedError(
            '--mesh is not ported yet: the port runs on one card; meshes '
            'wait for ROADMAP Queue 1 item 8 (parallelism)')


def _pooled_hidden(params, tokens: torch.Tensor, lens: torch.Tensor, *,
                   cfg, pool: str) -> torch.Tensor:
    """Final-norm hidden states [B, D] fp32 pooled over each row's real
    tokens: their mean, or with ``pool='last'`` the last one."""
    hidden = llama.forward(params, tokens, cfg, return_hidden=True)
    if pool == 'last':
        idx = torch.clamp(lens.long() - 1, min=0)
        return torch.gather(hidden, 1, idx[:, None, None].expand(
            -1, 1, hidden.shape[-1]))[:, 0]
    mask = (torch.arange(tokens.shape[1], device=tokens.device)[None, :]
            < lens[:, None]).float()
    return ((hidden * mask[..., None]).sum(dim=1)
            / torch.clamp(mask.sum(dim=1), min=1.0)[:, None])


def read_items(path: str, num_workers: int, worker_id: int
               ) -> List[Dict[str, Any]]:
    """This worker's stride slice of the input JSONL. Each line needs
    'prompt' or 'text'; 'id' defaults to the global line index (stable
    across workers and restarts)."""
    items = []
    with open(path, 'r', encoding='utf-8') as f:
        for idx, line in enumerate(f):
            line = line.strip()
            if not line or idx % num_workers != worker_id:
                continue
            rec = json.loads(line)
            text = rec.get('prompt', rec.get('text'))
            if text is None:
                raise ValueError(
                    f'{path}:{idx + 1}: record needs "prompt" or "text"')
            items.append({'id': rec.get('id', idx), 'text': text})
    return items


def done_ids(output_path: str) -> set:
    """Ids already in the output partition (resume). A truncated last
    line (a crash mid-write) is ignored."""
    done = set()
    if not os.path.exists(output_path):
        return done
    with open(output_path, 'r', encoding='utf-8') as f:
        for line in f:
            try:
                done.add(json.loads(line)['id'])
            except (json.JSONDecodeError, KeyError):
                continue
    return done


class BatchRunner:
    """Owns the params, the tokenizer and the bucketed batch loop.
    ``device`` defaults to 'cuda' and raises without a card; tests pass
    ``device='cpu'``, and may pass a small ``cfg`` with bridged
    ``params``."""

    def __init__(self, model: Optional[str] = None,
                 hf_dir: Optional[str] = None,
                 tokenizer_path: Optional[str] = None,
                 mesh_spec: Optional[Dict[str, int]] = None,
                 max_len: int = 2048, *, device: str = 'cuda',
                 cfg=None, params=None, seed: int = 0):
        refuse_unported(hf_dir, tokenizer_path, mesh_spec)
        self.device = torch.device(device)
        if self.device.type == 'cuda' and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: batch inference runs on the "
                               "card unless device='cpu' is asked for")
        if cfg is None:
            if model is None:
                raise ValueError('need --model')
            cfg = get_config(model)
        check_supported(cfg)
        self.cfg = cfg
        self.is_mla = isinstance(cfg, MLAConfig)
        self.mod = module_for(cfg)
        self.max_len = min(max_len, cfg.max_seq_len)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = self.mod.init_params(cfg, gen, self.device,
                                          dtype=cfg.dtype)
        self.params = params
        self.tokenizer = ByteTokenizer()

    def _pad_batch(self, token_rows: List[List[int]], width_cap: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, int]:
        """Pad to the batch's longest row rounded up to a power of two,
        capped at ``width_cap``. Longer rows are right-truncated: the
        job must make progress (a raise here would fail every restart of
        a managed job on the same record)."""
        lengths = [len(r) for r in token_rows]
        width = min(decode.bucket_size(max(lengths)), width_cap)
        if any(n > width for n in lengths):
            logger.warning(
                '%d prompt(s) truncated to %d tokens (generation headroom '
                'under --max-len %d).', sum(n > width for n in lengths),
                width, self.max_len)
        arr = torch.zeros((len(token_rows), width), dtype=torch.int32)
        for i, row in enumerate(token_rows):
            row = row[:width]
            arr[i, :len(row)] = torch.tensor(row, dtype=torch.int32)
            lengths[i] = len(row)
        return (arr.to(self.device),
                torch.tensor(lengths, dtype=torch.int32,
                             device=self.device), width)

    def generate_batch(self, token_rows: List[List[int]],
                       max_new_tokens: int, temperature: float,
                       top_k: Optional[int], top_p: Optional[float],
                       seed: int) -> List[List[int]]:
        """Per-row generated ids, cut at the first EOS."""
        dec = mla if self.is_mla else decode
        if max_new_tokens >= self.max_len:
            raise ValueError(
                f'--max-new-tokens {max_new_tokens} leaves no prompt '
                f'room under --max-len {self.max_len}')
        # The width cap reserves the generation budget, so no batch can
        # leave it short.
        prompt, lengths, width = self._pad_batch(
            token_rows, self.max_len - max_new_tokens)
        eos_ids = list(getattr(self.tokenizer, 'eos_ids', None) or [])
        gen = torch.Generator(device=self.device).manual_seed(seed)
        out = dec.generate(
            self.params, prompt, self.cfg, max_new_tokens,
            max_len=width + max_new_tokens, temperature=temperature,
            eos_id=eos_ids[0] if eos_ids else None, top_k=top_k,
            top_p=top_p, prompt_lengths=lengths, generator=gen).cpu()
        rows = []
        for r in out.tolist():
            ids = []
            for t in r:
                if t in eos_ids:
                    break
                ids.append(int(t))
            rows.append(ids)
        return rows

    @torch.no_grad()
    def embed_batch(self, token_rows: List[List[int]],
                    pool: str = 'mean') -> List[List[float]]:
        """Per-row embeddings: final-norm hidden states pooled over the
        real tokens (padding never enters the pool). Dense family
        only."""
        if self.mod is not llama:
            # Only llama.forward has return_hidden (the dense presets:
            # the recipe's gte-Qwen2 embedder is this architecture).
            raise ValueError(
                f'embed mode supports the dense family only, not '
                f'{type(self.cfg).__name__}')
        prompt, lengths, _ = self._pad_batch(token_rows, self.max_len)
        out = _pooled_hidden(self.params, prompt, lengths, cfg=self.cfg,
                             pool=pool)
        return out.cpu().tolist()


def run(args) -> Dict[str, int]:
    """One worker's pass over its partition: {'total', 'done', 'ran'}
    (its items, those found done, those run now)."""
    refuse_unported(args.hf_dir, args.tokenizer, args.mesh)
    num_workers = args.num_workers or int(
        os.environ.get('SKYPILOT_NUM_NODES', '1'))
    worker_id = (args.worker_id if args.worker_id is not None
                 else int(os.environ.get('SKYPILOT_NODE_RANK', '0')))
    if not 0 <= worker_id < num_workers:
        raise ValueError(f'worker_id {worker_id} outside [0, '
                         f'{num_workers})')
    out_path = (args.output if num_workers == 1
                else f'{args.output}.part{worker_id}')

    items = read_items(args.input, num_workers, worker_id)
    done = done_ids(out_path)
    todo = [it for it in items if it['id'] not in done]
    logger.info('worker %d/%d: %d items, %d already done, %d to run -> %s',
                worker_id, num_workers, len(items), len(done), len(todo),
                out_path)
    if not todo:
        return {'total': len(items), 'done': len(done), 'ran': 0}

    runner = BatchRunner(model=args.model, max_len=args.max_len,
                         device=getattr(args, 'device', 'cuda'))
    for it in todo:
        it['tokens'] = runner.tokenizer.encode(it['text'])
    # Length-sorted: near-uniform batches, little padding, few buckets.
    todo.sort(key=lambda it: len(it['tokens']))

    ran = 0
    t0 = time.perf_counter()
    with open(out_path, 'a', encoding='utf-8') as f:
        for lo in range(0, len(todo), args.batch_size):
            chunk = todo[lo:lo + args.batch_size]
            rows = [it['tokens'] for it in chunk]
            if args.mode == 'embed':
                embs = runner.embed_batch(rows, pool=args.pool)
                for it, e in zip(chunk, embs):
                    f.write(json.dumps(
                        {'id': it['id'],
                         'embedding': [round(v, 6) for v in e]}) + '\n')
            else:
                outs = runner.generate_batch(
                    rows, args.max_new_tokens, args.temperature,
                    args.top_k, args.top_p, seed=args.seed + lo)
                for it, ids in zip(chunk, outs):
                    f.write(json.dumps(
                        {'id': it['id'],
                         'completion': runner.tokenizer.decode(ids),
                         'tokens': len(ids)}) + '\n')
            f.flush()
            ran += len(chunk)
            if ran % (args.batch_size * 8) == 0 or ran == len(todo):
                rate = ran / max(time.perf_counter() - t0, 1e-9)
                logger.info('%d/%d (%.2f items/s)', ran, len(todo), rate)
    return {'total': len(items), 'done': len(done), 'ran': ran}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog='skypilot_tpu_torch.models.batch_infer')
    parser.add_argument('--input', required=True, help='JSONL of '
                        '{"prompt"|"text": ..., "id"?: ...} records.')
    parser.add_argument('--output', required=True)
    parser.add_argument('--mode', choices=('generate', 'embed'),
                        default='generate')
    parser.add_argument('--model', default=None)
    parser.add_argument('--hf-dir', default=None,
                        help='Not ported yet (ROADMAP Queue 1 item 6).')
    parser.add_argument('--tokenizer', default=None,
                        help='Not ported yet (ROADMAP Queue 1 item 6).')
    parser.add_argument('--mesh', default='',
                        help='Not ported yet (ROADMAP Queue 1 item 8).')
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (default) or 'cpu'.")
    parser.add_argument('--batch-size', type=int, default=32)
    parser.add_argument('--max-len', type=int, default=2048)
    parser.add_argument('--max-new-tokens', type=int, default=128)
    parser.add_argument('--temperature', type=float, default=0.0)
    parser.add_argument('--top-k', type=int, default=None)
    parser.add_argument('--top-p', type=float, default=None)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--pool', choices=('mean', 'last'),
                        default='mean')
    parser.add_argument('--num-workers', type=int, default=None,
                        help='Stride width (default: '
                             '$SKYPILOT_NUM_NODES).')
    parser.add_argument('--worker-id', type=int, default=None,
                        help='This worker (default: '
                             '$SKYPILOT_NODE_RANK).')
    return parser


def main() -> None:
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args()
    mesh = {}
    for part in filter(None, args.mesh.split(',')):
        k, v = part.split('=')
        mesh[k.strip()] = int(v)
    args.mesh = mesh
    stats = run(args)
    logger.info(json.dumps(stats))


if __name__ == '__main__':
    main()
