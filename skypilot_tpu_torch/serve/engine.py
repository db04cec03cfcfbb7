"""The inference engine and its HTTP surface (a reduced port of
skypilot_tpu/serve/engine.py: ``InferenceEngine``,
``_reset_device_state``, ``_pages_needed``, ``_admit_group``,
``batch_loop``, ``build_app``'s ``/health`` and ``/generate``, ``main``).

What it keeps: ``MAX_BATCH`` slots over a block-paged K/V pool
(page size 64, ``MAX_BATCH * pages_for(max_len) + 1`` pages with page
0 the trash page); admission that groups same-bucket prompts into one
prefill and scatters it into freshly allocated pages; one decode token
per active row per loop (inactive rows write the trash page); finish at
``max_new_tokens`` or a stop id, with pages released at once; per-row
greedy / temperature / top-k / top-p sampling.

What waits (ROADMAP Queue 1 item 3): speculative decoding, the prefix
cache, chunked prefill, multi-step dispatch, penalties and top
logprobs, the OpenAI routes and SSE, metrics and the flight recorder,
the spill tier and int8 KV, disagg, meshes and multi-host, and
``--hf-dir`` / ``--ckpt-dir``.

The HTTP server is the standard library's ThreadingHTTPServer; the
batch loop runs in its own thread and owns all device state. Request
handlers only enqueue and wait on a concurrent.futures.Future.

    python -m skypilot_tpu_torch.serve.engine --model llama-1b --port 8300
"""
from __future__ import annotations

import argparse
import collections
import concurrent.futures
import dataclasses
import json
import logging
import math
import queue
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from skypilot_tpu_torch.config import LlamaConfig, check_supported, get_config
from skypilot_tpu_torch.data.tokenizer import ByteTokenizer
from skypilot_tpu_torch.models import decode, llama, paging

logger = logging.getLogger(__name__)

MAX_BATCH = 8
PAGE_SIZE = 64
MAX_QUEUE = 64


class EngineOverloaded(Exception):
    """The bounded admission queue is full (answered with 429)."""


@dataclasses.dataclass
class Request:
    tokens: List[int]
    max_new: int
    temperature: float
    top_k: Optional[int]
    top_p: Optional[float]
    stop_ids: Tuple[int, ...]
    future: Optional[concurrent.futures.Future]
    t_submit: float = 0.0


class InferenceEngine:
    """Owns params, the page pool and the batched generate loop.

    ``device`` defaults to 'cuda'; constructing on 'cuda' without a card
    raises (there is no fallback to the CPU). Tests pass ``device='cpu'``
    plus a small ``cfg`` and bridged ``params``."""

    def __init__(self, model: str = 'llama-1b', *,
                 cfg: Optional[LlamaConfig] = None, params=None,
                 max_len: Optional[int] = None, device: str = 'cuda',
                 seed: int = 0):
        self.device = torch.device(device)
        if self.device.type == 'cuda' and not torch.cuda.is_available():
            raise RuntimeError('no CUDA device: the engine runs on the card '
                               "unless device='cpu' is asked for")
        self.cfg = cfg if cfg is not None else get_config(model)
        check_supported(self.cfg)
        self.model_name = model
        self.max_len = max_len or min(self.cfg.max_seq_len, 2048)
        self.max_batch = MAX_BATCH
        self.page_size = PAGE_SIZE
        self.seed = seed
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = llama.init_params(self.cfg, gen, self.device)
            logger.info('Serving randomly-initialized params (seed %d).',
                        seed)
        self.params = decode.cast_params_for_decode(params, self.cfg)
        self.tokenizer = ByteTokenizer()
        self._queue: 'queue.Queue[Request]' = queue.Queue(maxsize=MAX_QUEUE)
        self._hold: List[Request] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.warm = False
        self.loop_error: Optional[BaseException] = None
        self.step_count = 0
        # Finished requests' (ttft_s, tpot_s, n_tokens), newest last.
        self.timings: collections.deque = collections.deque(maxlen=4096)
        self._reset_device_state()

    # -- device state ------------------------------------------------------
    def _reset_device_state(self) -> None:
        """(Re)build the page pool, allocator, slots and sampling state.
        Runs at construction and after a failed admit/step."""
        psz = self.page_size
        self._max_pages = paging.pages_for(self.max_len, psz)
        self.n_pages = self.max_batch * self._max_pages + 1
        self.alloc = paging.PageAllocator(self.n_pages)
        self._table_np = np.zeros((self.max_batch, self._max_pages),
                                  np.int32)
        self._table_dirty = True
        self.cache = decode.init_page_pool(
            self.cfg, self.n_pages, psz, self.max_batch, self._max_pages,
            device=self.device)
        self.slots: List[Optional[Dict[str, Any]]] = [None] * self.max_batch
        self.last = np.zeros(self.max_batch, np.int32)
        self.temp = np.zeros(self.max_batch, np.float32)
        self.topk = np.zeros(self.max_batch, np.int32)
        self.topp = np.zeros(self.max_batch, np.float32)
        self.generator = torch.Generator(device=self.device).manual_seed(
            self.seed)

    def _refresh_table(self) -> None:
        """Push the host page-table mirror to the device if dirty."""
        if self._table_dirty:
            self.cache.table.copy_(torch.from_numpy(self._table_np))
            self._table_dirty = False

    def _pages_needed(self, req: Request) -> int:
        """Pages a request reserves: bucketed prompt + max_new, capped at
        the table's coverage."""
        want = min(decode.bucket_size(len(req.tokens)) + req.max_new,
                   self._max_pages * self.page_size)
        return paging.pages_for(want, self.page_size)

    def _reserve_slot_pages(self, slot: int, pids: List[int]) -> None:
        self._table_np[slot, :len(pids)] = pids
        self._table_np[slot, len(pids):] = 0
        self._table_dirty = True

    def _release_slot_pages(self, slot: int) -> None:
        pids = [int(p) for p in self._table_np[slot] if p]
        if pids:
            self.alloc.unref_all(pids)
            self._table_np[slot] = 0
            self._table_dirty = True

    # -- observability -----------------------------------------------------
    def queue_depth(self) -> int:
        return self._queue.qsize() + len(self._hold)

    def in_flight(self) -> int:
        return sum(1 for s in self.slots if s is not None)

    # -- requests ------------------------------------------------------------
    def check_len(self, tokens: List[int], max_new: int) -> Optional[str]:
        """Admission is checked against the bucketed prompt length."""
        bucket = decode.bucket_size(len(tokens))
        if bucket + max_new > self.max_len:
            return (f'bucketed prompt ({bucket}) + max new tokens exceeds '
                    f'max_len {self.max_len}')
        return None

    def submit(self, tokens: List[int], max_new: int,
               temperature: float = 0.0, top_k: Optional[int] = None,
               top_p: Optional[float] = None,
               stop_ids: Tuple[int, ...] = ()
               ) -> concurrent.futures.Future:
        """Enqueue a request; the future resolves to (tokens,
        finish_reason, chosen-token logprobs). Raises EngineOverloaded
        when the bounded queue is full."""
        fut: concurrent.futures.Future = concurrent.futures.Future()
        req = Request(list(tokens), int(max_new), float(temperature), top_k,
                      top_p, tuple(stop_ids), fut, time.perf_counter())
        try:
            self._queue.put_nowait(req)
        except queue.Full:
            raise EngineOverloaded(
                f'admission queue full ({MAX_QUEUE} waiting)') from None
        return fut

    # -- admission -------------------------------------------------------------
    def _drain_admissible(self) -> List[Request]:
        """Pop requests bounded by free slots and free pages, FIFO: once
        one is held, nothing younger passes it."""
        items: List[Request] = []
        free_slots = sum(1 for s in self.slots if s is None)
        budget = self.alloc.free_count

        def fits(req: Request) -> bool:
            nonlocal budget
            n = self._pages_needed(req)
            if n > budget:
                return False
            budget -= n
            return True

        held, self._hold = self._hold, []
        for req in held:
            if len(items) < free_slots and fits(req):
                items.append(req)
            else:
                self._hold.append(req)
        while (not self._hold and len(items) < free_slots and
               not self._queue.empty()):
            req = self._queue.get_nowait()
            if fits(req):
                items.append(req)
            else:
                self._hold.append(req)
        return items

    def _admit_groups(self, items: List[Request]) -> List[List[Request]]:
        """Same prompt bucket, power-of-two group sizes (largest first)."""
        by_bucket: Dict[int, List[Request]] = {}
        for req in items:
            by_bucket.setdefault(decode.bucket_size(len(req.tokens)),
                                 []).append(req)
        groups = []
        for _, lst in sorted(by_bucket.items()):
            i = 0
            while i < len(lst):
                size = 1
                while (size * 2 <= len(lst) - i and
                       size * 2 <= self.max_batch):
                    size *= 2
                groups.append(lst[i:i + size])
                i += size
        return groups

    def _admit_group(self, items: List[Request]) -> None:
        """Prefill same-bucket prompts in ONE call, scatter their K/V into
        freshly allocated pages, and sample each first token."""
        bucket = decode.bucket_size(len(items[0].tokens))
        slots, padded, lengths = [], [], []
        for req in items:
            if decode.bucket_size(len(req.tokens)) != bucket:
                raise ValueError('admit group mixes prompt buckets')
            slot = next(i for i, s in enumerate(self.slots)
                        if s is None and i not in slots)
            slots.append(slot)
            padded.append(req.tokens + [0] * (bucket - len(req.tokens)))
            lengths.append(len(req.tokens))
            self.temp[slot] = max(req.temperature, 0.0)
            self.topk[slot] = int(req.top_k) if req.top_k else 0
            self.topp[slot] = float(req.top_p) if req.top_p else 0.0
            self._reserve_slot_pages(
                slot, self.alloc.alloc(self._pages_needed(req)))
        self._refresh_table()
        dev = self.device
        slots_t = torch.tensor(slots, dtype=torch.int64, device=dev)
        lengths_t = torch.tensor(lengths, dtype=torch.int32, device=dev)
        logits, ks, vs = decode.prefill(
            self.params, torch.tensor(padded, dtype=torch.int32, device=dev),
            self.cfg, self.max_len, lengths=lengths_t)
        paging.scatter_prefill(self.cache, ks, vs, slots_t, bucket,
                               lengths_t)
        first = decode.select_token_per_row(
            logits, torch.from_numpy(self.temp[slots]).to(dev),
            torch.from_numpy(self.topk[slots]).to(dev),
            torch.from_numpy(self.topp[slots]).to(dev), self.generator)
        first_lp = decode.chosen_logprob(logits, first)
        first, first_lp = first.cpu().numpy(), first_lp.cpu().numpy()
        now = time.perf_counter()
        for i, req in enumerate(items):
            self._finish_admit(req, slots[i], int(first[i]),
                               float(first_lp[i]), now)

    def _finish_admit(self, req: Request, slot: int, first: int,
                      first_lp: float, now: float) -> None:
        self.last[slot] = first
        entry = {'req': req, 'out': [], 'lps': [], 'finish': None,
                 'stop': frozenset(req.stop_ids), 't_first': now}
        if first in entry['stop']:
            entry['finish'] = 'stop'
        else:
            entry['out'].append(first)
            entry['lps'].append(first_lp)
            if len(entry['out']) >= req.max_new:
                entry['finish'] = 'length'
        self.slots[slot] = entry

    # -- decode ----------------------------------------------------------------
    @staticmethod
    def _row_active(s: Optional[Dict[str, Any]]) -> bool:
        return s is not None and s['finish'] is None

    def _step(self) -> None:
        """One decode token for every active row; inactive rows write the
        trash page and keep their last token."""
        self._refresh_table()
        dev = self.device
        active_np = np.array([self._row_active(s) for s in self.slots])
        active = torch.from_numpy(active_np).to(dev)
        last = torch.from_numpy(self.last).to(dev)
        logits, _ = decode.paged_decode_step(
            self.params, last, self.cache, self.cfg, max_len=self.max_len,
            active=active)
        nxt = decode.select_token_per_row(
            logits, torch.from_numpy(self.temp).to(dev),
            torch.from_numpy(self.topk).to(dev),
            torch.from_numpy(self.topp).to(dev), self.generator)
        nxt = torch.where(active, nxt, last)
        lps = decode.chosen_logprob(logits, nxt).cpu().numpy()
        toks = nxt.cpu().numpy()
        self.step_count += 1
        for i, s in enumerate(self.slots):
            if not self._row_active(s):
                continue
            tok = int(toks[i])
            self.last[i] = tok
            if tok in s['stop']:
                s['finish'] = 'stop'
                continue
            s['out'].append(tok)
            s['lps'].append(float(lps[i]))
            if len(s['out']) >= s['req'].max_new:
                s['finish'] = 'length'

    def _publish(self) -> None:
        """Resolve finished rows and return their pages at once."""
        now = time.perf_counter()
        for i, s in enumerate(self.slots):
            if s is None or s['finish'] is None:
                continue
            req = s['req']
            n = len(s['out'])
            self.timings.append((
                s['t_first'] - req.t_submit,
                (now - s['t_first']) / (n - 1) if n > 1 else 0.0, n))
            if req.future is not None and not req.future.done():
                req.future.set_result((s['out'], s['finish'], s['lps']))
            self.slots[i] = None
            self._release_slot_pages(i)
            self.temp[i] = self.topk[i] = self.topp[i] = 0

    def _fail(self, err: Exception, extra: List[Request]) -> None:
        """Contain an admit/step failure: fail every request on the
        device and the group being admitted, then rebuild device state.
        Requests still queued or held are untouched."""
        logger.error('engine step/admit failed; resetting: %s\n%s', err,
                     traceback.format_exc())
        futs = [s['req'].future for s in self.slots if s is not None]
        futs += [r.future for r in extra]
        self._reset_device_state()
        for fut in futs:
            if fut is not None and not fut.done():
                fut.set_exception(err)

    def _admit_pending(self) -> None:
        for group in self._admit_groups(self._drain_admissible()):
            try:
                self._admit_group(group)
            except Exception as e:  # pylint: disable=broad-except
                self._fail(e, group)

    def warmup(self) -> None:
        """Run one prefill (bucket 16) and one decode step through the
        serving path, then flip ``warm`` (``/health`` answers 200)."""
        req = Request([1] * 8, 2, 0.0, None, None, (), None,
                      time.perf_counter())
        self._admit_group([req])
        self._step()
        self._publish()
        self.timings.clear()
        self.step_count = 0
        self.warm = True

    def batch_loop(self) -> None:
        """Continuous scheduler: admit whenever a slot and pages are
        free, step while anything is active, publish after each. A
        failure outside the contained admit/step (warm-up included) is
        kept in ``loop_error`` and ``/health`` answers 500."""
        try:
            self._batch_loop()
        except Exception as e:  # pylint: disable=broad-except
            logger.error('engine batch loop died: %s\n%s', e,
                         traceback.format_exc())
            self.loop_error = e
            raise

    def _batch_loop(self) -> None:
        self.warmup()
        while not self._stop.is_set():
            if not any(s is not None for s in self.slots) and \
                    not self._hold:
                try:
                    self._hold.append(self._queue.get(timeout=0.05))
                except queue.Empty:
                    continue
            if any(s is None for s in self.slots) and (
                    self._hold or not self._queue.empty()):
                self._admit_pending()
            self._publish()
            if not any(self._row_active(s) for s in self.slots):
                continue
            try:
                self._step()
            except Exception as e:  # pylint: disable=broad-except
                self._fail(e, [])
                continue
            self._publish()

    def start(self) -> None:
        """Start the batch loop thread (warm-up first)."""
        if self._thread is not None:
            raise RuntimeError('engine already started')
        self._thread = threading.Thread(target=self.batch_loop,
                                        name='engine-batch-loop',
                                        daemon=True)
        self._thread.start()

    def stop(self, timeout: float = 30.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                raise RuntimeError('engine batch loop did not stop')


# ---------------------------------------------------------------------------
# HTTP layer
# ---------------------------------------------------------------------------

def _parse_sampling(body) -> Tuple[float, Optional[int], Optional[float]]:
    """(temperature, top_k, top_p) from an untrusted body; ValueError or
    TypeError on garbage. Penalties wait for a later slice: a non-zero
    one is refused rather than ignored."""
    temperature = float(body.get('temperature', 0.0))
    if not math.isfinite(temperature):
        raise ValueError(f'temperature {temperature} not finite')
    temperature = max(temperature, 0.0)
    top_k = body.get('top_k')
    top_k = max(int(top_k), 0) if top_k is not None else None
    top_p = body.get('top_p')
    top_p = float(top_p) if top_p is not None else None
    if top_p is not None and not 0.0 <= top_p <= 1.0:
        raise ValueError(f'top_p {top_p} outside [0, 1]')
    for field in ('presence_penalty', 'frequency_penalty'):
        if float(body.get(field) or 0.0) != 0.0:
            raise ValueError(f'{field} is not supported by this engine yet')
    return temperature, top_k, top_p


def build_app(engine: InferenceEngine, host: str = '127.0.0.1',
              port: int = 0) -> ThreadingHTTPServer:
    """A ThreadingHTTPServer bound to (host, port) serving ``/health``
    and ``/generate``; the caller runs ``serve_forever`` (in a thread)
    and ``shutdown``/``server_close`` when done."""

    class Handler(BaseHTTPRequestHandler):
        protocol_version = 'HTTP/1.1'

        def log_message(self, fmt, *args):  # quiet: no per-request lines
            del fmt, args

        def _json(self, status: int, doc: Dict[str, Any]) -> None:
            body = json.dumps(doc).encode()
            self.send_response(status)
            self.send_header('Content-Type', 'application/json')
            self.send_header('Content-Length', str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 (http.server naming)
            if self.path != '/health':
                return self._json(404, {'error': 'not found'})
            if engine.loop_error is not None:
                return self._json(500, {'status': 'failed',
                                        'error': str(engine.loop_error)})
            if not engine.warm:
                return self._json(503, {'status': 'warming'})
            return self._json(200, {
                'status': 'ok', 'queue_depth': engine.queue_depth(),
                'in_flight': engine.in_flight(),
                'kv_pages_free': engine.alloc.free_count})

        def do_POST(self):  # noqa: N802
            if self.path != '/generate':
                return self._json(404, {'error': 'not found'})
            try:
                n = int(self.headers.get('Content-Length', 0))
                body = json.loads(self.rfile.read(n) or b'{}')
                if not isinstance(body, dict):
                    raise ValueError('body must be a JSON object')
                if 'text' in body:
                    tokens = engine.tokenizer.encode(str(body['text']))
                else:
                    tokens = [int(t) for t in body.get('tokens', [])]
                max_new = int(body.get('max_new_tokens', 64))
                sampling = _parse_sampling(body)
                stop_ids = tuple(int(i)
                                 for i in body.get('stop_token_ids', ()))
            except (TypeError, ValueError) as e:
                return self._json(400, {'error': f'bad request: {e}'})
            if not tokens:
                return self._json(400, {'error': 'empty prompt'})
            if max_new < 1:
                return self._json(400, {'error': 'max_new_tokens < 1'})
            msg = engine.check_len(tokens, max_new)
            if msg:
                return self._json(400, {'error': msg})
            try:
                fut = engine.submit(tokens, max_new, *sampling,
                                    stop_ids=stop_ids)
            except EngineOverloaded as e:
                return self._json(429, {'error': str(e)})
            try:
                out, finish, lps = fut.result()
            except Exception as e:  # pylint: disable=broad-except
                return self._json(503, {'error': f'engine failure: {e}'})
            resp = {'tokens': out, 'finish_reason': finish, 'logprobs': lps}
            if 'text' in body:
                resp['text'] = engine.tokenizer.decode(out)
            return self._json(200, resp)

    server = ThreadingHTTPServer((host, port), Handler)
    server.daemon_threads = True
    return server


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog='skypilot_tpu_torch.serve.engine')
    parser.add_argument('--model', default='llama-1b',
                        help='Preset name (skypilot_tpu_torch.config).')
    parser.add_argument('--max-len', type=int, default=None)
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (default) or 'cpu'.")
    parser.add_argument('--seed', type=int, default=0,
                        help='Seed of the random weights and the sampler.')
    parser.add_argument('--port', type=int, default=8300)
    parser.add_argument('--host', default='0.0.0.0')
    return parser


def main() -> None:
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args()
    engine = InferenceEngine(args.model, max_len=args.max_len,
                             device=args.device, seed=args.seed)
    server = build_app(engine, args.host, args.port)
    engine.start()
    try:
        server.serve_forever()
    finally:
        server.server_close()
        engine.stop()


if __name__ == '__main__':
    main()
