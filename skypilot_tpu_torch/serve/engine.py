"""The inference engine and its HTTP surface (a reduced port of
skypilot_tpu/serve/engine.py: ``InferenceEngine`` with its fused k-step
decode, ``_InFlightStep``, ``_dispatch_step`` / ``_collect_step``,
``_choose_k`` / ``_lookahead_k``, ``_publish``, ``cancel``,
``batch_loop`` / ``_step_round``, ``warmup``; ``build_app``'s
``/health``, ``/generate``, ``/v1/completions`` with SSE and
``/v1/models``; ``main``).

What it keeps: ``MAX_BATCH`` slots over a block-paged K/V pool (page
size 64, ``MAX_BATCH * pages_for(max_len) + 1`` pages with page 0 the
trash page); admission that groups same-bucket prompts into one prefill
(kernel A on the card) and scatters it into freshly allocated pages;
then fused decode calls of k ∈ {1, ``MAX_STEP_CHUNK``} steps each, every
step a paged decode step (kernel B on the card) → per-row sampling
(greedy / temperature / top-k / top-p, OpenAI presence and frequency
penalties over the row's generated-token counts) → optional top-5
logprobs. On the card each of the eight variants (k × penalties × top
logprobs) is one CUDA graph, captured in warm-up; on the CPU the same
function runs eagerly. The batch loop pipelines: it dispatches call N+1
before it collects call N while nothing waits to join, no cancel is
pending and no row can finish inside the call in flight. Admission,
cancels and failure resets happen only at drained points; at most two
calls are in flight.

What waits (ROADMAP Queue 1 item 4): chat completions, ``n`` /
``best_of`` and batched prompts (each refused with 400 by name),
speculative decoding, the prefix cache, chunked prefill, metrics and
the flight recorder, the spill tier and int8 KV, disagg, meshes and
multi-host, and ``--hf-dir`` / ``--ckpt-dir``.

The HTTP server is the standard library's ThreadingHTTPServer; the
batch loop runs in its own thread and owns all device state. Request
handlers only enqueue and wait on a concurrent.futures.Future or, when
streaming, a per-request queue.

    SKYTPU_ENGINE_STEP_CHUNK=8 python -m skypilot_tpu_torch.serve.engine \\
        --model llama-1b --port 8300
"""
from __future__ import annotations

import argparse
import collections
import concurrent.futures
import dataclasses
import json
import logging
import math
import os
import queue
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from skypilot_tpu_torch.config import LlamaConfig, check_supported, get_config
from skypilot_tpu_torch.data.tokenizer import ByteTokenizer, StreamDecoder
from skypilot_tpu_torch.kernels import build
from skypilot_tpu_torch.models import decode, llama, paging

logger = logging.getLogger(__name__)

MAX_BATCH = 8
PAGE_SIZE = 64
MAX_QUEUE = 64
# Decode steps fused into one device call when no request waits to join
# (the JAX knob of the same name): the two step widths are 1 and this.
MAX_STEP_CHUNK = int(os.environ.get('SKYTPU_ENGINE_STEP_CHUNK', '8'))
# Top-N alternative logprobs computed per token (OpenAI ``logprobs=N``):
# only in the step variants some active row asked for, always at admit.
TOP_LOGPROBS_K = 5
# Rows of the per-call control block the host uploads: active, then the
# sampler's temperature, top_k, top_p, presence and frequency.
CTRL_ROWS = 6
# Calls in flight at most (one collected while the next one runs).
MAX_INFLIGHT = 2


class EngineOverloaded(Exception):
    """The bounded admission queue is full (answered with 429)."""


@dataclasses.dataclass
class Request:
    tokens: List[int]
    max_new: int
    temperature: float = 0.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    presence: float = 0.0
    frequency: float = 0.0
    stop_ids: Tuple[int, ...] = ()
    want_tops: bool = False
    future: Optional[concurrent.futures.Future] = None
    stream: Optional['queue.Queue'] = None
    t_submit: float = 0.0


@dataclasses.dataclass
class _Stage:
    """One in-flight call's pinned host buffers: the control block it
    uploads (rows CTRL_ROWS.. hold a ``fix_last`` upload made at its
    collect) and the step outputs it downloads."""
    ctrl: torch.Tensor      # [CTRL_ROWS + 2, B] fp32
    toks: torch.Tensor      # [K, B] int32
    lps: torch.Tensor       # [K, B] fp32
    tis: torch.Tensor       # [K, B, TOP_LOGPROBS_K] int32
    tvs: torch.Tensor       # [K, B, TOP_LOGPROBS_K] fp32


class _InFlightStep:
    """Host handle for a dispatched-but-uncollected fused call: host
    views of its outputs (valid once ``event`` has completed; the CPU
    has no event and copies synchronously) and the static facts the
    collect half needs. ``tis``/``tvs`` are None in the want_tops=False
    variants: the [k, B, K] top-k tensors were never computed, let
    alone transferred."""

    __slots__ = ('k', 'want_tops', 'toks', 'lps', 'tis', 'tvs', 'event',
                 'stage')

    def __init__(self, k: int, want_tops: bool, stage: _Stage, event):
        self.k = k
        self.want_tops = want_tops
        self.stage = stage
        self.event = event
        self.toks = stage.toks[:k]
        self.lps = stage.lps[:k]
        self.tis = stage.tis[:k] if want_tops else None
        self.tvs = stage.tvs[:k] if want_tops else None


def _tops_list(ti, tv) -> list:
    """Top-K rows ([K] ids, [K] logprobs) → [(token_id, logprob), ...]."""
    return [(int(i), float(v)) for i, v in zip(ti, tv)]


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
        self.step_chunk = MAX_STEP_CHUNK
        if self.step_chunk < 1:
            raise ValueError(f'SKYTPU_ENGINE_STEP_CHUNK must be >= 1, got '
                             f'{self.step_chunk}')
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
        self._pending_cancels: collections.deque = collections.deque()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.warm = False
        self.loop_error: Optional[BaseException] = None
        self.step_count = 0
        # Fused calls dispatched, by variant (k, use_pen, want_tops).
        self.calls: collections.Counter = collections.Counter()
        # Finished requests' (ttft_s, tpot_s, n_tokens), newest last.
        self.timings: collections.deque = collections.deque(maxlen=4096)
        self._inflight: List[_InFlightStep] = []
        self._alloc_device_state()
        self._reset_host_state()

    # -- device state ------------------------------------------------------
    def _alloc_device_state(self) -> None:
        """Allocate every tensor a captured step reads or writes, once:
        CUDA graphs hold their addresses for the engine's lifetime, so a
        reset writes into these same tensors (:meth:`_reset_device_state`)."""
        psz, b, dev = self.page_size, self.max_batch, self.device
        self._max_pages = paging.pages_for(self.max_len, psz)
        self.n_pages = b * self._max_pages + 1
        self.cache = decode.init_page_pool(
            self.cfg, self.n_pages, psz, b, self._max_pages, device=dev)
        # Per-slot previous token, device-resident: the fused calls carry
        # it, so a lookahead call is dispatched with no host sync;
        # self.last is its host mirror, kept at admit and collect.
        self.last_dev = torch.zeros(b, dtype=torch.int32, device=dev)
        # Generated-token counts per slot (the penalties' state).
        self.counts = torch.zeros((b, self.cfg.vocab_size), dtype=torch.int32,
                                  device=dev)
        self._ctrl = torch.zeros((CTRL_ROWS, b), dtype=torch.float32,
                                 device=dev)
        self._fix = torch.zeros((2, b), dtype=torch.float32, device=dev)
        kmax, ntop = self.step_chunk, TOP_LOGPROBS_K
        self._out_toks = torch.zeros((kmax, b), dtype=torch.int32, device=dev)
        self._out_lps = torch.zeros((kmax, b), dtype=torch.float32,
                                    device=dev)
        self._out_tis = torch.zeros((kmax, b, ntop), dtype=torch.int32,
                                    device=dev)
        self._out_tvs = torch.zeros((kmax, b, ntop), dtype=torch.float32,
                                    device=dev)
        pin = dev.type == 'cuda'

        def host(shape, dtype):
            return torch.zeros(shape, dtype=dtype, pin_memory=pin)

        # One stage per call in flight: a stage's buffers are rewritten
        # only after its call was collected.
        self._stages = [_Stage(host((CTRL_ROWS + 2, b), torch.float32),
                               host((kmax, b), torch.int32),
                               host((kmax, b), torch.float32),
                               host((kmax, b, ntop), torch.int32),
                               host((kmax, b, ntop), torch.float32))
                        for _ in range(MAX_INFLIGHT)]
        self._n_dispatch = 0
        # Admission samples eagerly from one generator; the fused steps
        # draw from another, registered with every graph that draws.
        self.generator = torch.Generator(device=dev).manual_seed(self.seed)
        self._step_gen = torch.Generator(device=dev).manual_seed(
            self.seed + 1)
        # The captured variants (card only), their captured kernel
        # launches, one capture stream and one memory pool for all.
        self.graphs: Dict[Tuple[int, bool, bool], Any] = {}
        self._graph_launches: Dict[Tuple[int, bool, bool],
                                   Dict[str, int]] = {}
        self._graph_stream = None
        self._graph_pool = None

    def _reset_host_state(self) -> None:
        """The allocator, slots and every host mirror, as new."""
        self.alloc = paging.PageAllocator(self.n_pages)
        self._table_np = np.zeros((self.max_batch, self._max_pages),
                                  np.int32)
        self._table_dirty = True
        self.slots: List[Optional[Dict[str, Any]]] = [None] * self.max_batch
        self.last = np.zeros(self.max_batch, np.int32)
        self.temp = np.zeros(self.max_batch, np.float32)
        self.topk = np.zeros(self.max_batch, np.int32)
        self.topp = np.zeros(self.max_batch, np.float32)
        self.pres = np.zeros(self.max_batch, np.float32)
        self.freq = np.zeros(self.max_batch, np.float32)
        self._samp_dirty = True
        self._inflight = []

    def _reset_device_state(self) -> None:
        """After a failed admit/step: wait out whatever the card still
        runs (an uncollected call may be copying into a stage), then
        zero the pool, table, lengths, ``last`` and counts IN PLACE (the
        graphs keep their addresses) and reset the host state."""
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        for t in (self.cache.k, self.cache.v, self.cache.table,
                  self.cache.length, self.last_dev, self.counts):
            t.zero_()
        self._reset_host_state()

    def _refresh_table(self) -> None:
        """Push the host page-table mirror to the device if dirty. Only
        at drained points: a call in flight may be reading the table."""
        if self._table_dirty:
            assert not self._inflight, 'table refresh with a call in flight'
            self.cache.table.copy_(torch.from_numpy(self._table_np))
            self._table_dirty = False

    def _pages_needed(self, req: Request) -> int:
        """Pages a request reserves: bucketed prompt + max_new, capped at
        the table's coverage. A lookahead call never writes past them."""
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

    def calls_by_width(self) -> Dict[int, int]:
        """Fused device calls dispatched so far, by step width."""
        out: Dict[int, int] = collections.Counter()
        for (k, _, _), n in list(self.calls.items()):
            out[k] += n
        return dict(out)

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
               top_p: Optional[float] = None, presence: float = 0.0,
               frequency: float = 0.0, stop_ids: Tuple[int, ...] = (),
               want_tops: bool = False,
               stream: Optional['queue.Queue'] = None
               ) -> concurrent.futures.Future:
        """Enqueue a request; the future resolves to (tokens,
        finish_reason, chosen-token logprobs, per-token top-5 lists —
        empty lists unless ``want_tops``; the first token's are always
        there). ``stream`` (a queue.Queue) receives (token, logprob,
        tops) per token and None at the end. Raises EngineOverloaded
        when the bounded queue is full."""
        fut: concurrent.futures.Future = concurrent.futures.Future()
        req = Request(list(tokens), int(max_new), float(temperature), top_k,
                      top_p, float(presence), float(frequency),
                      tuple(stop_ids), bool(want_tops), fut, stream,
                      time.perf_counter())
        try:
            self._queue.put_nowait(req)
        except queue.Full:
            raise EngineOverloaded(
                f'admission queue full ({MAX_QUEUE} waiting)') from None
        return fut

    def cancel(self, fut: concurrent.futures.Future) -> None:
        """Abort the admitted request owning ``fut`` (a stream whose
        client went away, or a stop string matched mid-stream).
        Deferred: the batch loop applies it at its next drained point,
        never racing a call in flight. A request still queued is
        skipped at admission once ``fut.cancel()`` succeeded."""
        self._pending_cancels.append(fut)

    def _process_cancels(self) -> None:
        """Apply deferred cancels (drained points only). Marks only: the
        slot frees at the next publish."""
        while self._pending_cancels:
            fut = self._pending_cancels.popleft()
            for s in self.slots:
                if s is not None and s['req'].future is fut:
                    if s['finish'] is None:
                        s['finish'] = 'stop'
                    break

    # -- admission -------------------------------------------------------------
    def _drain_admissible(self) -> List[Request]:
        """Pop requests bounded by free slots and free pages, FIFO: once
        one is held, nothing younger passes it. A cancelled request is
        dropped here."""
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

        def live(req: Request) -> bool:
            return (req.future is None or
                    req.future.set_running_or_notify_cancel())

        held, self._hold = self._hold, []
        for req in held:
            if len(items) < free_slots and fits(req):
                if live(req):
                    items.append(req)
            else:
                self._hold.append(req)
        while (not self._hold and len(items) < free_slots and
               not self._queue.empty()):
            req = self._queue.get_nowait()
            if fits(req):
                if live(req):
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
        """Prefill same-bucket prompts in ONE call (eager: kernel A on
        the card), scatter their K/V into freshly allocated pages, sample
        each first token and seed the slot's device ``last`` and penalty
        counts (zeroed, the first token counted). Drained points only."""
        assert not self._inflight, 'admission with a call in flight'
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
            self.pres[slot] = req.presence
            self.freq[slot] = req.frequency
            self._reserve_slot_pages(
                slot, self.alloc.alloc(self._pages_needed(req)))
        self._samp_dirty = True
        self._refresh_table()
        dev = self.device
        slots_t = torch.tensor(slots, dtype=torch.int64, device=dev)
        lengths_t = torch.tensor(lengths, dtype=torch.int32, device=dev)
        with torch.no_grad():
            logits, ks, vs = decode.prefill(
                self.params,
                torch.tensor(padded, dtype=torch.int32, device=dev),
                self.cfg, self.max_len, lengths=lengths_t)
            paging.scatter_prefill(self.cache, ks, vs, slots_t, bucket,
                                   lengths_t)
            first = decode.select_token_per_row(
                logits, torch.from_numpy(self.temp[slots]).to(dev),
                torch.from_numpy(self.topk[slots]).to(dev),
                torch.from_numpy(self.topp[slots]).to(dev), self.generator)
            first_lp = decode.chosen_logprob(logits, first)
            tvs, tis = decode.top_k_logprobs(logits, TOP_LOGPROBS_K)
            self.last_dev[slots_t] = first
            self.counts[slots_t] = 0
            self.counts[slots_t, first.long()] += 1
        first, first_lp = first.cpu().numpy(), first_lp.cpu().numpy()
        tis, tvs = tis.cpu().numpy(), tvs.cpu().numpy()
        now = time.perf_counter()
        for i, req in enumerate(items):
            self._finish_admit(req, slots[i], int(first[i]),
                               float(first_lp[i]),
                               _tops_list(tis[i], tvs[i]), now)

    def _finish_admit(self, req: Request, slot: int, first: int,
                      first_lp: float, tops: list, now: float) -> None:
        self.last[slot] = first
        entry = {'req': req, 'out': [], 'lps': [], 'tops': [],
                 'finish': None, 'stop': frozenset(req.stop_ids),
                 't_first': now, 'sent': 0}
        if first in entry['stop']:
            entry['finish'] = 'stop'
        else:
            entry['out'].append(first)
            entry['lps'].append(first_lp)
            entry['tops'].append(tops)
            if len(entry['out']) >= req.max_new:
                entry['finish'] = 'length'
        self.slots[slot] = entry

    # -- the fused k-step program ----------------------------------------------
    def _step_body(self, k: int, use_pen: bool, want_tops: bool) -> None:
        """k × (paged decode step → sample → count → optional top-5),
        carrying ``last``, the pool, the counts and the generator — the
        JAX ``step_k`` (fused_paged branch). Reads the control block
        ``_ctrl`` and writes ``_out_*`` rows [0, k): every tensor it
        touches outside its own temporaries lives at a fixed address,
        and nothing syncs the host, so on the card it is captured once
        per variant and replayed. Inactive rows write the trash page,
        keep their ``last`` and count nothing."""
        ctrl = self._ctrl
        active = ctrl[0] > 0
        temp, topk, topp = ctrl[1], ctrl[2].to(torch.int32), ctrl[3]
        pres, freq = ctrl[4], ctrl[5]
        last = self.last_dev
        with torch.no_grad():
            for t in range(k):
                logits, _ = decode.paged_decode_step(
                    self.params, last, self.cache, self.cfg,
                    max_len=self.max_len, active=active)
                nxt = decode.select_token_per_row(
                    logits, temp, topk, topp, self._step_gen,
                    counts=self.counts if use_pen else None,
                    presence=pres if use_pen else None,
                    frequency=freq if use_pen else None)
                nxt = torch.where(active, nxt, last)
                self._out_toks[t].copy_(nxt)
                # Logprobs report the unpenalized model distribution.
                self._out_lps[t].copy_(decode.chosen_logprob(logits, nxt))
                if use_pen:
                    self.counts.scatter_add_(
                        1, nxt.long()[:, None], active.to(torch.int32)[:, None])
                if want_tops:
                    tv, ti = decode.top_k_logprobs(logits, TOP_LOGPROBS_K)
                    self._out_tvs[t].copy_(tv)
                    self._out_tis[t].copy_(ti)
                last = nxt
            self.last_dev.copy_(last)

    def _variant(self, k: int, use_pen: bool,
                 want_tops: bool) -> Callable[[], None]:
        """The callable that runs one fused call of this variant: on the
        CPU the step body itself; on the card the replay of its CUDA
        graph, captured here the first time (warm-up drives every
        variant, so after it nothing is captured and nothing runs
        eagerly)."""
        key = (k, use_pen, want_tops)
        if self.device.type != 'cuda':
            return lambda: self._step_body(k, use_pen, want_tops)
        if key not in self.graphs:
            if self.warm:
                raise RuntimeError(f'step variant {key} was not captured in '
                                   f'warm-up')
            self._capture(key)
        graph, launched = self.graphs[key], self._graph_launches[key]
        kernels = build.kernels()

        def replay() -> None:
            graph.replay()
            for name, n in launched.items():
                kernels[name].replayed(n)
        return replay

    def _capture(self, key: Tuple[int, bool, bool]) -> None:
        """Capture one variant into a CUDA graph on the engine's capture
        stream, into the pool all variants share (they never run at
        once). Its first run is eager on that same stream, with every
        row inactive, so lazily built state (kernel B's per-stream
        workspace, library handles) exists before the capture. A failed
        capture raises: warm-up fails and ``/health`` answers 500."""
        if self._graph_stream is None:
            self._graph_stream = torch.cuda.Stream(self.device)
            self._graph_pool = torch.cuda.graph_pool_handle()
        stream = self._graph_stream
        self._ctrl.zero_()               # every row inactive, greedy
        self._samp_dirty = True          # the next dispatch re-uploads
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            self._step_body(*key)
        stream.synchronize()
        before = build.captured()
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self._step_gen)
        with torch.cuda.graph(graph, pool=self._graph_pool, stream=stream,
                              capture_error_mode='thread_local'):
            self._step_body(*key)
        after = build.captured()
        self._graph_launches[key] = {n: after[n] - before[n] for n in after
                                     if after[n] > before[n]}
        self.graphs[key] = graph

    # -- dispatch / collect ----------------------------------------------------
    @staticmethod
    def _row_active(s: Optional[Dict[str, Any]]) -> bool:
        return s is not None and s['finish'] is None

    def _remaining(self, inflight_k: int = 0) -> List[int]:
        """Per-active-row token budget before a length finish; an
        uncollected call's tokens count as spent (the lookahead view)."""
        return [s['req'].max_new - len(s['out']) - inflight_k
                for s in self.slots if self._row_active(s)]

    def _choose_k(self, inflight_k: int = 0) -> int:
        """Step width for the next fused call: MAX_STEP_CHUNK while every
        active row has that many tokens left and nothing waits to be
        admitted, else 1. Only the two widths exist, so a client's
        max_new cannot ask for a variant warm-up did not capture."""
        if self._hold:
            return 1
        remaining = self._remaining(inflight_k)
        if (remaining and min(remaining) >= self.step_chunk and
                self._queue.empty()):
            return self.step_chunk
        return 1

    def _lookahead_k(self, inflight_k: int) -> Optional[int]:
        """Width for a lookahead dispatch (call N+1 before call N is
        collected), or None when the pipeline must drain first: a
        request waits to be admitted, a cancel is pending, or some
        active row may finish inside the call in flight."""
        if self._pending_cancels or self._hold or not self._queue.empty():
            return None
        remaining = self._remaining(inflight_k)
        if not remaining or min(remaining) < 1:
            return None
        return self._choose_k(inflight_k)

    def _dispatch_step(self, k: int,
                       want_tops_force: Optional[bool] = None
                       ) -> _InFlightStep:
        """Dispatch half of a fused call: pick the variant from host
        state, upload ``active`` (and the sampler arrays when dirty)
        from this call's pinned stage, run the variant, enqueue the
        outputs' copies into the stage and record an event. Never syncs
        the host. Rows already finished are masked out of ``active``."""
        if len(self._inflight) >= MAX_INFLIGHT:
            raise RuntimeError('dispatch with the pipeline full')
        use_pen = bool(self.pres.any() or self.freq.any())
        want_tops = (bool(want_tops_force) if want_tops_force is not None
                     else any(self._row_active(s) and s['req'].want_tops
                              for s in self.slots))
        run = self._variant(k, use_pen, want_tops)
        stage = self._stages[self._n_dispatch % MAX_INFLIGHT]
        self._n_dispatch += 1
        ctrl = stage.ctrl.numpy()
        ctrl[0] = [self._row_active(s) for s in self.slots]
        rows = 1
        if self._samp_dirty:
            ctrl[1:CTRL_ROWS] = (self.temp, self.topk, self.topp, self.pres,
                                 self.freq)
            rows = CTRL_ROWS
            self._samp_dirty = False
        self._ctrl[:rows].copy_(stage.ctrl[:rows], non_blocking=True)
        run()
        self.calls[(k, use_pen, want_tops)] += 1
        stage.toks[:k].copy_(self._out_toks[:k], non_blocking=True)
        stage.lps[:k].copy_(self._out_lps[:k], non_blocking=True)
        if want_tops:
            stage.tis[:k].copy_(self._out_tis[:k], non_blocking=True)
            stage.tvs[:k].copy_(self._out_tvs[:k], non_blocking=True)
        event = None
        if self.device.type == 'cuda':
            event = torch.cuda.Event()
            event.record()
        handle = _InFlightStep(k, want_tops, stage, event)
        self._inflight.append(handle)
        return handle

    def _collect_step(self) -> None:
        """Collect half: wait on the OLDEST call's event (never a
        blocking tensor read) and do the bookkeeping. Rows that finish
        mid-chunk leave the device ``last`` at the chunk's final token:
        ``_fix_last`` re-pins it to the host mirror."""
        assert self._inflight, 'collect with no step in flight'
        h = self._inflight.pop(0)
        if h.event is not None:
            h.event.synchronize()
        toks, lps = h.toks.numpy().copy(), h.lps.numpy().copy()
        if h.want_tops:
            tis, tvs = h.tis.numpy().copy(), h.tvs.numpy().copy()
        self.step_count += h.k
        fixups = []
        for i, s in enumerate(self.slots):
            if not self._row_active(s):
                # Finished rows were masked at dispatch, or this call
                # was dispatched before the finish was known: their
                # outputs are not consumed.
                continue
            for t in range(h.k):
                tok = int(toks[t, i])
                self.last[i] = tok
                if tok in s['stop']:
                    s['finish'] = 'stop'
                    break
                s['out'].append(tok)
                s['lps'].append(float(lps[t, i]))
                s['tops'].append(_tops_list(tis[t, i], tvs[t, i])
                                 if h.want_tops else [])
                if len(s['out']) >= s['req'].max_new:
                    s['finish'] = 'length'
                    break
            if s['finish'] is not None:
                fixups.append(i)
        if fixups:
            self._fix_last(h.stage, fixups)

    def _fix_last(self, stage: _Stage, rows: List[int]) -> None:
        """Re-sync the device ``last`` with the host mirror on ``rows``
        (the JAX ``fix_last``), through the collected call's stage: its
        rows CTRL_ROWS.. are rewritten only at its next collect, after
        this copy ran."""
        fix = stage.ctrl.numpy()[CTRL_ROWS:]
        fix[0] = 0
        fix[0, rows] = 1
        fix[1] = self.last
        self._fix.copy_(stage.ctrl[CTRL_ROWS:], non_blocking=True)
        self.last_dev.copy_(torch.where(self._fix[0] > 0,
                                        self._fix[1].to(torch.int32),
                                        self.last_dev))

    def _step_once(self, k_force: Optional[int] = None,
                   want_tops_force: Optional[bool] = None) -> None:
        """Synchronous dispatch + collect (warm-up and tests; the batch
        loop pipelines through ``_step_round``)."""
        k = k_force if k_force is not None else self._choose_k()
        self._dispatch_step(k, want_tops_force=want_tops_force)
        self._collect_step()

    def _publish(self) -> None:
        """Push new tokens to streaming consumers, resolve finished
        slots and return their pages at once; clear the row's sampler
        and penalty params (the penalized variants key off any nonzero
        penalty)."""
        now = time.perf_counter()
        for i, s in enumerate(self.slots):
            if s is None:
                continue
            req = s['req']
            q = req.stream
            if q is not None and s['sent'] < len(s['out']):
                for j in range(s['sent'], len(s['out'])):
                    q.put((s['out'][j], s['lps'][j], s['tops'][j]))
                s['sent'] = len(s['out'])
            if s['finish'] is None:
                continue
            n = len(s['out'])
            self.timings.append((
                s['t_first'] - req.t_submit,
                (now - s['t_first']) / (n - 1) if n > 1 else 0.0, n))
            if req.future is not None and not req.future.done():
                req.future.set_result((s['out'], s['finish'], s['lps'],
                                       s['tops']))
            if q is not None:
                q.put(None)                  # end-of-stream sentinel
            self.slots[i] = None
            self._release_slot_pages(i)
            self.temp[i] = self.topk[i] = self.topp[i] = 0
            self.pres[i] = self.freq[i] = 0
            self._samp_dirty = True

    def _fail(self, err: Exception, extra: List[Request]) -> None:
        """Contain an admit/step failure: fail every request on the
        device and the group being admitted, drop the calls in flight,
        then reset device state. Requests still queued or held are
        untouched."""
        logger.error('engine step/admit failed; resetting: %s\n%s', err,
                     traceback.format_exc())
        reqs = [s['req'] for s in self.slots if s is not None] + list(extra)
        self._reset_device_state()
        for req in reqs:
            if req.future is not None and not req.future.done():
                req.future.set_exception(err)
            if req.stream is not None:
                req.stream.put(None)

    def _admit_pending(self) -> None:
        for group in self._admit_groups(self._drain_admissible()):
            try:
                self._admit_group(group)
            except Exception as e:  # pylint: disable=broad-except
                self._fail(e, group)

    def warmup(self) -> None:
        """Run the whole variant matrix — k ∈ {1, MAX_STEP_CHUNK} ×
        penalties × top logprobs, the only calls ``_dispatch_step`` can
        make — through the real dispatch/collect path on one admitted
        request, capturing each variant on the card; then free the slot,
        reset the counters and flip ``warm`` (``/health`` answers 200).
        A capture that fails raises."""
        ks = sorted({self.step_chunk, 1}, reverse=True)
        steps = 4 * sum(ks)
        max_new = min(steps + 8, self.max_len - decode.bucket_size(8))
        self._admit_group([Request(list(range(1, 9)), max_new)])
        for want_tops in (False, True):
            for use_pen in (False, True):
                self.pres[:] = 1.0 if use_pen else 0.0
                self._samp_dirty = True
                for k in ks:
                    self._step_once(k_force=k, want_tops_force=want_tops)
        self.pres[:] = 0.0
        for i, s in enumerate(self.slots):
            if s is not None:
                s['finish'] = s['finish'] or 'length'
        self._publish()
        self.cache.length.zero_()
        self.last_dev.zero_()
        self.counts.zero_()
        self.last[:] = 0
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        self.timings.clear()
        self.calls.clear()
        self.step_count = 0
        self.warm = True

    def _step_round(self) -> None:
        """One scheduling round of device work, pipelined: dispatch call
        N, then — while ``_lookahead_k`` allows — dispatch call N+1
        BEFORE collecting call N, publishing after every collect."""
        inflight = self._dispatch_step(self._choose_k())
        while True:
            k2 = self._lookahead_k(inflight.k)
            if k2 is None:
                break
            nxt = self._dispatch_step(k2)
            self._collect_step()
            self._publish()
            inflight = nxt
        self._collect_step()

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
        if not self.warm:
            self.warmup()
        while not self._stop.is_set():
            # Drained point: no call in flight.
            self._process_cancels()
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
                self._step_round()
            except Exception as e:  # pylint: disable=broad-except
                self._fail(e, [])
                continue
            self._publish()

    def start(self) -> None:
        """Start the batch loop thread (warm-up first, unless done)."""
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

def _parse_sampling(body, default_temperature: float = 0.0
                    ) -> Tuple[float, Optional[int], Optional[float], float,
                               float]:
    """(temperature, top_k, top_p, presence_penalty, frequency_penalty)
    from an untrusted body; ValueError or TypeError on garbage (NaN,
    out of range; penalties in [-2, 2])."""
    temperature = float(body.get('temperature', default_temperature))
    if not math.isfinite(temperature):
        raise ValueError(f'temperature {temperature} not finite')
    temperature = max(temperature, 0.0)
    top_k = body.get('top_k')
    top_k = max(int(top_k), 0) if top_k is not None else None
    top_p = body.get('top_p')
    top_p = float(top_p) if top_p is not None else None
    if top_p is not None and not 0.0 <= top_p <= 1.0:
        raise ValueError(f'top_p {top_p} outside [0, 1]')
    penalties = []
    for field in ('presence_penalty', 'frequency_penalty'):
        val = float(body.get(field) or 0.0)
        if not math.isfinite(val) or not -2.0 <= val <= 2.0:
            raise ValueError(f'{field} {val} outside [-2, 2]')
        penalties.append(val)
    return (temperature, top_k, top_p, *penalties)


def _parse_logprobs(body) -> Tuple[bool, int]:
    """Completions ``logprobs: N`` (0..TOP_LOGPROBS_K) → (want_logprobs,
    top_n): chosen-token logprobs plus N alternatives per position;
    boolean true means N = 0."""
    lp = body.get('logprobs')
    if lp is None or lp is False:
        return False, 0
    top_n = 0 if lp is True else int(lp)
    if top_n < 0:
        raise ValueError('logprobs must be >= 0')
    if top_n > TOP_LOGPROBS_K:
        raise ValueError(f'top logprobs > {TOP_LOGPROBS_K} is not '
                         f'supported (the engine computes a fixed top-'
                         f'{TOP_LOGPROBS_K} per token)')
    return True, top_n


def _parse_stop_ids(body, tokenizer) -> Tuple[int, ...]:
    """Stop-token ids for a /v1 request: the tokenizer's EOS set plus any
    client-supplied stop_token_ids; ignore_eos=true disables all."""
    if body.get('ignore_eos'):
        return ()
    ids = list(tokenizer.eos_ids)
    extra = body.get('stop_token_ids')
    if extra is not None:
        if (not isinstance(extra, list) or
                not all(isinstance(i, int) for i in extra)):
            raise ValueError('stop_token_ids must be a list of ints')
        ids.extend(int(i) for i in extra)
    return tuple(ids)


def _stop_list(stop) -> List[str]:
    """OpenAI ``stop``: None, a string or a list of non-empty strings."""
    if stop is None:
        return []
    stops = [stop] if isinstance(stop, str) else list(stop)
    for s in stops:
        if not isinstance(s, str) or not s:
            raise ValueError('stop must be a string or list of strings')
    return stops


def _stop_scan(text: str, stops: List[str]) -> Optional[int]:
    """Earliest stop-string match index in ``text``, or None: the one
    scan the stream (holdback) and non-stream paths share."""
    cut = None
    for s in stops:
        i = text.find(s)
        if i >= 0 and (cut is None or i < cut):
            cut = i
    return cut


def _truncate_at_stop_strings(text: str, stop) -> Tuple[str, bool]:
    """OpenAI ``stop`` strings: cut at the earliest occurrence."""
    cut = _stop_scan(text, _stop_list(stop))
    if cut is None:
        return text, False
    return text[:cut], True


def _completion_logprobs(tokenizer, out, lps, text, tops=None):
    """OpenAI completions logprobs object aligned with the returned
    text: parallel tokens / token_logprobs / text_offset arrays, trimmed
    where a stop string cut the text. Pieces come from incremental
    detokenization (StreamDecoder), so a multi-byte char split across
    tokens does not drift the offsets. ``tops`` (per-token [(token_id,
    logprob), ...]) fills top_logprobs."""
    dec = StreamDecoder(tokenizer)
    all_pieces = [dec.feed([t]) for t in out]
    if all_pieces:
        all_pieces[-1] += dec.flush()
    pieces, offsets, kept, top_out = [], [], [], []
    pos = 0
    for i, v in enumerate(lps):
        if pos >= len(text):
            break    # text fully covered (or cut to nothing)
        piece = all_pieces[i]
        pieces.append(piece)
        offsets.append(pos)
        kept.append(round(v, 6))
        if tops is not None:
            top_out.append({tokenizer.decode([tid]): round(tv, 6)
                            for tid, tv in tops[i]})
        pos += len(piece)
    return {'tokens': pieces, 'token_logprobs': kept,
            'top_logprobs': top_out if tops is not None else None,
            'text_offset': offsets}


def _resolve_prompt(engine: InferenceEngine, prompt) -> List[int]:
    """OpenAI ``prompt`` → one token-id list: a string or a token-id
    list. A list of prompts waits for a later slice."""
    if isinstance(prompt, list):
        if prompt and all(isinstance(t, int) for t in prompt):
            return [int(t) for t in prompt]
        if prompt:
            raise ValueError('batched prompts are not supported by this '
                             'engine yet')
        return []
    return engine.tokenizer.encode(str(prompt))


def _refuse_fanout(body) -> None:
    """``n`` > 1 and ``best_of`` > 1 wait for a later slice."""
    for field in ('n', 'best_of'):
        val = body.get(field)
        if val is not None and int(val) != 1:
            raise ValueError(f'{field} > 1 is not supported by this engine '
                             f'yet')


class _SseState:
    """One streamed choice: incremental detokenization, the stop-string
    holdback buffer (pieces paired with their token's logprob info) and
    the text offset."""

    def __init__(self, tokenizer):
        self.decoder = StreamDecoder(tokenizer)
        self.pend: List[list] = []    # [piece_text, lp, tops]
        self.pend_chars = 0
        self.emitted = 0              # chars sent (text_offset)
        self.stopped = False


def build_app(engine: InferenceEngine, host: str = '127.0.0.1',
              port: int = 0) -> ThreadingHTTPServer:
    """A ThreadingHTTPServer bound to (host, port) serving ``/health``,
    ``/generate``, ``/v1/completions`` (JSON or SSE) and ``/v1/models``;
    the caller runs ``serve_forever`` (in a thread) and
    ``shutdown``/``server_close`` when done."""

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

        def _openai_error(self, msg: str, status: int = 400,
                          err_type: str = 'invalid_request_error') -> None:
            self._json(status, {'error': {'message': msg, 'type': err_type}})

        def _body(self) -> Dict[str, Any]:
            n = int(self.headers.get('Content-Length', 0))
            body = json.loads(self.rfile.read(n) or b'{}')
            if not isinstance(body, dict):
                raise ValueError('body must be a JSON object')
            return body

        def do_GET(self):  # noqa: N802 (http.server naming)
            if self.path == '/v1/models':
                return self._json(200, {'object': 'list', 'data': [
                    {'id': engine.model_name, 'object': 'model',
                     'owned_by': 'skytpu'}]})
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
            if self.path == '/generate':
                return self._generate()
            if self.path == '/v1/completions':
                return self._completions()
            if self.path == '/v1/chat/completions':
                self._drain()
                return self._openai_error('chat completions are not '
                                          'supported by this engine yet')
            return self._json(404, {'error': 'not found'})

        def _drain(self) -> None:
            self.rfile.read(int(self.headers.get('Content-Length', 0)))

        def _generate(self) -> None:
            try:
                body = self._body()
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
                out, finish, lps, _ = fut.result()
            except Exception as e:  # pylint: disable=broad-except
                return self._json(503, {'error': f'engine failure: {e}'})
            resp = {'tokens': out, 'finish_reason': finish, 'logprobs': lps}
            if 'text' in body:
                resp['text'] = engine.tokenizer.decode(out)
            return self._json(200, resp)

        def _completions(self) -> None:
            """OpenAI completions for one prompt (text or token ids):
            max_tokens, temperature (default 1.0), top_k, top_p, both
            penalties, logprobs = N <= 5, stop, stop_token_ids,
            ignore_eos and stream (SSE)."""
            try:
                body = self._body()
                tokens = _resolve_prompt(engine, body.get('prompt', ''))
                if not tokens:
                    raise ValueError('empty prompt')
                _refuse_fanout(body)
                max_new = int(body.get('max_tokens', 16))
                if max_new < 1:
                    raise ValueError('max_tokens must be >= 1')
                sampling = _parse_sampling(body, default_temperature=1.0)
                stop_ids = _parse_stop_ids(body, engine.tokenizer)
                stops = _stop_list(body.get('stop'))
                want_logprobs, top_n = _parse_logprobs(body)
            except (TypeError, ValueError) as e:
                return self._openai_error(f'invalid request: {e}')
            msg = engine.check_len(tokens, max_new)
            if msg:
                return self._openai_error(msg)
            meta = {'id': f'cmpl-{time.time_ns()}',
                    'object': 'text_completion', 'created': int(time.time()),
                    'model': body.get('model', engine.model_name)}
            stream = queue.Queue() if body.get('stream') else None
            try:
                fut = engine.submit(tokens, max_new, *sampling,
                                    stop_ids=stop_ids,
                                    want_tops=want_logprobs and top_n > 0,
                                    stream=stream)
            except EngineOverloaded as e:
                return self._openai_error(str(e), status=429,
                                          err_type='overloaded_error')
            if stream is not None:
                return self._sse(fut, stream, meta, stops, want_logprobs,
                                 top_n)
            try:
                out, finish, lps, tops = fut.result()
            except Exception as e:  # pylint: disable=broad-except
                return self._openai_error(f'engine failure: {e}', 503,
                                          'server_error')
            text = engine.tokenizer.decode(out)
            cut = _stop_scan(text, stops)
            if cut is not None:
                text, finish = text[:cut], 'stop'
            lp_obj = None
            if want_logprobs:
                lp_obj = _completion_logprobs(
                    engine.tokenizer, out, lps, text,
                    tops=[t[:top_n] for t in tops] if top_n else None)
            return self._json(200, {**meta, 'choices': [
                {'text': text, 'index': 0, 'logprobs': lp_obj,
                 'finish_reason': finish}],
                'usage': {'prompt_tokens': len(tokens),
                          'completion_tokens': len(out),
                          'total_tokens': len(tokens) + len(out)}})

        # -- SSE ------------------------------------------------------------
        def _chunk(self, data: bytes) -> None:
            self.wfile.write(b'%x\r\n%s\r\n' % (len(data), data))

        def _event(self, payload) -> None:
            self._chunk(b'data: ' + json.dumps(payload).encode() + b'\n\n')

        def _sse(self, fut, stream: 'queue.Queue', meta, stops: List[str],
                 want_logprobs: bool, top_n: int) -> None:
            """Stream one choice as server-sent events over chunked
            transfer: one ``data: {json}`` event per token (with its
            logprob info when asked), a final event with the
            finish_reason, then ``data: [DONE]``. Stop strings are held
            back by len(longest) - 1 characters so a match split across
            tokens never leaks; on a match the request is cancelled. A
            failed write (the client went away) cancels it too."""
            hold = max((len(s) for s in stops), default=0) - 1
            st = _SseState(engine.tokenizer)
            self.close_connection = True

            def send(text, lp=None, finish=None) -> None:
                lp_obj = None
                if lp is not None:
                    piece, lpv, tops, off = lp
                    lp_obj = {
                        'tokens': [piece], 'token_logprobs': [round(lpv, 6)],
                        'top_logprobs': [
                            {engine.tokenizer.decode([i]): round(v, 6)
                             for i, v in tops}] if top_n else None,
                        'text_offset': [off]}
                self._event({**meta, 'choices': [
                    {'text': text, 'index': 0, 'logprobs': lp_obj,
                     'finish_reason': finish}]})

            def emit_piece(piece: str, lp, tops) -> None:
                lp_info = ((piece, lp, tops[:top_n], st.emitted)
                           if want_logprobs and lp is not None else None)
                if not piece and lp_info is None:
                    return
                send(piece, lp_info)
                st.emitted += len(piece)

            def emit_until(cut: int) -> None:
                remaining = cut
                for p_text, p_lp, p_tops in st.pend:
                    if remaining <= 0:
                        break
                    emit_piece(p_text[:min(len(p_text), remaining)], p_lp,
                               p_tops)
                    remaining -= len(p_text)

            def on_token(item) -> None:
                tok, lp, tops = item
                piece = st.decoder.feed([tok])
                st.pend.append([piece, lp, tops])
                st.pend_chars += len(piece)
                cut = _stop_scan(''.join(p[0] for p in st.pend), stops)
                if cut is not None:
                    engine.cancel(fut)
                    emit_until(cut)
                    st.pend, st.stopped = [], True
                    return
                while st.pend and st.pend_chars - len(st.pend[0][0]) >= hold:
                    p_text, p_lp, p_tops = st.pend.pop(0)
                    st.pend_chars -= len(p_text)
                    emit_piece(p_text, p_lp, p_tops)

            def finish_choice() -> None:
                _, finish, _, _ = fut.result()
                if st.stopped:
                    finish = 'stop'
                else:
                    tail = st.decoder.flush()
                    if tail:
                        if st.pend:
                            st.pend[-1][0] += tail
                        else:
                            st.pend.append([tail, None, []])
                    joined = ''.join(p[0] for p in st.pend)
                    cut = _stop_scan(joined, stops)
                    if cut is not None:
                        finish = 'stop'
                    emit_until(len(joined) if cut is None else cut)
                send('', finish=finish)

            try:
                self.send_response(200)
                self.send_header('Content-Type', 'text/event-stream')
                self.send_header('Cache-Control', 'no-cache')
                self.send_header('Transfer-Encoding', 'chunked')
                self.end_headers()
                try:
                    while True:
                        try:
                            item = stream.get(timeout=1.0)
                        except queue.Empty:
                            if engine.loop_error is not None or \
                                    engine._stop.is_set():
                                raise RuntimeError(
                                    'engine stopped: '
                                    f'{engine.loop_error}') from None
                            continue
                        if item is None:
                            finish_choice()
                            break
                        if not st.stopped:
                            on_token(item)
                    self._chunk(b'data: [DONE]\n\n')
                except (ConnectionError, OSError):
                    raise
                except Exception as e:  # pylint: disable=broad-except
                    # The status line went out: an error event is the
                    # only signal left.
                    logger.warning('SSE stream aborted: %s', e)
                    self._event({'error': {'message': str(e),
                                           'type': 'server_error'}})
                self._chunk(b'')
            except (ConnectionError, OSError):
                pass                      # the client went away
            finally:
                if not fut.done():
                    engine.cancel(fut)
                    fut.cancel()

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
