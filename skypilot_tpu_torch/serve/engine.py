"""The inference engine and its HTTP surface (a reduced port of
skypilot_tpu/serve/engine.py: ``InferenceEngine`` with its fused k-step
decode, ``_InFlightStep``, ``_dispatch_step`` / ``_collect_step``,
``_choose_k`` / ``_lookahead_k``, the admission path with chunked
prefill and the shared-page prefix cache, prompt-lookup speculative
decoding (``_lookup_draft``, ``_spec_once``), ``_publish``, ``cancel``,
``batch_loop`` / ``_step_round``, ``warmup``; ``build_app``'s
``/health``, ``/generate``, ``/v1/completions`` with SSE and
``/v1/models``; ``main``).

What it keeps: ``MAX_BATCH`` slots over a block-paged K/V pool (page
size 64, ``(MAX_BATCH + min(PREFIX_CACHE_ENTRIES, MAX_BATCH)) *
pages_for(max_len) + 1`` pages unless ``SKYTPU_ENGINE_KV_PAGES`` says,
page 0 the trash page); admission, gated on free pages (counting what
evicting unshared prefix entries would return), that:
  - serves a prompt sharing a snapshotted power-of-two prefix of at
    least 64 tokens by prefilling only its suffix over the SAME pages
    (refcounted) — one ``paged_prefill_extend``;
  - prefills a longer miss in ``SKYTPU_ENGINE_PREFILL_CHUNK``-token
    chunks, one chunk per scheduling round, so decoding rows keep
    decoding; the first chunk is a plain prefill (kernel A on the
    card), later ones extend at an offset (the plain attention, as in
    JAX);
  - groups the other prompts by bucket into one prefill each (kernel
    A), scattered into freshly allocated pages;
then fused decode calls of k ∈ {1, ``MAX_STEP_CHUNK``} steps each, every
step a paged decode step (kernel B on the card) → per-row sampling
(greedy / temperature / top-k / top-p, OpenAI presence and frequency
penalties over the row's generated-token counts) → optional top-5
logprobs. An all-greedy pool without penalties speculates instead: a
host-side n-gram draft from each row's own context, then one
``SKYTPU_ENGINE_SPEC_K``-wide verify (kernel B at S = K), committing the
accepted run plus the correction. On the card each of the eight step
variants (k × penalties × top logprobs) and the two verify variants
(top logprobs or not) is one CUDA graph, captured in warm-up; on the
CPU the same functions run eagerly; extends stay eager. The batch loop
pipelines: it dispatches call N+1 before it collects call N while
nothing waits to join, no cancel or chunk is pending, speculation does
not apply and no row can finish inside the call in flight. Admission,
chunks, speculative rounds, cancels and failure resets happen only at
drained points; at most two calls are in flight.

Dense presets and the MoE family (``module_for``: models/moe.py, e.g.
``gpt-oss-20b``, ``moe-1b``) serve through the same paths, the routed
FFN inside every step graph; an MoE engine does not speculate
(``spec_k`` 0, as in JAX: capacity grouping makes a verify differ from
sequential steps), so its warm-up captures the eight step graphs only.
The MLA family (``deepseek-v2-lite``; ``deepseek-v2``, whose DeepSeekMoE
FFN is routed) decodes over a second cache family, the paged latent
pool: ``_decode`` is models/mla.py instead of models/decode.py, the
same calls on a ``PagedLatent`` (``cache_family()`` says which), every
attention the plain absorbed-matmul one, as in JAX; dense MLA
speculates, DeepSeekMoE does not. ``quantize='int8'`` (``--quantize
int8``) serves weight-only int8 params (models/decode.py
``cast_params_for_decode``, from fp32 masters): every step graph reads
them through the dequant of ``_d``; an MoE config is refused, as in JAX.

Weights come from a preset drawn from ``seed``, from a checkpoint of
the port's trainer (``ckpt_dir``: its params alone, restored onto the
engine's device) or from an HF checkpoint directory (``hf_dir``:
models/hf_import.py, the model named after the directory, its
``tokenizer.json`` required). ``/v1/chat/completions`` templates the
messages for the tokenizer's chat family (llama3, ChatML, or plain for
the byte tokenizer) and answers as JSON or SSE.

What waits (ROADMAP Queue 1 item 4): ``n`` / ``best_of`` and batched
prompts (each refused with 400 by name), metrics and the flight
recorder, failure resurrection, the spill tier and int8 KV, disagg,
meshes (an expert axis among them) and multi-host.

The HTTP server is the standard library's ThreadingHTTPServer; the
batch loop runs in its own thread and owns all device state. Request
handlers only enqueue and wait on a concurrent.futures.Future or, when
streaming, a per-request queue.

    SKYTPU_ENGINE_STEP_CHUNK=8 python -m skypilot_tpu_torch.serve.engine \\
        --model llama-1b --port 8300
    python -m skypilot_tpu_torch.serve.engine --model gpt-oss-20b
    python -m skypilot_tpu_torch.serve.engine --model deepseek-v2-lite
    python -m skypilot_tpu_torch.serve.engine --model llama3.2-1b \\
        --ckpt-dir ./ck      # a trainer checkpoint (e.g. from --hf-dir)
    python -m skypilot_tpu_torch.serve.engine --hf-dir ./Llama-3.2-1B
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

from skypilot_tpu_torch.config import (DeepSeekMoEConfig, LlamaConfig,
                                      MLAConfig, MoEConfig, check_supported,
                                      get_config)
from skypilot_tpu_torch.data import tokenizer as tokenizer_lib
from skypilot_tpu_torch.data.tokenizer import StreamDecoder
from skypilot_tpu_torch.kernels import build
from skypilot_tpu_torch.models import (decode, hf_import, mla, module_for,
                                       paging)
from skypilot_tpu_torch.train import checkpoints

logger = logging.getLogger(__name__)


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, str(default)))


MAX_BATCH = 8
PAGE_SIZE = 64
MAX_QUEUE = 64
# Decode steps fused into one device call when no request waits to join
# (the JAX knob of the same name): the two step widths are 1 and this.
MAX_STEP_CHUNK = _env_int('SKYTPU_ENGINE_STEP_CHUNK', 8)
# Top-N alternative logprobs computed per token (OpenAI ``logprobs=N``):
# only in the step variants some active row asked for, always at admit.
TOP_LOGPROBS_K = 5
# Rows of the per-call control block the host uploads: active, then the
# sampler's temperature, top_k, top_p, presence and frequency.
CTRL_ROWS = 6
# Calls in flight at most (one collected while the next one runs).
MAX_INFLIGHT = 2
# The JAX engine's knobs, under its names and with its defaults. Each is
# an instance attribute too, which tests may set before warm-up.
# Prefix cache: LRU entries (0 disables). A prompt sharing a snapshotted
# prefix prefills only its suffix, over the snapshot's own pages.
PREFIX_CACHE_ENTRIES = _env_int('SKYTPU_ENGINE_PREFIX_CACHE', 4)
# int8 K/V pools ('int8'; JAX default 'none'): refused, not ported yet.
KV_QUANT = os.environ.get('SKYTPU_ENGINE_KV_QUANT', 'none')
# Prompts shorter than this are never snapshotted; snapshots are powers
# of two, so the page size must divide it.
PREFIX_MIN_TOKENS = 64
# Speculative decoding: tokens proposed per verify round (0 disables).
SPEC_K = _env_int('SKYTPU_ENGINE_SPEC_K', 4)
# Longest n-gram of the row's own context matched when drafting, and the
# trailing window scanned (host-side Python on the decode loop).
SPEC_NGRAM = 3
SPEC_LOOKUP_WINDOW = 512
# A round accepting under SPEC_MIN_ACCEPT of its real proposals pauses
# speculation for SPEC_COOLDOWN collected calls; a probe that finds no
# draft (or a row without verify headroom) for SPEC_NO_DRAFT_COOLDOWN.
SPEC_MIN_ACCEPT = 0.25
SPEC_COOLDOWN = _env_int('SKYTPU_ENGINE_SPEC_COOLDOWN', 16)
SPEC_NO_DRAFT_COOLDOWN = 4
# Pool pages, the trash page included; 0: every slot's worst case plus
# the prefix cache's headroom.
KV_PAGES = _env_int('SKYTPU_ENGINE_KV_PAGES', 0)
# Prompts longer than this prefill in chunks of this many tokens (a power
# of two >= 16), one chunk per scheduling round.
PREFILL_CHUNK = _env_int('SKYTPU_ENGINE_PREFILL_CHUNK', 256)


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
    collect) and the step outputs it downloads. A speculative round's
    stage holds the verify's int32 block ([K + 4, B]) in ``ctrl`` and
    its [B, K] outputs."""
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


def _lookup_draft(ctx: List[int], k: int) -> Optional[List[int]]:
    """Prompt-lookup drafting: the tokens that followed the most recent
    earlier occurrence of the context's trailing SPEC_NGRAM-gram (then
    2-gram), at most k of them, or None when the context never repeats
    itself (the JAX ``_lookup_draft``)."""
    if len(ctx) > SPEC_LOOKUP_WINDOW:
        ctx = ctx[-SPEC_LOOKUP_WINDOW:]
    for n in (SPEC_NGRAM, 2):
        if len(ctx) < n + 1:
            continue
        key = ctx[-n:]
        for i in range(len(ctx) - n - 1, -1, -1):
            if ctx[i:i + n] == key:
                cont = ctx[i + n:i + n + k]
                if cont:
                    return cont
                break
    return None


class InferenceEngine:
    """Owns params, the tokenizer, the page pool and the batched
    generate loop.

    ``device`` defaults to 'cuda'; constructing on 'cuda' without a card
    raises (there is no fallback to the CPU). Tests pass ``device='cpu'``
    plus a small ``cfg`` and bridged ``params``. ``ckpt_dir`` (a
    checkpoint of the port's trainer, of ``model``'s config) and
    ``hf_dir`` (an HF checkpoint directory, which also gives the config)
    are exclusive, and neither takes ``params``. The tokenizer is
    ``tokenizer_path``'s ``tokenizer.json``, else ``hf_dir``'s (it must
    be there: no byte fallback for a real vocabulary), else the byte
    tokenizer. The pool and every
    tensor a graph touches are built at warm-up (or at the first
    admission), after tests may have set ``page_size``, ``kv_pages``,
    ``prefix_cache``, ``prefill_chunk``, ``spec_k`` or
    ``spec_cooldown``."""

    def __init__(self, model: Optional[str] = 'llama-1b', *,
                 cfg: Optional[LlamaConfig] = None, params=None,
                 ckpt_dir: Optional[str] = None,
                 hf_dir: Optional[str] = None,
                 tokenizer_path: Optional[str] = None,
                 max_len: Optional[int] = None, device: str = 'cuda',
                 seed: int = 0, quantize: Optional[str] = None):
        self.device = torch.device(device)
        if self.device.type == 'cuda' and not torch.cuda.is_available():
            raise RuntimeError('no CUDA device: the engine runs on the card '
                               "unless device='cpu' is asked for")
        if ckpt_dir and hf_dir:
            raise ValueError('--ckpt-dir and --hf-dir are exclusive')
        if params is not None and (ckpt_dir or hf_dir):
            raise ValueError('params come from the checkpoint: pass '
                             'params or ckpt_dir/hf_dir, not both')
        if hf_dir:
            cfg, params = hf_import.load_hf_checkpoint(hf_dir,
                                                       device=self.device)
            model = os.path.basename(os.path.normpath(
                os.path.expanduser(hf_dir)))
        elif cfg is None:
            if model is None:
                raise ValueError('need --model or --hf-dir')
            cfg = get_config(model)
        self.cfg = cfg
        check_supported(self.cfg)
        decode.check_quantize(self.cfg, quantize)
        self.model_name = model
        if ckpt_dir:
            if not os.path.isdir(os.path.expanduser(ckpt_dir)):
                raise FileNotFoundError(f'--ckpt-dir {ckpt_dir}: no such '
                                        f'directory')
            with checkpoints.Checkpointer(ckpt_dir) as ckpt:
                params, step = ckpt.restore_params(self.cfg, self.device)
            logger.info('Restored checkpoint step %d from %s (params '
                        'only).', step, ckpt_dir)
        # The MLA family decodes over the paged latent pool (models/
        # mla.py), every other over the paged K/V (models/decode.py):
        # one call surface, so the engine picks a module, not a path.
        self._decode = mla if isinstance(self.cfg, MLAConfig) else decode
        self.max_len = max_len or min(self.cfg.max_seq_len, 2048)
        self.max_batch = MAX_BATCH
        self.page_size = PAGE_SIZE
        self.step_chunk = MAX_STEP_CHUNK
        self.prefix_cache = PREFIX_CACHE_ENTRIES
        # Speculation needs a verify equal to sequential steps, which MoE
        # capacity grouping breaks: off for an MoE or DeepSeekMoE config,
        # as in JAX (dense MLA speculates).
        self.spec_k = (0 if isinstance(self.cfg, (MoEConfig,
                                                  DeepSeekMoEConfig))
                       else SPEC_K)
        self.spec_cooldown = SPEC_COOLDOWN
        self.prefill_chunk = PREFILL_CHUNK
        self.kv_pages = KV_PAGES
        self._check_knobs()
        self.seed = seed
        if params is None:
            # Drawn leaf by leaf into the compute dtype: the whole tree
            # never exists in fp32 (gpt-oss-20b's would not fit the card).
            # int8 quantizes from the fp32 masters, as JAX does (MoE,
            # the large family, is refused above).
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = module_for(self.cfg).init_params(
                self.cfg, gen, self.device,
                dtype=self.cfg.param_dtype if quantize else self.cfg.dtype)
            logger.info('Serving randomly-initialized params (seed %d).',
                        seed)
        self.params = decode.cast_params_for_decode(params, self.cfg,
                                                    quantize=quantize)
        if quantize:
            logger.info('Serving with weight-only %s quantization.',
                        quantize)
        if tokenizer_path:
            self.tokenizer = tokenizer_lib.load_tokenizer(tokenizer_path)
        elif hf_dir:
            self.tokenizer = tokenizer_lib.load_tokenizer(
                hf_dir, eos_extra=hf_import.hf_eos_ids(hf_dir))
            logger.info('Loaded tokenizer.json from %s (chat family: %s, '
                        'eos ids: %s).', hf_dir, self.tokenizer.chat_family,
                        self.tokenizer.eos_ids)
        else:
            self.tokenizer = tokenizer_lib.ByteTokenizer()
        self._queue: 'queue.Queue[Request]' = queue.Queue(maxsize=MAX_QUEUE)
        self._hold: List[Request] = []
        self._pending_cancels: collections.deque = collections.deque()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.warm = False
        self.loop_error: Optional[BaseException] = None
        self.step_count = 0
        # Fused calls dispatched, by variant (k, use_pen, want_tops), and
        # speculative verify calls, by want_tops.
        self.calls: collections.Counter = collections.Counter()
        self.verify_calls: collections.Counter = collections.Counter()
        # Admission and speculation counters (zeroed after warm-up).
        self.prefix_hits = 0
        self.prefill_chunks = 0
        self.spec_rounds = 0
        self.spec_proposed = 0
        self.spec_accepted = 0
        # Finished requests' (ttft_s, tpot_s, n_tokens), newest last.
        self.timings: collections.deque = collections.deque(maxlen=4096)
        self._inflight: List[_InFlightStep] = []
        self.cache: Optional[Any] = None    # PagedKV or PagedLatent
        self._layout: Optional[Tuple[int, int, int]] = None
        self.alloc: Optional[paging.PageAllocator] = None
        self.slots: List[Optional[Dict[str, Any]]] = [None] * self.max_batch
        self._prefix_store: 'collections.OrderedDict[tuple, List[int]]' = \
            collections.OrderedDict()

    def _check_knobs(self) -> None:
        """The JAX engine's checks of its paging knobs."""
        psz, chunk = self.page_size, self.prefill_chunk
        if psz < 1 or psz & (psz - 1) or PREFIX_MIN_TOKENS % psz:
            raise ValueError(f'page size must be a power of two dividing '
                             f'{PREFIX_MIN_TOKENS}, got {psz}')
        if chunk < 16 or chunk & (chunk - 1):
            raise ValueError(f'SKYTPU_ENGINE_PREFILL_CHUNK must be a power '
                             f'of two >= 16, got {chunk}')
        if self.step_chunk < 1:
            raise ValueError(f'SKYTPU_ENGINE_STEP_CHUNK must be >= 1, got '
                             f'{self.step_chunk}')
        if KV_QUANT not in ('', 'none'):
            raise NotImplementedError(
                f'SKYTPU_ENGINE_KV_QUANT={KV_QUANT!r}: int8 K/V pools are '
                f'not ported yet; they wait for ROADMAP Queue 1 item 3 '
                f'(int8 KV). Weight-only int8 is quantize=\'int8\'.')

    def cache_family(self) -> str:
        """'paged_kv' (dense/GQA/MoE) or 'paged_latent' (MLA): the
        family of the pool this engine decodes over."""
        return 'paged_latent' if self._decode is mla else 'paged_kv'

    # -- device state ------------------------------------------------------
    def _ensure_state(self) -> None:
        """Build the pool and the device state for the current knobs, once
        (warm-up, or the first admission of a test that skips it). The
        captured graphs hold these tensors' addresses: once a graph
        exists the layout may not change."""
        self._check_knobs()
        max_pages = paging.pages_for(self.max_len, self.page_size)
        n_pages = self.kv_pages
        if n_pages <= 0:
            n_pages = (self.max_batch + max(0, min(self.prefix_cache,
                                                   self.max_batch))) \
                * max_pages + 1
        if n_pages < max_pages + 1:
            raise ValueError(f'SKYTPU_ENGINE_KV_PAGES={n_pages} cannot hold '
                             f'one full-length request ({max_pages} pages + '
                             f'trash)')
        layout = (self.page_size, n_pages, max(self.spec_k, 0))
        if layout == self._layout:
            return
        if self._layout is not None and self.graphs:
            raise RuntimeError(f'pool layout {layout} changed after CUDA '
                               f'graphs were captured on {self._layout}')
        self.cache = None               # give the old pool back first
        self._layout = layout
        self._max_pages, self.n_pages = max_pages, n_pages
        self._alloc_device_state()
        self._reset_host_state()

    def _alloc_device_state(self) -> None:
        """Allocate every tensor a captured step or verify reads or
        writes, once: CUDA graphs hold their addresses for the engine's
        lifetime, so a reset writes into these same tensors
        (:meth:`_reset_device_state`), and the eager extends write the
        pool, lengths, ``last`` and counts in place."""
        psz, b, dev = self.page_size, self.max_batch, self.device
        self.cache = self._decode.init_page_pool(
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
        # The verify's block: rows [0, K) the fed tokens [last, d1..]
        # transposed, row K active, then the commit's length advance,
        # fix_last mask and last; its outputs are [B, K]. One pinned
        # stage: rounds run at drained points, one at a time.
        k = max(self.spec_k, 0)
        if k:
            self._spec_dev = torch.zeros((k + 4, b), dtype=torch.int32,
                                         device=dev)
            self._ver_toks = torch.zeros((b, k), dtype=torch.int32,
                                         device=dev)
            self._ver_lps = torch.zeros((b, k), dtype=torch.float32,
                                        device=dev)
            self._ver_tis = torch.zeros((b, k, ntop), dtype=torch.int32,
                                        device=dev)
            self._ver_tvs = torch.zeros((b, k, ntop), dtype=torch.float32,
                                        device=dev)
            self._spec_stage = _Stage(host((k + 4, b), torch.int32),
                                      host((b, k), torch.int32),
                                      host((b, k), torch.float32),
                                      host((b, k, ntop), torch.int32),
                                      host((b, k, ntop), torch.float32))
        # Admission samples eagerly from one generator; the fused steps
        # draw from another, registered with every graph that draws.
        self.generator = torch.Generator(device=dev).manual_seed(self.seed)
        self._step_gen = torch.Generator(device=dev).manual_seed(
            self.seed + 1)
        # The captured variants (card only), their captured kernel
        # launches, one capture stream and one memory pool for all.
        self.graphs: Dict[tuple, Any] = {}
        self._graph_launches: Dict[tuple, Dict[str, int]] = {}
        self._graph_stream = None
        self._graph_pool = None

    def _reset_host_state(self) -> None:
        """The allocator, slots, the prefix store and every host mirror,
        as new. The store is emptied without unref'ing its ids: they
        belonged to the allocator this replaces."""
        self.alloc = paging.PageAllocator(self.n_pages)
        self._table_np = np.zeros((self.max_batch, self._max_pages),
                                  np.int32)
        self._table_dirty = True
        self.slots = [None] * self.max_batch
        self._prefix_store = collections.OrderedDict()
        self.last = np.zeros(self.max_batch, np.int32)
        self.temp = np.zeros(self.max_batch, np.float32)
        self.topk = np.zeros(self.max_batch, np.int32)
        self.topp = np.zeros(self.max_batch, np.float32)
        self.pres = np.zeros(self.max_batch, np.float32)
        self.freq = np.zeros(self.max_batch, np.float32)
        self._samp_dirty = True
        self._inflight = []
        self._spec_cool = 0
        self._chunk_rr = 0

    def _reset_device_state(self) -> None:
        """After a failed admit/step: wait out whatever the card still
        runs (an uncollected call may be copying into a stage), then
        zero the pool, table, lengths, ``last`` and counts IN PLACE (the
        graphs keep their addresses) and reset the host state."""
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        for t in (*paging._pools(self.cache).values(), self.cache.table,
                  self.cache.length, self.last_dev, self.counts):
            t.zero_()
        if self.spec_k > 0:
            self._spec_dev.zero_()
        self._reset_host_state()

    def _refresh_table(self) -> None:
        """Push the host page-table mirror to the device if dirty. Only
        at drained points: a call in flight may be reading the table."""
        if self._table_dirty:
            assert not self._inflight, 'table refresh with a call in flight'
            self.cache.table.copy_(torch.from_numpy(self._table_np))
            self._table_dirty = False

    # -- pages -------------------------------------------------------------
    def _pages_needed(self, req: Request) -> int:
        """Pages a request reserves: bucketed prompt + max_new + the
        speculative verify's headroom (it writes K positions on every
        row), capped at the table's coverage. A lookahead call never
        writes past them; a prefix hit needs fewer of its own."""
        spec = max(self.spec_k, 0)
        want = min(decode.bucket_size(len(req.tokens)) + req.max_new + spec,
                   self._max_pages * self.page_size)
        return paging.pages_for(want, self.page_size)

    def _evictable_pages(self) -> int:
        """Pages the prefix store would free if evicted now: those no
        live request shares."""
        return sum(1 for pids in self._prefix_store.values()
                   for pid in pids if self.alloc.refcount(pid) == 1)

    def _alloc_pages(self, n: int) -> List[int]:
        """Reserve n pages, evicting prefix entries, oldest first, while
        the free list is short (a cached prefix is worth less than an
        admitted request)."""
        while not self.alloc.can_fit(n) and self._prefix_store:
            _, pids = self._prefix_store.popitem(last=False)
            self.alloc.unref_all(pids)
        return self.alloc.alloc(n)

    def _reserve_slot_pages(self, slot: int, pids: List[int]) -> None:
        self._table_np[slot, :len(pids)] = pids
        self._table_np[slot, len(pids):] = 0
        self._table_dirty = True

    def _release_slot_pages(self, slot: int) -> None:
        """Drop the slot's refs: its own pages free, shared prefix pages
        free when their last holder lets go."""
        pids = [int(p) for p in self._table_np[slot] if p]
        if pids:
            self.alloc.unref_all(pids)
            self._table_np[slot] = 0
            self._table_dirty = True

    def _drop_all_slots(self) -> None:
        """Warm-up's slot wipe, returning every slot's pages."""
        for i in range(self.max_batch):
            if self.slots[i] is not None:
                self._release_slot_pages(i)
                self.slots[i] = None

    def _clear_prefix_store(self) -> None:
        """Empty the prefix store, returning its page refs (a reset
        rebuilds the allocator and drops the store instead)."""
        while self._prefix_store:
            _, pids = self._prefix_store.popitem(last=False)
            self.alloc.unref_all(pids)

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
        slot (a prefilling one too) frees at the next publish."""
        while self._pending_cancels:
            fut = self._pending_cancels.popleft()
            for s in self.slots:
                if s is not None and s['req'].future is fut:
                    if s['finish'] is None:
                        s['finish'] = 'stop'
                    break

    # -- admission -------------------------------------------------------------
    def _drain_admissible(self) -> List[Request]:
        """Pop requests bounded by free slots and by free pages plus
        what evicting unshared prefix entries would return, FIFO: once
        one is held, nothing younger passes it. A cancelled request is
        dropped here."""
        items: List[Request] = []
        free_slots = sum(1 for s in self.slots if s is None)
        budget = self.alloc.free_count + self._evictable_pages()

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

    def _free_slot(self, taken=()) -> int:
        return next(i for i, s in enumerate(self.slots)
                    if s is None and i not in taken)

    def _set_sampling(self, slot: int, req: Request) -> None:
        self.temp[slot] = max(req.temperature, 0.0)
        self.topk[slot] = int(req.top_k) if req.top_k else 0
        self.topp[slot] = float(req.top_p) if req.top_p else 0.0
        self.pres[slot] = req.presence
        self.freq[slot] = req.frequency
        self._samp_dirty = True

    def _sample_first(self, logits: torch.Tensor, slots: List[int]):
        """Sample each admitted row's first token from the admission
        generator, seed the slot's device ``last`` and penalty counts
        (zeroed, the first token counted): (tokens, logprobs, top ids,
        top logprobs) on the host. The JAX ``sample_tail``."""
        dev = self.device
        slots_t = torch.tensor(slots, dtype=torch.int64, device=dev)
        first = decode.select_token_per_row(
            logits, torch.from_numpy(self.temp[slots]).to(dev),
            torch.from_numpy(self.topk[slots]).to(dev),
            torch.from_numpy(self.topp[slots]).to(dev), self.generator)
        first_lp = decode.chosen_logprob(logits, first)
        tvs, tis = decode.top_k_logprobs(logits, TOP_LOGPROBS_K)
        self.last_dev[slots_t] = first
        self.counts[slots_t] = 0
        self.counts[slots_t, first.long()] += 1
        return (first.cpu().numpy(), first_lp.cpu().numpy(),
                tis.cpu().numpy(), tvs.cpu().numpy())

    def _admit_group(self, items: List[Request]) -> None:
        """Admit requests at a drained point. Once warm with the prefix
        cache on, a hit prefills only its suffix (:meth:`_admit_with_
        prefix`), a long miss whose snapshot was evicted meanwhile
        starts chunked, and the other misses are re-split into
        power-of-two groups. A group (same bucket) prefills in ONE
        eager call (kernel A on the card), its K/V scattered into
        freshly allocated pages; each first token is sampled and, once
        warm, each prompt's prefix snapshotted."""
        assert not self._inflight, 'admission with a call in flight'
        self._ensure_state()
        if self.warm and self.prefix_cache > 0:
            rest = []
            for req in items:
                p = self._prefix_match(req.tokens)
                if p is not None:
                    self._admit_with_prefix(req, p)
                elif self._should_chunk(req):
                    self._start_chunked(req)
                else:
                    rest.append(req)
            if not rest:
                return
            if len(rest) != len(items):
                for group in self._admit_groups(rest):
                    self._admit_group(group)
                return
            items = rest
        bucket = decode.bucket_size(len(items[0].tokens))
        slots, padded, lengths = [], [], []
        for req in items:
            if decode.bucket_size(len(req.tokens)) != bucket:
                raise ValueError('admit group mixes prompt buckets')
            slot = self._free_slot(slots)
            slots.append(slot)
            padded.append(req.tokens + [0] * (bucket - len(req.tokens)))
            lengths.append(len(req.tokens))
            self._set_sampling(slot, req)
            self._reserve_slot_pages(
                slot, self._alloc_pages(self._pages_needed(req)))
        self._refresh_table()
        dev = self.device
        slots_t = torch.tensor(slots, dtype=torch.int64, device=dev)
        lengths_t = torch.tensor(lengths, dtype=torch.int32, device=dev)
        with torch.no_grad():
            logits, rows_a, rows_b = self._decode.prefill(
                self.params,
                torch.tensor(padded, dtype=torch.int32, device=dev),
                self.cfg, self.max_len, lengths=lengths_t)
            paging.scatter_prefill(self.cache, rows_a, rows_b, slots_t,
                                   bucket, lengths_t)
            first, first_lp, tis, tvs = self._sample_first(logits, slots)
        now = time.perf_counter()
        for i, req in enumerate(items):
            self._finish_admit(req, slots[i], int(first[i]),
                               float(first_lp[i]),
                               _tops_list(tis[i], tvs[i]), now)
            if self.warm:
                self._prefix_capture(req.tokens, slots[i])

    def _finish_admit(self, req: Request, slot: int, first: int,
                      first_lp: float, tops: list, now: float) -> None:
        self.last[slot] = first
        # ctx = prompt ++ generated: the draft's source, and the host
        # view of the row's cache length (len(ctx) - 1).
        entry = {'req': req, 'out': [], 'lps': [], 'tops': [],
                 'finish': None, 'stop': frozenset(req.stop_ids),
                 't_first': now, 'sent': 0,
                 'ctx': list(req.tokens) + [first]}
        if first in entry['stop']:
            entry['finish'] = 'stop'
        else:
            entry['out'].append(first)
            entry['lps'].append(first_lp)
            entry['tops'].append(tops)
            if len(entry['out']) >= req.max_new:
                entry['finish'] = 'length'
        self.slots[slot] = entry

    # -- the prefix cache --------------------------------------------------------
    def _prefix_match(self, tokens: List[int]) -> Optional[int]:
        """The longest snapshotted power-of-two prefix of ``tokens``
        leaving at least one suffix token, whose prefix + bucketed
        suffix fits max_len; None: a full prefill."""
        if not self._prefix_store:
            return None
        p, best = PREFIX_MIN_TOKENS, None
        while p < len(tokens):
            if (tuple(tokens[:p]) in self._prefix_store and
                    p + decode.bucket_size(len(tokens) - p) <= self.max_len):
                best = p
            p *= 2
        return best

    def _prefix_capture(self, tokens: List[int], slot: int) -> None:
        """Snapshot the slot's longest power-of-two prefix (at least
        PREFIX_MIN_TOKENS): p / page_size refs on the slot's own first
        pages, which nobody writes again (the row decodes at positions
        >= len(tokens) >= p). The store keeps ``prefix_cache`` entries,
        least recently used out first."""
        if self.prefix_cache <= 0 or len(tokens) < PREFIX_MIN_TOKENS:
            return
        p = PREFIX_MIN_TOKENS
        while p * 2 <= len(tokens):
            p *= 2
        key = tuple(tokens[:p])
        if key in self._prefix_store:
            self._prefix_store.move_to_end(key)
            return
        pids = [int(x) for x in self._table_np[slot, :p // self.page_size]]
        if not pids or 0 in pids:
            return
        for pid in pids:
            self.alloc.ref(pid)
        self._prefix_store[key] = pids
        while len(self._prefix_store) > self.prefix_cache:
            _, old = self._prefix_store.popitem(last=False)
            self.alloc.unref_all(old)

    def _admit_with_prefix(self, req: Request, p: int) -> None:
        """Admit one request over a stored prefix: its table points at
        the snapshot's pages (one more ref each), its own pages follow
        (the suffix starts on a page edge, so no sharer writes a shared
        page), then one ``paged_prefill_extend`` at (p, bucket(suffix))
        and the first token sampled; the longer prompt is snapshotted
        in turn, so a growing history extends its entry."""
        slot = self._free_slot()
        suffix = req.tokens[p:]
        s2 = decode.bucket_size(len(suffix))
        self._set_sampling(slot, req)
        key = tuple(req.tokens[:p])
        shared = list(self._prefix_store[key])
        self._prefix_store.move_to_end(key)
        # Ref the shared pages before allocating: an eviction under page
        # pressure may then drop the entry, never the pages.
        for pid in shared:
            self.alloc.ref(pid)
        own = self._alloc_pages(max(0, self._pages_needed(req) - len(shared)))
        self._reserve_slot_pages(slot, shared + own)
        self._refresh_table()
        with torch.no_grad():
            logits = self._decode.paged_prefill_extend(
                self.params, torch.tensor([suffix + [0] * (s2 - len(suffix))],
                                          dtype=torch.int32,
                                          device=self.device),
                self.cache, self.cfg, slot=slot, p=p, lengths=len(suffix))
            first, first_lp, tis, tvs = self._sample_first(logits, [slot])
        self.prefix_hits += 1
        self._finish_admit(req, slot, int(first[0]), float(first_lp[0]),
                           _tops_list(tis[0], tvs[0]), time.perf_counter())
        self._prefix_capture(req.tokens, slot)

    # -- chunked prefill ---------------------------------------------------------
    def _should_chunk(self, req: Request) -> bool:
        """A prompt longer than ``prefill_chunk`` prefills in chunks,
        unless it rides the prefix cache."""
        if len(req.tokens) <= self.prefill_chunk:
            return False
        return not (self.warm and self.prefix_cache > 0 and
                    self._prefix_match(req.tokens) is not None)

    def _pending_chunks(self) -> List[int]:
        """Slots mid-chunked-prefill."""
        return [i for i, s in enumerate(self.slots)
                if s is not None and s['finish'] is None and
                s.get('prefill') is not None]

    def _start_chunked(self, req: Request) -> None:
        """Claim a slot, reserve all of the row's pages now and run the
        first chunk; the batch loop runs the rest, one per round."""
        assert not self._inflight, 'chunk start with a call in flight'
        self._ensure_state()
        slot = self._free_slot()
        self._set_sampling(slot, req)
        self._reserve_slot_pages(
            slot, self._alloc_pages(self._pages_needed(req)))
        self.slots[slot] = {'req': req, 'out': [], 'lps': [], 'tops': [],
                            'finish': None, 'stop': frozenset(req.stop_ids),
                            'sent': 0, 'prefill': {'pos': 0}}
        self._advance_chunk(slot)

    def _advance_chunk(self, slot: int) -> None:
        """Run ONE prefill chunk of ``slot`` (drained points only). A
        non-final chunk writes positions [pos, pos + chunk) into the
        row's pages and touches neither the admission generator nor the
        device ``last``, so a chunked prompt draws what a grouped one
        would; the final chunk samples the first token, turns the slot
        into a decoding row and snapshots its prefix."""
        s = self.slots[slot]
        if s is None or s['finish'] is not None or s.get('prefill') is None:
            return                      # cancelled: publish reaps it
        assert not self._inflight, 'chunk with a call in flight'
        req, pos, c = s['req'], s['prefill']['pos'], self.prefill_chunk
        remaining = len(req.tokens) - pos
        self._refresh_table()
        dev = self.device
        with torch.no_grad():
            if remaining > c:
                self._decode.paged_prefill_extend(
                    self.params, torch.tensor([req.tokens[pos:pos + c]],
                                              dtype=torch.int32, device=dev),
                    self.cache, self.cfg, slot=slot, p=pos, lengths=c)
                s['prefill']['pos'] = pos + c
                self.prefill_chunks += 1
                return
            s2 = decode.bucket_size(remaining)
            logits = self._decode.paged_prefill_extend(
                self.params, torch.tensor(
                    [req.tokens[pos:] + [0] * (s2 - remaining)],
                    dtype=torch.int32, device=dev),
                self.cache, self.cfg, slot=slot, p=pos, lengths=remaining)
            first, first_lp, tis, tvs = self._sample_first(logits, [slot])
        self.prefill_chunks += 1
        self._finish_admit(req, slot, int(first[0]), float(first_lp[0]),
                           _tops_list(tis[0], tvs[0]), time.perf_counter())
        self._prefix_capture(req.tokens, slot)

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
                logits, _ = self._decode.paged_decode_step(
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

    def _verify_body(self, want_tops: bool) -> None:
        """One K-wide speculative verify over the whole pool: the fed
        [B, K] = per-row [last, d1..d_{K-1}] from ``_spec_dev`` (row K:
        active) through ``paged_verify_step`` (kernel B at S = K on the
        card; K/V of the fed tokens written at each row's offset, the
        inactive rows' on the trash page; ``length`` does not move),
        then the greedy token and its logprob at every position (and the
        top-5 in the want_tops variant) into ``_ver_*``. Fixed
        addresses and no host sync, as :meth:`_step_body`."""
        k = self.spec_k
        fed = self._spec_dev[:k].t()
        active = self._spec_dev[k] > 0
        with torch.no_grad():
            logits, _ = self._decode.paged_verify_step(
                self.params, fed, self.cache, self.cfg,
                max_len=self.max_len, active=active)
            greedy = torch.argmax(logits, dim=-1).to(torch.int32)
            self._ver_toks.copy_(greedy)
            self._ver_lps.copy_(decode.chosen_logprob(
                logits.reshape(-1, logits.shape[-1]),
                greedy.reshape(-1)).reshape(greedy.shape))
            if want_tops:
                tv, ti = decode.top_k_logprobs(logits, TOP_LOGPROBS_K)
                self._ver_tvs.copy_(tv)
                self._ver_tis.copy_(ti)

    def _body(self, key: tuple) -> Callable[[], None]:
        if key[0] == 'verify':
            return lambda: self._verify_body(key[1])
        return lambda: self._step_body(*key)

    def _variant(self, key: tuple) -> Callable[[], None]:
        """The callable that runs one call of variant ``key`` — (k,
        use_pen, want_tops) for a fused step, ('verify', want_tops) for
        a verify: on the CPU the body itself; on the card the replay of
        its CUDA graph, captured here the first time (warm-up drives
        every variant, so after it nothing is captured and nothing runs
        eagerly)."""
        if self.device.type != 'cuda':
            return self._body(key)
        if key not in self.graphs:
            if self.warm:
                raise RuntimeError(f'variant {key} was not captured in '
                                   f'warm-up')
            self._capture(key)
        graph, launched = self.graphs[key], self._graph_launches[key]
        kernels = build.kernels()

        def replay() -> None:
            graph.replay()
            for name, n in launched.items():
                kernels[name].replayed(n)
        return replay

    def _capture(self, key: tuple) -> None:
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
        body = self._body(key)
        if key[0] == 'verify':
            self._spec_dev[:self.spec_k + 1].zero_()   # no row active
        else:
            self._ctrl.zero_()           # every row inactive, greedy
            self._samp_dirty = True      # the next dispatch re-uploads
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            body()
        stream.synchronize()
        before = build.captured()
        graph = torch.cuda.CUDAGraph()
        if key[0] != 'verify':
            graph.register_generator_state(self._step_gen)
        with torch.cuda.graph(graph, pool=self._graph_pool, stream=stream,
                              capture_error_mode='thread_local'):
            body()
        after = build.captured()
        self._graph_launches[key] = {n: after[n] - before[n] for n in after
                                     if after[n] > before[n]}
        self.graphs[key] = graph

    # -- dispatch / collect ----------------------------------------------------
    @staticmethod
    def _row_active(s: Optional[Dict[str, Any]]) -> bool:
        """A row to step: occupied, unfinished, not mid-chunked-prefill."""
        return (s is not None and s['finish'] is None and
                s.get('prefill') is None)

    def _remaining(self, inflight_k: int = 0) -> List[int]:
        """Per-active-row token budget before a length finish; an
        uncollected call's tokens count as spent (the lookahead view)."""
        return [s['req'].max_new - len(s['out']) - inflight_k
                for s in self.slots if self._row_active(s)]

    def _choose_k(self, inflight_k: int = 0) -> int:
        """Step width for the next fused call: MAX_STEP_CHUNK while every
        active row has that many tokens left, nothing waits to be
        admitted and no chunk is pending, else 1. Only the two widths
        exist, so a client's max_new cannot ask for a variant warm-up
        did not capture."""
        if self._hold or self._pending_chunks():
            return 1
        remaining = self._remaining(inflight_k)
        if (remaining and min(remaining) >= self.step_chunk and
                self._queue.empty()):
            return self.step_chunk
        return 1

    def _lookahead_k(self, inflight_k: int) -> Optional[int]:
        """Width for a lookahead dispatch (call N+1 before call N is
        collected), or None when the pipeline must drain first: a
        request waits to be admitted, a cancel or a chunk is pending,
        the next drained round could speculate (speculation takes
        precedence while its preconditions hold), or some active row
        may finish inside the call in flight."""
        if self._pending_cancels or self._hold or not self._queue.empty():
            return None
        if self._pending_chunks() or self._spec_precheck():
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
        run = self._variant((k, use_pen, want_tops))
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
        handle = _InFlightStep(k, want_tops, stage, self._record())
        self._inflight.append(handle)
        return handle

    def _record(self):
        """An event after the work enqueued so far (None on the CPU,
        whose copies are synchronous)."""
        if self.device.type != 'cuda':
            return None
        event = torch.cuda.Event()
        event.record()
        return event

    def _commit(self, s: Dict[str, Any], tok: int, lp: float,
                tops: list) -> bool:
        """Append one generated token to row ``s`` unless it is a stop
        id; True when the row finished (stop or length)."""
        if tok in s['stop']:
            s['finish'] = 'stop'
            return True
        s['out'].append(tok)
        s['lps'].append(lp)
        s['tops'].append(tops)
        s['ctx'].append(tok)
        if len(s['out']) >= s['req'].max_new:
            s['finish'] = 'length'
            return True
        return False

    def _collect_step(self) -> None:
        """Collect half: wait on the OLDEST call's event (never a
        blocking tensor read) and do the bookkeeping. Rows that finish
        mid-chunk leave the device ``last`` at the chunk's final token:
        ``_fix_last`` re-pins it to the host mirror. One speculation
        cooldown tick per collected call."""
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
                # was dispatched before the finish was known; prefilling
                # rows were masked too: their outputs are not consumed.
                continue
            for t in range(h.k):
                tok = int(toks[t, i])
                self.last[i] = tok
                if self._commit(s, tok, float(lps[t, i]),
                                _tops_list(tis[t, i], tvs[t, i])
                                if h.want_tops else []):
                    break
            if s['finish'] is not None:
                fixups.append(i)
        if fixups:
            self._fix_last(h.stage, fixups)
        if self._spec_cool > 0:
            self._spec_cool -= 1

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

    # -- speculative decoding --------------------------------------------------
    def _spec_precheck(self) -> bool:
        """The cheap host-only preconditions of a speculative round:
        speculation on, warm, no cooldown, some active row, every active
        row greedy and no penalties anywhere."""
        if self.spec_k <= 0 or not self.warm or self._spec_cool > 0:
            return False
        active = [i for i, s in enumerate(self.slots) if self._row_active(s)]
        if not active or any(self.temp[i] > 0 for i in active):
            return False
        return not (self.pres.any() or self.freq.any())

    def _spec_once(self) -> bool:
        """Try ONE speculative round at a drained point; False: the
        caller runs a fused call instead. Each active row drafts from
        its own context (a row without a draft feeds its ``last`` and
        commits one token, the correction); one verify call; each row
        commits its accepted run plus the correction, ``length``
        advances by what was committed and ``last`` is re-pinned, both
        through the pinned stage. Outputs are the greedy decode's:
        acceptance only changes how many tokens a call commits. No
        draft anywhere, or a row without K positions of headroom,
        pauses speculation for SPEC_NO_DRAFT_COOLDOWN calls; a round
        accepting under SPEC_MIN_ACCEPT of its proposals for
        ``spec_cooldown``."""
        if self._inflight or not self._spec_precheck():
            return False
        k = self.spec_k
        active = [i for i, s in enumerate(self.slots) if self._row_active(s)]
        drafts, real_len = {}, {}
        for i in active:
            ctx = self.slots[i]['ctx']
            if len(ctx) - 1 + k > self.max_len:
                drafts = {}
                break
            d = _lookup_draft(ctx, k)
            if d:
                real_len[i] = len(d)
                drafts[i] = (d + [0] * k)[:k]
        if not drafts:
            self._spec_cool = SPEC_NO_DRAFT_COOLDOWN
            return False
        st = self._spec_stage
        block = st.ctrl.numpy()
        block[:k + 1] = 0
        for i in active:
            block[0, i] = self.last[i]
            block[1:k, i] = (drafts[i][:k - 1] if i in drafts
                             else [self.last[i]] * (k - 1))
            block[k, i] = 1
        want_tops = any(self.slots[i]['req'].want_tops for i in active)
        self._refresh_table()
        self._spec_dev[:k + 1].copy_(st.ctrl[:k + 1], non_blocking=True)
        self._variant(('verify', want_tops))()
        self.verify_calls[want_tops] += 1
        st.toks.copy_(self._ver_toks, non_blocking=True)
        st.lps.copy_(self._ver_lps, non_blocking=True)
        if want_tops:
            st.tis.copy_(self._ver_tis, non_blocking=True)
            st.tvs.copy_(self._ver_tvs, non_blocking=True)
        event = self._record()
        if event is not None:
            event.synchronize()
        greedy, lps = st.toks.numpy().copy(), st.lps.numpy().copy()
        if want_tops:
            tis, tvs = st.tis.numpy().copy(), st.tvs.numpy().copy()
        self.step_count += 1
        self.spec_rounds += 1
        adv = np.zeros(self.max_batch, np.int32)
        round_prop = round_acc = 0
        for i in active:
            s = self.slots[i]
            prop = drafts.get(i, [int(self.last[i])] * k)
            a = 0
            while a < k and prop[a] == int(greedy[i, a]):
                a += 1
            if i in drafts:
                round_prop += real_len[i]
                round_acc += min(a, real_len[i])
            row = prop[:a] + [int(greedy[i, a])] if a < k else prop[:k]
            # The fed tokens' K/V for row[:-1] were written; row[-1] is
            # the new last, whose K/V the next call writes.
            adv[i] = len(row)
            self.last[i] = row[-1]
            for j, tok in enumerate(row):
                if s['finish'] is not None or self._commit(
                        s, tok, float(lps[i, j]),
                        _tops_list(tis[i, j], tvs[i, j])
                        if want_tops else []):
                    break
        block[k + 1] = adv
        block[k + 2] = 0
        block[k + 2, active] = 1
        block[k + 3] = self.last
        self._spec_dev[k + 1:].copy_(st.ctrl[k + 1:], non_blocking=True)
        self.cache.length += self._spec_dev[k + 1]
        self.last_dev.copy_(torch.where(self._spec_dev[k + 2] > 0,
                                        self._spec_dev[k + 3],
                                        self.last_dev))
        self.spec_proposed += round_prop
        self.spec_accepted += round_acc
        if round_prop and round_acc < SPEC_MIN_ACCEPT * round_prop:
            self._spec_cool = self.spec_cooldown
        return True

    def _step_or_dispatch(self, k: int) -> Optional[_InFlightStep]:
        """A speculative round when it applies (then None), else a
        dispatch returning the in-flight handle."""
        if self._spec_once():
            return None
        return self._dispatch_step(k)

    def _step_once(self, k_force: Optional[int] = None,
                   want_tops_force: Optional[bool] = None) -> None:
        """Synchronous round: a speculative one when it applies, else a
        dispatch + collect (warm-up and tests; the batch loop pipelines
        through ``_step_round``)."""
        if self._spec_once():
            return
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
            if 't_first' in s:          # not a row cancelled mid-prefill
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
        device (prefilling ones too) and the group being admitted, drop
        the calls in flight, then reset device state. Requests still
        queued or held are untouched."""
        logger.error('engine step/admit failed; resetting: %s\n%s', err,
                     traceback.format_exc())
        reqs = [s['req'] for s in self.slots if s is not None]
        seen = {id(r) for r in reqs}
        reqs += [r for r in extra if id(r) not in seen]
        self._reset_device_state()
        for req in reqs:
            if req.future is not None and not req.future.done():
                req.future.set_exception(err)
            if req.stream is not None:
                req.stream.put(None)

    def _admit_pending(self) -> None:
        """Admit what fits: grouped prefills first, then the chunked
        starts."""
        items = self._drain_admissible()
        grouped = [r for r in items if not self._should_chunk(r)]
        chunked = [r for r in items if self._should_chunk(r)]
        for group in self._admit_groups(grouped):
            try:
                self._admit_group(group)
            except Exception as e:  # pylint: disable=broad-except
                self._fail(e, group)
        for req in chunked:
            try:
                self._start_chunked(req)
            except Exception as e:  # pylint: disable=broad-except
                self._fail(e, [req])

    def warmup(self) -> None:
        """Build the device state, then run the whole variant matrix —
        k ∈ {1, MAX_STEP_CHUNK} × penalties × top logprobs, the only
        calls ``_dispatch_step`` can make — through the real
        dispatch/collect path on one admitted request, and both verify
        variants with no row active, capturing each on the card; then
        free the slot (no page leaks), empty the prefix store, reset
        the counters and flip ``warm`` (``/health`` answers 200). A
        capture that fails raises."""
        self._ensure_state()
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
        if self.spec_k > 0:
            self._refresh_table()
            for want_tops in (False, True):
                self._spec_dev[:self.spec_k + 1].zero_()
                self._variant(('verify', want_tops))()
        self._drop_all_slots()
        self._clear_prefix_store()
        self.cache.length.zero_()
        self.last_dev.zero_()
        self.counts.zero_()
        self.last[:] = 0
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        self.timings.clear()
        self.calls.clear()
        self.verify_calls.clear()
        self.step_count = 0
        self.prefix_hits = self.prefill_chunks = 0
        self.spec_rounds = self.spec_proposed = self.spec_accepted = 0
        self._spec_cool = 0
        self.warm = True

    def _step_round(self) -> None:
        """One scheduling round of device work: a speculative round when
        it applies, else pipelined — dispatch call N, then, while
        ``_lookahead_k`` allows, dispatch call N+1 BEFORE collecting
        call N, publishing after every collect."""
        inflight = self._step_or_dispatch(self._choose_k())
        if inflight is None:
            return
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
        free, advance one pending chunk a round, step while anything is
        active, publish after each. A failure outside the contained
        admit/chunk/step (warm-up included) is kept in ``loop_error``
        and ``/health`` answers 500."""
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
            pending = self._pending_chunks()
            if pending:
                # One chunk a round, round-robin over the prefilling
                # rows: decoding rows keep decoding between chunks.
                slot = pending[self._chunk_rr % len(pending)]
                self._chunk_rr += 1
                try:
                    self._advance_chunk(slot)
                except Exception as e:  # pylint: disable=broad-except
                    self._fail(e, [])
                    continue
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


def _parse_logprobs(body, chat: bool = False) -> Tuple[bool, int]:
    """OpenAI logprobs → (want_logprobs, top_n). Completions:
    ``logprobs: N`` (0..TOP_LOGPROBS_K), chosen-token logprobs plus N
    alternatives per position, boolean true meaning N = 0. Chat:
    ``logprobs: true`` and an optional ``top_logprobs: N``."""
    lp = body.get('logprobs')
    if lp is None or lp is False:
        if chat and int(body.get('top_logprobs') or 0) > 0:
            raise ValueError('top_logprobs requires logprobs=true')
        return False, 0
    if chat:
        if lp is not True:
            raise ValueError('chat logprobs must be a boolean')
        top_n = int(body.get('top_logprobs') or 0)
    else:
        top_n = 0 if lp is True else int(lp)
    if top_n < 0:
        raise ValueError('logprobs/top_logprobs must be >= 0')
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


def _refuse_fanout(body, chat: bool = False) -> None:
    """``n`` > 1 and ``best_of`` > 1 wait for a later slice; chat has no
    ``best_of`` at all, as in JAX."""
    if chat and body.get('best_of') is not None:
        raise ValueError('best_of is not supported on /v1/chat/completions')
    for field in ('n', 'best_of'):
        val = body.get(field)
        if val is not None and int(val) != 1:
            raise ValueError(f'{field} > 1 is not supported by this engine '
                             f'yet')


def _completion_chunks(meta, top_n: int, tokenizer):
    """The SSE payloads of one /v1/completions choice:
    ``make(delta, finish, first=False, lp=None)`` yields the events for
    one token's text (with its logprob info), the finish, or the stream's
    opening (none)."""
    def make(delta, finish, first=False, lp=None):
        if first:
            return
        lp_obj = None
        if lp is not None:
            piece, lpv, tops, off = lp
            lp_obj = {'tokens': [piece], 'token_logprobs': [round(lpv, 6)],
                      'top_logprobs': [
                          {tokenizer.decode([i]): round(v, 6)
                           for i, v in tops}] if top_n else None,
                      'text_offset': [off]}
        yield {**meta, 'choices': [
            {'text': delta or '', 'index': 0, 'logprobs': lp_obj,
             'finish_reason': finish}]}
    return make


def _chat_chunks(meta, top_n: int, tokenizer):
    """The SSE payloads of one /v1/chat/completions choice (JAX
    ``openai_chat``'s ``make_chunks``): the opening delta with the role,
    a content delta per token (chat-format logprobs), then an empty
    delta with the finish reason."""
    def make(delta, finish, first=False, lp=None):
        if first:
            yield {**meta, 'choices': [{
                'index': 0, 'delta': {'role': 'assistant', 'content': ''},
                'finish_reason': None}]}
            return
        if delta is not None or lp is not None:
            lp_obj = None
            if lp is not None:
                piece, lpv, tops, _ = lp
                lp_obj = {'content': [{
                    'token': piece, 'logprob': round(lpv, 6),
                    'top_logprobs': [
                        {'token': tokenizer.decode([i]),
                         'logprob': round(v, 6)}
                        for i, v in tops] if top_n else None}]}
            yield {**meta, 'choices': [{
                'index': 0, 'delta': {'content': delta or ''},
                'logprobs': lp_obj, 'finish_reason': None}]}
        if finish is not None:
            yield {**meta, 'choices': [{
                'index': 0, 'delta': {}, 'finish_reason': finish}]}
    return make


def _chat_logprobs(tokenizer, out, lps, text, tops, top_n: int) -> dict:
    """Chat-format logprobs of a whole answer: content entries of
    {token, logprob, top_logprobs}, trimmed to the returned text."""
    flat = _completion_logprobs(tokenizer, out, lps, text,
                                tops=[t[:top_n] for t in tops]
                                if top_n else None)
    content = []
    for j, (p, v) in enumerate(zip(flat['tokens'], flat['token_logprobs'])):
        entry = {'token': p, 'logprob': v}
        if top_n:
            entry['top_logprobs'] = [{'token': tt, 'logprob': tv} for tt, tv
                                     in flat['top_logprobs'][j].items()]
        content.append(entry)
    return {'content': content}


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


def _usage(tokens: List[int], out: List[int]) -> Dict[str, int]:
    return {'prompt_tokens': len(tokens), 'completion_tokens': len(out),
            'total_tokens': len(tokens) + len(out)}


def build_app(engine: InferenceEngine, host: str = '127.0.0.1',
              port: int = 0) -> ThreadingHTTPServer:
    """A ThreadingHTTPServer bound to (host, port) serving ``/health``,
    ``/generate``, ``/v1/completions`` and ``/v1/chat/completions``
    (JSON or SSE) and ``/v1/models``;
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
                return self._chat()
            return self._json(404, {'error': 'not found'})

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
            meta = {'id': f'cmpl-{time.time_ns()}',
                    'object': 'text_completion', 'created': int(time.time()),
                    'model': body.get('model', engine.model_name)}
            got = self._submit(body, tokens, max_new, sampling, stop_ids,
                               want_logprobs and top_n > 0)
            if got is None:
                return None
            fut, stream = got
            if stream is not None:
                return self._sse(fut, stream, stops, want_logprobs, top_n,
                                 _completion_chunks(meta, top_n,
                                                    engine.tokenizer))
            res = self._result(fut, stops)
            if res is None:
                return None
            out, finish, lps, tops, text = res
            lp_obj = None
            if want_logprobs:
                lp_obj = _completion_logprobs(
                    engine.tokenizer, out, lps, text,
                    tops=[t[:top_n] for t in tops] if top_n else None)
            return self._json(200, {**meta, 'choices': [
                {'text': text, 'index': 0, 'logprobs': lp_obj,
                 'finish_reason': finish}],
                'usage': _usage(tokens, out)})

        def _chat(self) -> None:
            """OpenAI chat completions (JAX ``openai_chat``): the
            messages templated for the tokenizer's chat family, encoded
            with add_special_tokens=False (the template carries its
            specials); max_tokens or max_completion_tokens (default
            256), temperature (default 1.0), top_k, top_p, penalties,
            logprobs=true with top_logprobs <= 5, stop, stop_token_ids,
            ignore_eos and stream (SSE)."""
            try:
                body = self._body()
                prompt = tokenizer_lib.apply_chat_template(
                    body.get('messages'), engine.tokenizer.chat_family)
                tokens = [int(t) for t in engine.tokenizer.encode(
                    prompt, add_special_tokens=False)]
                if not tokens:
                    raise ValueError('empty prompt after templating')
                max_new = int(body.get('max_tokens',
                                       body.get('max_completion_tokens',
                                                256)))
                if max_new < 1:
                    raise ValueError('max_tokens must be >= 1')
                sampling = _parse_sampling(body, default_temperature=1.0)
                stop_ids = _parse_stop_ids(body, engine.tokenizer)
                stops = _stop_list(body.get('stop'))
                want_logprobs, top_n = _parse_logprobs(body, chat=True)
                _refuse_fanout(body, chat=True)
            except (TypeError, ValueError) as e:
                return self._openai_error(f'invalid request: {e}')
            meta = {'id': f'chatcmpl-{time.time_ns()}',
                    'object': 'chat.completion', 'created': int(time.time()),
                    'model': body.get('model', engine.model_name)}
            got = self._submit(body, tokens, max_new, sampling, stop_ids,
                               want_logprobs and top_n > 0)
            if got is None:
                return None
            fut, stream = got
            if stream is not None:
                return self._sse(fut, stream, stops, want_logprobs, top_n,
                                 _chat_chunks({**meta, 'object':
                                               'chat.completion.chunk'},
                                              top_n, engine.tokenizer))
            res = self._result(fut, stops)
            if res is None:
                return None
            out, finish, lps, tops, text = res
            lp_obj = (_chat_logprobs(engine.tokenizer, out, lps, text, tops,
                                     top_n) if want_logprobs else None)
            return self._json(200, {**meta, 'choices': [
                {'index': 0, 'message': {'role': 'assistant',
                                         'content': text},
                 'logprobs': lp_obj, 'finish_reason': finish}],
                'usage': _usage(tokens, out)})

        def _submit(self, body, tokens, max_new, sampling, stop_ids,
                    want_tops: bool):
            """Check the length and enqueue: (future, the token queue
            when streaming, else None), or None after answering 400 or
            429."""
            msg = engine.check_len(tokens, max_new)
            if msg:
                return self._openai_error(msg)
            stream = queue.Queue() if body.get('stream') else None
            try:
                fut = engine.submit(tokens, max_new, *sampling,
                                    stop_ids=stop_ids, want_tops=want_tops,
                                    stream=stream)
            except EngineOverloaded as e:
                return self._openai_error(str(e), status=429,
                                          err_type='overloaded_error')
            return fut, stream

        def _result(self, fut, stops: List[str]):
            """A finished request's (tokens, finish, logprobs, tops,
            text cut at the first stop string), or None after answering
            503."""
            try:
                out, finish, lps, tops = fut.result()
            except Exception as e:  # pylint: disable=broad-except
                return self._openai_error(f'engine failure: {e}', 503,
                                          'server_error')
            text = engine.tokenizer.decode(out)
            cut = _stop_scan(text, stops)
            if cut is not None:
                text, finish = text[:cut], 'stop'
            return out, finish, lps, tops, text

        # -- SSE ------------------------------------------------------------
        def _chunk(self, data: bytes) -> None:
            self.wfile.write(b'%x\r\n%s\r\n' % (len(data), data))

        def _event(self, payload) -> None:
            self._chunk(b'data: ' + json.dumps(payload).encode() + b'\n\n')

        def _sse(self, fut, stream: 'queue.Queue', stops: List[str],
                 want_logprobs: bool, top_n: int, make_chunks) -> None:
            """Stream one choice as server-sent events over chunked
            transfer: ``make_chunks``' opening events, its events for
            each token (with its logprob info when asked), its final
            events with the finish_reason, then ``data: [DONE]``. Stop
            strings are held back by len(longest) - 1 characters so a
            match split across tokens never leaks; on a match the
            request is cancelled. A failed write (the client went away)
            cancels it too."""
            hold = max((len(s) for s in stops), default=0) - 1
            st = _SseState(engine.tokenizer)
            self.close_connection = True

            def send(text, lp=None, finish=None, first=False) -> None:
                for payload in make_chunks(text, finish, first=first,
                                           lp=lp):
                    self._event(payload)

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
                send(None, finish=finish)

            try:
                self.send_response(200)
                self.send_header('Content-Type', 'text/event-stream')
                self.send_header('Cache-Control', 'no-cache')
                self.send_header('Transfer-Encoding', 'chunked')
                self.end_headers()
                try:
                    send(None, first=True)
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
    parser.add_argument('--model', default=None,
                        help='Preset name (skypilot_tpu_torch.config); '
                             'llama-1b unless --hf-dir is given.')
    parser.add_argument('--ckpt-dir', default=None,
                        help="A checkpoint of the port's trainer to serve "
                             '(its params; --model names its config).')
    parser.add_argument('--hf-dir', default=None,
                        help='An HF checkpoint directory (safetensors + '
                             'tokenizer.json) to serve.')
    parser.add_argument('--tokenizer', default=None,
                        help='A tokenizer.json (overrides the one in '
                             '--hf-dir).')
    parser.add_argument('--max-len', type=int, default=None)
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (default) or 'cpu'.")
    parser.add_argument('--seed', type=int, default=0,
                        help='Seed of the random weights and the sampler.')
    parser.add_argument('--quantize', choices=['int8'], default=None,
                        help='Weight-only int8 (the dense Llama and MLA '
                             'families).')
    parser.add_argument('--port', type=int, default=8300)
    parser.add_argument('--host', default='0.0.0.0')
    return parser


def main(argv: Optional[List[str]] = None) -> None:
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)
    engine = InferenceEngine(
        args.model or (None if args.hf_dir else 'llama-1b'),
        ckpt_dir=args.ckpt_dir, hf_dir=args.hf_dir,
        tokenizer_path=args.tokenizer, max_len=args.max_len,
        device=args.device, seed=args.seed, quantize=args.quantize)
    server = build_app(engine, args.host, args.port)
    engine.start()
    try:
        server.serve_forever()
    finally:
        server.server_close()
        engine.stop()


if __name__ == '__main__':
    main()
