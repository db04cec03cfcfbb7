"""The inference engine and its HTTP surface (a reduced port of
skypilot_tpu/serve/engine.py: ``InferenceEngine`` with its fused k-step
decode, ``_InFlightStep``, ``_dispatch_step`` / ``_collect_step``,
``_choose_k`` / ``_lookahead_k``, the admission path with chunked
prefill and the shared-page prefix cache, prompt-lookup speculative
decoding (``_lookup_draft``, ``_spec_once``), ``_publish``, ``cancel``,
``batch_loop`` / ``_step_round``, ``warmup``; ``build_app``'s
``/health``, ``/generate``, ``/v1/completions`` with SSE and
``/v1/models``; ``parse_mesh_arg``, ``_setup_mesh`` over 'expert' and
'tensor', ``_bcast``, ``_page_fp`` / ``_check_page_fp``; ``main`` with
its gang flags).

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

A replica behind the serve plane (the JAX engine's surface): ``GET
/health`` and ``GET /`` answer 503 while warming, 500 after a loop
error and 200 with the saturation doc (queue depth, in-flight rows,
free pages); ``GET /metrics`` renders every ``skytpu_engine_*`` family
of the JAX engine whose feature the port has, from the engine's own
registry (observe/metrics.py); ``GET /debug/flight?limit=N`` dumps the
flight ring (observe/flight.py: dispatch, collect, admit, finish,
spec, reset, cancel and chunk events). The request class comes from
``X-Skytpu-Class`` (observe/request_class.py) and goodput is counted
per class at publish. A failed admit, chunk, step or collect is
contained as in JAX ``_fail_all``: rows that finished resolve, requests
that never sampled go back to the front of the hold queue (at most
``SKYTPU_ENGINE_RESURRECT_MAX`` times), and only rows that had emitted
tokens fail, with the retriable :class:`EngineResetError` (a structured
503 over HTTP); the device state is zeroed in place, so the captured
graphs replay after a reset with no recapture. A sticky CUDA fault is
not contained: the reset itself raises, the loop dies and ``/health``
answers 500, and the replica manager restarts the replica. Failpoint
sites (utils/failpoints.py) sit at JAX's points: ``engine.admit``,
``engine.step`` and ``engine.collect``. ``/v1/completions`` takes
``n``, ``best_of`` (candidates ranked by mean token logprob) and
batched prompts; chat takes ``n``.

int8 K/V pools (the JAX engine's ``SKYTPU_ENGINE_KV_QUANT=int8``,
``kv_quant``): the pool holds int8 codes and fp32 scale sidecars
(models/paging.py), about half the bytes a page at head_dim 128; every
path above quantizes where it writes and dequantizes where it reads, the
sidecars captured with the pools into the step and verify graphs. Kernel
B declines int8 pools, as JAX's Pallas kernel does, so their steps run
the fused in-place formulation on the card too; prefill still runs
kernel A. ``/health`` names ``kv_quant``, and
``skytpu_engine_kv_pages_quantized`` counts the pool's pages.

The KV memory hierarchy (the JAX engine's): with
``SKYTPU_ENGINE_KV_HOST_MB`` > 0 a prefix entry that page pressure or
the LRU bound evicts, or that sat unused for
``SKYTPU_ENGINE_KV_IDLE_SPILL_S`` seconds (the sweep at the loop's
drained points), spills: its pages are exported (models/paging.py
``export_pages``) into the host tier (serve/host_store.py) and the
device refs freed. A spilled key still counts as a prefix hit: the
admission wakes it into fresh pages (``import_pages``) and extends it as
any hit. ``kv_spill`` and ``kv_wake`` land in the event journal
(observe/journal.py), and a failure reset snapshots the flight ring
there too.

Disaggregated prefill/decode (the JAX engine's): ``POST
/disagg/prefill?orig=<endpoint>`` prefills a request (kernel A on the
card) and samples its first token, exports the row (``gather_prefix``
of its bucket), finishes it with reason ``'handoff'`` (its pages free
at the next publish) and ships the rows and the sampler state to the
decode replica named by ``X-Skytpu-Handoff-Target``
(serve/disagg/handoff.py); that replica's framed-TCP receiver (on
``handoff_port``: ``--handoff-port``, by default the HTTP port + 1000)
stages it, and ``POST /disagg/continue?orig=<endpoint>`` adopts the
rows into pages of its own allocator (``paging.adopt_rows``) and decodes
in the captured step graphs (kernel B) like any other row, answering in
the original endpoint's shape, SSE included.

One replica over a gang of ranks (the JAX engine's multi-host serving,
serve/multihost.py): ``--mesh expert=E,tensor=T --num-processes E*T
--process-id R --coordinator HOST:PORT`` (the gang flags default from
the gang env) runs one process a rank, each holding its shard of the
model as the family's ``param_axes`` (the JAX ``param_specs``) lays it
out (``_setup_mesh``: parallel/sharding.py ``shard_params``): the dense
and MoE families' heads, kv heads, hidden units and vocabulary over
'tensor' and the MoE experts over 'expert' (a dense model is whole on
every 'expert' index), the MLA family's heads over 'tensor' with the
latent whole. A K/V pool holds the rank's KH/T kv heads, so kernels A
and B run at H/T q heads and KH/T kv heads on every rank; a latent pool
is whole on every rank (no kernel runs there). Rank
0 answers HTTP and broadcasts every device-touching op before it runs it
(``_bcast``: warmup, admit, chunkstart, chunk, spill, step, collect,
reap, cancel, reset, stop); the followers replay each op through the
same methods. On a tensor mesh the step and verify bodies run eagerly,
decided at construction: gloo's collectives cannot be captured into a
CUDA graph (capturing NCCL's waits for ROADMAP Queue 1 item 8).

The JAX engine's two other K/V layouts, for every family (``paged``,
``attn_backend``; tests may set them before warm-up):
  - ``SKYTPU_ENGINE_PAGED=0``: contiguous ``[L, MAX_BATCH, max_len]``
    slabs (models/decode.py ``init_cache``, models/mla.py's): no
    allocator, no table, no host tier; a grouped prefill writes its
    rows into ``cache[:, slots]``, nothing chunks (a long prompt takes
    one bucket prefill through kernel A), a prefix snapshot is a copy
    of the slot's first p positions (``.clone()``: a slice of the slab
    would be overwritten by the slot's next occupant) and a hit
    extends over it with ``prefill_extend``; the steps and the verify
    are the contiguous ``decode_step`` / ``verify_step`` on the slab;
    disaggregated serving answers "requires paged mode";
  - ``SKYTPU_ENGINE_ATTN=gather``: the paged pool, but every step and
    verify call materializes the per-row view (models/paging.py
    ``gather_view``), runs the contiguous step math on it and writes
    the stepped positions back (``scatter_steps``); an extend reads its
    prefix with ``gather_prefix`` and writes its suffix with
    ``scatter_suffix``.
Both run the plain attention in every step (JAX's contiguous step is
``impl='xla'``), never kernel B; kernel A still runs every grouped
prefill. Their step and verify bodies are CUDA graphs as the fused
ones are, the same control block, outputs and generator draws.

The knobs are the JAX engine's, read under its names and defaults
(utils/knobs.py). ``SKYTPU_ENGINE_PAGED=0`` or
``SKYTPU_ENGINE_ATTN=gather`` beside ``SKYTPU_ENGINE_KV_QUANT=int8`` is
the JAX engine's ValueError. What waits is refused by name: request
spans (ROADMAP Queue 1 item 4) and, on a serving mesh (item 8), the
'data', 'fsdp', 'stage' and 'sequence' axes, a mesh in one process (one
process holds one rank), a layout other than the fused paged pool and
disaggregated serving on a gang; int8 weights of the MoE family are
refused on any mesh, as in JAX.

The HTTP server is the standard library's ThreadingHTTPServer; the
batch loop runs in its own thread and owns all device state. Request
handlers only enqueue and wait on a concurrent.futures.Future or, when
streaming, a per-request queue.

    SKYTPU_ENGINE_STEP_CHUNK=8 python -m skypilot_tpu_torch.serve.engine \\
        --model llama-1b --port 8300
    SKYTPU_ENGINE_PAGED=0 python -m skypilot_tpu_torch.serve.engine \\
        --model llama-1b     # the contiguous slabs
    SKYTPU_ENGINE_ATTN=gather python -m skypilot_tpu_torch.serve.engine \\
        --model llama-1b     # the gather view baseline
    python -m skypilot_tpu_torch.serve.engine --model gpt-oss-20b
    python -m skypilot_tpu_torch.serve.engine --model deepseek-v2-lite
    python -m skypilot_tpu_torch.serve.engine --model llama3.2-1b \\
        --ckpt-dir ./ck      # a trainer checkpoint (e.g. from --hf-dir)
    python -m skypilot_tpu_torch.serve.engine --hf-dir ./Llama-3.2-1B
    # a decode replica (handoff receiver on 9300) and a prefill replica:
    python -m skypilot_tpu_torch.serve.engine --port 8300 --handoff-port 9300
    python -m skypilot_tpu_torch.serve.engine --port 8301 --handoff-port 0
    # one replica over two ranks (SKYTPU_MH_TOKEN set in both; two ranks
    # sharing one card also need SKYTPU_TORCH_DIST_BACKEND=gloo):
    python -m skypilot_tpu_torch.serve.engine --model llama-1b \
        --mesh tensor=2 --num-processes 2 --process-id R \
        --coordinator 127.0.0.1:29500
    # the MoE family over four ranks, two expert groups of two:
    python -m skypilot_tpu_torch.serve.engine --model moe-1b \
        --mesh expert=2,tensor=2 --num-processes 4 --process-id R \
        --coordinator 127.0.0.1:29500
"""
from __future__ import annotations

import argparse
import collections
import concurrent.futures
import contextlib
import dataclasses
import json
import logging
import math
import os
import queue
import signal
import threading
import time
import traceback
import urllib.parse
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
from skypilot_tpu_torch.models import (decode, hf_import, llama, mla,
                                       module_for, paging)
from skypilot_tpu_torch.observe import flight as flight_lib
from skypilot_tpu_torch.observe import journal
from skypilot_tpu_torch.observe import metrics as metrics_lib
from skypilot_tpu_torch.observe import request_class
from skypilot_tpu_torch.ops import paged_attention
from skypilot_tpu_torch.parallel import mesh as mesh_lib
from skypilot_tpu_torch.parallel import sharding
from skypilot_tpu_torch.serve import multihost
from skypilot_tpu_torch.serve.disagg import handoff as handoff_lib
from skypilot_tpu_torch.serve.host_store import HostPageStore
from skypilot_tpu_torch.train import checkpoints
from skypilot_tpu_torch.utils import failpoints
from skypilot_tpu_torch.utils import framed
from skypilot_tpu_torch.utils import knobs

logger = logging.getLogger(__name__)

# The JAX engine's knobs, under its names and with its defaults
# (utils/knobs.py), read at import as JAX reads them. Each is an
# instance attribute too, which tests may set before warm-up.
# Decode slots, tokens per KV page (a power of two dividing
# PREFIX_MIN_TOKENS), and the bounded admission queue (overflow: 429).
MAX_BATCH = knobs.get_int('SKYTPU_ENGINE_MAX_BATCH')
PAGE_SIZE = knobs.get_int('SKYTPU_ENGINE_PAGE_SIZE')
MAX_QUEUE = knobs.get_int('SKYTPU_ENGINE_MAX_QUEUE')
# Times a request that never sampled a token is resubmitted after a
# failure reset before it fails: an admission that faults every time
# must surface an error, not loop.
RESURRECT_MAX = knobs.get_int('SKYTPU_ENGINE_RESURRECT_MAX')
# Decode steps fused into one device call when no request waits to join
# (the JAX knob of the same name): the two step widths are 1 and this.
MAX_STEP_CHUNK = knobs.get_int('SKYTPU_ENGINE_STEP_CHUNK')
# Top-N alternative logprobs computed per token (OpenAI ``logprobs=N``):
# only in the step variants some active row asked for, always at admit.
TOP_LOGPROBS_K = 5
# Rows of the per-call control block the host uploads: active, then the
# sampler's temperature, top_k, top_p, presence and frequency.
CTRL_ROWS = 6
# Calls in flight at most (one collected while the next one runs).
MAX_INFLIGHT = 2
# Prefix cache: LRU entries (0 disables). A prompt sharing a snapshotted
# prefix prefills only its suffix, over the snapshot's own pages.
PREFIX_CACHE_ENTRIES = knobs.get_int('SKYTPU_ENGINE_PREFIX_CACHE')
# The device pages' representation: 'none' (JAX's default) keeps the
# pools in the compute dtype; 'int8' stores per-vector int8 codes with
# fp32 scale sidecars (models/paging.py), ~2x the pages per byte of
# the card's memory, decode allclose to the fp pools.
KV_QUANT = knobs.get_enum('SKYTPU_ENGINE_KV_QUANT')
# Prompts shorter than this are never snapshotted; snapshots are powers
# of two, so the page size must divide it.
PREFIX_MIN_TOKENS = 64
# Speculative decoding: tokens proposed per verify round (0 disables).
SPEC_K = knobs.get_int('SKYTPU_ENGINE_SPEC_K')
# Longest n-gram of the row's own context matched when drafting, and the
# trailing window scanned (host-side Python on the decode loop).
SPEC_NGRAM = 3
SPEC_LOOKUP_WINDOW = 512
# A round accepting under SPEC_MIN_ACCEPT of its real proposals pauses
# speculation for SPEC_COOLDOWN collected calls; a probe that finds no
# draft (or a row without verify headroom) for SPEC_NO_DRAFT_COOLDOWN.
SPEC_MIN_ACCEPT = 0.25
SPEC_COOLDOWN = knobs.get_int('SKYTPU_ENGINE_SPEC_COOLDOWN')
SPEC_NO_DRAFT_COOLDOWN = 4
# Pool pages, the trash page included; 0: every slot's worst case plus
# the prefix cache's headroom.
KV_PAGES = knobs.get_int('SKYTPU_ENGINE_KV_PAGES')
# Prompts longer than this prefill in chunks of this many tokens (a power
# of two >= 16), one chunk per scheduling round.
PREFILL_CHUNK = knobs.get_int('SKYTPU_ENGINE_PREFILL_CHUNK')
# The host spill tier: prefix entries idle this long spill at the batch
# loop's drained points (0: no idle sweep; pressure and the LRU bound
# still spill while the tier is on), and its byte budget (0: no tier,
# an evicted entry just drops).
KV_IDLE_SPILL_S = knobs.get_float('SKYTPU_ENGINE_KV_IDLE_SPILL_S')
KV_HOST_MB = knobs.get_int('SKYTPU_ENGINE_KV_HOST_MB')
# Disagg markers and export blobs kept at most (a backlog that outgrows
# them loses its oldest, as in JAX).
MAX_MARKS = 4096
MAX_EXPORTS = 256
# The instance knobs that steer the op stream of a gang: the leader ships
# its values in the warmup op and every follower takes them, so that an
# env skew across hosts cannot split the pool layout or the step widths.
MIRRORED_KNOBS = ('max_batch', 'page_size', 'kv_pages', 'step_chunk',
                  'prefix_cache', 'spec_k', 'spec_cooldown', 'prefill_chunk',
                  'kv_host_mb')
# A serving mesh shards over 'expert' and 'tensor' in this port.
WAITING_MESH_AXES = ('data', 'stage', 'fsdp', 'sequence')


def parse_mesh_arg(mesh: str) -> mesh_lib.MeshSpec:
    """'tensor=8' / 'data=2,tensor=4' → MeshSpec (the --mesh flag; the
    JAX engine's parser)."""
    kwargs = {}
    for part in mesh.split(','):
        if not part:
            continue
        if '=' not in part:
            raise ValueError(f"--mesh entries are axis=N, got {part!r}")
        k, v = part.split('=', 1)
        kwargs[k.strip()] = int(v)
    try:
        return mesh_lib.MeshSpec(**kwargs)
    except TypeError as e:
        raise ValueError(f'bad --mesh axis name: {e}') from None


def check_serving_mesh(cfg: LlamaConfig, shape: Dict[str, int]) -> None:
    """Refuse by name what a serving mesh cannot do here yet (each
    waits for ROADMAP Queue 1 item 8), then the family's JAX
    divisibility check (``validate_divisibility`` of ``module_for``):
    ``shape`` maps axes to sizes (-1: filled from the world later)."""
    for ax in WAITING_MESH_AXES:
        if shape.get(ax, 1) > 1:
            raise NotImplementedError(
                f"--mesh {ax}={shape[ax]}: serving over the {ax!r} axis is "
                f"not ported yet; the port's engine shards over 'expert' "
                f"and 'tensor' only (it waits for ROADMAP Queue 1 item 8)")
    module_for(cfg).validate_divisibility(cfg, shape)


class EngineOverloaded(Exception):
    """The bounded admission queue is full (answered with 429)."""


class EngineResetError(Exception):
    """A device admit/step serving this request failed and the device
    state was rebuilt after it had emitted tokens (the JAX class of the
    same name). Structured and retriable: the engine serves again, and
    ``tokens_emitted`` tells a streaming client how many tokens it
    already holds. Answered with a 503 of type ``engine_reset_error``,
    ``retriable: true`` and ``Retry-After: 1``."""

    def __init__(self, msg: str, tokens_emitted: int = 0):
        super().__init__(msg)
        self.tokens_emitted = tokens_emitted
        self.retriable = True


# Latency histogram buckets of the JAX engine (seconds).
_TTFT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
                 10.0, 30.0, 60.0)
_TPOT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                 0.25, 0.5, 1.0, 2.5)
_WAIT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)
# The attention backends the gauge labels (the JAX label set).
ATTN_BACKENDS = ('fused', 'pallas', 'gather')


class EngineMetrics:
    """The JAX engine's ``skytpu_engine_*`` families, under the same
    names, types, labels and buckets, in one registry per engine (so
    two engines in one process never share a count)."""

    def __init__(self):
        reg = self.registry = metrics_lib.Registry()
        self.step_seconds = reg.histogram(
            'skytpu_engine_step_seconds',
            'Decode-step latency by pipeline phase (dispatch = host time '
            'to enqueue the fused device call, collect = transfer + '
            'bookkeeping)', labels={'phase': ('dispatch', 'collect')})
        self.admit_seconds = reg.histogram(
            'skytpu_engine_admit_seconds',
            'Grouped-prefill admission latency (one device call per '
            'group)')
        self.host_sync_seconds = reg.histogram(
            'skytpu_engine_host_sync_seconds',
            'Time the decode loop blocks on device→host transfers')
        self.queue_depth = reg.gauge(
            'skytpu_engine_queue_depth',
            'Requests waiting in the admission queue')
        self.in_flight = reg.gauge(
            'skytpu_engine_in_flight', 'Requests occupying decode slots')
        self.steps = reg.counter(
            'skytpu_engine_steps_total',
            'Decode steps executed (fused steps count each token)')
        self.tokens = reg.counter(
            'skytpu_engine_tokens_total',
            'Tokens generated and delivered to requests')
        self.requests = reg.counter(
            'skytpu_engine_requests_total',
            'Requests accepted into the admission queue')
        self.rejected = reg.counter(
            'skytpu_engine_rejected_total',
            'Requests rejected with 429 (admission queue full)')
        self.resurrected = reg.counter(
            'skytpu_engine_resurrected_total',
            'Requests internally resubmitted after a device failure reset '
            '(they had not sampled a token, so nothing was lost)')
        self.prefix = reg.counter(
            'skytpu_engine_prefix_requests_total',
            'Prefix (system-prompt) cache lookups at admission',
            labels={'outcome': ('hit', 'miss')})
        self.prefix_hits = reg.counter(
            'skytpu_engine_prefix_hits_total',
            'Prefix-cache hits (suffix-only prefills)')
        self.spec_rounds = reg.counter(
            'skytpu_engine_spec_rounds_total', 'Speculative verify rounds')
        self.spec_proposed = reg.counter(
            'skytpu_engine_spec_proposed_total',
            'Draft tokens proposed to the verifier')
        self.spec_accepted = reg.counter(
            'skytpu_engine_spec_accepted_total',
            'Draft tokens accepted by the verifier')
        self.ttft = reg.histogram(
            'skytpu_engine_ttft_seconds',
            'Time to first token: request submit to first sampled token '
            '(queue wait + prefill)', buckets=_TTFT_BUCKETS)
        self.tpot = reg.histogram(
            'skytpu_engine_tpot_seconds',
            'Time per output token after the first (mean per request)',
            buckets=_TPOT_BUCKETS)
        self.class_ttft = reg.histogram(
            'skytpu_engine_class_ttft_seconds',
            'Time to first token by request class (declared via '
            'X-Skytpu-Class, clamped to the closed class registry)',
            labels={'cls': request_class.CLASSES}, buckets=_TTFT_BUCKETS)
        self.class_tpot = reg.histogram(
            'skytpu_engine_class_tpot_seconds',
            'Time per output token after the first by request class',
            labels={'cls': request_class.CLASSES}, buckets=_TPOT_BUCKETS)
        self.goodput = reg.counter(
            'skytpu_engine_goodput_total',
            'Finished requests by class and whether they met their '
            'class\'s latency objective (good = TTFT and TPOT at/under the '
            'request_class.OBJECTIVES bounds; slow = completed but missed '
            'them)',
            labels={'cls': request_class.CLASSES,
                    'outcome': ('good', 'slow')})
        self.pages_free = reg.gauge(
            'skytpu_engine_kv_pages_free',
            'Free KV cache pages in the pool (paged mode; excludes the '
            'trash page)')
        self.pages_used = reg.gauge(
            'skytpu_engine_kv_pages_used',
            'KV cache pages held by live requests and shared prefix '
            'entries (paged mode)')
        self.page_alloc = reg.counter(
            'skytpu_engine_kv_page_alloc_total',
            'Page-reservation attempts at admission: ok = pages granted, '
            'wait = the request stayed queued for lack of free pages',
            labels={'outcome': ('ok', 'wait')})
        self.admit_wait = reg.histogram(
            'skytpu_engine_admission_wait_seconds',
            'Request submit to admission (queue wait, incl. waiting on '
            'free KV pages)', buckets=_WAIT_BUCKETS)
        self.attn_backend = reg.gauge(
            'skytpu_engine_attn_backend',
            'Info gauge: 1 on the attention backend this replica serves '
            'the paged hot path with, 0 elsewhere',
            labels={'backend': ATTN_BACKENDS})
        self.cache_read = reg.counter(
            'skytpu_engine_cache_bytes_read_total',
            'KV-cache bytes read by the decode step/verify programs '
            '(shape-derived proxy: attention reads of the [B, max_len] '
            'span)')
        self.cache_written = reg.counter(
            'skytpu_engine_cache_bytes_written_total',
            'KV-cache bytes written by the decode step/verify programs '
            '(shape-derived proxy: the new token positions)')
        self.kv_pages_quantized = reg.gauge(
            'skytpu_engine_kv_pages_quantized',
            'Device pool pages holding int8-quantized KV (0 on fp pools)')
        self.handoff = reg.counter(
            'skytpu_engine_handoff_total',
            'KV page handoff operations by stage (export = gather + copy '
            'to the host of a prefilled row, send = framed-TCP ship to the '
            'decode replica, adopt = scatter into the local page pool) and '
            'outcome.',
            labels={'stage': ('export', 'send', 'adopt'),
                    'outcome': ('ok', 'error')})
        self.handoff_staged = reg.gauge(
            'skytpu_engine_handoff_staged',
            'Handoffs received and staged (host memory) but not yet '
            'continued by a /disagg/continue call (sampled at scrape).')
        self.kv_pages_spilled = reg.gauge(
            'skytpu_engine_kv_pages_spilled',
            'KV pages\' worth of cache parked in the host-RAM spill tier '
            '(SKYTPU_ENGINE_KV_HOST_MB; sampled at scrape)')
        self.spill_seconds = reg.histogram(
            'skytpu_engine_spill_seconds',
            'Host time to spill one prefix entry to the host tier (page '
            'export + copy to the host + framed encode)')
        self.wake_seconds = reg.histogram(
            'skytpu_engine_wake_seconds',
            'Host time to wake one spilled prefix entry (framed decode + '
            'page alloc + scatter into fresh pages)')
        self.kv_sessions_peak = reg.gauge(
            'skytpu_engine_kv_sessions_peak',
            'Peak count of session prefix entries resident in the KV '
            'hierarchy (device prefix store + host spill tier) since the '
            'last reset')

    def reset(self) -> None:
        """Zero every family, then seed the counter zeros (JAX
        ``_seed_counter_zeros``: every counter series exists from birth,
        so rate() and absent() alerts see it before its first event)."""
        self.registry.reset_for_tests()
        for metric in (self.steps, self.tokens, self.requests,
                       self.rejected, self.prefix_hits, self.spec_rounds,
                       self.spec_proposed, self.spec_accepted,
                       self.cache_read, self.cache_written):
            metric.inc(0)
        for outcome in ('hit', 'miss'):
            self.prefix.inc(0, outcome=outcome)
        for outcome in ('ok', 'wait'):
            self.page_alloc.inc(0, outcome=outcome)
        for cls in request_class.CLASSES:
            for outcome in ('good', 'slow'):
                self.goodput.inc(0, cls=cls, outcome=outcome)

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
    # The request's class, clamped through request_class.normalize.
    cls: str = request_class.DEFAULT_CLASS
    # Times resubmitted after a failure reset (bounded by RESURRECT_MAX).
    resurrects: int = 0
    # Counted once in kv_page_alloc_total{outcome="wait"}.
    waited: bool = False


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


def _resolve(fut: Optional[concurrent.futures.Future], result=None,
             exc: Optional[BaseException] = None) -> None:
    """Resolve a request's future unless it is already done (a handler
    may cancel a queued one at any moment)."""
    if fut is None or fut.done():
        return
    try:
        if exc is not None:
            fut.set_exception(exc)
        else:
            fut.set_result(result)
    except concurrent.futures.InvalidStateError:
        pass


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
    ``spec_cooldown``.

    ``mesh`` ('expert=E,tensor=T', a MeshSpec or a built mesh over the
    initialised process group) shards the params over 'expert' and
    'tensor' as this rank's slice (``_setup_mesh``); the engine then
    does its device work
    under that mesh (:meth:`on_mesh`) and runs its step bodies eagerly.
    ``seed`` draws the random weights and seeds the samplers; a gang's
    leader may set ``seed`` anew before warm-up (the weights are drawn
    by then) and ships it to the followers."""

    def __init__(self, model: Optional[str] = 'llama-1b', *,
                 cfg: Optional[LlamaConfig] = None, params=None,
                 ckpt_dir: Optional[str] = None,
                 hf_dir: Optional[str] = None,
                 tokenizer_path: Optional[str] = None,
                 max_len: Optional[int] = None, device: str = 'cuda',
                 seed: int = 0, quantize: Optional[str] = None,
                 mesh=None):
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
        self.max_queue = MAX_QUEUE
        self.resurrect_max = RESURRECT_MAX
        # The KV hierarchy's knobs (tests may set them before warm-up):
        # the host tier is built with the host state.
        self.kv_idle_spill_s = KV_IDLE_SPILL_S
        self.kv_host_mb = KV_HOST_MB
        self.host_store: Optional[HostPageStore] = None
        # The pool representation and the K/V layout: the paged pool
        # (False: the contiguous slabs) and the paged step's attention
        # ('gather': the view baseline). Tests may set them before
        # warm-up.
        self.kv_quant = KV_QUANT
        self.paged = knobs.get_bool('SKYTPU_ENGINE_PAGED')
        self.attn_backend = knobs.get_enum('SKYTPU_ENGINE_ATTN')
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
        # A gang's mesh (None: one process, the whole model), and the
        # leader's control channel (serve/multihost.py; None elsewhere).
        self.mesh: Optional[mesh_lib.Mesh] = None
        self._leader: Optional[multihost.ControlLeader] = None
        if mesh is not None:
            self._setup_mesh(mesh, quantize)
        # CUDA graphs of the step and verify bodies: on the card, unless
        # the bodies hold collectives (a tensor mesh), which run eagerly.
        self.use_graphs = self.device.type == 'cuda' and self.mesh is None
        if self.device.type == 'cuda' and not self.use_graphs:
            logger.info('On a tensor mesh the step and verify bodies run '
                        'eagerly: their collectives are not captured into '
                        'CUDA graphs (ROADMAP Queue 1 item 8).')
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
        self._queue: 'queue.Queue[Request]' = queue.Queue(
            maxsize=self.max_queue)
        self._hold: List[Request] = []
        self._pending_cancels: collections.deque = collections.deque()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.warm = False
        self.loop_error: Optional[BaseException] = None
        self.step_count = 0
        # Tokens generated, and resurrections and resets after a failure
        # (the JAX engine's attributes, kept by the batch loop alone;
        # warm-up zeroes the token count).
        self.tokens_generated = 0
        self.resurrected_total = 0
        self._resets = 0
        # The hot loop's telemetry: flight-ring tuples (no lock, no
        # device sync) and this engine's metric families, rendered at
        # /metrics.
        self.flight = flight_lib.FlightRecorder()
        self.metrics = EngineMetrics()
        self.metrics.reset()
        self._admit_t0 = 0.0
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
        # PagedKV or PagedLatent; KVCache or LatentCache when not paged.
        self.cache: Optional[Any] = None
        self._layout: Optional[tuple] = None
        self.alloc: Optional[paging.PageAllocator] = None
        self.slots: List[Optional[Dict[str, Any]]] = [None] * self.max_batch
        self._prefix_store: 'collections.OrderedDict[tuple, List[int]]' = \
            collections.OrderedDict()
        # The idle sweep's clock: key -> time.monotonic() of the entry's
        # last capture or hit.
        self._prefix_last_used: Dict[tuple, float] = {}
        self._kv_sessions_peak = 0
        # Disaggregated serving: markers keyed by the request's future,
        # set before it is queued — {'mode': 'export'} turns an
        # admission into a prefill-only one (its row exported, no
        # decode), {'mode': 'adopt', 'meta', 'arrays'} admits a
        # handed-off request by adopting the rows instead of prefilling
        # — and the export blobs the /disagg/prefill handler pops.
        self._marks_lock = threading.Lock()
        self._disagg_marks: Dict[concurrent.futures.Future,
                                 Dict[str, Any]] = {}
        self._exports: 'collections.OrderedDict' = collections.OrderedDict()
        # The decode side, started by build_app when handoff_port is set:
        # the framed-TCP receiver and its staged (meta, arrays) store
        # (host memory; pages are reserved at adoption).
        self.role = knobs.get_enum('SKYTPU_ENGINE_ROLE')
        self.handoff_port: Optional[int] = None
        self.handoff_store: Optional[handoff_lib.HandoffStore] = None
        self._handoff_receiver: Optional[handoff_lib.HandoffReceiver] = None
        # The prompt buckets the batch loop's warm-up admits once each
        # (``main``'s --warm-buckets).
        self.warm_buckets: List[int] = []

    def _setup_mesh(self, mesh, quantize: Optional[str]) -> None:
        """Shard the params over ``mesh`` (JAX ``_setup_mesh``, 'expert'
        and 'tensor'): this rank keeps its slice of every leaf
        (parallel/sharding.py ``shard_params`` over the family's
        ``param_axes``; int8 leaves after quantizing the whole tree, as
        JAX shards them); a K/V pool holds its kv heads once built under
        :meth:`on_mesh`, a latent pool the whole latent. A mesh spec is
        checked before any group is made, then built over the process
        group's ranks, with the ('expert', 'tensor') group of the
        routed experts' sum made here, on every rank in the same order;
        a layout other than the fused paged pool is refused before
        either."""
        self._check_layout(mesh)
        if isinstance(mesh, str):
            mesh = parse_mesh_arg(mesh)
        if isinstance(mesh, mesh_lib.MeshSpec):
            check_serving_mesh(self.cfg, {ax: getattr(mesh, ax)
                                          for ax in mesh_lib.MESH_AXES})
            mesh = mesh_lib.build_mesh(mesh)
        check_serving_mesh(self.cfg, mesh.shape)
        if knobs.get_bool('SKYTPU_ENGINE_WARM_DISAGG'):
            raise NotImplementedError(
                'SKYTPU_ENGINE_WARM_DISAGG on a serving mesh: '
                'disaggregated serving on a gang is not ported yet (it '
                'waits for ROADMAP Queue 1 item 8)')
        self.mesh = mesh
        mesh.group('expert', 'tensor')
        self.params = sharding.shard_params(
            self.params, module_for(self.cfg).param_axes(self.cfg), mesh)
        logger.info('Serving on mesh %s: rank %d of %d%s.', dict(mesh.shape),
                    mesh.rank, mesh.size,
                    ' [int8 weights sharded]' if quantize else '')

    def on_mesh(self):
        """The context the engine's device work runs in: its mesh made
        the current one (models/llama.py reads the 'tensor' group from
        it, models/moe.py the ('expert', 'tensor') one), or nothing
        without one."""
        if self.mesh is None:
            return contextlib.nullcontext()
        return mesh_lib.use_mesh(self.mesh)

    def mirrored_knobs(self) -> Dict[str, Any]:
        """This engine's :data:`MIRRORED_KNOBS`, for the warmup op."""
        return {name: getattr(self, name) for name in MIRRORED_KNOBS}

    def set_mirrored_knobs(self, values: Dict[str, Any]) -> None:
        """A follower takes its leader's :meth:`mirrored_knobs`."""
        unknown = set(values) - set(MIRRORED_KNOBS)
        if unknown:
            raise ValueError(f'unknown mirrored knobs {sorted(unknown)}')
        for name, value in values.items():
            setattr(self, name, value)

    def _bcast(self, op: tuple) -> None:
        """Leader → follower control broadcast (multi-host serving; a
        no-op everywhere else), sent BEFORE the leader executes the op
        so that every rank enters the same collective in the same
        order."""
        if self._leader is not None:
            self._leader.send(op)

    def _page_fp(self) -> Optional[tuple]:
        """The allocator fingerprint shipped with admit, chunkstart and
        spill ops: the gang's check that page assignments replay in
        lockstep."""
        return None if self.alloc is None else self.alloc.fingerprint()

    def _check_page_fp(self, fp: Optional[tuple]) -> None:
        """Follower side: the leader's fingerprint against ours BEFORE
        replaying the op. A mismatch means the page assignments diverged
        (KV corruption, not recoverable by retrying): raise, and the
        follower loop exits the gang."""
        if fp is None:
            return
        mine = self._page_fp()
        if mine != tuple(fp):
            raise RuntimeError(f'page allocator diverged from leader: '
                               f'leader {tuple(fp)}, local {mine}')

    def _check_kv_quant_combinations(self) -> None:
        """The JAX engine's checks of int8 pools against the layout, in
        its words: a bad combination fails loudly, never serves
        degraded."""
        if self.kv_quant == 'none':
            return
        if not self.paged:
            raise ValueError(
                'SKYTPU_ENGINE_KV_QUANT needs paged mode '
                '(SKYTPU_ENGINE_PAGED=1): the contiguous layout '
                'has no quantized pool variant')
        if self.attn_backend == 'gather':
            raise ValueError(
                'SKYTPU_ENGINE_KV_QUANT=int8 is incompatible with '
                'SKYTPU_ENGINE_ATTN=gather (the view baseline '
                'cannot carry the scale sidecars); use fused')

    def _check_layout(self, mesh=None) -> None:
        """A serving mesh (``mesh``, else the engine's) takes the fused
        paged pool alone: the gang's op stream and its page fingerprints
        assume the pool, so the other layouts are refused by name
        there."""
        if (mesh if mesh is not None else self.mesh) is None or \
                self._fused():
            return
        setting = ('SKYTPU_ENGINE_PAGED=0' if not self.paged else
                   'SKYTPU_ENGINE_ATTN=gather')
        raise NotImplementedError(
            f'{setting} on a serving mesh: a gang serves the fused paged '
            f'pool only (the other layouts wait for ROADMAP Queue 1 item '
            f'8)')

    def _fused(self) -> bool:
        """Whether the steps and extends index the pages in place (the
        default) rather than through a contiguous view or slab."""
        return self.paged and self.attn_backend != 'gather'

    def _check_knobs(self) -> None:
        """The JAX engine's checks of its paging knobs and of int8
        pools against the layout."""
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
        decode.check_kv_quant(self.kv_quant)
        self._check_kv_quant_combinations()

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
        self._check_layout()
        max_pages = n_pages = 0
        if self.paged:
            max_pages = paging.pages_for(self.max_len, self.page_size)
            n_pages = self.kv_pages
            if n_pages <= 0:
                n_pages = (self.max_batch + max(0, min(self.prefix_cache,
                                                       self.max_batch))) \
                    * max_pages + 1
            if n_pages < max_pages + 1:
                raise ValueError(f'SKYTPU_ENGINE_KV_PAGES={n_pages} cannot '
                                 f'hold one full-length request '
                                 f'({max_pages} pages + trash)')
        layout = (self.paged, self.attn_backend == 'gather', self.page_size,
                  n_pages, max(self.spec_k, 0), self.kv_quant)
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
        cache, lengths, ``last`` and counts in place."""
        psz, b, dev = self.page_size, self.max_batch, self.device
        if self.paged:
            self.cache = self._decode.init_page_pool(
                self.cfg, self.n_pages, psz, b, self._max_pages, device=dev,
                quant=self.kv_quant)
        else:
            self.cache = self._decode.init_cache(self.cfg, b, self.max_len,
                                                 device=dev)
        # The cache-traffic proxy's inputs (host arithmetic on static
        # shapes, never a device sync): one position's bytes across
        # layers, an int8 pool's scales included, and the whole
        # [B, max_len] span's.
        self._tok_bytes = sum(p[:, 0, 0].numel() * p.element_size()
                              for p in self.kv_tensors().values())
        self._view_bytes = b * self.max_len * self._tok_bytes
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
        """The allocator, slots, the prefix store, the host spill tier
        and every host mirror, as new. The store is emptied without
        unref'ing its ids: they belonged to the allocator this replaces;
        the host tier is built anew (a failure reset distrusts the
        parked blobs with everything else)."""
        self.alloc = (paging.PageAllocator(self.n_pages) if self.paged
                      else None)
        self._table_np = (np.zeros((self.max_batch, self._max_pages),
                                   np.int32) if self.paged else None)
        self._table_dirty = self.paged
        self.slots = [None] * self.max_batch
        self._prefix_store = collections.OrderedDict()
        self._prefix_last_used = {}
        # The host tier spills pages: none without the pool.
        self.host_store = (HostPageStore(self.kv_host_mb)
                           if self.paged and self.kv_host_mb > 0 else None)
        self._kv_sessions_peak = 0
        self.metrics.kv_sessions_peak.set(0)
        self.metrics.kv_pages_spilled.set(0)
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

    def _reset_device_state(self, reason: Optional[str] = None) -> None:
        """After a failed admit/step: snapshot the flight ring into the
        event journal (the loop's history as it stood at the failure),
        wait out whatever the card still runs (an uncollected call may
        be copying into a stage), then zero the pool, table, lengths,
        ``last`` and counts IN PLACE (the graphs keep their addresses)
        and reset the host state (the contiguous slabs likewise)."""
        flight_lib.snapshot_to_journal(
            self.flight, reason=reason or 'device state reset',
            entity=f'engine/{self.model_name}')
        self.flight.record(flight_lib.RESET, 0, self._resets)
        self._resets += 1
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        for t in (*self.kv_tensors().values(), self.cache.length,
                  self.last_dev, self.counts):
            t.zero_()
        if self.paged:
            self.cache.table.zero_()
        if self.spec_k > 0:
            self._spec_dev.zero_()
        self._reset_host_state()

    def kv_tensors(self) -> Dict[str, torch.Tensor]:
        """Every per-token tensor of the cache by field name: the pool's,
        an int8 pool's sidecars included (models/paging.py
        ``pool_tensors``), or the contiguous slabs."""
        if self.paged:
            return paging.pool_tensors(self.cache)
        return paging._pools_of_view(self.cache)

    def attn_backend_served(self) -> Optional[str]:
        """The JAX backend label of the paged step this replica serves:
        'pallas' where kernel B (the hand-written counterpart of the
        Pallas kernel) runs every decode step, 'fused' where the plain
        in-place formulation does (the CPU, MLA, int8 pools, a softcap,
        window or sinks, or a shape B does not take), 'gather' for the
        view baseline; None for the contiguous slabs, which serve no
        paged attention (JAX publishes no backend gauge there)."""
        if not self.paged:
            return None
        if self.attn_backend == 'gather':
            return 'gather'
        cfg = self.cfg
        if self.device.type != 'cuda' or self._decode is mla or \
                cfg.dtype != torch.bfloat16 or self.kv_quant != 'none':
            return 'fused'
        hd = cfg.head_dim or cfg.dim // cfg.n_heads
        tp = 1 if self.mesh is None else self.mesh.shape['tensor']
        takes = paged_attention.kernel_takes(
            (self.max_batch, 1, cfg.n_heads // tp, hd),
            (self.n_pages, self.page_size, cfg.n_kv_heads // tp, hd),
            cfg.attn_logit_softcap, cfg.sliding_window,
            True if cfg.attn_sinks else None)
        return 'pallas' if takes else 'fused'

    def _count_cache_traffic(self, n_attend: int, n_tokens: int) -> None:
        """One step or verify call's KV-cache bytes into the
        ``cache_bytes_*`` counters, derived from shapes on the host (the
        JAX proxy): ``n_attend`` passes over the [B, max_len] span, and
        ``n_tokens`` new positions written per row. The gather baseline
        also pays the view (a pool read and a view write) and the
        scatter back (a view read and a pool write)."""
        read = n_attend * self._view_bytes
        written = n_tokens * self.max_batch * self._tok_bytes
        if self.paged and self.attn_backend == 'gather':
            read += self._view_bytes + written
            written += self._view_bytes
        self.metrics.cache_read.inc(read)
        self.metrics.cache_written.inc(written)

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
        admitted request). With the host tier on, an evicted entry
        spills there instead of dropping (the same pages free either
        way)."""
        spills = []
        while not self.alloc.can_fit(n) and self._prefix_store:
            key, pids = self._prefix_store.popitem(last=False)
            info = self._spill_entry(key, pids)
            if info is not None:
                spills.append(info)
        self._journal_spill(spills)
        pids = self.alloc.alloc(n)
        self.metrics.page_alloc.inc(outcome='ok')
        return pids

    def _reserve_slot_pages(self, slot: int, pids: List[int]) -> None:
        self._table_np[slot, :len(pids)] = pids
        self._table_np[slot, len(pids):] = 0
        self._table_dirty = True

    def _release_slot_pages(self, slot: int) -> None:
        """Drop the slot's refs: its own pages free, shared prefix pages
        free when their last holder lets go (no pages: nothing)."""
        if not self.paged:
            return
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
        """Empty the prefix store, returning its page refs (contiguous
        snapshots just drop), and the host tier (a reset rebuilds the
        allocator and drops the store instead)."""
        while self._prefix_store:
            _, pids = self._prefix_store.popitem(last=False)
            if self.paged:
                self.alloc.unref_all(pids)
        self._prefix_last_used.clear()
        if self.host_store is not None:
            self.host_store.clear()

    # -- the KV hierarchy: the host spill tier (serve/host_store.py) --------
    def _spill_entry(self, key, pids: List[int]) -> Optional[Tuple[int, bool]]:
        """Spill one prefix entry the caller already popped: export its
        pages into the host tier (when on), then drop the store's refs.
        Prefix pages are read-only after capture, so the contents are
        final even while a live row still shares them. Drained points
        only. ``kv.spill`` fires between 'entry chosen' and 'pages
        parked'. Returns (pages, stored) for the caller's
        :meth:`_journal_spill`, or None with the tier off."""
        spilled = None
        if self.host_store is not None:
            if failpoints.ACTIVE and self.warm:
                failpoints.fire('kv.spill')
            t0 = time.perf_counter()
            with torch.no_grad():
                out = paging.export_pages(self.cache, pids)
            arrays = {name: a.cpu() for name, a in out.items()}
            ok = self.host_store.put(key, arrays, n_pages=len(pids))
            self.metrics.spill_seconds.observe(time.perf_counter() - t0)
            spilled = (len(pids), bool(ok))
        self.alloc.unref_all(pids)
        self._prefix_last_used.pop(key, None)
        return spilled

    def _journal_spill(self, spills: List[Tuple[int, bool]]) -> None:
        """One ``kv_spill`` journal event for a whole spill run (a
        pressure eviction, an LRU overflow or one idle sweep)."""
        if not spills or self.host_store is None:
            return
        journal.record_event(
            'kv_spill', entity=f'engine/{self.model_name}',
            data={'entries': len(spills),
                  'pages': sum(p for p, _ in spills),
                  'stored': sum(1 for _, ok in spills if ok),
                  'host_pages': self.host_store.pages_spilled()})

    def _spill_key(self, key) -> Optional[Tuple[int, bool]]:
        """Spill the named prefix entry (the idle sweep's step)."""
        pids = self._prefix_store.pop(key, None)
        if pids is None:
            return None
        return self._spill_entry(key, pids)

    def _wake_prefix_entry(self, key) -> None:
        """Bring a spilled entry back to the device: fresh pages from the
        allocator, the blob's contents imported into them, the entry
        restored to the prefix store (newest: the caller is about to hit
        it). Waking pops the host blob. ``kv.wake`` fires before the
        device work: a failure propagates out of the admission into
        :meth:`_fail_all`, which resurrects the interrupted request."""
        if failpoints.ACTIVE and self.warm:
            failpoints.fire('kv.wake')
        t0 = time.perf_counter()
        arrays = self.host_store.pop(key)
        if arrays is None:
            return
        pids = self._alloc_pages(len(key) // self.page_size)
        with torch.no_grad():
            paging.import_pages(self.cache, arrays, pids)
        self._prefix_store[key] = pids
        self._prefix_last_used[key] = time.monotonic()
        self.metrics.wake_seconds.observe(time.perf_counter() - t0)
        journal.record_event(
            'kv_wake', entity=f'engine/{self.model_name}',
            data={'pages': len(pids),
                  'host_pages': self.host_store.pages_spilled()})

    def _note_kv_residency(self) -> None:
        """High-water mark of sessions resident in the KV hierarchy
        (device prefix entries + host-tier entries)."""
        resident = len(self._prefix_store)
        if self.host_store is not None:
            resident += len(self.host_store)
        if resident > self._kv_sessions_peak:
            self._kv_sessions_peak = resident
            self.metrics.kv_sessions_peak.set(resident)

    def _sweep_due(self) -> bool:
        """Whether some prefix entry idled past the spill threshold (the
        loop's cheap check before :meth:`_sweep_idle_prefixes`)."""
        if (self.host_store is None or self.kv_idle_spill_s <= 0 or
                not self._prefix_store):
            return False
        now = time.monotonic()
        return any(now - ts >= self.kv_idle_spill_s
                   for ts in self._prefix_last_used.values())

    def _sweep_idle_prefixes(self) -> None:
        """Spill every prefix entry untouched for ``kv_idle_spill_s``
        (drained points), journalled as one run."""
        if (self.host_store is None or self.kv_idle_spill_s <= 0 or
                not self._prefix_store):
            return
        now = time.monotonic()
        spills = []
        for key in list(self._prefix_store):
            ts = self._prefix_last_used.get(key)
            if ts is not None and now - ts >= self.kv_idle_spill_s:
                # Clock-driven, so leader-private: each spill is its own
                # op for a gang's followers.
                self._bcast(('spill', key, self._page_fp()))
                info = self._spill_key(key)
                if info is not None:
                    spills.append(info)
        self._journal_spill(spills)

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
               stream: Optional['queue.Queue'] = None,
               cls: str = request_class.DEFAULT_CLASS,
               prefill_export: bool = False,
               _adopt: Optional[Dict[str, Any]] = None
               ) -> concurrent.futures.Future:
        """Enqueue a request; the future resolves to (tokens,
        finish_reason, chosen-token logprobs, per-token top-5 lists —
        empty lists unless ``want_tops``; the first token's are always
        there), or raises EngineResetError. ``stream`` (anything with a
        ``put``) receives (token, logprob, tops) per token and None at
        the end. ``cls`` is the request's declared class, clamped here.
        ``prefill_export`` makes it prefill-only
        (:meth:`mark_prefill_export`); :meth:`submit_adopted` passes its
        adoption marker. A marker is set before the request is queued:
        the batch loop may admit it at once. Raises EngineOverloaded
        when the bounded queue is full."""
        fut: concurrent.futures.Future = concurrent.futures.Future()
        req = Request(list(tokens), int(max_new), float(temperature), top_k,
                      top_p, float(presence), float(frequency),
                      tuple(stop_ids), bool(want_tops), fut, stream,
                      time.perf_counter(), request_class.normalize(cls))
        if prefill_export:
            self.mark_prefill_export(fut)
        elif _adopt is not None:
            self._mark(fut, _adopt)
        try:
            self._queue.put_nowait(req)
        except queue.Full:
            self._unmark(fut)
            self.metrics.rejected.inc()
            raise EngineOverloaded(
                f'admission queue full ({self.max_queue} waiting)') \
                from None
        self.metrics.requests.inc()
        self.metrics.queue_depth.set(self.queue_depth())
        return fut

    # -- disaggregated serving (serve/disagg) ----------------------------------
    def mark_prefill_export(self, fut: concurrent.futures.Future) -> None:
        """Turn the request owning ``fut`` into a PREFILL-ONLY admission:
        it prefills (grouped, chunked or over a prefix hit) and samples
        its first token like any other, then its row is exported to the
        host, the slot finishes with reason ``'handoff'`` and its pages
        free at the next publish; the blob waits in :meth:`pop_export`.
        It must be marked before it is admitted: ``submit(...,
        prefill_export=True)`` marks before queueing."""
        self._mark(fut, {'mode': 'export'})

    def submit_adopted(self, meta: Dict[str, Any], arrays: Dict[str, Any],
                       stream: Optional['queue.Queue'] = None
                       ) -> concurrent.futures.Future:
        """Enqueue a HANDED-OFF request (decode side): admission adopts
        the shipped rows into pages of this replica's allocator
        (``paging.adopt_rows``) instead of prefilling, seeds the sampler
        state from ``meta`` and decodes on as if this replica had
        prefilled the prompt (greedy tokens equal a monolithic run's).
        EngineOverloaded on a full queue, as :meth:`submit`."""
        return self.submit(
            list(meta['tokens']), int(meta['max_new']),
            float(meta['temperature']), int(meta['top_k']) or None,
            float(meta['top_p']) or None, float(meta['presence_penalty']),
            float(meta['frequency_penalty']),
            stop_ids=tuple(int(i) for i in meta['stop_ids']),
            want_tops=bool(meta['want_tops']), stream=stream,
            cls=str(meta.get('cls', request_class.DEFAULT_CLASS)),
            _adopt={'mode': 'adopt', 'meta': meta, 'arrays': arrays})

    def _mark(self, fut: concurrent.futures.Future,
              mark: Dict[str, Any]) -> None:
        with self._marks_lock:
            self._disagg_marks[fut] = mark
            while len(self._disagg_marks) > MAX_MARKS:
                self._disagg_marks.pop(next(iter(self._disagg_marks)))

    def _unmark(self, fut: Optional[concurrent.futures.Future]) -> None:
        with self._marks_lock:
            self._disagg_marks.pop(fut, None)

    def _mode_of(self, req: Request) -> Optional[str]:
        with self._marks_lock:
            mark = self._disagg_marks.get(req.future)
        return mark.get('mode') if mark else None

    def pop_export(self, fut: concurrent.futures.Future
                   ) -> Optional[Dict[str, Any]]:
        """The prefill-only request's exported rows and geometry, taken
        ONCE by the /disagg/prefill handler owning ``fut``; None when the
        request completed at admission (its first token a stop id, or
        max_new 1): no decode phase remains, so nothing ships."""
        with self._marks_lock:
            return self._exports.pop(fut, None)

    def handoff_validate(self, meta: Dict[str, Any]) -> Optional[str]:
        """The receiver's compatibility check, before staging: a prefill
        pool paired with an incompatible decode pool refuses (kind
        'spec'), never adopts garbage; so does a replica on the
        contiguous slabs, which has no pages to adopt into."""
        if not self.paged:
            return ('decode replica is not in paged mode (disagg '
                    'requires SKYTPU_ENGINE_PAGED=1)')
        family = self.cache_family()
        if meta['family'] != family:
            return (f'cache family mismatch: handoff {meta["family"]}, '
                    f'replica {family}')
        if int(meta['vocab_size']) != self.cfg.vocab_size:
            return (f'vocab mismatch: handoff {meta["vocab_size"]}, '
                    f'replica {self.cfg.vocab_size}')
        if str(meta['model']) != self.model_name:
            return (f'model mismatch: handoff {meta["model"]!r}, '
                    f'replica {self.model_name!r}')
        n = len(meta['tokens'])
        if n < 1:
            return 'handoff with empty prompt'
        bucket = decode.bucket_size(n)
        if int(meta['bucket']) != bucket:
            return (f'bucket mismatch: handoff {meta["bucket"]}, '
                    f'replica computes {bucket} for {n} tokens')
        if bucket + int(meta['max_new']) > self.max_len:
            return (f'bucketed prompt ({bucket}) + max_new '
                    f'({meta["max_new"]}) exceeds replica max_len '
                    f'{self.max_len}')
        return None

    def _export_slot(self, slot: int, tokens: List[int]) -> Dict[str, Any]:
        """The freshly prefilled row's first bucket-many positions,
        gathered out of the pool onto the host (the handoff payload),
        inside the admission at a drained point. ``prefill.flush`` fires
        between 'prefill done' and 'rows exported'."""
        if failpoints.ACTIVE and self.warm:
            failpoints.fire('prefill.flush')
        p = decode.bucket_size(len(tokens))
        try:
            with torch.no_grad():
                a, b = paging.gather_prefix(self.cache, slot, p)
            t_sync = time.perf_counter()
            a, b = a.cpu(), b.cpu()
            self.metrics.host_sync_seconds.observe(time.perf_counter() -
                                                   t_sync)
        except BaseException:
            self.metrics.handoff.inc(stage='export', outcome='error')
            raise
        self.metrics.handoff.inc(stage='export', outcome='ok')
        return {'a': a, 'b': b, 'bucket': p, 'length': len(tokens)}

    def _admit_adopted(self, req: Request) -> int:
        """Admit one handed-off request (drained points only): reserve
        its pages through this replica's allocator, adopt the shipped
        rows into them, seed the sampler state, the penalty counts and
        the device ``last`` from the meta and turn the slot into a
        decoding row holding the first token (sampled on the prefill
        replica; it streams at the next publish). A lost marker falls
        back to a local prefill. Returns the slot (-1 on the fallback)."""
        assert not self._inflight, 'adopt with a call in flight'
        with self._marks_lock:
            mark = self._disagg_marks.get(req.future) or {}
        meta, arrays = mark.get('meta'), mark.get('arrays')
        if meta is None:
            logger.warning('adopt marker lost; falling back to a local '
                           'prefill admission')
            self._admit_group([req])
            return -1
        if failpoints.ACTIVE and self.warm:
            failpoints.fire('engine.admit')
        t0 = self._admit_t0 = time.perf_counter()
        self._ensure_state()
        slot = self._free_slot()
        self._set_sampling(slot, req)
        self._reserve_slot_pages(
            slot, self._alloc_pages(self._pages_needed(req)))
        self._refresh_table()
        first = int(meta['first_token'])
        try:
            with torch.no_grad():
                paging.adopt_rows(self.cache, torch.as_tensor(arrays['a']),
                                  torch.as_tensor(arrays['b']), slot,
                                  decode.bucket_size(len(req.tokens)),
                                  len(req.tokens))
                self.last_dev[slot] = first
                self.counts[slot] = 0
                self.counts[slot, first] += 1
        except BaseException:
            self.metrics.handoff.inc(stage='adopt', outcome='error')
            raise
        self._finish_admit(req, slot, first, float(meta['first_lp']),
                           [tuple(t) for t in meta.get('first_tops') or []],
                           time.perf_counter())
        self._unmark(req.future)
        self.metrics.handoff.inc(stage='adopt', outcome='ok')
        self.metrics.admit_seconds.observe(time.perf_counter() - t0)
        return slot

    def cancel(self, fut: concurrent.futures.Future) -> None:
        """Abort the request owning ``fut`` (a stream whose client went
        away, a stop string matched mid-stream, or a fan-out whose
        sibling failed). Deferred: the batch loop applies it at its next
        drained point, never racing a call in flight. A request still
        queued is skipped at admission once ``fut.cancel()`` succeeded;
        one resurrected into the hold queue is dropped from it here."""
        self._pending_cancels.append(fut)

    def _process_cancels(self) -> None:
        """Apply deferred cancels (drained points only). Marks only: the
        slot (a prefilling one too) frees at the next publish. A held
        request that was admitted once (its future already running, so
        ``fut.cancel()`` cannot reach it) leaves the hold queue."""
        while self._pending_cancels:
            fut = self._pending_cancels.popleft()
            for i, s in enumerate(self.slots):
                if s is not None and s['req'].future is fut:
                    self._cancel_slot(i)
                    break
            else:
                self._hold = [r for r in self._hold if r.future is not fut]
                self._unmark(fut)

    def _cancel_slot(self, slot: int) -> None:
        """Mark the row in ``slot`` finished ('stop') unless it is; it
        frees at the next publish. Broadcast: a follower marks the same
        row at the same point of the op stream."""
        s = self.slots[slot]
        if s is not None and s['finish'] is None:
            self._bcast(('cancel', slot))
            s['finish'] = 'stop'
            self.flight.record(flight_lib.CANCEL, slot)

    # -- admission -------------------------------------------------------------
    def _drain_admissible(self) -> List[Request]:
        """Pop requests bounded by free slots and, when paged, by free
        pages plus what evicting unshared prefix entries would return,
        FIFO: once one is held, nothing younger passes it. A cancelled
        request is dropped here."""
        items: List[Request] = []
        free_slots = sum(1 for s in self.slots if s is None)
        budget = (self.alloc.free_count + self._evictable_pages()
                  if self.paged else None)

        def fits(req: Request) -> bool:
            nonlocal budget
            if budget is None:
                return True
            n = self._pages_needed(req)
            if n > budget:
                return False
            budget -= n
            return True

        def live(req: Request) -> bool:
            # A resurrected request's future is running already.
            return (req.future is None or req.future.running() or
                    req.future.set_running_or_notify_cancel())

        def hold(req: Request) -> None:
            self._hold.append(req)
            if not req.waited:
                # Counted once a request: admission found the pool
                # short of pages.
                req.waited = True
                self.metrics.page_alloc.inc(outcome='wait')

        held, self._hold = self._hold, []
        for req in held:
            if req.future is not None and req.future.cancelled():
                self._unmark(req.future)
                continue                 # cancelled while waiting
            if len(items) < free_slots and fits(req):
                if live(req):
                    items.append(req)
            else:
                self._hold.append(req)
        while (not self._hold and len(items) < free_slots and
               not self._queue.empty()):
            req = self._queue.get_nowait()
            if req.future is not None and req.future.cancelled():
                self._unmark(req.future)
                continue                 # cancelled while queued
            if fits(req):
                if live(req):
                    items.append(req)
            else:
                hold(req)
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
        t_sync = time.perf_counter()
        out = (first.cpu().numpy(), first_lp.cpu().numpy(),
               tis.cpu().numpy(), tvs.cpu().numpy())
        self.metrics.host_sync_seconds.observe(time.perf_counter() - t_sync)
        return out

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
        # Fault sites fire only once warm: warm-up drives the same
        # methods with no containment around them.
        if failpoints.ACTIVE and self.warm:
            failpoints.fire('engine.admit')
        t_admit = time.perf_counter()
        self._admit_t0 = t_admit
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
            if self.paged:
                self._reserve_slot_pages(
                    slot, self._alloc_pages(self._pages_needed(req)))
        self._refresh_table()
        if self.warm and self.prefix_cache > 0:
            # Every request reaching the grouped prefill missed the
            # prefix cache (hits took _admit_with_prefix above).
            self.metrics.prefix.inc(len(items), outcome='miss')
        dev = self.device
        slots_t = torch.tensor(slots, dtype=torch.int64, device=dev)
        lengths_t = torch.tensor(lengths, dtype=torch.int32, device=dev)
        with torch.no_grad():
            logits, rows_a, rows_b = self._decode.prefill(
                self.params,
                torch.tensor(padded, dtype=torch.int32, device=dev),
                self.cfg, self.max_len, lengths=lengths_t)
            if self.paged:
                paging.scatter_prefill(self.cache, rows_a, rows_b, slots_t,
                                       bucket, lengths_t)
            else:
                self._write_rows(slots_t, 0, (rows_a, rows_b), lengths_t)
            first, first_lp, tis, tvs = self._sample_first(logits, slots)
        now = time.perf_counter()
        for i, req in enumerate(items):
            self._finish_admit(req, slots[i], int(first[i]),
                               float(first_lp[i]),
                               _tops_list(tis[i], tvs[i]), now)
            if self.warm:
                self._prefix_capture(req.tokens, slots[i])
        self.metrics.admit_seconds.observe(time.perf_counter() - t_admit)

    def _write_rows(self, slots_t: torch.Tensor, p: int, rows,
                    lengths_t: torch.Tensor) -> None:
        """Contiguous slabs: the family's two row tensors ([L, N, s, ...],
        as its ``prefill`` or ``prefill_extend`` returns them) land at
        positions [p, p + s) of rows ``slots_t``, zeros after them (JAX
        writes each admitted row whole), and length[slots] = p +
        lengths."""
        for t, r in zip(self.kv_tensors().values(), rows):
            end = p + r.shape[2]
            t[:, slots_t, p:end] = r.to(t.dtype)
            t[:, slots_t, end:] = 0
        self.cache.length[slots_t] = (lengths_t + p).to(
            self.cache.length.dtype)

    def _extend(self, slot: int, tokens: List[int], p: int,
                n: int) -> torch.Tensor:
        """Prefill ``tokens`` (``n`` real, then padding) at positions
        [p, p + len(tokens)) of row ``slot`` over the p positions the row
        holds, in place; length[slot] = p + n. Returns the logits at the
        last real position, [1, vocab] fp32. The fused pool extends in
        place (``paged_prefill_extend``); the gather baseline reads the
        prefix out of the pages (``gather_prefix``), runs the family's
        ``prefill_extend`` at max_len p + len(tokens) and writes the
        suffix back (``scatter_suffix``); the contiguous slab reads the
        prefix out of the row itself. Kernel A at p == 0 on the card."""
        tok = torch.tensor([tokens], dtype=torch.int32, device=self.device)
        s2 = len(tokens)
        if self._fused():
            return self._decode.paged_prefill_extend(
                self.params, tok, self.cache, self.cfg, slot=slot, p=p,
                lengths=n)
        if self.paged:
            pre = paging.gather_prefix(self.cache, slot, p)
        else:
            pre = tuple(t[:, slot:slot + 1, :p]
                        for t in self.kv_tensors().values())
        n_t = torch.tensor([n], dtype=torch.int32, device=self.device)
        logits, rows_a, rows_b = self._decode.prefill_extend(
            self.params, tok, self.cfg, p + s2, *pre, lengths=n_t)
        if self.paged:
            paging.scatter_suffix(self.cache, rows_a, rows_b, slot, p, s2,
                                  p + n)
        else:
            self._write_rows(torch.tensor([slot], device=self.device), p,
                             (rows_a, rows_b), n_t)
        return logits

    def _finish_admit(self, req: Request, slot: int, first: int,
                      first_lp: float, tops: list, now: float) -> None:
        """Turn ``slot`` into a decoding row holding its first token.
        The hot loop records a flight tuple here; the admission wait
        (submit to the enclosing admit's start, or a chunked row's first
        chunk) is observed once a request."""
        self.last[slot] = first
        self.flight.record(flight_lib.ADMIT, slot,
                           decode.bucket_size(len(req.tokens)))
        self.metrics.admit_wait.observe(max(0.0,
                                            self._admit_t0 - req.t_submit))
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
            self.tokens_generated += 1
            self.metrics.tokens.inc()
            if len(entry['out']) >= req.max_new:
                entry['finish'] = 'length'
        self.slots[slot] = entry
        # Prefill-only (disaggregated serving): the row's job ends at its
        # first token. Export BEFORE marking it finished, so a failed
        # export leaves the row unfinished and _fail_all answers the
        # structured retriable error; a row that finished outright
        # (stop id, max_new 1) exports nothing.
        if self._mode_of(req) == 'export':
            self._unmark(req.future)
            if entry['finish'] is None:
                blob = self._export_slot(slot, req.tokens)
                with self._marks_lock:
                    self._exports[req.future] = blob
                    while len(self._exports) > MAX_EXPORTS:
                        self._exports.popitem(last=False)
                entry['finish'] = 'handoff'

    # -- the prefix cache --------------------------------------------------------
    def _prefix_match(self, tokens: List[int]) -> Optional[int]:
        """The longest snapshotted power-of-two prefix of ``tokens``
        leaving at least one suffix token, whose prefix + bucketed
        suffix fits max_len; None: a full prefill. A spilled entry
        counts: :meth:`_admit_with_prefix` wakes it before extending."""
        has_host = self.host_store is not None and len(self.host_store)
        if not self._prefix_store and not has_host:
            return None
        p, best = PREFIX_MIN_TOKENS, None
        while p < len(tokens):
            key = tuple(tokens[:p])
            if ((key in self._prefix_store or
                 (has_host and key in self.host_store)) and
                    p + decode.bucket_size(len(tokens) - p) <= self.max_len):
                best = p
            p *= 2
        return best

    def _prefix_capture(self, tokens: List[int], slot: int) -> None:
        """Snapshot the slot's longest power-of-two prefix (at least
        PREFIX_MIN_TOKENS): p / page_size refs on the slot's own first
        pages, which nobody writes again (the row decodes at positions
        >= len(tokens) >= p); on the contiguous slabs, copies of the
        row's first p positions (a slice would be a view into the slab,
        which the slot's next occupant overwrites). The store keeps
        ``prefix_cache`` entries, least recently used out first."""
        if self.prefix_cache <= 0 or len(tokens) < PREFIX_MIN_TOKENS:
            return
        p = PREFIX_MIN_TOKENS
        while p * 2 <= len(tokens):
            p *= 2
        key = tuple(tokens[:p])
        if key in self._prefix_store:
            self._prefix_store.move_to_end(key)
            self._prefix_last_used[key] = time.monotonic()
            return
        if self.paged:
            pids = [int(x)
                    for x in self._table_np[slot, :p // self.page_size]]
            if not pids or 0 in pids:
                return
            for pid in pids:
                self.alloc.ref(pid)
            self._prefix_store[key] = pids
        else:
            self._prefix_store[key] = tuple(
                t[:, slot, :p].clone() for t in self.kv_tensors().values())
        self._prefix_last_used[key] = time.monotonic()
        spills = []
        while len(self._prefix_store) > self.prefix_cache:
            # The LRU overflow spills (host tier on) or drops.
            old_key, old = self._prefix_store.popitem(last=False)
            if not self.paged:
                self._prefix_last_used.pop(old_key, None)
                continue
            info = self._spill_entry(old_key, old)
            if info is not None:
                spills.append(info)
        self._journal_spill(spills)
        self._note_kv_residency()

    def _admit_with_prefix(self, req: Request, p: int) -> None:
        """Admit one request over a stored prefix: its table points at
        the snapshot's pages (one more ref each), its own pages follow
        (the suffix starts on a page edge, so no sharer writes a shared
        page); on the contiguous slabs the snapshot is copied into the
        row instead. Then one extend at (p, bucket(suffix)) and the
        first token sampled; the longer prompt is snapshotted in turn,
        so a growing history extends its entry."""
        slot = self._free_slot()
        suffix = req.tokens[p:]
        s2 = decode.bucket_size(len(suffix))
        self._set_sampling(slot, req)
        key = tuple(req.tokens[:p])
        if key not in self._prefix_store and self.host_store is not None:
            # A host-tier hit wakes into the device tier first; a wake
            # failure reaches _fail_all, which resurrects this request
            # (it has not sampled).
            self._wake_prefix_entry(key)
        stored = self._prefix_store[key]
        self._prefix_store.move_to_end(key)
        self._prefix_last_used[key] = time.monotonic()
        if self.paged:
            # Ref the shared pages before allocating: an eviction under
            # page pressure may then drop the entry, never the pages.
            shared = list(stored)
            for pid in shared:
                self.alloc.ref(pid)
            own = self._alloc_pages(
                max(0, self._pages_needed(req) - len(shared)))
            self._reserve_slot_pages(slot, shared + own)
            self._refresh_table()
        with torch.no_grad():
            if not self.paged:
                for t, snap in zip(self.kv_tensors().values(), stored):
                    t[:, slot, :p] = snap
            logits = self._extend(slot, suffix + [0] * (s2 - len(suffix)),
                                  p, len(suffix))
            first, first_lp, tis, tvs = self._sample_first(logits, [slot])
        self.prefix_hits += 1
        self.metrics.prefix_hits.inc()
        self.metrics.prefix.inc(outcome='hit')
        self._finish_admit(req, slot, int(first[0]), float(first_lp[0]),
                           _tops_list(tis[0], tvs[0]), time.perf_counter())
        self._prefix_capture(req.tokens, slot)

    # -- chunked prefill ---------------------------------------------------------
    def _should_chunk(self, req: Request) -> bool:
        """A prompt longer than ``prefill_chunk`` prefills in chunks,
        unless it rides the prefix cache; on the contiguous slabs
        nothing chunks (one bucket prefill, as in JAX)."""
        if not self.paged or len(req.tokens) <= self.prefill_chunk:
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
        if failpoints.ACTIVE and self.warm:
            failpoints.fire('engine.admit')
        self._ensure_state()
        slot = self._free_slot()
        self._set_sampling(slot, req)
        self._reserve_slot_pages(
            slot, self._alloc_pages(self._pages_needed(req)))
        self.slots[slot] = {'req': req, 'out': [], 'lps': [], 'tops': [],
                            'finish': None, 'stop': frozenset(req.stop_ids),
                            'sent': 0, 'prefill': {
                                'pos': 0, 't_admit': time.perf_counter()}}
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
        t0 = time.perf_counter()
        self._refresh_table()
        with torch.no_grad():
            if remaining > c:
                self._extend(slot, req.tokens[pos:pos + c], pos, c)
                s['prefill']['pos'] = pos + c
                self.prefill_chunks += 1
                self.flight.record(flight_lib.CHUNK, slot, pos + c)
                self.metrics.admit_seconds.observe(time.perf_counter() - t0)
                return
            s2 = decode.bucket_size(remaining)
            logits = self._extend(
                slot, req.tokens[pos:] + [0] * (s2 - remaining), pos,
                remaining)
            first, first_lp, tis, tvs = self._sample_first(logits, [slot])
        self.prefill_chunks += 1
        # The admission anchor is the first chunk: chunk rounds count as
        # prefill, not as queue wait.
        self._admit_t0 = s['prefill']['t_admit']
        self._finish_admit(req, slot, int(first[0]), float(first_lp[0]),
                           _tops_list(tis[0], tvs[0]), time.perf_counter())
        self.flight.record(flight_lib.CHUNK, slot, len(req.tokens))
        self._prefix_capture(req.tokens, slot)
        self.metrics.admit_seconds.observe(time.perf_counter() - t0)

    # -- the fused k-step program ----------------------------------------------
    def _open_view(self):
        """The cache a step or verify call attends, and the lengths
        before it: the pool itself (fused), the contiguous slabs, or the
        pool's per-row view (gather: materialized here, inside the call,
        sharing the pool's ``length``)."""
        if self._fused() or not self.paged:
            return self.cache, None
        return (paging.gather_view(self.cache, self.max_len),
                self.cache.length.clone())

    def _close_view(self, view, start, k: int, active) -> None:
        """The gather baseline writes the call's k positions back from
        the view into the pages (inactive rows on the trash page)."""
        if start is not None:
            paging.scatter_steps(self.cache, view, start, k, active)

    def _step_logits(self, view, last: torch.Tensor,
                     active: torch.Tensor) -> torch.Tensor:
        """One decode step of every row on :meth:`_open_view`'s cache:
        the tokens ``last`` [B] in, their K/V written and the active
        rows' lengths advanced in place, the logits [B, vocab] out."""
        if self._fused():
            return self._decode.paged_decode_step(
                self.params, last, self.cache, self.cfg,
                max_len=self.max_len, active=active)[0]
        return self._decode.decode_step(self.params, last, view, self.cfg,
                                        active=active)[0]

    def _step_body(self, k: int, use_pen: bool, want_tops: bool) -> None:
        """k × (decode step → sample → count → optional top-5), carrying
        ``last``, the cache, the counts and the generator — the JAX
        ``step_k``: the fused paged step in place (kernel B on the
        card), or the contiguous ``decode_step`` on the slabs or, for
        the gather baseline, on the view gathered before the k steps and
        scattered back after them (JAX ``run_gather``). Reads the
        control block ``_ctrl`` and writes ``_out_*`` rows [0, k): every
        tensor it touches outside its own temporaries lives at a fixed
        address, and nothing syncs the host, so on the card it is
        captured once per variant and replayed. Inactive rows write the
        trash page (on the slabs, their frozen ``length`` slot, which
        the next step overwrites), keep their ``last`` and count
        nothing."""
        ctrl = self._ctrl
        active = ctrl[0] > 0
        temp, topk, topp = ctrl[1], ctrl[2].to(torch.int32), ctrl[3]
        pres, freq = ctrl[4], ctrl[5]
        last = self.last_dev
        with torch.no_grad():
            view, start = self._open_view()
            for t in range(k):
                logits = self._step_logits(view, last, active)
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
            self._close_view(view, start, k, active)
            self.last_dev.copy_(last)

    def _verify_body(self, want_tops: bool) -> None:
        """One K-wide speculative verify over the whole pool: the fed
        [B, K] = per-row [last, d1..d_{K-1}] from ``_spec_dev`` (row K:
        active) through ``paged_verify_step`` (kernel B at S = K on the
        card; K/V of the fed tokens written at each row's offset, the
        inactive rows' on the trash page; ``length`` does not move) or
        the contiguous ``verify_step`` (on the slabs, where it takes no
        ``active``, as JAX's; or on the gather view, scattered back),
        then the greedy token and its logprob at every position (and the
        top-5 in the want_tops variant) into ``_ver_*``. Fixed
        addresses and no host sync, as :meth:`_step_body`."""
        k = self.spec_k
        fed = self._spec_dev[:k].t()
        active = self._spec_dev[k] > 0
        with torch.no_grad():
            if self._fused():
                logits, _ = self._decode.paged_verify_step(
                    self.params, fed, self.cache, self.cfg,
                    max_len=self.max_len, active=active)
            else:
                view, start = self._open_view()
                logits, _ = self._decode.verify_step(self.params, fed, view,
                                                     self.cfg)
                self._close_view(view, start, k, active)
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
        eagerly). Without graphs (the CPU, a tensor mesh) the body
        itself."""
        if not self.use_graphs:
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
        # On the host, before anything is enqueued (no graph replay).
        if failpoints.ACTIVE and self.warm:
            failpoints.fire('engine.step')
        t0 = time.perf_counter()
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
        self._count_cache_traffic(k, k)
        # Ring only on the hot path (seq = step width).
        self.flight.record(flight_lib.DISPATCH, 0, k)
        self.metrics.step_seconds.observe(time.perf_counter() - t0,
                                          phase='dispatch')
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
        self.tokens_generated += 1
        self.metrics.tokens.inc()
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
        if failpoints.ACTIVE and self.warm:
            failpoints.fire('engine.collect')
        h = self._inflight.pop(0)
        t0 = time.perf_counter()
        if h.event is not None:
            h.event.synchronize()
        toks, lps = h.toks.numpy().copy(), h.lps.numpy().copy()
        if h.want_tops:
            tis, tvs = h.tis.numpy().copy(), h.tvs.numpy().copy()
        self.metrics.host_sync_seconds.observe(time.perf_counter() - t0)
        # After the wait: dispatch → collect is the call's device and
        # transfer time.
        self.flight.record(flight_lib.COLLECT, 0, h.k)
        self.step_count += h.k
        self.metrics.steps.inc(h.k)
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
        self.metrics.step_seconds.observe(time.perf_counter() - t0,
                                          phase='collect')

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
        t_sync = time.perf_counter()
        if event is not None:
            event.synchronize()
        greedy, lps = st.toks.numpy().copy(), st.lps.numpy().copy()
        if want_tops:
            tis, tvs = st.tis.numpy().copy(), st.tvs.numpy().copy()
        self.metrics.host_sync_seconds.observe(time.perf_counter() - t_sync)
        self._count_cache_traffic(1, k)
        self.step_count += 1
        self.spec_rounds += 1
        self.metrics.steps.inc()
        self.metrics.spec_rounds.inc()
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
        self.flight.record(flight_lib.SPEC, 0, round_acc)
        self.metrics.spec_proposed.inc(round_prop)
        self.metrics.spec_accepted.inc(round_acc)
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
        penalty). A gang's followers reap at the same point."""
        self._bcast(('reap',))
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
            self._finish_timing(i, s)
            _resolve(req.future, (s['out'], s['finish'], s['lps'],
                                  s['tops']))
            if q is not None:
                q.put(None)                  # end-of-stream sentinel
            # Pages first: a thread that sees the slot free (in_flight)
            # sees its pages back too.
            self._release_slot_pages(i)
            self.slots[i] = None
            self.temp[i] = self.topk[i] = self.topp[i] = 0
            self.pres[i] = self.freq[i] = 0
            self._samp_dirty = True

    def _finish_timing(self, slot: int, s: Dict[str, Any]) -> None:
        """A finished row's TTFT and TPOT from the host timestamps its
        entry carries: one observation of each per request at publish,
        never per token and never with a device sync; goodput judged
        against its class's objective. A row cancelled mid-prefill has
        no first token and records only its flight event."""
        self.flight.record(flight_lib.FINISH, slot, len(s['out']))
        if 't_first' not in s:
            return
        req, n = s['req'], len(s['out'])
        now = time.perf_counter()
        ttft = s['t_first'] - req.t_submit
        tpot = (now - s['t_first']) / (n - 1) if n > 1 else None
        self.timings.append((ttft, tpot or 0.0, n))
        m = self.metrics
        m.ttft.observe(ttft)
        m.class_ttft.observe(ttft, cls=req.cls)
        if tpot is not None:
            m.tpot.observe(tpot)
            m.class_tpot.observe(tpot, cls=req.cls)
        m.goodput.inc(cls=req.cls, outcome=(
            'good' if request_class.is_good(req.cls, ttft, tpot)
            else 'slow'))

    def _fail_all(self, err: Exception, extra: List[Request] = ()) -> None:
        """Contain a failed admit, chunk, step or collect with the
        smallest blast radius (JAX ``_fail_all``), then rebuild the
        device state in place:
          * rows that finished before the failure resolve normally;
          * requests that never sampled a token (the group whose admit
            failed, rows mid-chunked-prefill) go back to the front of
            the hold queue, oldest first, at most ``resurrect_max``
            times each;
          * only rows that had emitted tokens fail, with a retriable
            EngineResetError carrying ``tokens_emitted``.
        Every disposition is delivered after the rebuild lands, so a
        client that retries never meets the old state. The calls in
        flight and their stages are dropped with the host state.
        Requests still queued or held are untouched. If the rebuild
        itself raises (a sticky device fault), everything set aside
        fails and the error propagates: the loop dies. A gang's
        followers hit the same failure in the same op, and rebuild in
        lockstep on the ('reset',) sent here."""
        self._bcast(('reset',))
        logger.warning('engine admit/step failed; resetting the device '
                       'state: %s\n%s', err, traceback.format_exc())
        deliver: List[Callable[[], None]] = []
        resurrected: List[Request] = []

        def fail(req: Request, n_emitted: int) -> None:
            self._unmark(req.future)

            def apply() -> None:
                if req.stream is not None:
                    req.stream.put(None)
                if req.future is not None and not req.future.done():
                    reset = EngineResetError(
                        f'engine reset after device failure '
                        f'({type(err).__name__}: {err}); request state '
                        f'lost', tokens_emitted=n_emitted)
                    reset.__cause__ = err
                    _resolve(req.future, exc=reset)
            deliver.append(apply)

        def try_resurrect(req: Request) -> bool:
            if req.future is None or req.future.done() or \
                    req.resurrects >= self.resurrect_max:
                return False
            req.resurrects += 1
            resurrected.append(req)
            return True

        handled = set()
        for i, s in enumerate(self.slots):
            if s is None:
                continue
            req = s['req']
            handled.add(id(req))
            if s['finish'] is not None:
                self._finish_timing(i, s)

                def apply(s=s, req=req) -> None:
                    if req.stream is not None:
                        for j in range(s['sent'], len(s['out'])):
                            req.stream.put((s['out'][j], s['lps'][j],
                                            s['tops'][j]))
                        req.stream.put(None)
                    _resolve(req.future, (s['out'], s['finish'], s['lps'],
                                          s['tops']))
                deliver.append(apply)
                continue
            emitted = len(s['out'])
            if emitted == 0 and s['sent'] == 0 and try_resurrect(req):
                continue
            fail(req, emitted)
        for req in extra:
            if id(req) in handled:
                continue                 # admitted: the slot loop had it
            if not try_resurrect(req):
                fail(req, 0)
        try:
            self._reset_device_state(reason=f'{type(err).__name__}: {err}')
        except BaseException:
            for req in resurrected:
                fail(req, 0)
            for apply in deliver:
                apply()
            raise
        for apply in deliver:
            apply()
        if resurrected:
            self._hold[:0] = resurrected
            self.resurrected_total += len(resurrected)
            self.metrics.resurrected.inc(len(resurrected))
            logger.info('Resurrected %d request(s) that had not sampled a '
                        'token; %d held for re-admission.', len(resurrected),
                        len(self._hold))

    def _admit_pending(self) -> None:
        """Admit what fits: handed-off requests by adoption (they carry
        their K/V), then grouped prefills, then the chunked starts. A
        failure is contained (:meth:`_fail_all`) and the rest admit
        against the rebuilt state."""
        items = self._drain_admissible()
        adopted = [r for r in items if self._mode_of(r) == 'adopt']
        rest = [r for r in items if self._mode_of(r) != 'adopt']
        grouped = [r for r in rest if not self._should_chunk(r)]
        chunked = [r for r in rest if self._should_chunk(r)]
        for req in adopted:
            try:
                self._admit_adopted(req)
            except Exception as e:  # pylint: disable=broad-except
                self._fail_all(e, [req])
        for group in self._admit_groups(grouped):
            self._bcast(('admit', multihost.strip_items(group),
                         self._page_fp()))
            try:
                self._admit_group(group)
            except Exception as e:  # pylint: disable=broad-except
                self._fail_all(e, group)
        for req in chunked:
            self._bcast(('chunkstart', multihost.strip_items([req])[0],
                         self._page_fp()))
            try:
                self._start_chunked(req)
            except Exception as e:  # pylint: disable=broad-except
                self._fail_all(e, [req])

    def warmup(self, buckets: Optional[List[int]] = None) -> None:
        """Build the device state, then run the whole variant matrix —
        k ∈ {1, MAX_STEP_CHUNK} × penalties × top logprobs, the only
        calls ``_dispatch_step`` can make — through the real
        dispatch/collect path on one admitted request, and both verify
        variants with no row active, capturing each on the card; then
        admit one prompt of each bucket in ``buckets`` that a grouped
        prefill serves (16 < b < max_len, b <= prefill_chunk: longer
        prompts chunk), so that its first request allocates nothing new;
        (contiguous slabs: every bucket 16 < b < max_len, nothing
        chunks there), then free the slots (no page leaks), empty the
        prefix store,
        reset the counters and flip ``warm`` (``/health`` answers 200).
        A capture that fails raises. A gang's leader first ships the op
        with its sampling seed and :meth:`mirrored_knobs`."""
        self._bcast(('warmup', list(buckets or []), self.seed,
                     self.mirrored_knobs()))
        with self.on_mesh():
            self._warmup(buckets or [])

    def _warmup(self, buckets: List[int]) -> None:
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
        for b in buckets:
            if 16 < b < self.max_len and (not self.paged or
                                          b <= self.prefill_chunk):
                self._admit_group([Request(list(range(1, b + 1)), 1)])
                self._drop_all_slots()
        if self.paged and knobs.get_bool('SKYTPU_ENGINE_WARM_DISAGG'):
            self._warm_disagg_grid()
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
        self.step_count = self.tokens_generated = 0
        self.prefix_hits = self.prefill_chunks = 0
        self.spec_rounds = self.spec_proposed = self.spec_accepted = 0
        self._spec_cool = 0
        # Warm-up's synthetic admits and steps pollute neither the
        # metrics (its capture times would wreck the histograms) nor
        # the flight ring (a dump starts at real traffic).
        self.metrics.reset()
        # A contiguous replica publishes no backend gauge (no paged
        # attention serves there), as in JAX.
        backend = self.attn_backend_served()
        for b in ATTN_BACKENDS if backend is not None else ():
            self.metrics.attn_backend.set(1.0 if b == backend else 0.0,
                                          backend=b)
        self.metrics.kv_pages_quantized.set(
            self.n_pages - 1 if self.kv_quant == 'int8' else 0)
        # The KV-hierarchy gauges from live state; warm-up's synthetic
        # captures do not count towards the sessions peak.
        self.metrics.kv_pages_spilled.set(
            self.host_store.pages_spilled() if self.host_store else 0)
        self._kv_sessions_peak = 0
        self.metrics.kv_sessions_peak.set(0)
        self.flight.clear()
        self.warm = True

    def all_buckets(self) -> List[int]:
        """Every prompt bucket a request can take: powers of two from
        16 below max_len."""
        out, b = [], decode.bucket_size(1)
        while b < self.max_len:
            out.append(b)
            b *= 2
        return out

    def _warm_disagg_grid(self) -> None:
        """``SKYTPU_ENGINE_WARM_DISAGG``: run the adopt (scatter) and the
        export (gather + copy to the host) once per prompt bucket through
        the real code path — reserve a free slot's pages, adopt zero
        rows, export them back, release — so that the first handoff of
        each bucket allocates nothing new. The slot is never activated."""
        # The rows a handoff ships: the pool's dtype, fp32 off an int8
        # pool (gather_prefix dequantizes).
        dtype = (torch.float32 if paging.quantized(self.cache) else None)
        pools = list(paging._pools(self.cache).values())
        for b in self.all_buckets():
            need = paging.pages_for(b, self.page_size)
            if not self.alloc.can_fit(need):
                continue
            slot = self._free_slot()
            self._reserve_slot_pages(slot, self._alloc_pages(need))
            self._refresh_table()
            rows = [torch.zeros((p.shape[0], 1, b, *p.shape[3:]),
                                dtype=dtype or p.dtype, device=self.device)
                    for p in pools]
            with torch.no_grad():
                paging.adopt_rows(self.cache, *rows, slot, b, b)
                for t in paging.gather_prefix(self.cache, slot, b):
                    t.cpu()
            self.cache.length[slot] = 0
            self._release_slot_pages(slot)

    def _step_round(self) -> None:
        """One scheduling round of device work: a speculative round when
        it applies, else pipelined — dispatch call N, then, while
        ``_lookahead_k`` allows, dispatch call N+1 BEFORE collecting
        call N, publishing after every collect. A gang's followers get
        ('step', k) at every dispatch and ('collect',) before every
        collect (('reap',) rides in every publish), so they replay the
        same interleaving."""
        k = self._choose_k()
        self._bcast(('step', k))
        inflight = self._step_or_dispatch(k)
        if inflight is None:
            return
        while True:
            k2 = self._lookahead_k(inflight.k)
            if k2 is None:
                break
            self._bcast(('step', k2))
            nxt = self._dispatch_step(k2)
            self._bcast(('collect',))
            self._collect_step()
            self._publish()
            inflight = nxt
        self._bcast(('collect',))
        self._collect_step()

    def batch_loop(self) -> None:
        """Continuous scheduler: admit whenever a slot and pages are
        free, advance one pending chunk a round, step while anything is
        active, publish after each. A failure outside the contained
        admit/chunk/step (warm-up included) is kept in ``loop_error``
        and ``/health`` answers 500."""
        try:
            with self.on_mesh():
                self._batch_loop()
        except Exception as e:  # pylint: disable=broad-except
            logger.error('engine batch loop died: %s\n%s', e,
                         traceback.format_exc())
            self.loop_error = e
            raise

    def _batch_loop(self) -> None:
        if not self.warm:
            self.warmup(self.warm_buckets)
        while not self._stop.is_set():
            # Drained point: no call in flight.
            self._process_cancels()
            if self._sweep_due():
                # The idle wait below polls every 50 ms, so cold
                # sessions spill even when no request arrives.
                try:
                    self._sweep_idle_prefixes()
                except Exception as e:  # pylint: disable=broad-except
                    self._fail_all(e)
                    continue
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
                self._bcast(('chunk', slot))
                try:
                    self._advance_chunk(slot)
                except Exception as e:  # pylint: disable=broad-except
                    self._fail_all(e)
                    continue
                self._publish()
            if not any(self._row_active(s) for s in self.slots):
                continue
            try:
                self._step_round()
            except Exception as e:  # pylint: disable=broad-except
                self._fail_all(e)
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
        """Stop the batch loop; a gang's leader then sends ('stop',), on
        which its followers return."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                raise RuntimeError('engine batch loop did not stop')
        if self._leader is not None:
            self._bcast(('stop',))
            self._leader.close()
            self._leader = None


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


def _resolve_prompts(engine: InferenceEngine, prompt) -> List[List[int]]:
    """OpenAI ``prompt`` → one token-id list per prompt: a string, a
    token-id list, a list of strings or a list of token-id lists (the
    batched forms eval harnesses send; each is its own choice), as JAX
    ``_resolve_prompts``."""
    def encode(p) -> List[int]:
        if isinstance(p, list):
            if not all(isinstance(t, int) for t in p):
                raise ValueError('a prompt list must be all token ids')
            return [int(t) for t in p]
        return [int(t) for t in engine.tokenizer.encode(str(p))]

    if isinstance(prompt, list) and prompt and all(
            isinstance(t, int) for t in prompt):
        return [encode(prompt)]
    if isinstance(prompt, list):
        if not prompt:
            raise ValueError('empty prompt list')
        return [encode(p) for p in prompt]
    return [encode(prompt)]


def _parse_n(body, max_batch: int) -> Tuple[int, int]:
    """OpenAI ``n`` / ``best_of``: n samples returned, best_of generated
    and ranked by mean token logprob; both bounded by the slot pool
    (JAX ``_parse_n``)."""
    n = body.get('n')
    n = 1 if n is None else int(n)
    best_of = body.get('best_of')
    best_of = n if best_of is None else int(best_of)
    if not 1 <= n <= max_batch:
        raise ValueError(f'n must be in [1, {max_batch}]')
    if not n <= best_of <= max_batch:
        raise ValueError(f'best_of must be in [n, {max_batch}]')
    return n, best_of


def _wait(engine: InferenceEngine, fut: concurrent.futures.Future):
    """A request's result, checking every second that the batch loop is
    still alive: a dead or stopped loop raises instead of leaving the
    handler waiting forever."""
    while True:
        try:
            return fut.result(timeout=1.0)
        except concurrent.futures.TimeoutError:
            if engine.loop_error is not None or engine._stop.is_set():
                raise RuntimeError(
                    f'engine stopped: {engine.loop_error}') from None


def _cancel_all(engine: InferenceEngine, futs) -> None:
    """Cut every unfinished request of a fan-out: a queued one is
    skipped at admission, an admitted or held one is cancelled at the
    next drained point."""
    for f in futs:
        if not f.done():
            engine.cancel(f)
            f.cancel()


def _submit_many(engine: InferenceEngine, prompts, max_new: int, sampling,
                 stop_ids, n: int, best_of: int, want_tops: bool,
                 cls: str):
    """Fan prompts × best_of out into the continuous batcher, rank each
    prompt's candidates by mean token logprob and keep n per prompt
    (JAX ``_submit_many``): (results, every token generated, the
    discarded candidates' too). Enqueue is all or nothing: a 429 in
    the middle cancels the siblings already enqueued; a reset cancels
    the siblings still running, resurrected ones included."""
    futs = []
    try:
        for tokens in prompts:
            for _ in range(best_of):
                futs.append(engine.submit(tokens, max_new, *sampling,
                                          stop_ids=stop_ids,
                                          want_tops=want_tops, cls=cls))
    except EngineOverloaded:
        _cancel_all(engine, futs)
        raise
    try:
        all_res = [_wait(engine, f) for f in futs]
    except Exception:
        _cancel_all(engine, futs)
        raise
    generated = sum(len(r[0]) for r in all_res)
    results = []
    for p in range(len(prompts)):
        cand = all_res[p * best_of:(p + 1) * best_of]
        if best_of > n:
            cand.sort(key=lambda r: -(sum(r[2]) / max(len(r[2]), 1)))
        results.extend(cand[:n])
    return results, generated


def _completion_chunks(meta, top_n: int, tokenizer):
    """The SSE payloads of /v1/completions choices: ``make(delta,
    finish, first=False, lp=None, index=0)`` yields the events for one
    token's text (with its logprob info), the finish, or the stream's
    opening (none)."""
    def make(delta, finish, first=False, lp=None, index=0):
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
            {'text': delta or '', 'index': index, 'logprobs': lp_obj,
             'finish_reason': finish}]}
    return make


def _chat_chunks(meta, top_n: int, tokenizer):
    """The SSE payloads of /v1/chat/completions choices (JAX
    ``openai_chat``'s ``make_chunks``): the opening delta with the role,
    a content delta per token (chat-format logprobs), then an empty
    delta with the finish reason."""
    def make(delta, finish, first=False, lp=None, index=0):
        if first:
            yield {**meta, 'choices': [{
                'index': index, 'delta': {'role': 'assistant',
                                          'content': ''},
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
                'index': index, 'delta': {'content': delta or ''},
                'logprobs': lp_obj, 'finish_reason': None}]}
        if finish is not None:
            yield {**meta, 'choices': [{
                'index': index, 'delta': {}, 'finish_reason': finish}]}
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


class _ChoiceQueue:
    """One streamed choice's end of the handler's merged queue: the
    engine puts (token, logprob, tops) and None, the handler reads
    (choice index, item) as the batcher steps the pool."""

    __slots__ = ('merged', 'idx')

    def __init__(self, merged: 'queue.Queue', idx: int):
        self.merged, self.idx = merged, idx

    def put(self, item) -> None:
        self.merged.put((self.idx, item))


class _SseChoice:
    """One streamed choice: its index and future, incremental
    detokenization, the stop-string holdback buffer (pieces paired with
    their token's logprob info) and the text offset."""

    def __init__(self, tokenizer, idx: int, fut):
        self.idx, self.fut = idx, fut
        self.decoder = StreamDecoder(tokenizer)
        self.pend: List[list] = []    # [piece_text, lp, tops]
        self.pend_chars = 0
        self.emitted = 0              # chars sent (text_offset)
        self.stopped = False


def _usage(n_prompt: int, n_out: int) -> Dict[str, int]:
    return {'prompt_tokens': n_prompt, 'completion_tokens': n_out,
            'total_tokens': n_prompt + n_out}


def _reset_doc(e: EngineResetError) -> Dict[str, Any]:
    """JAX's structured body of a reset: retriable, with the count of
    tokens the request had emitted."""
    return {'error': {'message': str(e), 'type': 'engine_reset_error',
                      'retriable': True,
                      'tokens_emitted': e.tokens_emitted}}


def build_app(engine: InferenceEngine, host: str = '127.0.0.1',
              port: int = 0) -> ThreadingHTTPServer:
    """A ThreadingHTTPServer bound to (host, port) serving ``GET
    /health`` (and ``/``, the serve spec's default readiness path),
    ``/metrics``, ``/debug/flight`` and ``/v1/models``, and ``POST
    /generate``, ``/v1/completions`` and ``/v1/chat/completions`` (JSON
    or SSE), ``/disagg/prefill`` and ``/disagg/continue``; with
    ``engine.handoff_port`` set it also starts the KV handoff receiver
    on (host, handoff_port). The caller runs ``serve_forever`` (in a
    thread) and ``shutdown``/``server_close`` when done (the latter
    stops the receiver)."""

    class Handler(BaseHTTPRequestHandler):
        protocol_version = 'HTTP/1.1'

        def log_message(self, fmt, *args):  # quiet: no per-request lines
            del fmt, args

        def _send(self, status: int, body: bytes, ctype: str,
                  headers: Optional[Dict[str, str]] = None) -> None:
            self.send_response(status)
            self.send_header('Content-Type', ctype)
            self.send_header('Content-Length', str(len(body)))
            for name, value in (headers or {}).items():
                self.send_header(name, value)
            self.end_headers()
            self.wfile.write(body)

        def _json(self, status: int, doc: Dict[str, Any],
                  headers: Optional[Dict[str, str]] = None) -> None:
            self._send(status, json.dumps(doc).encode(), 'application/json',
                       headers)

        def _openai_error(self, msg: str, status: int = 400,
                          err_type: str = 'invalid_request_error') -> None:
            self._json(status, {'error': {'message': msg, 'type': err_type}})

        def _reset_error(self, e: EngineResetError) -> None:
            self._json(503, _reset_doc(e), {'Retry-After': '1'})

        def _body(self) -> Dict[str, Any]:
            n = int(self.headers.get('Content-Length', 0))
            body = json.loads(self.rfile.read(n) or b'{}')
            if not isinstance(body, dict):
                raise ValueError('body must be a JSON object')
            return body

        def do_GET(self):  # noqa: N802 (http.server naming)
            url = urllib.parse.urlsplit(self.path)
            if url.path == '/v1/models':
                return self._json(200, {'object': 'list', 'data': [
                    {'id': engine.model_name, 'object': 'model',
                     'owned_by': 'skytpu'}]})
            if url.path == '/metrics':
                return self._metrics()
            if url.path == '/debug/flight':
                return self._flight(url.query)
            if url.path not in ('/health', '/'):
                return self._json(404, {'error': 'not found'})
            if engine.loop_error is not None:
                return self._json(500, {'status': 'failed',
                                        'error': str(engine.loop_error)})
            if not engine.warm:
                return self._json(503, {'status': 'warming'})
            # The saturation doc the fleet scraper reads.
            doc = {'status': 'ok', 'queue_depth': engine.queue_depth(),
                   'in_flight': engine.in_flight()}
            if engine.alloc is not None:
                doc['kv_pages_free'] = engine.alloc.free_count
            if engine.host_store is not None:
                # The host tier's occupancy: the headroom the KV
                # hierarchy adds.
                doc['kv_host'] = engine.host_store.occupancy()
            if engine.kv_quant != 'none':
                doc['kv_quant'] = engine.kv_quant
            if engine.role:
                doc['role'] = engine.role
            if engine.handoff_store is not None:
                doc['handoff_port'] = engine.handoff_port
                doc['handoff_staged'] = len(engine.handoff_store)
            return self._json(200, doc)

        def _metrics(self) -> None:
            """The text exposition of the engine's registry, its gauges
            sampled now."""
            m = engine.metrics
            m.queue_depth.set(engine.queue_depth())
            m.in_flight.set(engine.in_flight())
            if engine.alloc is not None:
                m.pages_free.set(engine.alloc.free_count)
                m.pages_used.set(engine.alloc.used_count)
            if engine.host_store is not None:
                m.kv_pages_spilled.set(engine.host_store.pages_spilled())
            if engine.handoff_store is not None:
                m.handoff_staged.set(len(engine.handoff_store))
            self._send(200, m.registry.render().encode(),
                       'text/plain; charset=utf-8')

        def _flight(self, query: str) -> None:
            """The flight ring, newest last: ``?limit=N`` keeps the newest
            N (default 4096; 0 means all)."""
            try:
                limit = int(urllib.parse.parse_qs(query).get(
                    'limit', ['4096'])[0])
            except ValueError:
                return self._json(400, {'error': 'bad limit'})
            events = engine.flight.dump(limit if limit > 0 else None)
            return self._json(200, {'capacity': engine.flight.capacity,
                                    'count': len(events), 'events': events})

        def do_POST(self):  # noqa: N802
            url = urllib.parse.urlsplit(self.path)
            if url.path == '/generate':
                return self._generate()
            if url.path == '/v1/completions':
                return self._completions()
            if url.path == '/v1/chat/completions':
                return self._chat()
            if url.path in ('/disagg/prefill', '/disagg/continue'):
                if not engine.paged:
                    return self._json(501, {'error': {
                        'message': 'disagg requires paged mode '
                                   '(SKYTPU_ENGINE_PAGED=1)',
                        'type': 'handoff_unsupported'}})
                if engine.mesh is not None:
                    return self._json(501, {'error': {
                        'message': 'disaggregated prefill/decode on a gang '
                                   'of ranks is not ported yet (it waits '
                                   'for ROADMAP Queue 1 item 8)',
                        'type': 'handoff_unsupported'}})
                orig = urllib.parse.parse_qs(url.query).get(
                    'orig', ['/generate'])[0]
                if url.path == '/disagg/prefill':
                    return self._disagg_prefill(orig)
                return self._disagg_continue(orig)
            return self._json(404, {'error': 'not found'})

        def _cls(self) -> str:
            return request_class.from_headers(self.headers)

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
                                    stop_ids=stop_ids, cls=self._cls())
            except EngineOverloaded as e:
                return self._json(429, {'error': str(e)})
            try:
                out, finish, lps, _ = _wait(engine, fut)
            except EngineResetError as e:
                return self._reset_error(e)
            except Exception as e:  # pylint: disable=broad-except
                return self._json(503, {'error': f'engine failure: {e}'})
            resp = {'tokens': out, 'finish_reason': finish, 'logprobs': lps}
            if 'text' in body:
                resp['text'] = engine.tokenizer.decode(out)
            return self._json(200, resp)

        def _completions(self) -> None:
            """OpenAI completions (JAX ``openai_completions``): a prompt
            (text or token ids) or a batch of them, n and best_of,
            max_tokens, temperature (default 1.0), top_k, top_p, both
            penalties, logprobs = N <= 5, stop, stop_token_ids,
            ignore_eos and stream (SSE, one indexed choice per prompt ×
            n; best_of > n is refused with it)."""
            try:
                body = self._body()
                prompts = _resolve_prompts(engine, body.get('prompt', ''))
                if any(not t for t in prompts):
                    raise ValueError('empty prompt')
                max_new = int(body.get('max_tokens', 16))
                if max_new < 1:
                    raise ValueError('max_tokens must be >= 1')
                sampling = _parse_sampling(body, default_temperature=1.0)
                stop_ids = _parse_stop_ids(body, engine.tokenizer)
                stops = _stop_list(body.get('stop'))
                want_logprobs, top_n = _parse_logprobs(body)
                n, best_of = _parse_n(body, engine.max_batch)
                if body.get('stream') and best_of > n:
                    raise ValueError('best_of > n is not supported with '
                                     'stream=true')
            except (TypeError, ValueError) as e:
                return self._openai_error(f'invalid request: {e}')
            for tokens in prompts:
                msg = engine.check_len(tokens, max_new)
                if msg:
                    return self._openai_error(msg)
            meta = {'id': f'cmpl-{time.time_ns()}',
                    'object': 'text_completion', 'created': int(time.time()),
                    'model': body.get('model', engine.model_name)}
            want_tops = want_logprobs and top_n > 0
            if body.get('stream'):
                return self._stream(
                    [t for t in prompts for _ in range(n)], max_new,
                    sampling, stop_ids, want_tops, stops, want_logprobs,
                    top_n, _completion_chunks(meta, top_n, engine.tokenizer))
            got = self._fan_out(prompts, max_new, sampling, stop_ids, n,
                                best_of, want_tops)
            if got is None:
                return None
            results, n_out = got
            choices = []
            for idx, (out, finish, lps, tops) in enumerate(results):
                text, finish = self._cut(out, finish, stops)
                lp_obj = None
                if want_logprobs:
                    lp_obj = _completion_logprobs(
                        engine.tokenizer, out, lps, text,
                        tops=[t[:top_n] for t in tops] if top_n else None)
                choices.append({'text': text, 'index': idx,
                                'logprobs': lp_obj, 'finish_reason': finish})
            return self._json(200, {
                **meta, 'choices': choices,
                'usage': _usage(sum(len(t) for t in prompts), n_out)})

        def _chat(self) -> None:
            """OpenAI chat completions (JAX ``openai_chat``): the
            messages templated for the tokenizer's chat family, encoded
            with add_special_tokens=False (the template carries its
            specials); n (best_of is refused), max_tokens or
            max_completion_tokens (default 256), temperature (default
            1.0), top_k, top_p, penalties, logprobs=true with
            top_logprobs <= 5, stop, stop_token_ids, ignore_eos and
            stream (SSE)."""
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
                if body.get('best_of') is not None:
                    raise ValueError('best_of is not supported on '
                                     '/v1/chat/completions; use n')
                n, _ = _parse_n(body, engine.max_batch)
            except (TypeError, ValueError) as e:
                return self._openai_error(f'invalid request: {e}')
            msg = engine.check_len(tokens, max_new)
            if msg:
                return self._openai_error(msg)
            meta = {'id': f'chatcmpl-{time.time_ns()}',
                    'object': 'chat.completion', 'created': int(time.time()),
                    'model': body.get('model', engine.model_name)}
            want_tops = want_logprobs and top_n > 0
            if body.get('stream'):
                return self._stream(
                    [tokens] * n, max_new, sampling, stop_ids, want_tops,
                    stops, want_logprobs, top_n,
                    _chat_chunks({**meta, 'object': 'chat.completion.chunk'},
                                 top_n, engine.tokenizer))
            got = self._fan_out([tokens], max_new, sampling, stop_ids, n, n,
                                want_tops)
            if got is None:
                return None
            results, n_out = got
            choices = []
            for idx, (out, finish, lps, tops) in enumerate(results):
                text, finish = self._cut(out, finish, stops)
                lp_obj = (_chat_logprobs(engine.tokenizer, out, lps, text,
                                         tops, top_n)
                          if want_logprobs else None)
                choices.append({'index': idx,
                                'message': {'role': 'assistant',
                                            'content': text},
                                'logprobs': lp_obj, 'finish_reason': finish})
            return self._json(200, {**meta, 'choices': choices,
                                    'usage': _usage(len(tokens), n_out)})

        def _fan_out(self, prompts, max_new, sampling, stop_ids, n, best_of,
                     want_tops: bool):
            """_submit_many's (results, tokens generated), or None after
            answering 429 or 503."""
            try:
                return _submit_many(engine, prompts, max_new, sampling,
                                    stop_ids, n, best_of, want_tops,
                                    self._cls())
            except EngineOverloaded as e:
                return self._openai_error(str(e), status=429,
                                          err_type='overloaded_error')
            except EngineResetError as e:
                return self._reset_error(e)
            except Exception as e:  # pylint: disable=broad-except
                return self._openai_error(f'engine failure: {e}', 503,
                                          'server_error')

        # -- disaggregated prefill/decode (serve/disagg) ---------------------
        def _disagg_done_doc(self, orig: str, body, out, finish, lps,
                             n_prompt: int) -> Dict[str, Any]:
            """The answer, in the ORIGINAL endpoint's shape, of a request
            that completed on this replica."""
            if orig == '/v1/completions':
                return {'id': f'cmpl-{time.time_ns()}',
                        'object': 'text_completion',
                        'created': int(time.time()),
                        'model': body.get('model', engine.model_name),
                        'choices': [{'text': engine.tokenizer.decode(out),
                                     'index': 0, 'logprobs': None,
                                     'finish_reason': finish}],
                        'usage': _usage(n_prompt, len(out))}
            doc = {'tokens': out, 'finish_reason': finish, 'logprobs': lps}
            if 'text' in body:
                doc['text'] = engine.tokenizer.decode(out)
            return doc

        def _disagg_prefill(self, orig: str) -> None:
            """Stage 1 of the two-stage pipeline (the LB drives it):
            prefill the prompt and sample its first token here, export
            the row, ship it npy-framed to the decode replica named by
            ``X-Skytpu-Handoff-Target`` and answer with the handoff id
            the LB passes to /disagg/continue — or ``{'done': ...}``
            when the request completed at admission. The body is the
            ORIGINAL endpoint's (``?orig=`` names it: /generate or a
            single-choice /v1/completions)."""
            target = self.headers.get('X-Skytpu-Handoff-Target',
                                      '').strip()
            if not target:
                return self._json(400, {
                    'error': 'missing X-Skytpu-Handoff-Target header'})
            try:
                body = self._body()
            except ValueError:
                return self._json(400, {'error': 'bad json'})
            want_tops = False
            try:
                if orig == '/v1/completions':
                    prompts = _resolve_prompts(engine,
                                               body.get('prompt', ''))
                    if len(prompts) != 1 or not prompts[0]:
                        raise ValueError('disagg prefill serves exactly '
                                         'one non-empty prompt')
                    tokens = prompts[0]
                    max_new = int(body.get('max_tokens', 16))
                    sampling = _parse_sampling(body,
                                               default_temperature=1.0)
                    stop_ids = _parse_stop_ids(body, engine.tokenizer)
                    want_logprobs, top_n = _parse_logprobs(body)
                    want_tops = want_logprobs and top_n > 0
                    if _parse_n(body, engine.max_batch) != (1, 1):
                        raise ValueError('disagg prefill serves '
                                         'single-choice requests (n=1)')
                elif orig == '/generate':
                    if 'text' in body:
                        tokens = [int(t) for t in engine.tokenizer.encode(
                            str(body['text']))]
                    else:
                        tokens = [int(t) for t in body['tokens']]
                    if not tokens:
                        raise ValueError('empty prompt')
                    max_new = int(body.get('max_new_tokens', 64))
                    sampling = _parse_sampling(body)
                    stop_ids = tuple(int(i)
                                     for i in body.get('stop_token_ids', ()))
                else:
                    raise ValueError(f'unsupported orig endpoint {orig!r}')
                if max_new < 1:
                    raise ValueError('max new tokens must be >= 1')
            except (TypeError, ValueError, KeyError) as e:
                return self._json(400, {'error': f'invalid request: {e}'})
            msg = engine.check_len(tokens, max_new)
            if msg:
                return self._json(400, {'error': msg})
            cls = self._cls()
            try:
                fut = engine.submit(tokens, max_new, *sampling,
                                    stop_ids=stop_ids, want_tops=want_tops,
                                    cls=cls, prefill_export=True)
            except EngineOverloaded as e:
                return self._json(429, {'error': str(e)})
            try:
                out, finish, lps, tops = _wait(engine, fut)
            except EngineResetError as e:
                return self._reset_error(e)
            except Exception as e:  # pylint: disable=broad-except
                return self._json(503, {'error': f'engine failure: {e}'})
            blob = engine.pop_export(fut)
            if finish != 'handoff':
                # Completed at admission: nothing to hand off.
                return self._json(200, {'done': self._disagg_done_doc(
                    orig, body, out, finish, lps, len(tokens))})
            if blob is None:
                return self._json(503, {'error': {
                    'message': 'export blob lost before send',
                    'type': 'handoff_send_error', 'retriable': True}},
                    {'Retry-After': '1'})
            temperature, top_k, top_p, pres, freq = sampling
            arrays = {'a': blob['a'], 'b': blob['b']}
            meta = handoff_lib.build_meta(
                handoff_id=handoff_lib.new_handoff_id(),
                model=engine.model_name, vocab_size=engine.cfg.vocab_size,
                page_size=engine.page_size, family=engine.cache_family(),
                bucket=blob['bucket'], tokens=tokens, max_new=max_new,
                first_token=int(out[0]),
                first_lp=float(lps[0]) if lps else 0.0,
                first_tops=[list(t) for t in tops[0]] if tops else [],
                temperature=temperature, top_k=top_k, top_p=top_p,
                presence_penalty=pres, frequency_penalty=freq,
                stop_ids=list(stop_ids), want_tops=want_tops, cls=cls,
                kv_sha256=handoff_lib.kv_fingerprint(arrays))
            try:
                handoff_lib.send(framed.parse_addr(target), meta, arrays)
            except handoff_lib.HandoffError as e:
                engine.metrics.handoff.inc(stage='send', outcome='error')
                return self._json(
                    503 if e.retriable else 400,
                    {'error': {'message': str(e),
                               'type': 'handoff_send_error',
                               'kind': e.kind, 'retriable': e.retriable}},
                    {'Retry-After': '1'} if e.retriable else None)
            engine.metrics.handoff.inc(stage='send', outcome='ok')
            return self._json(200, {'handoff': {
                'id': meta['handoff_id'], 'first_token': int(out[0]),
                'prompt_tokens': len(tokens)}})

        def _disagg_continue(self, orig: str) -> None:
            """Stage 2: adopt the staged rows into this replica's pool
            and decode, answering in the ORIGINAL endpoint's shape
            (``?orig=``), SSE included (the completions chunk shape). A
            missing handoff (expired, consumed, or never received) is a
            structured retriable 503: the LB re-runs the pipeline."""
            if engine.handoff_store is None:
                return self._json(501, {'error': {
                    'message': 'no handoff receiver on this replica (set '
                               '--handoff-port)',
                    'type': 'handoff_unsupported'}})
            try:
                body = self._body()
            except ValueError:
                return self._json(400, {'error': 'bad json'})
            hid = str(body.get('handoff_id', ''))
            entry = engine.handoff_store.pop(hid) if hid else None
            engine.metrics.handoff_staged.set(len(engine.handoff_store))
            if entry is None:
                return self._json(503, {'error': {
                    'message': f'handoff {hid!r} not staged (expired, '
                               f'consumed, or never received)',
                    'type': 'handoff_missing', 'retriable': True}},
                    {'Retry-After': '0'})
            meta, arrays = entry
            if not body.get('stream'):
                try:
                    fut = engine.submit_adopted(meta, arrays)
                except EngineOverloaded as e:
                    return self._json(429, {'error': str(e)})
                try:
                    out, finish, lps, _ = _wait(engine, fut)
                except EngineResetError as e:
                    return self._reset_error(e)
                except Exception as e:  # pylint: disable=broad-except
                    return self._json(503,
                                      {'error': f'engine failure: {e}'})
                return self._json(200, self._disagg_done_doc(
                    orig, body, out, finish, lps, len(meta['tokens'])))
            q: 'queue.Queue' = queue.Queue()
            try:
                fut = engine.submit_adopted(meta, arrays, stream=q)
            except EngineOverloaded as e:
                return self._json(429, {'error': str(e)})
            head = {'id': f'cmpl-{time.time_ns()}',
                    'object': 'text_completion', 'created': int(time.time()),
                    'model': body.get('model', engine.model_name)}

            def chunk(text: str, finish=None) -> Dict[str, Any]:
                return {**head, 'choices': [{
                    'text': text, 'index': 0, 'logprobs': None,
                    'finish_reason': finish}]}

            self.close_connection = True
            decoder = StreamDecoder(engine.tokenizer)
            try:
                self.send_response(200)
                self.send_header('Content-Type', 'text/event-stream')
                self.send_header('Cache-Control', 'no-cache')
                self.send_header('Transfer-Encoding', 'chunked')
                self.end_headers()
                while True:
                    try:
                        item = q.get(timeout=1.0)
                    except queue.Empty:
                        if engine.loop_error is not None or \
                                engine._stop.is_set():
                            break
                        continue
                    if item is None:
                        break
                    piece = decoder.feed([item[0]])
                    if piece:
                        self._event(chunk(piece))
                try:
                    _, finish, _, _ = _wait(engine, fut)
                except EngineResetError as e:
                    # The structured event is the truncation marker:
                    # [DONE] never arrives.
                    self._event(_reset_doc(e))
                except Exception as e:  # pylint: disable=broad-except
                    self._event({'error': {'message': str(e),
                                           'type': 'server_error'}})
                else:
                    self._event(chunk(decoder.flush(), finish))
                    self._chunk(b'data: [DONE]\n\n')
                self._chunk(b'')
            except (ConnectionError, OSError):
                engine.cancel(fut)

        @staticmethod
        def _cut(out, finish, stops: List[str]):
            """(text cut at the first stop string, finish reason)."""
            text = engine.tokenizer.decode(out)
            cut = _stop_scan(text, stops)
            if cut is not None:
                text, finish = text[:cut], 'stop'
            return text, finish

        # -- SSE ------------------------------------------------------------
        def _chunk(self, data: bytes) -> None:
            self.wfile.write(b'%x\r\n%s\r\n' % (len(data), data))

        def _event(self, payload) -> None:
            self._chunk(b'data: ' + json.dumps(payload).encode() + b'\n\n')

        def _stream(self, prompts, max_new, sampling, stop_ids,
                    want_tops: bool, stops: List[str], want_logprobs: bool,
                    top_n: int, make_chunks) -> None:
            """Enqueue one streamed choice per prompt, all or nothing (a
            429 in the middle cancels the siblings enqueued), then
            stream them."""
            merged: 'queue.Queue' = queue.Queue()
            choices: List[_SseChoice] = []
            cls = self._cls()
            try:
                for idx, tokens in enumerate(prompts):
                    fut = engine.submit(tokens, max_new, *sampling,
                                        stop_ids=stop_ids,
                                        want_tops=want_tops,
                                        stream=_ChoiceQueue(merged, idx),
                                        cls=cls)
                    choices.append(_SseChoice(engine.tokenizer, idx, fut))
            except EngineOverloaded as e:
                _cancel_all(engine, [ch.fut for ch in choices])
                return self._openai_error(str(e), status=429,
                                          err_type='overloaded_error')
            return self._sse(choices, merged, stops, want_logprobs, top_n,
                             make_chunks)

        def _sse(self, choices: List[_SseChoice], merged: 'queue.Queue',
                 stops: List[str], want_logprobs: bool, top_n: int,
                 make_chunks) -> None:
            """Stream the choices as server-sent events over chunked
            transfer, their tokens interleaved as the batcher steps the
            pool: ``make_chunks``' opening events for each choice, its
            events for each token (with its logprob info when asked),
            each choice's final events with its finish_reason, then
            ``data: [DONE]``. Stop strings are held back by len(longest)
            - 1 characters so a match split across tokens never leaks;
            on a match that choice is cancelled. A reset ends the stream
            with JAX's structured error event; a failed write (the
            client went away) cancels every choice."""
            hold = max((len(s) for s in stops), default=0) - 1
            self.close_connection = True

            def send(ch: _SseChoice, text, lp=None, finish=None,
                     first=False) -> None:
                for payload in make_chunks(text, finish, first=first,
                                           lp=lp, index=ch.idx):
                    self._event(payload)

            def emit_piece(ch: _SseChoice, piece: str, lp, tops) -> None:
                lp_info = ((piece, lp, tops[:top_n], ch.emitted)
                           if want_logprobs and lp is not None else None)
                if not piece and lp_info is None:
                    return
                send(ch, piece, lp_info)
                ch.emitted += len(piece)

            def emit_until(ch: _SseChoice, cut: int) -> None:
                remaining = cut
                for p_text, p_lp, p_tops in ch.pend:
                    if remaining <= 0:
                        break
                    emit_piece(ch, p_text[:min(len(p_text), remaining)],
                               p_lp, p_tops)
                    remaining -= len(p_text)

            def on_token(ch: _SseChoice, item) -> None:
                tok, lp, tops = item
                piece = ch.decoder.feed([tok])
                ch.pend.append([piece, lp, tops])
                ch.pend_chars += len(piece)
                cut = _stop_scan(''.join(p[0] for p in ch.pend), stops)
                if cut is not None:
                    engine.cancel(ch.fut)
                    emit_until(ch, cut)
                    ch.pend, ch.stopped = [], True
                    return
                while ch.pend and ch.pend_chars - len(ch.pend[0][0]) >= hold:
                    p_text, p_lp, p_tops = ch.pend.pop(0)
                    ch.pend_chars -= len(p_text)
                    emit_piece(ch, p_text, p_lp, p_tops)

            def finish_choice(ch: _SseChoice) -> None:
                _, finish, _, _ = _wait(engine, ch.fut)
                if ch.stopped:
                    finish = 'stop'
                else:
                    tail = ch.decoder.flush()
                    if tail:
                        if ch.pend:
                            ch.pend[-1][0] += tail
                        else:
                            ch.pend.append([tail, None, []])
                    joined = ''.join(p[0] for p in ch.pend)
                    cut = _stop_scan(joined, stops)
                    if cut is not None:
                        finish = 'stop'
                    emit_until(ch, len(joined) if cut is None else cut)
                send(ch, None, finish=finish)

            try:
                self.send_response(200)
                self.send_header('Content-Type', 'text/event-stream')
                self.send_header('Cache-Control', 'no-cache')
                self.send_header('Transfer-Encoding', 'chunked')
                self.end_headers()
                try:
                    for ch in choices:
                        send(ch, None, first=True)
                    live = len(choices)
                    while live:
                        try:
                            idx, item = merged.get(timeout=1.0)
                        except queue.Empty:
                            if engine.loop_error is not None or \
                                    engine._stop.is_set():
                                raise RuntimeError(
                                    'engine stopped: '
                                    f'{engine.loop_error}') from None
                            continue
                        ch = choices[idx]
                        if item is None:
                            finish_choice(ch)
                            live -= 1
                        elif not ch.stopped:
                            on_token(ch, item)
                    self._chunk(b'data: [DONE]\n\n')
                except (ConnectionError, OSError):
                    raise
                except Exception as e:  # pylint: disable=broad-except
                    # The status line went out: an error event is the
                    # only signal left, structured for a reset.
                    logger.warning('SSE stream aborted: %s', e)
                    self._event(_reset_doc(e)
                                if isinstance(e, EngineResetError) else
                                {'error': {'message': str(e),
                                           'type': 'server_error'}})
                self._chunk(b'')
            except (ConnectionError, OSError):
                pass                      # the client went away
            finally:
                _cancel_all(engine, [ch.fut for ch in choices])

    server = _EngineServer((host, port), Handler)
    if engine.paged and engine.handoff_port:
        # The decode side's KV handoff listener (framed TCP) beside the
        # HTTP port: any paged engine with a handoff port can adopt, and
        # it still serves monolithic traffic.
        engine.handoff_store = handoff_lib.HandoffStore()
        engine._handoff_receiver = handoff_lib.HandoffReceiver(
            host, engine.handoff_port, engine.handoff_store,
            validate=engine.handoff_validate).start()
        server.receiver = engine._handoff_receiver
    return server


class _EngineServer(ThreadingHTTPServer):
    """The engine's HTTP server; ``server_close`` also stops the KV
    handoff receiver it started."""

    daemon_threads = True
    # The listen backlog: socketserver's default of 5 resets connections
    # of a burst that arrives while the accept loop lags; aiohttp, which
    # the JAX engine serves on, listens with 128.
    request_queue_size = 128
    receiver: Optional[handoff_lib.HandoffReceiver] = None

    def server_close(self) -> None:
        super().server_close()
        if self.receiver is not None:
            self.receiver.stop()
            self.receiver = None


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
    parser.add_argument('--seed', type=int, default=None,
                        help='Seed of the random weights and the sampler '
                             '(default 0; a gang\'s leader then draws the '
                             'sampling seed and ships it).')
    parser.add_argument('--quantize', choices=['int8'], default=None,
                        help='Weight-only int8 (the dense Llama and MLA '
                             'families; composes with --mesh).')
    parser.add_argument('--mesh', default=None,
                        help="Shard the replica over a gang of ranks, "
                             "'tensor=T' or 'expert=E,tensor=T' (with "
                             '--num-processes E*T: one process a rank).')
    parser.add_argument('--warm-buckets', default='all',
                        help="Comma-separated prompt buckets to admit once "
                             "in warm-up, or 'all' (the default).")
    # One replica over a gang of processes: the defaults come from the
    # gang env, so a gang launch needs no extra flags.
    parser.add_argument('--coordinator',
                        default=knobs.get_str('SKYTPU_COORDINATOR_ADDRESS'),
                        help='The process group\'s host:port (rank 0 '
                             'listens there; the control channel at port '
                             f'+ {multihost.CONTROL_PORT_OFFSET}).')
    parser.add_argument('--num-processes', type=int,
                        default=knobs.get_int('SKYTPU_NUM_PROCESSES'))
    parser.add_argument('--process-id', type=int,
                        default=knobs.get_int('SKYTPU_NODE_RANK'))
    parser.add_argument('--port', type=int,
                        default=knobs.get_int('SKYTPU_SERVE_PORT'))
    parser.add_argument('--host', default='0.0.0.0')
    # The framed-TCP port this replica takes KV page handoffs on: -1 is
    # the HTTP port + HANDOFF_PORT_OFFSET (the convention the LB derives
    # decode targets from), 0 disables the receiver.
    parser.add_argument('--handoff-port', type=int,
                        default=knobs.get_int('SKYTPU_ENGINE_HANDOFF_PORT'),
                        help='KV handoff listener port (-1: HTTP port + '
                             f'{handoff_lib.HANDOFF_PORT_OFFSET}; 0: none).')
    return parser


def handoff_port_for(handoff_port: int, http_port: int) -> Optional[int]:
    """--handoff-port → the receiver's port, or None for none."""
    if handoff_port < 0:
        return http_port + handoff_lib.HANDOFF_PORT_OFFSET
    return handoff_port or None


def main(argv: Optional[List[str]] = None) -> None:
    """The engine's CLI. With ``--num-processes`` > 1 and a coordinator,
    one rank of a gang: rank 0 answers HTTP and leads, the others mirror
    its ops (serve/multihost.py ``follower_serve``) and return on its
    'stop'. SIGTERM stops the leader as Ctrl-C does: the server closes,
    the loop stops and the followers get 'stop'."""
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)
    multihost_on = bool(args.coordinator) and args.num_processes > 1
    if args.mesh and not multihost_on:
        raise ValueError(
            f'--mesh {args.mesh} needs --num-processes > 1 and '
            f'--coordinator: one process holds one rank of the mesh in '
            f'this port (a mesh in one process waits for ROADMAP Queue 1 '
            f'item 8)')
    device = args.device
    if multihost_on:
        multihost.require_token()   # refuse guessable tokens pre-boot
        if not args.mesh:
            raise ValueError('multi-host serving needs --mesh spanning the '
                             'ranks (e.g. tensor=2 over 2 processes).')
        # The mesh must span the gang: checked before joining the world.
        parse_mesh_arg(args.mesh).sizes(args.num_processes)
        device = mesh_lib.rank_device(device)
        mesh_lib.init_distributed(args.coordinator, args.num_processes,
                                  args.process_id, device)
    engine = InferenceEngine(
        args.model or (None if args.hf_dir else 'llama-1b'),
        ckpt_dir=args.ckpt_dir, hf_dir=args.hf_dir,
        tokenizer_path=args.tokenizer, max_len=args.max_len,
        device=str(device), seed=args.seed or 0, quantize=args.quantize,
        mesh=args.mesh)
    # A gang takes no KV handoff: page export across ranks waits.
    engine.handoff_port = (None if multihost_on else
                           handoff_port_for(args.handoff_port, args.port))
    if args.warm_buckets == 'all':
        engine.warm_buckets = engine.all_buckets()
    else:
        engine.warm_buckets = [int(b) for b in args.warm_buckets.split(',')
                               if b]
    if multihost_on and args.process_id != 0:
        # Follower: mirror the leader's ops (warmup arrives first); no
        # HTTP frontend.
        multihost.follower_serve(engine, args.coordinator)
        return
    if multihost_on:
        if args.seed is None:
            # Every rank of THIS gang draws the same samples, but
            # replicas and restarts must not correlate: the leader draws
            # the sampling seed and ships it in the warmup op.
            engine.seed = int(time.time_ns()) % (2 ** 31)
        engine._leader = multihost.ControlLeader(args.coordinator,
                                                 args.num_processes)
    server = build_app(engine, args.host, args.port)
    signal.signal(signal.SIGTERM, lambda *_: threading.Thread(
        target=server.shutdown, daemon=True).start())
    engine.start()
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        engine.stop()


if __name__ == '__main__':
    main()
