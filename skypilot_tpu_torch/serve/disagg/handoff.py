"""KV page handoff between prefill and decode replicas (a copy of
skypilot_tpu/serve/disagg/handoff.py, the same wire contract: a JAX
prefill replica can hand a request to a port decode replica, and the
reverse).

Wire format: ONE framed-TCP exchange (utils/framed.py) per handoff:

  request  {'op': 'handoff', 'meta': {...}}  + arrays {'a': ..., 'b': ...}
  reply    {'ok': True, 'handoff_id': ...}   (or {'error', 'kind'})

``meta`` carries everything the decode replica needs to continue the
request as if it had prefilled it itself: the prompt tokens, sampler
state, the sampled FIRST token and its logprobs, stop ids, the request
class and the export geometry (bucket, page size, family). ``arrays``
are the [L, 1, bucket, ...] contiguous per-token rows in
``models/paging.gather_prefix`` order — (k, v) for PagedKV, (c_kv,
k_rope) for PagedLatent — bf16 rows as CPU torch tensors. Page IDS
never cross the wire: the decode replica reserves pages through its
OWN allocator and scatters the rows in (``paging.adopt_rows``).

Integrity: ``meta['kv_sha256']`` is the arrays' content fingerprint,
recomputed on receive BEFORE staging — a truncated or bit-flipped row
refuses (kind ``integrity``). Config skew refuses with kind ``spec``
(never retried); a duplicate handoff id with kind ``duplicate``. Staged
handoffs wait in :class:`HandoffStore` as host memory only, swept after
``SKYTPU_HANDOFF_TTL`` seconds; device pages are reserved only when the
decode engine admits the request (``/disagg/continue``).

Failpoints: ``handoff.send`` (prefill side, before the socket op) and
``handoff.recv`` (decode side, inside the receiver handler).
"""
from __future__ import annotations

import hashlib
import logging
import threading
import time
import uuid
from typing import Any, Callable, Dict, List, Optional, Tuple

from skypilot_tpu_torch.utils import failpoints
from skypilot_tpu_torch.utils import framed
from skypilot_tpu_torch.utils import knobs

logger = logging.getLogger(__name__)

# The decode replica's handoff listener rides alongside its HTTP port
# at a fixed offset, so the LB (and the prefill replica it instructs)
# derives the handoff address from the replica URL it already routes
# to. Engines accept --handoff-port to override.
HANDOFF_PORT_OFFSET = 1000

# Whole-exchange deadline for one handoff send (connect + frame + ack).
SEND_TIMEOUT_ENV = 'SKYTPU_HANDOFF_TIMEOUT'

# Staged handoffs whose /disagg/continue never arrives are swept after
# this many seconds.
STORE_TTL_ENV = 'SKYTPU_HANDOFF_TTL'

# meta keys every handoff must carry — refused (kind 'spec') otherwise.
REQUIRED_META = ('handoff_id', 'model', 'vocab_size', 'page_size',
                 'family', 'bucket', 'tokens', 'max_new', 'first_token',
                 'kv_sha256')


class HandoffError(RuntimeError):
    """Prefill-side send failure (socket/protocol/refusal). ``kind``
    mirrors the framed reply's error kind; ``retriable`` is False only
    for configuration refusals (kind ``spec``)."""

    def __init__(self, message: str, kind: str = 'error'):
        super().__init__(message)
        self.kind = kind
        self.retriable = kind != 'spec'


def kv_fingerprint(arrays: Dict[str, Any]) -> str:
    """Content sha256 over the handoff arrays (name-ordered, shape and
    dtype included so a reshaped buffer can't collide). The same digest
    as the JAX package's for the same bytes: a bf16 tensor hashes as
    dtype ``bfloat16`` over its 2-byte words, a numpy-typed one as its
    numpy array."""
    h = hashlib.sha256()
    for name in sorted(arrays):
        a, ext = framed.to_wire(arrays[name])
        h.update(name.encode())
        h.update(str(a.shape).encode())
        h.update((ext or str(a.dtype)).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def new_handoff_id() -> str:
    return uuid.uuid4().hex


def handoff_addr_for_url(url: str,
                         offset: int = HANDOFF_PORT_OFFSET
                         ) -> Tuple[str, int]:
    """Replica HTTP url → its handoff (host, port): the fixed-offset
    convention the LB uses to point prefill replicas at decode
    replicas."""
    rest = url.split('://', 1)[-1].rstrip('/')
    host, port = framed.parse_addr(rest, default_port=8000)
    return host, port + offset


def send_timeout() -> float:
    return knobs.get_float(SEND_TIMEOUT_ENV)


def send(addr: Tuple[str, int], meta: Dict[str, Any],
         arrays: Dict[str, Any]) -> Dict[str, Any]:
    """Ship one handoff to a decode replica's receiver; returns the
    ack. Raises :class:`HandoffError` on any failure — socket errors
    and protocol refusals are retriable, ``spec``-kinded refusals are
    not. Blocking."""
    try:
        if failpoints.ACTIVE:
            # A firing is a transport failure (a prefill replica dying
            # mid-send), retriable like any socket fault below.
            failpoints.fire('handoff.send')
        reply, _ = framed.request(addr, {'op': 'handoff', 'meta': meta},
                                  arrays, timeout=send_timeout())
        return reply
    except framed.RemoteError as e:
        raise HandoffError(f'decode replica refused handoff: {e}',
                           kind=e.kind) from e
    except (framed.ProtocolError, OSError, failpoints.FailpointError) as e:
        raise HandoffError(
            f'handoff transport to {addr[0]}:{addr[1]} failed: '
            f'{type(e).__name__}: {e}') from e


class HandoffStore:
    """Decode-side staging for received handoffs, keyed by handoff id.

    Thread-safe: the receiver's connection threads put, the HTTP
    handlers pop. Entries are (meta, arrays) HOST tuples with a TTL
    sweep for orphans and a hard entry cap. Duplicate puts refuse, a
    duplicate arriving after its twin was adopted too: at-most-once
    admission."""

    def __init__(self, ttl: Optional[float] = None, max_entries: int = 256):
        if ttl is None:
            ttl = knobs.get_float(STORE_TTL_ENV)
        self.ttl = ttl
        self.max_entries = max_entries
        self._lock = threading.Lock()
        self._entries: Dict[str, Tuple[float, Dict[str, Any],
                                       Dict[str, Any]]] = {}
        self._consumed: Dict[str, float] = {}

    def put(self, meta: Dict[str, Any], arrays: Dict[str, Any]) -> None:
        hid = str(meta['handoff_id'])
        now = time.monotonic()
        with self._lock:
            self._sweep_locked(now)
            if hid in self._entries or hid in self._consumed:
                raise framed.RemoteError(
                    f'handoff {hid} already received — duplicate '
                    f'delivery refused (at-most-once adoption)',
                    kind='duplicate')
            if len(self._entries) >= self.max_entries:
                raise framed.RemoteError(
                    f'handoff store full ({self.max_entries} staged); '
                    f'retry shortly', kind='overloaded')
            self._entries[hid] = (now + self.ttl, meta, arrays)

    def pop(self, handoff_id: str
            ) -> Optional[Tuple[Dict[str, Any], Dict[str, Any]]]:
        now = time.monotonic()
        with self._lock:
            self._sweep_locked(now)
            entry = self._entries.pop(handoff_id, None)
            if entry is None:
                return None
            self._consumed[handoff_id] = now + self.ttl
            return entry[1], entry[2]

    def sweep(self) -> int:
        """Drop expired entries; returns how many were swept."""
        with self._lock:
            return self._sweep_locked(time.monotonic())

    def _sweep_locked(self, now: float) -> int:
        dead = [hid for hid, (exp, _, _) in self._entries.items()
                if exp <= now]
        for hid in dead:
            del self._entries[hid]
            logger.warning('handoff %s expired unconsumed after %.0fs — '
                           'swept (host memory only; no pages were held)',
                           hid, self.ttl)
        for hid in [h for h, exp in self._consumed.items() if exp <= now]:
            del self._consumed[hid]
        return len(dead)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


class HandoffReceiver:
    """The decode replica's framed-TCP listener.

    ``validate(meta) -> Optional[str]`` is the engine's compatibility
    check; a non-None return refuses the handoff with kind ``spec``.
    Integrity and duplicate refusals happen here too, BEFORE staging."""

    def __init__(self, host: str, port: int, store: HandoffStore,
                 validate: Optional[Callable[[Dict[str, Any]],
                                             Optional[str]]] = None):
        self.store = store
        self._validate = validate
        self._server = framed.FramedServer(host, port, self._handle,
                                           name='kv-handoff')
        self.addr = self._server.addr

    def start(self) -> 'HandoffReceiver':
        self._server.start()
        logger.info('KV handoff receiver listening on %s:%d.',
                    self.addr[0], self.addr[1])
        return self

    def stop(self) -> None:
        self._server.stop()

    def _handle(self, obj: Dict[str, Any], arrays: framed.Arrays
                ) -> Tuple[Dict[str, Any], Optional[framed.Arrays]]:
        if failpoints.ACTIVE:
            failpoints.fire('handoff.recv')
        if obj.get('op') != 'handoff':
            raise framed.RemoteError(
                f'unknown op {obj.get("op")!r}', kind='spec')
        meta = obj.get('meta')
        if not isinstance(meta, dict):
            raise framed.RemoteError('handoff without meta', kind='spec')
        missing = [k for k in REQUIRED_META if k not in meta]
        if missing:
            raise framed.RemoteError(
                f'handoff meta missing {missing}', kind='spec')
        if set(arrays) != {'a', 'b'}:
            raise framed.RemoteError(
                f'handoff arrays must be exactly {{a, b}}, got '
                f'{sorted(arrays)}', kind='spec')
        digest = kv_fingerprint(arrays)
        if digest != meta['kv_sha256']:
            raise framed.RemoteError(
                f'handoff {meta["handoff_id"]} KV fingerprint mismatch '
                f'(sent {meta["kv_sha256"][:12]}…, received '
                f'{digest[:12]}…) — refusing to adopt corrupted pages',
                kind='integrity')
        if self._validate is not None:
            msg = self._validate(meta)
            if msg:
                raise framed.RemoteError(msg, kind='spec')
        self.store.put(meta, dict(arrays))
        return {'ok': True, 'handoff_id': meta['handoff_id']}, None


def build_meta(*, handoff_id: str, model: str, vocab_size: int,
               page_size: int, family: str, bucket: int,
               tokens: List[int], max_new: int, first_token: int,
               first_lp: float, first_tops: List,
               temperature: float, top_k: Optional[int],
               top_p: Optional[float], presence_penalty: float,
               frequency_penalty: float, stop_ids: List[int],
               want_tops: bool, cls: str,
               kv_sha256: str) -> Dict[str, Any]:
    """The handoff meta document — one constructor so the prefill
    handler and the tests never drift on field names."""
    return {
        'handoff_id': handoff_id, 'model': model,
        'vocab_size': int(vocab_size), 'page_size': int(page_size),
        'family': family, 'bucket': int(bucket),
        'tokens': [int(t) for t in tokens], 'max_new': int(max_new),
        'first_token': int(first_token), 'first_lp': float(first_lp),
        'first_tops': first_tops or [],
        'temperature': float(temperature),
        'top_k': (int(top_k) if top_k else 0),
        'top_p': (float(top_p) if top_p else 0.0),
        'presence_penalty': float(presence_penalty),
        'frequency_penalty': float(frequency_penalty),
        'stop_ids': [int(i) for i in (stop_ids or ())],
        'want_tops': bool(want_tops), 'cls': cls,
        'kv_sha256': kv_sha256,
        'sent_unix': round(time.time(), 6),
    }
