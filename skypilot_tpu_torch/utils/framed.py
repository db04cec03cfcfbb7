"""Versioned framed-TCP transport with npy array payloads (a copy of
skypilot_tpu/utils/framed.py, wire format byte for byte: ``send_msg``,
``recv_msg``, ``request``, ``parse_addr``, ``FramedClient``,
``FramedServer``, ``Deadline`` and the error classes).

The disaggregated serving plane ships KV cache rows between prefill
and decode replicas over it (serve/disagg/handoff.py), the host spill
tier parks page blobs in its payload encoding (serve/host_store.py),
and the harvested-RL plane's workers and learner speak the rollout
dispatcher's protocol over it (train/rollout/). One frame = a 12-byte header (magic ``SKDT``,
protocol version, payload length) followed by the payload: a
u32-prefixed JSON control object plus zero or more u32-prefixed npy
arrays. npy (not pickle) is the wire format for arrays, read with
``allow_pickle=False``: a malicious peer can at worst send a wrong
array, never code.

bfloat16 has no numpy dtype here (the card's machine has no
``ml_dtypes``). A bf16 torch tensor goes on the wire as the JAX package
sends an ``ml_dtypes.bfloat16`` array: an npy of descr ``<V2`` holding
the raw 2-byte words, named ``bfloat16`` in the head's ``_dtypes``
sidecar; on receive such an array comes back as a CPU
``torch.bfloat16`` tensor over the same bytes (any other extension
dtype is refused). Every other array is numpy on receive; a torch
tensor of a dtype numpy has goes out as its numpy view.

Every socket operation carries a deadline: a dead peer costs bounded
time, never a hung caller. A version-mismatched peer is refused at the
first frame (:class:`VersionMismatchError`).
"""
from __future__ import annotations

import io
import json
import logging
import socket
import struct
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

logger = logging.getLogger(__name__)

MAGIC = b'SKDT'
VERSION = 1

# magic(4) | version(u16) | reserved(u16) | payload_len(u32)
_HEADER = struct.Struct('!4sHHI')
# json_len(u32) prefix inside the payload; each array is u32 len + npy.
_U32 = struct.Struct('!I')

# A batch/page frame is O(megabytes). A peer announcing more than this
# is broken or hostile; refuse before allocating.
MAX_FRAME_BYTES = 1 << 30

# numpy arrays, or torch tensors (any device; bf16 included).
Arrays = Dict[str, Any]

# bf16's name in the sidecar, as the JAX package's ml_dtypes gives it.
BF16 = 'bfloat16'


class ProtocolError(RuntimeError):
    """Malformed/truncated frame, bad magic, oversized payload."""


class VersionMismatchError(ProtocolError):
    """Peer speaks a different protocol version — refuse, never guess."""


class ProtocolTimeout(ProtocolError):
    """A socket op exceeded its deadline."""


class RemoteError(RuntimeError):
    """The peer answered with a structured error reply.

    ``kind`` classifies it: ``'spec'``-kinded errors are configuration
    refusals (never retried — a tokenizer/model mismatch does not heal);
    anything else is transient."""

    def __init__(self, message: str, kind: str = 'error'):
        super().__init__(message)
        self.kind = kind


class Deadline:
    """Monotonic budget shared by the socket ops of one exchange."""

    def __init__(self, seconds: Optional[float]):
        self._expires = (None if seconds is None
                         else time.monotonic() + seconds)

    def remaining(self) -> Optional[float]:
        if self._expires is None:
            return None
        left = self._expires - time.monotonic()
        if left <= 0:
            raise ProtocolTimeout('deadline exceeded')
        return left


def to_wire(a) -> Tuple[np.ndarray, Optional[str]]:
    """(the contiguous numpy array that goes on the wire, ``BF16`` or
    None): a torch tensor of a dtype numpy has becomes its numpy view
    (moved to the host first); a bf16 tensor becomes its 2-byte words
    as an int16 array, named."""
    if isinstance(a, torch.Tensor):
        t = a.detach().contiguous().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), BF16
        return t.numpy(), None
    return np.ascontiguousarray(a), None


def _write_npy(bio: io.BytesIO, arr: np.ndarray,
               ext: Optional[str]) -> None:
    if ext is None:
        np.lib.format.write_array(bio, arr, allow_pickle=False)
        return
    # The header ml_dtypes' arrays get from numpy (descr '<V<n>'), so a
    # frame is byte-equal to the JAX package's for the same bits.
    np.lib.format.write_array_header_1_0(bio, {
        'descr': f'<V{arr.dtype.itemsize}', 'fortran_order': False,
        'shape': arr.shape})
    bio.write(arr.tobytes())


def _restore_dtype(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    """A wire array the sidecar names bf16 → a CPU torch.bfloat16
    tensor over the same bytes."""
    if dtype_name != BF16:
        raise ProtocolError(
            f'peer sent extension dtype {dtype_name!r} this side '
            f'cannot reconstruct')
    if arr.dtype.itemsize != 2:
        raise ProtocolError(
            f'extension dtype {dtype_name!r} is 2 bytes but the wire '
            f'array has {arr.dtype.itemsize}-byte items')
    return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)) \
        .view(torch.bfloat16)


def _encode_payload(obj: Dict[str, Any],
                    arrays: Optional[Arrays]) -> bytes:
    arrays = arrays or {}
    wire = {name: to_wire(a) for name, a in arrays.items()}
    head = dict(obj)
    head['_arrays'] = sorted(wire)
    ext = {name: e for name, (_, e) in wire.items() if e is not None}
    if ext:
        head['_dtypes'] = ext
    head_bytes = json.dumps(head).encode('utf-8')
    parts = [_U32.pack(len(head_bytes)), head_bytes]
    for name in sorted(wire):
        bio = io.BytesIO()
        _write_npy(bio, *wire[name])
        raw = bio.getvalue()
        parts.append(_U32.pack(len(raw)))
        parts.append(raw)
    return b''.join(parts)


def _decode_payload(payload: bytes) -> Tuple[Dict[str, Any], Arrays]:
    if len(payload) < _U32.size:
        raise ProtocolError('payload shorter than its json-length prefix')
    (json_len,) = _U32.unpack_from(payload, 0)
    off = _U32.size
    if off + json_len > len(payload):
        raise ProtocolError('json length exceeds payload')
    try:
        obj = json.loads(payload[off:off + json_len].decode('utf-8'))
    except (UnicodeDecodeError, ValueError) as e:
        raise ProtocolError(f'bad json header: {e}') from None
    off += json_len
    arrays: Arrays = {}
    ext = obj.pop('_dtypes', {}) or {}
    for name in obj.pop('_arrays', []):
        if off + _U32.size > len(payload):
            raise ProtocolError(f'truncated array block {name!r}')
        (raw_len,) = _U32.unpack_from(payload, off)
        off += _U32.size
        if off + raw_len > len(payload):
            raise ProtocolError(f'truncated array {name!r}')
        bio = io.BytesIO(payload[off:off + raw_len])
        try:
            arrays[name] = np.lib.format.read_array(bio,
                                                    allow_pickle=False)
        except ValueError as e:
            raise ProtocolError(f'bad npy array {name!r}: {e}') from None
        if name in ext:
            arrays[name] = _restore_dtype(arrays[name], str(ext[name]))
        off += raw_len
    return obj, arrays


def send_msg(sock: socket.socket, obj: Dict[str, Any],
             arrays: Optional[Arrays] = None,
             timeout: Optional[float] = None) -> None:
    """Send one frame; ``timeout`` bounds the whole send."""
    payload = _encode_payload(obj, arrays)
    if len(payload) > MAX_FRAME_BYTES:
        raise ProtocolError(f'frame of {len(payload)} bytes exceeds '
                            f'MAX_FRAME_BYTES={MAX_FRAME_BYTES}')
    deadline = Deadline(timeout)
    sock.settimeout(deadline.remaining())
    try:
        sock.sendall(_HEADER.pack(MAGIC, VERSION, 0, len(payload)) +
                     payload)
    except socket.timeout as e:
        raise ProtocolTimeout('send timed out') from e


def _recv_exact(sock: socket.socket, n: int, deadline: Deadline) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        sock.settimeout(deadline.remaining())
        try:
            chunk = sock.recv(min(n - len(buf), 1 << 20))
        except socket.timeout as e:
            raise ProtocolTimeout(f'recv timed out ({len(buf)}/{n} '
                                  f'bytes)') from e
        if not chunk:
            raise ProtocolError(
                f'truncated frame: peer closed after {len(buf)}/{n} bytes')
        buf.extend(chunk)
    return bytes(buf)


def recv_msg(sock: socket.socket, timeout: Optional[float] = None,
             max_frame: int = MAX_FRAME_BYTES
             ) -> Tuple[Dict[str, Any], Arrays]:
    """Receive one frame; raises on timeout/truncation/version skew."""
    deadline = Deadline(timeout)
    header = _recv_exact(sock, _HEADER.size, deadline)
    magic, version, _, length = _HEADER.unpack(header)
    if magic != MAGIC:
        raise ProtocolError(f'bad magic {magic!r}')
    if version != VERSION:
        raise VersionMismatchError(
            f'peer speaks protocol v{version}, this side v{VERSION} — '
            f'upgrade the older side')
    if length > max_frame:
        raise ProtocolError(f'frame of {length} bytes exceeds the '
                            f'{max_frame}-byte cap')
    return _decode_payload(_recv_exact(sock, length, deadline))


def raise_if_error(obj: Dict[str, Any]) -> Dict[str, Any]:
    """Reply postprocessor: a structured ``{'error': ...}`` reply
    becomes a :class:`RemoteError` carrying its ``kind``."""
    if 'error' in obj:
        raise RemoteError(str(obj['error']),
                          kind=str(obj.get('kind', 'error')))
    return obj


def request(addr: Tuple[str, int], obj: Dict[str, Any],
            arrays: Optional[Arrays] = None,
            timeout: float = 10.0) -> Tuple[Dict[str, Any], Arrays]:
    """One round-trip: connect, send, receive, close. ``timeout``
    bounds the WHOLE exchange (connect + send + recv), not each op."""
    deadline = Deadline(timeout)
    sock = socket.create_connection(addr, timeout=deadline.remaining())
    try:
        sock.settimeout(deadline.remaining())
        send_msg(sock, obj, arrays, timeout=deadline.remaining())
        reply, reply_arrays = recv_msg(sock, timeout=deadline.remaining())
        return raise_if_error(reply), reply_arrays
    finally:
        sock.close()


def parse_addr(text: str, default_port: int = 0) -> Tuple[str, int]:
    """``host:port`` (or bare ``host``) → (host, port)."""
    if ':' in text:
        host, _, port = text.rpartition(':')
        return host or '127.0.0.1', int(port)
    return text, default_port


class FramedClient:
    """Persistent framed connection with lazy (re)connect.

    One TCP connection serves many request/reply exchanges
    (:class:`FramedServer` keeps a connection open until idle-timeout),
    so a hot path (a heartbeat every interval, a collect per step) pays
    the handshake only after a failure. Any protocol or socket error
    closes the socket so the next request reconnects fresh. NOT
    thread-safe: each thread owns its own client (a torn half-exchange
    on a shared socket would desync framing).
    """

    def __init__(self, addr: Tuple[str, int]):
        self._addr = addr
        self._sock: Optional[socket.socket] = None

    def request(self, obj: Dict[str, Any],
                arrays: Optional[Arrays] = None,
                timeout: float = 10.0) -> Tuple[Dict[str, Any], Arrays]:
        deadline = Deadline(timeout)
        if self._sock is None:
            self._sock = socket.create_connection(
                self._addr, timeout=deadline.remaining())
        # Re-arm per request: the connect timeout must not linger as
        # the op timeout of every later exchange on this socket.
        self._sock.settimeout(deadline.remaining())
        try:
            send_msg(self._sock, obj, arrays,
                     timeout=deadline.remaining())
            reply, reply_arrays = recv_msg(
                self._sock, timeout=deadline.remaining())
        except (ProtocolError, OSError):
            self.close()
            raise
        # Outside the except-close: a structured error reply is a
        # healthy exchange, and the connection stays usable.
        return raise_if_error(reply), reply_arrays

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None


class FramedServer:
    """Accept loop + one daemon thread per connection.

    The handler sees ``(obj, arrays)`` and returns ``(obj, arrays)``;
    raising inside it sends a structured ``{'error', 'kind'}`` reply
    (a :class:`RemoteError` keeps its kind; anything else is
    ``'internal'``) and keeps the connection alive. Protocol-level
    failures (bad frame, timeout, disconnect) close the connection.
    Every accepted socket gets a per-request idle timeout, so an
    abandoned connection releases its thread in bounded time.
    """

    def __init__(self, host: str, port: int,
                 handler: Callable[[Dict[str, Any], Arrays],
                                   Tuple[Dict[str, Any],
                                         Optional[Arrays]]],
                 name: str = 'framed',
                 idle_timeout: float = 300.0):
        self._handler = handler
        self._name = name
        self._idle_timeout = idle_timeout
        self._stop = threading.Event()
        listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        listener.bind((host, port))
        listener.listen(64)
        # The accept loop polls the stop event at this cadence; every
        # later op on the accepted socket re-arms its own deadline.
        listener.settimeout(0.2)
        self._listener = listener
        self.addr: Tuple[str, int] = listener.getsockname()[:2]
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name=f'{name}-accept', daemon=True)

    def start(self) -> 'FramedServer':
        self._accept_thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._accept_thread.join(timeout=5.0)
        self._listener.close()

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return   # listener closed under us: shutting down
            conn.settimeout(self._idle_timeout)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             name=f'{self._name}-conn',
                             daemon=True).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            while not self._stop.is_set():
                try:
                    obj, arrays = recv_msg(conn,
                                           timeout=self._idle_timeout)
                except (ProtocolError, OSError):
                    return   # disconnect/idle/garbage: drop the conn
                try:
                    reply, reply_arrays = self._handler(obj, arrays)
                except RemoteError as e:
                    reply, reply_arrays = ({'error': str(e),
                                            'kind': e.kind}, None)
                except Exception as e:  # noqa: BLE001 — reply, don't die
                    logger.warning('%s: handler failed on %r: %s',
                                   self._name, obj.get('op'), e)
                    reply, reply_arrays = ({'error': str(e),
                                            'kind': 'internal'}, None)
                try:
                    send_msg(conn, reply, reply_arrays,
                             timeout=self._idle_timeout)
                except (ProtocolError, OSError):
                    return
        finally:
            conn.close()
