"""Multi-host serving: one engine replica over a gang of ranks (port of
skypilot_tpu/serve/multihost.py).

The JAX engine joins every host of a slice into one jax.distributed job
and lets XLA's collectives shard its params and cache over the global
mesh. The port runs one process a rank (``torch.distributed``, joined
by ``parallel/mesh.py init_distributed`` at the coordinator address):
each rank holds its shard of the model over 'expert' and 'tensor' (the
family's ``param_axes``), and the forward's all-reduces and all-gather
(models/llama.py, models/moe.py, models/mla.py) run inside the same
engine methods single-process serving uses. The leader sends one op
stream to every follower, however many ranks the mesh holds; the page
allocator's fingerprint covers the K/V and the latent pools alike.

Design — leader-follower SPMD mirroring, as in JAX:
  - Rank 0 (leader) runs the HTTP frontend and the continuous batcher.
    Every engine-level operation that touches the device (warmup, an
    admit group, a chunked start and each later chunk, an idle spill, a
    decode step DISPATCH, a step COLLECT, a cancel, a reap, a failure
    reset) is broadcast over a small TCP control channel BEFORE the
    leader executes it. Dispatch and collect are separate ops, so a
    lookahead dispatch before the previous collect replays in the same
    interleaving everywhere.
  - Followers run the SAME engine methods with the SAME inputs, so the
    host state (slot pool, page allocator, sampling arrays, prefix
    store, speculative drafts) evolves identically and every rank
    enters the same collective in the same order. The sampling seed
    comes from the leader; the logits every rank samples are the
    gathered, identical ones; everything derivable from mirrored state
    is not broadcast, only the leader-private bits are (the step width,
    the lookahead interleaving, request payloads, the chunk the round
    robin picks, the clock-driven spills).

The channel is ordered and reliable (TCP, length-prefixed pickle of
plain data only: :class:`_SafeUnpickler` refuses every class, so an op
carries tuples, lists, dicts, ints, floats, strings and bytes, and an
admitted request travels as the dict :func:`strip_items` makes of it).
A follower that dies takes the replica down: the leader's next send or
collective fails, and it exits with code 13 for the launcher to restart
the gang.

Env contract (the gang env): SKYTPU_COORDINATOR_ADDRESS,
SKYTPU_NUM_PROCESSES and SKYTPU_NODE_RANK default the engine's
``--coordinator``, ``--num-processes`` and ``--process-id``, plus
SKYTPU_MH_TOKEN, a per-job random secret authenticating the control
channel (startup refuses to run without it; see :func:`_resolve_token`).
"""
from __future__ import annotations

import dataclasses
import hmac
import io
import logging
import os
import pickle
import socket
import struct
import time
from typing import Any, Tuple

from skypilot_tpu_torch.utils import failpoints as failpoints_lib
from skypilot_tpu_torch.utils import knobs

logger = logging.getLogger(__name__)

# The control channel listens next to the process group's coordinator.
CONTROL_PORT_OFFSET = 1000
CONNECT_TIMEOUT_S = knobs.get_float('SKYTPU_MH_CONNECT_TIMEOUT')
# Per-broadcast send budget: a follower whose TCP buffer stays full this
# long is wedged, and the contract is to fail the replica loudly so the
# gang restarts, not to park the leader's batch loop in sendall forever.
SEND_TIMEOUT_S = knobs.get_float('SKYTPU_MH_SEND_TIMEOUT')
# Handshake magic + shared token: a follower must prove it belongs to
# this gang before the leader counts it (and before it receives request
# payloads); anything else connecting to the port is dropped.
_MAGIC = b'SKYTPU-MH1'
# The fields of an admitted request that stay with the leader.
_PRIVATE = ('future', 'stream')


def _resolve_token() -> str:
    """The control-channel secret (SKYTPU_MH_TOKEN, exported per job
    with the gang env).

    The leader binds 0.0.0.0 and ships request payloads (user prompts)
    to anything passing the HMAC handshake, so a guessable secret lets
    a port squatter claim a follower slot and read traffic. Multi-host
    startup refuses to run without a real token; the escape hatch
    (SKYTPU_MH_ALLOW_INSECURE_TOKEN=1) exists for loopback debugging
    only."""
    token = knobs.get_str('SKYTPU_MH_TOKEN')
    if token:
        return token
    if knobs.get_bool('SKYTPU_MH_ALLOW_INSECURE_TOKEN'):
        return knobs.get_str('SKYTPU_JOB_ID') or 'local'
    raise RuntimeError(
        'multi-host serving needs SKYTPU_MH_TOKEN (a per-job random '
        'secret; the slice driver exports it alongside '
        'SKYTPU_COORDINATOR_ADDRESS). Refusing the guessable '
        "'local'/job-id fallback — set "
        'SKYTPU_MH_ALLOW_INSECURE_TOKEN=1 only for loopback '
        'debugging.')


class _SafeUnpickler(pickle.Unpickler):
    """Control ops are PURE DATA (tuples/lists/dicts of primitives);
    refusing every class lookup turns a squatted port from arbitrary
    code execution into a parse error."""

    def find_class(self, module, name):
        raise pickle.UnpicklingError(
            f'control channel refuses class {module}.{name}')


def require_token() -> None:
    """Fail-fast preflight for multi-host startup: raise the
    :func:`_resolve_token` refusal BEFORE the process group joins and
    the model builds."""
    _resolve_token()


def control_address(coordinator: str) -> Tuple[str, int]:
    host, port = coordinator.rsplit(':', 1)
    return host, int(port) + CONTROL_PORT_OFFSET


def _send_msg(sock: socket.socket, obj: Any) -> None:
    data = pickle.dumps(obj)
    sock.sendall(struct.pack('>I', len(data)) + data)


def _recv_msg(sock: socket.socket) -> Any:
    hdr = _recv_exact(sock, 4)
    data = _recv_exact(sock, struct.unpack('>I', hdr)[0])
    return _SafeUnpickler(io.BytesIO(data)).load()


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b''
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError('control channel closed')
        buf += chunk
    return buf


def _handshake() -> bytes:
    return _MAGIC + hmac.new(_resolve_token().encode(), _MAGIC,
                             'sha256').digest()


class ControlLeader:
    """Rank 0's side: accept every follower (handshake-verified), then
    broadcast ops."""

    def __init__(self, coordinator: str, num_processes: int):
        _, port = control_address(coordinator)
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind(('0.0.0.0', port))
        srv.listen(num_processes)
        srv.settimeout(CONNECT_TIMEOUT_S)
        deadline = time.time() + CONNECT_TIMEOUT_S
        self._conns = []
        want = _handshake()
        while len(self._conns) < num_processes - 1:
            if time.time() > deadline:
                raise TimeoutError('not all followers handshook in time')
            conn, addr = srv.accept()
            try:
                conn.settimeout(10)
                got = _recv_exact(conn, len(want))
                if not hmac.compare_digest(got, want):
                    raise ConnectionError('bad handshake')
                # Leave a SEND timeout armed for the broadcast path: a
                # wedged follower (full TCP buffer) must surface as
                # OSError in send(), the fail-the-replica path, not
                # block the batch loop in sendall forever.
                conn.settimeout(SEND_TIMEOUT_S)
            except (OSError, ConnectionError) as e:
                logger.warning('rejecting connection from %s: %s', addr, e)
                conn.close()
                continue
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._conns.append(conn)
            logger.info('control follower connected: %s', addr)
        srv.close()

    def send(self, op: Tuple) -> None:
        """Broadcast; a dead OR wedged follower is FATAL: the replica's
        collectives can no longer complete, so exit loudly and let the
        launcher restart the gang. The per-conn send timeout
        (SEND_TIMEOUT_S) turns a stalled follower into socket.timeout
        (an OSError) instead of parking the batch loop in sendall."""
        for conn in self._conns:
            try:
                if failpoints_lib.ACTIVE:
                    # A dead or wedged follower socket (delay mode: a
                    # slow one): the same fail-the-replica path.
                    failpoints_lib.fire('multihost.send')
                _send_msg(conn, op)
            except (OSError, failpoints_lib.FailpointError) as e:
                logger.error('control follower lost or wedged (%s); '
                             'failing the replica so the gang restarts.', e)
                os._exit(13)

    def close(self) -> None:
        for conn in self._conns:
            conn.close()


class ControlFollower:
    def __init__(self, coordinator: str):
        host, port = control_address(coordinator)
        deadline = time.time() + CONNECT_TIMEOUT_S
        while True:
            try:
                self._sock = socket.create_connection((host, port),
                                                      timeout=5)
                break
            except OSError:
                if time.time() > deadline:
                    raise
                time.sleep(0.2)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock.sendall(_handshake())
        # The connect timeout must NOT persist: ops arrive whenever
        # traffic does, and an idle engine would kill the channel.
        self._sock.settimeout(None)

    def recv(self) -> Tuple:
        if failpoints_lib.ACTIVE:
            # A torn or poisoned channel: follower_serve takes the same
            # leader-gone exit a real torn channel does.
            failpoints_lib.fire('multihost.recv')
        return _recv_msg(self._sock)


def strip_items(items) -> list:
    """Admitted requests as plain dicts of their fields, minus the
    leader-private future and stream queue (followers publish to
    nobody, and the channel refuses every class)."""
    return [{f.name: getattr(it, f.name) for f in dataclasses.fields(it)
             if f.name not in _PRIVATE} for it in items]


def follower_serve(engine, coordinator: str) -> None:
    """Follower main loop: mirror every leader op until 'stop' or the
    channel closes. Device work happens inside the same engine methods
    the leader runs, under the engine's mesh; an op that raises here
    raised on the leader too (same computation), and the leader follows
    up with a 'reset'. A follower that failed an op its leader completed
    has diverged and exits with code 13."""
    from skypilot_tpu_torch.serve import engine as engine_lib
    chan = ControlFollower(coordinator)
    logger.info('follower ready; mirroring leader ops.')

    def requests(wire):
        return [engine_lib.Request(**d) for d in wire]
    failed = False
    with engine.on_mesh():
        while True:
            try:
                op = chan.recv()
            except (ConnectionError, failpoints_lib.FailpointError):
                logger.info('leader gone; follower exiting.')
                return
            kind = op[0]
            if failed and kind != 'reset':
                # Our state diverged from the leader's (the failed op
                # left it half done), so the next collective would hang
                # every rank: fail the gang instead.
                logger.error('follower diverged (local failure, leader sent '
                             '%r not reset); exiting.', kind)
                os._exit(13)
            try:
                if kind == 'warmup':
                    # The leader's sampling seed and the knobs that
                    # steer the op stream: every rank must build the
                    # same pool and draw the same samples.
                    engine.seed = op[2]
                    engine.set_mirrored_knobs(op[3])
                    engine.warmup(buckets=op[1])
                elif kind == 'admit':
                    # op[2]: the leader's allocator fingerprint BEFORE
                    # this admit; a mismatch means page assignments
                    # diverged (KV corruption).
                    engine._check_page_fp(op[2])
                    engine._admit_group(requests(op[1]))
                elif kind == 'chunkstart':
                    engine._check_page_fp(op[2])
                    engine._start_chunked(requests([op[1]])[0])
                elif kind == 'spill':
                    # The leader's idle sweep is clock-driven: each idle
                    # spill rides its own op (pressure spills replay
                    # inside admits).
                    engine._check_page_fp(op[2])
                    engine._spill_key(tuple(op[1]))
                elif kind == 'chunk':
                    engine._advance_chunk(op[1])
                elif kind == 'step':
                    # DISPATCH only; a speculative round is derived from
                    # mirrored state inside, as on the leader.
                    engine._step_or_dispatch(op[1])
                elif kind == 'collect':
                    engine._collect_step()
                elif kind == 'reap':
                    engine._publish()
                elif kind == 'cancel':
                    engine._cancel_slot(op[1])
                elif kind == 'reset':
                    engine._fail_all(RuntimeError('leader reset'))
                elif kind == 'stop':
                    return
                else:
                    raise ValueError(f'unknown control op {kind!r}')
                failed = False
            except Exception as e:  # pylint: disable=broad-except
                # If the leader hit the same failure it sends 'reset'
                # next and both sides rebuild; any OTHER next op means
                # the failure was ours alone (checked above).
                logger.warning('follower op %s failed: %s', kind, e)
                failed = True
