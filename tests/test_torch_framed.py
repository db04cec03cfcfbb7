"""The port's framed-TCP transport and KV handoff wire (utils/framed.py,
serve/disagg/handoff.py) against the JAX package's, on the CPU: frames
byte-equal for the same content, each side reading the other's (bf16
included: a torch.bfloat16 tensor on the port's side, an ml_dtypes
bfloat16 array on JAX's), the same refusals of bad frames, servers and
clients across packages, the same content fingerprint, and the handoff
receiver's integrity / spec / duplicate refusals whichever side sends."""
import socket
import struct
import threading

import ml_dtypes
import numpy as np
import pytest
import torch

from skypilot_tpu.serve.disagg import handoff as jhandoff
from skypilot_tpu.utils import framed as jframed
from skypilot_tpu_torch.serve.disagg import handoff
from skypilot_tpu_torch.utils import failpoints
from skypilot_tpu_torch.utils import framed


def _content(seed=0):
    """(port arrays, JAX arrays) of the same bytes: fp32, int32, bf16."""
    rng = np.random.default_rng(seed)
    f32 = rng.standard_normal((2, 1, 16, 2, 8)).astype(np.float32)
    i32 = rng.integers(-9, 9, (3, 5)).astype(np.int32)
    bf = rng.standard_normal((2, 1, 16, 2, 8)).astype(ml_dtypes.bfloat16)
    port = {'f': torch.from_numpy(f32.copy()), 'i': i32.copy(),
            'b': torch.from_numpy(bf.view(np.int16).copy()).view(
                torch.bfloat16)}
    return port, {'f': f32, 'i': i32, 'b': bf}


def _bits(a) -> np.ndarray:
    """Raw bytes of either side's array, for bit equality."""
    if isinstance(a, torch.Tensor):
        a = (a.view(torch.int16) if a.dtype == torch.bfloat16 else a).numpy()
    return np.frombuffer(np.ascontiguousarray(a).tobytes(), np.uint8)


def test_payload_is_byte_equal_to_jax():
    port, jax_side = _content()
    obj = {'op': 'handoff', 'meta': {'x': [1, 2]}}
    assert framed._encode_payload(obj, port) == \
        jframed._encode_payload(obj, jax_side)
    assert framed._encode_payload({'a': 1}, None) == \
        jframed._encode_payload({'a': 1}, None)


@pytest.mark.parametrize('direction', ['port_to_jax', 'jax_to_port'])
def test_frames_cross_packages(direction):
    port, jax_side = _content(1)
    a, b = socket.socketpair()
    try:
        if direction == 'port_to_jax':
            framed.send_msg(a, {'op': 'x', 'n': 3}, port, timeout=5)
            obj, got = jframed.recv_msg(b, timeout=5)
            assert got['b'].dtype == ml_dtypes.bfloat16
            assert got['f'].dtype == np.float32
        else:
            jframed.send_msg(a, {'op': 'x', 'n': 3}, jax_side, timeout=5)
            obj, got = framed.recv_msg(b, timeout=5)
            assert isinstance(got['b'], torch.Tensor)
            assert got['b'].dtype == torch.bfloat16
            assert isinstance(got['f'], np.ndarray)
            assert got['f'].dtype == np.float32
    finally:
        a.close()
        b.close()
    assert obj == {'op': 'x', 'n': 3}
    assert set(got) == {'f', 'i', 'b'}
    for name in got:
        assert tuple(got[name].shape) == jax_side[name].shape
        np.testing.assert_array_equal(_bits(got[name]), _bits(port[name]))


def test_port_round_trip_keeps_bf16_and_numpy():
    port, _ = _content(2)
    obj, got = framed._decode_payload(framed._encode_payload({}, port))
    assert obj == {}
    assert torch.equal(got['b'].view(torch.int16), port['b'].view(torch.int16))
    assert torch.equal(torch.from_numpy(got['f']), port['f'])
    np.testing.assert_array_equal(got['i'], port['i'])


def _bad_frames():
    good = jframed._encode_payload({'op': 'x'}, {'a': np.zeros(4)})
    hdr = struct.Struct('!4sHHI')
    return {
        'bad_magic': hdr.pack(b'NOPE', 1, 0, len(good)) + good,
        'version': hdr.pack(b'SKDT', 2, 0, len(good)) + good,
        'truncated': hdr.pack(b'SKDT', 1, 0, len(good)) + good[:-5],
        'oversized': hdr.pack(b'SKDT', 1, 0, 1 << 31),
        'bad_json': hdr.pack(b'SKDT', 1, 0, 9) + struct.pack('!I', 5) +
        b'{nope',
    }


@pytest.mark.parametrize('case', sorted(_bad_frames()))
def test_bad_frames_refused_as_jax_refuses(case):
    raw = _bad_frames()[case]
    errors = []
    for lib in (framed, jframed):
        a, b = socket.socketpair()
        try:
            a.sendall(raw)
            a.shutdown(socket.SHUT_WR)
            with pytest.raises(lib.ProtocolError) as err:
                lib.recv_msg(b, timeout=5)
            errors.append(type(err.value).__name__)
        finally:
            a.close()
            b.close()
    assert errors[0] == errors[1]
    assert (errors[0] == 'VersionMismatchError') == (case == 'version')


@pytest.mark.parametrize('server_side', ['port', 'jax'])
def test_server_and_client_across_packages(server_side):
    """A FramedServer of one package answers the other's request: echo
    with arrays, a structured RemoteError keeping its kind, an internal
    error, and a raw connection surviving both."""
    srv_lib, cli_lib = ((framed, jframed) if server_side == 'port'
                        else (jframed, framed))

    def handler(obj, arrays):
        if obj.get('op') == 'refuse':
            raise srv_lib.RemoteError('no', kind='spec')
        if obj.get('op') == 'boom':
            raise KeyError('boom')
        return {'echo': obj['v']}, arrays

    server = srv_lib.FramedServer('127.0.0.1', 0, handler).start()
    try:
        arr = np.arange(6, dtype=np.float32).reshape(2, 3)
        reply, arrays = cli_lib.request(server.addr, {'v': 7}, {'x': arr})
        assert reply == {'echo': 7}
        np.testing.assert_array_equal(arrays['x'], arr)
        with pytest.raises(cli_lib.RemoteError) as err:
            cli_lib.request(server.addr, {'op': 'refuse'})
        assert err.value.kind == 'spec'
        with socket.create_connection(server.addr, timeout=5) as conn:
            for op, kind in (('boom', 'internal'), ('refuse', 'spec')):
                cli_lib.send_msg(conn, {'op': op}, timeout=5)
                reply, _ = cli_lib.recv_msg(conn, timeout=5)
                assert reply['kind'] == kind
            cli_lib.send_msg(conn, {'v': 1}, timeout=5)
            assert cli_lib.recv_msg(conn, timeout=5)[0] == {'echo': 1}
    finally:
        server.stop()


def test_other_extension_dtypes_refused():
    raw = jframed._encode_payload({}, {'f8': np.zeros(4).astype(
        ml_dtypes.float8_e4m3fn)})
    with pytest.raises(framed.ProtocolError, match='float8_e4m3fn'):
        framed._decode_payload(raw)


def test_parse_addr_and_handoff_addr_agree():
    for text in ('host:81', ':82', 'bare', '10.0.0.1:9000'):
        assert framed.parse_addr(text, 5) == jframed.parse_addr(text, 5)
    for url in ('http://127.0.0.1:8300', 'http://h:8001/', 'h2'):
        assert handoff.handoff_addr_for_url(url) == \
            jhandoff.handoff_addr_for_url(url)
    assert handoff.HANDOFF_PORT_OFFSET == jhandoff.HANDOFF_PORT_OFFSET
    assert handoff.REQUIRED_META == jhandoff.REQUIRED_META


def test_kv_fingerprint_equals_jax():
    port, jax_side = _content(3)
    assert handoff.kv_fingerprint(port) == jhandoff.kv_fingerprint(jax_side)
    # numpy on the port's side too, and a changed bit changes it.
    as_numpy = {k: (v.numpy() if isinstance(v, torch.Tensor) and
                    v.dtype != torch.bfloat16 else v)
                for k, v in port.items()}
    assert handoff.kv_fingerprint(as_numpy) == \
        jhandoff.kv_fingerprint(jax_side)
    port['f'][0, 0, 0, 0, 0] += 1.0
    assert handoff.kv_fingerprint(port) != jhandoff.kv_fingerprint(jax_side)


def _meta(lib, arrays, hid=None, **over):
    meta = lib.build_meta(
        handoff_id=hid or lib.new_handoff_id(), model='llama-debug',
        vocab_size=256, page_size=64, family='paged_kv', bucket=32,
        tokens=list(range(1, 20)), max_new=4, first_token=5, first_lp=-1.0,
        first_tops=[], temperature=0.0, top_k=None, top_p=None,
        presence_penalty=0.0, frequency_penalty=0.0, stop_ids=[],
        want_tops=False, cls='other',
        kv_sha256=lib.kv_fingerprint(arrays))
    meta.update(over)
    return meta


def test_build_meta_equals_jax():
    port, jax_side = _content(4)
    a = _meta(handoff, port, hid='h1')
    b = _meta(jhandoff, jax_side, hid='h1')
    a.pop('sent_unix')
    b.pop('sent_unix')
    assert a == b


@pytest.mark.parametrize('sender', ['port', 'jax'])
def test_receiver_refusals_across_packages(sender):
    """Integrity, spec and duplicate refusals: a port receiver refusing
    JAX sends and a JAX receiver refusing the port's, each kind kept;
    the staged entry is the sender's bytes."""
    snd, rcv = (handoff, jhandoff) if sender == 'port' else (jhandoff, handoff)
    port, jax_side = _content(5)
    arrays = {'a': port['b'], 'b': port['f']} if sender == 'port' else \
        {'a': jax_side['b'], 'b': jax_side['f']}
    store = rcv.HandoffStore(ttl=60)

    def validate(meta):
        return None if meta['vocab_size'] == 256 else 'vocab mismatch'

    receiver = rcv.HandoffReceiver('127.0.0.1', 0, store,
                                   validate=validate).start()
    try:
        bad = dict(arrays)
        if sender == 'port':
            bad['b'] = arrays['b'].clone()
            bad['b'][0, 0, 0, 0, 0] += 1
        else:
            bad['b'] = arrays['b'].copy()
            bad['b'][0, 0, 0, 0, 0] += 1
        with pytest.raises(snd.HandoffError) as err:
            snd.send(receiver.addr, _meta(snd, arrays), bad)
        assert err.value.kind == 'integrity' and err.value.retriable
        with pytest.raises(snd.HandoffError) as err:
            snd.send(receiver.addr, _meta(snd, arrays, vocab_size=999),
                     arrays)
        assert err.value.kind == 'spec' and not err.value.retriable
        meta = _meta(snd, arrays)
        assert snd.send(receiver.addr, meta, arrays)['ok'] is True
        with pytest.raises(snd.HandoffError) as err:
            snd.send(receiver.addr, meta, arrays)
        assert err.value.kind == 'duplicate'
        assert len(store) == 1
        got_meta, got = store.pop(meta['handoff_id'])
        assert got_meta['tokens'] == meta['tokens']
        for name in ('a', 'b'):
            np.testing.assert_array_equal(_bits(got[name]),
                                          _bits(arrays[name]))
        assert store.pop(meta['handoff_id']) is None
    finally:
        receiver.stop()


def test_send_failpoint_and_dead_peer_are_retriable():
    port, _ = _content(6)
    arrays = {'a': port['f'], 'b': port['f']}
    with failpoints.armed('handoff.send', once=True):
        with pytest.raises(handoff.HandoffError) as err:
            handoff.send(('127.0.0.1', 1), _meta(handoff, arrays), arrays)
    assert err.value.retriable and 'FailpointError' in str(err.value)
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        dead = s.getsockname()
    with pytest.raises(handoff.HandoffError) as err:
        handoff.send(dead, _meta(handoff, arrays), arrays)
    assert err.value.retriable


def test_store_ttl_sweep_and_cap():
    store = handoff.HandoffStore(ttl=0.05, max_entries=2)
    store.put({'handoff_id': 'a'}, {})
    store.put({'handoff_id': 'b'}, {})
    with pytest.raises(framed.RemoteError) as err:
        store.put({'handoff_id': 'c'}, {})
    assert err.value.kind == 'overloaded'
    threading.Event().wait(0.1)
    assert store.sweep() == 2 and len(store) == 0
    assert store.pop('a') is None
