"""One serving replica over a gang of ranks: the port's engine at
``--mesh tensor=2`` as two processes on the CPU (gloo), against the JAX
engine unsharded and at ``mesh='tensor=2'`` on the conftest's 8 CPU
devices (as tests/unit_tests/test_engine_sharded.py runs it).

The gang runs ``python tests/torch_mh_worker.py`` (the engine's own
``main`` with llama-debug in fp32) once per run: a follower and a
leader with the gang flags, both restoring the JAX engine's weights
from one ``--ckpt-dir`` written here, 32-token prefill chunks, and
``engine.step=once`` armed in both (the first warm dispatch faults on
every rank). The whole scenario and its JAX references are computed
once and cached under a file lock in pytest's shared temp root (as
tests/test_torch_ring.py does), so xdist workers share one gang.
Greedy tokens must be IDENTICAL: /generate, a resent prompt (a prefix
hit), a prompt long enough to chunk, a self-repeating prompt
(speculation), a streamed /v1/completions and a chat completion.

Ports: fixed, below the kernel's ephemeral range (tests/torch_ports.py,
offsets 0 and 90), apart from the JAX multihost test's 34000-35399
block.

The unit tests port tests/unit_tests/test_engine_multihost.py's control
channel and flag tests and test_engine_sharded.py's mesh guards, and
check each refusal by name.
"""
import concurrent.futures
import dataclasses
import fcntl
import json
import os
import pickle
import secrets
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_ports
from aiohttp.test_utils import TestClient
from aiohttp.test_utils import TestServer as AioTestServer

from skypilot_tpu.serve import engine as jengine_lib
from skypilot_tpu_torch import config
from skypilot_tpu_torch.models import weights
from skypilot_tpu_torch.serve import engine as engine_lib
from skypilot_tpu_torch.serve import multihost
from skypilot_tpu_torch.train import checkpoints, train_lib

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, 'tests', 'torch_mh_worker.py')
MAX_LEN = 256
CHUNK = 32
SEND_TIMEOUT_S = 10.0
# A prompt that does not repeat itself (no draft, so the first warm
# round dispatches a step, where the armed fault fires), the same again
# after the reset, a short one, a 90-token prompt sent twice (3 chunks,
# then a prefix hit on its 64-token snapshot), a 120-token prompt (4
# chunks) and a self-repeating one (prompt-lookup speculation).
FAULT = [11, 40, 3, 97, 201, 5, 66, 18, 150, 7]
LONG = [(7 * i + 3) % 251 for i in range(90)]
PROMPTS = [
    ('after_reset', FAULT, 8), ('short', [1, 2, 3, 4, 5], 8),
    ('long', LONG, 8), ('long_again', LONG, 8),
    ('chunked', [(13 * i + 1) % 256 for i in range(120)], 8),
    ('repeating', [1, 2, 3, 4, 5] * 4, 16)]
STREAM = {'prompt': 'Hello multihost', 'max_tokens': 8, 'temperature': 0,
          'stream': True}
CHAT = {'messages': [{'role': 'user', 'content': 'hi'}], 'max_tokens': 8,
        'temperature': 0}


def _coord_port(offset: int) -> int:
    return torch_ports.coord_port(offset)


def _http_port(offset: int) -> int:
    return torch_ports.http_port(offset)


def _post(base, path, body, timeout=60):
    """(status, raw body)."""
    req = urllib.request.Request(base + path, data=json.dumps(body).encode(),
                                 headers={'Content-Type': 'application/json'})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=30) as r:
        return r.read().decode()


def _sse_text(raw: bytes) -> str:
    events = [e[len('data: '):] for e in raw.decode().split('\n\n')
              if e.startswith('data: ')]
    assert events and events[-1] == '[DONE]', events[-1:]
    return ''.join(json.loads(e)['choices'][0]['text'] for e in events[:-1])


def _answers(post):
    """Every compared request through ``post(path, body)``: {name:
    tokens or text}."""
    out = {}
    for name, tokens, n in PROMPTS:
        code, raw = post('/generate', {'tokens': tokens, 'max_new_tokens': n})
        assert code == 200, (name, raw)
        out[name] = json.loads(raw)['tokens']
    code, raw = post('/v1/completions', STREAM)
    assert code == 200, raw
    out['stream'] = _sse_text(raw)
    code, raw = post('/v1/chat/completions', CHAT)
    assert code == 200, raw
    out['chat'] = json.loads(raw)['choices'][0]['message']['content']
    return out


# ---------------------------------------------------------------- JAX side

def _jax_engine(mesh=None):
    eng = jengine_lib.InferenceEngine('llama-debug', max_len=MAX_LEN,
                                      mesh=mesh)
    eng.cfg = dataclasses.replace(eng.cfg, dtype=jnp.float32)
    eng.prefill_chunk = CHUNK
    return eng


def _jax_answers(eng):
    import asyncio
    eng.warmup()

    async def inner():
        client = TestClient(AioTestServer(jengine_lib.build_app(eng)))
        await client.start_server()
        try:
            loop = asyncio.get_running_loop()

            def post(path, body):
                async def one():
                    r = await client.post(path, json=body)
                    return r.status, await r.read()
                return asyncio.run_coroutine_threadsafe(one(), loop).result()
            return await loop.run_in_executor(None, _answers, post)
        finally:
            await client.close()
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(inner())
    finally:
        loop.close()


def _save_ckpt(jeng, ckdir):
    """The JAX engine's params (its bf16 cast, as fp32) as a port trainer
    checkpoint: both ranks' --ckpt-dir."""
    import jax
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        jax.device_get(jeng.params))
    cfg = dataclasses.replace(config.PRESETS['llama-debug'],
                              dtype=torch.float32)
    params = weights.params_from_jax(tree, cfg, device='cpu')
    state = train_lib.init_train_state(cfg, train_lib.default_optimizer(),
                                       'cpu', params=params)
    with checkpoints.Checkpointer(ckdir) as ck:
        ck.save(state, wait=True)


# --------------------------------------------------------------- the gang

def _spawn_gang(tmp, ckdir, coord_port, http_port):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS='1',
               SKYTPU_MH_TOKEN=secrets.token_hex(16),
               SKYTPU_MH_SEND_TIMEOUT=str(SEND_TIMEOUT_S),
               SKYTPU_ENGINE_PREFILL_CHUNK=str(CHUNK),
               SKYTPU_FAILPOINTS='engine.step=once',
               SKYTPU_OBSERVE_DB=os.path.join(tmp, 'journal.db'))
    flags = ['--model', 'llama-debug', '--device', 'cpu', '--max-len',
             str(MAX_LEN), '--ckpt-dir', ckdir, '--mesh', 'tensor=2',
             '--warm-buckets', '16,32', '--num-processes', '2',
             '--coordinator', f'127.0.0.1:{coord_port}', '--host',
             '127.0.0.1', '--port', str(http_port)]
    procs, logs = [], []
    for rank in (1, 0):
        path = os.path.join(tmp, f'rank{rank}.log')
        logs.append(path)
        with open(path, 'w') as f:
            procs.append(subprocess.Popen(
                [sys.executable, WORKER, *flags, '--process-id', str(rank)],
                env=env, stdout=f, stderr=subprocess.STDOUT))
    return procs, logs            # [follower, leader]


def _wait_healthy(base, procs, deadline):
    while time.monotonic() < deadline:
        for p in procs:
            assert p.poll() is None, f'a rank exited {p.returncode}'
        try:
            if json.loads(_get(base, '/health'))['status'] == 'ok':
                return
        except OSError:
            pass
        time.sleep(0.5)
    raise AssertionError('the gang never became healthy')


def _drive_gang(base, procs):
    """The gang's side of the scenario, in order: the armed step fault,
    the compared requests, the paths' counters, a refused disagg call,
    then the follower SIGKILLed under a request."""
    out = {}
    code, raw = _post(base, '/generate', {'tokens': FAULT,
                                          'max_new_tokens': 8})
    out['fault'] = (code, json.loads(raw))
    out['answers'] = _answers(lambda path, body: _post(base, path, body))
    metrics = _get(base, '/metrics')
    out['metrics'] = {line.split()[0]: float(line.split()[1])
                      for line in metrics.splitlines()
                      if line and not line.startswith('#')}
    out['flight'] = json.loads(_get(base, '/debug/flight?limit=4096'))
    out['disagg'] = _post(base, '/disagg/prefill?orig=/generate',
                          {'tokens': [1, 2], 'max_new_tokens': 2})
    out['follower_alive'] = procs[0].poll() is None
    procs[0].send_signal(signal.SIGKILL)
    procs[0].wait()
    t0 = time.monotonic()
    threading.Thread(target=_post, args=(base, '/generate', {
        'tokens': [1, 2, 3], 'max_new_tokens': 4}, 60), daemon=True).start()
    try:
        out['leader_rc'] = procs[1].wait(timeout=SEND_TIMEOUT_S + 30)
    except subprocess.TimeoutExpired:
        out['leader_rc'] = None
    out['leader_exit_s'] = time.monotonic() - t0
    return out


def _compute(tmp):
    ckdir = os.path.join(tmp, 'ck')
    single = _jax_engine()
    _save_ckpt(single, ckdir)
    http_port = _http_port(0)
    procs, logs = _spawn_gang(tmp, ckdir, _coord_port(0), http_port)
    try:
        # The two JAX engines compile at once (XLA compiles outside the
        # GIL), while the gang boots.
        sharded = _jax_engine(mesh='tensor=2')
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            ref = dict(zip(('single', 'tensor2'),
                           pool.map(_jax_answers, (single, sharded))))
        base = f'http://127.0.0.1:{http_port}'
        _wait_healthy(base, procs, time.monotonic() + 300)
        gang = _drive_gang(base, procs)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    gang['logs'] = {name: open(path).read()
                    for name, path in zip(('follower', 'leader'), logs)}
    return {'ref': ref, 'gang': gang}


@pytest.fixture(scope='module')
def results(tmp_path_factory):
    """The gang's scenario and the JAX references, computed once across
    xdist workers (a lock file in the shared temp root)."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get('PYTEST_XDIST_WORKER'):
        root = root.parent
    cache = root / 'torch_multihost_results.pkl'
    with open(str(cache) + '.lock', 'w') as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not cache.exists():
            data = _compute(str(tmp_path_factory.mktemp('gang')))
            with open(str(cache) + '.tmp', 'wb') as f:
                pickle.dump(data, f)
            os.replace(str(cache) + '.tmp', cache)
    with open(cache, 'rb') as f:
        return pickle.load(f)


# ---------------------------------------------------------- the gang: cases

@pytest.mark.parametrize('ref', ['single', 'tensor2'])
def test_gang_generate_tokens_equal_jax(results, ref):
    got, want = results['gang']['answers'], results['ref'][ref]
    for name, _, n in PROMPTS:
        assert len(got[name]) == n, name
        assert got[name] == want[name], name


@pytest.mark.parametrize('ref', ['single', 'tensor2'])
def test_gang_streamed_completion_and_chat_equal_jax(results, ref):
    got, want = results['gang']['answers'], results['ref'][ref]
    assert got['stream'] == want['stream']
    assert got['chat'] == want['chat']


def test_gang_took_the_prefix_chunk_and_speculation_paths(results):
    gang = results['gang']
    m = gang['metrics']
    assert m['skytpu_engine_prefix_hits_total'] >= 1
    assert m['skytpu_engine_spec_rounds_total'] >= 1
    kinds = [e['event'] for e in gang['flight']['events']]
    assert kinds.count('chunk') >= 3 + 4
    assert gang['follower_alive']
    follower = gang['logs']['follower']
    assert 'diverged' not in follower and 'mirroring leader ops' in follower


def test_step_fault_resets_both_ranks_and_next_request_answers(results):
    gang = results['gang']
    code, doc = gang['fault']
    assert code == 503 and doc['error']['type'] == 'engine_reset_error'
    # Both ranks failed the same step and rebuilt on the leader's reset.
    assert "follower op step failed: failpoint 'engine.step' fired" in \
        gang['logs']['follower']
    for log in gang['logs'].values():
        assert 'resetting the device state' in log
    assert gang['answers']['after_reset'] == results['ref']['single'][
        'after_reset']


def test_disagg_endpoints_are_refused_on_a_gang(results):
    code, raw = results['gang']['disagg']
    doc = json.loads(raw)
    assert code == 501 and doc['error']['type'] == 'handoff_unsupported'
    assert 'item 8' in doc['error']['message']


def test_killed_follower_fails_the_leader_within_send_timeout(results):
    gang = results['gang']
    assert gang['leader_rc'] == 13, gang['logs']['leader'][-3000:]
    assert gang['leader_exit_s'] < SEND_TIMEOUT_S + 5


# ------------------------------------------------------------- unit tests

def test_control_channel_refuses_guessable_token(monkeypatch):
    monkeypatch.delenv('SKYTPU_MH_TOKEN', raising=False)
    monkeypatch.delenv('SKYTPU_MH_ALLOW_INSECURE_TOKEN', raising=False)
    monkeypatch.setenv('SKYTPU_JOB_ID', '7')
    with pytest.raises(RuntimeError, match='SKYTPU_MH_TOKEN'):
        multihost._resolve_token()
    with pytest.raises(RuntimeError, match='SKYTPU_MH_TOKEN'):
        engine_lib.main(['--mesh', 'tensor=2', '--num-processes', '2',
                         '--coordinator', '127.0.0.1:1', '--device', 'cpu'])
    monkeypatch.setenv('SKYTPU_MH_ALLOW_INSECURE_TOKEN', '1')
    assert multihost._resolve_token() == '7'
    monkeypatch.setenv('SKYTPU_MH_TOKEN', 'per-job-secret')
    assert multihost._resolve_token() == 'per-job-secret'


def test_leader_send_timeout_armed_and_ops_are_plain_data(monkeypatch):
    """A real handshake over loopback: the accepted socket carries the
    send timeout, an op with a stripped request crosses, and a pickled
    class is refused."""
    monkeypatch.setenv('SKYTPU_MH_TOKEN', 'tok')
    coordinator = f'127.0.0.1:{_coord_port(90)}'
    follower = {}

    def connect():
        follower['chan'] = multihost.ControlFollower(coordinator)

    t = threading.Thread(target=connect, daemon=True)
    t.start()
    leader = multihost.ControlLeader(coordinator, num_processes=2)
    t.join(timeout=10)
    assert not t.is_alive()
    try:
        (conn,) = leader._conns
        assert conn.gettimeout() == multihost.SEND_TIMEOUT_S
        req = engine_lib.Request([1, 2, 3], 4, stop_ids=(9,),
                                 future=object(), stream=object())
        leader.send(('admit', multihost.strip_items([req]), (5, 1)))
        kind, items, fp = follower['chan'].recv()
        assert (kind, fp) == ('admit', (5, 1))
        assert engine_lib.Request(**items[0]) == dataclasses.replace(
            req, future=None, stream=None)
        multihost._send_msg(conn, ('admit', [req]))
        with pytest.raises(pickle.UnpicklingError, match='refuses class'):
            follower['chan'].recv()
    finally:
        leader.close()
        follower['chan']._sock.close()


def test_engine_flags_default_from_gang_env(monkeypatch):
    monkeypatch.setenv('SKYTPU_COORDINATOR_ADDRESS', '10.0.0.1:8476')
    monkeypatch.setenv('SKYTPU_NUM_PROCESSES', '4')
    monkeypatch.setenv('SKYTPU_NODE_RANK', '2')
    args = engine_lib.build_parser().parse_args([])
    assert (args.coordinator, args.num_processes, args.process_id) == \
        ('10.0.0.1:8476', 4, 2)
    assert (args.mesh, args.warm_buckets, args.seed) == (None, 'all', None)


def test_parse_mesh_arg():
    spec = engine_lib.parse_mesh_arg('data=2,tensor=4')
    assert spec.data == 2 and spec.tensor == 4
    with pytest.raises(ValueError):
        engine_lib.parse_mesh_arg('bogus_axis=2')
    with pytest.raises(ValueError):
        engine_lib.parse_mesh_arg('tensor:2')


def test_mesh_guards_refuse_a_non_dividing_mesh():
    # kv_heads=2 % 8: refused at construction, before any group.
    with pytest.raises(ValueError, match='divisible'):
        engine_lib.InferenceEngine('llama-debug', device='cpu',
                                   max_len=64, mesh='tensor=8')


@pytest.mark.parametrize('axis', engine_lib.WAITING_MESH_AXES)
def test_waiting_mesh_axes_are_refused_by_name(axis):
    with pytest.raises(NotImplementedError,
                       match=f"{axis}=2: serving over the '{axis}'.*item 8"):
        engine_lib.InferenceEngine('llama-debug', device='cpu', max_len=64,
                                   mesh=f'{axis}=2,tensor=2')


def test_moe_int8_on_a_mesh_is_refused_by_name():
    """int8 weights of the MoE family stay refused on a mesh, as in
    JAX (its expert dispatch does not read through the dequant)."""
    with pytest.raises(NotImplementedError,
                       match='int8 decode is implemented for the dense'):
        engine_lib.InferenceEngine('moe-debug', device='cpu', max_len=64,
                                   quantize='int8',
                                   mesh='expert=2,tensor=2')


@pytest.mark.parametrize('model,mesh,what', [
    ('moe-debug', 'expert=3', 'n_experts=4'),
    ('gptoss-debug', 'expert=2,tensor=4', 'n_kv_heads=2'),
    ('mla-debug', 'tensor=3', 'n_heads=4'),
    ('deepseek-moe-debug', 'expert=3,tensor=2', 'n_experts=4')])
def test_moe_and_mla_at_a_non_dividing_mesh_are_refused(model, mesh, what):
    """The family's JAX divisibility check, at construction and before
    any group is made."""
    with pytest.raises(ValueError, match=f'{what} not divisible'):
        engine_lib.InferenceEngine(model, device='cpu', max_len=64,
                                   mesh=mesh)


def test_a_gang_must_span_the_mesh(monkeypatch):
    """--num-processes must be the mesh's size: refused before the
    process joins any world."""
    monkeypatch.setenv('SKYTPU_MH_TOKEN', 'tok')
    with pytest.raises(ValueError, match='2 devices not divisible by fixed axes 4'):
        engine_lib.main(['--model', 'moe-debug', '--device', 'cpu',
                         '--mesh', 'expert=2,tensor=2', '--num-processes',
                         '2', '--coordinator', '127.0.0.1:1'])


def test_mesh_needs_a_gang_and_a_gang_needs_a_mesh(monkeypatch):
    monkeypatch.setenv('SKYTPU_MH_TOKEN', 'tok')
    with pytest.raises(ValueError, match='one process holds one rank'):
        engine_lib.main(['--mesh', 'tensor=2', '--device', 'cpu'])
    with pytest.raises(ValueError, match='needs --mesh'):
        engine_lib.main(['--num-processes', '2', '--coordinator',
                         '127.0.0.1:1', '--device', 'cpu'])


def test_warm_disagg_is_refused_on_a_mesh(monkeypatch):
    monkeypatch.setenv('SKYTPU_ENGINE_WARM_DISAGG', '1')
    with pytest.raises(NotImplementedError,
                       match='WARM_DISAGG on a serving mesh.*item 8'):
        engine_lib.InferenceEngine('llama-debug', device='cpu', max_len=64,
                                   mesh='tensor=1')
