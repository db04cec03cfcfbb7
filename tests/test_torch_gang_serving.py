"""The MoE and MLA families served by one replica over a gang of ranks:
the port's engine at ``--mesh expert=2,tensor=2`` (four processes) and
``--mesh tensor=2`` (two) on the CPU (gloo), against the JAX engine
unsharded and at the meshes tests/unit_tests/test_engine_sharded.py
serves them on (the conftest's 8 CPU devices).

Each gang runs ``python tests/torch_mh_worker.py`` (the engine's own
``main``, the debug presets in fp32), every rank restoring one
``--ckpt-dir`` written here from the JAX engine's weights: gptoss-debug
(sinks, windows, clamped SwiGLU, YaRN, qkv biases, routed experts) and
deepseek-moe-debug (MLA with routed and shared experts) at
expert=2,tensor=2, mla-debug at tensor=2, and mla-debug with int8
weights at tensor=2 (the checkpoint holds the fp32 masters of the
quantized leaves, which every rank quantizes whole before it cuts its
shard, as the JAX engine does). The prompts are the JAX tests'. Greedy
``/generate`` tokens, sent at once, and a streamed ``/v1/completions``
must be IDENTICAL to both JAX engines'. The gangs and the JAX engines
run at once and are computed once, cached under a file lock in pytest's
shared temp root, so xdist workers share them.

Ports: fixed, below the kernel's ephemeral range (tests/torch_ports.py,
offsets 10..40 for the coordinators and the HTTP ports), beside
tests/test_torch_multihost.py's 0 and 90.
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
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient
from aiohttp.test_utils import TestServer as AioTestServer

from skypilot_tpu import models as jmodels
from skypilot_tpu.models import decode as jdecode
from skypilot_tpu.serve import engine as jengine_lib
from skypilot_tpu_torch import config
from skypilot_tpu_torch.models import weights
from skypilot_tpu_torch.train import checkpoints, train_lib
from test_torch_multihost import (_coord_port, _get, _http_port, _post,
                                  _sse_text, _wait_healthy)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, 'tests', 'torch_mh_worker.py')
# Not test_engine_sharded.py's 64: JAX engines of the same models and
# meshes at the same length compile the same programs, and two xdist
# workers writing one persistent-cache entry at once can hand a reader a
# partial file.
MAX_LEN = 96
MOE_PROMPTS = ([[1, 2, 3, 4], [9] * 7], 6)
MLA_PROMPTS = ([[1, 2, 3, 4, 5], [7] * 9, [3, 1, 4, 1, 5, 9, 2, 6]], 8)
# name: (model, the gang's mesh, its ranks, the JAX engine's mesh,
# quantize, (prompts, max_new_tokens))
GANGS = {
    'gptoss': ('gptoss-debug', 'expert=2,tensor=2', 4,
               'expert=2,tensor=2,data=2', None, MOE_PROMPTS),
    'deepseek': ('deepseek-moe-debug', 'expert=2,tensor=2', 4,
                 'expert=2,tensor=2,data=2', None, MOE_PROMPTS),
    'mla': ('mla-debug', 'tensor=2', 2, 'data=2,fsdp=2,tensor=2', None,
            MLA_PROMPTS),
    'mla_int8': ('mla-debug', 'tensor=2', 2, 'data=2,fsdp=2,tensor=2',
                 'int8', (MLA_PROMPTS[0][:2], 8)),
}
STREAM = {'prompt': 'Hello gang', 'max_tokens': 6, 'temperature': 0,
          'stream': True}


def _answers(name, post):
    """Every compared request through ``post(path, body)``: the greedy
    prompts sent at once, then the streamed completion."""
    prompts, n = GANGS[name][5]
    with concurrent.futures.ThreadPoolExecutor(len(prompts)) as pool:
        got = list(pool.map(lambda t: post('/generate', {
            'tokens': t, 'max_new_tokens': n}), prompts))
    out = {}
    for i, (code, raw) in enumerate(got):
        assert code == 200, raw
        out[i] = json.loads(raw)['tokens']
    code, raw = post('/v1/completions', STREAM)
    assert code == 200, raw
    out['stream'] = _sse_text(raw)
    return out


# ---------------------------------------------------------------- JAX side

def _jax_engine(name, mesh=None):
    model, _, _, _, quantize, _ = GANGS[name]
    eng = jengine_lib.InferenceEngine(model, max_len=MAX_LEN, mesh=mesh,
                                      quantize=quantize)
    eng.cfg = dataclasses.replace(eng.cfg, dtype=jnp.float32)
    # No warm-up: the requests compile only the programs they run.
    eng.warm = True
    return eng


def _jax_answers(name, mesh=None):
    import asyncio
    eng = _jax_engine(name, mesh)

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
            return await loop.run_in_executor(None, _answers, name, post)
        finally:
            await client.close()
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(inner())
    finally:
        loop.close()


def _save_ckpt(name, ckdir):
    """The JAX engine's weights as a port trainer checkpoint, every
    rank's --ckpt-dir: its params (their bf16 cast, as fp32), and for an
    int8 engine the fp32 masters of the leaves it quantizes (drawn as
    the JAX engine draws them)."""
    model, _, _, _, quantize, _ = GANGS[name]
    jcfg = jmodels.get_config(model)
    tree = jax.jit(lambda r: jmodels.module_for(jcfg).init_params(r, jcfg))(
        jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        jax.device_get(tree))
    quantized = jdecode._QUANT_KEYS if quantize else ()
    rounded = {k: (v if k in quantized and 2 <= v.ndim <= 3 else
                   np.asarray(jnp.asarray(v, jnp.bfloat16), np.float32))
               for k, v in tree['layers'].items()}
    tree = {k: np.asarray(jnp.asarray(v, jnp.bfloat16), np.float32)
            for k, v in tree.items() if k != 'layers'}
    tree['layers'] = rounded
    cfg = dataclasses.replace(config.get_config(model), dtype=torch.float32)
    params = weights.params_from_jax(tree, cfg, device='cpu')
    state = train_lib.init_train_state(cfg, train_lib.default_optimizer(),
                                       'cpu', params=params)
    with checkpoints.Checkpointer(ckdir) as ck:
        ck.save(state, wait=True)


# --------------------------------------------------------------- the gangs

def _spawn_gang(name, tmp, coord_port, http_port):
    model, mesh, ranks, _, quantize, _ = GANGS[name]
    ckdir = os.path.join(tmp, f'ck_{name}')
    _save_ckpt(name, ckdir)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS='1',
               SKYTPU_MH_TOKEN=secrets.token_hex(16),
               SKYTPU_OBSERVE_DB=os.path.join(tmp, f'journal_{name}.db'))
    flags = ['--model', model, '--device', 'cpu', '--max-len', str(MAX_LEN),
             '--ckpt-dir', ckdir, '--mesh', mesh, '--warm-buckets', '16',
             '--num-processes', str(ranks), '--coordinator',
             f'127.0.0.1:{coord_port}', '--host', '127.0.0.1', '--port',
             str(http_port)] + (['--quantize', quantize] if quantize else [])
    procs, logs = [], []
    for rank in reversed(range(ranks)):
        path = os.path.join(tmp, f'{name}_rank{rank}.log')
        logs.append(path)
        with open(path, 'w') as f:
            procs.append(subprocess.Popen(
                [sys.executable, WORKER, *flags, '--process-id', str(rank)],
                env=env, stdout=f, stderr=subprocess.STDOUT))
    return procs, logs            # the leader last


def _drive_gang(name, base, procs):
    """The compared requests and the gang's health, then SIGTERM to the
    leader: every rank must exit 0."""
    _wait_healthy(base, procs, time.monotonic() + 300)
    out = {'answers': _answers(name, lambda path, body: _post(base, path,
                                                              body)),
           'health': json.loads(_get(base, '/health'))}
    procs[-1].send_signal(signal.SIGTERM)
    out['rcs'] = [p.wait(timeout=60) for p in procs]
    return out


def _compute(tmp):
    gangs = {}
    try:
        for i, name in enumerate(GANGS):
            http_port = _http_port(10 * (i + 1))
            gangs[name] = (f'http://127.0.0.1:{http_port}',
                           *_spawn_gang(name, tmp, _coord_port(10 * (i + 1)),
                                        http_port))
        # The JAX engines compile at once (XLA compiles outside the GIL)
        # while the gangs boot.
        with concurrent.futures.ThreadPoolExecutor(2 * len(GANGS)) as pool:
            refs = {(name, mesh): pool.submit(_jax_answers, name, mesh)
                    for name in GANGS for mesh in (None, GANGS[name][3])}
            got = {name: pool.submit(_drive_gang, name, base, procs)
                   for name, (base, procs, _) in gangs.items()}
            ref = {key: f.result() for key, f in refs.items()}
            got = {name: f.result() for name, f in got.items()}
    finally:
        for _, procs, _ in gangs.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
    for name, (_, _, logs) in gangs.items():
        got[name]['logs'] = [open(path).read() for path in logs]
    return {'ref': ref, 'gang': got}


@pytest.fixture(scope='module')
def results(tmp_path_factory):
    root = tmp_path_factory.getbasetemp()
    if os.environ.get('PYTEST_XDIST_WORKER'):
        root = root.parent
    cache = root / 'torch_gang_serving_results.pkl'
    with open(str(cache) + '.lock', 'w') as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not cache.exists():
            data = _compute(str(tmp_path_factory.mktemp('gangs')))
            with open(str(cache) + '.tmp', 'wb') as f:
                pickle.dump(data, f)
            os.replace(str(cache) + '.tmp', cache)
    with open(cache, 'rb') as f:
        return pickle.load(f)


@pytest.mark.parametrize('ref', ['single', 'sharded'])
@pytest.mark.parametrize('name', list(GANGS))
def test_gang_tokens_and_stream_equal_jax(results, name, ref):
    """The gang's greedy tokens and streamed text equal the JAX
    engine's, unsharded and on its own mesh."""
    got = results['gang'][name]['answers']
    want = results['ref'][(name, None if ref == 'single' else
                           GANGS[name][3])]
    prompts, n = GANGS[name][5]
    for i in range(len(prompts)):
        assert len(got[i]) == n
        assert got[i] == want[i], (i, got[i], want[i])
    assert got['stream'] == want['stream']


@pytest.mark.parametrize('name', list(GANGS))
def test_every_rank_serves_its_shard_and_exits_clean(results, name):
    """Every rank logs its mesh coordinates, the followers mirror the
    leader without diverging, and the leader's SIGTERM stops them all
    with exit code 0."""
    gang = results['gang'][name]
    mesh, ranks = GANGS[name][1], GANGS[name][2]
    assert gang['rcs'] == [0] * ranks, (gang['rcs'], [
        log[-2000:] for log in gang['logs']])
    assert gang['health']['status'] == 'ok'
    for log in gang['logs']:
        assert 'Serving on mesh' in log and 'diverged' not in log
    for axis in mesh.split(','):
        ax, n = axis.split('=')
        assert f"'{ax}': {n}" in gang['logs'][-1]
