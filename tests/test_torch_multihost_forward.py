"""The dense forward sharded over 'tensor' against the JAX package, on
the CPU.

Two ranks of a real gloo process group (tests/torch_dist_worker.py's
'tp' jobs, spawned once for the module with a ``file://`` rendezvous)
each hold their shard of the bridged JAX weights
(parallel/sharding.py ``shard_params`` over models/llama.py
``param_axes``) and run the engine's functions: a ragged prefill
scattered into pages, then three paged decode steps with one row
inactive, fed fixed tokens. Every step's logits, gathered to the whole
vocabulary, must equal on both ranks and lie within 1e-5 of the JAX
logits' std of JAX ``decode.prefill`` / ``paged_decode_step`` on the
same weights in fp32, for llama-debug, llama-debug with the Gemma
switches (post norms, both softcaps, the embedding scale, tied
embeddings, q/k norms; the zero-initialised leaves made random, as
tests/test_torch_gemma.py makes them) and Qwen2's q/k/v biases. The
int8-weight shard (quantized whole, then sharded as the JAX engine
shards it) and the int8 K/V pools (each rank its kv heads' codes and
scales) are held to the same bound against the one-rank port. A spied
run records every all_reduce / all_gather input through a paged verify
fed transposed tokens: all must be contiguous.
Results are cached under a file lock in pytest's shared temp root, so
xdist workers share one computation.
"""
import dataclasses
import fcntl
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import decode as jdecode
from skypilot_tpu.models import llama as jllama
from skypilot_tpu.models import paging as jpaging

import torch_dist_worker
from skypilot_tpu_torch.models import decode, weights

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, 'tests', 'torch_dist_worker.py')
WORLD = 2
REL = 1e-5
GEMMA = dict(norm_plus_one=True, mlp_activation='gelu', embed_scale=True,
             tie_embeddings=True, post_norms=True, attn_logit_softcap=1.0,
             final_logit_softcap=2.0, qk_norm=True)
CASES = {'llama': {}, 'gemma': GEMMA, 'qwen2': dict(qkv_bias=True)}
_RANDOMISED = ('attn_norm', 'mlp_norm', 'post_attn_norm', 'post_mlp_norm',
               'q_norm', 'k_norm', 'bq', 'bk', 'bv')


def _tree(overrides, seed):
    """JAX init_params of llama-debug with ``overrides`` (fp32), its
    zero- and one-initialised leaves made random."""
    jcfg = dataclasses.replace(jllama.PRESETS['llama-debug'],
                               dtype=jnp.float32, **overrides)
    tree = jax.device_get(jllama.init_params(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    for key in _RANDOMISED:
        if key in tree['layers']:
            tree['layers'][key] = 0.3 * rng.standard_normal(
                tree['layers'][key].shape).astype(np.float32)
    tree['final_norm'] = 0.3 * rng.standard_normal(
        tree['final_norm'].shape).astype(np.float32)
    return jcfg, tree


def _job(name, overrides, seed, quantize=None, kv_quant='none',
         spy=False):
    rng = np.random.default_rng(seed)
    b, s, max_len, psz = 3, 16, 64, 8
    maxp = max_len // psz
    lengths = np.array([16, 9, 3], np.int32)
    jcfg, tree = _tree(overrides, seed)
    return dict(kind='tp', world=WORLD, model='llama-debug', dtype='float32',
                overrides=overrides, params=tree, quantize=quantize,
                tokens=rng.integers(0, 256, (b, s)).astype(np.int32),
                lengths=lengths, max_len=max_len,
                table=rng.permutation(np.arange(1, b * maxp + 1)).reshape(
                    b, maxp).astype(np.int32),
                feed=rng.integers(0, 256, (3, b)).astype(np.int32),
                active=np.array([True, False, True]), kv_quant=kv_quant,
                spy=spy, verify=(rng.integers(0, 256, (4, b)).astype(np.int32)
                                 if spy else None))


def _jobs():
    jobs = {name: _job(name, kw, seed) for seed, (name, kw)
            in enumerate(CASES.items())}
    jobs['int8'] = _job('int8', {}, 7, quantize='int8')
    jobs['kv_int8'] = _job('kv_int8', {}, 8, kv_quant='int8')
    jobs['contig'] = _job('contig', {}, 9, spy=True)
    return jobs


# Held against the port on one rank, not JAX: int8 weights, int8 pools
# and the spied run (whose verify JAX's reference does not take).
ONE_RANK = ('int8', 'kv_int8', 'contig')


def _jax_logits(job):
    """JAX decode.prefill, scatter_prefill and paged_decode_step on the
    job's inputs, fed the job's tokens."""
    jcfg = dataclasses.replace(jllama.PRESETS['llama-debug'],
                               dtype=jnp.float32, **job['overrides'])
    jparams = jax.tree.map(jnp.asarray, job['params'])
    b, s = job['tokens'].shape
    maxp = job['table'].shape[1]
    psz = job['max_len'] // maxp
    logits, rows = jdecode.prefill(jparams, jnp.asarray(job['tokens']), jcfg,
                                   job['max_len'],
                                   lengths=jnp.asarray(job['lengths']))
    pool = dataclasses.replace(
        jdecode.init_page_pool(jcfg, b * maxp + 1, psz, b, maxp),
        table=jnp.asarray(job['table']))
    pool = jpaging.scatter_prefill(pool, rows, jnp.arange(b), s,
                                   jnp.asarray(job['lengths']))
    out = [np.asarray(logits)]
    for tok in job['feed']:
        logits, pool = jdecode.paged_decode_step(
            jparams, jnp.asarray(tok), pool, jcfg, max_len=job['max_len'],
            active=jnp.asarray(job['active']))
        out.append(np.asarray(logits))
    return out


def _one_rank(job):
    """The port on one rank, unsharded (the int8 case's reference)."""
    cfg = torch_dist_worker.tp_config(job)
    params = decode.cast_params_for_decode(
        weights.params_from_jax(job['params'], cfg, device='cpu'), cfg,
        quantize=job.get('quantize'))
    with torch.no_grad():
        return torch_dist_worker.paged_logits(params, cfg, job)


def _compute(tmp):
    jobs = _jobs()
    path = os.path.join(tmp, 'jobs.pkl')
    with open(path, 'wb') as f:
        pickle.dump(jobs, f)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS='1')
    procs = [subprocess.Popen(
        [sys.executable, WORKER, path, str(r), str(WORLD),
         os.path.join(tmp, 'init'), tmp], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    try:
        ref = {name: (_one_rank(job) if name in ONE_RANK else
                      _jax_logits(job)) for name, job in jobs.items()}
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    port = {}
    for r in range(WORLD):
        with open(os.path.join(tmp, f'rank{r}.pkl'), 'rb') as f:
            for name, res in pickle.load(f).items():
                port.setdefault(name, {})[r] = res
    return {'jobs': jobs, 'ref': ref, 'port': port}


@pytest.fixture(scope='module')
def results(tmp_path_factory):
    root = tmp_path_factory.getbasetemp()
    if os.environ.get('PYTEST_XDIST_WORKER'):
        root = root.parent
    cache = root / 'torch_tp_forward_results.pkl'
    with open(str(cache) + '.lock', 'w') as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not cache.exists():
            data = _compute(str(tmp_path_factory.mktemp('tp_ranks')))
            with open(str(cache) + '.tmp', 'wb') as f:
                pickle.dump(data, f)
            os.replace(str(cache) + '.tmp', cache)
    with open(cache, 'rb') as f:
        return pickle.load(f)


@pytest.mark.parametrize('name', [*CASES, 'int8', 'kv_int8'])
def test_sharded_prefill_and_paged_steps_match(results, name):
    """Both ranks' logits are the same bits, and within REL of the
    reference's std at the prefill and at every decode step (the
    inactive row's logits are not compared: its writes go to the trash
    page). 'kv_int8' runs on int8 pools, each rank holding its kv
    heads' codes and scales."""
    active = results['jobs'][name]['active']
    ranks = results['port'][name]
    assert sorted(ranks) == list(range(WORLD))
    for step, want in enumerate(results['ref'][name]):
        got = ranks[0][step]
        for r in range(1, WORLD):
            np.testing.assert_array_equal(ranks[r][step], got)
        rows = slice(None) if step == 0 else active
        assert got.shape == want.shape
        err = float(np.abs(got[rows] - want[rows]).max())
        assert err <= REL * float(want[rows].std()), (step, err)


def test_collective_inputs_are_contiguous(results):
    """Every tensor the sharded forward hands all_reduce or all_gather
    is contiguous (NCCL reduces nothing else), through a paged verify
    fed tokens with transposed strides, as the engine feeds its verify;
    the verify's logits equal the one-rank port's."""
    ranks = results['port']['contig']
    for r in range(WORLD):
        calls = ranks[r]['collectives']
        names = {name for name, _ in calls}
        assert names == {'all_reduce', 'all_gather'}, names
        assert all(ok for _, ok in calls), \
            [i for i, (_, ok) in enumerate(calls) if not ok]
    got, want = ranks[0]['logits'][-1], results['ref']['contig'][-1]
    active = results['jobs']['contig']['active']
    np.testing.assert_array_equal(ranks[1]['logits'][-1], got)
    err = float(np.abs(got[active] - want[active]).max())
    assert err <= REL * float(want[active].std())
