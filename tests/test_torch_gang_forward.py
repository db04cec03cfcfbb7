"""The MoE and MLA families sharded over 'expert' and 'tensor' against
the JAX package, on the CPU.

Real gloo process groups (tests/torch_dist_worker.py's 'tp' jobs, one
group of four ranks and one of two, spawned once for the module with
``file://`` rendezvous) hold their shards of the bridged JAX weights
(parallel/sharding.py ``shard_params`` over the family's
``param_axes``) and run the engine's functions: a ragged prefill
scattered into pages, then three paged decode steps with one row
inactive, fed fixed tokens. Every step's logits, gathered to the whole
vocabulary, must be the same bits on every rank and lie within 1e-5 of
the JAX logits' std (as tests/test_torch_multihost_forward.py holds the
dense gang) of JAX ``prefill`` / ``paged_decode_step`` on the same
weights in fp32:
  - moe-debug and gptoss-debug (sinks, windows, clamped SwiGLU, YaRN,
    qkv biases) at expert=2,tensor=2: each rank two of the four experts
    at half their hidden units, and half the heads;
  - mla-debug and deepseek-moe-debug at tensor=2, deepseek-moe-debug at
    expert=2,tensor=2: the heads over 'tensor', the latent pool whole;
  - mla-debug with int8 weights at tensor=2 (quantized whole, then
    sharded, against JAX's int8 decode);
  - llama-debug at expert=2,tensor=2: replicated over 'expert';
  - DeepSeekMoE's shared experts alone (the routed experts' w_down
    zeroed) at expert=2,tensor=2: they are counted once, not once per
    'expert' index (the same gang adding them on every index fails);
  - the MoE and DeepSeekMoE gangs hand every collective contiguous
    inputs, a paged verify fed transposed tokens included.
The norms, sinks and biases are randomised and the routers scaled up
(x5), as tests/test_torch_moe.py makes them, so every leaf matters and
no route rests on a near tie. Results are cached under a file lock in
pytest's shared temp root, so xdist workers share one computation.
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

from skypilot_tpu import models as jmodels
from skypilot_tpu.models import decode as jdecode
from skypilot_tpu.models import mla as jmla
from skypilot_tpu.models import paging as jpaging

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, 'tests', 'torch_dist_worker.py')
REL = 1e-5
EXPERT_TENSOR = {'expert': 2, 'tensor': 2}
TENSOR = {'tensor': 2}
# name: (model, mesh, quantize, zero the routed experts' w_down)
CASES = {
    'moe': ('moe-debug', EXPERT_TENSOR, None, False),
    'gptoss': ('gptoss-debug', EXPERT_TENSOR, None, False),
    'mla': ('mla-debug', TENSOR, None, False),
    'deepseek_tp': ('deepseek-moe-debug', TENSOR, None, False),
    'deepseek_ep_tp': ('deepseek-moe-debug', EXPERT_TENSOR, None, False),
    'mla_int8': ('mla-debug', TENSOR, 'int8', False),
    'llama_ep_tp': ('llama-debug', EXPERT_TENSOR, None, False),
    'shared_only': ('deepseek-moe-debug', EXPERT_TENSOR, None, True),
}
# Run beside the cases: 'shared_only' with every rank taking itself for
# expert index 0, so that the shared experts join the sum on each
# 'expert' index (the fault the shared-experts test must see); and the
# MoE and DeepSeekMoE gangs with every collective's inputs recorded
# through a paged verify fed transposed tokens (the engine's feed).
FAULTY = 'shared_everywhere'
SPIED = ('moe', 'deepseek_ep_tp')

_RANDOMISED = ('attn_norm', 'mlp_norm', 'moe_norm', 'kv_norm')
_RANDOM_ZEROS = ('sink', 'bq', 'bk', 'bv')


def _jcfg(model):
    return dataclasses.replace(jmodels.get_config(model), dtype=jnp.float32)


def _tree(model, seed, zero_routed):
    """JAX init_params of ``model`` (fp32), its norms, sinks and biases
    made random and its router scaled x5; with ``zero_routed`` the
    routed experts' w_down is zero, so the FFN is the shared experts'
    alone."""
    jcfg = _jcfg(model)
    tree = jax.device_get(jmodels.module_for(jcfg).init_params(
        jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    lay = tree['layers']
    for key in _RANDOMISED + _RANDOM_ZEROS:
        if key in lay:
            base = 0.0 if key in _RANDOM_ZEROS else 1.0
            lay[key] = base + 0.3 * rng.standard_normal(
                lay[key].shape).astype(np.float32)
    if 'router' in lay:
        lay['router'] = 5 * np.asarray(lay['router'])
    if zero_routed:
        lay['w_down'] = np.zeros_like(lay['w_down'])
    tree['final_norm'] = 1.0 + 0.3 * rng.standard_normal(
        tree['final_norm'].shape).astype(np.float32)
    return tree


def _job(name, seed):
    model, mesh, quantize, zero_routed = CASES[name]
    rng = np.random.default_rng(seed)
    b, s, max_len, psz = 3, 16, 64, 8
    maxp = max_len // psz
    return dict(kind='tp', world=int(np.prod(list(mesh.values()))),
                mesh=mesh, model=model, dtype='float32', overrides={},
                params=_tree(model, seed, zero_routed), quantize=quantize,
                tokens=rng.integers(0, 256, (b, s)).astype(np.int32),
                lengths=np.array([16, 9, 3], np.int32), max_len=max_len,
                table=rng.permutation(np.arange(1, b * maxp + 1)).reshape(
                    b, maxp).astype(np.int32),
                feed=rng.integers(0, 256, (3, b)).astype(np.int32),
                active=np.array([True, False, True]))


def _jax_logits(job):
    """JAX prefill, scatter_prefill and paged_decode_step of the job's
    family (int8 weights from JAX's own cast), fed the job's tokens."""
    jcfg = _jcfg(job['model'])
    jparams = jax.tree.map(jnp.asarray, job['params'])
    if job['quantize']:
        jparams = jdecode.cast_params_for_decode(jparams, jcfg,
                                                 quantize=job['quantize'])
    dec = jmla if isinstance(jcfg, jmla.MLAConfig) else jdecode
    b, s = job['tokens'].shape
    maxp = job['table'].shape[1]
    psz = job['max_len'] // maxp
    logits, rows = dec.prefill(jparams, jnp.asarray(job['tokens']), jcfg,
                               job['max_len'],
                               lengths=jnp.asarray(job['lengths']))
    pool = dataclasses.replace(
        dec.init_page_pool(jcfg, b * maxp + 1, psz, b, maxp),
        table=jnp.asarray(job['table']))
    pool = jpaging.scatter_prefill(pool, rows, jnp.arange(b), s,
                                   jnp.asarray(job['lengths']))
    out = [np.asarray(logits)]
    for tok in job['feed']:
        logits, pool = dec.paged_decode_step(
            jparams, jnp.asarray(tok), pool, jcfg, max_len=job['max_len'],
            active=jnp.asarray(job['active']))
        out.append(np.asarray(logits))
    return out


def _compute(tmp):
    jobs = {name: _job(name, seed) for seed, name in enumerate(CASES)}
    jobs[FAULTY] = dict(jobs['shared_only'], expert_index_zero=True)
    for name in SPIED:
        jobs[f'{name}_spy'] = dict(
            jobs[name], spy=True, verify=np.random.default_rng(9).integers(
                0, 256, (4, 3)).astype(np.int32))
    path = os.path.join(tmp, 'jobs.pkl')
    with open(path, 'wb') as f:
        pickle.dump(jobs, f)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS='1')
    procs = []
    for world in sorted({job['world'] for job in jobs.values()}):
        out = os.path.join(tmp, f'world{world}')
        os.makedirs(out)
        procs += [(world, out, subprocess.Popen(
            [sys.executable, WORKER, path, str(r), str(world),
             os.path.join(out, 'init'), out], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            for r in range(world)]
    try:
        ref = {name: _jax_logits(job) for name, job in jobs.items()
               if name in CASES}
        logs = [p.communicate(timeout=600)[0] for _, _, p in procs]
    finally:
        for _, _, p in procs:
            if p.poll() is None:
                p.kill()
    for (_, _, p), log in zip(procs, logs):
        assert p.returncode == 0, log
    port = {}
    for world, out in sorted({(w, o) for w, o, _ in procs}):
        for r in range(world):
            with open(os.path.join(out, f'rank{r}.pkl'), 'rb') as f:
                for name, res in pickle.load(f).items():
                    port.setdefault(name, {})[r] = res
    return {'jobs': jobs, 'ref': ref, 'port': port}


@pytest.fixture(scope='module')
def results(tmp_path_factory):
    root = tmp_path_factory.getbasetemp()
    if os.environ.get('PYTEST_XDIST_WORKER'):
        root = root.parent
    cache = root / 'torch_gang_forward_results.pkl'
    with open(str(cache) + '.lock', 'w') as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not cache.exists():
            data = _compute(str(tmp_path_factory.mktemp('gang_ranks')))
            with open(str(cache) + '.tmp', 'wb') as f:
                pickle.dump(data, f)
            os.replace(str(cache) + '.tmp', cache)
    with open(cache, 'rb') as f:
        return pickle.load(f)


@pytest.mark.parametrize('name', list(CASES))
def test_sharded_prefill_and_paged_steps_match_jax(results, name):
    """Every rank's logits are the same bits, and within REL of JAX's
    std at the prefill and at every decode step (the inactive row's
    logits are not compared: its writes go to the trash page)."""
    job = results['jobs'][name]
    ranks = results['port'][name]
    assert sorted(ranks) == list(range(job['world']))
    for step, want in enumerate(results['ref'][name]):
        got = ranks[0][step]
        for r in range(1, job['world']):
            np.testing.assert_array_equal(ranks[r][step], got)
        rows = slice(None) if step == 0 else job['active']
        assert got.shape == want.shape
        err = float(np.abs(got[rows] - want[rows]).max())
        assert err <= REL * float(want[rows].std()), (step, err)


def test_shared_experts_are_counted_once(results):
    """The FFN of 'shared_only' is DeepSeekMoE's shared experts alone
    (the routed experts' w_down zero) at expert=2: the gang's logits
    are JAX's, while the same gang adding the shared experts on both
    'expert' indices (as one all-reduce over ('expert', 'tensor') of
    every rank's shared partial would) lies far outside REL."""
    assert results['jobs']['shared_only']['mesh']['expert'] == 2
    for step, want in enumerate(results['ref']['shared_only']):
        rows = slice(None) if step == 0 else \
            results['jobs']['shared_only']['active']
        bound = REL * float(want[rows].std())
        good = results['port']['shared_only'][0][step]
        bad = results['port'][FAULTY][0][step]
        assert float(np.abs(good[rows] - want[rows]).max()) <= bound
        assert float(np.abs(bad[rows] - want[rows]).max()) > 1000 * bound


@pytest.mark.parametrize('name', SPIED)
def test_collective_inputs_are_contiguous(results, name):
    """Every tensor the MoE and MLA gangs hand all_reduce or all_gather
    is contiguous (NCCL reduces nothing else), through the prefill, the
    steps and a paged verify fed tokens with transposed strides; every
    rank's logits are the same bits and the steps' equal the unspied
    run's."""
    ranks = results['port'][f'{name}_spy']
    for r, res in ranks.items():
        names = {n for n, _ in res['collectives']}
        assert names == {'all_reduce', 'all_gather'}, names
        assert all(ok for _, ok in res['collectives'])
        for got, want in zip(res['logits'], ranks[0]['logits']):
            np.testing.assert_array_equal(got, want)
    for got, want in zip(ranks[0]['logits'], results['port'][name][0]):
        np.testing.assert_array_equal(got, want)
