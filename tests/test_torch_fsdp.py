"""Fully-sharded data-parallel training in the port against the JAX
package's, on the CPU: the JAX trainer's default mesh (every rank on
'fsdp'), 'data' x 'fsdp' and 'fsdp' x 'sequence', the sharded draw, the
router aux across ranks, and per-rank checkpoint chunks.

Ranks are real gloo process groups: tests/torch_dist_worker.py's
'fsdp' jobs, one process a rank (torch and the port only), a group of
2 and a group of 4 spawned once for the module. JAX runs its own
``make_train_step`` (and ``jax.value_and_grad`` of its loss) on the same
``MeshSpec`` over the first 2 or 4 of the conftest's 8 CPU devices, as
tests/test_torch_ring.py's ``_jax_train`` does, from the params the
port bridges (models/weights.py). The results are computed once and
cached under a file lock in pytest's shared temp root, so xdist
workers share them.

Checkpoints: the port's fsdp=2 gang saves a step, which is held
against what JAX's ``Checkpointer`` writes for ``MeshSpec(fsdp=2)``
(paths, shapes, dtypes, specs, chunk starts) and restored by JAX bit
for bit; the data=2,fsdp=2 gang's step restores at fsdp=2 and the
fsdp=2 gang's at data=2,fsdp=2 (each waiting for the other's
manifest), and a JAX step from ``MeshSpec(data=2, fsdp=4)`` on 8
devices restores on the fsdp=2 gang and on one process, bit for bit.

Tolerances: the llama-debug and mla-debug train steps (fp32, two steps
at the peak learning rate) at tests/test_torch_ring.py's
``test_train_step_matches_jax`` bounds: loss within 2e-3, grad norm
1e-2 relative, params within 1e-2 and the update within TOL_UPDATE of
JAX's. The MoE and MLA-MoE CE and aux within tests/torch_train_parity.py's
TOL (2e-4) and every leaf's grads within its TOL_GRAD (1e-4) of the
leaf's largest JAX grad (the norms and the router randomised, so no
route rests on a near tie).
"""
import concurrent.futures
import dataclasses
import fcntl
import json
import os
import pickle
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ports
import torch_train_parity as tp
from skypilot_tpu import models as jmodels
from skypilot_tpu.parallel import MeshSpec as JMeshSpec
from skypilot_tpu.parallel import build_mesh as jbuild_mesh
from skypilot_tpu.parallel import sharding as jsharding
from skypilot_tpu.parallel.mesh import use_mesh as juse_mesh
from skypilot_tpu.train import checkpoints as jcheckpoints
from skypilot_tpu.train import train_lib as jtrain_lib
from skypilot_tpu_torch import config
from skypilot_tpu_torch.models import llama, module_for, weights
from skypilot_tpu_torch.parallel import mesh as mesh_lib
from skypilot_tpu_torch.parallel import sharding
from skypilot_tpu_torch.train import checkpoints, train_lib, trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, 'tests', 'torch_dist_worker.py')
TOL_UPDATE = 0.2
# The train steps: (model, world, mesh, config overrides).
TRAIN = {
    'llama-fsdp2': ('llama-debug', 2, dict(fsdp=2), {}),
    'llama-data2-fsdp2': ('llama-debug', 4, dict(data=2, fsdp=2), {}),
    'llama-fsdp2-seq2': ('llama-debug', 4, dict(fsdp=2, sequence=2),
                         dict(attention_impl='ring', ring_layout='zigzag')),
    'mla-fsdp2': ('mla-debug', 2, dict(fsdp=2), {}),
}
# The router aux across ranks: (model, mesh) on 2 ranks.
AUX = {f'{m}-{ax}': (m, {ax: 2}) for m in ('moe-debug', 'deepseek-moe-debug')
       for ax in ('data', 'fsdp')}
# The JAX step that a port gang and one port process restore.
JAX_CKPT_MESH = dict(data=2, fsdp=4)


def _jcfg(model, **overrides):
    return dataclasses.replace(jmodels.get_config(model), dtype=jnp.float32,
                               remat='none', **overrides)


def _jmesh(axes, n):
    return jbuild_mesh(JMeshSpec(**{'fsdp': 1, **axes}),
                       devices=jax.devices('cpu')[:n])


def _init_tree(jcfg):
    """JAX's init draw (the one ``init_train_state`` makes from
    PRNGKey(0)), on the host."""
    return jax.device_get(jmodels.module_for(jcfg).init_params(
        jax.random.PRNGKey(0), jcfg))


def _tokens(seed, steps=2, b=4, s=64):
    return np.random.default_rng(seed).integers(
        0, 256, (steps, b, s + 1)).astype(np.int32)


def _jobs(tmp):
    jobs = {}
    for name, (model, world, mesh, over) in TRAIN.items():
        jobs[name] = dict(kind='fsdp', world=world, model=model, mesh=mesh,
                          overrides=dict(remat='none', **over),
                          params=_init_tree(_jcfg(model, **over)),
                          tokens=_tokens(1))
    jobs['llama-fsdp2']['save'] = os.path.join(tmp, 'ck_fsdp2')
    jobs['llama-data2-fsdp2']['save'] = os.path.join(tmp, 'ck_data2_fsdp2')
    for name, (model, mesh) in AUX.items():
        jcfg, _, tree = tp.model(model)
        jobs[name] = dict(kind='fsdp', world=2, model=model, mesh=mesh,
                          overrides=dict(remat='none'), params=tree,
                          tokens=tp.batch(2)[None], grads=True)
    # Each gang restores the other's step, and the fsdp=2 gang JAX's.
    restores = {'restore-fsdp2-from-data2-fsdp2': (2, dict(fsdp=2),
                                                   'ck_data2_fsdp2', 2),
                'restore-data2-fsdp2-from-fsdp2': (4, dict(data=2, fsdp=2),
                                                   'ck_fsdp2', 2),
                'restore-fsdp2-from-jax': (2, dict(fsdp=2), 'ck_jax', 1)}
    for name, (world, mesh, d, step) in restores.items():
        jobs[name] = dict(kind='fsdp', world=world, model='llama-debug',
                          mesh=mesh, overrides=dict(remat='none'),
                          restore=(os.path.join(tmp, d), step))
    return jobs


def _spawn(jobs_path, world, tmp):
    out = os.path.join(tmp, f'w{world}')
    os.makedirs(out)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS='1')
    return [subprocess.Popen(
        [sys.executable, WORKER, jobs_path, str(r), str(world),
         os.path.join(out, 'init'), out],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]


# ---------------------------------------------------------------- JAX side

def _jax_train(name, tmp):
    """JAX make_train_step on the job's mesh: (losses, grad norms, the
    params after the steps, the manifest a save of them writes)."""
    model, world, axes, over = TRAIN[name]
    jcfg = _jcfg(model, **over)
    mesh = _jmesh(axes, world)
    tx = jtrain_lib.default_optimizer(warmup_steps=0)
    state = jtrain_lib.init_train_state(jax.random.PRNGKey(0), jcfg, mesh, tx)
    step = jtrain_lib.make_train_step(jcfg, mesh, tx)
    losses, gnorms = [], []
    for tokens in _tokens(1):
        state, metrics = step(state, {'tokens': jnp.asarray(tokens)})
        losses.append(float(metrics['loss']))
        gnorms.append(float(metrics['grad_norm']))
    out = {'losses': losses, 'gnorms': gnorms,
           'params': [np.asarray(p) for p in jax.tree_util.tree_leaves(
               jax.device_get(state.params))]}
    if name == 'llama-fsdp2':
        d = os.path.join(tmp, 'jax_fsdp2')
        with jcheckpoints.Checkpointer(d, async_save=False) as ck:
            ck.save(state, wait=True)
        with open(os.path.join(d, 'step_00000002', 'MANIFEST.json')) as f:
            out['manifest'] = json.load(f)
    return out


def _jax_aux(name):
    """(CE, aux, grads of CE + aux) by jax.value_and_grad on the job's
    mesh, the params placed by their specs."""
    model, axes = AUX[name]
    jcfg, _, tree = tp.model(model)
    mesh = _jmesh(axes, 2)
    rules = jsharding.Rules()
    mod = jmodels.module_for(jcfg)
    params = jax.device_put(tp.jax_params(tree), jsharding.tree_shardings(
        mesh, mod.param_specs(jcfg, rules)))
    tokens = jnp.asarray(tp.batch(2))

    def loss_fn(p):
        logits, aux = mod.forward(p, tokens[:, :-1], jcfg, rules,
                                  return_aux=True)
        loss, _ = jtrain_lib.cross_entropy_loss(logits, tokens[:, 1:])
        return loss + aux, (loss, aux)

    with juse_mesh(mesh):
        (_, (loss, aux)), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(params)
    return float(loss), float(aux), jax.device_get(grads)


def _jax_ckpt(tmp):
    """A JAX llama-debug step (one update) saved from MeshSpec(data=2,
    fsdp=4) on the 8 devices: its manifest and its arrays by path."""
    jcfg = _jcfg('llama-debug')
    mesh = _jmesh(JAX_CKPT_MESH, 8)
    tx = jtrain_lib.default_optimizer(warmup_steps=0)
    state = jtrain_lib.init_train_state(jax.random.PRNGKey(3), jcfg, mesh, tx)
    state, _ = jtrain_lib.make_train_step(jcfg, mesh, tx)(
        state, {'tokens': jnp.asarray(_tokens(4, 1, 8, 16)[0])})
    d = os.path.join(tmp, 'ck_jax')
    with jcheckpoints.Checkpointer(d, async_save=False) as ck:
        ck.save(state, wait=True)
    flat = jax.tree_util.tree_flatten_with_path(jax.device_get(state))[0]
    return {jax.tree_util.keystr(kp): np.asarray(a) for kp, a in flat}


def _compute(tmp):
    jobs = _jobs(tmp)
    jobs_path = os.path.join(tmp, 'jobs.pkl')
    with open(jobs_path, 'wb') as f:
        pickle.dump(jobs, f)
    procs = _spawn(jobs_path, 2, tmp) + _spawn(jobs_path, 4, tmp)
    try:
        # The JAX side compiles in threads (XLA compiles outside the
        # GIL) while the ranks run; the rank restoring JAX's step waits
        # for its manifest.
        with concurrent.futures.ThreadPoolExecutor(4) as pool:
            futs = {'jax_ckpt': pool.submit(_jax_ckpt, tmp)}
            futs.update({name: pool.submit(_jax_train, name, tmp)
                         for name in TRAIN})
            futs.update({name: pool.submit(_jax_aux, name) for name in AUX})
            ref = {name: f.result() for name, f in futs.items()}
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    port = {}
    for world in (2, 4):
        for r in range(world):
            with open(os.path.join(tmp, f'w{world}', f'rank{r}.pkl'),
                      'rb') as f:
                for name, res in pickle.load(f).items():
                    port.setdefault(name, {})[r] = res
    manifests = {}
    for d in ('ck_fsdp2', 'ck_data2_fsdp2'):
        with open(os.path.join(tmp, d, 'step_00000002',
                               'MANIFEST.json')) as f:
            manifests[d] = json.load(f)
        manifests[d + '_files'] = sorted(os.listdir(os.path.join(
            tmp, d, 'step_00000002')))
    return {'jobs': jobs, 'ref': ref, 'port': port, 'tmp': tmp,
            'manifests': manifests}


@pytest.fixture(scope='module')
def results(tmp_path_factory):
    root = tmp_path_factory.getbasetemp()
    if os.environ.get('PYTEST_XDIST_WORKER'):
        root = root.parent
    cache = root / 'torch_fsdp_results.pkl'
    with open(str(cache) + '.lock', 'w') as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not cache.exists():
            data = _compute(str(tmp_path_factory.mktemp('fsdp_ranks')))
            with open(str(cache) + '.tmp', 'wb') as f:
                pickle.dump(data, f)
            os.replace(str(cache) + '.tmp', cache)
    with open(cache, 'rb') as f:
        return pickle.load(f)


def _update_err(params, init, params_ref):
    """||Δport - Δjax|| / ||Δjax|| over all leaves, Δ = new - init."""
    num = den = 0.0
    for p, p0, r in zip(params, init, params_ref):
        d_ref = r.astype(np.float64) - p0
        num += float(((p.astype(np.float64) - p0 - d_ref) ** 2).sum())
        den += float((d_ref ** 2).sum())
    return (num / den) ** 0.5, den ** 0.5


# --------------------------------------------------------------- training

@pytest.mark.parametrize('name', list(TRAIN))
def test_train_steps_match_jax_on_the_same_mesh(results, name):
    """Two steps at the peak learning rate on every rank: the loss, the
    global grad norm (every shard counted once) and the gathered params
    against JAX's make_train_step on the same MeshSpec; the ranks that
    hold one shard agree bit for bit."""
    ref = results['ref'][name]
    port = results['port'][name]
    world = TRAIN[name][1]
    assert sorted(port) == list(range(world))
    init = [np.asarray(p, np.float64) for p in jax.tree_util.tree_leaves(
        results['jobs'][name]['params'])]
    for r in range(world):
        got = port[r]
        assert len(got['losses']) == len(ref['losses']) == 2
        for a, b in zip(got['losses'], ref['losses']):
            assert abs(a - b) < 2e-3, (r, got['losses'], ref['losses'])
        for a, b in zip(got['gnorms'], ref['gnorms']):
            assert abs(a - b) <= 1e-2 * b, (r, got['gnorms'], ref['gnorms'])
        err = max(float(np.abs(a - b).max())
                  for a, b in zip(got['params'], ref['params']))
        assert err < 1e-2, (r, err)
        upd, size = _update_err(got['params'], init, ref['params'])
        assert size > 0 and upd <= TOL_UPDATE, (r, upd)
        for a, b in zip(got['params'], port[0]['params']):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('name', list(TRAIN))
def test_each_rank_holds_its_shards_and_moments(results, name):
    """Every leaf the rules cut over 'fsdp' ('embed' in its axes) is
    1/fsdp of its size on each rank, its moments too; the rest whole."""
    model, world, mesh, _ = TRAIN[name]
    cfg = config.get_config(model)
    axes = train_lib.leaves(module_for(cfg).param_axes(cfg))
    whole = [p.shape for p in results['ref'][name]['params']]
    n = mesh.get('fsdp', 1)
    for r in range(world):
        got = results['port'][name][r]
        for ax, full, shard, mom in zip(axes, whole, got['shard_shapes'],
                                        got['moment_shapes']):
            dim = sharding.fsdp_dim(ax)
            want = list(full)
            if dim is not None:
                want[dim] //= n
            assert list(shard) == want == list(mom), (ax, full, shard)
    assert any(sharding.fsdp_dim(ax) is not None for ax in axes)


@pytest.mark.parametrize('name', list(AUX))
def test_router_aux_and_grads_across_ranks_match_jax(results, name):
    """The MoE and MLA-MoE CE, the aux (its means over the whole batch)
    and the grads of CE + aux on 2 ranks, against JAX's value_and_grad
    on the same mesh: the aux enters the summed grads once."""
    jl, ja, jg = results['ref'][name]
    for r in range(2):
        got = results['port'][name][r]
        np.testing.assert_allclose([got['loss'], got['aux'],
                                    got['auxes'][0]], [jl, ja, ja],
                                   rtol=tp.TOL)
        tp.assert_grads_match([torch.from_numpy(g) for g in got['grads']],
                              jg)


def test_routing_is_within_row_groups():
    """Dispatch and capacity depend on each row's tokens alone: routing
    the rows of a batch in two halves gives the whole batch's slots."""
    from skypilot_tpu_torch.models import moe
    cfg = dataclasses.replace(config.get_config('moe-debug'),
                              dtype=torch.float32)
    rng = np.random.default_rng(7)
    xg = torch.from_numpy(rng.standard_normal((4, 2, 8, cfg.dim)).astype(
        np.float32))
    router = torch.from_numpy(rng.standard_normal(
        (cfg.dim, cfg.n_experts)).astype(np.float32))
    c = moe.capacity(cfg, 8)
    whole = moe.route(xg, router, cfg, c)
    halves = [moe.route(x, router, cfg, c) for x in xg.chunk(2)]
    for i, w in enumerate(whole):
        torch.testing.assert_close(torch.cat([h[i] for h in halves]), w,
                                   rtol=0, atol=0)


# ------------------------------------------------------------ the draw

@pytest.mark.parametrize('model', ['llama-debug', 'moe-debug',
                                   'deepseek-moe-debug'])
@pytest.mark.parametrize('sizes', [dict(fsdp=2), dict(data=2, fsdp=2)])
def test_sharded_draw_is_the_one_process_draw(model, sizes, monkeypatch):
    """Every rank's draw from the same seed, put together, is bit-equal
    to the one-process draw; while drawing, no rank holds more than its
    shards and one whole layer slice (or unstacked leaf) in fp32."""
    cfg = config.get_config(model)
    one = module_for(cfg).init_params(
        cfg, torch.Generator().manual_seed(5), 'cpu')
    spec = mesh_lib.MeshSpec(**sizes)
    world = spec.sizes(4 if 'data' in sizes else 2)
    n = int(np.prod(world))
    axes = train_lib.leaves(module_for(cfg).param_axes(cfg))
    # One layer slice of a stacked leaf, or an unstacked leaf whole.
    biggest = max((leaf[0] if path.startswith("['layers']") else leaf
                   ).numel() * 4 for path, leaf in
                  weights.tree_paths(one))
    real_empty = torch.empty
    for r in range(n):
        mesh = mesh_lib.Mesh(world, r)
        live = {'now': 0, 'peak': 0}

        def spy(*shape, **kw):
            t = real_empty(*shape, **kw)
            nbytes = t.numel() * t.element_size()
            live['now'] += nbytes
            live['peak'] = max(live['peak'], live['now'])
            import weakref
            weakref.finalize(t, lambda b=nbytes: live.__setitem__(
                'now', live['now'] - b))
            return t
        monkeypatch.setattr(torch, 'empty', spy)
        shards = module_for(cfg).init_params(
            cfg, torch.Generator().manual_seed(5), 'cpu', mesh=mesh)
        monkeypatch.setattr(torch, 'empty', real_empty)
        held = sum(t.numel() * t.element_size()
                   for t in train_lib.leaves(shards))
        assert live['peak'] <= held + biggest, (r, live, held, biggest)
        for got, want, ax in zip(train_lib.leaves(shards),
                                 train_lib.leaves(one), axes):
            start, size = sharding.leaf_box(want.shape, ax, mesh)
            cut = want[tuple(slice(a, a + s) for a, s in zip(start, size))]
            torch.testing.assert_close(got, cut, rtol=0, atol=0)
            if sharding.fsdp_dim(ax) is not None:
                assert got.numel() * 2 == want.numel()


# ------------------------------------------------------------ checkpoints

def _chunk_set(rec):
    return sorted((tuple(c['start']), tuple(c['shape'])) for c in rec['chunks'])


def test_fsdp_manifest_is_the_one_jax_writes(results):
    """The fsdp=2 gang's step: every array's path, shape, dtype, spec
    and chunk starts as JAX's Checkpointer writes them for
    MeshSpec(fsdp=2) (a moment recorded in the spec of the first param
    leaf of its shape); the ranks' indexes merged and removed; each
    rank's chunk files named by its rank."""
    got = results['manifests']['ck_fsdp2']
    want = results['ref']['llama-fsdp2']['manifest']
    assert got['mesh_axes'] == want['mesh_axes']
    assert got['process_count'] == 2 and got['format'] == want['format']
    assert [a['path'] for a in got['arrays']] == [
        a['path'] for a in want['arrays']]
    for a, b in zip(got['arrays'], want['arrays']):
        assert (a['shape'], a['dtype'], a['spec']) == (
            b['shape'], b['dtype'], b['spec']), a['path']
        assert _chunk_set(a) == _chunk_set(b), a['path']
        for c in a['chunks']:
            r = 0 if not c['start'] or max(c['start']) == 0 else 1
            assert c['file'].endswith(f'.p{r:04d}.c00.npy'), (a['path'], c)
    assert results['manifests']['ck_fsdp2_files'] == ['MANIFEST.json',
                                                      'arrays']
    wq = {a['path']: a['spec'] for a in got['arrays']}
    assert wq[".params['layers']['wq']"] == [None, 'fsdp', 'tensor']
    assert wq[".opt_state[1][0].mu['layers']['wq']"] == [None, 'tensor',
                                                         'fsdp']


def test_jax_restores_the_gang_step_bit_identical(results):
    """JAX's Checkpointer restores the fsdp=2 gang's step onto
    MeshSpec(fsdp=2), every array equal to the gang's state."""
    d = os.path.join(results['tmp'], 'ck_fsdp2')
    jcfg = _jcfg('llama-debug')
    mesh = _jmesh(dict(fsdp=2), 2)
    tx = jtrain_lib.default_optimizer(warmup_steps=0)
    state, step = jcheckpoints.Checkpointer(d).restore(jcfg, mesh, tx)
    assert step == 2
    flat = jax.tree_util.tree_flatten_with_path(jax.device_get(state))[0]
    want = results['port']['llama-fsdp2'][0]['state']
    assert len(flat) == len(want)
    for kp, a in flat:
        np.testing.assert_array_equal(np.asarray(a),
                                      want[jax.tree_util.keystr(kp)])


def _port_restore(d, step):
    cfg = dataclasses.replace(config.get_config('llama-debug'),
                              dtype=torch.float32, remat='none')
    tx = train_lib.default_optimizer(warmup_steps=0)
    ck = checkpoints.Checkpointer(d, cfg=cfg)
    state = ck.restore_tree(checkpoints.abstract_train_state(cfg, tx), step,
                            'cpu')
    out = {'.step': state.step}
    for path, leaf in checkpoints._leaves(state):
        out[path] = (leaf.detach().numpy() if torch.is_tensor(leaf)
                     else leaf)
    return out


@pytest.mark.parametrize('case', ['gang', 'one-process'])
def test_jax_data2_fsdp4_step_restores_on_the_port(results, case):
    """A JAX step saved from MeshSpec(data=2, fsdp=4) on 8 devices
    restores bit for bit on a port fsdp=2 gang and on one process."""
    want = results['ref']['jax_ckpt']
    if case == 'gang':
        got = [results['port']['restore-fsdp2-from-jax'][r]['restored']
               for r in range(2)]
    else:
        got = [_port_restore(os.path.join(results['tmp'], 'ck_jax'), 1)]
    for g in got:
        assert set(g) == set(want)
        for path, a in want.items():
            np.testing.assert_array_equal(np.asarray(g[path]), a,
                                          err_msg=path)


@pytest.mark.parametrize('saved,restored', [
    ('ck_data2_fsdp2', 'restore-fsdp2-from-data2-fsdp2'),
    ('ck_fsdp2', 'restore-data2-fsdp2-from-fsdp2')])
def test_gang_steps_restore_across_topologies(results, saved, restored):
    """A step saved at data=2,fsdp=2 restores at fsdp=2 and on one
    process, and the reverse, bit for bit."""
    source = {'ck_fsdp2': 'llama-fsdp2',
              'ck_data2_fsdp2': 'llama-data2-fsdp2'}[saved]
    want = results['port'][source][0]['state']
    one = _port_restore(os.path.join(results['tmp'], saved), 2)
    ranks = results['port'][restored]
    for got in [one] + [ranks[r]['restored'] for r in sorted(ranks)]:
        assert set(got) == set(want)
        for path, a in want.items():
            np.testing.assert_array_equal(np.asarray(got[path]), a,
                                          err_msg=path)


def test_a_rank_reads_only_the_chunks_of_its_slice(results):
    """Restoring the fsdp=2 step at data=2,fsdp=2, each rank opens
    exactly the chunk files that intersect its own slice of each array:
    for a param one file, its own fsdp index's; the replicated arrays
    and the scalars rank 0's."""
    manifest = results['manifests']['ck_fsdp2']
    cfg = config.get_config('llama-debug')
    lay = checkpoints.layouts(cfg)
    ranks = results['port']['restore-data2-fsdp2-from-fsdp2']
    for r in range(4):
        mesh = mesh_lib.Mesh(mesh_lib.MeshSpec(data=2, fsdp=2).sizes(4), r)
        want = []
        for rec in manifest['arrays']:
            held = lay.get(rec['path'], ((), ()))[0]
            lo, size = sharding.leaf_box(rec['shape'], held, mesh)
            for c in rec['chunks']:
                if all(a < x + n and x < a + s for a, s, x, n in
                       zip(c['start'], c['shape'], lo, size)):
                    want.append(c['file'])
            if rec['path'].startswith('.params') and 'fsdp' in str(
                    rec['spec']):
                mine = [c['file'] for c in rec['chunks']
                        if c['file'] in ranks[r]['read']]
                stem = rec['chunks'][0]['file'].rsplit('.p', 1)[0]
                assert mine == [f"{stem}.p{mesh.coords['fsdp']:04d}.c00.npy"]
        assert ranks[r]['read'] == sorted(want), r


# --------------------------------------------------- the refusals, in brief

def test_unported_training_axes_stay_refused():
    cfg = config.get_config('llama-debug')
    for axes in (dict(tensor=2), dict(expert=2), dict(stage=2)):
        mesh = mesh_lib.Mesh(mesh_lib.MeshSpec(**axes).sizes(2), 0)
        with pytest.raises(NotImplementedError,
                           match=f"{list(axes)[0]}=2.*Queue 1 item 8"):
            train_lib.check_mesh(cfg, mesh)
    with pytest.raises(ValueError, match='not divisible by mesh axis fsdp'):
        train_lib.check_mesh(dataclasses.replace(cfg, dim=66),
                             mesh_lib.Mesh(mesh_lib.MeshSpec().sizes(4), 0))


def test_whole_params_on_an_fsdp_mesh_are_refused():
    """The forward on an fsdp mesh runs on shards; whole params there
    are named, not silently misread."""
    cfg = config.get_config('llama-debug')
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), 'cpu')
    mesh = mesh_lib.Mesh(mesh_lib.MeshSpec().sizes(2), 0)
    with mesh_lib.use_mesh(mesh), pytest.raises(ValueError,
                                                match='not a shard'):
        llama.forward(params, torch.zeros((1, 4), dtype=torch.long), cfg)


# ------------------------------------------------- the trainer as a gang

FLAGS = ['--model', 'llama-debug', '--device', 'cpu', '--batch-size', '4',
         '--seq-len', '32', '--log-every', '1', '--steps', '6',
         '--ckpt-every', '2']


def _gang(tmp, tag, port, kill_after=None):
    """Two trainer processes with the gang env and no --mesh, rank 0
    listening on ``port``; with
    ``kill_after`` both are SIGKILLed once that step's checkpoint is
    complete (each step slowed by a delay failpoint so the run is still
    going). (rank 0's step records, each rank's log)."""
    procs, paths = [], []
    for r in range(2):
        env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS='1',
                   SKYTPU_COORDINATOR_ADDRESS=f'127.0.0.1:{port}',
                   SKYTPU_NUM_PROCESSES='2', SKYTPU_NODE_RANK=str(r))
        if kill_after:
            env['SKYTPU_FAILPOINTS'] = 'trainer.preempt=delay:0.5'
        paths.append(tmp / f'{tag}{r}.log')
        procs.append(subprocess.Popen(
            [sys.executable, '-m', 'skypilot_tpu_torch.train.trainer',
             *FLAGS, '--ckpt-dir', str(tmp / 'ck')], cwd=ROOT, env=env,
            stdout=open(paths[-1], 'w'), stderr=subprocess.STDOUT))
    try:
        if kill_after:
            done = tmp / 'ck' / f'step_{kill_after:08d}' / 'MANIFEST.json'
            deadline = time.monotonic() + 300
            while not done.exists():
                assert time.monotonic() < deadline
                assert all(p.poll() is None for p in procs), [
                    p.read_text() for p in paths]
                time.sleep(0.05)
            for p in procs:
                p.send_signal(signal.SIGKILL)
        for p in procs:
            p.wait(timeout=300)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    logs = [p.read_text() for p in paths]
    if not kill_after:
        for p, log in zip(procs, logs):
            assert p.returncode == 0, log
    recs = [json.loads(line) for line in logs[0].splitlines()
            if line.startswith('{"step"')]
    return recs, logs


def test_trainer_gang_default_mesh_matches_one_process_and_resumes(tmp_path):
    """The trainer CLI as two gang processes with no --mesh trains at
    fsdp=2 (JAX's MeshSpec()): its losses equal the one-process
    trainer's within 2e-3; SIGKILLed after its step-2 checkpoint, a
    second launch resumes every rank from the newest complete step and
    continues the one-process curve; the ranks report different shards
    (fsdp index 0 and 1)."""
    one = trainer.train(trainer.TrainerConfig(
        model='llama-debug', batch_size=4, seq_len=32, total_steps=6,
        log_every=1, device='cpu'))
    recs, _ = _gang(tmp_path, 'a', torch_ports.coord_port(50), kill_after=2)
    for a in recs:
        assert abs(a['loss'] - one[a['step'] - 1]['loss']) < 2e-3, (recs,
                                                                     one)
    recs, logs = _gang(tmp_path, 'b', torch_ports.coord_port(51))
    resumed = [int(line.split('step ')[1].split(' ')[0]) for line in
               logs[0].splitlines() if 'Resumed from checkpoint step' in line]
    assert len(resumed) == 1 and 2 <= resumed[0] < 6, logs[0]
    assert f'Resumed from checkpoint step {resumed[0]}' in logs[1]
    assert [r['step'] for r in recs] == list(range(resumed[0] + 1, 7))
    for a in recs:
        assert abs(a['loss'] - one[a['step'] - 1]['loss']) < 2e-3, (recs,
                                                                     one)
    reps = [json.loads(line) for log in logs for line in log.splitlines()
            if line.startswith('{"replica"')]
    assert sorted((r['replica'], r['fsdp_index']) for r in reps) == [
        (0, 0), (1, 1)]
    assert reps[0]['params_sha256'] != reps[1]['params_sha256']
