"""The port's context parallelism against the JAX package's, on the CPU.

Ranks are real gloo process groups: tests/torch_dist_worker.py, one
process a rank (torch and the port only), spawned once for the module
with a ``file://`` rendezvous in a temp dir, so xdist workers never
collide. One group of 2 ranks and one of 4 run every case at once; their
results, and the JAX references computed beside them, are cached under
a file lock in pytest's shared temp root, so whichever xdist worker
comes first computes them and the others read them.

The JAX reference runs as its own tests run it: ``ring_attention_sharded``
under a shard_map on the conftest's virtual CPU devices, interpret mode
(tests/unit_tests/test_ring_attention.py), ``_BWD_FLASH = '1'`` where
its Pallas backward is wanted. Inputs are seeded numpy arrays.

Tolerances: the port's plain backward of C and D (``grad_dtype`` fp32)
against the JAX ``_bwd`` within 1e-5 of the largest grad on fp32 inputs
and 1.5e-2 on bf16 (p and ds round to bf16 before their products, in a
different summation order); the ring within 1e-5 relative in fp32 (the
same arithmetic in another order) and at the JAX ring test's bounds in
bf16 (|out| error < 3e-2; each grad's max|err| / max|ref| < 2e-2); the
llama-debug train steps with a (data=2, sequence=2) mesh and the zigzag
ring at the JAX zigzag test's bounds (loss within 2e-3, params within
1e-2), and the update they make within TOL_UPDATE of JAX's.
"""
import dataclasses
import fcntl
import functools
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import llama as jllama
from skypilot_tpu.ops import ring_attention as jring
from skypilot_tpu.ops.pallas import flash_attention as jfa
from skypilot_tpu.parallel import MeshSpec as JMeshSpec
from skypilot_tpu.parallel import build_mesh as jbuild_mesh
from skypilot_tpu.parallel.mesh import use_mesh as juse_mesh
from skypilot_tpu.train import train_lib as jtrain_lib
from skypilot_tpu_torch import config
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.ops import attention
from skypilot_tpu_torch.ops import flash_attention as fa
from skypilot_tpu_torch.ops import ring_attention as ring

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, 'tests', 'torch_dist_worker.py')
B, S, H, KH, D = 1, 64, 4, 2, 32         # the JAX ring test's shapes
RTOL32 = 1e-5
TOL_OUT16, TOL_GRAD16 = 3e-2, 2e-2

# (name, world, layout, causal, dtype, extra job keys)
RING_CASES = [
    ('n2-seq-causal-f32', 2, 'seq', True, 'float32', {}),
    ('n2-zigzag-causal-f32', 2, 'zigzag', True, 'float32', {}),
    ('n2-seq-full-f32', 2, 'seq', False, 'float32', {}),
    ('n2-zigzag-full-f32', 2, 'zigzag', False, 'float32', {}),
    ('n2-seq-causal-bf16', 2, 'seq', True, 'bfloat16', {}),
    ('n2-zigzag-causal-bf16', 2, 'zigzag', True, 'bfloat16', {}),
    ('n4-seq-causal-f32', 4, 'seq', True, 'float32', {}),
    ('n4-zigzag-causal-f32', 4, 'zigzag', True, 'float32', {}),
    ('n4-zigzag-full-f32', 4, 'zigzag', False, 'float32', {}),
]
# The chunked einsum backward (SKYTPU_RING_BWD_CHUNK) against the same
# ring unchunked, port only.
CHUNK_CASES = [('n2-seq-causal-f32', 'seq'),
               ('n2-zigzag-causal-f32', 'zigzag')]
# The flash-kernel backward route, forced on both sides (the port's
# plain C and D in fp32 mode; JAX's Pallas kernels in interpret mode) at
# kernel-aligned shapes: B=1, S=512, 2/1 heads, D=128, 2 ranks.
FLASH_SHAPE = (1, 512, 2, 1, 128)
# The train steps: llama-debug, remat 'none', zigzag ring, two batches
# of 2 x 64, no warmup.
TRAIN_MESH = dict(data=2, sequence=2)
# The update (params after the steps - init) against JAX's, relative in
# norm: ~0.08 here (the sign of AdamW's first steps, g / |g|, flips
# where a grad is within bf16 noise of 0); ~1.15 with the grads left
# unsummed over the ranks.
TOL_UPDATE = 0.2


def _qkv(seed, b, s, h, kh, d):
    rng = np.random.default_rng(seed)
    return {'q': rng.standard_normal((b, s, h, d)).astype(np.float32),
            'k': rng.standard_normal((b, s, kh, d)).astype(np.float32),
            'v': rng.standard_normal((b, s, kh, d)).astype(np.float32),
            'do': rng.standard_normal((b, s, h, d)).astype(np.float32)}


def _jobs():
    jobs = {}
    base = _qkv(0, B, S, H, KH, D)
    for name, world, layout, causal, dtype, extra in RING_CASES:
        jobs[name] = dict(kind='ring', world=world, layout=layout,
                          causal=causal, dtype=dtype, **base, **extra)
    for name, layout in CHUNK_CASES:
        jobs[f'{name}-chunk4'] = dict(jobs[name], chunk=4)
    flash = _qkv(1, *FLASH_SHAPE)
    for mode in ('1', '0'):
        jobs[f'flash-{mode}'] = dict(kind='ring', world=2, layout='seq',
                                     causal=True, dtype='float32',
                                     flash=mode, **flash)
    tcfg = _train_cfgs()[0]
    jobs['train'] = dict(kind='train', world=4, model='llama-debug',
                         overrides=dict(remat='none', attention_impl='ring',
                                        ring_layout='zigzag'),
                         mesh=TRAIN_MESH, params=_train_params(tcfg),
                         tokens=_train_tokens(tcfg))
    return jobs


def _train_cfgs():
    jcfg = dataclasses.replace(jllama.PRESETS['llama-debug'], remat='none',
                               attention_impl='ring', ring_layout='zigzag')
    return jcfg, dataclasses.replace(config.PRESETS['llama-debug'],
                                     remat='none', attention_impl='ring',
                                     ring_layout='zigzag')


def _train_params(jcfg):
    return jax.device_get(jllama.init_params(jax.random.PRNGKey(0), jcfg))


def _train_tokens(jcfg):
    rng = np.random.default_rng(5)
    return rng.integers(0, jcfg.vocab_size, (2, 2, 65)).astype(np.int32)


def _spawn(jobs_path, world, tmp):
    """``world`` worker processes; their results land in tmp/w<world>."""
    out = os.path.join(tmp, f'w{world}')
    os.makedirs(out)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS='1')
    return [subprocess.Popen(
        [sys.executable, WORKER, jobs_path, str(r), str(world),
         os.path.join(out, 'init'), out],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]


# ---------------------------------------------------------------- JAX side

def _jax_ring(job, n):
    """JAX's ring_attention_sharded over n CPU devices: (out in the
    layout's order, grads in the layout's order), numpy fp32."""
    dt = jnp.bfloat16 if job['dtype'] == 'bfloat16' else jnp.float32
    layout = job['layout']
    mesh = jbuild_mesh(JMeshSpec(fsdp=1, sequence=n),
                       devices=jax.devices('cpu')[:n])

    def permute(x):
        return jring.zigzag_permute(x, n) if layout == 'zigzag' else x

    def run(q, k, v, do):
        def f(q, k, v):
            return jring.ring_attention_sharded(
                permute(q), permute(k), permute(v), causal=job['causal'],
                layout=layout, interpret=True)
        out, vjp = jax.vjp(f, q, k, v)
        return out, tuple(permute(g) for g in vjp(permute(do)))

    args = [jnp.asarray(job[x], dt) for x in ('q', 'k', 'v', 'do')]
    with juse_mesh(mesh):
        out, grads = jax.jit(run)(*args)
    return [np.asarray(t, np.float32) for t in (out,) + grads]


def _jax_train(job):
    jcfg, _ = _train_cfgs()
    mesh = jbuild_mesh(JMeshSpec(fsdp=1, **TRAIN_MESH),
                       devices=jax.devices('cpu')[:4])
    tx = jtrain_lib.default_optimizer(warmup_steps=0)
    state = jtrain_lib.init_train_state(jax.random.PRNGKey(0), jcfg, mesh, tx)
    step = jtrain_lib.make_train_step(jcfg, mesh, tx)
    losses, gnorms = [], []
    for tokens in job['tokens']:
        state, metrics = step(state, {'tokens': jnp.asarray(tokens)})
        losses.append(float(metrics['loss']))
        gnorms.append(float(metrics['grad_norm']))
    params = jax.tree_util.tree_leaves(jax.device_get(state.params))
    return losses, gnorms, [np.asarray(p) for p in params]


def _compute(tmp):
    jobs = _jobs()
    jobs_path = os.path.join(tmp, 'jobs.pkl')
    with open(jobs_path, 'wb') as f:
        pickle.dump(jobs, f)
    procs = _spawn(jobs_path, 2, tmp) + _spawn(jobs_path, 4, tmp)
    try:
        ref = {}
        for name, world, *_ in RING_CASES:
            ref[name] = _jax_ring(jobs[name], world)
        saved = jring._BWD_FLASH
        try:
            for mode in ('1', '0'):
                jring._BWD_FLASH = mode
                ref[f'flash-{mode}'] = _jax_ring(jobs[f'flash-{mode}'], 2)
        finally:
            jring._BWD_FLASH = saved
        ref['train'] = _jax_train(jobs['train'])
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
                    if isinstance(res, dict):        # a ring job's
                        res = res['arrays']
                    port.setdefault(name, {})[r] = res
    return {'jobs': jobs, 'ref': ref, 'port': port}


@pytest.fixture(scope='module')
def results(tmp_path_factory):
    """Every case's port results by rank and its JAX reference, computed
    once across xdist workers (a lock file in the shared temp root)."""
    # The run's root: shared by the xdist workers, fresh for each run.
    root = tmp_path_factory.getbasetemp()
    if os.environ.get('PYTEST_XDIST_WORKER'):
        root = root.parent
    cache = root / 'torch_ring_results.pkl'
    with open(str(cache) + '.lock', 'w') as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not cache.exists():
            tmp = tmp_path_factory.mktemp('ring_ranks')
            data = _compute(str(tmp))
            with open(str(cache) + '.tmp', 'wb') as f:
                pickle.dump(data, f)
            os.replace(str(cache) + '.tmp', cache)
    with open(cache, 'rb') as f:
        return pickle.load(f)


def _slot(x, world, rank):
    sl = x.shape[1] // world
    return x[:, rank * sl:(rank + 1) * sl]


def _rel(got, want):
    return float(np.abs(got - want).max()) / (float(np.abs(want).max())
                                              + 1e-12)


# ---------------------------------------------------------------- cases

@pytest.mark.parametrize('name,world,layout,causal,dtype,extra', RING_CASES,
                         ids=[c[0] for c in RING_CASES])
def test_ring_matches_jax(results, name, world, layout, causal, dtype,
                          extra):
    """Each rank's output shard and its q, k, v grads against the same
    slots of JAX's ring over the whole sequence."""
    ref = results['ref'][name]
    port = results['port'][name]
    assert sorted(port) == list(range(world))
    for r in range(world):
        for i, (got, want) in enumerate(zip(port[r], ref)):
            want = _slot(want, world, r)
            assert got.shape == want.shape
            if dtype == 'float32':
                assert _rel(got, want) <= RTOL32, (r, i)
            elif i == 0:
                assert float(np.abs(got - want).max()) < TOL_OUT16, r
            else:
                assert _rel(got, want) < TOL_GRAD16, (r, i)


@pytest.mark.parametrize('name,layout', CHUNK_CASES,
                         ids=[c[0] for c in CHUNK_CASES])
def test_chunked_backward_matches_unchunked(results, name, layout):
    """KV chunks of 4 in the einsum backward give the unchunked grads."""
    whole, chunked = results['port'][name], results['port'][f'{name}-chunk4']
    for r in whole:
        np.testing.assert_array_equal(whole[r][0], chunked[r][0])
        for got, want in zip(chunked[r][1:], whole[r][1:]):
            assert _rel(got, want) <= RTOL32


@pytest.mark.parametrize('mode', ['1', '0'])
def test_flash_backward_dispatch_matches_jax(results, mode):
    """The ring's backward with the flash route forced ('1': the port's
    plain C and D in their fp32 mode; JAX's Pallas kernels) and with the
    einsum route ('0'), each against JAX's own, at aligned shapes."""
    assert ring._flash_bwd_ok(256, 256, 128, on_card=False) is False
    ref, port = results['ref'][f'flash-{mode}'], results['port'][f'flash-{mode}']
    for r in range(2):
        for got, want in zip(port[r], ref):
            assert _rel(got, _slot(want, 2, r)) <= RTOL32


@pytest.mark.parametrize('mode,sq,tk,d,on_card,dtype,want', [
    ('', 256, 256, 128, True, torch.bfloat16, True),
    ('', 256, 256, 64, True, torch.bfloat16, True),    # C/D take hd 64
    ('', 256, 256, 256, True, torch.bfloat16, True),
    ('', 256, 256, 96, True, torch.bfloat16, False),   # not a C/D dim
    ('', 256, 256, 384, True, torch.bfloat16, False),
    ('', 256, 256, 128, True, torch.float32, False),   # C/D take bf16
    ('', 200, 256, 128, True, torch.bfloat16, False),  # JAX's sq % 128
    ('', 256, 256, 128, False, torch.float32, False),  # auto: the card
    ('1', 256, 256, 128, False, torch.float32, True),
    ('1', 256, 256, 64, False, torch.float32, False),  # JAX's d % 128
    ('0', 256, 256, 128, True, torch.bfloat16, False),
])
def test_flash_bwd_gate(monkeypatch, mode, sq, tk, d, on_card, dtype,
                        want):
    """The ring backward's route: JAX's gate off the card; on the card
    the head dims and dtype kernels C and D take, and JAX's sequence
    alignment."""
    monkeypatch.setattr(ring, '_BWD_FLASH', mode)
    assert ring._flash_bwd_ok(sq, tk, d, on_card, dtype) is want


def test_flash_route_equals_einsum_route(results):
    """The two backward routes of the port agree (the JAX dispatch
    test's claim, in fp32)."""
    a, b = results['port']['flash-1'], results['port']['flash-0']
    for r in range(2):
        for got, want in zip(a[r][1:], b[r][1:]):
            assert _rel(got, want) <= RTOL32


def _update_err(params, init, params_ref):
    """||Δport - Δjax|| / ||Δjax|| over all leaves, Δ = new - init."""
    num = den = 0.0
    for p, p0, r in zip(params, init, params_ref):
        d_ref = r.astype(np.float64) - p0
        num += float(((p.astype(np.float64) - p0 - d_ref) ** 2).sum())
        den += float((d_ref ** 2).sum())
    return (num / den) ** 0.5, den ** 0.5


def test_train_step_matches_jax(results):
    """llama-debug, zigzag ring, mesh (data=2, sequence=2) on 4 ranks, two
    steps at the peak learning rate: each step's loss and grad norm, and
    the params after them, against JAX's make_train_step on
    MeshSpec(fsdp=1, data=2, sequence=2) from the same params; every
    rank's params equal (the replicas stay in step). The grad norm is
    the global one (the grads summed over the ranks), within 1e-2: bf16
    compute summed in other orders. The update within TOL_UPDATE of
    JAX's. AdamW's first steps are nearly blind to the grads' scale, so
    the clip is held by the grad norm and the second loss only."""
    loss_ref, gnorm_ref, params_ref = results['ref']['train']
    init = [np.asarray(p, np.float64) for p in jax.tree_util.tree_leaves(
        results['jobs']['train']['params'])]
    port = results['port']['train']
    assert sorted(port) == [0, 1, 2, 3]
    for r in range(4):
        loss, gnorm, params = port[r]
        upd, size = _update_err(params, init, params_ref)
        assert len(loss) == len(loss_ref) == 2
        for a, b in zip(loss, loss_ref):
            assert abs(a - b) < 2e-3, (r, loss, loss_ref)
        for a, b in zip(gnorm, gnorm_ref):
            assert abs(a - b) <= 1e-2 * b, (r, gnorm, gnorm_ref)
        assert len(params) == len(params_ref) == len(init)
        err = max(float(np.abs(a - b).max())
                  for a, b in zip(params, params_ref))
        assert err < 1e-2, (r, err)
        assert size > 0
        assert upd <= TOL_UPDATE, (r, upd)
        for a, b in zip(params, port[0][2]):
            np.testing.assert_array_equal(a, b)


# ------------------------------------------------- in-process, no world

@pytest.mark.parametrize('dtype', [np.float32, jnp.bfloat16])
@pytest.mark.parametrize('causal', [True, False])
def test_bwd_f32_plain_matches_jax(dtype, causal):
    """The port's ``_bwd(grad_dtype=torch.float32)`` on the CPU (the plain
    C and D) against JAX ``fa._bwd(..., interpret=True,
    grad_dtype=jnp.float32)`` as the ring calls it: out = 0 and dlse =
    -delta."""
    rng = np.random.default_rng(11 + causal)
    b, h, kh, s, d = 1, 4, 2, 256, 128
    q = rng.standard_normal((b, h, s, d)).astype(np.float32) * d ** -0.5
    k, v = (rng.standard_normal((b, kh, s, d)).astype(np.float32)
            for _ in range(2))
    do = rng.standard_normal((b, h, s, d)).astype(np.float32)
    qj, kj, vj, doj = (jnp.asarray(x, dtype) for x in (q, k, v, do))
    _, lse = jfa._fwd(qj, kj, vj, causal, 128, 128, True)
    delta = rng.standard_normal((b, h, s)).astype(np.float32)
    want = jfa._bwd(qj, kj, vj, jnp.zeros_like(doj), lse, doj, causal, 128,
                    128, True, dlse=jnp.asarray(-delta),
                    grad_dtype=jnp.float32)
    tdt = torch.float32 if dtype == np.float32 else torch.bfloat16

    def t(x):
        return torch.from_numpy(np.asarray(x, np.float32).swapaxes(1, 2)
                                .copy()).to(tdt)
    got = fa._bwd(t(qj), t(kj), t(vj), torch.zeros_like(t(doj)),
                  torch.from_numpy(np.asarray(lse)[..., 0].copy()), t(doj),
                  torch.from_numpy(-delta), causal,
                  grad_dtype=torch.float32)
    tol = RTOL32 if dtype == np.float32 else 1.5e-2
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert _rel(g.numpy().swapaxes(1, 2), np.asarray(w)) <= tol


@pytest.mark.parametrize('n', [1, 2, 3, 4])
def test_zigzag_helpers_match_jax(n):
    assert ring.zigzag_chunk_order(n) == jring.zigzag_chunk_order(n)
    for s in (2 * n, 8 * n):
        np.testing.assert_array_equal(ring.zigzag_positions(s, n),
                                      jring.zigzag_positions(s, n))
    x = np.arange(2 * 8 * n * 3).reshape(2, 8 * n, 3)
    y = ring.zigzag_permute(torch.from_numpy(x), n)
    np.testing.assert_array_equal(y.numpy(), np.asarray(
        jring.zigzag_permute(jnp.asarray(x), n)))
    np.testing.assert_array_equal(ring.zigzag_unpermute(y, n).numpy(), x)
    with pytest.raises(ValueError, match='zigzag chunks'):
        ring.zigzag_positions(2 * n + 1, n)


def test_combine_is_stable():
    """The JAX test's case: a skipped partial (lse -1e30) leaves the
    other as it is; and random partials merge as JAX's _combine does."""
    o1 = torch.ones((1, 2, 1, 4))
    lse1 = torch.full((1, 2, 1), -1e30)
    o2 = torch.full((1, 2, 1, 4), 2.0)
    lse2 = torch.zeros((1, 2, 1))
    o, lse = ring._combine(o2, lse2, o1 * 0, lse1)
    np.testing.assert_allclose(o.numpy(), 2.0)
    np.testing.assert_allclose(lse.numpy(), 0.0)
    rng = np.random.default_rng(3)
    args = [rng.standard_normal(sh).astype(np.float32)
            for sh in ((2, 8, 4, 16), (2, 8, 4), (2, 8, 4, 16), (2, 8, 4))]
    got = ring._combine(*map(torch.from_numpy, args))
    want = jring._combine(*map(jnp.asarray, args))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)


def test_one_rank_ring_is_the_plain_attention():
    """No world (group None): the ring is one step with no message, its
    output and grads those of the plain attention, both layouts; the
    same through attention(impl='ring'), which refuses a window."""
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
               .requires_grad_() for sh in ((2, 16, 4, 8), (2, 16, 2, 8),
                                            (2, 16, 2, 8)))
    w = torch.from_numpy(rng.standard_normal((2, 16, 4, 8)).astype(
        np.float32))
    ref = attention.xla_attention(q, k, v, causal=True)
    g_ref = torch.autograd.grad((ref * w).sum(), (q, k, v))
    for layout in ('seq', 'zigzag'):
        perm = (functools.partial(ring.zigzag_permute, n_shards=1)
                if layout == 'zigzag' else (lambda x: x))
        out = ring.ring_attention(perm(q), perm(k), perm(v), layout=layout)
        grads = torch.autograd.grad((out * perm(w)).sum(), (q, k, v))
        assert _rel(out.detach().numpy(), perm(ref).detach().numpy()) < 1e-5
        for g, gr in zip(grads, g_ref):
            assert _rel(g.numpy(), gr.numpy()) < 1e-5
        # The model's route: attention(impl='ring') on the current mesh.
        via = attention.attention(perm(q), perm(k), perm(v), impl='ring',
                                  layout=layout)
        torch.testing.assert_close(via, out, rtol=0, atol=0)
    with pytest.raises(ValueError, match='ring attention takes no'):
        attention.attention(q, k, v, impl='ring', window=4)


def test_model_refuses_ring_switches_by_name():
    """The switches ring attention does not take, refused in the JAX
    layer's words before anything runs; zigzag without positions too."""
    base = dataclasses.replace(config.PRESETS['llama-debug'],
                               attention_impl='ring')
    params = llama.init_params(base, torch.Generator().manual_seed(0), 'cpu')
    tokens = torch.zeros((1, 8), dtype=torch.long)
    for field, value, words in (
            ('sliding_window', 4, 'sliding_window .* ring attention'),
            ('attn_logit_softcap', 50.0, 'attn_logit_softcap with ring'),
            ('local_rope_theta', 10000.0, 'local_rope_theta .* ring'),
            ('attn_sinks', True, 'attn_sinks .* ring')):
        cfg = dataclasses.replace(base, **{field: value})
        with pytest.raises(NotImplementedError, match=words):
            llama.forward(params, tokens, cfg)
    with pytest.raises(ValueError, match='zigzag'):
        llama.forward(params, tokens,
                      dataclasses.replace(base, ring_layout='zigzag'))
    with pytest.raises(NotImplementedError, match='MoE.*Queue 1 item 8'):
        config.check_supported(dataclasses.replace(
            config.get_config('moe-debug'), attention_impl='ring'))
    with pytest.raises(NotImplementedError, match='MLA'):
        config.check_supported(dataclasses.replace(
            config.get_config('mla-debug'), attention_impl='ring'))
