"""One rank of a gloo process group on the CPU, for the port's
context-parallel tests (tests/test_torch_ring.py), its sharded
serving forward (tests/test_torch_multihost_forward.py: the dense
family over 'tensor'; tests/test_torch_gang_forward.py: the MoE and MLA
families over 'expert' and 'tensor') and its fully-sharded training and
checkpoints (tests/test_torch_fsdp.py: 'fsdp', 'data', 'sequence').

    python tests/torch_dist_worker.py JOBS.pkl RANK WORLD INIT_FILE OUT_DIR

Joins the world through ``file://INIT_FILE``, runs every job of
JOBS.pkl whose world is WORLD, and writes OUT_DIR/rank<RANK>.pkl: {job
name: result}. Inputs and results are numpy, made from seeds by the
test; this process imports torch and the port only, never JAX.
"""
import contextlib
import os
import pickle
import sys
import time

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from skypilot_tpu_torch import config  # noqa: E402
from skypilot_tpu_torch.models import decode, mla, paging  # noqa: E402
from skypilot_tpu_torch.models import module_for, weights  # noqa: E402
from skypilot_tpu_torch.ops import ring_attention as ring  # noqa: E402
from skypilot_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from skypilot_tpu_torch.parallel import sharding  # noqa: E402
from skypilot_tpu_torch.train import checkpoints, train_lib  # noqa: E402

DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}


def ring_job(job, rank, world):
    """The ring over this rank's shard on ``job['device']`` (default the
    CPU): {'arrays': (out, dq, dk, dv) as fp32 numpy, 'launches': each
    kernel's launches in it}, with the backward knobs ``chunk`` /
    ``flash`` set for this job."""
    from skypilot_tpu_torch.kernels import build
    n, layout = world, job['layout']
    dt = DTYPES[job['dtype']]
    ring._BWD_KV_CHUNK = job.get('chunk', 1024)
    ring._BWD_FLASH = job.get('flash', '')
    q, k, v, do = (torch.from_numpy(job[x]).to(job.get('device', 'cpu'), dt)
                   for x in ('q', 'k', 'v', 'do'))
    if layout == 'zigzag':
        q, k, v, do = (ring.zigzag_permute(x, n) for x in (q, k, v, do))
    sl = q.shape[1] // n
    q, k, v, do = (x[:, rank * sl:(rank + 1) * sl].contiguous()
                   for x in (q, k, v, do))
    for x in (q, k, v):
        x.requires_grad_()
    build.reset_launches()
    out = ring.ring_attention(q, k, v, group=dist.group.WORLD,
                              causal=job['causal'], layout=layout)
    grads = torch.autograd.grad(out, (q, k, v), do)
    return {'arrays': [t.detach().float().cpu().numpy()
                       for t in (out,) + grads],
            'launches': {name: kern.launches
                         for name, kern in build.kernels().items()}}


def train_job(job, rank, world):
    """Train steps of ``job['model']`` with ``job['overrides']`` on a
    mesh of ``job['mesh']``, from the bridged params, one a batch of
    ``job['tokens']``, with no warmup (so the first step moves the
    params too): (losses, grad norms, the new params' leaves in the JAX
    order)."""
    import dataclasses
    from skypilot_tpu_torch.data import loader
    cfg = dataclasses.replace(config.get_config(job['model']),
                              **job['overrides'])
    mesh = mesh_lib.build_mesh(mesh_lib.MeshSpec(**job['mesh']))
    tx = train_lib.default_optimizer(warmup_steps=0)
    params = weights.params_from_jax(job['params'], cfg, device='cpu')
    state = train_lib.init_train_state(cfg, tx, 'cpu', params=params)
    step = train_lib.make_train_step(cfg, tx, mesh=mesh)
    losses, gnorms = [], []
    for tokens in job['tokens']:
        batch = loader.shard_batch({'tokens': tokens}, mesh, 'cpu')
        state, metrics = step(state, batch)
        losses.append(float(metrics['loss']))
        gnorms.append(float(metrics['grad_norm']))
    return losses, gnorms, [leaf.detach().numpy() for leaf in
                            train_lib.leaves(state.params)]


def tp_config(job):
    """The job's model config, computing in its dtype."""
    import dataclasses
    return dataclasses.replace(config.get_config(job['model']),
                               dtype=DTYPES[job['dtype']], **job['overrides'])


def paged_logits(params, cfg, job):
    """Prefill the job's ragged prompts, scatter their K/V (an MLA
    config: their latents) into its page table (pools of
    ``job['kv_quant']``, default 'none'), then one paged
    decode step per row of ``job['feed']`` with ``job['active']`` and,
    with ``job['verify']`` [K, B], one paged verify step fed its
    transpose (a [B, K] view with transposed strides, as the engine
    feeds its verify): every step's logits as fp32 numpy. On
    ``job['device']``, default the CPU."""
    dev = job.get('device', 'cpu')
    tokens, lengths, table, active = (
        torch.from_numpy(job[x]).to(dev)
        for x in ('tokens', 'lengths', 'table', 'active'))
    b, s = tokens.shape
    maxp, max_len = table.shape[1], job['max_len']
    psz = max_len // maxp
    dec = mla if isinstance(cfg, config.MLAConfig) else decode
    logits, ks, vs = dec.prefill(params, tokens, cfg, max_len,
                                 lengths=lengths)
    pool = dec.init_page_pool(cfg, b * maxp + 1, psz, b, maxp,
                              device=dev,
                              quant=job.get('kv_quant', 'none'))
    pool.table.copy_(table)
    paging.scatter_prefill(pool, ks, vs, torch.arange(b, device=dev), s,
                           lengths)
    out = [logits]
    for tok in job['feed']:
        logits, pool = dec.paged_decode_step(
            params, torch.from_numpy(tok).to(dev), pool, cfg,
            max_len=max_len, active=active)
        out.append(logits)
    if job.get('verify') is not None:
        fed = torch.from_numpy(job['verify']).to(dev).t()
        assert not fed.is_contiguous()
        logits, pool = dec.paged_verify_step(params, fed, pool, cfg,
                                             max_len=max_len,
                                             active=active)
        out.append(logits)
    return [x.float().cpu().numpy() for x in out]


@contextlib.contextmanager
def contiguity_spy():
    """Wrap ``dist.all_reduce`` and ``dist.all_gather`` inside the
    block: each call's (name, whether every tensor it was handed is
    contiguous) lands in the yielded list. NCCL reduces contiguous
    memory only, so the sharded forward must hand it nothing else."""
    calls = []
    saved = {name: getattr(dist, name) for name in ('all_reduce',
                                                    'all_gather')}
    for name, orig in saved.items():

        def wrapped(*args, _orig=orig, _name=name, **kwargs):
            tensors = [t for a in args for t in
                       (a if isinstance(a, (list, tuple)) else [a])
                       if isinstance(t, torch.Tensor)]
            calls.append((_name, all(t.is_contiguous() for t in tensors)))
            return _orig(*args, **kwargs)
        setattr(dist, name, wrapped)
    try:
        yield calls
    finally:
        for name, orig in saved.items():
            setattr(dist, name, orig)


def tp_job(job, rank, world):
    """:func:`paged_logits` of the bridged params (int8 with
    ``job['quantize']``, quantized whole, then sharded) on a mesh of
    ``job['mesh']`` (default 'tensor' = the world): each rank holds its
    shard of the family's ``param_axes`` (and its kv heads' pages, or
    the whole latent pool); the logits are every rank's gathered ones.
    With
    ``job['spy']`` the result is {'logits', 'collectives'}, the latter
    :func:`contiguity_spy`'s record of the run."""
    cfg = tp_config(job)
    params = decode.cast_params_for_decode(
        weights.params_from_jax(job['params'], cfg,
                                device=job.get('device', 'cpu')), cfg,
        quantize=job.get('quantize'))
    mesh = mesh_lib.build_mesh(mesh_lib.MeshSpec(
        **job.get('mesh', {'tensor': world})))
    mesh.group('expert', 'tensor')
    params = sharding.shard_params(params, module_for(cfg).param_axes(cfg),
                                   mesh)
    if job.get('expert_index_zero'):
        # The fault the shared-experts test must catch: every rank
        # taking itself for expert index 0 adds DeepSeekMoE's shared
        # experts on each 'expert' index.
        mesh.coords['expert'] = 0
    with torch.no_grad(), mesh_lib.use_mesh(mesh), contiguity_spy() as calls:
        out = paged_logits(params, cfg, job)
    return {'logits': out, 'collectives': calls} if job.get('spy') else out


def whole(tensors, cfg, mesh):
    """Tensors aligned with the params' leaves (params, grads, moments;
    on an fsdp mesh this rank's shards) gathered whole, as fp32 numpy."""
    axes = train_lib.leaves(module_for(cfg).param_axes(cfg))
    return [sharding.gather_whole(t.detach(), sharding.fsdp_dim(ax)
                                  if s else None, mesh).float().cpu().numpy()
            for t, ax, s in zip(tensors, axes,
                                train_lib.sharded_leaves(cfg, mesh))]


def state_arrays(state, cfg, mesh):
    """Every array of a TrainState whole, by checkpoint path."""
    opt = state.opt_state
    trees = {'.params': state.params, f'{weights.ADAM_PATH}.mu': opt.mu,
             f'{weights.ADAM_PATH}.nu': opt.nu}
    out = {'.step': state.step, f'{weights.ADAM_PATH}.count': opt.count,
           weights.SCHEDULE_COUNT_PATH: opt.count}
    for prefix, tree in trees.items():
        paths = [p for p, _ in weights.tree_paths(tree)]
        for p, a in zip(paths, whole(train_lib.leaves(tree), cfg, mesh)):
            out[prefix + p] = a
    return out


def fsdp_job(job, rank, world):
    """Fully-sharded training of ``job['model']`` (``job['dtype']``,
    default fp32, with ``job['overrides']``) on a mesh of
    ``job['mesh']`` on ``job['device']`` (default the CPU; the ranks
    share card 0), every array returned whole: with ``job['params']``
    (a JAX tree) the state drawn from them, with ``job['grads']`` the
    (CE, aux, grads) of the first batch, then a step a batch of
    ``job['tokens']`` at the peak learning rate (losses, grad norms,
    params), and with ``job['save']`` the state saved there. With
    ``job['restore']`` (a directory, a step) the step restored instead,
    once its manifest exists: its arrays and the chunk files this rank
    read. ``launches``: each kernel's launches in the steps."""
    import dataclasses
    from skypilot_tpu_torch.data import loader
    from skypilot_tpu_torch.kernels import build
    dev = job.get('device', 'cpu')
    if dev == 'cuda':
        torch.cuda.set_device(0)
    cfg = dataclasses.replace(config.get_config(job['model']),
                              dtype=DTYPES[job.get('dtype', 'float32')],
                              **job.get('overrides', {}))
    mesh = mesh_lib.build_mesh(mesh_lib.MeshSpec(**job['mesh']))
    tx = train_lib.default_optimizer(warmup_steps=0)
    out = {}
    if 'restore' in job:
        directory, step = job['restore']
        manifest = os.path.join(directory, f'step_{step:08d}',
                                'MANIFEST.json')
        deadline = time.monotonic() + 300
        while not os.path.exists(manifest):
            assert time.monotonic() < deadline, manifest
            time.sleep(0.2)
        read = []
        saved = checkpoints._read_chunk

        def spy(step_dir, step, chunk):
            read.append(chunk['file'])
            return saved(step_dir, step, chunk)
        checkpoints._read_chunk = spy
        try:
            ck = checkpoints.Checkpointer(directory, cfg=cfg, mesh=mesh)
            state = ck.restore_tree(checkpoints.abstract_train_state(cfg, tx),
                                    step, 'cpu')
        finally:
            checkpoints._read_chunk = saved
        out['restored'] = state_arrays(state, cfg, mesh)
        out['read'] = sorted(read)
        out['shard_shapes'] = [tuple(t.shape) for t in
                               train_lib.leaves(state.params)]
        return out
    params = weights.params_from_jax(job['params'], cfg, device=dev)
    state = train_lib.init_train_state(cfg, tx, dev, params=params,
                                       mesh=mesh)
    batches = [loader.shard_batch({'tokens': t}, mesh, dev)
               for t in job['tokens']]
    if job.get('grads'):
        grads, loss, _, aux = train_lib.make_grad_fn(cfg, mesh=mesh)(
            state.params, batches[0])
        out.update(loss=float(loss), aux=float(aux),
                   grads=whole(grads, cfg, mesh))
    step = train_lib.make_train_step(cfg, tx, mesh=mesh)
    build.reset_launches()
    losses, gnorms, auxes = [], [], []
    for batch in batches:
        state, metrics = step(state, batch)
        losses.append(float(metrics['loss']))
        gnorms.append(float(metrics['grad_norm']))
        auxes.append(float(metrics['aux']))
    out['launches'] = {n: k.launches for n, k in build.kernels().items()}
    out.update(losses=losses, gnorms=gnorms, auxes=auxes,
               params=whole(train_lib.leaves(state.params), cfg, mesh),
               shard_shapes=[tuple(t.shape) for t in
                             train_lib.leaves(state.params)],
               moment_shapes=[tuple(t.shape) for t in
                              train_lib.leaves(state.opt_state.mu)])
    if job.get('save'):
        with checkpoints.Checkpointer(job['save'], cfg=cfg, mesh=mesh) as ck:
            ck.save(state, wait=True)
        out['state'] = state_arrays(state, cfg, mesh)
    return out


JOBS = {'ring': ring_job, 'train': train_job, 'tp': tp_job,
        'fsdp': fsdp_job}


def main():
    jobs_path, rank, world, init_file, out_dir = sys.argv[1:]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    dist.init_process_group('gloo', init_method=f'file://{init_file}',
                            rank=rank, world_size=world)
    with open(jobs_path, 'rb') as f:
        jobs = pickle.load(f)
    out = {}
    for name, job in jobs.items():
        if job['world'] != world:
            continue
        out[name] = JOBS[job['kind']](job, rank, world)
    with open(os.path.join(out_dir, f'rank{rank}.pkl'), 'wb') as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


if __name__ == '__main__':
    main()
