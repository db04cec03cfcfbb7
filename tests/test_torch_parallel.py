"""The port's parallelism layer against the JAX package's, on the CPU:
``MeshSpec`` arithmetic and its errors, the rank layout of a mesh,
``DEFAULT_RULES`` and ``Rules``, a rank's rows and sequence slots, the
trainer's refusals by name, and the trainer CLI as a gang of two gloo
processes (``--mesh sequence=2``, zigzag ring) against the
single-process trainer: the losses within 2e-3 (the JAX zigzag test's
bound: bf16 compute summed in another order) and rank 0's checkpoint
restored by both ranks.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_ports
from skypilot_tpu.parallel import mesh as jmesh
from skypilot_tpu.parallel import sharding as jsharding
from skypilot_tpu_torch import config
from skypilot_tpu_torch.data import loader
from skypilot_tpu_torch.parallel import mesh as mesh_lib
from skypilot_tpu_torch.parallel import sharding
from skypilot_tpu_torch.train import train_lib, trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (MeshSpec kwargs, number of devices): fills, exact fits and each error.
SPECS = [({}, 1), ({}, 8), (dict(sequence=2), 2), (dict(sequence=2), 8),
         (dict(fsdp=1, data=2, sequence=2), 4), (dict(data=-1, fsdp=1), 4),
         (dict(tensor=2, expert=2, fsdp=2), 8),
         (dict(data=-1, fsdp=-1), 4), (dict(sequence=3), 8),
         (dict(fsdp=1, data=2), 4), (dict(stage=2, sequence=2), 8)]


def _outcome(make, n):
    try:
        spec = make()
        return ('ok', spec.sizes(n), spec.nontrivial_axes(n))
    except ValueError as e:
        return ('error', str(e))


@pytest.mark.parametrize('kwargs,n', SPECS,
                         ids=[f'{k}-{n}' for k, n in SPECS])
def test_mesh_spec_matches_jax(kwargs, n):
    """sizes and nontrivial_axes, errors word for word (the message
    names the spec, whose repr is the same dataclass's)."""
    assert mesh_lib.MESH_AXES == jmesh.MESH_AXES
    got = _outcome(lambda: mesh_lib.MeshSpec(**kwargs), n)
    want = _outcome(lambda: jmesh.MeshSpec(**kwargs), n)
    assert got == want


def test_rules_match_jax():
    assert sharding.DEFAULT_RULES == jsharding.DEFAULT_RULES
    port, jax_rules = sharding.Rules(), jsharding.Rules()
    for name, _ in jsharding.DEFAULT_RULES:
        assert port.mesh_axes(name) == jax_rules.mesh_axes(name)
    over = port.override(seq=None, batch='data')
    assert over.mesh_axes('seq') is None
    assert over.mesh_axes('batch') == ('data',)
    assert port.mesh_axes(None) is None
    with pytest.raises(KeyError, match='No sharding rule'):
        port.mesh_axes('nope')


@pytest.mark.parametrize('rank', range(4))
def test_mesh_layout_and_local_shards(rank):
    """Ranks lie row-major on MESH_AXES, as the JAX mesh reshapes its
    devices: on (data=2, sequence=2) rank r is at (r // 2, r % 2); a
    rank keeps the rows of its data coordinate and the sequence slots
    of its sequence coordinate."""
    mesh = mesh_lib.Mesh(mesh_lib.MeshSpec(fsdp=1, data=2,
                                           sequence=2).sizes(4), rank)
    grid = np.arange(4).reshape(
        jmesh.MeshSpec(fsdp=1, data=2, sequence=2).sizes(4))
    where = np.argwhere(grid == rank)[0]
    assert [mesh.coords[ax] for ax in mesh_lib.MESH_AXES] == list(where)
    assert (mesh.coords['data'], mesh.coords['sequence']) == (rank // 2,
                                                              rank % 2)
    assert mesh.index('data', 'fsdp') == rank // 2
    assert mesh.index('data', 'sequence') == rank
    x = torch.arange(4 * 8).reshape(4, 8)
    rows = sharding.local_shard(x, 'batch', 0, mesh)
    torch.testing.assert_close(rows, x[2 * (rank // 2):2 * (rank // 2) + 2])
    slots = sharding.local_shard(x, 'seq', 1, mesh)
    torch.testing.assert_close(slots,
                               x[:, 4 * (rank % 2):4 * (rank % 2) + 4])
    batch = loader.shard_batch({'tokens': x.numpy()}, mesh, 'cpu')
    torch.testing.assert_close(batch['tokens'], rows)
    with pytest.raises(ValueError, match='does not divide'):
        sharding.local_shard(torch.zeros(3, 8), 'batch', 0, mesh)


def test_one_rank_mesh_without_a_world():
    mesh = mesh_lib.build_mesh()
    assert mesh.size == 1 and mesh.group('sequence') is None
    assert mesh.shape == dict.fromkeys(mesh_lib.MESH_AXES, 1)
    assert mesh_lib.current_mesh().size == 1
    with mesh_lib.use_mesh(mesh) as m:
        assert mesh_lib.current_mesh() is m
    with pytest.raises(ValueError, match='does not multiply'):
        mesh_lib.build_mesh(mesh_lib.MeshSpec(fsdp=1, sequence=2))


def test_backend_knob(monkeypatch):
    monkeypatch.delenv('SKYTPU_TORCH_DIST_BACKEND', raising=False)
    assert mesh_lib.dist_backend('cuda') == 'nccl'
    assert mesh_lib.dist_backend('cpu') == 'gloo'
    monkeypatch.setenv('SKYTPU_TORCH_DIST_BACKEND', 'gloo')
    assert mesh_lib.dist_backend('cuda') == 'gloo'


# (--mesh, world): the axes training does not take, 'tensor', 'expert'
# and 'stage'.
UNPORTED = [(dict(tensor=2), 2), (dict(expert=2), 2), (dict(stage=2), 2)]


@pytest.mark.parametrize('axes,world', UNPORTED,
                         ids=[f'{a}-{w}' for a, w in UNPORTED])
def test_unported_axes_refused_by_name(axes, world, monkeypatch):
    """Refused by the step and by the trainer's --mesh check on a world
    of ``world``, each pointing at ROADMAP Queue 1 item 8."""
    mesh = mesh_lib.Mesh(mesh_lib.MeshSpec(**axes).sizes(world), 0)
    cfg = dataclasses.replace(config.PRESETS['llama-debug'],
                              attention_impl='ring')
    with pytest.raises(NotImplementedError, match='Queue 1 item 8'):
        train_lib.check_mesh(cfg, mesh)
    monkeypatch.setattr(trainer.dist, 'is_initialized', lambda: True)
    monkeypatch.setattr(trainer.dist, 'get_world_size', lambda: world)
    with pytest.raises(NotImplementedError,
                       match=f'Queue 1 item 8.*the default, no --mesh, is '
                             f'fsdp={world}'):
        trainer._build_mesh(trainer.TrainerConfig(mesh=axes, device='cpu'),
                            cfg)


# (--mesh, world, the 'fsdp' it gives): JAX's default MeshSpec() fills
# 'fsdp' with every rank left over, beside 'data' and 'sequence'.
ADMITTED = [(dict(data=2, fsdp=2), 4, 2), ({}, 2, 2), (dict(sequence=2), 4, 2),
            ({}, 8, 8), (dict(data=2), 4, 2), (dict(fsdp=2, sequence=2), 4, 2)]


@pytest.mark.parametrize('axes,world,fsdp', ADMITTED,
                         ids=[f'{a}-{w}' for a, w, _ in ADMITTED])
def test_fsdp_meshes_admitted(axes, world, fsdp, monkeypatch):
    """The step and the trainer's --mesh check admit the fully-sharded
    meshes, the default among them, for the dense family and the router
    aux families (MoE, MLA-MoE) alike where no ring is asked for."""
    mesh = mesh_lib.Mesh(mesh_lib.MeshSpec(**axes).sizes(world), 0)
    assert mesh.shape['fsdp'] == fsdp
    ring = mesh.shape['sequence'] > 1
    cfgs = [dataclasses.replace(config.PRESETS['llama-debug'],
                                attention_impl='ring')]
    if not ring:
        cfgs += [config.get_config('moe-debug'),
                 config.get_config('deepseek-moe-debug')]
    monkeypatch.setattr(trainer.dist, 'is_initialized', lambda: True)
    monkeypatch.setattr(trainer.dist, 'get_world_size', lambda: world)
    monkeypatch.setattr(trainer.mesh_lib, 'build_mesh',
                        lambda spec: mesh_lib.Mesh(spec.sizes(world), 0))
    for cfg in cfgs:
        train_lib.check_mesh(cfg, mesh)
        got = trainer._build_mesh(trainer.TrainerConfig(mesh=axes,
                                                        device='cpu'), cfg)
        assert got.shape == mesh.shape


def test_mesh_refusals_of_the_step_and_trainer(monkeypatch):
    """A sharded sequence without ring attention; a router aux across
    ranks admitted on ('data', 'fsdp'); LoRA on a mesh; the JAX
    batch-divisibility error."""
    mesh = mesh_lib.Mesh(mesh_lib.MeshSpec(fsdp=1, sequence=2).sizes(2), 0)
    with pytest.raises(ValueError, match="attention_impl='ring'"):
        train_lib.check_mesh(config.PRESETS['llama-debug'], mesh)
    dmesh = mesh_lib.Mesh(mesh_lib.MeshSpec(fsdp=1, data=2).sizes(2), 0)
    train_lib.check_mesh(config.get_config('moe-debug'), dmesh)
    train_lib.check_mesh(config.get_config('moe-debug'),
                         mesh_lib.Mesh(mesh_lib.MeshSpec().sizes(2), 0))
    monkeypatch.setattr(trainer, '_build_mesh', lambda tcfg, cfg: dmesh)
    with pytest.raises(NotImplementedError, match='--lora-rank on a mesh'):
        trainer.train(trainer.TrainerConfig(lora_rank=4, device='cpu'))
    with pytest.raises(ValueError, match='divisible by data\\*fsdp=2'):
        trainer.train(trainer.TrainerConfig(batch_size=3, device='cpu'))


# ------------------------------------------------- the trainer as a gang

FLAGS = ['--model', 'llama-debug', '--device', 'cpu', '--batch-size', '2',
         '--seq-len', '32', '--log-every', '1']
RING = ['--mesh', 'sequence=2', '--model-override', 'attention_impl=ring',
        '--model-override', 'ring_layout=zigzag']


def _gang(tmp, steps, tag, port):
    """Two trainer processes with the gang env a launch gives them,
    rank 0 listening on ``port``; (rank 0's step records, each rank's
    whole log)."""
    procs, paths = [], []
    for r in range(2):
        env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS='1',
                   SKYTPU_COORDINATOR_ADDRESS=f'127.0.0.1:{port}',
                   SKYTPU_NUM_PROCESSES='2', SKYTPU_NODE_RANK=str(r))
        paths.append(tmp / f'{tag}{r}.log')
        procs.append(subprocess.Popen(
            [sys.executable, '-m', 'skypilot_tpu_torch.train.trainer',
             *FLAGS, *RING, '--steps', str(steps), '--ckpt-dir',
             str(tmp / 'ck'), '--ckpt-every', '2'], cwd=ROOT, env=env,
            stdout=open(paths[-1], 'w'), stderr=subprocess.STDOUT))
    for p in procs:
        p.wait(timeout=300)
    logs = [p.read_text() for p in paths]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    recs = [json.loads(line) for line in logs[0].splitlines()
            if line.startswith('{"step"')]
    return recs, logs


def test_trainer_gang_matches_single_process(tmp_path):
    """--mesh sequence=2 with zigzag ring as two gang processes: losses
    equal to the single-process port trainer's within 2e-3, rank 1 logs
    no records, the replicas' params equal, and a second launch resumes
    both ranks from rank 0's checkpoint at step 2 and trains step 3 as
    the single process does."""
    one = trainer.train(trainer.TrainerConfig(
        model='llama-debug', batch_size=2, seq_len=32, total_steps=3,
        log_every=1, device='cpu'))
    recs, logs = _gang(tmp_path, 2, 'a', torch_ports.coord_port(70))
    assert [r['step'] for r in recs] == [1, 2]
    for a, b in zip(recs, one):
        assert abs(a['loss'] - b['loss']) < 2e-3, (recs, one)
    assert '{"step"' not in logs[1]
    reps = [json.loads(line) for log in logs for line in log.splitlines()
            if line.startswith('{"replica"')]
    assert sorted(r['replica'] for r in reps) == [0, 1]
    assert reps[0]['params_sha256'] == reps[1]['params_sha256']
    assert sorted(os.listdir(tmp_path / 'ck')) == ['step_00000002']

    recs, logs = _gang(tmp_path, 3, 'b', torch_ports.coord_port(71))
    for log in logs:
        assert 'Resumed from checkpoint step 2' in log
    assert [r['step'] for r in recs] == [3]
    assert abs(recs[0]['loss'] - one[2]['loss']) < 2e-3, (recs, one)
    assert sorted(os.listdir(tmp_path / 'ck')) == ['step_00000002',
                                                   'step_00000003']
