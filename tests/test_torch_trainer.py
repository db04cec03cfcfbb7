"""The port's trainer, input stream and checkpoints vs the JAX package's,
on the CPU.

- Batch streams (synthetic, text corpus, .npy): bit for bit.
- The trainer's loss history against the JAX trainer's on the same
  preset (cut to one narrow layer, fp32, bridged weights): within 2e-4
  absolute, the 4-decimal rounding both trainers log with.
- Checkpoints: a port resume equals the uninterrupted run exactly (fp32
  on the CPU is deterministic); a step the JAX Checkpointer saved (on a
  2x2x2 mesh, so in chunks) restores in the port, and a step the port
  saved restores through the JAX ``Checkpointer.restore_tree``, every
  leaf bit for bit.
"""
import dataclasses
import inspect
import os
import select
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.data import loader as jloader
from skypilot_tpu.data_service import spec as jspec
from skypilot_tpu.models import llama as jllama
from skypilot_tpu.parallel import MeshSpec, build_mesh
from skypilot_tpu.parallel import mesh as jmesh
from skypilot_tpu.train import checkpoints as jcheckpoints
from skypilot_tpu.train import train_lib as jtrain_lib
from skypilot_tpu.train import trainer as jtrainer
from skypilot_tpu_torch import config
from skypilot_tpu_torch.data import loader
from skypilot_tpu_torch.data_service import spec as spec_lib
from skypilot_tpu_torch.models import weights
from skypilot_tpu_torch.train import checkpoints, train_lib, trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = {'n_layers': 1, 'dim': 32, 'ffn_dim': 64, 'max_seq_len': 64}


def _cfgs():
    jcfg = dataclasses.replace(jllama.PRESETS['llama-debug'],
                               dtype=jnp.float32, **SMALL)
    tcfg = dataclasses.replace(config.PRESETS['llama-debug'],
                               dtype=torch.float32, **SMALL)
    return jcfg, tcfg


@pytest.fixture
def corpus(tmp_path):
    path = tmp_path / 'corpus.txt'
    path.write_text('the quick brown fox jumps over the lazy dog. ' * 200)
    return str(path)


def test_batch_streams_equal_jax(corpus, tmp_path):
    npy = str(tmp_path / 'tokens.npy')
    np.save(npy, np.random.default_rng(0).integers(0, 256, 5000)
            .astype(np.int32))
    for kw in ({'seed': 3}, {'data_path': corpus}, {'data_path': npy}):
        args = dict(batch_size=4, seq_len=16, vocab_size=256, **kw)
        mine = spec_lib.load_source(spec_lib.DatasetSpec(**args))
        ref = jspec.load_source(jspec.DatasetSpec(**args))
        for step in (0, 1, 7, 123):
            got = mine.batch_at_step(step)['tokens']
            want = ref.batch_at_step(step)['tokens']
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    tokens = loader.load_tokens(corpus)
    np.testing.assert_array_equal(tokens, jloader.load_tokens(corpus))
    mine = loader.token_batches(tokens, 4, 16, start_step=5)
    ref = jloader.token_batches(tokens, 4, 16, start_step=5)
    for _ in range(3):
        np.testing.assert_array_equal(next(mine)['tokens'],
                                      next(ref)['tokens'])


def test_vocab_mismatch_refused(corpus):
    with pytest.raises(ValueError, match='vocab'):
        spec_lib.load_source(spec_lib.DatasetSpec(
            batch_size=2, seq_len=8, vocab_size=100, data_path=corpus))


def test_trainer_loss_history_matches_jax(corpus):
    """Both trainers, 4 steps on the same corpus from the same weights
    (the JAX trainer on its default 8-device CPU mesh), with a held-out
    eval every 2 steps."""
    common = dict(model='llama-debug', batch_size=8, seq_len=16,
                  total_steps=4, warmup_steps=2, log_every=1,
                  data_path=corpus, eval_data_path=corpus, eval_every=2,
                  eval_batches=2)
    ref = jtrainer.train(jtrainer.TrainerConfig(
        model_overrides=dict(SMALL, dtype=jnp.float32), **common))
    jcfg, tcfg = _cfgs()
    init = jax.device_get(jllama.init_params(jax.random.PRNGKey(0), jcfg))
    got = trainer.train(
        trainer.TrainerConfig(model_overrides=dict(SMALL, dtype=torch.float32),
                              device='cpu', **common),
        params=weights.params_from_jax(init, tcfg, 'cpu'))
    assert [r['step'] for r in got] == [r['step'] for r in ref] == [1, 2, 3, 4]
    for key in ('loss', 'eval_loss'):
        np.testing.assert_allclose([r.get(key, 0.0) for r in got],
                                   [r.get(key, 0.0) for r in ref],
                                   atol=2e-4, rtol=0)
    assert [('eval_loss' in r) for r in got] == [False, True, False, True]


def test_port_resume_equals_uninterrupted_run(corpus, tmp_path):
    common = dict(model='llama-debug', model_overrides=SMALL, batch_size=4,
                  seq_len=16, warmup_steps=2, log_every=1, data_path=corpus,
                  device='cpu')
    ref = trainer.train(trainer.TrainerConfig(total_steps=4, **common))
    ck = str(tmp_path / 'ck')
    first = trainer.train(trainer.TrainerConfig(
        total_steps=2, ckpt_dir=ck, ckpt_every=2, **common))
    resumed = trainer.train(trainer.TrainerConfig(
        total_steps=4, ckpt_dir=ck, ckpt_every=2, **common))
    assert [r['step'] for r in resumed] == [3, 4]
    assert [r['loss'] for r in first + resumed] == [r['loss'] for r in ref]
    assert checkpoints.Checkpointer(ck).all_steps() == [2, 4]


def test_time_interval_saves_between_cadence_steps(corpus, tmp_path):
    """ckpt_time_interval bounds the work a preemption can lose when the
    step cadence is far off: a tiny interval saves after every step."""
    ck = str(tmp_path / 'ck')
    trainer.train(trainer.TrainerConfig(
        model='llama-debug', model_overrides=SMALL, batch_size=2,
        seq_len=16, total_steps=3, data_path=corpus, ckpt_dir=ck,
        ckpt_every=1000, ckpt_time_interval=1e-9, device='cpu'))
    assert checkpoints.Checkpointer(ck).all_steps() == [1, 2, 3]


def _assert_state_equals_jax(state, jstate):
    """Every leaf of the port's TrainState equals the JAX one's."""
    jflat = {jax.tree_util.keystr(p): np.asarray(x) for p, x in
             jax.tree_util.tree_flatten_with_path(jax.device_get(jstate))[0]}
    mine = weights.train_state_leaves(state)
    assert [p for p, _ in mine] == list(jflat)
    for path, leaf in mine:
        got = (leaf.detach().numpy() if isinstance(leaf, torch.Tensor)
               else np.int32(leaf))
        np.testing.assert_array_equal(got, jflat[path], err_msg=path)


def test_jax_saved_step_restores_in_port(tmp_path):
    jcfg, tcfg = _cfgs()
    mesh = build_mesh(MeshSpec(data=2, fsdp=2, tensor=2))
    jtx = jtrain_lib.default_optimizer(warmup_steps=1, total_steps=10)
    jstate = jtrain_lib.init_train_state(jax.random.PRNGKey(0), jcfg, mesh,
                                         jtx)
    tokens = np.random.default_rng(0).integers(0, 256, (8, 17))
    jstate, _ = jtrain_lib.make_train_step(jcfg, mesh, jtx)(
        jstate, {'tokens': jnp.asarray(tokens, jnp.int32)})
    with jcheckpoints.Checkpointer(str(tmp_path)) as jck:
        jck.save(jstate, wait=True)
    tx = train_lib.default_optimizer(warmup_steps=1, total_steps=10)
    ck = checkpoints.Checkpointer(str(tmp_path))
    assert ck.latest_step() == 1
    state = ck.restore_tree(checkpoints.abstract_train_state(tcfg, tx), 1,
                            'cpu')
    assert state.step == state.opt_state.count == 1
    assert all(p.requires_grad for p in train_lib.leaves(state.params))
    _assert_state_equals_jax(state, jstate)


def test_port_saved_step_restores_in_jax(tmp_path):
    jcfg, tcfg = _cfgs()
    tx = train_lib.default_optimizer(warmup_steps=1, total_steps=10)
    state = train_lib.init_train_state(tcfg, tx, 'cpu')
    tokens = np.random.default_rng(1).integers(0, 256, (2, 17))
    state, _ = train_lib.make_train_step(tcfg, tx)(
        state, {'tokens': torch.from_numpy(tokens)})
    with checkpoints.Checkpointer(str(tmp_path)) as ck:
        assert ck.save(state, wait=True) == 1
    jtx = jtrain_lib.default_optimizer(warmup_steps=1, total_steps=10)
    abstract = jcheckpoints.abstract_train_state(
        jcfg, jmesh.single_device_mesh(), jtx)
    jstate = jcheckpoints.Checkpointer(str(tmp_path)).restore_tree(abstract, 1)
    _assert_state_equals_jax(state, jstate)


def test_corrupted_chunk_raises_and_restore_falls_back(tmp_path):
    _, tcfg = _cfgs()
    tx = train_lib.default_optimizer()
    state = train_lib.init_train_state(tcfg, tx, 'cpu')
    ck = checkpoints.Checkpointer(str(tmp_path))
    ck.save(state, 1, wait=True)
    ck.save(state, 2, wait=True)
    template = checkpoints.abstract_train_state(tcfg, tx)

    def corrupt(step):
        path = tmp_path / f'step_{step:08d}' / 'arrays' / 'a0003.p0000.c00.npy'
        raw = bytearray(path.read_bytes())
        raw[-1] ^= 0xFF
        path.write_bytes(bytes(raw))

    corrupt(2)
    with pytest.raises(checkpoints.CheckpointCorruptError, match='digest'):
        ck.restore_tree(template, 2, 'cpu')
    restored, step = ck.restore_newest(template, 'cpu')
    assert step == 1 and restored.step == 0
    corrupt(1)
    with pytest.raises(checkpoints.CheckpointCorruptError, match='refusing'):
        ck.restore_newest(template, 'cpu')
    # A manifest-less step (a save killed before its commit) is invisible.
    os.makedirs(tmp_path / 'step_00000009' / 'arrays')
    assert ck.all_steps() == [1, 2]


def test_sigterm_writes_a_final_checkpoint(tmp_path):
    """A preemption notice mid-run: the trainer CLI saves the step it
    finished, logs it, and exits 0."""
    ck = str(tmp_path / 'ck')
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.Popen(
        [sys.executable, '-m', 'skypilot_tpu_torch.train.trainer',
         '--model', 'llama-debug', '--model-override', 'n_layers=1',
         '--model-override', 'dim=32', '--model-override', 'ffn_dim=64',
         '--batch-size', '2', '--seq-len', '16', '--steps', '100000',
         '--log-every', '1', '--ckpt-dir', ck, '--ckpt-every', '1000000',
         '--device', 'cpu'],
        cwd=ROOT, env=env, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + 120
        lines = []
        while not any('"step": 2' in line for line in lines):
            ready, _, _ = select.select([proc.stderr], [], [],
                                        max(0.0, deadline - time.monotonic()))
            assert ready, f'no step logged in time: {lines}'
            line = proc.stderr.readline()
            assert line, f'trainer exited early: {lines}'
            lines.append(line)
        proc.send_signal(signal.SIGTERM)
        _, rest = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, rest
    last = rest.strip().splitlines()[-1]
    assert '"preempted": true' in last and '"final_checkpoint": true' in last
    step = checkpoints.Checkpointer(ck).latest_step()
    assert step is not None and step >= 2 and f'"step": {step}' in last


def test_trainer_defaults_to_cuda_and_refuses_without_a_card(monkeypatch):
    assert trainer.TrainerConfig().device == 'cuda'
    assert inspect.signature(trainer.train).parameters['params'].default \
        is None
    assert trainer.build_parser().parse_args([]).device == 'cuda'
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        trainer.train(trainer.TrainerConfig())
    with pytest.raises(RuntimeError, match='no CUDA device'):
        trainer.main([])


@pytest.mark.parametrize('flags', [
    ['--mesh', 'data=2'], ['--lora-rank', '4'], ['--hf-dir', '/x'],
    ['--sft-data', 'c.jsonl'], ['--data-service', 'h:1']])
def test_unported_flags_refused_by_name(flags):
    with pytest.raises(NotImplementedError, match=f'{flags[0]}.*ROADMAP'):
        trainer.main(flags + ['--device', 'cpu'])
