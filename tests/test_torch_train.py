"""The port's train library vs the JAX package's, on the CPU.

Numpy-seeded inputs and JAX-initialised weights (bridged with
models/weights.py) go through skypilot_tpu.train.train_lib and the
port's train/train_lib.py, in fp32. Tolerances: 1e-6 on the loss and
the optimizer (the same fp32 arithmetic in another order; optax's
learning rate is fp32, the port's fp64); 1e-5 relative on the 4-step
llama-debug trajectory (two layers of fp32 products summed in different
orders, fed back through 4 AdamW updates).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from skypilot_tpu.models import llama as jllama
from skypilot_tpu.parallel import mesh as jmesh
from skypilot_tpu.train import train_lib as jtrain_lib
from skypilot_tpu_torch import config
from skypilot_tpu_torch.models import weights
from skypilot_tpu_torch.train import train_lib


def _cfgs(**kw):
    jcfg = dataclasses.replace(jllama.PRESETS['llama-debug'],
                               dtype=jnp.float32, **kw)
    tcfg = dataclasses.replace(config.PRESETS['llama-debug'],
                               dtype=torch.float32, **kw)
    return jcfg, tcfg


def _batch(seed, b=4, s=16, vocab=256):
    return np.random.default_rng(seed).integers(
        0, vocab, (b, s + 1)).astype(np.int32)


def test_cross_entropy_loss_with_mask_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 5, 11)).astype(np.float32) * 3
    targets = rng.integers(0, 11, (3, 5)).astype(np.int32)
    mask = (rng.random((3, 5)) < 0.6).astype(np.float32)
    for m in (None, mask):
        jl, jd = jtrain_lib.cross_entropy_loss(
            jnp.asarray(logits), jnp.asarray(targets),
            None if m is None else jnp.asarray(m))
        tl, td = train_lib.cross_entropy_loss(
            torch.from_numpy(logits), torch.from_numpy(targets),
            None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
        assert float(td) == float(jd)


@pytest.mark.parametrize('warmup,total', [(3, 10), (5, 4), (0, 8)])
def test_learning_rates_match_optax_schedule(warmup, total):
    """The lr of update c is the schedule at the count before the
    increment: 0 for the first update when warmup > 0."""
    sched = optax.warmup_cosine_decay_schedule(
        0.0, 3e-4, warmup, max(total, warmup + 1))
    tx = train_lib.default_optimizer(learning_rate=3e-4, warmup_steps=warmup,
                                     total_steps=total)
    got = [tx.learning_rate(c) for c in range(13)]
    want = [float(sched(c)) for c in range(13)]
    # optax evaluates the schedule in fp32 (its cosine good to a few
    # 1e-7 relative), the port in fp64.
    np.testing.assert_allclose(got, want, rtol=5e-6, atol=1e-12)
    if warmup:
        assert got[0] == 0.0


def test_optimizer_updates_match_optax():
    """5 updates on a small nested tree, some grads under the clip norm
    and some over it: params, moments and count equal optax's chain."""
    rng = np.random.default_rng(1)
    tree = {'a': rng.standard_normal((4, 3)), 'norm': np.ones(5),
            'layers': {'w': rng.standard_normal((2, 3, 5)),
                       'b': rng.standard_normal((2, 4))}}
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32), tree)
    jtx = jtrain_lib.default_optimizer(learning_rate=1e-2, warmup_steps=2,
                                       total_steps=6)
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = jtx.init(jparams)
    tx = train_lib.default_optimizer(learning_rate=1e-2, warmup_steps=2,
                                     total_steps=6)
    params = jax.tree.map(lambda x: torch.from_numpy(x.copy()), tree)
    state = tx.init(params)
    for i in range(5):
        scale = 0.05 if i % 2 else 3.0           # under, then over the clip
        grads = jax.tree.map(
            lambda x: (rng.standard_normal(x.shape) * scale).astype(
                np.float32), tree)
        upd, jstate = jtx.update(jax.tree.map(jnp.asarray, grads), jstate,
                                 jparams)
        jparams = optax.apply_updates(jparams, upd)
        norm = tx.update([torch.from_numpy(g.copy()) for g in
                          jax.tree.leaves(grads)], state, params)
        np.testing.assert_allclose(float(norm),
                                   float(optax.global_norm(grads)), rtol=1e-6)
    adam = jstate[1][0]
    assert state.count == int(adam.count) == int(jstate[1][2].count) == 5
    for got, want in ((params, jparams), (state.mu, adam.mu),
                      (state.nu, adam.nu)):
        for g, w in zip(train_lib.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                       rtol=1e-6)


@pytest.fixture(scope='module')
def jax_run():
    """JAX train_lib on a 1-device CPU mesh: initial params, the optax
    state after 4 steps, and each step's metrics."""
    jcfg, _ = _cfgs()
    mesh = jmesh.single_device_mesh()
    jtx = jtrain_lib.default_optimizer(warmup_steps=2, total_steps=10)
    jstate = jtrain_lib.init_train_state(jax.random.PRNGKey(0), jcfg, mesh,
                                         jtx)
    init = jax.device_get(jstate.params)
    step = jtrain_lib.make_train_step(jcfg, mesh, jtx)
    metrics = []
    for i in range(4):
        jstate, m = step(jstate, {'tokens': jnp.asarray(_batch(i))})
        metrics.append((float(m['loss']), float(m['grad_norm']),
                        float(m['tokens'])))
    return init, jax.device_get(jstate.opt_state), metrics


def test_train_step_trajectory_matches_jax(jax_run):
    init, jopt, jmetrics = jax_run
    _, tcfg = _cfgs()
    tx = train_lib.default_optimizer(warmup_steps=2, total_steps=10)
    state = train_lib.init_train_state(
        tcfg, tx, 'cpu', params=weights.params_from_jax(init, tcfg, 'cpu'))
    step = train_lib.make_train_step(tcfg, tx)
    for i, (jl, jg, jt) in enumerate(jmetrics):
        state, m = step(state, {'tokens': torch.from_numpy(_batch(i))})
        np.testing.assert_allclose(float(m['loss']), jl, rtol=1e-5)
        np.testing.assert_allclose(float(m['grad_norm']), jg, rtol=1e-5)
        assert float(m['tokens']) == jt and m['step'] == i
    assert state.step == 4
    count, mu, nu = weights.opt_state_from_jax(jopt, tcfg, 'cpu')
    assert state.opt_state.count == count == 4
    for got, want in ((state.opt_state.mu, mu), (state.opt_state.nu, nu)):
        for g, w in zip(train_lib.leaves(got), train_lib.leaves(want)):
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-8)


def test_grad_accumulation_equals_dense_step(jax_run):
    """Token-weighted accumulation over 2 microbatches whose loss masks
    count different tokens gives the dense step's update."""
    init = jax_run[0]
    _, tcfg = _cfgs()
    tokens = torch.from_numpy(_batch(9))
    mask = torch.ones(4, 16)
    mask[:2, 5:] = 0                      # microbatch 0: 10 tokens of 32
    out = []
    for accum in (1, 2):
        tx = train_lib.default_optimizer(warmup_steps=0, total_steps=10)
        state = train_lib.init_train_state(
            tcfg, tx, 'cpu', params=weights.params_from_jax(init, tcfg,
                                                            'cpu'))
        step = train_lib.make_train_step(tcfg, tx, grad_accum_steps=accum)
        state, m = step(state, {'tokens': tokens, 'loss_mask': mask})
        out.append((state, m))
    (dense, md), (acc, ma) = out
    np.testing.assert_allclose(float(ma['loss']), float(md['loss']),
                               rtol=1e-6)
    np.testing.assert_allclose(float(ma['grad_norm']),
                               float(md['grad_norm']), rtol=1e-5)
    assert float(ma['tokens']) == float(md['tokens']) == 42
    for g, w in zip(train_lib.leaves(acc.params),
                    train_lib.leaves(dense.params)):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-7)


def test_eval_step_matches_jax(jax_run):
    init = jax_run[0]
    jcfg, tcfg = _cfgs()
    tokens = _batch(11)
    want = jtrain_lib.make_eval_step(jcfg, jmesh.single_device_mesh())(
        jax.tree.map(jnp.asarray, init), {'tokens': jnp.asarray(tokens)})
    got = train_lib.make_eval_step(tcfg)(
        weights.params_from_jax(init, tcfg, 'cpu'),
        {'tokens': torch.from_numpy(tokens)})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert not got.requires_grad


def test_synthetic_batch():
    gen = torch.Generator().manual_seed(0)
    batch = train_lib.synthetic_batch(gen, 3, 16, 256, device='cpu')
    tokens = batch['tokens']
    assert tokens.shape == (3, 17) and tokens.dtype == torch.int32
    assert 0 <= int(tokens.min()) and int(tokens.max()) < 256


def test_dots_remat_is_refused_by_name():
    _, tcfg = _cfgs(remat='dots')
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        config.check_supported(tcfg)


@pytest.mark.parametrize('name', ['llama-debug', 'moe-debug'])
def test_pipeline_stages_refused_by_name(name):
    """The dense and MoE forwards have no pipeline schedule: a config
    asking for stages is refused by name (as MLA's always was), in the
    forward and in the trainer, not run as one stage."""
    from skypilot_tpu_torch.models import module_for
    from skypilot_tpu_torch.train import trainer
    cfg = dataclasses.replace(config.get_config(name), pipeline_stages=2)
    with pytest.raises(NotImplementedError,
                       match='pipeline_stages=2.*ROADMAP Queue 1 item 8'):
        config.check_supported(cfg)
    with pytest.raises(NotImplementedError, match='pipeline_stages'):
        module_for(cfg).forward({}, torch.zeros((1, 4), dtype=torch.int32),
                                cfg)
    with pytest.raises(NotImplementedError, match='pipeline_stages'):
        trainer.main(['--model', name, '--model-override',
                      'pipeline_stages=2', '--device', 'cpu'])
