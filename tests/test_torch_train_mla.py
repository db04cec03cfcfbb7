"""Training the MLA/DeepSeek family (mla-debug, deepseek-moe-debug) in
the PyTorch port vs the JAX package's ``train_lib``, on the CPU, in
fp32.

Per preset, the checks of tests/test_torch_train_moe.py
(tests/torch_train_parity.py holds the shared parts and the
tolerances): ``forward(return_aux=True)`` logits and aux with autograd
on and remat 'full'; per-leaf grads of CE + aux (through the absorbed
latent attention and the latent norms, and for deepseek-moe-debug the
routed and shared experts) against ``jax.value_and_grad``; a 4-step
trajectory (loss, grad_norm, then params, mu and nu); token-weighted
grad accumulation under a mask against JAX's and, with the aux weight
at 0, against the dense step; eval; remat 'full' against 'none'. Dense
MLA's aux is 0. Then the JAX assertions of the train step with the
router aux (tests/unit_tests/test_mla.py): losses finite and falling,
the router's grad of the aux alive.
"""
import numpy as np
import pytest
import torch

import torch_train_parity as tp
from skypilot_tpu_torch.models import mla
from skypilot_tpu_torch.train import train_lib

NAMES = ['mla-debug', 'deepseek-moe-debug']


@pytest.mark.parametrize('name', NAMES)
def test_forward_with_aux_under_remat_matches_jax(name):
    jcfg, tcfg, tree = tp.model(name, remat='full')
    tokens = tp.batch(1)[:, :-1]
    from skypilot_tpu.models import mla as jmla
    want, jaux = jmla.forward(tp.jax_params(tree), tokens, jcfg,
                              return_aux=True)
    got, aux = tp.forward_under_grad(tcfg, tree, tokens)
    tp.close(got, want)
    tp.close(aux, jaux)
    assert (float(aux.detach()) > 0) == (name == 'deepseek-moe-debug')
    assert mla.HAS_AUX


@pytest.mark.parametrize('name', NAMES)
def test_grads_of_loss_plus_aux_match_jax(name):
    jcfg, tcfg, tree = tp.model(name)
    tokens = tp.batch(2)
    jl, ja, jg = tp.jax_loss_grads(jcfg, tree, tokens)
    loss, aux, grads = tp.port_loss_grads(tcfg, tp.port_params(tree, tcfg),
                                          tokens)
    np.testing.assert_allclose([loss, aux], [jl, ja], rtol=tp.TOL)
    tp.assert_grads_match(grads, jg)


@pytest.mark.parametrize('name', NAMES)
def test_train_step_trajectory_matches_jax(name):
    jcfg, tcfg, tree = tp.model(name)
    batches = [tp.batch(10 + i) for i in range(tp.STEPS)]
    want, jstate = tp.jax_train(jcfg, tree, batches)
    got, state = tp.port_train(tcfg, tree, batches)
    tp.assert_trajectories_match(got, want)
    assert state.step == tp.STEPS
    tp.assert_state_matches(state, jstate, tcfg)


@pytest.mark.parametrize('name', NAMES)
def test_grad_accumulation_matches_jax_and_dense_step(name):
    jcfg, tcfg, tree = tp.model(name)
    tokens, mask = tp.masked_batch(9)
    want, jstate = tp.jax_train(jcfg, tree, [tokens], accum=2, masks=[mask])
    got, state = tp.port_train(tcfg, tree, [tokens], accum=2, masks=[mask])
    tp.assert_trajectories_match(got, want)
    assert got[0][2] == 42
    tp.assert_state_matches(state, jstate, tcfg)
    # Without the aux, the token-weighted accumulation is the dense step.
    cfg0 = tp.without_aux(tcfg)
    (acc,), s_acc = tp.port_train(cfg0, tree, [tokens], accum=2,
                                  masks=[mask])
    (dense,), s_dense = tp.port_train(cfg0, tree, [tokens], masks=[mask])
    np.testing.assert_allclose(acc, dense, rtol=1e-5)
    for g, w in zip(train_lib.leaves(s_acc.params),
                    train_lib.leaves(s_dense.params)):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize('name', NAMES)
def test_eval_step_matches_jax(name):
    from skypilot_tpu.parallel import mesh as jmesh
    from skypilot_tpu.train import train_lib as jtrain_lib
    jcfg, tcfg, tree = tp.model(name)
    tokens = tp.batch(11)
    want = jtrain_lib.make_eval_step(jcfg, jmesh.single_device_mesh())(
        tp.jax_params(tree), {'tokens': tokens})
    got = train_lib.make_eval_step(tcfg)(tp.port_params(tree, tcfg),
                                         {'tokens': torch.from_numpy(tokens)})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert not got.requires_grad


@pytest.mark.parametrize('name', NAMES)
def test_remat_full_gives_the_grads_of_none(name):
    _, tcfg, tree = tp.model(name)
    none, full = tp.remat_grads(tcfg, tree, tp.batch(3))
    for a, b in zip(none, full):
        torch.testing.assert_close(a, b, rtol=0, atol=tp.TOL_REMAT)


def test_train_step_with_router_aux():
    """tests/unit_tests/test_mla.py::test_train_step_with_router_aux_sharded
    on the port (one device): 4 steps of deepseek-moe-debug on one batch
    give finite, falling losses, and the router's grad of the aux alone
    is non-zero (the aux reaches the loss)."""
    _, tcfg, _ = tp.model('deepseek-moe-debug')
    tx = train_lib.default_optimizer()
    state = train_lib.init_train_state(
        tcfg, tx, 'cpu', generator=torch.Generator().manual_seed(0))
    step = train_lib.make_train_step(tcfg, tx)
    tokens = torch.from_numpy(tp.batch(1, b=4, s=32))
    losses = []
    for _ in range(4):
        state, metrics = step(state, {'tokens': tokens})
        losses.append(float(metrics['loss']))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    _, aux = mla.forward(state.params, tokens[:, :-1], tcfg, return_aux=True)
    router = state.params['layers']['router']
    (g,) = torch.autograd.grad(aux, [router])
    assert float(g.abs().max()) > 0
