"""Shared by tests/test_torch_train_moe.py and test_torch_train_mla.py:
the MoE and MLA families' train step in the port against JAX
``train_lib`` on the CPU, in fp32.

JAX ``init_params`` weights (norms, sinks and biases randomised, the
router scaled x5, so that every leaf matters and no route rests on a
near tie, as tests/test_torch_moe.py does) are bridged into the port
with models/weights.py; batches are made from a seed with numpy. JAX
runs on ``parallel.mesh.single_device_mesh()``, as
tests/test_torch_train.py's ``jax_run`` does.

Tolerances:
  - logits, aux and the CE: TOL (2e-4, rtol and atol), as the families'
    forward tests hold them (a few layers of fp32 products summed in
    other orders);
  - per-leaf grads of CE + aux: TOL_GRAD (1e-4) of the leaf's largest
    JAX grad, elementwise;
  - the 4-step trajectory: loss and grad_norm rtol 1e-5, mu and nu rtol
    1e-4 (tests/test_torch_train.py's bounds), the params within
    TOL_PARAMS (1e-5) of each leaf's largest value;
  - remat 'full' against 'none' in the port: TOL_REMAT (1e-6), the same
    products recomputed.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from skypilot_tpu import models as jmodels
from skypilot_tpu.parallel import mesh as jmesh
from skypilot_tpu.train import train_lib as jtrain_lib
from skypilot_tpu_torch import config
from skypilot_tpu_torch.models import module_for, weights
from skypilot_tpu_torch.train import train_lib

TOL = 2e-4
TOL_GRAD = 1e-4
TOL_REMAT = 1e-6
TOL_PARAMS = 1e-5
STEPS = 4

_RANDOMISED = ('attn_norm', 'moe_norm', 'mlp_norm', 'kv_norm', 'sink', 'bq',
               'bk', 'bv')
_TREES = {}


def model(name, seed=0, **overrides):
    """(JAX cfg, port cfg, host tree) of preset ``name`` in fp32 with
    ``overrides``; the tree's norms, sinks and biases randomised and its
    router scaled x5."""
    jcfg = dataclasses.replace(jmodels.get_config(name), dtype=jnp.float32,
                               **overrides)
    tcfg = dataclasses.replace(config.get_config(name), dtype=torch.float32,
                               **overrides)
    key = (name, seed)
    if key not in _TREES:
        tree = jax.device_get(jmodels.module_for(jcfg).init_params(
            jax.random.PRNGKey(seed), jcfg))
        rng = np.random.default_rng(seed)
        lay = tree['layers']
        for k in _RANDOMISED:
            if k in lay:
                lay[k] = (1.0 if 'norm' in k else 0.0) + 0.3 * \
                    rng.standard_normal(lay[k].shape).astype(np.float32)
        if 'router' in lay:
            lay['router'] = 5 * np.asarray(lay['router'])
        tree['final_norm'] = 1.0 + 0.3 * rng.standard_normal(
            tree['final_norm'].shape).astype(np.float32)
        _TREES[key] = tree
    return jcfg, tcfg, _TREES[key]


def jax_params(tree):
    """A fresh JAX copy of the host tree (a train step donates it)."""
    return jax.tree.map(lambda a: jnp.array(a, copy=True), tree)


def port_params(tree, tcfg):
    return weights.params_from_jax(tree, tcfg, device='cpu')


def batch(seed, b=4, s=16, vocab=256):
    return np.random.default_rng(seed).integers(
        0, vocab, (b, s + 1)).astype(np.int32)


def close(t, j, tol=TOL):
    np.testing.assert_allclose(np.asarray(t.detach()), np.asarray(j),
                               rtol=tol, atol=tol)


def jax_loss_grads(jcfg, tree, tokens):
    """JAX: (CE, aux, grads of CE + aux) by jax.value_and_grad, as
    ``train_lib.make_train_step``'s loss_fn computes them."""
    mod = jmodels.module_for(jcfg)

    def loss_fn(p):
        logits, aux = mod.forward(p, jnp.asarray(tokens[:, :-1]), jcfg,
                                  return_aux=True)
        loss, _ = jtrain_lib.cross_entropy_loss(logits,
                                                jnp.asarray(tokens[:, 1:]))
        return loss + aux, (loss, aux)

    (_, (loss, aux)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        jax_params(tree))
    return float(loss), float(aux), jax.device_get(grads)


def port_loss_grads(tcfg, params, tokens):
    """The port: (CE, aux, grads of CE + aux) through the train step's
    own forward (``train_lib.forward_with_aux``)."""
    leaves = train_lib.leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    tok = torch.from_numpy(tokens)
    logits, aux = train_lib.forward_with_aux(tcfg, params, tok[:, :-1])
    loss, _ = train_lib.cross_entropy_loss(logits, tok[:, 1:])
    grads = torch.autograd.grad(loss + aux, leaves)
    return float(loss.detach()), float(aux.detach()), grads


def assert_grads_match(grads, jgrads):
    """Per leaf, elementwise within TOL_GRAD of the leaf's largest JAX
    grad; every leaf's JAX grad non-zero (each leaf is on the path)."""
    jflat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert len(jflat) == len(grads)
    for (path, want), got in zip(jflat, grads):
        want = np.asarray(want)
        scale = float(np.abs(want).max())
        assert scale > 0, jax.tree_util.keystr(path)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=TOL_GRAD * scale,
                                   err_msg=jax.tree_util.keystr(path))


def jax_train(jcfg, tree, batches, accum=1, masks=None):
    """JAX ``make_train_step`` over ``batches`` from the tree: (each
    step's (loss, grad_norm, tokens), the final host TrainState)."""
    mesh = jmesh.single_device_mesh()
    jtx = jtrain_lib.default_optimizer(warmup_steps=2, total_steps=10)
    params = jax_params(tree)
    state = jtrain_lib.TrainState(step=jnp.zeros((), jnp.int32),
                                  params=params, opt_state=jtx.init(params))
    step = jtrain_lib.make_train_step(jcfg, mesh, jtx, grad_accum_steps=accum)
    out = []
    for i, tokens in enumerate(batches):
        b = {'tokens': jnp.asarray(tokens)}
        if masks is not None:
            b['loss_mask'] = jnp.asarray(masks[i])
        state, m = step(state, b)
        out.append((float(m['loss']), float(m['grad_norm']),
                    float(m['tokens'])))
    return out, jax.device_get(state)


def port_train(tcfg, tree, batches, accum=1, masks=None):
    """The port's ``make_train_step`` over ``batches``: (each step's
    (loss, grad_norm, tokens), the final TrainState)."""
    tx = train_lib.default_optimizer(warmup_steps=2, total_steps=10)
    state = train_lib.init_train_state(tcfg, tx, 'cpu',
                                       params=port_params(tree, tcfg))
    step = train_lib.make_train_step(tcfg, tx, grad_accum_steps=accum)
    out = []
    for i, tokens in enumerate(batches):
        b = {'tokens': torch.from_numpy(tokens)}
        if masks is not None:
            b['loss_mask'] = torch.from_numpy(masks[i])
        state, m = step(state, b)
        out.append((float(m['loss']), float(m['grad_norm']),
                    float(m['tokens'])))
    return out, state


def assert_trajectories_match(got, want, rtol=1e-5):
    for (gl, gg, gt), (wl, wg, wt) in zip(got, want):
        np.testing.assert_allclose(gl, wl, rtol=rtol)
        np.testing.assert_allclose(gg, wg, rtol=rtol)
        assert gt == wt


def assert_state_matches(state, jstate, tcfg):
    """After the run: mu and nu against JAX's within rtol 1e-4 (atol
    1e-8), as tests/test_torch_train.py holds them; the params
    elementwise within TOL_PARAMS of the leaf's largest value (an
    element that the updates bring near 0 has no relative bound)."""
    count, mu, nu = weights.opt_state_from_jax(jstate.opt_state, tcfg, 'cpu')
    assert state.opt_state.count == count
    for got, want in ((state.opt_state.mu, mu), (state.opt_state.nu, nu)):
        for g, w in zip(train_lib.leaves(got), train_lib.leaves(want)):
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-8)
    want_p = weights.params_from_jax(jstate.params, tcfg, 'cpu')
    for g, w in zip(train_lib.leaves(state.params), train_lib.leaves(want_p)):
        torch.testing.assert_close(g.detach(), w, rtol=0,
                                   atol=TOL_PARAMS * float(w.abs().max()))


def masked_batch(seed):
    """Tokens [4, 17] and a loss mask [4, 16] whose two halves count
    different tokens (10 of 32, then all 32)."""
    mask = np.ones((4, 16), np.float32)
    mask[:2, 5:] = 0
    return batch(seed), mask


def without_aux(tcfg):
    """The config with the router aux weight at 0 (dense MLA has none)."""
    if hasattr(tcfg, 'router_aux_weight'):
        return dataclasses.replace(tcfg, router_aux_weight=0.0)
    return tcfg


def remat_grads(tcfg, tree, tokens):
    """The port's grads of CE + aux under remat 'none' and 'full'."""
    out = []
    for remat in ('none', 'full'):
        cfg = dataclasses.replace(tcfg, remat=remat)
        out.append(port_loss_grads(cfg, port_params(tree, cfg), tokens)[2])
    return out


def forward_under_grad(tcfg, tree, tokens):
    """The port's forward(return_aux=True) with autograd on, so that
    remat 'full' takes its checkpointed layers."""
    params = port_params(tree, tcfg)
    for leaf in train_lib.leaves(params):
        leaf.requires_grad_(True)
    return module_for(tcfg).forward(params, torch.from_numpy(tokens), tcfg,
                                    return_aux=True)
