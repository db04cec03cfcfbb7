"""Training the Gemma family: the PyTorch port vs the JAX package, on the
CPU.

- ``unembed`` in bf16: fp32 logits from the bf16 operands, as the JAX
  einsum's ``preferred_element_type=f32`` gives them. Within 1e-3: the
  same bf16 operands on both sides, summed in fp32 in another order
  (logits of std ~16 here; a result rounded to bf16 is off by up to
  2^-9 of each logit, 3e-2 and more).
- Train steps of three configs shaped like gemma-7b, gemma2-9b and
  gemma3-12b: each is the preset with every switch kept, cut in width
  (dim 64, 4 q heads of 16, ffn 128), depth and vocab (256), in fp32 and
  with remat 'full' as the presets have it. Two sizes are cut to the
  test's sequences so that they act: the windows (8 and 6 keys for
  sequences of 16) and gemma2's softcaps (1.0 on attention logits, 2.0
  on the final ones, against a narrow random model's logits of a few
  units; 50 and 30 would change them by under 1e-4). gemma3's six
  layers keep its pattern of 6: five local (local rope base), one
  global. JAX's zero-initialised norm scales are drawn at random, so
  every leaf carries signal. 4 steps of JAX ``make_train_step`` (a
  1-device CPU mesh) and of the port's, from the same bridged weights
  and batches: losses and grad norms within 1e-5 relative, params and
  AdamW moments within 1e-4 relative (the llama test's fp32 tolerances:
  the same fp32 arithmetic summed in other orders, fed back through 4
  updates).
- Checkpoints of those trees cross both ways in the JAX package's
  format, every leaf bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import decode as jdecode
from skypilot_tpu.models import llama as jllama
from skypilot_tpu.parallel import mesh as jmesh
from skypilot_tpu.train import checkpoints as jcheckpoints
from skypilot_tpu.train import train_lib as jtrain_lib
from skypilot_tpu_torch import config
from skypilot_tpu_torch.models import llama, weights
from skypilot_tpu_torch.train import checkpoints, train_lib

WIDTH = dict(vocab_size=256, dim=64, n_heads=4, head_dim=16, ffn_dim=128,
             max_seq_len=64)
# Per preset: the width cut (gemma-7b keeps its kv heads = q heads),
# depth, and the sizes cut to the test's sequences.
CUTS = {
    'gemma-7b': dict(WIDTH, n_kv_heads=4, n_layers=2),
    'gemma2-9b': dict(WIDTH, n_kv_heads=2, n_layers=2, sliding_window=8,
                      attn_logit_softcap=1.0, final_logit_softcap=2.0),
    'gemma3-12b': dict(WIDTH, n_kv_heads=2, n_layers=6, sliding_window=6),
}
NAMES = list(CUTS)
STEPS, B, S = 4, 4, 16
_RANDOMISED = ('attn_norm', 'mlp_norm', 'post_attn_norm', 'post_mlp_norm',
               'q_norm', 'k_norm')


def _cfgs(name, **kw):
    cut = dict(CUTS[name], **kw)
    jcfg = dataclasses.replace(jllama.PRESETS[name], dtype=jnp.float32,
                               **cut)
    tcfg = dataclasses.replace(config.PRESETS[name], dtype=torch.float32,
                               **cut)
    return jcfg, tcfg


def _tree(jcfg, seed=0):
    """JAX init_params, its zero-initialised norm scales drawn at
    random (numpy)."""
    tree = jax.device_get(jllama.init_params(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    for key in _RANDOMISED:
        if key in tree['layers']:
            shape = tree['layers'][key].shape
            tree['layers'][key] = 0.3 * rng.standard_normal(shape).astype(
                np.float32)
    tree['final_norm'] = 0.3 * rng.standard_normal(
        tree['final_norm'].shape).astype(np.float32)
    return tree


def _batch(i):
    return np.random.default_rng(100 + i).integers(
        0, 256, (B, S + 1)).astype(np.int32)


def _optimizers():
    return (jtrain_lib.default_optimizer(warmup_steps=2, total_steps=10),
            train_lib.default_optimizer(warmup_steps=2, total_steps=10))


@pytest.mark.parametrize('softcap', [None, 30.0], ids=['plain', 'softcap'])
def test_unembed_in_bf16_keeps_fp32_logits(softcap):
    """bf16 hidden states and head, fp32 logits: the port's unembed
    against JAX decode._unembed (the same einsum as the forward's)."""
    kw = dict(dtype=jnp.bfloat16, dim=256, vocab_size=512, n_layers=1,
              final_logit_softcap=softcap)
    jcfg = dataclasses.replace(jllama.PRESETS['gemma2-9b'], **kw)
    tcfg = dataclasses.replace(config.PRESETS['gemma2-9b'],
                               **dict(kw, dtype=torch.bfloat16))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 256)).astype(np.float32)
    params = {'embed': rng.standard_normal((512, 256)).astype(np.float32),
              'final_norm': 0.3 * rng.standard_normal(256).astype(np.float32)}
    want = jdecode._unembed(jnp.asarray(x, jnp.bfloat16),
                            jax.tree.map(jnp.asarray, params), jcfg)
    got = llama.unembed(torch.from_numpy(x).bfloat16(),
                        {k: torch.from_numpy(v) for k, v in params.items()},
                        tcfg)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3,
                               rtol=0)


@pytest.fixture(scope='module', params=NAMES)
def jax_run(request):
    """JAX make_train_step, STEPS steps from the randomised tree: (name,
    the initial tree, the final TrainState, each step's metrics)."""
    name = request.param
    jcfg, _ = _cfgs(name)
    tree = _tree(jcfg)
    jtx, _ = _optimizers()
    mesh = jmesh.single_device_mesh()
    params = jax.tree.map(jnp.asarray, tree)
    # Placed as the step's outputs are, so that it compiles once.
    sh = jtrain_lib.state_shardings(jcfg, mesh, jtx)
    state = jax.device_put(
        jtrain_lib.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                              opt_state=jtx.init(params)),
        jtrain_lib.TrainState(step=sh.step, params=sh.params,
                              opt_state=sh.opt_state))
    step = jtrain_lib.make_train_step(jcfg, mesh, jtx)
    metrics = []
    for i in range(STEPS):
        state, m = step(state, {'tokens': jnp.asarray(_batch(i))})
        metrics.append((float(m['loss']), float(m['grad_norm']),
                        float(m['tokens'])))
    return name, tree, state, metrics


def _port_state(name, tree):
    _, tcfg = _cfgs(name)
    _, tx = _optimizers()
    return tcfg, tx, train_lib.init_train_state(
        tcfg, tx, 'cpu', params=weights.params_from_jax(tree, tcfg, 'cpu'))


def test_gemma_train_steps_match_jax(jax_run):
    name, tree, jstate, jmetrics = jax_run
    tcfg, tx, state = _port_state(name, tree)
    step = train_lib.make_train_step(tcfg, tx)
    for i, (jl, jg, jt) in enumerate(jmetrics):
        state, m = step(state, {'tokens': torch.from_numpy(_batch(i))})
        np.testing.assert_allclose(float(m['loss']), jl, rtol=1e-5)
        np.testing.assert_allclose(float(m['grad_norm']), jg, rtol=1e-5)
        assert float(m['tokens']) == jt
    jstate = jax.device_get(jstate)
    count, mu, nu = weights.opt_state_from_jax(jstate.opt_state, tcfg, 'cpu')
    assert state.opt_state.count == count == STEPS
    want_params = weights.params_from_jax(jstate.params, tcfg, 'cpu')
    for got, want in ((state.params, want_params),
                      (state.opt_state.mu, mu), (state.opt_state.nu, nu)):
        for (path, g), w in zip(weights.tree_paths(got),
                                train_lib.leaves(want)):
            torch.testing.assert_close(g.detach(), w, rtol=1e-4, atol=1e-8,
                                       msg=path)


def test_gemma_grad_accumulation_equals_dense_step():
    """gemma3's tree (q/k norms, post norms, windows): token-weighted
    accumulation over 2 microbatches with unequal masks equals the dense
    step."""
    _, tcfg = _cfgs('gemma3-12b')
    tokens = torch.from_numpy(_batch(9))
    mask = torch.ones(B, S)
    mask[:2, 5:] = 0
    out = []
    for accum in (1, 2):
        _, tx = _optimizers()
        gen = torch.Generator().manual_seed(1)
        params = llama.init_params(tcfg, gen, 'cpu')
        for key in _RANDOMISED:
            params['layers'][key].normal_(0.0, 0.3, generator=gen)
        state = train_lib.init_train_state(tcfg, tx, 'cpu', params=params)
        step = train_lib.make_train_step(tcfg, tx, grad_accum_steps=accum)
        out.append(step(state, {'tokens': tokens, 'loss_mask': mask}))
    (dense, md), (acc, ma) = out
    np.testing.assert_allclose(float(ma['loss']), float(md['loss']),
                               rtol=1e-6)
    np.testing.assert_allclose(float(ma['grad_norm']),
                               float(md['grad_norm']), rtol=1e-5)
    for g, w in zip(train_lib.leaves(acc.params),
                    train_lib.leaves(dense.params)):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-7)


def _assert_state_equals_jax(state, jstate):
    jflat = {jax.tree_util.keystr(p): np.asarray(x) for p, x in
             jax.tree_util.tree_flatten_with_path(jax.device_get(jstate))[0]}
    mine = weights.train_state_leaves(state)
    assert [p for p, _ in mine] == list(jflat)
    for path, leaf in mine:
        got = (leaf.detach().numpy() if isinstance(leaf, torch.Tensor)
               else np.int32(leaf))
        np.testing.assert_array_equal(got, jflat[path], err_msg=path)


@pytest.mark.parametrize('name', NAMES)
def test_gemma_checkpoint_saved_by_port_restores_in_jax(name, tmp_path):
    jcfg, _ = _cfgs(name)
    tcfg, tx, state = _port_state(name, _tree(jcfg, seed=2))
    state, _ = train_lib.make_train_step(tcfg, tx)(
        state, {'tokens': torch.from_numpy(_batch(5))})
    with checkpoints.Checkpointer(str(tmp_path)) as ck:
        assert ck.save(state, wait=True) == 1
    jtx, _ = _optimizers()
    abstract = jcheckpoints.abstract_train_state(
        jcfg, jmesh.single_device_mesh(), jtx)
    jstate = jcheckpoints.Checkpointer(str(tmp_path)).restore_tree(abstract, 1)
    _assert_state_equals_jax(state, jstate)


def test_gemma_checkpoint_saved_by_jax_restores_in_port(jax_run, tmp_path):
    name, _, jstate, _ = jax_run
    with jcheckpoints.Checkpointer(str(tmp_path)) as jck:
        jck.save(jstate, wait=True)
    _, tcfg = _cfgs(name)
    _, tx = _optimizers()
    ck = checkpoints.Checkpointer(str(tmp_path))
    assert ck.latest_step() == STEPS
    state = ck.restore_tree(checkpoints.abstract_train_state(tcfg, tx), STEPS,
                            'cpu')
    assert state.step == state.opt_state.count == STEPS
    _assert_state_equals_jax(state, jstate)
