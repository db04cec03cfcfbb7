"""LoRA fine-tuning in the port (train/lora.py, the trainer's LoRA
branch, train/lora_merge.py) against the JAX package on the CPU.

JAX ``init_params`` weights of llama-debug and moe-debug in fp32 (norms
randomised, the router scaled x5: tests/torch_train_parity.py) are the
frozen base of both packages; adapters are drawn with numpy from a seed
(A ~ N(0, 1) / r, B ~ N(0, 0.02)) or bridged from JAX's init, since the
two packages' RNGs draw different inits. moe-debug adapts its expert
leaves [L, E, in, out] beside the attention projections. JAX runs its
train step on ``single_device_mesh()``.

Tolerances:
  - merge_into: untargeted leaves bit-equal (the base's own tensors),
    targeted leaves within 1e-6 absolute (one fp32 rank-r product per
    element, summed in another order);
  - the three-step LoRA trajectory from B = 0: loss and grad_norm
    within 1e-5 relative; the adapter grads, read from the first moments
    (mu = 0.1 g after step 1, a decayed sum of them after step 3),
    within 1e-5 of the leaf's largest |g|; A's first grad exactly 0 in
    both; the updated adapters within 1e-3 lr an update wherever |g| is
    at least 1e-2 of the leaf's largest (elsewhere Adam's near-sign
    update may differ in sign between packages, so they are held within
    2.2 lr, the most two opposite updates part);
  - adapters.npz across packages: every leaf bit-equal, the moments
    non-zero after the round trip (not a fresh tx.init);
  - lora_merge's output against JAX lora_merge's: every bf16 element
    within one ulp (bit patterns at most 1 apart), untargeted tensors
    bit-equal.
"""
import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_train_parity as tp
from skypilot_tpu.parallel import mesh as jmesh
from skypilot_tpu.train import lora as jlora
from skypilot_tpu.train import lora_merge as jlora_merge
from skypilot_tpu.train import train_lib as jtrain_lib
from skypilot_tpu_torch import config
from skypilot_tpu_torch.models import (hf_export, hf_import, llama,
                                       safetensors_io, weights)
from skypilot_tpu_torch.train import lora, lora_merge, train_lib, trainer

TOL_MERGE = 1e-6
TOL_REL = 1e-5
TOL_GRAD = 1e-5
# The updated adapters, where |g| >= WELL x the leaf's largest: each of
# the two moving updates within TOL_UPDATE x lr (TOL_GRAD over WELL is
# the grads' worst relative error there, which Adam's m / sqrt(v)
# carries into the update).
WELL = 1e-2
TOL_UPDATE = 1e-3
LR = 1e-2
RANK = 4
FAMILIES = ['llama-debug', 'moe-debug']
TARGETS = {'llama-debug': lora.DEFAULT_TARGETS,
           'moe-debug': lora.DEFAULT_TARGETS + ('w_gate', 'w_down')}


def _lcfgs(name, rank=RANK):
    targets = TARGETS[name]
    return (lora.LoRAConfig(rank=rank, targets=targets),
            jlora.LoRAConfig(rank=rank, targets=targets))


def _np_adapters(tree, lcfg, seed, b_std=0.02):
    """Adapters for every target of ``tree`` from numpy: A ~ N(0,1)/r,
    B ~ N(0, b_std) (0 gives the fresh-init B)."""
    rng = np.random.default_rng(seed)
    flat = dict(lora._flat(tree))
    out = {}
    for key in jlora.target_keys(tree, jlora.LoRAConfig(
            rank=lcfg.rank, targets=lcfg.targets)):
        *lead, d_in, d_out = np.shape(flat[key])
        out[key] = {
            'a': (rng.standard_normal((*lead, d_in, lcfg.rank)) /
                  lcfg.rank).astype(np.float32),
            'b': (b_std * rng.standard_normal((*lead, lcfg.rank, d_out))
                  ).astype(np.float32)}
    return out


def _tx():
    return train_lib.default_optimizer(learning_rate=LR, warmup_steps=1,
                                       total_steps=10)


def _jtx():
    return jtrain_lib.default_optimizer(learning_rate=LR, warmup_steps=1,
                                        total_steps=10)


@pytest.mark.parametrize('name', FAMILIES)
def test_target_keys_match_jax_and_fail_loudly(name):
    _, tcfg, tree = tp.model(name)
    base = tp.port_params(tree, tcfg)
    for targets in (lora.DEFAULT_TARGETS, TARGETS[name], ('wq', 'router')):
        assert lora.target_keys(base, lora.LoRAConfig(targets=targets)) == \
            jlora.target_keys(tree, jlora.LoRAConfig(targets=targets))
    with pytest.raises(ValueError, match='matched no'):
        lora.target_keys(base, lora.LoRAConfig(targets=('final_norm', 'x')))


@pytest.mark.parametrize('name', FAMILIES)
def test_merge_into_matches_jax(name):
    _, tcfg, tree = tp.model(name)
    lcfg, jlcfg = _lcfgs(name)
    ad = _np_adapters(tree, lcfg, seed=1)
    want = jax.device_get(jlora.merge_into(tp.jax_params(tree), ad, jlcfg))
    base = tp.port_params(tree, tcfg)
    got = lora.merge_into(base, weights.adapters_from_jax(ad, 'cpu'), lcfg)
    adapted = set(ad)
    for (key, g), (_, w), (_, b) in zip(lora._flat(got), lora._flat(want),
                                        lora._flat(base)):
        if key in adapted:
            assert g.dtype == torch.float32 and g.shape == w.shape
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=TOL_MERGE,
                                       err_msg=key)
            assert not torch.equal(g, b), key
        else:
            assert g is b, key
            np.testing.assert_array_equal(g.numpy(), w, err_msg=key)
    if name == 'moe-debug':
        assert got['layers']['w_gate'].shape == (tcfg.n_layers,
                                                 tcfg.n_experts, tcfg.dim,
                                                 tcfg.ffn_dim)


def test_fresh_adapters_start_at_the_base_and_differentiate():
    _, tcfg, tree = tp.model('llama-debug')
    base = tp.port_params(tree, tcfg)
    lcfg = lora.LoRAConfig(rank=8)
    ad = lora.init_adapters(torch.Generator().manual_seed(3), base, lcfg)
    assert sorted(ad) == ['layers/wk', 'layers/wo', 'layers/wq', 'layers/wv']
    for key, ab in ad.items():
        assert ab['a'].dtype == ab['b'].dtype == torch.float32
        assert not ab['b'].any()
        assert ab['a'].shape == (tcfg.n_layers, tcfg.dim if key != 'layers/wo'
                                 else tcfg.n_heads * tcfg.hd, 8)
    a = torch.cat([ab['a'].reshape(-1) for ab in ad.values()])
    assert abs(float(a.std()) * lcfg.rank - 1.0) < 0.05     # N(0, 1) / r
    merged = lora.merge_into(base, ad, lcfg)
    jmerged = jax.device_get(jlora.merge_into(
        tp.jax_params(tree), weights.adapters_to_numpy(ad),
        jlora.LoRAConfig(rank=8)))
    for (_, m), (_, b), (_, j) in zip(lora._flat(merged), lora._flat(base),
                                      lora._flat(jmerged)):
        assert torch.equal(m, b)
        np.testing.assert_array_equal(np.asarray(j), b.numpy())
    # The merge is differentiable in the adapters, the base is not.
    state = lora.init_lora_state(torch.Generator().manual_seed(3), base,
                                 lcfg, _tx())
    assert all(t.requires_grad for t in train_lib.leaves(state.adapters))
    assert not any(t.requires_grad for t in train_lib.leaves(base))


def _jax_steps(jcfg, tree, ad, jlcfg, batches):
    jtx = _jtx()
    ad = jax.tree.map(jnp.asarray, ad)
    state = jlora.LoRAState(step=jnp.zeros((), jnp.int32), adapters=ad,
                            opt_state=jtx.init(ad))
    step = jlora.make_lora_train_step(jcfg, jmesh.single_device_mesh(), jtx,
                                      jlcfg)
    base = tp.jax_params(tree)
    out, states = [], []
    for tokens in batches:
        state, m = step(state, base, {'tokens': jnp.asarray(tokens)})
        out.append((float(m['loss']), float(m['grad_norm']),
                    float(m['tokens'])))
        states.append(jax.device_get(state))
    return out, states


def _port_steps(tcfg, tree, ad, lcfg, batches):
    tx = _tx()
    adapters = weights.adapters_from_jax(ad, 'cpu')
    for leaf in train_lib.leaves(adapters):
        leaf.requires_grad_(True)
    state = lora.LoRAState(step=0, adapters=adapters,
                           opt_state=tx.init(adapters))
    base = tp.port_params(tree, tcfg)
    step = lora.make_lora_train_step(tcfg, tx, lcfg)
    out, mu1 = [], None
    for tokens in batches:
        state, m = step(state, base, {'tokens': torch.from_numpy(tokens)})
        out.append((float(m['loss']), float(m['grad_norm']),
                    float(m['tokens'])))
        if mu1 is None:
            mu1 = weights.tree_unflatten(state.opt_state.mu, [
                t.clone() for t in train_lib.leaves(state.opt_state.mu)])
    for leaf in train_lib.leaves(base):
        assert not leaf.requires_grad
    return out, (mu1, state), base


def _opt_leaves(opt):
    return [np.asarray(leaf.detach() if isinstance(leaf, torch.Tensor)
                       else leaf) for _, leaf in weights.opt_state_leaves(opt)]


@pytest.fixture(scope='module', params=FAMILIES)
def three_steps(request):
    """Three LoRA steps of each package from the same base and the same
    fresh adapters (JAX's init_adapters: B = 0), lr 0 at the first step
    (the warmup): (name, lcfg, JAX out, the JAX host states after steps
    1 and 3, port out, the port's mu after step 1 and state after step
    3, the adapters before, the port's base)."""
    name = request.param
    jcfg, tcfg, tree = tp.model(name)
    lcfg, jlcfg = _lcfgs(name)
    ad = jax.device_get(jlora.init_adapters(jax.random.PRNGKey(1), tree,
                                            jlcfg))
    batches = [tp.batch(10), tp.batch(11), tp.batch(12)]
    jout, jstates = _jax_steps(jcfg, tree, ad, jlcfg, batches)
    pout, pstates, base = _port_steps(tcfg, tree, ad, lcfg, batches)
    return dict(name=name, lcfg=lcfg, tcfg=tcfg, jout=jout, jstates=jstates,
                pout=pout, pstates=pstates, ad=ad, base=base,
                batches=batches)


def test_fresh_b_gives_a_exactly_zero_first_grad(three_steps):
    """B = 0: the merged delta A B is 0 and A's grad (cotangent x B^T) is
    exactly 0 in both packages; the first loss is the base's own
    cross-entropy; B's grads agree."""
    r = three_steps
    tok = torch.from_numpy(r['batches'][0])
    with torch.no_grad():
        logits, _ = train_lib.forward_with_aux(r['tcfg'], r['base'],
                                               tok[:, :-1])
        ce = float(train_lib.cross_entropy_loss(logits, tok[:, 1:])[0])
    assert r['pout'][0][0] == ce
    mu, jmu = r['pstates'][0], r['jstates'][0].opt_state[1][0].mu
    for key in r['ad']:
        assert not mu[key]['a'].any() and not np.asarray(jmu[key]['a']).any()
        want = np.asarray(jmu[key]['b'])
        np.testing.assert_allclose(
            mu[key]['b'].numpy(), want, rtol=0,
            atol=TOL_GRAD * float(np.abs(want).max()))


def test_lora_steps_match_jax(three_steps):
    r = three_steps
    for (gl, gg, gt), (wl, wg, wt) in zip(r['pout'], r['jout']):
        np.testing.assert_allclose(gl, wl, rtol=TOL_REL)
        np.testing.assert_allclose(gg, wg, rtol=TOL_REL)
        assert gt == wt
    jstate, pstate = r['jstates'][-1], r['pstates'][-1]
    jl = [np.asarray(x) for x in jax.tree.leaves(jstate.opt_state)]
    pl = _opt_leaves(pstate.opt_state)
    assert len(jl) == len(pl) and int(pl[0]) == int(jl[0]) == 3
    n = (len(pl) - 2) // 2
    for got, want in zip(pl[1:1 + n], jl[1:1 + n]):      # mu: the grads
        scale = float(np.abs(want).max())
        assert scale > 0
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL_GRAD * scale)
    for got, want in zip(pl[1 + n:-1], jl[1 + n:-1]):    # nu
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-12)
    # The adapters after the updates (lr > 0 from step 2): tight where
    # the grad is well above rounding, within 2.2 lr elsewhere.
    for key, ab in pstate.adapters.items():
        for part in ('a', 'b'):
            got = ab[part].detach().numpy()
            want = np.asarray(jstate.adapters[key][part])
            g = np.asarray(jstate.opt_state[1][0].mu[key][part])
            well = np.abs(g) >= WELL * np.abs(g).max()
            assert well.mean() > 0.5
            err = np.abs(got - want)
            assert err[well].max() <= TOL_UPDATE * LR * 2, key
            assert err.max() <= 2.2 * LR, key
            assert not np.array_equal(got, r['ad'][key][part]), key


def _assert_moments_restored(opt_leaves_got, opt_leaves_want):
    assert len(opt_leaves_got) == len(opt_leaves_want)
    for got, want in zip(opt_leaves_got, opt_leaves_want):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    n = (len(opt_leaves_got) - 2) // 2
    assert int(opt_leaves_got[0]) == int(opt_leaves_got[-1]) == 3
    assert all(np.abs(m).max() > 0 for m in opt_leaves_got[1:1 + n])


def test_adapters_npz_jax_to_port(three_steps, tmp_path):
    """JAX save_adapters → the port's load_adapters / restore_opt_state:
    the adapters, step and moments as saved (a fresh tx.init would give
    zero moments and count 0)."""
    lcfg, jstate = three_steps['lcfg'], three_steps['jstates'][-1]
    jlcfg = jlora.LoRAConfig(rank=lcfg.rank, targets=lcfg.targets)
    jlora.save_adapters(str(tmp_path), jstate, jlcfg)
    adapters, got_lcfg, step, opt_leaves = lora.load_adapters(str(tmp_path))
    assert got_lcfg == lcfg and step == 3
    for key, ab in adapters.items():
        for part in ('a', 'b'):
            np.testing.assert_array_equal(ab[part].numpy(),
                                          np.asarray(jstate.adapters[key][part]))
    opt = lora.restore_opt_state(_tx(), adapters, opt_leaves)
    _assert_moments_restored(_opt_leaves(opt),
                             jax.tree.leaves(jstate.opt_state))
    state = lora.resume_state(_tx(), str(tmp_path), lcfg, 'cpu')
    assert state.step == 3 and state.opt_state.count == 3
    with pytest.raises(ValueError, match='holds rank=4'):
        lora.resume_state(_tx(), str(tmp_path),
                          dataclasses.replace(lcfg, rank=8), 'cpu')


def test_adapters_npz_port_to_jax(three_steps, tmp_path):
    lcfg, pstate = three_steps['lcfg'], three_steps['pstates'][-1]
    lora.save_adapters(str(tmp_path), pstate, lcfg)
    assert sorted(os.listdir(tmp_path)) == ['adapters.npz', 'lora.json']
    adapters, jlcfg, step, opt_leaves = jlora.load_adapters(str(tmp_path))
    assert (jlcfg.rank, jlcfg.alpha, jlcfg.targets) == (
        lcfg.rank, lcfg.alpha, lcfg.targets) and step == 3
    opt = jlora.restore_opt_state(_jtx(), adapters, opt_leaves)
    _assert_moments_restored(jax.tree.leaves(opt),
                             _opt_leaves(pstate.opt_state))
    for key, ab in pstate.adapters.items():
        for part in ('a', 'b'):
            np.testing.assert_array_equal(np.asarray(adapters[key][part]),
                                          ab[part].detach().numpy())


def test_restore_opt_state_falls_back_only_on_a_shape_change(caplog):
    _, tcfg, tree = tp.model('llama-debug')
    base = tp.port_params(tree, tcfg)
    lcfg = lora.LoRAConfig(rank=2)
    state = lora.init_lora_state(torch.Generator().manual_seed(0), base,
                                 lcfg, _tx())
    state.opt_state.count = 5
    leaves = _opt_leaves(state.opt_state)
    other = lora.init_adapters(torch.Generator().manual_seed(0), base,
                               lora.LoRAConfig(rank=3))
    fresh = lora.restore_opt_state(_tx(), other, leaves)
    assert fresh.count == 0 and 'do not fit' in caplog.text
    assert lora.restore_opt_state(_tx(), state.adapters, leaves).count == 5
    leaves[-1] = np.asarray(4, np.int32)
    with pytest.raises(ValueError, match='counts disagree'):
        lora.restore_opt_state(_tx(), state.adapters, leaves)


# --- The trainer's LoRA branch -----------------------------------------

def _argv(tmp_path, steps, *extra):
    return ['--model', 'llama-debug', '--batch-size', '2', '--seq-len', '8',
            '--steps', str(steps), '--log-every', '1', '--lr', '1e-2',
            '--lora-rank', '4', '--device', 'cpu', *extra]


def _records(caplog, argv):
    caplog.clear()
    with caplog.at_level('INFO', logger=trainer.logger.name):
        trainer.main(argv)
    return [json.loads(r.getMessage()) for r in caplog.records
            if r.name == trainer.logger.name and
            r.getMessage().startswith('{')]


def test_trainer_lora_saves_and_resumes_exactly(tmp_path, caplog):
    """4 steps at once against 2, a save, and a resume to 4 (the
    preset's seed-0 base, adapters from seed 1): the same losses, the
    same adapters bit for bit, the moments restored."""
    whole = tmp_path / 'whole'
    full = _records(caplog, _argv(tmp_path, 4, '--lora-dir', str(whole),
                                  '--ckpt-every', '2'))
    cut = tmp_path / 'cut'
    first = _records(caplog, _argv(tmp_path, 2, '--lora-dir', str(cut),
                                   '--ckpt-every', '2'))
    with open(cut / 'lora.json') as f:
        assert json.load(f)['step'] == 2
    rest = _records(caplog, _argv(tmp_path, 4, '--lora-dir', str(cut),
                                  '--ckpt-every', '2'))
    assert 'Resumed LoRA adapters at step 2' in caplog.text
    assert [r['step'] for r in first + rest] == [1, 2, 3, 4]
    assert [r['loss'] for r in first + rest] == [r['loss'] for r in full]
    a, _, step_a, opt_a = lora.load_adapters(str(whole))
    b, _, step_b, opt_b = lora.load_adapters(str(cut))
    assert step_a == step_b == 4
    for key in a:
        for part in ('a', 'b'):
            assert torch.equal(a[key][part], b[key][part])
    for x, y in zip(opt_a, opt_b):
        np.testing.assert_array_equal(x, y)


def test_trainer_lora_evaluates_the_merged_params(tmp_path, caplog,
                                                  monkeypatch):
    corpus = tmp_path / 'corpus.txt'
    corpus.write_text('the quick brown fox jumps over the lazy dog. ' * 100)
    seen = []
    real = train_lib.make_eval_step

    def spy(cfg, mesh=None):
        step = real(cfg, mesh)

        def wrapped(params, batch):
            seen.append(params['layers']['wq'])
            return step(params, batch)
        return wrapped
    monkeypatch.setattr(train_lib, 'make_eval_step', spy)
    recs = _records(caplog, _argv(tmp_path, 2, '--eval-data', str(corpus),
                                  '--eval-every', '2', '--eval-batches', '1',
                                  '--lora-dir', str(tmp_path / 'ad')))
    assert np.isfinite(recs[-1]['eval_loss'])
    base = llama.init_params(config.get_config('llama-debug'),
                             torch.Generator().manual_seed(0), 'cpu')
    adapters, lcfg, _, _ = lora.load_adapters(str(tmp_path / 'ad'))
    want = lora.merge_into(base, adapters, lcfg)['layers']['wq']
    assert len(seen) == 1 and torch.equal(seen[0], want)
    assert not torch.equal(want, base['layers']['wq'])


@pytest.mark.parametrize('extra,match', [
    (['--ckpt-dir', 'ck'], '--lora-rank and --ckpt-dir are exclusive'),
    (['--grad-accum', '2'], '--grad-accum is not supported with --lora-rank'),
])
def test_trainer_lora_exclusivity_errors(tmp_path, extra, match):
    with pytest.raises(ValueError, match=match):
        trainer.main(_argv(tmp_path, 1, *extra))


def test_trainer_lora_resume_refuses_another_config(tmp_path):
    trainer.main(_argv(tmp_path, 1, '--lora-dir', str(tmp_path)))
    with pytest.raises(ValueError, match='holds rank=4 .*requested rank=4 '
                       'alpha=32.0 targets=\\(\'wq\',\\)'):
        trainer.main(_argv(tmp_path, 2, '--lora-dir', str(tmp_path),
                           '--lora-targets', 'wq'))


# --- lora_merge ----------------------------------------------------------

def _bf16_hf_dir(path):
    """A tiny bf16 HF checkpoint of llama-debug's shapes (random, seed 4)
    with a generation_config.json sidecar."""
    cfg = dataclasses.replace(config.get_config('llama-debug'),
                              tie_embeddings=False)
    params = llama.init_params(cfg, torch.Generator().manual_seed(4), 'cpu',
                               dtype=torch.bfloat16)
    hf_export.save_hf_checkpoint(params, cfg, str(path))
    with open(os.path.join(str(path), 'generation_config.json'), 'w') as f:
        json.dump({'eos_token_id': 3}, f)
    return hf_import.load_hf_checkpoint(str(path))


def test_lora_merge_matches_jax_lora_merge(tmp_path, monkeypatch):
    hf = tmp_path / 'hf'
    cfg, base = _bf16_hf_dir(hf)
    lcfg = lora.LoRAConfig(rank=4, alpha=16.0, targets=('wq', 'wv', 'w_up'))
    host = {k: ({n: t.float().numpy() for n, t in v.items()}
                if isinstance(v, dict) else v.float().numpy())
            for k, v in base.items()}
    ad = weights.adapters_from_jax(_np_adapters(host, lcfg, seed=5,
                                                b_std=0.05), 'cpu')
    tx = _tx()
    lora.save_adapters(str(tmp_path / 'ad'), lora.LoRAState(
        step=7, adapters=ad, opt_state=tx.init(ad)), lcfg)
    lora_merge.main(['--hf-dir', str(hf), '--lora-dir', str(tmp_path / 'ad'),
                     '--out', str(tmp_path / 'mine'), '--device', 'cpu'])
    monkeypatch.setattr(sys, 'argv', [
        'lora_merge', '--hf-dir', str(hf), '--lora-dir', str(tmp_path / 'ad'),
        '--out', str(tmp_path / 'theirs')])
    jlora_merge.main()
    for name in ('config.json', 'generation_config.json'):
        assert (tmp_path / 'mine' / name).read_text() == \
            (hf / name).read_text()
    mine = safetensors_io.load_file(str(tmp_path / 'mine' /
                                        'model.safetensors'))
    theirs = safetensors_io.load_file(str(tmp_path / 'theirs' /
                                          'model.safetensors'))
    src = safetensors_io.load_file(str(hf / 'model.safetensors'))
    assert sorted(mine) == sorted(theirs) == sorted(src)
    changed = 0
    for key, t in mine.items():
        assert t.dtype == theirs[key].dtype == torch.bfloat16, key
        bits = (t.view(torch.int16).int() - theirs[key].view(torch.int16)
                .int()).abs()
        assert int(bits.max()) <= 1, key
        adapted = any(f'.{n}.' in key for n in ('q_proj', 'v_proj', 'up_proj'))
        if adapted:
            changed += int(not torch.equal(t, src[key]))
        else:
            assert torch.equal(t, src[key]) and torch.equal(theirs[key],
                                                            src[key]), key
    assert changed == 3 * cfg.n_layers
    # The merged directory re-imports to the in-process merge, bit for bit.
    _, back = hf_import.load_hf_checkpoint(str(tmp_path / 'mine'))
    with torch.no_grad():
        want = lora.merge_into(base, ad, lcfg)
    for (k, g), (_, w) in zip(lora._flat(back), lora._flat(want)):
        assert torch.equal(g, w), k


def test_lora_merge_refuses_a_non_dense_family_before_reading_weights(
        tmp_path):
    with open(tmp_path / 'config.json', 'w') as f:
        json.dump({'architectures': ['MixtralForCausalLM'],
                   'model_type': 'mixtral', 'vocab_size': 256,
                   'hidden_size': 64, 'intermediate_size': 128,
                   'num_hidden_layers': 2, 'num_attention_heads': 4,
                   'num_key_value_heads': 2, 'num_local_experts': 4,
                   'num_experts_per_tok': 2}, f)
    with pytest.raises(SystemExit, match='dense Llama/Qwen2 family only'):
        lora_merge.merge(str(tmp_path), str(tmp_path / 'ad'),
                         str(tmp_path / 'out'), device='cpu')


def test_lora_merge_runs_on_the_card_unless_asked(monkeypatch, tmp_path):
    assert lora_merge.build_parser().parse_args(
        ['--hf-dir', 'a', '--lora-dir', 'b', '--out', 'c']).device == 'cuda'
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        lora_merge.main(['--hf-dir', str(tmp_path), '--lora-dir', 'b',
                         '--out', 'c'])
