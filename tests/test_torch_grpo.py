"""GRPO in the port (train/grpo.py) against the JAX package on the CPU,
and the port's trainer on its own.

The math (token_logprobs through a fixed-logits module, completion_mask,
group_advantages, the rewards) is held against JAX on numpy inputs from
a seed. The update is held on fixed rollouts: the port's GRPOTrainer
rolls out (packed ragged rows) on JAX ``init_params`` weights of
llama-debug, or moe-debug (its router aux in the loss), in fp32
(tests/torch_train_parity.py), and both packages' ``make_grpo_update``
(JAX's ``mesh=None`` path) take that batch, its behaviour log-probs
pushed off the policy's by seeded noise so that ratios clip, and a
noisy reference for the KL term. Sampling is not compared: the two
packages' RNGs draw differently.

Tolerances:
  - token_logprobs on fixed logits: 1e-6 relative and absolute (one
    fp32 ulp at |lp| ~ 16 is 1.9e-6); group_advantages: 1e-6 absolute;
    completion_mask and the rewards: exact;
  - token_logprobs through the fp32 model: 2e-5 absolute (a few layers
    of fp32 products summed in other orders, then a logsumexp over the
    vocabulary);
  - the update: loss, mean_ratio, frac_clipped and grad_norm within
    1e-5 relative; the grads, read from the first moments (mu = 0.1 g
    after the first step), within 1e-5 of the leaf's largest |g|;
  - the port's seeded replay: bit-equal; the first iteration's
    mean_ratio on ragged prompts: 1 within 1e-3, as JAX pins it.
"""
import dataclasses
import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_train_parity as tp
from skypilot_tpu import models as jmodels
from skypilot_tpu.train import grpo as jgrpo
from skypilot_tpu.train import train_lib as jtrain_lib
from skypilot_tpu_torch import config
from skypilot_tpu_torch.models import module_for, weights
from skypilot_tpu_torch.train import checkpoints, grpo, train_lib

TOL_MATH = 1e-6
TOL_LP = 2e-5
TOL_REL = 1e-5
TOL_GRAD = 1e-5


class _FixedLogits:
    """A model module whose forward returns stored logits (numpy [B, L,
    V]) as the given package's array: the same logits for both
    packages' token_logprobs."""

    def __init__(self, logits, to_array, aux=None):
        self.logits, self.to_array, self.aux = logits, to_array, aux
        self.HAS_AUX = aux is not None

    def forward(self, params, tokens, cfg, return_aux=False):
        out = self.to_array(self.logits[:, :tokens.shape[1]])
        return (out, self.to_array(np.asarray(self.aux, np.float32))) \
            if return_aux else out


@pytest.mark.parametrize('temperature,aux', [(1.0, None), (0.7, 0.25)])
def test_token_logprobs_math_matches_jax(temperature, aux):
    rng = np.random.default_rng(0)
    logits = (3 * rng.standard_normal((3, 9, 50))).astype(np.float32)
    seq = rng.integers(0, 50, (3, 10)).astype(np.int32)
    lp, a = grpo.token_logprobs(
        None, torch.from_numpy(seq), None,
        _FixedLogits(logits, torch.from_numpy, aux), temperature)
    jlp, ja = jgrpo.token_logprobs(None, jnp.asarray(seq), None,
                                   _FixedLogits(logits, jnp.asarray, aux),
                                   temperature)
    assert lp.dtype == torch.float32 and lp.shape == (3, 9)
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), rtol=TOL_MATH,
                               atol=TOL_MATH)
    assert float(a) == float(ja) == (aux or 0.0)


def test_completion_mask_and_group_advantages_match_jax():
    rng = np.random.default_rng(1)
    comp = rng.integers(0, 6, (16, 7)).astype(np.int32)
    comp[0, 0] = 5
    comp[1] = 1                            # no EOS
    for eos in (5, 1, None):
        got = grpo.completion_mask(torch.from_numpy(comp), eos)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jgrpo.completion_mask(jnp.asarray(comp),
                                                          eos)))
    assert grpo.completion_mask(torch.zeros((2, 0), dtype=torch.int32),
                                5).shape == (2, 0)
    for g in (2, 4, 8):
        r = rng.normal(size=(16,)).astype(np.float32)
        r[:g] = 3.0                        # a zero-variance group
        got = grpo.group_advantages(torch.from_numpy(r), g)
        want = np.asarray(jgrpo.group_advantages(jnp.asarray(r), g))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL_MATH)
        assert not got[:g].any()


def test_rewards_match_jax():
    rng = np.random.default_rng(2)
    for _ in range(20):
        prompt = rng.integers(0, 8, 5)
        comp = rng.integers(0, 8, 9)
        for spec, eos in (('count_token:3', None), ('length', 7)):
            assert grpo.resolve_reward(spec, eos)(prompt, comp) == \
                jgrpo.resolve_reward(spec, eos)(prompt, comp)
    fn = grpo.resolve_reward('numpy:mean', None)
    assert fn is np.mean
    with pytest.raises(ValueError, match='needs --eos-id'):
        grpo.resolve_reward('length', None)
    with pytest.raises(ValueError, match='Unknown reward'):
        grpo.resolve_reward('nonsense', None)


def _trainer(name='llama-debug', fp32=True, **kw):
    """A port GRPOTrainer on the CPU: the fp32 JAX-init weights of
    tests/torch_train_parity.py (bridged), or the preset's own init."""
    gcfg = grpo.GRPOConfig(**{'group_size': 4, 'max_new_tokens': 6,
                              **kw.pop('gcfg', {})})
    if fp32:
        _, tcfg, tree = tp.model(name)
        kw['init_params'] = tp.port_params(tree, tcfg)
    else:
        tcfg = config.get_config(name)
    kw.setdefault('reward_fn', grpo.count_token_reward(3))
    return grpo.GRPOTrainer(tcfg, gcfg, device='cpu', **kw)


RAGGED = dict(prompts=np.random.default_rng(5).integers(
    1, 256, (2, 12)).astype(np.int32), lens=np.asarray([7, 12], np.int32))


@pytest.fixture(scope='module')
def rollouts():
    """name → (trainer, a packed ragged rollout at temperature 0.8), made
    once per preset."""
    made = {}

    def get(name):
        if name not in made:
            tr = _trainer(name, gcfg={'temperature': 0.8}, seed=4)
            made[name] = tr, tr.rollout(torch.from_numpy(RAGGED['prompts']),
                                        torch.from_numpy(RAGGED['lens']))
        return made[name]
    return get


@pytest.mark.parametrize('name', ['llama-debug', 'moe-debug'])
def test_rollout_packs_ragged_rows_at_their_sampled_positions(rollouts,
                                                              name):
    tr, ro = rollouts(name)
    g, t = tr.gcfg.group_size, tr.gcfg.max_new_tokens
    assert ro.seq.shape == (2 * g, 12 + t) and ro.comp_idx.shape == (2 * g, t)
    for i in range(2 * g):
        li = int(RAGGED['lens'][i // g])
        np.testing.assert_array_equal(ro.seq[i, :li].numpy(),
                                      RAGGED['prompts'][i // g, :li])
        assert torch.equal(ro.seq[i, li:li + t], ro.completions[i].long()
                           .to(ro.seq.dtype))
        assert ro.comp_idx[i].tolist() == list(range(li - 1, li - 1 + t))
    assert ro.ref_lp is None and torch.equal(ro.mask, torch.ones_like(ro.mask))
    if name != 'llama-debug':
        return      # moe-debug's forward is held against JAX by the update
    # The behaviour log-probs against JAX's token_logprobs on the same
    # packed rows and weights.
    jcfg, _, tree = tp.model(name)
    jlp, _ = jgrpo.token_logprobs(tp.jax_params(tree), jnp.asarray(
        ro.seq.numpy()), jcfg, jmodels.module_for(jcfg), 0.8)
    want = np.take_along_axis(np.asarray(jlp), ro.comp_idx.numpy(), axis=1)
    np.testing.assert_allclose(ro.behavior_lp.numpy(), want, rtol=0,
                               atol=TOL_LP)


@pytest.mark.parametrize('name,use_ref', [('llama-debug', True),
                                          ('moe-debug', False)])
def test_update_on_fixed_rollouts_matches_jax(rollouts, name, use_ref):
    tr, ro = rollouts(name)
    jcfg, tcfg, tree = tp.model(name)
    rng = np.random.default_rng(6)
    n, t = ro.behavior_lp.shape
    behavior = ro.behavior_lp.numpy() + (0.3 * rng.standard_normal(
        (n, t))).astype(np.float32)
    ref = ro.behavior_lp.numpy() + (0.2 * rng.standard_normal(
        (n, t))).astype(np.float32) if use_ref else None
    adv = rng.standard_normal(n).astype(np.float32)
    mask = np.ones((n, t), np.float32)
    mask[::3, 4:] = 0
    gcfg = dataclasses.replace(tr.gcfg, kl_coef=0.1 if use_ref else 0.0)

    jtx = jtrain_lib.default_optimizer(learning_rate=1e-3, warmup_steps=1,
                                       total_steps=10)
    jparams = tp.jax_params(tree)
    jstate = jtrain_lib.TrainState(step=jnp.zeros((), jnp.int32),
                                   params=jparams,
                                   opt_state=jtx.init(jparams))
    jupdate = jgrpo.make_grpo_update(jcfg, None, jtx, gcfg,
                                     jmodels.module_for(jcfg),
                                     use_ref=use_ref)
    jstate, jm = jupdate(jstate, jnp.asarray(ro.seq.numpy()),
                         jnp.asarray(ro.comp_idx.numpy(), jnp.int32),
                         jnp.asarray(behavior), jnp.asarray(adv),
                         jnp.asarray(mask),
                         None if ref is None else jnp.asarray(ref))

    tx = train_lib.default_optimizer(learning_rate=1e-3, warmup_steps=1,
                                     total_steps=10)
    state = train_lib.init_train_state(tcfg, tx, 'cpu',
                                       params=tp.port_params(tree, tcfg))
    update = grpo.make_grpo_update(tcfg, tx, gcfg, module_for(tcfg),
                                   use_ref=use_ref)
    state, m = update(state, ro.seq, ro.comp_idx, torch.from_numpy(behavior),
                      torch.from_numpy(adv), torch.from_numpy(mask),
                      None if ref is None else torch.from_numpy(ref))
    for key in ('loss', 'grad_norm', 'mean_ratio', 'frac_clipped'):
        np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                   rtol=TOL_REL, err_msg=key)
    assert 0.1 < float(m['frac_clipped']) < 0.9
    assert state.step == 1 and state.opt_state.count == 1
    jmu = jax.tree.leaves(jax.device_get(jstate.opt_state[1][0].mu))
    mu = train_lib.leaves(state.opt_state.mu)
    assert len(jmu) == len(mu)
    for got, want in zip(mu, jmu):
        scale = float(np.abs(want).max())
        assert scale > 0
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=TOL_GRAD * scale)


def _replay():
    """Two seeded iterations of the port's trainer (a KL reference): each
    iteration's metrics and the final params."""
    tr = _trainer(seed=0, gcfg={'kl_coef': 0.05},
                  tx=train_lib.default_optimizer(learning_rate=1e-3,
                                                 warmup_steps=1,
                                                 total_steps=10))
    out = []
    for i in range(2):
        prompts = torch.randint(0, 256, (2, 8), dtype=torch.int32,
                                generator=torch.Generator().manual_seed(100 + i))
        out.append(tr.iteration(prompts))
    return out, tr


def test_seeded_rollout_update_sequence_is_bit_equal():
    first, tr1 = _replay()
    second, tr2 = _replay()
    assert first == second
    for a, b in zip(train_lib.leaves(tr1.state.params),
                    train_lib.leaves(tr2.state.params)):
        assert torch.equal(a, b)
    # The reference is a real copy: the policy moved, the reference not.
    _, tcfg, tree = tp.model('llama-debug')
    init = tp.port_params(tree, tcfg)
    for p, r, i in zip(train_lib.leaves(tr1.state.params),
                       train_lib.leaves(tr1._ref_params),
                       train_lib.leaves(init)):
        assert torch.equal(r, i)
    assert any(not torch.equal(p, i) for p, i in zip(
        train_lib.leaves(tr1.state.params), train_lib.leaves(init)))


def test_ragged_prompts_ratio_is_one_at_first_step():
    tr = _trainer(seed=3, gcfg={'temperature': 0.7},
                  reward_fn=grpo.count_token_reward(1))
    m = tr.iteration(torch.from_numpy(RAGGED['prompts']),
                     prompt_lengths=torch.from_numpy(RAGGED['lens']))
    assert m['mean_ratio'] == pytest.approx(1.0, abs=1e-3), m
    for key in ('loss', 'mean_ratio', 'frac_clipped', 'mean_reward',
                'grad_norm', 'mean_completion_len'):
        assert np.isfinite(m[key]), key


def test_policy_learns_to_emit_rewarded_token():
    """Rewarding one token id raises its share of the completions (the
    JAX package's learning test, at 8 iterations and a larger lr: the
    share rises from under 0.02 by more than 0.1)."""
    tr = _trainer(seed=0, reward_fn=grpo.count_token_reward(42),
                  gcfg={'group_size': 8, 'max_new_tokens': 8},
                  tx=train_lib.default_optimizer(learning_rate=2e-2,
                                                 warmup_steps=1,
                                                 total_steps=200))
    prompts = torch.randint(0, 256, (2, 8), dtype=torch.int32,
                            generator=torch.Generator().manual_seed(7))
    rewards = [tr.iteration(prompts)['mean_reward'] for _ in range(8)]
    assert np.mean(rewards[:3]) < 0.02, rewards
    assert np.mean(rewards[-3:]) > np.mean(rewards[:3]) + 0.1, rewards


# --- The CLI -------------------------------------------------------------

def _sigterm_reward(prompt, completion) -> float:
    """A reward that delivers a preemption notice to its own process."""
    os.kill(os.getpid(), signal.SIGTERM)
    return 0.0


def _main(caplog, *argv):
    caplog.clear()
    with caplog.at_level('INFO', logger=grpo.logger.name):
        grpo.main(['--model', 'llama-debug', '--batch-prompts', '2',
                   '--prompt-len', '8', '--group-size', '4',
                   '--max-new-tokens', '4', '--lr', '1e-3', '--device', 'cpu',
                   *argv])
    return [json.loads(r.getMessage()) for r in caplog.records
            if r.name == grpo.logger.name and r.getMessage().startswith('{')]


def test_main_resumes_from_its_checkpoint_and_saves_on_preemption(
        tmp_path, caplog, monkeypatch):
    ck = str(tmp_path / 'ck')
    seen = []
    real = grpo.GRPOTrainer.iteration

    def spy(self, prompts, prompt_lengths=None):
        seen.append(prompts.clone())
        return real(self, prompts, prompt_lengths)
    monkeypatch.setattr(grpo.GRPOTrainer, 'iteration', spy)
    recs = _main(caplog, '--reward', 'count_token:3', '--iterations', '2',
                 '--ckpt-dir', ck, '--ckpt-every', '1')
    assert [r['iter'] for r in recs] == [1, 2]
    assert checkpoints.Checkpointer(ck).all_steps() == [1, 2]
    recs = _main(caplog, '--reward', 'count_token:3', '--iterations', '3',
                 '--ckpt-dir', ck, '--ckpt-every', '1')
    assert 'Resumed GRPO policy at iteration 2' in caplog.text
    assert [r['iter'] for r in recs] == [3]
    # Iteration 3's prompts are the stream's third batch, resumed or not.
    assert len(seen) == 3
    want = torch.randint(0, 256, (2, 8), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(1002))
    assert torch.equal(seen[2], want) and not torch.equal(seen[1], want)
    assert checkpoints.Checkpointer(ck).latest_step() == 3
    # A preemption notice during iteration 4: one synchronous final save.
    recs = _main(caplog, '--reward', 'test_torch_grpo:_sigterm_reward',
                 '--iterations', '9', '--ckpt-dir', ck, '--ckpt-every', '5')
    assert recs[-1] == {'iter': 4, 'preempted': True,
                        'final_checkpoint': True}
    assert checkpoints.Checkpointer(ck).latest_step() == 4


def test_main_reads_prompts_jsonl(tmp_path, caplog):
    path = tmp_path / 'prompts.jsonl'
    path.write_text('\n'.join(json.dumps({'tokens': list(range(1, n))})
                              for n in (5, 9, 7)) + '\n')
    batches = grpo.prompt_batches(str(path), 2, 8, 256)
    arr, lens = next(batches)
    assert lens.tolist() == [4, 8] and arr.shape == (2, 8)
    assert arr[0].tolist() == [1, 2, 3, 4, 0, 0, 0, 0]
    assert next(batches)[1].tolist() == [4, 8]       # the odd row skipped
    recs = _main(caplog, '--reward', 'length', '--eos-id', '2',
                 '--iterations', '1', '--prompts', str(path))
    assert recs[0]['iter'] == 1 and 'trailing prompt' in caplog.text
    with pytest.raises(ValueError, match='--prompts has 3 rows'):
        next(grpo.prompt_batches(str(path), 4, 8, 256))


def test_main_runs_on_the_card_unless_asked_and_refuses_a_mesh(
        monkeypatch, caplog):
    args = grpo.build_parser().parse_args(['--reward', 'length'])
    assert args.device == 'cuda'
    with pytest.raises(NotImplementedError, match='--mesh.*ROADMAP'):
        _main(caplog, '--reward', 'length', '--mesh', 'data=2')
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        grpo.main(['--reward', 'count_token:1', '--iterations', '1'])
    with pytest.raises(RuntimeError, match='no CUDA device'):
        grpo.GRPOTrainer(config.get_config('llama-debug'), grpo.GRPOConfig(),
                         grpo.count_token_reward(1))
