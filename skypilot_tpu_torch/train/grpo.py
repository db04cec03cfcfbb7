"""GRPO reinforcement-learning fine-tuning in the port (port of
skypilot_tpu/train/grpo.py, on one card or the CPU; the reference
launches verl, SkyRL and NeMo-RL recipes for this).

GRPO (group-relative policy optimization):
  - G rollouts per prompt; advantage = (r - mean_group) / (std_group +
    eps): no value network, the group is the baseline;
  - a clipped importance-ratio surrogate over completion tokens only;
  - an optional KL penalty against the frozen initial policy (the k3
    estimator exp(d) - d - 1, d = logp_ref - logp), added per token.

Rollouts go through the contiguous-cache ``generate`` of
models/decode.py (models/mla.py's for an MLAConfig), from a compute
cast of the fp32 policy made anew each iteration
(``decode.cast_params_for_compute``: the same bits as casting at use,
as JAX's generate on the fp32 policy), so rollout i + 1 samples from
the policy the update i left; the prefill runs kernel A on the card.
Behaviour and reference log-probs and the update run the family's
forward (A in the forward, C and D in the update's backward) on the
fp32 masters, and the port's AdamW (train/train_lib.py) moves them in
place. Ragged prompt rows are packed (prompt then completion at the
row's own length) so completions are scored at the positions they were
sampled at.

    python -m skypilot_tpu_torch.train.grpo --model llama-debug \\
        --reward count_token:42 --iterations 5 --device cpu

Not ported: the mesh (``--mesh`` is refused by name, ROADMAP Queue 1
item 8), and the harvested-RL learner and workers that call this module
(train/rollout in the JAX package).
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import logging
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from skypilot_tpu_torch import config
from skypilot_tpu_torch.models import decode, mla, module_for, weights
from skypilot_tpu_torch.train import train_lib

logger = logging.getLogger('skypilot_tpu_torch.train.grpo')


@dataclasses.dataclass(frozen=True)
class GRPOConfig:
    group_size: int = 8           # rollouts per prompt (G)
    max_new_tokens: int = 32      # completion length (T, static)
    temperature: float = 1.0      # rollout sampling temperature
    clip_eps: float = 0.2         # PPO ratio clip
    kl_coef: float = 0.0          # β for the k3 KL penalty (0 = off)
    inner_steps: int = 1          # optimizer updates per rollout batch
    adv_eps: float = 1e-4         # group-std floor


# A reward maps (prompt tokens [S], completion tokens [T]) → float, on
# the host (numpy int arrays). Completion tokens after the first EOS
# arrive as EOS fill from generate.
RewardFn = Callable[[Any, Any], float]


def token_logprobs(params, seq: torch.Tensor, cfg: config.LlamaConfig, mod,
                   temperature: float = 1.0
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(log-prob of each next token, router aux loss) under the policy:
    [B, L-1] fp32, entry t scoring seq[:, t+1] given seq[:, :t+1]. The
    logits are divided by the rollout temperature, so the ratio scores
    tokens under the distribution they were sampled from. aux is the
    MoE load-balance loss of a ``HAS_AUX`` module, else 0."""
    if getattr(mod, 'HAS_AUX', False):
        logits, aux = mod.forward(params, seq[:, :-1], cfg, return_aux=True)
    else:
        logits, aux = mod.forward(params, seq[:, :-1], cfg), 0.0
    logits = logits.float()
    if temperature != 1.0:      # x / 1 is x: no second [B, L, V] copy
        logits = logits / temperature
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, seq[:, 1:, None].long())[..., 0]
    return gold - logz, torch.as_tensor(aux, dtype=torch.float32,
                                        device=logz.device)


def completion_mask(completions: torch.Tensor,
                    eos_id: Optional[int]) -> torch.Tensor:
    """[B, T] float mask: tokens up to and including the first EOS
    (generate fills the slots after it with EOS)."""
    if eos_id is None:
        return torch.ones(completions.shape, dtype=torch.float32,
                          device=completions.device)
    is_eos = (completions == eos_id).to(torch.int32)
    after_eos = torch.cumsum(is_eos, dim=1) - is_eos
    return (after_eos == 0).float()


def group_advantages(rewards: torch.Tensor, group_size: int,
                     eps: float = 1e-4) -> torch.Tensor:
    """[B·G] rewards, group-major (prompt i owns rows i·G..(i+1)·G-1) →
    group-normalised advantages: population std, plus eps."""
    g = rewards.reshape(-1, group_size)
    mean = g.mean(dim=1, keepdim=True)
    std = g.std(dim=1, correction=0, keepdim=True)
    return ((g - mean) / (std + eps)).reshape(-1)


def grpo_loss(params, cfg: config.LlamaConfig, gcfg: GRPOConfig, mod, seq,
              comp_idx, behavior_lp, adv, mask, ref_lp=None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(loss, ratio, clipped ratio) of one update on a rollout batch:
    the clipped surrogate, with ``ref_lp`` the k3 KL against the
    reference, as a masked mean, plus the router aux. ``comp_idx`` [B,
    T] holds each row's completion positions in the [L-1] log-prob grid
    (rows are packed)."""
    lp_full, aux = token_logprobs(params, seq, cfg, mod, gcfg.temperature)
    lp = lp_full.gather(1, comp_idx.long())
    del lp_full
    ratio = torch.exp(lp - behavior_lp)
    clipped = ratio.clamp(1.0 - gcfg.clip_eps, 1.0 + gcfg.clip_eps)
    surr = torch.minimum(ratio * adv[:, None], clipped * adv[:, None])
    loss_tok = -surr
    if ref_lp is not None:
        # k3 estimator of KL(policy || ref): unbiased, positive.
        delta = ref_lp - lp
        loss_tok = loss_tok + gcfg.kl_coef * (torch.exp(delta) - delta - 1.0)
    denom = mask.sum().clamp(min=1.0)
    # aux keeps the MoE router's load-balancing pressure, as in the
    # supervised step.
    return (loss_tok * mask).sum() / denom + aux, ratio, clipped


def make_grpo_update(cfg: config.LlamaConfig, tx: train_lib.AdamW,
                     gcfg: GRPOConfig, mod, use_ref: bool = False
                     ) -> Callable[..., Tuple[train_lib.TrainState,
                                              Dict[str, torch.Tensor]]]:
    """(state, seq, comp_idx, behavior_lp, adv, mask, ref_lp=None) →
    (state, metrics): grpo_loss's grads through the optimizer; the state
    moves on in place. Metrics (0-d tensors): loss, grad_norm (of the
    unclipped grads), mean_ratio and frac_clipped over the mask. The
    JAX package's ``mesh=None`` path."""

    def update(state: train_lib.TrainState, seq, comp_idx, behavior_lp,
               adv, mask, ref_lp=None):
        loss, ratio, clipped = grpo_loss(
            state.params, cfg, gcfg, mod, seq, comp_idx, behavior_lp, adv,
            mask, ref_lp if use_ref else None)
        grads = torch.autograd.grad(loss, train_lib.leaves(state.params))
        gnorm = tx.update(list(grads), state.opt_state, state.params)
        with torch.no_grad():
            denom = mask.sum().clamp(min=1.0)
            frac_clipped = (((ratio - clipped).abs() > 1e-9).float()
                            * mask).sum() / denom
            mean_ratio = (ratio * mask).sum() / denom
        state.step += 1
        return state, {'loss': loss.detach(), 'grad_norm': gnorm,
                       'mean_ratio': mean_ratio,
                       'frac_clipped': frac_clipped}

    return update


@dataclasses.dataclass
class Rollout:
    """One iteration's rollout batch, on the trainer's device: the packed
    sequences [B·G, S+T], completion positions, mask, rewards, group
    advantages, behaviour (and reference) log-probs of the completions."""
    seq: torch.Tensor
    comp_idx: torch.Tensor
    completions: torch.Tensor
    mask: torch.Tensor
    rewards: torch.Tensor
    adv: torch.Tensor
    behavior_lp: torch.Tensor
    ref_lp: Optional[torch.Tensor]


class GRPOTrainer:
    """Rollout → reward → group advantage → clipped update, iterated.

    ``init_params`` (fp32 masters, e.g. an HF checkpoint read in fp32)
    start the policy, else the config's random init from ``seed``; the
    rollouts draw from a torch.Generator seeded with ``seed``. With
    ``kl_coef > 0`` a real copy of the initial params is the reference.
    Runs on the card unless ``device='cpu'`` is asked for."""

    def __init__(self, cfg: config.LlamaConfig, gcfg: GRPOConfig,
                 reward_fn: RewardFn, tx: Optional[train_lib.AdamW] = None,
                 eos_id: Optional[int] = None, init_params=None,
                 seed: int = 0, device='cuda'):
        self.device = torch.device(device)
        if self.device.type == 'cuda' and not torch.cuda.is_available():
            raise RuntimeError('no CUDA device: GRPO runs on the card '
                               "unless device='cpu' is asked for")
        self.cfg, self.gcfg = cfg, gcfg
        self.mod = module_for(cfg)
        self.reward_fn = reward_fn
        self.eos_id = eos_id
        self.tx = tx or train_lib.default_optimizer(
            learning_rate=1e-5, warmup_steps=1, total_steps=10_000,
            max_grad_norm=1.0)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.state = train_lib.init_train_state(
            cfg, self.tx, self.device,
            generator=torch.Generator(device=self.device).manual_seed(seed),
            params=init_params)
        use_ref = gcfg.kl_coef > 0.0
        # A real copy: the update moves the policy's tensors in place.
        self._ref_params = weights.tree_unflatten(
            self.state.params, [t.detach().clone() for t in
                                train_lib.leaves(self.state.params)]
        ) if use_ref else None
        self._update = make_grpo_update(cfg, self.tx, gcfg, self.mod,
                                        use_ref=use_ref)

    @torch.no_grad()
    def rollout(self, prompts: torch.Tensor,
                prompt_lengths: Optional[torch.Tensor] = None) -> Rollout:
        """Sample G completions of each of the [B, S] prompts (group
        major) from the current policy, reward them on the host, pack
        the rows and score the completions under the policy (and the
        reference)."""
        cfg, gcfg, dev = self.cfg, self.gcfg, self.device
        b, s = prompts.shape
        g, t = gcfg.group_size, gcfg.max_new_tokens
        rep = prompts.to(dev).repeat_interleave(g, dim=0)
        rep_lens = (prompt_lengths.to(dev).repeat_interleave(g)
                    if prompt_lengths is not None else None)
        dec = mla if isinstance(cfg, config.MLAConfig) else decode
        gen = dec.generate(decode.cast_params_for_compute(self.state.params,
                                                          cfg),
                           rep, cfg, t, max_len=s + t,
                           temperature=gcfg.temperature, eos_id=self.eos_id,
                           prompt_lengths=rep_lens, generator=self.generator)
        # One bulk copy to the host: rewards and packing are per-row
        # host work.
        rep_np, gen_np = rep.cpu().numpy(), gen.cpu().numpy()
        if rep_lens is None:
            seq_np = np.concatenate([rep_np, gen_np], axis=1)
            comp_np = np.broadcast_to(np.arange(t) + s - 1, (b * g, t))
        else:
            # Pack ragged rows: prompt[:len] + completion, right-padded,
            # so completions keep the positions generate sampled them at
            # (a pad gap would shift RoPE and the conditioning).
            lens_np = rep_lens.cpu().numpy()
            seq_np = np.zeros((b * g, s + t), rep_np.dtype)
            comp_np = np.zeros((b * g, t), np.int64)
            for i in range(b * g):
                li = int(lens_np[i])
                seq_np[i, :li] = rep_np[i, :li]
                seq_np[i, li:li + t] = gen_np[i]
                comp_np[i] = np.arange(t) + li - 1
        seq = torch.from_numpy(np.ascontiguousarray(seq_np)).to(dev)
        comp_idx = torch.from_numpy(np.array(comp_np, np.int64)).to(dev)
        rewards = torch.tensor([self.reward_fn(rep_np[i], gen_np[i])
                                for i in range(b * g)], dtype=torch.float32,
                               device=dev)

        def scored(params):
            lp_full, _ = token_logprobs(params, seq, cfg, self.mod,
                                        gcfg.temperature)
            return lp_full.gather(1, comp_idx)
        return Rollout(
            seq=seq, comp_idx=comp_idx, completions=gen,
            mask=completion_mask(gen, self.eos_id), rewards=rewards,
            adv=group_advantages(rewards, g, gcfg.adv_eps),
            behavior_lp=scored(self.state.params),
            ref_lp=(scored(self._ref_params)
                    if self._ref_params is not None else None))

    def update(self, ro: Rollout) -> Dict[str, float]:
        """``inner_steps`` updates on one rollout batch; the last one's
        metrics, with the batch's mean reward and completion length."""
        metrics: Dict[str, float] = {}
        for _ in range(self.gcfg.inner_steps):
            self.state, m = self._update(self.state, ro.seq, ro.comp_idx,
                                         ro.behavior_lp, ro.adv, ro.mask,
                                         ro.ref_lp)
            metrics = {k: float(v) for k, v in m.items()}
        metrics['mean_reward'] = float(ro.rewards.mean())
        metrics['mean_completion_len'] = float(ro.mask.sum(1).mean())
        return metrics

    def iteration(self, prompts: torch.Tensor,
                  prompt_lengths: Optional[torch.Tensor] = None
                  ) -> Dict[str, float]:
        """One GRPO iteration on a [B, S] prompt batch (ragged rows with
        ``prompt_lengths`` [B]). Returns the metrics (loss, grad_norm,
        mean_ratio, frac_clipped, mean_reward, mean_completion_len)."""
        return self.update(self.rollout(prompts, prompt_lengths))


# Built-in rewards (demos and tests; real use passes a callable).

def count_token_reward(target_id: int) -> RewardFn:
    """Fraction of completion tokens equal to ``target_id``: a toy
    objective whose optimum is unambiguous."""
    def fn(prompt, completion) -> float:
        return float((np.asarray(completion) == target_id).mean())
    return fn


def length_reward(eos_id: int) -> RewardFn:
    """Fraction of the budget used before the first EOS (longer
    completions score higher, in [0, 1])."""
    def fn(prompt, completion) -> float:
        c = np.asarray(completion)
        hits = np.flatnonzero(c == eos_id)
        used = hits[0] if hits.size else c.shape[0]
        return float(used) / float(c.shape[0])
    return fn


def resolve_reward(spec: str, eos_id: Optional[int]) -> RewardFn:
    """CLI reward: 'count_token:ID', 'length', or 'module.path:function'
    (a callable taking (prompt, completion))."""
    if spec.startswith('count_token:'):
        return count_token_reward(int(spec.split(':', 1)[1]))
    if spec == 'length':
        if eos_id is None:
            raise ValueError("reward 'length' needs --eos-id")
        return length_reward(eos_id)
    if ':' in spec:
        mod_name, fn_name = spec.rsplit(':', 1)
        return getattr(importlib.import_module(mod_name), fn_name)
    raise ValueError(f'Unknown reward {spec!r}: use count_token:ID, length, '
                     f'or module.path:function')


def prompt_batches(path: Optional[str], batch_prompts: int, prompt_len: int,
                   vocab_size: int
                   ) -> Iterator[Tuple[torch.Tensor, Optional[torch.Tensor]]]:
    """The CLI's prompt stream, on the host: batches of ``path``'s JSONL
    rows ({"tokens": [...]}, right-padded, with their lengths), cycled;
    else random prompts, batch i drawn from seed 1000 + i, so that
    batch i is a pure function of i (a resumed run fast-forwards)."""
    if path is None:
        i = 0
        while True:
            gen = torch.Generator().manual_seed(1000 + i)
            yield torch.randint(0, vocab_size, (batch_prompts, prompt_len),
                                generator=gen, dtype=torch.int32), None
            i += 1
    with open(path, 'r', encoding='utf-8') as f:
        rows: List[List[int]] = [json.loads(line)['tokens'] for line in f
                                 if line.strip()]
    if len(rows) < batch_prompts:
        raise ValueError(f'--prompts has {len(rows)} rows but '
                         f'--batch-prompts is {batch_prompts}; add prompts '
                         f'or lower the batch.')
    if len(rows) % batch_prompts:
        logger.warning('%d trailing prompt(s) are skipped each epoch (static '
                       'batch of %d).', len(rows) % batch_prompts,
                       batch_prompts)
    while True:
        for lo in range(0, len(rows) - batch_prompts + 1, batch_prompts):
            chunk = rows[lo:lo + batch_prompts]
            arr = torch.zeros((len(chunk), max(len(r) for r in chunk)),
                              dtype=torch.int32)
            for i, r in enumerate(chunk):
                arr[i, :len(r)] = torch.tensor(r, dtype=torch.int32)
            yield arr, torch.tensor([len(r) for r in chunk],
                                    dtype=torch.int32)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog='skypilot_tpu_torch.train.grpo')
    parser.add_argument('--model', default='llama-debug')
    parser.add_argument('--hf-dir', default=None,
                        help='HF checkpoint for the initial policy.')
    parser.add_argument('--reward', required=True,
                        help='count_token:ID | length | module:function')
    parser.add_argument('--iterations', type=int, default=100)
    parser.add_argument('--prompts', default=None,
                        help='JSONL of {"tokens": [...]} prompts (default: '
                             'random token prompts).')
    parser.add_argument('--batch-prompts', type=int, default=4)
    parser.add_argument('--prompt-len', type=int, default=16)
    parser.add_argument('--group-size', type=int, default=8)
    parser.add_argument('--max-new-tokens', type=int, default=32)
    parser.add_argument('--temperature', type=float, default=1.0)
    parser.add_argument('--kl-coef', type=float, default=0.0)
    parser.add_argument('--clip-eps', type=float, default=0.2)
    parser.add_argument('--inner-steps', type=int, default=1)
    parser.add_argument('--lr', type=float, default=1e-5)
    parser.add_argument('--eos-id', type=int, default=None)
    parser.add_argument('--ckpt-dir', default=None,
                        help='Checkpoint dir for the policy (resume from '
                             'the newest step).')
    parser.add_argument('--ckpt-every', type=int, default=50)
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (default) or 'cpu'.")
    # A flag of the JAX CLI that the port refuses by name.
    parser.add_argument('--mesh', default='')
    return parser


def main(argv: Optional[List[str]] = None) -> None:
    """CLI: GRPO fine-tuning, with checkpoints, resume (fast-forwarding
    the prompt stream) and a final save on SIGTERM."""
    from skypilot_tpu_torch.models import hf_import
    from skypilot_tpu_torch.train import checkpoints
    from skypilot_tpu_torch.train.trainer import _PreemptionWatch
    logging.basicConfig(level=logging.INFO, format='%(message)s')
    args = build_parser().parse_args(argv)
    if args.mesh:
        raise NotImplementedError(
            '--mesh is not ported yet: it waits for ROADMAP Queue 1 item 8 '
            '(parallelism and multi-process)')
    device = torch.device(args.device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('no CUDA device: GRPO runs on the card unless '
                           '--device cpu is asked for')
    init_params = None
    if args.hf_dir:
        cfg, init_params = hf_import.load_hf_checkpoint(
            args.hf_dir, dtype=torch.float32, device=device)
        eos = hf_import.hf_eos_ids(args.hf_dir)
        if args.eos_id is None and eos:
            args.eos_id = eos[0]
    else:
        cfg = config.get_config(args.model)
    gcfg = GRPOConfig(group_size=args.group_size,
                      max_new_tokens=args.max_new_tokens,
                      temperature=args.temperature, clip_eps=args.clip_eps,
                      kl_coef=args.kl_coef, inner_steps=args.inner_steps)
    tx = train_lib.default_optimizer(learning_rate=args.lr, warmup_steps=1,
                                     total_steps=args.iterations + 1)
    trainer = GRPOTrainer(cfg, gcfg, resolve_reward(args.reward, args.eos_id),
                          tx=tx, eos_id=args.eos_id, init_params=init_params,
                          device=device)
    del init_params
    ckpt = None
    start_it = 0
    if args.ckpt_dir:
        ckpt = checkpoints.Checkpointer(args.ckpt_dir)
        if ckpt.latest_step() is not None:
            # The newest complete step (a corrupt newest falls back to an
            # older one inside restore_newest).
            trainer.state, start_it = ckpt.restore_newest(
                checkpoints.abstract_train_state(cfg, trainer.tx), device)
            logger.info('Resumed GRPO policy at iteration %d from %s.',
                        start_it, args.ckpt_dir)
    try:
        batches = prompt_batches(args.prompts, args.batch_prompts,
                                 args.prompt_len, cfg.vocab_size)
        for _ in range(start_it):
            # Fast-forward: iteration i's prompts are the same whether or
            # not the run was preempted before it.
            next(batches)
        with _PreemptionWatch() as watch:
            for it in range(start_it, args.iterations):
                prompts, lens = next(batches)
                metrics = trainer.iteration(prompts, prompt_lengths=lens)
                logger.info(json.dumps(
                    {'iter': it + 1,
                     **{k: round(v, 4) for k, v in metrics.items()}}))
                if ckpt is not None and (it + 1) % args.ckpt_every == 0:
                    ckpt.save(trainer.state, it + 1)
                if watch.preempted:
                    # Preemption notice: one synchronous final save.
                    if ckpt is not None:
                        ckpt.save(trainer.state, it + 1, wait=True)
                    logger.info(json.dumps(
                        {'iter': it + 1, 'preempted': True,
                         'final_checkpoint': ckpt is not None}))
                    return
            if ckpt is not None and args.iterations % args.ckpt_every != 0:
                # Aligned totals were saved by the in-loop cadence.
                ckpt.save(trainer.state, args.iterations)
    finally:
        if ckpt is not None:
            ckpt.close()


if __name__ == '__main__':
    main()
