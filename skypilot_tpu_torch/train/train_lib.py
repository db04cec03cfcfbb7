"""Training step for the port (port of skypilot_tpu/train/train_lib.py,
without meshes: one card or the CPU).

fp32 master params and bf16 compute, next-token cross entropy (plus
the router load-balance aux of a model whose module sets ``HAS_AUX``:
the MoE and MLA families), and the JAX package's optimizer written out
as plain tensor code: ``optax.chain(clip_by_global_norm(max_grad_norm),
adamw(warmup_cosine_decay_schedule(0, lr, warmup, max(total,
warmup + 1)), b1=.9, b2=.95, eps=1e-8, weight_decay=wd))``. The step
updates the state in place (params, moments), where the JAX step
returns a new donated state; the numbers are the same.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple

import torch

from skypilot_tpu_torch.config import LlamaConfig
from skypilot_tpu_torch.models import module_for, weights

Batch = Dict[str, torch.Tensor]
Params = Dict[str, object]


@dataclasses.dataclass
class OptState:
    """The AdamW state: the update count (optax's ``ScaleByAdamState``
    and ``ScaleByScheduleState`` counts, always equal) and the first and
    second moments, trees shaped like the params."""
    count: int
    mu: Params
    nu: Params


@dataclasses.dataclass
class TrainState:
    step: int
    params: Params
    opt_state: OptState


def leaves(tree: Params) -> List[torch.Tensor]:
    """The tree's tensors in the JAX flattening order (sorted keys)."""
    return [leaf for _, leaf in weights.tree_paths(tree)]


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor,
                       mask: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean next-token CE over masked positions: (loss, token count).
    logits [B,S,V] (computed in fp32), targets [B,S] ints."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, targets.long()[..., None])[..., 0]
    nll = logz - gold
    mask = torch.ones_like(nll) if mask is None else mask.float()
    denom = mask.sum().clamp(min=1.0)
    return (nll * mask).sum() / denom, denom


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every element (optax.global_norm)."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


class AdamW:
    """``default_optimizer``: global-norm clip, then AdamW on a
    warmup-cosine learning rate, as the optax chain computes it.

    What the optax chain does and this keeps: the learning rate is the
    schedule at the update count *before* the increment (so the first
    update has lr 0); weight decay applies to every leaf, norms and the
    embedding included; the clip scales by ``max_norm / g_norm`` only
    when ``g_norm >= max_norm``, with no epsilon (unlike
    ``torch.nn.utils.clip_grad_norm_``).
    """

    def __init__(self, learning_rate: float = 3e-4,
                 weight_decay: float = 0.1, warmup_steps: int = 100,
                 total_steps: int = 10000, max_grad_norm: float = 1.0,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8):
        self.peak = learning_rate
        self.weight_decay = weight_decay
        self.warmup = warmup_steps
        self.decay_steps = max(total_steps, warmup_steps + 1)
        self.max_grad_norm = max_grad_norm
        self.b1, self.b2, self.eps = b1, b2, eps

    def learning_rate(self, count: int) -> float:
        """optax.warmup_cosine_decay_schedule(0, peak, warmup, decay)."""
        if count < self.warmup:
            return self.peak * count / self.warmup
        span = self.decay_steps - self.warmup
        done = min(count - self.warmup, span)
        return self.peak * 0.5 * (1 + math.cos(math.pi * done / span))

    def init(self, params: Params) -> OptState:
        def zeros(tree):
            if isinstance(tree, dict):
                return {k: zeros(v) for k, v in tree.items()}
            return torch.zeros_like(tree, dtype=torch.float32,
                                    requires_grad=False)
        return OptState(count=0, mu=zeros(params), nu=zeros(params))

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor], state: OptState,
               params: Params) -> torch.Tensor:
        """One update, in place: ``grads`` (the raw grads, consumed:
        clipped in place) align with ``leaves(params)``; params, mu, nu
        and the count move on. Returns the grads' global norm before the
        clip."""
        g_norm = global_norm(grads)
        # optax: select(g_norm < max_norm, g, (g / g_norm) * max_norm).
        keep = g_norm < self.max_grad_norm
        one = torch.ones_like(g_norm)
        denom = torch.where(keep, one, g_norm)
        mult = torch.where(keep, one, one * self.max_grad_norm)
        lr = self.learning_rate(state.count)
        count = state.count + 1
        bc1 = 1 - self.b1 ** count
        bc2 = 1 - self.b2 ** count
        for p, g, m, v in zip(leaves(params), grads, leaves(state.mu),
                              leaves(state.nu)):
            g.div_(denom).mul_(mult)
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            u = (m / bc1).div_((v / bc2).sqrt_().add_(self.eps))
            u.add_(p, alpha=self.weight_decay)
            p.add_(u, alpha=-lr)
        state.count = count
        return g_norm


def default_optimizer(learning_rate: float = 3e-4,
                      weight_decay: float = 0.1,
                      warmup_steps: int = 100,
                      total_steps: int = 10000,
                      max_grad_norm: float = 1.0) -> AdamW:
    return AdamW(learning_rate=learning_rate, weight_decay=weight_decay,
                 warmup_steps=warmup_steps, total_steps=total_steps,
                 max_grad_norm=max_grad_norm)


def init_train_state(cfg: LlamaConfig, tx: AdamW, device='cuda',
                     generator: Optional[torch.Generator] = None,
                     params: Optional[Params] = None) -> TrainState:
    """Step 0: ``params`` as given (e.g. bridged from JAX with
    models/weights.params_from_jax), else random from ``generator``
    (default: seed 0 on ``device``) by the config's model module, in
    cfg.param_dtype; fresh moments."""
    if params is None:
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        params = module_for(cfg).init_params(cfg, generator, device)
    for leaf in leaves(params):
        leaf.requires_grad_(True)
    return TrainState(step=0, params=params, opt_state=tx.init(params))


def _shift(tokens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return tokens[:, :-1], tokens[:, 1:]


def forward_with_aux(cfg: LlamaConfig, params: Params, inputs: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(logits, the router aux to add to the loss): the model module's
    ``forward(return_aux=True)`` when it sets ``HAS_AUX``, else its
    logits and 0."""
    mod = module_for(cfg)
    if getattr(mod, 'HAS_AUX', False):
        return mod.forward(params, inputs, cfg, return_aux=True)
    return mod.forward(params, inputs, cfg), 0.0


def make_train_step(cfg: LlamaConfig, tx: AdamW, grad_accum_steps: int = 1
                    ) -> Callable[[TrainState, Batch],
                                  Tuple[TrainState, Dict[str, object]]]:
    """(state, batch) → (state, metrics); the state moves on in place.

    batch: {'tokens': int [B, S+1]}, shifted here; an optional
    'loss_mask' [B, S] masks the target positions. grad_accum_steps > 1
    splits the batch into that many microbatches run one after another
    before one update, weighting each microbatch's mean grad by its
    target-token count, so the update equals the dense step. The grads
    are those of the CE plus the router aux (each microbatch's own aux
    inside its grads, as in the JAX scan). Metrics: loss (the CE alone),
    grad_norm (of the unclipped grads), tokens (0-d tensors, not
    synchronised) and step.
    """

    def grads_of(params, tokens, mask):
        inputs, targets = _shift(tokens)
        logits, aux = forward_with_aux(cfg, params, inputs)
        loss, denom = cross_entropy_loss(logits, targets, mask)
        grads = torch.autograd.grad(loss + aux, leaves(params))
        return list(grads), loss.detach(), denom

    def step_fn(state: TrainState, batch: Batch):
        tokens = batch['tokens']
        mask = batch.get('loss_mask')
        a = grad_accum_steps
        if a == 1:
            grads, loss, denom = grads_of(state.params, tokens, mask)
        else:
            b = tokens.shape[0]
            if b % a != 0:
                raise ValueError(f'batch {b} not divisible by '
                                 f'grad_accum_steps {a}')
            grads = None
            l_sum = d_sum = 0.0
            for tok_m, mask_m in zip(
                    tokens.chunk(a), mask.chunk(a) if mask is not None
                    else [None] * a):
                g, loss_m, denom_m = grads_of(state.params, tok_m, mask_m)
                if grads is None:
                    grads = [gi * denom_m for gi in g]
                else:
                    for s, gi in zip(grads, g):
                        s.add_(gi * denom_m)
                l_sum = l_sum + loss_m * denom_m
                d_sum = d_sum + denom_m
            d_safe = d_sum.clamp(min=1.0)
            grads = [g / d_safe for g in grads]
            loss, denom = l_sum / d_safe, d_sum
        gnorm = tx.update(grads, state.opt_state, state.params)
        metrics = {'loss': loss, 'grad_norm': gnorm, 'tokens': denom,
                   'step': state.step}
        state.step += 1
        return state, metrics

    return step_fn


def make_eval_step(cfg: LlamaConfig
                   ) -> Callable[[Params, Batch], torch.Tensor]:
    """Forward-only loss: (params, batch) → 0-d mean CE, no grad (the
    router aux is asked for and dropped, as in JAX)."""

    @torch.no_grad()
    def eval_fn(params, batch: Batch) -> torch.Tensor:
        inputs, targets = _shift(batch['tokens'])
        logits, _ = forward_with_aux(cfg, params, inputs)
        loss, _ = cross_entropy_loss(logits, targets, batch.get('loss_mask'))
        return loss

    return eval_fn


def synthetic_batch(generator: torch.Generator, batch_size: int,
                    seq_len: int, vocab_size: int, device='cuda') -> Batch:
    tokens = torch.randint(0, vocab_size, (batch_size, seq_len + 1),
                           generator=generator, device=device,
                           dtype=torch.int32)
    return {'tokens': tokens}
