"""LoRA fine-tuning in the port (port of skypilot_tpu/train/lora.py, on
one card or the CPU; the reference's recipe is
llm/llama-3_1-finetuning/lora.yaml).

Adapters are a path-keyed overlay on the stacked-layer params: a target
leaf ``[..., in, out]`` gets A ``[..., in, r]`` and B ``[..., r, out]``,
the leading axes riding along, so one batched product covers dense
layers ``[L, in, out]`` and MoE expert leaves ``[L, E, in, out]``. The
train step merges ``base + scaling * A @ B`` inside autograd and runs
the family's unmodified forward (``models.module_for``); the base is a
constant (no grad, no optimizer state) and the port's AdamW
(train/train_lib.py) runs over the adapter leaves alone.

Persistence is the JAX package's format, so an artifact of either
package resumes in the other: ``adapters.npz`` holds ``key:a`` /
``key:b``, the optimizer leaves ``opt:{i}`` in optax order
(models/weights.py::opt_state_leaves) and ``_step``; ``lora.json``
beside it holds the config. Both are written through a temp file and
``os.replace``.

Not ported: ``shard_base_params`` and the mesh path (ROADMAP Queue 1
item 8).
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from skypilot_tpu_torch.config import LlamaConfig
from skypilot_tpu_torch.models import weights
from skypilot_tpu_torch.train import train_lib

logger = logging.getLogger('skypilot_tpu_torch.train.lora')

# The attention projections, the standard LoRA recipe's default targets
# (leaf names as models/llama.py, moe.py and mla.py spell them).
DEFAULT_TARGETS = ('wq', 'wk', 'wv', 'wo')

Adapters = Dict[str, Dict[str, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    rank: int = 16
    alpha: float = 32.0
    # Leaf names to adapt (matched against the last path segment).
    targets: Tuple[str, ...] = DEFAULT_TARGETS

    @property
    def scaling(self) -> float:
        return self.alpha / self.rank


def _flat(tree: Dict[str, Any]) -> List[Tuple[str, Any]]:
    """(adapter key, leaf) in JAX's flattening order (dict keys sorted),
    the key '/'-joined, e.g. 'layers/wq'."""
    return [(weights.slash_key(path), leaf)
            for path, leaf in weights.tree_paths(tree)]


def target_keys(base_params: Dict[str, Any], lcfg: LoRAConfig) -> List[str]:
    """Sorted adapter keys: targeted leaves with a matmul shape. Raises
    when no leaf matches."""
    flat = _flat(base_params)
    keys = [key for key, leaf in flat
            if key.split('/')[-1] in lcfg.targets and leaf.ndim >= 2]
    if not keys:
        raise ValueError(
            f'LoRA targets {lcfg.targets} matched no >=2-D leaves; '
            f'available: {sorted(key for key, _ in flat)}')
    return sorted(keys)


def init_adapters(generator: torch.Generator, base_params: Dict[str, Any],
                  lcfg: LoRAConfig) -> Adapters:
    """{key: {'a', 'b'}}: A standard normal / rank, drawn from
    ``generator`` (on the device of the base), B zero, both fp32, so the
    merged model starts exactly at the base."""
    leaves = dict(_flat(base_params))
    adapters: Adapters = {}
    for key in target_keys(base_params, lcfg):
        leaf = leaves[key]
        *lead, d_in, d_out = leaf.shape
        a = torch.randn((*lead, d_in, lcfg.rank), generator=generator,
                        dtype=torch.float32, device=generator.device)
        adapters[key] = {
            'a': (a / lcfg.rank).to(leaf.device),
            'b': torch.zeros((*lead, lcfg.rank, d_out), dtype=torch.float32,
                             device=leaf.device)}
    return adapters


def merge_into(base_params: Dict[str, Any], adapters: Adapters,
               lcfg: LoRAConfig) -> Dict[str, Any]:
    """base + scaling * A @ B on the targeted leaves, in fp32, cast back
    to each leaf's dtype; every other leaf is the base's own tensor.
    Differentiable in the adapters."""
    scaling = lcfg.scaling

    def merge(key, leaf):
        ab = adapters.get(key)
        if ab is None:
            return leaf
        delta = (ab['a'].float() @ ab['b'].float()) * scaling
        return (leaf.float() + delta).to(leaf.dtype)
    return weights.tree_unflatten(
        base_params, [merge(key, leaf) for key, leaf in _flat(base_params)])


@dataclasses.dataclass
class LoRAState:
    step: int
    adapters: Adapters
    opt_state: train_lib.OptState


def _trainable(adapters: Adapters) -> Adapters:
    for leaf in train_lib.leaves(adapters):
        leaf.requires_grad_(True)
    return adapters


def init_lora_state(generator: torch.Generator, base_params: Dict[str, Any],
                    lcfg: LoRAConfig, tx: train_lib.AdamW) -> LoRAState:
    adapters = _trainable(init_adapters(generator, base_params, lcfg))
    return LoRAState(step=0, adapters=adapters, opt_state=tx.init(adapters))


def make_lora_train_step(cfg: LlamaConfig, tx: train_lib.AdamW,
                         lcfg: LoRAConfig
                         ) -> Callable[[LoRAState, Dict[str, Any],
                                        train_lib.Batch],
                                       Tuple[LoRAState, Dict[str, Any]]]:
    """(state, base_params, batch) → (state, metrics); the adapters and
    their moments move on in place, the base is read only. The batch is
    train_lib.make_train_step's ({'tokens': [B, S+1]}, an optional
    'loss_mask'). The grads are those of the CE plus the router aux
    (HAS_AUX families); metrics: loss (the CE alone), grad_norm (of the
    unclipped adapter grads), tokens, step."""

    def step_fn(state: LoRAState, base_params, batch):
        inputs, targets = train_lib._shift(batch['tokens'])
        merged = merge_into(base_params, state.adapters, lcfg)
        logits, aux = train_lib.forward_with_aux(cfg, merged, inputs)
        loss, denom = train_lib.cross_entropy_loss(logits, targets,
                                                   batch.get('loss_mask'))
        del logits, merged
        grads = torch.autograd.grad(loss + aux,
                                    train_lib.leaves(state.adapters))
        gnorm = tx.update(list(grads), state.opt_state, state.adapters)
        metrics = {'loss': loss.detach(), 'grad_norm': gnorm,
                   'tokens': denom, 'step': state.step}
        state.step += 1
        return state, metrics

    return step_fn


# Persistence: adapters.npz (flat 'key:a' / 'key:b' arrays, 'opt:{i}',
# '_step') and a lora.json sidecar, as the JAX package writes them.

def save_adapters(directory: str, state: LoRAState,
                  lcfg: LoRAConfig) -> str:
    """Persist the adapters, the optimizer state and the step; returns
    the npz's path. The step lives inside the npz, so weights, moments
    and step replace together (lora.json's copy is for people)."""
    directory = os.path.abspath(os.path.expanduser(directory))
    os.makedirs(directory, exist_ok=True)
    flat = {}
    for key, ab in state.adapters.items():
        for part in ('a', 'b'):
            flat[f'{key}:{part}'] = ab[part].detach().float().cpu().numpy()
    for i, (_, leaf) in enumerate(weights.opt_state_leaves(state.opt_state)):
        flat[f'opt:{i}'] = (leaf.detach().cpu().numpy()
                            if isinstance(leaf, torch.Tensor)
                            else np.asarray(leaf, np.int32))
    flat['_step'] = np.asarray(int(state.step), np.int64)
    path = os.path.join(directory, 'adapters.npz')
    tmp = os.path.join(directory, '.adapters.npz.tmp')
    with open(tmp, 'wb') as f:
        np.savez(f, **flat)
    os.replace(tmp, path)
    meta = {'rank': lcfg.rank, 'alpha': lcfg.alpha,
            'targets': list(lcfg.targets), 'step': int(state.step)}
    tmp = os.path.join(directory, '.lora.json.tmp')
    with open(tmp, 'w', encoding='utf-8') as f:
        json.dump(meta, f, indent=1)
    os.replace(tmp, os.path.join(directory, 'lora.json'))
    return path


def load_adapters(directory: str, device='cpu'
                  ) -> Tuple[Adapters, LoRAConfig, int, List[np.ndarray]]:
    """(adapters as fp32 tensors on ``device``, config, step, opt_leaves)
    from save_adapters' output (either package's). opt_leaves is [] for
    an artifact without optimizer state, else the flat leaves in optax
    order, as numpy arrays (:func:`restore_opt_state`)."""
    directory = os.path.abspath(os.path.expanduser(directory))
    with open(os.path.join(directory, 'lora.json'), 'r',
              encoding='utf-8') as f:
        meta = json.load(f)
    lcfg = LoRAConfig(rank=int(meta['rank']), alpha=float(meta['alpha']),
                      targets=tuple(meta['targets']))
    adapters: Adapters = {}
    opt: Dict[int, np.ndarray] = {}
    step = int(meta.get('step', 0))
    with np.load(os.path.join(directory, 'adapters.npz')) as z:
        for name in z.files:
            if name == '_step':
                step = int(z[name])     # authoritative: atomic with weights
            elif name.startswith('opt:'):
                opt[int(name.split(':', 1)[1])] = z[name]
            else:
                key, part = name.rsplit(':', 1)
                adapters.setdefault(key, {})[part] = torch.from_numpy(
                    np.array(z[name], np.float32)).to(device)
    return adapters, lcfg, step, [opt[i] for i in sorted(opt)]


def restore_opt_state(tx: train_lib.AdamW, adapters: Adapters,
                      opt_leaves: List[np.ndarray]) -> train_lib.OptState:
    """The optimizer state from saved leaves, on the adapters' device. A
    fresh ``tx.init`` when the artifact has none or its leaf count or
    shapes differ from the adapters' (as the JAX package does; logged
    here). Raises when the two saved counts disagree."""
    template = tx.init(adapters)
    t_leaves = [leaf for _, leaf in weights.opt_state_leaves(template)]

    def shape(leaf):
        return tuple(leaf.shape) if isinstance(leaf, torch.Tensor) else ()
    if len(opt_leaves) != len(t_leaves) or any(
            tuple(np.shape(a)) != shape(b)
            for a, b in zip(opt_leaves, t_leaves)):
        logger.warning('LoRA optimizer state: %d saved leaves do not fit '
                       'the adapters (%d); starting fresh moments.',
                       len(opt_leaves), len(t_leaves))
        return template
    count = int(opt_leaves[0])
    if int(opt_leaves[-1]) != count:
        raise ValueError(f'optimizer counts disagree: adam {count}, '
                         f'schedule {int(opt_leaves[-1])}')
    moments = [torch.from_numpy(np.array(a, np.float32)).to(b.device)
               for a, b in zip(opt_leaves[1:-1], t_leaves[1:-1])]
    n = len(moments) // 2
    return train_lib.OptState(
        count=count, mu=weights.tree_unflatten(template.mu, moments[:n]),
        nu=weights.tree_unflatten(template.nu, moments[n:]))


def resume_state(tx: train_lib.AdamW, directory: str, lcfg: LoRAConfig,
                 device) -> LoRAState:
    """A trainable LoRAState from ``directory`` (adapters, moments, step)
    on ``device``. Raises when the directory's rank, alpha or targets
    are not ``lcfg``'s."""
    adapters, saved, step, opt_leaves = load_adapters(directory, device)
    if (saved.rank, saved.alpha, saved.targets) != (lcfg.rank, lcfg.alpha,
                                                    lcfg.targets):
        raise ValueError(
            f'--lora-dir holds rank={saved.rank} alpha={saved.alpha} '
            f'targets={saved.targets}; requested rank={lcfg.rank} '
            f'alpha={lcfg.alpha} targets={lcfg.targets}.')
    return LoRAState(step=step, adapters=_trainable(adapters),
                     opt_state=restore_opt_state(tx, adapters, opt_leaves))
