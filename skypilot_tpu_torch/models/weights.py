"""The bridge between the JAX package's trees and the port's tensors:
params, the optimizer state, and a train state's checkpoint paths.

The JAX package's ``init_params`` (and its checkpoints) give a nested
dict whose layer leaves are stacked ``[L, ...]`` and whose projections
are ``[in, out]``. The port keeps exactly that layout (models/llama.py
multiplies ``h @ w``), so the bridge is a per-leaf copy with a dtype
and a device; nothing is transposed.

The JAX train state is ``TrainState(step, params, opt_state)`` with the
optax state of ``default_optimizer``: ``(EmptyState(),
(ScaleByAdamState(count, mu, nu), EmptyState(),
ScaleByScheduleState(count)))``. The port's ``OptState(count, mu, nu)``
(train/train_lib.py) holds the same numbers; :func:`train_state_leaves`
names each of them by the path the JAX checkpointer writes
(``jax.tree_util.keystr``, dict keys in sorted order), which is what
makes a checkpoint of one package restore in the other.
"""
from __future__ import annotations

from typing import Any, List, Mapping, Tuple

import numpy as np
import torch

from skypilot_tpu_torch.config import LlamaConfig

# Paths of the optax state's leaves in the JAX TrainState.
ADAM_PATH = '.opt_state[1][0]'
SCHEDULE_COUNT_PATH = '.opt_state[1][2].count'


def params_from_jax(tree: Mapping[str, Any], cfg: LlamaConfig,
                    device='cuda', dtype=None):
    """Nested dict of numpy arrays (``jax.device_get`` of the JAX tree)
    → the same nested dict of torch tensors in ``dtype`` (default
    cfg.param_dtype) on ``device``. Checks every layer leaf carries
    cfg.n_layers on its leading axis."""
    dtype = dtype or cfg.param_dtype

    def conv(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(
            device=device, dtype=dtype)

    out = {}
    for key, val in tree.items():
        if isinstance(val, Mapping):
            sub = {}
            for k, a in val.items():
                if np.shape(a)[0] != cfg.n_layers:
                    raise ValueError(f'layer leaf {k} has leading dim '
                                     f'{np.shape(a)[0]}, want '
                                     f'{cfg.n_layers}')
                sub[k] = conv(a)
            out[key] = sub
        else:
            out[key] = conv(val)
    return out


def opt_state_from_jax(opt_state: Any, cfg: LlamaConfig, device='cuda'
                       ) -> Tuple[int, dict, dict]:
    """``jax.device_get`` of the optax state of ``default_optimizer`` →
    (count, mu, nu) for the port's ``OptState``, moments in fp32."""
    adam = opt_state[1][0]
    return (int(adam.count),
            params_from_jax(adam.mu, cfg, device, torch.float32),
            params_from_jax(adam.nu, cfg, device, torch.float32))


def tree_paths(tree: Mapping[str, Any], prefix: str = ''
               ) -> List[Tuple[str, Any]]:
    """(path, leaf) pairs in JAX's flattening order (dict keys sorted),
    paths spelled as ``jax.tree_util.keystr`` spells them."""
    out = []
    for key in sorted(tree):
        val, path = tree[key], f"{prefix}['{key}']"
        if isinstance(val, Mapping):
            out.extend(tree_paths(val, path))
        else:
            out.append((path, val))
    return out


def train_state_leaves(state) -> List[Tuple[str, Any]]:
    """The port's TrainState as the JAX TrainState flattens: (checkpoint
    path, leaf) in order; a leaf is a tensor, or an int for the step and
    the two optax counts (both the port's ``opt_state.count``)."""
    opt = state.opt_state
    out = [('.step', state.step)]
    out += [('.params' + p, t) for p, t in tree_paths(state.params)]
    out.append((f'{ADAM_PATH}.count', opt.count))
    out += [(f'{ADAM_PATH}.mu' + p, t) for p, t in tree_paths(opt.mu)]
    out += [(f'{ADAM_PATH}.nu' + p, t) for p, t in tree_paths(opt.nu)]
    out.append((SCHEDULE_COUNT_PATH, opt.count))
    return out


def leaf_spec(leaf: Any) -> Tuple[Tuple[int, ...], str]:
    """(shape, dtype name as numpy and the JAX manifest spell it) of a
    train-state leaf; ints are the int32 scalars JAX keeps."""
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape), str(leaf.dtype).removeprefix('torch.')
    return (), 'int32'


def train_state_from_arrays(template, arrays: Mapping[str, np.ndarray],
                            device) -> Tuple[int, dict, int, dict, dict]:
    """Checkpoint arrays by path → (step, params, count, mu, nu) shaped
    like ``template`` (a TrainState, e.g. on the meta device), tensors
    on ``device``. The two optax counts must agree."""
    count = int(arrays[f'{ADAM_PATH}.count'])
    if int(arrays[SCHEDULE_COUNT_PATH]) != count:
        raise ValueError(f'optimizer counts disagree: adam {count}, '
                         f'schedule {int(arrays[SCHEDULE_COUNT_PATH])}')

    def fill(tree, prefix):
        out = {}
        for key, val in tree.items():
            path = f"{prefix}['{key}']"
            out[key] = (fill(val, path) if isinstance(val, Mapping) else
                        torch.from_numpy(np.array(arrays[path])).to(device))
        return out

    opt = template.opt_state
    return (int(arrays['.step']), fill(template.params, '.params'), count,
            fill(opt.mu, f'{ADAM_PATH}.mu'), fill(opt.nu, f'{ADAM_PATH}.nu'))
