"""The weight bridge: a JAX-layout param tree of numpy arrays → torch.

The JAX package's ``init_params`` (and its checkpoints) give a nested
dict whose layer leaves are stacked ``[L, ...]`` and whose projections
are ``[in, out]``. The port keeps exactly that layout (models/llama.py
multiplies ``h @ w``), so the bridge is a per-leaf copy with a dtype
and a device; nothing is transposed.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from skypilot_tpu_torch.config import LlamaConfig


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
