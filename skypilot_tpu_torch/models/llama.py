"""Llama-family dense forward (port of skypilot_tpu/models/llama.py:
``init_params``, ``attention_block``, ``_layer``, ``forward``).

Params are a plain dict of tensors in the JAX tree's layout: layer
leaves stacked on a leading [L] axis, projections kept [in, out] so the
products read as the JAX einsums do (``h @ wq[l]``). The layer scan is a
Python loop. Training keeps fp32 master params (cfg.param_dtype) and
computes in cfg.dtype; ``cfg.remat`` picks the layer recompute as the
JAX ``_REMAT_POLICIES`` do: 'none' saves every activation, 'full'
(``nothing_saveable``) recomputes each layer in the backward through
``torch.utils.checkpoint``; 'dots' is refused by
:func:`config.check_supported`. No pipeline or ring.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from skypilot_tpu_torch.config import LlamaConfig, check_supported
from skypilot_tpu_torch.ops import norms, rotary
from skypilot_tpu_torch.ops.attention import attention as _attention

Params = Dict[str, object]


def init_params(cfg: LlamaConfig, generator: torch.Generator,
                device='cuda') -> Params:
    """Random params from ``generator`` (on ``device``), in
    cfg.param_dtype: normal(0.02) embeddings and truncated-normal
    projections with std fan_in**-0.5. Torch's RNG stream differs from
    jax.random's, so these are not the JAX package's weights: parity
    tests bridge JAX weights with models/weights.py instead."""
    check_supported(cfg)
    hd, L, D, Fd = cfg.hd, cfg.n_layers, cfg.dim, cfg.ffn_dim
    dt = cfg.param_dtype

    def normal(shape, std):
        t = torch.empty(shape, dtype=dt, device=device)
        return t.normal_(0.0, std, generator=generator)

    def trunc(shape):
        t = torch.empty(shape, dtype=dt, device=device)
        std = 1.0 / math.sqrt(shape[-2])
        return torch.nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                           generator=generator)

    def ones(shape):
        return torch.ones(shape, dtype=dt, device=device)

    layers = {
        'attn_norm': ones((L, D)),
        'wq': trunc((L, D, cfg.n_heads * hd)),
        'wk': trunc((L, D, cfg.n_kv_heads * hd)),
        'wv': trunc((L, D, cfg.n_kv_heads * hd)),
        'wo': trunc((L, cfg.n_heads * hd, D)),
        'mlp_norm': ones((L, D)),
        'w_gate': trunc((L, D, Fd)),
        'w_up': trunc((L, D, Fd)),
        'w_down': trunc((L, Fd, D)),
    }
    if cfg.qkv_bias:
        layers['bq'] = torch.zeros((L, cfg.n_heads * hd), dtype=dt,
                                   device=device)
        layers['bk'] = torch.zeros((L, cfg.n_kv_heads * hd), dtype=dt,
                                   device=device)
        layers['bv'] = torch.zeros((L, cfg.n_kv_heads * hd), dtype=dt,
                                   device=device)
    params: Params = {'embed': normal((cfg.vocab_size, D), 0.02),
                      'layers': layers, 'final_norm': ones((D,))}
    if not cfg.tie_embeddings:
        params['lm_head'] = normal((D, cfg.vocab_size), 0.02)
    return params


def layer_params(params: Params, i: int) -> Dict[str, torch.Tensor]:
    """Layer i's slice of the stacked [L, ...] leaves (views)."""
    return {k: v[i] for k, v in params['layers'].items()}


def qkv(x: torch.Tensor, lp, cfg: LlamaConfig, sin, cos):
    """norm → q/k/v projections (+ Qwen2 biases) → rope. x [B, S, D] →
    q [B, S, H, hd], k/v [B, S, KH, hd]."""
    b, s, _ = x.shape
    h = norms.rms_norm(x, lp['attn_norm'], cfg.rms_eps)
    q = h @ lp['wq'].to(cfg.dtype)
    k = h @ lp['wk'].to(cfg.dtype)
    v = h @ lp['wv'].to(cfg.dtype)
    if cfg.qkv_bias:
        q = q + lp['bq'].to(cfg.dtype)
        k = k + lp['bk'].to(cfg.dtype)
        v = v + lp['bv'].to(cfg.dtype)
    q = q.reshape(b, s, cfg.n_heads, cfg.hd)
    k = k.reshape(b, s, cfg.n_kv_heads, cfg.hd)
    v = v.reshape(b, s, cfg.n_kv_heads, cfg.hd)
    return rotary.apply_rope(q, sin, cos), rotary.apply_rope(k, sin, cos), v


def wo_project(out: torch.Tensor, lp, cfg: LlamaConfig) -> torch.Tensor:
    b, s = out.shape[:2]
    return out.reshape(b, s, cfg.n_heads * cfg.hd) @ lp['wo'].to(cfg.dtype)


def ffn(x: torch.Tensor, lp, cfg: LlamaConfig) -> torch.Tensor:
    """Post-attention SwiGLU block (pre-norm)."""
    h = norms.rms_norm(x, lp['mlp_norm'], cfg.rms_eps)
    gate = h @ lp['w_gate'].to(cfg.dtype)
    up = h @ lp['w_up'].to(cfg.dtype)
    return (F.silu(gate) * up) @ lp['w_down'].to(cfg.dtype)


def unembed(x: torch.Tensor, params: Params, cfg: LlamaConfig
            ) -> torch.Tensor:
    """final norm → head; fp32 logits (the JAX einsum's
    preferred_element_type)."""
    x = norms.rms_norm(x, params['final_norm'], cfg.rms_eps)
    head = params['embed'].T if cfg.tie_embeddings else params['lm_head']
    return (x @ head.to(cfg.dtype)).float()


def embed(params: Params, tokens: torch.Tensor, cfg: LlamaConfig
          ) -> torch.Tensor:
    return params['embed'][tokens.long()].to(cfg.dtype)


def layer(x: torch.Tensor, lp, cfg: LlamaConfig, sin, cos) -> torch.Tensor:
    """One decoder layer over a whole sequence (positions from 0):
    attention by ``cfg.attention_impl``, then the SwiGLU block."""
    q, k, v = qkv(x, lp, cfg, sin, cos)
    out = _attention(q, k, v, impl=cfg.attention_impl, causal=True)
    x = x + wo_project(out, lp, cfg)
    return x + ffn(x, lp, cfg)


def forward(params: Params, tokens: torch.Tensor, cfg: LlamaConfig,
            return_hidden: bool = False) -> torch.Tensor:
    """tokens [B, S] → logits [B, S, vocab] (fp32), or the final-norm
    hidden states [B, S, D] fp32 with ``return_hidden``. Under autograd
    with ``cfg.remat == 'full'`` each layer is recomputed in the
    backward (its attention forward runs twice a step)."""
    check_supported(cfg)
    x = embed(params, tokens, cfg)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    sin, cos = rotary.rope_frequencies(cfg.hd, positions, cfg.rope_theta,
                                       cfg.rope_scaling)
    remat = cfg.remat == 'full' and torch.is_grad_enabled()
    # One unbind per stacked leaf, not an index per layer: the backward
    # of unbind stacks the L layer grads once, where indexing would
    # zero-fill and add a full [L, ...] grad for every layer.
    layers = {k: v.unbind(0) for k, v in params['layers'].items()}
    for i in range(cfg.n_layers):
        lp = {k: v[i] for k, v in layers.items()}
        if remat:
            x = torch.utils.checkpoint.checkpoint(
                layer, x, lp, cfg, sin, cos, use_reentrant=False)
        else:
            x = layer(x, lp, cfg, sin, cos)
    if return_hidden:
        return norms.rms_norm(x, params['final_norm'], cfg.rms_eps).float()
    return unembed(x, params, cfg)
