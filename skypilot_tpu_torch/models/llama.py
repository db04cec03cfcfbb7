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

The Gemma-2/3 and gpt-oss switches follow the JAX module: (1 + w)
norms with zero-initialised w, the tanh-gelu or clamped-SwiGLU MLP,
sqrt(dim)-scaled embeddings, post-sublayer norms, q/k norms before
RoPE, a final logit softcap, and per layer the attention softcap, the
sliding window (every ``sliding_window_pattern``-th layer global) with
its own local rope base, and sinks. A layer's index is a Python int,
so :func:`window_active` and :func:`select_rope` are plain branches
where JAX traces a ``where`` inside its layer scan.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

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

    def zeros(shape):
        return torch.zeros(shape, dtype=dt, device=device)

    def norm(shape):
        # (1 + w) norms carry their identity in the "+ 1": w starts at 0.
        if cfg.norm_plus_one:
            return zeros(shape)
        return torch.ones(shape, dtype=dt, device=device)

    layers = {
        'attn_norm': norm((L, D)),
        'wq': trunc((L, D, cfg.n_heads * hd)),
        'wk': trunc((L, D, cfg.n_kv_heads * hd)),
        'wv': trunc((L, D, cfg.n_kv_heads * hd)),
        'wo': trunc((L, cfg.n_heads * hd, D)),
        'mlp_norm': norm((L, D)),
        'w_gate': trunc((L, D, Fd)),
        'w_up': trunc((L, D, Fd)),
        'w_down': trunc((L, Fd, D)),
    }
    if cfg.qkv_bias:
        layers['bq'] = zeros((L, cfg.n_heads * hd))
        layers['bk'] = zeros((L, cfg.n_kv_heads * hd))
        layers['bv'] = zeros((L, cfg.n_kv_heads * hd))
    if cfg.post_norms:
        layers['post_attn_norm'] = norm((L, D))
        layers['post_mlp_norm'] = norm((L, D))
    if cfg.qk_norm:
        layers['q_norm'] = norm((L, hd))
        layers['k_norm'] = norm((L, hd))
    if cfg.attn_sinks:
        # exp(0) = 1 joins every softmax denominator from the start.
        layers['sink'] = zeros((L, cfg.n_heads))
    params: Params = {'embed': normal((cfg.vocab_size, D), 0.02),
                      'layers': layers, 'final_norm': norm((D,))}
    if not cfg.tie_embeddings:
        params['lm_head'] = normal((D, cfg.vocab_size), 0.02)
    return params


def layer_params(params: Params, i: int) -> Dict[str, torch.Tensor]:
    """Layer i's slice of the stacked [L, ...] leaves (views)."""
    return {k: v[i] for k, v in params['layers'].items()}


def window_active(layer_idx: int, cfg: LlamaConfig) -> bool:
    """Does this layer attend within the sliding window? Every
    ``sliding_window_pattern``-th layer is global, the rest local
    (pattern 2: Gemma-2's alternation; 6: Gemma-3's 5 local to 1)."""
    p = cfg.sliding_window_pattern
    return layer_idx % p != p - 1


def rope_tables(cfg: LlamaConfig, positions: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sin, cos) for RoPE at ``positions``; stacked on a leading [2]
    (0: the global base with its scaling, 1: ``local_rope_theta``
    unscaled) when the config has a local rope base (Gemma-3)."""
    sin, cos = rotary.rope_frequencies(cfg.hd, positions, cfg.rope_theta,
                                       cfg.rope_scaling)
    if cfg.local_rope_theta is not None:
        sin_l, cos_l = rotary.rope_frequencies(cfg.hd, positions,
                                               cfg.local_rope_theta, None)
        return torch.stack([sin, sin_l]), torch.stack([cos, cos_l])
    return sin, cos


def select_rope(sin: torch.Tensor, cos: torch.Tensor, layer_idx: int,
                cfg: LlamaConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """This layer's tables from :func:`rope_tables`: the local ones on a
    sliding-window layer when the config has a local rope base."""
    if cfg.local_rope_theta is not None:
        i = 1 if window_active(layer_idx, cfg) else 0
        return sin[i], cos[i]
    return sin, cos


def attention_switches(lp, cfg: LlamaConfig, layer_idx: int) -> dict:
    """The per-layer attention keywords (softcap, window, window_active,
    sinks) that the attention ops take, as the JAX layer passes them:
    the window to every layer of a windowed model, flagged off on the
    global ones."""
    return dict(
        logit_softcap=cfg.attn_logit_softcap,
        window=cfg.sliding_window,
        window_active=(window_active(layer_idx, cfg)
                       if cfg.sliding_window else None),
        sinks=lp['sink'].float() if cfg.attn_sinks else None)


def _norm(x: torch.Tensor, scale: torch.Tensor, cfg: LlamaConfig
          ) -> torch.Tensor:
    return norms.rms_norm(x, scale, cfg.rms_eps,
                          scale_plus_one=cfg.norm_plus_one)


def qkv(x: torch.Tensor, lp, cfg: LlamaConfig, sin, cos):
    """norm → q/k/v projections (+ Qwen2 biases) → (Gemma-3 q/k norms)
    → rope. x [B, S, D] → q [B, S, H, hd], k/v [B, S, KH, hd]. sin/cos
    are this layer's (:func:`select_rope`)."""
    b, s, _ = x.shape
    h = _norm(x, lp['attn_norm'], cfg)
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
    if cfg.qk_norm:
        q = _norm(q, lp['q_norm'], cfg)
        k = _norm(k, lp['k_norm'], cfg)
    return rotary.apply_rope(q, sin, cos), rotary.apply_rope(k, sin, cos), v


def wo_project(out: torch.Tensor, lp, cfg: LlamaConfig) -> torch.Tensor:
    """Attention output projection (+ the Gemma-2 post-attention norm)."""
    b, s = out.shape[:2]
    y = out.reshape(b, s, cfg.n_heads * cfg.hd) @ lp['wo'].to(cfg.dtype)
    if cfg.post_norms:
        y = _norm(y, lp['post_attn_norm'], cfg)
    return y


def ffn(x: torch.Tensor, lp, cfg: LlamaConfig) -> torch.Tensor:
    """Post-attention gated MLP block (pre-norm; + the Gemma-2
    post-MLP norm)."""
    h = _norm(x, lp['mlp_norm'], cfg)
    gate = h @ lp['w_gate'].to(cfg.dtype)
    up = h @ lp['w_up'].to(cfg.dtype)
    down = cfg.glu(gate, up) @ lp['w_down'].to(cfg.dtype)
    if cfg.post_norms:
        down = _norm(down, lp['post_mlp_norm'], cfg)
    return down


def final_norm(x: torch.Tensor, params: Params, cfg: LlamaConfig
               ) -> torch.Tensor:
    return _norm(x, params['final_norm'], cfg)


class _MatmulFp32Out(torch.autograd.Function):
    """x [M, K] @ w [K, N], both bf16 on the card, into fp32 by one
    cuBLAS product (fp32 accumulate, the result not rounded to bf16).
    The grads are bf16 products of the cotangent rounded to bf16, in the
    operands' dtype, as the JAX transpose casts them."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.mm(x, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        gx = g @ w.T if ctx.needs_input_grad[0] else None
        gw = x.T @ g if ctx.needs_input_grad[1] else None
        return gx, gw


def logits_matmul(x: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """x [..., D] @ head [D, V] into fp32 logits from operands in their
    own (compute) dtype: the JAX einsum's preferred_element_type=f32, no
    rounding of the result. On the card one product with fp32 output;
    on the CPU, which has no such product, both operands upcast."""
    if x.dtype == torch.float32 or not x.is_cuda:
        return x.float() @ head.float()
    lead = x.shape[:-1]
    out = _MatmulFp32Out.apply(x.reshape(-1, x.shape[-1]), head)
    return out.reshape(*lead, head.shape[-1])


def unembed(x: torch.Tensor, params: Params, cfg: LlamaConfig
            ) -> torch.Tensor:
    """final norm → head; fp32 logits from the bf16 operands (the JAX
    einsum's preferred_element_type), then the Gemma-2 final softcap on
    them."""
    x = final_norm(x, params, cfg)
    head = params['embed'].T if cfg.tie_embeddings else params['lm_head']
    logits = logits_matmul(x, head.to(cfg.dtype))
    if cfg.final_logit_softcap:
        cap = cfg.final_logit_softcap
        logits = cap * torch.tanh(logits / cap)
    return logits


def embed(params: Params, tokens: torch.Tensor, cfg: LlamaConfig
          ) -> torch.Tensor:
    """Token embeddings in cfg.dtype; Gemma scales them by sqrt(dim),
    rounded to cfg.dtype before the multiply (55.5 in bf16 at dim 3072),
    as the JAX package does."""
    x = params['embed'][tokens.long()].to(cfg.dtype)
    if cfg.embed_scale:
        x = x * torch.full((), cfg.dim ** 0.5, dtype=cfg.dtype,
                           device=x.device)
    return x


def layer(x: torch.Tensor, lp, cfg: LlamaConfig, sin, cos,
          layer_idx: int) -> torch.Tensor:
    """One decoder layer over a whole sequence (positions from 0):
    attention by ``cfg.attention_impl`` (the plain version whenever the
    layer has a softcap, a window or sinks), then the MLP block. sin/cos
    are :func:`rope_tables`' (both bases where there are two)."""
    sin, cos = select_rope(sin, cos, layer_idx, cfg)
    q, k, v = qkv(x, lp, cfg, sin, cos)
    out = _attention(q, k, v, impl=cfg.attention_impl, causal=True,
                     **attention_switches(lp, cfg, layer_idx))
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
    sin, cos = rope_tables(cfg, positions)
    remat = cfg.remat == 'full' and torch.is_grad_enabled()
    # One unbind per stacked leaf, not an index per layer: the backward
    # of unbind stacks the L layer grads once, where indexing would
    # zero-fill and add a full [L, ...] grad for every layer.
    layers = {k: v.unbind(0) for k, v in params['layers'].items()}
    for i in range(cfg.n_layers):
        lp = {k: v[i] for k, v in layers.items()}
        if remat:
            x = torch.utils.checkpoint.checkpoint(
                layer, x, lp, cfg, sin, cos, i, use_reentrant=False)
        else:
            x = layer(x, lp, cfg, sin, cos, i)
    if return_hidden:
        return final_norm(x, params, cfg).float()
    return unembed(x, params, cfg)
