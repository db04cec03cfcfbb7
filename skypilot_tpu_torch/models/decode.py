"""Prefill and the paged decode step for the Llama family (port of
skypilot_tpu/models/decode.py: ``bucket_size``,
``cast_params_for_decode``, ``init_page_pool``, ``prefill``,
``paged_verify_step``, ``paged_decode_step``, ``chosen_logprob``,
``select_token_per_row``).

``jax.lax.scan`` over layers becomes a Python loop. The paged steps
update the pool IN PLACE: K/V for the fed positions land in each row's
pages (inactive rows on the trash page) and the returned PagedKV holds
the same tensors. On CUDA, prefill attention runs kernel A and the
step's attention kernel B; on CPU both take their plain versions.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from skypilot_tpu_torch.config import LlamaConfig, check_supported
from skypilot_tpu_torch.models import llama, paging
from skypilot_tpu_torch.ops import paged_attention as pa
from skypilot_tpu_torch.ops import rotary
from skypilot_tpu_torch.ops.attention import attention as _attention


def bucket_size(n: int, floor: int = 16) -> int:
    """Round up to a power of two (the shared prompt-bucket contract)."""
    b = floor
    while b < n:
        b *= 2
    return b


def cast_params_for_decode(params, cfg: LlamaConfig):
    """Cast every leaf to the compute dtype once, for serving (no int8
    path in this slice)."""
    def cast(v):
        if isinstance(v, dict):
            return {k: cast(x) for k, x in v.items()}
        return v.to(cfg.dtype)
    return cast(params)


def init_page_pool(cfg: LlamaConfig, n_pages: int, page_size: int,
                   batch: int, max_pages: int, device='cuda'
                   ) -> paging.PagedKV:
    """fp [L, n_pages, page_size, KH, hd] pools, a zeroed
    [batch, max_pages] int32 table (0 = trash) and zero lengths."""
    shape = (cfg.n_layers, n_pages, page_size, cfg.n_kv_heads, cfg.hd)
    return paging.PagedKV(
        k=torch.zeros(shape, dtype=cfg.dtype, device=device),
        v=torch.zeros(shape, dtype=cfg.dtype, device=device),
        table=torch.zeros((batch, max_pages), dtype=torch.int32,
                          device=device),
        length=torch.zeros((batch,), dtype=torch.int32, device=device))


def prefill(params, tokens: torch.Tensor, cfg: LlamaConfig, max_len: int,
            lengths: Optional[torch.Tensor] = None,
            attention_impl: str = 'auto'
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Process right-padded prompts in one pass. tokens [B, S] →
    (logits at each row's last content position [B, vocab] fp32,
    k [L, B, S, KH, hd], v [L, B, S, KH, hd]). The JAX version pads the
    cache rows to max_len; the engine scatters positions [0, S) into
    pages, so the port returns just those."""
    check_supported(cfg)
    b, s = tokens.shape
    if s > max_len:
        raise ValueError(f'prompt length {s} exceeds cache max_len {max_len}')
    dev = tokens.device
    if lengths is None:
        lengths = torch.full((b,), s, dtype=torch.int32, device=dev)
    x = llama.embed(params, tokens, cfg)
    sin, cos = rotary.rope_frequencies(cfg.hd, torch.arange(s, device=dev),
                                       cfg.rope_theta, cfg.rope_scaling)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        lp = llama.layer_params(params, i)
        q, k, v = llama.qkv(x, lp, cfg, sin, cos)
        out = _attention(q, k, v, impl=attention_impl, causal=True)
        x = x + llama.wo_project(out, lp, cfg)
        x = x + llama.ffn(x, lp, cfg)
        ks.append(k)
        vs.append(v)
    idx = (lengths.long() - 1)[:, None, None].expand(b, 1, x.shape[-1])
    x_last = torch.gather(x, 1, idx)
    logits = llama.unembed(x_last, params, cfg)
    return logits[:, 0], torch.stack(ks), torch.stack(vs)


def paged_verify_step(params, tokens: torch.Tensor, pcache: paging.PagedKV,
                      cfg: LlamaConfig, *, max_len: int,
                      active: Optional[torch.Tensor] = None,
                      attention_fn=pa.paged_attention_step):
    """K tokens per row at each row's own offset, over the paged pool,
    in place. tokens [B, K] → logits [B, K, vocab] fp32. ``length``
    does NOT advance. ``attention_fn`` is the per-layer paged attention
    (the default dispatches on device; the model-path check passes the
    plain formulation explicitly)."""
    check_supported(cfg)
    kk = tokens.shape[1]
    length = pcache.length
    positions = length[:, None].long() + torch.arange(
        kk, device=tokens.device)
    pid, off = paging._write_indices(pcache, positions, active)
    x = llama.embed(params, tokens, cfg)
    sin, cos = rotary.rope_frequencies(cfg.hd, positions, cfg.rope_theta,
                                       cfg.rope_scaling)
    for i in range(cfg.n_layers):
        lp = llama.layer_params(params, i)
        q, k_new, v_new = llama.qkv(x, lp, cfg, sin, cos)
        out, _, _ = attention_fn(q, pcache.k[i], pcache.v[i], pcache.table,
                                 length, k_new, v_new, pid, off,
                                 max_len=max_len)
        x = x + llama.wo_project(out, lp, cfg)
        x = x + llama.ffn(x, lp, cfg)
    return llama.unembed(x, params, cfg), pcache


def paged_decode_step(params, token: torch.Tensor, pcache: paging.PagedKV,
                      cfg: LlamaConfig, *, max_len: int,
                      active: Optional[torch.Tensor] = None,
                      attention_fn=pa.paged_attention_step):
    """One in-place paged decode step: token [B] → logits [B, vocab];
    active rows' lengths advance by one."""
    logits, pcache = paged_verify_step(params, token[:, None], pcache, cfg,
                                       max_len=max_len, active=active,
                                       attention_fn=attention_fn)
    advance = 1 if active is None else active.to(pcache.length.dtype)
    pcache.length += advance
    return logits[:, 0], pcache


def chosen_logprob(logits: torch.Tensor, tokens: torch.Tensor
                   ) -> torch.Tensor:
    """log P(token) under the unmodified distribution: [B, V], [B] →
    [B] fp32."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, 1, tokens.long()[:, None])[:, 0]
    return gold - logz


def filter_logits(logits: torch.Tensor, temperature: torch.Tensor,
                  top_k: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """The per-row sampling distribution's logits: temperature-scaled,
    then top-k, then top-p (nucleus) masked to the fp32 minimum —
    ``select_token_per_row``'s mask construction, row by row.
    temperature [B] (<= 0 → greedy, scale 1), top_k [B] (<= 0 → off),
    top_p [B] (outside (0, 1) → off)."""
    logits = logits.float()
    v = logits.shape[-1]
    greedy = temperature <= 0.0
    scaled = logits / torch.where(greedy, torch.ones_like(temperature),
                                  temperature)[:, None]
    neg_inf = torch.finfo(torch.float32).min
    asc = torch.sort(scaled, dim=-1).values
    k = torch.clamp(top_k.long(), 1, v)
    kth = torch.gather(asc, 1, (v - k)[:, None])
    use_k = (top_k > 0)[:, None]
    scaled = torch.where(use_k & (scaled < kth),
                         torch.full_like(scaled, neg_inf), scaled)
    desc = torch.sort(scaled, dim=-1, descending=True).values
    probs = torch.softmax(desc, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    use_p = (top_p > 0.0) & (top_p < 1.0)
    p_eff = torch.where(use_p, top_p, torch.ones_like(top_p))[:, None]
    keep = (cum - probs) < p_eff                     # rank 0 always kept
    cutoff = torch.where(keep, desc, torch.full_like(desc, float('inf'))
                         ).min(dim=-1, keepdim=True).values
    return torch.where(use_p[:, None] & (scaled < cutoff),
                       torch.full_like(scaled, neg_inf), scaled)


def select_token_per_row(logits: torch.Tensor, temperature: torch.Tensor,
                         top_k: torch.Tensor, top_p: torch.Tensor,
                         generator: Optional[torch.Generator]
                         ) -> torch.Tensor:
    """Per-row greedy (temperature <= 0) or filtered sampling. Sampling
    is Gumbel-max over :func:`filter_logits` with noise drawn from
    ``generator`` — the same distribution as jax.random.categorical,
    not the same draws."""
    logits = logits.float()
    scaled = filter_logits(logits, temperature, top_k, top_p)
    u = torch.rand(scaled.shape, generator=generator, device=scaled.device)
    u = u.clamp_(min=torch.finfo(torch.float32).tiny)
    sampled = torch.argmax(scaled - torch.log(-torch.log(u)), dim=-1)
    greedy = torch.argmax(logits, dim=-1)
    return torch.where(temperature <= 0.0, greedy, sampled).to(torch.int32)
