"""Prefill, the decode steps and generation for the Llama family (port
of skypilot_tpu/models/decode.py: ``bucket_size``, ``KVCache``,
``QuantizedWeight``, ``_quantize_int8``, ``_d``,
``cast_params_for_decode``, ``init_cache``, ``init_page_pool``,
``prefill``, ``prefill_extend``, ``verify_step``, ``decode_step``,
``paged_prefill_extend``, ``paged_verify_step``, ``paged_decode_step``,
``generate_speculative``, ``_select_token``, ``top_k_logprobs``,
``chosen_logprob``, ``select_token_per_row`` with its penalties,
``generate``).

``jax.lax.scan`` over layers becomes a Python loop. Two cache families:
  - the contiguous ``KVCache`` [L, B, max_len, KH, hd] of
    :func:`generate` (offline batch inference, models/batch_infer.py):
    :func:`prefill_cache` fills it, :func:`verify_step` /
    :func:`decode_step` write each fed position's K/V into it IN PLACE
    and attend over the whole row with the plain attention, as JAX's
    contiguous steps do (``impl='xla'``);
  - the block-paged ``PagedKV`` of the engine: the paged steps write
    K/V into each row's pages in place (inactive rows on the trash
    page) and attend through kernel B on the card.
Prefill attention runs kernel A on the card and its plain version on
the CPU. An extend over a prefix (``p > 0``) attends at a position
offset, which the flash kernel does not take, so it runs the plain
attention on every device, as the JAX gate routes it; an extend at
``p == 0`` is a prefill and takes kernel A. A layer with an attention
softcap, a sliding window or sinks (Gemma-2/3, gpt-oss) takes the
plain versions on every device, as its JAX counterpart does; the
embedding scale, per-layer rope tables, post norms and final softcap
come with the shared layer math of models/llama.py. An MoE config
(models/moe.py) takes the same paths with its routed FFN in place of
the gated MLP (:func:`_ffn`). Every layer product reads its weight
through ``_d`` (models/quant.py), so the same paths serve weight-only
int8 params (:func:`cast_params_for_decode`).

On the card :func:`generate` captures one decode step (step, token
choice, EOS update) into a CUDA graph and replays it, with no host sync
per token: the counterpart of JAX's single jitted program. A capture
that fails raises; nothing falls back to eager steps on the card. On
the CPU the same step body runs eagerly.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from skypilot_tpu_torch.config import LlamaConfig, MoEConfig, check_supported
from skypilot_tpu_torch.kernels import build
from skypilot_tpu_torch.models import llama, moe, paging
# Re-exported: decode is where the JAX package keeps these names.
from skypilot_tpu_torch.models.quant import (  # noqa: F401
    _QUANT_KEYS, QuantizedWeight, _d, _quantize_int8)
from skypilot_tpu_torch.ops import paged_attention as pa
from skypilot_tpu_torch.ops.attention import attention as _attention


def bucket_size(n: int, floor: int = 16) -> int:
    """Round up to a power of two (the shared prompt-bucket contract)."""
    b = floor
    while b < n:
        b *= 2
    return b


@dataclasses.dataclass
class KVCache:
    """The contiguous cache: k/v [L, B, T, KH, hd] with T = max_len,
    length [B] int32, each row's valid prefix (ragged rows share one
    cache: pad slots are causally masked and overwritten before they
    are attended). The steps update it in place."""
    k: torch.Tensor
    v: torch.Tensor
    length: torch.Tensor


def check_quantize(cfg: LlamaConfig, quantize: Optional[str]) -> None:
    """The JAX refusals of ``cast_params_for_decode``: ``quantize`` None
    or 'int8', and int8 not for an MoE config (its expert dispatch does
    not read through ``_d``)."""
    if quantize not in (None, 'int8'):
        raise ValueError(f"quantize must be None or 'int8', got "
                         f'{quantize!r}')
    if quantize == 'int8' and isinstance(cfg, MoEConfig):
        raise NotImplementedError(
            'int8 decode is implemented for the dense Llama and MLA '
            'families (MoE expert dispatch is not quant-aware yet).')


def cast_params_for_decode(params, cfg: LlamaConfig,
                           quantize: Optional[str] = None):
    """Cast the weights to the compute dtype once, for serving; with
    ``quantize='int8'`` every layer projection named in ``_QUANT_KEYS``
    of 2 or 3 dims becomes a :class:`QuantizedWeight`, quantized from
    the weights as given (pass the fp32 masters), and the rest is cast.
    DeepSeekMoE's 4-D routed-expert stacks stay dense; an MoE config
    raises NotImplementedError, as in JAX."""
    check_quantize(cfg, quantize)

    def cast(v):
        if isinstance(v, dict):
            return {k: cast(x) for k, x in v.items()}
        return v.to(cfg.dtype)
    if quantize != 'int8':
        return cast(params)
    out = {}
    for key, sub in params.items():
        if key != 'layers':
            out[key] = cast(sub)
            continue
        out[key] = {k: (_quantize_int8(w) if k in _QUANT_KEYS and
                        2 <= w.ndim <= 3 else w.to(cfg.dtype))
                    for k, w in sub.items()}
    return out


def cast_params_for_compute(params, cfg: LlamaConfig, device=None):
    """The fp32 params tree with every leaf the model casts to
    ``cfg.dtype`` at use cast once now, and the leaves it reads in fp32
    (``llama.FP32_AT_USE``) left as they are, each then moved to
    ``device`` (default: where it is). The forward and generate give
    the same bits on either tree, as JAX's generate from fp32 params
    does, and the cast tree holds about half the bytes."""
    def cast(key, v):
        if isinstance(v, dict):
            return {k: cast(k, x) for k, x in v.items()}
        if not any(tag in key for tag in llama.FP32_AT_USE):
            v = v.to(cfg.dtype)
        return v if device is None else v.to(device)
    return {k: cast(k, v) for k, v in params.items()}


def init_cache(cfg: LlamaConfig, batch: int, max_len: int,
               device='cuda') -> KVCache:
    """Zeroed [L, batch, max_len, KH, hd] K/V in cfg.dtype (this rank's
    kv heads under a tensor mesh), zero lengths."""
    shape = (cfg.n_layers, batch, max_len, llama.local_kv_heads(cfg),
             cfg.hd)
    return KVCache(k=torch.zeros(shape, dtype=cfg.dtype, device=device),
                   v=torch.zeros(shape, dtype=cfg.dtype, device=device),
                   length=torch.zeros((batch,), dtype=torch.int32,
                                      device=device))


def _ffn(x: torch.Tensor, lp, cfg: LlamaConfig) -> torch.Tensor:
    """Post-attention FFN block: the dense gated MLP, or for an MoE
    config ``moe_norm`` → the routed experts with the aux dropped, as
    JAX's ``decode._ffn`` does. Each call routes its own [B, S] tokens
    in groups along S, so at a decode step (S = 1) every row is a group
    of one token, whose distinct top-k choices the min-8 capacity never
    drops; a prefill routes its pad tokens too (the JAX caveat at
    ``decode.prefill``)."""
    if isinstance(cfg, MoEConfig):
        return moe.ffn(x, lp, cfg)[0]
    return llama.ffn(x, lp, cfg)


def check_kv_quant(quant: str) -> None:
    """The pool representations: 'none' (cfg.dtype) or 'int8'."""
    if quant not in ('none', 'int8'):
        raise ValueError(f"kv quant must be 'none' or 'int8', got "
                         f'{quant!r}')


def init_page_pool(cfg: LlamaConfig, n_pages: int, page_size: int,
                   batch: int, max_pages: int, device='cuda', *,
                   quant: str = 'none') -> paging.PagedKV:
    """[L, n_pages, page_size, KH, hd] pools (KH: this rank's kv heads
    under a tensor mesh, as the JAX ``paged_pspecs`` put them and their
    sidecars on 'tensor'), a zeroed [batch, max_pages] int32 table
    (0 = trash) and zero lengths. ``quant='int8'``
    (SKYTPU_ENGINE_KV_QUANT) pools int8 codes with [L, n_pages,
    page_size, KH] fp32 scale sidecars, two distinct tensors; 'none'
    pools cfg.dtype values and no sidecars."""
    check_kv_quant(quant)
    shape = (cfg.n_layers, n_pages, page_size, llama.local_kv_heads(cfg),
             cfg.hd)
    int8 = quant == 'int8'
    dt = torch.int8 if int8 else cfg.dtype

    def scale():
        return (torch.zeros(shape[:-1], dtype=torch.float32, device=device)
                if int8 else None)
    return paging.PagedKV(
        k=torch.zeros(shape, dtype=dt, device=device),
        v=torch.zeros(shape, dtype=dt, device=device),
        table=torch.zeros((batch, max_pages), dtype=torch.int32,
                          device=device),
        length=torch.zeros((batch,), dtype=torch.int32, device=device),
        k_scale=scale(), v_scale=scale())


def _prefill_layers(params, tokens: torch.Tensor, cfg: LlamaConfig,
                    max_len: int, lengths: Optional[torch.Tensor],
                    attention_impl: str,
                    store: Callable[[int, torch.Tensor, torch.Tensor], None]
                    ) -> torch.Tensor:
    """The prefill pass of both cache forms: ``store(i, k, v)`` takes
    layer i's K/V [B, S, KH, hd]; returns the logits at each row's last
    content position, [B, vocab] fp32."""
    check_supported(cfg)
    b, s = tokens.shape
    if s > max_len:
        raise ValueError(f'prompt length {s} exceeds cache max_len {max_len}')
    dev = tokens.device
    if lengths is None:
        lengths = torch.full((b,), s, dtype=torch.int32, device=dev)
    x = llama.embed(params, tokens, cfg)
    sin, cos = llama.rope_tables(cfg, torch.arange(s, device=dev))
    for i in range(cfg.n_layers):
        lp = llama.layer_params(params, i)
        q, k, v = llama.qkv(x, lp, cfg,
                            *llama.select_rope(sin, cos, i, cfg))
        out = _attention(q, k, v, impl=attention_impl, causal=True,
                         **llama.attention_switches(lp, cfg, i))
        x = x + llama.wo_project(out, lp, cfg)
        x = x + _ffn(x, lp, cfg)
        store(i, k, v)
    idx = (lengths.long() - 1)[:, None, None].expand(b, 1, x.shape[-1])
    x_last = torch.gather(x, 1, idx)
    return llama.unembed(x_last, params, cfg)[:, 0]


def prefill(params, tokens: torch.Tensor, cfg: LlamaConfig, max_len: int,
            lengths: Optional[torch.Tensor] = None,
            attention_impl: str = 'auto'
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Process right-padded prompts in one pass. tokens [B, S] →
    (logits at each row's last content position [B, vocab] fp32,
    k [L, B, S, KH, hd], v [L, B, S, KH, hd]). The JAX version pads the
    cache rows to max_len; the engine scatters positions [0, S) into
    pages, so this form returns just those, and :func:`prefill_cache`
    is the padded one."""
    ks, vs = [], []

    def store(i, k, v):
        ks.append(k)
        vs.append(v)
    logits = _prefill_layers(params, tokens, cfg, max_len, lengths,
                             attention_impl, store)
    return logits, torch.stack(ks), torch.stack(vs)


def prefill_cache(params, tokens: torch.Tensor, cfg: LlamaConfig,
                  max_len: int, lengths: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, KVCache]:
    """JAX ``prefill``: right-padded prompts tokens [B, S] (``lengths``
    [B] the real lengths, ragged rows allowed) → (logits at each row's
    last content position [B, vocab] fp32, a :class:`KVCache` of
    max_len positions holding [0, S), length = lengths). The attention
    is ``cfg.attention_impl``'s, as in JAX ('auto': kernel A on the
    card). Each layer's K/V goes straight into the cache;
    :func:`prefill` is the engine's unpadded form of the same pass."""
    b, s = tokens.shape
    cache = init_cache(cfg, b, max_len, device=tokens.device)

    def store(i, k, v):
        cache.k[i, :, :s] = k
        cache.v[i, :, :s] = v
    logits = _prefill_layers(params, tokens, cfg, max_len, lengths,
                             cfg.attention_impl, store)
    if lengths is None:
        cache.length.fill_(s)
    else:
        cache.length.copy_(lengths)
    return logits, cache


def prefill_extend(params, tokens: torch.Tensor, cfg: LlamaConfig,
                   max_len: int, prefix_k: torch.Tensor,
                   prefix_v: torch.Tensor,
                   lengths: Optional[torch.Tensor] = None,
                   attention_impl: str = 'auto'
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Prefill a right-padded SUFFIX tokens [B, S2] over a computed
    prefix prefix_k/v [L, B, P, KH, hd] (every row a full P-token
    prefix; ``lengths`` [B] the real suffix lengths). The suffix runs at
    positions P..P+S2, for rope and for the causal offset, attending
    [prefix ++ suffix]: the math of a prefill of the whole sequence.
    Returns (logits at each row's last content position [B, vocab]
    fp32, the suffix's k [L, B, S2, KH, hd], v), the shape contract of
    :func:`prefill`; the JAX version returns the whole padded cache."""
    check_supported(cfg)
    b, s2 = tokens.shape
    p = prefix_k.shape[2]
    if p + s2 > max_len:
        raise ValueError(f'prefix ({p}) + suffix ({s2}) exceeds max_len '
                         f'({max_len})')
    dev = tokens.device
    if lengths is None:
        lengths = torch.full((b,), s2, dtype=torch.int32, device=dev)
    x = llama.embed(params, tokens, cfg)
    sin, cos = llama.rope_tables(cfg, torch.arange(s2, device=dev) + p)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        lp = llama.layer_params(params, i)
        q, k, v = llama.qkv(x, lp, cfg,
                            *llama.select_rope(sin, cos, i, cfg))
        k_all = torch.cat([prefix_k[i].to(k.dtype), k], dim=1)
        v_all = torch.cat([prefix_v[i].to(v.dtype), v], dim=1)
        out = _attention(q, k_all, v_all, impl=attention_impl, causal=True,
                         q_offset=p, **llama.attention_switches(lp, cfg, i))
        x = x + llama.wo_project(out, lp, cfg)
        x = x + _ffn(x, lp, cfg)
        ks.append(k)
        vs.append(v)
    idx = (lengths.long() - 1)[:, None, None].expand(b, 1, x.shape[-1])
    logits = llama.unembed(torch.gather(x, 1, idx), params, cfg)
    return logits[:, 0], torch.stack(ks), torch.stack(vs)


def paged_prefill_extend(params, tokens: torch.Tensor,
                         pcache: paging.PagedKV, cfg: LlamaConfig, *,
                         slot: int, p: int, lengths,
                         attention_impl: str = 'auto') -> torch.Tensor:
    """:func:`prefill_extend` for ONE paged row, in place: the [1, S2]
    suffix attends [prefix ++ suffix], the prefix gathered per layer
    from the (possibly shared) pages that row ``slot``'s table covers,
    and the suffix K/V written straight into the row's own pages (a
    position past the row's reservation lands on the trash page);
    length[slot] = p + lengths. The chunked-prefill and prefix-hit
    program of the engine. Returns the logits at the last content
    position, [1, vocab] fp32.

    At ``p == 0`` the attention is a plain prefill and takes kernel A
    on the card; at ``p > 0`` it carries an offset and takes the plain
    version (the JAX gate). A suffix reaching past the table's coverage
    raises: the JAX gather would clamp it onto a live page. On an int8
    pool the suffix attends its own DEQUANTIZED K/V (what later steps
    read), the gathered prefix dequantizes per layer, and codes and
    scales are written."""
    check_supported(cfg)
    b, s2 = tokens.shape
    psz, maxp = pcache.page_size, pcache.max_pages
    if b != 1:
        raise ValueError(f'paged_prefill_extend takes one row, got {b}')
    if p + s2 > maxp * psz:
        raise ValueError(f'paged_prefill_extend: prefix ({p}) + suffix '
                         f'({s2}) exceeds the table\'s {maxp} pages of '
                         f'{psz}')
    dev = tokens.device
    row = pcache.table[slot].long()
    pre_pos = torch.arange(p, device=dev)
    pre_pid, pre_off = row[pre_pos // psz], pre_pos % psz
    suf_pos = torch.arange(s2, device=dev) + p
    suf_pid, suf_off = row[suf_pos // psz], suf_pos % psz
    lengths = torch.as_tensor(lengths, dtype=torch.int32,
                              device=dev).reshape(b)
    x = llama.embed(params, tokens, cfg)
    sin, cos = llama.rope_tables(cfg, suf_pos)
    scales = paging._scale_pools(pcache)
    for i in range(cfg.n_layers):
        lp = llama.layer_params(params, i)
        q, k, v = llama.qkv(x, lp, cfg,
                            *llama.select_rope(sin, cos, i, cfg))
        kp, vp = pcache.k[i], pcache.v[i]
        pk, pv = kp[pre_pid, pre_off][None], vp[pre_pid, pre_off][None]
        if scales is not None:
            ks, vs = scales['k'][i], scales['v'][i]
            (kq, ks_new), (vq, vs_new) = (pa.quantize_values(k),
                                          pa.quantize_values(v))
            k = pa.dequantize_values(kq, ks_new, k.dtype)
            v = pa.dequantize_values(vq, vs_new, v.dtype)
            pk = pa.dequantize_values(pk, ks[pre_pid, pre_off][None],
                                      k.dtype)
            pv = pa.dequantize_values(pv, vs[pre_pid, pre_off][None],
                                      v.dtype)
        k_all = torch.cat([pk.to(k.dtype), k], 1)
        v_all = torch.cat([pv.to(v.dtype), v], 1)
        out = _attention(q, k_all, v_all, impl=attention_impl, causal=True,
                         q_offset=p, **llama.attention_switches(lp, cfg, i))
        if scales is None:
            kp[suf_pid, suf_off] = k[0].to(kp.dtype)
            vp[suf_pid, suf_off] = v[0].to(vp.dtype)
        else:
            kp[suf_pid, suf_off], ks[suf_pid, suf_off] = kq[0], ks_new[0]
            vp[suf_pid, suf_off], vs[suf_pid, suf_off] = vq[0], vs_new[0]
        x = x + llama.wo_project(out, lp, cfg)
        x = x + _ffn(x, lp, cfg)
    idx = (lengths.long() - 1)[:, None, None].expand(b, 1, x.shape[-1])
    logits = llama.unembed(torch.gather(x, 1, idx), params, cfg)
    pcache.length[slot] = (lengths[0] + p).to(pcache.length.dtype)
    return logits[:, 0]


def paged_verify_step(params, tokens: torch.Tensor, pcache: paging.PagedKV,
                      cfg: LlamaConfig, *, max_len: int,
                      active: Optional[torch.Tensor] = None,
                      attention_fn=pa.paged_attention_step):
    """K tokens per row at each row's own offset, over the paged pool,
    in place. tokens [B, K] → logits [B, K, vocab] fp32. ``length``
    does NOT advance. ``attention_fn`` is the per-layer paged attention
    (the default dispatches on device; the model-path check passes the
    plain formulation explicitly). An int8 pool hands each layer its
    scale sidecars, which the step reads and writes in place."""
    check_supported(cfg)
    kk = tokens.shape[1]
    length = pcache.length
    positions = length[:, None].long() + torch.arange(
        kk, device=tokens.device)
    pid, off = paging._write_indices(pcache, positions, active)
    x = llama.embed(params, tokens, cfg)
    sin, cos = llama.rope_tables(cfg, positions)
    scales = paging._scale_pools(pcache)
    for i in range(cfg.n_layers):
        lp = llama.layer_params(params, i)
        q, k_new, v_new = llama.qkv(x, lp, cfg,
                                    *llama.select_rope(sin, cos, i, cfg))
        quant = {} if scales is None else {'k_scale': scales['k'][i],
                                           'v_scale': scales['v'][i]}
        out = attention_fn(q, pcache.k[i], pcache.v[i], pcache.table,
                           length, k_new, v_new, pid, off, max_len=max_len,
                           **llama.attention_switches(lp, cfg, i),
                           **quant)[0]
        x = x + llama.wo_project(out, lp, cfg)
        x = x + _ffn(x, lp, cfg)
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


def top_k_logprobs(logits: torch.Tensor, k: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k alternative logprobs of the unpenalized model distribution
    (OpenAI ``logprobs=N``): [..., V] logits → (values [..., k] fp32,
    ids [..., k] int32), values minus the logsumexp."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1, keepdim=True)
    v, i = torch.topk(logits, k, dim=-1)
    return v - lse, i.to(torch.int32)


def chosen_logprob(logits: torch.Tensor, tokens: torch.Tensor
                   ) -> torch.Tensor:
    """log P(token) under the unmodified distribution: [B, V], [B] →
    [B] fp32."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, 1, tokens.long()[:, None])[:, 0]
    return gold - logz


def penalize(logits: torch.Tensor, counts: Optional[torch.Tensor],
             presence: Optional[torch.Tensor],
             frequency: Optional[torch.Tensor]) -> torch.Tensor:
    """OpenAI repetition penalties: fp32 logits [B, V] lose
    presence·1[count>0] + frequency·count, with ``counts`` [B, V] int32
    of the row's generated tokens and per-row ``presence`` /
    ``frequency`` [B] fp32. No ``counts``: the logits as they are."""
    logits = logits.float()
    if counts is None:
        return logits
    pen = (presence[:, None] * (counts > 0).float() +
           frequency[:, None] * counts.float())
    return logits - pen


def filter_logits(logits: torch.Tensor, temperature: torch.Tensor,
                  top_k: torch.Tensor, top_p: torch.Tensor,
                  counts: Optional[torch.Tensor] = None,
                  presence: Optional[torch.Tensor] = None,
                  frequency: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The per-row sampling distribution's logits: penalized
    (:func:`penalize`), temperature-scaled, then top-k, then top-p
    (nucleus) masked to the fp32 minimum — ``select_token_per_row``'s
    mask construction, row by row. temperature [B] (<= 0 → greedy,
    scale 1), top_k [B] (<= 0 → off), top_p [B] (outside (0, 1) →
    off)."""
    logits = penalize(logits, counts, presence, frequency)
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
                         generator: Optional[torch.Generator],
                         counts: Optional[torch.Tensor] = None,
                         presence: Optional[torch.Tensor] = None,
                         frequency: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Per-row greedy (temperature <= 0) or filtered sampling. Sampling
    is Gumbel-max over :func:`filter_logits` with noise drawn from
    ``generator`` — the same distribution as jax.random.categorical,
    not the same draws. ``counts`` (+ ``presence`` / ``frequency``):
    the penalties, applied before temperature and filtering, so they
    bite in greedy mode too. No host sync: the engine captures this in
    CUDA graphs."""
    logits = penalize(logits, counts, presence, frequency)
    sampled = _gumbel_argmax(filter_logits(logits, temperature, top_k,
                                           top_p), generator)
    greedy = torch.argmax(logits, dim=-1)
    return torch.where(temperature <= 0.0, greedy, sampled).to(torch.int32)


def _gumbel_argmax(logits: torch.Tensor,
                   generator: Optional[torch.Generator]) -> torch.Tensor:
    """One draw from softmax(logits) per row: the argmax of the logits
    plus Gumbel noise made from ``generator``'s uniforms, the
    construction of jax.random.categorical (its distribution, not its
    draws: Philox is not threefry)."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    u = u.clamp_(min=torch.finfo(torch.float32).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


# ---------------------------------------------------------------------------
# The contiguous cache: steps, generation, speculation
# ---------------------------------------------------------------------------

def put_positions(dst: torch.Tensor, positions: torch.Tensor,
                  new: torch.Tensor) -> None:
    """dst[b, positions[b, j]] = new[b, j] in place, for dst [B, T, ...],
    positions [B, K] running on from each row's length and new
    [B, K, ...]. A position at or past T is dropped, as JAX's scatter
    drops it: its write goes instead to the row's slot min(length, T) - 1,
    which no kept write of the row touches, with that slot's own value.
    Static shapes, no host sync (K must not exceed T)."""
    b, t = dst.shape[:2]
    rows = torch.arange(b, device=dst.device)[:, None]
    keep = positions < t
    spare = (positions[:, :1].clamp(max=t) - 1).clamp(min=0)
    idx = torch.where(keep, positions, spare)
    keep = keep.view(keep.shape + (1,) * (new.dim() - 2))
    dst[rows, idx] = torch.where(keep, new.to(dst.dtype), dst[rows, spare])


def verify_step(params, tokens: torch.Tensor, cache: KVCache,
                cfg: LlamaConfig) -> Tuple[torch.Tensor, KVCache]:
    """K tokens per row at each row's own offset in one call. tokens
    [B, K] → (logits [B, K, vocab] fp32, the cache): K/V for the K
    positions [length, length + K) are written into the cache in place
    and ``length`` does NOT advance — the caller commits what it
    accepts (stale K/V past the committed length is causally masked and
    overwritten later). The attention is the plain one over the row's
    whole max_len, as JAX's ``impl='xla'``. Writes at positions at or
    past max_len are dropped, as JAX's are (:func:`put_positions`). No
    shape depends on the data and nothing syncs the host, so the step
    captures into a CUDA graph."""
    check_supported(cfg)
    b, kk = tokens.shape
    dev = tokens.device
    length = cache.length
    positions = length[:, None].long() + torch.arange(kk, device=dev)
    x = llama.embed(params, tokens, cfg)
    sin, cos = llama.rope_tables(cfg, positions)
    for i in range(cfg.n_layers):
        lp = llama.layer_params(params, i)
        q, k_new, v_new = llama.qkv(x, lp, cfg,
                                    *llama.select_rope(sin, cos, i, cfg))
        k_l, v_l = cache.k[i], cache.v[i]
        put_positions(k_l, positions, k_new)
        put_positions(v_l, positions, v_new)
        out = _attention(q, k_l, v_l, impl='xla', causal=True,
                         q_offset=length,
                         **llama.attention_switches(lp, cfg, i))
        x = x + llama.wo_project(out, lp, cfg)
        x = x + _ffn(x, lp, cfg)
    return llama.unembed(x, params, cfg), cache


def decode_step(params, token: torch.Tensor, cache: KVCache,
                cfg: LlamaConfig, active: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, KVCache]:
    """One step: token [B] → (logits [B, vocab] fp32, the cache), the
    K = 1 case of :func:`verify_step` plus the length advance, in
    place. ``active`` [B] bool: rows where it is False do not advance
    (their write lands on the frozen ``length`` slot, which the next
    step overwrites)."""
    logits, cache = verify_step(params, token[:, None], cache, cfg)
    cache.length += 1 if active is None else active.to(cache.length.dtype)
    return logits[:, 0], cache


def _select_token(logits: torch.Tensor, temperature: float,
                  generator: Optional[torch.Generator],
                  top_k: Optional[int] = None,
                  top_p: Optional[float] = None) -> torch.Tensor:
    """Greedy (temperature <= 0, or no generator) or filtered sampling
    for the whole batch: int32 [B]. The masks are
    :func:`filter_logits`' with every row's values the same (top_k None
    or <= 0 and top_p None or outside (0, 1) turn them off; a top_k past
    the vocab keeps every token, as JAX's clamped index does); the draw
    is Gumbel-max from ``generator``. Static shapes, no host sync."""
    if temperature <= 0.0 or generator is None:
        return torch.argmax(logits, dim=-1).to(torch.int32)

    def rows(value):
        return torch.full(logits.shape[:1], value, dtype=torch.float32,
                          device=logits.device)
    scaled = filter_logits(logits, rows(temperature), rows(top_k or 0),
                           rows(1.0 if top_p is None else top_p))
    return _gumbel_argmax(scaled, generator).to(torch.int32)


def replay_steps(body: Callable[[], None], warm: Callable[[], None],
                 n: int, generator: torch.Generator,
                 device: torch.device) -> None:
    """Run ``body`` (one generation step, updating tensors in place) n
    times. On the CPU eagerly. On the card: ``warm`` (the step's work
    with nothing a later step reads changed) runs once on a side stream
    so that lazily made state exists, ``generator``'s state is put back,
    then ``body`` is captured into one CUDA graph, with the generator
    registered, and replayed n times with no host sync. A capture that
    fails raises. Kernel launches captured in the graph count once per
    replay (``Kernel.replayed``)."""
    if n <= 0:
        return
    if device.type != 'cuda':
        for _ in range(n):
            body()
        return
    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    state = generator.get_state()
    with torch.cuda.stream(stream):
        warm()
    generator.set_state(state)
    before = build.captured()
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(generator)
    with torch.cuda.graph(graph, stream=stream,
                          capture_error_mode='thread_local'):
        body()
    after = build.captured()
    launched = {k: after[k] - before.get(k, 0) for k in after
                if after[k] > before.get(k, 0)}
    kernels = build.kernels()
    for _ in range(n):
        graph.replay()
        for name, c in launched.items():
            kernels[name].replayed(c)


def run_generate(step: Callable[..., torch.Tensor], logits: torch.Tensor,
                 max_new_tokens: int, *, temperature: float,
                 eos_id: Optional[int], top_k: Optional[int],
                 top_p: Optional[float],
                 generator: torch.Generator) -> torch.Tensor:
    """The token loop of both cache families' ``generate``: the first
    token from the prefill ``logits`` [B, V], then max_new_tokens - 1
    steps, each ``step(tok, active)`` → logits (advancing its cache for
    the active rows, all when ``active`` is None) → :func:`_select_token`
    → the EOS fill (after a row's EOS every token is EOS). The steps run
    through :func:`replay_steps`; the warm-up step has every row
    inactive. Returns [B, max_new_tokens] int32."""
    b, dev = logits.shape[0], logits.device
    out = torch.zeros((b, max(max_new_tokens, 0)), dtype=torch.int32,
                      device=dev)
    if max_new_tokens <= 0:
        return out
    tok = _select_token(logits, temperature, generator, top_k, top_p)
    out[:, 0] = tok
    done = (tok == eos_id) if eos_id is not None else None
    col = torch.ones((1,), dtype=torch.long, device=dev)
    inactive = torch.zeros((b,), dtype=torch.bool, device=dev)

    def body():
        nxt = _select_token(step(tok, None), temperature, generator, top_k,
                            top_p)
        if done is not None:
            nxt = torch.where(done, eos_id, nxt)
            done.logical_or_(nxt == eos_id)
        tok.copy_(nxt)
        out.index_copy_(1, col, nxt[:, None])
        col.add_(1)

    def warm():
        _select_token(step(tok, inactive), temperature, generator, top_k,
                      top_p)

    replay_steps(body, warm, max_new_tokens - 1, generator, dev)
    return out


@torch.no_grad()
def generate(params, prompt: torch.Tensor, cfg: LlamaConfig,
             max_new_tokens: int, *, max_len: Optional[int] = None,
             temperature: float = 0.0, eos_id: Optional[int] = None,
             top_k: Optional[int] = None, top_p: Optional[float] = None,
             prompt_lengths: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Greedy / temperature / top-k / top-p generation over the
    contiguous cache: prompt [B, S] → [B, max_new_tokens] int32 (after
    a row's EOS every position is EOS). ``prompt_lengths`` [B] serves
    ragged right-padded rows. ``generator`` (default: seed 0 on the
    prompt's device) draws the samples: the same distribution as JAX's
    ``rng``, not the same draws. The prefill's attention is
    ``cfg.attention_impl``'s (kernel A on the card under 'auto'); the
    steps take the plain attention. On the card the steps replay one
    CUDA graph (:func:`replay_steps`)."""
    b, s = prompt.shape
    if max_len is None:
        max_len = min(cfg.max_seq_len, s + max_new_tokens)
    if s + max_new_tokens > max_len:
        raise ValueError(
            f'prompt ({s}) + max_new_tokens ({max_new_tokens}) exceeds '
            f'max_len ({max_len})')
    if generator is None:
        generator = torch.Generator(device=prompt.device).manual_seed(0)
    logits, cache = prefill_cache(params, prompt, cfg, max_len,
                                  lengths=prompt_lengths)

    def step(tok, active):
        return decode_step(params, tok, cache, cfg, active=active)[0]
    return run_generate(step, logits, max_new_tokens,
                        temperature=temperature, eos_id=eos_id, top_k=top_k,
                        top_p=top_p, generator=generator)


@torch.no_grad()
def generate_speculative(params, cfg: LlamaConfig, draft_params,
                         draft_cfg: LlamaConfig, prompt: torch.Tensor,
                         max_new_tokens: int, *, k: int = 4,
                         max_len: Optional[int] = None,
                         eos_id: Optional[int] = None,
                         prompt_lengths: Optional[torch.Tensor] = None,
                         return_stats: bool = False):
    """Greedy speculative decoding: the draft proposes k tokens by k
    decode steps, the target scores them in one K-wide
    :func:`verify_step`, and each row commits its agreeing run plus the
    target's own next token, so the output is exactly the target's
    greedy :func:`generate` whatever the draft. Rounds are
    host-synchronous, as in JAX. Near max_len k shrinks to fit (a round
    needs 2k slots past prompt + max_new_tokens); when even k = 1 does
    not fit it falls back to :func:`generate`. ``return_stats`` adds
    {'rounds': n} ({'rounds': max_new_tokens, 'fallback': True} on the
    fallback). The draft's vocab must cover the target's."""
    b, s = prompt.shape
    dev = prompt.device
    if draft_cfg.vocab_size < cfg.vocab_size:
        raise ValueError(
            f'draft vocab {draft_cfg.vocab_size} < target vocab '
            f'{cfg.vocab_size}: draft proposals could be unscorable')
    if max_len is None:
        max_len = min(cfg.max_seq_len, s + max_new_tokens + 2 * k)
    budget = max_len - s - max_new_tokens
    if budget < 2 * k:
        k = budget // 2
        if k < 1:
            out = generate(params, prompt, cfg, max_new_tokens,
                           max_len=max_len, eos_id=eos_id,
                           prompt_lengths=prompt_lengths)
            if return_stats:
                return out, {'rounds': max_new_tokens, 'fallback': True}
            return out
    if max_new_tokens <= 0:
        out = torch.zeros((b, 0), dtype=torch.int32, device=dev)
        return (out, {'rounds': 0}) if return_stats else out

    t_logits, t_cache = prefill_cache(params, prompt, cfg, max_len,
                                      lengths=prompt_lengths)
    _, d_cache = prefill_cache(draft_params, prompt, draft_cfg, max_len,
                               lengths=prompt_lengths)
    last = torch.argmax(t_logits, dim=-1).to(torch.int32)
    out = np.zeros((b, max_new_tokens), np.int32)
    count = np.ones((b,), np.int64)     # committed tokens per row
    done = np.zeros((b,), bool)
    last_h = last.cpu().numpy()
    out[:, 0] = last_h
    if eos_id is not None:
        done |= (last_h == eos_id)
        count[done] = max_new_tokens
        out[done, :] = eos_id

    # At the top of each round both caches hold K/V for every committed
    # token but ``last``, and both lengths advance by what a round
    # commits.
    rounds = 0
    while count.min() < max_new_tokens:
        rounds += 1
        t_len0 = t_cache.length.clone()
        d_len0 = d_cache.length.clone()
        proposals = []
        d_tok = last
        for _ in range(k):
            dl, _ = decode_step(draft_params, d_tok, d_cache, draft_cfg)
            d_tok = torch.argmax(dl[:, :cfg.vocab_size],
                                 dim=-1).to(torch.int32)
            proposals.append(d_tok)
        drafted = torch.stack(proposals, dim=1)               # [B, k]
        # The target scores fed = [last, d1..d_{k-1}]: greedy[:, i] is
        # its token after fed[:, :i+1], so d_j is accepted iff it equals
        # greedy[:, j-1] and every earlier proposal was accepted.
        fed = torch.cat([last[:, None], drafted[:, :-1]], dim=1)
        v_logits, _ = verify_step(params, fed, t_cache, cfg)
        greedy = torch.argmax(v_logits, dim=-1).cpu().numpy()
        drafted_h = drafted.cpu().numpy()
        n_commit = np.zeros((b,), np.int32)
        new_last = last_h.copy()
        for r in range(b):
            if done[r] or count[r] >= max_new_tokens:
                continue
            a = 0
            while a < k and drafted_h[r, a] == greedy[r, a]:
                a += 1
            if a < k:
                row = list(drafted_h[r, :a]) + [int(greedy[r, a])]
            else:
                row = list(drafted_h[r, :k])
            n_commit[r] = len(row)
            new_last[r] = row[-1]
            space = max_new_tokens - int(count[r])
            take = row[:space]
            out[r, count[r]:count[r] + len(take)] = take
            count[r] = min(count[r] + len(row), max_new_tokens)
            if eos_id is not None and eos_id in take:
                p = int(count[r]) - len(take) + take.index(eos_id)
                out[r, p:] = eos_id
                count[r] = max_new_tokens
                done[r] = True
        last_h = new_last
        last = torch.as_tensor(last_h, device=dev)
        # Both lengths advance by the committed count (a row that
        # committed nothing rolls the draft's k-step advance back).
        adv = torch.as_tensor(n_commit, device=dev)
        t_cache.length.copy_(t_len0 + adv)
        d_cache.length.copy_(d_len0 + adv)
    out_t = torch.as_tensor(out, device=dev)
    return (out_t, {'rounds': rounds}) if return_stats else out_t
