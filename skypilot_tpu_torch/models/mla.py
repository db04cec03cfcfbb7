"""DeepSeek-family decoder: Multi-head Latent Attention (port of
skypilot_tpu/models/mla.py: ``init_params``, ``_latents``,
``_attend_latent``, ``_mlp``, ``_ffn``, ``_layer``, ``forward``,
``init_page_pool``, ``prefill``, ``prefill_extend``,
``paged_verify_step``, ``paged_decode_step``, ``paged_prefill_extend``,
``LatentCache``, ``init_cache``, ``verify_step``, ``decode_step``,
``generate``).

MLA replaces the K/V heads with a low-rank bottleneck:

  c_kv   = rms_norm(x · W_dkv)             [B, S, r]    (the latent)
  k_rope = rope(x · W_kr)                  [B, S, dr]   (one key, shared)
  q      = x · W_q → (q_nope [dn] | q_rope [dr], rope'd per head)
  score  = q_nope · (c_kv · W_uk) + q_rope · k_rope

and the cache holds only (c_kv, k_rope): r + dr values a token a layer.
Attention is the absorbed-matmul formulation (:func:`_attend_latent`):
q_nope is pulled through W_uk into latent space, and the value side
expands probs · c_kv through W_uv, so no per-head K or V is ever made.
The JAX package runs it as plain XLA — its Pallas kernel covers the
dense K/V family only — so here it is plain PyTorch on every device,
rounded where JAX rounds: the bf16 products, then the scores cast to
fp32 and scaled by (dn + dr) ** -0.5, the probabilities back to the
compute dtype before the probs · c_kv product, fp32 logits from bf16
operands.

A ``DeepSeekMoEConfig`` layer's FFN is models/moe.py's routed
``moe_ffn`` on the ``moe_norm`` output plus a dense shared SwiGLU of
width ``n_shared_experts * ffn_dim``.

The decode functions keep models/decode.py's call surface over a
``paging.PagedLatent`` pool, so the engine picks a module, not a code
path; the contiguous ``LatentCache`` family (``prefill_cache``,
``verify_step``, ``decode_step``, ``generate``) mirrors decode.py's
``KVCache`` one for offline batch inference, its steps replayed as one
CUDA graph on the card. Every projection reads its weight through
``_d`` (models/quant.py), so int8 params serve too. The paged steps gather each layer's whole ``max_len`` view from
the pages (fixed shapes, no host sync: the engine captures them into
CUDA graphs), overlay the fed positions and attend; a position at or
past the view is dropped, as the JAX scatter drops it. The pools are
updated in place; int8 pools (``init_page_pool(quant='int8')``) carry
c_kv's and k_rope's scale sidecars through every paged function. Python
loop over layers, each recomputed in the backward under
``remat='full'``; no pipeline or ring.

A serving gang (serve/engine.py ``--mesh expert=E,tensor=T``) holds the
shard that :func:`param_axes` names, the JAX ``param_specs``: the heads
(``wq``, ``w_uk``, ``w_uv``, ``wo``'s rows) and the FFN's hidden units
over 'tensor', DeepSeekMoE's routed experts over 'expert' too; the
latent projections (``w_dkv``, ``w_kr``, ``kv_norm``) whole, so every
rank holds the whole latent pool. The attention takes the rank's heads
from the shapes, ``wo`` and the dense FFN's ``w_down`` are summed over
'tensor' (models/llama.py ``_row_parallel``), and the routed and shared
experts in one sum over ('expert', 'tensor') (moe.py ``moe_ffn``: the
shared experts, whole on every 'expert' index, are counted once).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from skypilot_tpu_torch.config import (DeepSeekMoEConfig, MLAConfig,
                                      check_supported)
from skypilot_tpu_torch.models import decode, llama, moe, paging
from skypilot_tpu_torch.models.quant import _d
from skypilot_tpu_torch.ops import norms, rotary
from skypilot_tpu_torch.ops.paged_attention import (
    dequantize_values, gather_pages, quantize_values, write_pages)
from skypilot_tpu_torch.parallel import mesh as mesh_lib

Params = llama.Params

NEG_INF = -1e30

# The training loop reads it: forward(return_aux=True) gives the router
# load-balance aux (0 for dense MLA).
HAS_AUX = True


def init_params(cfg: MLAConfig, generator: torch.Generator, device='cuda',
                dtype=None, mesh: Optional[mesh_lib.Mesh] = None) -> Params:
    """Random params from ``generator`` in ``dtype`` (default
    cfg.param_dtype), the JAX tree: ``wq`` [L, D, H·(dn+dr)], ``w_dkv``
    [L, D, r], ``w_kr`` [L, D, dr], ``kv_norm`` [L, r], ``w_uk`` [L, r,
    H·dn], ``w_uv`` [L, r, H·dv], ``wo`` [L, H·dv, D], then the dense
    MLP, or for a DeepSeekMoEConfig ``moe_norm``, ``router`` [L, D, E],
    the stacked experts [L, E, D, F] / [L, E, F, D] and the shared
    ``ws_*`` of width n_shared_experts·F. Drawn leaf by leaf
    (llama.LeafInit), so deepseek-v2 in bf16 never holds more than a
    layer slice in fp32; with a ``mesh``, this rank's shards of
    :func:`param_axes`."""
    check_supported(cfg)
    L, D, F, H = cfg.n_layers, cfg.dim, cfg.ffn_dim, cfg.n_heads
    r, dn, dr, dv = (cfg.kv_lora_rank, cfg.qk_nope_head_dim,
                     cfg.qk_rope_head_dim, cfg.v_head_dim)
    init = llama.LeafInit(generator, device, dtype or cfg.param_dtype,
                          mesh)
    layers = {
        'attn_norm': init.ones((L, D)),
        'wq': init.trunc((L, D, H * (dn + dr))),
        'w_dkv': init.trunc((L, D, r)),
        'w_kr': init.trunc((L, D, dr)),
        'kv_norm': init.ones((L, r)),
        'w_uk': init.trunc((L, r, H * dn)),
        'w_uv': init.trunc((L, r, H * dv)),
        'wo': init.trunc((L, H * dv, D)),
    }
    if isinstance(cfg, DeepSeekMoEConfig):
        E = cfg.n_experts
        layers.update({
            'moe_norm': init.ones((L, D)),
            'router': init.normal((L, D, E), stacked=True),
            'w_gate': init.trunc((L, E, D, F)),
            'w_up': init.trunc((L, E, D, F)),
            'w_down': init.trunc((L, E, F, D))})
        if cfg.n_shared_experts:
            fs = F * cfg.n_shared_experts
            layers.update({'ws_gate': init.trunc((L, D, fs)),
                           'ws_up': init.trunc((L, D, fs)),
                           'ws_down': init.trunc((L, fs, D))})
    else:
        layers.update({'mlp_norm': init.ones((L, D)),
                       'w_gate': init.trunc((L, D, F)),
                       'w_up': init.trunc((L, D, F)),
                       'w_down': init.trunc((L, F, D))})
    params: Params = {'embed': init.normal((cfg.vocab_size, D)),
                      'layers': layers, 'final_norm': init.ones((D,))}
    if not cfg.tie_embeddings:
        params['lm_head'] = init.normal((D, cfg.vocab_size))
    return init.finish(params, param_axes(cfg))


def param_axes(cfg: MLAConfig) -> Params:
    """The logical axis names of every dim of :func:`init_params`'
    leaves (JAX ``param_specs``): the heads over 'tensor', the latent
    replicated (it is shared by every head), the dense and shared FFNs
    over 'mlp', DeepSeekMoE's routed experts as models/moe.py lays
    them."""
    layers = {
        'attn_norm': ('layers', 'norm'),
        'wq': ('layers', 'embed', 'heads'),
        'w_dkv': ('layers', 'embed', 'norm'),
        'w_kr': ('layers', 'embed', 'norm'),
        'kv_norm': ('layers', 'norm'),
        'w_uk': ('layers', 'norm', 'heads'),
        'w_uv': ('layers', 'norm', 'heads'),
        'wo': ('layers', 'heads', 'embed'),
    }
    if isinstance(cfg, DeepSeekMoEConfig):
        layers.update(moe.EXPERT_AXES)
        if cfg.n_shared_experts:
            layers.update({'ws_gate': ('layers', 'embed', 'mlp'),
                           'ws_up': ('layers', 'embed', 'mlp'),
                           'ws_down': ('layers', 'mlp', 'embed')})
    else:
        layers.update({'mlp_norm': ('layers', 'norm'),
                       'w_gate': ('layers', 'embed', 'mlp'),
                       'w_up': ('layers', 'embed', 'mlp'),
                       'w_down': ('layers', 'mlp', 'embed')})
    axes: Params = {'embed': ('vocab', 'embed'), 'layers': layers,
                    'final_norm': ('norm',)}
    if not cfg.tie_embeddings:
        axes['lm_head'] = ('embed', 'vocab')
    return axes


def validate_divisibility(cfg: MLAConfig, mesh_shape: Dict[str, int]):
    """JAX's check: the heads over 'tensor', DeepSeekMoE's experts over
    'expert'."""
    tp = mesh_shape.get('tensor', 1)
    if tp > 1 and cfg.n_heads % tp != 0:
        raise ValueError(f'n_heads={cfg.n_heads} not divisible by tensor '
                         f'axis {tp}')
    ep = mesh_shape.get('expert', 1)
    if isinstance(cfg, DeepSeekMoEConfig) and ep > 1 and \
            cfg.n_experts % ep != 0:
        raise ValueError(f'n_experts={cfg.n_experts} not divisible by '
                         f'expert axis {ep}')


def rope_tables(cfg: MLAConfig, positions: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sin, cos) over the rope part of q and k only (qk_rope_head_dim)."""
    return rotary.rope_frequencies(cfg.qk_rope_head_dim, positions,
                                   cfg.rope_theta, cfg.rope_scaling)


def _latents(x: torch.Tensor, lp, cfg: MLAConfig, sin, cos):
    """x [B, S, D] → (q_nope [B, S, H, dn], q_rope [B, S, H, dr], c_kv
    [B, S, r], k_rope [B, S, dr]), norms and rope applied; H is the
    heads this rank holds (all of them unsharded). The shared rope key
    takes rope through a singleton heads axis."""
    b, s, _ = x.shape
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    dt = cfg.dtype
    h = norms.rms_norm(x, lp['attn_norm'], cfg.rms_eps)
    q = h @ _d(lp['wq'], dt)
    q = q.reshape(b, s, q.shape[-1] // (dn + dr), dn + dr)
    q_nope, q_rope = q[..., :dn], rotary.apply_rope(q[..., dn:], sin, cos)
    c_kv = norms.rms_norm(h @ _d(lp['w_dkv'], dt), lp['kv_norm'],
                          cfg.rms_eps)
    k_rope = rotary.apply_rope((h @ _d(lp['w_kr'], dt))[:, :, None, :], sin,
                               cos)[:, :, 0, :]
    return q_nope, q_rope, c_kv, k_rope


def _attend_latent(q_nope: torch.Tensor, q_rope: torch.Tensor,
                   c_kv: torch.Tensor, k_rope: torch.Tensor, lp,
                   cfg: MLAConfig, q_offset) -> torch.Tensor:
    """Absorbed-matmul causal attention over the latents: q_* [B, S, H,
    *] (this rank's H heads, whose columns of W_uk and W_uv it holds),
    c_kv [B, T, r], k_rope [B, T, dr] → out [B, S, H·dv]. Query s
    of row b sits at position q_offset (+ row b's entry when it is a
    [B] tensor) + s and sees latents 0..that position. The products
    stay in the compute dtype; the scores go to fp32 and take the
    (dn + dr) ** -0.5 scale; the probabilities go back to the compute
    dtype for probs · c_kv, which W_uv then expands per head."""
    b, s, H, dn = q_nope.shape
    t = c_kv.shape[1]
    r, dv = cfg.kv_lora_rank, cfg.v_head_dim
    scale = (dn + cfg.qk_rope_head_dim) ** -0.5
    dev = q_nope.device
    w_uk = _d(lp['w_uk'], cfg.dtype).reshape(r, H, dn)
    q_lat = torch.einsum('bshd,rhd->bshr', q_nope, w_uk)
    scores = (torch.einsum('bshr,btr->bhst', q_lat, c_kv) +
              torch.einsum('bshr,btr->bhst', q_rope, k_rope)).float() * scale
    q_pos = torch.arange(s, device=dev)
    if torch.is_tensor(q_offset):
        q_pos = q_pos[None, :] + q_offset.long().reshape(-1, 1)
    else:
        q_pos = (q_pos + q_offset)[None, :]
    mask = q_pos[:, None, :, None] >= torch.arange(t, device=dev)
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(cfg.dtype)
    ctx = torch.einsum('bhst,btr->bshr', probs, c_kv)
    w_uv = _d(lp['w_uv'], cfg.dtype).reshape(r, H, dv)
    out = torch.einsum('bshr,rhv->bshv', ctx, w_uv)
    return out.reshape(b, s, H * dv)


def _swiglu_hidden(h: torch.Tensor, w_gate, w_up, cfg: MLAConfig):
    dt = cfg.dtype
    return cfg.act(h @ _d(w_gate, dt)) * (h @ _d(w_up, dt))


def _mlp(x: torch.Tensor, lp, cfg: MLAConfig) -> torch.Tensor:
    """The dense MLA layer's SwiGLU block (pre-norm); ``w_down``'s rows
    summed over 'tensor' on a gang."""
    h = norms.rms_norm(x, lp['mlp_norm'], cfg.rms_eps)
    return llama._row_parallel(
        _swiglu_hidden(h, lp['w_gate'], lp['w_up'], cfg), lp['w_down'], cfg)


def _ffn(x: torch.Tensor, lp, cfg: MLAConfig
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(residual branch, router aux fp32 scalar): the dense SwiGLU with a
    zero aux, or DeepSeekMoE's ``moe_norm`` → routed experts (moe.
    moe_ffn) + the shared experts' dense SwiGLU, which joins the routed
    experts' sum on a gang (its 'tensor' partial, counted once)."""
    if not isinstance(cfg, DeepSeekMoEConfig):
        return _mlp(x, lp, cfg), torch.zeros((), dtype=torch.float32,
                                             device=x.device)
    h = norms.rms_norm(x, lp['moe_norm'], cfg.rms_eps)
    shared = None
    if cfg.n_shared_experts:
        shared = llama.row_partial(
            _swiglu_hidden(h, lp['ws_gate'], lp['ws_up'], cfg),
            lp['ws_down'], cfg)
    return moe.moe_ffn(h, lp, cfg, shared=shared)


def _wo(out: torch.Tensor, lp, cfg: MLAConfig) -> torch.Tensor:
    """The output projection, its rows (the heads) summed over 'tensor'
    on a gang."""
    return llama._row_parallel(out, lp['wo'], cfg)


def _layer(x: torch.Tensor, lp, cfg: MLAConfig, sin, cos, q_offset
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decoder layer over a whole sequence: (x, this layer's aux)."""
    q_nope, q_rope, c_kv, k_rope = _latents(x, lp, cfg, sin, cos)
    x = x + _wo(_attend_latent(q_nope, q_rope, c_kv, k_rope, lp, cfg,
                               q_offset), lp, cfg)
    y, aux = _ffn(x, lp, cfg)
    return x + y, aux


def forward(params: Params, tokens: torch.Tensor, cfg: MLAConfig,
            return_aux: bool = False):
    """tokens [B, S] → logits [B, S, vocab] fp32, and with
    ``return_aux`` (logits, router_aux_weight · Σ aux / n_layers; 0 for
    dense MLA). Under autograd with ``cfg.remat == 'full'`` each layer
    is recomputed in the backward (llama.apply_layers)."""
    check_supported(cfg)
    p_in, p_out = llama.fsdp_io(params, cfg)
    x = llama.embed(p_in, tokens, cfg)
    sin, cos = rope_tables(cfg, torch.arange(tokens.shape[1],
                                             device=tokens.device))

    def step(carry, lp, i):
        h, aux = carry
        h, a = _layer(h, lp, cfg, sin, cos, 0)
        return h, aux + a

    x, aux = llama.apply_layers(
        params, cfg, step,
        (x, torch.zeros((), dtype=torch.float32, device=tokens.device)))
    logits = llama.unembed(x, p_out, cfg)
    if return_aux:
        return logits, getattr(cfg, 'router_aux_weight', 0.0) * aux / \
            cfg.n_layers
    return logits


# ---------------------------------------------------------------------------
# Latent-pool decode
# ---------------------------------------------------------------------------

def init_page_pool(cfg: MLAConfig, n_pages: int, page_size: int,
                   batch: int, max_pages: int, device='cuda', *,
                   quant: str = 'none') -> paging.PagedLatent:
    """Zeroed c_kv [L, n_pages, page_size, r] and k_rope [L, n_pages,
    page_size, dr] pools, a zeroed [batch, max_pages] int32 table
    (0 = trash) and zero lengths. The pools are cfg.dtype, or with
    ``quant='int8'`` (SKYTPU_ENGINE_KV_QUANT) int8 codes with
    [L, n_pages, page_size] fp32 per-token scale sidecars, two distinct
    tensors."""
    decode.check_kv_quant(quant)
    shape = (cfg.n_layers, n_pages, page_size)
    int8 = quant == 'int8'
    dt = torch.int8 if int8 else cfg.dtype

    def scale():
        return (torch.zeros(shape, dtype=torch.float32, device=device)
                if int8 else None)
    return paging.PagedLatent(
        c_kv=torch.zeros(shape + (cfg.kv_lora_rank,), dtype=dt,
                         device=device),
        k_rope=torch.zeros(shape + (cfg.qk_rope_head_dim,), dtype=dt,
                           device=device),
        table=torch.zeros((batch, max_pages), dtype=torch.int32,
                          device=device),
        length=torch.zeros((batch,), dtype=torch.int32, device=device),
        c_scale=scale(), r_scale=scale())


@dataclasses.dataclass
class LatentCache:
    """The contiguous latent cache: c_kv [L, B, T, r] and k_rope [L, B,
    T, dr] with T = max_len, length [B] int32 (as decode.KVCache's).
    The steps update it in place."""
    c_kv: torch.Tensor
    k_rope: torch.Tensor
    length: torch.Tensor


def init_cache(cfg: MLAConfig, batch: int, max_len: int,
               device='cuda') -> LatentCache:
    """Zeroed latents in cfg.dtype and zero lengths."""
    shape = (cfg.n_layers, batch, max_len)
    return LatentCache(
        c_kv=torch.zeros(shape + (cfg.kv_lora_rank,), dtype=cfg.dtype,
                         device=device),
        k_rope=torch.zeros(shape + (cfg.qk_rope_head_dim,), dtype=cfg.dtype,
                           device=device),
        length=torch.zeros((batch,), dtype=torch.int32, device=device))


def _last_logits(x: torch.Tensor, lengths: torch.Tensor, params,
                 cfg: MLAConfig) -> torch.Tensor:
    """fp32 logits at each row's last content position: [B, vocab]."""
    idx = (lengths.long() - 1)[:, None, None].expand(x.shape[0], 1,
                                                     x.shape[-1])
    return llama.unembed(torch.gather(x, 1, idx), params, cfg)[:, 0]


def _prefill_layers(params, tokens: torch.Tensor, cfg: MLAConfig,
                    max_len: int, lengths: Optional[torch.Tensor],
                    store: Callable[[int, torch.Tensor, torch.Tensor], None]
                    ) -> torch.Tensor:
    """The prefill pass of both cache forms: ``store(i, c_kv, k_rope)``
    takes layer i's latents [B, S, r] and [B, S, dr]; returns the logits
    at each row's last content position, [B, vocab] fp32."""
    check_supported(cfg)
    b, s = tokens.shape
    if s > max_len:
        raise ValueError(f'prompt length {s} exceeds cache max_len {max_len}')
    dev = tokens.device
    if lengths is None:
        lengths = torch.full((b,), s, dtype=torch.int32, device=dev)
    x = llama.embed(params, tokens, cfg)
    sin, cos = rope_tables(cfg, torch.arange(s, device=dev))
    for i in range(cfg.n_layers):
        lp = llama.layer_params(params, i)
        q_nope, q_rope, c_kv, k_rope = _latents(x, lp, cfg, sin, cos)
        x = x + _wo(_attend_latent(q_nope, q_rope, c_kv, k_rope, lp, cfg,
                                   0), lp, cfg)
        x = x + _ffn(x, lp, cfg)[0]
        store(i, c_kv, k_rope)
    return _last_logits(x, lengths, params, cfg)


def prefill(params, tokens: torch.Tensor, cfg: MLAConfig, max_len: int,
            lengths: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Right-padded prompts in one pass. tokens [B, S] → (logits at each
    row's last content position [B, vocab] fp32, c_kv [L, B, S, r],
    k_rope [L, B, S, dr]): the rows :func:`paging.scatter_prefill`
    writes. The JAX version pads them to max_len in a LatentCache,
    which is :func:`prefill_cache`'s form."""
    cs, krs = [], []

    def store(i, c, kr):
        cs.append(c)
        krs.append(kr)
    logits = _prefill_layers(params, tokens, cfg, max_len, lengths, store)
    return logits, torch.stack(cs), torch.stack(krs)


def prefill_cache(params, tokens: torch.Tensor, cfg: MLAConfig,
                  max_len: int, lengths: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, LatentCache]:
    """JAX ``prefill``: right-padded prompts tokens [B, S] (``lengths``
    [B], ragged rows allowed) → (logits at each row's last content
    position [B, vocab] fp32, a :class:`LatentCache` of max_len
    positions holding [0, S), length = lengths)."""
    b, s = tokens.shape
    cache = init_cache(cfg, b, max_len, device=tokens.device)

    def store(i, c, kr):
        cache.c_kv[i, :, :s] = c
        cache.k_rope[i, :, :s] = kr
    logits = _prefill_layers(params, tokens, cfg, max_len, lengths, store)
    if lengths is None:
        cache.length.fill_(s)
    else:
        cache.length.copy_(lengths)
    return logits, cache


def prefill_extend(params, tokens: torch.Tensor, cfg: MLAConfig,
                   max_len: int, prefix_c: torch.Tensor,
                   prefix_kr: torch.Tensor,
                   lengths: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Prefill a right-padded SUFFIX tokens [B, S2] over a stored latent
    prefix prefix_c [L, B, P, r], prefix_kr [L, B, P, dr] (every row a
    full P-token prefix; ``lengths`` [B] the real suffix lengths): the
    suffix runs at positions P.. (rope and causal offset) attending
    [prefix ++ suffix], the math of a prefill of the whole sequence.
    Returns (logits at each row's last content position [B, vocab]
    fp32, the suffix's c_kv [L, B, S2, r], k_rope), the shape contract
    of :func:`prefill`; the JAX version returns the padded cache."""
    check_supported(cfg)
    b, s2 = tokens.shape
    p = prefix_c.shape[2]
    if p + s2 > max_len:
        raise ValueError(f'prefix ({p}) + suffix ({s2}) exceeds max_len '
                         f'({max_len})')
    dev = tokens.device
    if lengths is None:
        lengths = torch.full((b,), s2, dtype=torch.int32, device=dev)
    x = llama.embed(params, tokens, cfg)
    sin, cos = rope_tables(cfg, torch.arange(s2, device=dev) + p)
    cs, krs = [], []
    for i in range(cfg.n_layers):
        lp = llama.layer_params(params, i)
        q_nope, q_rope, c_new, kr_new = _latents(x, lp, cfg, sin, cos)
        c_all = torch.cat([prefix_c[i].to(c_new.dtype), c_new], dim=1)
        kr_all = torch.cat([prefix_kr[i].to(kr_new.dtype), kr_new], dim=1)
        x = x + _wo(_attend_latent(q_nope, q_rope, c_all, kr_all, lp, cfg,
                                   p), lp, cfg)
        x = x + _ffn(x, lp, cfg)[0]
        cs.append(c_new)
        krs.append(kr_new)
    return _last_logits(x, lengths, params, cfg), torch.stack(cs), \
        torch.stack(krs)


def paged_prefill_extend(params, tokens: torch.Tensor,
                         pcache: paging.PagedLatent, cfg: MLAConfig, *,
                         slot: int, p: int, lengths) -> torch.Tensor:
    """:func:`prefill_extend` for ONE paged latent row, in place: the
    [1, S2] suffix attends [prefix ++ suffix] latents, the prefix
    gathered per layer from the (possibly shared) pages that row
    ``slot``'s table covers, and the suffix latents written straight
    into the row's own pages (a position past the row's reservation
    lands on the trash page); length[slot] = p + lengths. The
    chunked-prefill and prefix-hit program of the engine. Returns the
    logits at the last content position, [1, vocab] fp32. A suffix
    reaching past the table's coverage raises: the JAX gather would
    clamp it onto a live page. On an int8 pool c_kv and k_rope quantize
    apart (``c_scale``, ``r_scale``): the suffix attends its own
    dequantized latents, the gathered prefix dequantizes per layer into
    the latents' dtype, and codes and scales are written."""
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
    sin, cos = rope_tables(cfg, suf_pos)
    scales = paging._scale_pools(pcache)
    for i in range(cfg.n_layers):
        lp = llama.layer_params(params, i)
        q_nope, q_rope, c_new, kr_new = _latents(x, lp, cfg, sin, cos)
        cp, krp = pcache.c_kv[i], pcache.k_rope[i]
        pc, pkr = cp[pre_pid, pre_off][None], krp[pre_pid, pre_off][None]
        if scales is not None:
            cs, rs = scales['c_kv'][i], scales['k_rope'][i]
            (cq, cs_new), (krq, rs_new) = (quantize_values(c_new),
                                           quantize_values(kr_new))
            c_new = dequantize_values(cq, cs_new, c_new.dtype)
            kr_new = dequantize_values(krq, rs_new, kr_new.dtype)
            pc = dequantize_values(pc, cs[pre_pid, pre_off][None],
                                   c_new.dtype)
            pkr = dequantize_values(pkr, rs[pre_pid, pre_off][None],
                                    kr_new.dtype)
        c_all = torch.cat([pc.to(c_new.dtype), c_new], 1)
        kr_all = torch.cat([pkr.to(kr_new.dtype), kr_new], 1)
        out = _attend_latent(q_nope, q_rope, c_all, kr_all, lp, cfg, p)
        if scales is None:
            cp[suf_pid, suf_off] = c_new[0].to(cp.dtype)
            krp[suf_pid, suf_off] = kr_new[0].to(krp.dtype)
        else:
            cp[suf_pid, suf_off], cs[suf_pid, suf_off] = cq[0], cs_new[0]
            krp[suf_pid, suf_off], rs[suf_pid, suf_off] = krq[0], rs_new[0]
        x = x + _wo(out, lp, cfg)
        x = x + _ffn(x, lp, cfg)[0]
    logits = _last_logits(x, lengths, params, cfg)
    pcache.length[slot] = (lengths[0] + p).to(pcache.length.dtype)
    return logits


def paged_verify_step(params, tokens: torch.Tensor,
                      pcache: paging.PagedLatent, cfg: MLAConfig, *,
                      max_len: int, active: Optional[torch.Tensor] = None):
    """K tokens per row at each row's own offset, over the paged latent
    pool, in place. tokens [B, K] → (logits [B, K, vocab] fp32, the
    pool); ``length`` does NOT advance. Each layer gathers its
    ``max_len`` view from the pre-write pages (one more trash page a
    row as scratch), overlays the fed positions' latents, attends, then
    writes them into the pages (inactive rows to the trash page). An
    overlay position at or past the view is dropped, as the JAX scatter
    drops it: it lands on the scratch position past the view, which the
    attention never reads. No shape depends on the data and nothing
    syncs the host, so the step captures into a CUDA graph. On an int8
    pool the fed latents quantize (c_kv and k_rope apart), the gathered
    view dequantizes into the latents' dtype, the overlay holds the
    dequantized fed latents, and codes and scales are written."""
    check_supported(cfg)
    b, kk = tokens.shape
    dev = tokens.device
    length = pcache.length
    positions = length[:, None].long() + torch.arange(kk, device=dev)
    pid, off = paging._write_indices(pcache, positions, active)
    rows = torch.arange(b, device=dev)[:, None].expand(b, kk)
    view_pos = torch.clamp(positions, max=max_len)
    table = torch.cat([pcache.table, torch.zeros_like(pcache.table[:, :1])],
                      1)
    x = llama.embed(params, tokens, cfg)
    sin, cos = rope_tables(cfg, positions)
    scales = paging._scale_pools(pcache)
    for i in range(cfg.n_layers):
        lp = llama.layer_params(params, i)
        q_nope, q_rope, c_new, kr_new = _latents(x, lp, cfg, sin, cos)
        cp, krp = pcache.c_kv[i], pcache.k_rope[i]
        c_l = gather_pages(cp, table, max_len + 1)
        kr_l = gather_pages(krp, table, max_len + 1)
        if scales is not None:
            cs, rs = scales['c_kv'][i], scales['k_rope'][i]
            (cq, cs_new), (krq, rs_new) = (quantize_values(c_new),
                                           quantize_values(kr_new))
            c_new = dequantize_values(cq, cs_new, c_new.dtype)
            kr_new = dequantize_values(krq, rs_new, kr_new.dtype)
            c_l = dequantize_values(c_l, gather_pages(cs, table, max_len + 1),
                                    c_new.dtype)
            kr_l = dequantize_values(kr_l,
                                     gather_pages(rs, table, max_len + 1),
                                     kr_new.dtype)
        c_l[rows, view_pos] = c_new.to(c_l.dtype)    # a fresh gather
        kr_l[rows, view_pos] = kr_new.to(kr_l.dtype)
        out = _attend_latent(q_nope, q_rope, c_l[:, :max_len],
                             kr_l[:, :max_len], lp, cfg, length)
        if scales is None:
            write_pages(cp, c_new.to(cp.dtype), pid, off)
            write_pages(krp, kr_new.to(krp.dtype), pid, off)
        else:
            write_pages(cp, cq, pid, off)
            write_pages(krp, krq, pid, off)
            write_pages(cs, cs_new, pid, off)
            write_pages(rs, rs_new, pid, off)
        x = x + _wo(out, lp, cfg)
        x = x + _ffn(x, lp, cfg)[0]
    return llama.unembed(x, params, cfg), pcache


def paged_decode_step(params, token: torch.Tensor,
                      pcache: paging.PagedLatent, cfg: MLAConfig, *,
                      max_len: int, active: Optional[torch.Tensor] = None):
    """One in-place paged decode step: token [B] → logits [B, vocab];
    active rows' lengths advance by one."""
    logits, pcache = paged_verify_step(params, token[:, None], pcache, cfg,
                                       max_len=max_len, active=active)
    advance = 1 if active is None else active.to(pcache.length.dtype)
    pcache.length += advance
    return logits[:, 0], pcache


def verify_step(params, tokens: torch.Tensor, cache: LatentCache,
                cfg: MLAConfig) -> Tuple[torch.Tensor, LatentCache]:
    """K tokens per row at each row's own offset over the contiguous
    latent cache: tokens [B, K] → (logits [B, K, vocab] fp32, the
    cache). The K positions' latents are written in place at [length,
    length + K) and ``length`` does NOT advance (decode.verify_step's
    contract); writes at or past max_len are dropped, as JAX's are. No
    host sync, so the step captures into a CUDA graph."""
    check_supported(cfg)
    kk = tokens.shape[1]
    length = cache.length
    positions = length[:, None].long() + torch.arange(kk,
                                                      device=tokens.device)
    x = llama.embed(params, tokens, cfg)
    sin, cos = rope_tables(cfg, positions)
    for i in range(cfg.n_layers):
        lp = llama.layer_params(params, i)
        q_nope, q_rope, c_new, kr_new = _latents(x, lp, cfg, sin, cos)
        c_l, kr_l = cache.c_kv[i], cache.k_rope[i]
        decode.put_positions(c_l, positions, c_new)
        decode.put_positions(kr_l, positions, kr_new)
        out = _attend_latent(q_nope, q_rope, c_l, kr_l, lp, cfg, length)
        x = x + _wo(out, lp, cfg)
        x = x + _ffn(x, lp, cfg)[0]
    return llama.unembed(x, params, cfg), cache


def decode_step(params, token: torch.Tensor, cache: LatentCache,
                cfg: MLAConfig, active: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, LatentCache]:
    """One step over the latent cache: token [B] → (logits [B, vocab],
    the cache); active rows' lengths advance by one, in place."""
    logits, cache = verify_step(params, token[:, None], cache, cfg)
    cache.length += 1 if active is None else active.to(cache.length.dtype)
    return logits[:, 0], cache


@torch.no_grad()
def generate(params, prompt: torch.Tensor, cfg: MLAConfig,
             max_new_tokens: int, *, max_len: Optional[int] = None,
             temperature: float = 0.0, eos_id: Optional[int] = None,
             top_k: Optional[int] = None, top_p: Optional[float] = None,
             prompt_lengths: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Generation over the latent cache with decode.generate's surface
    (greedy / temperature / top-k / top-p, EOS fill, ragged prompts);
    on the card the steps replay one CUDA graph
    (decode.replay_steps)."""
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
    return decode.run_generate(step, logits, max_new_tokens,
                               temperature=temperature, eos_id=eos_id,
                               top_k=top_k, top_p=top_p,
                               generator=generator)
