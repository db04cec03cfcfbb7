"""Mixture-of-Experts decoder, Mixtral family and gpt-oss (port of
skypilot_tpu/models/moe.py: ``capacity``, ``init_params``, ``moe_ffn``,
``_layer``, ``forward``).

GShard/Switch-style dense dispatch, as in JAX: tokens are routed within
fixed-size groups along the sequence, top-k of a softmax over an fp32
router, with a static per-expert capacity; one-hot dispatch and combine
tensors carry tokens to the experts' buffers and back, so the layer is
static-shaped (the engine captures it into CUDA graphs: no host sync,
no shape that depends on the data). The experts are SwiGLU FFNs (or
gpt-oss's clamped variant, ``cfg.glu``) stacked on a leading expert
axis; their products are batched matmuls, as the JAX package leaves
them to XLA. A layer is Llama's attention block (models/llama.py) then
``moe_norm`` → :func:`moe_ffn`. Python loop over layers, each
recomputed in the backward under ``remat='full'``
(llama.apply_layers); no pipeline or ring.

A serving gang (serve/engine.py ``--mesh expert=E,tensor=T``) holds the
shard that :func:`param_axes` names, the JAX ``param_specs``: each rank
its E/ep experts' stacks cut to F/tp columns, the attention over
'tensor' as models/llama.py shards it, the router whole. Every rank
routes every token, so the slots and the drops are the same on every
rank; each dispatches to its own experts and the fp32 partials of the
combine are summed over ('expert', 'tensor') in one all-reduce.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from skypilot_tpu_torch.config import MoEConfig, check_supported
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.ops import norms
from skypilot_tpu_torch.ops.attention import attention as _attention
from skypilot_tpu_torch.parallel import mesh as mesh_lib

Params = llama.Params

# The training loop reads it: forward(return_aux=True) gives the router
# load-balance aux.
HAS_AUX = True


def capacity(cfg: MoEConfig, seq_len: int) -> int:
    """Buffer slots an expert has in a group of ``seq_len`` tokens:
    capacity_factor times the fair share, rounded up to a multiple of 8,
    at least 8."""
    c = int(cfg.capacity_factor * seq_len * cfg.top_k / cfg.n_experts)
    return max(8, ((c + 7) // 8) * 8)


def init_params(cfg: MoEConfig, generator: torch.Generator, device='cuda',
                dtype=None, mesh: Optional[mesh_lib.Mesh] = None) -> Params:
    """Random params from ``generator`` in ``dtype`` (default
    cfg.param_dtype), the JAX tree: Llama's attention leaves, then
    ``moe_norm``, ``router`` [L, D, E], ``w_gate`` / ``w_up`` [L, E, D,
    F] and ``w_down`` [L, E, F, D]; ``bq/bk/bv``, ``sink`` and
    ``lm_head`` by the config. Drawn leaf by leaf (llama.LeafInit), so
    a server asking for bf16 never holds more than a layer slice in
    fp32; with a ``mesh``, this rank's shards of :func:`param_axes`."""
    check_supported(cfg)
    hd, L, D, Fd, E = (cfg.hd, cfg.n_layers, cfg.dim, cfg.ffn_dim,
                       cfg.n_experts)
    init = llama.LeafInit(generator, device, dtype or cfg.param_dtype,
                          mesh)
    layers = {
        'attn_norm': init.ones((L, D)),
        'wq': init.trunc((L, D, cfg.n_heads * hd)),
        'wk': init.trunc((L, D, cfg.n_kv_heads * hd)),
        'wv': init.trunc((L, D, cfg.n_kv_heads * hd)),
        'wo': init.trunc((L, cfg.n_heads * hd, D)),
        'moe_norm': init.ones((L, D)),
        'router': init.normal((L, D, E), stacked=True),
        'w_gate': init.trunc((L, E, D, Fd)),
        'w_up': init.trunc((L, E, D, Fd)),
        'w_down': init.trunc((L, E, Fd, D)),
    }
    if cfg.qkv_bias:
        layers['bq'] = init.zeros((L, cfg.n_heads * hd))
        layers['bk'] = init.zeros((L, cfg.n_kv_heads * hd))
        layers['bv'] = init.zeros((L, cfg.n_kv_heads * hd))
    if cfg.attn_sinks:
        layers['sink'] = init.zeros((L, cfg.n_heads))
    params: Params = {'embed': init.normal((cfg.vocab_size, D)),
                      'layers': layers, 'final_norm': init.ones((D,))}
    if not cfg.tie_embeddings:
        params['lm_head'] = init.normal((D, cfg.vocab_size))
    return init.finish(params, param_axes(cfg))


# The routed experts' leaves and their logical axes (the JAX
# ``param_specs``): each expert's stack over 'expert', its hidden units
# over 'mlp', the router whole. models/mla.py's DeepSeekMoE layers take
# the same.
EXPERT_AXES: Dict[str, tuple] = {
    'moe_norm': ('layers', 'norm'),
    'router': ('layers', 'embed', 'norm'),
    'w_gate': ('layers', 'expert', 'embed', 'mlp'),
    'w_up': ('layers', 'expert', 'embed', 'mlp'),
    'w_down': ('layers', 'expert', 'mlp', 'embed')}


def param_axes(cfg: MoEConfig) -> Params:
    """The logical axis names of every dim of :func:`init_params`'
    leaves (JAX ``param_specs``): Llama's attention leaves and the sinks
    over heads, then :data:`EXPERT_AXES`."""
    axes = llama.param_axes(cfg)
    layers = axes['layers']
    for key in ('mlp_norm', 'w_gate', 'w_up', 'w_down'):
        del layers[key]
    layers.update(EXPERT_AXES)
    return axes


def validate_divisibility(cfg: MoEConfig, mesh_shape: Dict[str, int]):
    """JAX's check: the dense dims over their axes, and the experts over
    'expert'."""
    llama.validate_divisibility(cfg, mesh_shape)
    ep = mesh_shape.get('expert', 1)
    if ep > 1 and cfg.n_experts % ep != 0:
        raise ValueError(f'n_experts={cfg.n_experts} not divisible by '
                         f'expert axis {ep}')


def expert_parallel(cfg: MoEConfig) -> Tuple[Optional[object], int, int]:
    """(the current mesh's ('expert', 'tensor') group, the first expert
    this rank holds, how many it holds); the group is None where both
    axes hold one rank, and then this rank holds every expert."""
    mesh = mesh_lib.current_mesh()
    n = cfg.n_experts // mesh.shape['expert']
    return (mesh.group('expert', 'tensor'), mesh.coords['expert'] * n, n)


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """fp32 one-hot of ``idx`` over n classes, by comparison with
    arange(n) (no host check of the indices: capture-safe)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def route(xg: torch.Tensor, router: torch.Tensor, cfg: MoEConfig, c: int
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The routing of grouped tokens xg [B, G, T, D] with capacity ``c``:
    (probs [B, G, T, E] fp32, renormalised gates [B, G, T, K] fp32,
    expert ids [B, G, T, K], slot [B, G, T, K, E, C] fp32: 1 where a
    kept choice lands in its expert's buffer).

    The router product is fp32 (x and the router cast up first); the
    top-k is a stable descending sort, so tied probabilities take the
    lower expert first as jax.lax.top_k does. A choice's slot is its
    expert's count of earlier choices in the group, counted over the
    [T·K] choices token-major (token 0's second choice before token 1's
    first); a choice at a slot >= c is dropped. The slot one-hot is a
    comparison with arange(c), never one_hot of the position, which
    lies past c for every dropped or unchosen expert."""
    e, k = cfg.n_experts, cfg.top_k
    logits = torch.einsum('bgtd,de->bgte', xg.float(), router.float())
    probs = torch.softmax(logits, dim=-1)
    gate_w, gate_idx = torch.sort(probs, dim=-1, descending=True,
                                  stable=True)
    gate_w, gate_idx = gate_w[..., :k], gate_idx[..., :k]
    gate_w = gate_w / gate_w.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gate_w, gate_idx, slots(gate_idx, e, c)


def slots(gate_idx: torch.Tensor, e: int, c: int) -> torch.Tensor:
    """The capacity slots of expert ids gate_idx [B, G, T, K] over ``e``
    experts of ``c`` slots: [B, G, T, K, E, C] fp32, 1 where a kept
    choice lands (:func:`route`'s token-major count)."""
    b, g, gs, k = gate_idx.shape
    onehot = _one_hot(gate_idx, e)                           # [B,G,T,K,E]
    flat = onehot.reshape(b, g, gs * k, e)
    pos = (torch.cumsum(flat, dim=2) - flat).reshape(b, g, gs, k, e)
    keep = (pos < c).float() * onehot
    slot = (pos[..., None] == torch.arange(c, device=gate_idx.device,
                                           dtype=pos.dtype)).float()
    return slot * keep[..., None]


def moe_ffn(x: torch.Tensor, lp, cfg: MoEConfig,
            shared: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, D] → (y [B, S, D], the Switch load-balance aux, fp32
    scalar). Routes within groups of ``router_group_size`` tokens (one
    group of S where that does not divide S), so every dispatch tensor
    is linear in S. The dispatch and combine tensors go to cfg.dtype
    before their products, as do the expert weights; the gates stay
    fp32 until the combine. ``shared`` [B, S, D] (DeepSeekMoE's shared
    experts) joins y: unsharded added after the combine.

    On a gang (:func:`expert_parallel`) the routing is every rank's
    whole routing, and the rank runs only its experts' slice of the
    dispatch and combine, at the hidden units it holds; the fp32
    partial of combine · out is summed over ('expert', 'tensor') in one
    all-reduce, then cast once (models/llama.py ``_row_parallel``'s
    rule). ``shared`` is then this rank's partial over 'tensor' of a
    term every 'expert' index holds alike, so only the ranks at expert
    index 0 add it before the sum: it is counted once."""
    b, s_len, d = x.shape
    e = cfg.n_experts
    gs = min(cfg.router_group_size, s_len)
    if s_len % gs != 0:
        gs = s_len
    g = s_len // gs
    c = capacity(cfg, gs)
    xg = x.reshape(b, g, gs, d)
    probs, gate_w, gate_idx, slot = route(xg, lp['router'], cfg, c)

    # Load-balance aux (Switch): E · Σ_e f_e · p̄_e over the top-1 choice,
    # the means over the whole batch (a training mesh's rows too).
    top1 = _one_hot(gate_idx[..., 0], e)
    f_e, p_e = top1.mean((0, 1, 2)), probs.mean((0, 1, 2))
    batch = mesh_lib.current_mesh()
    group = batch.group('data', 'fsdp')
    if group is not None:
        n = batch.count('data', 'fsdp')
        f_e = _mean_over(f_e.detach(), group, n)
        p_e = _MeanOver.apply(p_e, group, n)
    aux = e * torch.sum(f_e * p_e)

    dispatch = slot.sum(3)                                   # [B,G,T,E,C]
    combine = torch.einsum('bgtk,bgtkec->bgtec', gate_w, slot)
    group, first, e = expert_parallel(cfg)
    if group is not None:
        dispatch = dispatch[..., first:first + e, :]
        combine = combine[..., first:first + e, :]
    dt = cfg.dtype
    xin = torch.einsum('bgtec,bgtd->ebgcd', dispatch.to(dt), xg)
    xin = xin.reshape(e, b * g * c, d)
    gate = torch.bmm(xin, lp['w_gate'].to(dt))
    up = torch.bmm(xin, lp['w_up'].to(dt))
    out = torch.bmm(cfg.glu(gate, up), lp['w_down'].to(dt))  # [E,BGC,D]
    out = out.reshape(e, b, g, c, d)
    if group is None:
        y = torch.einsum('bgtec,ebgcd->bgtd', combine.to(dt), out)
        y = y.reshape(b, s_len, d)
        return (y if shared is None else y + shared), aux
    y = torch.einsum('bgtec,ebgcd->bgtd', combine.to(dt).float(),
                     out.float()).reshape(b, s_len, d)
    if shared is not None and first == 0:
        y = y + shared.float()
    dist.all_reduce(y, group=group)
    return y.to(dt), aux


def _mean_over(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """The mean of ``x`` over ``group``'s ``n`` ranks (no autograd)."""
    x = x.clone()
    dist.all_reduce(x, group=group)
    return x / n


class _MeanOver(torch.autograd.Function):
    """The mean over the batch group of a per-rank mean, as JAX's global
    mean over a batch sharded on ('data', 'fsdp') is. Every rank then
    holds the same aux and adds it to its loss; its backward hands this
    rank's mean 1/n of the cotangent, this rank's share, since the
    step sums the ranks' grads: the aux enters the summed grads once."""

    @staticmethod
    def forward(ctx, x, group, n):
        ctx.n = n
        return _mean_over(x, group, n)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None, None


def ffn(x: torch.Tensor, lp, cfg: MoEConfig
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The layer's FFN block: ``moe_norm`` → :func:`moe_ffn`."""
    return moe_ffn(norms.rms_norm(x, lp['moe_norm'], cfg.rms_eps), lp, cfg)


def layer(x: torch.Tensor, lp, cfg: MoEConfig, sin, cos, layer_idx: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decoder layer over a whole sequence: Llama's attention block
    (the plain attention on a layer with a window or sinks), then the
    routed FFN. Returns (x, this layer's aux)."""
    sin, cos = llama.select_rope(sin, cos, layer_idx, cfg)
    q, k, v = llama.qkv(x, lp, cfg, sin, cos)
    out = _attention(q, k, v, impl=cfg.attention_impl, causal=True,
                     **llama.attention_switches(lp, cfg, layer_idx))
    x = x + llama.wo_project(out, lp, cfg)
    y, aux = ffn(x, lp, cfg)
    return x + y, aux


def forward(params: Params, tokens: torch.Tensor, cfg: MoEConfig,
            return_aux: bool = False):
    """tokens [B, S] → logits [B, S, vocab] fp32, and with
    ``return_aux`` (logits, router_aux_weight · Σ aux / n_layers). Under
    autograd with ``cfg.remat == 'full'`` each layer, routing included,
    is recomputed in the backward (llama.apply_layers: ``route`` runs
    twice a layer a step, in the forward, then in the recompute)."""
    check_supported(cfg)
    p_in, p_out = llama.fsdp_io(params, cfg)
    x = llama.embed(p_in, tokens, cfg)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    sin, cos = llama.rope_tables(cfg, positions)

    def step(carry, lp, i):
        h, aux = carry
        h, a = layer(h, lp, cfg, sin, cos, i)
        return h, aux + a

    x, aux = llama.apply_layers(
        params, cfg, step,
        (x, torch.zeros((), dtype=torch.float32, device=tokens.device)))
    logits = llama.unembed(x, p_out, cfg)
    if return_aux:
        return logits, cfg.router_aux_weight * aux / cfg.n_layers
    return logits
