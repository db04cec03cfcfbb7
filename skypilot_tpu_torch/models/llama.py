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
:func:`config.check_supported`. No pipeline.

``attention_impl='ring'`` runs ring attention (ops/attention.py's
'ring' branch, ops/ring_attention.py) over the current mesh's
'sequence' group, in ``cfg.ring_layout``: the
tokens are this rank's sequence slots and ``positions`` their global
positions (train/train_lib.py cuts both), as the JAX forward's
sequence-sharded arrays are. The switches the ring does not take
(windows, softcaps, a local rope base, sinks) are refused by name, in
the JAX package's words.

The Gemma-2/3 and gpt-oss switches follow the JAX module: (1 + w)
norms with zero-initialised w, the tanh-gelu or clamped-SwiGLU MLP,
sqrt(dim)-scaled embeddings, post-sublayer norms, q/k norms before
RoPE, a final logit softcap, and per layer the attention softcap, the
sliding window (every ``sliding_window_pattern``-th layer global) with
its own local rope base, and sinks. A layer's index is a Python int,
so :func:`window_active` and :func:`select_rope` are plain branches
where JAX traces a ``where`` inside its layer scan.

Tensor parallelism (a serving gang, serve/engine.py ``--mesh
tensor=N``): under a mesh whose 'tensor' axis holds N > 1 ranks
(``parallel.mesh.use_mesh``), each rank holds the shard of the tree
that :func:`param_axes` names (parallel/sharding.py ``shard_params``,
the JAX ``param_specs``): q/k/v and the gate/up columns, the wo and
w_down rows and a slice of the vocabulary. The forward then runs on
H/N q heads, KH/N kv heads and F/N hidden units; the wo and w_down
products are summed over the group (fp32 partials, one all-reduce each,
before the Gemma-2 post norms), the embedding is a masked local lookup
summed over the group, and the fp32 logits of each vocabulary slice are
gathered to the whole vocabulary before the final softcap, so every
rank holds the same hidden states and logits. With no such mesh the
code is the unsharded forward, unchanged.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
import torch.utils.checkpoint

from skypilot_tpu_torch.config import LlamaConfig, check_supported
from skypilot_tpu_torch.models.quant import _d
from skypilot_tpu_torch.ops import norms, rotary
from skypilot_tpu_torch.ops.attention import attention as _attention
from skypilot_tpu_torch.parallel import mesh as mesh_lib

Params = Dict[str, object]


# Leaves every family reads in fp32 whatever the compute dtype: RMSNorm
# scales (ops/norms.rms_norm), attention sinks (:func:`attention_switches`)
# and MoE routers (models/moe.py). models/decode.py re-exports it.
FP32_AT_USE = ('norm', 'sink', 'router')


class _Pending:
    """A leaf :class:`LeafInit` will make: its place in the draw order,
    shape, fill (None: zeros, 'ones', else a function filling an fp32
    tensor from the generator) and whether it is drawn a layer slice at
    a time."""
    __slots__ = ('order', 'shape', 'fill', 'stacked')

    def __init__(self, order, shape, fill, stacked):
        self.order, self.shape = order, tuple(int(d) for d in shape)
        self.fill, self.stacked = fill, stacked


class LeafInit:
    """Makes ``init_params``' leaves from ``generator`` on ``device``, in
    ``dtype``: normal(0.02) and truncated-normal (std fan_in**-0.5,
    fan_in = shape[-2], cut at two std) draws, ones and zeros. The
    family's ``init_params`` builds its tree of pending leaves, then
    :meth:`finish` makes them, in the order they were asked for (the
    generator's order), each into this rank's slice of it.

    A stacked [L, ...] leaf is drawn one layer slice at a time in fp32
    and stored into its slice, so in a narrower dtype no leaf ever
    exists whole in fp32 (gpt-oss-20b's 41.8 GB of bf16 weights are 84
    GB in fp32, more than the card holds); the draws are the same in
    every dtype. With a ``mesh`` whose 'fsdp' axis holds several ranks
    (fully-sharded training) each leaf is allocated at this rank's
    slice of the family's ``param_axes`` (parallel/sharding.py
    ``leaf_box``), and every layer slice (or an unstacked leaf whole)
    is drawn into one fp32 temporary and its cut copied in: a rank
    holds its shards and one such temporary at most, and the union of
    the ranks' shards is the one-process draw, bit for bit."""

    def __init__(self, generator: torch.Generator, device, dtype,
                 mesh: Optional[mesh_lib.Mesh] = None):
        self.generator, self.device, self.dtype = generator, device, dtype
        self.mesh = mesh
        self._asked = 0

    def _pending(self, shape, fill, stacked: bool) -> _Pending:
        self._asked += 1
        return _Pending(self._asked, shape, fill, stacked)

    def normal(self, shape, std: float = 0.02,
               stacked: bool = False) -> _Pending:
        return self._pending(shape, lambda t: t.normal_(
            0.0, std, generator=self.generator), stacked)

    def trunc(self, shape) -> _Pending:
        std = 1.0 / math.sqrt(shape[-2])
        return self._pending(shape, lambda t: torch.nn.init.trunc_normal_(
            t, 0.0, std, -2 * std, 2 * std, generator=self.generator), True)

    def zeros(self, shape) -> _Pending:
        return self._pending(shape, None, False)

    def ones(self, shape) -> _Pending:
        return self._pending(shape, 'ones', False)

    def finish(self, params: Params, axes: Params) -> Params:
        """``params`` with every pending leaf made, ``axes`` the
        family's ``param_axes`` (where each leaf is cut on a mesh)."""
        todo = []

        def walk(tree, ax):
            out = {}
            for k, v in tree.items():
                if isinstance(v, dict):
                    out[k] = walk(v, ax[k])
                else:
                    out[k] = None
                    todo.append((v, ax[k], out, k))
            return out
        made = walk(params, axes)
        for leaf, ax, parent, key in sorted(todo, key=lambda t: t[0].order):
            parent[key] = self._make(leaf, ax)
        return made

    def _make(self, leaf: _Pending, axes) -> torch.Tensor:
        from skypilot_tpu_torch.parallel import sharding
        start, size = [0] * len(leaf.shape), list(leaf.shape)
        if self.mesh is not None:
            start, size = sharding.leaf_box(leaf.shape, axes, self.mesh)
        out = torch.empty(size, dtype=self.dtype, device=self.device)
        if leaf.fill is None or leaf.fill == 'ones':
            return out.fill_(0.0 if leaf.fill is None else 1.0)
        whole = list(leaf.shape) == size
        first = 1 if leaf.stacked else 0
        cut = tuple(slice(a, a + n) for a, n in
                    zip(start[first:], size[first:]))
        for part in (out.unbind(0) if leaf.stacked else (out,)):
            if whole and part.dtype == torch.float32:
                leaf.fill(part)
                continue
            tmp = torch.empty(leaf.shape[first:], dtype=torch.float32,
                              device=self.device)
            leaf.fill(tmp)
            part.copy_(tmp[cut])
            del tmp
        return out


def init_params(cfg: LlamaConfig, generator: torch.Generator,
                device='cuda', dtype=None,
                mesh: Optional[mesh_lib.Mesh] = None) -> Params:
    """Random params from ``generator`` (on ``device``), in ``dtype``
    (default cfg.param_dtype; a server asks for cfg.dtype, and gets the
    fp32 draws rounded, leaf by leaf: :class:`LeafInit`): normal(0.02)
    embeddings and truncated-normal projections with std fan_in**-0.5.
    With a ``mesh``, this rank's shards of them (:class:`LeafInit`).
    Torch's RNG stream differs from jax.random's, so these are not the
    JAX package's weights: parity tests bridge JAX weights with
    models/weights.py instead."""
    check_supported(cfg)
    hd, L, D, Fd = cfg.hd, cfg.n_layers, cfg.dim, cfg.ffn_dim
    init = LeafInit(generator, device, dtype or cfg.param_dtype, mesh)

    def norm(shape):
        # (1 + w) norms carry their identity in the "+ 1": w starts at 0.
        return init.zeros(shape) if cfg.norm_plus_one else init.ones(shape)

    layers = {
        'attn_norm': norm((L, D)),
        'wq': init.trunc((L, D, cfg.n_heads * hd)),
        'wk': init.trunc((L, D, cfg.n_kv_heads * hd)),
        'wv': init.trunc((L, D, cfg.n_kv_heads * hd)),
        'wo': init.trunc((L, cfg.n_heads * hd, D)),
        'mlp_norm': norm((L, D)),
        'w_gate': init.trunc((L, D, Fd)),
        'w_up': init.trunc((L, D, Fd)),
        'w_down': init.trunc((L, Fd, D)),
    }
    if cfg.qkv_bias:
        layers['bq'] = init.zeros((L, cfg.n_heads * hd))
        layers['bk'] = init.zeros((L, cfg.n_kv_heads * hd))
        layers['bv'] = init.zeros((L, cfg.n_kv_heads * hd))
    if cfg.post_norms:
        layers['post_attn_norm'] = norm((L, D))
        layers['post_mlp_norm'] = norm((L, D))
    if cfg.qk_norm:
        layers['q_norm'] = norm((L, hd))
        layers['k_norm'] = norm((L, hd))
    if cfg.attn_sinks:
        # exp(0) = 1 joins every softmax denominator from the start.
        layers['sink'] = init.zeros((L, cfg.n_heads))
    params: Params = {'embed': init.normal((cfg.vocab_size, D)),
                      'layers': layers, 'final_norm': norm((D,))}
    if not cfg.tie_embeddings:
        params['lm_head'] = init.normal((D, cfg.vocab_size))
    return init.finish(params, param_axes(cfg))


def param_axes(cfg: LlamaConfig) -> Params:
    """The logical axis names of every dim of :func:`init_params`' leaves,
    in its tree (the JAX ``param_specs`` before the rules map them to
    mesh axes): heads, kv_heads, mlp and vocab go over 'tensor' by the
    default rules (parallel/sharding.py)."""
    layers = {
        'attn_norm': ('layers', 'norm'),
        'wq': ('layers', 'embed', 'heads'),
        'wk': ('layers', 'embed', 'kv_heads'),
        'wv': ('layers', 'embed', 'kv_heads'),
        'wo': ('layers', 'heads', 'embed'),
        'mlp_norm': ('layers', 'norm'),
        'w_gate': ('layers', 'embed', 'mlp'),
        'w_up': ('layers', 'embed', 'mlp'),
        'w_down': ('layers', 'mlp', 'embed'),
    }
    if cfg.qkv_bias:
        layers['bq'] = ('layers', 'heads')
        layers['bk'] = ('layers', 'kv_heads')
        layers['bv'] = ('layers', 'kv_heads')
    if cfg.post_norms:
        layers['post_attn_norm'] = ('layers', 'norm')
        layers['post_mlp_norm'] = ('layers', 'norm')
    if cfg.qk_norm:
        layers['q_norm'] = ('layers', 'norm')
        layers['k_norm'] = ('layers', 'norm')
    if cfg.attn_sinks:
        layers['sink'] = ('layers', 'heads')
    axes: Params = {'embed': ('vocab', 'embed'), 'layers': layers,
                    'final_norm': ('norm',)}
    if not cfg.tie_embeddings:
        axes['lm_head'] = ('embed', 'vocab')
    return axes


def validate_divisibility(cfg: LlamaConfig, mesh_shape: Dict[str, int]):
    """Raise if the model dims don't divide the mesh axes they shard over."""
    tp = mesh_shape.get('tensor', 1)
    fsdp = mesh_shape.get('fsdp', 1)
    checks = [
        ('n_heads', cfg.n_heads, tp), ('n_kv_heads', cfg.n_kv_heads, tp),
        ('ffn_dim', cfg.ffn_dim, tp), ('vocab_size', cfg.vocab_size, tp),
        ('dim', cfg.dim, fsdp),
    ]
    for name, val, ax in checks:
        if ax > 1 and val % ax != 0:
            raise ValueError(f'{name}={val} not divisible by mesh axis '
                             f'size {ax}')


def tensor_parallel() -> Tuple[Optional[object], int, int]:
    """(group, this rank's index in it, its size) of the current mesh's
    'tensor' axis; the group is None where the axis holds one rank."""
    mesh = mesh_lib.current_mesh()
    return (mesh.group('tensor'), mesh.index('tensor'),
            mesh.shape['tensor'])


def local_kv_heads(cfg: LlamaConfig) -> int:
    """The kv heads this rank holds: all of them, or 1/N under a tensor
    mesh of N ranks (the paged pools and caches hold these)."""
    return cfg.n_kv_heads // tensor_parallel()[2]


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
    q = h @ _d(lp['wq'], cfg.dtype)
    k = h @ _d(lp['wk'], cfg.dtype)
    v = h @ _d(lp['wv'], cfg.dtype)
    if cfg.qkv_bias:
        q = q + lp['bq'].to(cfg.dtype)
        k = k + lp['bk'].to(cfg.dtype)
        v = v + lp['bv'].to(cfg.dtype)
    # This rank's heads: all of them, or a shard's (the columns it holds).
    q = q.reshape(b, s, q.shape[-1] // cfg.hd, cfg.hd)
    k = k.reshape(b, s, k.shape[-1] // cfg.hd, cfg.hd)
    v = v.reshape(b, s, v.shape[-1] // cfg.hd, cfg.hd)
    if cfg.qk_norm:
        q = _norm(q, lp['q_norm'], cfg)
        k = _norm(k, lp['k_norm'], cfg)
    return rotary.apply_rope(q, sin, cos), rotary.apply_rope(k, sin, cos), v


def row_partial(x: torch.Tensor, w, cfg: LlamaConfig) -> torch.Tensor:
    """x @ w, for w whose input rows a tensor mesh may shard: unsharded
    the product as it is; sharded this rank's fp32 partial product
    (:func:`logits_matmul`, no rounding to the compute dtype), which the
    caller sums over the group."""
    w = _d(w, cfg.dtype)
    if tensor_parallel()[0] is None:
        return x @ w
    return logits_matmul(x, w)


def _row_parallel(x: torch.Tensor, w, cfg: LlamaConfig) -> torch.Tensor:
    """:func:`row_partial`, whose fp32 partials a tensor mesh sums over
    its group in one all-reduce, then casts once, so the sum rounds
    where the unsharded product does."""
    y = row_partial(x, w, cfg)
    group = tensor_parallel()[0]
    if group is None:
        return y
    dist.all_reduce(y, group=group)
    return y.to(cfg.dtype)


def wo_project(out: torch.Tensor, lp, cfg: LlamaConfig) -> torch.Tensor:
    """Attention output projection (+ the Gemma-2 post-attention norm,
    after the sum over a tensor mesh)."""
    b, s = out.shape[:2]
    y = _row_parallel(out.reshape(b, s, -1), lp['wo'], cfg)
    if cfg.post_norms:
        y = _norm(y, lp['post_attn_norm'], cfg)
    return y


def ffn(x: torch.Tensor, lp, cfg: LlamaConfig) -> torch.Tensor:
    """Post-attention gated MLP block (pre-norm; + the Gemma-2
    post-MLP norm, after the sum over a tensor mesh)."""
    h = _norm(x, lp['mlp_norm'], cfg)
    gate = h @ _d(lp['w_gate'], cfg.dtype)
    up = h @ _d(lp['w_up'], cfg.dtype)
    down = _row_parallel(cfg.glu(gate, up), lp['w_down'], cfg)
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
    einsum's preferred_element_type), gathered over a tensor mesh from
    each rank's vocabulary slice, then the Gemma-2 final softcap on
    them."""
    x = final_norm(x, params, cfg)
    head = params['embed'].T if cfg.tie_embeddings else params['lm_head']
    logits = logits_matmul(x, head.to(cfg.dtype))
    group, _, n = tensor_parallel()
    if group is not None:
        parts = [torch.empty_like(logits) for _ in range(n)]
        dist.all_gather(parts, logits.contiguous(), group=group)
        logits = torch.cat(parts, dim=-1)
    if cfg.final_logit_softcap:
        cap = cfg.final_logit_softcap
        logits = cap * torch.tanh(logits / cap)
    return logits


def embed(params: Params, tokens: torch.Tensor, cfg: LlamaConfig
          ) -> torch.Tensor:
    """Token embeddings in cfg.dtype; Gemma scales them by sqrt(dim),
    rounded to cfg.dtype before the multiply (55.5 in bf16 at dim 3072),
    as the JAX package does. Under a tensor mesh each rank looks up the
    tokens of its vocabulary slice (zeros for the rest) and the group
    sums the rows: one rank's row and zeros, exact in fp32."""
    table = params['embed']
    group, index, _ = tensor_parallel()
    if group is None:
        if table.shape[0] != cfg.vocab_size:
            raise ValueError(
                f'the params hold {table.shape[0]} of {cfg.vocab_size} '
                f'vocabulary rows (a tensor shard) but no tensor mesh is '
                f'current: run the forward under parallel.mesh.use_mesh')
        x = table[tokens.long()].to(cfg.dtype)
    else:
        rows = table.shape[0]
        local = tokens.long() - index * rows
        mine = (local >= 0) & (local < rows)
        # Contiguous: NCCL reduces nothing else (a verify's tokens are a
        # transposed view, and the product keeps their strides).
        x = (table[local.clamp(0, rows - 1)].float() *
             mine[..., None]).contiguous()
        dist.all_reduce(x, group=group)
        x = x.to(cfg.dtype)
    if cfg.embed_scale:
        x = x * torch.full((), cfg.dim ** 0.5, dtype=cfg.dtype,
                           device=x.device)
    return x


def check_ring(cfg: LlamaConfig) -> None:
    """Refuse, in the JAX layer's words, the switches ring attention
    does not take."""
    if cfg.sliding_window is not None:
        raise NotImplementedError(
            'sliding_window (Gemma-2 local layers) with ring attention '
            'is not supported: windowed shards would need neighbor-'
            "bounded rings. Use attention_impl='auto'/'xla'.")
    if cfg.attn_logit_softcap is not None:
        raise NotImplementedError(
            'attn_logit_softcap with ring attention is not supported '
            "(the ring kernel does not cap logits); use 'auto'/'xla'.")
    if cfg.local_rope_theta is not None:
        raise NotImplementedError(
            'local_rope_theta (dual rope bases) with ring attention '
            "is not supported; use 'auto'/'xla'.")
    if cfg.attn_sinks:
        raise NotImplementedError(
            'attn_sinks (gpt-oss) with ring attention is not '
            'supported: the sink logit must join exactly one '
            "shard's softmax denominator. Use 'auto'/'xla'.")


def layer(x: torch.Tensor, lp, cfg: LlamaConfig, sin, cos,
          layer_idx: int) -> torch.Tensor:
    """One decoder layer over a whole sequence, or with ring attention
    over this rank's sequence shard: attention by ``cfg.attention_impl``
    (the plain version whenever the layer has a softcap, a window or
    sinks), then the MLP block. sin/cos are :func:`rope_tables`' (both
    bases where there are two) at the tokens' positions."""
    sin, cos = select_rope(sin, cos, layer_idx, cfg)
    q, k, v = qkv(x, lp, cfg, sin, cos)
    out = _attention(q, k, v, impl=cfg.attention_impl, causal=True,
                     layout=cfg.ring_layout,
                     **attention_switches(lp, cfg, layer_idx))
    x = x + wo_project(out, lp, cfg)
    return x + ffn(x, lp, cfg)


def fsdp_mesh() -> Optional[mesh_lib.Mesh]:
    """The current mesh when its 'fsdp' axis holds several ranks (the
    params are then this rank's shards: parallel/sharding.py), else
    None."""
    mesh = mesh_lib.current_mesh()
    return mesh if mesh.shape['fsdp'] > 1 else None


def _use_dtype(key: str, cfg: LlamaConfig) -> torch.dtype:
    """The dtype the forward reads leaf ``key`` in: fp32 for
    :data:`FP32_AT_USE`, else the compute dtype."""
    return (torch.float32 if any(tag in key for tag in FP32_AT_USE)
            else cfg.dtype)


def gather_leaves(tree, axes, cfg: LlamaConfig, mesh: mesh_lib.Mesh):
    """``tree``'s leaves whole from this rank's shards: each leaf cut
    over 'fsdp' gathered in the dtype the forward reads it in (cast
    before the gather, half the bytes of the fp32 master's), the rest
    as they are. ``axes`` holds each leaf's logical axes."""
    from skypilot_tpu_torch.parallel import sharding
    out = {}
    for k, v in tree.items():
        dim = sharding.fsdp_dim(axes[k])
        out[k] = v if dim is None else sharding.gather(
            v, dim, mesh, _use_dtype(k, cfg))
    return out


def fsdp_io(params: Params, cfg: LlamaConfig) -> Tuple[Params, Params]:
    """(the params :func:`embed` reads, the params :func:`unembed` and
    :func:`final_norm` read): ``params`` twice, or under an 'fsdp' mesh
    the leaves outside the layers gathered once a forward (the layers
    are gathered a layer at a time by :func:`apply_layers`). A tied
    embedding is gathered once for both readers, as two aliases whose
    cotangents are added in fp32."""
    mesh = fsdp_mesh()
    if mesh is None:
        return params, params
    from skypilot_tpu_torch.models import module_for
    from skypilot_tpu_torch.parallel import sharding
    n = mesh.shape['fsdp']
    if params['embed'].shape[1] * n != cfg.dim:
        raise ValueError(
            f"the embedding is {list(params['embed'].shape)}: not a shard "
            f'over fsdp={n} of dim {cfg.dim}; an fsdp mesh runs on the '
            f'shards of train_lib.init_train_state')
    axes = module_for(cfg).param_axes(cfg)
    top = {k: v for k, v in params.items() if k != 'layers'}
    if cfg.tie_embeddings:
        e_in, e_out = sharding.gather(
            params['embed'], sharding.fsdp_dim(axes['embed']), mesh,
            cfg.dtype, uses=2)
        rest = gather_leaves({k: v for k, v in top.items() if k != 'embed'},
                             axes, cfg, mesh)
        return (dict(params, embed=e_in),
                dict(params, **rest, embed=e_out))
    whole = gather_leaves(top, axes, cfg, mesh)
    return dict(params, **whole), dict(params, **whole)


def apply_layers(params: Params, cfg: LlamaConfig, step, carry):
    """The layer loop of every family's forward: ``carry = step(carry,
    lp, i)`` for each layer i, lp its slice of the stacked leaves. Under
    autograd with ``cfg.remat == 'full'`` each step is recomputed in the
    backward (a layer's forward runs twice a step, the recomputes last
    layer first). Under an 'fsdp' mesh lp is gathered from this rank's
    shards inside the step, so the recompute gathers again rather than
    keeping every layer's whole weights, and the gather's backward
    reduce-scatters each layer's grads."""
    remat = cfg.remat == 'full' and torch.is_grad_enabled()
    mesh = fsdp_mesh()
    if mesh is not None:
        from skypilot_tpu_torch.models import module_for
        axes = {k: a[1:] for k, a in
                module_for(cfg).param_axes(cfg)['layers'].items()}
        sharded_step = step

        def step(carry, lp, i):
            return sharded_step(carry, gather_leaves(lp, axes, cfg, mesh), i)
    # One unbind per stacked leaf, not an index per layer: the backward
    # of unbind stacks the L layer grads once, where indexing would
    # zero-fill and add a full [L, ...] grad for every layer.
    layers = {k: v.unbind(0) for k, v in params['layers'].items()}
    for i in range(cfg.n_layers):
        lp = {k: v[i] for k, v in layers.items()}
        if remat:
            carry = torch.utils.checkpoint.checkpoint(
                step, carry, lp, i, use_reentrant=False)
        else:
            carry = step(carry, lp, i)
    return carry


def forward(params: Params, tokens: torch.Tensor, cfg: LlamaConfig,
            return_hidden: bool = False,
            positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tokens [B, S] → logits [B, S, vocab] (fp32), or the final-norm
    hidden states [B, S, D] fp32 with ``return_hidden``. ``positions``
    [S] are the tokens' positions for RoPE (default 0..S-1); ring
    attention over a sharded sequence, or in the zigzag layout, needs
    them given. Under autograd with ``cfg.remat == 'full'`` each layer
    is recomputed in the backward (:func:`apply_layers`)."""
    check_supported(cfg)
    if cfg.attention_impl == 'ring':
        check_ring(cfg)
        if positions is None and cfg.ring_layout == 'zigzag':
            raise ValueError(
                "ring_layout='zigzag' needs zigzag-permuted tokens and "
                "explicit `positions` (ops.ring_attention.zigzag_positions)"
                " — contiguous tokens would be causally masked as if they "
                "were zigzag chunks. train_lib's train/eval steps do the "
                "permutation automatically.")
        if (positions is None and
                mesh_lib.current_mesh().shape['sequence'] > 1):
            raise ValueError(
                'ring attention over a sequence sharded on the mesh needs '
                'the shard\'s global `positions`; train_lib\'s train/eval '
                'steps pass them.')
    p_in, p_out = fsdp_io(params, cfg)
    x = embed(p_in, tokens, cfg)
    if positions is None:
        positions = torch.arange(tokens.shape[1], device=tokens.device)
    sin, cos = rope_tables(cfg, positions)
    x = apply_layers(params, cfg,
                     lambda h, lp, i: layer(h, lp, cfg, sin, cos, i), x)
    if return_hidden:
        return final_norm(x, p_out, cfg).float()
    return unembed(x, p_out, cfg)
