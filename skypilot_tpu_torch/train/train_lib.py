"""Training step for the port (port of skypilot_tpu/train/train_lib.py):
one card or the CPU, or one rank of a mesh (parallel/mesh.py) whose
'data', 'fsdp' and 'sequence' axes split the batch's rows, the params
and the sequence slots.

fp32 master params and bf16 compute, next-token cross entropy (plus
the router load-balance aux of a model whose module sets ``HAS_AUX``:
the MoE and MLA families), and the JAX package's optimizer written out
as plain tensor code: ``optax.chain(clip_by_global_norm(max_grad_norm),
adamw(warmup_cosine_decay_schedule(0, lr, warmup, max(total,
warmup + 1)), b1=.9, b2=.95, eps=1e-8, weight_decay=wd))``. The step
updates the state in place (params, moments), where the JAX step
returns a new donated state; the numbers are the same.

On a mesh, what GSPMD does for the JAX step is written out. Every rank
reads the same global batch and keeps the rows of its ('data', 'fsdp')
coordinate; the step shifts them, lays the sequence out zigzag where
the config asks for it (``_zigzag_shift``, as JAX does), and keeps this
rank's sequence slots (and their global positions). The CE is the
global masked mean: the token count is summed over the ranks before the
division and the nll sums after; a router aux takes its means over the
whole batch (models/moe.py). With 'fsdp' above 1 the params are
fully sharded, ZeRO-style, as the JAX default ``MeshSpec()`` shards
them: each leaf whose logical axes hold 'embed' is this rank's cut of
it over 'fsdp' (drawn so, ``init_train_state``), its moments too, and
the forward gathers each layer's leaves inside the layer's step
(models/llama.py ``apply_layers``), the gather's backward handing each
rank its cut of the grads summed over 'fsdp'. The grads are then summed
in flattened buckets over the rest of the batch: the shards' over
'data' and 'sequence', the whole leaves' over 'data', 'fsdp' and
'sequence'. The global norm adds every shard's squares once and every
whole leaf's once; the clip and AdamW run on every rank on its shards,
so the replicas of each shard stay bit-equal. The 'tensor', 'expert'
and 'stage' axes are not ported.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from skypilot_tpu_torch.config import LlamaConfig
from skypilot_tpu_torch.models import module_for, weights
from skypilot_tpu_torch.ops import ring_attention
from skypilot_tpu_torch.parallel import mesh as mesh_lib
from skypilot_tpu_torch.parallel import sharding

Batch = Dict[str, torch.Tensor]
Params = Dict[str, object]


@dataclasses.dataclass
class OptState:
    """The AdamW state: the update count (optax's ``ScaleByAdamState``
    and ``ScaleByScheduleState`` counts, always equal) and the first and
    second moments, trees shaped like the params."""
    count: int
    mu: Params
    nu: Params


@dataclasses.dataclass
class TrainState:
    step: int
    params: Params
    opt_state: OptState


def leaves(tree: Params) -> List[torch.Tensor]:
    """The tree's tensors in the JAX flattening order (sorted keys)."""
    return [leaf for _, leaf in weights.tree_paths(tree)]


def cross_entropy_sums(logits: torch.Tensor, targets: torch.Tensor,
                       mask: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of the masked next-token nll, the mask's token count) of
    logits [B,S,V] (computed in fp32) against targets [B,S] ints."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, targets.long()[..., None])[..., 0]
    nll = logz - gold
    mask = torch.ones_like(nll) if mask is None else mask.float()
    return (nll * mask).sum(), mask.sum()


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor,
                       mask: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean next-token CE over masked positions: (loss, token count).
    logits [B,S,V] (computed in fp32), targets [B,S] ints."""
    nll, count = cross_entropy_sums(logits, targets, mask)
    denom = count.clamp(min=1.0)
    return nll / denom, denom


def global_norm(tensors: List[torch.Tensor],
                sharded: Optional[List[bool]] = None,
                group=None) -> torch.Tensor:
    """sqrt of the sum of squares over every element (optax.global_norm).
    Where ``sharded`` flags a tensor as this rank's shard of a leaf cut
    over ``group``, its squares are summed over the group's ranks (every
    shard counted once); the other tensors are whole on every rank and
    counted once."""
    if sharded is None or group is None:
        return torch.sqrt(sum(t.float().square().sum() for t in tensors))
    zero = torch.zeros((), dtype=torch.float32, device=tensors[0].device)
    cut = sum((t.float().square().sum() for t, s in zip(tensors, sharded)
               if s), zero)
    dist.all_reduce(cut, group=group)
    whole = sum((t.float().square().sum() for t, s in zip(tensors, sharded)
                 if not s), zero)
    return torch.sqrt(cut + whole)


class AdamW:
    """``default_optimizer``: global-norm clip, then AdamW on a
    warmup-cosine learning rate, as the optax chain computes it.

    What the optax chain does and this keeps: the learning rate is the
    schedule at the update count *before* the increment (so the first
    update has lr 0); weight decay applies to every leaf, norms and the
    embedding included; the clip scales by ``max_norm / g_norm`` only
    when ``g_norm >= max_norm``, with no epsilon (unlike
    ``torch.nn.utils.clip_grad_norm_``).
    """

    def __init__(self, learning_rate: float = 3e-4,
                 weight_decay: float = 0.1, warmup_steps: int = 100,
                 total_steps: int = 10000, max_grad_norm: float = 1.0,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8):
        self.peak = learning_rate
        self.weight_decay = weight_decay
        self.warmup = warmup_steps
        self.decay_steps = max(total_steps, warmup_steps + 1)
        self.max_grad_norm = max_grad_norm
        self.b1, self.b2, self.eps = b1, b2, eps

    def learning_rate(self, count: int) -> float:
        """optax.warmup_cosine_decay_schedule(0, peak, warmup, decay)."""
        if count < self.warmup:
            return self.peak * count / self.warmup
        span = self.decay_steps - self.warmup
        done = min(count - self.warmup, span)
        return self.peak * 0.5 * (1 + math.cos(math.pi * done / span))

    def init(self, params: Params) -> OptState:
        def zeros(tree):
            if isinstance(tree, dict):
                return {k: zeros(v) for k, v in tree.items()}
            return torch.zeros_like(tree, dtype=torch.float32,
                                    requires_grad=False)
        return OptState(count=0, mu=zeros(params), nu=zeros(params))

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor], state: OptState,
               params: Params, g_norm: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
        """One update, in place: ``grads`` (the raw grads, consumed:
        clipped in place) align with ``leaves(params)``; params, mu, nu
        and the count move on (on a sharded mesh, each rank's shards).
        ``g_norm`` is the grads' global norm where the caller has it
        (:func:`global_norm` of a sharded tree), else it is computed
        here. Returns the global norm before the clip."""
        if g_norm is None:
            g_norm = global_norm(grads)
        # optax: select(g_norm < max_norm, g, (g / g_norm) * max_norm).
        keep = g_norm < self.max_grad_norm
        one = torch.ones_like(g_norm)
        denom = torch.where(keep, one, g_norm)
        mult = torch.where(keep, one, one * self.max_grad_norm)
        lr = self.learning_rate(state.count)
        count = state.count + 1
        bc1 = 1 - self.b1 ** count
        bc2 = 1 - self.b2 ** count
        for p, g, m, v in zip(leaves(params), grads, leaves(state.mu),
                              leaves(state.nu)):
            g.div_(denom).mul_(mult)
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            u = (m / bc1).div_((v / bc2).sqrt_().add_(self.eps))
            u.add_(p, alpha=self.weight_decay)
            p.add_(u, alpha=-lr)
        state.count = count
        return g_norm


def default_optimizer(learning_rate: float = 3e-4,
                      weight_decay: float = 0.1,
                      warmup_steps: int = 100,
                      total_steps: int = 10000,
                      max_grad_norm: float = 1.0) -> AdamW:
    return AdamW(learning_rate=learning_rate, weight_decay=weight_decay,
                 warmup_steps=warmup_steps, total_steps=total_steps,
                 max_grad_norm=max_grad_norm)


def init_train_state(cfg: LlamaConfig, tx: AdamW, device='cuda',
                     generator: Optional[torch.Generator] = None,
                     params: Optional[Params] = None,
                     mesh: Optional[mesh_lib.Mesh] = None) -> TrainState:
    """Step 0: ``params`` as given (e.g. bridged from JAX with
    models/weights.params_from_jax), else random from ``generator``
    (default: seed 0 on ``device``) by the config's model module, in
    cfg.param_dtype; fresh moments. On a ``mesh`` whose 'fsdp' axis
    holds several ranks, this rank's shards: drawn so (no rank holds a
    whole tree; the union of the shards is the one-process draw), or
    cut from the given params; the moments at the shards' size."""
    if params is None:
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        params = module_for(cfg).init_params(cfg, generator, device,
                                             mesh=fsdp_mesh(mesh))
    elif fsdp_mesh(mesh) is not None:
        params = sharding.shard_params(params,
                                       module_for(cfg).param_axes(cfg), mesh)
    for leaf in leaves(params):
        leaf.requires_grad_(True)
    return TrainState(step=0, params=params, opt_state=tx.init(params))


def _shift(tokens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return tokens[:, :-1], tokens[:, 1:]


def _zigzag_seq_shards(cfg: LlamaConfig, mesh: mesh_lib.Mesh) -> int:
    """0 when the config doesn't use zigzag ring attention; otherwise the
    'sequence' mesh size (>=1) — the zigzag layout then applies to
    tokens/targets/positions even at size 1 (identity permutation), so the
    model's explicit-positions guard is always satisfied."""
    if cfg.attention_impl == 'ring' and cfg.ring_layout == 'zigzag':
        return max(1, mesh.shape['sequence'])
    return 0


def _zigzag_shift(tokens: torch.Tensor, mask: Optional[torch.Tensor],
                  n_seq: int):
    """Shift tokens into (inputs, targets) and lay the sequence dim out in
    zigzag order so every 'sequence' shard does equal causal ring work
    (ops/ring_attention.py). Returns (inputs, targets, mask, positions);
    positions are the original sequence positions each layout slot holds —
    forward() feeds them to RoPE, so the permutation is invisible to the
    math (CE loss is a masked mean over positions, permutation-invariant).
    n_seq == 0 means "not zigzag": no permutation, default positions.
    """
    inputs, targets = _shift(tokens)
    if n_seq == 0:
        return inputs, targets, mask, None
    perm = torch.as_tensor(
        ring_attention.zigzag_positions(inputs.shape[1], n_seq),
        device=tokens.device)
    inputs = inputs.index_select(1, perm)
    targets = targets.index_select(1, perm)
    if mask is not None:
        mask = mask.index_select(1, perm)
    return inputs, targets, mask, perm


# Unported mesh axes, each refused by name.
UNPORTED_AXES = ('stage', 'expert', 'tensor')


def check_mesh(cfg: LlamaConfig, mesh: mesh_lib.Mesh) -> None:
    """Refuse what the port's step does not do on ``mesh``: the
    unported axes (tensor, expert, stage), a model dim that does not
    divide over 'fsdp', and a sharded sequence without ring attention
    (which the MoE and MLA families do not take:
    config.check_supported)."""
    big = [f'{ax}={mesh.shape[ax]}' for ax in UNPORTED_AXES
           if mesh.shape[ax] > 1]
    if big:
        raise NotImplementedError(
            f'mesh axes {", ".join(big)} over {mesh.size} ranks are not '
            f'ported to training: the tensor, expert and stage axes wait '
            f'for ROADMAP Queue 1 item 8 (parallelism). Lay the '
            f'{mesh.size} ranks out over data, fsdp and sequence (the '
            f'default, no --mesh, is fsdp={mesh.size}; or data=N,fsdp=M '
            f'or fsdp=M,sequence=K with a product of {mesh.size}).')
    fsdp = mesh.shape['fsdp']
    if fsdp > 1 and cfg.dim % fsdp:
        raise ValueError(f'dim={cfg.dim} not divisible by mesh axis fsdp '
                         f'size {fsdp}')
    if mesh.shape['sequence'] > 1 and cfg.attention_impl != 'ring':
        raise ValueError(
            f"a mesh with sequence={mesh.shape['sequence']} needs "
            f"attention_impl='ring' (got {cfg.attention_impl!r}): other "
            f'attention would see only its own shard')


def fsdp_mesh(mesh: Optional[mesh_lib.Mesh]) -> Optional[mesh_lib.Mesh]:
    """``mesh`` when its 'fsdp' axis holds several ranks (the params are
    then sharded), else None."""
    return mesh if mesh is not None and mesh.shape['fsdp'] > 1 else None


def sharded_leaves(cfg: LlamaConfig, mesh: mesh_lib.Mesh) -> List[bool]:
    """Per leaf of the params (:func:`leaves` order): whether this rank
    holds a shard of it over 'fsdp' rather than the whole leaf."""
    if fsdp_mesh(mesh) is None:
        return [False] * len(leaves(module_for(cfg).param_axes(cfg)))
    return [sharding.fsdp_dim(ax) is not None
            for ax in leaves(module_for(cfg).param_axes(cfg))]


def mesh_groups(mesh: mesh_lib.Mesh) -> Dict[str, object]:
    """The process groups the step uses, made on every rank in one
    order (torch's rule for new groups): the whole batch
    ('data', 'fsdp', 'sequence'), the grads of the shards ('data',
    'sequence'), the router aux's batch ('data', 'fsdp') and 'fsdp'."""
    return {'batch': mesh.group('data', 'fsdp', 'sequence'),
            'replicas': mesh.group('data', 'sequence'),
            'rows': mesh.group('data', 'fsdp'),
            'fsdp': mesh.group('fsdp')}


def _local_batch(cfg: LlamaConfig, mesh: mesh_lib.Mesh, tokens, mask):
    """This rank's (inputs, targets, mask, positions) of its rows
    [B_local, S+1]: shifted, zigzag-permuted where asked, cut to its
    sequence slots. positions None: 0..S-1 (one sequence shard)."""
    inputs, targets, mask, positions = _zigzag_shift(
        tokens, mask, _zigzag_seq_shards(cfg, mesh))
    if mesh.shape['sequence'] == 1:
        return inputs, targets, mask, positions
    if positions is None:
        positions = torch.arange(inputs.shape[1], device=tokens.device)

    def cut(x, dim):
        return None if x is None else sharding.local_shard(x, 'seq', dim,
                                                           mesh)
    return cut(inputs, 1), cut(targets, 1), cut(mask, 1), cut(positions, 0)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``x`` over ``group``'s ranks (``x`` itself without one)."""
    if group is not None:
        x = x.clone()
        dist.all_reduce(x, group=group)
    return x


# Grads are summed in flat buckets of about this many bytes: one
# collective a bucket, not one a leaf.
BUCKET_BYTES = 1 << 28


def all_reduce_grads(grads: List[torch.Tensor], group) -> None:
    """Sum each grad over ``group``'s ranks, in place, bucket by bucket
    (consecutive leaves of one dtype, up to BUCKET_BYTES a bucket)."""
    if group is None:
        return
    bucket: List[torch.Tensor] = []
    size = 0

    def flush():
        flat = torch.cat([g.reshape(-1) for g in bucket])
        dist.all_reduce(flat, group=group)
        off = 0
        for g in bucket:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()
    for g in grads:
        nbytes = g.numel() * g.element_size()
        if bucket and (size + nbytes > BUCKET_BYTES or
                       g.dtype != bucket[0].dtype):
            flush()
            bucket, size = [], 0
        bucket.append(g)
        size += nbytes
    if bucket:
        flush()


def forward_with_aux(cfg: LlamaConfig, params: Params, inputs: torch.Tensor,
                     positions: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(logits, the router aux to add to the loss): the model module's
    ``forward(return_aux=True)`` when it sets ``HAS_AUX``, else its
    logits and 0. ``positions`` (the dense family's ring attention)
    are passed on where given."""
    mod = module_for(cfg)
    if getattr(mod, 'HAS_AUX', False):
        return mod.forward(params, inputs, cfg, return_aux=True)
    if positions is not None:
        return mod.forward(params, inputs, cfg, positions=positions), 0.0
    return mod.forward(params, inputs, cfg), 0.0


def make_grad_fn(cfg: LlamaConfig, grad_accum_steps: int = 1,
                 mesh: Optional[mesh_lib.Mesh] = None
                 ) -> Callable[[Params, Batch],
                               Tuple[List[torch.Tensor], torch.Tensor,
                                     torch.Tensor, torch.Tensor]]:
    """(params, batch) → (grads, loss, tokens, aux): the grads of the CE
    plus the router aux over the global batch, aligned with
    ``leaves(params)`` (on an fsdp mesh this rank's shards of them),
    summed over every rank; the CE alone (0-d), the target-token count
    and the aux (0 without a router; the same on every rank, its means
    taken over the whole batch). The batch and ``grad_accum_steps`` as
    :func:`make_train_step` takes them."""
    mesh = mesh or mesh_lib.single_device_mesh()
    check_mesh(cfg, mesh)
    groups = mesh_groups(mesh)
    group = groups['batch']
    sharded = sharded_leaves(cfg, mesh)

    def grads_of(params, tokens, mask):
        inputs, targets, mask, positions = _local_batch(cfg, mesh, tokens,
                                                        mask)
        with mesh_lib.use_mesh(mesh):
            logits, aux = forward_with_aux(cfg, params, inputs, positions)
            nll, count = cross_entropy_sums(logits, targets, mask)
            denom = _all_reduce(count.detach(), group).clamp(min=1.0)
            loss = nll / denom
            grads = torch.autograd.grad(loss + aux, leaves(params))
        aux = aux.detach() if torch.is_tensor(aux) else torch.zeros(())
        return list(grads), _all_reduce(loss.detach(), group), denom, aux

    def grad_fn(params: Params, batch: Batch):
        tokens = batch['tokens']
        mask = batch.get('loss_mask')
        a = grad_accum_steps
        if a == 1:
            grads, loss, denom, aux = grads_of(params, tokens, mask)
        else:
            b = tokens.shape[0]
            if b % a != 0:
                raise ValueError(f'batch {b} not divisible by '
                                 f'grad_accum_steps {a}')
            grads = None
            l_sum = d_sum = x_sum = 0.0
            for tok_m, mask_m in zip(
                    tokens.chunk(a), mask.chunk(a) if mask is not None
                    else [None] * a):
                g, loss_m, denom_m, aux_m = grads_of(params, tok_m, mask_m)
                if grads is None:
                    grads = [gi * denom_m for gi in g]
                else:
                    for s, gi in zip(grads, g):
                        s.add_(gi * denom_m)
                l_sum = l_sum + loss_m * denom_m
                x_sum = x_sum + aux_m.to(denom_m.device) * denom_m
                d_sum = d_sum + denom_m
            d_safe = d_sum.clamp(min=1.0)
            grads = [g / d_safe for g in grads]
            loss, denom, aux = l_sum / d_safe, d_sum, x_sum / d_safe
        # The shards' grads are summed over 'fsdp' already (the
        # gather's backward); the whole leaves' are not.
        all_reduce_grads([g for g, s in zip(grads, sharded) if s],
                         groups['replicas'])
        all_reduce_grads([g for g, s in zip(grads, sharded) if not s],
                         group)
        return grads, loss, denom, aux

    return grad_fn


def make_train_step(cfg: LlamaConfig, tx: AdamW, grad_accum_steps: int = 1,
                    mesh: Optional[mesh_lib.Mesh] = None
                    ) -> Callable[[TrainState, Batch],
                                  Tuple[TrainState, Dict[str, object]]]:
    """(state, batch) → (state, metrics); the state moves on in place.

    batch: {'tokens': int [B, S+1]}, shifted here; an optional
    'loss_mask' [B, S] masks the target positions. On a ``mesh`` the
    batch is this rank's rows (data/loader.py ``shard_batch``) at the
    full length; the step keeps its sequence slots, and on an fsdp mesh
    the state is this rank's shards (:func:`init_train_state`).
    grad_accum_steps > 1 splits the batch into that many microbatches
    run one after another before one update, weighting each
    microbatch's mean grad by its target-token count, so the update
    equals the dense step. The grads are those of the CE plus the
    router aux (each microbatch's own aux inside its grads, as in the
    JAX scan): :func:`make_grad_fn`. Metrics: loss (the CE alone, over
    the global batch), grad_norm (of the unclipped grads, every shard
    counted once), tokens, aux (the router aux; 0-d tensors, not
    synchronised) and step.
    """
    mesh = mesh or mesh_lib.single_device_mesh()
    grad_fn = make_grad_fn(cfg, grad_accum_steps, mesh)
    sharded = sharded_leaves(cfg, mesh)
    fsdp = mesh_groups(mesh)['fsdp']

    def step_fn(state: TrainState, batch: Batch):
        grads, loss, denom, aux = grad_fn(state.params, batch)
        gnorm = tx.update(grads, state.opt_state, state.params,
                          global_norm(grads, sharded, fsdp))
        metrics = {'loss': loss, 'grad_norm': gnorm, 'tokens': denom,
                   'aux': aux, 'step': state.step}
        state.step += 1
        return state, metrics

    return step_fn


def make_eval_step(cfg: LlamaConfig, mesh: Optional[mesh_lib.Mesh] = None
                   ) -> Callable[[Params, Batch], torch.Tensor]:
    """Forward-only loss: (params, batch) → 0-d mean CE over the global
    batch, no grad (the router aux is asked for and dropped, as in JAX).
    On a ``mesh``, as :func:`make_train_step` takes its batch."""
    mesh = mesh or mesh_lib.single_device_mesh()
    check_mesh(cfg, mesh)
    group = mesh_groups(mesh)['batch']

    @torch.no_grad()
    def eval_fn(params, batch: Batch) -> torch.Tensor:
        inputs, targets, mask, positions = _local_batch(
            cfg, mesh, batch['tokens'], batch.get('loss_mask'))
        with mesh_lib.use_mesh(mesh):
            logits, _ = forward_with_aux(cfg, params, inputs, positions)
        nll, count = cross_entropy_sums(logits, targets, mask)
        return _all_reduce(nll, group) / _all_reduce(count, group).clamp(
            min=1.0)

    return eval_fn


def synthetic_batch(generator: torch.Generator, batch_size: int,
                    seq_len: int, vocab_size: int, device='cuda') -> Batch:
    tokens = torch.randint(0, vocab_size, (batch_size, seq_len + 1),
                           generator=generator, device=device,
                           dtype=torch.int32)
    return {'tokens': tokens}
