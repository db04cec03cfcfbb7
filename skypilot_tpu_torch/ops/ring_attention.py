"""Ring attention: exact context-parallel attention over the 'sequence'
axis (port of skypilot_tpu/ops/ring_attention.py).

Each rank of the 'sequence' process group holds one shard of the
sequence. K/V shards travel around the ring while every rank computes
flash-attention partials against its resident Q shard; the partials
merge by the log-sum-exp rule. Where the JAX package rotates with
``lax.ppermute`` inside a ``shard_map``, the port sends this shard's
tensors to rank ``me + 1`` and receives rank ``me - 1``'s with
``torch.distributed.batch_isend_irecv`` (:func:`_rotate`); under gloo a
tensor on a card goes through a host buffer, since gloo's point-to-point
takes host tensors. Communication does not overlap the kernels yet.

The backward is an explicit forward-style ring (the JAX ``custom_vjp``,
here one ``torch.autograd.Function``): K/V rotate as in the forward,
with their gradient accumulators (fp32) travelling alongside, so after
n steps each (dk, dv) has every rank's contribution and is home.

Kernels: each visible block's forward partial is kernel A
(``flash_attention_lse``, gated by ``flash_attention.flash_takes``, the
JAX ``_flash_ok``; the plain version elsewhere), and its backward is
kernels C and D in their fp32 mode (``_bwd(grad_dtype=torch.float32)``)
where :func:`_flash_bwd_ok` holds, else the chunked einsum route
(``SKYTPU_RING_BWD_CHUNK``), which is the JAX gate's route for shapes
the kernels do not take, not a fallback from a failure. A causal block
with nothing visible launches nothing, as JAX's ``lax.switch`` runs no
branch but the one it picks.

RoPE must already be applied at global positions (the model does, from
the positions the train step gives it; zigzag permutes them with
:func:`zigzag_positions`).

Causal layouts:
  * 'seq'    — contiguous shards: shard i has causal work for i + 1 of
    the n ring steps.
  * 'zigzag' — the global sequence is cut into 2n chunks and shard i
    holds chunks (i, 2n-1-i), so every shard does the same causal work.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from skypilot_tpu_torch.ops import flash_attention as fa
from skypilot_tpu_torch.ops.attention import NEG_INF, xla_attention_lse
from skypilot_tpu_torch.utils import knobs

# ---------------------------------------------------------------------------
# Zigzag layout helpers
# ---------------------------------------------------------------------------


def zigzag_chunk_order(n_shards: int) -> list:
    """Chunk ids in device-layout order: shard i holds (i, 2n-1-i)."""
    return [c for s in range(n_shards) for c in (s, 2 * n_shards - 1 - s)]


def zigzag_positions(seq_len: int, n_shards: int) -> np.ndarray:
    """positions[j] = original sequence position stored at layout slot j.

    Doubles as the gather index that permutes a contiguous sequence into
    zigzag layout, and as the ``positions`` argument for RoPE."""
    if seq_len % (2 * n_shards) != 0:
        raise ValueError(f'seq_len {seq_len} must divide into '
                         f'2*{n_shards} zigzag chunks.')
    chunk = seq_len // (2 * n_shards)
    order = zigzag_chunk_order(n_shards)
    return np.concatenate(
        [np.arange(c * chunk, (c + 1) * chunk) for c in order])


def zigzag_permute(x: torch.Tensor, n_shards: int, axis: int = 1
                   ) -> torch.Tensor:
    """Reorder a contiguous sequence dim into zigzag device layout."""
    perm = zigzag_positions(x.shape[axis], n_shards)
    return x.index_select(axis, torch.as_tensor(perm, device=x.device))


def zigzag_unpermute(x: torch.Tensor, n_shards: int, axis: int = 1
                     ) -> torch.Tensor:
    """Inverse of :func:`zigzag_permute`."""
    inv = np.argsort(zigzag_positions(x.shape[axis], n_shards))
    return x.index_select(axis, torch.as_tensor(inv, device=x.device))


# ---------------------------------------------------------------------------
# Log-sum-exp combine + single-block partials
# ---------------------------------------------------------------------------

def _combine(o: torch.Tensor, lse: torch.Tensor, o_i: torch.Tensor,
             lse_i: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge two normalized attention partials via their log-sum-exps.

    o, o_i: [B,S,H,D] (o fp32); lse, lse_i: [B,S,H] fp32."""
    m = torch.maximum(lse, lse_i)
    w = torch.exp(lse - m)[..., None]
    w_i = torch.exp(lse_i - m)[..., None]
    denom = w + w_i
    o_new = (o * w + o_i.float() * w_i) / denom
    lse_new = m + torch.log(denom[..., 0])
    return o_new, lse_new


def _partial(q, k, v, causal: bool, softmax_scale):
    """(out [B,S,H,D], lse [B,S,H]) for one visible block: kernel A where
    it takes the call, the plain version elsewhere (the JAX gate)."""
    if fa.flash_takes(q, k, v, wants_grad=False):
        return fa.flash_attention_lse(q, k, v, causal=causal,
                                      softmax_scale=softmax_scale)
    return xla_attention_lse(q, k, v, causal=causal,
                             softmax_scale=softmax_scale)


# rel: 0 = kv chunk strictly earlier (fully visible), 1 = the same chunk
# (causal diagonal), 2 = kv later (nothing visible: skipped).
FULL, DIAG, SKIP = 0, 1, 2


def _block_partial(qa, kb, vb, rel: int, softmax_scale):
    """Partial for one q-chunk × kv-chunk pair; None when skipped."""
    if rel == SKIP:
        return None
    return _partial(qa, kb, vb, causal=rel == DIAG,
                    softmax_scale=softmax_scale)


def _chunk_ids(shard_idx: int, n: int, layout: str) -> Tuple[int, ...]:
    if layout == 'zigzag':
        return (shard_idx, 2 * n - 1 - shard_idx)
    return (shard_idx,)


def _rel(q_chunk: int, kv_chunk: int) -> int:
    if kv_chunk == q_chunk:
        return DIAG
    return FULL if kv_chunk < q_chunk else SKIP


# ---------------------------------------------------------------------------
# The ring's point-to-point step
# ---------------------------------------------------------------------------

class _Ring(NamedTuple):
    group: Optional[object]     # the 'sequence' process group (None: 1 rank)
    causal: bool
    softmax_scale: Optional[float]
    layout: str

    @property
    def n(self) -> int:
        return 1 if self.group is None else dist.get_world_size(self.group)

    @property
    def me(self) -> int:
        return 0 if self.group is None else dist.get_rank(self.group)


def _rotate(tensors: List[torch.Tensor], group) -> List[torch.Tensor]:
    """Send ``tensors`` to the next rank of ``group``'s ring and return
    the previous rank's in their place, in one message: the tensors
    packed into one byte buffer (widest dtype first, so every view stays
    aligned), one ``batch_isend_irecv``. Under gloo a buffer on a card
    crosses through host memory (gloo's send and recv take host
    tensors)."""
    ranks = dist.get_process_group_ranks(group)
    n, me = len(ranks), dist.get_rank(group)
    flat = torch.cat([t.contiguous().reshape(-1).view(torch.uint8)
                      for t in tensors])
    staged = flat.is_cuda and dist.get_backend(group) == 'gloo'
    send = flat.cpu() if staged else flat
    recv = torch.empty_like(send)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send, ranks[(me + 1) % n], group),
        dist.P2POp(dist.irecv, recv, ranks[(me - 1) % n], group)])
    for req in reqs:
        req.wait()
    if staged:
        recv = recv.to(flat.device)
    out, off = [], 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        out.append(recv[off:off + nbytes].view(t.dtype).view(t.shape))
        off += nbytes
    return out


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _ring_forward(q, k, v, ring: _Ring) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [B,Sl,H,D] q.dtype, lse [B,Sl,H] fp32) of this rank's shard."""
    n, me = ring.n, ring.me
    b, sl, h, d = q.shape
    causal, layout = ring.causal, ring.layout
    qcs = _chunk_ids(me, n, layout) if causal else (me,)
    ncq = len(qcs)
    csize = sl // ncq
    if causal and layout == 'zigzag' and sl % 2 != 0:
        raise ValueError(f'zigzag needs an even local shard, got {sl}')

    o = torch.zeros((b, sl, h, d), dtype=torch.float32, device=q.device)
    lse = torch.full((b, sl, h), NEG_INF, dtype=torch.float32,
                     device=q.device)
    k_c, v_c = k, v
    for i in range(n):
        src = (me - i) % n                 # whose kv shard we hold now
        if not causal:
            o_i, lse_i = _partial(q, k_c, v_c, False, ring.softmax_scale)
        else:
            kcs = _chunk_ids(src, n, layout)
            o_rows, lse_rows = [], []
            for a in range(ncq):
                qa = q[:, a * csize:(a + 1) * csize]
                o_a = torch.zeros((b, csize, h, d), dtype=torch.float32,
                                  device=q.device)
                lse_a = torch.full((b, csize, h), NEG_INF,
                                   dtype=torch.float32, device=q.device)
                for bi, kc in enumerate(kcs):
                    part = _block_partial(
                        qa, k_c[:, bi * csize:(bi + 1) * csize],
                        v_c[:, bi * csize:(bi + 1) * csize],
                        _rel(qcs[a], kc), ring.softmax_scale)
                    if part is not None:
                        o_a, lse_a = _combine(o_a, lse_a, *part)
                o_rows.append(o_a)
                lse_rows.append(lse_a)
            o_i = torch.cat(o_rows, dim=1)
            lse_i = torch.cat(lse_rows, dim=1)
        o, lse = _combine(o, lse, o_i, lse_i)
        if i < n - 1:                      # the last shard is not sent on
            k_c, v_c = _rotate([k_c, v_c], ring.group)
    return o.to(q.dtype), lse


# ---------------------------------------------------------------------------
# Backward
# ---------------------------------------------------------------------------

# Long-context backward memory bound: KV chunks larger than this run in
# a loop, so the materialized score block is [B,KH,G,Sq,CHUNK] fp32.
_BWD_KV_CHUNK = knobs.get_int('SKYTPU_RING_BWD_CHUNK')
# Flash-kernel backward dispatch: '' = auto (on the card, aligned
# shapes), '1' = force (the CPU then runs the kernels' plain version),
# '0' = always the einsum route.
_BWD_FLASH = knobs.get_enum('SKYTPU_RING_BWD_FLASH')


def _flash_bwd_ok(sq: int, tk: int, d: int, on_card: bool,
                  dtype=torch.bfloat16) -> bool:
    """The JAX ``_flash_bwd_ok``: sq and tk multiples of 128, and (in
    auto mode) the accelerator, not the CPU. JAX also wants d a multiple
    of 128, the TPU lanes' width; on the card the head dim is asked of
    kernels C and D instead (bf16 at a head dim in ``BWD_HEAD_DIMS``,
    64 among them), so a hd-64 model's ring backward runs the kernels
    too. Off the card the gate is JAX's whole."""
    if _BWD_FLASH == '0':
        return False
    shapes_ok = sq % 128 == 0 and tk % 128 == 0
    if on_card:
        shapes_ok = (shapes_ok and dtype == torch.bfloat16 and
                     d in fa.BWD_HEAD_DIMS)
    else:
        shapes_ok = shapes_ok and d % 128 == 0
    if _BWD_FLASH == '1':
        return shapes_ok
    return shapes_ok and on_card


def _flash_block_grads(qa, do_a, lse_a, delta_a, kb, vb, masked: bool,
                       scale: float):
    """Block gradients through kernels C and D in their fp32 mode (their
    plain version on the CPU). ``_bwd`` takes the pre-scaled q and
    derives delta = rowsum(out * do) - dlse itself; the ring already
    holds the global delta, so it rides in as dlse = -delta with out = 0
    (out has no other use in ``_bwd``)."""
    qs = (qa * scale).to(qa.dtype)
    dq, dk, dv = fa._bwd(qs, kb, vb, torch.zeros_like(do_a),
                         lse_a.transpose(1, 2).contiguous(), do_a,
                         -delta_a.transpose(1, 2), masked,
                         # fp32 partials: each block grad is summed
                         # across ring steps.
                         grad_dtype=torch.float32)
    # dq is with respect to the pre-scaled q: chain through the scale.
    return dq * scale, dk, dv


def _block_grads(qa, do_a, lse_a, delta_a, kb, vb, rel: int, scale: float):
    """(dq, dk, dv) fp32 of one q-chunk × kv-chunk pair, None when the
    pair is skipped. Uses the final forward lse, so each block's
    probabilities are already normalized globally:
      P = exp(S - lse); dV = Pᵀ·dO; dP = dO·Vᵀ; dS = P ⊙ (dP - Δ);
      dQ = dS·K·scale; dK = dSᵀ·Q·scale.
    Shapes: qa/do_a [B,Sq,H,D], kb/vb [B,Tk,KH,D], lse_a/delta_a
    [B,Sq,H]."""
    if rel == SKIP:
        return None
    masked = rel == DIAG
    b, sq, h, d = qa.shape
    tk, kh = kb.shape[1], kb.shape[2]
    g = h // kh
    if _flash_bwd_ok(sq, tk, d, qa.is_cuda, qa.dtype):
        return _flash_block_grads(qa, do_a, lse_a, delta_a, kb, vb, masked,
                                  scale)

    qg = qa.reshape(b, sq, kh, g, d).float()
    dog = do_a.reshape(b, sq, kh, g, d).float()
    lse_g = lse_a.reshape(b, sq, kh, g).permute(0, 2, 3, 1)
    delta_g = delta_a.reshape(b, sq, kh, g).permute(0, 2, 3, 1)

    def vs_kv_chunk(kf, vf, kv_off):
        s = torch.einsum('bskgd,btkd->bkgst', qg, kf) * scale
        if masked:
            ck = kf.shape[1]
            keep = (torch.arange(sq, device=qa.device)[:, None] >=
                    torch.arange(ck, device=qa.device)[None, :] + kv_off)
            s = torch.where(keep, s, torch.full_like(s, NEG_INF))
        p = torch.exp(s - lse_g[..., None])
        dv = torch.einsum('bkgst,bskgd->btkd', p, dog)
        dp = torch.einsum('bskgd,btkd->bkgst', dog, vf)
        ds = p * (dp - delta_g[..., None])
        dq = torch.einsum('bkgst,btkd->bskgd', ds, kf).reshape(
            b, sq, h, d) * scale
        dk = torch.einsum('bkgst,bskgd->btkd', ds, qg) * scale
        return dq, dk, dv

    kf_all, vf_all = kb.float(), vb.float()
    # The largest divisor of tk <= the target chunk, so the memory bound
    # holds for any shard size.
    ck = min(_BWD_KV_CHUNK, tk)
    while tk % ck != 0:
        ck -= 1
    dq = None
    dks, dvs = [], []
    for off in range(0, tk, ck):
        dq_c, dk_c, dv_c = vs_kv_chunk(kf_all[:, off:off + ck],
                                       vf_all[:, off:off + ck], off)
        dq = dq_c if dq is None else dq + dq_c
        dks.append(dk_c)
        dvs.append(dv_c)
    return dq, torch.cat(dks, dim=1), torch.cat(dvs, dim=1)


def _ring_backward(q, k, v, o, lse, do, ring: _Ring):
    """(dq, dk, dv) fp32 of this rank's shard. The kv shards rotate as
    in the forward, their gradient accumulators alongside: after n steps
    each (dk, dv) has collected every rank's contribution and is home."""
    n, me = ring.n, ring.me
    b, sl, h, d = q.shape
    kh = k.shape[2]
    scale = (ring.softmax_scale if ring.softmax_scale is not None
             else d ** -0.5)
    causal, layout = ring.causal, ring.layout
    qcs = _chunk_ids(me, n, layout) if causal else (me,)
    ncq = len(qcs)
    csize = sl // ncq

    # Δ = rowsum(dO ⊙ O): one value per q position, shared by every block.
    delta = (do.float() * o.float()).sum(-1)

    dq = torch.zeros((b, sl, h, d), dtype=torch.float32, device=q.device)
    dk_c = torch.zeros((b, sl, kh, d), dtype=torch.float32, device=q.device)
    dv_c = torch.zeros_like(dk_c)
    k_c, v_c = k, v
    for i in range(n):
        src = (me - i) % n
        if not causal:
            dq_i, dk_i, dv_i = _block_grads(q, do, lse, delta, k_c, v_c,
                                            FULL, scale)
            dq += dq_i
            dk_c += dk_i
            dv_c += dv_i
        else:
            kcs = _chunk_ids(src, n, layout)
            for a in range(ncq):
                sla = slice(a * csize, (a + 1) * csize)
                for bi, kc in enumerate(kcs):
                    slb = slice(bi * csize, (bi + 1) * csize)
                    grads = _block_grads(
                        q[:, sla], do[:, sla], lse[:, sla], delta[:, sla],
                        k_c[:, slb], v_c[:, slb], _rel(qcs[a], kc), scale)
                    if grads is None:
                        continue
                    dq[:, sla] += grads[0]
                    dk_c[:, slb] += grads[1]
                    dv_c[:, slb] += grads[2]
        if n > 1:
            # dk, dv always travel (home after n steps); k, v not after
            # the last step.
            if i < n - 1:
                dk_c, dv_c, k_c, v_c = _rotate([dk_c, dv_c, k_c, v_c],
                                               ring.group)
            else:
                dk_c, dv_c = _rotate([dk_c, dv_c], ring.group)
    return dq, dk_c, dv_c


class _RingAttention(torch.autograd.Function):
    """The JAX ``_ring_local`` custom VJP: the forward ring saves q, k,
    v, the output and its lse; the backward ring returns the grads in
    the inputs' dtypes."""

    @staticmethod
    def forward(ctx, q, k, v, ring):
        out, lse = _ring_forward(q, k, v, ring)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.ring = ring
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _ring_backward(q, k, v, o, lse, g.contiguous(),
                                    ctx.ring)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   group=None, causal: bool = True,
                   softmax_scale: Optional[float] = None,
                   layout: str = 'seq') -> torch.Tensor:
    """Exact attention over a sequence sharded across ``group`` (the
    mesh's 'sequence' group; None for one rank, where the ring is one
    step with no communication).

    q [B,Sl,H,D], k/v [B,Sl,KH,D]: this rank's shard (layout 'seq':
    contiguous, rank i holding slots [i*Sl, (i+1)*Sl); 'zigzag': the
    zigzag-permuted sequence cut the same way). Returns the local output
    shard [B,Sl,H,D] in q.dtype, differentiable in q, k and v. Every rank
    of the group calls it with the same shapes, in the same order."""
    if layout not in ('seq', 'zigzag'):
        raise ValueError(f"ring layout must be 'seq' or 'zigzag', got "
                         f'{layout!r}')
    return _RingAttention.apply(q, k, v,
                                _Ring(group, causal, softmax_scale, layout))
