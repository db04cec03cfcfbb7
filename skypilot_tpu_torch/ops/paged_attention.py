"""In-place paged attention: kernel B, its plain version, and the step
entry point (port of skypilot_tpu/ops/paged_attention.py and
skypilot_tpu/ops/pallas/paged_attention.py).

Pools are ``[n_pages, page_size, KH, hd]`` per layer, tables
``[B, max_pages]`` int32, page 0 is the trash page.

:func:`paged_attention_step` has two formulations, chosen by where the
tensors lie:

  - CUDA, plain causal attention: write the step's new K/V into the
    pool first, then launch the hand-written kernel
    (csrc/paged_decode.cu, head_dim 64, 128 or 256) that streams pages
    through the table — the JAX ``impl='pallas'`` branch. The kernel
    splits each row's pages over blocks (:func:`split_pages`) and merges
    their partials itself, through a workspace this module keeps per
    (device, stream) (:func:`_workspace`).
  - CPU, a step with a logit softcap, a sliding window or sinks on
    any device, or a shape the kernel does not take (:func:`kernel_takes`):
    the fused overlay-then-attend formulation — gather this
    layer's view from the pre-write pool, overlay the new K/V at each
    row's positions, run the plain attention, then write the pool —
    the JAX ``impl='fused'`` branch. The kernel takes none of those
    switches, as the JAX kernel takes none (``_pallas_ok``); the choice
    is made from the arguments before anything is launched.

Both update the pool IN PLACE (the JAX version returns new pools);
the returned pools are the same tensors that were passed in.

int8 pools (``SKYTPU_ENGINE_KV_QUANT=int8``): the pools hold int8 codes
and ``k_scale`` / ``v_scale`` [n_pages, psz, KH] fp32 sidecars, one
scale per vector (:func:`quantize_values`). Kernel B reads bf16 pools
only, so a step with scales takes the fused formulation on every
device, as JAX's ``impl == 'pallas' and k_scale is None`` gate sends
it there: the gather dequantizes, the new K/V quantize on the way in.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch

from skypilot_tpu_torch.kernels import build
from skypilot_tpu_torch.ops.attention import xla_attention

KERNEL = build.Kernel(
    name='paged_decode', source='paged_decode.cu', symbol='paged_decode_bf16',
    argtypes=('p',) * 8 + ('l',) + ('i',) * 10 + ('f', 'p'))

HEAD_DIMS = (64, 128, 256)  # the kernel's head dims
MAX_ROWS = 64       # the kernel's g * S limit per block: four 16-row tiles
MAX_PAGE_SIZE = 128  # the kernel's ring holds K and V tiles of <= 128 keys
WARPS = 4           # the kernel's warps a block
# Blocks the chunk count aims for, per SM, by head_dim: at 64 and 128
# two fit on an SM at once (page 64; the block's launch bound), at 256
# one; twice that evens out rows of unequal length.
BLOCKS_PER_SM = {64: 4, 128: 4, 256: 2}


def split_pages(batch: int, kv_heads: int, max_pages: int, n_sm: int,
                head_dim: int = 128) -> Tuple[int, int]:
    """(chunks, pages per chunk) for kernel B's grid (chunks, KH, B):
    the chunk count aims at BLOCKS_PER_SM[head_dim] blocks per SM (never
    more chunks than pages), then rounds down so that every chunk but
    the last holds the same number of pages. The lengths are not known
    here: a chunk past its row's last page reads nothing."""
    want = -(-BLOCKS_PER_SM[head_dim] * n_sm // (batch * kv_heads))
    per = -(-max_pages // max(1, min(max_pages, want)))
    return -(-max_pages // per), per


def key_splits(rows: int) -> int:
    """Warps of a kernel-B block that share one 16-row tile of the g*S
    rows (each takes every key_splits-th 16-key tile of a page and
    writes its own partial)."""
    tiles = 1 if rows <= 16 else 2 if rows <= 32 else 4
    return WARPS // tiles


def workspace_sizes(batch: int, kv_heads: int, rows: int, chunks: int,
                    head_dim: int) -> Tuple[int, int]:
    """(floats, tickets) that kernel B's workspace needs: one partial
    per (batch row, kv head, chunk, key split, q row), each an fp32
    output row of head_dim floats and a max and a sum, and one counter
    per (batch row, kv head). The layout inside is the kernel's own
    (csrc/paged_decode.cu::paged_decode_bf16), which refuses a smaller
    workspace."""
    parts = batch * kv_heads * chunks * key_splits(rows) * rows
    return parts * (head_dim + 2), batch * kv_heads


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# Per (device, stream): (fp32 partials, int32 tickets), grown, never
# shrunk. The tickets must be 0 at a launch and the kernel leaves them
# 0, so the launches of one stream, which run in order, share one
# workspace; zeroing a fresh one per call would add a device operation
# per layer per decode step to a path the host already limits. A
# workspace that grew is kept alive, not freed: a CUDA graph captured
# with it still launches into its address (the engine captures decode
# steps at S = 1 before its verify at S = K, which needs more).
_WORKSPACES: Dict[Tuple[torch.device, int],
                  Tuple[torch.Tensor, torch.Tensor]] = {}
_OUTGROWN: list = []


def _workspace(device: torch.device, stream: int, floats: int,
               tickets: int) -> Tuple[torch.Tensor, torch.Tensor]:
    have = _WORKSPACES.get((device, stream))
    if have is None or have[0].numel() < floats or \
            have[1].numel() < tickets:
        floats = max(floats, have[0].numel() if have else 0)
        tickets = max(tickets, have[1].numel() if have else 0)
        if have is not None:
            _OUTGROWN.append(have)
        have = (torch.empty(floats, dtype=torch.float32, device=device),
                torch.zeros(tickets, dtype=torch.int32, device=device))
        _WORKSPACES[(device, stream)] = have
    return have


def gather_pages(pool_layer: torch.Tensor, table: torch.Tensor,
                 max_len: int) -> torch.Tensor:
    """One layer's contiguous view: position p of row b reads
    pool_layer[table[b, p // psz], p % psz] → [B, max_len, ...]."""
    v = pool_layer[table.long()]                    # [B, MAXP, psz, ...]
    v = v.reshape(v.shape[0], -1, *pool_layer.shape[2:])
    return v[:, :max_len]


def write_pages(pool_layer: torch.Tensor, new: torch.Tensor,
                pid: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    """Write new [B, S, ...] at (pid, off) [B, S], in place."""
    pool_layer[pid.long(), off.long()] = new
    return pool_layer


# Guards all-zero vectors (fresh pages, padding tokens): the scale stays
# finite and the round trip exactly zero.
QUANT_EPS = 1e-8


def quantize_values(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-vector int8 quantization over the LAST axis (the
    head dim of the dense K/V, the latent width of MLA's): (codes int8,
    scale fp32 of x's shape minus the last axis). JAX's order of
    operations, so that codes and scales come out bit-equal: amax in
    fp32, max(amax, QUANT_EPS) / 127 (a division), round half to even
    of x / scale, clip to +-127. Error per element <= scale / 2."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.clamp(amax, min=QUANT_EPS) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_values(q: torch.Tensor, scale: torch.Tensor,
                      dtype) -> torch.Tensor:
    """Inverse of :func:`quantize_values`: codes [..., d] with scale
    [...] back to ``dtype``, the multiply in fp32 (one rounding)."""
    return (q.float() * scale[..., None]).to(dtype)


def paged_decode_attention_ref(q: torch.Tensor, kp: torch.Tensor,
                               vp: torch.Tensor, table: torch.Tensor,
                               length: torch.Tensor, *,
                               softmax_scale: Optional[float] = None
                               ) -> torch.Tensor:
    """Plain version of kernel B: q [B, S, H, hd] at per-row offsets
    ``length`` over the pages ``table`` names (positions
    [length, length+S) already written) → [B, S, H, hd]."""
    max_len = table.shape[1] * kp.shape[1]
    k_l = gather_pages(kp, table, max_len)
    v_l = gather_pages(vp, table, max_len)
    return xla_attention(q, k_l, v_l, causal=True, q_offset=length,
                         softmax_scale=softmax_scale)


def _check_kernel_inputs(q: torch.Tensor, kp: torch.Tensor,
                         vp: torch.Tensor, table: torch.Tensor,
                         length: torch.Tensor) -> None:
    """Raise on what kernel B does not take."""
    b, s, h, hd = q.shape
    psz, kh = kp.shape[1], kp.shape[2]
    if q.dtype != torch.bfloat16 or kp.dtype != q.dtype or \
            vp.dtype != q.dtype:
        raise TypeError(f'paged kernel takes bf16 q/pools, got {q.dtype}, '
                        f'{kp.dtype}, {vp.dtype}')
    if hd not in HEAD_DIMS or kp.shape[3] != hd or vp.shape != kp.shape:
        raise ValueError(f'paged kernel needs head_dim in {HEAD_DIMS}: q '
                         f'{tuple(q.shape)} pool {tuple(kp.shape)}')
    if h % kh or (h // kh) * s > MAX_ROWS:
        raise ValueError(f'paged kernel serves at most {MAX_ROWS} q rows '
                         f'per kv head (g*S = {(h // kh) * s})')
    if psz % 8 or psz > MAX_PAGE_SIZE:
        raise ValueError(f'page size {psz} must be a multiple of 8, '
                         f'<= {MAX_PAGE_SIZE}')
    if table.shape[0] != b or length.shape != (b,):
        raise ValueError('table [B, max_pages] and length [B] must match q')
    if not (kp.is_cuda and vp.is_cuda and table.is_cuda and length.is_cuda):
        raise ValueError('q, pools, table and length must all lie on the '
                         'card')
    if not (kp.is_contiguous() and vp.is_contiguous()):
        raise ValueError('pools must be contiguous')


def kernel_call(q: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
                table: torch.Tensor, length: torch.Tensor, *,
                softmax_scale: Optional[float] = None):
    """Check kernel B's inputs and make its output: (out, a callable
    that launches the kernel into out). The callable holds every tensor
    whose address it passes."""
    _check_kernel_inputs(q, kp, vp, table, length)
    b, s, h, hd = q.shape
    psz, kh = kp.shape[1], kp.shape[2]
    maxp = table.shape[1]
    chunks, per = split_pages(b, kh, maxp, _sm_count(q.device.index), hd)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    floats, tickets = workspace_sizes(b, kh, (h // kh) * s, chunks, hd)
    work, ticket = _workspace(q.device, stream, floats, tickets)
    scale = softmax_scale if softmax_scale is not None else hd ** -0.5
    # out is contiguous whatever q's strides: the kernel writes
    # [B, S, H, hd] in order.
    held = (q.contiguous(), kp, vp, table.to(torch.int32).contiguous(),
            length.to(torch.int32).contiguous(),
            torch.empty(q.shape, dtype=q.dtype, device=q.device), work,
            ticket)
    args = tuple(t.data_ptr() for t in held) + (
        work.numel(), ticket.numel(), b, s, h, kh, hd, psz, maxp, chunks,
        per, float(scale), stream)

    def launch() -> None:
        KERNEL.launch(*args)

    launch.held = held   # alive as long as the callable is
    return held[5], launch


def paged_decode_attention(q: torch.Tensor, kp: torch.Tensor,
                           vp: torch.Tensor, table: torch.Tensor,
                           length: torch.Tensor, *,
                           softmax_scale: Optional[float] = None
                           ) -> torch.Tensor:
    """Kernel B on CUDA tensors (one launch: q is pre-scaled inside it),
    the plain version on CPU tensors."""
    if not q.is_cuda:
        return paged_decode_attention_ref(q, kp, vp, table, length,
                                          softmax_scale=softmax_scale)
    out, launch = kernel_call(q, kp, vp, table, length,
                              softmax_scale=softmax_scale)
    launch()
    return out


def paged_attention_step_ref(q: torch.Tensor, kp: torch.Tensor,
                             vp: torch.Tensor, table: torch.Tensor,
                             length: torch.Tensor, k_new: torch.Tensor,
                             v_new: torch.Tensor, pid: torch.Tensor,
                             off: torch.Tensor, *, max_len: int,
                             logit_softcap: Optional[float] = None,
                             window: Optional[int] = None,
                             window_active=None,
                             sinks: Optional[torch.Tensor] = None,
                             k_scale: Optional[torch.Tensor] = None,
                             v_scale: Optional[torch.Tensor] = None):
    """The fused overlay-then-attend formulation, on any device: gather
    this layer's view from the pre-write pool, overlay the new K/V at
    positions [length, length+S) of every row, attend with the plain
    reduction (with the softcap, window and sinks), then write the pool
    in place. Returns (out, kp, vp).

    With ``k_scale`` / ``v_scale`` (int8 pools): the new K/V quantize,
    the gathered view dequantizes into q's dtype, the overlay holds the
    DEQUANTIZED new values (what every later gather of these positions
    reads), and codes and scales are written in place. Returns (out,
    kp, vp, k_scale, v_scale), JAX's 5-tuple."""
    b, s = q.shape[0], q.shape[1]
    rows = torch.arange(b, device=q.device)[:, None].expand(b, s)
    positions = length[:, None].long() + torch.arange(s, device=q.device)
    # Positions at or past the view are dropped, as the JAX scatter
    # drops them: they land on one scratch position past the view (from
    # one more trash page a row), which the attention never reads. No
    # two kept writes share a slot, and no shape depends on the data, so
    # the step captures into a CUDA graph.
    positions = torch.clamp(positions, max=max_len)
    table = torch.cat([table, torch.zeros_like(table[:, :1])], 1)
    k_l = gather_pages(kp, table, max_len + 1)
    v_l = gather_pages(vp, table, max_len + 1)
    quant = k_scale is not None
    if quant:
        kq, ks_new = quantize_values(k_new)
        vq, vs_new = quantize_values(v_new)
        k_l = dequantize_values(k_l, gather_pages(k_scale, table,
                                                  max_len + 1), q.dtype)
        v_l = dequantize_values(v_l, gather_pages(v_scale, table,
                                                  max_len + 1), q.dtype)
        k_new = dequantize_values(kq, ks_new, q.dtype)
        v_new = dequantize_values(vq, vs_new, q.dtype)
    k_l[rows, positions] = k_new     # a fresh gather: safe to overlay
    v_l[rows, positions] = v_new
    out = xla_attention(q, k_l[:, :max_len], v_l[:, :max_len], causal=True,
                        q_offset=length, logit_softcap=logit_softcap,
                        window=window, window_active=window_active,
                        sinks=sinks)
    if not quant:
        write_pages(kp, k_new, pid, off)
        write_pages(vp, v_new, pid, off)
        return out, kp, vp
    write_pages(kp, kq, pid, off)
    write_pages(vp, vq, pid, off)
    write_pages(k_scale, ks_new, pid, off)
    write_pages(v_scale, vs_new, pid, off)
    return out, kp, vp, k_scale, v_scale


def _on_card(t: torch.Tensor) -> bool:
    """Whether the step's tensors lie on the card (kernel B's device)."""
    return t.is_cuda


def kernel_takes(q_shape, pool_shape, logit_softcap=None, window=None,
                 sinks=None) -> bool:
    """Kernel B's gate (the JAX ``_pallas_ok``) for q [B, S, H, hd] over
    a pool [n, psz, KH, hd]: plain causal attention only — a windowed
    model's global layers carry a window too (with ``window_active``
    False) and take the fused formulation, as in the JAX package — at
    the shapes the kernel takes: hd in HEAD_DIMS, psz a multiple of 8 up
    to MAX_PAGE_SIZE, g*S <= MAX_ROWS. JAX's shape clause (hd % 128,
    psz % 8) is the TPU's lane alignment; this one names the card
    kernel's own limits. Every other step takes the fused
    formulation."""
    if logit_softcap is not None or window is not None or sinks is not None:
        return False
    _, s, h, hd = q_shape
    psz, kh = pool_shape[1], pool_shape[2]
    return (hd in HEAD_DIMS and pool_shape[3] == hd and psz % 8 == 0 and
            psz <= MAX_PAGE_SIZE and h % kh == 0 and
            (h // kh) * s <= MAX_ROWS)


def paged_attention_step(q: torch.Tensor, kp: torch.Tensor,
                         vp: torch.Tensor, table: torch.Tensor,
                         length: torch.Tensor, k_new: torch.Tensor,
                         v_new: torch.Tensor, pid: torch.Tensor,
                         off: torch.Tensor, *, max_len: int,
                         logit_softcap: Optional[float] = None,
                         window: Optional[int] = None, window_active=None,
                         sinks: Optional[torch.Tensor] = None,
                         k_scale: Optional[torch.Tensor] = None,
                         v_scale: Optional[torch.Tensor] = None):
    """One layer of in-place paged decode/verify attention: q
    [B, S, H, hd] at offsets ``length`` [B], pools kp/vp
    [n_pages, psz, KH, hd], the step's new K/V [B, S, KH, hd] written at
    (pid, off). Returns (out [B, S, H, hd], kp, vp), the pools updated
    in place. CUDA with none of ``logit_softcap``, ``window`` (whatever
    ``window_active`` says) and ``sinks``, bf16 q and pools, at a shape
    kernel B takes: write the pool, then kernel B. Otherwise, and on the
    CPU: the fused formulation.

    ``k_scale`` / ``v_scale`` [n_pages, psz, KH] select the int8 pools:
    kernel B declines them, as JAX's kernel declines them (its gate is
    ``impl == 'pallas' and k_scale is None``; the kernel reads bf16
    pages and has no dequantizing load), so such a step takes the fused
    formulation on every device, the card included, and returns its
    5-tuple (out, kp, vp, k_scale, v_scale)."""
    if k_scale is not None or not _on_card(q) or \
            q.dtype != torch.bfloat16 or kp.dtype != torch.bfloat16 or \
            not kernel_takes(q.shape, kp.shape, logit_softcap, window, sinks):
        return paged_attention_step_ref(
            q, kp, vp, table, length, k_new, v_new, pid, off,
            max_len=max_len, logit_softcap=logit_softcap, window=window,
            window_active=window_active, sinks=sinks, k_scale=k_scale,
            v_scale=v_scale)
    write_pages(kp, k_new, pid, off)
    write_pages(vp, v_new, pid, off)
    out, launch = kernel_call(q, kp, vp, table, length)
    launch()
    return out, kp, vp
