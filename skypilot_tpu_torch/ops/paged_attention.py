"""In-place paged attention: kernel B, its plain version, and the step
entry point (port of skypilot_tpu/ops/paged_attention.py and
skypilot_tpu/ops/pallas/paged_attention.py).

Pools are ``[n_pages, page_size, KH, hd]`` per layer, tables
``[B, max_pages]`` int32, page 0 is the trash page.

:func:`paged_attention_step` has two formulations, chosen by where the
tensors lie:

  - CUDA: write the step's new K/V into the pool first, then launch the
    hand-written kernel (csrc/paged_decode.cu) that streams pages
    through the table — the JAX ``impl='pallas'`` branch.
  - CPU: the fused overlay-then-attend formulation — gather this
    layer's view from the pre-write pool, overlay the new K/V at each
    row's positions, run the plain attention, then write the pool —
    the JAX ``impl='fused'`` branch.

Both update the pool IN PLACE (the JAX version returns new pools);
the returned pools are the same tensors that were passed in.
"""
from __future__ import annotations

from typing import Optional

import torch

from skypilot_tpu_torch.kernels import build
from skypilot_tpu_torch.ops.attention import xla_attention

KERNEL = build.Kernel(
    name='paged_decode', source='paged_decode.cu', symbol='paged_decode_bf16',
    argtypes=('p', 'p', 'p', 'p', 'p', 'p', 'i', 'i', 'i', 'i', 'i', 'i',
              'i', 'p'))

HEAD_DIM = 128      # the kernel's head_dim
MAX_ROWS = 16       # the kernel's g * S limit per block
MAX_PAGE_SIZE = 128  # two K and two V pages must fit in shared memory


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


def paged_decode_attention(q: torch.Tensor, kp: torch.Tensor,
                           vp: torch.Tensor, table: torch.Tensor,
                           length: torch.Tensor, *,
                           softmax_scale: Optional[float] = None
                           ) -> torch.Tensor:
    """Kernel B on CUDA tensors, the plain version on CPU tensors."""
    if not q.is_cuda:
        return paged_decode_attention_ref(q, kp, vp, table, length,
                                          softmax_scale=softmax_scale)
    b, s, h, hd = q.shape
    psz, kh = kp.shape[1], kp.shape[2]
    maxp = table.shape[1]
    if q.dtype != torch.bfloat16 or kp.dtype != q.dtype or \
            vp.dtype != q.dtype:
        raise TypeError(f'paged kernel takes bf16 q/pools, got {q.dtype}, '
                        f'{kp.dtype}, {vp.dtype}')
    if hd != HEAD_DIM or kp.shape[3] != hd or vp.shape != kp.shape:
        raise ValueError(f'paged kernel needs head_dim {HEAD_DIM}: q '
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
    scale = softmax_scale if softmax_scale is not None else hd ** -0.5
    qs = (q * scale).to(q.dtype).contiguous()
    table = table.to(torch.int32).contiguous()
    length = length.to(torch.int32).contiguous()
    out = torch.empty_like(qs)
    KERNEL.launch(qs.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                  table.data_ptr(), length.data_ptr(), out.data_ptr(),
                  b, s, h, kh, hd, psz, maxp,
                  torch.cuda.current_stream(q.device).cuda_stream)
    return out


def paged_attention_step_ref(q: torch.Tensor, kp: torch.Tensor,
                             vp: torch.Tensor, table: torch.Tensor,
                             length: torch.Tensor, k_new: torch.Tensor,
                             v_new: torch.Tensor, pid: torch.Tensor,
                             off: torch.Tensor, *, max_len: int):
    """The fused overlay-then-attend formulation, on any device: gather
    this layer's view from the pre-write pool, overlay the new K/V at
    positions [length, length+S) of every row, attend with the plain
    reduction, then write the pool in place."""
    b, s = q.shape[0], q.shape[1]
    rows = torch.arange(b, device=q.device)[:, None].expand(b, s)
    positions = length[:, None].long() + torch.arange(s, device=q.device)
    # Positions at or past the view are dropped, as the JAX scatter
    # drops them: no two kept writes share a slot.
    keep = positions < max_len
    rows, positions = rows[keep], positions[keep]
    k_l = gather_pages(kp, table, max_len)     # a fresh gather: safe to
    v_l = gather_pages(vp, table, max_len)     # overlay in place
    k_l[rows, positions] = k_new[keep]
    v_l[rows, positions] = v_new[keep]
    out = xla_attention(q, k_l, v_l, causal=True, q_offset=length)
    write_pages(kp, k_new, pid, off)
    write_pages(vp, v_new, pid, off)
    return out, kp, vp


def paged_attention_step(q: torch.Tensor, kp: torch.Tensor,
                         vp: torch.Tensor, table: torch.Tensor,
                         length: torch.Tensor, k_new: torch.Tensor,
                         v_new: torch.Tensor, pid: torch.Tensor,
                         off: torch.Tensor, *, max_len: int):
    """One layer of in-place paged decode/verify attention: q
    [B, S, H, hd] at offsets ``length`` [B], pools kp/vp
    [n_pages, psz, KH, hd], the step's new K/V [B, S, KH, hd] written at
    (pid, off). Returns (out [B, S, H, hd], kp, vp), the pools updated
    in place. CUDA: write the pool, then kernel B. CPU: the fused
    formulation."""
    if not q.is_cuda:
        return paged_attention_step_ref(q, kp, vp, table, length, k_new,
                                        v_new, pid, off, max_len=max_len)
    write_pages(kp, k_new, pid, off)
    write_pages(vp, v_new, pid, off)
    return paged_decode_attention(q, kp, vp, table, length), kp, vp
