"""Attention dispatch: the plain GQA reference and the flash kernel
(port of skypilot_tpu/ops/attention.py).

Layouts: q [B, S, H, D]; k, v [B, T, KH, D] with H = KH * G. Scores
accumulate in fp32; the output comes back in q.dtype.

The plain version takes every switch of the JAX reference: per-row or
scalar position offsets, segment ids, the Gemma-2 logit softcap, the
sliding window (gated per layer by ``window_active``) and gpt-oss
attention sinks. The flash kernel takes none of them, as the JAX Pallas
kernel takes none: :func:`attention` sends a call with any of them to
the plain version on every device, decided from its arguments before
anything is launched (the JAX ``attention`` gate).

``impl='auto'`` sends any other CUDA call through the flash autograd
function (ops/flash_attention.py: kernel A forward, kernels C and D
backward), which serves prefill at every prompt bucket and training at
every length, and raises on what it does not take (dtypes other than
bf16, head dims other than 64, 128 and 256, a backward at 256); a CPU
tensor takes the plain version. ``impl='xla'`` asks for the plain
version on any device, differentiable by autograd.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -2.0 ** 30  # large-but-finite: keeps softmax fp32-safe


def _attention_impl(q, k, v, causal, q_offset, softmax_scale, return_lse,
                    kv_offset=0, segment_ids=None, logit_softcap=None,
                    window=None, window_active=None, sinks=None):
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    groups = h // kh
    dev = q.device
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    # Pre-scale and cast back to q.dtype BEFORE the product (the JAX
    # reference rounds here too).
    qf = (q * scale).to(q.dtype)
    qg = qf.reshape(b, s, kh, groups, d).float()
    scores = torch.einsum('bskgd,btkd->bkgst', qg, k.float())
    if logit_softcap:
        # Gemma-2: cap * tanh(s / cap) BEFORE the mask, so the mask's
        # NEG_INF stays -inf-like.
        scores = logit_softcap * torch.tanh(scores / logit_softcap)
    mask = None
    if causal:
        # Offsets join as they come (ints or tensors): no host-to-device
        # copy, so a decode step captures into a CUDA graph.
        kv_pos = torch.arange(t, device=dev) + kv_offset
        if torch.is_tensor(q_offset) and q_offset.ndim == 1:
            q_pos = torch.arange(s, device=dev)[None, :] + q_offset[:, None]
            rel = q_pos[:, :, None] - kv_pos[None, None, :]   # [B,S,T]
        else:
            q_pos = torch.arange(s, device=dev) + q_offset
            rel = (q_pos[:, None] - kv_pos[None, :])[None]     # [1,S,T]
        mask = rel >= 0
        # A global layer of a windowed model (window_active False) keeps
        # the plain causal mask.
        if window is not None and (window_active is None or
                                   bool(window_active)):
            mask = mask & (rel < window)
        mask = mask[:, None, None]                             # [B,1,1,S,T]
    if segment_ids is not None:
        q_seg, kv_seg = segment_ids
        seg = (q_seg[:, :, None] == kv_seg[:, None, :])[:, None, None]
        mask = seg if mask is None else mask & seg
    if mask is not None:
        scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    if sinks is not None:
        # gpt-oss sinks: a learned per-head logit joins the softmax as a
        # phantom key that is never masked and carries no value. Heads
        # are h = kh * G + g, so [H] reshapes to [KH, G].
        if return_lse:
            raise ValueError('sinks are not supported on the lse path')
        col = sinks.float().reshape(1, kh, groups, 1, 1).expand(
            b, kh, groups, s, 1)
        scores = torch.cat([scores, col], dim=-1)
    if return_lse:
        lse = torch.logsumexp(scores, dim=-1)              # [B,KH,G,S]
        probs = torch.exp(scores - lse[..., None]).to(q.dtype)
    else:
        lse = None
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
    if sinks is not None:
        probs = probs[..., :t]   # drop the phantom column
    out = torch.einsum('bkgst,btkd->bskgd', probs.float(), v.float())
    out = out.reshape(b, s, h, d).to(q.dtype)
    if return_lse:
        return out, lse.permute(0, 3, 1, 2).reshape(b, s, h)
    return out


def xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, q_offset=0, kv_offset=0,
                  segment_ids: Optional[Tuple[torch.Tensor,
                                              torch.Tensor]] = None,
                  softmax_scale: Optional[float] = None,
                  logit_softcap: Optional[float] = None,
                  window: Optional[int] = None, window_active=None,
                  sinks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain attention. q [B,S,H,D], k/v [B,T,KH,D] → [B,S,H,D].
    ``q_offset``/``kv_offset`` are the positions of q[:, 0] / k[:, 0]
    (an int, or a per-row [B] tensor for ragged decode);
    ``segment_ids`` a (q [B,S], kv [B,T]) pair; ``logit_softcap``
    bounds the scores; ``window`` masks keys ``window`` or more
    positions back, where ``window_active`` (None or a bool) is not
    False; ``sinks`` [H] adds a per-head phantom-key logit."""
    return _attention_impl(q, k, v, causal, q_offset, softmax_scale,
                           return_lse=False, kv_offset=kv_offset,
                           segment_ids=segment_ids,
                           logit_softcap=logit_softcap, window=window,
                           window_active=window_active, sinks=sinks)


def xla_attention_lse(q, k, v, *, causal: bool = True, softmax_scale=None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain attention that also returns lse [B,S,H] (fp32)."""
    return _attention_impl(q, k, v, causal, 0, softmax_scale,
                           return_lse=True)


def is_trivial(q_offset=0, kv_offset=0, segment_ids=None,
               logit_softcap=None, window=None, sinks=None) -> bool:
    """True when the flash kernel can take the call: no position
    offsets, segment ids, softcap, window or sinks (the JAX gate)."""
    return (isinstance(q_offset, int) and q_offset == 0 and
            isinstance(kv_offset, int) and kv_offset == 0 and
            segment_ids is None and logit_softcap is None and
            window is None and sinks is None)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              impl: str = 'auto', causal: bool = True, q_offset=0,
              kv_offset=0, segment_ids=None,
              softmax_scale: Optional[float] = None,
              logit_softcap: Optional[float] = None,
              window: Optional[int] = None, window_active=None,
              sinks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Self-attention by ``impl``: 'auto', 'flash' or 'xla'. A call that
    is not trivial (:func:`is_trivial`) takes the plain version whatever
    ``impl`` asks for, as in the JAX package."""
    trivial = is_trivial(q_offset, kv_offset, segment_ids, logit_softcap,
                         window, sinks)
    if impl == 'auto':
        impl = 'flash' if (q.is_cuda and trivial) else 'xla'
    elif impl == 'flash' and not trivial:
        impl = 'xla'
    if impl == 'xla':
        return xla_attention(q, k, v, causal=causal, q_offset=q_offset,
                             kv_offset=kv_offset, segment_ids=segment_ids,
                             softmax_scale=softmax_scale,
                             logit_softcap=logit_softcap, window=window,
                             window_active=window_active, sinks=sinks)
    if impl == 'flash':
        from skypilot_tpu_torch.ops import flash_attention
        out, _ = flash_attention.flash_attention_lse(
            q, k, v, causal=causal, softmax_scale=softmax_scale)
        return out
    raise ValueError(f'Unknown attention impl {impl!r}')
