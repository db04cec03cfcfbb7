"""Attention dispatch: the plain GQA reference and the flash kernel
(port of skypilot_tpu/ops/attention.py).

Layouts: q [B, S, H, D]; k, v [B, T, KH, D] with H = KH * G. Scores
accumulate in fp32; the output comes back in q.dtype.

``impl='auto'`` sends a CUDA tensor through the flash autograd function
(ops/flash_attention.py: kernel A forward, kernels C and D backward),
which serves prefill at every prompt bucket and training at every
length, and raises on what it does not take (dtypes other than bf16,
head dims other than 64 and 128); a CPU tensor takes the plain version.
``impl='xla'`` asks for the plain version on any device, differentiable
by autograd.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -2.0 ** 30  # large-but-finite: keeps softmax fp32-safe


def _attention_impl(q, k, v, causal, q_offset, softmax_scale, return_lse):
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    groups = h // kh
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    # Pre-scale and cast back to q.dtype BEFORE the product (the JAX
    # reference rounds here too).
    qf = (q * scale).to(q.dtype)
    qg = qf.reshape(b, s, kh, groups, d).float()
    scores = torch.einsum('bskgd,btkd->bkgst', qg, k.float())
    if causal:
        dev = q.device
        kv_pos = torch.arange(t, device=dev)
        q_off = torch.as_tensor(q_offset, device=dev)
        if q_off.ndim == 1:
            q_pos = torch.arange(s, device=dev)[None, :] + q_off[:, None]
            mask = (q_pos[:, :, None] >= kv_pos[None, None, :])
            mask = mask[:, None, None]                     # [B,1,1,S,T]
        else:
            q_pos = torch.arange(s, device=dev) + q_off
            mask = (q_pos[:, None] >= kv_pos[None, :])[None, None, None]
        scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    if return_lse:
        lse = torch.logsumexp(scores, dim=-1)              # [B,KH,G,S]
        probs = torch.exp(scores - lse[..., None]).to(q.dtype)
    else:
        lse = None
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum('bkgst,btkd->bskgd', probs.float(), v.float())
    out = out.reshape(b, s, h, d).to(q.dtype)
    if return_lse:
        return out, lse.permute(0, 3, 1, 2).reshape(b, s, h)
    return out


def xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, q_offset=0,
                  softmax_scale: Optional[float] = None) -> torch.Tensor:
    """Plain attention. q [B,S,H,D], k/v [B,T,KH,D] → [B,S,H,D].
    ``q_offset`` is an int or a per-row [B] tensor (ragged decode)."""
    return _attention_impl(q, k, v, causal, q_offset, softmax_scale,
                           return_lse=False)


def xla_attention_lse(q, k, v, *, causal: bool = True, softmax_scale=None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain attention that also returns lse [B,S,H] (fp32)."""
    return _attention_impl(q, k, v, causal, 0, softmax_scale,
                           return_lse=True)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              impl: str = 'auto', causal: bool = True,
              softmax_scale: Optional[float] = None) -> torch.Tensor:
    """Self-attention over a whole prompt (positions from 0), by
    ``impl``: 'auto', 'flash' or 'xla'."""
    if impl == 'auto':
        impl = 'flash' if q.is_cuda else 'xla'
    if impl == 'xla':
        return xla_attention(q, k, v, causal=causal,
                             softmax_scale=softmax_scale)
    if impl == 'flash':
        from skypilot_tpu_torch.ops import flash_attention
        out, _ = flash_attention.flash_attention_lse(
            q, k, v, causal=causal, softmax_scale=softmax_scale)
        return out
    raise ValueError(f'Unknown attention impl {impl!r}')
