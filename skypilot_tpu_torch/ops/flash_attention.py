"""Flash-attention forward: kernel A and its plain version.

Port of skypilot_tpu/ops/pallas/flash_attention.py's forward
(``_fwd_kernel``, ``_fwd``, ``flash_attention_lse``). The kernel is
hand-written CUDA C++ for sm_90a in csrc/flash_fwd.cu; this module
keeps the public layout (q [B,S,H,D], k/v [B,T,KH,D] in; o [B,S,H,D]
and lse [B,S,H] fp32 out), pre-scales q as the JAX wrapper does, and
holds the plain PyTorch version the CPU path and the tests use.

Wrapper rule: a CPU tensor takes the plain version; a CUDA tensor
launches the kernel or raises. There is no fallback.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from skypilot_tpu_torch.kernels import build
from skypilot_tpu_torch.ops.attention import xla_attention_lse

KERNEL = build.Kernel(
    name='flash_fwd', source='flash_fwd.cu', symbol='flash_fwd_bf16',
    argtypes=('p', 'p', 'p', 'p', 'p', 'i', 'i', 'i', 'i', 'i', 'i', 'i',
              'p'))

SUPPORTED_HEAD_DIMS = (64, 128)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        softmax_scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: (o [B,S,H,D] in q.dtype, lse [B,S,H] fp32), with
    fp32 scores and the same q pre-scale rounding as the kernel."""
    return xla_attention_lse(q, k, v, causal=causal,
                             softmax_scale=softmax_scale)


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        softmax_scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """o [B,S,H,D] and lse [B,S,H] (fp32). Any S and T: the kernel
    masks the ragged tile edge, so every prompt bucket runs on it."""
    if not q.is_cuda:
        return flash_attention_ref(q, k, v, causal=causal,
                                   softmax_scale=softmax_scale)
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f'flash kernel takes bf16 q/k/v, got {q.dtype}, '
                        f'{k.dtype}, {v.dtype}')
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f'flash kernel head_dim {d} not in '
                         f'{SUPPORTED_HEAD_DIMS}')
    if k.shape != (b, t, kh, d) or v.shape != k.shape or h % kh:
        raise ValueError(f'bad shapes q {tuple(q.shape)} k {tuple(k.shape)} '
                         f'v {tuple(v.shape)}')
    if not (k.is_cuda and v.is_cuda):
        raise ValueError('q, k and v must all lie on the card')
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    qs = (q * scale).to(q.dtype).contiguous()
    k = k.contiguous()
    v = v.contiguous()
    o = torch.empty_like(qs)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    KERNEL.launch(qs.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                  lse.data_ptr(), b, s, t, h, kh, d, int(causal),
                  torch.cuda.current_stream(q.device).cuda_stream)
    return o, lse.transpose(1, 2)
