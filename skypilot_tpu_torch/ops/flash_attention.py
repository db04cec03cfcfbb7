"""Flash attention, forward and backward: kernels A, C and D and their
plain versions.

Port of skypilot_tpu/ops/pallas/flash_attention.py: the forward
(``_fwd_kernel``, ``_fwd``), the backward (``_dq_kernel``,
``_dkv_kernel``, ``_bwd``), the ``jax.custom_vjp`` ``_flash`` (here the
``torch.autograd.Function`` :class:`_Flash`) and the public
``flash_attention_lse`` / ``flash_attention``. The kernels are
hand-written CUDA C++ for sm_90a: csrc/flash_fwd.cu (A) and
csrc/flash_bwd.cu (C: dq, D: dk and dv). This module keeps the public
layout (q [B,S,H,D], k/v [B,T,KH,D] in; o [B,S,H,D] and lse [B,S,H]
fp32 out), pre-scales q outside the autograd function as the JAX
wrapper does (so dq picks up the scale through the chain rule), and
holds the plain PyTorch versions the CPU path and the tests use.

The kernels take the raw lse as [B,H,S] fp32; ``delta = rowsum(o * do)
- dlse`` (the lse cotangent folded in, as in ``_flash_bwd_rule``) is a
plain PyTorch op beside them, as the JAX package computes it outside
Pallas. One difference from the JAX ``_bwd``: it writes per-q-head
dk/dv in bf16 and sums the H/KH heads of a group in bf16; kernel D sums
them in fp32 and rounds once (the tests hold the two within bf16
tolerance). ``_bwd(grad_dtype=torch.float32)`` is the JAX ``_bwd``'s
``grad_dtype``: kernels C and D write fp32 dq/dk/dv (their ``_f32``
entry points), which ring attention sums across its steps.

Wrapper rule: a CPU tensor takes the plain version; a CUDA tensor
launches the kernel or raises. There is no fallback.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from skypilot_tpu_torch.kernels import build
from skypilot_tpu_torch.ops.attention import NEG_INF, xla_attention_lse

KERNEL = build.Kernel(
    name='flash_fwd', source='flash_fwd.cu', symbol='flash_fwd_bf16',
    argtypes=('p', 'p', 'p', 'p', 'p', 'i', 'i', 'i', 'i', 'i', 'i', 'i',
              'p'))
DQ_KERNEL = build.Kernel(
    name='flash_dq', source='flash_bwd.cu', symbol='flash_dq_bf16',
    argtypes=('p',) * 7 + ('i',) * 7 + ('p',))
DKV_KERNEL = build.Kernel(
    name='flash_dkv', source='flash_bwd.cu', symbol='flash_dkv_bf16',
    argtypes=('p',) * 8 + ('i',) * 7 + ('p',))
# The same kernels writing fp32 grads (``_bwd(grad_dtype=torch.float32)``).
DQ_F32_KERNEL = build.Kernel(
    name='flash_dq_f32', source='flash_bwd.cu', symbol='flash_dq_f32',
    argtypes=('p',) * 7 + ('i',) * 7 + ('p',))
DKV_F32_KERNEL = build.Kernel(
    name='flash_dkv_f32', source='flash_bwd.cu', symbol='flash_dkv_f32',
    argtypes=('p',) * 8 + ('i',) * 7 + ('p',))

# Head dims kernel A takes, and those kernels C and D take (Gemma's 256
# among them: the JAX backward takes any multiple of 128).
FWD_HEAD_DIMS = (64, 128, 256)
BWD_HEAD_DIMS = (64, 128, 256)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        softmax_scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain forward: (o [B,S,H,D] in q.dtype, lse [B,S,H] fp32), with
    fp32 scores and the same q pre-scale rounding as the kernel."""
    return xla_attention_lse(q, k, v, causal=causal,
                             softmax_scale=softmax_scale)


def _delta(o: torch.Tensor, do: torch.Tensor,
           dlse: Optional[torch.Tensor]) -> torch.Tensor:
    """rowsum(o * do) - dlse: [B,H,S] fp32, contiguous."""
    delta = (o.float() * do.float()).sum(-1).transpose(1, 2)
    if dlse is not None:
        delta = delta - dlse.float()
    return delta.contiguous()


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            lse: torch.Tensor, do: torch.Tensor,
                            dlse: Optional[torch.Tensor] = None, *,
                            causal: bool = True,
                            grad_dtype: Optional[torch.dtype] = None
                            ) -> Tuple[torch.Tensor, ...]:
    """Plain backward of kernels C and D, step by step: q (pre-scaled),
    o, do [B,S,H,D]; k, v [B,T,KH,D]; lse and dlse [B,H,S] fp32 →
    (dq, dk, dv) in ``grad_dtype`` (default q.dtype). fp32 throughout,
    except that p and ds round to q.dtype before their products, as the
    kernels (and the TPU kernels) do, in either output type; the group
    sum over the H/KH q heads is fp32."""
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    g = h // kh
    dt = q.dtype
    out_dt = grad_dtype or dt
    qh = q.float().transpose(1, 2)                              # [B,H,S,D]
    kh_ = k.float().transpose(1, 2).repeat_interleave(g, dim=1)  # [B,H,T,D]
    vh = v.float().transpose(1, 2).repeat_interleave(g, dim=1)
    doh = do.float().transpose(1, 2)
    delta = _delta(o, do, dlse)                                 # [B,H,S]
    scores = qh @ kh_.transpose(-1, -2)                         # [B,H,S,T]
    if causal:
        keep = (torch.arange(t, device=q.device)[None, :] <=
                torch.arange(s, device=q.device)[:, None])
        scores = torch.where(keep, scores, torch.full_like(scores, NEG_INF))
    p = torch.exp(scores - lse.float()[..., None])
    dp = doh @ vh.transpose(-1, -2)
    ds = p * (dp - delta[..., None])
    p_r, ds_r = p.to(dt).float(), ds.to(dt).float()
    dq = ds_r @ kh_
    dk = (ds_r.transpose(-1, -2) @ qh).reshape(b, kh, g, t, d).sum(2)
    dv = (p_r.transpose(-1, -2) @ doh).reshape(b, kh, g, t, d).sum(2)
    return (dq.transpose(1, 2).to(out_dt), dk.transpose(1, 2).to(out_dt),
            dv.transpose(1, 2).to(out_dt))


def backward_refused(head_dim: int, on_card: bool, wants_grad: bool
                     ) -> bool:
    """True when a flash call must be refused before anything launches:
    on the card, with a gradient wanted, at a head dim kernels C and D
    do not take. Raising after the forward would leave a graph whose
    backward cannot run."""
    return on_card and wants_grad and head_dim not in BWD_HEAD_DIMS


def _check_kernel_inputs(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor,
                         head_dims: Tuple[int, ...] = FWD_HEAD_DIMS) -> None:
    """Raise on what the kernels do not take."""
    b, _, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f'flash kernel takes bf16 q/k/v, got {q.dtype}, '
                        f'{k.dtype}, {v.dtype}')
    if d not in head_dims:
        raise ValueError(f'flash kernel head_dim {d} not in {head_dims}')
    if k.shape != (b, t, kh, d) or v.shape != k.shape or h % kh:
        raise ValueError(f'bad shapes q {tuple(q.shape)} k {tuple(k.shape)} '
                         f'v {tuple(v.shape)}')
    if not (k.is_cuda and v.is_cuda):
        raise ValueError('q, k and v must all lie on the card')


def flash_takes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                wants_grad: bool) -> bool:
    """Kernel A's gate (the JAX ``_flash_ok``), decided from the
    arguments before anything launches: bf16 q/k/v on the card at a
    head dim in FWD_HEAD_DIMS and the shapes ``_check_kernel_inputs``
    accepts, and, where a gradient is wanted, a head dim kernels C and
    D take (:func:`backward_refused`). ``attention(impl='auto')`` sends
    every other call to the plain version; the wrappers called directly
    still raise on it."""
    if not q.is_cuda:
        return False
    try:
        _check_kernel_inputs(q, k, v)
    except (TypeError, ValueError):
        return False
    return not backward_refused(q.shape[-1], True, wants_grad)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """q pre-scaled → (o [B,S,H,D], lse [B,H,S] fp32): kernel A on the
    card, the plain version on the CPU."""
    if not q.is_cuda:
        o, lse = xla_attention_lse(q, k, v, causal=causal, softmax_scale=1.0)
        return o, lse.transpose(1, 2).contiguous()
    _check_kernel_inputs(q, k, v)
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    o = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                  lse.data_ptr(), b, s, t, h, kh, d, int(causal), _stream(q))
    return o, lse


def _bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
         lse: torch.Tensor, do: torch.Tensor, dlse: Optional[torch.Tensor],
         causal: bool, grad_dtype: Optional[torch.dtype] = None
         ) -> Tuple[torch.Tensor, ...]:
    """(dq, dk, dv) of the pre-scaled q, k and v, in ``grad_dtype``
    (None: q's bf16; ``torch.float32``: the kernels' fp32 mode): kernels
    C and D on the card, the plain version on the CPU."""
    if not q.is_cuda:
        return flash_attention_bwd_ref(q, k, v, o, lse, do, dlse,
                                       causal=causal, grad_dtype=grad_dtype)
    if grad_dtype not in (None, q.dtype, torch.float32):
        raise TypeError(f'kernels C and D write bf16 or fp32 grads, not '
                        f'{grad_dtype}')
    f32 = grad_dtype is torch.float32
    _check_kernel_inputs(q, k, v, BWD_HEAD_DIMS)
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    do = do.to(q.dtype).contiguous()
    delta = _delta(o, do, dlse)
    lse = lse.contiguous()
    out_dt = torch.float32 if f32 else q.dtype
    dq = torch.empty_like(q, dtype=out_dt)
    dk = torch.empty_like(k, dtype=out_dt)
    dv = torch.empty_like(v, dtype=out_dt)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr())
    dims = (b, s, t, h, kh, d, int(causal), _stream(q))
    (DQ_F32_KERNEL if f32 else DQ_KERNEL).launch(*ptrs, dq.data_ptr(), *dims)
    (DKV_F32_KERNEL if f32 else DKV_KERNEL).launch(
        *ptrs, dk.data_ptr(), dv.data_ptr(), *dims)
    return dq, dk, dv


class _Flash(torch.autograd.Function):
    """The custom VJP of ``_flash``: forward saves q (pre-scaled), k, v,
    o and the raw [B,H,S] lse; backward folds the lse cotangent into
    delta and runs the dq and dkv kernels (their plain versions on the
    CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = _fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(o)
        dq, dk, dv = _bwd(q, k, v, o, lse, do, dlse, ctx.causal)
        return dq, dk, dv, None


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        softmax_scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """o [B,S,H,D] and lse [B,S,H] (fp32), differentiable in q, k, v
    through both outputs. Any S and T: the kernels mask the ragged tile
    edge, so every prompt bucket and every training length runs on
    them. On the card a call that wants a gradient at a head dim the
    backward kernels do not take raises NotImplementedError first."""
    wants_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    if backward_refused(q.shape[-1], q.is_cuda, wants_grad):
        raise NotImplementedError(
            f'flash backward at head_dim {q.shape[-1]} is not ported: '
            f'kernels C and D take {BWD_HEAD_DIMS} (ROADMAP Queue 2)')
    scale = softmax_scale if softmax_scale is not None else q.shape[-1] ** -0.5
    # The pre-scale stays outside _Flash: dq gets `scale` by the chain rule.
    qs = (q * scale).to(q.dtype)
    o, lse = _Flash.apply(qs, k, v, causal)
    return o, lse.transpose(1, 2)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    softmax_scale: Optional[float] = None) -> torch.Tensor:
    """q [B,S,H,D], k/v [B,T,KH,D] → [B,S,H,D]; differentiable."""
    out, _ = flash_attention_lse(q, k, v, causal=causal,
                                 softmax_scale=softmax_scale)
    return out
