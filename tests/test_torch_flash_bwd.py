"""The port's flash backward vs the JAX package's, on the CPU.

``flash_attention_bwd_ref`` (the plain version of kernels C and D) is
held against the JAX ``_bwd`` run in interpret mode (block 128), as
tests/unit_tests/test_flash_attention.py runs the Pallas kernels, on
numpy-seeded fp32 inputs; and the port's differentiable
``flash_attention_lse`` (the ``_Flash`` autograd function, plain forward
and backward on the CPU) against ``jax.grad`` of the JAX one with an lse
cotangent. Tolerance: max|err| <= 1e-4 * max|ref| per grad. Both sides
compute in fp32 (p and ds round to the input dtype, a no-op here) and
differ only in summation order.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.ops.pallas import flash_attention as jflash
from skypilot_tpu_torch import config
from skypilot_tpu_torch.kernels import build
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.ops import attention
from skypilot_tpu_torch.ops import flash_attention as fa

RTOL = 1e-4


def _close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= RTOL * np.abs(want).max()


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize('groups', [1, 2, 4])
@pytest.mark.parametrize('causal', [True, False])
def test_plain_backward_matches_jax_bwd(groups, causal):
    """The [B,H,S,D] JAX kernels' layout in, the port's [B,S,H,D] out;
    the lse cotangent zero and nonzero."""
    rng = np.random.default_rng(groups + 10 * causal)
    b, kh, s, d = 1, 1, 256, 128
    h = kh * groups
    q = rng.standard_normal((b, h, s, d)).astype(np.float32) * d ** -0.5
    k, v = (rng.standard_normal((b, kh, s, d)).astype(np.float32)
            for _ in range(2))
    do = rng.standard_normal((b, h, s, d)).astype(np.float32)
    o, lse = jflash._fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal, 128, 128, True)
    o, lse = np.asarray(o), np.asarray(lse)[..., 0]          # [B,H,S]
    for dlse in (None, rng.standard_normal((b, h, s)).astype(np.float32)):
        want = jflash._bwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           jnp.asarray(o),
                           jnp.broadcast_to(jnp.asarray(lse)[..., None],
                                            (b, h, s, jflash.LANES)),
                           jnp.asarray(do), causal, 128, 128, True,
                           dlse=None if dlse is None else jnp.asarray(dlse))
        got = fa.flash_attention_bwd_ref(
            _t(q.swapaxes(1, 2)), _t(k.swapaxes(1, 2)), _t(v.swapaxes(1, 2)),
            _t(o.swapaxes(1, 2)), _t(lse), _t(do.swapaxes(1, 2)),
            None if dlse is None else _t(dlse), causal=causal)
        for g, w in zip(got, want):
            _close(g.numpy().swapaxes(1, 2), w)


@pytest.mark.parametrize('causal', [True, False])
def test_flash_autograd_matches_jax_grad(causal):
    """d/d(q, k, v) of sum(o * co) + sum(lse * cl) through the port's
    flash_attention_lse (CPU: plain forward and backward) and through
    the JAX one (interpret): the lse cotangent folds into delta on both
    sides, and dq picks up the softmax scale through the pre-scale."""
    rng = np.random.default_rng(7 + causal)
    b, s, kh, g, d = 1, 128, 1, 2, 128
    q = rng.standard_normal((b, s, kh * g, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, s, kh, d)).astype(np.float32)
            for _ in range(2))
    co = rng.standard_normal((b, s, kh * g, d)).astype(np.float32)
    cl = rng.standard_normal((b, s, kh * g)).astype(np.float32)

    def jloss(q, k, v):
        o, lse = jflash.flash_attention_lse(q, k, v, causal=causal,
                                            interpret=True, block_q=128,
                                            block_k=128)
        return (o * co).sum() + (lse * cl).sum()

    want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                              jnp.asarray(v))
    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    build.reset_launches()
    o, lse = fa.flash_attention_lse(tq, tk, tv, causal=causal)
    ((o * _t(co)).sum() + (lse * _t(cl)).sum()).backward()
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        _close(got.numpy(), w)
    assert all(kern.launches == 0 for kern in build.kernels().values())


def test_flash_autograd_equals_plain_attention_autograd():
    """On the CPU the autograd function's hand-written backward gives
    what autograd of the plain attention gives (GQA, ragged S)."""
    rng = np.random.default_rng(3)
    b, s, h, kh, d = 2, 37, 4, 2, 16
    q, k, v = (_t(rng.standard_normal(shape).astype(np.float32))
               for shape in ((b, s, h, d), (b, s, kh, d), (b, s, kh, d)))
    co, cl = (_t(rng.standard_normal(shape).astype(np.float32))
              for shape in ((b, s, h, d), (b, s, h)))
    grads = []
    for fn in (attention.xla_attention_lse, fa.flash_attention_lse):
        args = [x.clone().requires_grad_() for x in (q, k, v)]
        o, lse = fn(*args, causal=True)
        ((o * co).sum() + (lse * cl).sum()).backward()
        grads.append([x.grad for x in args])
    for a, w in zip(*grads):
        torch.testing.assert_close(a, w, rtol=0, atol=1e-5)
    assert torch.equal(fa.flash_attention(q, k, v),
                       fa.flash_attention_lse(q, k, v)[0])


def test_model_grads_through_flash_match_plain_path():
    """Every param of llama-debug (fp32, remat 'full') gets a grad
    through attention_impl='flash' (the autograd function), equal to the
    plain path's: the fault of a forward that wrote into a fresh tensor
    and cut wq, wk, wv and attn_norm out of the graph cannot return."""
    cfg = dataclasses.replace(config.PRESETS['llama-debug'],
                              dtype=torch.float32, remat='full')
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), 'cpu')
    leaves = [params['embed'], params['final_norm'], params['lm_head'],
              *params['layers'].values()]
    for leaf in leaves:
        leaf.requires_grad_(True)
    tokens = _t(np.random.default_rng(1).integers(0, 256, (2, 24)))
    grads = []
    for impl in ('flash', 'xla'):
        logits = llama.forward(params, tokens,
                               dataclasses.replace(cfg, attention_impl=impl))
        grads.append(torch.autograd.grad(logits.square().mean(), leaves,
                                         allow_unused=True))
    for a, w in zip(*grads):
        assert a is not None and w is not None
        torch.testing.assert_close(a, w, rtol=1e-4, atol=1e-6)
