"""The port's CUDA kernels on the card: each against its plain version.

Marked ``gpu``: each test asks its ``cuda`` fixture for a device and
skips without one (the CPU tests hold the plain versions against the
JAX package). On a machine with a card (``--noconftest``: the suite's
conftest.py imports jax, which this file does not need):

    python -m pytest tests/test_torch_gpu.py -q -p no:cacheprovider --noconftest

Tolerance, as in chip_smoke.py: the kernel's bf16 output against the
plain version computed in fp32 on the same bf16 inputs, elementwise
|o - ref| <= 1e-2 + 2^-8 |ref| (the kernels round probabilities to
bf16 before P V, and the output's own bf16 rounding is 2^-9 |o|); lse
within 1e-3 (fp32 statistics on both sides).
"""
import dataclasses

import numpy as np
import pytest
import torch

from skypilot_tpu_torch import config
from skypilot_tpu_torch.kernels import build
from skypilot_tpu_torch.models import decode, llama, paging
from skypilot_tpu_torch.ops import flash_attention as fa
from skypilot_tpu_torch.ops import paged_attention as pa

pytestmark = pytest.mark.gpu

TOL_O, ULP_O, TOL_LSE = 1e-2, 2.0 ** -8, 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernels have no CPU mode')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


def _rand(gen, *shape):
    return torch.randn(shape, generator=gen, device='cuda').bfloat16()


def _prescaled_fp32(q, *rest):
    qs = (q * q.shape[-1] ** -0.5).to(q.dtype)
    return (qs.float(), *(t.float() for t in rest))


def _assert_o_close(o, ref):
    o, ref = o.float(), ref.float()
    assert o.isfinite().all()
    err = (o - ref).abs()
    assert (err <= TOL_O + ULP_O * ref.abs()).all(), float(err.max())


@pytest.mark.parametrize('b,s,h,kh,d,causal', [
    (1, 16, 4, 2, 128, True), (2, 100, 4, 2, 128, True),
    (1, 130, 4, 4, 128, False), (1, 70, 4, 1, 64, True),
    (1, 300, 2, 2, 64, False)])
def test_flash_kernel_matches_plain(cuda, b, s, h, kh, d, causal):
    gen = torch.Generator(device=cuda).manual_seed(s)
    q, k, v = _rand(gen, b, s, h, d), _rand(gen, b, s, kh, d), \
        _rand(gen, b, s, kh, d)
    before = fa.KERNEL.launches
    o, lse = fa.flash_attention_lse(q, k, v, causal=causal)
    assert fa.KERNEL.launches == before + 1
    o_ref, lse_ref = fa.flash_attention_ref(*_prescaled_fp32(q, k, v),
                                            causal=causal, softmax_scale=1.0)
    torch.cuda.synchronize()
    assert o.shape == q.shape and lse.shape == (b, s, h)
    _assert_o_close(o, o_ref)
    assert float((lse - lse_ref).abs().max()) <= TOL_LSE


@pytest.mark.parametrize('s', [1, 2, 4])
def test_paged_kernel_matches_plain(cuda, s):
    b, h, kh, hd, psz, maxp = 4, 8, 2, 128, 16, 6
    rng = np.random.default_rng(s)
    lengths = rng.integers(1, maxp * psz - s, size=b).astype(np.int32)
    lengths[1] = 0
    n_pages = b * maxp + 1
    perm = rng.permutation(np.arange(1, n_pages))
    table = np.zeros((b, maxp), np.int32)
    used = 0
    for r in range(b):
        n = paging.pages_for(int(lengths[r]) + s, psz)
        table[r, :n] = perm[used:used + n]
        used += n
    gen = torch.Generator(device=cuda).manual_seed(s)
    kp, vp = _rand(gen, n_pages, psz, kh, hd), _rand(gen, n_pages, psz, kh, hd)
    q = _rand(gen, b, s, h, hd)
    table_t = torch.from_numpy(table).cuda()
    length_t = torch.from_numpy(lengths).cuda()
    before = pa.KERNEL.launches
    out = pa.paged_decode_attention(q, kp, vp, table_t, length_t)
    assert pa.KERNEL.launches == before + 1
    qf, kf, vf = _prescaled_fp32(q, kp, vp)
    ref = pa.paged_decode_attention_ref(qf, kf, vf, table_t, length_t,
                                        softmax_scale=1.0)
    torch.cuda.synchronize()
    _assert_o_close(out, ref)


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k = _rand(gen, 1, 8, 2, 128), _rand(gen, 1, 8, 2, 128)
    with pytest.raises(TypeError):
        fa.flash_attention_lse(q.float(), k.float(), k.float())
    q96, k96 = _rand(gen, 1, 8, 2, 96), _rand(gen, 1, 8, 2, 96)
    with pytest.raises(ValueError):
        fa.flash_attention_lse(q96, k96, k96)
    pool = _rand(gen, 3, 16, 2, 64)
    table = torch.zeros((1, 2), dtype=torch.int32, device=cuda)
    length = torch.zeros((1,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        pa.paged_decode_attention(_rand(gen, 1, 1, 4, 64), pool, pool, table,
                                  length)


def test_model_step_runs_both_kernels(cuda):
    """Prefill and one paged decode step of a narrow hd=128 model on the
    card launch kernel A once and kernel B once per layer, and agree
    with the plain path within bf16 noise."""
    cfg = dataclasses.replace(config.PRESETS['llama-debug'], dim=256,
                              n_heads=4, n_kv_heads=2, head_dim=128,
                              ffn_dim=512)
    params = decode.cast_params_for_decode(
        llama.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                          cuda), cfg)
    tokens = torch.randint(0, cfg.vocab_size, (2, 32), device=cuda,
                           generator=torch.Generator(device=cuda)
                           .manual_seed(1), dtype=torch.int32)
    lengths = torch.tensor([32, 20], dtype=torch.int32, device=cuda)
    psz, maxp = 16, 4
    outs, feed = [], None
    for plain in (False, True):
        build.reset_launches()
        logits, ks, vs = decode.prefill(params, tokens, cfg, 64,
                                        lengths=lengths,
                                        attention_impl='xla' if plain
                                        else 'auto')
        pc = decode.init_page_pool(cfg, 2 * maxp + 1, psz, 2, maxp, cuda)
        pc.table.copy_(torch.arange(1, 2 * maxp + 1, dtype=torch.int32,
                                    device=cuda).reshape(2, maxp))
        paging.scatter_prefill(pc, ks, vs, torch.arange(2, device=cuda), 32,
                               lengths)
        if feed is None:
            feed = logits.argmax(-1).int()     # both paths decode these
        step, _ = decode.paged_decode_step(
            params, feed, pc, cfg, max_len=64,
            attention_fn=(pa.paged_attention_step_ref if plain
                          else pa.paged_attention_step))
        launches = {n: k.launches for n, k in build.kernels().items()}
        want = 0 if plain else cfg.n_layers
        assert launches == {'flash_fwd': want, 'paged_decode': want}
        outs.append((logits, step))
    for a, b in zip(outs[0], outs[1]):
        assert a.isfinite().all()
        assert float((a - b).abs().max()) <= 5e-2 * float(b.std())
