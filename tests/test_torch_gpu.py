"""The port's CUDA kernels on the card: each against its plain version,
and the model's forward and backward through them against the plain
path.

Marked ``gpu``: each test asks its ``cuda`` fixture for a device and
skips without one (the CPU tests hold the plain versions against the
JAX package). On a machine with a card (``--noconftest``: the suite's
conftest.py imports jax, which this file does not need):

    python -m pytest tests/test_torch_gpu.py -q -p no:cacheprovider --noconftest

Tolerance, as in chip_smoke.py: the kernel's bf16 output against the
plain version computed in fp32 on the same bf16 inputs, elementwise
|o - ref| <= 1e-2 + 2^-8 |ref| (the kernels round probabilities to
bf16 before P V, and the output's own bf16 rounding is 2^-9 |o|); lse
within 1e-3 (fp32 statistics on both sides). Backward kernels: each
grad's max|err| / max|ref| < 2e-2, the JAX package's bound for its own
backward kernels (p and ds round to bf16 before their products).
"""
import dataclasses

import numpy as np
import pytest
import torch

from skypilot_tpu_torch import config
from skypilot_tpu_torch.kernels import build
from skypilot_tpu_torch.models import decode, llama, paging, weights
from skypilot_tpu_torch.ops import flash_attention as fa
from skypilot_tpu_torch.ops import paged_attention as pa
from skypilot_tpu_torch.train import train_lib

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


# (B, S, T, H, KH, D, causal): one partial tile (S=16, 70), exact
# multiples of the 128-row tile (128, 2048), tiles past the edge (130,
# 300), T != S (non-causal), D=64 and 128, GQA groups 1, 2 and 4.
FLASH_CASES = [(1, 16, 16, 4, 2, 128, True), (2, 100, 100, 4, 2, 128, True),
               (1, 130, 130, 4, 4, 128, False), (1, 70, 70, 4, 1, 64, True),
               (1, 300, 300, 2, 2, 64, False), (1, 128, 128, 4, 4, 128, True),
               (1, 2048, 2048, 4, 2, 128, True), (1, 2048, 2048, 4, 1, 64, True),
               (2, 100, 260, 4, 2, 128, False), (1, 300, 77, 4, 1, 64, False)]


@pytest.mark.parametrize('b,s,t,h,kh,d,causal', FLASH_CASES)
def test_flash_kernel_matches_plain(cuda, b, s, t, h, kh, d, causal):
    gen = torch.Generator(device=cuda).manual_seed(s + t)
    q, k, v = _rand(gen, b, s, h, d), _rand(gen, b, t, kh, d), \
        _rand(gen, b, t, kh, d)
    before = fa.KERNEL.launches
    o, lse = fa.flash_attention_lse(q, k, v, causal=causal)
    assert fa.KERNEL.launches == before + 1
    o_ref, lse_ref = fa.flash_attention_ref(*_prescaled_fp32(q, k, v),
                                            causal=causal, softmax_scale=1.0)
    torch.cuda.synchronize()
    assert o.shape == q.shape and lse.shape == (b, s, h)
    _assert_o_close(o, o_ref)
    assert float((lse - lse_ref).abs().max()) <= TOL_LSE


def _paged_inputs(cuda, s, h, kh, hd=128, psz=16):
    """Four ragged rows over shuffled pages (psz 16, 6 pages a row; the
    kernel's split puts each page in its own chunk): row 1 of length 0,
    row 2 inside its first page, row 3 ending exactly on a page (and
    chunk) boundary."""
    b, maxp = 4, 6
    rng = np.random.default_rng(s + h)
    lengths = rng.integers(1, maxp * psz - s, size=b).astype(np.int32)
    lengths[1], lengths[2], lengths[3] = 0, 10 - s, 2 * psz - s
    n_pages = b * maxp + 1
    perm = rng.permutation(np.arange(1, n_pages))
    table = np.zeros((b, maxp), np.int32)
    used = 0
    for r in range(b):
        n = paging.pages_for(int(lengths[r]) + s, psz)
        table[r, :n] = perm[used:used + n]
        used += n
    gen = torch.Generator(device=cuda).manual_seed(s + h)
    kp, vp = _rand(gen, n_pages, psz, kh, hd), _rand(gen, n_pages, psz, kh, hd)
    q = _rand(gen, b, s, h, hd)
    return (q, kp, vp, torch.from_numpy(table).cuda(),
            torch.from_numpy(lengths).cuda())


# (S, H, KH): groups of 4 q heads at S 1, 2, 4; then g*S past 16: g = 7
# at S = 3 and 5, g = 8 at S = 8 (64 rows, the kernel's limit).
PAGED_CASES = [pytest.param(s, 8, 2, id=str(s)) for s in (1, 2, 4)] + [
    pytest.param(s, h, kh, id=f's{s}-h{h}-kh{kh}')
    for s, h, kh in ((3, 28, 4), (5, 28, 4), (8, 32, 4))]


@pytest.mark.parametrize('s,h,kh', PAGED_CASES)
def test_paged_kernel_matches_plain(cuda, s, h, kh):
    q, kp, vp, table_t, length_t = _paged_inputs(cuda, s, h, kh)
    before = pa.KERNEL.launches
    out = pa.paged_decode_attention(q, kp, vp, table_t, length_t)
    assert pa.KERNEL.launches == before + 1
    qf, kf, vf = _prescaled_fp32(q, kp, vp)
    ref = pa.paged_decode_attention_ref(qf, kf, vf, table_t, length_t,
                                        softmax_scale=1.0)
    torch.cuda.synchronize()
    _assert_o_close(out, ref)


def test_paged_kernel_is_deterministic(cuda):
    """Kernel B twice on one input at 64 rows, its pages split over
    several blocks a row: bit-equal outputs (the partials merge in a
    fixed order)."""
    q, kp, vp, table, length = _paged_inputs(cuda, 8, 32, 4)
    assert pa.split_pages(q.shape[0], kp.shape[2], table.shape[1],
                          pa._sm_count(q.device.index))[0] > 1
    outs = []
    for _ in range(2):
        out, launch = pa.kernel_call(q, kp, vp, table, length)
        launch()
        outs.append(out)
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])


def test_paged_kernel_takes_a_permuted_q(cuda):
    """A dense q whose strides are not [B, S, H, hd]'s order gives the
    same output as its contiguous copy, and the output is contiguous."""
    q, kp, vp, table, length = _paged_inputs(cuda, 4, 8, 2)
    qp = q.transpose(1, 2).contiguous().transpose(1, 2)
    assert not qp.is_contiguous() and torch.equal(qp, q)
    out = pa.paged_decode_attention(qp, kp, vp, table, length)
    want = pa.paged_decode_attention(q, kp, vp, table, length)
    torch.cuda.synchronize()
    assert out.is_contiguous()
    assert torch.equal(out, want)


def test_paged_kernel_refuses_a_short_workspace(cuda):
    """The kernel's entry point owns the workspace layout and refuses a
    workspace one float or one ticket short, launching nothing."""
    q, kp, vp, table, length = _paged_inputs(cuda, 8, 32, 4)
    b, s, h, hd = q.shape
    kh, maxp = kp.shape[2], table.shape[1]
    chunks, per = pa.split_pages(b, kh, maxp, pa._sm_count(q.device.index))
    floats, tickets = pa.workspace_sizes(b, kh, h // kh * s, chunks, hd)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream
    for nf, nt in ((floats - 1, tickets), (floats, tickets - 1)):
        work = torch.empty(floats, dtype=torch.float32, device=cuda)
        ticket = torch.zeros(tickets, dtype=torch.int32, device=cuda)
        before = pa.KERNEL.launches
        with pytest.raises(RuntimeError, match='launch failed'):
            pa.KERNEL.launch(
                *(t.data_ptr() for t in (q, kp, vp, table, length, out, work,
                                         ticket)),
                nf, nt, b, s, h, kh, hd, kp.shape[1], maxp, chunks, per,
                hd ** -0.5, stream)
        assert pa.KERNEL.launches == before


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k = _rand(gen, 1, 8, 2, 128), _rand(gen, 1, 8, 2, 128)
    with pytest.raises(TypeError):
        fa.flash_attention_lse(q.float(), k.float(), k.float())
    q96, k96 = _rand(gen, 1, 8, 2, 96), _rand(gen, 1, 8, 2, 96)
    with pytest.raises(ValueError):
        fa.flash_attention_lse(q96, k96, k96)
    # head_dim 96: not one of B's (64, 128, 256).
    pool = _rand(gen, 3, 16, 2, 96)
    table = torch.zeros((1, 2), dtype=torch.int32, device=cuda)
    length = torch.zeros((1,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match='head_dim'):
        pa.paged_decode_attention(_rand(gen, 1, 1, 4, 96), pool, pool, table,
                                  length)
    # g*S = 72 rows per kv head: above the kernel's 64, refused with no
    # fallback.
    pool = _rand(gen, 3, 16, 2, 128)
    with pytest.raises(ValueError, match='at most 64'):
        pa.paged_decode_attention(_rand(gen, 1, 9, 16, 128), pool, pool,
                                  table, length)


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
        assert launches == {'flash_fwd': want, 'paged_decode': want,
                            'flash_dq': 0, 'flash_dkv': 0}
        outs.append((logits, step))
    for a, b in zip(outs[0], outs[1]):
        assert a.isfinite().all()
        assert float((a - b).abs().max()) <= 5e-2 * float(b.std())


def _bwd_inputs(cuda, b, s, t, h, kh, d, causal, with_dlse):
    """The backward kernels' inputs: q pre-scaled, o and lse from kernel
    A, dlse random or None."""
    gen = torch.Generator(device=cuda).manual_seed(s + t + h)
    qs = (_rand(gen, b, s, h, d) * d ** -0.5).bfloat16()
    k, v, do = _rand(gen, b, t, kh, d), _rand(gen, b, t, kh, d), \
        _rand(gen, b, s, h, d)
    o, lse = fa._fwd(qs, k, v, causal)
    dlse = torch.randn(lse.shape, generator=gen, device=cuda) \
        if with_dlse else None
    return qs, k, v, o, lse, do, dlse


# (B, S, T, H, KH, D, causal, nonzero lse cotangent): the chip_smoke
# shapes, plus one partial tile, exact multiples of 128, T != S, D=64 at
# S=2048; GQA groups 1, 2 and 4; then D=256 (the Gemma family): groups
# 1 and 2, ragged and odd S (lse and delta rows by plain loads), both
# causal settings, an lse cotangent, T != S, S=1024.
BWD_CASES = [(1, 100, 100, 4, 4, 128, True, False),
             (2, 130, 130, 4, 2, 128, False, True),
             (1, 256, 256, 8, 2, 128, True, True),
             (1, 200, 200, 4, 1, 64, True, False),
             (1, 300, 300, 4, 2, 64, False, True),
             (2, 2048, 2048, 16, 8, 128, True, False),
             (1, 16, 16, 4, 2, 128, True, True),
             (1, 70, 70, 4, 1, 64, True, True),
             (1, 128, 128, 4, 4, 128, True, False),
             (2, 100, 260, 4, 2, 128, False, True),
             (1, 300, 77, 4, 1, 64, False, False),
             (1, 2048, 2048, 4, 1, 64, True, False),
             (1, 100, 100, 4, 4, 256, True, False),
             (2, 130, 130, 4, 2, 256, False, True),
             (1, 301, 301, 8, 4, 256, True, True),
             (1, 16, 16, 2, 2, 256, True, False),
             (2, 100, 260, 4, 2, 256, False, False),
             (1, 1024, 1024, 4, 4, 256, True, False)]


@pytest.mark.parametrize('b,s,t,h,kh,d,causal,with_dlse', BWD_CASES)
def test_flash_bwd_kernels_match_plain(cuda, b, s, t, h, kh, d, causal,
                                       with_dlse):
    """Kernels C and D vs the plain backward in fp32 on the same bf16
    inputs (o and lse from kernel A)."""
    qs, k, v, o, lse, do, dlse = _bwd_inputs(cuda, b, s, t, h, kh, d, causal,
                                             with_dlse)
    before = (fa.DQ_KERNEL.launches, fa.DKV_KERNEL.launches)
    got = fa._bwd(qs, k, v, o, lse, do, dlse, causal)
    assert (fa.DQ_KERNEL.launches, fa.DKV_KERNEL.launches) == \
        (before[0] + 1, before[1] + 1)
    ref = fa.flash_attention_bwd_ref(qs.float(), k.float(), v.float(),
                                     o.float(), lse, do.float(), dlse,
                                     causal=causal)
    torch.cuda.synchronize()
    for a, r in zip(got, ref):
        assert a.shape == r.shape and a.dtype == torch.bfloat16
        assert a.isfinite().all()
        assert float((a.float() - r).abs().max()) < 2e-2 * float(
            r.abs().max())


@pytest.mark.parametrize('d', [128, 256])
def test_flash_dq_is_deterministic(cuda, d):
    """Kernel C twice on the same inputs gives a bit-identical dq: each
    block owns its q rows' dq and writes each element once, with no
    atomics."""
    b, s, h, kh = 1, 300, 8, 2
    qs, k, v, o, lse, do, _ = _bwd_inputs(cuda, b, s, s, h, kh, d, True,
                                          False)
    delta = fa._delta(o, do, None)
    stream = torch.cuda.current_stream().cuda_stream
    outs = []
    for _ in range(2):
        dq = torch.empty_like(qs)
        fa.DQ_KERNEL.launch(qs.data_ptr(), k.data_ptr(), v.data_ptr(),
                            do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                            dq.data_ptr(), b, s, s, h, kh, d, 1, stream)
        outs.append(dq)
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize('d', [128, 256])
def test_flash_dkv_is_deterministic(cuda, d):
    """Kernel D twice on the same inputs gives bit-identical dk and dv:
    each block owns its keys' grads and sums the group's q heads in
    registers, with no atomics."""
    b, s, h, kh = 1, 300, 8, 2
    qs, k, v, o, lse, do, _ = _bwd_inputs(cuda, b, s, s, h, kh, d, True,
                                          False)
    delta = fa._delta(o, do, None)
    stream = torch.cuda.current_stream().cuda_stream
    outs = []
    for _ in range(2):
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        fa.DKV_KERNEL.launch(qs.data_ptr(), k.data_ptr(), v.data_ptr(),
                             do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                             dk.data_ptr(), dv.data_ptr(), b, s, s, h, kh, d,
                             1, stream)
        outs.append((dk, dv))
    torch.cuda.synchronize()
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


def test_verify_step_at_64_rows_runs_kernel_b(cuda):
    """A verify step of 8 tokens with 8 q heads on one kv head (g*S =
    64) runs kernel B once a layer and agrees with the plain path within
    bf16 noise."""
    cfg = dataclasses.replace(config.PRESETS['llama-debug'], dim=1024,
                              n_heads=8, n_kv_heads=1, head_dim=128,
                              ffn_dim=512)
    params = decode.cast_params_for_decode(
        llama.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                          cuda), cfg)
    gen = torch.Generator(device=cuda).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (2, 32), device=cuda,
                           generator=gen, dtype=torch.int32)
    verify = torch.randint(0, cfg.vocab_size, (2, 8), device=cuda,
                           generator=gen, dtype=torch.int32)
    lengths = torch.tensor([32, 20], dtype=torch.int32, device=cuda)
    psz, maxp = 16, 4
    _, ks, vs = decode.prefill(params, tokens, cfg, 64, lengths=lengths,
                               attention_impl='xla')
    outs = []
    for fn in (pa.paged_attention_step, pa.paged_attention_step_ref):
        pc = decode.init_page_pool(cfg, 2 * maxp + 1, psz, 2, maxp, cuda)
        pc.table.copy_(torch.arange(1, 2 * maxp + 1, dtype=torch.int32,
                                    device=cuda).reshape(2, maxp))
        paging.scatter_prefill(pc, ks, vs, torch.arange(2, device=cuda), 32,
                               lengths)
        before = pa.KERNEL.launches
        logits, _ = decode.paged_verify_step(params, verify, pc, cfg,
                                             max_len=64, attention_fn=fn)
        n = cfg.n_layers if fn is pa.paged_attention_step else 0
        assert pa.KERNEL.launches == before + n
        outs.append(logits)
    assert outs[0].shape == (2, 8, cfg.vocab_size)
    assert outs[0].isfinite().all()
    assert float((outs[0] - outs[1]).abs().max()) <= \
        5e-2 * float(outs[1].std())


def test_model_backward_gives_every_param_a_grad(cuda):
    """One backward pass of a narrow hd=128 model (remat 'full') through
    the kernels: every param gets a grad, and each is close to the plain
    path's (relative Frobenius error < 5e-2, bf16 noise through 2
    layers). The kernels launch as designed: A twice a layer (forward
    and recompute), C and D once."""
    cfg = dataclasses.replace(config.PRESETS['llama-debug'], dim=256,
                              n_heads=4, n_kv_heads=2, head_dim=128,
                              ffn_dim=512, remat='full')
    params = llama.init_params(cfg, torch.Generator(device=cuda)
                               .manual_seed(0), cuda)
    leaves = [leaf for _, leaf in weights.tree_paths(params)]
    for leaf in leaves:
        leaf.requires_grad_(True)
    tokens = torch.randint(0, cfg.vocab_size, (2, 200), device=cuda,
                           generator=torch.Generator(device=cuda)
                           .manual_seed(1))
    grads = []
    for impl in ('auto', 'xla'):
        build.reset_launches()
        logits = llama.forward(params, tokens[:, :-1],
                               dataclasses.replace(cfg, attention_impl=impl))
        loss, _ = train_lib.cross_entropy_loss(logits, tokens[:, 1:])
        grads.append(torch.autograd.grad(loss, leaves, allow_unused=True))
        launches = {n: k.launches for n, k in build.kernels().items()}
        n = cfg.n_layers if impl == 'auto' else 0
        assert launches == {'flash_fwd': 2 * n, 'flash_dq': n,
                            'flash_dkv': n, 'paged_decode': 0}
    for (name, _), g, ref in zip(weights.tree_paths(params), *grads):
        assert g is not None and g.isfinite().all(), name
        assert float((g - ref).norm()) < 5e-2 * float(ref.norm()), name


# Head dim 256 (the Gemma family). Kernel A: (B, S, T, H, KH, causal) —
# gemma-7b's 16/16 heads narrowed to 4/4, ragged S past the 64-key
# tile, T != S, a GQA group (gemma2/3's 2).
FLASH256_CASES = [(1, 16, 16, 4, 4, True), (2, 100, 100, 4, 4, True),
                  (1, 130, 130, 4, 2, False), (1, 300, 77, 4, 4, False),
                  (1, 1024, 1024, 2, 2, True)]


@pytest.mark.parametrize('b,s,t,h,kh,causal', FLASH256_CASES)
def test_flash_kernel_matches_plain_at_256(cuda, b, s, t, h, kh, causal):
    gen = torch.Generator(device=cuda).manual_seed(s + t + 256)
    q, k, v = _rand(gen, b, s, h, 256), _rand(gen, b, t, kh, 256), \
        _rand(gen, b, t, kh, 256)
    before = fa.KERNEL.launches
    o, lse = fa.flash_attention_lse(q, k, v, causal=causal)
    assert fa.KERNEL.launches == before + 1
    o_ref, lse_ref = fa.flash_attention_ref(*_prescaled_fp32(q, k, v),
                                            causal=causal, softmax_scale=1.0)
    torch.cuda.synchronize()
    _assert_o_close(o, o_ref)
    assert float((lse - lse_ref).abs().max()) <= TOL_LSE


# Kernel B at head_dim 256, (S, H, KH, psz): g = 1 and 2 at decode and
# verify widths; g*S = 64 (two ring slots); pages of 16, 40 (a padded
# tile) and 72 (two padded halves: pages over 64 tokens stream in
# halves).
PAGED256_CASES = [(1, 4, 4, 16), (4, 4, 2, 16), (8, 32, 4, 16),
                  (1, 4, 4, 40), (3, 4, 2, 72)]


@pytest.mark.parametrize('s,h,kh,psz', PAGED256_CASES)
def test_paged_kernel_matches_plain_at_256(cuda, s, h, kh, psz):
    q, kp, vp, table_t, length_t = _paged_inputs(cuda, s, h, kh, hd=256,
                                                 psz=psz)
    before = pa.KERNEL.launches
    out = pa.paged_decode_attention(q, kp, vp, table_t, length_t)
    again = pa.paged_decode_attention(q, kp, vp, table_t, length_t)
    assert pa.KERNEL.launches == before + 2
    qf, kf, vf = _prescaled_fp32(q, kp, vp)
    ref = pa.paged_decode_attention_ref(qf, kf, vf, table_t, length_t,
                                        softmax_scale=1.0)
    torch.cuda.synchronize()
    _assert_o_close(out, ref)
    assert torch.equal(out, again)


# Kernel B at head_dim 64, (S, H, KH, psz): llama3.2-1b's heads (32/8,
# g = 4) at decode and verify widths on its engine's 64-token pages;
# then g = 4 and 8 on 16-token pages, up to g*S = 64.
PAGED64_CASES = [(1, 32, 8, 64), (4, 32, 8, 64), (1, 8, 2, 16),
                 (8, 32, 4, 16)]


@pytest.mark.parametrize('s,h,kh,psz', PAGED64_CASES)
def test_paged_kernel_matches_plain_at_64(cuda, s, h, kh, psz):
    q, kp, vp, table_t, length_t = _paged_inputs(cuda, s, h, kh, hd=64,
                                                 psz=psz)
    before = pa.KERNEL.launches
    out = pa.paged_decode_attention(q, kp, vp, table_t, length_t)
    again = pa.paged_decode_attention(q, kp, vp, table_t, length_t)
    assert pa.KERNEL.launches == before + 2
    qf, kf, vf = _prescaled_fp32(q, kp, vp)
    ref = pa.paged_decode_attention_ref(qf, kf, vf, table_t, length_t,
                                        softmax_scale=1.0)
    torch.cuda.synchronize()
    _assert_o_close(out, ref)
    assert torch.equal(out, again)


def _paged_step(cuda, s, h, kh, hd, psz):
    """One paged decode/verify step's inputs: the pools of
    ``_paged_inputs`` with S new K/V rows a row, written at each row's
    positions [length, length + S)."""
    q, kp, vp, table_t, length_t = _paged_inputs(cuda, s, h, kh, hd=hd,
                                                 psz=psz)
    gen = torch.Generator(device=cuda).manual_seed(7)
    b = q.shape[0]
    k_new, v_new = _rand(gen, b, s, kh, hd), _rand(gen, b, s, kh, hd)
    pos = length_t[:, None].long() + torch.arange(s, device=cuda)
    pid = torch.gather(table_t.long(), 1, pos // psz)
    max_len = table_t.shape[1] * psz
    return (q, kp, vp, table_t, length_t, k_new, v_new, pid, pos % psz,
            max_len)


@pytest.mark.parametrize('s', [1, 4])
def test_paged_step_at_head_dim_64_runs_kernel_b(cuda, s):
    """A dense model with head_dim 64 (llama3.2-1b: 32/8 heads, g = 4)
    decodes and verifies through kernel B, against the fused plain step
    on the same pools. Before B took head_dim 64 the gate still sent it
    there, and this step raised ValueError ('head_dim in (128, 256)')."""
    (q, kp, vp, table_t, length_t, k_new, v_new, pid, off,
     max_len) = _paged_step(cuda, s, 32, 8, 64, 64)
    kp_ref, vp_ref = kp.clone(), vp.clone()
    before = pa.KERNEL.launches
    out, kp2, vp2 = pa.paged_attention_step(
        q, kp, vp, table_t, length_t, k_new, v_new, pid, off,
        max_len=max_len)
    assert pa.KERNEL.launches == before + 1
    ref, kp_ref, vp_ref = pa.paged_attention_step_ref(
        q.float(), kp_ref.float(), vp_ref.float(), table_t, length_t,
        k_new.float(), v_new.float(), pid, off, max_len=max_len)
    torch.cuda.synchronize()
    assert kp2 is kp and vp2 is vp
    assert torch.equal(kp.float(), kp_ref) and torch.equal(vp.float(),
                                                           vp_ref)
    _assert_o_close(out, ref)


@pytest.mark.parametrize('hd,psz', [(96, 64), (64, 60)])
def test_paged_step_at_a_shape_b_refuses_takes_the_fused_path(cuda, hd,
                                                              psz):
    """A head_dim or page size kernel B does not take never reaches it:
    the step runs the fused formulation and launches nothing."""
    (q, kp, vp, table_t, length_t, k_new, v_new, pid, off,
     max_len) = _paged_step(cuda, 1, 8, 2, hd, psz)
    assert not pa.kernel_takes(q.shape, kp.shape)
    kp_ref, vp_ref = kp.clone(), vp.clone()
    before = pa.KERNEL.launches
    out, _, _ = pa.paged_attention_step(q, kp, vp, table_t, length_t,
                                        k_new, v_new, pid, off,
                                        max_len=max_len)
    ref, _, _ = pa.paged_attention_step_ref(q, kp_ref, vp_ref, table_t,
                                            length_t, k_new, v_new, pid,
                                            off, max_len=max_len)
    assert pa.KERNEL.launches == before
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


def _gemma_layer_run(cuda, plain, **switches):
    """Prefill and one paged decode step of a one-layer model with
    gemma-7b's head shape (head_dim 256, 16/16 heads narrowed to 4/4,
    its norms, gelu MLP and embedding scale) plus ``switches``, by the
    default routing or (``plain``) the plain path, on the same bf16
    weights (upcast for ``dtype=torch.float32``): (launch counts, the
    prefill and step logits)."""
    cfg = dataclasses.replace(config.PRESETS['gemma-7b'], n_layers=1,
                              dim=512, n_heads=4, n_kv_heads=4, ffn_dim=1024,
                              vocab_size=512, **switches)
    params = decode.cast_params_for_decode(decode.cast_params_for_decode(
        llama.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                          cuda), dataclasses.replace(cfg,
                                                     dtype=torch.bfloat16)),
        cfg)
    tokens = torch.randint(0, cfg.vocab_size, (2, 32), device=cuda,
                           generator=torch.Generator(device=cuda)
                           .manual_seed(1), dtype=torch.int32)
    lengths = torch.tensor([32, 20], dtype=torch.int32, device=cuda)
    psz, maxp = 16, 4
    build.reset_launches()
    logits, ks, vs = decode.prefill(params, tokens, cfg, 64, lengths=lengths,
                                    attention_impl='xla' if plain else 'auto')
    pc = decode.init_page_pool(cfg, 2 * maxp + 1, psz, 2, maxp, cuda)
    pc.table.copy_(torch.arange(1, 2 * maxp + 1, dtype=torch.int32,
                                device=cuda).reshape(2, maxp))
    paging.scatter_prefill(pc, ks, vs, torch.arange(2, device=cuda), 32,
                           lengths)
    # Every run decodes the same next tokens.
    feed = torch.tensor([7, 300], dtype=torch.int32, device=cuda)
    step, _ = decode.paged_decode_step(
        params, feed, pc, cfg, max_len=64,
        attention_fn=(pa.paged_attention_step_ref if plain
                      else pa.paged_attention_step))
    launches = {n: k.launches for n, k in build.kernels().items()}
    return launches, torch.cat([logits, step]).float()


def test_gemma_7b_layer_launches_kernels_a_and_b(cuda):
    """The kernels launch once each, and the kernel path lies no
    farther from an fp32 run of the same weights than the plain bf16
    path does (relative Frobenius error, within 1.25x as chip_smoke's
    model phases; the two bf16 paths round at different points)."""
    launches, got = _gemma_layer_run(cuda, False)
    assert launches == {'flash_fwd': 1, 'paged_decode': 1, 'flash_dq': 0,
                        'flash_dkv': 0}
    assert got.isfinite().all()
    _, ref = _gemma_layer_run(cuda, True)
    _, f32 = _gemma_layer_run(cuda, True, dtype=torch.float32)
    e_kern = float((got - f32).norm()) / float(f32.norm())
    e_plain = float((ref - f32).norm()) / float(f32.norm())
    assert e_kern <= 1.25 * e_plain, (e_kern, e_plain)


@pytest.mark.parametrize('switches', [
    dict(attn_logit_softcap=50.0), dict(sliding_window=16),
    dict(sliding_window=16, sliding_window_pattern=1)],
    ids=['softcap', 'window', 'window-global'])
def test_softcap_or_window_layer_launches_neither_kernel(cuda, switches):
    """A softcap or a window (even on a global layer, whose window is
    off) takes the plain route on the card, as in the JAX package: the
    same logits as the plain path, bit for bit, and no launch."""
    launches, got = _gemma_layer_run(cuda, False, **switches)
    assert all(n == 0 for n in launches.values()), launches
    assert torch.equal(got, _gemma_layer_run(cuda, True, **switches)[1])


def test_flash_with_grad_at_an_unported_head_dim_is_refused(cuda):
    """A head dim kernels C and D do not take: a call that wants a grad
    there raises NotImplementedError before anything launches."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    q = _rand(gen, 1, 64, 2, 96).requires_grad_()
    k = _rand(gen, 1, 64, 2, 96)
    before = fa.KERNEL.launches
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        fa.flash_attention(q, k, k)
    assert fa.KERNEL.launches == before


@pytest.mark.parametrize('causal', [True, False])
def test_flash_autograd_at_256_matches_plain_autograd(cuda, causal):
    """_Flash at head_dim 256 (gemma's heads narrowed to 4/2): kernel A
    forward, kernels C and D backward, once each; grads of q, k and v
    against autograd through the plain attention in fp32 on the same
    bf16 inputs, within the backward kernels' 2e-2 of the largest."""
    from skypilot_tpu_torch.ops import attention
    gen = torch.Generator(device=cuda).manual_seed(4)
    q, k, v = (_rand(gen, 2, 200, h, 256).requires_grad_()
               for h in (4, 2, 2))
    w = torch.randn((2, 200, 4, 256), generator=gen, device=cuda)
    build.reset_launches()
    o = fa.flash_attention(q, k, v, causal=causal)
    got = torch.autograd.grad((o.float() * w).sum(), (q, k, v))
    assert {n: kern.launches for n, kern in build.kernels().items()} == \
        {'flash_fwd': 1, 'flash_dq': 1, 'flash_dkv': 1, 'paged_decode': 0}
    q32, k32, v32 = (x.detach().float().requires_grad_() for x in (q, k, v))
    ref_o = attention.xla_attention(q32, k32, v32, causal=causal)
    want = torch.autograd.grad((ref_o * w).sum(), (q32, k32, v32))
    for a, r in zip(got, want):
        assert a.dtype == torch.bfloat16 and a.isfinite().all()
        assert float((a.float() - r).abs().max()) < 2e-2 * float(
            r.abs().max())


def test_gemma_model_backward_runs_kernels_a_c_d(cuda):
    """One backward pass of a narrow gemma-7b-shaped model (head_dim
    256, 4/4 heads, 2 layers, remat 'full') through the kernels: A twice
    a layer, C and D once; every param's grad close to the plain path's
    (relative Frobenius error < 5e-2, as at head_dim 128)."""
    cfg = dataclasses.replace(config.PRESETS['gemma-7b'], n_layers=2,
                              dim=512, n_heads=4, n_kv_heads=4, ffn_dim=1024,
                              vocab_size=512)
    params = llama.init_params(cfg, torch.Generator(device=cuda)
                               .manual_seed(0), cuda)
    leaves = [leaf for _, leaf in weights.tree_paths(params)]
    for leaf in leaves:
        leaf.requires_grad_(True)
    tokens = torch.randint(0, cfg.vocab_size, (2, 200), device=cuda,
                           generator=torch.Generator(device=cuda)
                           .manual_seed(1))
    grads = []
    for impl in ('auto', 'xla'):
        build.reset_launches()
        logits = llama.forward(params, tokens[:, :-1],
                               dataclasses.replace(cfg, attention_impl=impl))
        loss, _ = train_lib.cross_entropy_loss(logits, tokens[:, 1:])
        grads.append(torch.autograd.grad(loss, leaves))
        n = cfg.n_layers if impl == 'auto' else 0
        assert {n_: k.launches for n_, k in build.kernels().items()} == \
            {'flash_fwd': 2 * n, 'flash_dq': n, 'flash_dkv': n,
             'paged_decode': 0}
    for (name, _), g, ref in zip(weights.tree_paths(params), *grads):
        assert g.isfinite().all(), name
        assert float((g - ref).norm()) < 5e-2 * float(ref.norm()), name


@pytest.mark.parametrize('switches', [
    dict(logit_softcap=30.0), dict(window=8, window_active=True),
    dict(sinks=torch.tensor([0.5, -1.0, 2.0, 0.0]))],
    ids=['softcap', 'window', 'sinks'])
def test_plain_paged_step_captures_into_a_graph(cuda, switches):
    """The plain paged step (the route of every softcap, window or sinks
    layer, which the engine's graphs capture) has no host sync: captured
    into a CUDA graph and replayed, it gives the eager call's output and
    content pages bit for bit, a row past the view's end included (its
    overlay drops the positions past the view; inactive, it writes the
    trash page, where clamped writes race)."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    b, s, h, kh, hd, psz, maxp = 3, 4, 4, 2, 128, 16, 4
    max_len = psz * maxp
    kp0, vp0 = _rand(gen, 13, psz, kh, hd), _rand(gen, 13, psz, kh, hd)
    table = torch.arange(1, 13, dtype=torch.int32,
                         device=cuda).reshape(b, maxp)
    length = torch.tensor([5, 30, max_len - 2], dtype=torch.int32,
                          device=cuda)
    q, k_new, v_new = (_rand(gen, b, s, h, hd), _rand(gen, b, s, kh, hd),
                       _rand(gen, b, s, kh, hd))
    # PagedKV holds [L, pages, psz, KH, hd] pools (page_size is read from
    # their third axis): one layer here, stepped through its views.
    pc = paging.PagedKV(kp0.clone()[None], vp0.clone()[None], table, length)
    kp, vp = pc.k[0], pc.v[0]
    pid, off = paging._write_indices(
        pc, length[:, None].long() + torch.arange(s, device=cuda),
        torch.tensor([True, True, False], device=cuda))
    # Each active row writes its own slots; the inactive row the trash
    # page, where its positions past the table clamp onto one slot.
    assert pid.tolist() == [[1] * 4, [6, 6, 7, 7], [0] * 4]
    assert off.tolist() == [[5, 6, 7, 8], [14, 15, 0, 1], [14, 15, 15, 15]]
    kw = dict(max_len=max_len, **{
        n: (v.to(cuda) if torch.is_tensor(v) else v)
        for n, v in switches.items()})

    def call():
        return pa.paged_attention_step_ref(q, kp, vp, table, length,
                                           k_new, v_new, pid, off, **kw)[0]

    want = call().clone()
    want_k, want_v = kp.clone(), vp.clone()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        call()                          # warm up on the capture stream
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = call()
    kp.copy_(kp0)
    vp.copy_(vp0)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    assert torch.equal(kp[1:], want_k[1:])
    assert torch.equal(vp[1:], want_v[1:])
    assert not torch.equal(kp[1:], kp0[1:])    # the step wrote pages


def test_engine_decodes_through_graphs(cuda, monkeypatch):
    """The engine on the card: warm-up captures all eight step variants
    with kernel B inside (k launches a layer each), decode calls only
    replay them (nothing captured after warm-up, B's count rises by the
    captured launches per replay), and greedy tokens at MAX_STEP_CHUNK 8
    equal those at 1, one request at a time (the same shapes every
    step). Speculation is off on these engines: its verify calls would
    run at another S than the steps whose widths this compares."""
    from skypilot_tpu_torch.serve import engine as engine_lib
    cfg = dataclasses.replace(config.PRESETS['llama-debug'], dim=256,
                              n_heads=4, n_kv_heads=2, head_dim=128,
                              ffn_dim=512, vocab_size=512)
    params = llama.init_params(
        cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    prompts = [[3, 1, 4, 1, 5], list(range(40)), [9] * 20]
    outs = {}
    for chunk in (8, 1):
        monkeypatch.setattr(engine_lib, 'MAX_STEP_CHUNK', chunk)
        build.reset_launches()
        eng = engine_lib.InferenceEngine('llama-debug', cfg=cfg,
                                         params=params, device='cuda')
        eng.spec_k = 0
        eng.warmup()
        want = {(k, p, t) for k in {1, chunk} for p in (False, True)
                for t in (False, True)}
        assert set(eng.graphs) == want
        for (k, _, _), n in eng._graph_launches.items():
            assert n == {'paged_decode': k * cfg.n_layers}
        captured = build.captured()
        b0 = pa.KERNEL.launches
        eng.start()
        try:
            outs[chunk] = [eng.submit(p, 21).result(timeout=300)[0]
                           for p in prompts]
        finally:
            eng.stop()
        assert build.captured() == captured
        assert pa.KERNEL.launches - b0 == sum(
            n * eng._graph_launches[key]['paged_decode']
            for key, n in eng.calls.items())
        assert eng.calls_by_width().get(chunk, 0) > 0
    assert outs[8] == outs[1]


def _hd128_model(cuda, vocab=512):
    cfg = dataclasses.replace(config.PRESETS['llama-debug'], dim=256,
                              n_heads=4, n_kv_heads=2, head_dim=128,
                              ffn_dim=512, vocab_size=vocab)
    params = llama.init_params(
        cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    return cfg, params


def test_extend_launches_a_only_at_p_zero(cuda):
    """A paged extend at p == 0 is a prefill: kernel A once a layer; at
    p > 0 it attends at an offset and takes the plain attention (the
    JAX gate): no A. Both agree with the plain route within bf16 noise,
    and the two chunks give the one-shot prefill's logits."""
    cfg, params = _hd128_model(cuda)
    params = decode.cast_params_for_decode(params, cfg)
    tok = torch.randint(0, cfg.vocab_size, (1, 64), device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(2),
                        dtype=torch.int32)
    outs = {}
    for impl in ('auto', 'xla'):
        pc = decode.init_page_pool(cfg, 5, 16, 1, 4, cuda)
        pc.table[0] = torch.tensor([2, 4, 1, 3], dtype=torch.int32,
                                   device=cuda)
        launches = []
        for p in (0, 32):
            a0 = fa.KERNEL.launches
            logits = decode.paged_prefill_extend(
                params, tok[:, p:p + 32], pc, cfg, slot=0, p=p, lengths=32,
                attention_impl=impl)
            launches.append(fa.KERNEL.launches - a0)
        assert launches == ([cfg.n_layers, 0] if impl == 'auto' else [0, 0])
        outs[impl] = logits
    one_shot, _, _ = decode.prefill(params, tok, cfg, 64)
    for got in outs.values():
        assert got.isfinite().all()
        assert float((got - one_shot).abs().max()) <= \
            5e-2 * float(one_shot.std())


def test_verify_graph_replay_equals_eager_verify(cuda):
    """Warm-up captures the two verify variants (kernel B once a layer);
    a replay on admitted rows gives the eager verify's greedy tokens and
    logprobs bit for bit, and writes the same K/V."""
    from skypilot_tpu_torch.serve import engine as engine_lib
    cfg, params = _hd128_model(cuda)
    eng = engine_lib.InferenceEngine('llama-debug', cfg=cfg, params=params,
                                     device='cuda', max_len=256)
    eng.warmup()
    k = eng.spec_k
    assert {key for key in eng.graphs if key[0] == 'verify'} == \
        {('verify', False), ('verify', True)}
    for want_tops in (False, True):
        assert eng._graph_launches[('verify', want_tops)] == \
            {'paged_decode': cfg.n_layers}
    eng._admit_group([engine_lib.Request([3, 1, 4, 1, 5], 32),
                      engine_lib.Request(list(range(9)), 32)])
    gen = torch.Generator(device=cuda).manual_seed(5)
    fed = torch.randint(0, cfg.vocab_size, (eng.max_batch, k), device=cuda,
                        generator=gen, dtype=torch.int32)
    fed[:, 0] = eng.last_dev
    act = torch.zeros(eng.max_batch, dtype=torch.int32, device=cuda)
    act[:2] = 1
    eng._spec_dev[:k].copy_(fed.t())
    eng._spec_dev[k].copy_(act)
    b0 = pa.KERNEL.launches
    eng._variant(('verify', False))()
    torch.cuda.synchronize()
    assert pa.KERNEL.launches - b0 == cfg.n_layers
    g_tok, g_lp = eng._ver_toks.clone(), eng._ver_lps.clone()
    g_k = eng.cache.k.clone()
    eng._verify_body(False)                      # eager, same inputs
    torch.cuda.synchronize()
    # The active rows; the inactive ones read the trash page, which each
    # call rewrites.
    assert torch.equal(eng._ver_toks[:2], g_tok[:2])
    assert torch.equal(eng._ver_lps[:2], g_lp[:2])
    assert torch.equal(eng.cache.k[:, 1:], g_k[:, 1:])


def test_engine_pages_balance_after_a_mixed_burst(cuda):
    """Chunked prompts, prefix hits and speculative rounds on the card
    through the batch loop: every counter moved, nothing was captured
    after warm-up, and afterwards only the prefix store holds pages, one
    ref each; emptying it frees everything."""
    from skypilot_tpu_torch.serve import engine as engine_lib
    cfg, params = _hd128_model(cuda)
    eng = engine_lib.InferenceEngine('llama-debug', cfg=cfg, params=params,
                                     device='cuda', max_len=512)
    eng.prefill_chunk = 32
    eng.warmup()
    captured = build.captured()
    eng.start()
    try:
        system = [(i * 7) % 500 + 1 for i in range(70)]
        eng.submit(system + [1, 2], 8).result(timeout=300)
        futs = [eng.submit(system + [3 + j], 16) for j in range(3)]
        futs += [eng.submit([(i * 3) % 500 for i in range(150)], 16),
                 eng.submit([5, 6, 7, 8] * 6, 48),
                 eng.submit([9] * 12, 8, temperature=0.8)]
        outs = [f.result(timeout=300) for f in futs]
    finally:
        eng.stop()
    assert all(len(o[0]) == n for o, n in zip(outs, (16, 16, 16, 16, 48,
                                                     8)))
    assert eng.prefix_hits >= 3 and eng.prefill_chunks >= 6
    assert eng.spec_rounds > 0
    assert build.captured() == captured
    held = [p for pids in eng._prefix_store.values() for p in pids]
    assert eng.alloc.used_count == len(held) > 0
    assert all(eng.alloc.refcount(p) == 1 for p in held)
    eng._clear_prefix_store()
    assert eng.alloc.used_count == 0


@pytest.mark.parametrize('name,head_dim', [('moe-debug', 128),
                                           ('gptoss-debug', None)])
def test_moe_step_graph_replay_equals_eager_step(cuda, name, head_dim):
    """An MoE engine on random weights (seed 0): moe-debug at head_dim
    128, where kernel B runs inside the graphs, and gptoss-debug (sinks:
    the plain attention). Warm-up captures the eight step graphs and no
    verify graph (spec_k is 0), and a replay of the k=1 greedy graph on
    two admitted rows gives the eager step's tokens, logprobs and K/V
    bit for bit: the routed FFN's static dispatch has no host sync and
    no shape that depends on the data."""
    from skypilot_tpu_torch.models import moe
    from skypilot_tpu_torch.serve import engine as engine_lib
    cfg = config.MOE_PRESETS[name]
    if head_dim is not None:
        cfg = dataclasses.replace(cfg, head_dim=head_dim)
    params = moe.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                             cuda, dtype=cfg.dtype)
    eng = engine_lib.InferenceEngine(name, cfg=cfg, params=params,
                                     device='cuda', max_len=256)
    eng.warmup()
    assert eng.spec_k == 0
    assert set(eng.graphs) == {(k, p, t) for k in (1, eng.step_chunk)
                               for p in (False, True)
                               for t in (False, True)}
    per_layer = 0 if cfg.attn_sinks else 1
    for (k, _, _), n in eng._graph_launches.items():
        assert n.get('paged_decode', 0) == k * cfg.n_layers * per_layer
    eng._admit_group([engine_lib.Request([3, 1, 4, 1, 5], 32),
                      engine_lib.Request(list(range(9)), 32)])
    eng._ctrl.zero_()
    eng._ctrl[0, :2] = 1                     # two rows active, greedy
    state = (eng.cache.k, eng.cache.v, eng.cache.length, eng.last_dev)
    snap = [t.clone() for t in state]
    b0 = pa.KERNEL.launches
    eng._variant((1, False, False))()
    torch.cuda.synchronize()
    assert pa.KERNEL.launches - b0 == cfg.n_layers * per_layer
    g_tok, g_lp = eng._out_toks[0].clone(), eng._out_lps[0].clone()
    g_k, g_len = eng.cache.k.clone(), eng.cache.length.clone()
    for t, v in zip(state, snap):
        t.copy_(v)
    eng._step_body(1, False, False)          # eager, same inputs
    torch.cuda.synchronize()
    assert torch.equal(eng._out_toks[0, :2], g_tok[:2])
    assert torch.equal(eng._out_lps[0, :2], g_lp[:2])
    assert torch.equal(eng.cache.length, g_len)
    assert torch.equal(eng.cache.k[:, 1:], g_k[:, 1:])
    assert not torch.equal(g_k[:, 1:], snap[0][:, 1:])


@pytest.mark.parametrize('name', ['mla-debug', 'deepseek-moe-debug'])
def test_mla_paged_step_captures_into_a_graph(cuda, name):
    """The plain MLA paged decode step (the latent family has no kernel:
    its absorbed attention is plain PyTorch on every device, as in JAX)
    has no host sync: captured into a CUDA graph on random bf16 weights
    and replayed from the same pool, it gives the eager step's logits,
    latent pages and lengths bit for bit, with one row inactive and one
    writing the view's last position."""
    from skypilot_tpu_torch.models import mla
    cfg = config.MLA_PRESETS[name]
    params = mla.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                             cuda, dtype=cfg.dtype)
    b, psz, maxp = 3, 16, 4
    max_len = psz * maxp
    pool = mla.init_page_pool(cfg, b * maxp + 1, psz, b, maxp, device=cuda)
    pool.table.copy_(torch.arange(1, b * maxp + 1, dtype=torch.int32,
                                  device=cuda).reshape(b, maxp))
    gen = torch.Generator(device=cuda).manual_seed(1)
    _, cs, krs = mla.prefill(params, torch.randint(
        0, cfg.vocab_size, (b, 32), generator=gen, device=cuda,
        dtype=torch.int32), cfg, max_len)
    paging.scatter_prefill(pool, cs, krs, torch.arange(b, device=cuda), 32,
                           torch.tensor([7, 32, 20], dtype=torch.int32,
                                        device=cuda))
    pool.length[1] = max_len - 1
    tok = torch.tensor([5, 9, 11], dtype=torch.int32, device=cuda)
    active = torch.tensor([True, True, False], device=cuda)
    state = (pool.c_kv, pool.k_rope, pool.length)
    snap = [t.clone() for t in state]

    def step():
        return mla.paged_decode_step(params, tok, pool, cfg, max_len=max_len,
                                     active=active)[0]

    want = step().clone()
    want_state = [t.clone() for t in state]
    for t, v in zip(state, snap):
        t.copy_(v)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        step()                          # warm up on the capture stream
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = step()
    for t, v in zip(state, snap):
        t.copy_(v)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    assert torch.equal(pool.length, want_state[2])
    assert torch.equal(pool.c_kv[:, 1:], want_state[0][:, 1:])
    assert torch.equal(pool.k_rope[:, 1:], want_state[1][:, 1:])
    assert not torch.equal(pool.c_kv[:, 1:], snap[0][:, 1:])


@pytest.mark.parametrize('name', ['moe-debug', 'deepseek-moe-debug'])
def test_family_train_step_on_card_matches_cpu(cuda, name):
    """One train step (CE + router aux, then AdamW) of an MoE and an MLA
    family preset in fp32 from the same weights and batch on the card
    and on the CPU: loss and grad norm within rtol 1e-4, and every
    leaf's grad elementwise within 1e-4 of the leaf's largest (cuBLAS
    and the CPU sum in other orders; TF32 is off). fp32 takes the plain
    attention on the card (the kernels are bf16)."""
    from skypilot_tpu_torch.models import module_for
    cfg = dataclasses.replace(config.get_config(name), dtype=torch.float32,
                              attention_impl='xla', remat='full')
    host = module_for(cfg).init_params(cfg, torch.Generator().manual_seed(0),
                                       'cpu')
    tokens = torch.randint(0, cfg.vocab_size, (2, 65),
                           generator=torch.Generator().manual_seed(1))
    out = {}
    for dev in ('cpu', 'cuda'):
        # Copies: the step updates its params in place.
        params = {k: ({n: t.clone().to(dev) for n, t in v.items()}
                      if isinstance(v, dict) else v.clone().to(dev))
                  for k, v in host.items()}
        leaves = train_lib.leaves(params)
        for leaf in leaves:
            leaf.requires_grad_(True)
        tok = tokens.to(dev)
        logits, aux = train_lib.forward_with_aux(cfg, params, tok[:, :-1])
        loss, _ = train_lib.cross_entropy_loss(logits, tok[:, 1:])
        grads = [g.cpu() for g in torch.autograd.grad(loss + aux, leaves)]
        tx = train_lib.default_optimizer(warmup_steps=0, total_steps=10)
        state = train_lib.init_train_state(cfg, tx, dev, params=params)
        _, m = train_lib.make_train_step(cfg, tx)(state, {'tokens': tok})
        out[dev] = (float(m['loss']), float(m['grad_norm']), grads)
    (l_c, n_c, g_c), (l_g, n_g, g_g) = out['cpu'], out['cuda']
    np.testing.assert_allclose([l_g, n_g], [l_c, n_c], rtol=1e-4)
    for (path, _), a, b in zip(weights.tree_paths(host), g_g, g_c):
        scale = float(b.abs().max())
        assert scale > 0, path
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4 * scale,
                                   msg=path)


def test_moe_1b_attention_shape_launches_a_c_d(cuda):
    """moe-1b's attention (dim 1024, 8/4 heads, head_dim 128) under its
    routed FFN, cut to 2 layers with a narrow vocab and experts: one
    train step with remat 'full' launches A twice a layer (forward and
    recompute) and C and D once; loss and grad norm finite."""
    cfg = dataclasses.replace(config.get_config('moe-1b'), n_layers=2,
                              vocab_size=512, ffn_dim=256)
    assert cfg.remat == 'full' and cfg.hd == 128
    tx = train_lib.default_optimizer(warmup_steps=0, total_steps=10)
    state = train_lib.init_train_state(
        cfg, tx, cuda, generator=torch.Generator(device=cuda).manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (2, 257), device=cuda,
                           generator=torch.Generator(device=cuda)
                           .manual_seed(1))
    build.reset_launches()
    _, m = train_lib.make_train_step(cfg, tx)(state, {'tokens': tokens})
    torch.cuda.synchronize()
    n = cfg.n_layers
    assert {k: v.launches for k, v in build.kernels().items()} == \
        {'flash_fwd': 2 * n, 'flash_dq': n, 'flash_dkv': n,
         'paged_decode': 0}
    assert np.isfinite(float(m['loss'])) and np.isfinite(float(m['grad_norm']))


def _eager_greedy(decode_mod, params, cfg, prompt, lengths, n, max_len):
    """Greedy tokens from an eager decode_step loop over the contiguous
    cache: the reference for generate's replayed graph."""
    logits, cache = decode_mod.prefill_cache(params, prompt, cfg, max_len,
                                             lengths=lengths)
    toks = [torch.argmax(logits, -1).to(torch.int32)]
    for _ in range(n - 1):
        logits, cache = decode_mod.decode_step(params, toks[-1], cache, cfg)
        toks.append(torch.argmax(logits, -1).to(torch.int32))
    return torch.stack(toks, 1)


def test_generate_graph_replay_equals_eager_steps(cuda):
    """decode.generate on the card: the prefill through kernel A (once a
    layer), the steps one CUDA graph replayed with the plain attention
    (no kernel captured); its greedy tokens on ragged rows equal an eager
    decode_step loop's, and the graph's sampled tokens follow their
    generator (one seed twice: the same; two seeds: not)."""
    cfg, params = _hd128_model(cuda)
    params = decode.cast_params_for_decode(params, cfg)
    gen = torch.Generator(device=cuda).manual_seed(4)
    prompt = torch.randint(0, cfg.vocab_size, (4, 48), generator=gen,
                           device=cuda, dtype=torch.int32)
    lengths = torch.tensor([48, 17, 30, 5], dtype=torch.int32, device=cuda)
    a0, cap0 = fa.KERNEL.launches, build.captured()
    got = decode.generate(params, prompt, cfg, 24, max_len=80,
                          prompt_lengths=lengths)
    assert fa.KERNEL.launches - a0 == cfg.n_layers
    assert build.captured() == cap0
    want = _eager_greedy(decode, params, cfg, prompt, lengths, 24, 80)
    assert torch.equal(got, want)

    def sample(seed):
        return decode.generate(
            params, prompt, cfg, 16, max_len=80, prompt_lengths=lengths,
            temperature=1.0, top_k=50, top_p=0.95,
            generator=torch.Generator(device=cuda).manual_seed(seed))
    assert torch.equal(sample(1), sample(1))
    assert not torch.equal(sample(1), sample(2))


@pytest.mark.parametrize('name', ['mla-debug', 'deepseek-moe-debug'])
def test_mla_generate_graph_replay_equals_eager_steps(cuda, name):
    """mla.generate on the card replays its captured step; greedy tokens
    equal an eager mla.decode_step loop's."""
    from skypilot_tpu_torch.models import mla
    cfg = config.MLA_PRESETS[name]
    params = mla.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                             cuda, dtype=cfg.dtype)
    gen = torch.Generator(device=cuda).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (3, 32), device=cuda,
                           generator=gen, dtype=torch.int32)
    lengths = torch.tensor([32, 9, 20], dtype=torch.int32, device=cuda)
    got = mla.generate(params, prompt, cfg, 12, max_len=64,
                       prompt_lengths=lengths)
    want = _eager_greedy(mla, params, cfg, prompt, lengths, 12, 64)
    assert torch.equal(got, want)


def test_int8_engine_burst(cuda):
    """The engine with quantize='int8' (fp32 masters quantized at load)
    captures its step graphs with the dequant inside and kernel B a
    layer a step, and serves a burst of concurrent greedy requests to
    their length."""
    from skypilot_tpu_torch.serve import engine as engine_lib
    cfg, params = _hd128_model(cuda)
    eng = engine_lib.InferenceEngine('llama-debug', cfg=cfg, params=params,
                                     device='cuda', quantize='int8')
    assert isinstance(eng.params['layers']['wq'], decode.QuantizedWeight)
    eng.spec_k = 0
    eng.warmup()
    for (k, _, _), n in eng._graph_launches.items():
        assert n == {'paged_decode': k * cfg.n_layers}
    prompts = [[3, 1, 4, 1, 5], list(range(40)), [9] * 20, [7] * 33]
    b0 = pa.KERNEL.launches
    eng.start()
    try:
        futs = [eng.submit(p, 16) for p in prompts]
        burst = [f.result(timeout=300)[0] for f in futs]
    finally:
        eng.stop()
    assert all(len(t) == 16 and max(t) < cfg.vocab_size for t in burst)
    assert pa.KERNEL.launches > b0
