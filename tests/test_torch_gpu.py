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
    pool = _rand(gen, 3, 16, 2, 64)
    table = torch.zeros((1, 2), dtype=torch.int32, device=cuda)
    length = torch.zeros((1,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        pa.paged_decode_attention(_rand(gen, 1, 1, 4, 64), pool, pool, table,
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
    pc = paging.PagedKV(kp0.clone(), vp0.clone(), table, length)
    pid, off = paging._write_indices(
        pc, length[:, None].long() + torch.arange(s, device=cuda),
        torch.tensor([True, True, False], device=cuda))
    kw = dict(max_len=max_len, **{
        n: (v.to(cuda) if torch.is_tensor(v) else v)
        for n, v in switches.items()})

    def call():
        return pa.paged_attention_step_ref(q, pc.k, pc.v, table, length,
                                           k_new, v_new, pid, off, **kw)[0]

    want = call().clone()
    want_k, want_v = pc.k.clone(), pc.v.clone()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        call()                          # warm up on the capture stream
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = call()
    pc.k.copy_(kp0)
    pc.v.copy_(vp0)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    assert torch.equal(pc.k[1:], want_k[1:])
    assert torch.equal(pc.v[1:], want_v[1:])
    assert not torch.equal(pc.k[1:], kp0[1:])    # the step wrote pages


def test_engine_decodes_through_graphs(cuda, monkeypatch):
    """The engine on the card: warm-up captures all eight step variants
    with kernel B inside (k launches a layer each), decode calls only
    replay them (nothing captured after warm-up, B's count rises by the
    captured launches per replay), and greedy tokens at MAX_STEP_CHUNK 8
    equal those at 1, one request at a time (the same shapes every
    step)."""
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
