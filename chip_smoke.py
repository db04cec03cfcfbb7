"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is swallowed):
  1. build     — nvcc-build every kernel from skypilot_tpu_torch/csrc/
                 for sm_90a, one nvcc per source, all at once;
  2. flash     — kernel A vs its plain version at llama-1b shapes, and
                 at gemma-7b's head_dim 256 (16/16 heads; causal and
                 not, ragged S, S=2048);
  3. paged     — kernel B vs its plain version at llama-1b decode shapes
                 and at g*S up to 64 (g = 7 and 8), rows ending on the
                 split's page and chunk edges, two calls bit-equal; then
                 the same at head_dim 256: gemma-7b decode (g = 1),
                 gemma2-9b heads (g = 2) up to S = 8, g*S = 64, page
                 sizes 40, 64, 72 and 128 (pages over 64 tokens stream
                 in halves: rows end on a half's edge too);
  4. flash_bwd — kernels C (dq) and D (dk, dv) vs the plain backward:
                 GQA groups 1, 2, 4, both causal settings, ragged S,
                 D=64, an lse cotangent, llama-1b heads at S=2048, and
                 D=256 (groups 1, 2; S 100, 130, 300; gemma-7b's heads
                 at S=2048); two launches of each case bit-equal;
  5. timing    — each kernel's launch alone, its plain version's and
                 one library call's times (CUDA events, medians) beside
                 the kernel's bound and its share of it; kernel A at the
                 serve (B=2) and train (B=4) shapes; A's and B's
                 wrappers; B at other chunk counts; A and B again at
                 gemma-7b's head_dim 256 (A: B=2, S=T=2048, H=KH=16;
                 B: B=8, S=1, H=KH=16, psz 64, the same ragged rows);
                 C and D at gemma-7b's train shape (B=2, S=T=2048,
                 H=KH=16, D=256) beside SDPA's backward by backend;
  6. model     — llama-1b (full width, random bf16 weights) prefill + 8
                 paged decode steps through the kernels vs the plain path;
                 then a verify step of 8 tokens with 2 kv heads (g*S =
                 64) through kernel B vs the plain path;
  7. serve     — the port's engine on llama-1b: warm-up must capture
                 the 8 decode-step variants as CUDA graphs (k x layers
                 B launches each); a burst of 4 concurrent /generate
                 requests and 2 streamed /v1/completions (one with both
                 penalties, one with logprobs=5); kernels A and B must
                 launch, nothing is captured after warm-up; TTFT, TPOT,
                 tok/s, device calls by width, peak memory; the burst
                 again under torch.profiler for the idle share, time by
                 kernel and B's launches counted on the device (equal
                 to captured launches x replays); then, the loop
                 stopped, one k=1 greedy replay against the eager step
                 and two sampled replays that must differ;
  8. model_gemma — gemma-7b at full width (28 layers, dim 3072, 16/16
                 heads, hd 256, vocab 256000; random bf16 weights from
                 seed 0, ~17.1 GB): prefill + 8 paged decode steps
                 through kernels A and B vs the plain and fp32 paths;
  9. serve_gemma — the port's engine on gemma-7b, checked as in serve;
 10. gemma_switches — gemma2-9b (2 layers) and gemma3-12b (6 layers:
                 one global) at full width: prefill + decode on the
                 card vs fp32, with kernels A and B launched zero times
                 (softcaps, windows: the plain route, as in JAX);
 11. train_gemma — the port's trainer on gemma-7b at full width cut to
                 4 layers, 4 steps of 2 x 2048 tokens: A twice and C, D
                 once per layer per step at head_dim 256; peak memory;
                 grads against the plain and fp32 paths, the loss
                 against the plain-attention trainer; one step under
                 torch.profiler; then one step each of gemma2-9b (2
                 layers) and gemma3-12b (6 layers) with no kernel
                 launched, their grads against fp32;
 12. train     — the port's trainer on llama-1b at full width, 6 steps
                 of 4 x 2048 tokens: A twice and C, D once per layer per
                 step; grads against the plain and fp32 paths, the loss
                 against the plain-attention trainer, a resume at step
                 3; one step under torch.profiler.
Then it prints the card's name and power limit, one {"kernels": [...]}
line, and as its last line {"ok": true, "device": {...}}.

It imports nothing of JAX and nothing of the JAX package. Without a
CUDA device, or without the skypilot_tpu_torch package beside it, it
exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import socket
import statistics
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, 'chiprun_out')

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, HBM3.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# Tolerances: kernel output vs the plain version computed in fp32 on the
# same bf16 inputs (prescaled_fp32). o: |o - ref| <= TOL_O + ULP_O*|ref|
# elementwise. TOL_O covers the kernel's rounding of probabilities to
# bf16 before P V; ULP_O*|ref| is one bf16 ulp of the output itself,
# whose own rounding alone exceeds 1e-2 once |o| >= 4 (half an ulp is
# 1.56e-2 there). lse: fp32 statistics on both sides.
TOL_O = 1e-2
ULP_O = 2.0 ** -8
TOL_LSE = 1e-3
# Model path: the kernel bf16 path's max |logit error| against the fp32
# path, over the plain bf16 path's. Both bf16 paths carry bf16 rounding
# through 16 layers (about 6e-2 of the logits' std at the max, measured
# on an H100); the kernels may add at most a quarter to it.
TOL_MODEL = 1.25

FLASH_CASES = [(16, True), (100, True), (512, True), (2048, True),
               (512, False)]
# Backward kernels: each grad's max|err| / max|ref| against the plain
# backward in fp32 on the same bf16 inputs, the JAX package's own bound
# for its backward kernels (tests/unit_tests/test_flash_attention.py).
# The kernels round p and ds to bf16 before their products (2^-9
# relative each), as the TPU kernels do.
TOL_BWD = 2e-2
# (B, S=T, H, KH, D, causal, nonzero lse cotangent): GQA groups 1, 2, 4;
# ragged S; both causal settings; D=64; llama-1b heads at S=2048; then
# D=256 (the Gemma family): groups 1 and 2, ragged S (odd-S lse and
# delta rows), both causal settings, an lse cotangent, gemma-7b's heads
# at S=2048.
BWD_CASES = [(1, 100, 4, 4, 128, True, False),
             (2, 130, 4, 2, 128, False, False),
             (1, 256, 8, 2, 128, True, True),
             (1, 200, 4, 1, 64, True, False),
             (1, 300, 4, 2, 64, False, True),
             (1, 2048, 16, 8, 128, True, False),
             (1, 100, 4, 4, 256, True, False),
             (2, 130, 4, 2, 256, False, True),
             (1, 300, 8, 4, 256, True, True),
             (1, 300, 4, 4, 256, False, False),
             (2, 2048, 16, 16, 256, True, False)]
# The kernels each main path must launch.
SERVE_KERNELS = ('flash_fwd', 'paged_decode')
# Kernel A at head_dim 256 (gemma-7b's heads, 16/16): (B, S=T, H, KH,
# causal) — ragged S, both causal settings, a GQA group, S=2048.
FLASH256_CASES = [(2, 16, 16, 16, True), (2, 100, 16, 16, True),
                  (1, 130, 16, 16, False), (2, 512, 16, 16, True),
                  (1, 300, 16, 8, False), (1, 2048, 16, 16, True)]
TRAIN_KERNELS = ('flash_fwd', 'flash_dq', 'flash_dkv')
# Train phase: llama-1b at full width, batch 4 x 2048, 6 steps.
TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_WARMUP = 4, 2048, 6, 2
# Grads: per leaf, the kernel bf16 path's relative error (Frobenius)
# against an fp32 plain-attention run of the same weights and batch,
# over the plain bf16 path's: bf16 rounding through 16 layers dominates
# both; the kernels may add at most a quarter to it (as TOL_MODEL).
TOL_GRAD = 1.25
# Loss trajectory, kernel path vs the plain-attention path, both bf16:
# |loss difference| per step, absolute, on a loss of ~10.4 (ln 32768):
# 1e-3 relative, the bf16 rounding of the logits' inputs.
TOL_LOSS = 1e-2
# Resume at step 3 vs the uninterrupted run, steps 4-6: the same
# arithmetic but for the embedding backward's atomics on the card, whose
# order changes from run to run; the trainer logs losses to 4 decimals.
TOL_RESUME = 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f'FAIL: {msg}', file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, iters: int = 20, repeats: int = 5) -> float:
    """Median per-call milliseconds over ``repeats`` runs of ``iters``
    calls, timed with CUDA events after a warm-up."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        samples.append(start.elapsed_time(end) / iters)
    return statistics.median(samples)


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def o_ok(o, ref) -> bool:
    """Elementwise |o - ref| <= TOL_O + ULP_O * |ref|, all finite."""
    o, ref = o.float(), ref.float()
    return bool(((o - ref).abs() <= TOL_O + ULP_O * ref.abs()).all()) and \
        bool(o.isfinite().all())


def prescaled_fp32(q, *rest):
    """The kernels' inputs as the plain version sees them in fp32: q
    pre-scaled by head_dim**-0.5 and rounded to bf16 (as both kernels
    and the JAX reference do), everything then upcast. Call the plain
    version on these with softmax_scale=1.0."""
    qs = (q * q.shape[-1] ** -0.5).to(q.dtype)
    return (qs.float(), *(t.float() for t in rest))


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_build(build) -> dict:
    t0 = time.perf_counter()
    logs = build.build_all()
    secs = time.perf_counter() - t0
    log(f'[build] {len(build.kernels())} kernels ready in {secs:.1f}s '
        f'(built now: {sorted(logs)})')
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, 'ptxas.txt'), 'w') as f:
        for name, text in logs.items():
            f.write(f'== {name}\n{text}\n')
    for name, text in logs.items():
        for line in text.splitlines():
            if 'registers' in line or 'spill' in line:
                log(f'[build] {name}: {line.strip()}')
    return logs


def flash_inputs(torch, b, s, h, kh, d, seed):
    g = torch.Generator(device='cuda').manual_seed(seed)
    shape_q, shape_kv = (b, s, h, d), (b, s, kh, d)
    q = torch.randn(shape_q, generator=g, device='cuda').bfloat16()
    k = torch.randn(shape_kv, generator=g, device='cuda').bfloat16()
    v = torch.randn(shape_kv, generator=g, device='cuda').bfloat16()
    return q, k, v


def phase_flash(torch, fa) -> dict:
    worst = 0.0
    cases = [(2, s, 16, 8, 128, causal) for s, causal in FLASH_CASES] + \
        [(b, s, h, kh, 256, causal) for b, s, h, kh, causal in FLASH256_CASES]
    for i, (b, s, h, kh, d, causal) in enumerate(cases):
        q, k, v = flash_inputs(torch, b, s, h, kh, d, seed=100 + i)
        before = fa.KERNEL.launches
        o, lse = fa.flash_attention_lse(q, k, v, causal=causal)
        qf, kf, vf = prescaled_fp32(q, k, v)
        o_ref, lse_ref = fa.flash_attention_ref(qf, kf, vf, causal=causal,
                                                softmax_scale=1.0)
        torch.cuda.synchronize()
        eo, el = max_err(o, o_ref), max_err(lse, lse_ref)
        ok = o_ok(o, o_ref) and el <= TOL_LSE and \
            fa.KERNEL.launches == before + 1
        where = f'D={d} B={b} S=T={s} H={h} KH={kh} causal={causal}'
        log(f'[flash] {where}: o err {eo:.3e} (tol {TOL_O} + 2^-8|o|), lse '
            f'err {el:.3e} (tol {TOL_LSE}) {"ok" if ok else "MISMATCH"}')
        if not ok:
            fail(f'flash kernel disagrees at {where}')
        worst = max(worst, eo)
    return {'max_abs_err': worst}


def bwd_inputs(torch, fa, b, s, h, kh, d, causal, with_dlse, seed):
    """The backward kernels' inputs: q pre-scaled and rounded to bf16,
    k, v, do random bf16, o and lse from kernel A, dlse random or None."""
    q, k, v = flash_inputs(torch, b, s, h, kh, d, seed)
    qs = (q * d ** -0.5).bfloat16()
    o, lse = fa._fwd(qs, k, v, causal)
    g = torch.Generator(device='cuda').manual_seed(seed + 1)
    do = torch.randn(q.shape, generator=g, device='cuda').bfloat16()
    dlse = (torch.randn(lse.shape, generator=g, device='cuda')
            if with_dlse else None)
    return qs, k, v, o, lse, do, dlse


def phase_flash_bwd(torch, fa) -> dict:
    """Kernels C (dq) and D (dk, dv) vs the plain backward computed in
    fp32 on the same bf16 inputs: max|err| / max|ref| < TOL_BWD for each
    grad; then both kernels again on each case's inputs, bit-equal (each
    grad element is written once by one block, with no atomics)."""
    worst = {'flash_dq': 0.0, 'flash_dkv': 0.0}
    for i, (b, s, h, kh, d, causal, with_dlse) in enumerate(BWD_CASES):
        qs, k, v, o, lse, do, dlse = bwd_inputs(torch, fa, b, s, h, kh, d,
                                                causal, with_dlse,
                                                seed=200 + i)
        got = fa._bwd(qs, k, v, o, lse, do, dlse, causal)
        again = fa._bwd(qs, k, v, o, lse, do, dlse, causal)
        ref = fa.flash_attention_bwd_ref(qs.float(), k.float(), v.float(),
                                         o.float(), lse, do.float(), dlse,
                                         causal=causal)
        torch.cuda.synchronize()
        rel = []
        for name, a, r in zip(('dq', 'dk', 'dv'), got, ref):
            if not bool(a.isfinite().all()):
                fail(f'flash backward: non-finite {name} in case {i}')
            rel.append(max_err(a, r) / float(r.abs().max()))
        same = all(torch.equal(a, a2) for a, a2 in zip(got, again))
        ok = max(rel) < TOL_BWD
        log(f'[flash_bwd] B={b} S=T={s} H={h} KH={kh} D={d} causal={causal}'
            f' dlse={with_dlse}: max|err|/max|ref| dq {rel[0]:.3e} dk '
            f'{rel[1]:.3e} dv {rel[2]:.3e} (tol {TOL_BWD}) '
            f'{"ok" if ok else "MISMATCH"}; two launches '
            f'{"bit-equal" if same else "DIFFER"}')
        if not ok:
            fail(f'flash backward kernels disagree in case {i}')
        if not same:
            fail(f'flash backward kernels are not deterministic in case {i}')
        worst['flash_dq'] = max(worst['flash_dq'], max_err(got[0], ref[0]))
        worst['flash_dkv'] = max(worst['flash_dkv'], max_err(got[1], ref[1]),
                                 max_err(got[2], ref[2]))
        del got, again, ref
    return worst


# Kernel B's cases, (S, H, KH): llama-1b's heads (g = 2) at S = 1 and
# 4, then more than 16 q rows per kv head: g = 7 (qwen2-7b's group) at
# S = 3 and 5, and g = 8 (llama3-70b's) at S = 8, g*S = 64, the limit.
PAGED_CASES = [(1, 16, 8), (4, 16, 8), (3, 28, 4), (5, 28, 4), (8, 32, 4)]
# At head_dim 256, (S, H, KH, psz): gemma-7b decode (g = 1) at pages of
# 64 and 128; gemma2-9b's heads (g = 2) at S 1, 4, 8; g*S 21 and 64
# (two ring slots); pages of 40 (padded tiles) and 72 (padded halves).
PAGED256_CASES = [(1, 16, 16, 64), (1, 16, 16, 128), (1, 16, 8, 64),
                  (4, 16, 8, 128), (8, 16, 8, 64), (3, 28, 4, 64),
                  (8, 32, 4, 128), (1, 16, 16, 40), (4, 16, 8, 72)]


def paged_inputs(torch, pa, paging, s, seed, h=16, kh=8, edges=False,
                 hd=128, psz=64):
    """llama-1b decode shapes (B=8, psz 64, max_pages 32; ``hd`` and
    ``psz`` may differ): ragged lengths (one row of length 0), shuffled
    page ids, table tails 0, the step's K/V written first. ``edges``
    also sets the rows that end where the kernel's split changes hands:
    row 5 ends inside its first page, row 6 exactly on a page and chunk
    boundary, row 7 one key past one; at head_dim 256 with pages over 64
    tokens (streamed in halves), row 4 ends on the first half of its
    second page."""
    b, maxp = 8, 32
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, maxp * psz - s, size=b)
    lengths[3] = 0
    if edges:
        _, per = pa.split_pages(b, kh, maxp, pa._sm_count(0), hd)
        lengths[5] = 40 - s
        lengths[6] = per * psz - s
        lengths[7] = per * psz + 1 - s
        if hd == 256 and psz > 64:
            lengths[4] = psz + psz // 2 - s
    n_pages = b * maxp + 1
    perm = rng.permutation(np.arange(1, n_pages))
    table = np.zeros((b, maxp), np.int32)
    used = 0
    for r in range(b):
        n = paging.pages_for(int(lengths[r]) + s, psz)
        table[r, :n] = perm[used:used + n]
        used += n
    g = torch.Generator(device='cuda').manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device='cuda').bfloat16()

    kp, vp = rnd(n_pages, psz, kh, hd), rnd(n_pages, psz, kh, hd)
    q, k_new, v_new = rnd(b, s, h, hd), rnd(b, s, kh, hd), rnd(b, s, kh, hd)
    table_t = torch.from_numpy(table).cuda()
    length_t = torch.from_numpy(lengths.astype(np.int32)).cuda()
    pcache = paging.PagedKV(k=kp[None], v=vp[None], table=table_t,
                            length=length_t)
    pos = length_t[:, None].long() + torch.arange(s, device='cuda')
    pid, off = paging._write_indices(pcache, pos)
    pa.write_pages(kp, k_new, pid, off)
    pa.write_pages(vp, v_new, pid, off)
    return q, kp, vp, table_t, length_t, lengths


def phase_paged(torch, pa, paging) -> dict:
    """Kernel B vs its plain version in every PAGED_CASE, with the split's
    edge rows; two calls of each case must be bit-equal (the partials
    merge in a fixed order)."""
    worst = 0.0
    cases = [(s, h, kh, 128, 64) for s, h, kh in PAGED_CASES] + \
        [(s, h, kh, 256, psz) for s, h, kh, psz in PAGED256_CASES]
    for i, (s, h, kh, hd, psz) in enumerate(cases):
        q, kp, vp, table, length, lengths = paged_inputs(
            torch, pa, paging, s, seed=7 + s + i, h=h, kh=kh, edges=True,
            hd=hd, psz=psz)
        out = pa.paged_decode_attention(q, kp, vp, table, length)
        again = pa.paged_decode_attention(q, kp, vp, table, length)
        qf, kf, vf = prescaled_fp32(q, kp, vp)
        ref = pa.paged_decode_attention_ref(qf, kf, vf, table, length,
                                            softmax_scale=1.0)
        torch.cuda.synchronize()
        e = max_err(out, ref)
        ok = o_ok(out, ref)
        same = torch.equal(out, again)
        where = f'hd={hd} psz={psz} S={s} H={h} KH={kh}'
        log(f'[paged] {where} (g*S={h // kh * s}) lengths '
            f'{lengths.tolist()}: out err {e:.3e} (tol {TOL_O} + '
            f'2^-8|o|) {"ok" if ok else "MISMATCH"}; two calls '
            f'{"bit-equal" if same else "DIFFER"}')
        if not ok:
            fail(f'paged kernel disagrees at {where}')
        if not same:
            fail(f'paged kernel is not deterministic at {where}')
        worst = max(worst, e)
    return {'max_abs_err': worst}


def sdpa_gqa(torch, q, k, v, **kw):
    """One SDPA call on [B, H, S, D] tensors with grouped kv heads."""
    import torch.nn.functional as F
    return F.scaled_dot_product_attention(q, k, v, enable_gqa=True, **kw)


# Kernel A is timed at the serve shape (B=2) and at the train shape
# (B=4); C and D at the train shape. All S=T=2048, H=16, KH=8, D=128,
# causal, bf16 (llama-1b's heads).
FWD_TIMING_B = (2, 4)
BWD_TIMING_B = 4
TIMING_SHAPE = dict(s=2048, h=16, kh=8, d=128)
# Kernels A and B at gemma-7b's heads (16/16, head_dim 256): A at the
# serve shape; B at B's llama-1b timing rows (B=8, S=1, psz 64,
# max_pages 32, the same ragged lengths); C and D at the train_gemma
# phase's batch (B=2: the same FLOPs as the B=4, D=128 shape).
TIMING_SHAPE_256 = dict(s=2048, h=16, kh=16, d=256)
BWD_TIMING_B_256 = 2


def fwd_launch(torch, fa, b, shape=TIMING_SHAPE):
    """Kernel A's inputs at batch ``b`` and a callable that launches the
    kernel alone on pre-scaled q, as C and D are launched."""
    s, h, kh, d = (shape[x] for x in ('s', 'h', 'kh', 'd'))
    q, k, v = flash_inputs(torch, b, s, h, kh, d, seed=1)
    qs = (q * d ** -0.5).bfloat16()
    o = torch.empty_like(qs)
    lse = torch.empty((b, h, s), dtype=torch.float32, device='cuda')
    args = (qs.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b, s, s, h, kh, d, 1,
            torch.cuda.current_stream().cuda_stream)
    held = (qs, o, lse)    # the closure holds every tensor in args
    return (q, k, v), lambda: (held, fa.KERNEL.launch(*args))


def bwd_launches(torch, fa, b=BWD_TIMING_B, shape=TIMING_SHAPE):
    """Kernels C and D's inputs at batch ``b`` and ``shape`` (o and lse
    from kernel A, delta from the delta op) and a callable launching
    each alone."""
    s, h, kh, d = (shape[x] for x in ('s', 'h', 'kh', 'd'))
    qs, k, v, o, lse, do, _ = bwd_inputs(torch, fa, b, s, h, kh, d, True,
                                         False, seed=2)
    delta = fa._delta(o, do, None)
    dq, dk, dv = torch.empty_like(qs), torch.empty_like(k), torch.empty_like(v)
    ptrs = (qs.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr())
    dims = (b, s, s, h, kh, d, 1, torch.cuda.current_stream().cuda_stream)
    return ((qs, k, v, o, lse, do),
            lambda: fa.DQ_KERNEL.launch(*ptrs, dq.data_ptr(), *dims),
            lambda: fa.DKV_KERNEL.launch(*ptrs, dk.data_ptr(), dv.data_ptr(),
                                         *dims))


def paged_launch(torch, pa, paging, **heads):
    """Kernel B's inputs at the timing shape (B=8, S=1, llama-1b heads or
    ``heads`` (h, kh, hd), psz 64, max_pages 32, ragged) and a callable
    that launches the kernel alone."""
    inputs = paged_inputs(torch, pa, paging, 1, seed=8, **heads)
    q, kp, vp, table, length, _ = inputs
    return inputs, pa.kernel_call(q, kp, vp, table, length)[1]


def paged_launch_at(torch, pa, q, kp, vp, table, length, chunks):
    """Kernel B's launch with the pages split over ``chunks`` blocks a
    (row, kv head) instead of the wrapper's choice: (out, a callable
    that launches into out). For the split's variants only."""
    b, s, h, hd = q.shape
    psz, kh, maxp = kp.shape[1], kp.shape[2], table.shape[1]
    per = -(-maxp // chunks)
    chunks = -(-maxp // per)
    stream = torch.cuda.current_stream().cuda_stream
    floats, tickets = pa.workspace_sizes(b, kh, h // kh * s, chunks, hd)
    work, ticket = pa._workspace(q.device, stream, floats, tickets)
    out = torch.empty_like(q)
    held = (q, kp, vp, table, length, out, work, ticket)
    args = tuple(t.data_ptr() for t in held) + (
        work.numel(), ticket.numel(), b, s, h, kh, hd, psz, maxp, chunks,
        per, hd ** -0.5, stream)
    return out, lambda: (held, pa.KERNEL.launch(*args))


def kernel_ms(torch, fa, pa, paging, paged=paged_launch) -> dict:
    """Each kernel's launch alone, in ms (kernel_ab.py compares two
    checkouts with it; ``paged`` makes kernel B's inputs and launch),
    and A and B at head_dim 256 where the checkout serves it."""
    out = {f'flash_fwd B={b}': time_ms(fwd_launch(torch, fa, b)[1])
           for b in FWD_TIMING_B}
    out['paged_decode'] = time_ms(paged(torch, pa, paging)[1], iters=100)
    _, dq, dkv = bwd_launches(torch, fa)
    out[f'flash_dq B={BWD_TIMING_B}'] = time_ms(dq)
    out[f'flash_dkv B={BWD_TIMING_B}'] = time_ms(dkv)
    if 256 in getattr(fa, 'FWD_HEAD_DIMS', ()):
        out['flash_fwd hd256'] = time_ms(
            fwd_launch(torch, fa, FWD_TIMING_B[0], TIMING_SHAPE_256)[1])
        out['paged_decode hd256'] = time_ms(
            paged(torch, pa, paging, h=16, kh=16, hd=256)[1], iters=100)
    if 256 in getattr(fa, 'BWD_HEAD_DIMS', ()):
        _, dq, dkv = bwd_launches(torch, fa, BWD_TIMING_B_256,
                                  TIMING_SHAPE_256)
        out['flash_dq hd256'] = time_ms(dq)
        out['flash_dkv hd256'] = time_ms(dkv)
    return out


def fwd_flops_bytes(b, s, h, kh, d):
    """Causal forward: 2 products of 2*B*H*S*T*D/2 FLOPs; q, k, v in,
    o and lse out, each once."""
    return (4 * b * h * s * s * d / 2,
            2 * (2 * b * s * h * d + 2 * b * s * kh * d) + 4 * b * h * s)


def time_fwd(torch, fa, b, shape) -> dict:
    """Kernel A's launch alone at batch ``b`` and ``shape``, beside its
    wrapper, its plain version and SDPA."""
    s, h, kh, d = (shape[x] for x in ('s', 'h', 'kh', 'd'))
    (q, k, v), launch = fwd_launch(torch, fa, b, shape)
    ms = time_ms(launch)
    wrapper = time_ms(lambda: fa.flash_attention_lse(q, k, v, causal=True))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    lib = time_ms(lambda: sdpa_gqa(torch, qt, kt, vt, is_causal=True))
    plain = time_ms(lambda: fa.flash_attention_ref(q, k, v, causal=True),
                    iters=3)
    row = dict(ms=ms, plain_ms=plain, library_ms=lib,
               **bound(*fwd_flops_bytes(b, s, h, kh, d)),
               shape=f'B={b} S=T={s} H={h} KH={kh} D={d} causal bf16')
    log(f'[timing] flash_fwd {row["shape"]}: wrapper flash_attention_lse '
        f'(q pre-scale pass + kernel) {wrapper:.4f} ms')
    return row


def time_paged(torch, pa, paging, h, kh, hd) -> dict:
    """Kernel B's launch alone at B=8, S=1, psz 64, max_pages 32 and the
    ragged timing rows, beside its wrapper, its plain version and SDPA
    over pre-gathered pages; then the same launch at other chunk counts,
    each twice (bit-equal) and held to the fp32 plain version."""
    (q, kp, vp, table, length, lengths), launch = paged_launch(
        torch, pa, paging, h=h, kh=kh, hd=hd)
    ms = time_ms(launch, iters=100)
    wrapper = time_ms(lambda: pa.paged_decode_attention(q, kp, vp, table,
                                                        length), iters=100)
    plain = time_ms(lambda: pa.paged_decode_attention_ref(q, kp, vp, table,
                                                          length), iters=5)
    max_len = table.shape[1] * kp.shape[1]
    k_l = pa.gather_pages(kp, table, max_len).transpose(1, 2).contiguous()
    v_l = pa.gather_pages(vp, table, max_len).transpose(1, 2).contiguous()
    scale = q.shape[-1] ** -0.5
    qs = (q * scale).bfloat16().transpose(1, 2).contiguous()
    pos = torch.arange(max_len, device='cuda')
    mask = (pos[None, :] <= length[:, None])[:, None, None, :]
    lib = time_ms(lambda: sdpa_gqa(torch, qs, k_l, v_l, attn_mask=mask,
                                   scale=1.0), iters=100)
    del k_l, v_l
    b8, s1 = q.shape[0], q.shape[1]
    toks = int(np.sum(lengths + s1))
    nbytes = 2 * 2 * toks * kh * hd + 2 * 2 * b8 * s1 * h * hd + \
        4 * (table.numel() + b8)
    flops = 4 * toks * s1 * h * hd
    chunks, per = pa.split_pages(b8, kh, table.shape[1], pa._sm_count(0), hd)
    log(f'[timing] paged_decode hd={hd}: wrapper paged_decode_attention '
        f'(checks + launch) {wrapper:.4f} ms; kernel {nbytes / ms / 1e6:.1f} '
        f'GB/s; grid {chunks} chunks x KH {kh} x B {b8} = '
        f'{chunks * kh * b8} blocks, {per} pages a chunk')
    qf, kf, vf = prescaled_fp32(q, kp, vp)
    ref = pa.paged_decode_attention_ref(qf, kf, vf, table, length,
                                        softmax_scale=1.0)
    del qf, kf, vf
    for n in sorted({1, 2, 4, 8, 16, 32, chunks}):
        out_n, launch_n = paged_launch_at(torch, pa, q, kp, vp, table,
                                          length, n)
        launch_n()
        first = out_n.clone()
        ms_n = time_ms(launch_n, iters=100)
        same = torch.equal(first, out_n)
        e = max_err(out_n, ref)
        mark = " (the split's choice)" if n == chunks else ''
        log(f'[timing] paged_decode hd={hd} at {n} chunks{mark}: '
            f'{ms_n:.4f} ms; err vs fp32 plain {e:.4e}; launches '
            f'{"bit-equal" if same else "DIFFER"}')
        if not same or not o_ok(out_n, ref):
            fail(f'paged kernel hd={hd} at {n} chunks: bit-equal {same}, '
                 f'err {e}')
    return dict(ms=ms, plain_ms=plain, library_ms=lib, **bound(flops, nbytes),
                shape=f'B={b8} S={s1} H={h} KH={kh} hd={hd} psz=64 '
                      f'max_pages=32 ragged ({toks} K/V tokens) bf16')


def phase_timing(torch, fa, pa, paging) -> dict:
    """Times at the largest main-path shapes of phases 2, 3 and 4, each
    kernel by its launch alone: llama-1b's heads (A at the serve and
    train batches), then A and B at gemma-7b's (head_dim 256)."""
    res = {}
    for b in FWD_TIMING_B:
        # The serve-shape row is the kernel's row in the kernels line.
        res['flash_fwd' if b == FWD_TIMING_B[0] else f'flash_fwd B={b}'] = \
            time_fwd(torch, fa, b, TIMING_SHAPE)
    res['paged_decode'] = time_paged(torch, pa, paging, 16, 8, 128)
    res.update(time_flash_bwd(torch, fa))
    res['flash_fwd hd256'] = time_fwd(torch, fa, FWD_TIMING_B[0],
                                      TIMING_SHAPE_256)
    res['paged_decode hd256'] = time_paged(torch, pa, paging, 16, 16, 256)
    res.update({f'{n} hd256': r for n, r in time_flash_bwd(
        torch, fa, BWD_TIMING_B_256, TIMING_SHAPE_256).items()})
    for name, r in res.items():
        log(f'[timing] {name} {r["shape"]}: kernel {r["ms"]:.4f} ms, '
            f'plain {r["plain_ms"]:.4f} ms, library {r["library_ms"]:.4f} '
            f'ms, bound {r["bound_ms"]:.4f} ms ({r["bound_by"]}), '
            f'{r["bound_ms"] / r["ms"]:.1%} of bound')
    return res


def sdpa_bwd_backends(torch, qt, kt, vt, go) -> dict:
    """SDPA's whole backward (dq, dk, dv) on [B, H, S, D] tensors, timed
    under each backend that takes it: {backend name: ms}."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    out = {}
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION):
        try:
            with sdpa_kernel([backend]):
                o = F.scaled_dot_product_attention(
                    qt, kt, vt, enable_gqa=True, is_causal=True, scale=1.0)
                out[backend.name] = time_ms(lambda: torch.autograd.grad(
                    o, (qt, kt, vt), go, retain_graph=True))
        except RuntimeError as e:
            log(f'[timing] SDPA backend {backend.name} refused: '
                f'{str(e).splitlines()[0][:120]}')
    return out


def time_flash_bwd(torch, fa, b=BWD_TIMING_B, shape=TIMING_SHAPE) -> dict:
    """Kernels C and D at batch ``b`` and ``shape`` (by default llama-1b
    training: B=4, S=T=2048, H=16, KH=8, D=128; causal, bf16), each
    launched alone on inputs that kernel A and the delta op made. The
    plain backward and SDPA's backward compute dq, dk and dv in one
    call: their times are the pair's and stand on both rows. SDPA runs
    under each backend that takes it; the fastest is the row's library
    time, named."""
    s, h, kh, d = (shape[x] for x in ('s', 'h', 'kh', 'd'))
    (qs, k, v, o, lse, do), launch_dq, launch_dkv = bwd_launches(
        torch, fa, b, shape)
    ms_dq = time_ms(launch_dq)
    ms_dkv = time_ms(launch_dkv)
    plain = time_ms(lambda: fa.flash_attention_bwd_ref(qs, k, v, o, lse, do,
                                                       causal=True), iters=3)
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (qs, k, v))
    go = do.transpose(1, 2).contiguous()
    libs = sdpa_bwd_backends(torch, qt, kt, vt, go)
    log(f'[timing] SDPA backward at D={d}: ' + ', '.join(
        f'{n} {ms:.4f} ms' for n, ms in libs.items()))
    lib_name = min(libs, key=libs.get) if libs else None
    # Matrix-product FLOPs, halved for causal: dq 3 products (s, dp,
    # ds k), dkv 4 (s, dp, p^T do, ds^T q), each 2*B*H*S*T*D.
    prod = 2 * b * h * s * s * d / 2
    n_in = 2 * (2 * b * s * h * d + 2 * b * s * kh * d) + 4 * 2 * b * h * s
    shape = f'B={b} S=T={s} H={h} KH={kh} D={d} causal bf16'
    lib = dict(library_ms=libs.get(lib_name), library=f'SDPA {lib_name}')
    return {
        'flash_dq': dict(ms=ms_dq, plain_ms=plain, shape=shape, **lib,
                         **bound(3 * prod, n_in + 2 * b * s * h * d)),
        'flash_dkv': dict(ms=ms_dkv, plain_ms=plain, shape=shape, **lib,
                          **bound(4 * prod, n_in + 4 * b * s * kh * d))}


def bound(flops: float, nbytes: float) -> dict:
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return {'bound_ms': max(t_ops, t_bytes),
            'bound_by': 'operations' if t_ops >= t_bytes else 'bytes'}


# The model phases' prompts: four rows of ragged lengths, right-padded
# to one bucket, over a pool of 64-token pages of max_len positions.
MODEL_SHAPE = dict(lengths=[200, 256, 130, 17], bucket=256, max_len=512)
# Prompts past gemma3-12b's 1024-token window, so that it masks.
LONG_SHAPE = dict(lengths=[1300, 2048, 700, 17], bucket=2048, max_len=2176)
MODEL_PSZ = 64


def model_prompts(torch, vocab: int, rng, shape=MODEL_SHAPE):
    """Random tokens for shape's lengths, zero-padded to its bucket, and
    the lengths, on the card."""
    lengths = shape['lengths']
    tokens = np.zeros((len(lengths), shape['bucket']), np.int32)
    for r, n in enumerate(lengths):
        tokens[r, :n] = rng.integers(0, vocab, size=n)
    return (torch.from_numpy(tokens).cuda(),
            torch.tensor(lengths, dtype=torch.int32, device='cuda'))


def prefilled_pool(torch, decode, paging, params, cfg, tok_t, len_t,
                   impl: str, shape=MODEL_SHAPE):
    """Prefill the prompts (attention ``impl``) and scatter their K/V
    into a fresh page pool, each row's pages after the last's: (the
    prefill logits, the pool)."""
    b = tok_t.shape[0]
    max_len = shape['max_len']
    maxp = paging.pages_for(max_len, MODEL_PSZ)
    logits, ks, vs = decode.prefill(params, tok_t, cfg, max_len,
                                    lengths=len_t, attention_impl=impl)
    pc = decode.init_page_pool(cfg, b * maxp + 1, MODEL_PSZ, b, maxp,
                               device='cuda')
    pc.table.copy_(torch.arange(1, b * maxp + 1, dtype=torch.int32,
                                device='cuda').reshape(b, maxp))
    paging.scatter_prefill(pc, ks, vs, torch.arange(b, device='cuda'),
                           shape['bucket'], len_t)
    return logits, pc


def phase_model(torch, cfg, params, decode, paging, pa, build, name,
                shape=MODEL_SHAPE, kernels=True) -> float:
    """Prefill + 8 paged decode steps three ways, teacher-forced with the
    default path's greedy tokens: bf16 by the default routing (through
    kernels A and B where the config lets them serve), bf16 through the
    plain attention, and fp32 through the plain attention on the same
    weights upcast. Both bf16 paths round activations at different
    points, so the check is that the default path lies no farther from
    the fp32 path than the plain bf16 path does (TOL_MODEL). The default
    path must launch A once a layer and B once a layer a step, or
    (``kernels`` False: a softcap or a window on every layer) neither.
    Returns the worst error ratio."""
    import dataclasses
    steps = 8
    tok_t, len_t = model_prompts(torch, cfg.vocab_size,
                                 np.random.default_rng(5), shape)

    def run(cfg_run, params_run, plain: bool, feed=None):
        logits, pc = prefilled_pool(torch, decode, paging, params_run,
                                    cfg_run, tok_t, len_t,
                                    'xla' if plain else 'auto', shape)
        fn = pa.paged_attention_step_ref if plain else \
            pa.paged_attention_step
        out, toks = [logits], []
        for i in range(steps):
            nxt = (feed[i] if feed is not None
                   else torch.argmax(out[-1], dim=-1).to(torch.int32))
            toks.append(nxt)
            logits, pc = decode.paged_decode_step(
                params_run, nxt, pc, cfg_run, max_len=shape['max_len'],
                attention_fn=fn)
            out.append(logits)
        return out, toks

    build.reset_launches()
    kern, toks = run(cfg, params, False)
    launches = {n: build.kernels()[n].launches for n in SERVE_KERNELS}
    want = ({'flash_fwd': cfg.n_layers, 'paged_decode': cfg.n_layers * steps}
            if kernels else {'flash_fwd': 0, 'paged_decode': 0})
    if launches != want:
        fail(f'model path {name}: launches {launches}, want {want}')
    plain, _ = run(cfg, params, True, feed=toks)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    params32 = decode.cast_params_for_decode(params, cfg32)
    ref, _ = run(cfg32, params32, True, feed=toks)
    del params32
    torch.cuda.synchronize()
    worst = 0.0
    for i, (a, p, f) in enumerate(zip(kern, plain, ref)):
        if not bool(torch.isfinite(a).all()) or \
                a.shape != (len(shape['lengths']), cfg.vocab_size):
            fail(f'model path {name}: bad logits at step {i}')
        std = float(f.std())
        e_k = float((a - f).abs().max()) / std
        e_p = float((p - f).abs().max()) / std
        e_kp = float((a - p).abs().max()) / std
        worst = max(worst, e_k / e_p)
        # Not checked: the same ratio over all logits (Frobenius), which
        # the max of one logit's error does not show.
        fro = float((a - f).norm()) / float((p - f).norm())
        log(f'[model] {name} step {i} ({"prefill" if i == 0 else "decode"}):'
            f' max|diff|/std(fp32 logits): default-fp32 {e_k:.3e}, '
            f'plain-fp32 {e_p:.3e}, default-plain {e_kp:.3e}; Frobenius '
            f'ratio {fro:.3f}')
    if worst > TOL_MODEL:
        fail(f'model path {name}: default-path error {worst:.2f}x the plain '
             f'bf16 error > {TOL_MODEL}x')
    log(f'[model] {name} {cfg.n_layers} layers, {len(shape["lengths"])} '
        f'rows, prefill bucket {shape["bucket"]} + {steps} decode steps, '
        f'launches {launches}: default/plain error ratio worst '
        f'{worst:.3f} (tol {TOL_MODEL}) ok')
    return worst


def phase_verify(torch, cfg, decode, llama, paging, pa) -> None:
    """paged_verify_step at S = 8 on a g = 8 head layout (llama-1b with 2
    kv heads: 64 q rows per kv head, kernel B's limit), three ways as in
    phase_model: bf16 through kernel B, bf16 through the plain attention,
    fp32 through the plain attention on the same weights upcast. Every
    path prefills through the plain attention, so the pools agree and
    the verify step is the only place they part. Kernel B must launch
    once a layer, and its path lie no farther from fp32 than the plain
    bf16 path does (TOL_MODEL)."""
    import dataclasses
    cfg8 = dataclasses.replace(cfg, n_kv_heads=2)
    params = decode.cast_params_for_decode(
        llama.init_params(cfg8, torch.Generator(device='cuda').manual_seed(3),
                          'cuda'), cfg8)
    k = 8
    rng = np.random.default_rng(6)
    tok_t, len_t = model_prompts(torch, cfg8.vocab_size, rng)
    b = tok_t.shape[0]
    ver_t = torch.from_numpy(rng.integers(0, cfg8.vocab_size, size=(b, k))
                             .astype(np.int32)).cuda()

    def run(cfg_run, params_run, plain: bool):
        _, pc = prefilled_pool(torch, decode, paging, params_run, cfg_run,
                               tok_t, len_t, 'xla')
        before = pa.KERNEL.launches
        logits, _ = decode.paged_verify_step(
            params_run, ver_t, pc, cfg_run, max_len=MODEL_SHAPE['max_len'],
            attention_fn=(pa.paged_attention_step_ref if plain
                          else pa.paged_attention_step))
        return logits, pa.KERNEL.launches - before

    kern, n_kern = run(cfg8, params, False)
    plain, _ = run(cfg8, params, True)
    cfg32 = dataclasses.replace(cfg8, dtype=torch.float32)
    ref, _ = run(cfg32, decode.cast_params_for_decode(params, cfg32), True)
    torch.cuda.synchronize()
    if n_kern != cfg8.n_layers:
        fail(f'verify step launched kernel B {n_kern} times, not '
             f'{cfg8.n_layers}')
    if kern.shape != (b, k, cfg8.vocab_size) or \
            not bool(torch.isfinite(kern).all()):
        fail(f'verify step: bad logits {tuple(kern.shape)}')
    std = float(ref.std())
    e_k = float((kern - ref).abs().max()) / std
    e_p = float((plain - ref).abs().max()) / std
    log(f'[model] verify step, llama-1b heads 16/2 (g=8), S={k}, g*S='
        f'{8 * k}, {cfg8.n_layers} layers: kernel B launched {n_kern}x; '
        f'max|diff|/std(fp32 logits): kernel-fp32 {e_k:.3e}, plain-fp32 '
        f'{e_p:.3e}, ratio {e_k / e_p:.3f} (tol {TOL_MODEL})')
    if e_k / e_p > TOL_MODEL:
        fail(f'verify step: kernel error {e_k / e_p:.2f}x the plain bf16 '
             f'error > {TOL_MODEL}x')


def free_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def http(url: str, doc=None, timeout: float = 600.0):
    data = json.dumps(doc).encode() if doc is not None else None
    req = urllib.request.Request(url, data=data,
                                 headers={'Content-Type': 'application/json'})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b'{}')


def sse(url: str, doc, timeout: float = 600.0) -> list:
    """POST a streaming request; the JSON of every event before the
    final ``data: [DONE]``, which must be there."""
    req = urllib.request.Request(url, data=json.dumps(doc).encode(),
                                 headers={'Content-Type': 'application/json'})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        if r.status != 200 or r.headers['Content-Type'] != \
                'text/event-stream':
            fail(f'stream answered {r.status} {r.headers["Content-Type"]}')
        events = [e for e in r.read().decode().split('\n\n') if e]
    if not events or events[-1] != 'data: [DONE]':
        fail(f'stream did not end with data: [DONE]: {events[-2:]}')
    return [json.loads(e[len('data: '):]) for e in events[:-1]]


# Graph replay vs the eager step: the same kernels on the same inputs,
# so they are expected bit-equal; a library may pick another algorithm
# under capture, so logprobs (chosen and top-5, fp32, from bf16
# activations) may differ by up to half a bf16 ulp of a logit near 4.
TOL_GRAPH = 1e-2


def check_graph_replay(torch, eng, engine_lib, decode, build, tag) -> dict:
    """With the batch loop stopped, on one state of four admitted rows:
    one replay of the k=1 greedy top-logprobs graph against the eager
    paged_decode_step + sampler (tokens exactly, logprobs to TOL_GRAPH),
    then two replays of the sampled k=MAX_STEP_CHUNK graph from the same
    state at a flat distribution, which must draw different tokens."""
    rng = np.random.default_rng(12)
    reqs = [engine_lib.Request(rng.integers(0, 256, n).tolist(), 64)
            for n in (17, 100, 250, 40)]
    for group in eng._admit_groups(reqs):
        eng._admit_group(group)
    rows = [i for i, s in enumerate(eng.slots) if eng._row_active(s)]
    act = torch.zeros(eng.max_batch, dtype=torch.bool, device='cuda')
    act[rows] = True
    snap = [t.clone() for t in (eng.cache.length, eng.last_dev, eng.counts)]

    def restore() -> None:
        for t, v in zip((eng.cache.length, eng.last_dev, eng.counts), snap):
            t.copy_(v)

    def replay(k: int, want_tops: bool):
        key = (k, False, want_tops)
        if key not in eng.graphs:
            fail(f'{tag} variant {key} was not captured')
        b0, cap0 = build.kernels()['paged_decode'].launches, build.captured()
        h = eng._dispatch_step(k, want_tops_force=want_tops)
        h.event.synchronize()
        eng._inflight.remove(h)
        if build.captured() != cap0 or \
                build.kernels()['paged_decode'].launches - b0 != \
                eng._graph_launches[key]['paged_decode']:
            fail(f'{tag} dispatch of {key} did not replay its graph')
        return [x.clone() for x in (h.toks, h.lps, h.tis, h.tvs)
                if x is not None]

    zf = torch.zeros(eng.max_batch, device='cuda')
    with torch.no_grad():
        logits, _ = decode.paged_decode_step(
            eng.params, snap[1].clone(), eng.cache, eng.cfg,
            max_len=eng.max_len, active=act)
        tok = decode.select_token_per_row(logits, zf, zf.int(), zf, None)
        tok = torch.where(act, tok, snap[1])
        lp = decode.chosen_logprob(logits, tok)
        tv, ti = decode.top_k_logprobs(logits, engine_lib.TOP_LOGPROBS_K)
    torch.cuda.synchronize()
    restore()
    g_tok, g_lp, g_ti, g_tv = replay(1, True)
    tok, lp, ti, tv = (x.cpu()[rows] for x in (tok, lp, ti, tv))
    g_tok, g_lp, g_ti, g_tv = (x[0, rows] for x in (g_tok, g_lp, g_ti, g_tv))
    err = max(max_err(g_lp, lp), max_err(g_tv, tv))
    if not torch.equal(g_tok, tok) or not torch.equal(g_ti, ti) or \
            err > TOL_GRAPH:
        fail(f'{tag} k=1 graph vs eager step: tokens {g_tok.tolist()} vs '
             f'{tok.tolist()}, top ids equal {torch.equal(g_ti, ti)}, '
             f'logprob error {err:.3e} (tol {TOL_GRAPH})')
    # A temperature that flattens the distribution: random weights give
    # peaked logits (gemma-7b's rows draw one token at temperature 1).
    eng.temp[rows] = 1e6
    eng._samp_dirty = True
    restore()
    first = replay(eng.step_chunk, False)[0][:, rows]
    restore()
    second = replay(eng.step_chunk, False)[0][:, rows]
    if torch.equal(first, second):
        fail(f'{tag} two replays of the sampled k={eng.step_chunk} graph '
             f'drew the same tokens: {first.tolist()}')
    eng._reset_device_state()
    out = {'graph_vs_eager_max_logprob_err': err,
           'sampled_replays_differ': int((first != second).sum())}
    log(f'{tag} k=1 greedy graph replay == eager step on {len(rows)} rows '
        f'(tokens and top-5 ids exact, logprobs max|diff| {err:.3e}, tol '
        f'{TOL_GRAPH}); two replays of the sampled k={eng.step_chunk} graph '
        f'differ in {out["sampled_replays_differ"]} of {first.numel()} '
        f'tokens')
    return out


def phase_serve(torch, model, cfg, params, engine_lib, build,
                decode) -> dict:
    """The port's engine on preset ``model`` with ``params``: /health
    (warm-up captures the eight step variants as CUDA graphs), then one
    burst of 4 concurrent /generate requests, one penalized and one
    logprobs=5 streaming /v1/completions request (kernels A and B must
    launch, B's launches inside graph replays), then the burst again
    under the profiler, whose kernel events count B's launches on the
    device; then, with the loop stopped, a graph replay against the
    eager step. Returns the launch counts of the first burst (warm-up
    included)."""
    tag = '[serve]' if model == 'llama-1b' else f'[serve {model}]'
    torch.cuda.reset_peak_memory_stats()
    eng = engine_lib.InferenceEngine(model, params=params, device='cuda',
                                     seed=0)
    server = engine_lib.build_app(eng, '127.0.0.1', free_port())
    port = server.server_address[1]
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    base = f'http://127.0.0.1:{port}'
    try:
        # The main path starts here: every launch count from 0.
        build.reset_launches()
        eng.start()
        t0 = time.perf_counter()
        while True:
            code, doc = http(base + '/health')
            if code == 200:
                break
            if code != 503 or time.perf_counter() - t0 > 600:
                fail(f'/health never came up: {code} {doc}')
            time.sleep(0.1)
        want = {(k, p, t) for k in (1, engine_lib.MAX_STEP_CHUNK)
                for p in (False, True) for t in (False, True)}
        if set(eng.graphs) != want:
            fail(f'{tag} warm-up captured {sorted(eng.graphs)}, not {want}')
        per_graph = {key: n.get('paged_decode', 0)
                     for key, n in eng._graph_launches.items()}
        if any(n != key[0] * cfg.n_layers for key, n in per_graph.items()):
            fail(f'{tag} captured B launches {per_graph}: want k x '
                 f'{cfg.n_layers} layers')
        log(f'{tag} /health ok after {time.perf_counter() - t0:.1f}s '
            f'(warm-up captured {len(eng.graphs)} graphs, B launches '
            f'captured per graph {per_graph}): {doc}')
        rng = np.random.default_rng(11)
        max_new = 32
        reqs = [{'text': 'The quick brown f', 'max_new_tokens': max_new}]
        for n in (130, 300, 700):
            reqs.append({'tokens': rng.integers(0, 256, size=n).tolist(),
                         'max_new_tokens': max_new})
        streams = [
            {'prompt': rng.integers(0, 256, size=60).tolist(),
             'max_tokens': 48, 'temperature': 0, 'presence_penalty': 0.5,
             'frequency_penalty': 0.5, 'logprobs': 0, 'ignore_eos': True,
             'stream': True},
            {'prompt': 'Once upon a time', 'max_tokens': 40,
             'temperature': 0.8, 'top_p': 0.9, 'logprobs': 5,
             'ignore_eos': True, 'stream': True}]

        def check_stream(d, events) -> None:
            lps = [e['choices'][0]['logprobs'] for e in events
                   if e['choices'][0]['logprobs'] is not None]
            if len(lps) != d['max_tokens'] or \
                    events[-1]['choices'][0]['finish_reason'] != 'length' \
                    or not all(np.isfinite(lp['token_logprobs'][0])
                               for lp in lps):
                fail(f'bad stream for {d}: {events[-3:]}')
            if d['logprobs'] and not all(
                    lp['top_logprobs'][0] and all(
                        np.isfinite(v) and v <= 0
                        for v in lp['top_logprobs'][0].values())
                    for lp in lps):
                fail(f'stream without top logprobs: {lps[:2]}')

        def burst() -> float:
            """Send every request at once, check every answer; seconds."""
            t1 = time.perf_counter()
            with concurrent.futures.ThreadPoolExecutor(
                    len(reqs) + len(streams)) as ex:
                futs = [ex.submit(http, base + '/generate', d) for d in reqs]
                sfuts = [ex.submit(sse, base + '/v1/completions', d)
                         for d in streams]
                answers = [f.result() for f in futs]
                for d, f in zip(streams, sfuts):
                    check_stream(d, f.result())
            secs = time.perf_counter() - t1
            for d, (code, doc) in zip(reqs, answers):
                n_in = len(d.get('tokens', d.get('text', '')))
                if code != 200:
                    fail(f'/generate ({n_in} tokens) answered {code}: {doc}')
                toks = doc['tokens']
                if len(toks) != max_new or doc['finish_reason'] != 'length' \
                        or not all(0 <= t < cfg.vocab_size for t in toks) \
                        or len(doc['logprobs']) != max_new \
                        or not all(np.isfinite(doc['logprobs'])):
                    fail(f'bad answer for a {n_in}-token prompt: {doc}')
                if 'text' in d and 'text' not in doc:
                    fail('text request answered without text')
            return secs

        at_health = {n: k.launches for n, k in build.kernels().items()}
        captured = build.captured()
        calls0 = dict(eng.calls)
        wall = burst()
        launches = {n: k.launches for n, k in build.kernels().items()}
        in_burst = {n: launches[n] - at_health[n] for n in launches}
        calls = {key: n - calls0.get(key, 0) for key, n in eng.calls.items()
                 if n > calls0.get(key, 0)}
        log(f'{tag} 4 /generate (17/130/300/700 tokens, {max_new} new) + '
            f'2 streamed /v1/completions (penalized 48, logprobs=5 40) '
            f'answered in {wall:.3f}s; launches since 0 {launches}, in the '
            f'burst {in_burst}; device calls by (k, penalties, top '
            f'logprobs) {sorted(calls.items())}')
        for name in SERVE_KERNELS:
            if in_burst[name] == 0:
                fail(f'kernel {name} was never launched while serving')
        if not any(key[1] for key in calls) or \
                not any(key[2] for key in calls):
            fail(f'{tag} the burst ran no penalized or no top-logprobs '
                 f'call: {calls}')
        timings = list(eng.timings)
        ttft = [t[0] for t in timings]
        tpot = [t[1] for t in timings]
        n_tok = sum(t[2] for t in timings)
        by_k = {}
        for key, n in calls.items():
            by_k[key[0]] = by_k.get(key[0], 0) + n
        stats = {'requests': len(timings),
                 'ttft_ms_median': statistics.median(ttft) * 1e3,
                 'ttft_ms_max': max(ttft) * 1e3,
                 'tpot_ms_median': statistics.median(tpot) * 1e3,
                 'tok_per_s': n_tok / wall,
                 'decode_steps': eng.step_count,
                 'device_calls_by_k': by_k,
                 'graph_replays': sum(calls.values())}
        # The same burst again under the profiler: how much of the wall
        # time the card spends running kernels, and kernel B's launches
        # counted on the device (the engine's count, captured launches
        # x replays, must agree). Not the timed burst: the profiler
        # slows the host.
        b0 = build.kernels()['paged_decode'].launches
        prof = profile_device(torch, burst)
        b_engine = build.kernels()['paged_decode'].launches - b0
        b_device = prof['kernel_counts'].get('paged_decode', 0)
        log(f'{tag} profiled burst: kernel B launched {b_device}x on the '
            f'device (profiler kernel events), {b_engine}x by the engine\'s '
            f'count (captured launches x replays)')
        if b_device == 0 or b_device != b_engine:
            fail(f'{tag} kernel B on the device {b_device}x, by the engine '
                 f'{b_engine}x')
        if build.captured() != captured:
            fail(f'{tag} a kernel was captured after warm-up: '
                 f'{build.captured()} vs {captured}')
        stats.update(idle_share=prof['idle_share'],
                     b_launches_device=b_device,
                     peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        log(f'{tag} ' + json.dumps(stats))
        eng.stop()
        check_graph_replay(torch, eng, engine_lib, decode, build, tag)
        return launches
    finally:
        server.shutdown()
        server.server_close()
        eng.stop()


def train_checked(torch, build, tcfg, cfg, tag: str):
    """The port's trainer with ``tcfg`` from launch counts of 0: with
    remat 'full', kernel A twice and C and D once per layer per step
    (none where the config takes the plain route); finite losses and
    grad norms; ms/step and tokens/s; peak memory; then the
    plain-attention trainer's losses within TOL_LOSS. Returns (the
    history, the launch counts)."""
    import dataclasses
    from skypilot_tpu_torch.train import trainer
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    hist = trainer.train(tcfg)
    launches = {n: k.launches for n, k in build.kernels().items()}
    peak = torch.cuda.max_memory_allocated() / 1e9
    layers, n = cfg.n_layers, tcfg.total_steps
    want = {'flash_fwd': 2 * layers * n, 'flash_dq': layers * n,
            'flash_dkv': layers * n, 'paged_decode': 0}
    log(f'{tag} {tcfg.model}, {layers} layers, remat {cfg.remat}, batch '
        f'{tcfg.batch_size}x{tcfg.seq_len}, {n} steps: launches {launches} '
        f'(want {want}); peak memory {peak:.2f} GB')
    if launches != want:
        fail(f'{tag} launches {launches} != {want}')
    for r in hist:
        log(f'{tag} {json.dumps(r)}')
        if not (np.isfinite(r['loss']) and np.isfinite(r['grad_norm'])):
            fail(f'{tag} step {r["step"]}: non-finite loss or grad norm')
    sec = statistics.median(r['sec_per_step'] for r in hist[1:])
    log(f'{tag} {sec * 1e3:.1f} ms/step (median of steps 2-{n}), '
        f'{tcfg.batch_size * tcfg.seq_len / sec:.0f} tokens/s')

    plain = trainer.train(dataclasses.replace(
        tcfg, model_overrides={**tcfg.model_overrides,
                               'attention_impl': 'xla'}))
    diff = max(abs(a['loss'] - b['loss']) for a, b in zip(hist, plain))
    log(f'{tag} loss, kernels vs plain attention: '
        f'{[r["loss"] for r in hist]} vs {[r["loss"] for r in plain]}, '
        f'max |diff| {diff:.4f} (tol {TOL_LOSS})')
    if diff > TOL_LOSS:
        fail(f'{tag} loss departs from the plain path by {diff}')
    return hist, launches


def phase_train(torch, build) -> dict:
    """The port's trainer on llama-1b at full width (16 layers, dim
    2048, vocab 32768, tied embeddings, remat 'full'): TRAIN_STEPS steps
    of batch TRAIN_B x TRAIN_S on the synthetic corpus, through the
    kernels (train_checked), a resume at step 3 (TOL_RESUME), one
    step's grads against the plain bf16 and fp32 paths (TOL_GRAD), one
    step profiled. Returns the main run's launch counts."""
    import dataclasses
    import shutil
    from skypilot_tpu_torch import config
    from skypilot_tpu_torch.train import trainer
    cfg = config.get_config('llama-1b')
    tcfg = trainer.TrainerConfig(
        model='llama-1b', batch_size=TRAIN_B, seq_len=TRAIN_S,
        total_steps=TRAIN_STEPS, warmup_steps=TRAIN_WARMUP, log_every=1,
        device='cuda')
    hist, launches = train_checked(torch, build, tcfg, cfg, '[train]')

    ck = os.path.join(HERE, '.smoke_ckpt')
    shutil.rmtree(ck, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        trainer.train(dataclasses.replace(tcfg, total_steps=3, ckpt_dir=ck,
                                          ckpt_every=3))
        resumed = trainer.train(dataclasses.replace(tcfg, ckpt_dir=ck,
                                                    ckpt_every=3))
        secs = time.perf_counter() - t0
    finally:
        shutil.rmtree(ck, ignore_errors=True)
    if [r['step'] for r in resumed] != list(range(4, TRAIN_STEPS + 1)):
        fail(f'resume ran steps {[r["step"] for r in resumed]}')
    diff = max(abs(a['loss'] - b['loss']) for a, b in zip(hist[3:], resumed))
    log(f'[train] resume at step 3 (save, restore, 3 more steps: '
        f'{secs:.1f}s): losses {[r["loss"] for r in resumed]}, max |diff| '
        f'vs uninterrupted {diff:.4f} (tol {TOL_RESUME})')
    if diff > TOL_RESUME:
        fail(f'resumed run departs from the uninterrupted one by {diff}')

    # One step's grads three ways on the trainer's initial weights and
    # first batch, then that step under the profiler.
    params, batch = first_step(torch, cfg, TRAIN_B)
    check_grads(torch, cfg, params, batch, '[train]')
    profile_step(torch, cfg, params, batch)
    return launches


def first_step(torch, cfg, batch_size: int):
    """The trainer's initial weights (seed 0, fp32 master, on the card,
    requiring grad) and its first batch of ``batch_size`` x TRAIN_S."""
    from skypilot_tpu_torch.data import loader
    from skypilot_tpu_torch.data_service import spec as spec_lib
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.train import train_lib
    params = llama.init_params(cfg, torch.Generator(device='cuda')
                               .manual_seed(0), 'cuda')
    for leaf in train_lib.leaves(params):
        leaf.requires_grad_(True)
    source = spec_lib.load_source(spec_lib.DatasetSpec(
        batch_size, TRAIN_S, cfg.vocab_size))
    return params, loader.to_device(source.batch_at_step(0), 'cuda')


def profile_step(torch, cfg, params, batch) -> None:
    """One train step on ``params`` and ``batch`` (run once first, so
    that nothing is built inside the window) under the profiler: the
    card's idle share and where its time goes."""
    from skypilot_tpu_torch.train import train_lib
    tx = train_lib.default_optimizer(warmup_steps=TRAIN_WARMUP)
    state = train_lib.init_train_state(cfg, tx, 'cuda', params=params)
    step_fn = train_lib.make_train_step(cfg, tx)
    step_fn(state, batch)
    profile_device(torch, lambda: step_fn(state, batch))


def check_grads(torch, cfg, params, batch, tag: str) -> float:
    """One step's grads three ways on ``params`` and ``batch``: the
    default route (bf16; through the kernels where the config lets
    them), plain attention in bf16, plain attention in fp32. Per leaf,
    the default route's relative error (Frobenius) against fp32 may be
    at most TOL_GRAD times the plain bf16 path's. Returns the worst
    ratio."""
    import dataclasses
    from skypilot_tpu_torch.models import llama, weights
    from skypilot_tpu_torch.train import train_lib
    leaves = train_lib.leaves(params)

    def grads(cfg_run):
        tokens = batch['tokens']
        logits = llama.forward(params, tokens[:, :-1], cfg_run)
        loss, _ = train_lib.cross_entropy_loss(logits, tokens[:, 1:])
        del logits
        return torch.autograd.grad(loss, leaves, allow_unused=True)

    g_kern = grads(cfg)
    g_plain = grads(dataclasses.replace(cfg, attention_impl='xla'))
    g_ref = grads(dataclasses.replace(cfg, attention_impl='xla',
                                      dtype=torch.float32))
    names = [p for p, _ in weights.tree_paths(params)]
    worst = 0.0
    for name, gk, gp, gr in zip(names, g_kern, g_plain, g_ref):
        if gk is None or not bool(gk.isfinite().all()):
            fail(f'{tag} grad of {name}: missing or non-finite')
        ref_norm = float(gr.norm())
        e_k = float((gk - gr).norm()) / ref_norm
        e_p = float((gp - gr).norm()) / ref_norm
        worst = max(worst, e_k / e_p)
        log(f'{tag} grad {name}: |err|/|fp32| default {e_k:.3e}, plain '
            f'{e_p:.3e}, ratio {e_k / e_p:.3f}')
    if worst > TOL_GRAD:
        fail(f'{tag} grads: default-route error {worst:.2f}x the plain bf16 '
             f'error > {TOL_GRAD}x')
    log(f'{tag} grads of all {len(names)} leaves: default/plain error '
        f'ratio worst {worst:.3f} (tol {TOL_GRAD}) ok')
    return worst


# train_gemma: gemma-7b at full width cut to 4 layers (~1.89 B params,
# 18 bytes a param of master, moments, grads and bf16 copies, ~34 GB,
# before the fp32 logits at vocab 256000), batch 2 x 2048, 4 steps; then
# one step each of gemma2-9b and gemma3-12b at SWITCH_DEPTHS, batch 1.
GEMMA_TRAIN_LAYERS, GEMMA_TRAIN_B, GEMMA_TRAIN_STEPS = 4, 2, 4


def phase_train_gemma(torch, build) -> dict:
    """The port's trainer on gemma-7b (full width, GEMMA_TRAIN_LAYERS
    layers, remat 'full'; kernels A, C and D at head_dim 256) through
    train_checked, one step's grads against the plain bf16 and fp32
    paths (TOL_GRAD), one step profiled. No checkpoint is written (the
    format is held on the CPU). Then one trainer step each of gemma2-9b
    and gemma3-12b (a softcap or a window on every layer: the plain
    route, as in JAX), with zero kernel launches, and their grads
    against fp32. Returns gemma-7b's launch counts."""
    import dataclasses
    from skypilot_tpu_torch import config
    from skypilot_tpu_torch.train import trainer
    cfg = dataclasses.replace(config.get_config('gemma-7b'),
                              n_layers=GEMMA_TRAIN_LAYERS)
    tcfg = trainer.TrainerConfig(
        model='gemma-7b', model_overrides={'n_layers': GEMMA_TRAIN_LAYERS},
        batch_size=GEMMA_TRAIN_B, seq_len=TRAIN_S,
        total_steps=GEMMA_TRAIN_STEPS, warmup_steps=TRAIN_WARMUP,
        log_every=1, device='cuda')
    free_card(torch)
    log(f'[train_gemma] {torch.cuda.memory_allocated() / 1e9:.2f} GB held '
        f'by earlier phases')
    _, launches = train_checked(torch, build, tcfg, cfg, '[train_gemma]')
    params, batch = first_step(torch, cfg, GEMMA_TRAIN_B)
    check_grads(torch, cfg, params, batch, '[train_gemma]')
    profile_step(torch, cfg, params, batch)
    del params, batch
    free_card(torch)

    for name, depth in SWITCH_DEPTHS.items():
        tag = f'[train_gemma {name}]'
        build.reset_launches()
        rec = trainer.train(trainer.TrainerConfig(
            model=name, model_overrides={'n_layers': depth}, batch_size=1,
            seq_len=TRAIN_S, total_steps=1, warmup_steps=TRAIN_WARMUP,
            log_every=1, device='cuda'))[0]
        got = {k: v.launches for k, v in build.kernels().items()}
        log(f'{tag} {depth} layers, batch 1x{TRAIN_S}, one step: '
            f'{json.dumps(rec)}; launches {got}')
        if any(got.values()):
            fail(f'{tag} launched kernels {got}: its layers take the plain '
                 f'route')
        if not (np.isfinite(rec['loss']) and np.isfinite(rec['grad_norm'])):
            fail(f'{tag} non-finite loss or grad norm')
        cfg_s = dataclasses.replace(config.get_config(name), n_layers=depth)
        params, batch = first_step(torch, cfg_s, 1)
        check_grads(torch, cfg_s, params, batch, tag)
        del params, batch
        free_card(torch)
    return launches


# Kernel-name fragments of the port's kernels, as the profiler shows them.
KERNEL_SYMBOLS = {'paged_decode': 'paged_decode_kernel',
                  'flash_fwd': 'flash_fwd'}


def profile_device(torch, fn) -> dict:
    """Run ``fn`` under torch.profiler (CUDA activity) and print its wall
    time, the device time of every kernel and copy it ran, the idle
    share, and the kernels that took the most device time. Returns the
    idle share (None when the profiler saw no kernel) and the number of
    kernel events of each of KERNEL_SYMBOLS' kernels."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.self_device_time_total / 1e3, e.count, e.key)
            for e in prof.key_averages() if e.self_device_time_total > 0]
    busy_ms = sum(r[0] for r in rows)
    counts = {name: sum(n for _, n, key in rows if sym in key)
              for name, sym in KERNEL_SYMBOLS.items()}
    if not rows:
        log(f'[profile] wall {wall_ms:.1f} ms; device time not measured '
            f'(the profiler saw no kernel)')
        return {'idle_share': None, 'kernel_counts': counts}
    idle = 1 - busy_ms / wall_ms
    log(f'[profile] wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms, '
        f'idle share {idle:.3f}; by device time:')
    for ms, n, key in sorted(rows, reverse=True)[:8]:
        log(f'[profile]   {ms:8.2f} ms {n:6d}x  {key[:90]}')
    return {'idle_share': idle, 'kernel_counts': counts}


def free_card(torch) -> None:
    """Collect what an ended phase left in reference cycles (an engine
    and its server threads hold each other) and give the cached blocks
    back, so that the next phase starts from an empty card."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def bf16_params(torch, cfg, llama, decode):
    """Random params of preset ``cfg`` from seed 0, made on the card in
    fp32 and kept in bf16."""
    gen = torch.Generator(device='cuda').manual_seed(0)
    params = decode.cast_params_for_decode(llama.init_params(cfg, gen, 'cuda'),
                                           cfg)
    torch.cuda.empty_cache()
    return params


# Gemma-2/3 at full width, cut in depth: gemma2-9b to 2 layers (one
# local, one global), gemma3-12b to 6 (five local, one global).
SWITCH_DEPTHS = {'gemma2-9b': 2, 'gemma3-12b': 6}


def phase_gemma_switches(torch, config, llama, decode, paging, pa,
                         build) -> None:
    """gemma2-9b and gemma3-12b at full width and reduced depth: prefill
    (past gemma3's 1024-token window) + 8 decode steps by the default
    routing vs the plain and fp32 paths. Every layer of both carries a
    window (and gemma2 softcaps), so, as in the JAX package, kernels A
    and B must launch zero times."""
    import dataclasses
    for name, depth in SWITCH_DEPTHS.items():
        cfg = dataclasses.replace(config.get_config(name), n_layers=depth)
        params = bf16_params(torch, cfg, llama, decode)
        phase_model(torch, cfg, params, decode, paging, pa, build,
                    f'{name} ({depth} layers)', LONG_SHAPE, kernels=False)
        del params
        torch.cuda.empty_cache()


def gpu_line() -> str:
    try:
        return subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f'nvidia-smi unavailable: {e}'


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--phases', default='build,flash,paged,flash_bwd,'
                        'timing,model,serve,model_gemma,serve_gemma,'
                        'gemma_switches,train_gemma,train', help='comma-separated '
                        'subset (for '
                        'debugging; the full run is the check)')
    args = parser.parse_args()
    phases = set(args.phases.split(','))
    sys.path.insert(0, HERE)
    try:
        import torch
        from skypilot_tpu_torch import config
        from skypilot_tpu_torch.kernels import build
        from skypilot_tpu_torch.models import decode, llama, paging
        from skypilot_tpu_torch.ops import flash_attention as fa
        from skypilot_tpu_torch.ops import paged_attention as pa
        from skypilot_tpu_torch.serve import engine as engine_lib
    except ImportError as e:
        print(f'chip_smoke: cannot import the port ({e}); run it from the '
              f'repository root', file=sys.stderr)
        sys.exit(2)
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        sys.exit(3)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = gpu_line()
    log(f'[device] {torch.cuda.get_device_name(0)} | {card} | torch '
        f'{torch.__version__} cuda {torch.version.cuda}')

    errs, times, by_path = {}, {}, {}
    if 'build' in phases:
        phase_build(build)
    if 'flash' in phases:
        errs['flash_fwd'] = phase_flash(torch, fa)['max_abs_err']
    if 'paged' in phases:
        errs['paged_decode'] = phase_paged(torch, pa, paging)['max_abs_err']
    if 'flash_bwd' in phases:
        errs.update(phase_flash_bwd(torch, fa))
    if 'timing' in phases:
        times = phase_timing(torch, fa, pa, paging)
    if 'model' in phases or 'serve' in phases:
        cfg = config.get_config('llama-1b')
        params = bf16_params(torch, cfg, llama, decode)
        if 'model' in phases:
            phase_model(torch, cfg, params, decode, paging, pa, build,
                        'llama-1b')
            phase_verify(torch, cfg, decode, llama, paging, pa)
        if 'serve' in phases:
            by_path['serve'] = phase_serve(torch, 'llama-1b', cfg, params,
                                           engine_lib, build, decode)
        del params
        free_card(torch)
    if 'model_gemma' in phases or 'serve_gemma' in phases:
        cfg = config.get_config('gemma-7b')
        params = bf16_params(torch, cfg, llama, decode)
        if 'model_gemma' in phases:
            phase_model(torch, cfg, params, decode, paging, pa, build,
                        'gemma-7b')
            free_card(torch)
        if 'serve_gemma' in phases:
            by_path['serve_gemma'] = phase_serve(torch, 'gemma-7b', cfg,
                                                 params, engine_lib, build,
                                                 decode)
        del params
        free_card(torch)
    if 'gemma_switches' in phases:
        phase_gemma_switches(torch, config, llama, decode, paging, pa, build)
    if 'train_gemma' in phases:
        by_path['train_gemma'] = phase_train_gemma(torch, build)
        free_card(torch)
    if 'train' in phases:
        by_path['train'] = phase_train(torch, build)

    replaces = {
        'flash_fwd': 'skypilot_tpu/ops/pallas/flash_attention.py:63',
        'flash_dq': 'skypilot_tpu/ops/pallas/flash_attention.py:159',
        'flash_dkv': 'skypilot_tpu/ops/pallas/flash_attention.py:196',
        'paged_decode': 'skypilot_tpu/ops/pallas/paged_attention.py:48'}
    # Launches: each kernel's count on the main paths it belongs to
    # (serving: SERVE_KERNELS, training: TRAIN_KERNELS), summed.
    paths = {'serve': SERVE_KERNELS, 'serve_gemma': SERVE_KERNELS,
             'train': TRAIN_KERNELS, 'train_gemma': TRAIN_KERNELS}
    rows = []
    for name, kern in build.kernels().items():
        t = times.get(name, {})
        mine = {p: n[name] for p, n in by_path.items() if name in paths[p]}
        rows.append({
            'name': name, 'route': 'cuda',
            'source': f'skypilot_tpu_torch/csrc/{kern.source}',
            'replaces': replaces[name],
            'launches': sum(mine.values()) if mine else None,
            'launches_by_path': mine,
            'max_abs_err': errs.get(name),
            'ms': t.get('ms'), 'plain_ms': t.get('plain_ms'),
            **({'train_shape_ms': times['flash_fwd B=4']['ms']}
               if name == 'flash_fwd' and 'flash_fwd B=4' in times else {}),
            **({'hd256': times[f'{name} hd256']}
               if f'{name} hd256' in times else {}),
            'bound_ms': t.get('bound_ms'), 'bound_by': t.get('bound_by'),
            'library_ms': t.get('library_ms')})
    log(f'[device] {card}')
    print(json.dumps({'kernels': rows}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
