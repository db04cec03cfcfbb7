"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is swallowed):
  1. build     — nvcc-build every kernel from skypilot_tpu_torch/csrc/
                 for sm_90a, one nvcc per source, all at once;
  2. flash     — kernel A vs its plain version at llama-1b shapes, at
                 gemma-7b's head_dim 256 (16/16 heads; causal and not,
                 ragged S, S=2048) and at llama3.2-1b's head_dim 64
                 (32/8 heads);
  3. paged     — kernel B vs its plain version at llama-1b decode shapes
                 and at g*S up to 64 (g = 7 and 8), rows ending on the
                 split's page and chunk edges, two calls bit-equal; then
                 the same at head_dim 256: gemma-7b decode (g = 1),
                 gemma2-9b heads (g = 2) up to S = 8, g*S = 64, page
                 sizes 40, 64, 72 and 128 (pages over 64 tokens stream
                 in halves: rows end on a half's edge too); then at
                 head_dim 64: llama3.2-1b's heads (g = 4) at S 1, 2, 4
                 on pages of 40, 64 and 128, and g = 8 at S = 8;
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
                 B at the speculative verify's S=4 at every head dim;
                 C and D at gemma-7b's train shape (B=2, S=T=2048,
                 H=KH=16, D=256) beside SDPA's backward by backend; A,
                 B (S=1 and 4), C and D at llama3.2-1b's heads (32/8,
                 D=64; A at B=2, C and D at B=4);
  6. model     — llama-1b (full width, random bf16 weights) prefill + 8
                 paged decode steps through the kernels vs the plain path;
                 then a verify step of 8 tokens with 2 kv heads (g*S =
                 64) through kernel B vs the plain path;
  7. serve     — the port's engine on llama-1b with the JAX engine's
                 default admission (the prefix cache, speculation,
                 256-token chunks): warm-up must capture the 8
                 decode-step variants (k x layers B launches each) and
                 the 2 verify variants (layers each) as CUDA graphs; a
                 burst of 4 concurrent /generate
                 requests and 2 streamed /v1/completions (one with both
                 penalties, one with logprobs=5); kernels A and B must
                 launch, nothing is captured after warm-up; TTFT, TPOT,
                 tok/s, device calls by width, peak memory; the burst
                 again under torch.profiler for the idle share, time by
                 kernel and B's launches counted on the device (equal
                 to captured launches x replays); then, the loop
                 stopped, one k=1 greedy replay against the eager step
                 and two sampled replays that must differ. Before that,
                 with the loop running, the admission burst (timed,
                 then profiled): a 1000-token prompt with three short
                 ones (4 chunks, A in the first only, the short ones'
                 first tokens first), a cold 552-token request then 4
                 sharing its 512-token system prompt (>= 3 prefix hits
                 on its pages, refcount > 1), 4 self-repeating greedy
                 prompts (speculative rounds); after it, one verify
                 replay against the eager verify and 4 sequential eager
                 steps, and 10 replays whose B launches the profiler
                 counts. Then a second engine with speculation and the
                 prefix cache off takes the same burst (TTFT, TPOT,
                 tok/s, idle share, peak memory side by side, also in
                 chiprun_out/admission_<model>.json), and a 1000-token
                 prompt's logits after the 4 chunks are held against
                 one-shot prefills (bf16 kernel, bf16 plain, fp32);
  7b. batch_infer — offline batch inference on llama-1b whole (bf16,
                 random weights from seed 0) through batch_infer.run in
                 process: 64 records of random bytes, 16-1000 tokens, in
                 batches of 32, 64 greedy tokens each: all written, a
                 second run re-runs none, kernel A exactly 16 layers x 2
                 batches in generate and again in embed (every row
                 finite, dim wide); items/s, tokens/s, peak memory; the
                 file's completions == the replayed CUDA-graph generate
                 == an eager decode_step loop; contiguous decode_step
                 logits vs paged_decode_step's (kernels A, B) against
                 fp32 (TOL_MODEL); generate_speculative in fp32 with a
                 2-layer draft == fp32 generate, its rounds; int8 from
                 the fp32 masters vs bf16: first-logit error (< 0.1), ms
                 a replayed step at B=32, peak memory
                 (chiprun_out/batch_infer.json);
  8. model_gemma — gemma-7b at full width cut to 14 of its 28 layers
                 (dim 3072, 16/16 heads, hd 256, vocab 256000; random
                 bf16 weights from seed 0, ~9.7 GB): prefill + 8 paged decode steps
                 through kernels A and B vs the plain and fp32 paths;
  9. serve_gemma — the port's engine on gemma-7b, checked as in serve;
 10. gemma_switches — gemma2-9b (2 layers) and gemma3-12b (6 layers:
                 one global) at full width: prefill + decode on the
                 card vs fp32, with kernels A and B launched zero times
                 (softcaps, windows: the plain route, as in JAX);
 11. model_moe — gpt-oss-20b at full width cut to 4 layers, then moe-1b
                 at full width and depth (12 layers, dim 1024, 8/4
                 heads, hd 128, 8 experts top-2, ffn 4096, vocab 32768,
                 tied; random bf16 weights from seed 0): prefill + 8
                 paged decode steps by the default routing (moe-1b
                 through kernels A and B, gpt-oss through neither) vs
                 the plain and fp32 paths, those two taking the default
                 path's routes (experts and capacity drops), so that
                 every token's routes agree in every layer on all three
                 paths; free runs first print the share of (token,
                 layer) routes that differ;
 12. serve_moe — the port's engine on moe-1b, checked as in serve but
                 with no speculation (spec_k 0 for MoE, as in JAX: 8
                 graphs, no verify) and no chunked-logits check;
 13. serve_gptoss — the engine on gpt-oss-20b at full width cut to 12
                 of its 24 layers (dim 2880, 64/8 heads, hd 64, 32
                 experts top-4, vocab 201088, sinks, a 128-token window
                 on every other layer, YaRN, clamped SwiGLU, qkv bias;
                 random bf16 weights drawn leaf by leaf, ~21 GB), the
                 same bursts: A and B launch zero times (sinks: the
                 plain route);
 14. model_mla — deepseek-v2-lite at full width cut to 14 of its 27
                 layers (dim 2048, 16 heads, latent r 512, dn 128, dr 64, dv 128,
                 ffn 10944, vocab 102400; random bf16 weights from seed
                 0): prefill + 8 paged decode steps over the paged
                 latent pool, teacher-forced, against the fp32 paged
                 path (its error at most TOL_MODEL x the plain bf16
                 forward's); the fp32 paged steps against the fp32 full
                 forward (TOL_MLA_SELF); a k=1 CUDA-graph replay of
                 mla.paged_decode_step bit-equal to the eager step; A
                 and B launched zero times (the latent family has no
                 kernel, as in JAX); mla.generate over the contiguous
                 latent cache: the replayed graph's greedy tokens == the
                 eager steps', first logits bf16 vs fp32 (TOL_MODEL);
 15. serve_mla — the engine on deepseek-v2-lite, checked as in serve
                 (the bursts, the admission burst with chunks, prefix
                 hits and speculation, the verify graphs, the chunked
                 logits), A and B launched zero times;
 16. serve_deepseek_v2 — deepseek-v2 at full width: first model_mla's
                 checks at 2 layers with capacity for every token (no
                 routed choice dropped) and the forwards' and fp32
                 path's routes forced to the default path's; then the
                 engine at 4 of 60 layers (160 experts top-6 + 2
                 shared; random bf16 weights, 34.5 GB), spec_k 0,
                 checked as in serve_moe; A and B launched zero times;
 17. train_gemma — the port's trainer on gemma-7b at full width cut to
                 4 layers, 4 steps of 2 x 2048 tokens: A twice and C, D
                 once per layer per step at head_dim 256; peak memory;
                 grads against the plain and fp32 paths, the loss
                 against the plain-attention trainer; one step under
                 torch.profiler; then one step each of gemma2-9b (2
                 layers) and gemma3-12b (6 layers) with no kernel
                 launched, their grads against fp32;
 18. train     — the port's trainer on llama-1b at full width, 6 steps
                 of 4 x 2048 tokens: A twice and C, D once per layer per
                 step; grads against the plain and fp32 paths, the loss
                 against the plain-attention trainer, a resume at step
                 3; one step under torch.profiler;
 19. train_moe — the trainer on moe-1b at full width cut to 6 of its 12
                 layers (8 experts top-2, hd 128), checked as in train:
                 A 72, C 36 and D 36 launches in 6 steps; the grads (CE + router aux) at
                 capacity for every choice, the plain and fp32 runs
                 teacher-forced onto the default run's routes in the
                 forward and in the remat recompute; then gpt-oss-20b at
                 full width cut to 2 layers, one step with no kernel, its
                 grads finite and those of the sinks, the q/k/v biases
                 and the clamped experts non-zero;
 20. train_mla — the trainer on deepseek-v2-lite whole (27 layers, r 512,
                 vocab 102400), 4 steps of 4 x 2048, no kernel launched
                 (the latent attention is plain PyTorch, as in JAX);
                 finite losses and grads, each leaf's bf16 grad within
                 TOL_GRAD_MLA of fp32; one step profiled, peak memory;
 21. hf        — real checkpoints at llama3.2-1b's full width (16
                 layers, dim 2048, 32/8 heads, hd 64, vocab 128256,
                 tied, llama3 rope scaling; random bf16 weights from
                 seed 0, 2.47 GB): save_hf_checkpoint, whose config
                 imports equal to the preset and whose tensors
                 load_hf_checkpoint puts on the card bit for bit; the
                 trainer from --hf-dir, 3 steps of 4 x 2048 (A 96, C 48,
                 D 48 launches; the first loss against the imported
                 tree's cross-entropy, TOL_LOSS), saving 14.8 GB of fp32
                 state at the last; the engine on that checkpoint
                 (--ckpt-dir) behind build_app: /health, 4 greedy
                 /generate and a chat completion as JSON and streamed
                 (A and B launch), the greedy tokens against
                 decode.generate; then `python -m
                 skypilot_tpu_torch.serve.engine --model llama3.2-1b
                 --ckpt-dir` as a subprocess (no --device): /health and
                 one chat; then qwen2.5-1.5b (qkv biases) exported and
                 imported bit for bit. Its files live in the git-ignored
                 .smoke_hf/ and are removed.
Then it prints the card's name and power limit, one {"kernels": [...]}
line, and as its last line {"ok": true, "device": {...}}.

It imports nothing of JAX and nothing of the JAX package. Without a
CUDA device, or without the skypilot_tpu_torch package beside it, it
exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
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
# Kernel A at head_dim 64 (llama3.2-1b's heads, 32/8): (B, S=T, causal).
FLASH64_CASES = [(2, 100, True), (2, 2048, True), (1, 300, False)]
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
             (1, 2048, 32, 8, 64, True, False),
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
        [(b, s, h, kh, 256, causal) for b, s, h, kh, causal in
         FLASH256_CASES] + \
        [(b, s, 32, 8, 64, causal) for b, s, causal in FLASH64_CASES]
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
# At head_dim 64, (S, H, KH, psz): llama3.2-1b's heads (g = 4) at decode
# and verify widths on 64-token pages and on pages of 128 and 40; then
# g = 8 at S = 8 (64 rows).
PAGED64_CASES = [(1, 32, 8, 64), (4, 32, 8, 64), (1, 32, 8, 128),
                 (2, 32, 8, 40), (8, 32, 4, 64)]


def paged_inputs(torch, pa, paging, s, seed, h=16, kh=8, edges=False,
                 hd=128, psz=64, rows_of_s=None):
    """llama-1b decode shapes (B=8, psz 64, max_pages 32; ``hd`` and
    ``psz`` may differ): ragged lengths (one row of length 0), shuffled
    page ids, table tails 0, the step's K/V written first. The lengths
    are drawn as for S = ``rows_of_s`` where given (the verify's timing
    rows are the decode step's). ``edges``
    also sets the rows that end where the kernel's split changes hands:
    row 5 ends inside its first page, row 6 exactly on a page and chunk
    boundary, row 7 one key past one; at head_dim 256 with pages over 64
    tokens (streamed in halves), row 4 ends on the first half of its
    second page."""
    b, maxp = 8, 32
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, maxp * psz - (rows_of_s or s), size=b)
    lengths[3] = 0
    if int(lengths.max()) + s > maxp * psz:
        fail(f'paged inputs: a row of {lengths.max()} + S={s} overflows')
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
        [(s, h, kh, 256, psz) for s, h, kh, psz in PAGED256_CASES] + \
        [(s, h, kh, 64, psz) for s, h, kh, psz in PAGED64_CASES]
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
# At llama3.2-1b's heads (32/8, head_dim 64), the hf phase's model: A at
# the serve shape (B=2), B at the timing rows, C and D at its train
# batch (B=4).
TIMING_SHAPE_64 = dict(s=2048, h=32, kh=8, d=64)


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


def paged_launch(torch, pa, paging, s=1, **heads):
    """Kernel B's inputs at the timing shape (B=8, S=``s``, llama-1b heads
    or ``heads`` (h, kh, hd), psz 64, max_pages 32, the ragged rows of
    S=1) and a callable that launches the kernel alone."""
    inputs = paged_inputs(torch, pa, paging, s, seed=8, rows_of_s=1,
                          **heads)
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


def time_paged(torch, pa, paging, h, kh, hd, s=1) -> dict:
    """Kernel B's launch alone at B=8, S=``s`` (1: a decode step; 4: the
    speculative verify), psz 64, max_pages 32 and the ragged timing
    rows, beside its wrapper, its plain version and SDPA over
    pre-gathered pages; then the same launch at other chunk counts, each
    twice (bit-equal) and held to the fp32 plain version."""
    (q, kp, vp, table, length, lengths), launch = paged_launch(
        torch, pa, paging, s=s, h=h, kh=kh, hd=hd)
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
    rows = length[:, None] + torch.arange(q.shape[1], device='cuda')
    mask = (pos[None, None, :] <= rows[:, :, None])[:, None]
    lib = time_ms(lambda: sdpa_gqa(torch, qs, k_l, v_l, attn_mask=mask,
                                   scale=1.0), iters=100)
    del k_l, v_l
    b8, s1 = q.shape[0], q.shape[1]
    toks = int(np.sum(lengths + s1))
    nbytes = 2 * 2 * toks * kh * hd + 2 * 2 * b8 * s1 * h * hd + \
        4 * (table.numel() + b8)
    flops = 4 * toks * s1 * h * hd
    chunks, per = pa.split_pages(b8, kh, table.shape[1], pa._sm_count(0), hd)
    log(f'[timing] paged_decode hd={hd} S={s1}: wrapper '
        f'paged_decode_attention (checks + launch) {wrapper:.4f} ms; kernel '
        f'{nbytes / ms / 1e6:.1f} GB/s; grid {chunks} chunks x KH {kh} x B '
        f'{b8} = {chunks * kh * b8} blocks, {per} pages a chunk')
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
        log(f'[timing] paged_decode hd={hd} S={s1} at {n} chunks{mark}: '
            f'{ms_n:.4f} ms; err vs fp32 plain {e:.4e}; launches '
            f'{"bit-equal" if same else "DIFFER"}')
        if not same or not o_ok(out_n, ref):
            fail(f'paged kernel hd={hd} S={s1} at {n} chunks: bit-equal '
                 f'{same}, err {e}')
    return dict(ms=ms, plain_ms=plain, library_ms=lib, **bound(flops, nbytes),
                shape=f'B={b8} S={s1} H={h} KH={kh} hd={hd} psz=64 '
                      f'max_pages=32 ragged ({toks} K/V tokens) bf16')


def phase_timing(torch, fa, pa, paging) -> dict:
    """Times at the largest main-path shapes of phases 2, 3 and 4, each
    kernel by its launch alone: llama-1b's heads (A at the serve and
    train batches), then A and B at gemma-7b's (head_dim 256), then A,
    B, C and D at llama3.2-1b's (head_dim 64)."""
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
    # B at the speculative verify's shape: S = 4 (g*S 8 at llama-1b's
    # heads, 4 at gemma-7b's), the decode step's ragged rows.
    res['paged_decode S=4'] = time_paged(torch, pa, paging, 16, 8, 128, s=4)
    res['paged_decode hd256 S=4'] = time_paged(torch, pa, paging, 16, 16,
                                               256, s=4)
    res.update({f'{n} hd256': r for n, r in time_flash_bwd(
        torch, fa, BWD_TIMING_B_256, TIMING_SHAPE_256).items()})
    res['flash_fwd hd64'] = time_fwd(torch, fa, FWD_TIMING_B[0],
                                     TIMING_SHAPE_64)
    res['paged_decode hd64'] = time_paged(torch, pa, paging, 32, 8, 64)
    res['paged_decode hd64 S=4'] = time_paged(torch, pa, paging, 32, 8, 64,
                                              s=4)
    res.update({f'{n} hd64': r for n, r in time_flash_bwd(
        torch, fa, BWD_TIMING_B, TIMING_SHAPE_64).items()})
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


class RouteLog:
    """While installed (``with``), records every ``models.moe.route``
    call's expert ids [B, G, T, K] and capacity slots [B, G, T, K, E,
    C]. Given another run's calls (``force``), it hands each call that
    run's ids and slots in place of its own, the gates then being this
    run's own probabilities at those experts, renormalised: the routes
    teacher-forced, as phase_model forces the tokens. ``force`` may
    instead be a function (call index, own ids) → ids, for a run whose
    calls group tokens otherwise (a forward of whole sequences against
    prefill + steps): the slots are then counted from the forced ids.
    ``no_drop`` makes any dropped choice fail the run; the slots then
    follow from the ids and are not kept."""

    def __init__(self, moe, force=None, no_drop=False):
        self.moe, self.force, self.calls = moe, force, []
        self.no_drop = no_drop

    def __enter__(self):
        orig = self.route = self.moe.route

        def spy(xg, router, cfg, c):
            probs, gate_w, idx, slot = orig(xg, router, cfg, c)
            if callable(self.force):
                idx = self.force(len(self.calls), idx)
                slot = self.moe.slots(idx, cfg.n_experts, c)
            elif self.force is not None:
                idx, slot = self.force[len(self.calls)]
            if self.force is not None:
                gate_w = probs.gather(-1, idx)
                gate_w = gate_w / gate_w.sum(-1, keepdim=True)
            if self.no_drop and int(slot.sum()) != idx.numel():
                fail(f'route call {len(self.calls)}: {int(slot.sum())} of '
                     f'{idx.numel()} choices kept, want no drop')
            self.calls.append((idx, None if self.no_drop else slot))
            return probs, gate_w, idx, slot
        self.moe.route = spy
        return self

    def __exit__(self, *exc):
        self.moe.route = self.route

    def routes(self, i: int):
        """Call i's (expert ids, kept flags), each [B, G·T, K]."""
        idx, slot = self.calls[i]
        b, g, t, k = idx.shape
        return (idx.reshape(b, g * t, k),
                slot.sum((-1, -2)).reshape(b, g * t, k))


def route_agreement(torch, ra, rb, n_layers: int, len_t, steps: int):
    """Two paths' RouteLog calls (prefill, then each decode step, a call
    a layer) compared: (same [steps + 1, B]: whether the measured
    token's routes, experts and drops, agree in every layer: at step 0
    the prefill's last content position, then the step's token;
    differing (token, layer) pairs; all such pairs, over content
    positions)."""
    def stack(log, calls):
        got = [log.routes(i) for i in calls]
        return (torch.stack([c[0] for c in got]),
                torch.stack([c[1] for c in got]))

    def eq(calls):
        a, b = stack(ra, calls), stack(rb, calls)
        return (a[0] == b[0]).all(-1) & (a[1] == b[1]).all(-1)

    L = n_layers
    pre = eq(range(L))                                          # [L,B,S]
    dec = eq(range(L, len(ra.calls)))                           # [nL,B,1]
    dec = dec[..., 0].reshape(steps, L, -1)
    b, s = pre.shape[1:]
    content = torch.arange(s, device=pre.device)[None] < len_t[:, None]
    last = pre.all(0)[torch.arange(b), len_t.long() - 1]
    same = torch.cat([last[None], dec.all(1)])
    n_diff = int((~pre & content).sum()) + int((~dec).sum())
    n_all = int(content.sum()) * L + dec.numel()
    return same, n_diff, n_all


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
    An MoE config routes each path's own hidden states, and a near tie
    of router probabilities can pick other experts on one path: a flip
    moves that token's logits far more than any rounding, and through
    attention every later token's. So the ratio is held on the tokens
    whose routes (experts and drops) agree in every layer on all three
    paths, and made to agree on all of them: the plain and fp32 paths
    take the default path's routes (RouteLog's ``force``), as they take
    its tokens. Free runs of both first give the share of (token,
    layer) routes that differ, printed. Returns the worst error ratio."""
    import dataclasses
    from skypilot_tpu_torch.models import moe
    steps = 8
    routed = hasattr(cfg, 'n_experts')
    tok_t, len_t = model_prompts(torch, cfg.vocab_size,
                                 np.random.default_rng(5), shape)

    def run(cfg_run, params_run, plain: bool, feed=None, force=None):
        routes = RouteLog(moe, force)
        with routes if routed else contextlib.nullcontext():
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
        return out, toks, routes

    build.reset_launches()
    kern, toks, r_kern = run(cfg, params, False)
    launches = {n: build.kernels()[n].launches for n in SERVE_KERNELS}
    want = ({'flash_fwd': cfg.n_layers, 'paged_decode': cfg.n_layers * steps}
            if kernels else {'flash_fwd': 0, 'paged_decode': 0})
    if launches != want:
        fail(f'model path {name}: launches {launches}, want {want}')
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    params32 = decode.cast_params_for_decode(params, cfg32)
    force = None
    if routed:
        logs = {'default': r_kern}
        logs['plain bf16'] = run(cfg, params, True, feed=toks)[2]
        logs['fp32'] = run(cfg32, params32, True, feed=toks)[2]
        for a, b in (('default', 'plain bf16'), ('default', 'fp32'),
                     ('plain bf16', 'fp32')):
            same, n_diff, n_all = route_agreement(
                torch, logs[a], logs[b], cfg.n_layers, len_t, steps)
            log(f'[model] {name} free routes, {a} vs {b}: {n_diff} of '
                f'{n_all} (token, layer) choices differ (share '
                f'{n_diff / n_all:.4f}); measured tokens whose routes agree '
                f'in every layer: {int(same.sum())} of {same.numel()}')
        del logs
        force = r_kern.calls
    plain, _, r_plain = run(cfg, params, True, feed=toks, force=force)
    ref, _, r_ref = run(cfg32, params32, True, feed=toks, force=force)
    del params32
    torch.cuda.synchronize()
    # The rule: every measured token's routes agree in every layer on
    # the three paths (forced above), so the ratio is held on all rows.
    for other in ((r_plain, r_ref) if routed else ()):
        held = route_agreement(torch, r_kern, other, cfg.n_layers, len_t,
                               steps)[0]
        if not bool(held.all()):
            fail(f'model path {name}: forced routes differ: {held.tolist()}')
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


# The MLA model check's bound on the fp32 paged path against the fp32
# whole-sequence forward (max|diff| / std of the forward's logits): the
# same products in other shapes and orders, no rounding but fp32's.
TOL_MLA_SELF = 1e-3
# deepseek-v2's model check at full width cut to 2 layers (an fp32 layer
# is 16.2 GB: 2 in fp32 beside 2 in bf16 take ~55 GB), with capacity
# n_experts / top_k: an expert's slots cover every token of a group, so
# no routed choice drops in any grouping (random routers send most of a
# group's tokens to a few experts), and the whole-sequence forward and
# prefill + steps, once their expert ids are forced to the default
# path's, route alike. deepseek-v2 serves at 4 of its 60 layers (34.5 GB
# of bf16 weights; all 60 take 488 GB).
DSV2_MODEL_DEPTH, DSV2_SERVE_DEPTH = 2, 4


def mla_sequences(torch, tok_t, len_t, toks):
    """Each row's prompt then the fed tokens, zero-padded: [B, bucket +
    steps] for the whole-sequence forward; and [B, steps + 1], the
    positions whose logits the paged path gave (the prompt's last, then
    each fed token's)."""
    b, steps = tok_t.shape[0], len(toks)
    seq = torch.zeros((b, tok_t.shape[1] + steps), dtype=torch.int32,
                      device='cuda')
    fed = torch.stack(toks, 1)
    lens = len_t.tolist()
    for r, n in enumerate(lens):
        seq[r, :n] = tok_t[r, :n]
        seq[r, n:n + steps] = fed[r]
    pos = torch.tensor([[n - 1 + i for i in range(steps + 1)] for n in lens],
                       device='cuda')
    return seq, pos


def forced_by_token(r_paged, n_layers: int, lens, steps: int):
    """A RouteLog force function for a whole-sequence forward, from the
    paged path's calls (a prefill call a layer, then a call a layer a
    step): layer i's ids at row b's position j < len_b are the
    prefill's, at len_b + t step t's; the padding after keeps its own
    (it reaches no content position)."""
    def force(i, idx):
        out = idx.clone()
        pre = r_paged.calls[i][0]
        for b, n in enumerate(lens):
            out[b, 0, :n] = pre[b, 0, :n]
            for t in range(steps):
                out[b, 0, n + t] = r_paged.calls[n_layers * (t + 1) + i][0][
                    b, 0, 0]
        return out
    return force


def mla_graph_check(torch, mla, params, cfg, pc, max_len: int, tag) -> None:
    """One mla.paged_decode_step on ``pc`` captured into a CUDA graph and
    replayed from the same pool state: logits, latent pages and lengths
    bit-equal to the eager step's."""
    b = pc.length.shape[0]
    tok = (torch.arange(b, dtype=torch.int32, device='cuda') * 7 + 3) % \
        cfg.vocab_size
    state = (pc.c_kv, pc.k_rope, pc.length)
    snap = [t.clone() for t in state]

    def restore():
        for t, v in zip(state, snap):
            t.copy_(v)

    def step():
        return mla.paged_decode_step(params, tok, pc, cfg,
                                     max_len=max_len)[0]

    with torch.no_grad():
        want = step().clone()
        want_state = [t.clone() for t in state]
        restore()
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            step()                      # warm up on the capture stream
        torch.cuda.synchronize()
        restore()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            out = step()
        restore()
        graph.replay()
        torch.cuda.synchronize()
    same = [torch.equal(out, want)] + [
        torch.equal(t, w) for t, w in zip(state, want_state)]
    if not all(same):
        fail(f'{tag} k=1 graph replay of mla.paged_decode_step vs the eager '
             f'step: (logits, c_kv, k_rope, length) equal {same}')
    log(f'{tag} k=1 CUDA-graph replay of mla.paged_decode_step on {b} rows '
        f'== the eager step, bit for bit (logits, latent pages, lengths)')
    del graph, out
    restore()


def phase_model_mla(torch, cfg, params, mla, paging, build, name,
                    steps: int = 8, gen_check: bool = False) -> float:
    """Prefill + ``steps`` paged decode steps over the paged latent pool,
    teacher-forced with the bf16 path's own greedy tokens, four ways:
    bf16 paged (the serving path), the bf16 whole-sequence forward
    (each row's prompt and fed tokens, read at the same positions),
    fp32 paged and the fp32 forward on the same weights upcast. The
    bf16 paged path must lie no farther from the fp32 paged path than
    the plain bf16 forward does (TOL_MODEL, phase_model's chain); the
    fp32 paged path must equal the fp32 forward within TOL_MLA_SELF
    (paged steps are the full forward's math); a k=1 graph replay of
    the step must equal the eager step bit for bit; A and B must launch
    zero times. A DeepSeekMoE config routes: the fp32 paged path takes
    the default path's routes (RouteLog's ``force``) and the forwards
    take them token by token, with no choice dropped on any path (the
    config's capacity must be ample). ``gen_check``: mla.generate over
    the contiguous latent cache too (mla_generate_check). Returns the
    worst error ratio."""
    import dataclasses
    from skypilot_tpu_torch.models import decode, moe
    shape = MODEL_SHAPE
    routed = hasattr(cfg, 'n_experts')
    tok_t, len_t = model_prompts(torch, cfg.vocab_size,
                                 np.random.default_rng(5), shape)
    lens, b, max_len = len_t.tolist(), tok_t.shape[0], shape['max_len']
    maxp = paging.pages_for(max_len, MODEL_PSZ)

    def routes(force=None):
        return (RouteLog(moe, force, no_drop=True) if routed
                else contextlib.nullcontext())

    def paged(cfg_run, params_run, feed=None, force=None):
        with routes(force) as log_:
            logits, cs, krs = mla.prefill(params_run, tok_t, cfg_run,
                                          max_len, lengths=len_t)
            pc = mla.init_page_pool(cfg_run, b * maxp + 1, MODEL_PSZ, b,
                                    maxp, device='cuda')
            pc.table.copy_(torch.arange(1, b * maxp + 1, dtype=torch.int32,
                                        device='cuda').reshape(b, maxp))
            paging.scatter_prefill(pc, cs, krs, torch.arange(b, device='cuda'),
                                   shape['bucket'], len_t)
            del cs, krs
            out, toks = [logits], []
            for i in range(steps):
                nxt = (feed[i] if feed is not None
                       else torch.argmax(out[-1], dim=-1).to(torch.int32))
                toks.append(nxt)
                logits, pc = mla.paged_decode_step(params_run, nxt, pc,
                                                   cfg_run, max_len=max_len)
                out.append(logits)
        return torch.stack(out, 1), toks, log_, pc

    def whole(cfg_run, params_run, seq, pos, force=None):
        with routes(force):
            logits = mla.forward(params_run, seq, cfg_run)
        return torch.gather(logits, 1, pos[..., None].expand(
            -1, -1, logits.shape[-1]))

    with torch.no_grad():
        build.reset_launches()
        kern, toks, r_def, pc = paged(cfg, params)
        launches = {n: build.kernels()[n].launches for n in SERVE_KERNELS}
        if any(launches.values()):
            fail(f'model path {name}: launches {launches}, want none (the '
                 f'latent family has no kernel)')
        mla_graph_check(torch, mla, params, cfg, pc, max_len,
                        f'[model] {name}')
        del pc
        seq, pos = mla_sequences(torch, tok_t, len_t, toks)
        by_token = (forced_by_token(r_def, cfg.n_layers, lens, steps)
                    if routed else None)
        plain = whole(cfg, params, seq, pos, by_token)
        cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
        params32 = decode.cast_params_for_decode(params, cfg32)
        ref = paged(cfg32, params32, feed=toks,
                    force=(lambda i, _: r_def.calls[i][0]) if routed
                    else None)[0]
        ref_fwd = whole(cfg32, params32, seq, pos, by_token)
        if gen_check:
            f0 = ref[:, 0]
            mla_generate_check(
                torch, mla, cfg, params, params32, f0,
                float((plain[:, 0] - f0).abs().max()) / float(f0.std()),
                name)
        del params32, r_def, by_token
    torch.cuda.synchronize()
    if not bool(torch.isfinite(kern).all()) or \
            kern.shape != (b, steps + 1, cfg.vocab_size):
        fail(f'model path {name}: bad logits {tuple(kern.shape)}')
    e_self = float((ref - ref_fwd).abs().max()) / float(ref_fwd.std())
    if e_self > TOL_MLA_SELF:
        fail(f'model path {name}: fp32 paged steps vs the fp32 forward '
             f'max|diff|/std {e_self:.3e} > {TOL_MLA_SELF}')
    worst = 0.0
    for i in range(steps + 1):
        a, p, f = kern[:, i], plain[:, i], ref[:, i]
        std = float(f.std())
        e_k = float((a - f).abs().max()) / std
        e_p = float((p - f).abs().max()) / std
        worst = max(worst, e_k / e_p)
        log(f'[model] {name} step {i} ({"prefill" if i == 0 else "decode"}):'
            f' max|diff|/std(fp32 logits): paged-fp32 {e_k:.3e}, '
            f'forward-fp32 {e_p:.3e}, paged-forward '
            f'{float((a - p).abs().max()) / std:.3e}')
    if worst > TOL_MODEL:
        fail(f'model path {name}: paged error {worst:.2f}x the plain bf16 '
             f'forward\'s > {TOL_MODEL}x')
    log(f'[model] {name} {cfg.n_layers} layers, {b} rows, prefill bucket '
        f'{shape["bucket"]} + {steps} paged latent steps{", routes forced" if routed else ""}'
        f', launches {launches}: paged/forward error ratio worst '
        f'{worst:.3f} (tol {TOL_MODEL}); fp32 paged vs fp32 forward '
        f'{e_self:.3e} (tol {TOL_MLA_SELF}) ok')
    return worst


def mla_generate_check(torch, mla, cfg, params, params32, ref0, e_plain0,
                       name) -> None:
    """mla.generate over the contiguous latent cache, on the block's
    prompts: the graph's greedy tokens (16 steps) equal an eager
    prefill_cache + decode_step loop's; its bf16 first logits lie no
    farther from the fp32 paged path's (``ref0``) than TOL_MODEL x the
    bf16 forward's error there (``e_plain0``), and the fp32 contiguous
    prefill's equal them within TOL_MLA_SELF."""
    import dataclasses
    shape, n = MODEL_SHAPE, 16
    tok_t, len_t = model_prompts(torch, cfg.vocab_size,
                                 np.random.default_rng(5), shape)
    max_len = shape['bucket'] + n
    got = mla.generate(params, tok_t, cfg, n, max_len=max_len,
                       prompt_lengths=len_t)
    with torch.no_grad():
        logits, cache = mla.prefill_cache(params, tok_t, cfg, max_len,
                                          lengths=len_t)
        first = logits
        toks = [torch.argmax(logits, -1).to(torch.int32)]
        for _ in range(n - 1):
            logits, cache = mla.decode_step(params, toks[-1], cache, cfg)
            toks.append(torch.argmax(logits, -1).to(torch.int32))
        del cache
        cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
        first32 = mla.prefill_cache(params32, tok_t, cfg32, max_len,
                                    lengths=len_t)[0]
    eager = torch.stack(toks, 1)
    if not torch.equal(got, eager):
        fail(f'{name} mla.generate graph tokens differ from the eager '
             f'steps in {int((got != eager).sum())} of {got.numel()}')
    std = float(ref0.std())
    e16 = float((first - ref0).abs().max()) / std
    e32 = float((first32 - ref0).abs().max()) / std
    if e16 > TOL_MODEL * e_plain0 or e32 > TOL_MLA_SELF:
        fail(f'{name} mla.generate first logits: bf16-fp32 {e16:.3e} '
             f'(tol {TOL_MODEL} x {e_plain0:.3e}), fp32 contiguous vs fp32 '
             f'paged {e32:.3e} (tol {TOL_MLA_SELF})')
    log(f'[model] {name} mla.generate: {tuple(got.shape)} greedy tokens of '
        f'the replayed graph == the eager steps; first logits bf16-fp32 '
        f'{e16:.3e} (forward {e_plain0:.3e}), fp32 contiguous vs paged '
        f'{e32:.3e} ok')


# The batch_infer phase: 64 records of random printable bytes (1 byte,
# 1 token) of 16 to 1000 tokens, in batches of 32, 64 new tokens each.
BI_RECORDS, BI_BATCH, BI_NEW = 64, 32, 64
# Weight-only int8 against bf16: the first logits' max |diff| over the
# bf16 max |logit|, JAX's bound (tests/unit_tests/test_decode.py).
TOL_INT8 = 0.1


def batch_records(path: str, seed: int = 0) -> None:
    rng = np.random.default_rng(seed)
    with open(path, 'w', encoding='utf-8') as f:
        for n in rng.integers(16, 1001, size=BI_RECORDS):
            text = ''.join(map(chr, rng.integers(32, 127, size=n)))
            f.write(json.dumps({'prompt': text}) + '\n')


def timed(torch, fn):
    """(fn's result, its wall seconds ending in a synchronise)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def tree_gb(tree) -> float:
    """GB held by a params tree's tensors (an int8 weight's codes and
    scales both)."""
    if isinstance(tree, dict):
        return sum(tree_gb(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_gb(v) for v in tree)
    if hasattr(tree, 'q') and hasattr(tree, 'scale'):
        return tree_gb(tree.q) + tree_gb(tree.scale)
    return tree.numel() * tree.element_size() / 1e9


# A replayed step's time: the median of this many runs of BI_NEW - 1
# replays each.
REPLAY_REPEATS = 5


def step_cost(torch, decode, p, cfg, tok_t, len_t, width: int) -> dict:
    """What generate's step costs with the weights ``p`` on one batch.
    'ms': a replayed step, the median of REPLAY_REPEATS runs ('ms_all'),
    each BI_NEW - 1 replays of one captured step (decode_step, then the
    greedy token fed back, as generate's graph does) from the same
    prefilled cache, timed with CUDA events; no prefill, capture or host
    work inside. 'tree_gb': p's bytes. 'work_gb': what one generate call
    allocates above what was live before it, so that tree_gb + work_gb
    ('alone_gb') is its peak with p the only tree on the card. 'out':
    that call's tokens."""
    tree = tree_gb(p)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = decode.generate(p, tok_t, cfg, BI_NEW, max_len=width + BI_NEW,
                          prompt_lengths=len_t)
    torch.cuda.synchronize()
    work = (torch.cuda.max_memory_allocated() - base) / 1e9
    n, ms = BI_NEW - 1, []
    with torch.no_grad():
        logits, cache = decode.prefill_cache(p, tok_t, cfg, width + BI_NEW,
                                             lengths=len_t)
        tok = torch.argmax(logits, -1).to(torch.int32)
        len0 = cache.length.clone()

        def body():
            lg = decode.decode_step(p, tok, cache, cfg)[0]
            tok.copy_(torch.argmax(lg, -1).to(torch.int32))
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            body()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode='thread_local'):
            body()
        for _ in range(REPLAY_REPEATS):
            cache.length.copy_(len0)
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            for _ in range(n):
                graph.replay()
            t1.record()
            t1.synchronize()
            ms.append(t0.elapsed_time(t1) / n)
        del graph, cache
    return {'ms': float(np.median(ms)), 'ms_all': ms, 'tree_gb': tree,
            'work_gb': work, 'alone_gb': tree + work, 'out': out}


def kernel_a_at_batch(torch, cfg, params, decode, batch_infer, batches,
                      padded, emb_recs) -> float:
    """Kernel A at the shapes batch_infer.run gave it: the first and the
    last batch (BI_BATCH of the file's own ragged rows, widths 512 and
    1024). generate's prefill logits (prefill_cache) and embed's pooled
    rows (batch_infer._pooled_hidden through llama.forward), with A
    ('auto'), against the same with the plain attention in bf16 and in
    fp32 (the weights upcast): A's max |diff| to fp32 must be no more
    than TOL_MODEL x the plain bf16 path's. The pooled rows with A must
    also be the file's embed records. Returns the worst ratio."""
    import dataclasses
    cfg_x = dataclasses.replace(cfg, attention_impl='xla')
    cfg32 = dataclasses.replace(cfg_x, dtype=torch.float32)
    params32 = decode.cast_params_for_decode(params, cfg32)
    by_id = {r['id']: r['embedding'] for r in emb_recs}
    worst = 0.0
    for i in (0, len(padded) - 1):
        tok_t, len_t, width = padded[i]
        runs = {
            'prefill logits': lambda c, p: decode.prefill_cache(
                p, tok_t, c, width, lengths=len_t)[0],
            'embed rows': lambda c, p: batch_infer._pooled_hidden(
                p, tok_t, len_t, cfg=c, pool='mean')}
        for what, fn in runs.items():
            with torch.no_grad():
                a, x, f = fn(cfg, params), fn(cfg_x, params), \
                    fn(cfg32, params32)
            if not bool(torch.isfinite(a).all()):
                fail(f'batch_infer: kernel A {what} non-finite at B='
                     f'{tok_t.shape[0]} width {width}')
            std = float(f.std())
            e_a = float((a - f).abs().max()) / std
            e_x = float((x - f).abs().max()) / std
            worst = max(worst, e_a / e_x)
            if e_a > TOL_MODEL * e_x:
                fail(f'batch_infer: kernel A {what} at B={tok_t.shape[0]} '
                     f'width {width}: max|diff|/std to fp32 {e_a:.3e} > '
                     f'{TOL_MODEL} x the plain bf16 path\'s {e_x:.3e}')
            if what == 'embed rows':
                file_rows = torch.tensor([by_id[it['id']]
                                          for it in batches[i]])
                d = float((file_rows - a.cpu()).abs().max())
                if d > 1e-6 * float(file_rows.abs().max()):
                    fail(f'batch_infer: batch {i} embed records differ '
                         f'from _pooled_hidden with kernel A by {d:.3e}')
            log(f'[batch_infer] kernel A, batch {i} (B={tok_t.shape[0]}, '
                f'width {width}), {what}: max|diff|/std(fp32): A '
                f'{e_a:.3e}, plain bf16 {e_x:.3e}, ratio {e_a / e_x:.3f} '
                f'(tol {TOL_MODEL}) ok')
    del params32
    return worst


def contiguous_vs_paged(torch, cfg, params, decode, paging, pa) -> float:
    """Prefill + 8 decode steps on phase_model's prompts, teacher-forced
    with the paged path's greedy tokens: the paged path through kernels
    A and B (checked in phase_model), the contiguous path of generate
    (A, then plain-attention steps) and the contiguous path in fp32 on
    the same weights upcast. The contiguous bf16 path must lie no
    farther from fp32 than TOL_MODEL x the paged path does. Returns the
    worst ratio."""
    import dataclasses
    steps, shape = 8, MODEL_SHAPE
    tok_t, len_t = model_prompts(torch, cfg.vocab_size,
                                 np.random.default_rng(5), shape)
    max_len = shape['max_len']
    with torch.no_grad():
        logits, pc = prefilled_pool(torch, decode, paging, params, cfg,
                                    tok_t, len_t, 'auto', shape)
        paged, toks = [logits], []
        for _ in range(steps):
            toks.append(torch.argmax(paged[-1], -1).to(torch.int32))
            logits, pc = decode.paged_decode_step(params, toks[-1], pc, cfg,
                                                  max_len=max_len)
            paged.append(logits)
        del pc

        def contiguous(cfg_run, params_run):
            logits, cache = decode.prefill_cache(params_run, tok_t, cfg_run,
                                                 max_len, lengths=len_t)
            out = [logits]
            for t in toks:
                logits, cache = decode.decode_step(params_run, t, cache,
                                                   cfg_run)
                out.append(logits)
            return out
        contig = contiguous(cfg, params)
        cfg32 = dataclasses.replace(cfg, dtype=torch.float32,
                                    attention_impl='xla')
        params32 = decode.cast_params_for_decode(params, cfg32)
        ref = contiguous(cfg32, params32)
        del params32
    worst = 0.0
    for i, (c, p, f) in enumerate(zip(contig, paged, ref)):
        if not bool(torch.isfinite(c).all()):
            fail(f'contiguous decode: non-finite logits at step {i}')
        std = float(f.std())
        e_c = float((c - f).abs().max()) / std
        e_p = float((p - f).abs().max()) / std
        worst = max(worst, e_c / e_p)
        log(f'[batch_infer] step {i}: max|diff|/std(fp32 logits): '
            f'contiguous-fp32 {e_c:.3e}, paged (A, B)-fp32 {e_p:.3e}, '
            f'contiguous-paged {float((c - p).abs().max()) / std:.3e}')
    if worst > TOL_MODEL:
        fail(f'contiguous decode error {worst:.2f}x the paged path\'s > '
             f'{TOL_MODEL}x')
    log(f'[batch_infer] contiguous decode_step vs paged_decode_step '
        f'(kernel B), {len(toks)} steps on {tok_t.shape[0]} rows: error '
        f'ratio worst {worst:.3f} (tol {TOL_MODEL}) ok')
    return worst


def speculative_check(torch, cfg, params, decode) -> dict:
    """generate_speculative in fp32 with the plain attention on
    phase_model's prompts, the draft llama-1b's first 2 layers (and its
    embedding and head): its tokens must equal fp32 generate's."""
    import dataclasses
    shape, k = MODEL_SHAPE, 4
    tok_t, len_t = model_prompts(torch, cfg.vocab_size,
                                 np.random.default_rng(5), shape)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32,
                                attention_impl='xla')
    p32 = decode.cast_params_for_decode(params, cfg32)
    dcfg = dataclasses.replace(cfg32, n_layers=2)
    draft = dict(p32, layers={n: v[:2] for n, v in p32['layers'].items()})
    max_len = shape['bucket'] + BI_NEW + 2 * k
    want, t_gen = timed(torch, lambda: decode.generate(
        p32, tok_t, cfg32, BI_NEW, max_len=max_len, prompt_lengths=len_t))
    (got, stats), t_spec = timed(torch, lambda: decode.generate_speculative(
        p32, cfg32, draft, dcfg, tok_t, BI_NEW, k=k, max_len=max_len,
        prompt_lengths=len_t, return_stats=True))
    del p32, draft
    if not torch.equal(got, want):
        fail(f'generate_speculative (fp32, 2-layer draft) differs from fp32 '
             f'generate in {int((got != want).sum())} of {got.numel()} '
             f'tokens')
    log(f'[batch_infer] generate_speculative fp32, k={k}, 2-layer draft: '
        f'{tuple(got.shape)} tokens == fp32 generate; {stats["rounds"]} '
        f'rounds for {BI_NEW} tokens ({t_spec:.2f} s; generate '
        f'{t_gen:.2f} s) ok')
    return {'rounds': stats['rounds'], 'spec_s': t_spec, 'generate_s': t_gen}


def phase_batch_infer(torch, cfg, params, decode, paging, pa, build,
                      card: str) -> dict:
    """Offline batch inference on llama-1b whole (bf16, random weights
    from seed 0), through the user's entry point batch_infer.run in
    process: BI_RECORDS records in batches of BI_BATCH, BI_NEW greedy
    tokens each. Checks: every record written; a second run re-runs
    none; kernel A launched exactly once a layer a batch in generate and
    again in embed; the output equals the replayed graph's tokens,
    which equal an eager decode_step loop's; contiguous vs paged steps
    (contiguous_vs_paged); speculative == greedy in fp32
    (speculative_check); embed rows finite and dim wide; kernel A at
    the run's own shapes against the plain attention (kernel_a_at_batch);
    int8 from fp32 masters against bf16 (first logits within TOL_INT8, a
    replayed step, each tree's bytes and a generate's working set:
    step_cost). Returns the launches of the counted runs (generate and
    embed), by kernel."""
    import argparse
    import shutil
    from skypilot_tpu_torch.models import batch_infer, llama
    work = os.path.join(OUT_DIR, 'batch_infer')
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    inp = os.path.join(work, 'in.jsonl')
    batch_records(inp)

    def args(mode, out):
        return argparse.Namespace(
            input=inp, output=os.path.join(work, out), mode=mode,
            model='llama-1b', hf_dir=None, tokenizer=None, mesh={},
            batch_size=BI_BATCH, max_len=2048, max_new_tokens=BI_NEW,
            temperature=0.0, top_k=None, top_p=None, seed=0, pool='mean',
            num_workers=1, worker_id=0, device='cuda')

    n_batches = -(-BI_RECORDS // BI_BATCH)
    counted = {}
    runs = {}
    for mode, out in (('generate', 'gen.jsonl'), ('embed', 'emb.jsonl')):
        torch.cuda.reset_peak_memory_stats()
        build.reset_launches()
        stats, secs = timed(torch, lambda: batch_infer.run(args(mode, out)))
        launched = {n: k.launches for n, k in build.kernels().items()}
        for n, c in launched.items():
            counted[n] = counted.get(n, 0) + c
        want_a = cfg.n_layers * n_batches
        if launched.get('flash_fwd') != want_a or any(
                c for n, c in launched.items() if n != 'flash_fwd'):
            fail(f'batch_infer {mode}: launches {launched}, want flash_fwd '
                 f'{want_a} ({cfg.n_layers} layers x {n_batches} batches) '
                 f'and no other kernel')
        if stats != {'total': BI_RECORDS, 'done': 0, 'ran': BI_RECORDS}:
            fail(f'batch_infer {mode}: stats {stats}')
        recs = [json.loads(line) for line in open(args(mode, out).output)]
        if sorted(r['id'] for r in recs) != list(range(BI_RECORDS)):
            fail(f'batch_infer {mode}: {len(recs)} records written')
        runs[mode] = dict(secs=secs, recs=recs,
                          peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        again = batch_infer.run(args(mode, out))
        if again != {'total': BI_RECORDS, 'done': BI_RECORDS, 'ran': 0}:
            fail(f'batch_infer {mode} resume: {again}, want 0 re-run')
    gen, emb = runs['generate'], runs['embed']
    if any(r['tokens'] != BI_NEW for r in gen['recs']):
        fail('batch_infer generate: a record has fewer than '
             f'{BI_NEW} tokens (the byte tokenizer has no EOS)')
    for r in emb['recs']:
        e = np.asarray(r['embedding'])
        if e.shape != (cfg.dim,) or not np.isfinite(e).all():
            fail(f'batch_infer embed: record {r["id"]} shape {e.shape}')
    items_s = BI_RECORDS / gen['secs']
    tok_s = BI_RECORDS * BI_NEW / gen['secs']
    log(f'[batch_infer] generate: {BI_RECORDS} records, batches of '
        f'{BI_BATCH}, {BI_NEW} new tokens each, in {gen["secs"]:.2f} s '
        f'(weights drawn, prefill, graph capture and replays): '
        f'{items_s:.2f} items/s, {tok_s:.1f} generated tokens/s, peak '
        f'{gen["peak_gb"]:.2f} GB; embed {BI_RECORDS} in {emb["secs"]:.2f} '
        f's ({BI_RECORDS / emb["secs"]:.2f} items/s, peak '
        f'{emb["peak_gb"]:.2f} GB); a second run of each ran 0; A '
        f'{cfg.n_layers} x {n_batches} batches in each mode ok')

    # The replayed graph against the file and against eager steps, on
    # the first (shortest) batch.
    runner = batch_infer.BatchRunner(device='cuda', cfg=cfg, params=params)
    items = batch_infer.read_items(inp, 1, 0)
    for it in items:
        it['tokens'] = runner.tokenizer.encode(it['text'])
    items.sort(key=lambda it: len(it['tokens']))
    by_id = {r['id']: r['completion'] for r in gen['recs']}
    batches = [items[i:i + BI_BATCH] for i in range(0, BI_RECORDS,
                                                    BI_BATCH)]
    padded = [runner._pad_batch([it['tokens'] for it in b],
                                runner.max_len - BI_NEW) for b in batches]
    tok_t, len_t, width = padded[0]
    got = decode.generate(params, tok_t, cfg, BI_NEW,
                          max_len=width + BI_NEW, prompt_lengths=len_t)
    for it, row in zip(batches[0], got.tolist()):
        if runner.tokenizer.decode(row) != by_id[it['id']]:
            fail(f'batch_infer: record {it["id"]} in the file differs from '
                 f'the replayed generate')
    with torch.no_grad():
        logits, cache = decode.prefill_cache(params, tok_t, cfg,
                                             width + BI_NEW, lengths=len_t)
        toks = [torch.argmax(logits, -1).to(torch.int32)]
        for _ in range(BI_NEW - 1):
            logits, cache = decode.decode_step(params, toks[-1], cache, cfg)
            toks.append(torch.argmax(logits, -1).to(torch.int32))
        del cache
    eager = torch.stack(toks, 1)
    if not torch.equal(got, eager):
        fail(f'batch_infer: the replayed graph\'s tokens differ from the '
             f'eager steps\' in {int((got != eager).sum())} of '
             f'{got.numel()}')
    log(f'[batch_infer] batch 0 (B={tok_t.shape[0]}, width {width}): the '
        f'file\'s completions == the replayed generate == an eager '
        f'decode_step loop, token for token ok')

    a_ratio = kernel_a_at_batch(torch, cfg, params, decode, batch_infer,
                                batches, padded, emb['recs'])
    paged_ratio = contiguous_vs_paged(torch, cfg, params, decode, paging, pa)
    spec = speculative_check(torch, cfg, params, decode)

    # bf16 against int8 (quantized from the fp32 masters of the same
    # seed) on the longest batch: a replayed step, each tree's bytes and
    # the working set of a generate, first logits.
    tok_t, len_t, width = padded[-1]
    masters = llama.init_params(cfg, torch.Generator(
        device='cuda').manual_seed(0), 'cuda')
    q8 = decode.cast_params_for_decode(masters, cfg, quantize='int8')
    del masters
    free_card(torch)
    res = {}
    for tag, p in (('bf16', params), ('int8', q8)):
        with torch.no_grad():
            first = decode.prefill_cache(p, tok_t, cfg, width + BI_NEW,
                                         lengths=len_t)[0]
        res[tag] = step_cost(torch, decode, p, cfg, tok_t, len_t, width)
        res[tag]['first'] = first
    log(f'[batch_infer] profile of one bf16 generate, B={tok_t.shape[0]}, '
        f'width {width} + {BI_NEW} (prefill, capture, {BI_NEW - 1} '
        f'replays):')
    prof = profile_device(torch, lambda: decode.generate(
        params, tok_t, cfg, BI_NEW, max_len=width + BI_NEW,
        prompt_lengths=len_t))
    rel = float((res['int8']['first'] - res['bf16']['first']).abs().max()) \
        / float(res['bf16']['first'].abs().max())
    agree = float((res['int8']['out'] == res['bf16']['out']).float().mean())
    del q8
    if rel >= TOL_INT8 or not bool(torch.isfinite(res['int8']['first'])
                                   .all()):
        fail(f'int8 first logits rel err {rel:.4f} >= {TOL_INT8}')
    for tag in ('bf16', 'int8'):
        r = res[tag]
        log(f'[batch_infer] {tag}, B={tok_t.shape[0]} width {width} + '
            f'{BI_NEW}: a replayed step {r["ms"]:.3f} ms (median of '
            f'{[round(m, 3) for m in r["ms_all"]]}); tree '
            f'{r["tree_gb"]:.3f} GB + a generate\'s working set '
            f'{r["work_gb"]:.3f} GB = {r["alone_gb"]:.3f} GB alone | {card}')
    log(f'[batch_infer] int8 first logits rel err {rel:.4f} (tol '
        f'{TOL_INT8}); greedy tokens equal to bf16 {agree:.3f} ok')
    summary = {
        'card': card, 'records': BI_RECORDS, 'batch': BI_BATCH,
        'new_tokens': BI_NEW, 'generate_s': gen['secs'],
        'items_per_s': items_s, 'tokens_per_s': tok_s,
        'generate_peak_gb': gen['peak_gb'], 'embed_s': emb['secs'],
        'embed_peak_gb': emb['peak_gb'], 'kernel_a_ratio': a_ratio,
        'contiguous_paged_ratio': paged_ratio,
        'step_batch_width': width, 'int8_rel_err': rel,
        'int8_token_agreement': agree,
        'generate_idle_share': prof['idle_share'],
        'speculative': spec, 'launches': counted}
    for tag in ('bf16', 'int8'):
        for key in ('ms', 'ms_all', 'tree_gb', 'work_gb', 'alone_gb'):
            summary[f'step_{key}_{tag}'] = res[tag][key]
    with open(os.path.join(OUT_DIR, 'batch_infer.json'), 'w') as f:
        json.dump(summary, f, indent=1)
    log(f'[batch_infer] summary {json.dumps(summary)}')
    return counted


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
                eng._graph_launches[key].get('paged_decode', 0):
            fail(f'{tag} dispatch of {key} did not replay its graph')
        return [x.clone() for x in (h.toks, h.lps, h.tis, h.tvs)
                if x is not None]

    zf = torch.zeros(eng.max_batch, device='cuda')
    with torch.no_grad():
        logits, _ = eng._decode.paged_decode_step(
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
    t0 = time.perf_counter()
    second = replay(eng.step_chunk, False)[0][:, rows]
    step_ms = (time.perf_counter() - t0) * 1e3 / eng.step_chunk
    if torch.equal(first, second):
        fail(f'{tag} two replays of the sampled k={eng.step_chunk} graph '
             f'drew the same tokens: {first.tolist()}')
    eng._reset_device_state()
    out = {'graph_vs_eager_max_logprob_err': err,
           'sampled_replays_differ': int((first != second).sum()),
           'step_ms': step_ms}
    log(f'{tag} k=1 greedy graph replay == eager step on {len(rows)} rows '
        f'(tokens and top-5 ids exact, logprobs max|diff| {err:.3e}, tol '
        f'{TOL_GRAPH}); two replays of the sampled k={eng.step_chunk} graph '
        f'differ in {out["sampled_replays_differ"]} of {first.numel()} '
        f'tokens; that replay took {step_ms:.3f} ms a step (host clock to '
        f'its event, {eng.max_batch} rows computed)')
    return out


def is_mla(cfg) -> bool:
    return hasattr(cfg, 'kv_lora_rank')


def decode_module(cfg):
    """The decode functions of the config's cache family: models/mla.py
    (the paged latent pool) for an MLA config, else models/decode.py."""
    from skypilot_tpu_torch.models import decode, mla
    return mla if is_mla(cfg) else decode


def takes_kernels(cfg) -> bool:
    """Whether the config's layers run kernels A and B: not an MLA
    config (its absorbed latent attention is plain PyTorch, as the JAX
    package's is plain XLA) and none of a softcap, a window or sinks
    (the JAX gates send every layer of a model with one of them, global
    layers included, to the plain attention)."""
    return not (is_mla(cfg) or cfg.attn_logit_softcap or
                cfg.sliding_window or cfg.attn_sinks)


def start_engine(model, cfg, params, engine_lib, tag, **knobs):
    """An engine on preset ``model`` (as ``cfg`` has it: a depth cut
    stays cut) with ``knobs`` set before warm-up,
    behind its HTTP server; waits for /health (warm-up: every variant
    captured, the eight step graphs with k x layers B launches each and,
    with speculation on, the two verify graphs with one a layer; no B
    launch where the config does not take kernels). Returns (engine,
    server, base url)."""
    eng = engine_lib.InferenceEngine(model, cfg=cfg, params=params,
                                     device='cuda', seed=0)
    return serve_engine(eng, engine_lib, tag, **knobs)


def serve_engine(eng, engine_lib, tag, **knobs):
    """start_engine's serving half, on an engine already built."""
    for name, val in knobs.items():
        setattr(eng, name, val)
    server = engine_lib.build_app(eng, '127.0.0.1', free_port())
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f'http://127.0.0.1:{server.server_address[1]}'
    eng.start()
    t0 = time.perf_counter()
    while True:
        code, doc = http(base + '/health')
        if code == 200:
            break
        if code != 503 or time.perf_counter() - t0 > 600:
            fail(f'{tag} /health never came up: {code} {doc}')
        time.sleep(0.1)
    layers = eng.cfg.n_layers * takes_kernels(eng.cfg)
    want = {(k, p, t): k * layers for k in (1, engine_lib.MAX_STEP_CHUNK)
            for p in (False, True) for t in (False, True)}
    if eng.spec_k > 0:
        want.update({('verify', t): layers for t in (False, True)})
    got = {key: n.get('paged_decode', 0)
           for key, n in eng._graph_launches.items()}
    if got != want:
        fail(f'{tag} warm-up captured B launches by graph {got}, want '
             f'{want}')
    log(f'{tag} /health ok after {time.perf_counter() - t0:.1f}s (warm-up '
        f'captured {len(eng.graphs)} graphs, B launches captured per graph '
        f'{got}; knobs {knobs or "defaults"}): {doc}')
    return eng, server, base


def stop_engine(eng, server) -> None:
    server.shutdown()
    server.server_close()
    eng.stop()


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


def generate_all(base, docs, vocab: int) -> list:
    """POST every /generate body at once; each answer must be 200 with
    max_new_tokens finite-logprob tokens in the vocabulary."""
    with concurrent.futures.ThreadPoolExecutor(len(docs)) as ex:
        answers = list(ex.map(lambda d: http(base + '/generate', d), docs))
    for d, (code, doc) in zip(docs, answers):
        n_in = len(d.get('tokens', d.get('text', '')))
        if code != 200:
            fail(f'/generate ({n_in} tokens) answered {code}: {doc}')
        toks, n = doc['tokens'], d['max_new_tokens']
        if len(toks) != n or doc['finish_reason'] != 'length' \
                or not all(0 <= t < vocab for t in toks) \
                or len(doc['logprobs']) != n \
                or not all(np.isfinite(doc['logprobs'])):
            fail(f'bad answer for a {n_in}-token prompt: {doc}')
        if 'text' in d and 'text' not in doc:
            fail('text request answered without text')
    return answers


# The admission burst: three waves of greedy /generate requests, each
# sent at once, the next after it is answered. (1) A 1000-token prompt
# with three short ones: 256-token chunks, 3 of 256 and a last of 232
# at bucket 256, and the short ones' first tokens first. (2) One cold
# request of a 512-token system prompt and its own 40-token suffix,
# then four requests sharing the system prompt, each its own suffix:
# prefix hits over the snapshot's pages. (3) Four self-repeating greedy
# prompts (a 6-token pattern 8 times): speculation.
ADMIT_LONG, ADMIT_SHORT, ADMIT_CHUNK = 1000, (20, 40, 60), 256
ADMIT_SYSTEM, ADMIT_SUFFIX, ADMIT_HITS = 512, 40, 4
ADMIT_NEW, SPEC_ROWS, SPEC_NEW = 32, 4, 64
# Verify replay vs 4 sequential eager decode steps, both bf16 through
# kernel B: each path lies within TOL_MODEL x ~6e-2 of the logits' std
# of the fp32 path (the model phase's reading), so the two differ by at
# most ~0.15 std. Tokens must agree where the sequential path's top-2
# margin exceeds that; elsewhere the logits must agree within it.
TOL_SPEC = 0.15


class Watch:
    """Instance wrappers on one engine that record what its admission
    did: each chunk (prompt length, position, tokens left, kernel A
    launches inside it), each first token (prompt length, seconds since
    submit), each prefix hit (p, whether the row's table starts with the
    snapshot's pages, their refcounts while the row holds them)."""

    def __init__(self, eng, build):
        self.chunks, self.firsts, self.hits = [], [], []
        kern_a = build.kernels()['flash_fwd']
        advance, finish, hit = (eng._advance_chunk, eng._finish_admit,
                                eng._admit_with_prefix)

        def advance_chunk(slot):
            s = eng.slots[slot]
            pre = s.get('prefill') if s is not None else None
            n = len(s['req'].tokens) if pre else 0
            pos, a0 = (pre['pos'] if pre else None), kern_a.launches
            advance(slot)
            if pre:
                self.chunks.append((n, pos, n - pos, kern_a.launches - a0))

        def finish_admit(req, slot, *rest):
            self.firsts.append((len(req.tokens),
                                time.perf_counter() - req.t_submit))
            finish(req, slot, *rest)

        def admit_with_prefix(req, p):
            shared = list(eng._prefix_store[tuple(req.tokens[:p])])
            hit(req, p)
            slot = next(i for i, s in enumerate(eng.slots)
                        if s is not None and s['req'] is req)
            self.hits.append((p, eng._table_np[slot, :len(shared)].tolist()
                              == shared,
                              [eng.alloc.refcount(x) for x in shared]))

        eng._advance_chunk = advance_chunk
        eng._finish_admit = finish_admit
        eng._admit_with_prefix = admit_with_prefix


def admission_burst(eng, base, watch, seed: int, tag: str) -> dict:
    """The three waves on a running engine, checked: the long prompt's
    chunks, the first-token order, the hits on shared pages (prefix
    cache on; none with it off), speculation (on: rounds > 0; off:
    none). Returns the burst's end-to-end numbers and counters."""
    vocab = eng.cfg.vocab_size
    rng = np.random.default_rng(seed)
    layers = eng.cfg.n_layers * takes_kernels(eng.cfg)
    n_t = len(eng.timings)
    c0 = {k: getattr(eng, k) for k in ('prefix_hits', 'prefill_chunks',
                                       'spec_rounds', 'spec_proposed',
                                       'spec_accepted', 'step_count')}
    calls0, ver0 = dict(eng.calls), dict(eng.verify_calls)
    for lst in (watch.chunks, watch.firsts, watch.hits):
        lst.clear()

    def body(tokens, n=ADMIT_NEW):
        return {'tokens': tokens, 'max_new_tokens': n}

    t0 = time.perf_counter()
    long_p = rng.integers(0, vocab, ADMIT_LONG).tolist()
    generate_all(base, [body(long_p)] + [
        body(rng.integers(0, vocab, n).tolist()) for n in ADMIT_SHORT], vocab)
    wave1 = list(watch.firsts)
    system = rng.integers(0, vocab, ADMIT_SYSTEM).tolist()
    generate_all(base, [body(system + rng.integers(
        0, vocab, ADMIT_SUFFIX).tolist())], vocab)
    cold = list(watch.firsts[len(wave1):])
    generate_all(base, [body(system + rng.integers(
        0, vocab, ADMIT_SUFFIX).tolist()) for _ in range(ADMIT_HITS)], vocab)
    hits = list(watch.firsts[len(wave1) + len(cold):])
    generate_all(base, [body(rng.integers(0, vocab, 6).tolist() * 8,
                             SPEC_NEW) for _ in range(SPEC_ROWS)], vocab)
    wall = time.perf_counter() - t0
    d = {k: getattr(eng, k) - v for k, v in c0.items()}
    # (1) The long prompt: 4 chunks, A in the first only (or never).
    last = ADMIT_LONG - (ADMIT_LONG - 1) // ADMIT_CHUNK * ADMIT_CHUNK
    want = [(ADMIT_LONG, p, ADMIT_LONG - p, layers if p == 0 else 0)
            for p in range(0, ADMIT_LONG - last + 1, ADMIT_CHUNK)]
    got = [c for c in watch.chunks if c[0] == ADMIT_LONG]
    if got != want:
        fail(f'{tag} chunks of the {ADMIT_LONG}-token prompt (length, '
             f'position, left, A launches): {got}, want {want}')
    order = [n for n, _ in wave1]
    if sorted(order[:-1]) != sorted(ADMIT_SHORT) or order[-1] != ADMIT_LONG:
        fail(f'{tag} first tokens by prompt length {order}: the short '
             f'prompts must come first')
    # (2) Prefix hits on the snapshot's shared pages.
    on = eng.prefix_cache > 0
    if on and (d['prefix_hits'] < 3 or len(watch.hits) != d['prefix_hits']
               or not all(p == ADMIT_SYSTEM and same and min(rc) > 1
                          for p, same, rc in watch.hits)):
        fail(f'{tag} prefix hits {d["prefix_hits"]}: (p, table on the '
             f'snapshot pages, refcounts) {watch.hits}')
    if not on and (d['prefix_hits'] or watch.hits):
        fail(f'{tag} prefix hits with the cache off: {watch.hits}')
    # (3) Speculation.
    if (eng.spec_k > 0) != (d['spec_rounds'] > 0):
        fail(f'{tag} spec_k {eng.spec_k} but {d["spec_rounds"]} '
             f'speculative rounds')
    timings = list(eng.timings)[n_t:]
    n_tok = sum(t[2] for t in timings)
    calls = {str(k): n - calls0.get(k, 0) for k, n in eng.calls.items()
             if n > calls0.get(k, 0)}
    vcalls = {str(k): n - ver0.get(k, 0) for k, n in eng.verify_calls.items()
              if n > ver0.get(k, 0)}
    ms = lambda xs: [round(x * 1e3, 3) for x in xs]   # noqa: E731
    out = {'requests': len(timings), 'wall_s': wall,
           'tok_per_s': n_tok / wall,
           'ttft_ms_median': statistics.median(t[0] for t in timings) * 1e3,
           'tpot_ms_median': statistics.median(
               t[1] for t in timings if t[2] > 1) * 1e3,
           'ttft_ms_long': wave1[-1][1] * 1e3,
           'ttft_ms_short': ms(t for _, t in wave1[:-1]),
           'ttft_ms_cold': ms(t for _, t in cold),
           'ttft_ms_hits': ms(t for _, t in hits),
           'tpot_ms_spec_wave': statistics.median(
               t[1] for t in timings[-SPEC_ROWS:]) * 1e3,
           'chunks': d['prefill_chunks'], 'prefix_hits': d['prefix_hits'],
           'spec_rounds': d['spec_rounds'],
           'spec_proposed': d['spec_proposed'],
           'spec_accepted': d['spec_accepted'],
           'decode_steps': d['step_count'], 'step_calls': calls,
           'verify_calls': vcalls}
    log(f'{tag} admission burst (seed {seed}): {json.dumps(out)}')
    return out


def check_verify(torch, eng, decode, build, tag) -> dict:
    """With the batch loop stopped, on four admitted rows: one replay of
    the greedy verify graph (kernel B at S = K, one launch a layer)
    against the eager ``paged_verify_step`` on the same pool (tokens
    exactly) and against K sequential eager ``paged_decode_step`` calls
    on the same fed tokens (tokens where the sequential top-2 margin
    exceeds TOL_SPEC x std, else logits within it); then ten replays
    under the profiler, whose kernel events must count ten x layers B
    launches, as the engine's count does."""
    rng = np.random.default_rng(13)
    from skypilot_tpu_torch.serve import engine as engine_lib
    for group in eng._admit_groups([
            engine_lib.Request(rng.integers(0, 256, n).tolist(), 64)
            for n in (17, 100, 250, 40)]):
        eng._admit_group(group)
    k, b = eng.spec_k, eng.max_batch
    layers = eng.cfg.n_layers * takes_kernels(eng.cfg)
    rows = [i for i, s in enumerate(eng.slots) if eng._row_active(s)]
    act = torch.zeros(b, dtype=torch.bool, device='cuda')
    act[rows] = True
    fed = torch.from_numpy(rng.integers(0, eng.cfg.vocab_size, (b, k))
                           .astype(np.int32)).cuda()
    fed[:, 0] = eng.last_dev
    eng._spec_dev[:k].copy_(fed.t())
    eng._spec_dev[k].copy_(act.int())
    length0 = eng.cache.length.clone()
    kern_b = build.kernels()['paged_decode']
    b0 = kern_b.launches
    eng._variant(('verify', False))()
    torch.cuda.synchronize()
    if kern_b.launches - b0 != layers:
        fail(f'{tag} verify replay counted {kern_b.launches - b0} B '
             f'launches, not {layers}')
    g_tok = eng._ver_toks.clone()
    with torch.no_grad():
        v_logits, _ = eng._decode.paged_verify_step(
            eng.params, fed, eng.cache, eng.cfg, max_len=eng.max_len,
            active=act)
        seq = []
        for j in range(k):
            logits, _ = eng._decode.paged_decode_step(
                eng.params, fed[:, j].contiguous(), eng.cache, eng.cfg,
                max_len=eng.max_len, active=act)
            seq.append(logits)
    eng.cache.length.copy_(length0)
    seq = torch.stack(seq, 1)[rows]
    v_logits, g_tok = v_logits[rows], g_tok[rows]
    e_tok = torch.argmax(v_logits, -1).int()
    std = float(seq.std())
    top2 = torch.topk(seq, 2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > TOL_SPEC * std
    diff = (v_logits - seq).abs().amax(-1) / std
    bad = (decided & (g_tok != torch.argmax(seq, -1).int())) | \
        (~decided & (diff > TOL_SPEC))
    if not torch.equal(g_tok, e_tok) or bool(bad.any()):
        fail(f'{tag} verify graph tokens {g_tok.tolist()}, eager verify '
             f'{e_tok.tolist()}, sequential '
             f'{torch.argmax(seq, -1).tolist()}; max|diff|/std '
             f'{diff.tolist()} (tol {TOL_SPEC})')
    n_rep = 10
    eng._spec_dev[k].zero_()                 # no row active: trash page
    b0 = kern_b.launches
    prof = profile_device(torch, lambda: [eng._variant(('verify', False))()
                                          for _ in range(n_rep)])
    on_dev, counted = prof['kernel_counts']['paged_decode'], \
        kern_b.launches - b0
    if not on_dev == counted == n_rep * layers:
        fail(f'{tag} {n_rep} verify replays: B {on_dev}x on the device, '
             f'{counted}x by the engine, want {n_rep * layers}')
    eng._reset_device_state()
    out = {'verify_vs_sequential_max_diff_std': float(diff.max()),
           'positions_by_logits': int((~decided).sum()),
           'verify_b_device': on_dev}
    log(f'{tag} verify graph replay (S={k}, {len(rows)} rows) == eager '
        f'verify tokens; vs {k} sequential steps: max|diff|/std '
        f'{out["verify_vs_sequential_max_diff_std"]:.3e} (tol {TOL_SPEC}), '
        f'{out["positions_by_logits"]} of {diff.numel()} positions held by '
        f'logits (top-2 margin under tol); {n_rep} replays ran B '
        f'{on_dev}x on the device (profiler) = {counted}x counted')
    return out


def check_chunked_logits(torch, cfg, params, decode, paging, build,
                         tag) -> dict:
    """A 1000-token prompt's first-token logits after the engine's four
    chunks (``paged_prefill_extend`` at 0, 256, 512 and 768, the last
    of 232 tokens at bucket 256; A in the first only) against one-shot
    prefills of the same prompt: bf16 through kernel A, bf16 plain and
    fp32 plain on the same weights upcast. The chunked path must lie no
    farther from fp32 than the plain bf16 path does (TOL_MODEL)."""
    import dataclasses
    rng = np.random.default_rng(21)
    n, c = ADMIT_LONG, ADMIT_CHUNK
    dec = decode_module(cfg)
    # An MLA config has no kernel path: its one-shot prefill is the
    # plain one.
    plain_kw = {} if is_mla(cfg) else {'attention_impl': 'xla'}
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, n)
                           .astype(np.int32)).cuda()
    maxp = paging.pages_for(decode.bucket_size(n), MODEL_PSZ)
    pc = dec.init_page_pool(cfg, maxp + 1, MODEL_PSZ, 1, maxp,
                            device='cuda')
    pc.table[0] = torch.arange(1, maxp + 1, dtype=torch.int32, device='cuda')
    kern_a, deltas = build.kernels()['flash_fwd'], []
    bucket = decode.bucket_size(n)
    padded = torch.zeros((1, bucket), dtype=torch.int32, device='cuda')
    padded[0, :n] = tok
    lengths = torch.tensor([n], dtype=torch.int32, device='cuda')
    chunk_ms = []
    with torch.no_grad():
        pos = 0
        while True:
            left, a0 = n - pos, kern_a.launches
            s2 = c if left > c else decode.bucket_size(left)
            chunk = torch.zeros((1, s2), dtype=torch.int32, device='cuda')
            chunk[0, :min(left, s2)] = tok[pos:pos + s2]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            chunked = dec.paged_prefill_extend(
                params, chunk, pc, cfg, slot=0, p=pos, lengths=min(left, c))
            torch.cuda.synchronize()
            chunk_ms.append((time.perf_counter() - t0) * 1e3)
            deltas.append(kern_a.launches - a0)
            if left <= c:
                break
            pos += c
        kern, _, _ = dec.prefill(params, padded, cfg, bucket,
                                 lengths=lengths)
        plain, _, _ = dec.prefill(params, padded, cfg, bucket,
                                  lengths=lengths, **plain_kw)
        del pc
        cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
        params32 = decode.cast_params_for_decode(params, cfg32)
        ref, _, _ = dec.prefill(params32, padded, cfg32, bucket,
                                lengths=lengths, **plain_kw)
        del params32
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    want = [cfg.n_layers * takes_kernels(cfg), 0, 0, 0]
    if deltas != want:
        fail(f'{tag} chunks launched A {deltas} times, want {want}')
    if not bool(torch.isfinite(chunked).all()):
        fail(f'{tag} chunked logits not finite')
    std = float(ref.std())
    err = {name: float((x - ref).abs().max()) / std
           for name, x in (('chunked', chunked), ('kernel', kern),
                           ('plain', plain))}
    ratio = err['chunked'] / err['plain']
    log(f'{tag} {n}-token prompt in 4 chunks (A launches {deltas}, '
        f'{[round(x, 3) for x in chunk_ms]} ms each, synchronised, the '
        f'first cold) vs one '
        f'shot: max|diff|/std(fp32 logits): chunked-fp32 '
        f'{err["chunked"]:.3e}, one-shot kernel-fp32 {err["kernel"]:.3e}, '
        f'plain-fp32 {err["plain"]:.3e}; chunked/plain {ratio:.3f} (tol '
        f'{TOL_MODEL}); chunked-vs-kernel argmax '
        f'{"equal" if int(chunked.argmax()) == int(kern.argmax()) else "DIFFER"}')
    if ratio > TOL_MODEL:
        fail(f'{tag} chunked logits {ratio:.2f}x the plain bf16 error > '
             f'{TOL_MODEL}x')
    return {'chunked_vs_plain_error_ratio': ratio, **err}


def phase_serve(torch, model, cfg, params, engine_lib, build, decode,
                paging, label=None) -> dict:
    """The port's engine on preset ``model`` with ``params`` and the
    default knobs (the prefix cache, speculation, 256-token chunks):
    /health (warm-up captures the eight step and two verify graphs),
    then one burst of 4 concurrent /generate requests, one penalized and
    one logprobs=5 streaming /v1/completions request (kernels A and B
    must launch, B's launches inside graph replays), then the burst
    again under the profiler, whose kernel events count B's launches on
    the device; then the admission burst, timed, then again under the
    profiler; then, with the loop stopped, graph replays against the
    eager step and the verify against sequential steps. Then a second
    engine with speculation and the prefix cache off (the first freed)
    takes the same admission burst, and the chunked prefill's logits
    are held against one-shot prefills. An MoE engine does not
    speculate (spec_k 0: eight graphs, no verify to check), so its
    second engine differs by the prefix cache alone and its burst is
    timed, not profiled again (the profiler's pass over gpt-oss-20b's
    ~660k kernel events takes about a minute); and its chunked logits
    are not held against a one-shot prefill: a chunk routes in groups
    of its own tokens, so where capacity binds other choices drop (and
    gpt-oss-20b's fp32 copy would not fit the card).
    A config with sinks, a window or a softcap (gpt-oss), or an MLA
    config (the latent pool: no kernel, as in JAX), must launch neither
    kernel. ``label`` names a cut of the preset in the output. Returns
    the launch counts of the main path (warm-up, the first burst and
    the timed admission burst)."""
    tag = '[serve]' if model == 'llama-1b' else f'[serve {label or model}]'
    kernels = takes_kernels(cfg)
    moe = hasattr(cfg, 'n_experts')
    torch.cuda.reset_peak_memory_stats()
    # The main path starts here: every launch count from 0.
    build.reset_launches()
    eng, server, base = start_engine(model, cfg, params, engine_lib, tag)
    try:
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

        def burst() -> float:
            """Send every request at once, check every answer; seconds."""
            t1 = time.perf_counter()
            with concurrent.futures.ThreadPoolExecutor(len(streams)) as ex:
                sfuts = [ex.submit(sse, base + '/v1/completions', d)
                         for d in streams]
                generate_all(base, reqs, cfg.vocab_size)
                for d, f in zip(streams, sfuts):
                    check_stream(d, f.result())
            return time.perf_counter() - t1

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
            if (in_burst[name] > 0) != kernels:
                fail(f'{tag} kernel {name} launched {in_burst[name]} times '
                     f'while serving (the config takes kernels: {kernels})')
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
                 'cache_family': eng.cache_family(),
                 'pool_bytes_per_token': sum(
                     p[:, 0, 0].numel() * p.element_size()
                     for p in paging._pools(eng.cache).values()),
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
        if (b_device > 0) != kernels or b_device != b_engine:
            fail(f'{tag} kernel B on the device {b_device}x, by the engine '
                 f'{b_engine}x')
        stats.update(idle_share=prof['idle_share'],
                     b_launches_device=b_device,
                     peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        log(f'{tag} ' + json.dumps(stats))
        # The admission burst on the defaults: timed, then profiled.
        watch = Watch(eng, build)
        admit = {'on': admission_burst(eng, base, watch, 31, tag)}
        launches = {n: k.launches for n, k in build.kernels().items()}
        admit['on']['peak_gb'] = torch.cuda.max_memory_allocated() / 1e9
        b0 = build.kernels()['paged_decode'].launches
        prof = profile_device(torch, lambda: admission_burst(
            eng, base, watch, 32, tag + ' profiled'))
        b_engine = build.kernels()['paged_decode'].launches - b0
        b_device = prof['kernel_counts'].get('paged_decode', 0)
        # Reported, not held: over this ~1 s window the profiler has
        # reported fewer B kernel events than launches on an H100 (1472
        # of 2240) where other runs of the same burst matched; the first
        # burst and the verify replays below are held to the device's
        # count.
        log(f'{tag} profiled admission burst: kernel B {b_device}x on the '
            f'device (profiler kernel events), {b_engine}x by the engine')
        if (b_device > 0) != kernels:
            fail(f'{tag} admission burst: kernel B {b_device}x on the '
                 f'device (the config takes kernels: {kernels})')
        admit['on'].update(idle_share=prof['idle_share'],
                           b_launches_device=b_device)
        if build.captured() != captured:
            fail(f'{tag} a kernel was captured after warm-up: '
                 f'{build.captured()} vs {captured}')
        eng.stop()
        check_graph_replay(torch, eng, engine_lib, decode, build, tag)
        if eng.spec_k > 0:
            admit['on'].update(check_verify(torch, eng, decode, build, tag))
    finally:
        stop_engine(eng, server)
    # The server's handler holds the engine: drop both, then the pool.
    del eng, watch, server
    free_card(torch)
    # The same admission burst with speculation and the prefix cache off.
    torch.cuda.reset_peak_memory_stats()
    eng, server, base = start_engine(model, cfg, params, engine_lib,
                                     tag + ' off',
                                     spec_k=0, prefix_cache=0)
    try:
        watch = Watch(eng, build)
        admit['off'] = admission_burst(eng, base, watch, 31, tag + ' off')
        admit['off']['peak_gb'] = torch.cuda.max_memory_allocated() / 1e9
        if not moe:
            prof = profile_device(torch, lambda: admission_burst(
                eng, base, watch, 32, tag + ' off profiled'))
            admit['off']['idle_share'] = prof['idle_share']
    finally:
        stop_engine(eng, server)
    del eng, watch, server
    free_card(torch)
    if not moe:
        admit['chunked'] = check_chunked_logits(torch, cfg, params, decode,
                                                paging, build, tag)
    for key in ('tpot_ms_median', 'tpot_ms_spec_wave', 'ttft_ms_median',
                'tok_per_s',
                'idle_share', 'peak_gb', 'ttft_ms_long', 'ttft_ms_short',
                'ttft_ms_cold', 'ttft_ms_hits', 'spec_rounds',
                'spec_accepted', 'spec_proposed', 'decode_steps'):
        log(f'{tag} admission burst {key}: spec+prefix on '
            f'{admit["on"][key]} | off {admit["off"].get(key)}')
    with open(os.path.join(OUT_DIR, f'admission_{model}.json'), 'w') as f:
        json.dump(admit, f, indent=1)
    return launches


def train_checked(torch, build, tcfg, cfg, tag: str, plain: bool = True):
    """The port's trainer with ``tcfg`` from launch counts of 0: with
    remat 'full', kernel A twice and C and D once per layer per step
    (none where the config takes the plain route: takes_kernels); finite
    losses and grad norms; ms/step and tokens/s; peak memory; then, with
    ``plain``, the plain-attention trainer's losses within TOL_LOSS.
    Returns (the history, the launch counts)."""
    import dataclasses
    from skypilot_tpu_torch.train import trainer
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    hist = trainer.train(tcfg)
    launches = {n: k.launches for n, k in build.kernels().items()}
    peak = torch.cuda.max_memory_allocated() / 1e9
    layers, n = cfg.n_layers, tcfg.total_steps
    k = layers * n if takes_kernels(cfg) else 0
    want = {'flash_fwd': 2 * k, 'flash_dq': k, 'flash_dkv': k,
            'paged_decode': 0}
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
    if not plain:
        return hist, launches

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
    from skypilot_tpu_torch import config
    from skypilot_tpu_torch.train import trainer
    cfg = config.get_config('llama-1b')
    tcfg = trainer.TrainerConfig(
        model='llama-1b', batch_size=TRAIN_B, seq_len=TRAIN_S,
        total_steps=TRAIN_STEPS, warmup_steps=TRAIN_WARMUP, log_every=1,
        device='cuda')
    hist, launches = train_checked(torch, build, tcfg, cfg, '[train]')
    check_resume(tcfg, hist, '[train]')

    # One step's grads three ways on the trainer's initial weights and
    # first batch, then that step under the profiler.
    params, batch = first_step(torch, cfg, TRAIN_B)
    check_grads(torch, cfg, params, batch, '[train]')
    profile_step(torch, cfg, params, batch)
    return launches


def check_resume(tcfg, hist, tag: str) -> None:
    """The trainer run of ``tcfg`` again, cut at step 3 with a checkpoint
    in the git-ignored .smoke_ckpt/ (deleted after), then resumed to its
    end: steps 4.. within TOL_RESUME of the uninterrupted ``hist``."""
    import dataclasses
    import shutil
    from skypilot_tpu_torch.train import trainer
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
    if [r['step'] for r in resumed] != list(range(4, tcfg.total_steps + 1)):
        fail(f'{tag} resume ran steps {[r["step"] for r in resumed]}')
    diff = max(abs(a['loss'] - b['loss']) for a, b in zip(hist[3:], resumed))
    log(f'{tag} resume at step 3 (save, restore, '
        f'{tcfg.total_steps - 3} more steps: {secs:.1f}s): losses '
        f'{[r["loss"] for r in resumed]}, max |diff| vs uninterrupted '
        f'{diff:.4f} (tol {TOL_RESUME})')
    if diff > TOL_RESUME:
        fail(f'{tag} resumed run departs from the uninterrupted one by '
             f'{diff}')


def first_step(torch, cfg, batch_size: int):
    """The trainer's initial weights (seed 0, fp32 master, on the card,
    requiring grad) and its first batch of ``batch_size`` x TRAIN_S."""
    from skypilot_tpu_torch.data import loader
    from skypilot_tpu_torch.data_service import spec as spec_lib
    from skypilot_tpu_torch.models import module_for
    from skypilot_tpu_torch.train import train_lib
    params = module_for(cfg).init_params(
        cfg, torch.Generator(device='cuda').manual_seed(0), 'cuda')
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


def step_grads(torch, cfg, params, batch, routes=None):
    """The grads of CE + router aux (train_lib's step) on ``params`` and
    ``batch`` under ``cfg``, aligned with train_lib.leaves(params) (None
    for a leaf off the path). ``routes``, a RouteLog, is installed over
    the forward and the backward both: under remat 'full' the backward
    recomputes each layer, its routing included."""
    from skypilot_tpu_torch.train import train_lib
    tokens = batch['tokens']
    with routes or contextlib.nullcontext():
        logits, aux = train_lib.forward_with_aux(cfg, params, tokens[:, :-1])
        loss, _ = train_lib.cross_entropy_loss(logits, tokens[:, 1:])
        del logits
        return torch.autograd.grad(loss + aux, train_lib.leaves(params),
                                   allow_unused=True)


def forced_routes(torch, moe, cfg, rec):
    """A RouteLog that hands a remat 'full' run the routes ``rec`` (a
    run of the same batch, no choice dropped) took in its forward: call
    i < L is layer i's forward, call L + j the recompute of layer L-1-j
    (the backward runs the layers last to first). Checks first that
    ``rec``'s own recompute routed as its forward did."""
    L = cfg.n_layers
    order = list(range(L)) + list(range(L - 1, -1, -1))
    if len(rec.calls) != len(order):
        fail(f'{len(rec.calls)} route calls, want {len(order)} (forward '
             f'and recompute of {L} layers)')
    fwd = [idx for idx, _ in rec.calls[:L]]
    for i, layer in enumerate(order[L:], L):
        if not torch.equal(rec.calls[i][0], fwd[layer]):
            fail(f'layer {layer}: the recompute routed apart from the '
                 f'forward')
    return RouteLog(moe, force=lambda i, _: fwd[order[i]], no_drop=True)


def check_grads(torch, cfg, params, batch, tag: str, bound=None,
                force_routes: bool = False) -> float:
    """One step's grads (CE + router aux) three ways on ``params`` and
    ``batch``: the default route (bf16; through the kernels where the
    config lets them), plain attention in bf16, plain attention in fp32.
    Per leaf, the default route's relative error (Frobenius) against
    fp32 may be at most TOL_GRAD times the plain bf16 path's. With
    ``bound`` (a config whose default route is the plain one, so that
    there is no second bf16 path), the default route's own error may be
    at most ``bound`` instead. With ``force_routes`` (an MoE config with
    capacity for every choice), the plain and fp32 runs take the
    default run's routes. Returns the worst ratio, or error."""
    import dataclasses
    from skypilot_tpu_torch.models import moe, weights
    rec = RouteLog(moe, no_drop=True) if force_routes else None
    g_kern = step_grads(torch, cfg, params, batch, rec)

    def routes():
        return forced_routes(torch, moe, cfg, rec) if force_routes else None

    g_plain = (None if bound is not None else step_grads(
        torch, dataclasses.replace(cfg, attention_impl='xla'), params,
        batch, routes()))
    g_ref = step_grads(torch, dataclasses.replace(
        cfg, attention_impl='xla', dtype=torch.float32), params, batch,
        routes())
    names = [p for p, _ in weights.tree_paths(params)]
    worst = 0.0
    for i, (name, gk, gr) in enumerate(zip(names, g_kern, g_ref)):
        if gk is None or not bool(gk.isfinite().all()):
            fail(f'{tag} grad of {name}: missing or non-finite')
        ref_norm = float(gr.norm())
        e_k = float((gk - gr).norm()) / ref_norm
        if bound is not None:
            worst = max(worst, e_k)
            log(f'{tag} grad {name}: |err|/|fp32| {e_k:.3e}')
            continue
        e_p = float((g_plain[i] - gr).norm()) / ref_norm
        worst = max(worst, e_k / e_p)
        log(f'{tag} grad {name}: |err|/|fp32| default {e_k:.3e}, plain '
            f'{e_p:.3e}, ratio {e_k / e_p:.3f}')
    if bound is not None:
        if worst > bound:
            fail(f'{tag} grads: bf16 error {worst:.3e} against fp32 > '
                 f'{bound}')
        log(f'{tag} grads of all {len(names)} leaves: bf16 vs fp32 error '
            f'worst {worst:.3e} (bound {bound}) ok')
        return worst
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


# train_moe: moe-1b at full width cut to MOE_TRAIN_DEPTH of its 12 layers
# (dim 1024, 8 experts top-2, hd 128, 8/4 heads: kernels A, C and D under
# the routed FFN), TRAIN_B x TRAIN_S, TRAIN_STEPS steps; its grads
# checked at capacity n_experts / top_k (no choice dropped) with the
# routes forced. Then gpt-oss-20b at full width
# cut to GPTOSS_TRAIN_LAYERS (one window layer, one full, sinks on both:
# no kernel), one step of 1 x TRAIN_S (44.9 GB of fp32 state).
GPTOSS_TRAIN_LAYERS = 2
# Depth cuts that keep the whole script well inside its time limit on a
# slow host (every check stands at any depth; full depth was checked
# before): gemma-7b's model and serve phases, deepseek-v2-lite's model
# and serve phases, and moe-1b's training, each at half its layers.
GEMMA_SERVE_DEPTH, MLA_SERVE_DEPTH, MOE_TRAIN_DEPTH = 14, 14, 6
# train_mla: deepseek-v2-lite whole (27 layers, 2.607 B params, 41.7 GB of
# fp32 state), MLA_TRAIN_B x TRAIN_S, MLA_TRAIN_STEPS steps; no kernel
# (the latent attention is plain PyTorch, as in JAX). Batch 4: at batch 2
# the trainer's peak was 49.04 GB (H100 80GB HBM3), leaving room.
MLA_TRAIN_B, MLA_TRAIN_STEPS = 4, 4
# Its grads: per leaf, the bf16 step's relative error (Frobenius) against
# the fp32 step at most this. There is no second bf16 path to hold it
# against (no kernel); llama-1b's 16 layers give at most 2.6e-2 a leaf,
# and 27 layers of bf16 rounding may give more: four times that, rounded.
TOL_GRAD_MLA = 0.1


def phase_train_moe(torch, build) -> dict:
    """The port's trainer on moe-1b at MOE_TRAIN_DEPTH layers (remat
    'full') through train_checked, a resume at step 3 (TOL_RESUME), one step's grads
    against the plain bf16 and fp32 paths (TOL_GRAD; capacity for every
    choice, the plain and fp32 runs on the default run's routes), one
    step profiled; then gpt-oss-20b's step (gptoss_train_step). Returns
    moe-1b's launch counts."""
    import dataclasses
    from skypilot_tpu_torch import config
    from skypilot_tpu_torch.train import trainer
    cfg = dataclasses.replace(config.get_config('moe-1b'),
                              n_layers=MOE_TRAIN_DEPTH)
    tcfg = trainer.TrainerConfig(
        model='moe-1b', model_overrides={'n_layers': MOE_TRAIN_DEPTH},
        batch_size=TRAIN_B, seq_len=TRAIN_S,
        total_steps=TRAIN_STEPS, warmup_steps=TRAIN_WARMUP, log_every=1,
        device='cuda')
    free_card(torch)
    log(f'[train_moe] {torch.cuda.memory_allocated() / 1e9:.2f} GB held by '
        f'earlier phases')
    hist, launches = train_checked(torch, build, tcfg, cfg, '[train_moe]')
    check_resume(tcfg, hist, '[train_moe]')
    free_card(torch)
    ample = dataclasses.replace(cfg,
                                capacity_factor=cfg.n_experts / cfg.top_k)
    params, batch = first_step(torch, cfg, TRAIN_B)
    check_grads(torch, ample, params, batch, '[train_moe]',
                force_routes=True)
    free_card(torch)
    profile_step(torch, cfg, params, batch)
    del params, batch
    free_card(torch)
    gptoss_train_step(torch, build)
    return launches


def gptoss_train_step(torch, build) -> None:
    """gpt-oss-20b at full width, GPTOSS_TRAIN_LAYERS layers: one trainer
    step of 1 x TRAIN_S with no kernel launched (sinks and the window send
    every layer to the plain attention, as JAX's gate does), a finite loss
    and grad norm; then one step's grads, every leaf's finite and those
    of the sinks, the q/k/v biases and the clamped experts non-zero."""
    import dataclasses
    from skypilot_tpu_torch import config
    from skypilot_tpu_torch.models import weights
    from skypilot_tpu_torch.train import trainer
    name, depth = 'gpt-oss-20b', GPTOSS_TRAIN_LAYERS
    tag = f'[train_moe {name}]'
    build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    rec = trainer.train(trainer.TrainerConfig(
        model=name, model_overrides={'n_layers': depth}, batch_size=1,
        seq_len=TRAIN_S, total_steps=1, warmup_steps=TRAIN_WARMUP,
        log_every=1, device='cuda'))[0]
    got = {k: v.launches for k, v in build.kernels().items()}
    log(f'{tag} {depth} layers, batch 1x{TRAIN_S}, one step: '
        f'{json.dumps(rec)}; launches {got}; peak memory '
        f'{torch.cuda.max_memory_allocated() / 1e9:.2f} GB')
    if any(got.values()):
        fail(f'{tag} launched kernels {got}: its layers take the plain route')
    if not (np.isfinite(rec['loss']) and np.isfinite(rec['grad_norm'])):
        fail(f'{tag} non-finite loss or grad norm')
    free_card(torch)
    cfg = dataclasses.replace(config.get_config(name), n_layers=depth)
    params, batch = first_step(torch, cfg, 1)
    grads = dict(zip((p for p, _ in weights.tree_paths(params)),
                     step_grads(torch, cfg, params, batch)))
    for path, g in grads.items():
        if g is None or not bool(g.isfinite().all()):
            fail(f'{tag} grad of {path}: missing or non-finite')
    live = {k: float(grads[f"['layers']['{k}']"].norm())
            for k in ('sink', 'bq', 'bk', 'bv', 'w_gate', 'w_up', 'w_down')}
    log(f'{tag} grads of all {len(grads)} leaves finite; norms '
        + ', '.join(f'{k} {v:.3e}' for k, v in live.items()))
    if not all(v > 0 for v in live.values()):
        fail(f'{tag} a grad is zero: {live}')
    del params, batch, grads
    free_card(torch)


def phase_train_mla(torch, build) -> dict:
    """The port's trainer on deepseek-v2-lite whole (remat 'full') through
    train_checked, with no kernel launched and no plain-attention rerun
    (the one path is the plain one); then one step's grads, bf16 against
    fp32, each leaf's error at most TOL_GRAD_MLA; one step profiled.
    Its resume is held on the CPU (tests/test_torch_trainer.py): a
    checkpoint here would be 31 GB. Returns the launch counts (all 0)."""
    from skypilot_tpu_torch import config
    from skypilot_tpu_torch.train import trainer
    cfg = config.get_config('deepseek-v2-lite')
    tcfg = trainer.TrainerConfig(
        model='deepseek-v2-lite', batch_size=MLA_TRAIN_B, seq_len=TRAIN_S,
        total_steps=MLA_TRAIN_STEPS, warmup_steps=TRAIN_WARMUP,
        log_every=1, device='cuda')
    free_card(torch)
    log(f'[train_mla] {torch.cuda.memory_allocated() / 1e9:.2f} GB held by '
        f'earlier phases')
    _, launches = train_checked(torch, build, tcfg, cfg, '[train_mla]',
                                plain=False)
    free_card(torch)
    params, batch = first_step(torch, cfg, MLA_TRAIN_B)
    check_grads(torch, cfg, params, batch, '[train_mla]',
                bound=TOL_GRAD_MLA)
    free_card(torch)
    torch.cuda.reset_peak_memory_stats()
    profile_step(torch, cfg, params, batch)
    log(f'[train_mla] profiled step: peak memory '
        f'{torch.cuda.max_memory_allocated() / 1e9:.2f} GB')
    del params, batch
    free_card(torch)
    return launches


# Seconds the profiler's window stays open before its work starts and
# after it has finished.
PROFILE_MARGIN_S = 0.5
# Kernel-name fragments of the port's kernels, as the profiler shows them.
KERNEL_SYMBOLS = {'paged_decode': 'paged_decode_kernel',
                  'flash_fwd': 'flash_fwd', 'flash_dq': 'flash_dq',
                  'flash_dkv': 'flash_dkv'}


def profile_device(torch, fn) -> dict:
    """Run ``fn`` under torch.profiler (CUDA activity) and print its wall
    time, the port's kernels' events and device time, the idle share,
    and the kernels that took the most device time. Returns the
    idle share (None when the profiler saw no kernel) and the number of
    kernel events of each of KERNEL_SYMBOLS' kernels."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # The profiler keeps a device event only if, on the host clock
        # it converts the card's timestamps to, the event lies inside
        # its window: idle margins on both sides keep fn's first and
        # last kernels in (a window that opens or closes right at them
        # has lost some).
        time.sleep(PROFILE_MARGIN_S)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        time.sleep(PROFILE_MARGIN_S)
    rows = [(e.self_device_time_total / 1e3, e.count, e.key)
            for e in prof.key_averages() if e.self_device_time_total > 0]
    busy_ms = sum(r[0] for r in rows)
    counts = {name: sum(n for _, n, key in rows if sym in key)
              for name, sym in KERNEL_SYMBOLS.items()}
    log(f'[profile] kernel events {sum(r[1] for r in rows)}; by port '
        f'kernel: ' + '; '.join(f'{key[:60]} {n}x {ms:.2f} ms'
                                for ms, n, key in rows
                                if any(sym in key for sym in
                                       KERNEL_SYMBOLS.values())))
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


# The hf phase: llama3.2-1b at full width (16 layers, dim 2048, 32/8
# heads, hd 64, vocab 128256, tied, llama3 rope scaling by 32; random
# bf16 weights from seed 0) exported as an HF checkpoint, imported,
# fine-tuned from the HF directory and served from the trainer's
# checkpoint; then qwen2.5-1.5b (qkv biases, hd 128) exported and
# imported. HF_EOS is Llama 3's <|end_of_text|>, written into the
# export's generation_config.json.
HF_MODEL, HF_QWEN, HF_EOS = 'llama3.2-1b', 'qwen2.5-1.5b', 128001
HF_B, HF_STEPS, HF_NEW = 4, 3, 32
HF_CHAT = {'messages': [{'role': 'system', 'content': 'be brief'},
                        {'role': 'user', 'content': 'Say hi'}],
           'max_tokens': 16, 'temperature': 0}


def hf_round_trip(torch, cfg, out: str, tag: str, eos=None) -> None:
    """Random bf16 params of ``cfg`` exported with the port's
    save_hf_checkpoint into ``out``: its config must import equal to the
    preset, and load_hf_checkpoint onto the card must give every leaf
    bit for bit, bf16 kept."""
    import dataclasses
    from skypilot_tpu_torch.models import hf_export, hf_import, weights
    params = bf16_params(torch, cfg)
    t0 = time.perf_counter()
    hf_export.save_hf_checkpoint(params, cfg, out)
    t_export = time.perf_counter() - t0
    if eos is not None:
        with open(os.path.join(out, 'generation_config.json'), 'w') as f:
            json.dump({'eos_token_id': eos}, f)
    nbytes = os.path.getsize(os.path.join(out, 'model.safetensors'))
    got = hf_import.load_hf_config(out)
    if got != dataclasses.replace(cfg, head_dim=cfg.hd):
        fail(f'{tag} the export\'s config imports as {got}, not the preset')
    t0 = time.perf_counter()
    _, back = hf_import.load_hf_checkpoint(out, device='cuda')
    torch.cuda.synchronize()
    t_import = time.perf_counter() - t0
    mine, theirs = weights.tree_paths(params), weights.tree_paths(back)
    if [p for p, _ in mine] != [p for p, _ in theirs]:
        fail(f'{tag} imported tree {[p for p, _ in theirs]}')
    for (path, a), (_, b) in zip(mine, theirs):
        if b.dtype != a.dtype or b.device.type != 'cuda' or \
                not torch.equal(a.view(torch.int16), b.view(torch.int16)):
            fail(f'{tag} leaf {path}: {b.dtype} {tuple(b.shape)} on '
                 f'{b.device} is not the exported {a.dtype} bit for bit')
    if eos is not None and hf_import.hf_eos_ids(out) != [eos]:
        fail(f'{tag} eos ids {hf_import.hf_eos_ids(out)}')
    n = sum(a.numel() for _, a in mine)
    log(f'{tag} {cfg.n_layers} layers, {n / 1e9:.3f} B params: exported '
        f'{nbytes / 1e9:.2f} GB of safetensors in {t_export:.1f}s, imported '
        f'onto the card in {t_import:.1f}s; config == preset, {len(mine)} '
        f'leaves bit-equal in {a.dtype} ok')
    del params, back
    free_card(torch)


def hf_finetune(torch, build, cfg, hf_dir: str, ck: str) -> dict:
    """The port's trainer from ``hf_dir`` (its fp32 masters read from
    the export), HF_STEPS steps of HF_B x TRAIN_S saving the last into
    ``ck``: kernel launches (train_checked), the first loss against the
    imported tree's cross-entropy on the same batch (TOL_LOSS), one
    complete step on disk. Returns the launch counts."""
    from skypilot_tpu_torch.data import loader
    from skypilot_tpu_torch.data_service import spec as spec_lib
    from skypilot_tpu_torch.models import hf_import
    from skypilot_tpu_torch.train import checkpoints, train_lib, trainer
    _, p32 = hf_import.load_hf_checkpoint(hf_dir, dtype=torch.float32,
                                          device='cuda')
    batch = loader.to_device(spec_lib.load_source(spec_lib.DatasetSpec(
        HF_B, TRAIN_S, cfg.vocab_size)).batch_at_step(0), 'cuda')
    with torch.no_grad():
        tokens = batch['tokens']
        logits, _ = train_lib.forward_with_aux(cfg, p32, tokens[:, :-1])
        ce = float(train_lib.cross_entropy_loss(logits, tokens[:, 1:])[0])
    del logits, p32, batch
    free_card(torch)
    tcfg = trainer.TrainerConfig(
        model=HF_MODEL, hf_dir=hf_dir, batch_size=HF_B, seq_len=TRAIN_S,
        total_steps=HF_STEPS, warmup_steps=TRAIN_WARMUP, log_every=1,
        ckpt_dir=ck, ckpt_every=HF_STEPS, device='cuda')
    t0 = time.perf_counter()
    hist, launches = train_checked(torch, build, tcfg, cfg, '[hf train]',
                                   plain=False)
    secs = time.perf_counter() - t0
    diff = abs(hist[0]['loss'] - ce)
    steps = checkpoints.Checkpointer(ck).all_steps()
    nbytes = sum(os.path.getsize(os.path.join(d, f))
                 for d, _, fs in os.walk(ck) for f in fs)
    log(f'[hf train] --hf-dir run of {HF_STEPS} steps with its save: '
        f'{secs:.1f}s; first loss {hist[0]["loss"]} vs the imported '
        f'tree\'s cross-entropy {ce:.4f} on batch 0: |diff| {diff:.4f} (tol '
        f'{TOL_LOSS}); checkpoint steps {steps}, {nbytes / 1e9:.2f} GB')
    if diff > TOL_LOSS:
        fail(f'[hf train] first loss departs from the imported tree\'s by '
             f'{diff}')
    if steps != [HF_STEPS]:
        fail(f'[hf train] checkpoint steps {steps}, want [{HF_STEPS}]')
    return launches


def held_against_generate(torch, decode, llama, cfg, params, prompts,
                          answers, tag: str) -> None:
    """The engine's greedy tokens for each prompt against
    decode.generate on the same params (the contiguous cache, B=1):
    equal up to the first difference, where both tokens must be near
    the top of the reference's logits at that point (within TOL_SPEC of
    their std: the paged steps through kernel B and the contiguous ones
    round differently in bf16); past it the sequences part."""
    agree = []
    for prompt, got in zip(prompts, answers):
        tok_t = torch.tensor([prompt], dtype=torch.int32, device='cuda')
        want = decode.generate(params, tok_t, cfg, len(got),
                               max_len=len(prompt) + len(got))[0].tolist()
        j = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                 len(got))
        agree.append(j)
        if j == len(got):
            continue
        seq = torch.tensor([prompt + got[:j]], dtype=torch.long,
                           device='cuda')
        with torch.no_grad():
            logits = llama.forward(params, seq, cfg)[0, -1].float()
        gap = float(logits[want[j]] - logits[got[j]]) / float(logits.std())
        if gap > TOL_SPEC:
            fail(f'{tag} a {len(prompt)}-token prompt: token {j} is '
                 f'{got[j]}, decode.generate\'s {want[j]}, {gap:.3f} std '
                 f'apart (tol {TOL_SPEC})')
    log(f'{tag} greedy tokens == decode.generate on the restored params '
        f'for {agree} of {[len(a) for a in answers]} (to the first '
        f'near-tie, within {TOL_SPEC} std) ok')


def hf_serve(torch, build, engine_lib, decode, cfg, ck: str) -> dict:
    """The engine main() builds, on the trainer's checkpoint
    (InferenceEngine(HF_MODEL, ckpt_dir=ck): the params alone, restored
    onto the card), behind build_app: /health (graphs captured),
    4 greedy /generate requests, then /v1/chat/completions (the plain
    template and the byte tokenizer) as JSON and streamed, the stream's
    text equal to the JSON's; kernels A and B must launch. Then the
    greedy tokens against decode.generate. Returns the launch counts
    from the engine's construction on."""
    from skypilot_tpu_torch.models import llama
    tag = '[hf serve]'
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    t0 = time.perf_counter()
    eng = engine_lib.InferenceEngine(HF_MODEL, ckpt_dir=ck, device='cuda',
                                     seed=0)
    log(f'{tag} engine on {ck} (params restored onto the card) built in '
        f'{time.perf_counter() - t0:.1f}s')
    eng, server, base = serve_engine(eng, engine_lib, tag)
    try:
        rng = np.random.default_rng(13)
        prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
                   for n in (17, 130, 300, 700)]
        answers = [doc['tokens'] for _, doc in generate_all(
            base, [{'tokens': p, 'max_new_tokens': HF_NEW}
                   for p in prompts], cfg.vocab_size)]
        code, doc = http(base + '/v1/chat/completions', HF_CHAT)
        c = doc.get('choices', [{}])[0] if code == 200 else {}
        if code != 200 or doc['object'] != 'chat.completion' or \
                c['message']['role'] != 'assistant' or \
                c['finish_reason'] != 'length' or \
                doc['usage']['completion_tokens'] != HF_CHAT['max_tokens']:
            fail(f'{tag} chat answered {code}: {doc}')
        events = sse(base + '/v1/chat/completions',
                     dict(HF_CHAT, stream=True))
        text = ''.join(e['choices'][0]['delta'].get('content', '')
                       for e in events[1:])
        if events[0]['choices'][0]['delta'] != {'role': 'assistant',
                                                'content': ''} or \
                events[-1]['choices'][0]['finish_reason'] != 'length' or \
                text != c['message']['content']:
            fail(f'{tag} chat stream {events[:2]} ... {events[-1:]}: text '
                 f'{text!r} vs {c["message"]["content"]!r}')
        launches = {n: k.launches for n, k in build.kernels().items()}
        log(f'{tag} 4 /generate (17/130/300/700 tokens, {HF_NEW} new), a '
            f'chat completion (prompt {doc["usage"]["prompt_tokens"]} '
            f'tokens) and its stream ({len(events)} events, same text): '
            f'ok; launches {launches}; peak '
            f'{torch.cuda.max_memory_allocated() / 1e9:.2f} GB')
        if not launches['flash_fwd'] or not launches['paged_decode']:
            fail(f'{tag} kernels A and B must launch: {launches}')
    finally:
        stop_engine(eng, server)
    held_against_generate(torch, decode, llama, eng.cfg, eng.params,
                          prompts, answers, tag)
    del eng, server
    return launches


def hf_cli(ck: str) -> None:
    """``python -m skypilot_tpu_torch.serve.engine --model HF_MODEL
    --ckpt-dir ck`` as a user starts it (no --device: the card): /health
    must answer 200, then one chat completion; the process is stopped
    and waited for. Its output goes to chiprun_out/hf_cli.log."""
    port = free_port()
    base = f'http://127.0.0.1:{port}'
    cmd = [sys.executable, '-m', 'skypilot_tpu_torch.serve.engine',
           '--model', HF_MODEL, '--ckpt-dir', ck, '--host', '127.0.0.1',
           '--port', str(port)]
    t0 = time.perf_counter()
    with open(os.path.join(OUT_DIR, 'hf_cli.log'), 'w') as out:
        proc = subprocess.Popen(cmd, cwd=HERE, stdout=out,
                                stderr=subprocess.STDOUT)
        try:
            while True:
                if proc.poll() is not None:
                    fail(f'[hf cli] {" ".join(cmd[1:])} exited '
                         f'{proc.returncode} before /health (see '
                         f'chiprun_out/hf_cli.log)')
                try:
                    code, _ = http(base + '/health', timeout=5)
                except (urllib.error.URLError, OSError):
                    code = None
                if code == 200:
                    break
                if time.perf_counter() - t0 > 300:
                    fail(f'[hf cli] /health not 200 after 300 s: {code}')
                time.sleep(0.5)
            up = time.perf_counter() - t0
            code, doc = http(base + '/v1/chat/completions', HF_CHAT)
            if code != 200 or doc['choices'][0]['finish_reason'] != 'length':
                fail(f'[hf cli] chat answered {code}: {doc}')
        finally:
            proc.terminate()
            try:
                proc.wait(60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
    log(f'[hf cli] {" ".join(cmd[1:6])} (no --device) up in {up:.1f}s, '
        f'a chat completion answered ({doc["usage"]}), stopped: exit '
        f'{proc.returncode}')


def phase_hf(torch, build, engine_lib, decode) -> dict:
    """Real checkpoints: hf_round_trip of llama3.2-1b, hf_finetune from
    its HF directory, hf_serve and hf_cli on the trainer's checkpoint,
    then hf_round_trip of qwen2.5-1.5b; every file under the git-ignored
    .smoke_hf/, removed at the end. Returns the launch counts of the
    paths 'train_hf' and 'serve_hf'."""
    import shutil
    from skypilot_tpu_torch import config
    t0 = time.perf_counter()
    root = os.path.join(HERE, '.smoke_hf')
    shutil.rmtree(root, ignore_errors=True)
    hf_dir = os.path.join(root, 'Llama-3.2-1B')
    ck = os.path.join(root, 'ck')
    paths = {}
    try:
        cfg = config.get_config(HF_MODEL)
        hf_round_trip(torch, cfg, hf_dir, '[hf]', eos=HF_EOS)
        paths['train_hf'] = hf_finetune(torch, build, cfg, hf_dir, ck)
        free_card(torch)
        paths['serve_hf'] = hf_serve(torch, build, engine_lib, decode, cfg,
                                     ck)
        free_card(torch)
        hf_cli(ck)
        shutil.rmtree(hf_dir)
        hf_round_trip(torch, config.get_config(HF_QWEN),
                      os.path.join(root, 'Qwen2.5-1.5B'), '[hf qwen]')
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f'[hf] phase took {time.perf_counter() - t0:.1f}s')
    return paths


def free_card(torch) -> None:
    """Collect what an ended phase left in reference cycles (an engine
    and its server threads hold each other) and give the cached blocks
    back, so that the next phase starts from an empty card."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def bf16_params(torch, cfg):
    """Random params of preset ``cfg`` (dense or MoE) from seed 0, drawn
    on the card leaf by leaf into bf16, as the engine's serving init
    draws them (no leaf whole in fp32)."""
    from skypilot_tpu_torch.models import module_for
    gen = torch.Generator(device='cuda').manual_seed(0)
    params = module_for(cfg).init_params(cfg, gen, 'cuda', dtype=cfg.dtype)
    torch.cuda.empty_cache()
    return params


# Gemma-2/3 at full width, cut in depth: gemma2-9b to 2 layers (one
# local, one global), gemma3-12b to 6 (five local, one global).
SWITCH_DEPTHS = {'gemma2-9b': 2, 'gemma3-12b': 6}
# gpt-oss-20b's model check at full width, cut in depth so that its fp32
# copy fits beside the bf16 one (24 layers would take 84 GB in fp32).
GPTOSS_MODEL_DEPTH = 4
# gpt-oss-20b's serve phase at full width, cut to 12 of its 24 layers
# (six windowed, six global; ~21 GB of bf16 weights) so that the whole
# script keeps a margin inside its time limit.
GPTOSS_SERVE_DEPTH = 12


def phase_gemma_switches(torch, config, decode, paging, pa, build) -> None:
    """gemma2-9b and gemma3-12b at full width and reduced depth: prefill
    (past gemma3's 1024-token window) + 8 decode steps by the default
    routing vs the plain and fp32 paths. Every layer of both carries a
    window (and gemma2 softcaps), so, as in the JAX package, kernels A
    and B must launch zero times."""
    import dataclasses
    for name, depth in SWITCH_DEPTHS.items():
        cfg = dataclasses.replace(config.get_config(name), n_layers=depth)
        params = bf16_params(torch, cfg)
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
                        'timing,model,serve,batch_infer,model_gemma,'
                        'serve_gemma,'
                        'gemma_switches,model_moe,serve_moe,serve_gptoss,'
                        'model_mla,serve_mla,serve_deepseek_v2,'
                        'train_gemma,train,train_moe,train_mla,hf',
                        help='comma-separated '
                        'subset (for '
                        'debugging; the full run is the check)')
    args = parser.parse_args()
    t_main = time.perf_counter()
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
    last = [t_main]

    def lap(done: str) -> None:
        """The wall time of the block of phases just run."""
        now = time.perf_counter()
        if now - last[0] > 0.5:
            log(f'[time] {done}: {now - last[0]:.1f}s (total '
                f'{now - t_main:.1f}s)')
        last[0] = now
    if 'build' in phases:
        phase_build(build)
    lap('build')
    if 'flash' in phases:
        errs['flash_fwd'] = phase_flash(torch, fa)['max_abs_err']
    lap('flash')
    if 'paged' in phases:
        errs['paged_decode'] = phase_paged(torch, pa, paging)['max_abs_err']
    lap('paged')
    if 'flash_bwd' in phases:
        errs.update(phase_flash_bwd(torch, fa))
    lap('flash_bwd')
    if 'timing' in phases:
        times = phase_timing(torch, fa, pa, paging)
    lap('timing')
    if phases & {'model', 'serve', 'batch_infer'}:
        cfg = config.get_config('llama-1b')
        params = bf16_params(torch, cfg)
        if 'model' in phases:
            phase_model(torch, cfg, params, decode, paging, pa, build,
                        'llama-1b')
            phase_verify(torch, cfg, decode, llama, paging, pa)
        if 'serve' in phases:
            by_path['serve'] = phase_serve(torch, 'llama-1b', cfg, params,
                                           engine_lib, build, decode, paging)
            free_card(torch)
        if 'batch_infer' in phases:
            by_path['batch_infer'] = phase_batch_infer(
                torch, cfg, params, decode, paging, pa, build, card)
        del params
        free_card(torch)
    lap('model+serve+batch_infer')
    if 'model_gemma' in phases or 'serve_gemma' in phases:
        import dataclasses
        cfg = dataclasses.replace(config.get_config('gemma-7b'),
                                  n_layers=GEMMA_SERVE_DEPTH)
        label = f'gemma-7b ({GEMMA_SERVE_DEPTH} of 28 layers)'
        params = bf16_params(torch, cfg)
        if 'model_gemma' in phases:
            phase_model(torch, cfg, params, decode, paging, pa, build,
                        label)
            free_card(torch)
        if 'serve_gemma' in phases:
            by_path['serve_gemma'] = phase_serve(
                torch, 'gemma-7b', cfg, params, engine_lib, build, decode,
                paging, label=label)
        del params
        free_card(torch)
    lap('model_gemma+serve_gemma')
    if 'gemma_switches' in phases:
        phase_gemma_switches(torch, config, decode, paging, pa, build)
    lap('gemma_switches')
    if 'model_moe' in phases:
        # gpt-oss-20b at full width cut to 4 layers (2 windowed, 2
        # global): sinks, the window, YaRN, qkv bias and the clamped
        # SwiGLU with the routed FFN, off the kernels, against fp32.
        import dataclasses
        cfg = dataclasses.replace(config.get_config('gpt-oss-20b'),
                                  n_layers=GPTOSS_MODEL_DEPTH)
        params = bf16_params(torch, cfg)
        phase_model(torch, cfg, params, decode, paging, pa, build,
                    f'gpt-oss-20b ({GPTOSS_MODEL_DEPTH} layers)',
                    kernels=False)
        del params
        free_card(torch)
    lap('model_moe')
    if 'model_moe' in phases or 'serve_moe' in phases:
        cfg = config.get_config('moe-1b')
        params = bf16_params(torch, cfg)
        if 'model_moe' in phases:
            phase_model(torch, cfg, params, decode, paging, pa, build,
                        'moe-1b')
            free_card(torch)
        if 'serve_moe' in phases:
            by_path['serve_moe'] = phase_serve(torch, 'moe-1b', cfg, params,
                                               engine_lib, build, decode,
                                               paging)
        del params
        free_card(torch)
    lap('model_moe+serve_moe')
    if 'serve_gptoss' in phases:
        import dataclasses
        cfg = dataclasses.replace(config.get_config('gpt-oss-20b'),
                                  n_layers=GPTOSS_SERVE_DEPTH)
        params = bf16_params(torch, cfg)
        by_path['serve_gptoss'] = phase_serve(
            torch, 'gpt-oss-20b', cfg, params, engine_lib, build, decode,
            paging, label=f'gpt-oss-20b ({GPTOSS_SERVE_DEPTH} of 24 layers)')
        del params
        free_card(torch)
    lap('serve_gptoss')
    if 'model_mla' in phases or 'serve_mla' in phases:
        import dataclasses
        from skypilot_tpu_torch.models import mla
        cfg = dataclasses.replace(config.get_config('deepseek-v2-lite'),
                                  n_layers=MLA_SERVE_DEPTH)
        label = f'deepseek-v2-lite ({MLA_SERVE_DEPTH} of 27 layers)'
        params = bf16_params(torch, cfg)
        if 'model_mla' in phases:
            phase_model_mla(torch, cfg, params, mla, paging, build, label,
                            gen_check=True)
            free_card(torch)
        if 'serve_mla' in phases:
            by_path['serve_mla'] = phase_serve(
                torch, 'deepseek-v2-lite', cfg, params, engine_lib, build,
                decode, paging, label=label)
        del params
        free_card(torch)
    lap('model_mla+serve_mla')
    if 'serve_deepseek_v2' in phases:
        import dataclasses
        from skypilot_tpu_torch.models import mla
        # The model check at 2 layers (fp32 beside bf16), no drops.
        cfg = config.get_config('deepseek-v2')
        cfg = dataclasses.replace(cfg, n_layers=DSV2_MODEL_DEPTH,
                                  capacity_factor=cfg.n_experts / cfg.top_k)
        params = bf16_params(torch, cfg)
        phase_model_mla(torch, cfg, params, mla, paging, build,
                        f'deepseek-v2 ({DSV2_MODEL_DEPTH} of 60 layers, '
                        f'capacity_factor {cfg.capacity_factor:.2f})')
        del params
        free_card(torch)
        cfg = dataclasses.replace(config.get_config('deepseek-v2'),
                                  n_layers=DSV2_SERVE_DEPTH)
        params = bf16_params(torch, cfg)
        by_path['serve_deepseek_v2'] = phase_serve(
            torch, 'deepseek-v2', cfg, params, engine_lib, build, decode,
            paging, label=f'deepseek-v2 ({DSV2_SERVE_DEPTH} of 60 layers)')
        del params
        free_card(torch)
    lap('serve_deepseek_v2')
    if 'train_gemma' in phases:
        by_path['train_gemma'] = phase_train_gemma(torch, build)
        free_card(torch)
    lap('train_gemma')
    if 'train' in phases:
        by_path['train'] = phase_train(torch, build)
        free_card(torch)
    lap('train')
    if 'train_moe' in phases:
        by_path['train_moe'] = phase_train_moe(torch, build)
        free_card(torch)
    lap('train_moe')
    if 'train_mla' in phases:
        by_path['train_mla'] = phase_train_mla(torch, build)
        free_card(torch)
    lap('train_mla')
    if 'hf' in phases:
        by_path.update(phase_hf(torch, build, engine_lib, decode))
        free_card(torch)

    lap('hf')
    replaces = {
        'flash_fwd': 'skypilot_tpu/ops/pallas/flash_attention.py:63',
        'flash_dq': 'skypilot_tpu/ops/pallas/flash_attention.py:159',
        'flash_dkv': 'skypilot_tpu/ops/pallas/flash_attention.py:196',
        'paged_decode': 'skypilot_tpu/ops/pallas/paged_attention.py:48'}
    # Launches: each kernel's count on the main paths it belongs to
    # (serving: SERVE_KERNELS, training: TRAIN_KERNELS), summed.
    paths = {'serve': SERVE_KERNELS, 'serve_gemma': SERVE_KERNELS,
             'serve_moe': SERVE_KERNELS, 'serve_gptoss': SERVE_KERNELS,
             'serve_mla': SERVE_KERNELS, 'serve_deepseek_v2': SERVE_KERNELS,
             'batch_infer': ('flash_fwd',),
             'train': TRAIN_KERNELS, 'train_gemma': TRAIN_KERNELS,
             'train_moe': TRAIN_KERNELS, 'train_mla': TRAIN_KERNELS,
             'train_hf': TRAIN_KERNELS, 'serve_hf': SERVE_KERNELS}
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
            **({'hd64': times[f'{name} hd64']}
               if f'{name} hd64' in times else {}),
            **({'verify_s4': times[f'{name} S=4'],
                'hd256_verify_s4': times[f'{name} hd256 S=4'],
                'hd64_verify_s4': times[f'{name} hd64 S=4']}
               if f'{name} S=4' in times else {}),
            'bound_ms': t.get('bound_ms'), 'bound_by': t.get('bound_by'),
            'library_ms': t.get('library_ms')})
    log(f'[total] {time.perf_counter() - t_main:.1f}s')
    log(f'[device] {card}')
    print(json.dumps({'kernels': rows}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
