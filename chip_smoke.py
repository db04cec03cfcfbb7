"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is swallowed):
  1. build   — nvcc-build every kernel of the serving path from
               skypilot_tpu_torch/csrc/ for sm_90a;
  2. flash   — kernel A vs its plain version at llama-1b shapes;
  3. paged   — kernel B vs its plain version at llama-1b decode shapes;
  4. timing  — kernel, plain-version and library-call times (CUDA
               events, medians) beside each kernel's bound;
  5. model   — llama-1b (full width, random bf16 weights) prefill + 8
               paged decode steps through the kernels vs the plain path;
  6. serve   — the port's engine on llama-1b, 4 concurrent /generate
               requests over HTTP; both kernels' launch counts must grow;
               then the same burst under torch.profiler for the card's
               idle share and its time by kernel.
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
PAGED_STEPS = (1, 4)


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
    b, h, kh, d = 2, 16, 8, 128
    worst = 0.0
    for i, (s, causal) in enumerate(FLASH_CASES):
        q, k, v = flash_inputs(torch, b, s, h, kh, d, seed=100 + i)
        o, lse = fa.flash_attention_lse(q, k, v, causal=causal)
        qf, kf, vf = prescaled_fp32(q, k, v)
        o_ref, lse_ref = fa.flash_attention_ref(qf, kf, vf, causal=causal,
                                                softmax_scale=1.0)
        torch.cuda.synchronize()
        eo, el = max_err(o, o_ref), max_err(lse, lse_ref)
        ok = o_ok(o, o_ref) and el <= TOL_LSE
        log(f'[flash] S=T={s} causal={causal}: o err {eo:.3e} '
            f'(tol {TOL_O} + 2^-8|o|), lse err {el:.3e} (tol {TOL_LSE}) '
            f'{"ok" if ok else "MISMATCH"}')
        if not ok:
            fail(f'flash kernel disagrees at S={s} causal={causal}')
        worst = max(worst, eo)
    return {'max_abs_err': worst}


def paged_inputs(torch, pa, paging, s, seed):
    """llama-1b decode shapes: ragged lengths (one row of length 0),
    shuffled page ids, table tails 0, the step's K/V written first."""
    b, h, kh, hd, psz, maxp = 8, 16, 8, 128, 64, 32
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, maxp * psz - s, size=b)
    lengths[3] = 0
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
    worst = 0.0
    for s in PAGED_STEPS:
        q, kp, vp, table, length, _ = paged_inputs(torch, pa, paging, s,
                                                   seed=7 + s)
        out = pa.paged_decode_attention(q, kp, vp, table, length)
        qf, kf, vf = prescaled_fp32(q, kp, vp)
        ref = pa.paged_decode_attention_ref(qf, kf, vf, table, length,
                                            softmax_scale=1.0)
        torch.cuda.synchronize()
        e = max_err(out, ref)
        ok = o_ok(out, ref)
        log(f'[paged] S={s}: out err {e:.3e} (tol {TOL_O} + 2^-8|o|) '
            f'{"ok" if ok else "MISMATCH"}')
        if not ok:
            fail(f'paged kernel disagrees at S={s}')
        worst = max(worst, e)
    return {'max_abs_err': worst}


def sdpa_gqa(torch, q, k, v, **kw):
    """One SDPA call on [B, H, S, D] tensors with grouped kv heads."""
    import torch.nn.functional as F
    return F.scaled_dot_product_attention(q, k, v, enable_gqa=True, **kw)


def phase_timing(torch, fa, pa, paging) -> dict:
    """Times at the largest main-path shapes of phases 2 and 3."""
    res = {}
    # Kernel A: S=T=2048 causal, B=2, H=16, KH=8, D=128.
    b, s, h, kh, d = 2, 2048, 16, 8, 128
    q, k, v = flash_inputs(torch, b, s, h, kh, d, seed=1)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    ms = time_ms(lambda: fa.flash_attention_lse(q, k, v, causal=True))
    plain = time_ms(lambda: fa.flash_attention_ref(q, k, v, causal=True),
                    iters=3)
    lib = time_ms(lambda: sdpa_gqa(torch, qt, kt, vt, is_causal=True))
    flops = 4 * b * h * s * s * d / 2
    nbytes = 2 * (2 * b * s * h * d + 2 * b * s * kh * d) + 4 * b * h * s
    res['flash_fwd'] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                            **bound(flops, nbytes),
                            shape=f'B={b} S=T={s} H={h} KH={kh} D={d} '
                                  f'causal bf16')
    # Kernel B: B=8, S=1, ragged lengths, psz=64, max_pages=32.
    s1 = 1
    q, kp, vp, table, length, lengths = paged_inputs(torch, pa, paging, s1,
                                                     seed=8)
    ms = time_ms(lambda: pa.paged_decode_attention(q, kp, vp, table,
                                                   length))
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
                                   scale=1.0))
    b8, h8, kh8, hd = q.shape[0], q.shape[2], kp.shape[2], q.shape[3]
    toks = int(np.sum(lengths + s1))
    nbytes = 2 * 2 * toks * kh8 * hd + 2 * 2 * b8 * s1 * h8 * hd + \
        4 * (table.numel() + b8)
    flops = 4 * toks * s1 * h8 * hd
    res['paged_decode'] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                               **bound(flops, nbytes),
                               shape=f'B={b8} S={s1} H={h8} KH={kh8} '
                                     f'hd={hd} psz=64 max_pages=32 '
                                     f'ragged ({toks} K/V tokens) bf16')
    for name, r in res.items():
        log(f'[timing] {name} {r["shape"]}: kernel {r["ms"]:.4f} ms, '
            f'plain {r["plain_ms"]:.4f} ms, library {r["library_ms"]:.4f} '
            f'ms, bound {r["bound_ms"]:.4f} ms ({r["bound_by"]})')
    return res


def bound(flops: float, nbytes: float) -> dict:
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return {'bound_ms': max(t_ops, t_bytes),
            'bound_by': 'operations' if t_ops >= t_bytes else 'bytes'}


def phase_model(torch, cfg, params, decode, paging, pa) -> None:
    """Prefill + 8 paged decode steps three ways, teacher-forced with the
    kernel path's greedy tokens: bf16 through the kernels, bf16 through
    the plain attention, and fp32 through the plain attention on the same
    weights upcast. Both bf16 paths round activations at different
    points, so the check is that the kernel path lies no farther from the
    fp32 path than the plain bf16 path does (TOL_MODEL)."""
    import dataclasses
    lengths = [200, 256, 130, 17]
    b, bucket, max_len, psz, steps = len(lengths), 256, 512, 64, 8
    rng = np.random.default_rng(5)
    tokens = np.zeros((b, bucket), np.int32)
    for r, n in enumerate(lengths):
        tokens[r, :n] = rng.integers(0, cfg.vocab_size, size=n)
    tok_t = torch.from_numpy(tokens).cuda()
    len_t = torch.tensor(lengths, dtype=torch.int32, device='cuda')
    maxp = paging.pages_for(max_len, psz)

    def run(cfg_run, params_run, plain: bool, feed=None):
        logits, ks, vs = decode.prefill(
            params_run, tok_t, cfg_run, max_len, lengths=len_t,
            attention_impl='xla' if plain else 'auto')
        pc = decode.init_page_pool(cfg_run, b * maxp + 1, psz, b, maxp,
                                   device='cuda')
        pc.table.copy_(torch.arange(1, b * maxp + 1, dtype=torch.int32,
                                    device='cuda').reshape(b, maxp))
        paging.scatter_prefill(pc, ks, vs, torch.arange(b, device='cuda'),
                               bucket, len_t)
        fn = pa.paged_attention_step_ref if plain else \
            pa.paged_attention_step
        out, toks = [logits], []
        for i in range(steps):
            nxt = (feed[i] if feed is not None
                   else torch.argmax(out[-1], dim=-1).to(torch.int32))
            toks.append(nxt)
            logits, pc = decode.paged_decode_step(
                params_run, nxt, pc, cfg_run, max_len=max_len,
                attention_fn=fn)
            out.append(logits)
        return out, toks

    kern, toks = run(cfg, params, False)
    plain, _ = run(cfg, params, True, feed=toks)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    params32 = decode.cast_params_for_decode(params, cfg32)
    ref, _ = run(cfg32, params32, True, feed=toks)
    del params32
    torch.cuda.synchronize()
    worst = 0.0
    for i, (a, p, f) in enumerate(zip(kern, plain, ref)):
        if not bool(torch.isfinite(a).all()):
            fail(f'model path: non-finite logits at step {i}')
        std = float(f.std())
        e_k = float((a - f).abs().max()) / std
        e_p = float((p - f).abs().max()) / std
        e_kp = float((a - p).abs().max()) / std
        worst = max(worst, e_k / e_p)
        log(f'[model] step {i} ({"prefill" if i == 0 else "decode"}): '
            f'max|diff|/std(fp32 logits): kernel-fp32 {e_k:.3e}, '
            f'plain-fp32 {e_p:.3e}, kernel-plain {e_kp:.3e}')
    if worst > TOL_MODEL:
        fail(f'model path: kernel error {worst:.2f}x the plain bf16 '
             f'error > {TOL_MODEL}x')
    log(f'[model] llama-1b {cfg.n_layers} layers, {b} rows, prefill bucket '
        f'{bucket} + {steps} decode steps: kernel/plain error ratio worst '
        f'{worst:.3f} (tol {TOL_MODEL}) ok')


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


def phase_serve(torch, cfg, params, engine_lib, build) -> dict:
    eng = engine_lib.InferenceEngine('llama-1b', params=params,
                                     device='cuda', seed=0)
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
        log(f'[serve] /health ok after {time.perf_counter() - t0:.1f}s: '
            f'{doc}')
        rng = np.random.default_rng(11)
        max_new = 32
        reqs = [{'text': 'The quick brown f', 'max_new_tokens': max_new}]
        for n in (130, 300, 700):
            reqs.append({'tokens': rng.integers(0, 256, size=n).tolist(),
                         'max_new_tokens': max_new})

        def burst() -> float:
            """Send every request at once, check every answer; seconds."""
            t1 = time.perf_counter()
            with concurrent.futures.ThreadPoolExecutor(len(reqs)) as ex:
                answers = list(ex.map(
                    lambda d: http(base + '/generate', d), reqs))
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

        wall = burst()
        launches = {n: k.launches for n, k in build.kernels().items()}
        log(f'[serve] 4 concurrent requests (17/130/300/700 tokens, '
            f'{max_new} new each) answered in {wall:.3f}s; launches '
            f'{launches}')
        for name, n in launches.items():
            if n == 0:
                fail(f'kernel {name} was never launched while serving')
        timings = list(eng.timings)
        ttft = [t[0] for t in timings]
        tpot = [t[1] for t in timings]
        n_tok = sum(t[2] for t in timings)
        stats = {'requests': len(timings),
                 'ttft_ms_median': statistics.median(ttft) * 1e3,
                 'ttft_ms_max': max(ttft) * 1e3,
                 'tpot_ms_median': statistics.median(tpot) * 1e3,
                 'tok_per_s': n_tok / wall,
                 'decode_steps': eng.step_count}
        log('[serve] ' + json.dumps(stats))
        # The same burst again under the profiler: how much of the wall
        # time the card spends running kernels. Not the timed burst: the
        # profiler slows the host.
        profile_device(torch, burst)
        return launches
    finally:
        server.shutdown()
        server.server_close()
        eng.stop()


def profile_device(torch, fn) -> None:
    """Run ``fn`` under torch.profiler (CUDA activity) and print its wall
    time, the device time of every kernel and copy it ran, the idle
    share, and the kernels that took the most device time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.self_device_time_total / 1e3, e.count, e.key)
            for e in prof.key_averages() if e.self_device_time_total > 0]
    busy_ms = sum(r[0] for r in rows)
    if not rows:
        log(f'[profile] wall {wall_ms:.1f} ms; device time not measured '
            f'(the profiler saw no kernel)')
        return
    log(f'[profile] wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms, '
        f'idle share {1 - busy_ms / wall_ms:.3f}; by device time:')
    for ms, n, key in sorted(rows, reverse=True)[:8]:
        log(f'[profile]   {ms:8.2f} ms {n:6d}x  {key[:90]}')


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
    parser.add_argument('--phases', default='build,flash,paged,timing,'
                        'model,serve', help='comma-separated subset (for '
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

    errs, times, launches = {}, {}, {}
    if 'build' in phases:
        phase_build(build)
    if 'flash' in phases:
        errs['flash_fwd'] = phase_flash(torch, fa)['max_abs_err']
    if 'paged' in phases:
        errs['paged_decode'] = phase_paged(torch, pa, paging)['max_abs_err']
    if 'timing' in phases:
        times = phase_timing(torch, fa, pa, paging)
    if 'model' in phases or 'serve' in phases:
        cfg = config.get_config('llama-1b')
        gen = torch.Generator(device='cuda').manual_seed(0)
        params = decode.cast_params_for_decode(
            llama.init_params(cfg, gen, 'cuda'), cfg)
        if 'model' in phases:
            phase_model(torch, cfg, params, decode, paging, pa)
        if 'serve' in phases:
            launches = phase_serve(torch, cfg, params, engine_lib, build)

    replaces = {
        'flash_fwd': 'skypilot_tpu/ops/pallas/flash_attention.py:63',
        'paged_decode': 'skypilot_tpu/ops/pallas/paged_attention.py:48'}
    rows = []
    for name, kern in build.kernels().items():
        t = times.get(name, {})
        rows.append({
            'name': name, 'route': 'cuda',
            'source': f'skypilot_tpu_torch/csrc/{kern.source}',
            'replaces': replaces[name],
            'launches': launches.get(name),
            'max_abs_err': errs.get(name),
            'ms': t.get('ms'), 'plain_ms': t.get('plain_ms'),
            'bound_ms': t.get('bound_ms'), 'bound_by': t.get('bound_by'),
            'library_ms': t.get('library_ms')})
    log(f'[device] {card}')
    print(json.dumps({'kernels': rows}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
