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
                 one-shot prefills (bf16 kernel, bf16 plain, fp32). The
                 llama-1b engine is also checked as a serve-plane
                 replica: /metrics scraped before and after the first
                 burst (every family the fleet scraper stores; tokens
                 and TTFT/TPOT counts equal to what the burst
                 received), GET / answering 200, /debug/flight holding
                 dispatch and collect events; then, after the
                 admission burst, an engine.admit fault that the
                 request survives (resurrected once, tokens held
                 against decode.generate), engine.step faults (every 3,
                 at most 2) under 8 concurrent requests, each answering
                 200 or the structured retriable 503, with no graph
                 recaptured, no page leaked and the next request's
                 tokens held against decode.generate, and a greedy
                 n = 2 completion whose two choices are equal and held
                 against decode.generate;
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
  7c. disagg  — disaggregated prefill/decode and the KV host tier on
                 llama-1b whole (the same random bf16 weights; ~2 GB,
                 shared by two engines with ~1 GiB K/V pools each): a
                 decode replica with its handoff receiver (spec_k 0, the
                 host tier on, a 1 s idle sweep) and a prefill replica
                 (spec_k 0, no prefix cache); 700/130/40-token /generate
                 prompts and a 300-token streamed /v1/completions through
                 /disagg/prefill (kernel A > 0 launches there) and
                 /disagg/continue (kernel B > 0 launches in the step
                 graphs there), tokens and streamed text equal to the
                 decode replica alone; export, send and adopt ms per
                 handoff and the blob bytes; both allocators back to
                 every page free; then a 512-token system prompt swept
                 to the host and woken as a prefix hit, its tokens and
                 logprobs equal to the resident hit's and its tokens to
                 the cold run's; kv_spill and kv_wake in the journal;
                 spill and wake ms (chiprun_out/disagg.json);
  7d. kv_int8  — llama-1b whole on int8 K/V pools
                 (SKYTPU_ENGINE_KV_QUANT=int8, the same weights): the
                 JAX bench's quality protocol in bf16 on the int8 and
                 the fp pool (NLL drift <= 0.05 held; argmax agreement
                 printed); the pool's bytes against the fp pool's at
                 385 pages; from launch counts of 0 the engine's
                 warm-up (no B in any graph), the serve burst and the
                 admission burst, every answer checked, A launched and
                 B never (it declines int8 pools, as JAX's kernel does);
                 TPOT, idle share and peak memory beside the serve
                 phase's; a 512-token prefix spilled (codes and scales
                 parked) and woken, its tokens and logprobs equal to
                 the resident hit's; every graph replay equal to its
                 eager body bit for bit (codes and scales included)
                 (chiprun_out/kv_int8.json);
  7f. layouts  — llama-1b whole (the same weights) on the fused paged
                 pool, the contiguous slabs (SKYTPU_ENGINE_PAGED=0) and
                 the gather view baseline (SKYTPU_ENGINE_ATTN=gather) in
                 turn, each from launch counts of 0: warm-up captures
                 the 8 step and 2 verify graphs (B inside the fused
                 pool's only); 700- and 20-token /generate at once, 600
                 tokens, its first 512 resent (a prefix hit), a
                 speculative wave and a stream; A launched in every
                 layout, B only on the fused pool (counted and on the
                 device, in a profiled repeat of the 700- and 20-token
                 wave, which gives the idle share); TPOT, TTFT short and
                 long, peak memory and the cache-bytes counters per
                 layout; every graph replay bit-equal to its eager
                 body; 8 teacher-forced bf16 steps of each layout
                 against fp32 within TOL_MODEL x the plain bf16 error
                 (the largest over the steps); then fp32
                 engines cut to 4 of the 16 layers give identical
                 greedy streams in the three layouts
                 (chiprun_out/layouts.json);
  7e. tp_serve — one replica over a gang: llama-1b whole (bf16, random
                 weights from seed 0) at --mesh tensor=2, two ranks
                 sharing the card over gloo (this script with
                 --tp-worker, each running the engine's main with the
                 gang flags; 8/4 heads, ffn 3584, 16384 vocabulary rows
                 a rank): A at S 700 and 256 and B at S 1 and 4 at those
                 heads against their plain versions; 700- and 20-token
                 /generate at once, a 600-token one, its first 512
                 tokens resent (a prefix hit), a streamed completion;
                 A and B launched on each rank during that traffic; then
                 the leader SIGTERMed (the follower gets 'stop'), both
                 ranks exit 0 after a teacher-forced prefill + 8 paged
                 steps (A 16, B 128 a rank, both ranks' logits the same
                 bits) and 16 free greedy steps in lockstep, against the
                 one-process path and fp32 (TOL_MODEL); TPOT, the
                 collectives' ms a step, boot, peak memory and launches
                 a rank. --tp-model, --tp-ranks (or --tp-mesh, e.g.
                 expert=4), --tp-depth and --tp-backend nccl run it a
                 card a rank on a host with that many cards;
  7f. tp_serve_moe — the same phase on moe-1b whole at --mesh
                 expert=2,tensor=2: four ranks sharing the card, each 4
                 of the 8 experts at 2048 of 4096 hidden units and 4/2
                 heads (B at g = 2); A and B at those heads against
                 their plain versions; a 300- and a 20-token /generate
                 at once and a streamed completion; A and B on every
                 rank; the one-process and fp32 paths teacher-forced
                 with the gang's tokens and routes (RouteLog);
                 chiprun_out/tp_moe_rank<r>.json;
  7g. tp_serve_mla — deepseek-v2-lite at full width cut to 4 of 27
                 layers at --mesh tensor=2: 8 of 16 heads a rank, the
                 latent pool whole; checks (c) and (d), A and B launched
                 0 times; chiprun_out/tp_mla_rank<r>.json;
  8. model_gemma — gemma-7b at full width cut to 6 of its 28 layers
                 (dim 3072, 16/16 heads, hd 256, vocab 256000; random
                 bf16 weights from seed 0, ~9.7 GB): prefill + 8 paged decode steps
                 through kernels A and B vs the plain and fp32 paths;
  9. serve_gemma — the port's engine on gemma-7b, checked as in serve;
 10. gemma_switches — gemma2-9b (2 layers) and gemma3-12b (6 layers:
                 one global) at full width: prefill + decode on the
                 card vs fp32, with kernels A and B launched zero times
                 (softcaps, windows: the plain route, as in JAX);
 11. model_moe — gpt-oss-20b at full width cut to 4 layers, then moe-1b
                 at full width cut to 6 of its 12 layers (dim 1024, 8/4
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
 13. serve_gptoss — the engine on gpt-oss-20b at full width cut to 2
                 of its 24 layers (dim 2880, 64/8 heads, hd 64, 32
                 experts top-4, vocab 201088, sinks, a 128-token window
                 on every other layer, YaRN, clamped SwiGLU, qkv bias;
                 random bf16 weights drawn leaf by leaf), the
                 same bursts: A and B launch zero times (sinks: the
                 plain route);
 14. model_mla — deepseek-v2-lite at full width cut to 2 of its 27
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
                 engine at 2 of 60 layers (160 experts top-6 + 2
                 shared; random bf16 weights), spec_k 0,
                 checked as in serve_moe; A and B launched zero times;
 17. train_gemma — the port's trainer on gemma-7b at full width cut to
                 4 layers, 4 steps of 2 x 2048 tokens: A twice and C, D
                 once per layer per step at head_dim 256; peak memory;
                 grads against the plain and fp32 paths, the loss
                 against the plain-attention trainer; one step under
                 torch.profiler; then one step each of gemma2-9b (2
                 layers) and gemma3-12b (6 layers) with no kernel
                 launched, their grads against fp32;
 18. train     — the port's trainer on llama-1b at full width (4 of its
                 16 layers, to make room for the fsdp phase), 6 steps
                 of 4 x 2048 tokens: A twice and C, D once per layer per
                 step; grads against the plain and fp32 paths, the loss
                 against the plain-attention trainer, a resume at step
                 3; one step under torch.profiler;
 18b. ring     — context-parallel training: (a) kernels C and D's fp32
                 mode at a ring block's shape (sq = tk = 2048, B=2;
                 llama-1b's, gemma-7b's and llama3.2-1b's heads, causal
                 and not) against the plain backward (TOL_BWD) and,
                 rounded to bf16, bit-equal to the bf16 mode, each
                 mode's launch timed; (b) two ranks sharing the card
                 over gloo (this script with --ring-worker): llama-1b's
                 attention at global S = 8192, both layouts, the ring's
                 output and q/k/v grads against kernels A, C and D over
                 the whole sequence in one process, A and C, D (fp32)
                 once a visible block, fwd+bwd ms; what gloo does with
                 CUDA tensors (all_reduce, send/recv) and what a grad
                 bucket and a ring message cost; (c) `python -m
                 skypilot_tpu_torch.train.trainer --mesh sequence=2`
                 with zigzag ring as two processes with the gang env,
                 llama-1b at full width cut to 4 of its 16 layers
                 (room for the fsdp phase), 2 steps of 2 x 4096: launches per rank
                 (A twice, C and D fp32 once per block per layer per
                 step), both replicas' params sha256 equal, ms/step and
                 peak memory per rank, the losses against the
                 single-process trainer on the same batches (TOL_LOSS);
 18c. fsdp     — fully-sharded training, the JAX trainer's default mesh:
                 `python -m skypilot_tpu_torch.train.trainer` as two
                 processes with the gang env and no --mesh (fsdp=2,
                 gloo, one card), llama-1b whole (16 layers, 0.97 B
                 params, 7.8 GB of fp32 state a rank), 3 steps of
                 4 x 2048: each rank's launches (A 96, C 48, D 48), its
                 peak memory below the one-process trainer's, the
                 losses against the one-process trainer on the same
                 batches (TOL_LOSS); the step-3 checkpoint (each rank's
                 chunks) restored on one process, whose cut of the
                 params equals each rank's shard digest, and on the
                 gang, one more step in each (TOL_LOSS); then moe-1b at
                 4 of 12 layers at --mesh data=2, 2 steps: loss
                 (TOL_LOSS) and router aux (TOL_AUX) against one
                 process. Scratch in the git-ignored .smoke_fsdp/
                 (removed); logs chiprun_out/fsdp_<tag><rank>.log;
 19. train_moe — the trainer on moe-1b at full width cut to 4 of its 12
                 layers (8 experts top-2, hd 128),
                 checked as in train: A 48, C 24 and D 24 launches in 6
                 steps; the grads (CE + router aux) at
                 capacity for every choice, the plain and fp32 runs
                 teacher-forced onto the default run's routes in the
                 forward and in the remat recompute; then gpt-oss-20b at
                 full width cut to 2 layers, one step with no kernel, its
                 grads finite and those of the sinks, the q/k/v biases
                 and the clamped experts non-zero;
 20. train_mla — the trainer on deepseek-v2-lite at full width cut to 14
                 of its 27 layers (r 512, vocab 102400), 4 steps of 4 x 2048, no kernel launched
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
                 --ckpt-dir` as a subprocess (no --device) with
                 SKYTPU_ENGINE_MAX_BATCH=16: /health reporting the pool
                 of 16 slots, GET / and one chat; then qwen2.5-1.5b (qkv biases) exported and
                 imported bit for bit. Its files live in the git-ignored
                 .smoke_hf/ and are removed (llama3.2-1b's HF directory
                 after sft, lora and grpo);
 22. sft       — real text: the port's own tokenizer.json reader on the
                 committed fixtures of tests/data (a Llama-3-style and a
                 Qwen2/ChatML-style byte-level BPE): the golden ids of
                 the tokenizers library for every golden text with and
                 without specials, decode(encode(t)) == t, vocab_size,
                 load seconds and encode tokens/s; then chat SFT on
                 llama3.2-1b whole from that HF directory with the
                 Llama-3-style fixture as its tokenizer.json: `trainer
                 --hf-dir --sft-data tests/data/torch_sft_chat.jsonl
                 --lora-rank 16`, 3 steps of 4 x 2048 (A 96, C 48, D 48
                 launches), the first batch's tokens and loss_mask
                 digest as the JAX package's, the first loss against
                 the base's masked cross-entropy through the kernels
                 (TOL_LORA_CE) and the plain attention, the adapters'
                 grads under the SFT mask against the plain attention in
                 bf16 and fp32 (TOL_GRAD); `lora_merge` (tokenizer.json
                 carried); the engine on the merged --hf-dir in-process:
                 family llama3, <|eot_id|> an eos id, a chat completion
                 as JSON and SSE with the templated prompt ids equal to
                 the golden ones (A and B launch); then `python -m
                 skypilot_tpu_torch.serve.engine --hf-dir MERGED` as a
                 subprocess: /health and one chat;
 23. lora      — LoRA on llama3.2-1b whole from that HF directory
                 (exported here when hf does not run): `trainer --hf-dir
                 --lora-rank 16 --lora-dir`, 3 steps of 4 x 2048 (A 96,
                 C 48, D 48 launches), the first loss against the base's
                 cross-entropy on batch 0 (TOL_LORA_CE), the trainer's
                 base bit-equal to the import after the steps, the
                 adapters' size; the state restored from adapters.npz
                 (step, count and non-zero moments from disk), a save
                 timed, the restored adapters' grads against the plain
                 attention in bf16 and fp32 (TOL_GRAD), the trainer
                 resumed for step 4 (saved count 4); `lora_merge` (main, on the card) and the merged
                 directory re-imported: targeted leaves == merge_into,
                 the rest == the base, bit for bit; one step of the
                 restored adapters profiled; the merged tree
                 served by the engine (params, byte tokenizer): 3
                 /generate, A and B launch, greedy tokens against
                 decode.generate;
 24. grpo      — GRPOTrainer on llama3.2-1b whole (fp32 masters from the
                 HF directory): 4 prompts x group 8, 64-token prompts
                 (ragged at the first iteration), 64 new tokens at
                 temperature 1, kl_coef 0.04 against a reference copy,
                 2 iterations (A 5 x layers each: prefill, behaviour and
                 reference scoring, the update's forward and recompute;
                 C, D once a layer); the first mean_ratio 1 within
                 TOL_RATIO; the first iteration's rows scored after its
                 update differ from their behaviour log-probs; rollout
                 and update ms, peak memory, frac_clipped; a third
                 iteration profiled; the first iteration again from the
                 same seeds, its differences by stage printed, and
                 between its rollout and its update A on generate's
                 ragged prefill and on the scoring (TOL_MODEL) and the
                 update's grads (TOL_GRAD) against the plain attention
                 in bf16 and fp32;
 25. harvest   — harvested RL on llama-1b whole (fp32 masters from seed
                 0) through train/rollout/harness.run_harvest: the
                 dispatcher and the learner in this process, two
                 workers as `python -m skypilot_tpu_torch.train.rollout
                 worker` subprocesses on the card; groups of 8 x (64 +
                 64) tokens at temperature 1 rewarded by the fraction
                 of even token ids (every group's rewards vary), 1 s of
                 pacing a group, 2 groups a step, kl_coef 0.04, 28
                 steps, a snapshot at the start and after the last
                 step; one worker SIGKILLed after step 4 (a lease
                 holder), a fresh one spawned after step 6: every step
                 completes, the kill journaled rollout_worker_lost and
                 its leases rollout_lease_reassign, every worker's
                 stats file there, the fresh worker's first group
                 between the degraded and the post-rejoin windows,
                 some group's advantages non-zero; kernel A 2 x layers
                 a group in each worker (prefill, behaviour scoring;
                 its own counts from --stats-file) and, in the learner,
                 A 3 x layers and C, D once a layer a step plus the
                 warm-up's update; replay_losses bit-equal to the live
                 losses; on the last logged batch, A on the learner's
                 scoring (B=16) and the worker's prefill and scoring on
                 its compute cast (B=8) (TOL_MODEL), and the update's
                 grads (TOL_GRAD), against the plain attention; a lease
                 generated twice against the newest snapshot
                 byte-identical, another lease different; run_harvest's
                 samples/s before the kill, degraded and after the
                 rejoin, s/step, publish and restore seconds of the
                 3.89 GB snapshot, peak memory of the learner and each
                 worker. Scratch in the git-ignored .smoke_harvest/
                 (removed).
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
import hashlib
import json
import math
import os
import signal
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
# ragged S; both causal settings; D=64; llama-1b heads at S=2048 (B=2:
# a rank's rows on the fsdp path); then
# D=256 (the Gemma family): groups 1 and 2, ragged S (odd-S lse and
# delta rows), both causal settings, an lse cotangent, gemma-7b's heads
# at S=2048.
BWD_CASES = [(1, 100, 4, 4, 128, True, False),
             (2, 130, 4, 2, 128, False, False),
             (1, 256, 8, 2, 128, True, True),
             (1, 200, 4, 1, 64, True, False),
             (1, 300, 4, 2, 64, False, True),
             (1, 2048, 16, 8, 128, True, False),
             (2, 2048, 16, 8, 128, True, False),
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
# Train phase: llama-1b at full width cut to TRAIN_DEPTH of its 16
# layers (8 since the kv_int8 phase took its room: the resume's two
# checkpoints were most of the phase; 4 since the fsdp phase, which
# trains, saves and restores llama-1b whole), batch 4 x 2048, 6 steps.
TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_WARMUP = 4, 2048, 6, 2
TRAIN_DEPTH = 4
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


def launch_counts(build) -> dict:
    """Each kernel's launches since the last build.reset_launches()."""
    return {n: k.launches for n, k in build.kernels().items()}


def want_launches(build, **counts) -> dict:
    """Every kernel's expected launches: ``counts``, 0 for the rest."""
    return {n: counts.get(n, 0) for n in build.kernels()}


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


def bwd_launches(torch, fa, b=BWD_TIMING_B, shape=TIMING_SHAPE,
                 f32=False):
    """Kernels C and D's inputs at batch ``b`` and ``shape`` (o and lse
    from kernel A, delta from the delta op) and a callable launching
    each alone: the bf16 mode, or with ``f32`` the fp32 mode."""
    s, h, kh, d = (shape[x] for x in ('s', 'h', 'kh', 'd'))
    qs, k, v, o, lse, do, _ = bwd_inputs(torch, fa, b, s, h, kh, d, True,
                                         False, seed=2)
    delta = fa._delta(o, do, None)
    out = torch.float32 if f32 else qs.dtype
    dq = torch.empty_like(qs, dtype=out)
    dk, dv = torch.empty_like(k, dtype=out), torch.empty_like(v, dtype=out)
    ptrs = (qs.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr())
    dims = (b, s, s, h, kh, d, 1, torch.cuda.current_stream().cuda_stream)
    kdq, kdkv = ((fa.DQ_F32_KERNEL, fa.DKV_F32_KERNEL) if f32 else
                 (fa.DQ_KERNEL, fa.DKV_KERNEL))
    return ((qs, k, v, o, lse, do),
            lambda: kdq.launch(*ptrs, dq.data_ptr(), *dims),
            lambda: kdkv.launch(*ptrs, dk.data_ptr(), dv.data_ptr(), *dims))


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
    # C and D in their fp32 mode (ring attention's block grads) at the
    # same three shapes.
    res.update(time_flash_bwd(torch, fa, f32=True))
    res.update({f'{n} hd256': r for n, r in time_flash_bwd(
        torch, fa, BWD_TIMING_B_256, TIMING_SHAPE_256, f32=True).items()})
    res.update({f'{n} hd64': r for n, r in time_flash_bwd(
        torch, fa, BWD_TIMING_B, TIMING_SHAPE_64, f32=True).items()})
    for name, r in res.items():
        lib = ('none' if r['library_ms'] is None else
               f'{r["library_ms"]:.4f} ms')
        log(f'[timing] {name} {r["shape"]}: kernel {r["ms"]:.4f} ms, '
            f'plain {r["plain_ms"]:.4f} ms, library {lib}, bound '
            f'{r["bound_ms"]:.4f} ms ({r["bound_by"]}), '
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


def time_flash_bwd(torch, fa, b=BWD_TIMING_B, shape=TIMING_SHAPE,
                   f32=False) -> dict:
    """Kernels C and D at batch ``b`` and ``shape`` (by default llama-1b
    training: B=4, S=T=2048, H=16, KH=8, D=128; causal, bf16 in), each
    launched alone on inputs that kernel A and the delta op made, in the
    bf16 mode or (``f32``) the fp32 mode. The plain backward and SDPA's
    backward compute dq, dk and dv in one call: their times are the
    pair's and stand on both rows. SDPA runs under each backend that
    takes it; the fastest is the row's library time, named. The fp32
    mode has no library time: no PyTorch call writes fp32 grads of bf16
    operands (SDPA's backward writes the operands' dtype)."""
    s, h, kh, d = (shape[x] for x in ('s', 'h', 'kh', 'd'))
    (qs, k, v, o, lse, do), launch_dq, launch_dkv = bwd_launches(
        torch, fa, b, shape, f32)
    ms_dq = time_ms(launch_dq)
    ms_dkv = time_ms(launch_dkv)
    grad_dtype = torch.float32 if f32 else None
    plain = time_ms(lambda: fa.flash_attention_bwd_ref(
        qs, k, v, o, lse, do, causal=True, grad_dtype=grad_dtype), iters=3)
    if f32:
        lib = dict(library_ms=None, library='none')
    else:
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                      for x in (qs, k, v))
        go = do.transpose(1, 2).contiguous()
        libs = sdpa_bwd_backends(torch, qt, kt, vt, go)
        log(f'[timing] SDPA backward at D={d}: ' + ', '.join(
            f'{n} {ms:.4f} ms' for n, ms in libs.items()))
        lib_name = min(libs, key=libs.get) if libs else None
        lib = dict(library_ms=libs.get(lib_name), library=f'SDPA {lib_name}')
    # Matrix-product FLOPs, halved for causal: dq 3 products (s, dp,
    # ds k), dkv 4 (s, dp, p^T do, ds^T q), each 2*B*H*S*T*D.
    prod = 2 * b * h * s * s * d / 2
    n_in = 2 * (2 * b * s * h * d + 2 * b * s * kh * d) + 4 * 2 * b * h * s
    out_b = 4 if f32 else 2
    mode = 'fp32' if f32 else 'bf16'
    shape = f'B={b} S=T={s} H={h} KH={kh} D={d} causal bf16 in, {mode} out'
    sfx = '_f32' if f32 else ''
    return {
        f'flash_dq{sfx}': dict(ms=ms_dq, plain_ms=plain, shape=shape, **lib,
                               **bound(3 * prod, n_in + out_b * b * s * h * d)),
        f'flash_dkv{sfx}': dict(ms=ms_dkv, plain_ms=plain, shape=shape,
                                **lib, **bound(4 * prod, n_in +
                                               2 * out_b * b * s * kh * d))}


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
    prefill logits, the pool). ``decode`` is the config's cache
    family (decode_module); an MLA config's latents take the pool of
    models/mla.py, whose prefill has no attention choice."""
    b = tok_t.shape[0]
    max_len = shape['max_len']
    maxp = paging.pages_for(max_len, MODEL_PSZ)
    impl_kw = {} if is_mla(cfg) else {'attention_impl': impl}
    logits, ks, vs = decode.prefill(params, tok_t, cfg, max_len,
                                    lengths=len_t, **impl_kw)
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
# path's, route alike. deepseek-v2 serves at 2 of its 60 layers (all 60
# take 488 GB; 2, since the ring phase came, so that the whole script
# keeps a margin inside its time limit: the latent family runs no
# kernel).
DSV2_MODEL_DEPTH, DSV2_SERVE_DEPTH = 2, 2


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


def a_vs_plain(torch, fn, cfg, params, params32, tag: str,
               what: str, whole: bool = False):
    """``fn(cfg, params)`` three ways, without grad: with kernel A
    (``cfg``, 'auto'), with the plain attention in bf16, and with the
    plain attention in fp32 on ``params32``. A's max |diff| to fp32 must
    be no more than TOL_MODEL x the plain bf16 path's; with ``whole``,
    its error over all elements (Frobenius) instead, the max printed.
    Returns (the ratio held, A's output)."""
    import dataclasses
    cfg_x = dataclasses.replace(cfg, attention_impl='xla')
    cfg32 = dataclasses.replace(cfg_x, dtype=torch.float32)
    with torch.no_grad():
        a, x, f = fn(cfg, params), fn(cfg_x, params), fn(cfg32, params32)
    if not bool(torch.isfinite(a).all()):
        fail(f'{tag} kernel A {what}: non-finite')
    std = float(f.std())
    e_a = float((a - f).abs().max()) / std
    e_x = float((x - f).abs().max()) / std
    if whole:
        fro = float((a - f).norm()) / float((x - f).norm())
        log(f'{tag} kernel A, {what}: |diff| to fp32 over all elements, A '
            f'/ plain bf16 {fro:.3f} (tol {TOL_MODEL}); max|diff|/std '
            f'A {e_a:.3e}, plain bf16 {e_x:.3e}, ratio {e_a / e_x:.3f} '
            f'(not held)')
        if fro > TOL_MODEL:
            fail(f'{tag} kernel A {what}: error over all elements {fro:.3f}'
                 f' x the plain bf16 path\'s > {TOL_MODEL}')
        return fro, a
    log(f'{tag} kernel A, {what}: max|diff|/std(fp32): A {e_a:.3e}, plain '
        f'bf16 {e_x:.3e}, ratio {e_a / e_x:.3f} (tol {TOL_MODEL})')
    if e_a > TOL_MODEL * e_x:
        fail(f'{tag} kernel A {what}: max|diff|/std to fp32 {e_a:.3e} > '
             f'{TOL_MODEL} x the plain bf16 path\'s {e_x:.3e}')
    return e_a / e_x, a


def kernel_a_at_batch(torch, cfg, params, decode, batch_infer, batches,
                      padded, emb_recs) -> float:
    """Kernel A at the shapes batch_infer.run gave it: the first and the
    last batch (BI_BATCH of the file's own ragged rows, widths 512 and
    1024). generate's prefill logits (prefill_cache) and embed's pooled
    rows (batch_infer._pooled_hidden through llama.forward) held against
    the plain attention (a_vs_plain, the weights upcast for fp32). The
    pooled rows with A must also be the file's embed records. Returns
    the worst ratio."""
    import dataclasses
    params32 = decode.cast_params_for_decode(
        params, dataclasses.replace(cfg, dtype=torch.float32))
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
            ratio, a = a_vs_plain(
                torch, fn, cfg, params, params32, '[batch_infer]',
                f'batch {i} (B={tok_t.shape[0]}, width {width}), {what}')
            worst = max(worst, ratio)
            if what == 'embed rows':
                file_rows = torch.tensor([by_id[it['id']]
                                          for it in batches[i]])
                d = float((file_rows - a.cpu()).abs().max())
                if d > 1e-6 * float(file_rows.abs().max()):
                    fail(f'batch_infer: batch {i} embed records differ '
                         f'from _pooled_hidden with kernel A by {d:.3e}')
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
        launched = launch_counts(build)
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


def http(url: str, doc=None, timeout: float = 600.0, headers=None):
    data = json.dumps(doc).encode() if doc is not None else None
    req = urllib.request.Request(url, data=data, headers={
        'Content-Type': 'application/json', **(headers or {})})
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
    # Kernel B takes bf16 only, declines int8 pools and serves neither
    # the contiguous slabs nor the gather view: no graph of those
    # engines holds it.
    layers = eng.cfg.n_layers * takes_kernels(eng.cfg) * \
        (eng.kv_quant == 'none') * eng._fused() * \
        (str(eng.cfg.dtype) == 'torch.bfloat16')
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


# The families the serve plane's fleet scraper stores from every replica
# (skypilot_tpu/observe/scrape.py STORED_FAMILIES), and the saturation
# gauges its snapshot falls back on.
REPLICA_FAMILIES = (
    'skytpu_engine_ttft_seconds', 'skytpu_engine_tpot_seconds',
    'skytpu_engine_class_ttft_seconds', 'skytpu_engine_class_tpot_seconds',
    'skytpu_engine_goodput_total', 'skytpu_engine_queue_depth',
    'skytpu_engine_in_flight', 'skytpu_engine_kv_pages_free',
    'skytpu_engine_requests_total', 'skytpu_engine_tokens_total',
    'skytpu_engine_prefix_requests_total')
SATURATION_GAUGES = ('skytpu_engine_queue_depth', 'skytpu_engine_in_flight',
                     'skytpu_engine_kv_pages_free')


def scrape(base: str):
    """GET /metrics: ({family: type}, {sample with its labels: value})."""
    with urllib.request.urlopen(base + '/metrics', timeout=60) as r:
        if r.status != 200:
            fail(f'/metrics answered {r.status}')
        text = r.read().decode()
    types, samples = {}, {}
    for line in text.splitlines():
        if line.startswith('# TYPE '):
            _, _, name, kind = line.split(' ', 3)
            types[name] = kind
        elif line and not line.startswith('#'):
            key, val = line.rsplit(' ', 1)
            samples[key] = float(val)
    return types, samples


def replica_surface(base: str, before: dict, received: int, requests: int,
                    tag: str) -> None:
    """What the serve plane reads of a replica, after a burst of
    ``requests`` that received ``received`` tokens, against the scrape
    ``before`` it: every stored family present, the token and TTFT/TPOT
    counts moved by exactly the burst, the saturation gauges present;
    GET / answering 200; /debug/flight holding dispatch and collect
    events."""
    types, after = scrape(base)
    missing = [f for f in REPLICA_FAMILIES if f not in types]
    if missing:
        fail(f'{tag} /metrics lacks the stored families {missing}')

    def moved(key: str) -> float:
        return after.get(key, 0.0) - before.get(key, 0.0)

    got = {'tokens': moved('skytpu_engine_tokens_total'),
           'ttft': moved('skytpu_engine_ttft_seconds_count'),
           'tpot': moved('skytpu_engine_tpot_seconds_count')}
    if got != {'tokens': received, 'ttft': requests, 'tpot': requests}:
        fail(f'{tag} /metrics moved by {got} over the burst, want '
             f'{received} tokens and {requests} TTFT/TPOT observations')
    absent = [g for g in SATURATION_GAUGES if g not in after]
    if absent:
        fail(f'{tag} /metrics lacks the saturation gauges {absent}')
    code, doc = http(base + '/')
    if code != 200 or doc.get('status') != 'ok':
        fail(f'{tag} GET / answered {code}: {doc}')
    code, flight = http(base + '/debug/flight?limit=0')
    kinds = {e['event'] for e in flight.get('events', [])}
    if code != 200 or not {'dispatch', 'collect'} <= kinds:
        fail(f'{tag} /debug/flight answered {code} with events {kinds}')
    log(f'{tag} replica surface: {len(REPLICA_FAMILIES)} stored families '
        f'present, over the burst tokens_total +{got["tokens"]:.0f}, '
        f'TTFT/TPOT counts +{got["ttft"]:.0f}/+{got["tpot"]:.0f}; GET / '
        f'200; /debug/flight {flight["count"]} events {sorted(kinds)}')


def wait_idle(eng, tag: str) -> None:
    t0 = time.perf_counter()
    while eng.in_flight() or eng.queue_depth():
        if time.perf_counter() - t0 > 120:
            fail(f'{tag} the engine did not go idle')
        time.sleep(0.01)


def replica_faults(torch, eng, base, engine_lib, build, decode, tag) -> dict:
    """Containment on the card, with the loop running: an engine.admit
    fault that the request survives (resurrected once, its greedy tokens
    held against decode.generate); engine.step faults (every 3, at most
    2) under 8 concurrent greedy requests, each answering 200 or the
    structured retriable 503 within its timeout, then the next request's
    tokens held against decode.generate, no graph captured and every
    page not held by the prefix store free; then a greedy n = 2
    completion over HTTP (two equal choices) and through the same
    fan-out in process (two equal token lists, held against
    decode.generate)."""
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.utils import failpoints
    rng = np.random.default_rng(14)
    vocab = eng.cfg.vocab_size
    graphs, captured, resets0 = dict(eng.graphs), build.captured(), \
        eng._resets
    t0 = time.perf_counter()
    prompt = rng.integers(0, vocab, 24).tolist()
    failpoints.arm('engine.admit', once=True)
    try:
        code, doc = http(base + '/generate', {'tokens': prompt,
                                              'max_new_tokens': 16},
                         timeout=120)
    finally:
        failpoints.reset()
    _, samples = scrape(base)
    resurrected = samples.get('skytpu_engine_resurrected_total')
    if code != 200 or len(doc['tokens']) != 16 or \
            eng.resurrected_total != 1 or resurrected != 1:
        fail(f'{tag} after an engine.admit fault: {code} {doc}, '
             f'resurrected {eng.resurrected_total} (metric {resurrected})')
    held_against_generate(torch, decode, llama, eng.cfg, eng.params,
                          [prompt], [doc['tokens']], tag + ' resurrected')
    docs = [{'tokens': rng.integers(0, vocab, n).tolist(),
             'max_new_tokens': 24} for n in (8, 12, 17, 20, 25, 33, 40, 50)]
    failpoints.arm('engine.step', every=3, max_fires=2)
    try:
        with concurrent.futures.ThreadPoolExecutor(len(docs)) as ex:
            answers = list(ex.map(
                lambda d: http(base + '/generate', d, timeout=120), docs))
    finally:
        failpoints.reset()
    outcome = {'ok': 0, 'reset': 0}
    for code, doc in answers:
        err = doc.get('error') if code == 503 else None
        if code == 200 and len(doc['tokens']) == 24:
            outcome['ok'] += 1
        elif isinstance(err, dict) and err['type'] == 'engine_reset_error' \
                and err['retriable'] is True and \
                isinstance(err['tokens_emitted'], int):
            outcome['reset'] += 1
        else:
            fail(f'{tag} under engine.step faults: {code} {doc}')
    resets = eng._resets - resets0
    if not resets:
        fail(f'{tag} engine.step faults armed but no reset ran')
    after = rng.integers(0, vocab, 30).tolist()
    code, doc = http(base + '/generate', {'tokens': after,
                                          'max_new_tokens': 16})
    if code != 200:
        fail(f'{tag} the request after the resets answered {code}: {doc}')
    held_against_generate(torch, decode, llama, eng.cfg, eng.params,
                          [after], [doc['tokens']], tag + ' after resets')
    wait_idle(eng, tag)
    held = sum(len(v) for v in eng._prefix_store.values())
    if eng.graphs != graphs or build.captured() != captured or \
            eng.alloc.used_count != held:
        fail(f'{tag} after the resets: {len(eng.graphs)} graphs (had '
             f'{len(graphs)}), captured {build.captured()} (had '
             f'{captured}), {eng.alloc.used_count} pages used, {held} held '
             f'by the prefix store')
    fan = rng.integers(0, vocab, 20).tolist()
    code, doc = http(base + '/v1/completions', {
        'prompt': fan, 'max_tokens': 16, 'temperature': 0, 'n': 2,
        'ignore_eos': True, 'logprobs': 0})
    ch = doc.get('choices', []) if code == 200 else []
    if len(ch) != 2 or [c['index'] for c in ch] != [0, 1] or \
            ch[0]['text'] != ch[1]['text'] or \
            ch[0]['logprobs']['token_logprobs'] != \
            ch[1]['logprobs']['token_logprobs'] or \
            doc['usage']['completion_tokens'] != 32:
        fail(f'{tag} greedy n=2 completion answered {code}: {doc}')
    results, n_out = engine_lib._submit_many(
        eng, [fan], 16, (0.0, None, None, 0.0, 0.0), (), 2, 2, False,
        'other')
    if n_out != 32 or results[0][0] != results[1][0]:
        fail(f'{tag} greedy n=2 fan-out: {results[0][0]} vs '
             f'{results[1][0]} ({n_out} tokens)')
    held_against_generate(torch, decode, llama, eng.cfg, eng.params,
                          [fan], [results[0][0]], tag + ' n=2')
    out = {'resets': resets, **outcome,
           'seconds': time.perf_counter() - t0}
    log(f'{tag} containment on the card: engine.admit fault resurrected '
        f'to completion; engine.step faults: {resets} reset(s), '
        f'{outcome["ok"]} answered 200 and {outcome["reset"]} the '
        f'structured 503, no graph recaptured, no page leaked; n=2 '
        f'choices equal; {out["seconds"]:.1f}s')
    return out


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

    @staticmethod
    def detach(eng) -> None:
        """Give the engine its own methods back (a wake from the host
        tier admits a hit whose key the store does not hold yet)."""
        for name in ('_advance_chunk', '_finish_admit',
                     '_admit_with_prefix'):
            delattr(eng, name)


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


SERVE_NEW = 32
# The serve phases' burst statistics by model (the kv_int8 phase prints
# its own beside llama-1b's).
SERVE_STATS = {}


def serve_requests():
    """The serve burst: 4 /generate (a short text, 130, 300 and 700
    tokens, SERVE_NEW new each) and 2 streamed /v1/completions (a
    penalized greedy one of 48 tokens, a logprobs=5 sampled one of
    40)."""
    rng = np.random.default_rng(11)
    reqs = [{'text': 'The quick brown f', 'max_new_tokens': SERVE_NEW}]
    for n in (130, 300, 700):
        reqs.append({'tokens': rng.integers(0, 256, size=n).tolist(),
                     'max_new_tokens': SERVE_NEW})
    streams = [
        {'prompt': rng.integers(0, 256, size=60).tolist(),
         'max_tokens': 48, 'temperature': 0, 'presence_penalty': 0.5,
         'frequency_penalty': 0.5, 'logprobs': 0, 'ignore_eos': True,
         'stream': True},
        {'prompt': 'Once upon a time', 'max_tokens': 40,
         'temperature': 0.8, 'top_p': 0.9, 'logprobs': 5,
         'ignore_eos': True, 'stream': True}]
    return reqs, streams


def run_burst(base, reqs, streams, vocab: int) -> float:
    """Send every request at once, check every answer; seconds."""
    t1 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(streams)) as ex:
        sfuts = [ex.submit(sse, base + '/v1/completions', d)
                 for d in streams]
        generate_all(base, reqs, vocab)
        for d, f in zip(streams, sfuts):
            check_stream(d, f.result())
    return time.perf_counter() - t1


def burst_stats(eng, paging, wall: float, calls: dict) -> dict:
    """A burst's end-to-end numbers from the engine's timings."""
    timings = list(eng.timings)
    ttft = [t[0] for t in timings]
    tpot = [t[1] for t in timings]
    by_k = {}
    for key, n in calls.items():
        by_k[key[0]] = by_k.get(key[0], 0) + n
    return {'requests': len(timings),
            'cache_family': eng.cache_family(),
            'pool_bytes_per_token': sum(
                p[:, 0, 0].numel() * p.element_size()
                for p in paging.pool_tensors(eng.cache).values()),
            'ttft_ms_median': statistics.median(ttft) * 1e3,
            'ttft_ms_max': max(ttft) * 1e3,
            'tpot_ms_median': statistics.median(tpot) * 1e3,
            'tok_per_s': sum(t[2] for t in timings) / wall,
            'decode_steps': eng.step_count,
            'device_calls_by_k': by_k,
            'graph_replays': sum(calls.values())}


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
        max_new = SERVE_NEW
        reqs, streams = serve_requests()

        def burst() -> float:
            return run_burst(base, reqs, streams, cfg.vocab_size)

        replica = model == 'llama-1b'
        if replica:
            before = scrape(base)[1]
        at_health = launch_counts(build)
        captured = build.captured()
        calls0 = dict(eng.calls)
        wall = burst()
        launches = launch_counts(build)
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
        if replica:
            replica_surface(base, before,
                            sum(d['max_new_tokens'] for d in reqs) +
                            sum(d['max_tokens'] for d in streams),
                            len(reqs) + len(streams), tag)
        stats = burst_stats(eng, paging, wall, calls)
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
        log(f'{tag} burst TPOT median {stats["tpot_ms_median"]:.3f} ms, '
            f'idle share {stats["idle_share"]:.3f} on {gpu_line()}')
        SERVE_STATS[model] = stats
        # The admission burst on the defaults: timed, then profiled.
        watch = Watch(eng, build)
        admit = {'on': admission_burst(eng, base, watch, 31, tag)}
        launches = launch_counts(build)
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
        if replica:
            admit['replica_faults'] = replica_faults(
                torch, eng, base, engine_lib, build, decode, tag)
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


# The disagg phase: four greedy requests of distinct prompt buckets (so
# that no two share a grouped prefill), the 700-token one chunked, one
# streamed through /v1/completions; then a 512-token system prompt with
# two 40-token tails for the spill tier. The host tier's budget and idle
# threshold of the decode replica.
DISAGG_LENS, DISAGG_STREAM_LEN, DISAGG_NEW = (700, 130, 40), 300, 32
DISAGG_HOST_MB, DISAGG_IDLE_S = 1024, 1.0


class Timed:
    """Wall seconds of each call of ``obj.name`` (an instance or module
    attribute), the card synchronised before the clock stops; ``note``
    may record something about each call's result."""

    def __init__(self, torch, obj, name: str, note=None):
        self.obj, self.name, self.orig = obj, name, getattr(obj, name)
        self.seconds, self.notes = [], []

        def wrapper(*args, **kw):
            t0 = time.perf_counter()
            out = self.orig(*args, **kw)
            torch.cuda.synchronize()
            self.seconds.append(time.perf_counter() - t0)
            if note is not None:
                self.notes.append(note(out))
            return out
        setattr(obj, name, wrapper)

    def restore(self) -> None:
        setattr(self.obj, self.name, self.orig)

    def ms(self) -> list:
        return [round(s * 1e3, 3) for s in self.seconds]


def wait_for(cond, tag: str, what: str, timeout: float = 30.0) -> None:
    t0 = time.perf_counter()
    while not cond():
        if time.perf_counter() - t0 > timeout:
            fail(f'{tag} {what} did not happen within {timeout:.0f}s')
        time.sleep(0.02)


def phase_disagg(torch, cfg, params, engine_lib, build) -> dict:
    """Disaggregated prefill/decode and the host spill tier on llama-1b at
    full width (the serve phase's random bf16 weights, shared by both
    engines). A decode replica (handoff receiver, spec_k 0, the host
    tier at DISAGG_HOST_MB with a DISAGG_IDLE_S idle sweep) and a
    prefill replica (spec_k 0, no prefix cache). The reference: each
    prompt's greedy tokens by /generate (or /v1/completions) on the
    decode replica alone. Then each prompt through /disagg/prefill on
    the prefill replica (kernel A: its launches counted there from 0)
    and /disagg/continue on the decode replica, all four at once
    (kernel B in the step graphs: its launches counted there from 0):
    tokens (and the streamed text) equal to the reference; export, send
    and adopt ms per handoff and the blob bytes. Both allocators back to
    every page free once the idle sweep has spilled the decode side's
    prefix entries. Then the spill tier: a system prompt + tail a cold
    (captured), + tail b a device-tier hit, swept to the host, + tail b
    again woken as a prefix hit: its tokens and logprobs equal the
    resident hit's and the cold run's (tail b on the prefill replica,
    whose 256-token chunks compute what the hit computes); kv_spill and
    kv_wake in the journal; spill and wake seconds. Returns the launch
    counts of the disagg run."""
    import tempfile
    from skypilot_tpu_torch.observe import journal
    from skypilot_tpu_torch.serve.disagg import handoff as handoff_lib
    tag = '[disagg]'
    db_dir = tempfile.mkdtemp(prefix='smoke_journal_')
    old_db = os.environ.get('SKYTPU_OBSERVE_DB')
    os.environ['SKYTPU_OBSERVE_DB'] = os.path.join(db_dir, 'journal.db')
    t_phase = time.perf_counter()
    dec = engine_lib.InferenceEngine('llama-1b', cfg=cfg, params=params,
                                     device='cuda', seed=0)
    dec.handoff_port = free_port()
    dec, dsrv, dbase = serve_engine(
        dec, engine_lib, tag + ' decode', spec_k=0,
        kv_host_mb=DISAGG_HOST_MB, kv_idle_spill_s=DISAGG_IDLE_S)
    pre, psrv, pbase = start_engine('llama-1b', cfg, params, engine_lib,
                                    tag + ' prefill', spec_k=0,
                                    prefix_cache=0)
    timers = []
    try:
        rng = np.random.default_rng(17)
        vocab = cfg.vocab_size
        gens = [{'tokens': rng.integers(0, vocab, size=n).tolist(),
                 'max_new_tokens': DISAGG_NEW} for n in DISAGG_LENS]
        stream = {'prompt': rng.integers(0, vocab,
                                         size=DISAGG_STREAM_LEN).tolist(),
                  'max_tokens': DISAGG_NEW, 'temperature': 0,
                  'ignore_eos': True}
        # The reference, one request at a time on the decode replica.
        ref = [http(dbase + '/generate', d) for d in gens]
        ref.append(http(dbase + '/v1/completions', stream))
        if any(code != 200 for code, _ in ref):
            fail(f'{tag} reference answered {[c for c, _ in ref]}')
        want = [doc['tokens'] for _, doc in ref[:-1]]
        want_text = ref[-1][1]['choices'][0]['text']
        wait_idle(dec, tag)
        exports = Timed(torch, pre, '_export_slot', note=lambda blob: sum(
            t.numel() * t.element_size() for t in (blob['a'], blob['b'])))
        sends = Timed(torch, handoff_lib, 'send')
        adopts = Timed(torch, dec, '_admit_adopted')
        timers = [exports, sends, adopts]
        target = {'X-Skytpu-Handoff-Target':
                  f'127.0.0.1:{dec.handoff_port}'}
        stage1 = [('/generate', d) for d in gens] + \
            [('/v1/completions', {**stream, 'stream': True})]
        build.reset_launches()
        with concurrent.futures.ThreadPoolExecutor(len(stage1)) as ex:
            firsts = list(ex.map(lambda od: http(
                f'{pbase}/disagg/prefill?orig={od[0]}', od[1],
                headers=target), stage1))
        at_prefill = launch_counts(build)
        bad = [(c, d) for c, d in firsts if c != 200 or 'handoff' not in d]
        if bad:
            fail(f'{tag} /disagg/prefill answered {bad}')
        build.reset_launches()

        def cont(i):
            hid = firsts[i][1]['handoff']['id']
            orig = stage1[i][0]
            if orig == '/v1/completions':
                return sse(f'{dbase}/disagg/continue?orig={orig}',
                           {'handoff_id': hid, 'stream': True})
            return http(f'{dbase}/disagg/continue?orig={orig}',
                        {'handoff_id': hid})

        with concurrent.futures.ThreadPoolExecutor(len(stage1)) as ex:
            seconds = list(ex.map(cont, range(len(stage1))))
        at_decode = launch_counts(build)
        got = []
        for code, doc in seconds[:-1]:
            if code != 200:
                fail(f'{tag} /disagg/continue answered {code}: {doc}')
            got.append(doc['tokens'])
        got_text = ''.join(e['choices'][0]['text'] for e in seconds[-1])
        finish = seconds[-1][-1]['choices'][0]['finish_reason']
        if got != want or got_text != want_text or finish != 'length':
            fail(f'{tag} two-stage tokens differ from one engine\'s: '
                 f'{got} vs {want}; stream {got_text!r} ({finish}) vs '
                 f'{want_text!r}')
        if any(f[1]['handoff']['first_token'] != w[0]
               for f, w in zip(firsts, want)):
            fail(f'{tag} first tokens {firsts} vs {want}')
        kinds = ('flash_fwd', 'paged_decode')
        launches = {n: at_prefill[n] + at_decode[n] for n in at_prefill}
        log(f'{tag} 4 requests ({DISAGG_LENS} tokens by /generate, '
            f'{DISAGG_STREAM_LEN} streamed by /v1/completions, '
            f'{DISAGG_NEW} new each) through /disagg/prefill and '
            f'/disagg/continue: tokens and streamed text equal to the '
            f'decode replica alone; launches on the prefill replica '
            f'{ {k: at_prefill[k] for k in kinds} }, on the decode replica '
            f'{ {k: at_decode[k] for k in kinds} }')
        if at_prefill['flash_fwd'] <= 0 or at_decode['paged_decode'] <= 0:
            fail(f'{tag} kernel A on the prefill replica '
                 f'{at_prefill["flash_fwd"]}x, B on the decode replica '
                 f'{at_decode["paged_decode"]}x: both must launch')
        for t in timers:
            t.restore()
        timers = []
        blob = exports.notes
        log(f'{tag} per handoff: export ms {exports.ms()}, send ms '
            f'{sends.ms()}, adopt ms {adopts.ms()}, blob bytes {blob} on '
            f'{gpu_line()}')
        # Pages: every page of both pools back once the decode side's
        # prefix entries (the reference's captures) have been swept to
        # the host tier.
        wait_idle(pre, tag)
        wait_for(lambda: not dec._prefix_store and not dec.in_flight(),
                 tag, 'the idle sweep of the decode replica')
        free = {'prefill': (pre.alloc.free_count, pre.n_pages - 1),
                'decode': (dec.alloc.free_count, dec.n_pages - 1)}
        if any(a != b for a, b in free.values()):
            fail(f'{tag} pages not conserved (free, baseline): {free}')
        log(f'{tag} pages conserved (free, baseline): {free}; host tier '
            f'{dec.host_store.occupancy()}')
        # The spill tier on the decode replica.
        system = rng.integers(0, vocab, size=512).tolist()
        tail_a = rng.integers(0, vocab, size=40).tolist()
        tail_b = rng.integers(0, vocab, size=40).tolist()
        spills = Timed(torch, dec, '_spill_entry')
        wakes = Timed(torch, dec, '_wake_prefix_entry')
        timers = [spills, wakes]

        def gen(base, tokens):
            code, doc = http(base + '/generate', {
                'tokens': tokens, 'max_new_tokens': DISAGG_NEW})
            if code != 200:
                fail(f'{tag} /generate answered {code}: {doc}')
            return doc['tokens'], doc['logprobs']

        key = tuple(system)
        hits0 = dec.prefix_hits
        gen(dbase, system + tail_a)
        resident = gen(dbase, system + tail_b)
        if dec.prefix_hits != hits0 + 1:
            fail(f'{tag} the resent system prompt was not a prefix hit')
        wait_for(lambda: key in dec.host_store and
                 key not in dec._prefix_store, tag,
                 'the idle sweep of the system prompt')
        host_pages = dec.host_store.pages_spilled()
        woken = gen(dbase, system + tail_b)
        cold = gen(pbase, system + tail_b)
        if dec.prefix_hits != hits0 + 2 or not wakes.seconds:
            fail(f'{tag} the spilled system prompt was not woken as a hit '
                 f'({dec.prefix_hits - hits0} hits, {len(wakes.seconds)} '
                 f'wakes)')
        if woken != resident or woken[0] != cold[0]:
            fail(f'{tag} woken tokens {woken[0]} vs resident hit '
                 f'{resident[0]} vs cold {cold[0]}')
        kinds_j = {e['kind'] for e in journal.query(since=0)}
        if not {'kv_spill', 'kv_wake'} <= kinds_j:
            fail(f'{tag} journal kinds {kinds_j}')
        log(f'{tag} spill tier: the 512-token system prompt swept to the '
            f'host (the tier then held {host_pages} pages) after '
            f'{DISAGG_IDLE_S}s idle and '
            f'woken as a prefix hit: tokens and logprobs equal to the '
            f'resident hit, tokens equal to the cold run; journal kinds '
            f'{sorted(kinds_j)}; spill ms {spills.ms()}, wake ms '
            f'{wakes.ms()} on {gpu_line()}')
        log(f'{tag} phase {time.perf_counter() - t_phase:.1f}s')
        with open(os.path.join(OUT_DIR, 'disagg.json'), 'w') as f:
            json.dump({'export_ms': exports.ms(), 'send_ms': sends.ms(),
                       'adopt_ms': adopts.ms(), 'blob_bytes': blob,
                       'spill_ms': spills.ms(), 'wake_ms': wakes.ms(),
                       'launches_prefill': at_prefill,
                       'launches_decode': at_decode, 'card': gpu_line()},
                      f, indent=1)
    finally:
        for t in timers:
            t.restore()
        stop_engine(dec, dsrv)
        stop_engine(pre, psrv)
        if old_db is None:
            os.environ.pop('SKYTPU_OBSERVE_DB', None)
        else:
            os.environ['SKYTPU_OBSERVE_DB'] = old_db
        import shutil
        shutil.rmtree(db_dir, ignore_errors=True)
    return launches


# The kv_int8 phase: llama-1b whole on int8 K/V pools
# (SKYTPU_ENGINE_KV_QUANT=int8, JAX's other default knobs). The quality
# protocol of the JAX bench (4 rows, a 24-token prompt, 16 forced steps,
# pages of 8, 8 a row) in bf16 on the int8 and the fp pool; the pool's
# bytes against the fp pool's at the same n_pages; the serve burst and
# the admission burst (a chunked 1000-token prompt, prefix hits,
# speculation) with kernel A counted and kernel B at 0 (it declines
# int8 pools); a 512-token system prompt spilled to the host tier and
# woken; then, the loop stopped, the step and verify graph replays
# against their eager bodies, bit for bit.
KV_INT8_HOST_MB, KV_INT8_IDLE_S = 1024, 1.0
QUALITY_SHAPE = dict(rows=4, prompt=24, cont=16, page_size=8, max_pages=8)


def int8_quality(torch, cfg, params, decode) -> dict:
    """The teacher-forced protocol on the int8 and the fp pool: the NLL
    drift (gated at the JAX band), and, reported, the teacher-forced
    argmax agreement and the greedy chain's, with the fp run's top-2
    margins where the argmax differs."""
    from skypilot_tpu_torch.models import quality
    q = QUALITY_SHAPE
    rng = np.random.default_rng(19)
    prompts, forced = (torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (q['rows'], n)).astype(np.int32)).cuda()
        for n in (q['prompt'], q['cont']))
    rows = {mode: quality.quality_family(
        decode, params, cfg, prompts, forced, mode, q['page_size'],
        q['max_pages']) for mode in ('none', 'int8')}
    fp, i8 = rows['none'], rows['int8']
    drift = abs(i8['nll'] - fp['nll'])
    same = fp['tf_argmax'] == i8['tf_argmax']
    out = {'nll_fp': fp['nll'], 'nll_int8': i8['nll'], 'nll_drift': drift,
           'tf_argmax_agreement': float(same.float().mean()),
           'greedy_agreement': quality.greedy_match(
               i8['greedy_tokens'], fp['greedy_tokens']),
           'fp_margins_where_argmax_differs':
               fp['tf_margin'][~same].tolist(),
           'fp_margin_median': float(fp['tf_margin'].median())}
    log(f'[kv_int8] quality protocol (JAX bench: {q}) in bf16: '
        f'{json.dumps(out)}; bands: NLL drift <= '
        f'{quality.QUALITY_NLL_BAND} (held), greedy agreement >= '
        f'{quality.QUALITY_GREEDY_MATCH_MIN} (reported)')
    if not np.isfinite(i8['nll']) or drift > quality.QUALITY_NLL_BAND:
        fail(f'[kv_int8] int8 NLL {i8["nll"]} vs fp {fp["nll"]}: drift '
             f'{drift:.4f} > {quality.QUALITY_NLL_BAND}')
    return out


def int8_pool_bytes(torch, eng, decode, paging) -> dict:
    """The int8 pool's bytes (codes and sidecars) against an fp pool of
    the same n_pages (shapes only, on the meta device)."""
    def nbytes(pool):
        return sum(t.numel() * t.element_size()
                   for t in paging.pool_tensors(pool).values())
    i8 = nbytes(eng.cache)
    fp = nbytes(decode.init_page_pool(eng.cfg, eng.n_pages, eng.page_size,
                                      eng.max_batch, eng._max_pages,
                                      device='meta'))
    page_i8, page_fp = i8 // eng.n_pages, fp // eng.n_pages
    out = {'n_pages': eng.n_pages, 'int8_bytes': i8, 'fp_bytes': fp,
           'ratio': i8 / fp, 'int8_pages_in_fp_bytes': fp // page_i8,
           'pages_per_gb_int8': 1e9 / page_i8,
           'pages_per_gb_fp': 1e9 / page_fp}
    hd = eng.cfg.hd
    log(f'[kv_int8] pool: {json.dumps(out)} (predicted ratio '
        f'{(hd + 4) / (2 * hd):.6f}: hd {hd} int8 codes + one fp32 scale '
        f'against {hd} bf16 values)')
    if i8 * 2 * hd != fp * (hd + 4) or not paging.quantized(eng.cache):
        fail(f'[kv_int8] pool bytes {i8} vs fp {fp}: not the int8 layout')
    return out


def int8_spill_wake(eng, base, vocab: int, tag: str) -> dict:
    """A 512-token system prompt with two tails: the second a resident
    prefix hit; the idle sweep then spills the entry to the host tier
    (its blob: codes and scales of k and v); the second tail again is
    woken as a hit and answers the resident hit's tokens and
    logprobs."""
    from skypilot_tpu_torch.utils import framed
    rng = np.random.default_rng(21)
    system = rng.integers(0, vocab, size=512).tolist()
    tails = [rng.integers(0, vocab, size=40).tolist() for _ in range(2)]

    def gen(tokens):
        code, doc = http(base + '/generate', {'tokens': tokens,
                                               'max_new_tokens': 32})
        if code != 200:
            fail(f'{tag} /generate answered {code}: {doc}')
        return doc['tokens'], doc['logprobs']

    key = tuple(system)
    hits0 = eng.prefix_hits
    gen(system + tails[0])
    resident = gen(system + tails[1])
    if eng.prefix_hits != hits0 + 1:
        fail(f'{tag} the resent system prompt was not a prefix hit')
    eng.kv_idle_spill_s = KV_INT8_IDLE_S
    try:
        wait_for(lambda: key in eng.host_store and
                 key not in eng._prefix_store, tag,
                 'the idle sweep of the system prompt')
    finally:
        eng.kv_idle_spill_s = 0.0
    blob = eng.host_store._entries[key][0]
    _, parked = framed._decode_payload(blob)
    names = sorted(parked)
    scale_bytes = sum(np.asarray(parked[n]).nbytes for n in names
                      if n.endswith('scale'))
    if names != ['k', 'k_scale', 'v', 'v_scale'] or \
            any(np.asarray(parked[n]).dtype != np.int8 for n in ('k', 'v')):
        fail(f'{tag} parked arrays {names}, dtypes '
             f'{[str(np.asarray(parked[n]).dtype) for n in names]}')
    woken = gen(system + tails[1])
    if eng.prefix_hits != hits0 + 2 or woken != resident:
        fail(f'{tag} woken hit ({eng.prefix_hits - hits0} hits): tokens '
             f'{woken[0]} vs resident {resident[0]}')
    out = {'blob_bytes': len(blob), 'scale_bytes': scale_bytes,
           'pages': 512 // eng.page_size, 'arrays': names}
    log(f'{tag} spill tier: the 512-token system prompt parked '
        f'{json.dumps(out)} and woken as a prefix hit: tokens and '
        f'logprobs equal to the resident hit')
    return out


def phase_kv_int8(torch, cfg, params, engine_lib, build, decode,
                  paging) -> dict:
    """llama-1b (the serve phase's random bf16 weights) on int8 K/V
    pools: the quality protocol, then the int8 engine from launch
    counts of 0: warm-up (eight step and two verify graphs, no kernel B
    in any), the serve burst and the admission burst, each answer
    checked, kernel A launched and B not; TPOT, idle share and peak
    memory beside the fp serve phase's; the pool's bytes; the spill
    tier; the graphs against their eager bodies. Returns the launch
    counts of the main path (warm-up and both bursts)."""
    tag = '[kv_int8]'
    t_phase = time.perf_counter()
    result = {'card': gpu_line(), 'quality': int8_quality(
        torch, cfg, params, decode)}
    free_card(torch)
    torch.cuda.reset_peak_memory_stats()
    # The main path starts here: every launch count from 0.
    build.reset_launches()
    eng, server, base = start_engine('llama-1b', cfg, params, engine_lib,
                                     tag, kv_quant='int8',
                                     kv_host_mb=KV_INT8_HOST_MB)
    try:
        result['pool'] = int8_pool_bytes(torch, eng, decode, paging)
        reqs, streams = serve_requests()
        calls0 = dict(eng.calls)
        wall = run_burst(base, reqs, streams, cfg.vocab_size)
        calls = {key: n - calls0.get(key, 0) for key, n in eng.calls.items()
                 if n > calls0.get(key, 0)}
        stats = burst_stats(eng, paging, wall, calls)
        b0 = build.kernels()['paged_decode'].launches
        prof = profile_device(torch, lambda: run_burst(
            base, reqs, streams, cfg.vocab_size))
        stats.update(idle_share=prof['idle_share'],
                     b_launches_device=prof['kernel_counts'].get(
                         'paged_decode', 0),
                     b_launches_counted=build.kernels()[
                         'paged_decode'].launches - b0,
                     peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        watch = Watch(eng, build)
        admit = admission_burst(eng, base, watch, 31, tag)
        launches = launch_counts(build)
        watch.detach(eng)
        result.update(burst=stats, admission=admit, launches=launches)
        fp = SERVE_STATS.get('llama-1b')
        for name in ('tpot_ms_median', 'ttft_ms_median', 'tok_per_s',
                     'idle_share', 'peak_gb'):
            log(f'{tag} burst {name}: int8 {stats[name]} | fp serve '
                f'{fp[name] if fp else "not run"}')
        log(f'{tag} launches since 0 (warm-up, serve burst, admission '
            f'burst) {launches}; B on the device in the profiled burst '
            f'{stats["b_launches_device"]} on {gpu_line()}')
        if launches['flash_fwd'] <= 0 or launches['paged_decode'] != 0 or \
                stats['b_launches_device'] or stats['b_launches_counted']:
            fail(f'{tag} kernel A {launches["flash_fwd"]}x (must launch), '
                 f'B {launches["paged_decode"]}x counted and '
                 f'{stats["b_launches_device"]}x on the device (must be 0: '
                 f'it declines int8 pools)')
        if admit['prefix_hits'] < 3 or admit['chunks'] < 4 or \
                admit['spec_rounds'] <= 0:
            fail(f'{tag} admission burst took the paths: {admit}')
        result['spill'] = int8_spill_wake(eng, base, cfg.vocab_size, tag)
        eng.stop()
        result['graphs_bit_equal'] = layout_graphs_vs_eager(
            torch, eng, engine_lib, tag)
    finally:
        stop_engine(eng, server)
    del eng, server, watch
    free_card(torch)
    result['seconds'] = time.perf_counter() - t_phase
    log(f'{tag} phase {result["seconds"]:.1f}s')
    with open(os.path.join(OUT_DIR, 'kv_int8.json'), 'w') as f:
        json.dump(result, f, indent=1, default=str)
    return launches


# The layouts phase: llama-1b whole (16 layers, dim 2048, 8 slots, page
# 64, max_len 2048; the serve phase's random bf16 weights from seed 0)
# on the fused paged pool, the contiguous slabs (SKYTPU_ENGINE_PAGED=0)
# and the gather baseline (SKYTPU_ENGINE_ATTN=gather) in turn, each
# served tp_serve's traffic (700 and 20 tokens at once, then 600, then
# its first 512 resent with a new tail: a prefix hit) with a speculative
# wave and a stream, LAYOUT_NEW tokens a request (32 in the wave).
LAYOUTS = (('fused', True, 'fused'), ('contiguous', False, 'fused'),
           ('gather', True, 'gather'))
LAYOUT_NEW = 16
# The fp32 greedy streams of the three layouts: llama-1b at full width
# cut to 4 of its 16 layers (the only cut of this phase; three fp32
# engines at 16 layers would take ~13 GB more and ~30 s).
LAYOUT_F32_DEPTH = 4
# Teacher-forced decode steps against fp32: four rows of one prompt
# bucket (one admission group), 8 steps.
LAYOUT_FORCED_LENS, LAYOUT_FORCED_STEPS = (200, 256, 130, 150), 8


def layout_traffic(base: str, vocab: int, tag: str,
                   first_wave: bool = False) -> list:
    """The phase's requests, each answer checked: 700 and 20 tokens at
    once (alone with ``first_wave``), 600, then its first 512 with a new
    40-token tail, two self-repeating greedy prompts at once, a streamed
    greedy /v1/completions. Returns every answer's tokens, the stream's
    text pieces last."""
    rng = np.random.default_rng(21)

    def prompt(n):
        return [int(t) for t in rng.integers(1, vocab, n)]

    def body(tokens, n=LAYOUT_NEW):
        return {'tokens': tokens, 'max_new_tokens': n}
    system = prompt(600)
    answers = generate_all(base, [body(prompt(700)), body(prompt(20))], vocab)
    if first_wave:
        return [doc['tokens'] for _, doc in answers]
    answers += generate_all(base, [body(system)], vocab)
    answers += generate_all(base, [body(system[:512] + prompt(40))], vocab)
    answers += generate_all(base, [body(prompt(6) * 8, 2 * LAYOUT_NEW)
                                   for _ in range(2)], vocab)
    events = sse(base + '/v1/completions', {
        'prompt': 'One replica, three layouts.', 'max_tokens': LAYOUT_NEW,
        'temperature': 0, 'ignore_eos': True, 'stream': True})
    if events[-1]['choices'][0].get('finish_reason') != 'length':
        fail(f'{tag} the streamed completion did not finish: {events[-1]}')
    return [doc['tokens'] for _, doc in answers] + \
        [[e['choices'][0]['text'] for e in events]]


def layout_state(eng) -> list:
    """Every tensor a step or verify call reads and writes besides its
    outputs: the cache (pool or slabs), lengths, ``last``, counts."""
    return [*eng.kv_tensors().values(), eng.cache.length, eng.last_dev,
            eng.counts]


def layout_graphs_vs_eager(torch, eng, engine_lib, tag) -> int:
    """With the loop stopped, on two admitted greedy rows (presence set,
    for the penalized variants): every captured variant replayed from
    its graph and run as its eager body from the same state; the two
    rows' outputs, the cache, lengths, last and counts bit for bit (a
    pool's trash page aside: inactive rows write it in no set order,
    and on the fused pool they read it back, so their outputs are
    left out too). Returns the number of variants held."""
    rng = np.random.default_rng(15)
    eng._admit_group([engine_lib.Request(rng.integers(0, 256, n).tolist(),
                                         64) for n in (100, 120)])
    b, k = eng.max_batch, eng.spec_k
    act = torch.zeros(b, device='cuda')
    act[:2] = 1
    eng._ctrl.zero_()
    eng._ctrl[0] = act
    eng._ctrl[4, :2] = 0.5
    fed = torch.from_numpy(rng.integers(0, eng.cfg.vocab_size,
                                        (b, k)).astype(np.int32)).cuda()
    fed[:, 0] = eng.last_dev
    eng._spec_dev[:k].copy_(fed.t())
    eng._spec_dev[k].copy_(act.int())
    snap = [t.clone() for t in layout_state(eng)]
    n_kv = len(eng.kv_tensors())
    lo = 1 if eng.paged else 0
    for key in sorted(eng.graphs, key=str):
        if key[0] == 'verify':
            outs = [x[:2] for x in (eng._ver_toks, eng._ver_lps,
                                    eng._ver_tis, eng._ver_tvs)]
        else:
            outs = [x[:key[0], :2] for x in (eng._out_toks, eng._out_lps,
                                             eng._out_tis, eng._out_tvs)]
        runs = []
        for run in (eng.graphs[key].replay, eng._body(key)):
            for t, v in zip(layout_state(eng), snap):
                t.copy_(v)
            run()
            torch.cuda.synchronize()
            state = layout_state(eng)
            runs.append([t.clone() for t in outs] +
                        [t[:, lo:].clone() for t in state[:n_kv]] +
                        [t.clone() for t in state[n_kv:]])
        differ = [i for i, (x, y) in enumerate(zip(*runs))
                  if not torch.equal(x, y)]
        if differ:
            fail(f'{tag} graph {key} vs its eager body: tensors {differ} '
                 f'differ (outputs 0-3, then the cache, length, last, '
                 f'counts)')
    eng._reset_device_state()
    log(f'{tag} {len(eng.graphs)} graph replays == their eager bodies bit '
        f'for bit on 2 rows (outputs, cache, lengths, last, counts)')
    return len(eng.graphs)


def forced_prompts(torch, vocab: int):
    """The teacher-forced rows: right-padded prompts [4, 256], lengths."""
    rng = np.random.default_rng(16)
    bucket = max(LAYOUT_FORCED_LENS)
    tok = np.zeros((len(LAYOUT_FORCED_LENS), bucket), np.int32)
    for i, n in enumerate(LAYOUT_FORCED_LENS):
        tok[i, :n] = rng.integers(1, vocab, n)
    return (torch.from_numpy(tok).cuda(),
            torch.tensor(LAYOUT_FORCED_LENS, dtype=torch.int32,
                         device='cuda'))


def plain_forced(torch, decode, cfg, params, tok_t, len_t, max_len,
                 feed=None):
    """The contiguous plain path (plain prefill, plain steps) on the
    forced rows: the logits of each of LAYOUT_FORCED_STEPS steps fed
    ``feed`` (None: its own greedy tokens) and the tokens fed."""
    import dataclasses
    cfg = dataclasses.replace(cfg, attention_impl='xla')
    with torch.no_grad():
        logits, cache = decode.prefill_cache(params, tok_t, cfg, max_len,
                                             lengths=len_t)
        out, fed = [], []
        for i in range(LAYOUT_FORCED_STEPS):
            nxt = (feed[i] if feed is not None else
                   torch.argmax(logits, dim=-1).to(torch.int32))
            fed.append(nxt)
            logits, cache = decode.decode_step(params, nxt, cache, cfg)
            out.append(logits.float())
    return out, fed


def layout_forced(torch, eng, engine_lib, tok_t, len_t, feed) -> list:
    """The engine's own step in its layout (``_step_logits`` on
    ``_open_view``'s cache, the view scattered back) on the forced rows,
    admitted as one group, fed ``feed``: the logits of each step."""
    eng._reset_device_state()
    eng._admit_group([engine_lib.Request(
        tok_t[i, :int(n)].tolist(), 64) for i, n in enumerate(len_t)])
    rows = len(LAYOUT_FORCED_LENS)
    act = torch.zeros(eng.max_batch, dtype=torch.bool, device='cuda')
    act[:rows] = True
    out = []
    with torch.no_grad():
        for nxt in feed:
            last = eng.last_dev.clone()
            last[:rows] = nxt
            view, start = eng._open_view()
            logits = eng._step_logits(view, last, act)
            eng._close_view(view, start, 1, act)
            out.append(logits[:rows].float())
    eng._reset_device_state()
    return out


def phase_layouts(torch, cfg, params, engine_lib, build, decode) -> dict:
    """The port's engine on llama-1b in each of the three K/V layouts,
    each from launch counts of 0 (warm-up: the eight step and two verify
    graphs, k x layers B launches each on the fused pool and none on the
    others; then the traffic): every answer checked, a prefix hit and
    speculative rounds in each, chunks on the paged layouts only, kernel
    A launched in every layout and B on the fused pool alone (counted,
    and on the device in a profiled repeat of the first wave); TPOT,
    TTFT short and long, the idle share (of that repeat), peak memory
    and the cache-bytes counters per layout.
    With the loop stopped: every graph against its eager body, and 8
    teacher-forced steps of each layout against the fp32 plain path:
    the largest error over the steps within TOL_MODEL x the plain bf16
    path's. Then fp32 engines at
    LAYOUT_F32_DEPTH layers serve the traffic again: the same greedy
    streams in all three layouts. Returns kernel A's launches on the two
    new layouts' main paths."""
    import dataclasses
    tag0 = '[layouts]'
    t_phase = time.perf_counter()
    result = {'card': gpu_line(), 'layouts': {}}
    tok_t, len_t = forced_prompts(torch, cfg.vocab_size)
    max_len = min(cfg.max_seq_len, 2048)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    params32 = decode.cast_params_for_decode(params, cfg32)
    ref, feed = plain_forced(torch, decode, cfg32, params32, tok_t, len_t,
                             max_len)
    del params32
    plain, _ = plain_forced(torch, decode, cfg, params, tok_t, len_t,
                            max_len, feed)
    free_card(torch)
    new_a = 0
    for name, paged, attn in LAYOUTS:
        tag = f'{tag0} {name}'
        t_layout = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        # This layout's main path starts here: every launch count from 0.
        build.reset_launches()
        eng = engine_lib.InferenceEngine('llama-1b', cfg=cfg, params=params,
                                         device='cuda', seed=0)
        eng.paged, eng.attn_backend = paged, attn
        eng, server, base = serve_engine(eng, engine_lib, tag)
        firsts = {}
        finish = eng._finish_admit

        def finish_admit(req, slot, *rest, finish=finish):
            firsts.setdefault(len(req.tokens),
                              time.perf_counter() - req.t_submit)
            finish(req, slot, *rest)
        eng._finish_admit = finish_admit
        try:
            c0 = {k: getattr(eng, k) for k in ('prefix_hits',
                                               'prefill_chunks',
                                               'spec_rounds')}
            m = eng.metrics
            r0, w0 = m.cache_read.value(), m.cache_written.value()
            n_t = len(eng.timings)
            t0 = time.perf_counter()
            streams = layout_traffic(base, cfg.vocab_size, tag)
            wall = time.perf_counter() - t0
            launches = launch_counts(build)
            d = {k: getattr(eng, k) - v for k, v in c0.items()}
            timings = list(eng.timings)[n_t:]
            stats = {
                'wall_s': wall,
                'tpot_ms_median': statistics.median(
                    t[1] for t in timings if t[2] > 1) * 1e3,
                'ttft_ms_short': firsts[20] * 1e3,
                'ttft_ms_long': firsts[700] * 1e3,
                'cache_bytes_read': m.cache_read.value() - r0,
                'cache_bytes_written': m.cache_written.value() - w0,
                'peak_gb': torch.cuda.max_memory_allocated() / 1e9,
                'launches': launches, **d}
            t_prof = time.perf_counter()
            # The idle share of the first wave (700 and 20 tokens at
            # once): the profiler's pass over the whole traffic's ~100k
            # kernel events took ~20 s a layout.
            prof = profile_device(torch, lambda: layout_traffic(
                base, cfg.vocab_size, tag + ' profiled', first_wave=True))
            stats['profiled_s'] = time.perf_counter() - t_prof
            stats['idle_share'] = prof['idle_share']
            stats['b_launches_device'] = prof['kernel_counts'].get(
                'paged_decode', 0)
            fused = name == 'fused'
            if launches['flash_fwd'] <= 0 or \
                    (launches['paged_decode'] > 0) != fused or \
                    (stats['b_launches_device'] > 0) != fused:
                fail(f'{tag} kernel A {launches["flash_fwd"]}x (must '
                     f'launch), B {launches["paged_decode"]}x counted and '
                     f'{stats["b_launches_device"]}x on the device (only '
                     f'the fused pool runs B)')
            if d['prefix_hits'] < 1 or d['spec_rounds'] < 1 or \
                    (d['prefill_chunks'] > 0) != paged:
                fail(f'{tag} the traffic took the paths {d} (a hit, '
                     f'speculation, chunks on the paged layouts only)')
            eng.stop()
            t_checks = time.perf_counter()
            stats['graphs_bit_equal'] = layout_graphs_vs_eager(
                torch, eng, engine_lib, tag)
            forced = layout_forced(torch, eng, engine_lib, tok_t, len_t,
                                   feed)
            stats['checks_s'] = time.perf_counter() - t_checks
        finally:
            stop_engine(eng, server)
        # Each path's error against fp32 over the 8 steps (max|diff| /
        # std of the fp32 logits, per step, then the max over steps), the
        # layout's over the plain bf16 path's: the ratio of two maxima
        # over one step swings by up to a third from step to step on the
        # same path (the per-step lists logged below); over 8 it settles.
        e_a, e_p = [], []
        for i, (a, p, f) in enumerate(zip(forced, plain, ref)):
            if not bool(torch.isfinite(a).all()):
                fail(f'{tag} non-finite teacher-forced logits at step {i}')
            std = float(f.std())
            e_a.append(float((a - f).abs().max()) / std)
            e_p.append(float((p - f).abs().max()) / std)
        worst = max(e_a) / max(e_p)
        log(f'{tag} teacher-forced steps, max|diff|/std(fp32 logits): '
            f'{name} {[round(e, 5) for e in e_a]}, plain bf16 '
            f'{[round(e, 5) for e in e_p]}')
        stats['forced_error_ratio'] = worst
        if worst > TOL_MODEL:
            fail(f'{tag} teacher-forced bf16 logits {worst:.3f}x the plain '
                 f'bf16 error against fp32 > {TOL_MODEL}')
        stats['bf16_streams'] = streams
        result['layouts'][name] = stats
        if not fused:
            new_a += launches['flash_fwd']
        log(f'{tag} TPOT median {stats["tpot_ms_median"]:.3f} ms, TTFT '
            f'short {stats["ttft_ms_short"]:.1f} / long '
            f'{stats["ttft_ms_long"]:.1f} ms, idle share '
            f'{stats["idle_share"]}, peak {stats["peak_gb"]:.2f} GB, cache '
            f'bytes read {stats["cache_bytes_read"]:.0f} written '
            f'{stats["cache_bytes_written"]:.0f}, launches A '
            f'{launches["flash_fwd"]} B {launches["paged_decode"]} (B on '
            f'the device {stats["b_launches_device"]}), hits '
            f'{d["prefix_hits"]}, chunks {d["prefill_chunks"]}, spec '
            f'rounds {d["spec_rounds"]}, teacher-forced error ratio '
            f'{worst:.3f} (tol {TOL_MODEL}), {len(eng.graphs)} graphs '
            f'bit-equal to eager, on {gpu_line()}; '
            f'{time.perf_counter() - t_layout:.1f}s (traffic {wall:.1f}s, '
            f'profiled {stats["profiled_s"]:.1f}s, checks '
            f'{stats["checks_s"]:.1f}s)')
        del eng, server
        free_card(torch)
    # fp32 greedy streams, LAYOUT_F32_DEPTH of 16 layers.
    cut = dataclasses.replace(cfg, n_layers=LAYOUT_F32_DEPTH,
                              dtype=torch.float32)
    t_f32 = time.perf_counter()
    p32 = decode.cast_params_for_decode(
        {k: ({n: w[:LAYOUT_F32_DEPTH] for n, w in v.items()}
             if k == 'layers' else v) for k, v in params.items()}, cut)
    f32 = {}
    for name, paged, attn in LAYOUTS:
        eng = engine_lib.InferenceEngine('llama-1b', cfg=cut, params=p32,
                                         device='cuda', seed=0)
        eng.paged, eng.attn_backend = paged, attn
        eng, server, base = serve_engine(eng, engine_lib,
                                         f'{tag0} fp32 {name}')
        try:
            f32[name] = layout_traffic(base, cut.vocab_size,
                                       f'{tag0} fp32 {name}')
        finally:
            stop_engine(eng, server)
        del eng, server
        free_card(torch)
    del p32
    if not f32['fused'] == f32['contiguous'] == f32['gather']:
        fail(f'{tag0} fp32 greedy streams differ across the layouts: '
             f'{json.dumps(f32)[:2000]}')
    result['fp32_streams_identical'] = True
    result['fp32_depth'] = LAYOUT_F32_DEPTH
    result['seconds'] = time.perf_counter() - t_phase
    log(f'{tag0} fp32 greedy streams of the three layouts identical '
        f'({LAYOUT_F32_DEPTH} of 16 layers, {len(f32["fused"])} answers, '
        f'{time.perf_counter() - t_f32:.1f}s); phase '
        f'{result["seconds"]:.1f}s')
    with open(os.path.join(OUT_DIR, 'layouts.json'), 'w') as f:
        json.dump(result, f, indent=1, default=str)
    return {'flash_fwd': new_a}


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
    launches = launch_counts(build)
    peak = torch.cuda.max_memory_allocated() / 1e9
    layers, n = cfg.n_layers, tcfg.total_steps
    k = layers * n if takes_kernels(cfg) else 0
    want = want_launches(build, flash_fwd=2 * k, flash_dq=k, flash_dkv=k)
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
    """The port's trainer on llama-1b at full width (TRAIN_DEPTH of its 16
    layers, dim 2048, vocab 32768, tied embeddings, remat 'full'): TRAIN_STEPS steps
    of batch TRAIN_B x TRAIN_S on the synthetic corpus, through the
    kernels (train_checked), a resume at step 3 (TOL_RESUME), one
    step's grads against the plain bf16 and fp32 paths (TOL_GRAD), one
    step profiled. Returns the main run's launch counts."""
    import dataclasses
    from skypilot_tpu_torch import config
    from skypilot_tpu_torch.train import trainer
    cfg = dataclasses.replace(config.get_config('llama-1b'),
                              n_layers=TRAIN_DEPTH)
    tcfg = trainer.TrainerConfig(
        model='llama-1b', model_overrides={'n_layers': TRAIN_DEPTH},
        batch_size=TRAIN_B, seq_len=TRAIN_S,
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


def step_grads(torch, cfg, params, batch, routes=None, loss_fn=None):
    """The grads of CE + router aux (train_lib's step) on ``params`` and
    ``batch`` under ``cfg``, or of ``loss_fn(cfg, params)`` where given,
    aligned with train_lib.leaves(params) (None for a leaf off the
    path). ``routes``, a RouteLog, is installed over the forward and the
    backward both: under remat 'full' the backward recomputes each
    layer, its routing included."""
    from skypilot_tpu_torch.train import train_lib
    with routes or contextlib.nullcontext():
        if loss_fn is not None:
            loss = loss_fn(cfg, params)
        else:
            tokens = batch['tokens']
            logits, aux = train_lib.forward_with_aux(cfg, params,
                                                     tokens[:, :-1])
            loss = train_lib.cross_entropy_loss(logits, tokens[:, 1:])[0] \
                + aux
            del logits
        return torch.autograd.grad(loss, train_lib.leaves(params),
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
                force_routes: bool = False, loss_fn=None) -> float:
    """One step's grads (CE + router aux, or ``loss_fn``: step_grads)
    three ways on ``params`` and ``batch``: the default route (bf16; through the kernels where the
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
    g_kern = step_grads(torch, cfg, params, batch, rec, loss_fn)

    def routes():
        return forced_routes(torch, moe, cfg, rec) if force_routes else None

    g_plain = (None if bound is not None else step_grads(
        torch, dataclasses.replace(cfg, attention_impl='xla'), params,
        batch, routes(), loss_fn))
    g_ref = step_grads(torch, dataclasses.replace(
        cfg, attention_impl='xla', dtype=torch.float32), params, batch,
        routes(), loss_fn)
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
# Depth cuts that keep the whole script inside its time limit on a slow
# host (every check stands at any depth; full depth was checked before):
# gemma-7b's model and serve phases at 6 of 28 layers, moe-1b's at 6 of
# 12 and its training at 4, deepseek-v2-lite's model and serve phases at
# 2 of 27 (the latent family runs no kernel). Each was cut further (from
# 14, 12, 6 and 4) when the tp_serve phase joined: the whole script read
# 1220.5 s on a slow H100 host at the earlier depths.
GEMMA_SERVE_DEPTH, MLA_SERVE_DEPTH, MOE_TRAIN_DEPTH = 6, 2, 4
MOE_SERVE_DEPTH = 6
# train_mla: deepseek-v2-lite at full width (2.607 B params and 41.7 GB
# of fp32 state whole) cut to MLA_TRAIN_DEPTH of its 27 layers since the
# tp_serve phase joined the script (no kernel runs on this path, and it
# trained whole before), MLA_TRAIN_B x TRAIN_S, MLA_TRAIN_STEPS steps;
# no kernel (the latent attention is plain PyTorch, as in JAX). Batch 4:
# at batch 2 the whole model's peak was 49.04 GB (H100 80GB HBM3).
MLA_TRAIN_B, MLA_TRAIN_STEPS, MLA_TRAIN_DEPTH = 4, 4, 14
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
    """The port's trainer on deepseek-v2-lite at MLA_TRAIN_DEPTH layers
    (remat 'full') through train_checked, with no kernel launched and no plain-attention rerun
    (the one path is the plain one); then one step's grads, bf16 against
    fp32, each leaf's error at most TOL_GRAD_MLA; one step profiled.
    Its resume is held on the CPU (tests/test_torch_trainer.py): a
    checkpoint here would be 31 GB. Returns the launch counts (all 0)."""
    import dataclasses
    from skypilot_tpu_torch import config
    from skypilot_tpu_torch.train import trainer
    cfg = dataclasses.replace(config.get_config('deepseek-v2-lite'),
                              n_layers=MLA_TRAIN_DEPTH)
    tcfg = trainer.TrainerConfig(
        model='deepseek-v2-lite',
        model_overrides={'n_layers': MLA_TRAIN_DEPTH},
        batch_size=MLA_TRAIN_B, seq_len=TRAIN_S,
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


def bits_equal(torch, a, b) -> bool:
    """Same dtype, shape and bits (bf16 compared as int16)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.bfloat16:
        return torch.equal(a.view(torch.int16), b.view(torch.int16))
    return torch.equal(a, b)


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
        if b.device.type != 'cuda' or not bits_equal(torch, a, b):
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
        launches = launch_counts(build)
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


# The engine's prefix-cache entries and pages a slot at max_len 2048
# (the pool's default size is (slots + min(entries, slots)) x pages).
ENGINE_PREFIX, ENGINE_SLOT_PAGES = 4, 2048 // 64


def engine_cli(flags: list, tag: str, log_name: str, chat=HF_CHAT,
               slots: int = 0) -> None:
    """``python -m skypilot_tpu_torch.serve.engine`` with ``flags``, as a
    user starts it (no --device: the card): /health must answer 200,
    then one chat completion of ``chat``; the process is stopped and
    waited for. Its output goes to chiprun_out/``log_name``. With
    ``slots``, it runs under SKYTPU_ENGINE_MAX_BATCH=``slots``, and
    /health must report the free pages of that many slots at max_len
    2048 and GET / answer 200."""
    port = free_port()
    base = f'http://127.0.0.1:{port}'
    cmd = [sys.executable, '-m', 'skypilot_tpu_torch.serve.engine', *flags,
           '--host', '127.0.0.1', '--port', str(port)]
    env = dict(os.environ)
    if slots:
        env['SKYTPU_ENGINE_MAX_BATCH'] = str(slots)
    t0 = time.perf_counter()
    with open(os.path.join(OUT_DIR, log_name), 'w') as out:
        proc = subprocess.Popen(cmd, cwd=HERE, stdout=out,
                                stderr=subprocess.STDOUT, env=env)
        try:
            while True:
                if proc.poll() is not None:
                    fail(f'{tag} {" ".join(cmd[1:])} exited '
                         f'{proc.returncode} before /health (see '
                         f'chiprun_out/{log_name})')
                try:
                    code, _ = http(base + '/health', timeout=5)
                except (urllib.error.URLError, OSError):
                    code = None
                if code == 200:
                    break
                if time.perf_counter() - t0 > 300:
                    fail(f'{tag} /health not 200 after 300 s: {code}')
                time.sleep(0.5)
            up = time.perf_counter() - t0
            if slots:
                free = (slots + min(ENGINE_PREFIX, slots)) * \
                    ENGINE_SLOT_PAGES
                code, health = http(base + '/health')
                if code != 200 or health['kv_pages_free'] != free:
                    fail(f'{tag} /health under SKYTPU_ENGINE_MAX_BATCH='
                         f'{slots}: {code} {health}, want {free} free pages')
                code, root = http(base + '/')
                if code != 200 or root['kv_pages_free'] != free:
                    fail(f'{tag} GET / answered {code}: {root}')
                log(f'{tag} SKYTPU_ENGINE_MAX_BATCH={slots}: /health and '
                    f'GET / report {free} free pages ({slots} slots)')
            code, doc = http(base + '/v1/chat/completions', chat)
            if code != 200 or doc['choices'][0]['finish_reason'] != 'length':
                fail(f'{tag} chat answered {code}: {doc}')
        finally:
            proc.terminate()
            try:
                proc.wait(60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
    log(f'{tag} {" ".join(cmd[1:3 + len(flags)])} (no --device) up in '
        f'{up:.1f}s, a chat completion answered ({doc["usage"]}), stopped: '
        f'exit {proc.returncode}')


def phase_hf(torch, build, engine_lib, decode) -> dict:
    """Real checkpoints: hf_round_trip of llama3.2-1b, hf_finetune from
    its HF directory, hf_serve and engine_cli on the trainer's checkpoint,
    then hf_round_trip of qwen2.5-1.5b; every file under the git-ignored
    .smoke_hf/, which the caller removes, and all but llama3.2-1b's HF
    directory (sft, lora and grpo start from it) removed here. Returns the
    launch counts of the paths 'train_hf' and 'serve_hf'."""
    import shutil
    from skypilot_tpu_torch import config
    t0 = time.perf_counter()
    root = os.path.join(HERE, '.smoke_hf')
    shutil.rmtree(root, ignore_errors=True)
    hf_dir = os.path.join(root, 'Llama-3.2-1B')
    ck = os.path.join(root, 'ck')
    paths = {}
    cfg = config.get_config(HF_MODEL)
    hf_round_trip(torch, cfg, hf_dir, '[hf]', eos=HF_EOS)
    paths['train_hf'] = hf_finetune(torch, build, cfg, hf_dir, ck)
    free_card(torch)
    paths['serve_hf'] = hf_serve(torch, build, engine_lib, decode, cfg, ck)
    free_card(torch)
    engine_cli(['--model', HF_MODEL, '--ckpt-dir', ck], '[hf cli]',
               'hf_cli.log', slots=16)
    shutil.rmtree(ck)
    qwen = os.path.join(root, 'Qwen2.5-1.5B')
    hf_round_trip(torch, config.get_config(HF_QWEN), qwen, '[hf qwen]')
    shutil.rmtree(qwen)
    log(f'[hf] phase took {time.perf_counter() - t0:.1f}s')
    return paths


# The lora and grpo phases: llama3.2-1b whole from the HF directory the
# hf phase exports (exported here when hf does not run). LoRA: rank 16 on
# the attention projections, LORA_STEPS steps of HF_B x TRAIN_S, one more
# after a resume, the merge, the merged tree served. GRPO: GRPO_PROMPTS
# prompts of GRPO_S tokens (ragged lengths GRPO_LENS at the first
# iteration), groups of GRPO_G, GRPO_NEW new tokens at temperature 1,
# the k3 KL against a reference copy, GRPO_ITERS iterations at lr
# GRPO_LR with no warmup (so that the first update moves the policy).
LORA_RANK, LORA_STEPS, LORA_NEW = 16, 3, 16
# The first LoRA loss (B = 0: the merged tree is the base, bit for bit)
# against the base's CE on batch 0: the trainer logs 4 decimals.
TOL_LORA_CE = 1e-4
GRPO_PROMPTS, GRPO_G, GRPO_S, GRPO_NEW = 4, 8, 64, 64
GRPO_LENS, GRPO_KL, GRPO_ITERS, GRPO_LR = (64, 41, 17, 53), 0.04, 2, 1e-5
# The first iteration's mean ratio: the behaviour scoring and the update
# score the same rows with the same weights (JAX's ragged test's bound).
TOL_RATIO = 1e-3


def llama_hf_dir(torch) -> str:
    """llama3.2-1b's HF directory under .smoke_hf/: the hf phase's
    export, or a new one (hf_round_trip) when that phase did not run."""
    from skypilot_tpu_torch import config
    hf_dir = os.path.join(HERE, '.smoke_hf', 'Llama-3.2-1B')
    if not os.path.exists(os.path.join(hf_dir, 'model.safetensors')):
        hf_round_trip(torch, config.get_config(HF_MODEL), hf_dir, '[lora]',
                      eos=HF_EOS)
    return hf_dir


def lora_train(torch, build, cfg, base, tcfg) -> dict:
    """The trainer from --hf-dir with --lora-rank (train_checked: A 2 x
    layers x steps, C and D layers x steps), its first loss against the
    base's CE on batch 0 (TOL_LORA_CE), and the base the trainer read
    bit-equal to ``base`` (the import) after the steps, no leaf taking a
    grad. Returns the launch counts."""
    from skypilot_tpu_torch.data import loader
    from skypilot_tpu_torch.data_service import spec as spec_lib
    from skypilot_tpu_torch.models import hf_import, weights
    from skypilot_tpu_torch.train import train_lib
    batch = loader.to_device(spec_lib.load_source(spec_lib.DatasetSpec(
        HF_B, TRAIN_S, cfg.vocab_size)).batch_at_step(0), 'cuda')
    with torch.no_grad():
        tokens = batch['tokens']
        logits, _ = train_lib.forward_with_aux(cfg, base, tokens[:, :-1])
        ce = float(train_lib.cross_entropy_loss(logits, tokens[:, 1:])[0])
    del logits, batch
    free_card(torch)
    seen = []
    real = hf_import.load_hf_checkpoint

    def keep(*args, **kwargs):
        out = real(*args, **kwargs)
        seen.append(out[1])
        return out
    hf_import.load_hf_checkpoint = keep     # the trainer's own base
    try:
        t0 = time.perf_counter()
        hist, launches = train_checked(torch, build, tcfg, cfg, '[lora]',
                                       plain=False)
        secs = time.perf_counter() - t0
    finally:
        hf_import.load_hf_checkpoint = real
    mine, theirs = weights.tree_paths(seen[0]), weights.tree_paths(base)
    bad = [p for (p, a), (_, b) in zip(mine, theirs)
           if a.requires_grad or not bits_equal(torch, a, b)]
    diff = abs(hist[0]['loss'] - ce)
    nbytes = os.path.getsize(os.path.join(tcfg.lora_dir, 'adapters.npz'))
    log(f'[lora] --hf-dir --lora-rank {LORA_RANK} run of {LORA_STEPS} steps '
        f'with its save: {secs:.1f}s; first loss {hist[0]["loss"]} vs the '
        f'base\'s cross-entropy {ce:.4f} on batch 0: |diff| {diff:.5f} (tol '
        f'{TOL_LORA_CE}); the trainer\'s base {len(mine) - len(bad)} of '
        f'{len(mine)} leaves bit-equal to the import after the steps; '
        f'adapters.npz {nbytes / 1e6:.2f} MB')
    if diff > TOL_LORA_CE:
        fail(f'[lora] first loss departs from the base\'s CE by {diff}')
    if bad or len(mine) != len(theirs):
        fail(f'[lora] base leaves changed or taking grads: {bad}')
    return launches


def lora_grads(torch, cfg, base, adapters, lcfg, batch,
               tag: str = '[lora]') -> None:
    """The adapters' grads of the LoRA step's loss (CE, under the batch's
    loss_mask where it has one, + aux of the forward on
    merge_into(base, adapters)) on ``batch``, held against the plain
    attention in bf16 and in fp32 (the base upcast) by check_grads: A,
    C and D at the trainer's shapes."""
    import dataclasses
    from skypilot_tpu_torch.models import decode
    from skypilot_tpu_torch.train import lora, train_lib
    base32 = decode.cast_params_for_decode(
        base, dataclasses.replace(cfg, dtype=torch.float32))
    tokens, mask = batch['tokens'], batch.get('loss_mask')

    def loss_fn(c, ad):
        merged = lora.merge_into(base32 if c.dtype == torch.float32
                                 else base, ad, lcfg)
        logits, aux = train_lib.forward_with_aux(c, merged, tokens[:, :-1])
        return train_lib.cross_entropy_loss(logits, tokens[:, 1:],
                                             mask)[0] + aux
    check_grads(torch, cfg, adapters, None, tag, loss_fn=loss_fn)
    del base32
    free_card(torch)


def lora_resume(torch, build, cfg, base, tcfg, lcfg) -> None:
    """The adapters left after LORA_STEPS steps, restored from disk: the
    step, the optimizer count and every first-moment leaf non-zero (a
    fresh tx.init gives zeros); a save of them timed; their grads held
    against the plain attention (lora_grads); one step of them over
    ``base`` profiled; then the trainer resumed for one more step
    (A 2 x layers, C and D x layers), after which the saved step and
    count are LORA_STEPS + 1 (from a fresh init the count would be
    1)."""
    import dataclasses
    import shutil
    from skypilot_tpu_torch.data import loader
    from skypilot_tpu_torch.data_service import spec as spec_lib
    from skypilot_tpu_torch.train import lora, train_lib, trainer
    tx = train_lib.default_optimizer(learning_rate=tcfg.learning_rate,
                                     warmup_steps=tcfg.warmup_steps,
                                     total_steps=tcfg.total_steps)
    t0 = time.perf_counter()
    state = lora.resume_state(tx, tcfg.lora_dir, lcfg, 'cuda')
    torch.cuda.synchronize()
    t_restore = time.perf_counter() - t0
    mu = train_lib.leaves(state.opt_state.mu)
    mu_min = min(float(m.abs().max()) for m in mu)
    if state.step != LORA_STEPS or state.opt_state.count != LORA_STEPS or \
            mu_min == 0:
        fail(f'[lora] restored step {state.step}, count '
             f'{state.opt_state.count}, smallest max|mu| {mu_min}')
    copy = tcfg.lora_dir + '_copy'
    t0 = time.perf_counter()
    lora.save_adapters(copy, state, lcfg)
    t_save = time.perf_counter() - t0
    shutil.rmtree(copy)
    # One step of the restored state on the next batch (run once first,
    # so that nothing is built inside the window) under the profiler.
    batch = loader.to_device(spec_lib.load_source(spec_lib.DatasetSpec(
        HF_B, TRAIN_S, cfg.vocab_size)).batch_at_step(LORA_STEPS), 'cuda')
    lora_grads(torch, cfg, base, state.adapters, lcfg, batch)
    step_fn = lora.make_lora_train_step(cfg, tx, lcfg)
    step_fn(state, base, batch)
    log('[lora] one step of the restored adapters under the profiler:')
    profile_device(torch, lambda: step_fn(state, base, batch))
    del state, batch
    free_card(torch)
    build.reset_launches()
    hist = trainer.train(dataclasses.replace(tcfg,
                                             total_steps=LORA_STEPS + 1))
    launches = launch_counts(build)
    _, _, step, opt_leaves = lora.load_adapters(tcfg.lora_dir)
    n = cfg.n_layers
    want = want_launches(build, flash_fwd=2 * n, flash_dq=n, flash_dkv=n)
    log(f'[lora] restored {len(mu)} moment leaves of step {LORA_STEPS} in '
        f'{t_restore:.2f}s (count {LORA_STEPS}, smallest max|mu| '
        f'{mu_min:.3e}: from disk, not a fresh init); a save of the state '
        f'{t_save:.2f}s; the resumed run {[r["step"] for r in hist]}, loss '
        f'{[r["loss"] for r in hist]}, launches {launches}; saved step '
        f'{step}, count {int(opt_leaves[0])}')
    if [r['step'] for r in hist] != [LORA_STEPS + 1] or launches != want or \
            step != LORA_STEPS + 1 or int(opt_leaves[0]) != LORA_STEPS + 1:
        fail(f'[lora] resume ran {hist}, launches {launches} (want {want}), '
             f'saved step {step}, count {int(opt_leaves[0])}')


def lora_merge_check(torch, base, hf_dir: str, lora_dir: str, out: str,
                     tag: str = '[lora]') -> dict:
    """`python -m skypilot_tpu_torch.train.lora_merge` (main, no
    --device: the card) into ``out``, re-imported: each targeted leaf
    bit-equal to the in-process merge_into of the saved adapters and
    changed from the base, every other leaf bit-equal to the base.
    Returns the merged params (bf16, on the card)."""
    from skypilot_tpu_torch.models import hf_import, weights
    from skypilot_tpu_torch.train import lora, lora_merge
    t0 = time.perf_counter()
    lora_merge.main(['--hf-dir', hf_dir, '--lora-dir', lora_dir,
                     '--out', out])
    t_merge = time.perf_counter() - t0
    _, merged = hf_import.load_hf_checkpoint(out, device='cuda')
    adapters, lcfg, step, _ = lora.load_adapters(lora_dir, 'cuda')
    with torch.no_grad():
        want = lora.merge_into(base, adapters, lcfg)
    targeted = {path for path, _ in weights.tree_paths(base)
                if weights.slash_key(path) in adapters}
    bad, changed = [], 0
    for (path, got), (_, w), (_, b) in zip(weights.tree_paths(merged),
                                           weights.tree_paths(want),
                                           weights.tree_paths(base)):
        if not bits_equal(torch, got, w if path in targeted else b):
            bad.append(path)
        changed += path in targeted and not bits_equal(torch, got, b)
    log(f'{tag} lora_merge of step {step} in {t_merge:.1f}s (load, merge, '
        f'export); re-imported: {len(targeted)} targeted leaves == '
        f'merge_into bit for bit ({changed} changed from the base), the '
        f'other {len(weights.tree_paths(merged)) - len(targeted)} == the base '
        f'bit for bit; bad {bad}')
    if bad or changed != len(targeted):
        fail(f'{tag} merged leaves off: {bad}, {changed} of '
             f'{len(targeted)} targeted changed')
    return merged


def lora_serve(torch, build, engine_lib, decode, cfg, params) -> dict:
    """The merged tree served: InferenceEngine(params=..., the byte
    tokenizer) behind build_app, 3 greedy /generate; kernels A and B
    must launch; the greedy tokens against decode.generate. Returns the
    launch counts from the engine's construction on."""
    from skypilot_tpu_torch.models import llama
    tag = '[lora serve]'
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    t0 = time.perf_counter()
    eng = engine_lib.InferenceEngine(HF_MODEL, cfg=cfg, params=params,
                                     device='cuda', seed=0)
    eng, server, base = serve_engine(eng, engine_lib, tag)
    try:
        rng = np.random.default_rng(17)
        prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
                   for n in (23, 300, 700)]
        answers = [doc['tokens'] for _, doc in generate_all(
            base, [{'tokens': p, 'max_new_tokens': LORA_NEW}
                   for p in prompts], cfg.vocab_size)]
        launches = launch_counts(build)
        log(f'{tag} the merged llama3.2-1b built and warm in '
            f'{time.perf_counter() - t0:.1f}s; 3 /generate (23/300/700 '
            f'tokens, {LORA_NEW} new) ok; launches {launches}; peak '
            f'{torch.cuda.max_memory_allocated() / 1e9:.2f} GB')
        if not launches.get('flash_fwd') or \
                not launches.get('paged_decode'):
            fail(f'{tag} kernels A and B must launch: {launches}')
    finally:
        stop_engine(eng, server)
    held_against_generate(torch, decode, llama, eng.cfg, eng.params,
                          prompts, answers, tag)
    del eng, server
    return launches


def phase_lora(torch, build, engine_lib, decode, hf_dir: str) -> dict:
    """LoRA on llama3.2-1b whole from ``hf_dir``: lora_train, lora_resume,
    lora_merge_check, lora_serve; the adapters and the merged directory
    live beside ``hf_dir`` and are removed. Returns the launch counts of
    the paths 'train_lora' and 'serve_lora'."""
    import shutil
    from skypilot_tpu_torch.models import hf_import
    from skypilot_tpu_torch.train import lora, trainer
    t0 = time.perf_counter()
    root = os.path.dirname(hf_dir)
    lora_dir = os.path.join(root, 'adapters')
    merged_dir = os.path.join(root, 'merged')
    paths = {}
    try:
        cfg, base = hf_import.load_hf_checkpoint(hf_dir, device='cuda')
        tcfg = trainer.TrainerConfig(
            model=HF_MODEL, hf_dir=hf_dir, batch_size=HF_B, seq_len=TRAIN_S,
            total_steps=LORA_STEPS, warmup_steps=TRAIN_WARMUP, log_every=1,
            lora_rank=LORA_RANK, lora_dir=lora_dir, ckpt_every=LORA_STEPS,
            device='cuda')
        paths['train_lora'] = lora_train(torch, build, cfg, base, tcfg)
        free_card(torch)
        lora_resume(torch, build, cfg, base, tcfg,
                    lora.LoRAConfig(rank=LORA_RANK))
        free_card(torch)
        merged = lora_merge_check(torch, base, hf_dir, lora_dir, merged_dir)
        del base
        free_card(torch)
        paths['serve_lora'] = lora_serve(torch, build, engine_lib, decode,
                                         cfg, merged)
        del merged
    finally:
        shutil.rmtree(lora_dir, ignore_errors=True)
        shutil.rmtree(merged_dir, ignore_errors=True)
    log(f'[lora] phase took {time.perf_counter() - t0:.1f}s')
    return paths


# The sft phase: the Llama-3-style fixture as llama3.2-1b's tokenizer.json
# (a directory beside the hf phase's export, its other files linked),
# SFT_STEPS steps of HF_B x TRAIN_S of the committed chat JSONL with
# LoRA rank LORA_RANK, the merge, and the merged directory served with
# its tokenizer (SFT_NEW greedy tokens of the golden file's chat). The
# fixtures and the golden file (the tokenizers library's ids, the JAX
# package's SFT digests, the chat, seq_len and batch) are those of
# tests/data/make_torch_tokenizer_fixtures.py.
SFT_STEPS, SFT_NEW = 3, 16
FIXTURE_DIR = os.path.join(HERE, 'tests', 'data')
SFT_TOKENIZERS = {'llama3': os.path.join(FIXTURE_DIR, 'torch_tok_llama3.json'),
                  'qwen2': os.path.join(FIXTURE_DIR, 'torch_tok_qwen2.json')}
SFT_JSONL = os.path.join(FIXTURE_DIR, 'torch_sft_chat.jsonl')
SFT_GOLDEN = os.path.join(FIXTURE_DIR, 'torch_tokenizer_golden.json')


def digest(*arrays) -> str:
    """The fixture maker's digest of numpy arrays: dtype, shape, bytes."""
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(str((a.dtype.str, a.shape)).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def sft_tokenizer(golden) -> None:
    """Each committed fixture read by the port's reader: its ids for
    every golden text with and without specials, and its decodes, equal
    to the library's in the golden file; decode(encode(t)) == t (NFC of
    t under the Qwen2-style normalizer) for every text without added
    tokens; vocab_size. Prints the load seconds (the Unicode classes
    are built once, before) and the encode rate of the chat JSONL's
    messages from a cold cache."""
    import unicodedata
    from skypilot_tpu_torch.data import tokenizer as tokenizer_lib
    from skypilot_tpu_torch.data import tokenizer_json
    t0 = time.perf_counter()
    tokenizer_json.unicode_classes()
    log(f'[sft] \\p{{L}}, \\p{{N}} and \\s classes built in '
        f'{time.perf_counter() - t0:.2f}s')
    with open(SFT_JSONL, encoding='utf-8') as f:
        corpus = [m['content'] for line in f if line.strip()
                  for m in json.loads(line)['messages']]
    plain = [t for t in golden['texts'] if '<|' not in t and '<tool' not in t]
    for name, path in sorted(SFT_TOKENIZERS.items()):
        want = golden['fixtures'][name]
        t0 = time.perf_counter()
        tok = tokenizer_lib.load_tokenizer(path)
        t_load = time.perf_counter() - t0
        bad = [t for t, row in zip(golden['texts'], want['rows'])
               if tok.encode(t) != row['ids'] or
               tok.encode(t, add_special_tokens=False) != row['ids_raw'] or
               tok.decode(row['ids']) != row['decoded']]
        nfc = name == 'qwen2'
        trips = [t for t in plain if tok.decode(tok.encode(t)) != (
            unicodedata.normalize('NFC', t) if nfc else t)]
        t0 = time.perf_counter()
        n = sum(len(tok.encode(t, add_special_tokens=False))
                for t in corpus)
        secs = time.perf_counter() - t0
        log(f'[sft] {os.path.basename(path)}: vocab_size {tok.vocab_size} '
            f'(golden {want["vocab_size"]}), family {tok.chat_family}, '
            f'loaded in {t_load:.3f}s; {len(want["rows"])} golden texts x 2 '
            f'flags: {len(bad)} off the library; round trips of '
            f'{len(plain)}: {len(trips)} off; {n} tokens of the chat JSONL '
            f'in {secs:.3f}s from a cold cache: {n / secs:.0f} tokens/s')
        if bad or trips or tok.vocab_size != want['vocab_size']:
            fail(f'[sft] {name}: ids or decodes off the library for '
                 f'{bad[:3]}, round trips off for {trips[:3]}, vocab_size '
                 f'{tok.vocab_size}')


def sft_train(torch, build, cfg, base, tcfg, golden) -> dict:
    """The trainer with ``tcfg`` (--hf-dir, --sft-data, --lora-rank:
    train_checked: A 2 x layers x steps, C and D layers x steps); the
    first batch of the trainer's own source digested against the JAX
    package's; the first loss (B = 0: the base) against the base's
    masked cross-entropy on that batch through the kernels (TOL_LORA_CE)
    and through the plain attention; the saved adapters' grads under
    the mask against the plain attention (lora_grads). Returns the
    launch counts."""
    import dataclasses
    from skypilot_tpu_torch.data import loader
    from skypilot_tpu_torch.data_service import spec as spec_lib
    from skypilot_tpu_torch.train import lora, train_lib
    sources = []
    real = spec_lib.load_source

    def keep(spec):
        sources.append(real(spec))
        return sources[-1]
    spec_lib.load_source = keep     # the trainer's own source
    try:
        t0 = time.perf_counter()
        hist, launches = train_checked(torch, build, tcfg, cfg, '[sft]',
                                       plain=False)
        secs = time.perf_counter() - t0
    finally:
        spec_lib.load_source = real
    first = sources[0].batch_at_step(0)
    got = digest(first['tokens'], first['loss_mask'])
    want = golden['sft']['llama3']['first_batch']
    share = float(first['loss_mask'].mean())
    batch = loader.to_device(first, 'cuda')
    tokens, mask = batch['tokens'], batch['loss_mask']
    ce = {}
    with torch.no_grad():
        for impl in ('auto', 'xla'):
            c = dataclasses.replace(cfg, attention_impl=impl)
            logits, _ = train_lib.forward_with_aux(c, base, tokens[:, :-1])
            ce[impl] = float(train_lib.cross_entropy_loss(
                logits, tokens[:, 1:], mask)[0])
            del logits
    free_card(torch)
    d_k, d_p = abs(hist[0]['loss'] - ce['auto']), abs(hist[0]['loss'] -
                                                      ce['xla'])
    log(f'[sft] --hf-dir --sft-data --lora-rank {LORA_RANK} run of '
        f'{SFT_STEPS} steps with its save: {secs:.1f}s; the first batch: '
        f'{tokens.shape[0]} rows of {tokens.shape[1]}, masked share '
        f'{share:.4f} (golden {golden["sft"]["llama3"]["masked_share"]:.4f})'
        f', digest {got[:16]} (JAX {want[:16]}); first loss '
        f'{hist[0]["loss"]} vs the base\'s masked cross-entropy '
        f'{ce["auto"]:.5f} through the kernels (|diff| {d_k:.5f}, tol '
        f'{TOL_LORA_CE}) and {ce["xla"]:.5f} through the plain attention '
        f'(|diff| {d_p:.5f}, tol {TOL_LOSS})')
    if got != want:
        fail('[sft] the first batch differs from the JAX package\'s')
    # Through the plain attention: the kernels' bf16 rounding apart from
    # the plain path's (train_checked holds whole runs of the two within
    # TOL_LOSS).
    if d_k > TOL_LORA_CE or d_p > TOL_LOSS:
        fail(f'[sft] first loss departs from the base\'s masked CE: '
             f'{d_k} (kernels), {d_p} (plain attention)')
    adapters, lcfg, _, _ = lora.load_adapters(tcfg.lora_dir, 'cuda')
    for leaf in train_lib.leaves(adapters):
        leaf.requires_grad_(True)
    lora_grads(torch, cfg, base, adapters, lcfg, batch, tag='[sft]')
    return launches


def sft_serve(torch, build, engine_lib, merged_dir: str, golden) -> dict:
    """InferenceEngine(hf_dir=merged_dir) behind build_app: its tokenizer
    the fixture (family llama3, <|eot_id|> among the eos ids); the
    golden chat as JSON and as SSE at temperature 0, the ids the engine
    tokenized for it equal to the golden ones, the stream's completion
    ids and text equal to the JSON's, the text the decode of those ids;
    A and B must launch. Then the completion ids against decode.generate
    from the golden prompt ids (held_against_generate). Returns the
    launch counts from the engine's construction on."""
    from skypilot_tpu_torch.models import decode, llama
    tag = '[sft serve]'
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    t0 = time.perf_counter()
    eng = engine_lib.InferenceEngine(hf_dir=merged_dir, device='cuda',
                                     seed=0)
    tok = eng.tokenizer
    eot = tok.token_to_id('<|eot_id|>')
    log(f'{tag} engine on {os.path.basename(merged_dir)} built in '
        f'{time.perf_counter() - t0:.1f}s; tokenizer family '
        f'{tok.chat_family}, eos ids {tok.eos_ids}, vocab_size '
        f'{tok.vocab_size}')
    if tok.chat_family != 'llama3' or eot not in tok.eos_ids:
        fail(f'{tag} tokenizer family {tok.chat_family}, eos {tok.eos_ids}')
    seen = []
    encode = tok.encode

    def recorded(text, add_special_tokens=True):
        seen.append(encode(text, add_special_tokens=add_special_tokens))
        return seen[-1]
    tok.encode = recorded
    futures = []
    submit = eng.submit

    def kept(*args, **kwargs):
        futures.append(submit(*args, **kwargs))
        return futures[-1]
    eng.submit = kept
    eng, server, base = serve_engine(eng, engine_lib, tag)
    chat = {'messages': golden['sft_chat'], 'max_tokens': SFT_NEW,
            'temperature': 0}
    want = golden['chat_prompt_ids']
    try:
        seen.clear()
        futures.clear()
        code, doc = http(base + '/v1/chat/completions', chat)
        c = doc.get('choices', [{}])[0] if code == 200 else {}
        if code != 200 or c['message']['role'] != 'assistant' or \
                doc['usage']['completion_tokens'] > SFT_NEW:
            fail(f'{tag} chat answered {code}: {doc}')
        prompt_ids = list(seen)
        events = sse(base + '/v1/chat/completions', dict(chat, stream=True))
        text = ''.join(e['choices'][0]['delta'].get('content', '')
                       for e in events[1:])
        launches = launch_counts(build)
        if len(futures) != 2:
            fail(f'{tag} {len(futures)} requests reached the engine, not 2')
        out, stream_out = (f.result()[0] for f in futures)
        log(f'{tag} chat completion: prompt {doc["usage"]["prompt_tokens"]} '
            f'tokens under the llama3 template, the engine\'s ids '
            f'{"==" if prompt_ids == [want] else "!="} the golden ones; '
            f'{doc["usage"]["completion_tokens"]} new ({c["finish_reason"]}),'
            f' ids {out}, text {c["message"]["content"]!r}; its stream '
            f'({len(events)} events) ids {"==" if stream_out == out else "!="}'
            f' these, the same text; launches {launches}; '
            f'peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB')
        if events[0]['choices'][0]['delta'] != {'role': 'assistant',
                                                'content': ''} or \
                events[-1]['choices'][0]['finish_reason'] != \
                c['finish_reason'] or text != c['message']['content'] or \
                stream_out != out or tok.decode(out) != text or \
                len(out) != doc['usage']['completion_tokens']:
            fail(f'{tag} chat stream {events[:2]} ... {events[-1:]}: ids '
                 f'{stream_out} vs {out}, text {text!r} vs '
                 f'{c["message"]["content"]!r}')
        if prompt_ids != [want] or \
                doc['usage']['prompt_tokens'] != len(want):
            fail(f'{tag} prompt ids {prompt_ids} != golden {want}')
        if not launches['flash_fwd'] or not launches['paged_decode']:
            fail(f'{tag} kernels A and B must launch: {launches}')
    finally:
        stop_engine(eng, server)
    held_against_generate(torch, decode, llama, eng.cfg, eng.params, [want],
                          [out], tag)
    del eng, server
    return launches


def phase_sft(torch, build, engine_lib, hf_dir: str) -> dict:
    """Real text: sft_tokenizer; then, in a directory beside ``hf_dir``
    holding links to its files and the Llama-3-style fixture as
    tokenizer.json, sft_train, lora_merge_check (the merge carries the
    tokenizer.json), sft_serve and the engine's CLI on the merged
    directory (engine_cli); every file of the phase is removed. Returns
    the launch counts of the paths 'train_sft' and 'serve_sft'."""
    import shutil
    from skypilot_tpu_torch.models import hf_import
    from skypilot_tpu_torch.train import trainer
    t0 = time.perf_counter()
    with open(SFT_GOLDEN, encoding='utf-8') as f:
        golden = json.load(f)
    sft_tokenizer(golden)
    root = os.path.join(os.path.dirname(hf_dir), 'sft')
    chat_dir = os.path.join(root, 'Llama-3.2-1B-chat')
    lora_dir = os.path.join(root, 'adapters')
    merged_dir = os.path.join(root, 'merged')
    paths = {}
    try:
        os.makedirs(chat_dir)
        for name in os.listdir(hf_dir):
            if name != 'tokenizer.json':
                os.symlink(os.path.join(hf_dir, name),
                           os.path.join(chat_dir, name))
        shutil.copyfile(SFT_TOKENIZERS['llama3'],
                        os.path.join(chat_dir, 'tokenizer.json'))
        cfg, base = hf_import.load_hf_checkpoint(chat_dir, device='cuda')
        tcfg = trainer.TrainerConfig(
            model=HF_MODEL, hf_dir=chat_dir,
            sft_data_path=SFT_JSONL, batch_size=golden['sft_batch'],
            seq_len=golden['sft']['llama3']['seq_len'], total_steps=SFT_STEPS,
            warmup_steps=TRAIN_WARMUP, log_every=1, lora_rank=LORA_RANK,
            lora_dir=lora_dir, ckpt_every=SFT_STEPS, device='cuda')
        paths['train_sft'] = sft_train(torch, build, cfg, base, tcfg,
                                       golden)
        free_card(torch)
        merged = lora_merge_check(torch, base, chat_dir, lora_dir,
                                  merged_dir, tag='[sft]')
        del merged, base
        free_card(torch)
        with open(SFT_TOKENIZERS['llama3'], 'rb') as a, \
                open(os.path.join(merged_dir, 'tokenizer.json'), 'rb') as b:
            if a.read() != b.read():
                fail('[sft] the merged directory\'s tokenizer.json is not '
                     'the fixture')
        paths['serve_sft'] = sft_serve(torch, build, engine_lib, merged_dir,
                                       golden)
        free_card(torch)
        engine_cli(['--hf-dir', merged_dir], '[sft cli]', 'sft_cli.log',
                   chat={'messages': golden['sft_chat'],
                         'max_tokens': SFT_NEW, 'temperature': 0})
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f'[sft] phase took {time.perf_counter() - t0:.1f}s')
    return paths


def even_share(prompt, completion) -> float:
    """GRPO's reward here: the share of even token ids in the completion
    (a spread in every group, so advantages and grads are non-zero)."""
    return float((np.asarray(completion) % 2 == 0).mean())


def grpo_vs_plain(torch, tr, ro, prompts, lens) -> None:
    """Kernels A, C and D at the shapes GRPO gives them, held against the
    plain attention in bf16 and in fp32 on the trainer's weights (its
    fp32 masters): generate's prefill logits on the group-major ragged
    ``prompts`` (a_vs_plain at B = prompts x group, S = GRPO_S, lengths
    ``lens``), token_logprobs on ``ro``'s packed rows (B = prompts x
    group, L = GRPO_S + GRPO_NEW - 1), and the grads of one update's
    loss on ``ro`` (check_grads on grpo.grpo_loss). Call it before the
    first update, while the masters hold the imported bf16 values: the
    fp32 path then runs the weights the bf16 paths round to, not an
    update smaller than their ulp."""
    import dataclasses
    from skypilot_tpu_torch.models import decode
    from skypilot_tpu_torch.train import grpo
    cfg, gcfg, params = tr.cfg, tr.gcfg, tr.state.params
    rep = prompts.to('cuda').repeat_interleave(gcfg.group_size, dim=0)
    rep_lens = lens.to('cuda').repeat_interleave(gcfg.group_size)
    max_len = rep.shape[1] + gcfg.max_new_tokens
    p16 = decode.cast_params_for_decode(params, cfg)
    p32 = decode.cast_params_for_decode(
        params, dataclasses.replace(cfg, dtype=torch.float32))
    a_vs_plain(torch, lambda c, p: decode.prefill_cache(
        p, rep, c, max_len, lengths=rep_lens)[0], cfg, p16, p32, '[grpo]',
        f'generate\'s prefill logits (B={rep.shape[0]}, S={rep.shape[1]}, '
        f'ragged lengths {lens.tolist()} x {gcfg.group_size})')
    del p16
    a_vs_plain(torch, lambda c, p: grpo.token_logprobs(
        p, ro.seq, c, tr.mod, gcfg.temperature)[0], cfg, params, p32,
        '[grpo]', f'token_logprobs on the packed rows (B={ro.seq.shape[0]}, '
        f'L={ro.seq.shape[1] - 1})')
    del p32
    free_card(torch)

    def loss_fn(c, p):
        return grpo.grpo_loss(p, c, gcfg, tr.mod, ro.seq, ro.comp_idx,
                              ro.behavior_lp, ro.adv, ro.mask, ro.ref_lp)[0]
    check_grads(torch, cfg, params, None, '[grpo]', loss_fn=loss_fn)
    free_card(torch)


def phase_grpo(torch, build, hf_dir: str) -> dict:
    """GRPO on llama3.2-1b whole (fp32 masters from ``hf_dir``) through
    GRPOTrainer: GRPO_ITERS iterations, each a rollout (generate's
    prefill through A, the behaviour and reference scoring through A)
    and an update (A twice a layer with remat, C and D once), timed;
    the first on ragged prompts, its mean_ratio 1 within TOL_RATIO; the
    first iteration's rows scored again after its update must differ
    from their behaviour log-probs (the next rollout samples the moved
    policy); peak memory. Then the first iteration again from the same
    seeds on a second trainer, its differences printed; between its
    rollout and its update, A, C and D at these shapes against the plain
    attention (grpo_vs_plain). Returns the launch counts of the main
    run."""
    from skypilot_tpu_torch.models import hf_import, weights
    from skypilot_tpu_torch.train import grpo, train_lib
    t_phase = time.perf_counter()
    cfg, p32 = hf_import.load_hf_checkpoint(hf_dir, dtype=torch.float32,
                                            device='cuda')
    again = weights.tree_unflatten(p32, [t.clone() for t in
                                         train_lib.leaves(p32)])
    eos = hf_import.hf_eos_ids(hf_dir)[0]
    gcfg = grpo.GRPOConfig(group_size=GRPO_G, max_new_tokens=GRPO_NEW,
                           temperature=1.0, kl_coef=GRPO_KL)
    rng = np.random.default_rng(19)
    prompts = [torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (GRPO_PROMPTS, GRPO_S)).astype(np.int32))
        for _ in range(GRPO_ITERS)]
    lens = torch.tensor(GRPO_LENS, dtype=torch.int32)

    def make(params):
        return grpo.GRPOTrainer(
            cfg, gcfg, even_share, eos_id=eos, init_params=params, seed=0,
            device='cuda', tx=train_lib.default_optimizer(
                learning_rate=GRPO_LR, warmup_steps=0, total_steps=100))

    def timed_iteration(tr, i):
        t0 = time.perf_counter()
        ro = tr.rollout(prompts[i], lens if i == 0 else None)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        m = tr.update(ro)
        torch.cuda.synchronize()
        return ro, m, (t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3

    torch.cuda.reset_peak_memory_stats()
    tr = make(p32)
    del p32
    build.reset_launches()
    ro1, m1, roll_ms, upd_ms = timed_iteration(tr, 0)
    log(f'[grpo] iteration 1 (ragged prompts {list(GRPO_LENS)}): rollout '
        f'{roll_ms:.1f} ms, update {upd_ms:.1f} ms; {json.dumps(m1)}')
    before = launch_counts(build)
    with torch.no_grad():
        lp, _ = grpo.token_logprobs(tr.state.params, ro1.seq, cfg, tr.mod)
        moved = float((lp.gather(1, ro1.comp_idx) -
                       ro1.behavior_lp).abs().max())
    extra = {k: v - before[k] for k, v in launch_counts(build).items()}
    for i in range(1, GRPO_ITERS):
        _, m, roll_ms, upd_ms = timed_iteration(tr, i)
        log(f'[grpo] iteration {i + 1}: rollout {roll_ms:.1f} ms, update '
            f'{upd_ms:.1f} ms; {json.dumps(m)}')
    launches = {k: v - extra[k] for k, v in launch_counts(build).items()}
    peak = torch.cuda.max_memory_allocated() / 1e9
    n = cfg.n_layers * GRPO_ITERS
    want = want_launches(build, flash_fwd=5 * n, flash_dq=n, flash_dkv=n)
    log(f'[grpo] llama3.2-1b, {GRPO_PROMPTS} prompts x group {GRPO_G}, '
        f'{GRPO_S}-token prompts, {GRPO_NEW} new, kl {GRPO_KL}, '
        f'{GRPO_ITERS} iterations: launches {launches} (want {want}); peak '
        f'memory {peak:.2f} GB; first mean_ratio {m1["mean_ratio"]!r} (tol '
        f'{TOL_RATIO}); iteration 1\'s rows after its update: max|lp - '
        f'behaviour lp| {moved:.3e} (the next rollout samples a moved '
        f'policy)')
    if launches != want:
        fail(f'[grpo] launches {launches} != {want}')
    if abs(m1['mean_ratio'] - 1.0) > TOL_RATIO or moved == 0 or \
            not all(np.isfinite(v) for v in m1.values()):
        fail(f'[grpo] first iteration {m1}, moved {moved}')
    log('[grpo] one more iteration (rollout and update) under the '
        'profiler:')
    profile_device(torch, lambda: tr.iteration(prompts[-1]))
    del tr
    free_card(torch)
    tr = make(again)
    del again
    ro = tr.rollout(prompts[0], lens)
    grpo_vs_plain(torch, tr, ro, prompts[0], lens)
    m = tr.update(ro)
    diffs = {'completions_equal': bool(torch.equal(ro.completions,
                                                   ro1.completions)),
             'behavior_lp': float((ro.behavior_lp - ro1.behavior_lp)
                                  .abs().max()),
             'ref_lp': float((ro.ref_lp - ro1.ref_lp).abs().max()),
             **{k: abs(m[k] - m1[k]) for k in m1}}
    log(f'[grpo] the first iteration again from the same seeds, |diff| by '
        f'stage: {json.dumps(diffs)}')
    del tr, ro, ro1
    free_card(torch)
    log(f'[grpo] phase took {time.perf_counter() - t_phase:.1f}s')
    return launches


# The harvest phase: harvested RL on llama-1b whole (fp32 masters from
# seed 0), through train/rollout/harness.run_harvest in this process
# (dispatcher and learner) with its workers as real subprocesses sharing
# the card: prompts of HARVEST_S tokens, HARVEST_NEW new tokens at
# temperature 1, groups of HARVEST_G rewarded by harness.even_token_reward
# (about half of any completion's tokens are even, so every group's
# rewards vary on random weights), HARVEST_GROUPS groups a step, kl_coef
# HARVEST_KL, HARVEST_STEPS steps. A snapshot at the start and one after
# the last step (HARVEST_PUBLISH, 2 kept), so that no restore falls in a
# rate window. Each group costs a worker HARVEST_DELAY_S more (the
# harness's pacing), so that the fleet, not the learner, sets the pace
# and a kill shows in it. Two workers; one SIGKILLed after step
# HARVEST_KILL_AT, one fresh worker after step HARVEST_RESPAWN_AT. The
# rates are run_harvest's windows: before the kill steps 3-4, degraded
# steps 6-10 (before the fresh worker can have booted and restored), after
# the rejoin the last 4 steps; the fresh worker's first group must fall
# between the two. Scratch lives in the git-ignored .smoke_harvest/.
HARVEST_S, HARVEST_NEW, HARVEST_G, HARVEST_GROUPS = 64, 64, 8, 2
HARVEST_KL, HARVEST_STEPS, HARVEST_PUBLISH, HARVEST_LR = 0.04, 28, 28, 1e-5
HARVEST_KILL_AT, HARVEST_RESPAWN_AT, HARVEST_HEARTBEAT_S = 4, 6, 3.0
HARVEST_DELAY_S, HARVEST_WORKERS = 1.0, 2


@contextlib.contextmanager
def first_kernel_inputs(fa):
    """Records, cloned, the arguments of the first kernel A call
    (``fa._fwd``: ``rec['fwd']``) and the first C and D call
    (``fa._bwd``: ``rec['bwd']``) made while it is active: the inputs a
    path gives the kernels, to hold them against the plain versions."""
    rec = {}
    fwd, bwd = fa._fwd, fa._bwd

    def keep(key, args):
        if key not in rec:
            rec[key] = tuple(x.detach().clone() if hasattr(x, 'detach')
                             else x for x in args)

    def spy_fwd(*args):
        keep('fwd', args)
        return fwd(*args)

    def spy_bwd(*args, **kw):
        keep('bwd', args)
        return bwd(*args, **kw)
    fa._fwd, fa._bwd = spy_fwd, spy_bwd
    try:
        yield rec
    finally:
        fa._fwd, fa._bwd = fwd, bwd


def hold_kernel_inputs(torch, fa, rec: dict, tag: str, what: str) -> None:
    """Kernel A, and C and D where recorded, again on the inputs
    first_kernel_inputs took from a path, against the plain versions in
    fp32 on the same bf16 inputs: o elementwise (o_ok), lse within
    TOL_LSE, each grad's max|err| / max|ref| under TOL_BWD."""
    qs, k, v, causal = rec['fwd']
    o, lse = fa._fwd(qs, k, v, causal)
    o_ref, lse_ref = fa.flash_attention_ref(qs.float(), k.float(),
                                            v.float(), causal=causal,
                                            softmax_scale=1.0)
    el = max_err(lse.transpose(1, 2), lse_ref)
    ok = o_ok(o, o_ref) and el <= TOL_LSE
    log(f'{tag} kernel A on its first call\'s inputs in {what} (q '
        f'{list(qs.shape)}, k {list(k.shape)}): o err '
        f'{max_err(o, o_ref):.3e} (tol {TOL_O}'
        f' + 2^-8|o|), lse err {el:.3e} (tol {TOL_LSE}) '
        f'{"ok" if ok else "MISMATCH"}')
    if not ok:
        fail(f'{tag} kernel A disagrees with the plain attention on '
             f'{what}\'s inputs')
    if 'bwd' not in rec:
        return
    qs, k, v, o, lse, do, dlse, causal = rec['bwd'][:8]
    do = do.to(qs.dtype)
    got = fa._bwd(qs, k, v, o, lse, do, dlse, causal)
    ref = fa.flash_attention_bwd_ref(qs.float(), k.float(), v.float(),
                                     o.float(), lse, do.float(), dlse,
                                     causal=causal)
    rel = [max_err(a, r) / float(r.abs().max()) for a, r in zip(got, ref)]
    ok = all(bool(a.isfinite().all()) for a in got) and max(rel) < TOL_BWD
    log(f'{tag} kernels C, D on their first call\'s inputs in {what} '
        f'(the last layer\'s backward): '
        f'max|err|/max|ref| dq {rel[0]:.3e} dk {rel[1]:.3e} dv '
        f'{rel[2]:.3e} (tol {TOL_BWD}) {"ok" if ok else "MISMATCH"}')
    if not ok:
        fail(f'{tag} kernels C, D disagree with the plain backward on '
             f'{what}\'s inputs')


def harvest_vs_plain(torch, spec, traj_path: str, tag: str) -> None:
    """Kernels A, C and D on the harvest's path, against the plain
    attention, over the batch of one logged step (``traj_path``) on the
    fp32 masters from ``spec.seed``: the learner's scoring
    (token_logprobs, B = groups x group, S = prompt + new - 1), the
    update's grads (check_grads on grpo.grpo_loss, TOL_GRAD) and, on the
    worker's compute cast (decode.cast_params_for_compute), generate's
    prefill of one group's prompts (B = group, S = prompt) and that
    group's behaviour scoring. Each is held twice: the kernels on the
    inputs the path gave them (hold_kernel_inputs: the kernel
    tolerances), and the path's output against the plain attention in
    bf16 and fp32 (a_vs_plain over all elements, TOL_MODEL: the max of
    one log-prob's error moves with the data, either way, more than the
    kernels do)."""
    import dataclasses
    from skypilot_tpu_torch.models import decode
    from skypilot_tpu_torch.ops import flash_attention as fa
    from skypilot_tpu_torch.train import grpo, train_lib
    from skypilot_tpu_torch.train.rollout import learner as learner_lib
    cfg, mod, gcfg, _, _, ref_lp_fn = learner_lib._grpo_pieces(
        spec, None, HARVEST_LR, HARVEST_STEPS)
    params = mod.init_params(
        cfg, torch.Generator(device='cuda').manual_seed(spec.seed), 'cuda')
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    with torch.no_grad():
        p32 = decode.cast_params_for_decode(params, cfg32)
        p16 = decode.cast_params_for_compute(params, cfg)
    batch = learner_lib._assemble_batch(
        spec, gcfg, learner_lib._read_log_step(traj_path), 'cuda')
    seq, comp_idx, behavior_lp, adv, mask = batch
    ref_lp = learner_lib._ref_logprobs(ref_lp_fn, params, batch)
    b, L = seq.shape       # token_logprobs attends over L - 1 tokens
    g, s = spec.group_size, spec.prompt_len
    runs = [
        (f'the learner\'s scoring (B={b}, S={L - 1})', params,
         lambda c, p: grpo.token_logprobs(p, seq, c, mod,
                                          spec.temperature)[0]),
        (f'the worker\'s prefill on its compute cast (B={g}, S={s})', p16,
         lambda c, p: decode.prefill_cache(p, seq[:g, :s], c, L)[0]),
        (f'the worker\'s behaviour scoring on its compute cast (B={g}, '
         f'S={L - 1})', p16,
         lambda c, p: grpo.token_logprobs(p, seq[:g], c, mod,
                                          spec.temperature)[0])]
    for what, tree, fn in runs:
        with torch.no_grad(), first_kernel_inputs(fa) as rec:
            fn(cfg, tree)
        hold_kernel_inputs(torch, fa, rec, tag, what)
        a_vs_plain(torch, fn, cfg, tree, p32, tag, what, whole=True)
    del p16, p32, rec
    free_card(torch)
    for leaf in train_lib.leaves(params):
        leaf.requires_grad_(True)

    def loss_fn(c, p):
        return grpo.grpo_loss(p, c, gcfg, mod, seq, comp_idx, behavior_lp,
                              adv, mask, ref_lp)[0]
    what = f'the update on the logged batch (B={b}, S={L - 1})'
    log(f'{tag} {what}, max |advantage| {float(adv.abs().max()):.3f}: '
        f'grads against the plain attention')
    with first_kernel_inputs(fa) as rec:
        check_grads(torch, cfg, params, None, tag, loss_fn=loss_fn)
    hold_kernel_inputs(torch, fa, rec, tag, what)
    del params, batch, ref_lp, rec
    free_card(torch)


def phase_harvest(torch, build, card: str) -> dict:
    """Harvested RL at llama-1b's full width: run_harvest with the kill
    and the rejoin; every step completes; the killed worker journaled
    rollout_worker_lost and its leases rollout_lease_reassign; every
    spawned worker left its stats file, and the fresh one generated its
    first group after the degraded window and before the post-rejoin
    one; some group's rewards vary (the advantages are not all 0);
    kernel A exactly 2 x layers x groups generated in each worker
    (prefill, behaviour scoring) and, in the learner, A 3 x layers a step
    (the reference scoring, the update's forward and its recompute) and
    C, D once a layer, plus one update of the warm-up; then, outside the
    counted run, replay_losses over the trajectory log bit-equal to the
    live losses, A, C and D at the run's shapes against the plain
    attention (harvest_vs_plain), and one lease generated twice against
    the newest snapshot byte-identical (a second lease differs). Prints
    run_harvest's samples/s before the kill, degraded and after the
    rejoin, s/step, publish and restore seconds of the fp32 snapshot,
    peak memory of the learner and of each worker, with the card.
    Returns the run's launch counts (learner + workers)."""
    import glob
    import shutil
    from skypilot_tpu_torch import config
    from skypilot_tpu_torch.observe import journal
    from skypilot_tpu_torch.train.rollout import harness
    from skypilot_tpu_torch.train.rollout import learner as learner_lib
    from skypilot_tpu_torch.train.rollout import worker as worker_lib
    tag = '[harvest]'
    t_phase = time.perf_counter()
    run_dir = os.path.join(HERE, '.smoke_harvest')
    shutil.rmtree(run_dir, ignore_errors=True)
    stats_dir = os.path.join(run_dir, 'stats')
    old_db = os.environ.get('SKYTPU_OBSERVE_DB')
    os.environ['SKYTPU_OBSERVE_DB'] = os.path.join(run_dir, 'journal.db')
    cfg = config.get_config('llama-1b')
    n_l = cfg.n_layers
    try:
        torch.cuda.reset_peak_memory_stats()
        build.reset_launches()
        art = harness.run_harvest(
            run_dir, n_workers=HARVEST_WORKERS, total_steps=HARVEST_STEPS,
            kill_at_step=HARVEST_KILL_AT, kill_count=1,
            respawn_at_step=HARVEST_RESPAWN_AT,
            groups_per_step=HARVEST_GROUPS, publish_every=HARVEST_PUBLISH,
            max_staleness=2, learning_rate=HARVEST_LR,
            heartbeat_timeout=HARVEST_HEARTBEAT_S, lease_timeout=120.0,
            stall_budget_s=300.0, tag='smoke', device='cuda',
            stats_dir=stats_dir, snapshot_max_to_keep=2,
            spec_overrides=dict(
                model='llama-1b', reward=harness.EVEN_TOKEN_REWARD,
                vocab_size=cfg.vocab_size, prompt_len=HARVEST_S,
                group_size=HARVEST_G, max_new_tokens=HARVEST_NEW,
                temperature=1.0, kl_coef=HARVEST_KL, seed=0,
                rollout_delay_s=HARVEST_DELAY_S))
        torch.cuda.synchronize()
        learner_launches = launch_counts(build)
        learner_peak = torch.cuda.max_memory_allocated() / 1e9
        spec = art['spec']
        workers = {}
        for wid in art['workers']:
            path = os.path.join(stats_dir, f'{wid}.json')
            if not os.path.exists(path):
                fail(f'{tag} worker {wid} left no stats file: it never '
                     f'restored a snapshot')
            with open(path) as f:
                workers[wid] = json.load(f)
        history = art['history']
        log(f'{tag} llama-1b whole, {HARVEST_GROUPS} groups of '
            f'{HARVEST_G} x ({HARVEST_S} + {HARVEST_NEW}) tokens a step, '
            f'kl {HARVEST_KL}, {HARVEST_DELAY_S}s pacing a group: '
            f'{art["steps"]} of {HARVEST_STEPS} steps in '
            f'{art["duration_s"]:.1f}s; killed {art["killed"]} after step '
            f'{HARVEST_KILL_AT}, workers {art["workers"]}; report '
            f'{json.dumps(art["report"])}')
        if art['steps'] != HARVEST_STEPS or len(art['killed']) != 1:
            fail(f'{tag} steps {art["steps"]}, killed {art["killed"]}')
        lost_ev = journal.query(kind='rollout_worker_lost', limit=100)
        lost = [e['entity'] for e in lost_ev]
        moved = [e for e in journal.query(kind='rollout_lease_reassign',
                                          limit=100)
                 if e['entity'] in art['killed']]
        # Journal stamps are wall-clock, the step stamps monotonic.
        last_step = art['step_walls'][-1] + (time.time() - time.monotonic())
        when = [(e['entity'], round(e['ts'] - last_step, 2)) for e in lost_ev]
        log(f'{tag} journal: rollout_worker_lost {when} (s after the last '
            f'step); '
            f'rollout_lease_reassign of the killed worker '
            f'{[(e["reason"], e["data"]) for e in moved]}')
        for wid in art['killed']:
            if wid not in lost or not any(e['entity'] == wid and
                                          e['data']['leases']
                                          for e in moved):
                fail(f'{tag} no loss or reassignment journaled for {wid}')
        # Launches: the learner in this process, each worker in its own.
        want = want_launches(build, flash_fwd=n_l * (2 + 3 * HARVEST_STEPS),
                             flash_dq=n_l * (1 + HARVEST_STEPS),
                             flash_dkv=n_l * (1 + HARVEST_STEPS))
        log(f'{tag} learner launches {learner_launches} (want {want})')
        if learner_launches != want:
            fail(f'{tag} learner launches {learner_launches} != {want}')
        launches = dict(learner_launches)
        for wid, st in workers.items():
            got = st['kernel_launches']
            w_want = {n: (2 * n_l * st['generated'] if n == 'flash_fwd'
                          else 0) for n in got}
            gen_s = (f'{statistics.median(st["generate_s"]):.3f}'
                     if st['generate_s'] else 'none')
            log(f'{tag} worker {wid}: {st["generated"]} groups generated, '
                f'launches {got} (want {w_want}); restore s '
                f'{[round(x, 3) for x in st["restore_s"]]}; generate s '
                f'(median, pacing included) {gen_s}; peak memory '
                f'{st["peak_memory_gb"]:.2f} GB | {card}')
            if got != w_want:
                fail(f'{tag} worker {wid} launches {got} != {w_want}')
            for n, c in got.items():
                launches[n] = launches.get(n, 0) + c
        if sum(st['generated'] for st in workers.values()) < \
                HARVEST_STEPS * HARVEST_GROUPS:
            fail(f'{tag} workers generated fewer groups than the learner '
                 f'consumed: {workers}')
        # The fresh worker: its first group after the degraded window
        # (steps HARVEST_KILL_AT + 1 .. + 6) and before the last 5 step
        # stamps, which the post-rejoin rate spans.
        walls = art['step_walls']
        fresh = art['workers'][HARVEST_WORKERS:]
        for wid in fresh:
            done = workers[wid]['generated_at']
            if not done:
                fail(f'{tag} the fresh worker {wid} generated no group in '
                     f'{HARVEST_STEPS} steps')
            log(f'{tag} fresh worker {wid}: first group '
                f'{done[0] - art["respawn_wall"]:.2f}s after its spawn; '
                f'degraded window ends '
                f'{walls[HARVEST_KILL_AT + 5] - art["respawn_wall"]:.2f}s, '
                f'post-rejoin window starts '
                f'{walls[-5] - art["respawn_wall"]:.2f}s after it')
            if not walls[HARVEST_KILL_AT + 5] < done[0] < walls[-5]:
                fail(f'{tag} the fresh worker\'s first group falls outside '
                     f'the gap between the degraded and the post-rejoin '
                     f'windows: the rates would not measure what they '
                     f'are named')
        log(f'{tag} samples/s (run_harvest\'s windows): whole run '
            f'{art["samples_per_sec"]!r}; before the kill '
            f'{art["pre_kill_sps"]!r}, degraded {art["degraded_sps"]!r}, '
            f'after the rejoin {art["post_rejoin_sps"]!r}; recovery to '
            f'90% of the pre-kill rate {art["recovery_s"]!r} s after the '
            f'kill | {card}')
        log(f'{tag} s/step {[h["sec_per_step"] for h in history]}; losses '
            f'{art["losses"]}; mean rewards '
            f'{[round(h["mean_reward"], 4) for h in history]}')
        logged = sorted(glob.glob(os.path.join(art['traj_log_dir'],
                                               'traj_*.npz')))
        varied = sum(int(np.var(g['rewards']) > 0) for p in logged
                     for g in learner_lib._read_log_step(p))
        log(f'{tag} groups whose rewards vary (non-zero advantages): '
            f'{varied} of {len(logged) * HARVEST_GROUPS}')
        if varied == 0:
            fail(f'{tag} every group\'s rewards are equal: every advantage '
                 f'is 0 and the update trains on the KL term alone')
        snap_gb = cfg.num_params * 4 / 1e9
        restores = [x for st in workers.values() for x in st['restore_s']]
        log(f'{tag} snapshot {snap_gb:.2f} GB fp32: publish s '
            f'{[round(x, 3) for x in art["report"]["publish_s"]]}, worker '
            f'restore s {[round(x, 3) for x in restores]}; learner peak '
            f'memory {learner_peak:.2f} GB | {card}')

        # Replay, outside the counted run: the same update code on the
        # same log from the same seed, bit for bit.
        t0 = time.perf_counter()
        replayed = learner_lib.replay_losses(
            spec, art['traj_log_dir'], learning_rate=HARVEST_LR,
            total_steps=HARVEST_STEPS, device='cuda')
        log(f'{tag} replay of the trajectory log: {replayed} in '
            f'{time.perf_counter() - t0:.1f}s; bit-equal to the live '
            f'losses: {replayed == art["losses"]}')
        if replayed != art['losses']:
            fail(f'{tag} replay {replayed} != live {art["losses"]}')
        free_card(torch)
        harvest_vs_plain(torch, spec, logged[-1], tag)
        # One lease twice against the newest snapshot, and another.
        w = worker_lib.RolloutWorker(('127.0.0.1', 1),
                                     worker_id='smoke-regen', device='cuda')
        w._spec, w._latest_version = spec, art['report']['snapshot_version']
        t0 = time.perf_counter()
        if not (w._ensure_model() and w._ensure_snapshot()):
            fail(f'{tag} the regeneration worker restored no snapshot')
        t_restore = time.perf_counter() - t0
        lease = 1000
        first, again, other = (w._generate(lease), w._generate(lease),
                               w._generate(lease + 1))
        same = {k: first[k].tobytes() == again[k].tobytes() for k in first}
        differ = first['completions'].tobytes() != \
            other['completions'].tobytes()
        log(f'{tag} lease {lease} twice against snapshot '
            f'v{w._held_version} (restored in this process in '
            f'{t_restore:.2f}s): byte-identical {same}; lease {lease + 1} '
            f'differs: {differ}')
        if not all(same.values()) or not differ:
            fail(f'{tag} same-lease regeneration {same}, differ {differ}')
        w.stop()
        del w
    finally:
        if old_db is None:
            os.environ.pop('SKYTPU_OBSERVE_DB', None)
        else:
            os.environ['SKYTPU_OBSERVE_DB'] = old_db
        shutil.rmtree(run_dir, ignore_errors=True)
    free_card(torch)
    log(f'{tag} phase took {time.perf_counter() - t_phase:.1f}s')
    return launches


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
# gpt-oss-20b's serve phase at full width, cut to 2 of its 24 layers
# (one windowed, one global; sinks: no kernel) so that the whole script
# keeps a margin inside its time limit.
GPTOSS_SERVE_DEPTH = 2


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


# ---------------------------------------------------------------------------
# The ring phase: context-parallel training
# ---------------------------------------------------------------------------

# (a) Kernels C and D's fp32 mode at a ring block's shape (sq = tk =
# 2048, B=2): llama-1b's heads (16/8, D=128), gemma-7b's (16/16,
# D=256), llama3.2-1b's (32/8, D=64), causal and not, the last two with
# an lse cotangent (the ring's -delta rides in as one).
RING_F32_CASES = [(2, 2048, 16, 8, 128, True, False),
                  (2, 2048, 16, 8, 128, False, True),
                  (2, 2048, 16, 16, 256, True, False),
                  (2, 2048, 16, 16, 256, False, True),
                  (2, 2048, 32, 8, 64, True, False),
                  (2, 2048, 32, 8, 64, False, True)]
# (b) The ring on two ranks sharing the card over gloo: llama-1b's
# attention (16/8 heads, hd 128), B=1, global S=8192 (4096 a rank, so
# 2048-token blocks), causal, both layouts; against kernels A, C and D
# over the whole sequence in one process, at the JAX ring test's bounds
# (tests/unit_tests/test_ring_attention.py): max |out - ref| < 3e-2,
# each grad's max|err| / max|ref| < 2e-2.
RING_B, RING_S, RING_RANKS = 1, 8192, 2
TOL_RING_OUT, TOL_RING_GRAD = 3e-2, 2e-2
# (c) The trainer CLI, two gang processes on the card: llama-1b at full
# width cut to RING_TRAIN_DEPTH of its 16 layers (8 since the kv_int8
# phase, 4 since the fsdp phase), remat 'full', 2 x 4096 tokens (2048 a
# rank), zigzag ring, 2 steps.
RING_TRAIN_B, RING_TRAIN_S, RING_TRAIN_STEPS = 2, 4096, 2
RING_TRAIN_DEPTH = 4
RING_KERNELS = ('flash_fwd', 'flash_dq_f32', 'flash_dkv_f32')


def ring_f32_check(torch, fa, card: str) -> dict:
    """(a): C and D's fp32 mode (``_bwd(grad_dtype=torch.float32)``)
    against the plain backward in fp32 on the same bf16 inputs (TOL_BWD,
    the existing C/D check's bound); its outputs rounded to bf16
    bit-equal to the bf16 mode's (the same accumulation, rounded on
    store or not); each mode's launch timed alone."""
    worst = {'flash_dq_f32': 0.0, 'flash_dkv_f32': 0.0}
    for i, (b, s, h, kh, d, causal, with_dlse) in enumerate(RING_F32_CASES):
        qs, k, v, o, lse, do, dlse = bwd_inputs(torch, fa, b, s, h, kh, d,
                                                causal, with_dlse,
                                                seed=900 + i)
        got = fa._bwd(qs, k, v, o, lse, do, dlse, causal,
                      grad_dtype=torch.float32)
        b16 = fa._bwd(qs, k, v, o, lse, do, dlse, causal)
        ref = fa.flash_attention_bwd_ref(qs.float(), k.float(), v.float(),
                                         o.float(), lse, do.float(), dlse,
                                         causal=causal)
        torch.cuda.synchronize()
        rel, diff = [], []
        for name, a, a16, r in zip(('dq', 'dk', 'dv'), got, b16, ref):
            if a.dtype != torch.float32 or not bool(a.isfinite().all()):
                fail(f'[ring] fp32 mode: {name} is {a.dtype} or non-finite '
                     f'in case {i}')
            rel.append(max_err(a, r) / float(r.abs().max()))
            diff.append(max_err(a.to(torch.bfloat16), a16))
        ok = max(rel) < TOL_BWD
        same = max(diff) == 0.0
        log(f'[ring] fp32 mode B={b} S=T={s} H={h} KH={kh} D={d} causal='
            f'{causal} dlse={with_dlse}: max|err|/max|ref| dq {rel[0]:.3e} '
            f'dk {rel[1]:.3e} dv {rel[2]:.3e} (tol {TOL_BWD}) '
            f'{"ok" if ok else "MISMATCH"}; rounded to bf16 vs the bf16 '
            f'mode: {"bit-equal" if same else f"max diff {max(diff):.3e}"}')
        if not ok:
            fail(f'[ring] the fp32 mode of C and D disagrees in case {i}')
        if not same:
            fail(f'[ring] the fp32 mode rounded to bf16 differs from the '
                 f'bf16 mode in case {i} (max {max(diff)})')
        worst['flash_dq_f32'] = max(worst['flash_dq_f32'],
                                    max_err(got[0], ref[0]))
        worst['flash_dkv_f32'] = max(worst['flash_dkv_f32'],
                                     max_err(got[1], ref[1]),
                                     max_err(got[2], ref[2]))
        del got, b16, ref
    for b, s, h, kh, d, causal, _ in RING_F32_CASES[::2]:
        shape = dict(s=s, h=h, kh=kh, d=d)
        ms = {}
        for f32 in (False, True):
            _, dq, dkv = bwd_launches(torch, fa, b, shape, f32)
            ms[f32] = (time_ms(dq), time_ms(dkv))
        log(f'[ring] C, D at B={b} S=T={s} H={h} KH={kh} D={d} causal: '
            f'fp32 mode {ms[True][0]:.4f}, {ms[True][1]:.4f} ms; bf16 mode '
            f'{ms[False][0]:.4f}, {ms[False][1]:.4f} ms | {card}')
    return worst


# Blocks a rank's causal ring over two ranks computes (each one launch
# of A in the forward, and one of C and of D in the backward): the
# visible (q chunk, kv chunk) pairs over its 2 steps. 'seq': rank 0
# sees its own diagonal, rank 1 its diagonal and rank 0's chunk.
# 'zigzag' (rank 0 holds chunks 0 and 3, rank 1 chunks 1 and 2): 3 pairs
# of its own chunks and 2 of the other's, on either rank.
RING_BLOCKS = {'seq': (1, 2), 'zigzag': (5, 5)}


def ring_worker(rank: int, port: int) -> None:
    """(b), one rank: the ring's forward and backward over this rank's
    shard of the global sequence, both layouts, against kernels A, C and
    D over the whole sequence in this process; launches from 0 around
    the ring, ms of a forward + backward (both ranks on the card at
    once); what the trainer's collectives cost here; whether gloo
    all-reduces a CUDA tensor (the train step's reduction). Writes
    chiprun_out/ring_rank<r>.json."""
    import torch
    import torch.distributed as dist
    from skypilot_tpu_torch.kernels import build
    from skypilot_tpu_torch.ops import flash_attention as fa
    from skypilot_tpu_torch.ops import ring_attention as ring
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh_lib.init_distributed(f'127.0.0.1:{port}', RING_RANKS, rank,
                              'cuda:0', timeout_s=60)
    n, sl = RING_RANKS, RING_S // RING_RANKS
    g = torch.Generator(device='cuda').manual_seed(31)

    def rand(*shape):
        return torch.randn(shape, generator=g, device='cuda').bfloat16()
    q, do = rand(RING_B, RING_S, 16, 128), rand(RING_B, RING_S, 16, 128)
    k, v = rand(RING_B, RING_S, 8, 128), rand(RING_B, RING_S, 8, 128)
    # One process, the whole sequence: kernels A, C, D.
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    ref_o = fa.flash_attention(*leaves, causal=True)
    ref = (ref_o,) + torch.autograd.grad(ref_o, leaves, do)
    result = {'rank': rank, 'layouts': {}}
    for layout in ('seq', 'zigzag'):
        def mine(x):
            if layout == 'zigzag':
                x = ring.zigzag_permute(x, n)
            return x[:, rank * sl:(rank + 1) * sl].contiguous()

        def run(ql, kl, vl, dol):
            ql, kl, vl = (x.clone().requires_grad_() for x in (ql, kl, vl))
            out = ring.ring_attention(ql, kl, vl, group=dist.group.WORLD,
                                      causal=True, layout=layout)
            return (out,) + torch.autograd.grad(out, (ql, kl, vl), dol)
        local = [mine(x) for x in (q, k, v, do)]
        build.reset_launches()
        got = run(*local)
        torch.cuda.synchronize()
        launches = {nm: kern.launches for nm, kern in build.kernels().items()}
        errs = {'out': max_err(got[0], mine(ref[0]))}
        for name, a, r in zip(('dq', 'dk', 'dv'), got[1:], ref[1:]):
            r = mine(r)
            errs[name] = max_err(a, r) / float(r.abs().max())
        times = []
        for _ in range(3):
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(*local)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        want = RING_BLOCKS[layout][rank]
        result['layouts'][layout] = dict(
            errs=errs, launches=launches, want=want,
            ms=statistics.median(times))
    probe = {}
    t = torch.full((4,), float(rank + 1), device='cuda')
    dist.all_reduce(t)
    probe['gloo_all_reduce_cuda'] = (
        'ok' if bool((t == n * (n + 1) / 2).all()) else f'wrong: {t}')
    result['probe'] = probe

    def timed_ms(fn):
        samples = []
        for _ in range(3):
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            samples.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(samples)
    # What the trainer's collectives cost here: one 256 MiB grad bucket
    # all-reduced (train_lib.BUCKET_BYTES), one 64 MiB ring message.
    bucket = torch.ones(64 << 20, device='cuda')
    msg = torch.ones(64 << 20, dtype=torch.uint8, device='cuda')
    result['comm_ms'] = {
        'all_reduce_256MiB': timed_ms(lambda: dist.all_reduce(bucket)),
        'rotate_64MiB': timed_ms(lambda: ring._rotate([msg],
                                                      dist.group.WORLD))}
    del bucket, msg
    with open(os.path.join(OUT_DIR, f'ring_rank{rank}.json'), 'w') as f:
        json.dump(result, f)
    dist.destroy_process_group()


def gloo_p2p_probe(rank: int, port: int) -> None:
    """One rank of a pair that tries gloo's send and recv of a tensor on
    the card, as they are (the ring stages its messages through the
    host instead). Writes the outcome to chiprun_out/gloo_p2p<r>.json;
    the parent reports it, or the abort of this process, and never
    fails on it."""
    import torch
    import torch.distributed as dist
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    mesh_lib.init_distributed(f'127.0.0.1:{port}', RING_RANKS, rank,
                              'cuda:0', timeout_s=60)
    path = os.path.join(OUT_DIR, f'gloo_p2p{rank}.json')
    other = (rank + 1) % RING_RANKS
    send = torch.full((4,), float(rank), device='cuda')
    recv = torch.zeros(4, device='cuda')
    try:
        for req in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, send, other),
                dist.P2POp(dist.irecv, recv, other)]):
            req.wait()
        got = ('ok' if float(recv[0]) == other else
               f'wrong data: {recv.tolist()}')
    except (RuntimeError, ValueError) as e:
        got = f'refused: {str(e).splitlines()[0][:160]}'
    with open(path, 'w') as f:
        json.dump({'gloo_p2p_cuda': got}, f)
    dist.destroy_process_group()


def spawn_ranks(cmds, envs, logs, timeout: float):
    """Start one process a rank, wait for all (killing every one when a
    rank fails or the time runs out); returns their exit codes."""
    procs = []
    try:
        for cmd, env, path in zip(cmds, envs, logs):
            f = open(path, 'w')
            procs.append((subprocess.Popen(cmd, cwd=HERE, env=env, stdout=f,
                                           stderr=subprocess.STDOUT), f))
        deadline = time.monotonic() + timeout
        # A rank that failed leaves the others waiting on it: stop them.
        while any(p.poll() is None for p, _ in procs):
            if time.monotonic() > deadline or any(
                    p.poll() not in (None, 0) for p, _ in procs):
                break
            time.sleep(0.5)
    finally:
        for p, f in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            f.close()
    return [p.returncode for p, _ in procs]


def rank_env(rank: int, port: int, ranks: int = RING_RANKS) -> dict:
    """The gang's environment for ``rank`` of ``ranks`` on this host,
    the ranks sharing the card over gloo."""
    return dict(os.environ, PYTHONPATH=HERE,
                SKYTPU_COORDINATOR_ADDRESS=f'127.0.0.1:{port}',
                SKYTPU_NUM_PROCESSES=str(ranks),
                SKYTPU_NODE_RANK=str(rank),
                SKYTPU_TORCH_DIST_BACKEND='gloo')


def fresh(paths) -> None:
    """Remove an earlier run's result and log files, so that a rank that
    writes none is seen to have written none."""
    for path in paths:
        if os.path.exists(path):
            os.remove(path)


def ring_two_ranks(card: str) -> None:
    """(b): two ring_worker processes on the card; every rank exits 0,
    every error within its bound, launches as the blocks the ranks see.
    Then a pair of gloo_p2p_probe processes, reported only."""
    port = free_port()
    logs = [os.path.join(OUT_DIR, f'ring_worker{r}.log')
            for r in range(RING_RANKS)]
    paths = [os.path.join(OUT_DIR, f'ring_rank{r}.json')
             for r in range(RING_RANKS)]
    fresh(logs + paths)
    rcs = spawn_ranks(
        [[sys.executable, os.path.join(HERE, 'chip_smoke.py'),
          '--ring-worker', str(r), '--ring-port', str(port)]
         for r in range(RING_RANKS)],
        [rank_env(r, port) for r in range(RING_RANKS)], logs, 300)
    for r in range(RING_RANKS):
        if rcs[r] != 0 or not os.path.exists(paths[r]):
            tail = ''.join(open(logs[r]).readlines()[-15:])
            fail(f'[ring] rank {r} exited {rcs[r]} (result '
                 f'{"written" if os.path.exists(paths[r]) else "missing"}):'
                 f'\n{tail}')
    for r in range(RING_RANKS):
        with open(paths[r]) as f:
            res = json.load(f)
        for layout, lr in res['layouts'].items():
            e, lc, want = lr['errs'], lr['launches'], lr['want']
            ok = (e['out'] < TOL_RING_OUT and
                  max(e['dq'], e['dk'], e['dv']) < TOL_RING_GRAD)
            launch_ok = lc == {n: (want if n in RING_KERNELS else 0)
                               for n in lc}
            log(f'[ring] 2 ranks on one card (gloo), rank {r}, {layout}: '
                f'S={RING_S} ({RING_S // RING_RANKS} a rank), 16/8 heads, '
                f'hd 128: max|out err| {e["out"]:.3e} (tol {TOL_RING_OUT}), '
                f'grads max|err|/max|ref| dq {e["dq"]:.3e} dk {e["dk"]:.3e} '
                f'dv {e["dv"]:.3e} (tol {TOL_RING_GRAD}) '
                f'{"ok" if ok else "MISMATCH"}; launches A '
                f'{lc["flash_fwd"]}, C fp32 {lc["flash_dq_f32"]}, D fp32 '
                f'{lc["flash_dkv_f32"]} (want {want} each), fwd+bwd '
                f'{lr["ms"]:.1f} ms | {card}')
            if not ok:
                fail(f'[ring] rank {r} {layout}: the ring disagrees with '
                     f'the one-process kernels')
            if not launch_ok:
                fail(f'[ring] rank {r} {layout}: launches {lc}, want '
                     f'{want} of each of {RING_KERNELS}')
        comm = res['comm_ms']
        log(f'[ring] rank {r} gloo on the card: a 256 MiB all_reduce '
            f'{comm["all_reduce_256MiB"]:.1f} ms, a 64 MiB ring message '
            f'(host-staged) {comm["rotate_64MiB"]:.1f} ms | {card}')
        log(f'[ring] rank {r} gloo all_reduce of a CUDA tensor: '
            f'{res["probe"]["gloo_all_reduce_cuda"]}')
        if res['probe']['gloo_all_reduce_cuda'] != 'ok':
            fail(f'[ring] gloo all_reduce of a CUDA tensor: '
                 f'{res["probe"]["gloo_all_reduce_cuda"]}')
    port = free_port()
    logs = [os.path.join(OUT_DIR, f'gloo_p2p{r}.log')
            for r in range(RING_RANKS)]
    paths = [os.path.join(OUT_DIR, f'gloo_p2p{r}.json')
             for r in range(RING_RANKS)]
    fresh(logs + paths)
    rcs = spawn_ranks(
        [[sys.executable, os.path.join(HERE, 'chip_smoke.py'),
          '--gloo-probe', str(r), '--ring-port', str(port)]
         for r in range(RING_RANKS)],
        [rank_env(r, port) for r in range(RING_RANKS)], logs, 120)
    for r in range(RING_RANKS):
        got = f'the rank ended (rc {rcs[r]}) in the attempt'
        if os.path.exists(paths[r]):
            with open(paths[r]) as f:
                got = json.load(f)['gloo_p2p_cuda']
        log(f'[ring] rank {r} gloo send/recv of a CUDA tensor (reported '
            f'only; the ring stages through the host): {got}')


def ring_trainer(torch, card: str) -> dict:
    """(c): ``python -m skypilot_tpu_torch.train.trainer --mesh
    sequence=2`` with zigzag ring attention as two gang processes on the
    card; the losses against the single-process trainer on the same
    batches (TOL_LOSS), both replicas' params sha256 equal, every rank's
    launches as its ring blocks (A twice a block under remat 'full', C
    and D in their fp32 mode once), ms per step, each rank's peak
    memory. Returns the ranks' launches, summed."""
    from skypilot_tpu_torch.train import trainer
    port = free_port()
    logs = [os.path.join(OUT_DIR, f'ring_trainer{r}.log')
            for r in range(RING_RANKS)]
    fresh(logs)
    flags = ['--model', 'llama-1b', '--batch-size', str(RING_TRAIN_B),
             '--seq-len', str(RING_TRAIN_S), '--steps', str(RING_TRAIN_STEPS),
             '--log-every', '1']
    cmd = [sys.executable, '-m', 'skypilot_tpu_torch.train.trainer', *flags,
           '--mesh', f'sequence={RING_RANKS}',
           '--model-override', 'attention_impl=ring',
           '--model-override', 'ring_layout=zigzag',
           '--model-override', f'n_layers={RING_TRAIN_DEPTH}']
    t0 = time.perf_counter()
    rcs = spawn_ranks([cmd] * RING_RANKS,
                      [rank_env(r, port) for r in range(RING_RANKS)], logs,
                      600)
    wall = time.perf_counter() - t0
    recs = []
    for r in range(RING_RANKS):
        with open(logs[r]) as f:
            recs.append([json.loads(line) for line in f
                         if line.startswith('{')])
        if rcs[r] != 0:
            tail = ''.join(open(logs[r]).readlines()[-15:])
            fail(f'[ring] trainer rank {r} exited {rcs[r]}:\n{tail}')
    hist = [x for x in recs[0] if 'loss' in x]
    reps = [next(x for x in rs if 'replica' in x) for rs in recs]
    if any('loss' in x for x in recs[1]):
        fail('[ring] rank 1 wrote log records: rank 0 alone writes them')
    digests = {x['params_sha256'] for x in reps}
    layers = RING_TRAIN_DEPTH
    launch_ok = True
    for x in reps:
        blocks = RING_BLOCKS['zigzag'][x['replica']]
        want = {n: 0 for n in x['kernel_launches']}
        want.update(flash_fwd=2 * blocks * layers * RING_TRAIN_STEPS,
                    flash_dq_f32=blocks * layers * RING_TRAIN_STEPS,
                    flash_dkv_f32=blocks * layers * RING_TRAIN_STEPS)
        launch_ok &= x['kernel_launches'] == want
        log(f'[ring] trainer rank {x["replica"]}: launches '
            f'{x["kernel_launches"]} (want {want}); peak memory '
            f'{x.get("peak_memory_gb")} GB; params sha256 '
            f'{x["params_sha256"][:16]} | {card}')
    sec = statistics.median(x['sec_per_step'] for x in hist[1:])
    log(f'[ring] trainer --mesh sequence={RING_RANKS}, llama-1b '
        f'({RING_TRAIN_DEPTH} of 16 layers), zigzag, '
        f'{RING_TRAIN_B}x{RING_TRAIN_S}, {RING_TRAIN_STEPS} steps: losses '
        f'{[x["loss"] for x in hist]}, {sec * 1e3:.1f} ms/step (median of '
        f'steps 2-{RING_TRAIN_STEPS}), the two processes {wall:.1f}s from '
        f'start to exit | {card}')
    if len(digests) != 1:
        fail(f'[ring] the replicas\' params differ: {digests}')
    if not launch_ok:
        fail('[ring] the trainer ranks\' launches are not their ring '
             'blocks\'')
    torch.cuda.reset_peak_memory_stats()
    one = trainer.train(trainer.TrainerConfig(
        model='llama-1b', model_overrides={'n_layers': RING_TRAIN_DEPTH},
        batch_size=RING_TRAIN_B, seq_len=RING_TRAIN_S,
        total_steps=RING_TRAIN_STEPS, log_every=1, device='cuda'))
    diff = max(abs(a['loss'] - b['loss']) for a, b in zip(hist, one))
    log(f'[ring] the single-process trainer (kernels A, C, D over the whole '
        f'sequence): losses {[x["loss"] for x in one]}, '
        f'{statistics.median(x["sec_per_step"] for x in one[1:]) * 1e3:.1f}'
        f' ms/step, peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; '
        f'max |loss diff| {diff:.4f} (tol {TOL_LOSS}) | {card}')
    if len(one) != len(hist) or diff > TOL_LOSS:
        fail(f'[ring] the 2-rank trainer\'s losses depart from the '
             f'single process\'s by {diff}')
    return {n: sum(x['kernel_launches'][n] for x in reps)
            for n in reps[0]['kernel_launches']}


def phase_ring(torch, fa, build, card: str) -> dict:
    """Context-parallel training: (a) C and D's fp32 mode, (b) the ring
    on two ranks sharing the card, (c) the trainer's --mesh sequence=2.
    Returns (the fp32 mode's errors, the trainer ranks' launches)."""
    t0 = time.perf_counter()
    errs = ring_f32_check(torch, fa, card)
    free_card(torch)
    t1 = time.perf_counter()
    ring_two_ranks(card)
    t2 = time.perf_counter()
    launches = ring_trainer(torch, card)
    log(f'[ring] parts: (a) {t1 - t0:.1f}s, (b) {t2 - t1:.1f}s, (c) '
        f'{time.perf_counter() - t2:.1f}s')
    return errs, launches


# ---------------------------------------------------------------------------
# The fsdp phase: the JAX trainer's default mesh, params fully sharded
# ---------------------------------------------------------------------------

# fsdp: `python -m skypilot_tpu_torch.train.trainer` as FSDP_RANKS gang
# processes sharing the card over gloo with no --mesh (JAX's MeshSpec():
# fsdp=2): llama-1b whole (16 layers, 0.97 B params, 15.6 GB of fp32
# params, moments and grads; 7.8 GB a rank), FSDP_STEPS steps of FSDP_B
# x FSDP_S saving the last; that step restored on one process and on
# the gang, one more step each; then moe-1b at train_moe's depth at
# --mesh data=2, FSDP_MOE_STEPS steps (its router aux's means over both
# ranks' rows).
FSDP_RANKS = 2
FSDP_B, FSDP_S, FSDP_STEPS, FSDP_MOE_STEPS = 4, 2048, 3, 2
FSDP_DIR = os.path.join(HERE, '.smoke_fsdp')
# The aux of the gang against one process, relative: each rank's bf16
# products run at 2 of the batch's 4 rows, so a router input may differ
# in its last bit and a near-tied route flip (one token of 8192 moves
# f_e by 1.2e-4 of its mass).
TOL_AUX = 1e-3


def fsdp_gang(flags, tag: str, card: str, port: int) -> tuple:
    """The trainer CLI with ``flags`` as FSDP_RANKS gang processes on the
    card, rank 0 listening on ``port``: (rank 0's step records, each
    rank's replica record, the wall seconds). Any rank's failure fails
    the phase."""
    logs = [os.path.join(OUT_DIR, f'fsdp_{tag}{r}.log')
            for r in range(FSDP_RANKS)]
    fresh(logs)
    cmd = [sys.executable, '-m', 'skypilot_tpu_torch.train.trainer', *flags]
    t0 = time.perf_counter()
    rcs = spawn_ranks([cmd] * FSDP_RANKS,
                      [rank_env(r, port, FSDP_RANKS)
                       for r in range(FSDP_RANKS)], logs, 600)
    wall = time.perf_counter() - t0
    recs = []
    for r in range(FSDP_RANKS):
        if rcs[r] != 0:
            tail = ''.join(open(logs[r]).readlines()[-15:])
            fail(f'[fsdp] {tag} rank {r} exited {rcs[r]}:\n{tail}')
        with open(logs[r]) as f:
            recs.append([json.loads(line) for line in f
                         if line.startswith('{')])
    if any('loss' in x for x in recs[1]):
        fail(f'[fsdp] {tag}: rank 1 wrote step records')
    reps = [next(x for x in rs if 'replica' in x) for rs in recs]
    hist = [x for x in recs[0] if 'loss' in x]
    sec = statistics.median(x['sec_per_step'] for x in hist[1:]) \
        if len(hist) > 1 else hist[0]['sec_per_step']
    log(f'[fsdp] {tag}: {FSDP_RANKS} gang processes, {" ".join(flags)}: '
        f'losses {[x["loss"] for x in hist]}'
        + (f', aux {[x["aux"] for x in hist]}' if 'aux' in hist[0] else '')
        + f', {sec * 1e3:.1f} ms/step, {wall:.1f}s from start to exit; '
        f'peak memory a rank {[x.get("peak_memory_gb") for x in reps]} GB '
        f'| {card}')
    return hist, reps, wall


def fsdp_launches_ok(reps, layers: int, steps: int, tag: str,
                     card: str) -> None:
    """Each rank launched A twice and C, D once a layer a step (remat
    'full', bf16 mode), nothing else."""
    k = layers * steps
    for x in reps:
        want = {n: 0 for n in x['kernel_launches']}
        want.update(flash_fwd=2 * k, flash_dq=k, flash_dkv=k)
        log(f'[fsdp] {tag} rank {x["replica"]} (fsdp index '
            f'{x["fsdp_index"]}): launches {x["kernel_launches"]} (want '
            f'{want}); shard sha256 {x["params_sha256"][:16]} | {card}')
        if x['kernel_launches'] != want:
            fail(f'[fsdp] {tag} rank {x["replica"]}: launches '
                 f'{x["kernel_launches"]}, want {want}')


def shard_digests(params, cfg, ranks: int) -> list:
    """sha256 of each rank's cut of ``params`` (whole, one process) at
    fsdp=``ranks``, as the trainer's replica records digest a shard."""
    from skypilot_tpu_torch.models import module_for
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    from skypilot_tpu_torch.parallel import sharding
    from skypilot_tpu_torch.train import train_lib
    axes = train_lib.leaves(module_for(cfg).param_axes(cfg))
    out = []
    for r in range(ranks):
        mesh = mesh_lib.Mesh(mesh_lib.MeshSpec().sizes(ranks), r)
        h = hashlib.sha256()
        for leaf, ax in zip(train_lib.leaves(params), axes):
            lo, size = sharding.leaf_box(leaf.shape, ax, mesh)
            cut = leaf.detach()[tuple(slice(a, a + n)
                                      for a, n in zip(lo, size))]
            h.update(cut.contiguous().cpu().numpy().data)
        out.append(h.hexdigest())
    return out


def fsdp_one_process_step(torch, tcfg, cfg, ck: str, step: int) -> tuple:
    """Step ``step`` + 1 on one process from the gang's checkpoint of
    ``step`` (restored whole, on the card), the trainer's batch and
    optimizer: (its loss, the restored params' shard digests)."""
    from skypilot_tpu_torch.data import loader
    from skypilot_tpu_torch.data_service import spec as spec_lib
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    from skypilot_tpu_torch.train import checkpoints, train_lib, trainer
    tx = train_lib.default_optimizer(learning_rate=tcfg.learning_rate,
                                     warmup_steps=tcfg.warmup_steps,
                                     total_steps=step + 1)
    t0 = time.perf_counter()
    state = checkpoints.Checkpointer(ck, cfg=cfg).restore_tree(
        checkpoints.abstract_train_state(cfg, tx), step, 'cuda')
    secs = time.perf_counter() - t0
    digests = shard_digests(state.params, cfg, FSDP_RANKS)
    source = spec_lib.load_source(trainer._dataset_spec(tcfg,
                                                        cfg.vocab_size))
    batch = loader.shard_batch(source.batch_at_step(step),
                               mesh_lib.single_device_mesh(), 'cuda')
    _, metrics = train_lib.make_train_step(cfg, tx)(state, batch)
    loss = float(metrics['loss'])
    log(f'[fsdp] one process: the gang\'s step {step} restored whole in '
        f'{secs:.1f}s (while the resumed gang ran), step {step + 1} loss '
        f'{loss:.4f}')
    del state
    return loss, digests


def phase_fsdp(torch, build, card: str) -> dict:
    """Fully-sharded training, the JAX trainer's default mesh: the
    trainer CLI as two gang processes with no --mesh (fsdp=2) on
    llama-1b whole: losses against the one-process trainer on the same
    batches (TOL_LOSS), each rank's launches (A twice, C and D once a
    layer a step) and peak memory (below the one process's); its last
    step's checkpoint restored on one process (each rank's shard digest
    equal to the cut of the restored params) and on the gang, one more
    step in each (TOL_LOSS). Then moe-1b at MOE_TRAIN_DEPTH layers at
    --mesh data=2: loss and aux against one process. The one-process
    runs go on in this process while the gangs run (whose steps wait
    mostly on their collectives through the host), and the resumed
    gang beside the moe-1b gang. Returns the ranks' launches, summed."""
    import shutil
    from skypilot_tpu_torch import config
    from skypilot_tpu_torch.train import trainer
    t_phase = time.perf_counter()
    ck = os.path.join(FSDP_DIR, 'ck')
    shutil.rmtree(FSDP_DIR, ignore_errors=True)
    common = ['--batch-size', str(FSDP_B), '--seq-len', str(FSDP_S),
              '--log-every', '1']
    launches = {}

    def add(reps):
        for x in reps:
            for n, c in x['kernel_launches'].items():
                launches[n] = launches.get(n, 0) + c
    cfg = config.get_config('llama-1b')
    tcfg = trainer.TrainerConfig(model='llama-1b', batch_size=FSDP_B,
                                 seq_len=FSDP_S, total_steps=FSDP_STEPS,
                                 log_every=1, device='cuda')
    moe_flags = ['--model', 'moe-1b', '--model-override',
                 f'n_layers={MOE_TRAIN_DEPTH}', '--mesh',
                 f'data={FSDP_RANKS}', *common, '--steps',
                 str(FSDP_MOE_STEPS)]
    ports = set()
    while len(ports) < 3:          # three gangs, two of them at once
        ports.add(free_port())
    ports = sorted(ports)
    pool = concurrent.futures.ThreadPoolExecutor(2)
    try:
        gang = pool.submit(fsdp_gang, [
            '--model', 'llama-1b', *common, '--steps', str(FSDP_STEPS),
            '--ckpt-dir', ck, '--ckpt-every', str(FSDP_STEPS)], 'llama', card,
            ports[0])
        torch.cuda.reset_peak_memory_stats()
        one = trainer.train(tcfg)
        peak = torch.cuda.max_memory_allocated() / 1e9
        free_card(torch)
        moe_one = trainer.train(trainer.TrainerConfig(
            model='moe-1b', model_overrides={'n_layers': MOE_TRAIN_DEPTH},
            batch_size=FSDP_B, seq_len=FSDP_S, total_steps=FSDP_MOE_STEPS,
            log_every=1, device='cuda'))
        free_card(torch)
        hist, reps, _ = gang.result()
        add(reps)
        fsdp_launches_ok(reps, cfg.n_layers, FSDP_STEPS, 'llama-1b', card)
        if sorted(x['fsdp_index'] for x in reps) != list(range(FSDP_RANKS)):
            fail(f'[fsdp] the default mesh did not shard over fsdp: {reps}')
        diff = max(abs(a['loss'] - b['loss']) for a, b in zip(hist, one))
        sec = statistics.median(x['sec_per_step'] for x in one[1:])
        log(f'[fsdp] one process, llama-1b whole (while the gang ran): '
            f'losses {[x["loss"] for x in one]}, {sec * 1e3:.1f} ms/step, '
            f'peak {peak:.2f} GB; the gang\'s max |loss diff| {diff:.4f} '
            f'(tol {TOL_LOSS}) | {card}')
        if len(one) != len(hist) or diff > TOL_LOSS:
            fail(f'[fsdp] the gang\'s losses depart from one process\'s '
                 f'by {diff}')
        if any(x['peak_memory_gb'] >= peak for x in reps):
            fail(f'[fsdp] a rank\'s peak {[x["peak_memory_gb"] for x in reps]}'
                 f' GB is not below one process\'s {peak:.2f} GB')

        resume = pool.submit(fsdp_gang, [
            '--model', 'llama-1b', *common, '--steps', str(FSDP_STEPS + 1),
            '--ckpt-dir', ck, '--ckpt-every', str(FSDP_STEPS)],
            'llama_resume', card, ports[1])
        moe = pool.submit(fsdp_gang, moe_flags, 'moe', card, ports[2])
        loss_one, digests = fsdp_one_process_step(torch, tcfg, cfg, ck,
                                                  FSDP_STEPS)
        free_card(torch)
        ok = digests == [x['params_sha256'] for x in reps]
        log(f'[fsdp] each rank\'s shard digest against its cut of the '
            f'restored params: {"equal" if ok else "DIFFERENT"}')
        if not ok:
            fail('[fsdp] the checkpoint does not restore the shards\' bits')
        resumed, reps, _ = resume.result()
        add(reps)
        fsdp_launches_ok(reps, cfg.n_layers, 1, 'llama-1b resumed', card)
        if [x['step'] for x in resumed] != [FSDP_STEPS + 1]:
            fail(f'[fsdp] the gang resumed at {resumed}')
        diff = abs(resumed[0]['loss'] - loss_one)
        log(f'[fsdp] step {FSDP_STEPS + 1} after the restore: gang '
            f'{resumed[0]["loss"]}, one process {loss_one:.4f}, |diff| '
            f'{diff:.4f} (tol {TOL_LOSS})')
        if diff > TOL_LOSS:
            fail(f'[fsdp] the restored gang departs from the restored one '
                 f'process by {diff}')
        hist, reps, _ = moe.result()
    finally:
        pool.shutdown(wait=True)
        shutil.rmtree(FSDP_DIR, ignore_errors=True)
    add(reps)
    fsdp_launches_ok(reps, MOE_TRAIN_DEPTH, FSDP_MOE_STEPS, 'moe-1b', card)
    d_loss = max(abs(a['loss'] - b['loss']) for a, b in zip(hist, moe_one))
    d_aux = max(abs(a['aux'] - b['aux']) / b['aux']
                for a, b in zip(hist, moe_one))
    log(f'[fsdp] one process, moe-1b ({MOE_TRAIN_DEPTH} of 12 layers): '
        f'losses {[x["loss"] for x in moe_one]}, aux '
        f'{[x["aux"] for x in moe_one]}; the data=2 gang\'s max |loss diff| '
        f'{d_loss:.4f} (tol {TOL_LOSS}), aux relative {d_aux:.2e} (tol '
        f'{TOL_AUX}) | {card}')
    if len(moe_one) != len(hist) or d_loss > TOL_LOSS or d_aux > TOL_AUX:
        fail('[fsdp] the moe-1b gang\'s loss or aux departs from one '
             'process\'s')
    log(f'[fsdp] phase {time.perf_counter() - t_phase:.1f}s')
    return launches


# ---------------------------------------------------------------------------
# The tp_serve phases: one replica over a gang of ranks
# ---------------------------------------------------------------------------

# tp_serve: by default llama-1b whole (bf16, random weights from seed 0)
# at --mesh tensor=2, two ranks sharing the card over gloo: each holds 8
# of 16 q heads, 4 of 8 kv heads, 3584 of 7168 ffn units and 16384 of
# 32768 vocabulary rows. --tp-model, --tp-ranks and --tp-backend nccl
# run the same phase with a rank a card (LOCAL_RANK r) on a host of that
# many.
TP_MODEL, TP_RANKS, TP_BACKEND = 'llama-1b', 2, 'gloo'
TP_DIR = os.path.join(HERE, '.smoke_tp')
# tp_serve_moe: moe-1b whole at --mesh expert=2,tensor=2, four ranks
# sharing the card: each holds 4 of 8 experts at 2048 of 4096 hidden
# units, 4 of 8 q heads and 2 of 4 kv heads (kernel B at g = 2). And
# tp_serve_mla: deepseek-v2-lite at full width (dim 2048, 16 heads,
# latent rank 512) cut to TP_MLA_DEPTH of 27 layers at --mesh tensor=2:
# each rank 8 heads and the whole latent pool; no kernel runs there.
TP_MOE = ('moe-1b', 'expert=2,tensor=2', None)
TP_MLA_DEPTH = 4
TP_MLA = ('deepseek-v2-lite', 'tensor=2', TP_MLA_DEPTH)
# The traffic: a 700-token prompt (3 chunks of 256) beside a short one,
# a 600-token prompt, then a request resending its first 512 tokens
# (a prefix hit), then one streamed completion. The MoE and MLA gangs
# take a lighter load (TP_LIGHT_NEW tokens each): a 300-token prompt
# beside a short one, then the streamed completion.
TP_NEW = 16
TP_LIGHT_NEW = 8
TP_FREE_STEPS = 16


def mesh_sizes(mesh: str) -> dict:
    """'expert=2,tensor=2' → {'expert': 2, 'tensor': 2}."""
    return {ax: int(n) for ax, n in (part.split('=')
                                     for part in mesh.split(','))}


def step_kw(cfg, fn) -> dict:
    """The attention choice of a paged decode step: none for an MLA
    config (its absorbed latent attention has one formulation)."""
    return {} if is_mla(cfg) else {'attention_fn': fn}


def cut_preset(config, model: str, depth, install: bool = False):
    """``model``'s preset, cut to ``depth`` layers when given; with
    ``install`` the cut preset replaces the preset in this process, so
    that the engine's ``--model`` serves it (a rank's process)."""
    import dataclasses
    cfg = config.get_config(model)
    if depth is None:
        return cfg
    cfg = dataclasses.replace(cfg, n_layers=depth)
    for presets in (config.PRESETS, config.MOE_PRESETS, config.MLA_PRESETS):
        if install and model in presets:
            presets[model] = cfg
    return cfg


def tp_worker(rank: int, port: int, http_port: int, model: str, mesh: str,
              tag: str, depth) -> None:
    """One rank of the gang: ``engine.main`` with the gang flags, the
    launch counters zeroed when its warm-up ends (just before traffic).
    After the leader's 'stop' every rank holds, in lockstep on the
    engine's own sharded params and mesh, model_prompts' prefill + 8
    paged decode steps fed their own greedy tokens (then 8 more with
    every collective timed), and TP_FREE_STEPS free greedy steps; an
    MoE config's rank 0 records the routes of the first 9 calls'
    layers (RouteLog), which the one-process paths then take. Writes
    chiprun_out/<tag>_rank<r>.json; rank 0 also the logits, tokens and
    routes under .smoke_tp/."""
    t_start = time.perf_counter()
    import torch
    import torch.distributed as dist
    from skypilot_tpu_torch import config
    from skypilot_tpu_torch.kernels import build
    from skypilot_tpu_torch.models import moe, paging
    from skypilot_tpu_torch.ops import paged_attention as pa
    from skypilot_tpu_torch.serve import engine as engine_lib
    torch.backends.cuda.matmul.allow_tf32 = False
    cut_preset(config, model, depth, install=True)
    state = {}
    warmup = engine_lib.InferenceEngine.warmup

    def counted_warmup(self, buckets=None):
        warmup(self, buckets)
        torch.cuda.synchronize()
        state['engine'] = self
        state['boot_s'] = time.perf_counter() - t_start
        build.reset_launches()
    engine_lib.InferenceEngine.warmup = counted_warmup
    ranks = math.prod(mesh_sizes(mesh).values())
    engine_lib.main(['--model', model, '--mesh', mesh,
                     '--num-processes', str(ranks), '--process-id',
                     str(rank), '--coordinator', f'127.0.0.1:{port}',
                     '--host', '127.0.0.1', '--port', str(http_port),
                     '--warm-buckets', '16'])
    served = launch_counts(build)
    eng = state['engine']
    cfg = eng.cfg
    dec = decode_module(cfg)
    routed = hasattr(cfg, 'n_experts')
    tok_t, len_t = model_prompts(torch, cfg.vocab_size,
                                 np.random.default_rng(5))
    spent = [0.0]
    collectives = (dist.all_reduce, dist.all_gather)

    def timed(fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            spent[0] += time.perf_counter() - t0
            return out
        return run

    kw = step_kw(cfg, pa.paged_attention_step)
    with eng.on_mesh(), torch.no_grad():
        build.reset_launches()
        routes = RouteLog(moe)
        with routes if routed else contextlib.nullcontext():
            logits, pc = prefilled_pool(torch, dec, paging, eng.params, cfg,
                                        tok_t, len_t, 'auto')
            out, toks, step_ms = [logits], [], []
            for _ in range(8):
                nxt = torch.argmax(out[-1], dim=-1).to(torch.int32)
                toks.append(nxt)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits, pc = dec.paged_decode_step(
                    eng.params, nxt, pc, cfg,
                    max_len=MODEL_SHAPE['max_len'], **kw)
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
                out.append(logits)
        forced = launch_counts(build)
        dist.all_reduce, dist.all_gather = (timed(f) for f in collectives)
        try:
            nxt = toks[-1]
            for _ in range(8):
                logits, pc = dec.paged_decode_step(
                    eng.params, nxt, pc, cfg,
                    max_len=MODEL_SHAPE['max_len'], **kw)
        finally:
            dist.all_reduce, dist.all_gather = collectives
        logits = torch.stack(out).float()
        free = free_greedy(torch, dec, paging, pa, eng.params, cfg, tok_t,
                           len_t)
    result = {
        'rank': rank, 'boot_s': state['boot_s'], 'launches': served,
        'forced_launches': forced,
        'peak_gb': torch.cuda.max_memory_allocated() / 1e9,
        'step_ms': statistics.median(step_ms),
        'collective_ms_per_step': spent[0] * 1e3 / 8,
        'logits_sha256': hashlib.sha256(
            logits.cpu().numpy().tobytes()).hexdigest(),
        'tpot_ms': [t[1] * 1e3 for t in eng.timings if t[2] > 1],
        'requests': len(eng.timings)}
    if rank == 0:
        np.save(os.path.join(TP_DIR, 'logits.npy'), logits.cpu().numpy())
        np.save(os.path.join(TP_DIR, 'toks.npy'),
                torch.stack(toks).cpu().numpy())
        np.save(os.path.join(TP_DIR, 'free.npy'), free)
        if routed:
            np.savez(os.path.join(TP_DIR, 'routes.npz'),
                     *[idx.cpu().numpy() for idx, _ in routes.calls])
    with open(os.path.join(OUT_DIR, f'{tag}_rank{rank}.json'), 'w') as f:
        json.dump(result, f)


def free_greedy(torch, decode, paging, pa, params, cfg, tok_t, len_t):
    """TP_FREE_STEPS greedy paged decode steps from model_prompts'
    prefill through kernels A and B where the config takes them: the
    tokens, [steps + 1, B]. ``decode`` is the config's cache family."""
    logits, pc = prefilled_pool(torch, decode, paging, params, cfg, tok_t,
                                len_t, 'auto')
    toks = [torch.argmax(logits, dim=-1).to(torch.int32)]
    for _ in range(TP_FREE_STEPS):
        logits, pc = decode.paged_decode_step(
            params, toks[-1], pc, cfg, max_len=MODEL_SHAPE['max_len'],
            **step_kw(cfg, pa.paged_attention_step))
        toks.append(torch.argmax(logits, dim=-1).to(torch.int32))
    return torch.stack(toks).cpu().numpy()


def tp_kernels_at_local_shapes(torch, fa, pa, paging, cfg, tp: int,
                               tag: str) -> dict:
    """(b): kernel A at a rank's prompt shapes (B=2 at S 700 and 256,
    causal) and kernel B at its decode and verify widths (S 1 and 4),
    at a rank's heads over a 'tensor' axis of ``tp`` (llama-1b at
    tensor=2: 8 q heads over 4 kv heads at hd 128; moe-1b: 4 over 2),
    against their plain versions at the script's tolerances. Returns
    each kernel's worst error."""
    h, kh, d = cfg.n_heads // tp, cfg.n_kv_heads // tp, cfg.hd
    worst = {'flash_fwd': 0.0, 'paged_decode': 0.0}
    for i, s in enumerate((700, 256)):
        q, k, v = flash_inputs(torch, 2, s, h, kh, d, seed=1300 + i)
        o, lse = fa.flash_attention_lse(q, k, v, causal=True)
        o_ref, lse_ref = fa.flash_attention_ref(*prescaled_fp32(q, k, v),
                                                causal=True,
                                                softmax_scale=1.0)
        torch.cuda.synchronize()
        ok = o_ok(o, o_ref) and max_err(lse, lse_ref) <= TOL_LSE
        log(f'[{tag}] A at a rank\'s shape B=2 S=T={s} H={h} KH={kh} '
            f'D={d}: o err {max_err(o, o_ref):.3e}, lse err '
            f'{max_err(lse, lse_ref):.3e} {"ok" if ok else "MISMATCH"}')
        if not ok:
            fail(f'[{tag}] kernel A disagrees at S={s}, H={h}, KH={kh}')
        worst['flash_fwd'] = max(worst['flash_fwd'], max_err(o, o_ref))
    for s in (1, 4):
        q, kp, vp, table, length, _ = paged_inputs(
            torch, pa, paging, s, seed=1310 + s, h=h, kh=kh, edges=True)
        out = pa.paged_decode_attention(q, kp, vp, table, length)
        ref = pa.paged_decode_attention_ref(*prescaled_fp32(q, kp, vp),
                                            table, length, softmax_scale=1.0)
        torch.cuda.synchronize()
        ok = o_ok(out, ref)
        log(f'[{tag}] B at a rank\'s shape S={s} H={h} KH={kh} hd={d}: '
            f'out err {max_err(out, ref):.3e} {"ok" if ok else "MISMATCH"}')
        if not ok:
            fail(f'[{tag}] kernel B disagrees at S={s}, H={h}, KH={kh}')
        worst['paged_decode'] = max(worst['paged_decode'], max_err(out, ref))
    return worst


def tp_traffic(base: str, vocab: int, tag: str, light: bool) -> int:
    """4 /generate (700 and 20 tokens at once, then 600, then its first
    512 tokens resent with a new tail) and a streamed /v1/completions;
    ``light``: 2 /generate (300 and 20 tokens at once) and the streamed
    completion. Every answer checked. Returns the prefix hits /metrics
    counts."""
    rng = np.random.default_rng(21)
    new = TP_LIGHT_NEW if light else TP_NEW

    def prompt(n):
        return [int(t) for t in rng.integers(1, vocab, n)]
    system = prompt(600)
    docs = [{'tokens': prompt(300 if light else 700), 'max_new_tokens': new},
            {'tokens': prompt(20), 'max_new_tokens': new}]
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        answers = list(pool.map(lambda d: http(base + '/generate', d),
                                docs))
    if not light:
        docs += [{'tokens': system, 'max_new_tokens': new},
                 {'tokens': system[:512] + prompt(40),
                  'max_new_tokens': new}]
        answers += [http(base + '/generate', d) for d in docs[2:]]
    for d, (code, doc) in zip(docs, answers):
        if code != 200 or len(doc.get('tokens', ())) != new:
            fail(f'[{tag}] /generate of {len(d["tokens"])} tokens '
                 f'answered {code}: {str(doc)[:300]}')
    events = sse(base + '/v1/completions', {
        'prompt': 'A gang of ranks serves one replica.', 'max_tokens': new,
        'temperature': 0, 'stream': True})
    if not events or events[-1]['choices'][0].get('finish_reason') is None:
        fail(f'[{tag}] the streamed completion did not finish')
    with urllib.request.urlopen(base + '/metrics', timeout=30) as r:
        text = r.read().decode()
    return int(float(next(line.split()[1] for line in text.splitlines()
                          if line.startswith(
                              'skytpu_engine_prefix_hits_total'))))


def phase_tp_serve(torch, fa, pa, paging, decode, build, config,
                   card: str, model: str = TP_MODEL, ranks: int = TP_RANKS,
                   backend: str = TP_BACKEND, mesh=None, depth=None,
                   tag: str = 'tp_serve') -> dict:
    """One replica over a gang at ``mesh`` (default tensor=``ranks``;
    by default two ranks sharing the card over gloo; with 'nccl' a card
    each), ``model`` cut to ``depth`` layers when given: (a) A and B
    launch on each rank while it serves the traffic (neither on an MLA
    config, whose attention runs no kernel), (b) both match their plain
    versions at a rank's shapes, (c) the gang's teacher-forced logits
    lie within TOL_MODEL of the one-process engine path's error against
    fp32 (an MoE config's one-process paths take the gang's routes:
    RouteLog), (d) every rank exits 0 and writes a fresh result.
    Returns (the kernels' errors at these shapes, the ranks' launches on
    the traffic, summed)."""
    import dataclasses
    import secrets
    import shutil
    from skypilot_tpu_torch.models import moe
    mesh = mesh or f'tensor={ranks}'
    sizes = mesh_sizes(mesh)
    ranks = math.prod(sizes.values())
    tp = sizes.get('tensor', 1)
    light = tag != 'tp_serve'
    files = 'tp' if tag == 'tp_serve' else tag.replace('_serve', '')
    cfg = cut_preset(config, model, depth)
    label = model if depth is None else \
        f'{model} ({depth} of {config.get_config(model).n_layers} layers)'
    kernels = takes_kernels(cfg)
    dec = decode_module(cfg)
    routed = hasattr(cfg, 'n_experts')
    errs = (tp_kernels_at_local_shapes(torch, fa, pa, paging, cfg, tp, tag)
            if kernels else {})
    free_card(torch)
    logs = [os.path.join(OUT_DIR, f'{files}_rank{r}.log')
            for r in range(ranks)]
    paths = [os.path.join(OUT_DIR, f'{files}_rank{r}.json')
             for r in range(ranks)]
    fresh(logs + paths)
    shutil.rmtree(TP_DIR, ignore_errors=True)
    os.makedirs(TP_DIR)
    port, http_port = free_port(), free_port()
    token = secrets.token_hex(16)
    procs = []
    try:
        for r in reversed(range(ranks)):
            env = dict(rank_env(r, port), SKYTPU_MH_TOKEN=token,
                       SKYTPU_NUM_PROCESSES=str(ranks),
                       SKYTPU_TORCH_DIST_BACKEND=backend,
                       LOCAL_RANK=str(r if backend == 'nccl' else 0))
            with open(logs[r], 'w') as f:
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.join(HERE, 'chip_smoke.py'),
                     '--tp-worker', str(r), '--ring-port', str(port),
                     '--tp-http', str(http_port), '--tp-model', model,
                     '--tp-mesh', mesh, '--tp-tag', files] +
                    ([] if depth is None else ['--tp-depth', str(depth)]),
                    cwd=HERE, env=env, stdout=f, stderr=subprocess.STDOUT))
        leader = procs[-1]
        base = f'http://127.0.0.1:{http_port}'
        t0 = time.perf_counter()
        status = None
        while time.perf_counter() - t0 < 300:
            if any(p.poll() is not None for p in procs):
                break
            try:
                status = http(base + '/health', timeout=5)[0]
            except OSError:
                pass
            # 200: warm; 500: the leader's loop died (a rank failed).
            if status in (200, 500):
                break
            time.sleep(1)
        if status != 200:
            fail(f'[{tag}] the gang never answered /health 200 (last '
                 f'{status}): ' + ''.join(open(logs[0]).readlines()[-15:]))
        boot_wall = time.perf_counter() - t0
        t1 = time.perf_counter()
        hits = tp_traffic(base, cfg.vocab_size, tag, light)
        traffic_s = time.perf_counter() - t1
        leader.send_signal(signal.SIGTERM)
        deadline = time.monotonic() + 300
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    res = []
    for r in range(ranks):
        rc = procs[ranks - 1 - r].returncode
        if rc != 0 or not os.path.exists(paths[r]):
            tail = ''.join(open(logs[r]).readlines()[-20:])
            fail(f'[{tag}] rank {r} exited {rc} (result '
                 f'{"written" if os.path.exists(paths[r]) else "missing"}):'
                 f'\n{tail}')
        with open(paths[r]) as f:
            res.append(json.load(f))
    if not light and hits < 1:
        fail(f'[{tag}] the resent prefix made {hits} prefix hits')
    layers, steps = cfg.n_layers, 8
    for x in res:
        lc, fc = x['launches'], x['forced_launches']
        log(f'[{tag}] rank {x["rank"]}: launches on the traffic A '
            f'{lc["flash_fwd"]}, B {lc["paged_decode"]}; on the forced path '
            f'A {fc["flash_fwd"]}, B {fc["paged_decode"]}; boot '
            f'{x["boot_s"] * 1e3:.0f} ms; peak memory {x["peak_gb"]:.2f} GB;'
            f' a forced decode step {x["step_ms"]:.2f} ms, of which the '
            f'collectives {x["collective_ms_per_step"]:.2f} ms | {card}')
        if kernels and (lc['flash_fwd'] <= 0 or lc['paged_decode'] <= 0):
            fail(f'[{tag}] rank {x["rank"]} served without A or B: {lc}')
        if not kernels and any(lc.values()):
            fail(f'[{tag}] rank {x["rank"]} launched a kernel: {lc}')
        want = (want_launches(build, flash_fwd=layers,
                              paged_decode=layers * steps)
                if kernels else want_launches(build))
        if fc != want:
            fail(f'[{tag}] rank {x["rank"]} forced-path launches {fc}')
    if len({x['logits_sha256'] for x in res}) != 1:
        fail(f'[{tag}] the ranks\' gathered logits differ')
    tpot = statistics.median(res[0]['tpot_ms'])
    where = ('one card' if backend == 'gloo' else f'{ranks} cards')
    log(f'[{tag}] {label} at {mesh} on {where} ({backend}): '
        f'{res[0]["requests"]} requests in {traffic_s:.1f} s, TPOT median '
        f'{tpot:.2f} ms over {len(res[0]["tpot_ms"])} requests, the gang '
        f'healthy {boot_wall:.1f} s after its start, prefix hits {hits} | '
        f'{card}')
    gang = torch.from_numpy(np.load(os.path.join(TP_DIR, 'logits.npy')))
    feed = torch.from_numpy(np.load(os.path.join(TP_DIR, 'toks.npy'))).cuda()
    gang_free = np.load(os.path.join(TP_DIR, 'free.npy'))
    force = None
    if routed:
        with np.load(os.path.join(TP_DIR, 'routes.npz')) as z:
            gang_routes = [torch.from_numpy(z[f'arr_{i}']).cuda()
                           for i in range(len(z.files))]

        def force(i, idx):
            return gang_routes[i]
    shutil.rmtree(TP_DIR, ignore_errors=True)
    params = bf16_params(torch, cfg)
    tok_t, len_t = model_prompts(torch, cfg.vocab_size,
                                 np.random.default_rng(5))

    def run(cfg_run, params_run, impl, fn):
        with RouteLog(moe, force) if routed else contextlib.nullcontext():
            logits, pc = prefilled_pool(torch, dec, paging, params_run,
                                        cfg_run, tok_t, len_t, impl)
            out = [logits]
            for nxt in feed:
                logits, pc = dec.paged_decode_step(
                    params_run, nxt, pc, cfg_run,
                    max_len=MODEL_SHAPE['max_len'], **step_kw(cfg_run, fn))
                out.append(logits)
        return torch.stack(out).float().cpu()
    with torch.no_grad():
        one = run(cfg, params, 'auto', pa.paged_attention_step)
        free = free_greedy(torch, dec, paging, pa, params, cfg, tok_t,
                           len_t)
        cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
        params32 = decode.cast_params_for_decode(params, cfg32)
        del params
        ref = run(cfg32, params32, 'xla', pa.paged_attention_step_ref)
        del params32
    worst = 0.0
    for i in range(gang.shape[0]):
        std = float(ref[i].std())
        e_g = float((gang[i] - ref[i]).abs().max()) / std
        e_o = float((one[i] - ref[i]).abs().max()) / std
        worst = max(worst, e_g / e_o)
        log(f'[{tag}] step {i} ({"prefill" if i == 0 else "decode"}): '
            f'max|diff|/std(fp32 logits): gang-fp32 {e_g:.3e}, one '
            f'process-fp32 {e_o:.3e}, gang-one process '
            f'{float((gang[i] - one[i]).abs().max()) / std:.3e}')
    agree = [int(np.argmax(np.append(gang_free[:, r] != free[:, r], True)))
             for r in range(free.shape[1])]
    log(f'[{tag}] free greedy decoding, gang vs one process: tokens '
        f'that agree before the first divergence, per row: {agree} of '
        f'{free.shape[0]}' + (' (routes free on both)' if routed else ''))
    log(f'[{tag}] gang/one-process error ratio against fp32, worst '
        f'{worst:.3f} (tol {TOL_MODEL}) {"ok" if worst <= TOL_MODEL else "MISMATCH"}'
        + (' (the one-process paths on the gang\'s routes)' if routed
           else ''))
    if worst > TOL_MODEL:
        fail(f'[{tag}] the gang\'s logits err {worst:.2f}x the one-process '
             f'path\'s > {TOL_MODEL}x')
    launches = {n: sum(x['launches'][n] for x in res) for n in res[0]['launches']}
    return errs, launches


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
                        'timing,model,serve,batch_infer,disagg,kv_int8,'
                        'layouts,'
                        'tp_serve,tp_serve_moe,tp_serve_mla,'
                        'model_gemma,'
                        'serve_gemma,'
                        'gemma_switches,model_moe,serve_moe,serve_gptoss,'
                        'model_mla,serve_mla,serve_deepseek_v2,'
                        'train_gemma,train,ring,fsdp,train_moe,train_mla,'
                        'hf,sft,'
                        'lora,grpo,harvest',
                        help='comma-separated '
                        'subset (for '
                        'debugging; the full run is the check)')
    # The ring phase's worker processes (one a rank): this script again.
    parser.add_argument('--ring-worker', type=int, default=None,
                        help=argparse.SUPPRESS)
    parser.add_argument('--ring-port', type=int, default=None,
                        help=argparse.SUPPRESS)
    parser.add_argument('--gloo-probe', type=int, default=None,
                        help=argparse.SUPPRESS)
    # The tp_serve phase's ranks (this script again, engine.main inside).
    parser.add_argument('--tp-worker', type=int, default=None,
                        help=argparse.SUPPRESS)
    parser.add_argument('--tp-http', type=int, default=None,
                        help=argparse.SUPPRESS)
    parser.add_argument('--tp-model', default=TP_MODEL,
                        help='the tp_serve phase\'s model')
    parser.add_argument('--tp-ranks', type=int, default=TP_RANKS,
                        help='the tp_serve phase\'s ranks (--mesh tensor=N)')
    parser.add_argument('--tp-backend', choices=('gloo', 'nccl'),
                        default=TP_BACKEND,
                        help="the tp_serve phase's process group: 'gloo' "
                             "(the ranks share card 0) or 'nccl' (a card "
                             'a rank)')
    parser.add_argument('--tp-mesh', default=None,
                        help="the tp_serve phase's --mesh (default "
                             'tensor=<--tp-ranks>), e.g. expert=4')
    parser.add_argument('--tp-depth', type=int, default=None,
                        help="the tp_serve phase's model cut to this many "
                             'layers')
    parser.add_argument('--tp-tag', default='tp', help=argparse.SUPPRESS)
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
    if args.ring_worker is not None:
        ring_worker(args.ring_worker, args.ring_port)
        return
    if args.gloo_probe is not None:
        gloo_p2p_probe(args.gloo_probe, args.ring_port)
        return
    if args.tp_worker is not None:
        tp_worker(args.tp_worker, args.ring_port, args.tp_http,
                  args.tp_model, args.tp_mesh or f'tensor={args.tp_ranks}',
                  args.tp_tag, args.tp_depth)
        return
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
    if phases & {'model', 'serve', 'batch_infer', 'disagg', 'kv_int8',
                 'layouts'}:
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
            free_card(torch)
        lap('model+serve+batch_infer')
        if 'disagg' in phases:
            by_path['disagg'] = phase_disagg(torch, cfg, params, engine_lib,
                                             build)
        lap('disagg')
        if 'kv_int8' in phases:
            by_path['kv_int8'] = phase_kv_int8(torch, cfg, params, engine_lib,
                                               build, decode, paging)
        lap('kv_int8')
        if 'layouts' in phases:
            free_card(torch)
            by_path['layouts'] = phase_layouts(torch, cfg, params,
                                               engine_lib, build, decode)
        del params
        free_card(torch)
    lap('layouts')
    if 'tp_serve' in phases:
        tp_errs, by_path['tp_serve'] = phase_tp_serve(
            torch, fa, pa, paging, decode, build, config, card,
            args.tp_model, args.tp_ranks, args.tp_backend,
            mesh=args.tp_mesh, depth=args.tp_depth)
        for name, e in tp_errs.items():
            errs[name] = max(errs.get(name, 0.0), e)
        free_card(torch)
    lap('tp_serve')
    for tag, (model, mesh, depth) in (('tp_serve_moe', TP_MOE),
                                      ('tp_serve_mla', TP_MLA)):
        if tag in phases:
            tp_errs, by_path[tag] = phase_tp_serve(
                torch, fa, pa, paging, decode, build, config, card, model,
                backend='gloo', mesh=mesh, depth=depth, tag=tag)
            for name, e in tp_errs.items():
                errs[name] = max(errs.get(name, 0.0), e)
            free_card(torch)
        lap(tag)
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
        import dataclasses
        cfg = dataclasses.replace(config.get_config('moe-1b'),
                                  n_layers=MOE_SERVE_DEPTH)
        params = bf16_params(torch, cfg)
        if 'model_moe' in phases:
            phase_model(torch, cfg, params, decode, paging, pa, build,
                        f'moe-1b ({MOE_SERVE_DEPTH} of 12 layers)')
            free_card(torch)
        if 'serve_moe' in phases:
            by_path['serve_moe'] = phase_serve(
                torch, 'moe-1b', cfg, params, engine_lib, build, decode,
                paging, label=f'moe-1b ({MOE_SERVE_DEPTH} of 12 layers)')
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
    if 'ring' in phases:
        ring_errs, by_path['ring'] = phase_ring(torch, fa, build, card)
        errs.update(ring_errs)
        free_card(torch)
    lap('ring')
    if 'fsdp' in phases:
        by_path['fsdp'] = phase_fsdp(torch, build, card)
        free_card(torch)
    lap('fsdp')
    if 'train_moe' in phases:
        by_path['train_moe'] = phase_train_moe(torch, build)
        free_card(torch)
    lap('train_moe')
    if 'train_mla' in phases:
        by_path['train_mla'] = phase_train_mla(torch, build)
        free_card(torch)
    lap('train_mla')
    try:
        if 'hf' in phases:
            by_path.update(phase_hf(torch, build, engine_lib, decode))
            free_card(torch)
        lap('hf')
        if 'sft' in phases:
            by_path.update(phase_sft(torch, build, engine_lib,
                                     llama_hf_dir(torch)))
            free_card(torch)
        lap('sft')
        if 'lora' in phases:
            by_path.update(phase_lora(torch, build, engine_lib, decode,
                                      llama_hf_dir(torch)))
            free_card(torch)
        lap('lora')
        if 'grpo' in phases:
            by_path['grpo'] = phase_grpo(torch, build, llama_hf_dir(torch))
            free_card(torch)
        lap('grpo')
    finally:
        import shutil
        shutil.rmtree(os.path.join(HERE, '.smoke_hf'), ignore_errors=True)
    if 'harvest' in phases:
        by_path['harvest'] = phase_harvest(torch, build, card)
    lap('harvest')
    replaces = {
        'flash_fwd': 'skypilot_tpu/ops/pallas/flash_attention.py:63',
        'flash_dq': 'skypilot_tpu/ops/pallas/flash_attention.py:159',
        'flash_dkv': 'skypilot_tpu/ops/pallas/flash_attention.py:196',
        'flash_dq_f32': 'skypilot_tpu/ops/pallas/flash_attention.py:159',
        'flash_dkv_f32': 'skypilot_tpu/ops/pallas/flash_attention.py:196',
        'paged_decode': 'skypilot_tpu/ops/pallas/paged_attention.py:48'}
    # Launches: each kernel's count on the main paths it belongs to
    # (serving: SERVE_KERNELS, training: TRAIN_KERNELS), summed.
    paths = {'serve': SERVE_KERNELS, 'serve_gemma': SERVE_KERNELS,
             'serve_moe': SERVE_KERNELS, 'serve_gptoss': SERVE_KERNELS,
             'serve_mla': SERVE_KERNELS, 'serve_deepseek_v2': SERVE_KERNELS,
             'batch_infer': ('flash_fwd',), 'disagg': SERVE_KERNELS,
             'kv_int8': ('flash_fwd',), 'layouts': ('flash_fwd',),
             'tp_serve': SERVE_KERNELS, 'tp_serve_moe': SERVE_KERNELS,
             'tp_serve_mla': SERVE_KERNELS,
             'train': TRAIN_KERNELS, 'train_gemma': TRAIN_KERNELS,
             'train_moe': TRAIN_KERNELS, 'train_mla': TRAIN_KERNELS,
             'train_hf': TRAIN_KERNELS, 'serve_hf': SERVE_KERNELS,
             'train_lora': TRAIN_KERNELS, 'serve_lora': SERVE_KERNELS,
             'train_sft': TRAIN_KERNELS, 'serve_sft': SERVE_KERNELS,
             'grpo': TRAIN_KERNELS, 'ring': RING_KERNELS,
             'fsdp': TRAIN_KERNELS,
             'harvest': TRAIN_KERNELS}
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
