// Kernels C and D: flash-attention backward, bf16 q/k/v/o/do in, bf16
// dq (kernel C) and dk, dv (kernel D) out.
//
// Replaces: skypilot_tpu/ops/pallas/flash_attention.py::_dq_kernel and
// ::_dkv_kernel (the two pl.pallas_call in _bwd). Both TPU kernels
// recompute p = exp(s - lse) from the forward's saved log-sum-exp, so no
// S x T matrix reaches device memory; they carry an fp32 accumulator in
// VMEM scratch across a sequential grid axis (kv for dq, q for dkv), and
// the dkv kernel writes per-q-head dk/dv that the wrapper group-sums.
//
// Math (q pre-scaled by the wrapper; delta = rowsum(o * do) - dlse,
// computed beside the kernels in PyTorch):
//   s = q k^T, p = exp(s - lse), dp = do v^T, ds = p * (dp - delta)
//   dq = ds k          (kernel C)
//   dv = p^T do, dk = ds^T q, summed over the H/KH q heads of a kv head
//                      (kernel D)
//
// Bound on an H100 SXM: operations. Per (row, q head) kernel C does 3
// matrix products of 2*S*T*D FLOPs and kernel D 4, halved when causal;
// their bytes (q, k, v, do, lse, delta in, the grads out, each once) are
// far below the ~295 FLOP/byte ridge at training lengths, so the floor
// is FLOPs / 989 TFLOP/s (dense bf16).
//
// Kernel C (Hopper: wgmma, TMA, warp specialisation), kernel A's
// shape: one block per (128-row q tile, q head, batch row), heaviest
// causal tiles first, of three warpgroups. A producer (40 registers,
// setmaxnreg) loads the tile's Q and dO once by TMA, then streams the
// kv head's K and V in 64-key tiles into a three-stage ring, each stage
// one mbarrier for both tiles; the loop over key tiles takes the place
// of the TPU's sequential kv grid axis and stops at the diagonal when
// causal. Two consumers (232 registers) own 64 q rows each. Per key
// tile: s = q k^T and dp = do v^T by SS wgmma m64n64k16 (Q and dO the A
// operands, K and V the B operands, all K-major from shared memory);
// p = exp2(s log2e - lse2) and ds = p (dp - delta), the ragged edge and
// the causal diagonal masked in registers; ds, rounded to bf16, is the
// register A operand of dq += ds k (RS wgmma, K read MN-major: the
// transpose bit). lse (base 2) and delta are per-row constants of a
// consumer: plain loads, once. A consumer only computes the key tiles
// up to its own last row and releases the rest, so consumer 0's
// diagonal comes a tile before consumer 1's. dq (fp32, 64 registers a
// thread at D=128, beside 32 each of s and dp) rounds to bf16 once,
// through shared memory, 16 bytes a lane to device memory: each dq
// element is written once by one block, with no atomics, so a step is
// deterministic. At D=256 (Gemma) dq alone is 128 registers a thread:
// the key tile halves to 32 (s and dp 16 registers each), and dq goes
// from registers straight to device memory, since Q, dO and three K/V
// stages fill 224 KB of shared memory.
//
// Kernel D (Hopper: wgmma, TMA, warp specialisation): one block per
// (128-key tile, kv head, batch row) of three warpgroups. A producer (40
// registers, setmaxnreg) loads K and V once by TMA, then streams, over
// the H/KH q heads of the kv head and the 64-row q tiles from the
// diagonal on, each tile's Q and dO by TMA into a three-stage ring; its
// first warp stores the tile's lse (base 2) and delta rows into the same
// stage with plain loads (a TMA box cannot start at an odd fp32 offset)
// and arrives on the stage's one mbarrier, so no consumer waits on a
// global load. Two consumers (232 registers) own 64 keys each and take a
// q tile in two halves of 32 rows: s^T = k q^T and dp^T = v do^T by
// wgmma m64n32k16 (K and V the A operands, Q and dO the B operands, all
// from shared memory, K-major); p^T and ds^T, masked and rounded to bf16
// in registers, are the register A operands of dv += p^T do and
// dk += ds^T q, whose B operands are the same Q and dO tiles read
// MN-major (the transpose bit); the second half's first products run
// with the first half's second ones. The halves keep the two fp32 64 x D
// accumulators (128 registers a thread at D=128) beside 32 of scores: a
// 64-row tile at once spilled 272-300 bytes at D=128 and ran slower on
// an H100. So
// the group sum over the q heads happens inside the block, in fp32
// registers, with no [B,H,T,D] intermediate, and no block writes
// another's output: no atomics, a step is deterministic. Tiles are
// 128-byte swizzled; 4-D tensor maps over [B, S, H, D] keep a box inside
// one head and batch row and zero-fill rows past S or T. The ragged edge
// and the causal diagonal are masked in registers, so any S and T run.
// Probabilities and ds round to bf16 before their products, as the TPU
// kernels do. At D=256 dk and dv of one consumer's keys would be 256
// registers a thread: flash_dkv256_kernel (below) gives the two
// consumers one 64-key tile and one accumulator each.
#include "common.cuh"

using port::bf16;

namespace {

constexpr int WG_THREADS = 384;      // producer + two consumer warpgroups
constexpr int CONSUMER_WARPS = 8;
constexpr float LOG2E = 1.4426950408889634f;

// ---------------------------------------------------------------- kernel C

constexpr int DQ_BQ = 128;       // q rows a block: two consumers of 64
constexpr int DQ_STAGES = 3;     // K/V ring depth

// Shared memory, every tile 1024-byte aligned: Q and dO (resident), the
// K and V ring, each warp's 16 staging rows of dq, then the barriers. A
// tile of D columns is D/64 swizzled boxes of 64 columns (128 B a row).
// At D=256 the key tile halves to 32 (s and dp 16 registers each beside
// the 128 of dq) and dq goes from registers straight to device memory:
// Q and dO (128 KB) and three K/V stages (96 KB) leave no room for the
// staging rows.
template <int D>
struct DqSmem {
  static constexpr int BK = D == 256 ? 32 : 64;        // keys a tile
  static constexpr int BOXES = D / 64;
  static constexpr int Q_BOX = DQ_BQ * 128;
  static constexpr int KV_BOX = BK * 128;
  static constexpr int Q_TILE = BOXES * Q_BOX;
  static constexpr int KV_TILE = BOXES * KV_BOX;
  static constexpr int OUT_LD = D + 8;                  // staging pitch, bf16
  static constexpr int OUT_BYTES = D == 256 ? 0 : CONSUMER_WARPS * 16 * OUT_LD * 2;
  static constexpr int Q_OFF = 0;
  static constexpr int DO_OFF = Q_TILE;
  static constexpr int K_OFF = 2 * Q_TILE;              // [stage] K tiles
  static constexpr int V_OFF = K_OFF + DQ_STAGES * KV_TILE;
  static constexpr int OUT_OFF = V_OFF + DQ_STAGES * KV_TILE;
  static constexpr int BAR_OFF = OUT_OFF + OUT_BYTES;
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 2 * DQ_STAGES) + 1024;
};

// acc (a 64 x D fp32 tile) += A B: A 64 x 16 bf16 in registers (the
// mma.m16n8k16 A fragment of each warp's 16 rows), B 16 x D bf16 from
// a tile of D/64 swizzled boxes of `box` bytes at `b`, MN-major (a
// 16-row k step is 2048 B down a box). At D=256, one m64n128k16 product
// per 128-column half: half j is acc's elements [64j, 64j + 64) (element
// 4i + e lies in column 8i + 2t + e%2 either way) and boxes 2j, 2j + 1.
template <int D>
__device__ __forceinline__ void rs_mn_tile(float (&acc)[D / 2],
                                           const uint32_t (&a)[4], uint32_t b,
                                           uint32_t box) {
  if constexpr (D == 256) {
    port::wgmma_rs_mn_n128<0>(acc, a, port::sw128_desc(b, box));
    port::wgmma_rs_mn_n128<64>(acc, a, port::sw128_desc(b + 2 * box, box));
  } else {
    port::wgmma_rs_mn(acc, a, port::sw128_desc(b, box));
  }
}

// Accumulator element i of a 64 x N wgmma tile, in the thread of lane l
// of warp w of its warpgroup: row 16w + l/4 + 8 * ((i / 2) % 2), column
// 8 * (i / 4) + 2 * (l % 4) + i % 2.

// One consumer warpgroup's 64 rows of dq.
template <int D>
__device__ __forceinline__ void dq_consume(unsigned char* smem, uint64_t* bar_q,
                                           uint64_t* full, uint64_t* empty,
                                           const float* __restrict__ lse,
                                           const float* __restrict__ delta,
                                           bf16* __restrict__ dq, int q0, int c,
                                           int h, int b, int n_kv, int S, int T,
                                           int H, int causal) {
  using L = DqSmem<D>;
  constexpr int BK = L::BK;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int t = lane % 4;
  const int qw = q0 + 64 * c;                       // the consumer's first row
  const int row0 = qw + warp * 16 + lane / 4;       // rows row0, row0 + 8
  // This lane's rows' lse (base 2) and delta; rows past S read 0: their
  // Q and dO land as zeros, so ds is 0.
  float lse2[2], dlt[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = row0 + 8 * hr;
    const long idx = ((long)b * H + h) * S + row;
    lse2[hr] = row < S ? lse[idx] * LOG2E : 0.f;
    dlt[hr] = row < S ? delta[idx] : 0.f;
  }
  const uint32_t q_addr = port::smem_u32(smem + L::Q_OFF) + 64 * c * 128;
  const uint32_t do_addr = port::smem_u32(smem + L::DO_OFF) + 64 * c * 128;
  const uint32_t k_addr = port::smem_u32(smem + L::K_OFF);
  const uint32_t v_addr = port::smem_u32(smem + L::V_OFF);

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float sc[BK / 2], dp[BK / 2];
  uint32_t da[BK / 16][4];

  const int n_mine = qw >= S ? 0 : causal ? min(n_kv, (qw + 63) / BK + 1) : n_kv;
  port::mbar_wait(bar_q, 0);
  for (int kt = 0; kt < n_kv; ++kt) {
    const int s = kt % DQ_STAGES;
    port::mbar_wait(&full[s], (kt / DQ_STAGES) & 1);
    if (kt < n_mine) {
      const uint32_t k_tile = k_addr + s * L::KV_TILE;
      const uint32_t v_tile = v_addr + s * L::KV_TILE;
      port::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;   // 16 columns a step
        port::wgmma_ss(sc, port::sw128_desc(q_addr + (kk / 4) * L::Q_BOX + off, 16),
                       port::sw128_desc(k_tile + (kk / 4) * L::KV_BOX + off, 16),
                       kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        port::wgmma_ss(dp, port::sw128_desc(do_addr + (kk / 4) * L::Q_BOX + off, 16),
                       port::sw128_desc(v_tile + (kk / 4) * L::KV_BOX + off, 16),
                       kk > 0);
      }
      port::wgmma_commit();
      port::wgmma_wait<0>();
      port::fence_regs(sc);
      port::fence_regs(dp);

      // p = exp(s - lse), 0 where masked; ds = p (dp - delta), in bf16
      // as the A fragments of dq += ds k.
      const int k0 = kt * BK;
      const bool edge = k0 + BK > T || (causal && k0 + BK - 1 > qw);
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int hr = (i / 2) & 1;
        float p = exp2f(sc[i] * LOG2E - lse2[hr]);
        if (edge) {
          const int key = k0 + 8 * (i / 4) + 2 * t + (i & 1);
          if (key >= T || (causal && key > row0 + 8 * hr)) p = 0.f;
        }
        sc[i] = p * (dp[i] - dlt[hr]);
      }
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          da[kc][r] = port::pack_bf16x2(sc[8 * kc + 2 * r], sc[8 * kc + 2 * r + 1]);
      // dq += ds k: K ([key][d], d contiguous) the MN-major B operand; a
      // 16-key step is 16 rows (2048 B) down the tile.
      port::wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc)
        rs_mn_tile<D>(acc, da[kc], k_tile + kc * 16 * 128, L::KV_BOX);
      port::wgmma_commit();
      port::wgmma_wait<0>();
      port::fence_regs(acc);
    }
    __syncwarp();
    if (lane == 0) port::mbar_arrive(&empty[s]);
  }

  const long q_pitch = (long)H * D;
  if constexpr (D == 256) {
    // dq in bf16 straight from registers, this lane's two rows, 4 bytes
    // a store.
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = row0 + 8 * hr;
      if (row < S) {
        bf16* dst = dq + ((long)b * S + row) * q_pitch + (long)h * D + 2 * t;
#pragma unroll
        for (int i = 0; i < D / 8; ++i)
          *reinterpret_cast<uint32_t*>(dst + 8 * i) =
              port::pack_bf16x2(acc[4 * i + 2 * hr], acc[4 * i + 2 * hr + 1]);
      }
    }
  } else {
    // dq in bf16 into this warp's 16 staging rows, then 16 bytes a lane
    // to device memory.
    bf16* stage = reinterpret_cast<bf16*>(smem + L::OUT_OFF) +
                  (c * 4 + warp) * 16 * L::OUT_LD;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        *reinterpret_cast<uint32_t*>(stage + (lane / 4 + 8 * hr) * L::OUT_LD + 8 * i + 2 * t) =
            port::pack_bf16x2(acc[4 * i + 2 * hr], acc[4 * i + 2 * hr + 1]);
    __syncwarp();
    const int first = qw + warp * 16;
    bf16* dst = dq + (long)b * S * q_pitch + (long)h * D;
    for (int ci = lane; ci < 16 * (D / 8); ci += 32) {
      const int r = ci / (D / 8), cc = ci % (D / 8);
      if (first + r < S)
        *reinterpret_cast<uint4*>(dst + (long)(first + r) * q_pitch + cc * 8) =
            *reinterpret_cast<const uint4*>(stage + r * L::OUT_LD + cc * 8);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_dq_kernel(const __grid_constant__ CUtensorMap tm_q,    // [B,S,H,D] pre-scaled
                const __grid_constant__ CUtensorMap tm_k,    // [B,T,KH,D]
                const __grid_constant__ CUtensorMap tm_v,    // [B,T,KH,D]
                const __grid_constant__ CUtensorMap tm_do,   // [B,S,H,D]
                const float* __restrict__ lse,               // [B,H,S]
                const float* __restrict__ delta,             // [B,H,S]
                bf16* __restrict__ dq,                        // [B,S,H,D]
                int S, int T, int H, int KH, int causal) {
  using L = DqSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = port::align1024(smem_raw);
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* full = bar_q + 1;
  uint64_t* empty = full + DQ_STAGES;

  // Causal work grows with the q tile: launch the heaviest tiles first.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * DQ_BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / KH);
  int n_kv = (T + L::BK - 1) / L::BK;
  if (causal) n_kv = min(n_kv, (q0 + DQ_BQ - 1) / L::BK + 1);

  if (threadIdx.x == 0) {
    port::mbar_init(bar_q, 1);
    for (int s = 0; s < DQ_STAGES; ++s) {
      port::mbar_init(&full[s], 1);
      port::mbar_init(&empty[s], CONSUMER_WARPS);
    }
    port::fence_barrier_init();
  }
  __syncthreads();

  // The warpgroup index, broadcast from lane 0 so that the compiler
  // sees it warp-uniform: each role's registers are then its own.
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    port::setmaxnreg_dec<40>();
    // ---- producer warpgroup: one thread issues every load.
    if (threadIdx.x == 0) {
      port::mbar_expect_tx(bar_q, 2 * L::Q_TILE);
      for (int bx = 0; bx < L::BOXES; ++bx) {
        port::tma_load_4d(smem + L::Q_OFF + bx * L::Q_BOX, &tm_q, bar_q, 64 * bx,
                          h, q0, b);
        port::tma_load_4d(smem + L::DO_OFF + bx * L::Q_BOX, &tm_do, bar_q, 64 * bx,
                          h, q0, b);
      }
      for (int kt = 0; kt < n_kv; ++kt) {
        const int s = kt % DQ_STAGES;
        port::mbar_wait(&empty[s], ((kt / DQ_STAGES) & 1) ^ 1);
        port::mbar_expect_tx(&full[s], 2 * L::KV_TILE);
        for (int bx = 0; bx < L::BOXES; ++bx) {
          port::tma_load_4d(smem + L::K_OFF + s * L::KV_TILE + bx * L::KV_BOX, &tm_k,
                            &full[s], 64 * bx, kh, kt * L::BK, b);
          port::tma_load_4d(smem + L::V_OFF + s * L::KV_TILE + bx * L::KV_BOX, &tm_v,
                            &full[s], 64 * bx, kh, kt * L::BK, b);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 q rows each.
    port::setmaxnreg_inc<232>();
    dq_consume<D>(smem, bar_q, full, empty, lse, delta, dq, q0, wg - 1, h, b,
                  n_kv, S, T, H, causal);
  }
}

// ---------------------------------------------------------------- kernel D

constexpr int DK_BK = 128;       // keys a block: two consumers of 64
constexpr int DK_BQ = 64;        // q rows a tile
constexpr int DK_STAGES = 3;     // q-tile ring depth

// Shared memory, every tile 1024-byte aligned: K and V (resident), the
// Q and dO ring, then each stage's lse (base 2) and delta rows and the
// barriers.
// A tile of D columns is D/64 swizzled boxes of 64 columns (128 B a row).
template <int D>
struct DkvSmem {
  static constexpr int BQ = DK_BQ, STAGES = DK_STAGES;
  static constexpr int BOXES = D / 64;
  static constexpr int KV_BOX = DK_BK * 128;
  static constexpr int Q_BOX = DK_BQ * 128;
  static constexpr int KV_TILE = BOXES * KV_BOX;
  static constexpr int Q_TILE = BOXES * Q_BOX;
  static constexpr int ROWS_BYTES = DK_BQ * 4;            // lse or delta
  static constexpr int K_OFF = 0;
  static constexpr int V_OFF = KV_TILE;
  static constexpr int Q_OFF = 2 * KV_TILE;               // [stage] Q tiles
  static constexpr int DO_OFF = Q_OFF + DK_STAGES * Q_TILE;
  static constexpr int LSE_OFF = DO_OFF + DK_STAGES * Q_TILE;
  static constexpr int DELTA_OFF = LSE_OFF + DK_STAGES * ROWS_BYTES;
  static constexpr int BAR_OFF = DELTA_OFF + DK_STAGES * ROWS_BYTES;
  static constexpr int STAGE_TX = 2 * Q_TILE;             // TMA bytes
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 2 * DK_STAGES) + 1024;
};

// Kernel D's producer warp (layout L: DkvSmem<D> or Dkv256Smem): K and
// V of the block's keys once by TMA; then, for each (q head, q tile), a
// ring stage of Q and dO by TMA (rows past S land as zeros) and the
// tile's lse (base 2) and delta rows by plain loads (rows past S read
// 0), all under the stage's one barrier.
template <typename L>
__device__ __forceinline__ void dkv_produce(
    unsigned char* smem, uint64_t* bar_kv, uint64_t* full, uint64_t* empty,
    const CUtensorMap* tm_q, const CUtensorMap* tm_k, const CUtensorMap* tm_v,
    const CUtensorMap* tm_do, const float* __restrict__ lse,
    const float* __restrict__ delta, int lane, int k0, int kh, int b, int G,
    int H, int S, int q_start, int n_qt, int n_it) {
  if (lane == 0) {
    port::mbar_expect_tx(bar_kv, 2 * L::KV_TILE);
    for (int bx = 0; bx < L::BOXES; ++bx) {
      port::tma_load_4d(smem + L::K_OFF + bx * L::KV_BOX, tm_k, bar_kv,
                        64 * bx, kh, k0, b);
      port::tma_load_4d(smem + L::V_OFF + bx * L::KV_BOX, tm_v, bar_kv,
                        64 * bx, kh, k0, b);
    }
  }
  for (int it = 0; it < n_it; ++it) {
    const int s = it % L::STAGES;
    port::mbar_wait(&empty[s], ((it / L::STAGES) & 1) ^ 1);
    const int hq = kh * G + it / n_qt;
    const int q0 = q_start + (it % n_qt) * L::BQ;
    if (lane == 0) {
      port::mbar_expect_tx(&full[s], L::STAGE_TX);
      for (int bx = 0; bx < L::BOXES; ++bx) {
        port::tma_load_4d(smem + L::Q_OFF + s * L::Q_TILE + bx * L::Q_BOX,
                          tm_q, &full[s], 64 * bx, hq, q0, b);
        port::tma_load_4d(smem + L::DO_OFF + s * L::Q_TILE + bx * L::Q_BOX,
                          tm_do, &full[s], 64 * bx, hq, q0, b);
      }
    }
    float* lse_s = reinterpret_cast<float*>(smem + L::LSE_OFF +
                                            s * L::ROWS_BYTES);
    float* dl_s = reinterpret_cast<float*>(smem + L::DELTA_OFF +
                                           s * L::ROWS_BYTES);
    const long base = ((long)b * H + hq) * S;
#pragma unroll
    for (int r = lane; r < L::BQ; r += 32) {
      const bool in = q0 + r < S;
      lse_s[r] = in ? lse[base + q0 + r] * LOG2E : 0.f;
      dl_s[r] = in ? delta[base + q0 + r] : 0.f;
    }
    port::mbar_arrive(&full[s]);
  }
}

template <int D>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_dkv_kernel(const __grid_constant__ CUtensorMap tm_q,    // [B,S,H,D] pre-scaled
                 const __grid_constant__ CUtensorMap tm_k,    // [B,T,KH,D]
                 const __grid_constant__ CUtensorMap tm_v,    // [B,T,KH,D]
                 const __grid_constant__ CUtensorMap tm_do,   // [B,S,H,D]
                 const float* __restrict__ lse,               // [B,H,S]
                 const float* __restrict__ delta,             // [B,H,S]
                 bf16* __restrict__ dk,                        // [B,T,KH,D]
                 bf16* __restrict__ dv,                        // [B,T,KH,D]
                 int S, int T, int H, int KH, int causal) {
  using L = DkvSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = port::align1024(smem_raw);
  uint64_t* bar_kv = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* full = bar_kv + 1;
  uint64_t* empty = full + DK_STAGES;

  // Causal work shrinks as the key tile moves right: the lowest tiles,
  // launched first, are the heaviest.
  const int k0 = blockIdx.x * DK_BK;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KH;
  // q rows below the block's first key see none of its keys when causal.
  const int q_start = causal ? k0 : 0;
  const int n_qt = q_start < S ? (S - q_start + DK_BQ - 1) / DK_BQ : 0;
  const int n_it = G * n_qt;             // (q head, q tile) pairs

  if (threadIdx.x == 0) {
    port::mbar_init(bar_kv, 1);
    for (int s = 0; s < DK_STAGES; ++s) {
      // Lane 0's arrival with the TMA bytes, then one from each lane of
      // the producer warp once its lse and delta values are stored.
      port::mbar_init(&full[s], 1 + 32);
      port::mbar_init(&empty[s], CONSUMER_WARPS);
    }
    port::fence_barrier_init();
  }
  __syncthreads();

  // The warpgroup index, broadcast from lane 0 so that the compiler
  // sees it warp-uniform: each role's registers are then its own.
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    // ---- producer warpgroup: its first warp fills the ring.
    port::setmaxnreg_dec<40>();
    const int lane = threadIdx.x;
    if (lane < 32)
      dkv_produce<L>(smem, bar_kv, full, empty, &tm_q, &tm_k, &tm_v, &tm_do,
                     lse, delta, lane, k0, kh, b, G, H, S, q_start, n_qt,
                     n_it);
  } else {
    // ---- consumer warpgroups: 64 keys each.
    port::setmaxnreg_inc<232>();
    const int c = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int t = lane % 4;
    const int kc0 = k0 + 64 * c;          // the warpgroup's first key
    const int key0 = kc0 + warp * 16 + lane / 4;   // keys key0, key0 + 8

    // Accumulator element i of a 64 x N wgmma tile: key key0 + 8 *
    // ((i / 2) % 2), column 8 * (i / 4) + 2 * t + i % 2 (a q row of s^T
    // and dp^T, a d column of dk and dv).
    float dka[D / 2], dva[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;

    const uint32_t k_addr = port::smem_u32(smem + L::K_OFF) + 64 * c * 128;
    const uint32_t v_addr = port::smem_u32(smem + L::V_OFF) + 64 * c * 128;
    const uint32_t q_addr = port::smem_u32(smem + L::Q_OFF);
    const uint32_t do_addr = port::smem_u32(smem + L::DO_OFF);
    port::mbar_wait(bar_kv, 0);

    for (int it = 0; it < n_it; ++it) {
      const int s = it % DK_STAGES;
      const int q0 = q_start + (it % n_qt) * DK_BQ;
      port::mbar_wait(&full[s], (it / DK_STAGES) & 1);
      // Every key of the warpgroup past T, or (causal) past every row of
      // the tile: p and ds are 0, nothing to add.
      const bool skip = kc0 >= T || (causal && kc0 > q0 + DK_BQ - 1);
      if (!skip) {
        // The tile's 64 q rows in two halves of 32, to keep registers
        // low: s^T = k q^T and dp^T = v do^T (64 keys x 32 rows, K and V
        // the A operands, Q and dO the B operands, all K-major), then p^T
        // and ds^T in bf16 as the register A operands of dv += p^T do
        // and dk += ds^T q (do and q read MN-major). The second half's
        // s^T and dp^T are issued with the first half's dv and dk.
        const uint32_t qs = q_addr + s * L::Q_TILE;
        const uint32_t dos = do_addr + s * L::Q_TILE;
        const float* lse_s = reinterpret_cast<const float*>(
            smem + L::LSE_OFF + s * L::ROWS_BYTES);
        const float* dl_s = reinterpret_cast<const float*>(
            smem + L::DELTA_OFF + s * L::ROWS_BYTES);
        const bool edge = kc0 + 64 > T || q0 + DK_BQ > S ||
                          (causal && kc0 + 63 > q0);
#pragma unroll
        float st[16], dpt[16];
        // s^T and dp^T of one 32-row half, issued, not waited on.
        auto issue_sdp = [&](uint32_t rows) {
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            const uint32_t off = (kk % 4) * 32;   // 16 columns a step
            port::wgmma_ss(st, port::sw128_desc(k_addr + (kk / 4) * L::KV_BOX + off, 16),
                           port::sw128_desc(qs + (kk / 4) * L::Q_BOX + rows + off, 16),
                           kk > 0);
          }
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            const uint32_t off = (kk % 4) * 32;
            port::wgmma_ss(dpt, port::sw128_desc(v_addr + (kk / 4) * L::KV_BOX + off, 16),
                           port::sw128_desc(dos + (kk / 4) * L::Q_BOX + rows + off, 16),
                           kk > 0);
          }
        };
        port::wgmma_fence();
        issue_sdp(0);
        port::wgmma_commit();
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const uint32_t rows = hh * 32 * 128;     // 32 rows down the tile
          port::wgmma_wait<0>();
          port::fence_regs(st);
          port::fence_regs(dpt);
          uint32_t ap[2][4], ads[2][4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int col = 32 * hh + 8 * j + 2 * t;
            const float2 lv = *reinterpret_cast<const float2*>(lse_s + col);
            const float2 dl = *reinterpret_cast<const float2*>(dl_s + col);
            float p[4], ds[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = 4 * j + e;
              p[e] = exp2f(st[i] * LOG2E - ((e & 1) ? lv.y : lv.x));
              if (edge) {
                const int key = key0 + 8 * (e >> 1), row = q0 + col + (e & 1);
                if (key >= T || row >= S || (causal && key > row)) p[e] = 0.f;
              }
              ds[e] = p[e] * (dpt[i] - ((e & 1) ? dl.y : dl.x));
            }
            ap[j / 2][2 * (j & 1)] = port::pack_bf16x2(p[0], p[1]);
            ap[j / 2][2 * (j & 1) + 1] = port::pack_bf16x2(p[2], p[3]);
            ads[j / 2][2 * (j & 1)] = port::pack_bf16x2(ds[0], ds[1]);
            ads[j / 2][2 * (j & 1) + 1] = port::pack_bf16x2(ds[2], ds[3]);
          }
          port::wgmma_fence();
#pragma unroll
          for (int kc = 0; kc < 2; ++kc)
            port::wgmma_rs_mn(dva, ap[kc],
                              port::sw128_desc(dos + rows + kc * 16 * 128, L::Q_BOX));
#pragma unroll
          for (int kc = 0; kc < 2; ++kc)
            port::wgmma_rs_mn(dka, ads[kc],
                              port::sw128_desc(qs + rows + kc * 16 * 128, L::Q_BOX));
          if (hh == 0) issue_sdp(32 * 128);   // the second half, meanwhile
          port::wgmma_commit();
        }
        port::wgmma_wait<0>();
        port::fence_regs(dka);
        port::fence_regs(dva);
      }
      __syncwarp();
      if (lane == 0) port::mbar_arrive(&empty[s]);
    }

    // dk and dv in bf16, this lane's two keys, 4 bytes a store.
    const long kv_pitch = (long)KH * D;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int key = key0 + 8 * hr;
      if (key < T) {
        const long off = ((long)b * T + key) * kv_pitch + (long)kh * D + 2 * t;
#pragma unroll
        for (int i = 0; i < D / 8; ++i) {
          *reinterpret_cast<uint32_t*>(dk + off + 8 * i) =
              port::pack_bf16x2(dka[4 * i + 2 * hr], dka[4 * i + 2 * hr + 1]);
          *reinterpret_cast<uint32_t*>(dv + off + 8 * i) =
              port::pack_bf16x2(dva[4 * i + 2 * hr], dva[4 * i + 2 * hr + 1]);
        }
      }
    }
  }
}

// ------------------------------------------------------- kernel D, D=256

// At D=256 one consumer cannot hold both of its keys' accumulators:
// dk and dv of 64 keys are 2 x 64 x 256 fp32, 256 registers a thread.
// So the two consumers share one 64-key tile and split the work by
// accumulator. The p side computes s^T = k q^T, p^T = exp(s^T - lse)
// and dv += p^T do; the ds side computes dp^T = v do^T, takes p^T (fp32)
// from the p side through shared memory, and computes ds^T = p^T (dp^T
// - delta) and dk += ds^T q. Each does two of a tile's four products
// and holds one 128-register accumulator; no product is computed twice.
// q tiles are 32 rows (a 16-register score tile), streamed with dO,
// lse and delta through a four-stage ring as in the D <= 128 kernel.
// p^T crosses in two slots under named barriers: the p side fills slot
// i % 2 and arrives on its FULL barrier; the ds side waits there, reads,
// and arrives on the slot's FREE barrier, which the p side waits on
// before it fills the slot again two tiles later.
constexpr int DK256_BK = 64;       // keys a block, shared by both consumers
constexpr int DK256_BQ = 32;       // q rows a tile
constexpr int DK256_STAGES = 4;    // q-tile ring depth
constexpr int BAR_P_FULL = 1;      // named barriers 1, 2: slot filled
constexpr int BAR_P_FREE = 3;      // named barriers 3, 4: slot read

struct Dkv256Smem {
  static constexpr int BQ = DK256_BQ, STAGES = DK256_STAGES;
  static constexpr int BOXES = 4;
  static constexpr int KV_BOX = DK256_BK * 128;
  static constexpr int Q_BOX = DK256_BQ * 128;
  static constexpr int KV_TILE = BOXES * KV_BOX;
  static constexpr int Q_TILE = BOXES * Q_BOX;
  static constexpr int ROWS_BYTES = DK256_BQ * 4;         // lse or delta
  static constexpr int P_SLOT = 16 * 128 * 4;             // 64 x 32 fp32
  static constexpr int K_OFF = 0;
  static constexpr int V_OFF = KV_TILE;
  static constexpr int Q_OFF = 2 * KV_TILE;               // [stage] Q tiles
  static constexpr int DO_OFF = Q_OFF + DK256_STAGES * Q_TILE;
  static constexpr int LSE_OFF = DO_OFF + DK256_STAGES * Q_TILE;
  static constexpr int DELTA_OFF = LSE_OFF + DK256_STAGES * ROWS_BYTES;
  static constexpr int P_OFF = DELTA_OFF + DK256_STAGES * ROWS_BYTES;
  static constexpr int BAR_OFF = P_OFF + 2 * P_SLOT;
  static constexpr int STAGE_TX = 2 * Q_TILE;             // TMA bytes
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 2 * DK256_STAGES) + 1024;
};

// One consumer of kernel D at D=256: the p side (P_SIDE: s^T, p^T, dv)
// or the ds side (dp^T, ds^T, dk), each its own code so that neither
// carries the other's registers. Writes its accumulator to `out`.
template <bool P_SIDE>
__device__ __forceinline__ void dkv256_consume(
    unsigned char* smem, uint64_t* bar_kv, uint64_t* full, uint64_t* empty,
    bf16* __restrict__ out, int k0, int kh, int b, int q_start, int n_qt,
    int n_it, int S, int T, int KH, int causal) {
  using L = Dkv256Smem;
  constexpr int D = 256;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int t = lane % 4;
  const int key0 = k0 + warp * 16 + lane / 4;   // keys key0, key0 + 8

  // Accumulator element i of a 64 x N wgmma tile: key key0 + 8 * ((i /
  // 2) % 2), column 8 * (i / 4) + 2 * t + i % 2 (a q row of s^T and
  // dp^T, a d column of dk and dv). Both sides share this layout, so
  // lane tid of one reads lane tid of the other's p^T.
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float sc[16];
  uint32_t frag[2][4];

  // The p side's scores come from K and Q, the ds side's from V and dO;
  // its product then takes dO (dv) or Q (dk) as the B operand.
  const uint32_t a_addr = port::smem_u32(smem + (P_SIDE ? L::K_OFF : L::V_OFF));
  const uint32_t b_addr = port::smem_u32(smem + (P_SIDE ? L::Q_OFF : L::DO_OFF));
  const uint32_t o_addr = port::smem_u32(smem + (P_SIDE ? L::DO_OFF : L::Q_OFF));
  float* slots = reinterpret_cast<float*>(smem + L::P_OFF);
  port::mbar_wait(bar_kv, 0);

  for (int it = 0; it < n_it; ++it) {
    const int s = it % DK256_STAGES;
    const int q0 = q_start + (it % n_qt) * DK256_BQ;
    port::mbar_wait(&full[s], (it / DK256_STAGES) & 1);
    // s^T (p side) or dp^T (ds side): 64 keys x 32 rows, K or V the A
    // operand, Q or dO the B operand, both K-major.
    const uint32_t bs = b_addr + s * L::Q_TILE;
    port::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;   // 16 columns a step
      port::wgmma_ss(sc, port::sw128_desc(a_addr + (kk / 4) * L::KV_BOX + off, 16),
                     port::sw128_desc(bs + (kk / 4) * L::Q_BOX + off, 16),
                     kk > 0);
    }
    port::wgmma_commit();
    port::wgmma_wait<0>();
    port::fence_regs(sc);

    const int slot = it & 1;
    float* p_slot = slots + slot * (L::P_SLOT / 4);
    if constexpr (P_SIDE) {
      // p^T = exp(s^T - lse), 0 past T or S and above the diagonal.
      const float* lse_s = reinterpret_cast<const float*>(
          smem + L::LSE_OFF + s * L::ROWS_BYTES);
      const bool edge = k0 + DK256_BK > T || q0 + DK256_BQ > S ||
                        (causal && k0 + DK256_BK - 1 > q0);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = 8 * j + 2 * t;
        const float2 lv = *reinterpret_cast<const float2*>(lse_s + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          float p = exp2f(sc[i] * LOG2E - ((e & 1) ? lv.y : lv.x));
          if (edge) {
            const int key = key0 + 8 * (e >> 1), row = q0 + col + (e & 1);
            if (key >= T || row >= S || (causal && key > row)) p = 0.f;
          }
          sc[i] = p;
        }
      }
      if (it >= 2) port::named_bar_sync(BAR_P_FREE + slot, 256);
#pragma unroll
      for (int i = 0; i < 16; ++i) p_slot[i * 128 + tid] = sc[i];
      port::named_bar_arrive(BAR_P_FULL + slot, 256);
    } else {
      // ds^T = p^T (dp^T - delta).
      const float* dl_s = reinterpret_cast<const float*>(
          smem + L::DELTA_OFF + s * L::ROWS_BYTES);
      port::named_bar_sync(BAR_P_FULL + slot, 256);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 dl = *reinterpret_cast<const float2*>(dl_s + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          sc[i] = p_slot[i * 128 + tid] * (sc[i] - ((e & 1) ? dl.y : dl.x));
        }
      }
      if (it + 2 < n_it) port::named_bar_arrive(BAR_P_FREE + slot, 256);
    }
    // p^T or ds^T in bf16 as the register A operand (k = the tile's 32 q
    // rows, two steps of 16) of dv += p^T do or dk += ds^T q, with dO or
    // Q read MN-major.
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      frag[j / 2][2 * (j & 1)] = port::pack_bf16x2(sc[4 * j], sc[4 * j + 1]);
      frag[j / 2][2 * (j & 1) + 1] = port::pack_bf16x2(sc[4 * j + 2], sc[4 * j + 3]);
    }
    const uint32_t os = o_addr + s * L::Q_TILE;
    port::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < 2; ++kc)
      rs_mn_tile<D>(acc, frag[kc], os + kc * 16 * 128, L::Q_BOX);
    port::wgmma_commit();
    port::wgmma_wait<0>();
    port::fence_regs(acc);
    __syncwarp();
    if (lane == 0) port::mbar_arrive(&empty[s]);
  }

  // dv (p side) or dk (ds side) in bf16, this lane's two keys, 4 bytes a
  // store.
  const long kv_pitch = (long)KH * D;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int key = key0 + 8 * hr;
    if (key < T) {
      const long off = ((long)b * T + key) * kv_pitch + (long)kh * D + 2 * t;
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
        *reinterpret_cast<uint32_t*>(out + off + 8 * i) =
            port::pack_bf16x2(acc[4 * i + 2 * hr], acc[4 * i + 2 * hr + 1]);
    }
  }
}

__global__ void __launch_bounds__(WG_THREADS, 1)
flash_dkv256_kernel(const __grid_constant__ CUtensorMap tm_q,    // [B,S,H,256] pre-scaled
                    const __grid_constant__ CUtensorMap tm_k,    // [B,T,KH,256]
                    const __grid_constant__ CUtensorMap tm_v,    // [B,T,KH,256]
                    const __grid_constant__ CUtensorMap tm_do,   // [B,S,H,256]
                    const float* __restrict__ lse,               // [B,H,S]
                    const float* __restrict__ delta,             // [B,H,S]
                    bf16* __restrict__ dk,                        // [B,T,KH,256]
                    bf16* __restrict__ dv,                        // [B,T,KH,256]
                    int S, int T, int H, int KH, int causal) {
  using L = Dkv256Smem;
  constexpr int D = 256;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = port::align1024(smem_raw);
  uint64_t* bar_kv = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* full = bar_kv + 1;
  uint64_t* empty = full + DK256_STAGES;

  // Causal work shrinks as the key tile moves right: the lowest tiles,
  // launched first, are the heaviest.
  const int k0 = blockIdx.x * DK256_BK;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KH;
  // q rows below the block's first key see none of its keys when causal.
  const int q_start = causal ? k0 : 0;
  const int n_qt = q_start < S ? (S - q_start + DK256_BQ - 1) / DK256_BQ : 0;
  const int n_it = G * n_qt;             // (q head, q tile) pairs

  if (threadIdx.x == 0) {
    port::mbar_init(bar_kv, 1);
    for (int s = 0; s < DK256_STAGES; ++s) {
      // Lane 0's arrival with the TMA bytes, then one from each lane of
      // the producer warp once its lse and delta values are stored.
      port::mbar_init(&full[s], 1 + 32);
      port::mbar_init(&empty[s], CONSUMER_WARPS);
    }
    port::fence_barrier_init();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    // ---- producer warpgroup: its first warp fills the ring.
    port::setmaxnreg_dec<40>();
    const int lane = threadIdx.x;
    if (lane < 32)
      dkv_produce<L>(smem, bar_kv, full, empty, &tm_q, &tm_k, &tm_v, &tm_do,
                     lse, delta, lane, k0, kh, b, G, H, S, q_start, n_qt,
                     n_it);
    return;
  }

  // ---- consumer warpgroups: wg 1 the p side (dv), wg 2 the ds side (dk).
  port::setmaxnreg_inc<232>();
  if (wg == 1)
    dkv256_consume<true>(smem, bar_kv, full, empty, dv, k0, kh, b, q_start,
                         n_qt, n_it, S, T, KH, causal);
  else
    dkv256_consume<false>(smem, bar_kv, full, empty, dk, k0, kh, b, q_start,
                          n_qt, n_it, S, T, KH, causal);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int B, int S,
              int T, int H, int KH, int causal, cudaStream_t stream) {
  // Tensor maps carry the pointers: encoded anew at every launch.
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  int err = port::map_rows_bf16(&tm_q, q, B, S, H, D, DQ_BQ);
  if (!err) err = port::map_rows_bf16(&tm_do, dout, B, S, H, D, DQ_BQ);
  if (!err) err = port::map_rows_bf16(&tm_k, k, B, T, KH, D, DqSmem<D>::BK);
  if (!err) err = port::map_rows_bf16(&tm_v, v, B, T, KH, D, DqSmem<D>::BK);
  if (err) return err;
  const size_t smem = DqSmem<D>::BYTES;
  cudaError_t e = allow_smem(flash_dq_kernel<D>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((S + DQ_BQ - 1) / DQ_BQ, H, B);
  flash_dq_kernel<D><<<grid, WG_THREADS, smem, stream>>>(
      tm_q, tm_k, tm_v, tm_do, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), S, T, H, KH,
      causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int B,
               int S, int T, int H, int KH, int causal, cudaStream_t stream) {
  // Tensor maps carry the pointers: encoded anew at every launch.
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  int err = port::map_rows_bf16(&tm_q, q, B, S, H, D, DK_BQ);
  if (!err) err = port::map_rows_bf16(&tm_do, dout, B, S, H, D, DK_BQ);
  if (!err) err = port::map_rows_bf16(&tm_k, k, B, T, KH, D, DK_BK);
  if (!err) err = port::map_rows_bf16(&tm_v, v, B, T, KH, D, DK_BK);
  if (err) return err;
  const size_t smem = DkvSmem<D>::BYTES;
  cudaError_t e = allow_smem(flash_dkv_kernel<D>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((T + DK_BK - 1) / DK_BK, KH, B);
  flash_dkv_kernel<D><<<grid, WG_THREADS, smem, stream>>>(
      tm_q, tm_k, tm_v, tm_do, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), S, T, H, KH, causal);
  return (int)cudaGetLastError();
}

int launch_dkv256(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  void* dk, void* dv, int B, int S, int T, int H, int KH,
                  int causal, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  int err = port::map_rows_bf16(&tm_q, q, B, S, H, 256, DK256_BQ);
  if (!err) err = port::map_rows_bf16(&tm_do, dout, B, S, H, 256, DK256_BQ);
  if (!err) err = port::map_rows_bf16(&tm_k, k, B, T, KH, 256, DK256_BK);
  if (!err) err = port::map_rows_bf16(&tm_v, v, B, T, KH, 256, DK256_BK);
  if (err) return err;
  const size_t smem = Dkv256Smem::BYTES;
  cudaError_t e = allow_smem(flash_dkv256_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((T + DK256_BK - 1) / DK256_BK, KH, B);
  flash_dkv256_kernel<<<grid, WG_THREADS, smem, stream>>>(
      tm_q, tm_k, tm_v, tm_do, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), S, T, H, KH, causal);
  return (int)cudaGetLastError();
}

bool bad_shape(int B, int S, int T, int H, int KH) {
  return B <= 0 || S <= 0 || T <= 0 || KH <= 0 || H % KH != 0;
}

}  // namespace

extern "C" int flash_dq_bf16(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dq, int B, int S, int T,
                             int H, int KH, int D, int causal, void* stream) {
  if (bad_shape(B, S, T, H, KH)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return launch_dq<128>(q, k, v, dout, lse, delta, dq, B, S, T, H, KH, causal, st);
  if (D == 256)
    return launch_dq<256>(q, k, v, dout, lse, delta, dq, B, S, T, H, KH, causal, st);
  if (D == 64)
    return launch_dq<64>(q, k, v, dout, lse, delta, dq, B, S, T, H, KH, causal, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_dkv_bf16(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* delta, void* dk, void* dv, int B,
                              int S, int T, int H, int KH, int D, int causal,
                              void* stream) {
  if (bad_shape(B, S, T, H, KH)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, B, S, T, H, KH,
                           causal, st);
  if (D == 256)
    return launch_dkv256(q, k, v, dout, lse, delta, dk, dv, B, S, T, H, KH,
                         causal, st);
  if (D == 64)
    return launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, B, S, T, H, KH,
                          causal, st);
  return (int)cudaErrorInvalidValue;
}
