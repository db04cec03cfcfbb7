// Kernel A: flash-attention forward, bf16 in, bf16 o + fp32 lse out.
//
// Replaces: skypilot_tpu/ops/pallas/flash_attention.py::_fwd_kernel
// (pl.pallas_call in _fwd), the Pallas TPU kernel that runs the
// blockwise online-softmax forward over a (B, H, nq, nk) grid with the
// kv axis sequential and VMEM scratch carrying (m, l, acc) across it.
//
// Bound on an H100 SXM: operations. Causal attention does
// 4*B*H*S*T*D/2 FLOPs (two matrix products, half the score matrix) on
// 2*(B*S*H + 2*B*T*KH)*D bytes of bf16 in and out; at prompt lengths of
// a few hundred tokens and up it is far above the card's ~295 FLOP/byte
// ridge, so the floor is FLOPs / 989 TFLOP/s (dense bf16).
//
// Design (Hopper: wgmma, TMA, warp specialisation). One block per
// (128-row q tile, head, batch row), the heaviest causal tiles launched
// first, of three warpgroups:
//  - a producer, down to 40 registers with setmaxnreg, one thread of
//    which issues TMA loads: the Q tile once, then K and V tiles of BK
//    keys (128; 64 at D=256) into a two-stage ring in shared memory,
//    each stage guarded by
//    full (K, V) and empty mbarriers. The loop over key tiles takes the
//    place of the TPU's sequential kv grid axis and stops at the
//    diagonal tile when causal. Tiles are 128-byte swizzled (a row of
//    D is D/64 64-column boxes) and the tensor maps are 4-D over
//    [B, S, H, D], so a box never crosses into another head or batch
//    row and rows past S or T land as zeros;
//  - two consumers of 64 q rows each, up to 232 registers. Each runs
//    S = Q K^T with wgmma m64nBKk16 (both operands from shared memory,
//    K-major; bf16 in, fp32 accumulate), masks the ragged edge and the
//    causal diagonal in registers with the finite NEG_INF (edge tiles
//    only), takes the base-2 online softmax, rescales O, rounds P to
//    bf16 in registers and feeds it as the register A operand of
//    O += P V (V from shared memory, MN-major: the transpose bit), then
//    releases the stage. The accumulator layout of S is exactly the A
//    fragment layout of the second product, so P never leaves registers.
//    When causal, a consumer only releases the key tiles past its last
//    row.
// wgmma reads each K or V tile once per 64-row warpgroup (mma.sync read
// it once per 16-row warp). Probabilities round to bf16 before P V, as
// the TPU kernel does. GQA maps q head h to kv head h / (H / KH).
// Each consumer waits on its two products in turn; the other consumer's
// products fill the tensor cores during its softmax. Overlapping one
// tile's softmax with the previous tile's P V inside a warpgroup (FA3's
// intra-warpgroup overlap) needs a second score tile in registers: at
// D=128 ptxas spilled it (216 B, even at 232 registers) and it ran ~40%
// slower on an H100, so it is left for later with the inter-warpgroup
// ping-pong.
// D=256 (Gemma): a consumer's fp32 O is 128 registers a thread, so the
// key tile halves to 64 (a 32-register score tile, P in 16) to keep one
// score tile in flight under the 232; O += P V runs as two m64n128k16
// products, one per 128-column half of V. Shared memory: Q 64 KB and
// two stages of K and V at 32 KB each, 192 KB; three stages do not fit.
#include "common.cuh"

using port::bf16;

namespace {

constexpr int BQ = 128;          // q rows a block: two consumers of 64
constexpr int STAGES = 2;        // K/V ring depth
constexpr int NTHREADS = 384;    // producer + two consumer warpgroups
constexpr int NCONSUMER_WARPS = 8;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Shared memory, every tile 1024-byte aligned: Q (BQ rows), then the K
// and the V ring. A tile of D columns is D/64 swizzled boxes of 64
// columns (128 B a row), one after the other.
template <int D>
struct Smem {
  static constexpr int BK = D == 256 ? 64 : 128;   // keys a tile
  static constexpr int BOXES = D / 64;
  static constexpr int Q_BOX = BQ * 128;            // bytes of one Q box
  static constexpr int KV_BOX = BK * 128;           // one K or V box
  static constexpr int KV_TILE = BOXES * KV_BOX;
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + BOXES * Q_BOX;
  static constexpr int V_OFF = K_OFF + STAGES * KV_TILE;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_TILE;
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 3 * STAGES) + 1024;
};

// Accumulator element i of a 64 x N wgmma tile, in the thread of lane l
// of warp w of its warpgroup: row 16w + l/4 + 8 * ((i / 2) % 2), column
// 8 * (i / 4) + 2 * (l % 4) + i % 2.

// S = Q K^T of one key tile (64 rows x BK keys), issued, not waited on.
template <int D, int BK = Smem<D>::BK>
__device__ __forceinline__ void issue_s(float (&sc)[BK / 2], uint32_t q_addr,
                                        uint32_t k_tile) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;   // 16 columns a step
    port::wgmma_ss(sc, port::sw128_desc(q_addr + (kk / 4) * (BQ * 128) + off, 16),
                   port::sw128_desc(k_tile + (kk / 4) * (BK * 128) + off, 16),
                   kk > 0);
  }
  port::wgmma_commit();
}

// O += P V of one key tile: P in registers, V ([key][d], d contiguous)
// the MN-major B operand; a 16-key step is 16 rows (2048 B) down the
// tile. At D=256, one m64n128k16 product per 128-column half of O: half
// j is O's elements [64j, 64j + 64) (element 4i + e lies in column
// 8i + 2t + e%2 either way) and V's boxes 2j and 2j + 1. Issued, not
// waited on.
template <int D, int BK = Smem<D>::BK>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2],
                                         const uint32_t (&pa)[BK / 16][4],
                                         uint32_t v_tile) {
#pragma unroll
  for (int kc = 0; kc < BK / 16; ++kc) {
    const uint32_t v = v_tile + kc * 16 * 128;
    if constexpr (D == 256) {
      port::wgmma_rs_mn_n128<0>(acc, pa[kc], port::sw128_desc(v, BK * 128));
      port::wgmma_rs_mn_n128<64>(acc, pa[kc],
                                 port::sw128_desc(v + 2 * BK * 128, BK * 128));
    } else {
      port::wgmma_rs_mn(acc, pa[kc], port::sw128_desc(v, BK * 128));
    }
  }
  port::wgmma_commit();
}

// The online softmax of one tile of scores, in place: mask (ragged edge,
// causal diagonal) with the finite NEG_INF, move to base-2 units, update
// the running max m and sum l, and leave exp2(s - m) in sc and the
// factor that rescales O in alpha.
template <int BK>
__device__ __forceinline__ void softmax_tile(float (&sc)[BK / 2], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             int k0, int qw, int row0, int t,
                                             int T, int causal) {
  constexpr int NT = BK / 8;              // 8-key column chunks
  const bool edge = k0 + BK > T || (causal && k0 + BK - 1 > qw);
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    float x = sc[i];
    if (edge) {
      const int key = k0 + 8 * (i / 4) + 2 * t + (i & 1);
      const int row = row0 + 8 * ((i / 2) & 1);
      if (key >= T || (causal && key > row)) x = port::NEG_INF;
    }
    sc[i] = x * LOG2E;
  }
  // Each row's max over the quad (4 lanes share a row).
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float mx = m[hr];
#pragma unroll
    for (int j = 0; j < NT; ++j)
      mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * hr], sc[4 * j + 2 * hr + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    alpha[hr] = exp2f(m[hr] - mx);
    m[hr] = mx;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      sc[4 * j + 2 * hr] = exp2f(sc[4 * j + 2 * hr] - mx);
      sc[4 * j + 2 * hr + 1] = exp2f(sc[4 * j + 2 * hr + 1] - mx);
      sum += sc[4 * j + 2 * hr] + sc[4 * j + 2 * hr + 1];
    }
    l[hr] = l[hr] * alpha[hr] + sum;
  }
}

// P in bf16: column chunks 2c and 2c+1 (keys 16c..16c+15) are the
// register A fragment of the c-th 16-key step of P V.
template <int BK>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[BK / 16][4],
                                       const float (&sc)[BK / 2]) {
#pragma unroll
  for (int kc = 0; kc < BK / 16; ++kc)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      pa[kc][r] = port::pack_bf16x2(sc[8 * kc + 2 * r], sc[8 * kc + 2 * r + 1]);
}

// One consumer warpgroup's 64 rows: for each key tile, S = Q K^T, the
// online softmax, O += P V, then the stage goes back to the producer.
// Rows all past S, or (causal) tiles past the warpgroup's last row, are
// only released.
template <int D>
__device__ __forceinline__ void consume(unsigned char* smem, uint64_t* bar_q,
                                        uint64_t* full_k, uint64_t* full_v,
                                        uint64_t* empty,
                                        bf16* __restrict__ o,
                                        float* __restrict__ lse, int q0, int qw,
                                        int h, int b, int n_kv, int S, int T,
                                        int H, int causal) {
  using L = Smem<D>;
  constexpr int BK = L::BK;
  const int c = (qw - q0) / 64;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int t = lane % 4;
  const int row0 = qw + warp * 16 + lane / 4;   // rows row0, row0 + 8
  const uint32_t q_addr = port::smem_u32(smem + L::Q_OFF) + 64 * c * 128;
  const uint32_t k_addr = port::smem_u32(smem + L::K_OFF);
  const uint32_t v_addr = port::smem_u32(smem + L::V_OFF);

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max (base-2 units)
  float l[2] = {0.f, 0.f};              // this lane's share of the sum
  float alpha[2];
  float sc[BK / 2];
  uint32_t pa[BK / 16][4];

  const int n_mine = qw >= S ? 0 : causal ? min(n_kv, (qw + 63) / BK + 1) : n_kv;
  port::mbar_wait(bar_q, 0);
  for (int kt = 0; kt < n_kv; ++kt) {
    const int s = kt % STAGES;
    const uint32_t ph = (kt / STAGES) & 1;
    port::mbar_wait(&full_k[s], ph);
    if (kt < n_mine) {
      port::wgmma_fence();
      issue_s<D>(sc, q_addr, k_addr + s * L::KV_TILE);
      port::wgmma_wait<0>();
      port::fence_regs(sc);
      softmax_tile<BK>(sc, m, l, alpha, kt * BK, qw, row0, t, T, causal);
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        acc[4 * i] *= alpha[0];
        acc[4 * i + 1] *= alpha[0];
        acc[4 * i + 2] *= alpha[1];
        acc[4 * i + 3] *= alpha[1];
      }
      pack_p<BK>(pa, sc);
      port::mbar_wait(&full_v[s], ph);
      port::wgmma_fence();
      issue_pv<D>(acc, pa, v_addr + s * L::KV_TILE);
      port::wgmma_wait<0>();
      port::fence_regs(acc);
    } else {
      port::mbar_wait(&full_v[s], ph);
    }
    __syncwarp();
    if (lane == 0) port::mbar_arrive(&empty[s]);
  }

  // Finalize: o = acc / l (l == 0 guard), lse = m + log(l).
  float inv[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
    inv[hr] = (l[hr] == 0.f) ? 1.f : 1.f / l[hr];
  }
  const long q_pitch = (long)H * D;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = row0 + 8 * hr;
    if (row < S) {
      bf16* out = o + ((long)b * S + row) * q_pitch + (long)h * D + 2 * t;
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
        *reinterpret_cast<uint32_t*>(out + 8 * i) = port::pack_bf16x2(
            acc[4 * i + 2 * hr] * inv[hr], acc[4 * i + 2 * hr + 1] * inv[hr]);
      if (t == 0)
        lse[((long)b * H + h) * S + row] = m[hr] * LN2 + logf(fmaxf(l[hr], 1e-30f));
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,   // [B,S,H,D] pre-scaled
                 const __grid_constant__ CUtensorMap tm_k,   // [B,T,KH,D]
                 const __grid_constant__ CUtensorMap tm_v,   // [B,T,KH,D]
                 bf16* __restrict__ o,                        // [B,S,H,D]
                 float* __restrict__ lse,                     // [B,H,S]
                 int S, int T, int H, int KH, int causal) {
  using L = Smem<D>;
  constexpr int BK = L::BK;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = port::align1024(smem_raw);
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* full_k = bar_q + 1;
  uint64_t* full_v = full_k + STAGES;
  uint64_t* empty = full_v + STAGES;

  // Causal work grows with the q tile: launch the heaviest tiles first.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / KH);
  int n_kv = (T + BK - 1) / BK;
  if (causal) n_kv = min(n_kv, (q0 + BQ - 1) / BK + 1);

  if (threadIdx.x == 0) {
    port::mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      port::mbar_init(&full_k[s], 1);
      port::mbar_init(&full_v[s], 1);
      port::mbar_init(&empty[s], NCONSUMER_WARPS);
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
      port::mbar_expect_tx(bar_q, L::BOXES * L::Q_BOX);
      for (int bx = 0; bx < L::BOXES; ++bx)
        port::tma_load_4d(smem + L::Q_OFF + bx * L::Q_BOX, &tm_q, bar_q,
                          64 * bx, h, q0, b);
      for (int kt = 0; kt < n_kv; ++kt) {
        const int s = kt % STAGES;
        port::mbar_wait(&empty[s], ((kt / STAGES) & 1) ^ 1);
        unsigned char* k_tile = smem + L::K_OFF + s * L::KV_TILE;
        unsigned char* v_tile = smem + L::V_OFF + s * L::KV_TILE;
        port::mbar_expect_tx(&full_k[s], L::KV_TILE);
        for (int bx = 0; bx < L::BOXES; ++bx)
          port::tma_load_4d(k_tile + bx * L::KV_BOX, &tm_k, &full_k[s],
                            64 * bx, kh, kt * BK, b);
        port::mbar_expect_tx(&full_v[s], L::KV_TILE);
        for (int bx = 0; bx < L::BOXES; ++bx)
          port::tma_load_4d(v_tile + bx * L::KV_BOX, &tm_v, &full_v[s],
                            64 * bx, kh, kt * BK, b);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 q rows each.
    port::setmaxnreg_inc<232>();
    consume<D>(smem, bar_q, full_k, full_v, empty, o, lse, q0,
               q0 + 64 * (wg - 1), h, b, n_kv, S, T, H, causal);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int S, int T, int H, int KH, int causal,
           cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v;
  int err = port::map_rows_bf16(&tm_q, q, B, S, H, D, BQ);
  if (!err) err = port::map_rows_bf16(&tm_k, k, B, T, KH, D, Smem<D>::BK);
  if (!err) err = port::map_rows_bf16(&tm_v, v, B, T, KH, D, Smem<D>::BK);
  if (err) return err;
  const int smem = Smem<D>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<D><<<grid, NTHREADS, smem, stream>>>(
      tm_q, tm_k, tm_v, static_cast<bf16*>(o), static_cast<float*>(lse), S, T,
      H, KH, causal);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              void* o, void* lse, int B, int S, int T, int H,
                              int KH, int D, int causal, void* stream) {
  if (B <= 0 || S <= 0 || T <= 0 || KH <= 0 || H % KH != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 256) return launch<256>(q, k, v, o, lse, B, S, T, H, KH, causal, st);
  if (D == 128) return launch<128>(q, k, v, o, lse, B, S, T, H, KH, causal, st);
  if (D == 64) return launch<64>(q, k, v, o, lse, B, S, T, H, KH, causal, st);
  return (int)cudaErrorInvalidValue;
}
