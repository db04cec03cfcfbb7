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
// Design. One block (4 warps) per (64-row q tile, head, batch row), the
// heaviest causal tiles launched first; a loop over 64-key tiles inside
// the block takes the place of the TPU's sequential kv grid axis and
// stops at the diagonal tile when causal. Only Q, K and V pass through
// shared memory: Q once, K and V double-buffered with cp.async, so the
// next tile loads while this one is computed. Everything else stays in
// registers, where the FLOPs are: each warp owns 16 q rows and runs both
// products on the tensor cores with mma.sync m16n8k16 (bf16 in, fp32
// accumulate), its fragments loaded with ldmatrix (transposed for V).
// The S = Q K^T accumulator is masked, exponentiated (fp32 online
// softmax, base 2) and rounded to bf16 in place, and its C fragments
// are exactly the A fragments of O += P V, so P never leaves registers;
// the running O (16 x D per warp) is rescaled in registers. Probabilities
// round to bf16 before P V, as the TPU kernel does. The kernel masks the
// ragged edge (rows past S, keys past T) itself, so any prompt length
// runs on it; GQA maps q head h to kv head h / (H / KH). What this
// leaves for later: wgmma, TMA loads and a producer/consumer warp split.
#include "common.cuh"

using port::bf16;

namespace {

constexpr int BQ = 64;           // q rows per block
constexpr int BK = 64;           // keys per tile
constexpr int NWARPS = 4;        // each warp owns 16 q rows
constexpr int NTHREADS = NWARPS * 32;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int D>
struct Layout {
  static constexpr int LD = D + 8;      // bf16 row pitch: 16-byte rows,
                                        // conflict-free ldmatrix
  static constexpr int TILE = BK * LD;  // elements of one K or V tile
  static constexpr size_t BYTES = sizeof(bf16) * (BQ * LD + 4 * TILE);
};

// Stage `rows` rows of D bf16 (global row pitch `pitch` elements) into
// shared memory (row pitch LD) with cp.async; rows at or past `valid`
// are zero-filled. The caller commits the group.
template <int D>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src,
                                           long pitch, int rows, int valid) {
  constexpr int CHUNKS = D / 8;          // 16-byte chunks per row
  constexpr int LD = Layout<D>::LD;
  for (int c = threadIdx.x; c < rows * CHUNKS; c += NTHREADS) {
    const int r = c / CHUNKS, cc = c % CHUNKS;
    const bool ok = r < valid;
    port::cp_async16_zfill(dst + r * LD + cc * 8,
                           src + (ok ? r * pitch + cc * 8 : 0), ok ? 16 : 0);
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS, 2)
flash_fwd_kernel(const bf16* __restrict__ q,    // [B,S,H,D] pre-scaled
                 const bf16* __restrict__ k,    // [B,T,KH,D]
                 const bf16* __restrict__ v,    // [B,T,KH,D]
                 bf16* __restrict__ o,          // [B,S,H,D]
                 float* __restrict__ lse,       // [B,H,S]
                 int S, int T, int H, int KH, int causal) {
  constexpr int LD = Layout<D>::LD, TILE = Layout<D>::TILE;
  constexpr int NT = BK / 8;             // 8-key score tiles per warp
  constexpr int DT = D / 8;              // 8-column output tiles per warp
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + BQ * LD;               // two K tiles, then two V tiles
  bf16* sV = sK + 2 * TILE;

  // Causal work grows with the q tile: launch the heaviest tiles first.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / KH);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // mma fragment row / column pair

  const long q_pitch = (long)H * D;
  const long kv_pitch = (long)KH * D;
  const bf16* kb = k + (long)b * T * kv_pitch + (long)kh * D;
  const bf16* vb = v + (long)b * T * kv_pitch + (long)kh * D;

  int n_kv = (T + BK - 1) / BK;
  if (causal) n_kv = min(n_kv, (q0 + BQ - 1) / BK + 1);

  stage_rows<D>(sQ, q + ((long)b * S + q0) * q_pitch + (long)h * D, q_pitch,
                BQ, S - q0);
  stage_rows<D>(sK, kb, kv_pitch, BK, T);
  stage_rows<D>(sV, vb, kv_pitch, BK, T);
  port::cp_async_commit();

  // This lane's rows: r0 = warp*16 + g and r0 + 8 of the block's tile.
  const int row0 = q0 + warp * 16 + g;
  float m[2] = {-INFINITY, -INFINITY};   // running max (base-2 units)
  float l[2] = {0.f, 0.f};               // this lane's share of the sum
  float acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  // ldmatrix addresses: lane l names row l % 8 of matrix l / 8.
  const int lm = lane / 8, lr = lane % 8;
  const bf16* q_frag = sQ + (warp * 16 + (lm % 2) * 8 + lr) * LD + (lm / 2) * 8;
  const int k_row = (lm / 2) * 8 + lr, k_col = (lm % 2) * 8;
  const int v_row = (lm % 2) * 8 + lr, v_col = (lm / 2) * 8;

  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * BK;
    const int buf = kt & 1;
    port::cp_async_wait<0>();   // tile kt (and Q) landed
    __syncthreads();            // ... for every thread; tile kt-1 is free
    if (kt + 1 < n_kv) {        // the next tile loads while this one runs
      stage_rows<D>(sK + (buf ^ 1) * TILE, kb + (long)(k0 + BK) * kv_pitch,
                    kv_pitch, BK, T - k0 - BK);
      stage_rows<D>(sV + (buf ^ 1) * TILE, vb + (long)(k0 + BK) * kv_pitch,
                    kv_pitch, BK, T - k0 - BK);
      port::cp_async_commit();
    }
    const bf16* tK = sK + buf * TILE;
    const bf16* tV = sV + buf * TILE;

    // S = Q K^T: 16 rows x 64 keys per warp, fp32.
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      port::ldmatrix_x4(a, q_frag + kk * 16);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bk[4];
        port::ldmatrix_x4(bk, tK + (np * 16 + k_row) * LD + kk * 16 + k_col);
        port::mma_bf16_16816(s[2 * np], a, bk[0], bk[1]);
        port::mma_bf16_16816(s[2 * np + 1], a, bk[2], bk[3]);
      }
    }

    // Mask (ragged edge, causal diagonal) with the finite NEG_INF, then
    // move to base-2 units. Fragment element e of tile j: row row0 +
    // 8*(e/2), key k0 + 8*j + 2*t + e%2.
    const bool edge = k0 + BK > T || (causal && k0 + BK - 1 > q0);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e];
        if (edge) {
          const int key = k0 + 8 * j + 2 * t + (e & 1);
          const int row = row0 + 8 * (e >> 1);
          if (key >= T || (causal && key > row)) x = port::NEG_INF;
        }
        s[j][e] = x * LOG2E;
      }
    }

    // Online softmax: each row's max over the quad (4 lanes share a row).
    float alpha[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = m[hr];
#pragma unroll
      for (int j = 0; j < NT; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * hr], s[j][2 * hr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      alpha[hr] = exp2f(m[hr] - mx);
      m[hr] = mx;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        s[j][2 * hr] = exp2f(s[j][2 * hr] - mx);
        s[j][2 * hr + 1] = exp2f(s[j][2 * hr + 1] - mx);
        sum += s[j][2 * hr] + s[j][2 * hr + 1];
      }
      l[hr] = l[hr] * alpha[hr] + sum;
    }
#pragma unroll
    for (int i = 0; i < DT; ++i) {
      acc[i][0] *= alpha[0];
      acc[i][1] *= alpha[0];
      acc[i][2] *= alpha[1];
      acc[i][3] *= alpha[1];
    }

    // O += P V. Score tiles 2c and 2c+1 (keys 16c..16c+15) are, rounded
    // to bf16, the A fragment of the c-th 16-key step.
#pragma unroll
    for (int c = 0; c < BK / 16; ++c) {
      uint32_t a[4];
      a[0] = port::pack_bf16x2(s[2 * c][0], s[2 * c][1]);
      a[1] = port::pack_bf16x2(s[2 * c][2], s[2 * c][3]);
      a[2] = port::pack_bf16x2(s[2 * c + 1][0], s[2 * c + 1][1]);
      a[3] = port::pack_bf16x2(s[2 * c + 1][2], s[2 * c + 1][3]);
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t bv[4];
        port::ldmatrix_x4_trans(bv, tV + (c * 16 + v_row) * LD + dp * 16 + v_col);
        port::mma_bf16_16816(acc[2 * dp], a, bv[0], bv[1]);
        port::mma_bf16_16816(acc[2 * dp + 1], a, bv[2], bv[3]);
      }
    }
  }

  // Finalize: o = acc / l (l == 0 guard), lse = m + log(l). The warp
  // stages its 16 rows of o in its own rows of sQ (no other warp reads
  // them) for 16-byte stores.
  float inv[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
    inv[hr] = (l[hr] == 0.f) ? 1.f : 1.f / l[hr];
  }
  bf16* sO = sQ + warp * 16 * LD;
#pragma unroll
  for (int i = 0; i < DT; ++i) {
    *reinterpret_cast<uint32_t*>(sO + g * LD + 8 * i + 2 * t) =
        port::pack_bf16x2(acc[i][0] * inv[0], acc[i][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(sO + (g + 8) * LD + 8 * i + 2 * t) =
        port::pack_bf16x2(acc[i][2] * inv[1], acc[i][3] * inv[1]);
  }
  __syncwarp();
  constexpr int CHUNKS = D / 8;
  for (int c = lane; c < 16 * CHUNKS; c += 32) {
    const int r = c / CHUNKS, cc = c % CHUNKS;
    const int q_pos = q0 + warp * 16 + r;
    if (q_pos < S)
      *reinterpret_cast<uint4*>(o + ((long)b * S + q_pos) * q_pitch +
                                (long)h * D + cc * 8) =
          *reinterpret_cast<const uint4*>(sO + r * LD + cc * 8);
  }
  if (t == 0) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int q_pos = row0 + 8 * hr;
      if (q_pos < S)
        lse[((long)b * H + h) * S + q_pos] =
            m[hr] * LN2 + logf(fmaxf(l[hr], 1e-30f));
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int S, int T, int H, int KH, int causal,
           cudaStream_t stream) {
  const size_t smem = Layout<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<D><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), S, T, H, KH, causal);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              void* o, void* lse, int B, int S, int T, int H,
                              int KH, int D, int causal, void* stream) {
  if (B <= 0 || S <= 0 || T <= 0 || KH <= 0 || H % KH != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128) return launch<128>(q, k, v, o, lse, B, S, T, H, KH, causal, st);
  if (D == 64) return launch<64>(q, k, v, o, lse, B, S, T, H, KH, causal, st);
  return (int)cudaErrorInvalidValue;
}
