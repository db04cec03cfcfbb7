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
// Design, shared with kernel A (flash_fwd.cu): 4 warps a block, each
// warp owning 16 rows of the block's own tile; every product on the
// tensor cores with mma.sync m16n8k16 (bf16 in, fp32 accumulate) and
// ldmatrix fragment loads; a C fragment of s or ds, rounded to bf16, is
// directly the A fragment of the next product, so p and ds never leave
// registers; the streamed operand is double-buffered through shared
// memory with zero-filling cp.async; the ragged edge (rows past S, keys
// past T) and the causal diagonal are masked in registers, so any S and
// T run. Probabilities and ds round to bf16 before their products, as
// the TPU kernels do.
//
// Kernel C: one block per (64-row q tile, q head, batch row), heaviest
// causal tiles first. Q and dO stay in shared memory; a loop over 64-key
// tiles up to the causal diagonal streams K and V (the TPU's sequential
// kv grid axis) and accumulates dq (16 x D a warp) in fp32 registers.
//
// Kernel D: one block per (64-key kv tile, kv head, batch row). K and V
// stay in shared memory; a loop over the H/KH q heads of the kv head and
// over 32-row q tiles from the diagonal on streams Q, dO and their rows'
// lse and delta, and accumulates dk and dv (16 x D each a warp) in fp32
// registers. So the group sum happens inside the kernel, in fp32, with
// no [B,H,T,D] intermediate, and no block writes another's output: no
// atomics, a step is deterministic. Recomputing s^T = k q^T (keys as
// rows) makes p^T and ds^T C fragments whose bf16 packing is the A
// fragment of p^T do and ds^T q, with do and q loaded transposed by
// ldmatrix.trans. The q tile is 32 rows, not 64, to keep the two fp32
// accumulators (128 floats a thread at D=128) and the score fragments
// within 255 registers without spilling.
//
// What this leaves for later: wgmma, TMA loads, a producer/consumer warp
// split, and 8-warp blocks over wider tiles.
#include "common.cuh"

using port::bf16;

namespace {

constexpr int BQ = 64;           // kernel C: q rows a block
constexpr int BK = 64;           // kernel C: keys a tile; kernel D: keys a block
constexpr int BQ2 = 32;          // kernel D: q rows a tile
constexpr int NWARPS = 4;        // each warp owns 16 rows
constexpr int NTHREADS = NWARPS * 32;
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src,
                                           long pitch, int rows, int valid) {
  port::stage_rows<D, NTHREADS>(dst, src, pitch, rows, valid);
}

// ldmatrix lane addressing (lane l names row l % 8 of matrix l / 8):
//  - A fragment (16 rows x 16 k) of a row-major [row][k] tile, and the B
//    fragments of a [k][n] tile read transposed: row a_row, column a_col;
//  - B fragments of an [n][k] tile read as is: row b_row, column b_col.
struct Lanes {
  int a_row, a_col, b_row, b_col;
  __device__ explicit Lanes(int lane) {
    const int lm = lane / 8, lr = lane % 8;
    a_row = (lm % 2) * 8 + lr;
    a_col = (lm / 2) * 8;
    b_row = (lm / 2) * 8 + lr;
    b_col = (lm % 2) * 8;
  }
};

// Two C fragments (n-tiles 2c and 2c+1 of a 16-row product) rounded to
// bf16: the A fragment of the c-th 16-wide step of the next product.
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&x)[4],
                                       const float (&y)[4]) {
  a[0] = port::pack_bf16x2(x[0], x[1]);
  a[1] = port::pack_bf16x2(x[2], x[3]);
  a[2] = port::pack_bf16x2(y[0], y[1]);
  a[3] = port::pack_bf16x2(y[2], y[3]);
}

// A warp's 16 x D fp32 accumulator, rounded to bf16, into its own 16
// rows of a shared tile (pitch LD) and from there, 16 bytes a lane, to
// global rows first_row.. (row pitch `pitch`, valid below `valid`).
template <int D>
__device__ __forceinline__ void store_rows(bf16* stage, const float (&acc)[D / 8][4],
                                           bf16* out, long pitch, int first_row,
                                           int valid, int lane) {
  constexpr int LD = port::row_pitch<D>();
  constexpr int CHUNKS = D / 8;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    *reinterpret_cast<uint32_t*>(stage + g * LD + 8 * i + 2 * t) =
        port::pack_bf16x2(acc[i][0], acc[i][1]);
    *reinterpret_cast<uint32_t*>(stage + (g + 8) * LD + 8 * i + 2 * t) =
        port::pack_bf16x2(acc[i][2], acc[i][3]);
  }
  __syncwarp();
  for (int c = lane; c < 16 * CHUNKS; c += 32) {
    const int r = c / CHUNKS, cc = c % CHUNKS;
    if (first_row + r < valid)
      *reinterpret_cast<uint4*>(out + (long)(first_row + r) * pitch + cc * 8) =
          *reinterpret_cast<const uint4*>(stage + r * LD + cc * 8);
  }
}

// ---------------------------------------------------------------- kernel C

template <int D>
struct DqLayout {
  static constexpr int LD = port::row_pitch<D>();
  static constexpr int TILE = BK * LD;   // one K or V tile
  static constexpr size_t BYTES = sizeof(bf16) * (2 * BQ * LD + 4 * TILE);
};

template <int D>
__global__ void __launch_bounds__(NTHREADS, 2)
flash_dq_kernel(const bf16* __restrict__ q,      // [B,S,H,D] pre-scaled
                const bf16* __restrict__ k,      // [B,T,KH,D]
                const bf16* __restrict__ v,      // [B,T,KH,D]
                const bf16* __restrict__ dout,   // [B,S,H,D]
                const float* __restrict__ lse,   // [B,H,S]
                const float* __restrict__ delta, // [B,H,S]
                bf16* __restrict__ dq,           // [B,S,H,D]
                int S, int T, int H, int KH, int causal) {
  constexpr int LD = DqLayout<D>::LD, TILE = DqLayout<D>::TILE;
  constexpr int NT = BK / 8;             // 8-key tiles of s and dp
  constexpr int DT = D / 8;              // 8-column tiles of dq
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sdO = sQ + BQ * LD;
  bf16* sK = sdO + BQ * LD;              // two K tiles, then two V tiles
  bf16* sV = sK + 2 * TILE;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // heaviest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / KH);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const Lanes ln(lane);

  const long q_pitch = (long)H * D;
  const long kv_pitch = (long)KH * D;
  const long q_off = ((long)b * S + q0) * q_pitch + (long)h * D;
  const bf16* kb = k + (long)b * T * kv_pitch + (long)kh * D;
  const bf16* vb = v + (long)b * T * kv_pitch + (long)kh * D;

  int n_kv = (T + BK - 1) / BK;
  if (causal) n_kv = min(n_kv, (q0 + BQ - 1) / BK + 1);

  stage_rows<D>(sQ, q + q_off, q_pitch, BQ, S - q0);
  stage_rows<D>(sdO, dout + q_off, q_pitch, BQ, S - q0);
  stage_rows<D>(sK, kb, kv_pitch, BK, T);
  stage_rows<D>(sV, vb, kv_pitch, BK, T);
  port::cp_async_commit();

  // This lane's rows row0 and row0 + 8: lse in base-2 units and delta.
  // Rows past S read 0: their q and dO are zero-filled, so ds is 0.
  const int row0 = q0 + warp * 16 + g;
  float lse2[2], dlt[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = row0 + 8 * hr;
    const long idx = ((long)b * H + h) * S + row;
    lse2[hr] = row < S ? lse[idx] * LOG2E : 0.f;
    dlt[hr] = row < S ? delta[idx] : 0.f;
  }
  float acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  const bf16* q_frag = sQ + (warp * 16 + ln.a_row) * LD + ln.a_col;
  const bf16* do_frag = sdO + (warp * 16 + ln.a_row) * LD + ln.a_col;

  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * BK;
    const int buf = kt & 1;
    port::cp_async_wait<0>();   // tile kt (and Q, dO) landed
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

    // s = q k^T and dp = do v^T: 16 rows x 64 keys a warp, fp32.
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t aq[4], ao[4];
      port::ldmatrix_x4(aq, q_frag + kk * 16);
      port::ldmatrix_x4(ao, do_frag + kk * 16);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        const int off = (np * 16 + ln.b_row) * LD + kk * 16 + ln.b_col;
        uint32_t bk[4], bv[4];
        port::ldmatrix_x4(bk, tK + off);
        port::mma_bf16_16816(s[2 * np], aq, bk[0], bk[1]);
        port::mma_bf16_16816(s[2 * np + 1], aq, bk[2], bk[3]);
        port::ldmatrix_x4(bv, tV + off);
        port::mma_bf16_16816(dp[2 * np], ao, bv[0], bv[1]);
        port::mma_bf16_16816(dp[2 * np + 1], ao, bv[2], bv[3]);
      }
    }

    // p = exp(s - lse), 0 where masked; ds = p (dp - delta), into s.
    // Fragment element e of tile j: row row0 + 8*(e/2), key
    // k0 + 8*j + 2*t + e%2.
    const bool edge = k0 + BK > T || (causal && k0 + BK - 1 > q0);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hr = e >> 1;
        float p = exp2f(s[j][e] * LOG2E - lse2[hr]);
        if (edge) {
          const int key = k0 + 8 * j + 2 * t + (e & 1);
          if (key >= T || (causal && key > row0 + 8 * hr)) p = 0.f;
        }
        s[j][e] = p * (dp[j][e] - dlt[hr]);
      }
    }

    // dq += ds k: k read transposed ([key][d] is the [k][n] operand).
#pragma unroll
    for (int c = 0; c < BK / 16; ++c) {
      uint32_t a[4];
      c_to_a(a, s[2 * c], s[2 * c + 1]);
#pragma unroll
      for (int dp2 = 0; dp2 < DT / 2; ++dp2) {
        uint32_t bk[4];
        port::ldmatrix_x4_trans(
            bk, tK + (c * 16 + ln.a_row) * LD + dp2 * 16 + ln.a_col);
        port::mma_bf16_16816(acc[2 * dp2], a, bk[0], bk[1]);
        port::mma_bf16_16816(acc[2 * dp2 + 1], a, bk[2], bk[3]);
      }
    }
  }

  // The warp's own rows of sQ (only it reads them) stage its 16 rows.
  store_rows<D>(sQ + warp * 16 * LD, acc, dq + (long)b * S * q_pitch + (long)h * D,
                q_pitch, q0 + warp * 16, S, lane);
}

// ---------------------------------------------------------------- kernel D

template <int D>
struct DkvLayout {
  static constexpr int LD = port::row_pitch<D>();
  static constexpr int KTILE = BK * LD;   // K or V, resident
  static constexpr int QTILE = BQ2 * LD;  // one Q or dO tile
  static constexpr size_t BYTES =
      sizeof(bf16) * (2 * KTILE + 4 * QTILE) + sizeof(float) * 4 * BQ2;
};

template <int D>
__global__ void __launch_bounds__(NTHREADS, 2)
flash_dkv_kernel(const bf16* __restrict__ q,      // [B,S,H,D] pre-scaled
                 const bf16* __restrict__ k,      // [B,T,KH,D]
                 const bf16* __restrict__ v,      // [B,T,KH,D]
                 const bf16* __restrict__ dout,   // [B,S,H,D]
                 const float* __restrict__ lse,   // [B,H,S]
                 const float* __restrict__ delta, // [B,H,S]
                 bf16* __restrict__ dk,           // [B,T,KH,D]
                 bf16* __restrict__ dv,           // [B,T,KH,D]
                 int S, int T, int H, int KH, int causal) {
  constexpr int LD = DkvLayout<D>::LD;
  constexpr int KTILE = DkvLayout<D>::KTILE, QTILE = DkvLayout<D>::QTILE;
  constexpr int NT = BQ2 / 8;            // 8-row q tiles of s^T and dp^T
  constexpr int DT = D / 8;              // 8-column tiles of dk and dv
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + KTILE;
  bf16* sQ = sV + KTILE;                 // two Q tiles, then two dO tiles
  bf16* sdO = sQ + 2 * QTILE;
  float* sL = reinterpret_cast<float*>(sdO + 2 * QTILE);   // [2][BQ2]
  float* sDl = sL + 2 * BQ2;                               // [2][BQ2]

  // Causal work shrinks as the key tile moves right: the lowest tiles,
  // launched first, are the heaviest.
  const int k0 = blockIdx.x * BK;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KH;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const Lanes ln(lane);

  const long q_pitch = (long)H * D;
  const long kv_pitch = (long)KH * D;
  const long kv_off = ((long)b * T + k0) * kv_pitch + (long)kh * D;

  // q rows below the block's first key see none of its keys when causal.
  const int q_start = causal ? k0 : 0;
  const int n_qt = q_start < S ? (S - q_start + BQ2 - 1) / BQ2 : 0;
  const int n_it = G * n_qt;             // (q head, q tile) pairs

  // Stage iteration `it`'s Q and dO tiles (cp.async) and its rows' lse
  // (base 2) and delta (plain loads; rows past S read 0) into buffer buf.
  auto stage_q = [&](int it, int buf) {
    const int hq = kh * G + it / n_qt;
    const int q0 = q_start + (it % n_qt) * BQ2;
    const long off = ((long)b * S + q0) * q_pitch + (long)hq * D;
    stage_rows<D>(sQ + buf * QTILE, q + off, q_pitch, BQ2, S - q0);
    stage_rows<D>(sdO + buf * QTILE, dout + off, q_pitch, BQ2, S - q0);
    if (threadIdx.x < BQ2) {
      const int row = q0 + threadIdx.x;
      const long idx = ((long)b * H + hq) * S + row;
      sL[buf * BQ2 + threadIdx.x] = row < S ? lse[idx] * LOG2E : 0.f;
      sDl[buf * BQ2 + threadIdx.x] = row < S ? delta[idx] : 0.f;
    }
  };

  stage_rows<D>(sK, k + kv_off, kv_pitch, BK, T - k0);
  stage_rows<D>(sV, v + kv_off, kv_pitch, BK, T - k0);
  if (n_it > 0) stage_q(0, 0);
  port::cp_async_commit();

  float dka[DT][4], dva[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[i][e] = dva[i][e] = 0.f;

  const bf16* k_frag = sK + (warp * 16 + ln.a_row) * LD + ln.a_col;
  const bf16* v_frag = sV + (warp * 16 + ln.a_row) * LD + ln.a_col;
  const int key0 = k0 + warp * 16 + g;   // this lane's keys: key0, key0 + 8

  for (int it = 0; it < n_it; ++it) {
    const int buf = it & 1;
    port::cp_async_wait<0>();   // tile `it` (and K, V) landed
    __syncthreads();            // ... for every thread; tile it-1 is free
    if (it + 1 < n_it) {        // the next tile loads while this one runs
      stage_q(it + 1, buf ^ 1);
      port::cp_async_commit();
    }
    const int q0 = q_start + (it % n_qt) * BQ2;
    const bf16* tQ = sQ + buf * QTILE;
    const bf16* tdO = sdO + buf * QTILE;
    const float* L = sL + buf * BQ2;
    const float* Dl = sDl + buf * BQ2;

    // s^T = k q^T and dp^T = v do^T: 16 keys x 32 q rows a warp, fp32.
    float st[NT][4], dpt[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ak[4], av[4];
      port::ldmatrix_x4(ak, k_frag + kk * 16);
      port::ldmatrix_x4(av, v_frag + kk * 16);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        const int off = (np * 16 + ln.b_row) * LD + kk * 16 + ln.b_col;
        uint32_t bq[4], bo[4];
        port::ldmatrix_x4(bq, tQ + off);
        port::mma_bf16_16816(st[2 * np], ak, bq[0], bq[1]);
        port::mma_bf16_16816(st[2 * np + 1], ak, bq[2], bq[3]);
        port::ldmatrix_x4(bo, tdO + off);
        port::mma_bf16_16816(dpt[2 * np], av, bo[0], bo[1]);
        port::mma_bf16_16816(dpt[2 * np + 1], av, bo[2], bo[3]);
      }
    }

    // p^T = exp(s^T - lse), 0 where masked, into st; ds^T = p^T (dp^T -
    // delta), into dpt. Element e of tile j: key key0 + 8*(e/2), q row
    // q0 + 8*j + 2*t + e%2.
    const bool edge = k0 + BK > T || q0 + BQ2 > S ||
                      (causal && k0 + BK - 1 > q0);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * t + (e & 1);
        float p = exp2f(st[j][e] * LOG2E - L[col]);
        if (edge) {
          const int key = key0 + 8 * (e >> 1), row = q0 + col;
          if (key >= T || row >= S || (causal && key > row)) p = 0.f;
        }
        st[j][e] = p;
        dpt[j][e] = p * (dpt[j][e] - Dl[col]);
      }
    }

    // dv += p^T do and dk += ds^T q, over the tile's 32 q rows in two
    // 16-row steps; do and q read transposed ([q row][d] is [k][n]).
#pragma unroll
    for (int c = 0; c < BQ2 / 16; ++c) {
      uint32_t ap[4], ads[4];
      c_to_a(ap, st[2 * c], st[2 * c + 1]);
      c_to_a(ads, dpt[2 * c], dpt[2 * c + 1]);
#pragma unroll
      for (int dp2 = 0; dp2 < DT / 2; ++dp2) {
        const int off = (c * 16 + ln.a_row) * LD + dp2 * 16 + ln.a_col;
        uint32_t bo[4], bq[4];
        port::ldmatrix_x4_trans(bo, tdO + off);
        port::mma_bf16_16816(dva[2 * dp2], ap, bo[0], bo[1]);
        port::mma_bf16_16816(dva[2 * dp2 + 1], ap, bo[2], bo[3]);
        port::ldmatrix_x4_trans(bq, tQ + off);
        port::mma_bf16_16816(dka[2 * dp2], ads, bq[0], bq[1]);
        port::mma_bf16_16816(dka[2 * dp2 + 1], ads, bq[2], bq[3]);
      }
    }
  }

  // Every copy has landed (a block with no q tile still has K and V in
  // flight) before the warps' own rows of sK and sV stage dk and dv.
  port::cp_async_wait<0>();
  __syncthreads();
  const long out_base = (long)b * T * kv_pitch + (long)kh * D;
  store_rows<D>(sK + warp * 16 * LD, dka, dk + out_base, kv_pitch,
                k0 + warp * 16, T, lane);
  store_rows<D>(sV + warp * 16 * LD, dva, dv + out_base, kv_pitch,
                k0 + warp * 16, T, lane);
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
  const size_t smem = DqLayout<D>::BYTES;
  cudaError_t err = allow_smem(flash_dq_kernel<D>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_dq_kernel<D><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), S, T, H, KH, causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int B,
               int S, int T, int H, int KH, int causal, cudaStream_t stream) {
  const size_t smem = DkvLayout<D>::BYTES;
  cudaError_t err = allow_smem(flash_dkv_kernel<D>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + BK - 1) / BK, KH, B);
  flash_dkv_kernel<D><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), S, T, H, KH, causal);
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
  if (D == 64)
    return launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, B, S, T, H, KH,
                          causal, st);
  return (int)cudaErrorInvalidValue;
}
