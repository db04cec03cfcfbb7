// Kernel B: paged decode/verify attention over the block-paged K/V pool.
//
// Replaces: skypilot_tpu/ops/pallas/paged_attention.py::_kernel
// (pl.pallas_call in paged_decode_attention), the Pallas TPU kernel that
// streams one K/V page per grid step of a (B, H, max_pages) grid, with
// the page table and row lengths as scalar-prefetch operands and VMEM
// scratch carrying the online softmax across pages.
//
// Bound on an H100 SXM: bytes. Each decoded token reads its row's whole
// K and V history for every kv head and does only 4*g*S FLOPs per bf16
// pair read (g = H/KH q heads per kv head, S = 1 at decode), far below
// the ~295 FLOP/byte ridge; the floor is the K+V bytes the rows' lengths
// need / 3.35 TB/s.
//
// Design. One block per (kv head, batch row) serves all g*S query rows
// of the group, so each K/V page is read from device memory once per
// group, not once per q head as the TPU grid does. The block reads its
// own table[b, j] and length[b] (the counterpart of scalar prefetch)
// and loops j from 0 to min((length+S-1)/psz, max_pages-1): pages past
// the row's content are never touched. Pages stream through a double
// buffer in shared memory with cp.async, the next page in flight while
// the current one is scored, so the block always has a whole page of
// loads outstanding. Scores take one thread per (q row, key), reading
// its key row (padded, conflict-free 16-byte loads) and the q row
// (fp32, broadcast). The positional mask length+s >= j*psz+off, the
// fp32 online softmax and the l == 0 guard follow the TPU kernel, and
// probabilities round to bf16 before P V as there; then thread d
// accumulates output column d of every row. What this leaves for later:
// splitting a long row's pages over several blocks (flash-decoding) so
// that B*KH blocks fill all 132 SMs.
#include "common.cuh"

using port::bf16;
using port::NEG_INF;

namespace {

constexpr int HD = 128;          // head_dim
constexpr int LDK = HD + 8;      // padded bf16 pitch of sK rows
constexpr int NTHREADS = 128;    // thread d owns output column d
constexpr int NWARPS = NTHREADS / 32;
constexpr int MAXR = 16;         // max q rows per block: g * S
constexpr int MAXPSZ = 128;

// RT: compile-time row capacity (1, 2, 4, 8 or 16) >= the block's g*S,
// so the per-key P V update is RT fused multiply-adds, not MAXR
// predicated ones.
template <int RT>
__host__ __device__ constexpr size_t smem_bytes(int psz) {
  return 2 * sizeof(bf16) * (size_t)psz * LDK +    // sK, double buffered
         2 * sizeof(bf16) * (size_t)psz * HD +     // sV, double buffered
         sizeof(float) * (size_t)RT * HD +         // sQ
         sizeof(float) * (size_t)RT * psz +        // sP (scores/probs)
         3 * sizeof(float) * RT;                   // sM, sL, sAlpha
}

template <int RT>
__global__ void __launch_bounds__(NTHREADS)
paged_decode_kernel(const bf16* __restrict__ q,     // [B,S,H,HD] pre-scaled
                    const bf16* __restrict__ kp,    // [NP,psz,KH,HD]
                    const bf16* __restrict__ vp,    // [NP,psz,KH,HD]
                    const int* __restrict__ table,  // [B,maxp]
                    const int* __restrict__ length, // [B]
                    bf16* __restrict__ out,         // [B,S,H,HD]
                    int S, int H, int KH, int psz, int maxp) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK0 = reinterpret_cast<bf16*>(smem);
  bf16* sV0 = sK0 + 2 * (size_t)psz * LDK;
  float* sQ = reinterpret_cast<float*>(sV0 + 2 * (size_t)psz * HD);
  float* sP = sQ + RT * HD;
  float* sM = sP + RT * psz;
  float* sL = sM + RT;
  float* sAlpha = sL + RT;

  const int kh = blockIdx.x, b = blockIdx.y;
  const int g = H / KH;
  const int R = g * S;            // row r = s * g + gi, q head kh*g + gi
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int len = length[b];
  const int last = min((len + S - 1) / psz, maxp - 1);
  const long row_pitch = (long)KH * HD;          // one token of the pool
  constexpr int CHUNKS = HD / 8;                 // 16-byte chunks per row

  auto issue_page = [&](int j, int buf) {
    const long pid = table[(long)b * maxp + j];
    const long base = pid * psz * row_pitch + (long)kh * HD;
    bf16* dk = sK0 + (size_t)buf * psz * LDK;
    bf16* dv = sV0 + (size_t)buf * psz * HD;
    for (int c = tid; c < psz * CHUNKS; c += NTHREADS) {
      const int t = c / CHUNKS, cc = c % CHUNKS;
      const long off = base + t * row_pitch + cc * 8;
      port::cp_async16(dk + t * LDK + cc * 8, kp + off);
      port::cp_async16(dv + t * HD + cc * 8, vp + off);
    }
    port::cp_async_commit();
  };

  issue_page(0, 0);
  for (int i = tid; i < R * HD; i += NTHREADS) {
    const int r = i / HD, d = i % HD;
    const int s = r / g, h = kh * g + r % g;
    sQ[i] = __bfloat162float(q[(((long)b * S + s) * H + h) * HD + d]);
  }
  if (tid < RT) {
    sM[tid] = NEG_INF;
    sL[tid] = 0.f;
    sAlpha[tid] = 1.f;
  }
  for (int i = R * psz + tid; i < RT * psz; i += NTHREADS) sP[i] = 0.f;
  float acc[RT];
#pragma unroll
  for (int r = 0; r < RT; ++r) acc[r] = 0.f;

  for (int j = 0; j <= last; ++j) {
    const int buf = j & 1;
    if (j < last) {
      issue_page(j + 1, buf ^ 1);   // its buffer was released last round
      port::cp_async_wait<1>();
    } else {
      port::cp_async_wait<0>();
    }
    __syncthreads();                 // page j (and sQ, sM, sL) visible
    const bf16* sK = sK0 + (size_t)buf * psz * LDK;
    const bf16* sV = sV0 + (size_t)buf * psz * HD;

    // Scores with the positional mask: one thread per (row, key).
    for (int it = tid; it < R * psz; it += NTHREADS) {
      const int r = it / psz, t = it % psz;   // rows past R stay 0
      const uint4* krow = reinterpret_cast<const uint4*>(sK + t * LDK);
      const float4* qrow = reinterpret_cast<const float4*>(sQ + r * HD);
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < CHUNKS; ++c) {
        const uint4 raw = krow[c];
        const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
        const float4 qa = qrow[2 * c], qb = qrow[2 * c + 1];
        const float2 f0 = __bfloat1622float2(k2[0]);
        const float2 f1 = __bfloat1622float2(k2[1]);
        const float2 f2 = __bfloat1622float2(k2[2]);
        const float2 f3 = __bfloat1622float2(k2[3]);
        dot += qa.x * f0.x + qa.y * f0.y + qa.z * f1.x + qa.w * f1.y +
               qb.x * f2.x + qb.y * f2.y + qb.z * f3.x + qb.w * f3.y;
      }
      const int q_pos = len + r / g;
      sP[r * psz + t] = (q_pos >= j * psz + t) ? dot : NEG_INF;
    }
    __syncthreads();

    // Online softmax per row: warp w takes rows w, w+NWARPS, ...
    for (int r = warp; r < R; r += NWARPS) {
      float* prow = sP + r * psz;
      float mloc = NEG_INF;
      for (int c = lane; c < psz; c += 32) mloc = fmaxf(mloc, prow[c]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, o));
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, mloc);
      const float alpha = expf(m_prev - m_new);
      float sum = 0.f;
      for (int c = lane; c < psz; c += 32) {
        const float p = expf(prow[c] - m_new);
        sum += p;
        prow[c] = __bfloat162float(__float2bfloat16(p));
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      __syncwarp();
      if (lane == 0) {
        sM[r] = m_new;
        sL[r] = sL[r] * alpha + sum;
        sAlpha[r] = alpha;
      }
    }
    __syncthreads();

    // P V: thread tid accumulates column tid of every row (rows past R
    // hold zeros in sP and stay 0).
#pragma unroll
    for (int r = 0; r < RT; ++r) acc[r] *= sAlpha[r];
#pragma unroll 4
    for (int t = 0; t < psz; ++t) {
      const float vv = __bfloat162float(sV[t * HD + tid]);
#pragma unroll
      for (int r = 0; r < RT; ++r) acc[r] += sP[r * psz + t] * vv;
    }
    __syncthreads();                 // buffer `buf` and sP are free again
  }

#pragma unroll
  for (int r = 0; r < RT; ++r) {
    if (r < R) {
      const float l = sL[r];
      const float inv = (l == 0.f) ? 1.f : 1.f / l;
      const int s = r / g, h = kh * g + r % g;
      out[(((long)b * S + s) * H + h) * HD + tid] =
          __float2bfloat16(acc[r] * inv);
    }
  }
}

}  // namespace

template <int RT>
int launch(const void* q, const void* kp, const void* vp, const void* table,
           const void* length, void* out, int B, int S, int H, int KH,
           int psz, int maxp, cudaStream_t stream) {
  const size_t smem = smem_bytes<RT>(psz);
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel<RT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(KH, B);
  paged_decode_kernel<RT><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(kp),
      static_cast<const bf16*>(vp), static_cast<const int*>(table),
      static_cast<const int*>(length), static_cast<bf16*>(out), S, H, KH, psz,
      maxp);
  return (int)cudaGetLastError();
}

extern "C" int paged_decode_bf16(const void* q, const void* kp,
                                 const void* vp, const void* table,
                                 const void* length, void* out, int B, int S,
                                 int H, int KH, int hd, int psz, int maxp,
                                 void* stream) {
  if (hd != HD || B <= 0 || S <= 0 || KH <= 0 || H % KH != 0 ||
      (H / KH) * S > MAXR || psz <= 0 || psz % 8 != 0 || psz > MAXPSZ ||
      maxp <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int R = (H / KH) * S;
  if (R <= 1) return launch<1>(q, kp, vp, table, length, out, B, S, H, KH, psz, maxp, st);
  if (R <= 2) return launch<2>(q, kp, vp, table, length, out, B, S, H, KH, psz, maxp, st);
  if (R <= 4) return launch<4>(q, kp, vp, table, length, out, B, S, H, KH, psz, maxp, st);
  if (R <= 8) return launch<8>(q, kp, vp, table, length, out, B, S, H, KH, psz, maxp, st);
  return launch<16>(q, kp, vp, table, length, out, B, S, H, KH, psz, maxp, st);
}
