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
// Design (flash-decoding). The TPU grid walks a row's pages in order on
// one core; here a row's pages are split over blocks so that the card's
// 132 SMs all stream. The grid is (chunks, KH, B): block (c, kh, b)
// takes pages [c*ppc, (c+1)*ppc) of row b for kv head kh, with all g*S
// query rows of the group (row r = s*g + gi, q head kh*g + gi), so each
// K/V page is read from device memory once per group. The host picks
// the chunk count from max_pages, B*KH and the SM count (it does not
// know the lengths); a block whose pages all lie past its row's last
// page, min((length+S-1)/psz, max_pages-1), reads nothing, so as on the
// TPU no page past a row's content is touched.
//  - Loads: each block reads its own table[b, j] (the counterpart of
//    scalar prefetch) and streams its pages through a ring of slots in
//    shared memory with cp.async, all slots but one in flight while one
//    is scored; one __syncthreads a slot publishes it and frees the
//    oldest. A slot holds a whole page, or at head_dim 256 at most 64
//    tokens: a page of 72 to 128 tokens streams as two equal halves (one
//    128-token K+V page would be 128 KB). A slot is a tile of keys
//    either way: tile u of a row covers positions [u*tile, (u+1)*tile),
//    on page u / (psz/tile). The ring has three slots, or two where
//    three do not fit in shared memory at the largest tile (head_dim 256
//    with 64 q rows).
//  - Products on the tensor cores (mma.sync m16n8k16, bf16 in, fp32
//    accumulate): the g*S rows, padded to MT m-tiles of 16 (MT 1, 2 or
//    4: up to 64 rows), are the A operand; a tile is cut into 16-key
//    tiles. The four warps split (m-tile, key tile) pairs: warp w owns
//    m-tile w % MT and the key tiles kt with kt % (4/MT) == w / MT, and
//    keeps its own online softmax (m, l, and a 16 x HD fp32 output) over
//    them. q, pre-scaled in the kernel as bf16(float(q) * scale) (what
//    the JAX wrapper's (q * scale).astype(q.dtype) gives), is staged in
//    shared memory once; at head_dim 128 each warp then holds its A
//    fragments in registers, at 256 (where the 16 x 256 fp32 output
//    alone is 128 registers a thread) it reads them from shared memory
//    at every 16-key tile. The fp32 scores' C fragments, masked
//    (positional: length + s >= key position) and exponentiated, round
//    to bf16 and are directly the A fragment of P V, as the TPU kernel
//    rounds p before P V.
//  - Combine: every warp writes its partial (unnormalised fp32 output,
//    running max in base-2 units, sum) to a workspace; the block then
//    takes a ticket from a per-(b, kh) counter, and the last block to
//    arrive merges the partials of that (b, kh) in fixed order (chunk,
//    then warp), applies the l == 0 guard, writes bf16 out and resets the
//    counter to 0 for the next call. The order of every sum is fixed, so
//    two calls give bit-equal outputs. One launch a call.
// Masked scores give p = 0 exactly (not exp of NEG_INF - m), so a warp
// whose keys a row cannot see yet contributes an empty partial.
#include "common.cuh"

using port::bf16;
using port::NEG_INF;

namespace {

constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int MAXSTAGES = 3;     // ring slots: all but one in flight
constexpr int MAXR = 64;         // max q rows per block: g * S
constexpr int MAXPSZ = 128;
constexpr int SMEM_LIMIT = 232448;  // a block's shared memory on sm_90
constexpr float LOG2E = 1.4426950408889634f;

__host__ __device__ constexpr int pad16(int n) { return (n + 15) / 16 * 16; }

// Padded bf16 pitch of Q, K and V rows (no ldmatrix bank conflicts), and
// the most tokens a ring slot holds.
template <int HD> struct Dims {
  static constexpr int LD = HD + 8;
  static constexpr int MAX_TILE = HD <= 128 ? MAXPSZ : 64;
};

// Tokens a slot holds: the page, or an equal part of it no larger than
// MAX_TILE (psz is a multiple of 8, so halves are whole tokens). At
// head_dim 128 every page fits: the compiler sees tile == psz.
template <int HD>
__host__ __device__ constexpr int tile_tokens(int psz) {
  return Dims<HD>::MAX_TILE >= MAXPSZ || psz <= Dims<HD>::MAX_TILE ? psz
                                                                   : psz / 2;
}

// Q (MT*16 rows), then per slot a tile's K rows and V rows, each padded
// to a multiple of 16 rows (the pad rows are zeroed once).
template <int HD>
__host__ __device__ constexpr size_t smem_bytes(int mt, int stages, int psz) {
  return sizeof(bf16) * Dims<HD>::LD *
         ((size_t)mt * 16 + (size_t)stages * 2 * pad16(tile_tokens<HD>(psz)));
}

// Ring slots: three where they fit beside the q tile at the largest
// tile, else two (head_dim 256 with 64 q rows).
template <int HD, int MT>
__host__ __device__ constexpr int ring_stages() {
  return smem_bytes<HD>(MT, MAXSTAGES, Dims<HD>::MAX_TILE) <= SMEM_LIMIT
             ? MAXSTAGES : 2;
}

// ldmatrix lane addressing (lane l names row l % 8 of matrix l / 8): the
// A fragment of a [row][k] tile, and the B fragments of a [k][n] tile
// read transposed, at (a_row, a_col); the B fragments of an [n][k] tile
// at (b_row, b_col).
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

template <int HD, int MT>
__global__ void __launch_bounds__(NTHREADS, 2)
paged_decode_kernel(const bf16* __restrict__ q,     // [B,S,H,HD]
                    const bf16* __restrict__ kp,    // [NP,psz,KH,HD]
                    const bf16* __restrict__ vp,    // [NP,psz,KH,HD]
                    const int* __restrict__ table,  // [B,maxp]
                    const int* __restrict__ length, // [B]
                    bf16* __restrict__ out,         // [B,S,H,HD]
                    float* __restrict__ part_o,     // [B*KH, parts, R, HD]
                    float* __restrict__ part_ml,    // [B*KH, parts, R, 2]
                    int* __restrict__ ticket,       // [B*KH], 0 between calls
                    int S, int H, int KH, int psz, int maxp, int ppc,
                    float scale) {
  constexpr int LD = Dims<HD>::LD;
  constexpr int STAGES = ring_stages<HD, MT>();
  constexpr int KS = NWARPS / MT;   // key splits: warps sharing an m-tile
  constexpr bool Q_IN_REGS = HD <= 128;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_last;
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sKV = sQ + MT * 16 * LD;
  const int tile = tile_tokens<HD>(psz);
  const int nsub = tile == psz ? 1 : 2;            // slots a page
  const int P16 = pad16(tile);
  const int stage_elems = 2 * P16 * LD;

  const int chunk = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int nchunks = gridDim.x, nparts = nchunks * KS;
  const int g = H / KH;
  const int R = g * S;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int t = lane % 4;
  const int len = length[b];
  const int last = min((len + S - 1) / psz, maxp - 1);
  const int j0 = chunk * ppc;
  const int j1 = min(j0 + ppc, last + 1);          // this block's pages [j0, j1)
  // ... as tiles: none past the one holding the row's last position.
  const int u0 = j0 * nsub;
  const int u1 = min(j1 * nsub, (len + S - 1) / tile + 1);
  const long bkh = (long)b * KH + kh;
  const long row_pitch = (long)KH * HD;            // one token of the pool

  if (u0 < u1) {
    const int mt = warp % MT, split = warp / MT;
    const Lanes ln(lane);

    auto issue_tile = [&](int u, int st) {
      if (u < u1) {
        const long pid = table[(long)b * maxp + u / nsub];
        const long base = (pid * psz + (long)(u % nsub) * tile) * row_pitch +
                          (long)kh * HD;
        bf16* dk = sKV + (size_t)st * stage_elems;
        bf16* dv = dk + P16 * LD;
        for (int c = tid; c < tile * (HD / 8); c += NTHREADS) {
          const int tok = c / (HD / 8), cc = c % (HD / 8);
          const long off = base + tok * row_pitch + cc * 8;
          port::cp_async16(dk + tok * LD + cc * 8, kp + off);
          port::cp_async16(dv + tok * LD + cc * 8, vp + off);
        }
      }
      port::cp_async_commit();     // empty past the block's tiles
    };
#pragma unroll
    for (int i = 0; i < STAGES - 1; ++i) issue_tile(u0 + i, i);

    // q rows, pre-scaled and rounded to bf16; rows past R and the pad
    // rows of every slot are zeros.
    for (int i = tid; i < MT * 16 * (HD / 2); i += NTHREADS) {
      const int r = i / (HD / 2), d = 2 * (i % (HD / 2));
      float2 v = make_float2(0.f, 0.f);
      if (r < R) {
        const int s = r / g, h = kh * g + r % g;
        const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            q + (((long)b * S + s) * H + h) * HD + d));
        v = make_float2(x.x * scale, x.y * scale);
      }
      *reinterpret_cast<uint32_t*>(sQ + r * LD + d) = port::pack_bf16x2(v.x, v.y);
    }
    if (P16 != tile) {
      const int pad = (P16 - tile) * LD;
      for (int i = tid; i < STAGES * 2 * pad; i += NTHREADS) {
        const int half = i / pad;          // slot * 2 + (K or V)
        sKV[(size_t)half * P16 * LD + tile * LD + i % pad] = __float2bfloat16(0.f);
      }
    }
    __syncthreads();

    const bf16* qrow = sQ + (mt * 16 + ln.a_row) * LD + ln.a_col;
    uint32_t qa[Q_IN_REGS ? HD / 16 : 1][4];
    if constexpr (Q_IN_REGS) {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) port::ldmatrix_x4(qa[kk], qrow + kk * 16);
    }

    // This lane's rows mt*16 + lane/4 (+8): their q positions.
    int qpos[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) qpos[hr] = len + (mt * 16 + lane / 4 + 8 * hr) / g;

    float acc[HD / 8][4];
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    float m[2] = {NEG_INF, NEG_INF};   // running max, base-2 units
    float l[2] = {0.f, 0.f};           // this lane's share of the sum

    for (int i = 0; u0 + i < u1; ++i) {
      const int u = u0 + i;
      port::cp_async_wait<STAGES - 2>();   // tile u (this thread's part)
      __syncthreads();                     // ... everyone's; slot i-1 free
      issue_tile(u + STAGES - 1, (i + STAGES - 1) % STAGES);
      const bf16* tK = sKV + (size_t)(i % STAGES) * stage_elems;
      const bf16* tV = tK + P16 * LD;
      const int key0 = u * tile;           // position of the tile's first key

      for (int kt = split; kt < P16 / 16; kt += KS) {
        // s = q k^T: 16 rows x 16 keys, fp32.
        float s[2][4];
#pragma unroll
        for (int n = 0; n < 2; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          uint32_t bk[4];
          port::ldmatrix_x4(bk, tK + (kt * 16 + ln.b_row) * LD + kk * 16 + ln.b_col);
          if constexpr (Q_IN_REGS) {
            port::mma_bf16_16816(s[0], qa[kk], bk[0], bk[1]);
            port::mma_bf16_16816(s[1], qa[kk], bk[2], bk[3]);
          } else {
            uint32_t a[4];
            port::ldmatrix_x4(a, qrow + kk * 16);
            port::mma_bf16_16816(s[0], a, bk[0], bk[1]);
            port::mma_bf16_16816(s[1], a, bk[2], bk[3]);
          }
        }
        // Mask and online softmax. Element e of tile n: row lane/4 +
        // 8*(e/2), key kt*16 + 8n + 2t + e%2 of the slot.
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int off = kt * 16 + 8 * n + 2 * t + (e & 1);
            const int hr = e >> 1;
            const bool ok = off < tile && qpos[hr] >= key0 + off;
            s[n][e] = ok ? s[n][e] * LOG2E : NEG_INF;
            mx[hr] = fmaxf(mx[hr], s[n][e]);
          }
        float alpha[2];
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
          mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
          alpha[hr] = exp2f(m[hr] - mx[hr]);
          m[hr] = mx[hr];
          l[hr] *= alpha[hr];
        }
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int hr = e >> 1;
            const float p = s[n][e] == NEG_INF ? 0.f : exp2f(s[n][e] - m[hr]);
            l[hr] += p;
            s[n][e] = p;
          }
#pragma unroll
        for (int i2 = 0; i2 < HD / 8; ++i2) {
          acc[i2][0] *= alpha[0];
          acc[i2][1] *= alpha[0];
          acc[i2][2] *= alpha[1];
          acc[i2][3] *= alpha[1];
        }
        // o += p v: p (bf16) is the A fragment; v read transposed.
        uint32_t pa[4];
        pa[0] = port::pack_bf16x2(s[0][0], s[0][1]);
        pa[1] = port::pack_bf16x2(s[0][2], s[0][3]);
        pa[2] = port::pack_bf16x2(s[1][0], s[1][1]);
        pa[3] = port::pack_bf16x2(s[1][2], s[1][3]);
#pragma unroll
        for (int dp = 0; dp < HD / 16; ++dp) {
          uint32_t bv[4];
          port::ldmatrix_x4_trans(bv, tV + (kt * 16 + ln.a_row) * LD + dp * 16 + ln.a_col);
          port::mma_bf16_16816(acc[2 * dp], pa, bv[0], bv[1]);
          port::mma_bf16_16816(acc[2 * dp + 1], pa, bv[2], bv[3]);
        }
      }
    }
    port::cp_async_wait<0>();

    // This warp's partial, rows below R only.
    const long part = (bkh * nparts + (long)chunk * KS + split) * R;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
      l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
      const int row = mt * 16 + lane / 4 + 8 * hr;
      if (row < R) {
        float* po = part_o + (part + row) * HD + 2 * t;
#pragma unroll
        for (int i2 = 0; i2 < HD / 8; ++i2)
          *reinterpret_cast<float2*>(po + 8 * i2) =
              make_float2(acc[i2][2 * hr], acc[i2][2 * hr + 1]);
        if (t == 0)
          *reinterpret_cast<float2*>(part_ml + (part + row) * 2) = make_float2(m[hr], l[hr]);
      }
    }
  }

  // The last block of this (b, kh) to arrive merges every partial.
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(ticket + bkh, 1) == nchunks - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  const int used = (last / ppc + 1) * KS;   // partials of chunks with pages
  const float* pm = part_ml + bkh * nparts * R * 2;
  const float* po = part_o + bkh * nparts * R * HD;
  for (int r = warp; r < R; r += NWARPS) {
    float mm = NEG_INF;
    for (int p = 0; p < used; ++p) mm = fmaxf(mm, __ldcg(pm + ((long)p * R + r) * 2));
    float ll = 0.f;
    float4 o[HD / 128];
#pragma unroll
    for (int c = 0; c < HD / 128; ++c) o[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int p = 0; p < used; ++p) {
      const float2 ml = __ldcg(reinterpret_cast<const float2*>(pm + ((long)p * R + r) * 2));
      const float w = exp2f(ml.x - mm);
      ll += ml.y * w;
#pragma unroll
      for (int c = 0; c < HD / 128; ++c) {
        const float4 x = __ldcg(reinterpret_cast<const float4*>(
            po + ((long)p * R + r) * HD + 128 * c) + lane);
        o[c].x += x.x * w;
        o[c].y += x.y * w;
        o[c].z += x.z * w;
        o[c].w += x.w * w;
      }
    }
    const float inv = (ll == 0.f) ? 1.f : 1.f / ll;
    const int s = r / g, h = kh * g + r % g;
#pragma unroll
    for (int c = 0; c < HD / 128; ++c) {
      uint2 pk;
      pk.x = port::pack_bf16x2(o[c].x * inv, o[c].y * inv);
      pk.y = port::pack_bf16x2(o[c].z * inv, o[c].w * inv);
      *reinterpret_cast<uint2*>(out + (((long)b * S + s) * H + h) * HD + 128 * c +
                                4 * lane) = pk;
    }
  }
  if (tid == 0) ticket[bkh] = 0;
}

template <int HD, int MT>
int launch(const void* q, const void* kp, const void* vp, const void* table,
           const void* length, void* out, void* part_o, void* part_ml,
           void* ticket, int B, int S, int H, int KH, int psz, int maxp,
           int nchunks, int ppc, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<HD>(MT, ring_stages<HD, MT>(), psz);
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel<HD, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(nchunks, KH, B);
  paged_decode_kernel<HD, MT><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(kp),
      static_cast<const bf16*>(vp), static_cast<const int*>(table),
      static_cast<const int*>(length), static_cast<bf16*>(out),
      static_cast<float*>(part_o), static_cast<float*>(part_ml),
      static_cast<int*>(ticket), S, H, KH, psz, maxp, ppc, scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_rows(int R, const void* q, const void* kp, const void* vp,
                const void* table, const void* length, void* out, void* part_o,
                void* part_ml, void* ticket, int B, int S, int H, int KH,
                int psz, int maxp, int nchunks, int ppc, float scale,
                cudaStream_t st) {
  if (R <= 16)
    return launch<HD, 1>(q, kp, vp, table, length, out, part_o, part_ml, ticket,
                         B, S, H, KH, psz, maxp, nchunks, ppc, scale, st);
  if (R <= 32)
    return launch<HD, 2>(q, kp, vp, table, length, out, part_o, part_ml, ticket,
                         B, S, H, KH, psz, maxp, nchunks, ppc, scale, st);
  return launch<HD, 4>(q, kp, vp, table, length, out, part_o, part_ml, ticket,
                       B, S, H, KH, psz, maxp, nchunks, ppc, scale, st);
}

}  // namespace

// The workspace's layout is this entry point's alone: ``work`` holds
// the partials' fp32 outputs [B*KH, nchunks*KS, R, hd] and then their
// (max, sum) pairs [B*KH, nchunks*KS, R, 2], where R = (H/KH)*S and KS =
// 4/MT (MT = ceil(R/16) rounded up to 1, 2 or 4); ``ticket`` holds B*KH
// ints that are 0 before the call and 0 again after it. A workspace
// smaller than that (work_floats, n_tickets) is refused, never
// overrun. head_dim is 128 or 256.
extern "C" int paged_decode_bf16(const void* q, const void* kp,
                                 const void* vp, const void* table,
                                 const void* length, void* out, void* work,
                                 void* ticket, long long work_floats,
                                 int n_tickets, int B, int S, int H, int KH,
                                 int hd, int psz, int maxp, int nchunks,
                                 int ppc, float scale, void* stream) {
  if ((hd != 128 && hd != 256) || B <= 0 || S <= 0 || KH <= 0 ||
      H % KH != 0 || (H / KH) * S > MAXR || psz <= 0 || psz % 8 != 0 ||
      psz > MAXPSZ || maxp <= 0 || nchunks <= 0 || ppc <= 0 ||
      (long)nchunks * ppc < maxp || (long)(nchunks - 1) * ppc >= maxp ||
      KH > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const int R = (H / KH) * S;
  const int MT = R <= 16 ? 1 : R <= 32 ? 2 : 4;
  const long long parts = (long long)B * KH * nchunks * (NWARPS / MT) * R;
  if (work_floats < parts * (hd + 2) || n_tickets < B * KH)
    return (int)cudaErrorInvalidValue;
  float* part_o = static_cast<float*>(work);
  float* part_ml = part_o + parts * hd;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 128)
    return launch_rows<128>(R, q, kp, vp, table, length, out, part_o, part_ml,
                            ticket, B, S, H, KH, psz, maxp, nchunks, ppc, scale,
                            st);
  return launch_rows<256>(R, q, kp, vp, table, length, out, part_o, part_ml,
                          ticket, B, S, H, KH, psz, maxp, nchunks, ppc, scale,
                          st);
}
