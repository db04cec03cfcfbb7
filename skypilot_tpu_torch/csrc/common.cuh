// Shared device helpers for the port's kernels: async copies, ldmatrix
// and the bf16 mma.sync tile (sm_80 and up, built for sm_90a).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace port {

typedef __nv_bfloat16 bf16;

constexpr float NEG_INF = -1073741824.0f;   // -2**30, finite (as the JAX code)

// 16-byte global -> shared copy that bypasses registers (cp.async.cg).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

// The same, copying `src_bytes` (0 or 16) and zero-filling the rest: a
// row past the tensor's edge lands as zeros without a separate store.
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem,
                                                 int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Shared-memory row pitch of a tile of D bf16 columns: 16-byte rows and
// conflict-free ldmatrix.
template <int D>
__host__ __device__ constexpr int row_pitch() { return D + 8; }

// Stage `rows` rows of D bf16 (global row pitch `pitch` elements) into
// shared memory (row pitch row_pitch<D>()) with cp.async, THREADS
// threads sharing the copy; rows at or past `valid` are zero-filled. The
// caller commits the group.
template <int D, int THREADS>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src,
                                           long pitch, int rows, int valid) {
  constexpr int CHUNKS = D / 8;          // 16-byte chunks per row
  for (int c = threadIdx.x; c < rows * CHUNKS; c += THREADS) {
    const int r = c / CHUNKS, cc = c % CHUNKS;
    const bool ok = r < valid;
    cp_async16_zfill(dst + r * row_pitch<D>() + cc * 8,
                     src + (ok ? r * pitch + cc * 8 : 0), ok ? 16 : 0);
  }
}

// Four 8x8 b16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8 and receives r[m] from matrix m.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// The same, each matrix transposed on the way.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// d += a b on the tensor cores: a 16x16 bf16 (row), b 16x8 bf16 (col),
// d 16x8 fp32. Fragment layouts: PTX ISA, "mma.m16n8k16".
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to a bf16 pair, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

}  // namespace port
