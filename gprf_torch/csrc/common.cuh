// Shared helpers of the batched Cholesky kernels.
//
// The blocked kernels (K1 chol_inv.cu and K2 mvn.cu through blocked.cuh, K3
// tri_inv.cu) take only kTiny, the cp.async helpers and fma_row.  The rest
// serves the sequential kernels K4 mvn_inv.cu and K5 chol.cu: each takes a
// row-major [B, m, m] f32 batch and runs one CTA per matrix, the matrix in
// dynamic shared memory for the whole factorization and the k-loop
// sequential.  The O(m^2) update of step k goes one warp per row, lanes
// along the row.  Row updates are rank-1: row i loses x_i * v for a vector
// v that is the same for every row of the step, so each lane holds its
// slice of v in registers (kChunks values, columns lane + 32 c) instead of
// reading it again for every row.
#pragma once

#include <cuda_runtime.h>

namespace gprf {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
// pivot clamp and tiny-guard of the substitution, as in the TPU kernels
constexpr float kTiny = 1e-30f;

__device__ __forceinline__ void load(float* dst, const float* __restrict__ src, int n) {
#pragma unroll 8
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = __ldg(src + i);
}

__device__ __forceinline__ void set_identity(float* W, int m) {
  for (int idx = threadIdx.x; idx < m * m; idx += blockDim.x) {
    const int i = idx / m;
    W[idx] = (idx - i * m) == i ? 1.f : 0.f;
  }
}

// lower triangle of src, zeros above the diagonal
__device__ __forceinline__ void store_lower(float* __restrict__ dst, const float* src, int m) {
#pragma unroll 4
  for (int idx = threadIdx.x; idx < m * m; idx += blockDim.x) {
    const int i = idx / m;
    dst[idx] = (idx - i * m) <= i ? src[idx] : 0.f;
  }
}

// this lane's slice of a row vector v[0:n): v[lane + 32 c], 0 past n
template <int kChunks>
__device__ __forceinline__ void lane_slice(float (&out)[kChunks], const float* v, int n) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int j = lane + 32 * c;
    out[c] = j < n ? v[j] : 0.f;
  }
}

// Rank-1 update of rows r0 <= r < m of a row-major buffer M with row
// stride ld, restricted to columns [lo, hi(r)):
//   M[r, j] -= x(r) * v[j]
// v is given as this lane's register slice; x(r) is read from shared
// memory.  Warps take rows round-robin, one row at a time, loading the
// row's chunks before storing any (two or four rows at once measured
// slower).
template <int kChunks, typename X, typename Hi>
__device__ __forceinline__ void rank1_rows(float* M, int ld, int r0, int m, int lo, Hi hi,
                                           X x, const float (&v)[kChunks]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = r0 + warp; r < m; r += kWarps) {
    const float xr = x(r);
    const int h = hi(r);
    float* Mr = M + r * ld;
    float val[kChunks];
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int j = lane + 32 * c;
      val[c] = (j >= lo && j < h) ? Mr[j] : 0.f;
    }
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int j = lane + 32 * c;
      if (j >= lo && j < h) Mr[j] = val[c] - xr * v[c];
    }
  }
}

// 4-byte async copy global -> shared; zero-fills when !valid (src unread)
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// acc[j] += a * b[j], a 1 x 4 row of a register tile
__device__ __forceinline__ void fma_row(float (&acc)[4], float a, const float4& b) {
  acc[0] = fmaf(a, b.x, acc[0]);
  acc[1] = fmaf(a, b.y, acc[1]);
  acc[2] = fmaf(a, b.z, acc[2]);
  acc[3] = fmaf(a, b.w, acc[3]);
}

// set the dynamic shared memory limit, launch, and report the launch status
template <typename Kernel, typename... Args>
int launch(Kernel kernel, int batch, size_t smem, void* stream, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  if (batch == 0) return 0;
  kernel<<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gprf
