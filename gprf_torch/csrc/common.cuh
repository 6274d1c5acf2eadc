// Shared helpers of the batched Cholesky kernels: the blocked kernels (K1 and
// K5 chol_inv.cu, K2 mvn.cu and K4 mvn_inv.cu through blocked.cuh, K3
// tri_inv.cu) take the pivot clamp, the cp.async helpers and fma_row.
#pragma once

#include <cuda_runtime.h>

namespace gprf {

// pivot clamp and tiny-guard of the substitution, as in the TPU kernels
constexpr float kTiny = 1e-30f;

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

}  // namespace gprf
