// K1: fused Cholesky + triangular inverse, (L, W = L^-1) of SPD [B, m, m].
//
// Replaces the TPU kernel _chol_inv_kernel (gprf_tpu/ops/pallas_mvn.py),
// which runs the batch in the 128-wide lane axis and walks m sequential
// steps over a [m, m, 128] VMEM tile.  On the H100 one CTA owns one matrix
// instead (B = 100 unary blocks at the flagship: one wave over 132 SMs).
//
// Bound: m sequential steps, each an O(m^2) shared-memory update followed
// by a block barrier.  Measured on the H100, one CTA at m = 136 spends
// ~1.5 us a step, nearly all of it in the warps' chains of shared-memory
// loads and stores of their rows; the barriers cost ~36 cycles each, and
// neither the FLOPs (m^3/2 FMAs per matrix), the shared-memory bandwidth
// nor the HBM bytes (3 m^2 floats) come close to bounding it.
// Design: K and the running right-hand side of L W = I both stay in shared
// memory (2 m^2 + m floats, m <= 168), and the substitution for W is folded
// into the factorization's k-loop (right-looking on both), so each step
// costs two barriers and the factor never leaves the SM before it is final.
#include "common.cuh"

namespace {

constexpr int kChunks = (192 + 31) / 32;  // columns per lane, m <= 192

__global__ void __launch_bounds__(gprf::kThreads)
chol_inv_kernel(const float* __restrict__ K, float* __restrict__ L,
                float* __restrict__ W, int m) {
  extern __shared__ float smem[];
  float* A = smem;          // K, overwritten by L in its lower triangle
  float* R = A + m * m;     // I, overwritten row by row by W
  float* col = R + m * m;   // scaled column k of L
  const size_t off = static_cast<size_t>(blockIdx.x) * m * m;
  gprf::load(A, K + off, m * m);
  gprf::set_identity(R, m);
  __syncthreads();

  for (int k = 0; k < m; ++k) {
    const float akk = A[k * m + k];
    const float d = rsqrtf(fmaxf(akk, gprf::kTiny));
    const float lkk = akk * d;
    const float winv = 1.f / (fabsf(lkk) > gprf::kTiny ? lkk : gprf::kTiny);
    for (int i = k + threadIdx.x; i < m; i += blockDim.x) col[i] = A[i * m + k] * d;
    for (int j = threadIdx.x; j <= k; j += blockDim.x) R[k * m + j] *= winv;
    __syncthreads();

    for (int i = k + threadIdx.x; i < m; i += blockDim.x) A[i * m + k] = col[i];
    float v[kChunks];
    auto lik = [&](int i) { return col[i]; };
    // trailing update of the lower triangle: rows > k, columns k < j <= i
    gprf::lane_slice(v, col, m);
    gprf::rank1_rows(A, m, k + 1, m, k + 1, [](int i) { return i + 1; }, lik, v);
    // substitution: rows > k of the running right-hand side lose L[i, k] W[k, :]
    gprf::lane_slice(v, R + k * m, k + 1);
    gprf::rank1_rows(R, m, k + 1, m, 0, [k](int) { return k + 1; }, lik, v);
    __syncthreads();
  }
  gprf::store_lower(L + off, A, m);
  gprf::store_lower(W + off, R, m);
}

}  // namespace

extern "C" int gprf_chol_inv(const float* K, float* L, float* W, int batch, int m,
                             void* stream) {
  const size_t smem = (2 * static_cast<size_t>(m) * m + m) * sizeof(float);
  return gprf::launch(chol_inv_kernel, batch, smem, stream, K, L, W, m);
}
