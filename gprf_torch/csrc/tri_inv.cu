// K3: W = L^-1 for lower-triangular [B, m, m].
//
// Replaces the TPU kernel _tri_inv_kernel (gprf_tpu/ops/pallas_mvn.py),
// which the backward pass of K2 reaches through tri_inv_split.  Only the
// lower triangle of L is read.
//
// Bound: m sequential substitution steps of (m - k) (k + 1) FMAs, each
// followed by a block barrier; as in K1, the time goes to the warps'
// chains of shared-memory loads and stores, ~0.9 us a step at m = 136 on
// the H100, not to the barriers or the FLOPs.  Design: L and the running
// right-hand side of L W = I stay in shared memory (2 m^2 floats,
// m <= 168), one CTA per matrix (E = 180 at the flagship, two waves), and
// row k of W is finished and applied to the rows below it in the same
// step, right-looking, at two barriers a step.
#include "common.cuh"

namespace {

constexpr int kChunks = (192 + 31) / 32;  // columns per lane, m <= 192

__global__ void __launch_bounds__(gprf::kThreads)
tri_inv_kernel(const float* __restrict__ Lin, float* __restrict__ W, int m) {
  extern __shared__ float smem[];
  float* A = smem;       // L
  float* R = A + m * m;  // I, overwritten row by row by W
  const size_t off = static_cast<size_t>(blockIdx.x) * m * m;
  gprf::load(A, Lin + off, m * m);
  gprf::set_identity(R, m);
  __syncthreads();

  for (int k = 0; k < m; ++k) {
    const float lkk = A[k * m + k];
    const float winv = 1.f / (fabsf(lkk) > gprf::kTiny ? lkk : gprf::kTiny);
    for (int j = threadIdx.x; j <= k; j += blockDim.x) R[k * m + j] *= winv;
    __syncthreads();
    // rows > k of the running right-hand side lose L[i, k] W[k, :]
    float v[kChunks];
    gprf::lane_slice(v, R + k * m, k + 1);
    gprf::rank1_rows(R, m, k + 1, m, 0, [k](int) { return k + 1; },
                     [&](int i) { return A[i * m + k]; }, v);
    __syncthreads();
  }
  gprf::store_lower(W + off, R, m);
}

}  // namespace

extern "C" int gprf_tri_inv(const float* L, float* W, int batch, int m, void* stream) {
  const size_t smem = 2 * static_cast<size_t>(m) * m * sizeof(float);
  return gprf::launch(tri_inv_kernel, batch, smem, stream, L, W, m);
}

extern "C" const char* gprf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
