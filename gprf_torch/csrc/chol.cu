// K5: lower Cholesky factor L of SPD [B, m, m].
//
// Replaces the TPU kernel _chol_kernel (gprf_tpu/ops/pallas_mvn.py), which
// the unary-doubling route of the objective runs for every unary block
// (B = 100 at the flagship: one wave over 132 SMs).
//
// Bound: m sequential steps of an O(m^2) shared-memory update, each between
// block barriers, paced by the warps' chains of shared-memory loads and
// stores of their rows.  Design: a right-looking k-loop, the CTA holding
// only K and one column ((m^2 + m) floats: m <= 240), each step one
// trailing update.
#include "common.cuh"

namespace {

constexpr int kChunks = 8;  // columns per lane: m <= 256 (shared memory caps it at 240)

__global__ void __launch_bounds__(gprf::kThreads)
chol_kernel(const float* __restrict__ K, float* __restrict__ L, int m) {
  extern __shared__ float smem[];
  float* A = smem;         // K, overwritten by L in its lower triangle
  float* col = A + m * m;  // scaled column k of L
  const size_t off = static_cast<size_t>(blockIdx.x) * m * m;
  gprf::load(A, K + off, m * m);
  __syncthreads();

  for (int k = 0; k < m; ++k) {
    const float d = rsqrtf(fmaxf(A[k * m + k], gprf::kTiny));
    for (int i = k + threadIdx.x; i < m; i += blockDim.x) col[i] = A[i * m + k] * d;
    __syncthreads();

    for (int i = k + threadIdx.x; i < m; i += blockDim.x) A[i * m + k] = col[i];
    // trailing update of the lower triangle: rows > k, columns k < j <= i
    float v[kChunks];
    gprf::lane_slice(v, col, m);
    gprf::rank1_rows(A, m, k + 1, m, k + 1, [](int i) { return i + 1; },
                     [&](int i) { return col[i]; }, v);
    __syncthreads();
  }
  gprf::store_lower(L + off, A, m);
}

}  // namespace

extern "C" int gprf_cholesky(const float* K, float* L, int batch, int m, void* stream) {
  if (m > 32 * kChunks) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (static_cast<size_t>(m) * m + m) * sizeof(float);
  return gprf::launch(chol_kernel, batch, smem, stream, K, L, m);
}
