// K4: masked Gaussian log-density of padded blocks, with the backward
// pass's residuals W = L^-1 and Z = L^-1 Y instead of the factor.
//
//   ll_b = -1/2 |L^-1 Y_b|^2 - dy/2 logdet K_b - dy n_b/2 log 2 pi,  L L^T = K_b
//
// Replaces the TPU kernel _mvn_inv_kernel (gprf_tpu/ops/pallas_mvn.py), the
// pair kernel of the MVN+inverse route: with W and Z saved, the backward
// pass is products only and launches no triangular inverse (K3).
//
// Bound: m sequential steps of shared-memory row updates between block
// barriers (E = 180 pair blocks at the flagship: two waves over 132 SMs),
// O(m^2 + m dy + k m) a step.  Design: one right-looking k-loop carries the
// factorization, the dy right-hand sides, the log-determinant and the
// quadratic form, and the substitution for W, folded in as a second rank-1
// update of a running right-hand side, rides the same loop, so each step
// costs two barriers.  K, W and Y share the CTA's shared
// memory ((2 m^2 + m dy + m) floats: m <= 158 at dy = 50); L never leaves
// the SM, only ll, W (zero above the diagonal) and Z are written.
#include "common.cuh"

namespace {

constexpr float kLog2Pi = 1.8378770664093453f;
constexpr int kChunks = 6;  // columns of K and W per lane: m <= 192 (shared memory caps it at 169)

// kYChunks: columns of Y per lane, dy <= 32 kYChunks
template <int kYChunks>
__global__ void __launch_bounds__(gprf::kThreads)
mvn_inv_kernel(const float* __restrict__ K, const float* __restrict__ Y,
               const float* __restrict__ n_active, float* __restrict__ ll,
               float* __restrict__ W, float* __restrict__ Zout, int m, int dy) {
  extern __shared__ float smem[];
  __shared__ float partial[gprf::kWarps];
  float* A = smem;          // K; its trailing lower triangle is updated in place
  float* R = A + m * m;     // I, overwritten row by row by W
  float* Z = R + m * m;     // Y, overwritten by L^-1 Y
  float* col = Z + m * dy;  // scaled column k of L
  const size_t off = static_cast<size_t>(blockIdx.x) * m * m;
  const size_t yoff = static_cast<size_t>(blockIdx.x) * m * dy;
  gprf::load(A, K + off, m * m);
  gprf::load(Z, Y + yoff, m * dy);
  gprf::set_identity(R, m);
  __syncthreads();

  float logdet = 0.f;  // the same value in every thread
  for (int k = 0; k < m; ++k) {
    const float akk = A[k * m + k];
    const float d = rsqrtf(fmaxf(akk, gprf::kTiny));
    const float lkk = akk * d;
    const float winv = 1.f / (fabsf(lkk) > gprf::kTiny ? lkk : gprf::kTiny);
    logdet += logf(fmaxf(akk, gprf::kTiny));
    for (int i = k + threadIdx.x; i < m; i += blockDim.x) col[i] = A[i * m + k] * d;
    for (int c = threadIdx.x; c < dy; c += blockDim.x) Z[k * dy + c] *= d;
    for (int j = threadIdx.x; j <= k; j += blockDim.x) R[k * m + j] *= winv;
    __syncthreads();

    // column k of L lives in col only: nothing reads column k of A again
    auto lik = [&](int i) { return col[i]; };
    // trailing update of the lower triangle: rows > k, columns k < j <= i
    float v[kChunks];
    gprf::lane_slice(v, col, m);
    gprf::rank1_rows(A, m, k + 1, m, k + 1, [](int i) { return i + 1; }, lik, v);
    // forward substitution of the right-hand sides: Z[i, :] -= L[i, k] z_k
    float z[kYChunks];
    gprf::lane_slice(z, Z + k * dy, dy);
    gprf::rank1_rows(Z, dy, k + 1, m, 0, [dy](int) { return dy; }, lik, z);
    // substitution for W: rows > k of the running right-hand side lose L[i, k] W[k, :]
    gprf::lane_slice(v, R + k * m, k + 1);
    gprf::rank1_rows(R, m, k + 1, m, 0, [k](int) { return k + 1; }, lik, v);
    __syncthreads();
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float quad = 0.f;
  for (int idx = threadIdx.x; idx < m * dy; idx += blockDim.x) {
    const float zi = Z[idx];
    quad += zi * zi;
    Zout[yoff + idx] = zi;
  }
  for (int s = 16; s > 0; s >>= 1) quad += __shfl_down_sync(0xffffffffu, quad, s);
  if (lane == 0) partial[warp] = quad;
  __syncthreads();
  if (threadIdx.x == 0) {
    float q = 0.f;
    for (int w = 0; w < gprf::kWarps; ++w) q += partial[w];
    ll[blockIdx.x] = -0.5f * q - 0.5f * dy * logdet - 0.5f * dy * n_active[blockIdx.x] * kLog2Pi;
  }
  gprf::store_lower(W + off, R, m);
}

}  // namespace

extern "C" int gprf_mvn_ll_inv(const float* K, const float* Y, const float* n_active, float* ll,
                               float* W, float* Z, int batch, int m, int dy, void* stream) {
  if (m > 32 * kChunks) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      (2 * static_cast<size_t>(m) * m + static_cast<size_t>(m) * dy + m) * sizeof(float);
  if (dy <= 32) return gprf::launch(mvn_inv_kernel<1>, batch, smem, stream, K, Y, n_active, ll, W, Z, m, dy);
  if (dy <= 64) return gprf::launch(mvn_inv_kernel<2>, batch, smem, stream, K, Y, n_active, ll, W, Z, m, dy);
  if (dy <= 128) return gprf::launch(mvn_inv_kernel<4>, batch, smem, stream, K, Y, n_active, ll, W, Z, m, dy);
  if (dy <= 256) return gprf::launch(mvn_inv_kernel<8>, batch, smem, stream, K, Y, n_active, ll, W, Z, m, dy);
  return static_cast<int>(cudaErrorInvalidValue);
}
