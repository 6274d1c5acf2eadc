// K2: masked Gaussian log-density of padded blocks, with the factor.
//
//   ll_b = -1/2 |L^-1 Y_b|^2 - dy/2 logdet K_b - dy n_b/2 log 2 pi,  L L^T = K_b
//
// Replaces the TPU kernel _mvn_kernel (gprf_tpu/ops/pallas_mvn.py).  Padded
// rows and columns of K_b are identity and padded rows of Y_b are zero, so
// they add nothing to the quadratic form or the log-determinant.
//
// Bound: as K1, m sequential steps of O(m^2 + m dy) shared-memory updates
// separated by block barriers, paced by the warps' shared-memory access
// chains; one CTA per pair block (E = 180 at the flagship: two waves over
// 132 SMs, since a CTA's shared memory leaves room for one per SM).
// Design: K and Y share the CTA's shared memory ((m^2 + m dy + m) floats:
// m <= 216 at dy = 50), and the forward substitution of the dy right-hand
// sides (dy <= 256), the log-determinant and the quadratic form ride the
// factorization's k-loop, so one pass over K gives ll; L is written out
// once for the backward pass.
#include "common.cuh"

namespace {

constexpr float kLog2Pi = 1.8378770664093453f;
constexpr int kChunks = 8;  // columns of K per lane: m <= 256 (shared memory caps it at 240)

// kYChunks: columns of Y per lane, dy <= 32 kYChunks
template <int kYChunks>
__global__ void __launch_bounds__(gprf::kThreads)
mvn_kernel(const float* __restrict__ K, const float* __restrict__ Y,
           const float* __restrict__ n_active, float* __restrict__ ll,
           float* __restrict__ L, int m, int dy) {
  extern __shared__ float smem[];
  __shared__ float partial[gprf::kWarps];
  float* A = smem;          // K, overwritten by L in its lower triangle
  float* Z = A + m * m;     // Y, overwritten by L^-1 Y
  float* col = Z + m * dy;  // scaled column k of L
  const size_t off = static_cast<size_t>(blockIdx.x) * m * m;
  gprf::load(A, K + off, m * m);
  gprf::load(Z, Y + static_cast<size_t>(blockIdx.x) * m * dy, m * dy);
  __syncthreads();

  float logdet = 0.f;  // the same value in every thread
  for (int k = 0; k < m; ++k) {
    const float akk = A[k * m + k];
    const float d = rsqrtf(fmaxf(akk, gprf::kTiny));
    logdet += logf(fmaxf(akk, gprf::kTiny));
    for (int i = k + threadIdx.x; i < m; i += blockDim.x) col[i] = A[i * m + k] * d;
    for (int c = threadIdx.x; c < dy; c += blockDim.x) Z[k * dy + c] *= d;
    __syncthreads();

    for (int i = k + threadIdx.x; i < m; i += blockDim.x) A[i * m + k] = col[i];
    auto lik = [&](int i) { return col[i]; };
    // trailing update of the lower triangle: rows > k, columns k < j <= i
    float v[kChunks];
    gprf::lane_slice(v, col, m);
    gprf::rank1_rows(A, m, k + 1, m, k + 1, [](int i) { return i + 1; }, lik, v);
    // forward substitution of the right-hand sides: Z[i, :] -= L[i, k] z_k
    float z[kYChunks];
    gprf::lane_slice(z, Z + k * dy, dy);
    gprf::rank1_rows(Z, dy, k + 1, m, 0, [dy](int) { return dy; }, lik, z);
    __syncthreads();
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float quad = 0.f;
  for (int idx = threadIdx.x; idx < m * dy; idx += blockDim.x) quad += Z[idx] * Z[idx];
  for (int s = 16; s > 0; s >>= 1) quad += __shfl_down_sync(0xffffffffu, quad, s);
  if (lane == 0) partial[warp] = quad;
  __syncthreads();
  if (threadIdx.x == 0) {
    float q = 0.f;
    for (int w = 0; w < gprf::kWarps; ++w) q += partial[w];
    ll[blockIdx.x] = -0.5f * q - 0.5f * dy * logdet - 0.5f * dy * n_active[blockIdx.x] * kLog2Pi;
  }
  gprf::store_lower(L + off, A, m);
}

}  // namespace

extern "C" int gprf_mvn_ll(const float* K, const float* Y, const float* n_active,
                           float* ll, float* L, int batch, int m, int dy, void* stream) {
  const size_t smem = (static_cast<size_t>(m) * m + static_cast<size_t>(m) * dy + m) * sizeof(float);
  if (dy <= 32) return gprf::launch(mvn_kernel<1>, batch, smem, stream, K, Y, n_active, ll, L, m, dy);
  if (dy <= 64) return gprf::launch(mvn_kernel<2>, batch, smem, stream, K, Y, n_active, ll, L, m, dy);
  if (dy <= 128) return gprf::launch(mvn_kernel<4>, batch, smem, stream, K, Y, n_active, ll, L, m, dy);
  if (dy <= 256) return gprf::launch(mvn_kernel<8>, batch, smem, stream, K, Y, n_active, ll, L, m, dy);
  return static_cast<int>(cudaErrorInvalidValue);
}
