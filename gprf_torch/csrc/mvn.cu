// K2: masked Gaussian log-density of padded blocks, with the factor.
//
//   ll_b = -1/2 |L^-1 Y_b|^2 - dy/2 logdet K_b - dy n_b/2 log 2 pi,  L L^T = K_b
//
// Replaces the TPU kernel _mvn_kernel (gprf_tpu/ops/pallas_mvn.py).  Padded
// rows and columns of K_b are identity and padded rows of Y_b are zero, so
// they add nothing to the quadratic form or the log-determinant and stay
// exact identity rows of L.  Only the lower triangle of K_b is read.
//
// Bound: the work is small (m^3/6 + m^2 dy/2 FMAs, 0.88 M a matrix at
// m = 136, dy = 50) and so are the bytes (K and Y read once, L written
// once); what bounds a CTA is the length of its dependency chain.  The
// design this replaces ran m sequential rank-1 steps at two barriers each,
// 0.340 ms for the flagship's [180, 136, 136] on the H100.  This one takes
// ~88k cycles a CTA there (alone, at m = 136, dy = 50): the load 12k, the
// 9 block columns' factor-and-update phases 56k (the diagonal factor alone
// ~3.7k: 16 dependent pivots, each a shuffle, a rsqrt and an FMA), the
// solves 11k, the store 9k; ~0.070 ms for the 180 matrices.
//
// Design (the factor phase of blocked.cuh, which K1, K4 and K5 run too, here
// with the right-hand sides Z): blocks of kNb = 16, m padded with identity to
// mp = 16 ceil(m/16) and dy with zero columns to dyp = 4 ceil(dy/4), cropped
// on the store.
// Left-looking over the block columns k, two barriers each:
//  1. Warp 0 forms the diagonal block A_kk - sum_p L_kp L_kp^T (lane c holds
//     column c, the two half-warps split the contraction) and factors it in
//     registers, rows broadcast by shuffles, with the TPU kernel's pivot
//     d_j = rsqrt(max(a_jj, 1e-30)), L_jj = a_jj d_j and log(max(a_jj, 1e-30)).
//     The same steps give D_k = M^-1 for M = strict_lower(L_kk) + diag(1/d_j).
//     Meanwhile warps 1-7 form the panel blocks A_ik - sum_p L_ip L_kp^T
//     (i > k) and the block row Y_k - sum_p L_kp Z_p of the right-hand
//     sides: 16 x 16 register tiles, 2 x 4 a lane.
//  2. All warps: L_ik = A'_ik D_k^T and Z_k = D_k Y'_k, 16-deep register-tiled
//     products.  D_k and not L_kk^-1: where a pivot is clamped, 1/d_j is not
//     L_jj, and the TPU kernel scales column j by d_j.
// A (mp^2 floats) holds the lower triangle of K, overwritten by L, and in
// its upper triangle the transpose of every finished off-diagonal block of
// L, so that both operands of every contraction are rows, read as float2 and
// float4; Z (mp dyp floats) holds Y, overwritten by L^-1 Y.  At m = 136,
// dy = 50 that is 112,896 B, so two CTAs share an SM and the flagship's 180
// matrices run in one wave; m <= 208 at dy = 50.
#include "blocked.cuh"

namespace {

using gprf::kBlockThreads;
using gprf::kBlockWarps;
using gprf::kNb;
using gprf::round_up;

__global__ void __launch_bounds__(kBlockThreads, 2)
mvn_kernel(const float* __restrict__ Kin, const float* __restrict__ Yin,
           const float* __restrict__ n_active, float* __restrict__ ll,
           float* __restrict__ Lout, int m, int dy) {
  extern __shared__ float4 smem4[];
  __shared__ __align__(16) float DT[kNb * kNb];
  __shared__ float partial[kBlockWarps];
  const int mp = round_up(m, kNb), dyp = round_up(dy, 4), nblk = mp / kNb;
  float* A = reinterpret_cast<float*>(smem4);
  float* Z = A + mp * mp;
  const size_t off = static_cast<size_t>(blockIdx.x) * m * m;

  gprf::load_inputs(A, Z, Kin + off, Yin + static_cast<size_t>(blockIdx.x) * m * dy, m, mp, dy,
                    dyp);
  __syncthreads();

  const float logdet = gprf::factor_blocks(A, Z, DT, mp, dyp, nblk);  // warp 0's

  gprf::quad_form_partial(Z, mp * dyp, partial);
  __syncthreads();
  if (threadIdx.x == 0)
    ll[blockIdx.x] = gprf::mvn_log_density(partial, dy, logdet, n_active[blockIdx.x]);
  gprf::store_lower_cropped(Lout, off, A, m, mp);
}

}  // namespace

extern "C" int gprf_mvn_ll(const float* K, const float* Y, const float* n_active, float* ll,
                           float* L, int batch, int m, int dy, void* stream) {
  return gprf::launch(mvn_kernel, batch, gprf::smem_bytes(m, dy), stream, K, Y, n_active, ll, L,
                      m, dy);
}

// CTAs of K2 resident on one SM at (m, dy) (negative: a CUDA error code)
extern "C" int gprf_mvn_ctas_per_sm(int m, int dy) {
  return gprf::ctas_per_sm(mvn_kernel, gprf::smem_bytes(m, dy));
}
