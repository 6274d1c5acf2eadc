// K4: masked Gaussian log-density of padded blocks, with the backward
// pass's residuals W = L^-1 and Z = L^-1 Y instead of the factor.
//
//   ll_b = -1/2 |L^-1 Y_b|^2 - dy/2 logdet K_b - dy n_b/2 log 2 pi,  L L^T = K_b
//
// Replaces the TPU kernel _mvn_inv_kernel (gprf_tpu/ops/pallas_mvn.py), the
// pair kernel of the MVN+inverse route: with W and Z saved, the backward
// pass is products only and launches no triangular inverse (K3).  Only the
// lower triangle of K_b is read; W has exact zeros above the diagonal, and
// padded rows (identity in K_b, zero in Y_b) stay identity rows of W and
// zero rows of Z.  The pivots are the TPU kernel's: column j is scaled by
// d_j = rsqrt(max(a_jj, 1e-30)), logdet adds log(max(a_jj, 1e-30)), and the
// inverse divides by the guarded 1 / (|L_jj| > 1e-30 ? L_jj : 1e-30).
//
// Bound: the work is small (m^3/3 + m^2 dy/2 FMAs, 1.3 M a matrix at
// m = 136, dy = 50) and so are the bytes (half of K and Y read, W and Z
// written); what bounds a CTA is the length of its dependency chain.  The
// design this replaces ran m sequential steps at two barriers each, the
// substitution for W folded into the factor's loop as a rank-1 update of a
// second m x m buffer.
//
// Design: the two phases of blocked.cuh on K2's buffers, A of mp^2 floats
// and Z of mp x dyp (mp = 16 ceil(m/16), dyp = 4 ceil(dy/4)), cropped on the
// stores.
//  1. The factor with the right-hand sides, K2's loop: two barriers a
//     16-wide block column.  L is then in A's lower triangle, the transposes
//     of its off-diagonal blocks above the diagonal, and Z = L^-1 Y is final.
//  2. The quadratic form is summed and Z is stored; the inverse never
//     touches Z.
//  3. The inverse in place, K1's: the diagonal blocks at once from L_kk by
//     the guarded reciprocal (not from the factor's D_k: at a clamped pivot
//     1/d_j is not L_jj), then block row i = 1 .. nblk-1, one barrier each,
//     W_ij = -W_ii sum_k L_ik W_kj over L_ij, with L_ik read from the
//     transposes.  L is never stored, so no barrier separates the phases but
//     the factor's last.
//  4. ll and W are stored.
// A, Z, the 1 KB block D_k^T and 8 partial sums are all the shared memory, as
// in K2: 112,896 B dynamic at m = 136, dy = 50, so two CTAs share an SM and
// the flagship's 180 matrices run in one wave; m <= 208 at dy = 50.
#include "blocked.cuh"

namespace {

using gprf::kBlockThreads;
using gprf::kBlockWarps;
using gprf::kNb;
using gprf::round_up;

__global__ void __launch_bounds__(kBlockThreads, 2)
mvn_inv_kernel(const float* __restrict__ Kin, const float* __restrict__ Yin,
               const float* __restrict__ n_active, float* __restrict__ ll,
               float* __restrict__ Wout, float* __restrict__ Zout, int m, int dy) {
  extern __shared__ float4 smem4[];
  __shared__ __align__(16) float DT[kNb * kNb];
  __shared__ float partial[kBlockWarps];
  const int mp = round_up(m, kNb), dyp = round_up(dy, 4), nblk = mp / kNb;
  float* A = reinterpret_cast<float*>(smem4);
  float* Z = A + mp * mp;
  const size_t yoff = static_cast<size_t>(blockIdx.x) * m * dy;

  gprf::load_inputs(A, Z, Kin + static_cast<size_t>(blockIdx.x) * m * m, Yin + yoff, m, mp, dy,
                    dyp);
  __syncthreads();

  const float logdet = gprf::factor_blocks(A, Z, DT, mp, dyp, nblk);  // warp 0's

  gprf::quad_form_partial(Z, mp * dyp, partial);
  gprf::store_rows_cropped(Zout, yoff, Z, m, dy, dyp);

  gprf::invert_diagonal_blocks(A, mp, nblk);
  for (int i = 1; i < nblk; ++i) {
    __syncthreads();  // W_ii and block rows < i of W are final
    gprf::inverse_block_row(A, mp, i);
  }
  __syncthreads();  // W is whole, and the partial sums are published
  if (threadIdx.x == 0)
    ll[blockIdx.x] = gprf::mvn_log_density(partial, dy, logdet, n_active[blockIdx.x]);
  gprf::store_lower_cropped(Wout, static_cast<size_t>(blockIdx.x) * m * m, A, m, mp);
}

}  // namespace

extern "C" int gprf_mvn_ll_inv(const float* K, const float* Y, const float* n_active, float* ll,
                               float* W, float* Z, int batch, int m, int dy, void* stream) {
  return gprf::launch(mvn_inv_kernel, batch, gprf::smem_bytes(m, dy), stream, K, Y, n_active, ll,
                      W, Z, m, dy);
}

// CTAs of K4 resident on one SM at (m, dy) (negative: a CUDA error code)
extern "C" int gprf_mvn_inv_ctas_per_sm(int m, int dy) {
  return gprf::ctas_per_sm(mvn_inv_kernel, gprf::smem_bytes(m, dy));
}
