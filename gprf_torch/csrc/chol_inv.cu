// K1: fused Cholesky + triangular inverse, (L, W = L^-1) of SPD [B, m, m],
// and K5: the Cholesky factor L alone, which is K1 up to its store of L.
//
// K1 replaces the TPU kernel _chol_inv_kernel (gprf_tpu/ops/pallas_mvn.py),
// which runs the batch in the 128-wide lane axis and walks m sequential
// steps over a [m, m, 128] VMEM tile, twice.  K5 replaces _chol_kernel, the
// first of those walks alone, which the unary-doubling route of the
// objective runs for every unary block.  On the H100 one CTA owns one matrix
// instead (B = 100 unary blocks at the flagship: one wave over 132 SMs).
// Only the lower triangle of K is read; L and W have exact zeros above the
// diagonal.  The factor scales column j by the TPU kernel's
// d_j = rsqrt(max(a_jj, 1e-30)), so L_jj = a_jj d_j, and the inverse divides
// by the guarded 1 / (|L_jj| > 1e-30 ? L_jj : 1e-30); f32 throughout.
//
// Bound: the work is small (m^3/3 FMAs a matrix, 0.84 M at m = 136) and so
// are the bytes (half of K read, L and W written); what bounds a CTA is the
// length of its dependency chain.  The design this replaces ran m
// sequential rank-1 steps at two barriers each over K and a running
// right-hand side, ~1.5 us a step, 0.213 ms for the flagship's
// [100, 136, 136] on the H100.
//
// Design: the two phases of blocked.cuh on one buffer A of mp^2 floats,
// mp = 16 ceil(m/16), identity-padded, cropped on the stores.
//  1. The factor, K2's loop with no right-hand side: per 16-wide block
//     column, warp 0 factors the diagonal block in registers while warps
//     1-7 update the panel, then all warps solve the panel with D_k; two
//     barriers a block column.  L is then in A's lower triangle and the
//     transposes of its off-diagonal blocks above the diagonal.
//  2. L is stored.  K5 (Wout == nullptr) ends here.
//  3. The inverse in place, K3's algorithm: the diagonal blocks are
//     inverted at once, a half-warp each, from L_kk by the guarded
//     reciprocal (not from D_k: at a clamped pivot 1/d_j is not L_jj); then
//     block row i = 1 .. nblk-1, one barrier each, warp j forms
//     T_ij = sum_k L_ik W_kj with L_ik read from the transposes above the
//     diagonal, which need no panel buffer and no copy, and writes
//     W_ij = -W_ii T_ij over L_ij, dead since step 2.
//  4. W is stored.
// A and the 1 KB block D_k^T are all the shared memory: 82,944 B + 1,024 B at
// m = 136, so two CTAs share an SM up to m = 160, and m <= 240.  One CTA
// takes ~103k cycles at m = 136 on the H100: the load 6k, the factor 48k
// (the diagonal factor's 16 dependent pivots and, as k grows, its 16 k deep
// contraction on warp 0), the solves 8k, the store of L 8k, the diagonal
// inversions 4k, the block rows 21k, the store of W 8k; 0.056 ms for the
// flagship's 100 matrices.  K5 is one kernel with K1 and not a second one or
// a template: the factor sits at the 128-register cap, and the same lines
// compiled alone, or as chol_inv_kernel<false>, spill 8 bytes there.
#include "blocked.cuh"

namespace {

using gprf::kBlockThreads;
using gprf::kNb;
using gprf::round_up;

__global__ void __launch_bounds__(kBlockThreads, 2)
chol_inv_kernel(const float* __restrict__ Kin, float* __restrict__ Lout,
                float* __restrict__ Wout, int m) {
  extern __shared__ float4 smem4[];
  __shared__ __align__(16) float DT[kNb * kNb];
  float* A = reinterpret_cast<float*>(smem4);
  const int mp = round_up(m, kNb), nblk = mp / kNb;
  const size_t off = static_cast<size_t>(blockIdx.x) * m * m;

  gprf::load_lower(A, Kin + off, m, mp);
  __syncthreads();

  gprf::factor_blocks(A, nullptr, DT, mp, 0, nblk);
  gprf::store_lower_cropped(Lout, off, A, m, mp);
  if (Wout == nullptr) return;  // K5: the factor alone
  __syncthreads();  // L is read out before W lands on it

  gprf::invert_diagonal_blocks(A, mp, nblk);
  for (int i = 1; i < nblk; ++i) {
    __syncthreads();  // W_ii and block rows < i of W are final
    gprf::inverse_block_row(A, mp, i);
  }
  __syncthreads();
  gprf::store_lower_cropped(Wout, off, A, m, mp);
}

}  // namespace

extern "C" int gprf_chol_inv(const float* K, float* L, float* W, int batch, int m,
                             void* stream) {
  return gprf::launch(chol_inv_kernel, batch, gprf::smem_bytes(m, 0), stream, K, L, W, m);
}

extern "C" int gprf_cholesky(const float* K, float* L, int batch, int m, void* stream) {
  return gprf::launch(chol_inv_kernel, batch, gprf::smem_bytes(m, 0), stream, K, L,
                      static_cast<float*>(nullptr), m);
}

// CTAs of K1 and K5 resident on one SM at width m (negative: a CUDA error code)
extern "C" int gprf_chol_inv_ctas_per_sm(int m) {
  return gprf::ctas_per_sm(chol_inv_kernel, gprf::smem_bytes(m, 0));
}
