// K1: fused Cholesky + triangular inverse, (L, W = L^-1) of SPD [B, m, m].
//
// Replaces the TPU kernel _chol_inv_kernel (gprf_tpu/ops/pallas_mvn.py),
// which runs the batch in the 128-wide lane axis and walks m sequential
// steps over a [m, m, 128] VMEM tile, twice.  On the H100 one CTA owns one
// matrix instead (B = 100 unary blocks at the flagship: one wave over 132
// SMs).  Only the lower triangle of K is read; L and W have exact zeros
// above the diagonal.  The factor scales column j by the TPU kernel's
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
//  2. L is stored.
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
// flagship's 100 matrices.
#include "blocked.cuh"

namespace {

using gprf::kBlockThreads;
using gprf::kBlockWarps;
using gprf::kNb;
using gprf::round_up;

size_t smem_bytes(int m) {
  const size_t mp = round_up(m, kNb);
  return mp * mp * sizeof(float);
}

__global__ void __launch_bounds__(kBlockThreads, 2)
chol_inv_kernel(const float* __restrict__ Kin, float* __restrict__ Lout,
                float* __restrict__ Wout, int m) {
  extern __shared__ float4 smem4[];
  __shared__ __align__(16) float DT[kNb * kNb];
  float* A = reinterpret_cast<float*>(smem4);
  const int mp = round_up(m, kNb), nblk = mp / kNb;
  const size_t off = static_cast<size_t>(blockIdx.x) * m * m;
  const int warp = threadIdx.x >> 5;

  for (int r = warp; r < mp; r += kBlockWarps) gprf::load_lower_row(A, Kin + off, r, m, mp);
  gprf::cp_async_commit();
  gprf::cp_async_wait_all();
  __syncthreads();

  for (int k = 0; k < nblk; ++k) {
    const int tiles = gprf::tile_count(k, nblk, 0);
    if (warp == 0)
      gprf::factor_diagonal(A, DT, mp, kNb * k, 0.f);
    else if (k > 0)
      for (int t = warp - 1; t < tiles; t += kBlockWarps - 1)
        gprf::update_tile(A, nullptr, mp, 0, k, nblk, t);
    __syncthreads();
    for (int t = warp; t < tiles; t += kBlockWarps)
      gprf::solve_tile(A, nullptr, DT, mp, 0, k, nblk, t);
    __syncthreads();
  }
  gprf::store_lower_cropped(Lout, off, A, m, mp);
  __syncthreads();  // L is read out before W lands on it

  gprf::invert_diagonal_blocks(A, mp, nblk);
  for (int i = 1; i < nblk; ++i) {
    __syncthreads();  // W_ii and block rows < i of W are final
    gprf::inverse_block_row(A, mp, i);
  }
  __syncthreads();
  gprf::store_lower_cropped(Wout, off, A, m, mp);
}

cudaError_t configure(size_t smem) {
  cudaError_t e = cudaFuncSetAttribute(
      chol_inv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  // the whole of the SM's unified memory as shared memory, so that two CTAs fit
  return cudaFuncSetAttribute(chol_inv_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

}  // namespace

extern "C" int gprf_chol_inv(const float* K, float* L, float* W, int batch, int m,
                             void* stream) {
  const size_t smem = smem_bytes(m);
  cudaError_t e = configure(smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (batch == 0) return 0;
  chol_inv_kernel<<<batch, kBlockThreads, smem, static_cast<cudaStream_t>(stream)>>>(K, L, W, m);
  return static_cast<int>(cudaGetLastError());
}

// CTAs of K1 resident on one SM at width m (negative: a CUDA error code)
extern "C" int gprf_chol_inv_ctas_per_sm(int m) {
  const size_t smem = smem_bytes(m);
  cudaError_t e = configure(smem);
  int n = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, chol_inv_kernel, kBlockThreads, smem);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}
