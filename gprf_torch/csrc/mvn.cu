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
// Design: blocks of kNb = 16, m padded with identity to mp = 16 ceil(m/16)
// and dy with zero columns to dyp = 4 ceil(dy/4), cropped on the store.
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
#include "common.cuh"

namespace {

using gprf::cp_async4;
using gprf::cp_async_commit;
using gprf::cp_async_wait_all;
using gprf::fma_row;

constexpr float kLog2Pi = 1.8378770664093453f;
constexpr int kNb = 16;
constexpr int kMvnThreads = 256;
constexpr int kMvnWarps = kMvnThreads / 32;

__host__ __device__ constexpr int round_up(int n, int to) { return (n + to - 1) / to * to; }

size_t smem_bytes(int m, int dy) {
  const size_t mp = round_up(m, kNb), dyp = round_up(dy, 4);
  return (mp * mp + mp * dyp) * sizeof(float);
}

// dst[0:n) = src[0:valid) then zeros, by 4-byte cp.async; one warp
__device__ __forceinline__ void copy_row(float* dst, const float* src, int valid, int n) {
  for (int c = threadIdx.x & 31; c < n; c += 32)
    cp_async4(dst + c, src + (c < valid ? c : 0), c < valid);
}

// The lower triangle of K (identity past m) into A and Y (zero past m, dy)
// into Z; a warp a row.  A's upper triangle is not written (nor read
// before it is).
__device__ __forceinline__ void load_inputs(float* A, float* Z, const float* K, const float* Y,
                                            int m, int mp, int dy, int dyp) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < mp; r += kMvnWarps) {
    if (r < m) {
      copy_row(A + r * mp, K + static_cast<size_t>(r) * m, r + 1, r + 1);
    } else {
      for (int c = lane; c <= r; c += 32) A[r * mp + c] = c == r ? 1.f : 0.f;
    }
    copy_row(Z + r * dyp, Y + static_cast<size_t>(min(r, m - 1)) * dy, r < m ? dy : 0, dyp);
  }
  cp_async_commit();
  cp_async_wait_all();
}

// Warp 0: the diagonal block at offset o, updated by the finished columns
// left of it and factored in registers.  Writes L_kk to A's lower triangle
// and DT = D_k^T; returns logdet plus this block's share.
__device__ __forceinline__ float factor_diagonal(float* A, float* DT, int mp, int o,
                                                 float logdet) {
  const int lane = threadIdx.x & 31, c = lane & 15, h = lane >> 4;
  float a[kNb];
#pragma unroll
  for (int r = 0; r < kNb; ++r) a[r] = 0.f;
  // row p of the upper triangle holds L[o + r, p] at A[p * mp + o + r]
#pragma unroll 2
  for (int p = h; p < o; p += 2) {
    const float* Up = A + p * mp + o;
    const float u = Up[c];
#pragma unroll
    for (int r4 = 0; r4 < kNb; r4 += 4) {
      const float4 v = *reinterpret_cast<const float4*>(Up + r4);
      a[r4] = fmaf(v.x, u, a[r4]);
      a[r4 + 1] = fmaf(v.y, u, a[r4 + 1]);
      a[r4 + 2] = fmaf(v.z, u, a[r4 + 2]);
      a[r4 + 3] = fmaf(v.w, u, a[r4 + 3]);
    }
  }
  // column c of the symmetric block, from its lower triangle
#pragma unroll
  for (int r = 0; r < kNb; ++r) {
    const float s = a[r] + __shfl_xor_sync(0xffffffffu, a[r], 16);
    a[r] = A[(o + max(r, c)) * mp + o + min(r, c)] - s;
  }
  // Step j: lane c > j holds a[j] = A[j, c] = A[c, j], so L[c, j] = a[j] d;
  // L[r, j] comes from lane j.  w is column c of D_k, by forward substitution.
  float w[kNb];
#pragma unroll
  for (int r = 0; r < kNb; ++r) w[r] = 0.f;
  float mypiv = 1.f;  // lane c's: pivot c
#pragma unroll
  for (int j = 0; j < kNb; ++j) {
    const float piv = fmaxf(__shfl_sync(0xffffffffu, a[j], j), gprf::kTiny);
    const float d = piv == 1.f ? 1.f : rsqrtf(piv);  // exact at 1: padded rows stay identity
    if (c == j) mypiv = piv;
    const float lcj = a[j] * d;
    if (c == j) w[j] = 1.f;  // column c of the identity, entered late
    w[j] *= d;
#pragma unroll
    for (int r = j + 1; r < kNb; ++r) {
      const float x = __shfl_sync(0xffffffffu, a[r], j) * d;  // L[r, j]
      a[r] = c == j ? x : (c > j ? fmaf(-x, lcj, a[r]) : a[r]);
      w[r] = fmaf(-x, w[j], w[r]);
    }
    if (c == j) a[j] = lcj;
  }
  // the 16 logs at once, off the chain of pivots
  float lg = logf(mypiv);
#pragma unroll
  for (int s = 8; s > 0; s >>= 1) lg += __shfl_xor_sync(0xffffffffu, lg, s);
  logdet += lg;
  if (h == 0) {
#pragma unroll
    for (int r = 0; r < kNb; ++r)
      if (r >= c) A[(o + r) * mp + o + c] = a[r];
#pragma unroll
    for (int r4 = 0; r4 < kNb; r4 += 4)
      *reinterpret_cast<float4*>(DT + c * kNb + r4) =
          make_float4(w[r4], w[r4 + 1], w[r4 + 2], w[r4 + 3]);
  }
  return logdet;
}

// Tiles of block column k: first the panel blocks (i, k), i > k, then the
// 16-column tiles of Z's block row k.
__device__ __forceinline__ int tile_count(int k, int nblk, int dyp) {
  return nblk - 1 - k + (dyp + kNb - 1) / kNb;
}

// Warps 1..: tile t of block column k (offset o) loses the contribution of
// the finished columns left of it, in place.  Lane (rp, q) owns rows
// 2 rp, 2 rp + 1 and columns 4 q .. 4 q + 3 of the tile.
__device__ __forceinline__ void update_tile(float* A, float* Z, int mp, int dyp, int k,
                                            int nblk, int t) {
  const int lane = threadIdx.x & 31, rp = lane >> 2, q = lane & 3;
  const int o = kNb * k;
  float acc[2][4] = {};
  float* T;
  int ld;
  if (t < nblk - 1 - k) {
    const int ri = o + kNb * (t + 1);
#pragma unroll 4
    for (int p = 0; p < o; ++p) {
      const float2 a = *reinterpret_cast<const float2*>(A + p * mp + ri + 2 * rp);
      const float4 b = *reinterpret_cast<const float4*>(A + p * mp + o + 4 * q);
      fma_row(acc[0], a.x, b);
      fma_row(acc[1], a.y, b);
    }
    T = A + (ri + 2 * rp) * mp + o + 4 * q;
    ld = mp;
  } else {
    const int col = kNb * (t - (nblk - 1 - k)) + 4 * q;
    if (col >= dyp) return;
#pragma unroll 4
    for (int p = 0; p < o; ++p) {
      const float2 a = *reinterpret_cast<const float2*>(A + p * mp + o + 2 * rp);
      const float4 b = *reinterpret_cast<const float4*>(Z + p * dyp + col);
      fma_row(acc[0], a.x, b);
      fma_row(acc[1], a.y, b);
    }
    T = Z + (o + 2 * rp) * dyp + col;
    ld = dyp;
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    float4* Te = reinterpret_cast<float4*>(T + e * ld);
    const float4 v = *Te;
    *Te = make_float4(v.x - acc[e][0], v.y - acc[e][1], v.z - acc[e][2], v.w - acc[e][3]);
  }
}

// All warps: tile t of block column k from D_k: a panel block becomes
// L_ik = A'_ik D_k^T (and its transpose goes to the upper triangle), a tile
// of Z becomes D_k Y'_k.
__device__ __forceinline__ void solve_tile(float* A, float* Z, const float* DT, int mp, int dyp,
                                           int k, int nblk, int t) {
  const int lane = threadIdx.x & 31, rp = lane >> 2, q = lane & 3;
  const int o = kNb * k;
  float out[2][4] = {};
  if (t < nblk - 1 - k) {
    const int ri = o + kNb * (t + 1);
    float* Ti = A + (ri + 2 * rp) * mp + o;
#pragma unroll
    for (int s4 = 0; s4 < kNb; s4 += 4) {
      const float4 a0 = *reinterpret_cast<const float4*>(Ti + s4);
      const float4 a1 = *reinterpret_cast<const float4*>(Ti + mp + s4);
      const float x0[4] = {a0.x, a0.y, a0.z, a0.w}, x1[4] = {a1.x, a1.y, a1.z, a1.w};
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const float4 b = *reinterpret_cast<const float4*>(DT + (s4 + s) * kNb + 4 * q);
        fma_row(out[0], x0[s], b);
        fma_row(out[1], x1[s], b);
      }
    }
    __syncwarp();
#pragma unroll
    for (int e = 0; e < 2; ++e)
      *reinterpret_cast<float4*>(Ti + e * mp + 4 * q) =
          make_float4(out[e][0], out[e][1], out[e][2], out[e][3]);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc)
      *reinterpret_cast<float2*>(A + (o + 4 * q + cc) * mp + ri + 2 * rp) =
          make_float2(out[0][cc], out[1][cc]);
  } else {
    const int col = kNb * (t - (nblk - 1 - k)) + 4 * q;
    const bool valid = col < dyp;
    float* Tz = Z + o * dyp + col;
    if (valid) {
#pragma unroll
      for (int s = 0; s < kNb; ++s) {
        const float2 a = *reinterpret_cast<const float2*>(DT + s * kNb + 2 * rp);
        const float4 b = *reinterpret_cast<const float4*>(Tz + s * dyp);
        fma_row(out[0], a.x, b);
        fma_row(out[1], a.y, b);
      }
    }
    __syncwarp();
    if (valid) {
#pragma unroll
      for (int e = 0; e < 2; ++e)
        *reinterpret_cast<float4*>(Tz + (2 * rp + e) * dyp) =
            make_float4(out[e][0], out[e][1], out[e][2], out[e][3]);
    }
  }
}

__global__ void __launch_bounds__(kMvnThreads, 2)
mvn_kernel(const float* __restrict__ Kin, const float* __restrict__ Yin,
           const float* __restrict__ n_active, float* __restrict__ ll,
           float* __restrict__ Lout, int m, int dy) {
  extern __shared__ float4 smem4[];
  __shared__ __align__(16) float DT[kNb * kNb];
  __shared__ float partial[kMvnWarps];
  const int mp = round_up(m, kNb), dyp = round_up(dy, 4), nblk = mp / kNb;
  float* A = reinterpret_cast<float*>(smem4);
  float* Z = A + mp * mp;
  const size_t off = static_cast<size_t>(blockIdx.x) * m * m;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  load_inputs(A, Z, Kin + off, Yin + static_cast<size_t>(blockIdx.x) * m * dy, m, mp, dy, dyp);
  __syncthreads();

  float logdet = 0.f;  // warp 0's
  for (int k = 0; k < nblk; ++k) {
    const int tiles = tile_count(k, nblk, dyp);
    if (warp == 0)
      logdet = factor_diagonal(A, DT, mp, kNb * k, logdet);
    else if (k > 0)
      for (int t = warp - 1; t < tiles; t += kMvnWarps - 1) update_tile(A, Z, mp, dyp, k, nblk, t);
    __syncthreads();
    for (int t = warp; t < tiles; t += kMvnWarps) solve_tile(A, Z, DT, mp, dyp, k, nblk, t);
    __syncthreads();
  }

  float quad = 0.f;
  for (int idx = threadIdx.x; idx < mp * dyp; idx += kMvnThreads) quad += Z[idx] * Z[idx];
  for (int s = 16; s > 0; s >>= 1) quad += __shfl_down_sync(0xffffffffu, quad, s);
  if (lane == 0) partial[warp] = quad;
  __syncthreads();
  if (threadIdx.x == 0) {
    float q = 0.f;
    for (int w = 0; w < kMvnWarps; ++w) q += partial[w];
    ll[blockIdx.x] = -0.5f * q - 0.5f * dy * logdet - 0.5f * dy * n_active[blockIdx.x] * kLog2Pi;
  }
  float* L = Lout + off;
  for (int r = warp; r < m; r += kMvnWarps) {
    float* Lr = L + static_cast<size_t>(r) * m;
    for (int c0 = lane; c0 < m; c0 += 128) {
      float v[4];  // four loads in flight before the stores
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = c0 + 32 * u <= r ? A[r * mp + c0 + 32 * u] : 0.f;
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (c0 + 32 * u < m) Lr[c0 + 32 * u] = v[u];
    }
  }
}

cudaError_t configure(size_t smem) {
  cudaError_t e = cudaFuncSetAttribute(
      mvn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  // the whole of the SM's unified memory as shared memory, so that two CTAs fit
  return cudaFuncSetAttribute(mvn_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

}  // namespace

extern "C" int gprf_mvn_ll(const float* K, const float* Y, const float* n_active, float* ll,
                           float* L, int batch, int m, int dy, void* stream) {
  const size_t smem = smem_bytes(m, dy);
  cudaError_t e = configure(smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (batch == 0) return 0;
  mvn_kernel<<<batch, kMvnThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      K, Y, n_active, ll, L, m, dy);
  return static_cast<int>(cudaGetLastError());
}

// CTAs of K2 resident on one SM at (m, dy) (negative: a CUDA error code)
extern "C" int gprf_mvn_ctas_per_sm(int m, int dy) {
  const size_t smem = smem_bytes(m, dy);
  cudaError_t e = configure(smem);
  int n = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, mvn_kernel, kMvnThreads, smem);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}
