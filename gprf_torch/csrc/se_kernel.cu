// The squared-exponential kernel matrices of the Schur objective, from the
// points, and their gradient back to the points in one pass over G.
//
//   pair:  K[n, a, b] = mi[n, a] mj[n, b] sv exp(-sum_d ((xi[n, a, d] - xj[n, b, d]) / l_d)^2)
//   block: the same with xj = xi and mj = mi, plus nv on the active
//          diagonal and 1 on the padded one: pad_kernel_matrix(K + nv I, mask)
//
// It replaces no TPU kernel.  The JAX package composes these matrices from
// broadcast operations (kernels/distances.py, kernels/covfn.py,
// linalg/masked.py) and XLA fuses the chain (scale, difference, square, sum,
// exp, scale, mask, pad) into one loop; eager PyTorch writes each step as a
// whole [N, m, m] (the difference [N, m, m, dx]) tensor and autograd keeps
// them for the backward.  This restores that fusion on the H100.
//
// Bound: bytes.  The forward does dx + ~12 flops an entry and writes 4 bytes,
// the backward ~2 dx + ~16 flops and reads 4; at [342, 896, 896] each moves
// 1.10 GB, 0.33 ms at 3.35 TB/s, while the flops need ~0.05 ms.
//
// Design: a CTA of 8 warps owns a tile of 64 rows x 128 columns of one
// matrix.  Lane l owns columns 4l .. 4l + 3 of the tile and warp w rows
// 8w .. 8w + 7, so each warp reads or writes one 512-byte row segment at a
// time, as float4 where m is a multiple of 4.  The tile's row points, scaled
// by 1/l as sq_euclidean scales them (a division, then the difference), and
// their masks sit in shared memory; each lane keeps its four column points
// in registers.  Each entry is computed where it is written, so no
// intermediate tensor exists and the backward saves only the points, masks
// and hyperparameters.
//
// Backward: w_ab = sv G_ab e_ab mi_a mj_b (e = exp(-r2)), recomputed from
// the points, a lane's loads of G for all 8 of its warp's rows issued
// before any is used.  dXi_a = -2 sum_b w_ab (u_a - v_b) / l and dXj_b =
// +2 sum_a w_ab (u_a - v_b) / l, both summed in full, since the splits of
// the Schur objective hand back a G that is not symmetric.  A row's sum over the
// tile's columns is a warp's shuffle reduction; a column's sum over the
// tile's rows goes through shared memory across the 8 warps.  Each CTA
// writes its partial sums (per column tile for rows, per row tile for
// columns) and sum_ab G_ab e_ab mi_a mj_b (for d sv); the wrapper sums the
// partials in a second pass, so the result does not depend on the order in
// which CTAs run.  The lengthscales' and the noise variance's gradients
// follow from these and the points (gprf_torch/ops/se_kernel.py).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileRows = 64;
constexpr int kRowsPerWarp = kTileRows / kWarps;
constexpr int kTileCols = 128;  // 32 lanes x 4 columns
constexpr int kMaxDx = 15;      // wider inputs take the quadratic expansion, not this kernel

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// The tile of a CTA: matrix n, row tile rt, column tile ct.
struct Tile {
  int n, rt, ct, row0, col0;
  __device__ Tile(int m) {
    const int nct = cdiv(m, kTileCols), nrt = cdiv(m, kTileRows);
    ct = blockIdx.x % nct;
    rt = (blockIdx.x / nct) % nrt;
    n = blockIdx.x / (nct * nrt);
    row0 = rt * kTileRows;
    col0 = ct * kTileCols;
  }
};

// l_d of replica r, for k = 1 (one lengthscale) or k = dx lengthscales
__device__ __forceinline__ float lscale(const float* ls, int r, int k, int d) {
  return ls[r * k + (k == 1 ? 0 : d)];
}

// The tile's row points scaled by 1/l and their masks, into shared memory
// (zeros past m).
__device__ __forceinline__ void stage_rows(float* su, float* smi, const float* Xi,
                                           const float* mi, const float* ls, const Tile& t,
                                           int r, int m, int dx, int k) {
  for (int i = threadIdx.x; i < kTileRows * dx; i += kThreads) {
    const int row = t.row0 + i / dx, d = i % dx;
    su[i] = row < m ? Xi[(static_cast<size_t>(t.n) * m + row) * dx + d] / lscale(ls, r, k, d)
                    : 0.f;
  }
  for (int i = threadIdx.x; i < kTileRows; i += kThreads) {
    const int row = t.row0 + i;
    smi[i] = row < m ? mi[static_cast<size_t>(t.n) * m + row] : 0.f;
  }
}

// This lane's four column points scaled by 1/l and their masks (zeros past m).
template <int DX>
__device__ __forceinline__ void load_cols(float (&v)[4][DX ? DX : kMaxDx], float (&mcol)[4],
                                          const float* Xj, const float* mj, const float* ls,
                                          int n, int c0, int r, int m, int dx, int k) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = c0 + j;
    mcol[j] = c < m ? mj[static_cast<size_t>(n) * m + c] : 0.f;
#pragma unroll
    for (int d = 0; d < (DX ? DX : kMaxDx); ++d)
      if (d < dx)
        v[j][d] = c < m ? Xj[(static_cast<size_t>(n) * m + c) * dx + d] / lscale(ls, r, k, d)
                        : 0.f;
  }
}

// r2 = sum_d (u_d - v_d)^2, in the order and rounding of sq_euclidean's
// broadcast form (the products, then their sum from 0; no fused multiply-add)
template <int DX>
__device__ __forceinline__ float sq_dist(const float* u, const float* v, int dx) {
  float r2 = 0.f;
#pragma unroll
  for (int d = 0; d < (DX ? DX : kMaxDx); ++d)
    if (d < dx) {
      const float diff = __fsub_rn(u[d], v[d]);
      r2 = __fadd_rn(r2, __fmul_rn(diff, diff));
    }
  return r2;
}

template <int DX>
__global__ void __launch_bounds__(kThreads)
se_kernel_fwd(const float* __restrict__ Xi, const float* __restrict__ Xj,
              const float* __restrict__ mi, const float* __restrict__ mj,
              const float* __restrict__ sv, const float* __restrict__ ls,
              const float* __restrict__ nv, float* __restrict__ K, int per_replica, int m,
              int dx, int k) {
  constexpr int D = DX ? DX : kMaxDx;
  __shared__ float su[kTileRows * D];
  __shared__ float smi[kTileRows];
  const Tile t(m);
  const int r = t.n / per_replica;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = t.col0 + 4 * lane;
  stage_rows(su, smi, Xi, mi, ls, t, r, m, dx, k);
  float v[4][D], mcol[4];
  load_cols<DX>(v, mcol, Xj, mj, ls, t.n, c0, r, m, dx, k);
  const float s = sv[r];
  const bool block = nv != nullptr;
  const float noise = block ? nv[r] : 0.f;
  const bool vec = (m & 3) == 0;
  __syncthreads();
  if (c0 >= m) return;

#pragma unroll 2
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int lr = warp * kRowsPerWarp + i, row = t.row0 + lr;
    if (row >= m) break;
    const float* u = su + lr * dx;
    const float ma = smi[lr];
    float out[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float val = s * expf(-sq_dist<DX>(u, v[j], dx));
      const bool diag = block && row == c0 + j;
      if (diag) val = val + noise;
      val = val * (ma * mcol[j]);
      if (diag) val = val + (1.f - ma);
      out[j] = val;
    }
    float* dst = K + (static_cast<size_t>(t.n) * m + row) * m + c0;
    if (vec) {
      *reinterpret_cast<float4*>(dst) = make_float4(out[0], out[1], out[2], out[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c0 + j < m) dst[j] = out[j];
    }
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int DX>
__global__ void __launch_bounds__(kThreads)
se_kernel_bwd(const float* __restrict__ G, const float* __restrict__ Xi,
              const float* __restrict__ Xj, const float* __restrict__ mi,
              const float* __restrict__ mj, const float* __restrict__ sv,
              const float* __restrict__ ls, float* __restrict__ dxi_part,
              float* __restrict__ dxj_part, float* __restrict__ dsv_part, int per_replica,
              int m, int dx, int k) {
  constexpr int D = DX ? DX : kMaxDx;
  __shared__ float su[kTileRows * D];
  __shared__ float smi[kTileRows];
  __shared__ float red[kWarps][kTileCols];
  const Tile t(m);
  const int nct = cdiv(m, kTileCols), nrt = cdiv(m, kTileRows);
  const int r = t.n / per_replica;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = t.col0 + 4 * lane;
  stage_rows(su, smi, Xi, mi, ls, t, r, m, dx, k);
  float v[4][D], mcol[4];
  load_cols<DX>(v, mcol, Xj, mj, ls, t.n, c0, r, m, dx, k);
  const float s = sv[r];
  const bool vec = (m & 3) == 0;
  float acc[4][D];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int d = 0; d < D; ++d) acc[j][d] = 0.f;
  float wsum = 0.f;
  __syncthreads();

  // this lane's four entries of each of the warp's rows, all loads in
  // flight at once (zeros past m)
  float g[kRowsPerWarp][4];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int row = t.row0 + warp * kRowsPerWarp + i;
    const float* src = G + (static_cast<size_t>(t.n) * m + row) * m + c0;
#pragma unroll
    for (int j = 0; j < 4; ++j) g[i][j] = 0.f;
    if (row < m && c0 < m) {
      if (vec) {
        const float4 g4 = *reinterpret_cast<const float4*>(src);
        g[i][0] = g4.x, g[i][1] = g4.y, g[i][2] = g4.z, g[i][3] = g4.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c0 + j < m) g[i][j] = src[j];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int lr = warp * kRowsPerWarp + i, row = t.row0 + lr;
    if (row >= m) break;  // warp-uniform
    const float* u = su + lr * dx;
    const float ma = smi[lr];
    float racc[D];
#pragma unroll
    for (int d = 0; d < D; ++d) racc[d] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float w0 = g[i][j] * expf(-sq_dist<DX>(u, v[j], dx)) * (ma * mcol[j]);
      wsum += w0;
      const float w = s * w0;
#pragma unroll
      for (int d = 0; d < D; ++d)
        if (d < dx) {
          const float wd = w * (u[d] - v[j][d]);
          acc[j][d] += wd;
          racc[d] += wd;
        }
    }
#pragma unroll
    for (int d = 0; d < D; ++d)
      if (d < dx) {
        const float tot = warp_sum(racc[d]);
        if (lane == 0)
          dxi_part[((static_cast<size_t>(t.n) * nct + t.ct) * m + row) * dx + d] =
              -2.f * tot / lscale(ls, r, k, d);
      }
  }

  // the columns' sums over the tile's rows, one coordinate at a time
  for (int d = 0; d < dx; ++d) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float x = 0.f;
#pragma unroll
      for (int dd = 0; dd < D; ++dd)
        if (dd == d) x = acc[j][dd];
      red[warp][4 * lane + j] = x;
    }
    __syncthreads();
    if (threadIdx.x < kTileCols) {
      const int col = t.col0 + threadIdx.x;
      float tot = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) tot += red[w][threadIdx.x];
      if (col < m)
        dxj_part[((static_cast<size_t>(t.n) * nrt + t.rt) * m + col) * dx + d] =
            2.f * tot / lscale(ls, r, k, d);
    }
    __syncthreads();
  }
  wsum = warp_sum(wsum);
  if (lane == 0) red[warp][0] = wsum;
  __syncthreads();
  if (threadIdx.x == 0) {
    float tot = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) tot += red[w][0];
    dsv_part[(static_cast<size_t>(t.n) * nrt + t.rt) * nct + t.ct] = tot;
  }
}

// dx = 2, the dimension of every configuration that reaches the kernel,
// unrolled; any other dx < 16 takes the generic instantiation (DX = 0).
template <template <int> class Launch, typename... Args>
int dispatch_dx(int dx, Args... args) {
  return dx == 2 ? Launch<2>::run(args...) : Launch<0>::run(args...);
}

template <int DX>
struct Fwd {
  static int run(const float* Xi, const float* Xj, const float* mi, const float* mj,
                 const float* sv, const float* ls, const float* nv, float* K, int batch,
                 int per_replica, int m, int dx, int k, cudaStream_t stream) {
    const int grid = batch * cdiv(m, kTileRows) * cdiv(m, kTileCols);
    se_kernel_fwd<DX><<<grid, kThreads, 0, stream>>>(Xi, Xj, mi, mj, sv, ls, nv, K,
                                                     per_replica, m, dx, k);
    return static_cast<int>(cudaGetLastError());
  }
};

template <int DX>
struct Bwd {
  static int run(const float* G, const float* Xi, const float* Xj, const float* mi,
                 const float* mj, const float* sv, const float* ls, float* dxi_part,
                 float* dxj_part, float* dsv_part, int batch, int per_replica, int m, int dx,
                 int k, cudaStream_t stream) {
    const int grid = batch * cdiv(m, kTileRows) * cdiv(m, kTileCols);
    se_kernel_bwd<DX><<<grid, kThreads, 0, stream>>>(G, Xi, Xj, mi, mj, sv, ls, dxi_part,
                                                     dxj_part, dsv_part, per_replica, m, dx,
                                                     k);
    return static_cast<int>(cudaGetLastError());
  }
};

}  // namespace

// K [batch, m, m] from the points Xi, Xj [batch, m, dx] and masks mi, mj
// [batch, m]; matrix n is replica n / per_replica's, whose hyperparameters
// are sv[r], ls[r k .. r k + k) and, in block mode (nv != nullptr), nv[r].
// Returns the launch status (a cudaError_t; 0: launched, or nothing to do;
// cudaErrorInvalidValue: dx or k out of range).
extern "C" int gprf_se_kernel(const float* Xi, const float* Xj, const float* mi, const float* mj,
                              const float* sv, const float* ls, const float* nv, float* K,
                              int batch, int per_replica, int m, int dx, int k, void* stream) {
  if (dx < 1 || dx > kMaxDx || (k != 1 && k != dx)) return cudaErrorInvalidValue;
  if (batch == 0 || m == 0) return 0;
  return dispatch_dx<Fwd>(dx, Xi, Xj, mi, mj, sv, ls, nv, K, batch, per_replica, m, dx, k,
                          static_cast<cudaStream_t>(stream));
}

// The partial sums of the backward under the cotangent G [batch, m, m]:
// dxi_part [batch, ceil(m / 128), m, dx] (row points, per column tile),
// dxj_part [batch, ceil(m / 64), m, dx] (column points, per row tile) and
// dsv_part [batch, ceil(m / 64) ceil(m / 128)] (sum G e mi mj, per tile).
extern "C" int gprf_se_kernel_bwd(const float* G, const float* Xi, const float* Xj,
                                  const float* mi, const float* mj, const float* sv,
                                  const float* ls, float* dxi_part, float* dxj_part,
                                  float* dsv_part, int batch, int per_replica, int m, int dx,
                                  int k, void* stream) {
  if (dx < 1 || dx > kMaxDx || (k != 1 && k != dx)) return cudaErrorInvalidValue;
  if (batch == 0 || m == 0) return 0;
  return dispatch_dx<Bwd>(dx, G, Xi, Xj, mi, mj, sv, ls, dxi_part, dxj_part, dsv_part, batch,
                          per_replica, m, dx, k, static_cast<cudaStream_t>(stream));
}
