// The device phases of the blocked kernels: K1 (the factor, then the inverse)
// and K5 (the factor alone) in chol_inv.cu, K2 mvn.cu (the factor with
// right-hand sides) and K4 mvn_inv.cu (the factor with right-hand sides, then
// the inverse).
//
// One CTA of kBlockThreads owns one matrix in a shared-memory buffer A of
// mp x mp floats, mp = 16 ceil(m/16), padded with identity rows.  Two phases
// work on it, in blocks of kNb = 16:
//
//  * The factor (factor_blocks: factor_diagonal, update_tile, solve_tile),
//    left-looking over the block columns, with an optional buffer Z of
//    mp x dyp right-hand sides that is solved along (dyp = 0: none; dy is
//    padded with zero columns to dyp = 4 ceil(dy/4)).  It leaves L in A's
//    lower triangle and, in A's upper triangle, the transpose of every finished
//    off-diagonal block: A[p * mp + o + r] = L[o + r, p] for p left of the
//    block at offset o.  The strict upper parts of the diagonal blocks are
//    never written and never read.
//  * The inverse in place (invert_diagonal_blocks, inverse_block_row),
//    left-looking over the block rows: W = L^-1 overwrites L in the lower
//    triangle, reading L's off-diagonal blocks from the transposes above
//    the diagonal, which it leaves as they are.
#pragma once

#include "common.cuh"

namespace gprf {

constexpr int kNb = 16;
constexpr int kBlockThreads = 256;
constexpr int kBlockWarps = kBlockThreads / 32;
constexpr float kLog2Pi = 1.8378770664093453f;

__host__ __device__ constexpr int round_up(int n, int to) { return (n + to - 1) / to * to; }

// dst[0:n) = src[0:valid) then zeros, by 4-byte cp.async; one warp
__device__ __forceinline__ void copy_row(float* dst, const float* src, int valid, int n) {
  for (int c = threadIdx.x & 31; c < n; c += 32)
    cp_async4(dst + c, src + (c < valid ? c : 0), c < valid);
}

// Row r of A from the lower triangle of K (an identity row past m); one
// warp.  A's upper triangle is not written (nor read before it is).
__device__ __forceinline__ void load_lower_row(float* A, const float* K, int r, int m, int mp) {
  if (r < m) {
    copy_row(A + r * mp, K + static_cast<size_t>(r) * m, r + 1, r + 1);
  } else {
    for (int c = threadIdx.x & 31; c <= r; c += 32) A[r * mp + c] = c == r ? 1.f : 0.f;
  }
}

// The lower triangle of K (identity past m) into A; a warp a row
__device__ __forceinline__ void load_lower(float* A, const float* K, int m, int mp) {
  for (int r = threadIdx.x >> 5; r < mp; r += kBlockWarps) load_lower_row(A, K, r, m, mp);
  cp_async_commit();
  cp_async_wait_all();
}

// The lower triangle of K (identity past m) into A and Y (zero past m, dy)
// into Z; a warp a row.
__device__ __forceinline__ void load_inputs(float* A, float* Z, const float* K, const float* Y,
                                            int m, int mp, int dy, int dyp) {
  const int warp = threadIdx.x >> 5;
  for (int r = warp; r < mp; r += kBlockWarps) {
    load_lower_row(A, K, r, m, mp);
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
    const float piv = fmaxf(__shfl_sync(0xffffffffu, a[j], j), kTiny);
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

// All warps: the factor, left-looking over the nblk block columns, two
// barriers each.  Warp 0 factors the diagonal block while warps 1.. update
// the panel and Z's block row; then all solve them with D_k.  A and Z must
// be loaded and a barrier passed; a barrier ends it.  Returns the
// log-determinant on warp 0.
__device__ __forceinline__ float factor_blocks(float* A, float* Z, float* DT, int mp, int dyp,
                                               int nblk) {
  const int warp = threadIdx.x >> 5;
  float logdet = 0.f;
  for (int k = 0; k < nblk; ++k) {
    const int tiles = tile_count(k, nblk, dyp);
    if (warp == 0)
      logdet = factor_diagonal(A, DT, mp, kNb * k, logdet);
    else if (k > 0)
      for (int t = warp - 1; t < tiles; t += kBlockWarps - 1)
        update_tile(A, Z, mp, dyp, k, nblk, t);
    __syncthreads();
    for (int t = warp; t < tiles; t += kBlockWarps) solve_tile(A, Z, DT, mp, dyp, k, nblk, t);
    __syncthreads();
  }
  return logdet;
}

// This warp's share of |Z|^2 over Z's n floats, to partial[warp]; the next
// barrier publishes it.
__device__ __forceinline__ void quad_form_partial(const float* Z, int n, float* partial) {
  float quad = 0.f;
  for (int idx = threadIdx.x; idx < n; idx += kBlockThreads) quad += Z[idx] * Z[idx];
  for (int s = 16; s > 0; s >>= 1) quad += __shfl_down_sync(0xffffffffu, quad, s);
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = quad;
}

// The masked log-density from the published partial sums of |L^-1 Y|^2
__device__ __forceinline__ float mvn_log_density(const float* partial, int dy, float logdet,
                                                 float n_active) {
  float q = 0.f;
  for (int w = 0; w < kBlockWarps; ++w) q += partial[w];
  return -0.5f * q - 0.5f * dy * logdet - 0.5f * dy * n_active * kLog2Pi;
}

// Rows 0..m-1 of A's lower triangle to the [m, m] matrix at base + off,
// zeros above the diagonal; a warp a row.  The batch's array and the
// matrix's offset come apart: with their sum formed by the caller, ptxas
// spills 8 bytes in K2 at its 128 registers.
__device__ __forceinline__ void store_lower_cropped(float* __restrict__ base, size_t off,
                                                    const float* A, int m, int mp) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* dst = base + off;
  for (int r = warp; r < m; r += kBlockWarps) {
    float* Dr = dst + static_cast<size_t>(r) * m;
    for (int c0 = lane; c0 < m; c0 += 128) {
      float v[4];  // four loads in flight before the stores
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = c0 + 32 * u <= r ? A[r * mp + c0 + 32 * u] : 0.f;
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (c0 + 32 * u < m) Dr[c0 + 32 * u] = v[u];
    }
  }
}

// Rows 0..m-1 and columns 0..dy-1 of Z (row stride dyp) to the [m, dy]
// matrix at base + off; a warp a row.  The array and the offset come apart
// as in store_lower_cropped.
__device__ __forceinline__ void store_rows_cropped(float* __restrict__ base, size_t off,
                                                   const float* Z, int m, int dy, int dyp) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* dst = base + off;
  for (int r = warp; r < m; r += kBlockWarps)
    for (int c = lane; c < dy; c += 32) dst[static_cast<size_t>(r) * dy + c] = Z[r * dyp + c];
}

// In place: every diagonal block L_bb of A's lower triangle becomes
// W_bb = L_bb^-1, whole, with zeros above its diagonal.  One half-warp a
// block (16 blocks a pass), the block in registers and its rows broadcast
// by shuffles: lane c of half h holds column c of L_bb for b = 2 warp + h
// and solves column c of W_bb.  Every diagonal entry goes through the
// guarded reciprocal 1 / (|L_jj| > 1e-30 ? L_jj : 1e-30); the factor's D_k
// is not W_kk, since at a clamped pivot 1/d_j is not L_jj.
__device__ __forceinline__ void invert_diagonal_blocks(float* A, int mp, int nblk) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = lane & 15, h = lane >> 4;
  // the loop is uniform over the warp: its shuffles need both halves
  for (int b0 = 2 * warp; b0 < nblk; b0 += 2 * kBlockWarps) {
    const int b = min(b0 + h, nblk - 1), o = b * kNb;
    float l[kNb];
#pragma unroll
    for (int r = 0; r < kNb; ++r) l[r] = c <= r ? A[(o + r) * mp + o + c] : 0.f;
    float w[kNb];
#pragma unroll
    for (int r = 0; r < kNb; ++r) {
      // L[r, s] lives in lane s of this half, register r
      float acc = 0.f;
#pragma unroll
      for (int s = 0; s < r; ++s)
        acc = fmaf(__shfl_sync(0xffffffffu, l[r], 16 * h + s), w[s], acc);
      const float lrr = __shfl_sync(0xffffffffu, l[r], 16 * h + r);
      w[r] = ((r == c ? 1.f : 0.f) - acc) * (1.f / (fabsf(lrr) > kTiny ? lrr : kTiny));
    }
    if (b0 + h < nblk) {
#pragma unroll
      for (int r = 0; r < kNb; ++r) A[(o + r) * mp + o + c] = w[r];
    }
  }
}

// In place: block row i of W from the final block rows above it, the
// inverted diagonal blocks and the transposes of L above the diagonal.
// Warp j owns block (i, j): T_ij = sum_{j <= k < i} L_ik W_kj, with L_ik
// read as A[k * mp + 16 i + r], goes over the dead L_ij, and then
// W_ij = -W_ii T_ij.  Lane (rp, q) owns rows 2 rp, 2 rp + 1 and columns
// 4 q .. 4 q + 3 of the block.
__device__ __forceinline__ void inverse_block_row(float* A, int mp, int i) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rp = lane >> 2, q = lane & 3;
  const int ri = kNb * i;
  for (int j = warp; j < i; j += kBlockWarps) {
    const int cj = kNb * j;
    float acc[2][4] = {};
    for (int k0 = cj; k0 < ri; k0 += kNb) {
#pragma unroll
      for (int kk = 0; kk < kNb; ++kk) {
        const int k = k0 + kk;
        const float2 a = *reinterpret_cast<const float2*>(A + k * mp + ri + 2 * rp);
        const float4 b = *reinterpret_cast<const float4*>(A + k * mp + cj + 4 * q);
        fma_row(acc[0], a.x, b);
        fma_row(acc[1], a.y, b);
      }
    }
    // T_ij goes to block (i, j), which no other warp touches this step
    float* Tij = A + ri * mp + cj + 4 * q;
#pragma unroll
    for (int e = 0; e < 2; ++e)
      *reinterpret_cast<float4*>(Tij + (2 * rp + e) * mp) =
          make_float4(acc[e][0], acc[e][1], acc[e][2], acc[e][3]);
    __syncwarp();
    // this lane's two rows of W_ii (zero above its diagonal), loaded only
    // now so that the product above has the registers for its loads
    const float* Wii = A + (ri + 2 * rp) * mp + ri;
    float out[2][4] = {};
#pragma unroll
    for (int s4 = 0; s4 < kNb; s4 += 4) {
      const float4 w0 = *reinterpret_cast<const float4*>(Wii + s4);
      const float4 w1 = *reinterpret_cast<const float4*>(Wii + mp + s4);
      const float a0[4] = {w0.x, w0.y, w0.z, w0.w}, a1[4] = {w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const float4 t = *reinterpret_cast<const float4*>(Tij + (s4 + s) * mp);
        fma_row(out[0], a0[s], t);
        fma_row(out[1], a1[s], t);
      }
    }
    __syncwarp();
#pragma unroll
    for (int e = 0; e < 2; ++e)
      *reinterpret_cast<float4*>(Tij + (2 * rp + e) * mp) =
          make_float4(-out[e][0], -out[e][1], -out[e][2], -out[e][3]);
  }
}

// Host side.  Dynamic shared memory of a kernel at (m, dy): A and, with
// dy > 0, Z.
inline size_t smem_bytes(int m, int dy) {
  const size_t mp = round_up(m, kNb), dyp = round_up(dy, 4);
  return (mp * mp + mp * dyp) * sizeof(float);
}

// Let `kernel` take `smem` bytes of dynamic shared memory, and give the SM's
// whole unified memory to shared memory, so that two CTAs fit.
template <typename Kernel>
cudaError_t configure(Kernel kernel, size_t smem) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// CTAs of `kernel` resident on one SM with `smem` bytes each (negative: a
// CUDA error code)
template <typename Kernel>
int ctas_per_sm(Kernel kernel, size_t smem) {
  cudaError_t e = configure(kernel, smem);
  int n = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kBlockThreads, smem);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

// Configure `kernel`, launch it with one CTA per matrix on `stream`, and
// return the launch status (a cudaError_t; 0: launched, or an empty batch).
template <typename Kernel, typename... Args>
int launch(Kernel kernel, int batch, size_t smem, void* stream, Args... args) {
  const cudaError_t e = configure(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (batch == 0) return 0;
  kernel<<<batch, kBlockThreads, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gprf
