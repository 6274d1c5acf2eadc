// K3: W = L^-1 for lower-triangular [B, m, m].
//
// Replaces the TPU kernel _tri_inv_kernel (gprf_tpu/ops/pallas_mvn.py),
// which the backward passes of K2 and K5 reach through tri_inv_split.  Only
// the lower triangle of L is read; W has exact zeros above its diagonal;
// every diagonal entry goes through the TPU kernel's guarded reciprocal
// 1 / (|L_kk| > 1e-30 ? L_kk : 1e-30); f32 accumulation throughout.
//
// Bound: the work is small (m^3/6 FMAs, 0.5 M a matrix at m = 136) and so
// are the bytes (L read once, W written once); what bounds a CTA is the
// length of its dependency chain.  The design this replaces ran m
// sequential rank-1 steps at two barriers each, ~119 us a CTA at m = 136
// on the H100, in the latency of shared-memory load-FMA-store chains.
// This one takes ~19 us a CTA there: ~2.5 us for the diagonal blocks,
// ~15 us for the block rows (block column 0's chain of 36 16-deep block
// products, ~525 SM cycles each while the row's other warps share the
// schedulers) and ~3 us for the store.
//
// Design: blocks of kNb = 16, m padded with identity to mp = 16 ceil(m/16)
// and cropped on the store.
//  1. Each half-warp inverts one diagonal block L_ii -> W_ii by forward
//     substitution, the block in registers and its rows broadcast by
//     shuffles; all blocks at once, no barrier.  Clamping a diagonal entry
//     of L clamps it in its block, so the blocked W is L'^-1 for the same
//     clamped L' as the TPU kernel's.
//  2. Block row i = 1 .. nblk-1, left-looking: warp j forms
//     T_ij = sum_{j <= k < i} L_ik W_kj, a 16 x 16 register tile (2 x 4 a
//     lane, L as float2 and W as float4 from shared memory; the zero
//     blocks of W above the diagonal are skipped), then W_ij = -W_ii T_ij
//     through its own block of W, at one barrier a block row.
// W (mp^2 floats) stays in shared memory.  The panel of L left of each
// diagonal block (16 x 16 i floats, stored transposed) streams in by
// cp.async, double-buffered, and is read once.  mp^2 + 32 mp floats:
// 101,376 B at m = 136, so two CTAs share an SM and the flagship's 180
// matrices run in one wave; m <= 224.
#include "common.cuh"

namespace {

constexpr int kNb = 16;
constexpr int kTriThreads = 256;
constexpr int kTriWarps = kTriThreads / 32;

__host__ __device__ constexpr int padded(int m) { return (m + kNb - 1) / kNb * kNb; }

size_t smem_bytes(int m) {
  const size_t mp = padded(m);
  return (mp * mp + 2 * kNb * mp) * sizeof(float);
}

using gprf::cp_async4;
using gprf::cp_async_commit;
using gprf::cp_async_wait_all;
using gprf::fma_row;

// Panel i of L, the 16 x 16 i block row left of L_ii, transposed into
// P[k * 16 + r] = L[16 i + r, k]; rows past m are zero.
__device__ __forceinline__ void load_panel(float* P, const float* L, int m, int i) {
  const int n = kNb * kNb * i;
  for (int idx = threadIdx.x; idx < n; idx += kTriThreads) {
    const int k = idx / kNb, row = kNb * i + idx % kNb;
    const bool valid = row < m;
    cp_async4(P + idx, L + (valid ? static_cast<size_t>(row) * m + k : 0), valid);
  }
  cp_async_commit();
}

// W_bb = L_bb^-1 for every diagonal block b, one half-warp a block (16
// blocks a pass, so one pass up to the cap).  Lane c of half h holds
// column c of L_bb for b = 2 warp + h and solves column c of W_bb.
__device__ __forceinline__ void invert_diagonal(float* W, const float* L, int m, int mp,
                                                int nblk) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = lane & 15, h = lane >> 4;
  // the loop is uniform over the warp: its shuffles need both halves
  for (int b0 = 2 * warp; b0 < nblk; b0 += 2 * kTriWarps) {
    const int b = b0 + h, o = b * kNb;
    float l[kNb];
#pragma unroll
    for (int r = 0; r < kNb; ++r)
      l[r] = (o + r >= m) ? (r == c ? 1.f : 0.f)
             : (c <= r)   ? __ldg(L + static_cast<size_t>(o + r) * m + o + c)
                          : 0.f;
    float w[kNb];
#pragma unroll
    for (int r = 0; r < kNb; ++r) {
      // L[r, s] lives in lane s of this half, register r
      float acc = 0.f;
#pragma unroll
      for (int s = 0; s < r; ++s)
        acc = fmaf(__shfl_sync(0xffffffffu, l[r], 16 * h + s), w[s], acc);
      const float lrr = __shfl_sync(0xffffffffu, l[r], 16 * h + r);
      w[r] = ((r == c ? 1.f : 0.f) - acc) * (1.f / (fabsf(lrr) > gprf::kTiny ? lrr : gprf::kTiny));
    }
    if (b < nblk) {
#pragma unroll
      for (int r = 0; r < kNb; ++r) W[(o + r) * mp + o + c] = w[r];
    }
  }
}

// Block row i of W from the final block rows above it and panel P of L.
// Warp j owns block (i, j); lane (rp, q) owns its rows 2 rp, 2 rp + 1 and
// columns 4 q .. 4 q + 3.
__device__ __forceinline__ void block_row(float* W, const float* P, int mp, int i) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rp = lane >> 2, q = lane & 3;
  const int ri = kNb * i;
  for (int j = warp; j < i; j += kTriWarps) {
    const int cj = kNb * j;
    float acc[2][4] = {};
    for (int k0 = cj; k0 < ri; k0 += kNb) {
#pragma unroll
      for (int kk = 0; kk < kNb; ++kk) {
        const int k = k0 + kk;
        const float2 a = *reinterpret_cast<const float2*>(P + k * kNb + 2 * rp);
        const float4 b = *reinterpret_cast<const float4*>(W + k * mp + cj + 4 * q);
        fma_row(acc[0], a.x, b);
        fma_row(acc[1], a.y, b);
      }
    }
    // T_ij goes to block (i, j) of W, which no other warp touches this step
    float* Tij = W + ri * mp + cj + 4 * q;
#pragma unroll
    for (int e = 0; e < 2; ++e)
      *reinterpret_cast<float4*>(Tij + (2 * rp + e) * mp) =
          make_float4(acc[e][0], acc[e][1], acc[e][2], acc[e][3]);
    __syncwarp();
    // this lane's two rows of W_ii (zero above its diagonal), loaded only
    // now so that the product above has the registers for its loads
    const float* Wii = W + (ri + 2 * rp) * mp + ri;
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

__global__ void __launch_bounds__(kTriThreads, 2)
tri_inv_kernel(const float* __restrict__ Lin, float* __restrict__ Wout, int m) {
  extern __shared__ float4 smem4[];
  float* W = reinterpret_cast<float*>(smem4);
  const int mp = padded(m), nblk = mp / kNb;
  float* panels = W + mp * mp;  // two buffers of 16 x mp floats
  const size_t off = static_cast<size_t>(blockIdx.x) * m * m;
  const float* L = Lin + off;

  if (nblk > 1) load_panel(panels + kNb * mp, L, m, 1);
  invert_diagonal(W, L, m, mp, nblk);
  for (int i = 1; i < nblk; ++i) {
    cp_async_wait_all();
    // panel i has landed, block rows < i of W are final, and the other
    // buffer (panel i - 1) is no longer read
    __syncthreads();
    if (i + 1 < nblk) load_panel(panels + ((i + 1) & 1) * kNb * mp, L, m, i + 1);
    block_row(W, panels + (i & 1) * kNb * mp, mp, i);
  }
  __syncthreads();

  float* Wg = Wout + off;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < m; r += kTriWarps)
    for (int c = lane; c < m; c += 32)
      Wg[static_cast<size_t>(r) * m + c] = c <= r ? W[r * mp + c] : 0.f;
}

cudaError_t configure(size_t smem) {
  cudaError_t e = cudaFuncSetAttribute(
      tri_inv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  // the whole of the SM's unified memory as shared memory, so that two CTAs fit
  return cudaFuncSetAttribute(tri_inv_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

}  // namespace

extern "C" int gprf_tri_inv(const float* L, float* W, int batch, int m, void* stream) {
  const size_t smem = smem_bytes(m);
  cudaError_t e = configure(smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (batch == 0) return 0;
  tri_inv_kernel<<<batch, kTriThreads, smem, static_cast<cudaStream_t>(stream)>>>(L, W, m);
  return static_cast<int>(cudaGetLastError());
}

// CTAs of K3 resident on one SM at width m (negative: a CUDA error code)
extern "C" int gprf_tri_inv_ctas_per_sm(int m) {
  const size_t smem = smem_bytes(m);
  cudaError_t e = configure(smem);
  int n = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, tri_inv_kernel, kTriThreads, smem);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

extern "C" const char* gprf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
