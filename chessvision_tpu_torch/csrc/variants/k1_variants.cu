// Variants of the two-pass warp that were measured against the kernels of
// ../hat_resample.cu and not kept.  Nothing in the package calls them;
// chessvision_tpu_torch/k1_variants.py builds this file and times them,
// so that the times PERF.md gives for them can be taken again.
//
// - pass2_staged: pass 2 with the tile's rows of the intermediate staged
//   in shared memory instead of read through L1.
// - warp_slab: the whole warp in one kernel.  A block takes a 32 u x
//   FUSED_V v tile of the output, finds the rows of the intermediate its
//   taps need, computes that slab from the source into shared memory, and
//   resamples it; the intermediate never reaches device memory.  A tile
//   whose slab is over SLAB_ROWS rows computes each tap's intermediate
//   value on the fly instead (the same arithmetic, about twice the work).
//
// Both give the kept kernels' floats: they share tap_at, tap_sum and the
// position functions.

#include "../hat_resample.cu"

#include <limits.h>

namespace {

constexpr int SLAB_ROWS = 128;
constexpr int FUSED_PER_THREAD = 8;
constexpr int FUSED_V = TILE_WARPS * FUSED_PER_THREAD;

// The block's lowest and highest row over all threads' [lo, hi].
__device__ __forceinline__ void block_range(int& lo, int& hi) {
  __shared__ int red[2 * TILE_WARPS];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  if (threadIdx.x == 0) {
    red[threadIdx.y] = lo;
    red[TILE_WARPS + threadIdx.y] = hi;
  }
  __syncthreads();
  for (int i = 0; i < TILE_WARPS; ++i) {
    lo = min(lo, red[i]);
    hi = max(hi, red[TILE_WARPS + i]);
  }
}

// The rows [lo, hi] of a j-row column that a tap at p reads, merged into lo, hi.
__device__ __forceinline__ void widen(float p, int j, int& lo, int& hi) {
  if (p > -1.0f && p < (float)j) {
    const int i = (int)floorf(p);
    lo = min(lo, max(i, 0));
    hi = max(hi, min(i + 1, j - 1));
  }
}

// A tap whose row indices are safe to look up in a slab that starts at row lo.
__device__ __forceinline__ Tap slab_tap(float p, int j, int lo) {
  Tap t = tap_at(p, j);
  if (!t.ok0) t.i0 = lo;
  if (!t.ok1) t.i1 = lo;
  return t;
}

template <int PER_THREAD>
__global__ void pass2_staged_kernel(const float* __restrict__ tmp, const float* __restrict__ minv,
                                    float* __restrict__ out, int src_h, int out_h, int out_w) {
  __shared__ float slab[SLAB_ROWS * TILE_U];
  const int b = blockIdx.z;
  const int u = min(blockIdx.x * TILE_U + threadIdx.x, out_w - 1);  // lanes past the edge repeat the last column
  const bool u_ok = blockIdx.x * TILE_U + threadIdx.x < out_w;
  const Homography m = load_homography(minv + (int64_t)b * 9);
  const float* col = tmp + (int64_t)b * src_h * out_w + u;
  float* dst = out + (int64_t)b * out_h * out_w + u;
  const int v0 = blockIdx.y * (TILE_WARPS * PER_THREAD) + threadIdx.y;
  float vy[PER_THREAD];
  int lo = INT_MAX, hi = -1;
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    vy[k] = position_vy(m, (float)u, (float)min(v0 + k * TILE_WARPS, out_h - 1));
    widen(vy[k], src_h, lo, hi);
  }
  block_range(lo, hi);
  const int ny = hi - lo + 1;
  const bool staged = ny <= SLAB_ROWS;
  if (staged) {
    for (int r = threadIdx.y; r < ny; r += TILE_WARPS) slab[r * TILE_U + threadIdx.x] = __ldg(col + (lo + r) * out_w);
    __syncthreads();
  }
  const float* rows = staged ? slab + threadIdx.x - lo * TILE_U : col;
  const int stride = staged ? TILE_U : out_w;
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const int v = v0 + k * TILE_WARPS;
    const Tap t = slab_tap(vy[k], src_h, staged ? lo : 0);
    if (u_ok && v < out_h) dst[v * out_w] = tap_sum(t, rows[t.i0 * stride], rows[t.i1 * stride]);
  }
}

__global__ void __launch_bounds__(TILE_U* TILE_WARPS)
    warp_slab_kernel(const float* __restrict__ imgs, const float* __restrict__ minv, float* __restrict__ out,
                      int h, int w, int out_h, int out_w) {
  __shared__ float slab[SLAB_ROWS * TILE_U];
  const int b = blockIdx.z;
  const int u = min(blockIdx.x * TILE_U + threadIdx.x, out_w - 1);
  const bool u_ok = blockIdx.x * TILE_U + threadIdx.x < out_w;
  const float us = (float)u;
  const Homography m = load_homography(minv + (int64_t)b * 9);
  const float* src = imgs + (int64_t)b * h * w;
  float* dst = out + (int64_t)b * out_h * out_w + u;
  const int v0 = blockIdx.y * FUSED_V + threadIdx.y;
  float vy[FUSED_PER_THREAD];
  int lo = INT_MAX, hi = -1;
#pragma unroll
  for (int k = 0; k < FUSED_PER_THREAD; ++k) {
    vy[k] = position_vy(m, us, (float)min(v0 + k * TILE_WARPS, out_h - 1));
    widen(vy[k], h, lo, hi);
  }
  block_range(lo, hi);
  const int ny = hi - lo + 1;
  // the intermediate's value at row y of this thread's column
  auto intermediate = [&](int y) {
    const Tap s = tap_at(position_hx(m, us, (float)y), w);
    return tap_sum(s, __ldg(src + y * w + s.i0), __ldg(src + y * w + s.i1));
  };
  if (ny <= SLAB_ROWS) {
    for (int r = threadIdx.y; r < ny; r += TILE_WARPS) slab[r * TILE_U + threadIdx.x] = intermediate(lo + r);
    __syncthreads();
    const float* rows = slab + threadIdx.x - lo * TILE_U;
#pragma unroll
    for (int k = 0; k < FUSED_PER_THREAD; ++k) {
      const int v = v0 + k * TILE_WARPS;
      const Tap t = slab_tap(vy[k], h, lo);
      if (u_ok && v < out_h) dst[v * out_w] = tap_sum(t, rows[t.i0 * TILE_U], rows[t.i1 * TILE_U]);
    }
  } else {
#pragma unroll 1
    for (int k = 0; k < FUSED_PER_THREAD; ++k) {
      const int v = v0 + k * TILE_WARPS;
      const Tap t = tap_at(vy[k], h);
      if (u_ok && v < out_h) dst[v * out_w] = tap_sum(t, intermediate(t.i0), intermediate(t.i1));
    }
  }
}

}  // namespace

extern "C" int pass2_staged_launch(const void* tmp, const void* minv, void* out,
                                   int b, int src_h, int out_h, int out_w, void* stream) {
  const dim3 block(TILE_U, TILE_WARPS);
  const dim3 grid(ceil_div(out_w, TILE_U), ceil_div(out_h, TILE_V), (unsigned int)b);
  pass2_staged_kernel<TILE_PER_THREAD><<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)tmp, (const float*)minv, (float*)out, src_h, out_h, out_w);
  return (int)cudaGetLastError();
}

extern "C" int warp_slab_launch(const void* imgs, const void* minv, void* out,
                                 int b, int h, int w, int out_h, int out_w, void* stream) {
  const dim3 block(TILE_U, TILE_WARPS);
  const dim3 grid(ceil_div(out_w, TILE_U), ceil_div(out_h, FUSED_V), (unsigned int)b);
  warp_slab_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)imgs, (const float*)minv, (float*)out, h, w, out_h, out_w);
  return (int)cudaGetLastError();
}
