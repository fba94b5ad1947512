// Linear (hat) resample and the two-pass projective warp built on it, for
// Hopper (sm_90a).
//
//   out[n, u] = sum_j max(0, 1 - |pos[n, u] - j|) * src[n, j]
//
// with a zero border: a position in (-1, 0) or (J-1, J) keeps the partial
// weight of its one tap inside the row, and a position outside (-1, J)
// gives 0.
//
// Replaces the TPU kernel chessvision_tpu/ops/pallas_kernels.py:
// banded_resample, the function under both passes of the two-pass
// projective warp (chessvision_tpu/ops/warp.py:_warp_batched_twopass).
// The TPU kernel contracted a band of the row against every output,
// because TPU lanes cannot gather; Hopper gathers, so every output reads
// its two taps src[floor(pos)] and src[floor(pos) + 1] directly (tap_at
// and tap_sum below, shared by every kernel of this file).
//
// Two entries:
//
// 1. The whole warp from the images and the inverse homographies, by one
//    of two routes that the caller picks from the shapes alone
//    (ops/hat_resample.py:warp_plan): warp_pass1_launch + warp_pass2_launch
//    (the two-pass route: the main path's 512^2 frames and the training
//    augmentations), or warp_fused_launch (the fused route: frames that the
//    warp shrinks, the camera photos users send).  Both give the same
//    floats.
//
//    The two-pass route, in two kernels.
//    Bound: device-memory bytes.  The function itself reads the images
//    and writes the boards; this two-kernel design also writes and reads
//    the intermediate once, and nothing else.  The positions never touch
//    memory: they are a dozen float operations on the board's nine
//    coefficients and the thread's own (u, y) or (u, v), so each thread
//    computes its own, with __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn
//    in the plain version's order of operations (no FMA contraction),
//    which gives the plain version's floats.  Beside the bytes, what a
//    pass needs is enough loads in flight: each thread first computes
//    the positions of all its outputs, then starts all their tap loads
//    together (the taps are branch-free: a tap outside the row reads
//    element 0 with weight 0), then stores.
//    - pass 1: a block owns `rows` source rows of one board, brings them
//      into shared memory with 16-byte loads, and each thread computes
//      four neighbouring outputs of each row from shared memory and
//      stores them as 16 bytes.  The caller picks `rows` from the width
//      (ops/hat_resample.py:pass1_plan): 8, 4, 2 or 1, the most whose
//      floats fit a block's 227 KB, so a row of up to 58 112 floats is
//      staged; a wider row takes the variant that reads its two taps
//      from device memory through __ldg, as hat_resample_kernel does.
//      Both read the same taps and sum them alike, so every width gives
//      the same floats.
//    - pass 2: threads run along u, the contiguous axis of both the
//      intermediate and the output, and read the intermediate in place
//      with row stride out_w: no transposed copy before or after.  A
//      block covers a 32 u x TILE_V v tile; for a rotated board
//      floor(vy) steps along u, so one warp's taps touch several rows,
//      and the other warps of the block find those rows in L1.
//
//    The fused route, one kernel (warp_fused_kernel).  At a camera frame
//    (12-48 MP into the 576^2 canvas) the warp shrinks the frame 5-10x
//    along each axis: the taps touch 9-25% of the frame's bytes, and pass
//    2 reads at most two rows of the intermediate for each output, so
//    staging whole source rows (pass 1) and writing every row of the
//    intermediate move 4-11x the function's bytes.  Here each thread
//    owns outputs (b, v, u), threads running along u so that stores are
//    contiguous, and computes each one from the source directly: the
//    pass-2 tap at vy(u, v) names at most two rows r of the intermediate;
//    for each row whose tap lies inside the frame it computes hx(u, r),
//    the pass-1 tap, and reads that tap's two source floats through
//    __ldg; then the two pass-1 sums and the pass-2 sum, with the same
//    __f*_rn operations in the same order as the two kernels, so the
//    floats are the two-pass floats.  A tap outside the frame is never
//    loaded.  Each thread first computes every position of its
//    TILE_PER_THREAD outputs, then issues all their loads, then sums and
//    stores, so that up to 4 * TILE_PER_THREAD loads are in flight.
//    Bound: device-memory bytes, and of the function's own kind: the
//    32-byte source sectors the taps touch plus the canvas written
//    (tools/flops.py:tap_sector_bytes; 11-19 MB a camera frame).
//    Neighbouring outputs share their sectors through L1 and L2.  No
//    shared-memory staging: the reads are a sparse gather, which the
//    load path serves by the sector, while a staged row is read whole.
//    The price is arithmetic: five __fdiv_rn an output where the two
//    passes spend 2 * h / out_h + 1, which is why frames the warp does
//    not shrink (512^2 into 576^2, 128 at a time) stay two-pass.
//
// 2. hat_resample_launch: the TPU kernel's own signature, positions given
//    in memory.  Bound: device-memory bytes (one position read, one
//    float written, two taps).  It reads the source in place through a
//    batch, a row and an element stride, so a transposed view needs no
//    copy.  Threads run along u; a block covers 32 u x TILE_V rows, so
//    that for a transposed source (neighbouring rows at neighbouring
//    addresses) the sectors one warp fetches serve the block's other
//    warps from L1.
//
// The weights are the same expression as the plain PyTorch version
// (1 - |pos - j|), and the products and the sum use __fmul_rn and
// __fadd_rn so that no FMA contraction changes the last bit: the result
// equals the plain version's bit for bit.
//
// Each launcher returns cudaGetLastError() of its launch, or NOTHING_LAUNCHED
// (-1, no cudaError_t has it) when the shape holds no output element and no
// kernel was launched.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE_U = 32;          // threads along u in the tiled kernels
constexpr int TILE_WARPS = 8;
constexpr int TILE_PER_THREAD = 3;  // rows (or v) a thread walks in a tile
constexpr int TILE_V = TILE_WARPS * TILE_PER_THREAD;
constexpr int SHARED_DEFAULT = 48 * 1024;  // dynamic shared memory a kernel gets without asking
constexpr int NOTHING_LAUNCHED = -1;

// The two taps of one output at position p of a row of j elements: their
// indices, hat weights, and whether each lies inside the row.  A tap
// outside the row has index 0, so that its load is always in range.
struct Tap {
  int i0, i1;
  float w0, w1;
  bool ok0, ok1;
};

__device__ __forceinline__ Tap tap_at(float p, int j) {
  Tap t;
  const float f = floorf(p);
  const int i = (int)f;
  const bool inside = p > -1.0f && p < (float)j;
  t.w0 = 1.0f - fabsf(p - f);
  t.w1 = 1.0f - fabsf(p - (f + 1.0f));
  t.ok0 = inside && i >= 0;
  t.ok1 = inside && i + 1 < j;
  t.i0 = t.ok0 ? i : 0;
  t.i1 = t.ok1 ? i + 1 : 0;
  return t;
}

__device__ __forceinline__ float tap_sum(const Tap& t, float s0, float s1) {
  const float t0 = t.ok0 ? __fmul_rn(t.w0, s0) : 0.0f;
  const float t1 = t.ok1 ? __fmul_rn(t.w1, s1) : 0.0f;
  return __fadd_rn(t0, t1);
}

// |den| < 1e-8 -> 1e-8, the plain version's guard of a projective denominator.
__device__ __forceinline__ float guard(float den) {
  return fabsf(den) < 1e-8f ? 1e-8f : den;
}

// One board's inverse homography, row-major a b c / d e f / g h i.
struct Homography {
  float a, b, c, d, e, f, g, h, i;
};

__device__ __forceinline__ Homography load_homography(const float* m) {
  return {__ldg(m + 0), __ldg(m + 1), __ldg(m + 2), __ldg(m + 3), __ldg(m + 4),
          __ldg(m + 5), __ldg(m + 6), __ldg(m + 7), __ldg(m + 8)};
}

// Pass-1 position: hx(u, y) = X(u, v*) where Y(u, v*) = y.
__device__ __forceinline__ float position_hx(const Homography& m, float us, float ys) {
  const float gu = __fmul_rn(m.g, us);
  const float den_v = __fsub_rn(m.e, __fmul_rn(ys, m.h));
  const float num_v = __fsub_rn(__fsub_rn(__fmul_rn(ys, __fadd_rn(gu, m.i)), __fmul_rn(m.d, us)), m.f);
  const float v_star = __fdiv_rn(num_v, guard(den_v));
  const float den_x = __fadd_rn(__fadd_rn(gu, __fmul_rn(m.h, v_star)), m.i);
  const float num_x = __fadd_rn(__fadd_rn(__fmul_rn(m.a, us), __fmul_rn(m.b, v_star)), m.c);
  return __fdiv_rn(num_x, guard(den_x));
}

// Pass-2 position: vy(u, v) = Y(u, v).
__device__ __forceinline__ float position_vy(const Homography& m, float us, float vs) {
  const float den = __fadd_rn(__fadd_rn(__fmul_rn(m.g, us), __fmul_rn(m.h, vs)), m.i);
  const float num = __fadd_rn(__fadd_rn(__fmul_rn(m.d, us), __fmul_rn(m.e, vs)), m.f);
  return __fdiv_rn(num, guard(den));
}

// src viewed as (batches, rows, j) through three strides (in elements);
// pos and out contiguous (n = batches * rows, u).
__global__ void hat_resample_kernel(const float* __restrict__ src,
                                    const float* __restrict__ pos,
                                    float* __restrict__ out,
                                    int n, int rows, int j, int u,
                                    int64_t batch_stride, int64_t row_stride, int64_t elem_stride) {
  const int uu = blockIdx.y * TILE_U + threadIdx.x;
  if (uu >= u) return;
  const int n0 = blockIdx.x * TILE_V + threadIdx.y;
  Tap t[TILE_PER_THREAD];
  float s0[TILE_PER_THREAD], s1[TILE_PER_THREAD];
#pragma unroll
  for (int k = 0; k < TILE_PER_THREAD; ++k) {
    const int row = min(n0 + k * TILE_WARPS, n - 1);  // past the end: recompute the last row, store nothing
    const int b = row / rows;
    const float* s = src + b * batch_stride + (row - b * rows) * row_stride;
    t[k] = tap_at(__ldg(pos + (int64_t)row * u + uu), j);
    s0[k] = __ldg(s + t[k].i0 * elem_stride);
    s1[k] = __ldg(s + t[k].i1 * elem_stride);
  }
#pragma unroll
  for (int k = 0; k < TILE_PER_THREAD; ++k) {
    const int row = n0 + k * TILE_WARPS;
    if (row < n) out[(int64_t)row * u + uu] = tap_sum(t[k], s0[k], s1[k]);
  }
}

// Pass 1: tmp[b, y, u] = hat resample of source row (b, y) at hx(u, y).
// A block owns `rows` rows (the last block of a board fewer).  STAGED: the
// rows sit in dynamic shared memory; otherwise each tap is read from
// device memory.  VEC: w and out_w are multiples of 4 and both arrays
// start on 16 bytes, so rows load and outputs store as float4; otherwise
// one float at a time.
template <bool VEC, bool STAGED>
__global__ void warp_pass1_kernel(const float* __restrict__ imgs,
                                  const float* __restrict__ minv,
                                  float* __restrict__ tmp,
                                  int h, int w, int out_w, int rows, int groups) {
  extern __shared__ __align__(16) float rows_sm[];
  const int b = blockIdx.x / groups;
  const int y0 = (blockIdx.x - b * groups) * rows;
  const int nrows = (h - y0 < rows) ? h - y0 : rows;
  const float* src = imgs + ((int64_t)b * h + y0) * w;
  if (STAGED) {
    const int count = nrows * w;  // <= 58 112: it fits the block's shared memory
    if (VEC) {
      const float4* src4 = reinterpret_cast<const float4*>(src);
      float4* sm4 = reinterpret_cast<float4*>(rows_sm);
      for (int i = threadIdx.x; i < count / 4; i += blockDim.x) sm4[i] = __ldg(src4 + i);
    } else {
      for (int i = threadIdx.x; i < count; i += blockDim.x) rows_sm[i] = __ldg(src + i);
    }
  }
  const Homography m = load_homography(minv + (int64_t)b * 9);
  if (STAGED) __syncthreads();

  float* dst = tmp + ((int64_t)b * h + y0) * out_w;
  for (int u0 = threadIdx.x * 4; u0 < out_w; u0 += blockDim.x * 4) {
    for (int r = 0; r < nrows; ++r) {
      const float ys = (float)(y0 + r);
      float hx[4], o[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) hx[k] = position_hx(m, (float)(u0 + k), ys);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const Tap t = tap_at(hx[k], w);
        if (STAGED) {
          const float* row = rows_sm + r * w;
          o[k] = tap_sum(t, row[t.i0], row[t.i1]);
        } else {
          const float* row = src + (int64_t)r * w;
          o[k] = tap_sum(t, __ldg(row + t.i0), __ldg(row + t.i1));
        }
      }
      float* d = dst + r * out_w + u0;
      if (VEC) {
        *reinterpret_cast<float4*>(d) = make_float4(o[0], o[1], o[2], o[3]);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (u0 + k < out_w) d[k] = o[k];
        }
      }
    }
  }
}

// Pass 2: out[b, v, u] = hat resample of column u of tmp[b] (src_h rows,
// out_w apart) at vy(u, v).
__global__ void warp_pass2_kernel(const float* __restrict__ tmp,
                                  const float* __restrict__ minv,
                                  float* __restrict__ out,
                                  int src_h, int out_h, int out_w) {
  const int b = blockIdx.z;
  const int u = blockIdx.x * TILE_U + threadIdx.x;
  if (u >= out_w) return;
  const Homography m = load_homography(minv + (int64_t)b * 9);
  const float* col = tmp + (int64_t)b * src_h * out_w + u;
  float* dst = out + (int64_t)b * out_h * out_w + u;
  const int v0 = blockIdx.y * TILE_V + threadIdx.y;
  const float us = (float)u;
  float vy[TILE_PER_THREAD];
#pragma unroll
  for (int k = 0; k < TILE_PER_THREAD; ++k) vy[k] = position_vy(m, us, (float)(v0 + k * TILE_WARPS));
  Tap t[TILE_PER_THREAD];
  float s0[TILE_PER_THREAD], s1[TILE_PER_THREAD];
#pragma unroll
  for (int k = 0; k < TILE_PER_THREAD; ++k) {
    t[k] = tap_at(vy[k], src_h);
    s0[k] = __ldg(col + t[k].i0 * out_w);
    s1[k] = __ldg(col + t[k].i1 * out_w);
  }
#pragma unroll
  for (int k = 0; k < TILE_PER_THREAD; ++k) {
    const int v = v0 + k * TILE_WARPS;
    if (v < out_h) dst[v * out_w] = tap_sum(t[k], s0[k], s1[k]);
  }
}

// The fused route: out[b, v, u] = pass 2's hat sum at vy(u, v) over the
// rows r of the intermediate it reads, each computed here as pass 1 would,
// the hat sum of source row (b, r) at hx(u, r).  imgs (b, h, w), out
// (b, out_h, out_w); grid and block as pass 2's.
__global__ void __launch_bounds__(TILE_U* TILE_WARPS)
    warp_fused_kernel(const float* __restrict__ imgs, const float* __restrict__ minv, float* __restrict__ out,
                      int h, int w, int out_h, int out_w) {
  const int b = blockIdx.z;
  const int u = blockIdx.x * TILE_U + threadIdx.x;
  if (u >= out_w) return;
  const Homography m = load_homography(minv + (int64_t)b * 9);
  const float* src = imgs + (int64_t)b * h * w;
  float* dst = out + (int64_t)b * out_h * out_w + u;
  const int v0 = blockIdx.y * TILE_V + threadIdx.y;
  const float us = (float)u;
  const Tap none = {0, 0, 0.0f, 0.0f, false, false};
  Tap t[TILE_PER_THREAD];     // pass 2: the rows of the intermediate
  Tap s[TILE_PER_THREAD][2];  // pass 1: the columns of each of those rows
#pragma unroll
  for (int k = 0; k < TILE_PER_THREAD; ++k) {
    t[k] = tap_at(position_vy(m, us, (float)(v0 + k * TILE_WARPS)), h);
    s[k][0] = t[k].ok0 ? tap_at(position_hx(m, us, (float)t[k].i0), w) : none;
    s[k][1] = t[k].ok1 ? tap_at(position_hx(m, us, (float)t[k].i1), w) : none;
  }
  float x[TILE_PER_THREAD][2][2];
#pragma unroll
  for (int k = 0; k < TILE_PER_THREAD; ++k) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float* row = src + (int64_t)(r ? t[k].i1 : t[k].i0) * w;
      x[k][r][0] = s[k][r].ok0 ? __ldg(row + s[k][r].i0) : 0.0f;
      x[k][r][1] = s[k][r].ok1 ? __ldg(row + s[k][r].i1) : 0.0f;
    }
  }
#pragma unroll
  for (int k = 0; k < TILE_PER_THREAD; ++k) {
    const int v = v0 + k * TILE_WARPS;
    const float r0 = tap_sum(s[k][0], x[k][0][0], x[k][0][1]);
    const float r1 = tap_sum(s[k][1], x[k][1][0], x[k][1][1]);
    if (v < out_h) dst[(int64_t)v * out_w] = tap_sum(t[k], r0, r1);
  }
}

inline unsigned int ceil_div(int64_t a, int64_t b) { return (unsigned int)((a + b - 1) / b); }

}  // namespace

// src (batches, rows, j) through its strides (in elements); pos and out
// (batches * rows, u) contiguous; float32 on the device.  Launches on
// `stream` and returns cudaGetLastError() of the launch.
extern "C" int hat_resample_launch(const void* src, const void* pos, void* out,
                                   int batches, int rows, int j, int u,
                                   int64_t batch_stride, int64_t row_stride, int64_t elem_stride,
                                   void* stream) {
  const int64_t n = (int64_t)batches * rows;  // < 2^31, checked by the caller
  if (n == 0 || u == 0) return NOTHING_LAUNCHED;
  const dim3 block(TILE_U, TILE_WARPS);
  const dim3 grid(ceil_div(n, TILE_V), ceil_div(u, TILE_U));
  hat_resample_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)src, (const float*)pos, (float*)out, (int)n, rows, j, u,
      batch_stride, row_stride, elem_stride);
  return (int)cudaGetLastError();
}

// Pass 1 alone: imgs (b, h, w) and minv (b, 3, 3) contiguous ->
// tmp (b, h, out_w) contiguous.  A block owns `rows` source rows and
// stages them in `smem` = rows * w * 4 bytes of shared memory, or, with
// smem 0, reads its taps from device memory (the caller's plan,
// ops/hat_resample.py:pass1_plan).
extern "C" int warp_pass1_launch(const void* imgs, const void* minv, void* tmp,
                                 int b, int h, int w, int out_w, int rows, int smem, void* stream) {
  if (b == 0 || h == 0 || out_w == 0) return NOTHING_LAUNCHED;
  if (rows < 1 || (smem != 0 && (int64_t)smem != (int64_t)rows * w * (int64_t)sizeof(float)))
    return (int)cudaErrorInvalidValue;
  const int groups = (h + rows - 1) / rows;
  const int warps = ((out_w + 3) / 4 + 31) / 32;
  const int threads = 32 * (warps < 8 ? warps : 8);
  const bool vec = w % 4 == 0 && out_w % 4 == 0 && (uintptr_t)imgs % 16 == 0 && (uintptr_t)tmp % 16 == 0;
  const auto kernel = smem ? (vec ? warp_pass1_kernel<true, true> : warp_pass1_kernel<false, true>)
                           : (vec ? warp_pass1_kernel<true, false> : warp_pass1_kernel<false, false>);
  if (smem > SHARED_DEFAULT) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(unsigned int)((int64_t)b * groups), threads, smem, (cudaStream_t)stream>>>(
      (const float*)imgs, (const float*)minv, (float*)tmp, h, w, out_w, rows, groups);
  return (int)cudaGetLastError();
}

// Pass 2 alone: tmp (b, src_h, out_w) and minv (b, 3, 3) contiguous ->
// out (b, out_h, out_w) contiguous.
extern "C" int warp_pass2_launch(const void* tmp, const void* minv, void* out,
                                 int b, int src_h, int out_h, int out_w, void* stream) {
  if (b == 0 || out_h == 0 || out_w == 0) return NOTHING_LAUNCHED;
  const dim3 block(TILE_U, TILE_WARPS);
  const dim3 grid(ceil_div(out_w, TILE_U), ceil_div(out_h, TILE_V), (unsigned int)b);
  warp_pass2_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)tmp, (const float*)minv, (float*)out, src_h, out_h, out_w);
  return (int)cudaGetLastError();
}

// The fused route: imgs (b, h, w) and minv (b, 3, 3) contiguous ->
// out (b, out_h, out_w) contiguous, in one kernel.
extern "C" int warp_fused_launch(const void* imgs, const void* minv, void* out,
                                 int b, int h, int w, int out_h, int out_w, void* stream) {
  if (b == 0 || out_h == 0 || out_w == 0) return NOTHING_LAUNCHED;
  const dim3 block(TILE_U, TILE_WARPS);
  const dim3 grid(ceil_div(out_w, TILE_U), ceil_div(out_h, TILE_V), (unsigned int)b);
  warp_fused_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)imgs, (const float*)minv, (float*)out, h, w, out_h, out_w);
  return (int)cudaGetLastError();
}
