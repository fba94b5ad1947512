// The quadrangle's decimation, for Hopper (sm_90a): closed polygons of k
// points (B, k, 2) down to 4 vertices each, in one launch.
//
// Each of the k - 4 steps removes the active vertex whose deviation from the
// chord of its active neighbours is smallest (the lower index on equal
// values), then unlinks it:
//
//   dev[i] = |(a - p) x (c - p)| / max(|c - a|, 1e-6) + i * 1e-6     (active i)
//   dev[i] = 3e18                                                     (removed i)
//
// with a = p[prv[i]] and c = p[nxt[i]].  The result is the points at the
// first active index and the three that follow it along nxt.
//
// No TPU kernel of the repository corresponds: the JAX package runs this
// loop as plain jnp inside its jitted quadrangle (chessvision_tpu/ops/quad.py
// decimate_to_quad, a fori_loop that XLA keeps on the device).  PyTorch's
// eager version (ops/quad.py:decimate_to_quad_plain) launches 28 small kernels
// a step, about 1 680 a call at k = 64 whatever the batch, and the host's
// launches, not the device, set its time.
//
// Bound: the chain of k - 4 dependent steps, each a few dozen float
// operations and a 32-lane reduction; the bytes (k * 8 in, 32 out a board)
// are nothing.  Design: one warp a board, WARPS boards a block.  The board's
// points, prv, nxt and active flags live in shared memory; lane l owns the
// vertices l, l + 32, ... (up to 8 a lane, so k <= 256).  Every step each
// lane computes the deviations of its vertices, a __shfl_xor_sync butterfly
// takes the argmin over (value, index), and lane 0 unlinks the vertex
// before a __syncwarp.  No block-wide barrier: warps whose board lies past
// the batch return at once.
//
// Rounding: every operation is __fsub_rn / __fmul_rn / __fadd_rn /
// __fdiv_rn / __fsqrt_rn in the plain version's order, so nvcc contracts
// nothing into an FMA (a*b - c*d would become one at -O3), the clamp keeps
// a NaN as torch's clamp_min does, and the argmin ranks a NaN first and
// takes the lower index on equal values, as torch.argmin does: the kernel
// gives the plain version's bits.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int WARPS = 4;         // boards a block
constexpr int MAX_K = 256;       // points a board
constexpr int PER_LANE = MAX_K / 32;
constexpr int NOTHING_LAUNCHED = -1;
constexpr unsigned FULL = 0xffffffffu;
constexpr float REMOVED = 3.0e18f;

// torch.argmin's order: a NaN before any number, then the smaller value,
// then the lower index
__device__ __forceinline__ bool before(float v, int i, float w, int j) {
  const bool vn = v != v, wn = w != w;
  if (vn || wn) return vn && (!wn || i < j);
  return v < w || (v == w && i < j);
}

__global__ void __launch_bounds__(WARPS * 32) quad_decimate_kernel(const float2* __restrict__ pts,
                                                                   float2* __restrict__ out, int b, int k) {
  __shared__ float2 s_pts[WARPS][MAX_K];
  __shared__ int s_prv[WARPS][MAX_K];
  __shared__ int s_nxt[WARPS][MAX_K];
  __shared__ bool s_active[WARPS][MAX_K];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int board = blockIdx.x * WARPS + warp;
  if (board >= b) return;
  float2* p = s_pts[warp];
  int* prv = s_prv[warp];
  int* nxt = s_nxt[warp];
  bool* active = s_active[warp];
  const float2* src = pts + (size_t)board * k;
  for (int i = lane; i < k; i += 32) {
    p[i] = src[i];
    prv[i] = i == 0 ? k - 1 : i - 1;
    nxt[i] = i == k - 1 ? 0 : i + 1;
    active[i] = true;
  }
  __syncwarp();

  for (int step = 0; step < k - 4; ++step) {
    float best = __int_as_float(0x7f800000);  // +inf: loses to every vertex on its index
    int best_i = INT_MAX;
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) {
      const int i = lane + 32 * j;
      if (i < k) {
        float v = REMOVED;
        if (active[i]) {
          const float2 a = p[prv[i]], q = p[i], c = p[nxt[i]];
          const float cross = fabsf(__fsub_rn(__fmul_rn(__fsub_rn(a.x, q.x), __fsub_rn(c.y, q.y)),
                                              __fmul_rn(__fsub_rn(a.y, q.y), __fsub_rn(c.x, q.x))));
          const float dx = __fsub_rn(c.x, a.x), dy = __fsub_rn(c.y, a.y);
          const float chord = __fsqrt_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
          const float dist = __fdiv_rn(cross, chord != chord ? chord : fmaxf(chord, 1e-6f));
          v = __fadd_rn(dist, __fmul_rn((float)i, 1e-6f));
        }
        if (before(v, i, best, best_i)) {
          best = v;
          best_i = i;
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float w = __shfl_xor_sync(FULL, best, off);
      const int j = __shfl_xor_sync(FULL, best_i, off);
      if (before(w, j, best, best_i)) {
        best = w;
        best_i = j;
      }
    }
    if (lane == 0) {
      const int pr = prv[best_i], nx = nxt[best_i];
      active[best_i] = false;
      nxt[pr] = nx;
      prv[nx] = pr;
    }
    __syncwarp();
  }

  if (lane == 0) {
    int i = 0;
    while (!active[i]) ++i;
    float2* o = out + (size_t)board * 4;
    for (int c = 0; c < 4; ++c, i = nxt[i]) o[c] = p[i];
  }
}

}  // namespace

// pts: contiguous float32 (b, k, 2), 4 <= k <= 256; out: float32 (b, 4, 2).
// Launches on `stream` and returns cudaGetLastError() of the launch, or
// NOTHING_LAUNCHED for an empty batch.
extern "C" int quad_decimate_launch(const float* pts, float* out, int b, int k, cudaStream_t stream) {
  if (b == 0) return NOTHING_LAUNCHED;
  if (b < 0 || k < 4 || k > MAX_K) return (int)cudaErrorInvalidValue;
  const unsigned int blocks = (unsigned int)((b + WARPS - 1) / WARPS);
  quad_decimate_kernel<<<blocks, WARPS * 32, 0, stream>>>((const float2*)pts, (float2*)out, b, k);
  return (int)cudaGetLastError();
}
