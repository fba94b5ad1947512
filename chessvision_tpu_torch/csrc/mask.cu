// The segmentation mask's threshold, for Hopper (sm_90a): float32 logits to
// a uint8 mask in one launch, with the count and the indices of the logits
// that lie in the band the host settles.
//
//   mask[i]  = x[i] > hi ? 255 : 0
//   band[0]  = #{ i : lo < x[i] <= hi }
//   band[1:] = those i, the first `capacity` of them to arrive, in no order
//
// The mask the engine returns is the host formula 1 / (1 + exp(-x)) > t in
// float32 numpy.  ops/mask.py:band gives the float32 edges lo < ln(t/(1-t))
// < hi outside which comparing the logit decides that formula exactly; the
// host evaluates the formula itself at the pixels inside (lo, hi], so the
// mask comes back bit for bit (engine._binary_mask).
//
// No TPU kernel of the repository corresponds: the JAX package computes the
// mask on the host with numpy after its copy back
// (chessvision_tpu/engine.py, Engine.process_batch).
//
// Bound: bytes, 4 read and 1 written a pixel (42 MB at B = 128 of 256²
// logits: 12.5 us at 3.35 TB/s).  Design: a grid-stride loop in which a
// thread reads a float4 and writes a uchar4; the n % 4 last values go to
// the first threads of block 0.  A band pixel takes a slot with an
// atomicAdd on the count and writes its index there while slots last: real
// logits land in the band a few dozen times a batch, so the atomics cost
// nothing, and the host settles the listed pixels without scanning the
// batch (it scans only where the list overflowed).  A NaN is neither above
// hi nor inside the band, so it gives 0, as the formula does.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 8;  // H100's 132 SMs, 8 blocks each
constexpr int NOTHING_LAUNCHED = -1;

// value i's mask; a band value is counted and, while slots last, listed
__device__ __forceinline__ unsigned char decide(float v, int i, float lo, float hi, int* band, int capacity) {
  if (v > lo && v <= hi) {
    const int slot = atomicAdd(band, 1);
    if (slot < capacity) band[1 + slot] = i;
  }
  return v > hi ? 255 : 0;
}

__global__ void __launch_bounds__(THREADS) mask_threshold_kernel(const float* __restrict__ x,
                                                                 unsigned char* __restrict__ mask, int n, float lo,
                                                                 float hi, int* __restrict__ band, int capacity) {
  const int n4 = n / 4;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  uchar4* m4 = reinterpret_cast<uchar4*>(mask);
  for (int i = blockIdx.x * THREADS + threadIdx.x; i < n4; i += gridDim.x * THREADS) {
    const float4 v = x4[i];
    const int j = 4 * i;
    m4[i] = make_uchar4(decide(v.x, j, lo, hi, band, capacity), decide(v.y, j + 1, lo, hi, band, capacity),
                        decide(v.z, j + 2, lo, hi, band, capacity), decide(v.w, j + 3, lo, hi, band, capacity));
  }
  if (blockIdx.x == 0 && threadIdx.x < n - n4 * 4) {
    const int i = n4 * 4 + threadIdx.x;
    mask[i] = decide(x[i], i, lo, hi, band, capacity);
  }
}

}  // namespace

// x: float32, n values (n < 2^31), 16-byte aligned; mask: uint8, n values,
// 4-byte aligned; band: int32, 1 + capacity values.  Zeroes the count and
// launches on `stream`; returns cudaGetLastError() of the launch, or
// NOTHING_LAUNCHED for n = 0 (the count zeroed all the same).
extern "C" int mask_threshold_launch(const float* x, unsigned char* mask, int* band, int n, int capacity, float lo,
                                     float hi, cudaStream_t stream) {
  if (n < 0 || capacity < 0) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaMemsetAsync(band, 0, sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return NOTHING_LAUNCHED;
  const int groups = n / 4 > 0 ? n / 4 : 1;
  int blocks = (groups + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  mask_threshold_kernel<<<blocks, THREADS, 0, stream>>>(x, mask, n, lo, hi, band, capacity);
  return (int)cudaGetLastError();
}
