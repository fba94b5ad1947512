// Per-row linear (hat) resample for Hopper (sm_90a).
//
//   out[n, u] = sum_j max(0, 1 - |pos[n, u] - j|) * src[n, j]
//
// with a zero border: a position in (-1, 0) or (J-1, J) keeps the partial
// weight of its one tap inside the row, and a position outside (-1, J)
// gives 0.
//
// Replaces the TPU kernel chessvision_tpu/ops/pallas_kernels.py:
// banded_resample, the function under both passes of the two-pass
// projective warp (chessvision_tpu/ops/warp.py:_hat_resample_dispatch).
//
// Bound: device-memory bytes.  Each output reads one position and two
// source values and writes one float; there are 4 flops per output.
// The TPU kernel contracted a band of the row against every output,
// because TPU lanes cannot gather; Hopper gathers, so each thread reads
// its two taps src[n, floor(pos)] and src[n, floor(pos) + 1] directly.
// One thread per output (n, u): neighbouring threads read neighbouring
// positions and write neighbouring outputs, so those accesses coalesce,
// and the taps of one row stay in L1/L2 across the warp.
//
// The weights are the same expression as the plain PyTorch version
// (1 - |pos - j|), and the products and the sum use __fmul_rn and
// __fadd_rn so that no FMA contraction changes the last bit: the result
// equals the plain version's bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void hat_resample_kernel(const float* __restrict__ src,
                                    const float* __restrict__ pos,
                                    float* __restrict__ out,
                                    int64_t total, int j, int u) {
  int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int64_t row = idx / u;
  const float p = pos[idx];
  float acc = 0.0f;
  if (p > -1.0f && p < (float)j) {
    const float f = floorf(p);
    const int i0 = (int)f;
    const float* s = src + row * (int64_t)j;
    float t0 = 0.0f;
    float t1 = 0.0f;
    if (i0 >= 0) {
      t0 = __fmul_rn(1.0f - fabsf(p - f), __ldg(s + i0));
    }
    if (i0 + 1 < j) {
      t1 = __fmul_rn(1.0f - fabsf(p - (f + 1.0f)), __ldg(s + i0 + 1));
    }
    acc = __fadd_rn(t0, t1);
  }
  out[idx] = acc;
}

}  // namespace

// src (n, j), pos (n, u), out (n, u): contiguous float32 on the device.
// Launches on `stream` and returns cudaGetLastError() of the launch.
extern "C" int hat_resample_launch(const void* src, const void* pos, void* out,
                                   int64_t n, int j, int u, void* stream) {
  const int64_t total = n * (int64_t)u;
  if (total == 0) return 0;
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  hat_resample_kernel<<<(unsigned int)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)src, (const float*)pos, (float*)out, total, j, u);
  return (int)cudaGetLastError();
}
