// Inference BatchNorm, residual and activation in one pass, for Hopper (sm_90a).
//
//   t = (x[n, c, h, w] - mean[c]) * mul[c] + bias[c]     (mul = rsqrt(var + eps) * weight)
//   t = t + residual[n, c, h, w]                          (where a residual is given, before the activation)
//   t = relu(t) or silu(t) = t / (1 + exp(-t))            (where asked)
//   out[n, c, h, w] = t [+ residual[n, c, h, w]]          (a residual after the activation), in bf16 or float32
//
// The residual is bf16 or float32.  ReLU and the residual before it are
// the ResNet's (Flax's order); SiLU with the residual after it is the YOLO
// family's Bottleneck, x + cv2(cv1(x)) where cv2 ends in SiLU.
//
// No TPU kernel of the repository corresponds: in the JAX package XLA
// fuses Flax's BatchNorm on the running statistics (flax.linen.normalization
// _normalize: x - mean, times mul, plus bias, all in float32), the residual
// sum, the ReLU and the cast to the next convolution's dtype into one pass,
// so no float32 map of a layer is ever stored.  PyTorch's eager ops store
// each of them (a float32 copy of the conv output, the normalized map, the
// ReLU's map), which is what kept a batch of 1024 frames off an 80 GB card.
//
// Bound: device-memory bytes.  Each element is read once (2 or 4 bytes,
// and 4 more for a residual) and written once (2 or 4 bytes); the three
// channel arrays stay in L1/L2.  Design: one thread owns 8 consecutive
// elements of a dense map (NCHW, or NHWC in memory), loads them with
// 16-byte loads (one for bf16, two for float32), walks their channels by
// counting instead of dividing, and stores 16 bytes at a time.  A map that
// is not dense (a transposed view) takes a kernel that reads it through
// its four strides, one element a thread, and writes a contiguous NCHW map.
//
// Rounding: every operation is __fsub_rn / __fmul_rn / __fadd_rn /
// __fdiv_rn, so nvcc contracts nothing into an FMA, the ReLU keeps a NaN as
// torch's clamp_min does, SiLU's exp is expf (libdevice's, as torch.exp's
// float kernel), and the bf16 store rounds to nearest even with
// __float2bfloat16_rn, the conversion torch's own cast uses on this card:
// the kernel gives the plain version's (ops/bn_act.py:bn_act_plain) bits.
//
// A residual that is a channel slice of a wider map (the YOLO C3k2's second
// half of cv1's output) is read in place: in the dense kernel it is dense
// in blocks of res_block elements that lie res_pitch elements apart (one
// block for a dense residual; a batch item of an NCHW slice; a pixel of an
// NHWC slice).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 8;  // elements a thread of the dense kernel
constexpr int NOTHING_LAUNCHED = -1;
// activations (a template argument: each kernel's code holds one)
constexpr int ACT_NONE = 0, ACT_RELU = 1, ACT_SILU = 2;

struct Channels {
  const float* mean;
  const float* mul;
  const float* bias;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ void load8(const float* p, float v[VEC]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[VEC]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
  for (int k = 0; k < VEC; ++k) v[k] = __bfloat162float(h[k]);
}

__device__ __forceinline__ void store8(float* p, const float v[VEC]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float v[VEC]) {
  uint4 u;
  __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&u);
#pragma unroll
  for (int k = 0; k < VEC; ++k) h[k] = __float2bfloat16_rn(v[k]);
  *reinterpret_cast<uint4*>(p) = u;
}

struct Residual {
  const void* p;  // null: none
  bool bf16;      // else float32
  bool after;     // added after the activation, else before
};

__device__ __forceinline__ float res_at(const Residual& r, int64_t i) {
  return r.bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(r.p)[i]) : static_cast<const float*>(r.p)[i];
}

// The plain version's arithmetic on one element, in its order.
template <int ACT>
__device__ __forceinline__ float bn_one(float x, int c, const Channels& ch, const Residual& res, float r) {
  float t = __fadd_rn(__fmul_rn(__fsub_rn(x, ch.mean[c]), ch.mul[c]), ch.bias[c]);
  const bool has_res = res.p != nullptr;
  if (has_res && !res.after) t = __fadd_rn(t, r);
  if (ACT == ACT_RELU) t = isnan(t) ? t : fmaxf(t, 0.0f);
  if (ACT == ACT_SILU) t = __fdiv_rn(t, __fadd_rn(1.0f, expf(-t)));
  if (has_res && res.after) t = __fadd_rn(t, r);
  return t;
}

// x and out dense in one memory order; element i of it has channel
// (i / inner) % channels (inner = h * w for NCHW, 1 for NHWC), and the
// residual's element (i / res_block) * res_pitch + i % res_block (res_block
// a multiple of VEC, or n).
template <typename Tin, typename Tout, int ACT>
__global__ void __launch_bounds__(THREADS) bn_act_dense_kernel(
    const Tin* __restrict__ x, Channels ch, Residual res, Tout* __restrict__ out,
    int64_t n, int64_t inner, int channels, int64_t res_block, int64_t res_pitch) {
  const int64_t i0 = ((int64_t)blockIdx.x * THREADS + threadIdx.x) * VEC;
  if (i0 >= n) return;
  const bool has_res = res.p != nullptr;
  const int64_t q = i0 / inner;
  int64_t r = i0 - q * inner;
  int c = (int)(q % channels);
  float v[VEC], rv[VEC] = {};
  const bool whole = i0 + VEC <= n;
  int64_t ri = i0;
  if (has_res && res_block < n) ri = (i0 / res_block) * res_pitch + i0 % res_block;
  if (whole) {
    load8(x + i0, v);
    if (has_res) {
      if (res.bf16) load8(static_cast<const __nv_bfloat16*>(res.p) + ri, rv);
      else load8(static_cast<const float*>(res.p) + ri, rv);
    }
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      v[k] = i0 + k < n ? to_float(x[i0 + k]) : 0.0f;
      rv[k] = has_res && i0 + k < n ? res_at(res, ri + k) : 0.0f;
    }
  }
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    v[k] = bn_one<ACT>(v[k], c, ch, res, rv[k]);
    if (++r == inner) {
      r = 0;
      if (++c == channels) c = 0;
    }
  }
  if (whole) {
    store8(out + i0, v);
  } else {
    for (int k = 0; k < VEC && i0 + k < n; ++k) out[i0 + k] = from_float<Tout>(v[k]);
  }
}

struct Strides {
  int64_t n, c, h, w;
};

// x and residual through their strides; out contiguous NCHW.
template <typename Tin, typename Tout, int ACT>
__global__ void __launch_bounds__(THREADS) bn_act_strided_kernel(
    const Tin* __restrict__ x, Strides sx, Channels ch, Residual res, Strides sr,
    Tout* __restrict__ out, int64_t n, int channels, int height, int width) {
  const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const int w = (int)(i % width);
  int64_t t = i / width;
  const int h = (int)(t % height);
  t /= height;
  const int c = (int)(t % channels);
  const int64_t b = t / channels;
  const float xv = to_float(x[b * sx.n + c * sx.c + h * sx.h + w * sx.w]);
  const float rv = res.p != nullptr ? res_at(res, b * sr.n + c * sr.c + h * sr.h + w * sr.w) : 0.0f;
  out[i] = from_float<Tout>(bn_one<ACT>(xv, c, ch, res, rv));
}

inline unsigned int blocks_for(int64_t threads) { return (unsigned int)((threads + THREADS - 1) / THREADS); }

struct Shape {
  int64_t n;
  int channels, height, width;
  int64_t inner, res_block, res_pitch;
};

template <typename Tin, typename Tout, int ACT>
void launch_act(const void* x, Channels ch, Residual res, void* out, const Shape& s, bool dense, Strides sx,
                Strides sr, cudaStream_t stream) {
  if (dense) {
    bn_act_dense_kernel<Tin, Tout, ACT><<<blocks_for((s.n + VEC - 1) / VEC), THREADS, 0, stream>>>(
        (const Tin*)x, ch, res, (Tout*)out, s.n, s.inner, s.channels, s.res_block, s.res_pitch);
  } else {
    bn_act_strided_kernel<Tin, Tout, ACT><<<blocks_for(s.n), THREADS, 0, stream>>>(
        (const Tin*)x, sx, ch, res, sr, (Tout*)out, s.n, s.channels, s.height, s.width);
  }
}

template <typename Tin, typename Tout>
void launch(const void* x, Channels ch, Residual res, void* out, const Shape& s, bool dense, Strides sx,
            Strides sr, int act, cudaStream_t stream) {
  if (act == ACT_RELU) launch_act<Tin, Tout, ACT_RELU>(x, ch, res, out, s, dense, sx, sr, stream);
  else if (act == ACT_SILU) launch_act<Tin, Tout, ACT_SILU>(x, ch, res, out, s, dense, sx, sr, stream);
  else launch_act<Tin, Tout, ACT_NONE>(x, ch, res, out, s, dense, sx, sr, stream);
}

}  // namespace

// x: (batch, channels, height, width), bf16 (in_bf16) or float32; mean,
// mul, bias: float32 (channels); residual: bf16 (res_bf16) or float32 of
// x's shape, or null, added after the activation (res_after) or before it;
// act: 0 none, 1 ReLU, 2 SiLU; out: bf16 (out_bf16) or float32.  dense: x
// and out are dense in one memory order (inner = height * width for NCHW, 1
// for NHWC) and 16-byte aligned, x's strides are not read, and the residual
// is read in blocks of res_block elements res_pitch apart (both multiples
// of 8, 16-byte aligned; res_block = n for a dense one); otherwise x and
// residual are read through their strides (in elements) and out is
// contiguous NCHW.  Launches on `stream` and returns cudaGetLastError() of
// the launch, or NOTHING_LAUNCHED for a map with no element.
extern "C" int bn_act_launch(const void* x, const void* mean, const void* mul, const void* bias,
                             const void* residual, void* out, int in_bf16, int out_bf16, int act,
                             int res_bf16, int res_after, int batch, int channels, int height, int width,
                             int dense, int64_t inner, int64_t res_block, int64_t res_pitch,
                             int64_t sxn, int64_t sxc, int64_t sxh, int64_t sxw,
                             int64_t srn, int64_t src, int64_t srh, int64_t srw, void* stream) {
  const int64_t n = (int64_t)batch * channels * height * width;
  if (n == 0) return NOTHING_LAUNCHED;
  if (channels < 1 || act < ACT_NONE || act > ACT_SILU || (dense && (inner < 1 || res_block < 1)))
    return (int)cudaErrorInvalidValue;
  const Channels ch{(const float*)mean, (const float*)mul, (const float*)bias};
  const Residual res{residual, res_bf16 != 0, res_after != 0};
  const Shape shape{n, channels, height, width, inner, res_block, res_pitch};
  const Strides sx{sxn, sxc, sxh, sxw}, sr{srn, src, srh, srw};
  const auto s = (cudaStream_t)stream;
  if (in_bf16 && out_bf16)
    launch<__nv_bfloat16, __nv_bfloat16>(x, ch, res, out, shape, dense, sx, sr, act, s);
  else if (in_bf16)
    launch<__nv_bfloat16, float>(x, ch, res, out, shape, dense, sx, sr, act, s);
  else if (out_bf16)
    launch<float, __nv_bfloat16>(x, ch, res, out, shape, dense, sx, sr, act, s);
  else
    launch<float, float>(x, ch, res, out, shape, dense, sx, sr, act, s);
  return (int)cudaGetLastError();
}
