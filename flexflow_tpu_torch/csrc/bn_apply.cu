// P1: BatchNorm apply with the residual add and the ReLU that follow it,
// y = max(x * scale + shift + res, 0), over [M, C] rows, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `pallas_apply` of scripts/resnet_bn_probe.py
// (the Pallas kernel over 256-row blocks of a channels-last [M, C]
// tensor).  It computes the same function: per element, x times its
// channel's scale plus its channel's shift, plus the residual, then the
// ReLU, in float32 registers, rounded once to x's dtype.  Compile-time
// variants drop the residual and the ReLU, so every BatchNorm apply of
// a ResNet runs here: with both (bn3 -> add -> relu), with the ReLU only
// (bn1, bn2, the stem) or with neither (the downsample branch).  The
// multiply and the adds are __fmul_rn / __fadd_rn, never contracted to
// an FMA, so the kernel gives the bits of its plain PyTorch version.
//
// Bound: bytes.  Each element is read once (x, and res) and written
// once, with 2-4 flops between, far below the card's ratio of
// operations to bytes; the best the kernel can do is stream at the
// memory rate.  What this simple design does about it:
//   * a grid-stride loop over 16-byte vectors of the flat [M, C] array
//     (8 bfloat16 or 4 float32 per load), neighbouring threads on
//     neighbouring vectors, so every warp load and store is 512
//     coalesced bytes;
//   * the grid is sized so that its stride is a whole number of rows:
//     each thread then meets the same kV channels in every vector it
//     touches, and holds their scale and shift in registers, read once
//     (no shared memory, whose per-element reads at a stride of kV
//     words would conflict on the banks; no division in the loop);
//   * each thread keeps kUnroll vectors of x (and res) in flight before
//     it computes, so one resident wave of blocks (8 blocks of 256
//     threads per SM) covers the memory latency;
//   * a scalar path, one element per thread step, when C is not a
//     multiple of the vector width or a pointer is not 16-byte aligned;
//     and, when no grid of at most one wave has a stride of whole rows
//     (C of more than ~1000 channels with few factors of 2), a general
//     loop that advances its channel by the stride mod C and reads scale
//     and shift through the read-only cache.
// The TPU kernel walks 256-row blocks on a sequential grid; here the
// blocks run in parallel and each owns a strided set of vectors, so
// nothing is carried between them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 2048 / kThreads;
constexpr int kUnroll = 4;

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

// kV elements of T in one aligned load or store (16 bytes when kV > 1)
template <typename T, int kV>
struct alignas(sizeof(T) * kV) Pack {
  T v[kV];
};

template <typename T, int kV, bool kRes, bool kRelu>
__device__ __forceinline__ Pack<T, kV> apply(const Pack<T, kV>& a,
                                             const Pack<T, kV>& r,
                                             const float* s,
                                             const float* b) {
  Pack<T, kV> out;
#pragma unroll
  for (int j = 0; j < kV; ++j) {
    float v = __fadd_rn(__fmul_rn(to_f32(a.v[j]), s[j]), b[j]);
    if constexpr (kRes) v = __fadd_rn(v, to_f32(r.v[j]));
    if constexpr (kRelu) v = v < 0.f ? 0.f : v;  // keeps NaN, as torch.relu
    out.v[j] = from_f32<T>(v);
  }
  return out;
}

// fixed: the grid's stride is a whole number of rows, so every unit a
// thread touches starts at the same channel
template <typename T, int kV, bool kRes, bool kRelu>
__global__ void __launch_bounds__(kThreads)
    bn_apply_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                    const T* __restrict__ shift, const T* __restrict__ res,
                    T* __restrict__ y, long long units, int channels,
                    bool fixed) {
  using P = Pack<T, kV>;
  const P* xv = reinterpret_cast<const P*>(x);
  const P* rv = reinterpret_cast<const P*>(res);
  P* yv = reinterpret_cast<P*>(y);
  long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads;
  // channel of the first element of unit i; kV divides C on the vector
  // path, so a unit never crosses a row
  int c = (int)((i * kV) % channels);
  float s[kV], b[kV];
  if (fixed) {
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      s[j] = to_f32(__ldg(scale + c + j));
      b[j] = to_f32(__ldg(shift + c + j));
    }
    for (; i < units; i += kUnroll * stride) {
      P a[kUnroll], r[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long k = i + u * stride;
        if (k < units) {
          a[u] = xv[k];
          if constexpr (kRes) r[u] = rv[k];
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long k = i + u * stride;
        if (k < units) yv[k] = apply<T, kV, kRes, kRelu>(a[u], r[u], s, b);
      }
    }
    return;
  }
  const int step = (int)((stride * kV) % channels);
  for (; i < units; i += stride) {
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      s[j] = to_f32(__ldg(scale + c + j));
      b[j] = to_f32(__ldg(shift + c + j));
    }
    P r;
    if constexpr (kRes) r = rv[i];
    yv[i] = apply<T, kV, kRes, kRelu>(xv[i], r, s, b);
    c += step;
    if (c >= channels) c -= channels;
  }
}

int sm_count() {
  static int counts[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (counts[dev] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        n <= 0)
      n = 132;
    counts[dev] = n;
  }
  return counts[dev];
}

long long gcd(long long a, long long b) {
  while (b) {
    const long long t = a % b;
    a = b;
    b = t;
  }
  return a;
}

template <typename T, int kV, bool kRes, bool kRelu>
cudaError_t launch(const void* x, const void* scale, const void* shift,
                   const void* res, void* y, long long rows, int channels,
                   cudaStream_t stream) {
  const long long units = rows * channels / kV;
  const long long wave = (long long)sm_count() * kBlocksPerSm;
  long long blocks = (units + kThreads - 1) / kThreads;
  if (blocks > wave) blocks = wave;
  // the grid's stride, blocks * kThreads * kV elements, is a whole
  // number of rows when blocks is a multiple of g
  const long long g = channels / gcd(channels, (long long)kThreads * kV);
  const bool fixed = g <= wave;
  if (fixed) blocks = blocks < g ? g : blocks / g * g;
  bn_apply_kernel<T, kV, kRes, kRelu><<<(int)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(scale),
      static_cast<const T*>(shift), static_cast<const T*>(res),
      static_cast<T*>(y), units, channels, fixed);
  return cudaGetLastError();
}

template <typename T, int kV>
cudaError_t dispatch(const void* x, const void* scale, const void* shift,
                     const void* res, void* y, long long rows, int channels,
                     bool relu, cudaStream_t s) {
  if (res && relu)
    return launch<T, kV, true, true>(x, scale, shift, res, y, rows, channels,
                                     s);
  if (res)
    return launch<T, kV, true, false>(x, scale, shift, res, y, rows,
                                      channels, s);
  if (relu)
    return launch<T, kV, false, true>(x, scale, shift, res, y, rows,
                                      channels, s);
  return launch<T, kV, false, false>(x, scale, shift, res, y, rows, channels,
                                     s);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// x, res, y: [rows, channels] row-major in dtype (0 float32, 1 bfloat16);
// scale, shift: [channels] in the same dtype; res may be null.  Returns
// the launch's cudaGetLastError().
extern "C" int ff_bn_apply(const void* x, const void* scale,
                           const void* shift, const void* res, void* y,
                           long long rows, int channels, int relu, int dtype,
                           void* stream) {
  if (rows < 0 || channels < 1) return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = aligned16(x) && aligned16(y) && (!res || aligned16(res));
  if (dtype == 0) {
    if (vec && channels % 4 == 0)
      return (int)dispatch<float, 4>(x, scale, shift, res, y, rows, channels,
                                     relu != 0, s);
    return (int)dispatch<float, 1>(x, scale, shift, res, y, rows, channels,
                                   relu != 0, s);
  }
  if (dtype == 1) {
    if (vec && channels % 8 == 0)
      return (int)dispatch<__nv_bfloat16, 8>(x, scale, shift, res, y, rows,
                                             channels, relu != 0, s);
    return (int)dispatch<__nv_bfloat16, 1>(x, scale, shift, res, y, rows,
                                           channels, relu != 0, s);
  }
  return (int)cudaErrorInvalidValue;
}

// 1 when ff_bn_apply takes the 16-byte vector path for these arguments
extern "C" int ff_bn_apply_vectorized(const void* x, const void* res,
                                      const void* y, int channels,
                                      int dtype) {
  const int width = dtype == 0 ? 4 : 8;
  return aligned16(x) && aligned16(y) && (!res || aligned16(res)) &&
         channels % width == 0;
}

extern "C" const char* ff_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
