// Flash attention for Hopper (sm_90a): the forward (K1), the dq backward
// (K2) and the dk/dv backward (K3), on [batch*heads, seq, head_dim]
// tensors in float32 or bfloat16, head_dim 64 or 128, any sq, sk >= 1.
//
// Replaces the TPU kernels of flexflow_tpu/ops/pallas/flash_attention.py:
//   K1 flash_fwd_kernel      <- _fwd_kernel      (launched by _flash_fwd_pallas)
//   K2 flash_bwd_dq_kernel   <- _bwd_dq_kernel   (launched by _flash_bwd_pallas)
//   K3 flash_bwd_dkv_kernel  <- _bwd_dkv_kernel  (launched by _flash_bwd_pallas)
// They compute what the Pallas kernels compute, not grid step by grid
// step:
//   K1: S = Q K^T * scale, online softmax in float32 (running max m,
//       denominator l, context acc), O = acc / l_safe and LSE = m + log
//       l_safe with l_safe = l > 0 ? l : 1.  P is rounded to V's dtype
//       before P V, as the TPU kernel casts it.
//   K2: P = exp(S - LSE) recomputed per tile, dS = P (dO V^T - delta) *
//       scale rounded to K's dtype, dQ = sum over kv tiles of dS K.
//   K3: dV = sum over q tiles of P^T dO (P rounded to dO's dtype), dK =
//       sum of dS^T Q (dS rounded to Q's dtype); under causal it starts at
//       the first q tile that sees the kv tile.
// delta = rowsum(dO * O) is one torch reduction in the wrapper, shared by
// K2 and K3, as the reference computes it outside its kernels.
// Causal is the reference's tril(ones(sq, sk)) in absolute positions: q
// row i sees keys 0..i, also when sq != sk.  Masked and out-of-range keys
// take no weight (-inf before the max in K1, P = 0 in K2/K3); the TPU
// kernels use the finite -1e30 there, which gives the same sums because
// key 0 is live for every row and sets the running max in the first kv
// tile.  A row that no key reaches keeps m = -1e30 and l = 0, so its LSE
// is -1e30 and its output 0, and the backward gives it P = 0.
//
// Bound: at the training shape (bh 96, seq 2048, d 64) each kernel does
// two to four products of [64 x 64 x d] per pair of tiles and reads each
// input once per tile pair from L2, so it is bound by operations: in
// float32 by the SIMT FMA rate, since the parity checks need full
// float32 and TF32 stays off.  The design, simple first:
//   * one block of 256 threads per (bh, 64-row tile); K1 and K2 loop over
//     the kv tiles, K3 (one block per kv tile) over the q tiles, so every
//     output tile has one owner: no atomics, the same sums in the same
//     order on every run;
//   * tiles are staged in shared memory as float32 rows padded by 4
//     floats, so 16-byte loads of 8 neighbouring rows fall in distinct
//     banks;
//   * each thread owns a 4 x 4 block of the 64 x 64 score tile (rows
//     4*ty + i, columns tx + 16*j) and reads its operands as float4 along
//     d: 8 shared-memory loads for 64 FMAs.  A row's 16 owners are one
//     half-warp, so the softmax reductions are 4 shuffles;
//   * the [64 x d] accumulators are split over the 16 threads of a row
//     group (4 or 8 columns each), so d = 128 does not spill;
//   * K2 and K3 keep dS and P in shared memory only: the [s, s]
//     probabilities never reach device memory.
// bfloat16 inputs are widened to float32 on load and use the same float32
// SIMT path; wgmma tensor cores, TMA and warp specialisation are later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;          // rows of a q tile and of a kv tile
constexpr int kThreads = 256;      // 16 x 16 threads, a 4 x 4 block each
constexpr int kPS = kTile + 4;     // row stride of the [64][64] tiles
constexpr float kNegInf = -1e30f;  // the TPU kernels' running-max start

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
  return __float2bfloat16(x);
}

// x rounded through T: the reference's casts of P and dS before a product
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32<T>(from_f32<T>(x));
}

__device__ __forceinline__ float component(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// four neighbouring elements of a row, widened to float32
template <typename T>
__device__ __forceinline__ float4 load4(const T* p);
template <>
__device__ __forceinline__ float4 load4<float>(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
template <>
__device__ __forceinline__ float4 load4<__nv_bfloat16>(const __nv_bfloat16* p) {
  const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 lo = __bfloat1622float2(p2[0]);
  const float2 hi = __bfloat1622float2(p2[1]);
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

template <typename T>
__device__ __forceinline__ void store4(T* p, float4 v);
template <>
__device__ __forceinline__ void store4<float>(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
template <>
__device__ __forceinline__ void store4<__nv_bfloat16>(__nv_bfloat16* p,
                                                      float4 v) {
  __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(p);
  p2[0] = __floats2bfloat162_rn(v.x, v.y);
  p2[1] = __floats2bfloat162_rn(v.z, v.w);
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Rows [row0, row0 + 64) of a row-major [n_rows, D] matrix into
// dst[64][D + 4] as float32; rows at or past n_rows read as 0.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int row0, int n_rows) {
  constexpr int kVecs = D / 4;
  for (int idx = threadIdx.x; idx < kTile * kVecs; idx += kThreads) {
    const int r = idx / kVecs, c = (idx % kVecs) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n_rows) v = load4<T>(src + (size_t)(row0 + r) * D + c);
    *reinterpret_cast<float4*>(dst + r * (D + 4) + c) = v;
  }
}

// acc[i][j] += A[4*ty + i] . B[tx + 16*j] over d, for A and B in [64][D + 4]
template <int D>
__device__ __forceinline__ void dot_tile(const float* A, const float* B,
                                         int ty, int tx, float acc[4][4]) {
  constexpr int DS = D + 4;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (4 * ty + i) * DS + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(B + (tx + 16 * j) * DS + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float s = acc[i][j];
        s = fmaf(a[i].x, b[j].x, s);
        s = fmaf(a[i].y, b[j].y, s);
        s = fmaf(a[i].z, b[j].z, s);
        s = fmaf(a[i].w, b[j].w, s);
        acc[i][j] = s;
      }
  }
}

// acc[i][u] += sum_c P[4*ty + i][c] * M[c][64*u + 4*tx .. +3], for P in
// [64][kPS] and M in [64][D + 4]: the thread's 4 rows times its D/16
// columns of a [64 x 64] x [64 x D] product.
template <int D>
__device__ __forceinline__ void pm_tile(const float* P, const float* M,
                                        int ty, int tx,
                                        float4 acc[4][D / 64]) {
  constexpr int DS = D + 4, NU = D / 64;
#pragma unroll 2
  for (int c = 0; c < kTile; c += 4) {
    float4 p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p[i] = *reinterpret_cast<const float4*>(P + (4 * ty + i) * kPS + c);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        const float4 m = *reinterpret_cast<const float4*>(
            M + (c + cc) * DS + 64 * u + 4 * tx);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float w = component(p[i], cc);
          acc[i][u].x = fmaf(w, m.x, acc[i][u].x);
          acc[i][u].y = fmaf(w, m.y, acc[i][u].y);
          acc[i][u].z = fmaf(w, m.z, acc[i][u].z);
          acc[i][u].w = fmaf(w, m.w, acc[i][u].w);
        }
      }
    }
  }
}

// kv tiles that q tile [q0, q0 + 64) reads: all of them, or under causal
// those up to its last live row
__device__ __forceinline__ int kv_tiles(int q0, int sq, int sk, int causal) {
  int n = (sk + kTile - 1) / kTile;
  if (causal) n = min(n, (min(q0 + kTile, sq) - 1) / kTile + 1);
  return n;
}

// K1.  grid (q tiles, bh); o [bh, sq, D] in T, lse [bh, sq] float32.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int sq, int sk, float scale,
                 int causal) {
  constexpr int DS = D + 4, NU = D / 64;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [64][DS]
  float* Ks = Qs + kTile * DS;                   // [64][DS]
  float* Vs = Ks + kTile * DS;                   // [64][DS]
  float* Ps = Vs + kTile * DS;                   // [64][kPS]
  const int q0 = blockIdx.x * kTile;
  const size_t bh = blockIdx.y;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const T* kb = k + bh * sk * D;
  const T* vb = v + bh * sk * D;
  load_tile<T, D>(Qs, q + bh * sq * D, q0, sq);

  float m[4], l[4];
  float4 acc[4][NU];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int u = 0; u < NU; ++u) acc[i][u] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  const int n_kt = kv_tiles(q0, sq, sk, causal);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the last tile's readers are done with Ks, Vs, Ps
    load_tile<T, D>(Ks, kb, k0, sk);
    load_tile<T, D>(Vs, vb, k0, sk);
    __syncthreads();
    float s[4][4] = {};
    dot_tile<D>(Qs, Ks, ty, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + 4 * ty + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (kp >= sk || (causal && kp > qp)) x = -INFINITY;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        Ps[(4 * ty + i) * kPS + tx + 16 * j] = round_to<T>(p);
      }
      l[i] = l[i] * corr + half_warp_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        acc[i][u].x *= corr;
        acc[i][u].y *= corr;
        acc[i][u].z *= corr;
        acc[i][u].w *= corr;
      }
    }
    __syncthreads();
    pm_tile<D>(Ps, Vs, ty, tx, acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + 4 * ty + i;
    if (r >= sq) continue;
    const float ls = l[i] > 0.f ? l[i] : 1.f;
    T* orow = o + (bh * sq + r) * D;
#pragma unroll
    for (int u = 0; u < NU; ++u)
      store4<T>(orow + 64 * u + 4 * tx,
                make_float4(acc[i][u].x / ls, acc[i][u].y / ls,
                            acc[i][u].z / ls, acc[i][u].w / ls));
    if (tx == 0) lse[bh * sq + r] = m[i] + logf(ls);
  }
}

// K2.  grid (q tiles, bh); dq [bh, sq, D] in T.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int sq, int sk, float scale, int causal) {
  constexpr int DS = D + 4, NU = D / 64;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [64][DS]
  float* dOs = Qs + kTile * DS;                  // [64][DS]
  float* Ks = dOs + kTile * DS;                  // [64][DS]
  float* Vs = Ks + kTile * DS;                   // [64][DS]
  float* dSs = Vs + kTile * DS;                  // [64][kPS]
  const int q0 = blockIdx.x * kTile;
  const size_t bh = blockIdx.y;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const T* kb = k + bh * sk * D;
  const T* vb = v + bh * sk * D;
  load_tile<T, D>(Qs, q + bh * sq * D, q0, sq);
  load_tile<T, D>(dOs, dout + bh * sq * D, q0, sq);

  float lse_r[4], dl_r[4];
  float4 acc[4][NU];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + 4 * ty + i;
    lse_r[i] = r < sq ? lse[bh * sq + r] : 0.f;
    dl_r[i] = r < sq ? delta[bh * sq + r] : 0.f;
#pragma unroll
    for (int u = 0; u < NU; ++u) acc[i][u] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  const int n_kt = kv_tiles(q0, sq, sk, causal);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile<T, D>(Ks, kb, k0, sk);
    load_tile<T, D>(Vs, vb, k0, sk);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    dot_tile<D>(Qs, Ks, ty, tx, s);
    dot_tile<D>(dOs, Vs, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        const bool live = qp < sq && kp < sk && !(causal && kp > qp);
        const float p = live ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
        dSs[(4 * ty + i) * kPS + tx + 16 * j] =
            round_to<T>(p * (dp[i][j] - dl_r[i]) * scale);
      }
    }
    __syncthreads();
    pm_tile<D>(dSs, Ks, ty, tx, acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + 4 * ty + i;
    if (r >= sq) continue;
    T* row = dq + (bh * sq + r) * D;
#pragma unroll
    for (int u = 0; u < NU; ++u) store4<T>(row + 64 * u + 4 * tx, acc[i][u]);
  }
}

// K3.  grid (kv tiles, bh); dk, dv [bh, sk, D] in T.  The thread owns kv
// rows 4*ty + i and q columns tx + 16*j of the transposed score tile.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int sq, int sk, float scale,
                     int causal) {
  constexpr int DS = D + 4, NU = D / 64;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);  // [64][DS]
  float* Vs = Ks + kTile * DS;                   // [64][DS]
  float* Qs = Vs + kTile * DS;                   // [64][DS]
  float* dOs = Qs + kTile * DS;                  // [64][DS]
  float* Ps = dOs + kTile * DS;                  // [64][kPS]  P^T
  float* dSs = Ps + kTile * kPS;                 // [64][kPS]  dS^T
  const int k0 = blockIdx.x * kTile;
  const size_t bh = blockIdx.y;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const T* qb = q + bh * sq * D;
  const T* dob = dout + bh * sq * D;
  load_tile<T, D>(Ks, k + bh * sk * D, k0, sk);
  load_tile<T, D>(Vs, v + bh * sk * D, k0, sk);

  float4 dk_acc[4][NU], dv_acc[4][NU];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      dk_acc[i][u] = make_float4(0.f, 0.f, 0.f, 0.f);
      dv_acc[i][u] = make_float4(0.f, 0.f, 0.f, 0.f);
    }

  // under causal, q rows before k0 see none of this tile's keys
  const int n_qt = (sq + kTile - 1) / kTile;
  for (int qt = causal ? k0 / kTile : 0; qt < n_qt; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();
    load_tile<T, D>(Qs, qb, q0, sq);
    load_tile<T, D>(dOs, dob, q0, sq);
    float lse_c[4], dl_c[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = q0 + tx + 16 * j;
      lse_c[j] = r < sq ? lse[bh * sq + r] : 0.f;
      dl_c[j] = r < sq ? delta[bh * sq + r] : 0.f;
    }
    __syncthreads();
    float st[4][4] = {}, dpt[4][4] = {};
    dot_tile<D>(Ks, Qs, ty, tx, st);
    dot_tile<D>(Vs, dOs, ty, tx, dpt);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kp = k0 + 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qp = q0 + tx + 16 * j;
        const bool live = qp < sq && kp < sk && !(causal && kp > qp);
        const float p = live ? expf(st[i][j] * scale - lse_c[j]) : 0.f;
        Ps[(4 * ty + i) * kPS + tx + 16 * j] = round_to<T>(p);
        dSs[(4 * ty + i) * kPS + tx + 16 * j] =
            round_to<T>(p * (dpt[i][j] - dl_c[j]) * scale);
      }
    }
    __syncthreads();
    pm_tile<D>(Ps, dOs, ty, tx, dv_acc);
    pm_tile<D>(dSs, Qs, ty, tx, dk_acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = k0 + 4 * ty + i;
    if (r >= sk) continue;
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      store4<T>(dk + (bh * sk + r) * D + 64 * u + 4 * tx, dk_acc[i][u]);
      store4<T>(dv + (bh * sk + r) * D + 64 * u + 4 * tx, dv_acc[i][u]);
    }
  }
}

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, size_t smem_floats, int tiles, int bh,
                   cudaStream_t stream, Args... args) {
  const size_t smem = sizeof(float) * smem_floats;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(tiles, bh), kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o,
                void* lse, int bh, int sq, int sk, float scale, int causal,
                cudaStream_t s) {
  return launch(flash_fwd_kernel<T, D>, 3 * kTile * (D + 4) + kTile * kPS,
                (sq + kTile - 1) / kTile, bh, s, static_cast<const T*>(q),
                static_cast<const T*>(k), static_cast<const T*>(v),
                static_cast<T*>(o), static_cast<float*>(lse), sq, sk, scale,
                causal);
}

template <typename T, int D>
cudaError_t bwd_dq(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, int bh, int sq, int sk, float scale, int causal,
                   cudaStream_t s) {
  return launch(flash_bwd_dq_kernel<T, D>, 4 * kTile * (D + 4) + kTile * kPS,
                (sq + kTile - 1) / kTile, bh, s, static_cast<const T*>(q),
                static_cast<const T*>(k), static_cast<const T*>(v),
                static_cast<const T*>(dout), static_cast<const float*>(lse),
                static_cast<const float*>(delta), static_cast<T*>(dq), sq, sk,
                scale, causal);
}

template <typename T, int D>
cudaError_t bwd_dkv(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    void* dk, void* dv, int bh, int sq, int sk, float scale,
                    int causal, cudaStream_t s) {
  return launch(flash_bwd_dkv_kernel<T, D>,
                4 * kTile * (D + 4) + 2 * kTile * kPS,
                (sk + kTile - 1) / kTile, bh, s, static_cast<const T*>(q),
                static_cast<const T*>(k), static_cast<const T*>(v),
                static_cast<const T*>(dout), static_cast<const float*>(lse),
                static_cast<const float*>(delta), static_cast<T*>(dk),
                static_cast<T*>(dv), sq, sk, scale, causal);
}

bool bad_shape(int bh, int sq, int sk) {
  return bh < 1 || bh > 65535 || sq < 1 || sk < 1;
}

}  // namespace

// FN<T, D>(args) for dtype (0 float32, 1 bfloat16) and head_dim (64, 128)
#define FF_DISPATCH(FN, ...)                                                \
  do {                                                                      \
    if (dtype == 0 && head_dim == 64) return (int)FN<float, 64>(__VA_ARGS__); \
    if (dtype == 0 && head_dim == 128)                                      \
      return (int)FN<float, 128>(__VA_ARGS__);                              \
    if (dtype == 1 && head_dim == 64)                                       \
      return (int)FN<__nv_bfloat16, 64>(__VA_ARGS__);                       \
    if (dtype == 1 && head_dim == 128)                                      \
      return (int)FN<__nv_bfloat16, 128>(__VA_ARGS__);                      \
    return (int)cudaErrorInvalidValue;                                      \
  } while (0)

// q [bh, sq, d], k and v [bh, sk, d], o [bh, sq, d]; lse [bh, sq] float32.
// dtype: 0 = float32, 1 = bfloat16.  Each entry point returns the launch's
// cudaError_t.
extern "C" int ff_flash_fwd(const void* q, const void* k, const void* v,
                            void* o, void* lse, int bh, int sq, int sk,
                            int head_dim, float scale, int causal, int dtype,
                            void* stream) {
  if (bad_shape(bh, sq, sk)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FF_DISPATCH(fwd, q, k, v, o, lse, bh, sq, sk, scale, causal, s);
}

// dout [bh, sq, d]; lse and delta [bh, sq] float32; dq [bh, sq, d].
extern "C" int ff_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dq, int bh, int sq,
                               int sk, int head_dim, float scale, int causal,
                               int dtype, void* stream) {
  if (bad_shape(bh, sq, sk)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FF_DISPATCH(bwd_dq, q, k, v, dout, lse, delta, dq, bh, sq, sk, scale,
              causal, s);
}

// dk and dv [bh, sk, d].
extern "C" int ff_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dk, void* dv, int bh,
                                int sq, int sk, int head_dim, float scale,
                                int causal, int dtype, void* stream) {
  if (bad_shape(bh, sq, sk)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FF_DISPATCH(bwd_dkv, q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, scale,
              causal, s);
}

extern "C" const char* ff_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
