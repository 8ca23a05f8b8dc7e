// Paged attention, the read side of the paged-KV decode step, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel `_paged_kernel` launched by `paged_attention`
// in flexflow_tpu/ops/pallas/paged_attention.py.  It computes the same
// function: for row i and chunk token j, softmax over the key positions
// 0 .. seq_lens[i] + j of the row's pages, read in place through
// block_table[i, :], then the context product with the value pages.
// The online softmax (running max m, denominator l, context acc) is
// float32; masked scores use the TPU kernel's finite -1e30, and a row
// whose l is 0 divides by 1.
//
// Bound: bytes.  Every KV byte a row attends is read once and takes two
// flops per element (one for q.k, one for p.v), far below the card's
// ratio of operations to bytes, so the kernel can at best stream the
// row's live pages at the memory rate.  What this simple design does
// about it:
//   * one block per (head, row) reads only that row's live pages, like
//     the TPU kernel's grid steps past the live count that fetch
//     nothing; the dense [rows, max_seq] view of the gather
//     formulation never exists;
//   * the warps of a block take a page's tokens in turn, so neighbouring
//     warps read neighbouring tokens and every lane reads neighbouring
//     head-dim elements of one token;
//   * each warp prefetches its next token's k and v rows before it
//     folds the current one into its state, so two tokens per warp are
//     in flight.
// The TPU kernel carries m/l/acc across a sequential grid axis; here
// each warp keeps its own state in registers and the warps' states are
// merged through shared memory at the end.  Splitting long rows over
// several blocks, cp.async/TMA pipelines and tensor cores for the chunk
// case are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kMaxChunk = 16;
constexpr float kNegInf = -1e30f;

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

template <typename T, int E>
__device__ __forceinline__ void load_row(const T* __restrict__ pool,
                                         size_t base, int lane, float* dst) {
#pragma unroll
  for (int e = 0; e < E; ++e) dst[e] = to_f32(pool[base + lane + 32 * e]);
}

// q, out: [batch, chunk, heads, D]; k_pool, v_pool: [blocks, page, heads, D]
// block_table: [batch, table_width] int32; seq_lens: [batch] int32.
template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                       const T* __restrict__ v_pool,
                       const int32_t* __restrict__ block_table,
                       const int32_t* __restrict__ seq_lens,
                       T* __restrict__ out, int chunk, int heads, int page,
                       int table_width, float scale) {
  constexpr int E = D / 32;  // head-dim elements per lane
  const int hh = blockIdx.x;
  const int row = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  extern __shared__ float smem[];
  float* q_s = smem;                          // [chunk][D]
  float* acc_s = q_s + chunk * D;             // [kWarps][chunk][D]
  float* m_s = acc_s + kWarps * chunk * D;    // [kWarps][kMaxChunk]
  float* l_s = m_s + kWarps * kMaxChunk;      // [kWarps][kMaxChunk]

  for (int idx = threadIdx.x; idx < chunk * D; idx += blockDim.x) {
    const int j = idx / D, d = idx - (idx / D) * D;
    q_s[idx] = to_f32(q[((size_t)(row * chunk + j) * heads + hh) * D + d]);
  }
  __syncthreads();

  float m[kMaxChunk], l[kMaxChunk], acc[kMaxChunk][E];
#pragma unroll
  for (int j = 0; j < kMaxChunk; ++j) {
    m[j] = kNegInf;
    l[j] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[j][e] = 0.f;
  }

  // chunk token j attends key positions <= pos + j; positions past the
  // table are never attended (the TPU kernel's _live_block_count)
  const int pos = seq_lens[row];
  const int n_tok = min(pos + chunk - 1, table_width * page - 1) + 1;
  const int32_t* btab = block_table + (size_t)row * table_width;
  auto row_base = [&](int t) {
    const int kb = t / page;
    const int blk = btab[kb];
    return (((size_t)blk * page + (t - kb * page)) * heads + hh) * D;
  };

  float kc[E], vc[E];
  int t = warp;
  if (t < n_tok) {
    const size_t base = row_base(t);
    load_row<T, E>(k_pool, base, lane, kc);
    load_row<T, E>(v_pool, base, lane, vc);
  }
  for (; t < n_tok; t += kWarps) {
    float kn[E], vn[E];
    const int tn = t + kWarps;
    if (tn < n_tok) {
      const size_t base = row_base(tn);
      load_row<T, E>(k_pool, base, lane, kn);
      load_row<T, E>(v_pool, base, lane, vn);
    }
#pragma unroll
    for (int j = 0; j < kMaxChunk; ++j) {
      // warp-uniform conditions: a masked key contributes exactly 0,
      // since key 0 is live for every query and sets m first
      if (j < chunk && t <= pos + j) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) part += q_s[j * D + lane + 32 * e] * kc[e];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, o);
        const float s = part * scale;
        const float m_new = fmaxf(m[j], s);
        const float corr = expf(m[j] - m_new);
        const float p = expf(s - m_new);
        l[j] = l[j] * corr + p;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[j][e] = acc[j][e] * corr + p * vc[e];
        m[j] = m_new;
      }
    }
    if (tn < n_tok) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        kc[e] = kn[e];
        vc[e] = vn[e];
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kMaxChunk; ++j) {
    if (j < chunk) {
      if (lane == 0) {
        m_s[warp * kMaxChunk + j] = m[j];
        l_s[warp * kMaxChunk + j] = l[j];
      }
#pragma unroll
      for (int e = 0; e < E; ++e)
        acc_s[(warp * chunk + j) * D + lane + 32 * e] = acc[j][e];
    }
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < chunk * D; idx += blockDim.x) {
    const int j = idx / D, d = idx - (idx / D) * D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_s[w * kMaxChunk + j]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(m_s[w * kMaxChunk + j] - mx);
      lsum += l_s[w * kMaxChunk + j] * f;
      a += acc_s[(w * chunk + j) * D + d] * f;
    }
    out[((size_t)(row * chunk + j) * heads + hh) * D + d] =
        from_f32<T>(a / (lsum > 0.f ? lsum : 1.f));
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* block_table, const void* seq_lens, void* out,
                   int batch, int chunk, int heads, int page, int table_width,
                   float scale, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)chunk * D * (1 + kWarps) + 2 * kWarps * kMaxChunk);
  auto kernel = paged_attention_kernel<T, D>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(heads, batch), kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int32_t*>(block_table),
      static_cast<const int32_t*>(seq_lens), static_cast<T*>(out), chunk,
      heads, page, table_width, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the launch's cudaError_t.
extern "C" int ff_paged_attention(const void* q, const void* k_pool,
                                  const void* v_pool, const void* block_table,
                                  const void* seq_lens, void* out, int batch,
                                  int chunk, int heads, int head_dim, int page,
                                  int table_width, float scale, int dtype,
                                  void* stream) {
  if (chunk < 1 || chunk > kMaxChunk || page < 1 || table_width < 1)
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || heads == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64)
    return (int)launch<float, 64>(q, k_pool, v_pool, block_table, seq_lens,
                                  out, batch, chunk, heads, page, table_width,
                                  scale, s);
  if (dtype == 0 && head_dim == 128)
    return (int)launch<float, 128>(q, k_pool, v_pool, block_table, seq_lens,
                                   out, batch, chunk, heads, page,
                                   table_width, scale, s);
  if (dtype == 1 && head_dim == 64)
    return (int)launch<__nv_bfloat16, 64>(q, k_pool, v_pool, block_table,
                                          seq_lens, out, batch, chunk, heads,
                                          page, table_width, scale, s);
  if (dtype == 1 && head_dim == 128)
    return (int)launch<__nv_bfloat16, 128>(q, k_pool, v_pool, block_table,
                                           seq_lens, out, batch, chunk,
                                           heads, page, table_width, scale,
                                           s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* ff_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
