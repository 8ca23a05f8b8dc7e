// Paged attention, the read side of the paged-KV decode step, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel `_paged_kernel` launched by `paged_attention`
// in flexflow_tpu/ops/pallas/paged_attention.py.  It computes the same
// function: for row i and chunk token j, softmax over the key positions
// 0 .. seq_lens[i] + j of the row's pages, read in place through
// block_table[i, :], then the context product with the value pages.
// Scores, softmax and the context product are float32 (bfloat16 pools are
// widened); a chunk token whose l is 0 divides by 1.
//
// Bound: bytes.  Every KV byte a row attends is read once and takes two
// flops per element (one for q.k, one for p.v), far below the card's
// ratio of operations to bytes, so the kernel can at best stream the
// row's live pages at the memory rate.  At the decode shape (8 rows, 12
// heads, ~5000 live tokens) that is ~30 MB, and it takes many bytes in
// flight on every SM.  The design:
//   * the grid is (head, row, split): a split is a run of split_pages
//     whole pages of one row, sized on the host from the table width
//     alone, so one shape needs no host read of seq_lens.  A block whose
//     split starts past the row's live count exits at once; the rest
//     (about live tokens / span x heads of them, several waves of the 132
//     SMs at the decode shape) each read one split;
//   * a block stages its split's K and V rows of its head with 16-byte
//     cp.async copies, page by page through the block table, all issued
//     before the first wait, so a whole split (32 KB at float32, d 64,
//     four pages) is in flight at once and several blocks share an SM;
//   * then it scores all of the split's keys at once (a thread per (chunk
//     token, key), q broadcast from shared memory, k read as 16-byte
//     vectors along a row padded by 16 bytes: conflict-free), takes one max
//     and one sum per chunk token over the split (a warp each), and P V
//     with a thread per (chunk token, d);
//   * each split writes a float32 partial (m, l, acc[d]) per chunk token to
//     a workspace.  The last block of a (row, head) to finish, found by an
//     atomic counter after __threadfence, merges the partials by their m
//     in split order, so the bits do not depend on which block finished
//     last, and resets the counter for the next launch: no memset, one
//     launch per call.  A row with a single live split writes its output
//     directly.  A split with no live key for a chunk token (its keys all
//     past pos + j) gives m = -1e30 and l = 0 and drops out of the merge;
//   * decode (chunk 1) is its own instance, with the chunk loops gone.
// The TPU kernel carries m/l/acc across a sequential grid axis over a
// row's pages; blocks here run in no order, hence the partials and the
// merge.  Tensor cores for the chunk case are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxChunk = 16;
constexpr float kNegInf = -1e30f;
constexpr size_t kMaxSmem = 227 * 1024;  // dynamic shared memory of a block

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

// 16 bytes global -> shared, asynchronously
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// q . x over the 16 bytes at p (4 float32 or 8 bfloat16 values), q in
// float32
__device__ __forceinline__ float dot16(const float* q, const float* p,
                                       float acc) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  acc = fmaf(q[0], x.x, acc);
  acc = fmaf(q[1], x.y, acc);
  acc = fmaf(q[2], x.z, acc);
  return fmaf(q[3], x.w, acc);
}

__device__ __forceinline__ float dot16(const float* q,
                                       const __nv_bfloat16* p, float acc) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    acc = fmaf(q[2 * i], f.x, acc);
    acc = fmaf(q[2 * i + 1], f.y, acc);
  }
  return acc;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Shared memory of one block: K and V rows of the split in T, each padded
// by 16 bytes; then float32 q [chunk][D], scores and probabilities [chunk]
// [span], and m, l [kMaxChunk].
template <typename T, int D>
struct Smem {
  static constexpr int kPer = 16 / sizeof(T);  // elements per 16 bytes
  static constexpr int kLd = D + kPer;         // row stride
  static __host__ __device__ size_t bytes(int chunk, int span) {
    return sizeof(T) * 2 * (size_t)span * kLd +
           sizeof(float) * ((size_t)chunk * D + (size_t)chunk * span +
                            2 * kMaxChunk);
  }
};

// q, out: [batch, chunk, heads, D]; k_pool, v_pool: [blocks, page, heads, D]
// block_table: [batch, table_width] int32; seq_lens: [batch] int32.
// part: [batch, heads, gridDim.z][chunk][D + 2] float32 partials (acc, then
// m and l per chunk token); counters: [batch, heads] int32, 0 between
// launches.
template <typename T, int D, bool kDecode>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                       const T* __restrict__ v_pool,
                       const int32_t* __restrict__ block_table,
                       const int32_t* __restrict__ seq_lens,
                       T* __restrict__ out, float* __restrict__ part,
                       int* __restrict__ counters, int chunk_arg, int heads,
                       int page, int table_width, int split_pages,
                       float scale) {
  using S = Smem<T, D>;
  constexpr int PER = S::kPer, LD = S::kLd, CPR = D / PER;
  const int chunk = kDecode ? 1 : chunk_arg;
  const int hh = blockIdx.x, row = blockIdx.y, sp = blockIdx.z;
  const int span = split_pages * page;  // tokens of a split
  // chunk token j attends key positions <= pos + j; positions past the
  // table are never attended (the TPU kernel's _live_block_count)
  const int pos = seq_lens[row];
  const int n_tok = min(pos + chunk - 1, table_width * page - 1) + 1;
  const int n_live = (n_tok + span - 1) / span;
  if (sp >= n_live) return;
  const int t0 = sp * span, nt = min(span, n_tok - t0);

  extern __shared__ float4 smem4[];
  T* Ks = reinterpret_cast<T*>(smem4);                    // [span][LD]
  T* Vs = Ks + (size_t)span * LD;                         // [span][LD]
  float* qs = reinterpret_cast<float*>(Vs + (size_t)span * LD);  // [chunk][D]
  float* ps = qs + chunk * D;                             // [chunk][span]
  float* ms = ps + chunk * span;                          // [kMaxChunk]
  float* ls = ms + kMaxChunk;                             // [kMaxChunk]
  __shared__ int last;

  const int32_t* btab = block_table + (size_t)row * table_width;
  for (int i = threadIdx.x; i < nt * CPR; i += kThreads) {
    const int r = i / CPR, c = (i - r * CPR) * PER;
    const int tok = t0 + r, kb = tok / page;
    const size_t src =
        (((size_t)btab[kb] * page + (tok - kb * page)) * heads + hh) * D + c;
    cp_async16(Ks + r * LD + c, k_pool + src);
    cp_async16(Vs + r * LD + c, v_pool + src);
  }
  for (int i = threadIdx.x; i < chunk * D; i += kThreads) {
    const int j = i / D, d = i - j * D;
    qs[i] = to_f32(q[((size_t)(row * chunk + j) * heads + hh) * D + d]);
  }
  cp_async_wait_all();
  __syncthreads();

  // scores of every (chunk token, key) of the split; masked keys -inf
  for (int i = threadIdx.x; i < chunk * nt; i += kThreads) {
    const int j = kDecode ? 0 : i / nt, tt = kDecode ? i : i - j * nt;
    float s = -INFINITY;
    if (t0 + tt <= pos + j) {
      const float* qj = qs + j * D;
      const T* kr = Ks + tt * LD;
      float a = 0.f;
#pragma unroll
      for (int c = 0; c < D; c += PER) a = dot16(qj + c, kr + c, a);
      s = a * scale;
    }
    ps[j * span + tt] = s;
  }
  __syncthreads();

  // one max and one sum per chunk token over the split, a warp each
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int j = warp; j < chunk; j += kThreads / 32) {
    float* pj = ps + j * span;
    float mx = -INFINITY;
    for (int tt = lane; tt < nt; tt += 32) mx = fmaxf(mx, pj[tt]);
    mx = warp_max(mx);
    const float m = mx == -INFINITY ? kNegInf : mx;
    float sum = 0.f;
    for (int tt = lane; tt < nt; tt += 32) {
      const float p = expf(pj[tt] - m);  // masked: exp(-inf) = 0
      pj[tt] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      ms[j] = m;
      ls[j] = sum;
    }
  }
  __syncthreads();

  const int n_splits = gridDim.z;
  const int stride = chunk * (D + 2);  // floats of one split's partial
  const size_t rbase = ((size_t)row * heads + hh) * n_splits * stride;
  float* mine = part + rbase + (size_t)sp * stride;
  for (int i = threadIdx.x; i < chunk * D; i += kThreads) {
    const int j = kDecode ? 0 : i / D, d = i - j * D;
    const float* pj = ps + j * span;
    float a = 0.f;
#pragma unroll 4
    for (int tt = 0; tt < nt; ++tt)
      a = fmaf(pj[tt], to_f32(Vs[tt * LD + d]), a);
    if (n_live == 1)
      out[((size_t)(row * chunk + j) * heads + hh) * D + d] =
          from_f32<T>(a / (ls[j] > 0.f ? ls[j] : 1.f));
    else
      mine[i] = a;
  }
  if (n_live == 1) return;
  if (threadIdx.x < chunk) {
    mine[chunk * D + threadIdx.x] = ms[threadIdx.x];
    mine[chunk * D + chunk + threadIdx.x] = ls[threadIdx.x];
  }

  // the last of the row's live splits to finish merges them all
  __threadfence();  // this block's partial is visible before its count
  __syncthreads();
  if (threadIdx.x == 0) {
    int* cnt = counters + (size_t)row * heads + hh;
    last = atomicAdd(cnt, 1) == n_live - 1;
    if (last) atomicExch(cnt, 0);  // ready for the next launch
  }
  __syncthreads();
  if (!last) return;
  __threadfence();  // and the others' partials are seen after theirs
  const float* rp = part + rbase;
  for (int i = threadIdx.x; i < chunk * D; i += kThreads) {
    const int j = kDecode ? 0 : i / D, d = i - j * D;
    float mx = kNegInf;
    for (int s = 0; s < n_live; ++s)
      mx = fmaxf(mx, __ldcg(rp + s * stride + chunk * D + j));
    float lsum = 0.f, a = 0.f;
    for (int s = 0; s < n_live; ++s) {
      const float* p = rp + s * stride;
      const float f = expf(__ldcg(p + chunk * D + j) - mx);
      lsum += __ldcg(p + chunk * D + chunk + j) * f;
      a += __ldcg(p + i) * f;
    }
    out[((size_t)(row * chunk + j) * heads + hh) * D + d] =
        from_f32<T>(a / (lsum > 0.f ? lsum : 1.f));
  }
}

template <typename T, int D, bool kDecode>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* block_table, const void* seq_lens, void* out,
                   void* part, void* counters, int batch, int chunk,
                   int heads, int page, int table_width, int split_pages,
                   float scale, cudaStream_t stream) {
  const size_t smem = Smem<T, D>::bytes(chunk, split_pages * page);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = paged_attention_kernel<T, D, kDecode>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int n_splits = (table_width + split_pages - 1) / split_pages;
  kernel<<<dim3(heads, batch, n_splits), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int32_t*>(block_table),
      static_cast<const int32_t*>(seq_lens), static_cast<T*>(out),
      static_cast<float*>(part), static_cast<int*>(counters), chunk, heads,
      page, table_width, split_pages, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dispatch_chunk(const void* q, const void* k_pool,
                           const void* v_pool, const void* block_table,
                           const void* seq_lens, void* out, void* part,
                           void* counters, int batch, int chunk, int heads,
                           int page, int table_width, int split_pages,
                           float scale, cudaStream_t s) {
  auto fn = chunk == 1 ? launch<T, D, true> : launch<T, D, false>;
  return fn(q, k_pool, v_pool, block_table, seq_lens, out, part, counters,
            batch, chunk, heads, page, table_width, split_pages, scale, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  workspace: batch * heads * n_splits *
// chunk * (head_dim + 2) floats with n_splits = ceil(table_width /
// split_pages); counters: batch * heads int32, all 0 before the first
// launch (the kernel leaves them 0).  Returns the launch's cudaError_t.
extern "C" int ff_paged_attention(const void* q, const void* k_pool,
                                  const void* v_pool, const void* block_table,
                                  const void* seq_lens, void* out,
                                  void* workspace, void* counters, int batch,
                                  int chunk, int heads, int head_dim, int page,
                                  int table_width, int split_pages,
                                  float scale, int dtype, void* stream) {
  if (chunk < 1 || chunk > kMaxChunk || page < 1 || table_width < 1 ||
      split_pages < 1 || batch > 65535 || heads > 65535 ||
      (table_width + split_pages - 1) / split_pages > 65535)
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || heads == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FF_PAGED(T, D)                                                      \
  return (int)dispatch_chunk<T, D>(q, k_pool, v_pool, block_table, seq_lens, \
                                   out, workspace, counters, batch, chunk,  \
                                   heads, page, table_width, split_pages,   \
                                   scale, s)
  if (dtype == 0 && head_dim == 64) FF_PAGED(float, 64);
  if (dtype == 0 && head_dim == 128) FF_PAGED(float, 128);
  if (dtype == 1 && head_dim == 64) FF_PAGED(__nv_bfloat16, 64);
  if (dtype == 1 && head_dim == 128) FF_PAGED(__nv_bfloat16, 128);
#undef FF_PAGED
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* ff_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
