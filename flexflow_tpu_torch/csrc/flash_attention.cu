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
// tile.  A row that no key reaches keeps l = 0, so its LSE is -1e30 and
// its output 0, and the backward gives it P = 0.
//
// All three are bound by operations on the tensor cores.  Per pair of
// 64-row tiles K1 does two [64 x 64 x d] products (Q K^T, P V), K2 three
// (Q K^T, dO V^T, dS K) and K3 four (K Q^T, V dO^T, P^T dO, dS^T Q), each
// input read once per tile pair from L2.  Float32 keeps float32 accuracy
// through three TF32 passes of mma.sync m16n8k8: x = hi + lo with hi =
// tf32(x), lo = tf32(x - hi), both rounded as cvt.rna.tf32.f32 rounds (in
// two integer operations; the cvt itself compiles to five on sm_90a), and
// acc += lo*hi + hi*lo + hi*hi with the two small terms first; the dropped
// lo*lo is 2^-22 of the product.  The bound is then 3 x flops at 495
// TFLOP/s of TF32, against flops at 67 on the SIMT path.  bfloat16 runs
// one pass of mma.sync m16n8k16 on the reference's bfloat16 values (Q, K,
// V, dO, and P and dS rounded to bfloat16).  The design:
//   * a block owns 16 rows per warp of the output (K1, K2: q rows; K3: kv
//     rows) and loops over the other side's 64-row tiles (K1 and K2 up to
//     the diagonal under causal, where a K1 warp skips a tile wholly above
//     its rows; K3 from the first q tile causal masking leaves live).
//     Each warp owns its 16 rows of the output, so every output element
//     has one owner: no atomics, the same sums in the same order on every
//     run;
//   * the TF32 split of the operands was most of the instructions, and a
//     streamed tile (K1, K2: K and V; K3: Q and dO) is the B operand of
//     every warp.  Float32 at d 64 therefore splits each streamed tile once
//     for the block when it lands (hi in place, lo beside it) and runs 8
//     warps (128 rows) over it; K1 splits its resident Q the same way once
//     and, at d 64, keeps the warp's Q fragments in registers from then on
//     (K2 and K3 split their resident operands (A) where they read them).
//     At d 128 the streamed lo tiles do not fit beside two stages, and
//     bfloat16 needs no split: 4 warps (64 rows), every streamed fragment
//     split where it is read (Tiles below);
//   * the score tiles never leave registers: a K1 or K2 warp holds its 16 x
//     64 rows of S (and K2 of dP), K3's its 16 x 64 rows of S^T and dP^T
//     (at d 128 16 x 32 per pass, and 16 x 16 for float32 K3, whose dK and
//     dV accumulators take 128 registers), and the accumulator fragments of
//     P and dS are reused as the A operands of the next product (P V in K1,
//     dS K in K2, P^T dO and dS^T Q in K3).  For TF32 the accumulator holds
//     columns 2t and 2t + 1 where the A operand wants t and t + 4, so the
//     contraction runs in the order 0, 2, 4, 6, 1, 3, 5, 7 within each
//     8-step, and the B operand is read in the same order.  P and dS never
//     reach shared or device memory.  K2 and K3 recompute P = 2^(S scale
//     log2 e - LSE log2 e): one FFMA and one ex2 per element, masked by
//     per-row key bounds;
//   * K1's online softmax runs on the S fragments: a row's max over the
//     tile is a max over the lane's columns and then across its quad of
//     lanes (two shuffles), m is kept in base 2, P = 2^(S scale log2 e -
//     m) and the O accumulator (16 x d per warp, in registers) is scaled
//     by 2^(m_old - m_new).  Only a tile that reaches past some row's
//     last key (the diagonal under causal, the ragged end) is masked.
//     Each lane keeps its own part of l, summed over the quad once at the
//     end: O = acc / l_safe, LSE = m ln 2 + log l_safe;
//   * the streamed operands are double-buffered with cp.async.cg 16-byte
//     copies, issued one tile ahead (K1, K2: K and V; K3: Q, dO, and LSE
//     and delta by 4-byte copies) and waited on with commit_group /
//     wait_group 1, so the next tile loads while this one's products run.
//     Rows past sq or sk are zero-filled through the copy's source size and
//     never read;
//   * shared-memory tiles are stored in the input's type, rows padded to a
//     stride of 4 (mod 32) words: float32 D + 4 floats, bfloat16 D + 8
//     halves.  Every fragment read is then conflict-free: A and the B read
//     along d come as ldmatrix.x4 (8 rows of 16 bytes per phase, rows 4
//     words apart), and the float32 B reads along the contraction at
//     2t*stride + g (the order above) hit banks 8t + g, all 32; bfloat16
//     B operands along the contraction are read with ldmatrix.trans;
//   * shared memory per block: the resident operands (16 rows per warp;
//     K1's float32 Q with its lo part), two stages of the streamed pair (64
//     rows each), the split lo tiles, and for K3 1 KB of LSE and delta:
//     170-175 KB for float32 d 64 (one block of 8 warps on an SM), 198-204
//     KB at d 128 (one of 4), 46-105 KB for bfloat16 (two or more blocks
//     of 4).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;          // rows of a q tile and of a kv tile
constexpr float kNegInf = -1e30f;  // the TPU kernels' running-max start
constexpr float kLog2e = 1.4426950408889634f;  // exp(x) = 2^(x log2 e)
constexpr float kLn2 = 0.6931471805599453f;    // K1: LSE from a base-2 max

// kv tiles that the q rows [q0, q0 + rows) read: all of them, or under
// causal those up to their last live row
__device__ __forceinline__ int kv_tiles(int q0, int rows, int sq, int sk,
                                        int causal) {
  int n = (sk + kTile - 1) / kTile;
  if (causal) n = min(n, (min(q0 + rows, sq) - 1) / kTile + 1);
  return n;
}

// ---- tensor cores, cp.async ------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; src_bytes < 16 zero-fills
// the rest (0: nothing is read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A warp's lane as the mma fragments index it: group g (rows g and g + 8
// of an accumulator), thread t within the group.
__device__ __forceinline__ int lane_g() { return (threadIdx.x & 31) >> 2; }
__device__ __forceinline__ int lane_t() { return threadIdx.x & 3; }

// x rounded to TF32 (10 mantissa bits) to nearest, ties away from zero:
// the bits cvt.rna.tf32.f32 gives, in two integer operations where that
// cvt compiles to five on sm_90a
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// c (16 x 8, float32) += a (16 x 8) b (8 x 8), TF32 operands
__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c (16 x 8, float32) += a (16 x 16) b (16 x 8), bfloat16 operands
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8-row matrices of 16 bytes per row from shared memory, lanes 8m to
// 8m + 7 giving the row addresses of matrix m; lane 4g + t receives the
// 32-bit word t of row g of each, in r[m].
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// The A fragment (16 rows from s, a 16-byte column block at s and the
// next) and the B fragments of two neighbouring n-tiles read along their
// rows (rows 0-7 and 8-15 from s), each as one ldmatrix.x4.  kW elements
// of T make 16 bytes.
template <typename T>
__device__ __forceinline__ void ldsm_a(uint32_t r[4], const T* s, int ld) {
  constexpr int kW = 16 / sizeof(T);
  const int l = threadIdx.x & 31;
  ldsm_x4(r, s + (l & 15) * ld + (l >> 4) * kW);
}

template <typename T>
__device__ __forceinline__ void ldsm_b_nk2(uint32_t r[4], const T* s,
                                           int ld) {
  constexpr int kW = 16 / sizeof(T);
  const int l = threadIdx.x & 31;
  ldsm_x4(r, s + ((l & 7) + 8 * (l >> 4)) * ld + ((l >> 3) & 1) * kW);
}

// A streamed float32 tile split once for the block: the TF32 hi parts in
// place of the values, the lo parts in a tile beside it.
struct SplitTile {
  const float* hi;
  const float* lo;
};

__device__ __forceinline__ SplitTile operator+(SplitTile s, int offset) {
  return {s.hi + offset, s.lo + offset};
}

// The warp-level product for inputs of type T: fragments of a 16 x kK A,
// a kK x 8 B and the 16 x 8 float32 accumulator c[4] (c0, c1 at row g,
// columns 2t, 2t + 1; c2, c3 at row g + 8).  Loaders read shared memory
// at a row stride ld (elements of T).
template <typename T>
struct Mma;

template <>
struct Mma<float> {
  static constexpr int kK = 8;       // contraction of one mma
  static constexpr int kPasses = 3;  // lo*hi, hi*lo, hi*hi
  static constexpr int kPad = 4;     // row stride D + 4 floats
  struct A {
    uint32_t hi[4], lo[4];
  };
  struct B {
    uint32_t hi[2], lo[2];
  };

  static __device__ __forceinline__ A make_a(float x0, float x1, float x2,
                                             float x3) {
    A a;
    split_tf32(x0, a.hi[0], a.lo[0]);
    split_tf32(x1, a.hi[1], a.lo[1]);
    split_tf32(x2, a.hi[2], a.lo[2]);
    split_tf32(x3, a.hi[3], a.lo[3]);
    return a;
  }
  static __device__ __forceinline__ B make_b(float x0, float x1) {
    B b;
    split_tf32(x0, b.hi[0], b.lo[0]);
    split_tf32(x1, b.hi[1], b.lo[1]);
    return b;
  }
  // A(m, k) = s[m * ld + k]
  static __device__ __forceinline__ A load_a(const float* s, int ld) {
    uint32_t r[4];
    ldsm_a(r, s, ld);
    return make_a(__uint_as_float(r[0]), __uint_as_float(r[1]),
                  __uint_as_float(r[2]), __uint_as_float(r[3]));
  }
  static __device__ __forceinline__ A load_a(SplitTile s, int ld) {
    A a;
    ldsm_a(a.hi, s.hi, ld);
    ldsm_a(a.lo, s.lo, ld);
    return a;
  }
  // B(k, n) = s[n * ld + k] for n-tiles 0 (b[0]) and 1 (b[1])
  static __device__ __forceinline__ void load_b_nk2(B b[2], const float* s,
                                                    int ld) {
    uint32_t r[4];
    ldsm_b_nk2(r, s, ld);
    b[0] = make_b(__uint_as_float(r[0]), __uint_as_float(r[1]));
    b[1] = make_b(__uint_as_float(r[2]), __uint_as_float(r[3]));
  }
  static __device__ __forceinline__ void load_b_nk2(B b[2], SplitTile s,
                                                    int ld) {
    uint32_t h[4], l[4];
    ldsm_b_nk2(h, s.hi, ld);
    ldsm_b_nk2(l, s.lo, ld);
    b[0] = {{h[0], h[1]}, {l[0], l[1]}};
    b[1] = {{h[2], h[3]}, {l[2], l[3]}};
  }
  // B(k, n) = s[k * ld + n], the contraction in a_from_acc's order: slot
  // t holds row 2t, slot t + 4 row 2t + 1
  static __device__ __forceinline__ B load_b_kn(const float* s, int ld) {
    const int g = lane_g(), t = lane_t();
    return make_b(s[2 * t * ld + g], s[(2 * t + 1) * ld + g]);
  }
  static __device__ __forceinline__ B load_b_kn(SplitTile s, int ld) {
    const int i0 = 2 * lane_t() * ld + lane_g(), i1 = i0 + ld;
    return {{__float_as_uint(s.hi[i0]), __float_as_uint(s.hi[i1])},
            {__float_as_uint(s.lo[i0]), __float_as_uint(s.lo[i1])}};
  }
  // the A operand of one k-step from the accumulator tile c[0]: its
  // columns 2t and 2t + 1 go to slots t and t + 4
  static __device__ __forceinline__ A a_from_acc(const float (*c)[4]) {
    return make_a(c[0][0], c[0][2], c[0][1], c[0][3]);
  }
  static __device__ __forceinline__ void mma(int pass, float c[4], const A& a,
                                             const B& b) {
    if (pass == 0)
      mma_tf32(c, a.lo, b.hi);
    else if (pass == 1)
      mma_tf32(c, a.hi, b.lo);
    else
      mma_tf32(c, a.hi, b.hi);
  }
};

template <>
struct Mma<__nv_bfloat16> {
  using bf16 = __nv_bfloat16;
  static constexpr int kK = 16;
  static constexpr int kPasses = 1;
  static constexpr int kPad = 8;  // row stride D + 8 halves
  struct A {
    uint32_t x[4];
  };
  struct B {
    uint32_t x[2];
  };

  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
  static __device__ __forceinline__ A load_a(const bf16* s, int ld) {
    A a;
    ldsm_a(a.x, s, ld);
    return a;
  }
  static __device__ __forceinline__ void load_b_nk2(B b[2], const bf16* s,
                                                    int ld) {
    uint32_t r[4];
    ldsm_b_nk2(r, s, ld);
    b[0] = {{r[0], r[1]}};
    b[1] = {{r[2], r[3]}};
  }
  // rows 0-7 and 8-15 as two transposed 8 x 8 matrices; lanes 0-15 give
  // the row addresses
  static __device__ __forceinline__ B load_b_kn(const bf16* s, int ld) {
    B b;
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];"
        : "=r"(b.x[0]), "=r"(b.x[1])
        : "r"(smem_u32(s + (threadIdx.x & 15) * ld)));
    return b;
  }
  // one k-step from two accumulator tiles: rounds P or dS to bfloat16
  static __device__ __forceinline__ A a_from_acc(const float (*c)[4]) {
    return {{pack(c[0][0], c[0][1]), pack(c[0][2], c[0][3]),
             pack(c[1][0], c[1][1]), pack(c[1][2], c[1][3])}};
  }
  static __device__ __forceinline__ void mma(int, float c[4], const A& a,
                                             const B& b) {
    mma_bf16(c, a.x, b.x);
  }
};

// A warp's 16 x K A operand held in registers, for K <= 64 (a contraction
// that mma_nk unrolls whole, so every fragment has a constant index)
template <typename T, int K>
struct RegA {
  typename Mma<T>::A f[K / Mma<T>::kK];
};

// the A fragment of the k-step at k: from registers, or read from a tile
// of T or a SplitTile at row stride lda
template <typename T, int K>
__device__ __forceinline__ const typename Mma<T>::A& a_frag(
    const RegA<T, K>& a, int, int k) {
  return a.f[k / Mma<T>::kK];
}
template <typename T, typename ASrc>
__device__ __forceinline__ typename Mma<T>::A a_frag(const ASrc& a, int lda,
                                                     int k) {
  return Mma<T>::load_a(a + k, lda);
}

// acc[j] += A B[:, 8j .. 8j + 7] for j < NT over k < K: the warp's 16 x K
// A rows at a[m * lda + k] (a tile of T or a SplitTile) or in a RegA, and
// B(k, n) = b[n * ldb + k], b a tile of T or a SplitTile.  The passes run
// over all NT tiles in turn, so one tile's three TF32 products are NT
// independent mma apart.
template <typename T, int K, int NT, typename ASrc, typename BSrc>
__device__ __forceinline__ void mma_nk(float (*acc)[4], const ASrc& a,
                                       int lda, BSrc b, int ldb) {
  using M = Mma<T>;
  constexpr int KB = K < 64 ? K : 64;  // contraction unrolled at once
#pragma unroll 1
  for (int kb = 0; kb < K; kb += KB)
#pragma unroll
  for (int k = kb; k < kb + KB; k += M::kK) {
    const typename M::A fa = a_frag<T>(a, lda, k);
    typename M::B fb[NT];
#pragma unroll
    for (int j = 0; j < NT; j += 2)
      M::load_b_nk2(fb + j, b + 8 * j * ldb + k, ldb);
#pragma unroll
    for (int p = 0; p < M::kPasses; ++p)
#pragma unroll
      for (int j = 0; j < NT; ++j) M::mma(p, acc[j], fa, fb[j]);
  }
}

// acc[j] += C B[:, 8j .. 8j + 7] for j < NT over k < K, where C is the
// warp's 16 x K accumulator tiles c[K / 8] (P or dS) taken as the A
// operand, and B(k, n) = b[k * ldb + n].
template <typename T, int K, int NT, typename BSrc>
__device__ __forceinline__ void mma_kn(float (*acc)[4], const float (*c)[4],
                                       BSrc b, int ldb) {
  using M = Mma<T>;
  // B fragments held at once: fewer at d 128, where the accumulators
  // take most of the registers (float32: 2, split into 8 registers)
  constexpr int G = NT <= 8 ? NT : M::kPasses > 1 ? 2 : 4;
#pragma unroll
  for (int k = 0; k < K; k += M::kK) {
    const typename M::A fa = M::a_from_acc(c + k / 8);
#pragma unroll
    for (int j0 = 0; j0 < NT; j0 += G) {
      typename M::B fb[G];
#pragma unroll
      for (int j = 0; j < G; ++j)
        fb[j] = M::load_b_kn(b + k * ldb + 8 * (j0 + j), ldb);
#pragma unroll
      for (int p = 0; p < M::kPasses; ++p)
#pragma unroll
        for (int j = 0; j < G; ++j) M::mma(p, acc[j0 + j], fa, fb[j]);
    }
  }
}

// The layout of K1, K2 and K3 for (T, D).  Streamed float32 tiles at d 64 are
// split into TF32 hi and lo once for the block, when they land, rather than
// by every warp at every fragment it reads: that split was most of the
// kernels' instructions.  8 warps (128 output rows) then share each split
// tile.  At d 128 the lo tiles do not fit beside two stages, and bfloat16
// needs no split: 4 warps (64 rows), each fragment split where it is read.
template <typename T, int D>
struct Tiles {
  static constexpr bool kSplit = sizeof(T) == 4 && D == 64;
  static constexpr int kWarps = kSplit ? 8 : 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kRows = 16 * kWarps;  // output rows of a block
  static constexpr int kLd = D + Mma<T>::kPad;  // shared row stride
  static constexpr int kTS = kTile * kLd;       // one 64-row tile
  // columns of the score tile per pass (K2: kv, K3: q), so that the
  // accumulators, the score fragments and the split operands fit in 255
  // registers without spills: the whole tile at d 64; at d 128 half, and
  // a quarter for float32 K3 (dK and dV, 128 registers together)
  template <int kOutputs>
  __host__ __device__ static constexpr int cols() {
    return D == 64 ? kTile : kOutputs == 2 && sizeof(T) == 4 ? 16 : 32;
  }
  // K2: Q, dO [kRows]; K, V [2 stages]; lo of K, V.
  __host__ __device__ static constexpr size_t dq_smem() {
    return sizeof(T) * (2 * kRows * kLd + (kSplit ? 6 : 4) * kTS);
  }
  // K1: Q [kRows] and, in float32, its lo part; K, V [2 stages]; lo of K, V.
  __host__ __device__ static constexpr size_t fwd_smem() {
    return sizeof(T) *
           ((sizeof(T) == 4 ? 2 : 1) * kRows * kLd + (kSplit ? 6 : 4) * kTS);
  }
  // K3: K, V [kRows]; Q, dO [2 stages]; lo of Q, dO; LSE, delta [2 stages].
  __host__ __device__ static constexpr size_t dkv_smem() {
    return dq_smem() + sizeof(float) * 4 * kTile;
  }
};

// Rows [row0, row0 + ROWS) of a row-major [n_rows, D] matrix into
// dst[ROWS][Tiles::kLd], asynchronously, by the block's threads; rows at or
// past n_rows are zero-filled and not read.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void copy_tile_async(T* dst,
                                                const T* __restrict__ src,
                                                int row0, int n_rows) {
  using L = Tiles<T, D>;
  constexpr int kPer = 16 / sizeof(T);  // elements per 16-byte copy
  constexpr int kChunks = D / kPer;     // copies per row
#pragma unroll
  for (int n = 0; n < ROWS * kChunks / L::kThreads; ++n) {
    const int i = threadIdx.x + n * L::kThreads;
    const int r = i / kChunks, c = (i % kChunks) * kPer;
    const bool live = row0 + r < n_rows;
    cp_async16(dst + r * L::kLd + c,
               src + (size_t)(live ? row0 + r : 0) * D + c, live ? 16 : 0);
  }
}

// rows [row0, row0 + 64) of lse and delta ([n_rows] float32 each) into
// dst[0..63] and dst[64..127], zero past n_rows; threads 0-127 copy
__device__ __forceinline__ void copy_lse_delta_async(float* dst,
                                                     const float* lse,
                                                     const float* delta,
                                                     int row0, int n_rows) {
  if (threadIdx.x >= 2 * kTile) return;
  const int i = threadIdx.x % kTile, r = row0 + i;
  const float* src = threadIdx.x < kTile ? lse : delta;
  cp_async4(dst + threadIdx.x, src + (r < n_rows ? r : 0),
            r < n_rows ? 4 : 0);
}

// The n floats at x (n a multiple of 4, x 16-byte aligned) into their TF32
// hi parts in place and their lo parts at lo, by the block's threads.
template <int kThreadsBlock>
__device__ __forceinline__ void split_tile(float* x, float* lo, int n) {
  for (int i = 4 * threadIdx.x; i < n; i += 4 * kThreadsBlock) {
    float4 v = *reinterpret_cast<float4*>(x + i);
    uint4 h, l;
    split_tf32(v.x, h.x, l.x);
    split_tf32(v.y, h.y, l.y);
    split_tf32(v.z, h.z, l.z);
    split_tf32(v.w, h.w, l.w);
    *reinterpret_cast<uint4*>(x + i) = h;
    *reinterpret_cast<uint4*>(lo + i) = l;
  }
}

template <typename T>
__device__ __forceinline__ void store2(T* p, float x, float y);
template <>
__device__ __forceinline__ void store2<float>(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p,
                                                      float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// the warp's 16 x D accumulator (rows row0 + g and row0 + g + 8) into
// out [n_rows, D]
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* out, const float (*acc)[4],
                                           int row0, int n_rows) {
  const int g = lane_g(), t = lane_t();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + g + 8 * i;
    if (r >= n_rows) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      store2<T>(out + (size_t)r * D + 8 * j + 2 * t, acc[j][2 * i],
                acc[j][2 * i + 1]);
  }
}

// K1.  grid (q blocks of Tiles::kRows rows, bh); o [bh, sq, D] in T, lse
// [bh, sq] float32.  Warp w owns q rows q0 + 16w .. +15.
template <typename T, int D>
__global__ void __launch_bounds__(Tiles<T, D>::kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int sq, int sk, float scale,
                 int causal) {
  using L = Tiles<T, D>;
  constexpr int LD = L::kLd, TS = L::kTS, ROWS = L::kRows;
  constexpr int CT = kTile / 8, DT = D / 8;
  constexpr bool kSplitQ = sizeof(T) == 4;
  extern __shared__ float4 smem4[];
  T* Qs = reinterpret_cast<T*>(smem4);         // [ROWS][LD]
  T* Qlo = Qs + ROWS * LD;                     // float32: [ROWS][LD]
  T* KVs = Qlo + (kSplitQ ? ROWS * LD : 0);    // [2 stages][K, V][64][LD]
  T* KVlo = KVs + 4 * TS;                      // kSplit: [K, V][64][LD]
  const int q0 = blockIdx.x * ROWS;
  const size_t bh = blockIdx.y;
  const int warp = threadIdx.x / 32, g = lane_g(), t = lane_t();
  const int r0 = q0 + 16 * warp;  // the warp's first row
  const T* kb = k + bh * sk * D;
  const T* vb = v + bh * sk * D;
  copy_tile_async<T, D, ROWS>(Qs, q + bh * sq * D, q0, sq);
  copy_tile_async<T, D, kTile>(KVs, kb, 0, sk);
  copy_tile_async<T, D, kTile>(KVs + TS, vb, 0, sk);
  cp_async_commit();

  // rows g and g + 8 of the warp: the keys below lim_r that the row sees,
  // the running max in base 2 (the same in the row's quad of lanes) and
  // the lane's part of the row's sum
  const float scale2 = scale * kLog2e;
  int lim_r[2];
  float m_r[2], l_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + g + 8 * i;
    lim_r[i] = r >= sq ? 0 : causal ? min(r + 1, sk) : sk;
    m_r[i] = kNegInf;
    l_r[i] = 0.f;
  }
  float acc[DT][4] = {};

  // one kv tile: S = Q K^T, the online softmax on S's fragments, O += P V;
  // the warp's Q rows from QA (a RegA, or a tile of T or SplitTile at its
  // first row), K and V read through KB and VB (tiles of T or SplitTiles)
  auto tile = [&](int k0, const auto& QA, auto KB, auto VB) {
    if (causal && k0 > r0 + 15) return;  // no key of the tile is live
    float s[CT][4] = {};
    mma_nk<T, D, CT>(s, QA, LD, KB, LD);
    // only a tile that reaches past some row's last key is masked
    if (!__all_sync(0xffffffffu, k0 + kTile <= min(lim_r[0], lim_r[1]))) {
#pragma unroll
      for (int j = 0; j < CT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + 8 * j + 2 * t + (e & 1) >= lim_r[e >> 1])
            s[j][e] = -INFINITY;
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < CT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_r[i], mx[i] * scale2);
      corr[i] = exp2f(m_r[i] - m_new);
      m_r[i] = m_new;
      l_r[i] *= corr[i];
    }
#pragma unroll
    for (int j = 0; j < CT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(fmaf(s[j][e], scale2, -m_r[e >> 1]));
        s[j][e] = p;  // P, rounded to T where it becomes the A operand
        l_r[e >> 1] += p;
      }
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      acc[j][0] *= corr[0];
      acc[j][1] *= corr[0];
      acc[j][2] *= corr[1];
      acc[j][3] *= corr[1];
    }
    mma_kn<T, kTile, DT>(acc, s, VB, LD);
  };

  // the warp's Q rows as the A operand: at d 64 held in registers from
  // the first tile on (float32: 64 registers of hi and lo), at d 128 read
  // from shared memory at every tile
  constexpr bool kRegQ = D == 64;
  RegA<T, D> qa;
  const int qoff = 16 * warp * LD;
  const int n_kt = kv_tiles(q0, ROWS, sq, sk, causal);
  for (int kt = 0; kt < n_kt; ++kt) {
    T* Ks = KVs + (kt & 1) * 2 * TS;
    T* Vs = Ks + TS;
    if (kt + 1 < n_kt) {  // the next kv tile into the other stage
      T* nxt = KVs + ((kt + 1) & 1) * 2 * TS;
      copy_tile_async<T, D, kTile>(nxt, kb, (kt + 1) * kTile, sk);
      copy_tile_async<T, D, kTile>(nxt + TS, vb, (kt + 1) * kTile, sk);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int k0 = kt * kTile;
    if constexpr (kSplitQ) {
      const SplitTile QS = SplitTile{Qs, Qlo} + qoff;
      if (kt == 0) split_tile<L::kThreads>(Qs, Qlo, ROWS * LD);
      if constexpr (L::kSplit) split_tile<L::kThreads>(Ks, KVlo, 2 * TS);
      __syncthreads();
      if constexpr (kRegQ) {
        if (kt == 0)
#pragma unroll
          for (int k = 0; k < D; k += Mma<T>::kK)
            qa.f[k / Mma<T>::kK] = Mma<T>::load_a(QS + k, LD);
      }
      if constexpr (L::kSplit)
        tile(k0, qa, SplitTile{Ks, KVlo}, SplitTile{Vs, KVlo + TS});
      else
        tile(k0, QS, static_cast<const T*>(Ks), static_cast<const T*>(Vs));
    } else {
      const T* QT = Qs + qoff;
      if constexpr (kRegQ) {
        if (kt == 0)
#pragma unroll
          for (int k = 0; k < D; k += Mma<T>::kK)
            qa.f[k / Mma<T>::kK] = Mma<T>::load_a(QT + k, LD);
        tile(k0, qa, static_cast<const T*>(Ks), static_cast<const T*>(Vs));
      } else {
        tile(k0, QT, static_cast<const T*>(Ks), static_cast<const T*>(Vs));
      }
    }
    __syncthreads();  // the next iteration's copy overwrites this stage
  }

  float lse_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_r[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float ls = l > 0.f ? l : 1.f;
    lse_r[i] = l > 0.f ? m_r[i] * kLn2 + logf(ls) : kNegInf;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      acc[j][2 * i] /= ls;
      acc[j][2 * i + 1] /= ls;
    }
  }
  store_rows<T, D>(o + bh * sq * D, acc, r0, sq);
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + g + 8 * i;
      if (r < sq) lse[bh * sq + r] = lse_r[i];
    }
  }
}

// K2.  grid (q blocks of Tiles::kRows rows, bh); dq [bh, sq, D] in T.  Warp
// w owns q rows q0 + 16w .. +15.
template <typename T, int D>
__global__ void __launch_bounds__(Tiles<T, D>::kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int sq, int sk, float scale, int causal) {
  using L = Tiles<T, D>;
  constexpr int LD = L::kLd, TS = L::kTS, ROWS = L::kRows;
  constexpr int NC = L::template cols<1>(), CT = NC / 8, DT = D / 8;
  extern __shared__ float4 smem4[];
  T* Qs = reinterpret_cast<T*>(smem4);  // [ROWS][LD]
  T* dOs = Qs + ROWS * LD;              // [ROWS][LD]
  T* KVs = dOs + ROWS * LD;             // [2 stages][K, V][64][LD]
  T* KVlo = KVs + 4 * TS;               // kSplit: [K, V][64][LD]
  const int q0 = blockIdx.x * ROWS;
  const size_t bh = blockIdx.y;
  const int warp = threadIdx.x / 32, g = lane_g(), t = lane_t();
  const T* kb = k + bh * sk * D;
  const T* vb = v + bh * sk * D;
  copy_tile_async<T, D, ROWS>(Qs, q + bh * sq * D, q0, sq);
  copy_tile_async<T, D, ROWS>(dOs, dout + bh * sq * D, q0, sq);
  copy_tile_async<T, D, kTile>(KVs, kb, 0, sk);
  copy_tile_async<T, D, kTile>(KVs + TS, vb, 0, sk);
  cp_async_commit();

  // rows g and g + 8 of the warp: LSE in base 2, delta, and the keys
  // below lim_r that the row sees
  const float scale2 = scale * kLog2e;
  float lse2_r[2], dl_r[2];
  int lim_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + 16 * warp + g + 8 * i;
    lse2_r[i] = r < sq ? lse[bh * sq + r] * kLog2e : 0.f;
    dl_r[i] = r < sq ? delta[bh * sq + r] : 0.f;
    lim_r[i] = r >= sq ? 0 : causal ? min(r + 1, sk) : sk;
  }
  float acc[DT][4] = {};

  // one kv tile's products, K and V read through KB and VB (tiles of T or
  // SplitTiles)
  auto tile = [&](int k0, auto KB, auto VB) {
#pragma unroll 1
    for (int c0 = 0; c0 < kTile; c0 += NC) {
      float s[CT][4] = {}, dp[CT][4] = {};
      mma_nk<T, D, CT>(s, Qs + 16 * warp * LD, LD, KB + c0 * LD, LD);
      mma_nk<T, D, CT>(dp, dOs + 16 * warp * LD, LD, VB + c0 * LD, LD);
#pragma unroll
      for (int j = 0; j < CT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const int kp = k0 + c0 + 8 * j + 2 * t + (e & 1);
          const float p = kp < lim_r[i]
                              ? exp2f(fmaf(s[j][e], scale2, -lse2_r[i]))
                              : 0.f;
          s[j][e] = p * (dp[j][e] - dl_r[i]) * scale;  // dS
        }
      mma_kn<T, NC, DT>(acc, s, KB + c0 * LD, LD);
    }
  };

  const int n_kt = kv_tiles(q0, ROWS, sq, sk, causal);
  for (int kt = 0; kt < n_kt; ++kt) {
    T* Ks = KVs + (kt & 1) * 2 * TS;
    T* Vs = Ks + TS;
    if (kt + 1 < n_kt) {  // the next kv tile into the other stage
      T* nxt = KVs + ((kt + 1) & 1) * 2 * TS;
      copy_tile_async<T, D, kTile>(nxt, kb, (kt + 1) * kTile, sk);
      copy_tile_async<T, D, kTile>(nxt + TS, vb, (kt + 1) * kTile, sk);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if constexpr (L::kSplit) {
      split_tile<L::kThreads>(Ks, KVlo, 2 * TS);
      __syncthreads();
      tile(kt * kTile, SplitTile{Ks, KVlo}, SplitTile{Vs, KVlo + TS});
    } else {
      tile(kt * kTile, static_cast<const T*>(Ks), static_cast<const T*>(Vs));
    }
    __syncthreads();  // the next iteration's copy overwrites this stage
  }
  store_rows<T, D>(dq + bh * sq * D, acc, q0 + 16 * warp, sq);
}

// K3.  grid (kv blocks of Tiles::kRows rows, bh); dk, dv [bh, sk, D] in T.
// Warp w owns kv rows k0 + 16w .. +15 and computes the transposed score
// tiles S^T = K Q^T and dP^T = V dO^T, NC q columns per pass.
template <typename T, int D>
__global__ void __launch_bounds__(Tiles<T, D>::kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int sq, int sk, float scale,
                     int causal) {
  using L = Tiles<T, D>;
  constexpr int LD = L::kLd, TS = L::kTS, ROWS = L::kRows;
  constexpr int NC = L::template cols<2>(), CT = NC / 8, DT = D / 8;
  extern __shared__ float4 smem4[];
  T* Ks = reinterpret_cast<T*>(smem4);  // [ROWS][LD]
  T* Vs = Ks + ROWS * LD;               // [ROWS][LD]
  T* QdOs = Vs + ROWS * LD;             // [2 stages][Q, dO][64][LD]
  T* QdOlo = QdOs + 4 * TS;             // kSplit: [Q, dO][64][LD]
  // [2 stages][lse, delta][64]
  float* rows = reinterpret_cast<float*>(QdOlo + (L::kSplit ? 2 * TS : 0));
  const int k0 = blockIdx.x * ROWS;
  const size_t bh = blockIdx.y;
  const int warp = threadIdx.x / 32, g = lane_g(), t = lane_t();
  const T* qb = q + bh * sq * D;
  const T* dob = dout + bh * sq * D;
  const float* lb = lse + bh * sq;
  const float* db = delta + bh * sq;
  copy_tile_async<T, D, ROWS>(Ks, k + bh * sk * D, k0, sk);
  copy_tile_async<T, D, ROWS>(Vs, v + bh * sk * D, k0, sk);
  // under causal, q rows before k0 see none of this block's keys
  const int qt0 = causal ? k0 / kTile : 0;
  const int n_qt = (sq + kTile - 1) / kTile;
  if (qt0 < n_qt) {
    copy_tile_async<T, D, kTile>(QdOs, qb, qt0 * kTile, sq);
    copy_tile_async<T, D, kTile>(QdOs + TS, dob, qt0 * kTile, sq);
    copy_lse_delta_async(rows, lb, db, qt0 * kTile, sq);
  }
  cp_async_commit();

  const float scale2 = scale * kLog2e;
  float dk_acc[DT][4] = {}, dv_acc[DT][4] = {};

  // one q tile's products, Q and dO read through QB and DOB (tiles of T
  // or SplitTiles), LSE and delta from lse_s and dl_s
  auto tile = [&](int q0, auto QB, auto DOB, const float* lse_s,
                  const float* dl_s) {
#pragma unroll 1
    for (int c0 = 0; c0 < kTile; c0 += NC) {
      float st[CT][4] = {}, dpt[CT][4] = {};
      mma_nk<T, D, CT>(st, Ks + 16 * warp * LD, LD, QB + c0 * LD, LD);
      mma_nk<T, D, CT>(dpt, Vs + 16 * warp * LD, LD, DOB + c0 * LD, LD);
#pragma unroll
      for (int j = 0; j < CT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // kv row kp sees the q rows in [causal ? kp : 0, kp < sk ? sq : 0),
          // worked out here: held across the loop, the bounds spill at
          // float32 d 128
          const int kp = k0 + 16 * warp + g + 8 * (e >> 1);
          const int c = c0 + 8 * j + 2 * t + (e & 1);
          const int qp = q0 + c;
          const float p =
              qp >= (causal ? kp : 0) && qp < (kp < sk ? sq : 0)
                  ? exp2f(fmaf(st[j][e], scale2, -lse_s[c] * kLog2e))
                  : 0.f;
          st[j][e] = p;                                   // P^T
          dpt[j][e] = p * (dpt[j][e] - dl_s[c]) * scale;  // dS^T
        }
      mma_kn<T, NC, DT>(dv_acc, st, DOB + c0 * LD, LD);
      mma_kn<T, NC, DT>(dk_acc, dpt, QB + c0 * LD, LD);
    }
  };

  for (int qt = qt0; qt < n_qt; ++qt) {
    const int stage = (qt - qt0) & 1;
    T* Qs = QdOs + stage * 2 * TS;
    T* dOs = Qs + TS;
    const float* lse_s = rows + stage * 2 * kTile;
    if (qt + 1 < n_qt) {  // the next q tile into the other stage
      T* nxt = QdOs + (stage ^ 1) * 2 * TS;
      copy_tile_async<T, D, kTile>(nxt, qb, (qt + 1) * kTile, sq);
      copy_tile_async<T, D, kTile>(nxt + TS, dob, (qt + 1) * kTile, sq);
      copy_lse_delta_async(rows + (stage ^ 1) * 2 * kTile, lb, db,
                           (qt + 1) * kTile, sq);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if constexpr (L::kSplit) {
      split_tile<L::kThreads>(Qs, QdOlo, 2 * TS);
      __syncthreads();
      tile(qt * kTile, SplitTile{Qs, QdOlo}, SplitTile{dOs, QdOlo + TS},
           lse_s, lse_s + kTile);
    } else {
      tile(qt * kTile, static_cast<const T*>(Qs), static_cast<const T*>(dOs),
           lse_s, lse_s + kTile);
    }
    __syncthreads();  // the next iteration's copy overwrites this stage
  }
  cp_async_wait<0>();  // no copy outlives the block when no q tile ran
  store_rows<T, D>(dk + bh * sk * D, dk_acc, k0 + 16 * warp, sk);
  store_rows<T, D>(dv + bh * sk * D, dv_acc, k0 + 16 * warp, sk);
}

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, size_t smem, int threads, int tiles, int bh,
                   cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(tiles, bh), threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o,
                void* lse, int bh, int sq, int sk, float scale, int causal,
                cudaStream_t s) {
  using L = Tiles<T, D>;
  return launch(flash_fwd_kernel<T, D>, L::fwd_smem(), L::kThreads,
                (sq + L::kRows - 1) / L::kRows, bh, s, static_cast<const T*>(q),
                static_cast<const T*>(k), static_cast<const T*>(v),
                static_cast<T*>(o), static_cast<float*>(lse), sq, sk, scale,
                causal);
}

template <typename T, int D>
cudaError_t bwd_dq(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, int bh, int sq, int sk, float scale, int causal,
                   cudaStream_t s) {
  using L = Tiles<T, D>;
  return launch(flash_bwd_dq_kernel<T, D>, L::dq_smem(), L::kThreads,
                (sq + L::kRows - 1) / L::kRows, bh, s, static_cast<const T*>(q),
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
  using L = Tiles<T, D>;
  return launch(flash_bwd_dkv_kernel<T, D>, L::dkv_smem(), L::kThreads,
                (sk + L::kRows - 1) / L::kRows, bh, s, static_cast<const T*>(q),
                static_cast<const T*>(k), static_cast<const T*>(v),
                static_cast<const T*>(dout), static_cast<const float*>(lse),
                static_cast<const float*>(delta), static_cast<T*>(dk),
                static_cast<T*>(dv), sq, sk, scale, causal);
}

// out = {registers per thread, local-memory bytes per thread (spills and
// stack), dynamic shared memory per block, resident blocks per SM} of K1
// (kernel 1), K2 (kernel 2) or K3 (kernel 3)
template <typename T, int D>
cudaError_t bwd_resources(int kernel, int* out) {
  const void* fn =
      kernel == 1   ? reinterpret_cast<const void*>(flash_fwd_kernel<T, D>)
      : kernel == 2 ? reinterpret_cast<const void*>(flash_bwd_dq_kernel<T, D>)
                    : reinterpret_cast<const void*>(flash_bwd_dkv_kernel<T, D>);
  using L = Tiles<T, D>;
  const size_t smem = kernel == 1   ? L::fwd_smem()
                      : kernel == 2 ? L::dq_smem()
                                    : L::dkv_smem();
  cudaFuncAttributes attr = {};
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn,
                                                        L::kThreads, smem);
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)smem;
  out[3] = blocks;
  return err;
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

// out[4] = registers, local bytes, shared bytes, blocks per SM of K1
// (kernel 1), K2 (kernel 2) or K3 (kernel 3) at (head_dim, dtype).
extern "C" int ff_flash_bwd_resources(int kernel, int head_dim, int dtype,
                                      int* out) {
  if (kernel < 1 || kernel > 3) return (int)cudaErrorInvalidValue;
  FF_DISPATCH(bwd_resources, kernel, out);
}

extern "C" const char* ff_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
