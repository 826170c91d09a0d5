// Tensor-core dot products of a block's queries with a corpus tile that
// lies in shared memory exactly as an asynchronous copy wrote it: no staging
// pass, no barrier inside the feature loop.  For Hopper (mma.sync, sm_90a).
//
// The product.  Corpus rows are the M side, queries the N side, features K:
// one warp multiplies 16 rows by NQ groups of 8 queries.  Per storage type
// and, for float32, per precision tier (the JAX package's matmul_precision,
// approximatenn_tpu/ops/pallas_exact.py:_dist_dot):
//   float32 "highest"  m16n8k8  TF32, fp32 accumulators, three passes
//                  ("3xTF32"): each factor splits in registers into
//                    hi = cvt.rna.tf32(x),  lo = cvt.rna.tf32(x - hi)
//                  (the queries' once per block, the corpus values' in
//                  the tile loop); the small products
//                  lo*hi and hi*lo and the large hi*hi sum in accumulators
//                  of their own, added at the end, small ones first; lo*lo
//                  (2^-22 of a product) is dropped.  Every product of two
//                  TF32 values is exact in fp32, so what is left of the error
//                  is the accumulation's, as in any fp32 dot product.
//   float32 "split3"   m16n8k16 bf16, fp32 accumulators, three passes: the
//                  JAX package's _dot_split3, each factor split into
//                    hi = cvt.rn.bf16(x),   lo = cvt.rn.bf16(x - hi)
//                  (to nearest even, as its astype), lo*hi, hi*lo and hi*hi
//                  summed as above; lo*lo (2^-16 of a product) is dropped.
//                  A k16 step covers two of the tile's 8-float K steps.
//   float32 "default"  m16n8k16 bf16, one pass of bf16(x) * bf16(q): what
//                  Precision.DEFAULT is on the TPU's MXU.
//   bf16 / f16     m16n8k16, one pass, fp32 accumulators.  Queries are
//                  rounded to the corpus's type, so products are exact.
//   int8           m16n8k32 s8, int32 accumulators: exact.
// Only a float32 stream has tiers; the other types take TIER_HIGHEST alone.
//
// Fragments, in 32-bit words.  Seen as words (1 float, 2 halves, 4 int8),
// all three instructions cut their operands alike.  With g = lane / 4 and
// t = lane % 4, for the K step that starts at word w0:
//   A (16 rows x 8 words):   a0 = row g     word w0 + t
//                            a1 = row g + 8 word w0 + t
//                            a2 = row g     word w0 + t + 4
//                            a3 = row g + 8 word w0 + t + 4
//   B (8 words x 8 queries): b0 = query g   word w0 + t
//                            b1 = query g   word w0 + t + 4
//   C (16 rows x 8 queries): c0 = (row g,     query 2t)   c1 = (row g,     query 2t + 1)
//                            c2 = (row g + 8, query 2t)   c3 = (row g + 8, query 2t + 1)
//
// The tile's layout.  Rows lie at a padded stride: row_words(d) = the row's
// bytes rounded up to a whole K step (32 bytes: 8 floats, 16 halves, 32
// int8), and stride = row_words + 4, so stride = 4 (mod 8) words.  An A load
// (each of the four 8-row phases of load_a's ldmatrix) touches rows
// g = 0..7 at words t = 0..3: bank = (stride g + t) mod 32.
// With stride = 8a + 4, stride g = 4 g (2a + 1) (mod 32); 2a + 1 is odd, so
// g -> g (2a + 1) mod 8 is a permutation of 0..7 and the 32 lanes fall in
// the 32 banks 4 perm(g) + t: conflict-free without a swizzle.
//   d = 128 f32: 128 + 4 = 132 words, 132 mod 32 = 4,  banks 4 g + t
//   d =  96 f32:  96 + 4 = 100 words, 100 mod 32 = 4,  banks 4 g + t
//   d =  33 f32:  40 + 4 =  44 words,  44 mod 32 = 12, 12 g mod 32 =
//                 0 12 24 4 16 28 8 20 for g = 0..7: eight distinct
//                 multiples of 4, plus t
//   d = 128 bf16: 64 + 4 =  68 words,  68 mod 32 = 4
// Every row starts on a 16-byte boundary (stride is a multiple of 4 words),
// so 16-byte copies can fill it.  Bytes from the row's end up to row_words
// must be zero (the caller zeroes them once; copies never write them), and
// the query fragments are zero there too.  The 4 words after row_words are
// never read.
//
// Query fragments are made once per block (stage_query_fragments) and kept
// in shared memory in lane order: one 16-byte (float32: b0 hi, b1 hi, b0 lo,
// b1 lo) or 8-byte (b0, b1) load per lane and K step, conflict-free.
//
// The bf16 tiers of a float32 tile.  The tile stays float32, as the copies
// wrote it, and load_a's ldmatrix is unchanged: the A words of two K steps s
// and s + 1 (a0..a3 of each, one float a word) pack pairwise into the four
// bf16x2 A registers of one m16n8k16, the K step s value in the low half:
//   A0 = (row g,     features 8s + t,     8(s+1) + t)      MMA k 2t, 2t + 1
//   A1 = (row g + 8, the same features)
//   A2 = (row g,     features 8s + t + 4, 8(s+1) + t + 4)  MMA k 2t + 8, 2t + 9
//   A3 = (row g + 8, the same features)
// and the query fragments pack B in the same feature order (b0: features
// 8s + t and 8(s+1) + t of query g, b1: the two + 4).  A dot product does not
// depend on the order of k as long as A and B share it.  Where a chunk has
// an odd number of K steps its last pair's second half is zero registers on
// both sides: never the 4 pad words or the next row.  A lane's fragment per
// pair of K steps: 16 bytes (split3: b0 hi, b1 hi, b0 lo, b1 lo) or 8
// (default: b0, b1).
//
// Nothing here knows where the tile came from: the streaming kernel and the
// tile loop of the rank kernel, the rescan merge and the two-phase emit
// (knn_tile.cuh) hand it a ring slot, or one feature chunk of it.

#pragma once

#include <type_traits>

#include "knn_common.cuh"

namespace knn {

constexpr int MMA_ROWS = 16;     // corpus rows per warp and MMA
constexpr int MMA_QUERIES = 8;   // queries per MMA
constexpr int KSTEP_WORDS = 8;   // 32-bit words of a row per K step

// precision tiers of a float32 stream (the codes the C entry points take)
constexpr int TIER_HIGHEST = 0;  // 3xTF32
constexpr int TIER_SPLIT3 = 1;   // three bf16 passes
constexpr int TIER_DEFAULT = 2;  // one bf16 pass

// A tier code an entry point takes for storage type code dtype (0 =
// float32): any tier for float32, "highest" alone for the other types
// (which ignore the knob before it reaches a kernel).
inline bool tier_ok(int dtype, int tier) {
  return tier == TIER_HIGHEST || (dtype == 0 && (tier == TIER_SPLIT3 || tier == TIER_DEFAULT));
}

// f(std::integral_constant<int, TIER>()) for a checked tier code: an entry
// point's launch of its float32 instantiation at that tier.
template <class F>
int with_tier(int tier, F f) {
  if (tier == TIER_SPLIT3) return f(std::integral_constant<int, TIER_SPLIT3>());
  if (tier == TIER_DEFAULT) return f(std::integral_constant<int, TIER_DEFAULT>());
  return f(std::integral_constant<int, TIER_HIGHEST>());
}

// words of a d-value row of itemsize bytes, rounded up to whole K steps
__host__ __device__ inline int row_words(int d, int itemsize) {
  return (d * itemsize + 4 * KSTEP_WORDS - 1) / (4 * KSTEP_WORDS) * KSTEP_WORDS;
}
// the padded row stride, in words: row_words + 4, so 4 (mod 8)
__host__ __device__ inline int padded_stride(int d, int itemsize) {
  return row_words(d, itemsize) + 4;
}

// float32 to TF32 (10 mantissa bits), to nearest, ties away from zero.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo + (an error below 2^-22 |x|), both TF32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// Two floats to bf16, each to nearest even, packed: lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// The two floats a packed bf16x2 word holds (exact).
__device__ __forceinline__ float bf16_low(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_high(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// x0, x1 -> hi = bf16x2(x0, x1) and (split) lo = bf16x2(x0 - hi0, x1 - hi1);
// x - hi is exact in fp32
template <bool SPLIT>
__device__ __forceinline__ void split_bf16x2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  hi = pack_bf16x2(x0, x1);
  if constexpr (SPLIT) lo = pack_bf16x2(x0 - bf16_low(hi), x1 - bf16_high(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_f16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Per storage type: FW = words of query fragment per lane and K step, the
// packing of one fragment word from the float32 queries (``col`` is the
// word's first feature; features past d are zero), and one K step.
template <typename T> struct Mma;

template <> struct Mma<float> {
  static constexpr int FW = 4;  // b0 hi, b1 hi, b0 lo, b1 lo
  static constexpr int PER_WORD = 1;
};
template <> struct Mma<__nv_bfloat16> {
  static constexpr int FW = 2;
  static constexpr int PER_WORD = 2;
  __device__ static uint32_t pack(const float* v) {
    return (uint32_t)__bfloat16_as_ushort(__float2bfloat16(v[0])) |
           ((uint32_t)__bfloat16_as_ushort(__float2bfloat16(v[1])) << 16);
  }
  __device__ static void step(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
    mma_bf16(c, a, b0, b1);
  }
};
template <> struct Mma<__half> {
  static constexpr int FW = 2;
  static constexpr int PER_WORD = 2;
  __device__ static uint32_t pack(const float* v) {
    return (uint32_t)__half_as_ushort(__float2half_rn(v[0])) |
           ((uint32_t)__half_as_ushort(__float2half_rn(v[1])) << 16);
  }
  __device__ static void step(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
    mma_f16(c, a, b0, b1);
  }
};
template <> struct Mma<int8_t> {
  static constexpr int FW = 2;
  static constexpr int PER_WORD = 4;
  // queries arrive quantised (integer values in [-127, 127] held in fp32)
  __device__ static uint32_t pack(const float* v) {
    uint32_t w = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) w |= ((uint32_t)__float2int_rn(v[i]) & 0xffu) << (8 * i);
    return w;
  }
  __device__ static void step(int (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
    mma_s8(c, a, b0, b1);
  }
};

// words of a lane's query fragment per K step (a pair of K steps for the
// bf16 tiers of float32)
template <typename T, int TIER>
__host__ __device__ constexpr int lane_fragment_words() {
  return TIER == TIER_HIGHEST ? Mma<T>::FW : (TIER == TIER_SPLIT3 ? 4 : 2);
}

// words of the fragments of NQ groups of 8 queries over ksteps K steps
template <typename T, int TIER = TIER_HIGHEST>
__host__ __device__ inline int fragment_words(int nq, int ksteps) {
  static_assert(TIER == TIER_HIGHEST || std::is_same<T, float>::value,
                "only a float32 stream has precision tiers");
  const int units = TIER == TIER_HIGHEST ? ksteps : (ksteps + 1) / 2;
  return units * nq * 32 * lane_fragment_words<T, TIER>();
}

// Make the fragments of queries [q0, q0 + 8 NQ) of q (m, d) float32 over
// K steps [ks0, ks0 + ksteps) in qf (fragment_words<T, TIER>(NQ, ksteps)
// words of shared memory, 16-byte aligned): entry ((ks NQ + nq) 32 + lane)
// holds lane's B words of K step ks0 + ks (of the pair of K steps ks0 + 2 ks
// and ks0 + 2 ks + 1 for a bf16 tier) for query group nq.  Queries >= m,
// features >= d and a pair's half past ks0 + ksteps are zero.  Thread tid
// of nthreads; the caller synchronises before tile_mma reads qf.
template <typename T, int NQ, int TIER = TIER_HIGHEST>
__device__ __forceinline__ void stage_query_fragments(const float* __restrict__ q, int q0, int m,
                                                      int d, int ks0, int ksteps, uint32_t* qf,
                                                      int tid, int nthreads) {
  if constexpr (TIER != TIER_HIGHEST) {
    constexpr bool SPLIT = TIER == TIER_SPLIT3;
    const int npairs = (ksteps + 1) / 2;
    for (int e = tid; e < npairs * NQ * 32; e += nthreads) {
      const int lane = e & 31, nq = (e >> 5) % NQ, pr = (e >> 5) / NQ;
      const int g = lane >> 2, t = lane & 3;
      const int qi = q0 + MMA_QUERIES * nq + g;
      const bool second = 2 * pr + 1 < ksteps;  // the pair's K step s + 1 exists
      uint32_t hi[2], lo[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c0 = (ks0 + 2 * pr) * KSTEP_WORDS + t + 4 * h, c1 = c0 + KSTEP_WORDS;
        const float v0 = (qi < m && c0 < d) ? q[(long long)qi * d + c0] : 0.0f;
        const float v1 = (second && qi < m && c1 < d) ? q[(long long)qi * d + c1] : 0.0f;
        split_bf16x2<SPLIT>(v0, v1, hi[h], lo[h]);
      }
      uint32_t* out = qf + (long long)e * lane_fragment_words<T, TIER>();
      out[0] = hi[0]; out[1] = hi[1];
      if constexpr (SPLIT) { out[2] = lo[0]; out[3] = lo[1]; }
    }
    return;
  }
  constexpr int PW = Mma<T>::PER_WORD;
  for (int e = tid; e < ksteps * NQ * 32; e += nthreads) {
    const int lane = e & 31, nq = (e >> 5) % NQ, ks = ks0 + (e >> 5) / NQ;
    const int g = lane >> 2, t = lane & 3;
    const int qi = q0 + MMA_QUERIES * nq + g;
    uint32_t b[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = (ks * KSTEP_WORDS + t + 4 * h) * PW;
      float v[PW];
#pragma unroll
      for (int i = 0; i < PW; ++i)
        v[i] = (qi < m && col + i < d) ? q[(long long)qi * d + col + i] : 0.0f;
      if constexpr (PW == 1) b[h] = __float_as_uint(v[0]);
      else b[h] = Mma<T>::pack(v);
    }
    uint32_t* out = qf + (long long)e * Mma<T>::FW;
    if constexpr (PW == 1) {
      uint32_t hi0, lo0, hi1, lo1;
      split_tf32(__uint_as_float(b[0]), hi0, lo0);
      split_tf32(__uint_as_float(b[1]), hi1, lo1);
      out[0] = hi0; out[1] = hi1; out[2] = lo0; out[3] = lo1;
    } else {
      out[0] = b[0]; out[1] = b[1];
    }
  }
}

// The A fragment of one K step in one instruction: seen as 8 x 8 matrices
// of 16-bit values, the 16 rows x 8 words are four matrices (rows 0-7 and
// 8-15, words 0-3 and 4-7), and ldmatrix hands lane l the word (row l / 4,
// word l % 4) of each: a0..a3 as the MMAs want them.  ``addr`` is this
// lane's row address (shared space): lanes 8i..8i + 7 name the rows of
// matrix i.  Rows 16 bytes apart modulo 128 (the padded stride) are read
// without bank conflicts.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

// tile_mma's bf16 tiers of a float32 tile (see the top of this file): a
// k16 MMA per pair of K steps, the A words of both steps loaded by load_a
// and packed to bf16 (split into hi and lo for split3) in registers; a
// pair's missing second step is zero.  Loads of pair pr + 1 go before the
// MMAs of pair pr; accumulator sets as in tile_mma.
template <int NQ, int TIER>
__device__ __forceinline__ void tile_mma_bf16(const uint32_t* rows16, int stride, int ksteps,
                                              const uint32_t* qf, int lane,
                                              float (&dot)[NQ][4]) {
  constexpr bool SPLIT = TIER == TIER_SPLIT3;
  using B = typename std::conditional<SPLIT, uint4, uint2>::type;  // a lane's fragment
  const uint32_t a_addr = static_cast<uint32_t>(__cvta_generic_to_shared(
      rows16 + ((lane & 7) + 8 * ((lane >> 3) & 1)) * stride + 4 * (lane >> 4)));
  const B* bf = reinterpret_cast<const B*>(qf) + lane;
  constexpr int NACC = SPLIT ? 3 : 1;  // split3: hi*hi, lo*hi, hi*lo
  constexpr int NSET = NQ >= 4 ? 1 : 2;
  const int npairs = (ksteps + 1) / 2;
  float acc[NSET][NACC][NQ][4];
#pragma unroll
  for (int p = 0; p < NSET; ++p)
#pragma unroll
    for (int i = 0; i < NACC; ++i)
#pragma unroll
      for (int nq = 0; nq < NQ; ++nq)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[p][i][nq][c] = 0.0f;
  uint32_t a[2][2][4];  // [buffer][K step of the pair][A word]
  B b[2][NQ];
  auto load = [&](int pr, auto buffer) {
    constexpr int p = decltype(buffer)::value;
    load_a(a[p][0], a_addr + 2 * pr * (4 * KSTEP_WORDS));
    if (2 * pr + 1 < ksteps) {
      load_a(a[p][1], a_addr + (2 * pr + 1) * (4 * KSTEP_WORDS));
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) a[p][1][i] = 0u;
    }
#pragma unroll
    for (int nq = 0; nq < NQ; ++nq) b[p][nq] = bf[(pr * NQ + nq) * 32];
  };
  auto kpair = [&](int pr, auto parity) {
    constexpr int p = decltype(parity)::value;
    constexpr int ps = p % NSET;  // this pair's accumulator set
    if (pr + 1 < npairs) load(pr + 1, std::integral_constant<int, 1 - p>());
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      split_bf16x2<SPLIT>(__uint_as_float(a[p][0][i]), __uint_as_float(a[p][1][i]), hi[i], lo[i]);
#pragma unroll
    for (int nq = 0; nq < NQ; ++nq) {
      if constexpr (SPLIT) {
        const uint4 q = b[p][nq];  // hi0 hi1 lo0 lo1
        mma_bf16(acc[ps][1][nq], lo, q.x, q.y);
        mma_bf16(acc[ps][2][nq], hi, q.z, q.w);
        mma_bf16(acc[ps][0][nq], hi, q.x, q.y);
      } else {
        mma_bf16(acc[ps][0][nq], hi, b[p][nq].x, b[p][nq].y);
      }
    }
  };
  load(0, std::integral_constant<int, 0>());
  int pr = 0;
#pragma unroll 2
  for (; pr + 1 < npairs; pr += 2) {
    kpair(pr, std::integral_constant<int, 0>());
    kpair(pr + 1, std::integral_constant<int, 1>());
  }
  if (pr < npairs) kpair(pr, std::integral_constant<int, 0>());
#pragma unroll
  for (int nq = 0; nq < NQ; ++nq)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float sum[NACC];
#pragma unroll
      for (int i = 0; i < NACC; ++i)
        sum[i] = NSET == 2 ? acc[0][i][nq][c] + acc[NSET - 1][i][nq][c] : acc[0][i][nq][c];
      if constexpr (SPLIT)  // the small terms first, then the large ones
        dot[nq][c] = (sum[1] + sum[2]) + sum[0];
      else
        dot[nq][c] = sum[0];
    }
}

// dot[nq][c] = x[row] . q[query] for this warp's 16 rows, in the MMA's C
// layout: c = 0..3 is (row g, query 2t), (g, 2t + 1), (g + 8, 2t),
// (g + 8, 2t + 1) of query group nq.  ``rows16`` points at the warp's first
// row in the tile (shared memory, rows at ``stride`` words, zero from the
// row's end to its last whole K step); qf holds the block's query fragments.
// One warp; no barrier.  Rows that are not valid give values the caller
// masks: a row's results depend on that row alone.
//
// The few warps of a block cannot hide a load's latency behind each other,
// so the loop hides it itself: the fragments of K step ks + 1 are loaded
// before the MMAs of K step ks start.  With one query group (NQ = 1) even
// and odd K steps sum into accumulator sets of their own, which doubles the
// independent MMA chains; from NQ = 4 up the groups' own chains are enough
// (4 x 3 for float32) and one set keeps the registers.  TIER (float32
// only) picks the precision tier; the bf16 tiers are tile_mma_bf16.
template <typename T, int NQ, int TIER = TIER_HIGHEST>
__device__ __forceinline__ void tile_mma(const uint32_t* rows16, int stride, int ksteps,
                                         const uint32_t* qf, int lane,
                                         typename Tr<T>::S (&dot)[NQ][4]) {
  static_assert(TIER == TIER_HIGHEST || std::is_same<T, float>::value,
                "only a float32 stream has precision tiers");
  if constexpr (TIER != TIER_HIGHEST) {
    tile_mma_bf16<NQ, TIER>(rows16, stride, ksteps, qf, lane, dot);
    return;
  }
  constexpr bool F32 = Mma<T>::PER_WORD == 1;
  using S = typename Tr<T>::S;
  using B = typename std::conditional<F32, uint4, uint2>::type;  // a lane's fragment
  // this lane's row address for ldmatrix (see load_a)
  const uint32_t a_addr = static_cast<uint32_t>(__cvta_generic_to_shared(
      rows16 + ((lane & 7) + 8 * ((lane >> 3) & 1)) * stride + 4 * (lane >> 4)));
  const B* bf = reinterpret_cast<const B*>(qf) + lane;
  constexpr int NACC = F32 ? 3 : 1;  // float32: hi*hi, lo*hi, hi*lo
  constexpr int NSET = NQ >= 4 ? 1 : 2;
  S acc[NSET][NACC][NQ][4];
#pragma unroll
  for (int p = 0; p < NSET; ++p)
#pragma unroll
    for (int i = 0; i < NACC; ++i)
#pragma unroll
      for (int nq = 0; nq < NQ; ++nq)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[p][i][nq][c] = S(0);
  uint32_t a[2][4];
  B b[2][NQ];
  auto load = [&](int ks, auto buffer) {
    constexpr int p = decltype(buffer)::value;
    load_a(a[p], a_addr + ks * (4 * KSTEP_WORDS));
#pragma unroll
    for (int nq = 0; nq < NQ; ++nq) b[p][nq] = bf[(ks * NQ + nq) * 32];
  };
  auto kstep = [&](int ks, auto parity) {
    constexpr int p = decltype(parity)::value;
    constexpr int ps = p % NSET;  // this K step's accumulator set
    if (ks + 1 < ksteps) load(ks + 1, std::integral_constant<int, 1 - p>());
    if constexpr (F32) {
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        split_tf32(__uint_as_float(a[p][i]), hi[i], lo[i]);
#pragma unroll
      for (int nq = 0; nq < NQ; ++nq) {
        const uint4 q = b[p][nq];  // hi0 hi1 lo0 lo1
        mma_tf32(acc[ps][1][nq], lo, q.x, q.y);
        mma_tf32(acc[ps][2][nq], hi, q.z, q.w);
        mma_tf32(acc[ps][0][nq], hi, q.x, q.y);
      }
    } else {
#pragma unroll
      for (int nq = 0; nq < NQ; ++nq)
        Mma<T>::step(acc[ps][0][nq], a[p], b[p][nq].x, b[p][nq].y);
    }
  };
  load(0, std::integral_constant<int, 0>());
  int ks = 0;
#pragma unroll 2
  for (; ks + 1 < ksteps; ks += 2) {
    kstep(ks, std::integral_constant<int, 0>());
    kstep(ks + 1, std::integral_constant<int, 1>());
  }
  if (ks < ksteps) kstep(ks, std::integral_constant<int, 0>());
#pragma unroll
  for (int nq = 0; nq < NQ; ++nq)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if constexpr (NSET == 2) {
        if constexpr (F32)  // the small terms first, then the large ones
          dot[nq][c] = ((acc[0][1][nq][c] + acc[1][1][nq][c]) +
                        (acc[0][2][nq][c] + acc[1][2][nq][c])) +
                       (acc[0][0][nq][c] + acc[1][0][nq][c]);
        else
          dot[nq][c] = acc[0][0][nq][c] + acc[1][0][nq][c];
      } else {
        if constexpr (F32)
          dot[nq][c] = (acc[0][1][nq][c] + acc[0][2][nq][c]) + acc[0][0][nq][c];
        else
          dot[nq][c] = acc[0][0][nq][c];
      }
    }
}

}  // namespace knn
