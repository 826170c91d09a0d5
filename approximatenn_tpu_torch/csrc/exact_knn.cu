// Exact k-nearest-neighbour search (squared L2, k <= 128) for Hopper.
//
// Replaces the TPU kernel approximatenn_tpu/ops/pallas_exact.py:_kernel_rank
// (with its helpers _rank_insert and _rank_merge), launched by
// exact_knn_pallas(merge="rank").  Same contract: for every query, the k
// corpus rows of smallest squared L2 distance on the raw coordinates,
// ascending, ties to the smaller id, rows that run out padded with
// (n, +inf); an optional per-query excluded id; f32, bf16, f16 or int8
// stored corpora.
//
// What bounds it on this card.  At d = 128 a batch of 1000 queries against
// 1M points is m*n*d*2 = 2.6e11 flop against a 512 MB corpus read: by the
// H100 SXM datasheet (67 TFLOP/s fp32 on the CUDA cores, 495 TF32 on the
// tensor cores, 3.35 TB/s of HBM; none measured here) the arithmetic, not
// the read, sets the least time.  On the tensor cores float32 takes three
// TF32 passes (7.7e11 flop, 1.55 ms at the dense peak), and what is left is
// the L2 traffic of reading the corpus once per block of 32 queries (16 GB
// a call) and the instruction issue of the MMAs' operands.  The design:
//   * pass 1, grid (query blocks x corpus splits): the TPU grid carries its
//     running top-k from one step to the next; Hopper blocks run in
//     parallel, so the corpus is cut into `splits` ranges (so that the
//     blocks fill the card's SMs in whole waves, ops/exact.py:splits) and
//     every block keeps its own top-k.  The block walks its range's
//     128-row tiles through the tile loop of knn_tile.cuh: copying warps
//     fill a cp.async ring, eight multiplying warps take 16 rows each
//     against the block's 32 queries on the tensor cores (knn_mma.cuh:
//     tile_mma) and form the scores |x|^2 - 2 q.x in a padded array S,
//     with |x|^2 summed from the values in the slot: the norms of the
//     corpus as streamed.  Selection: one warp per query compares the
//     tile's scores with the query's current k-th best and inserts the few
//     that beat it into a sorted list in shared memory (warp-cooperative
//     shift).  After warm-up only ~k ln(n) candidates per query are ever
//     inserted, so selection costs little next to the dot products.
//   * pass 2 (knn_common.cuh: split_merge_kernel): one warp per query
//     merges the `splits` sorted partial lists by (score, id), adds |q|^2
//     and applies the sentinel.
// Ranking runs in the TPU kernel's score domain, |x|^2 - 2 q.x, with |q|^2
// added at emit; ties order by (score, id), so the result does not depend
// on the split or on the order in which candidates arrive.
//
// Precision: a float32 stream takes the JAX package's matmul_precision
// tiers (knn_mma.cuh), each a kernel of its own: "highest" is 3xTF32 with
// fp32 accumulation, within fp32 summation error of the IEEE dot product,
// so it ranks as IEEE fp32 does; "split3" the three bf16 passes of the JAX
// package's _dot_split3 (hi*hi + hi*lo + lo*hi); "default" one bf16 pass of
// the rounded factors, as Precision.DEFAULT on the TPU.  bf16 / f16 corpora multiply at storage width
// with queries rounded to the corpus's type first, as the TPU kernel feeds
// its MXU (exact products, fp32 accumulation); int8 corpora multiply
// int8-quantised queries in int32 (exact).  Norms are fp32 sums of the
// streamed values' squares (int32 for int8).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (plain C interface, loaded through ctypes).

#include "knn_tile.cuh"

namespace {

using namespace knn;

constexpr int MAX_SPLITS = 32;

// The rank kernel's selection step: sorted lists topd/topi [QB][k] in
// shared memory; warp w owns queries w, w + NW, ...
template <typename T>
struct RankSelect {
  using S_t = typename Tr<T>::S;
  static constexpr bool PN = false;     // no precomputed norms
  static constexpr bool NORMS = true;   // norms of the values in the slot
  static size_t state_bytes(int k) { return (sizeof(float) + sizeof(int)) * (size_t)tile::QB * k; }

  float* topd;
  int* topi;
  const int* excl;
  int q0, m, k, warp, lane;
  float* part_d;
  int* part_i;

  __device__ RankSelect(const tile::TiledArgs& a, unsigned char* state, int q0_)
      : topd(reinterpret_cast<float*>(state)),
        topi(reinterpret_cast<int*>(state) + tile::QB * a.k), excl(a.excl), q0(q0_), m(a.m),
        k(a.k), warp(threadIdx.x >> 5), lane(threadIdx.x & 31), part_d(a.part_d),
        part_i(a.part_i) {
    for (int e = threadIdx.x; e < tile::QB * k; e += blockDim.x) {
      topd[e] = pos_inf();
      topi[e] = ID_NONE;
    }
  }

  __device__ float score(S_t dot, S_t norm, float, int, int) const {
    return Tr<T>::score(norm, dot);
  }

  __device__ void select(const float* S, int t0, int hi) {
    for (int qq = warp; qq < tile::QB; qq += NW) {
      const int qi = q0 + qq;
      if (qi >= m) break;
      float* ld = topd + qq * k;
      int* li = topi + qq * k;
      const int ex = excl ? excl[qi] : -1;
      float wd = ld[k - 1];
      int wi = li[k - 1];
#pragma unroll
      for (int r0 = 0; r0 < TN; r0 += 32) {
        const int r = r0 + lane;
        const int id = t0 + r;
        const float dv = S[qq * tile::SS + r];
        const bool ok = id < hi && id != ex && dv < pos_inf() && lex_less(dv, id, wd, wi);
        unsigned mask = __ballot_sync(0xffffffffu, ok);
        while (mask) {
          const int src = __ffs(mask) - 1;
          mask &= mask - 1;
          const float cd = __shfl_sync(0xffffffffu, dv, src);
          const int ci = __shfl_sync(0xffffffffu, id, src);
          if (lex_less(cd, ci, wd, wi)) {
            warp_insert(ld, li, k, cd, ci, lane);
            wd = ld[k - 1];
            wi = li[k - 1];
          }
        }
      }
    }
  }

  __device__ void finish(int split, int splits) const {
    for (int qq = warp; qq < tile::QB; qq += NW) {
      const int qi = q0 + qq;
      if (qi >= m) break;
      const long long o = ((long long)qi * splits + split) * k;
      for (int j = lane; j < k; j += 32) {
        part_d[o + j] = topd[qq * k + j];
        part_i[o + j] = topi[qq * k + j];
      }
    }
  }
};

template <typename T, int TIER = TIER_HIGHEST>
int launch(const void* pts, const float* q, const int* excl, const float* qn, int n, int d,
           int m, int k, int splits, float* part_d, int* part_i, float* out_d, int* out_i,
           float scale2, cudaStream_t stream) {
  tile::TiledArgs a{pts, q, nullptr, nullptr, excl, n, d, m, k, 0, 0, 0, part_d, part_i};
  cudaError_t err = tile::launch_tiled<T, RankSelect<T>, TIER>(a, splits, 1, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_split_merge(part_d, part_i, qn, n, m, k, splits, scale2, out_d, out_i,
                                 stream);
}

}  // namespace

extern "C" {

// device: the CUDA ordinal of every pointer.  dtype: 0 = float32,
// 1 = bfloat16, 2 = float16, 3 = int8.  tier: 0 = "highest", 1 = "split3",
// 2 = "default" (float32 only; other types take 0).  All pointers are
// device pointers, pts 16-byte aligned; excl may be null.  part_d/part_i
// hold m * splits * k entries, out_d/out_i m * k.  Returns the CUDA error
// code (0 = launched).
int exact_knn_launch(int device, const void* pts, int dtype, int tier, const float* q,
                     const int* excl, const float* qn, int n, int d, int m, int k,
                     int splits, float* part_d, int* part_i, float* out_d,
                     int* out_i, float scale2, void* stream) {
  if (k < 1 || k > knn::KMAX || splits < 1 || splits > MAX_SPLITS || n < 1 || d < 1 || m < 1 ||
      reinterpret_cast<uintptr_t>(pts) % 16 || !knn::tier_ok(dtype, tier))
    return (int)cudaErrorInvalidValue;
  // this library carries its own CUDA runtime: select the caller's device
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return knn::with_tier(tier, [&](auto t) {
        return launch<float, decltype(t)::value>(pts, q, excl, qn, n, d, m, k, splits, part_d, part_i, out_d, out_i, scale2, s);
      });
    case 1: return launch<__nv_bfloat16>(pts, q, excl, qn, n, d, m, k, splits, part_d, part_i, out_d, out_i, scale2, s);
    case 2: return launch<__half>(pts, q, excl, qn, n, d, m, k, splits, part_d, part_i, out_d, out_i, scale2, s);
    case 3: return launch<int8_t>(pts, q, excl, qn, n, d, m, k, splits, part_d, part_i, out_d, out_i, scale2, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// queries per block and corpus rows per tile: a call's pass 1 runs
// ceil(m / query block) x splits blocks over 128-row tiles
int exact_knn_query_block() { return knn::tile::QB; }
int exact_knn_tile_rows() { return knn::TN; }

const char* exact_knn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
