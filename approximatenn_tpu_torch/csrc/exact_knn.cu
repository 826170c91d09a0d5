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
// That tile loop costs ~5 ps a score at any precision (at SIFT-1M's shape,
// m = 10,000, 84.8 ms against the 3xTF32 bound's 15.5).  A float32 stream at
// "highest" with d a multiple of 4 up to 128, k <= 64 and more than one
// block of 128 queries (ops/exact.py:rank_design) takes the Hopper pipeline
// of knn_wgmma_tf32.cuh instead: TMA-fed 128-row tiles split into TF32
// halves in shared memory, wgmma with 128 queries a block, the top-k read
// from the accumulators by RankSelectWG below (24.9 ms there), persistent
// blocks over the units of ops/exact.py:rank_plan, then the same split
// merge.  Every other type, tier and shape keeps the tile loop.
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
#include "knn_wgmma_tf32.cuh"

namespace {

using namespace knn;

constexpr int MAX_SPLITS = 32;
// the Hopper rank kernel's largest k: 128 sorted lists of k (score, id)
// pairs beside a ring of at least MIN_STAGES slots
constexpr int WG_KMAX = 64;

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

// The rank kernel's selection step on the Hopper pipeline
// (knn_wgmma_tf32.cuh), for float32 at "highest": consumer thread (warp w of
// its warpgroup, lane = 4 g + tq) holds the scores of queries A = 16 w + g
// and B = A + 8 against rows t0 + 8 j + 2 tq + b (j < 16, b < 2) of each
// tile, in the accumulators.  Each query keeps its sorted top-k in shared
// memory, as RankSelect does; the four threads of a quad hold its columns
// and cache its k-th best (score, id).  A tile is one compare a score
// against that cache, into a candidate bit (2 j + b) a query, and one vote;
// where a lane of the warp has a candidate, the slow path takes them one at
// a time a lane: the exact test (lexicographic (score, id), below +inf, not
// the excluded row, inside the split), then the quads' survivors go in by
// tq in turn, each by one thread's insertion into its query's list, the
// cache re-read after each turn.  After warm-up that path is rare.  The
// slow path is one copy, not one a column group: unrolled sixteen times it
// made the consumers' loop too long for the instruction cache (the
// selection took ~5,000 cycles a tile on an H100, ~3x its share).  Lists of
// a warp's 16 queries are that warp's alone: no barrier but __syncwarp.
struct RankSelectWG {
  static size_t state_bytes(int k) { return (size_t)wg::BLOCK_Q * k * (sizeof(float) + sizeof(int)); }

  const wg::tf32::Args& a;  // the launch's (a __grid_constant__ parameter)
  float* sd;                // [BLOCK_Q][k] distances, then [BLOCK_Q][k] ids
  int lane, wl;             // wl: the warp's first list
  int qw, hi;               // the warp's first query, the split's end
  int ex[2];                // queries A and B's excluded rows (-1: none)
  float td[2];              // their k-th best
  int ti[2];

  __device__ RankSelectWG(const wg::tf32::Args& a_, unsigned char* state, int wgi, int wt)
      : a(a_), sd(reinterpret_cast<float*>(state)), lane(wt & 31),
        wl(wgi * wg::WG_Q + 16 * (wt >> 5)) {}

  __device__ int* ids() const { return reinterpret_cast<int*>(sd) + wg::BLOCK_Q * a.k; }
  // the first entry of query i's list (query A: i = 0, B: i = 1)
  __device__ int list(int i) const { return (wl + (lane >> 2) + 8 * i) * a.k; }

  __device__ void begin(int q0, int, int hi_) {
    qw = q0 + (wl & (wg::WG_Q - 1));
    hi = hi_;
    __syncwarp();
    for (int e = lane; e < 16 * a.k; e += 32) {
      sd[wl * a.k + e] = pos_inf();
      ids()[wl * a.k + e] = ID_NONE;
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qi = qw + (lane >> 2) + 8 * i;
      ex[i] = (a.excl && qi < a.m) ? a.excl[qi] : -1;
      td[i] = pos_inf();
      ti[i] = ID_NONE;
    }
  }

  // (v, id) beats query i's k-th best: into its list, by this thread alone
  __device__ void insert(int i, float v, int id) {
    float* d = sd + list(i);
    int* li = ids() + list(i);
    int p = a.k - 1;
    while (p > 0 && lex_less(v, id, d[p - 1], li[p - 1])) {
      d[p] = d[p - 1];
      li[p] = li[p - 1];
      --p;
    }
    d[p] = v;
    li[p] = id;
  }

  // query i's dot product with column `bit` (2 j + b): acc[4 j + 2 i + b],
  // picked without indexing the registers
  template <int I>
  __device__ __forceinline__ static float pick(const float (&acc)[64], int bit) {
    float r = 0.0f;
#pragma unroll
    for (int e = 0; e < 32; ++e)
      if (e == bit) r = acc[4 * (e >> 1) + 2 * I + (e & 1)];
    return r;
  }

  // the slow path: query I's candidates (bits of mk) one at a time a lane;
  // whole warp
  template <int I>
  __device__ void candidates(const float (&acc)[64], const float* nq, int t0, unsigned mk) {
    const int tq = lane & 3;
    while (__any_sync(0xffffffffu, mk)) {
      const bool has = mk != 0;
      const int bit = has ? __ffs(mk) - 1 : 0;
      mk &= mk - 1;
      const float v = fmaf(-2.0f, pick<I>(acc, bit), nq[8 * (bit >> 1) + (bit & 1)]);
      const int id = t0 + 8 * (bit >> 1) + 2 * tq + (bit & 1);
      bool ok = has && v < pos_inf() && id < hi && id != ex[I] &&
                lex_less(v, id, td[I], ti[I]);
      unsigned go = __ballot_sync(0xffffffffu, ok);
      for (int r = 0; r < 4 && go; ++r) {
        if (!(go & (0x11111111u << r))) continue;
        if (ok && tq == r) insert(I, v, id);
        __syncwarp();
        const int o = list(I) + a.k - 1;
        td[I] = sd[o];
        ti[I] = ids()[o];
        ok = ok && tq > r && lex_less(v, id, td[I], ti[I]);
        go = __ballot_sync(0xffffffffu, ok);
      }
    }
  }

  __device__ __forceinline__ void tile(const float (&acc)[64], const float* nq, int t0) {
    unsigned c0 = 0, c1 = 0;  // candidate bits 2 j + b of queries A and B
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float2 nn = *reinterpret_cast<const float2*>(nq + 8 * j);
      // |x|^2 - 2 q.x, as Tr<float>::score rounds it (2 q.x is exact); a
      // NaN score is no candidate
      c0 |= (fmaf(-2.0f, acc[4 * j], nn.x) <= td[0] ? 1u : 0u) << (2 * j);
      c0 |= (fmaf(-2.0f, acc[4 * j + 1], nn.y) <= td[0] ? 2u : 0u) << (2 * j);
      c1 |= (fmaf(-2.0f, acc[4 * j + 2], nn.x) <= td[1] ? 1u : 0u) << (2 * j);
      c1 |= (fmaf(-2.0f, acc[4 * j + 3], nn.y) <= td[1] ? 2u : 0u) << (2 * j);
    }
    if (__any_sync(0xffffffffu, c0 | c1)) {
      candidates<0>(acc, nq, t0, c0);
      candidates<1>(acc, nq, t0, c1);
    }
  }

  __device__ void finish(int split) const {
    __syncwarp();
    for (int e = lane; e < 16 * a.k; e += 32) {
      const int qi = qw + e / a.k;
      if (qi < a.m) {
        const long long o = ((long long)qi * a.splits + split) * a.k + e % a.k;
        a.part_d[o] = sd[wl * a.k + e];
        a.part_i[o] = ids()[wl * a.k + e];
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

// The Hopper rank kernel (float32, "highest"), then the split merge: the
// wrapper's plan (ops/exact.py:rank_plan) gives split_rows, splits, stages
// and blocks.
int launch_wgmma(const void* pts, const float* q, const int* excl, const float* qn, int n, int d,
                 int m, int k, int split_rows, int splits, int stages, int blocks, float* part_d,
                 int* part_i, float* out_d, int* out_i, float scale2, cudaStream_t stream) {
  const int n_qb = (m + wg::BLOCK_Q - 1) / wg::BLOCK_Q;
  const long long units = (long long)n_qb * splits;
  if (units > INT32_MAX || blocks > units) return (int)cudaErrorInvalidValue;
  const int boxes = (d + wg::tf32::BOX - 1) / wg::tf32::BOX;
  const wg::tf32::Args a{q,      excl, part_d,     part_i,     n,     d, m, k, boxes,
                         stages, n_qb, (int)units, split_rows, splits};
  cudaError_t err = wg::tf32::launch<RankSelectWG>(pts, a, blocks, stream);
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

// The rank kernel on the Hopper pipeline (knn_wgmma_tf32.cuh): float32 at
// "highest", d a multiple of 4 in [4, 128], k in [1, 64].  The corpus is cut
// into `splits` (<= 32) splits of split_rows rows (a multiple of 128), none
// empty, each with every block of 128 queries a work unit; `blocks`
// persistent blocks (at most the units) of `stages` ring slots walk them.
// part_d/part_i hold m * splits * k entries, out_d/out_i m * k.  Returns the
// CUDA error code (0 = launched).
int exact_knn_wgmma_launch(int device, const void* pts, const float* q, const int* excl,
                           const float* qn, int n, int d, int m, int k, int split_rows,
                           int splits, int stages, int blocks, float* part_d, int* part_i,
                           float* out_d, int* out_i, float scale2, void* stream) {
  namespace tf = knn::wg::tf32;
  if (k < 1 || k > WG_KMAX || n < 1 || m < 1 || d < 4 || d % 4 || d > tf::MAX_BOXES * tf::BOX ||
      reinterpret_cast<uintptr_t>(pts) % 16 || split_rows < 1 || split_rows % tf::ROWS ||
      splits < 1 || splits > MAX_SPLITS || (long long)split_rows * (splits - 1) >= n ||
      (long long)split_rows * splits < n || stages < tf::MIN_STAGES ||
      stages > tf::MAX_STAGES || blocks < 1)
    return (int)cudaErrorInvalidValue;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  return launch_wgmma(pts, q, excl, qn, n, d, m, k, split_rows, splits, stages, blocks, part_d,
                      part_i, out_d, out_i, scale2, static_cast<cudaStream_t>(stream));
}

// the Hopper rank kernel's geometry: queries a work unit, corpus rows a
// tile, its largest k, and the shared memory of a block of `stages` ring
// slots of items of bpi 16-feature boxes at k
int exact_knn_wgmma_query_block() { return knn::wg::BLOCK_Q; }
int exact_knn_wgmma_tile_rows() { return knn::wg::tf32::ROWS; }
int exact_knn_wgmma_max_k() { return WG_KMAX; }
int exact_knn_wgmma_smem(int stages, int bpi, int k) {
  return (int)knn::wg::tf32::smem_bytes(stages, bpi, RankSelectWG::state_bytes(k));
}

const char* exact_knn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
