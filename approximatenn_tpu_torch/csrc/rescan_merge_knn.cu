// Exact k-nearest-neighbour search (squared L2, k <= 128) with the rescan
// merge, for Hopper.
//
// Replaces the TPU kernel approximatenn_tpu/ops/pallas_exact.py:_kernel,
// launched by exact_knn_pallas(merge="rescan").  The rank kernel's contract
// (exact_knn.cu): for every query the k corpus rows of smallest squared L2
// distance, ascending, ties to the smaller id, (n, +inf) past the real
// candidates; an optional per-query excluded id; f32, bf16, f16 or int8
// stored corpora.  What defines this kernel, and what it keeps:
//   * the points' squared norms come in precomputed, pn (n,) float32 from
//     the unrounded corpus, and a candidate's distance is formed in float32
//     as (|q|^2 + pn) - 2 q.x, in that order;
//   * each query's running top-k is unsorted;
//   * a corpus tile whose least distance does not beat the query's running
//     worst is skipped; otherwise the tile's minimum (ties to the smaller
//     id) replaces the worst running slot (ties to the smallest slot) while
//     it beats it, at most k rounds;
//   * at the end the running k leave in ascending order.
//
// What bounds it on this card: as the rank kernel (at 1M x 128 and 1000
// queries, 2.6e11 flop against a 512 MB corpus read; on the tensor cores
// the L2 reads of the corpus once per 32-query block and the MMAs' operand
// issue).  The TPU grid walks the corpus tiles of a query block in
// sequence; Hopper blocks run in parallel, so, as in the rank kernel, the
// corpus is cut into `splits` ranges, each block keeps the running top-k
// of its 32 queries over its range, and a second pass (knn_common.cuh:
// split_merge_kernel) merges the splits' ascending lists by (distance,
// id).  A block runs the rank kernel's tile loop (knn_tile.cuh: cp.async
// ring, tensor-core dot products through knn_mma.cuh:tile_mma); the ring
// also brings each tile's slice of pn, and the multiplying warps write the
// distances into S.  Warp w reads the 128 distances of its queries
// 4w..4w+3 from S (4 per lane), tests the tile's minimum against the
// running worst with one warp reduction, and runs the replace-the-worst
// rounds itself.
//
// Precision: the rank kernel's (exact_knn.cu): a float32 stream at the
// tier asked for ("highest": three TF32 passes, ranks as IEEE fp32 does;
// "split3": three bf16 passes; "default": one), bf16 / f16 at storage
// width with queries rounded to the corpus's type, int8 in int32 (exact).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (plain C interface, loaded through ctypes).

#include "knn_tile.cuh"

namespace {

using namespace knn;

constexpr int MAX_SPLITS = 32;

// The rescan merge's selection step: unsorted running lists rd/ri [QB][k]
// in shared memory; warp w owns queries QPW w .. QPW w + QPW - 1 and keeps
// their running worst (wd, ws), |q|^2 and excluded id in registers.
template <typename T>
struct RescanSelect {
  using S_t = typename Tr<T>::S;
  static constexpr bool PN = true;      // pn's slice of each tile rides in the ring
  static constexpr bool NORMS = false;
  static size_t state_bytes(int k) { return (sizeof(float) + sizeof(int)) * (size_t)tile::QB * k; }

  float* rd;
  int* ri;
  int q0, m, k, warp, lane;
  float* part_d;
  int* part_i;
  float wd[tile::QPW], qnv[tile::QPW];
  int ws[tile::QPW], ex[tile::QPW];
  float qnl[tile::NQ][2];  // |q|^2 of this lane's C-fragment queries

  __device__ RescanSelect(const tile::TiledArgs& a, unsigned char* state, int q0_)
      : rd(reinterpret_cast<float*>(state)),
        ri(reinterpret_cast<int*>(state) + tile::QB * a.k), q0(q0_), m(a.m), k(a.k),
        warp(threadIdx.x >> 5), lane(threadIdx.x & 31), part_d(a.part_d), part_i(a.part_i) {
    for (int e = threadIdx.x; e < tile::QB * k; e += blockDim.x) {
      rd[e] = pos_inf();
      ri[e] = ID_NONE;
    }
#pragma unroll
    for (int i = 0; i < tile::QPW; ++i) {
      const int qi = q0 + tile::QPW * warp + i;
      wd[i] = pos_inf();
      ws[i] = 0;
      qnv[i] = qi < m ? a.qn[qi] : 0.0f;
      ex[i] = (a.excl && qi < m) ? a.excl[qi] : -1;
    }
#pragma unroll
    for (int j = 0; j < tile::NQ; ++j)
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int qi = q0 + MMA_QUERIES * j + 2 * (lane & 3) + b;
        qnl[j][b] = qi < m ? a.qn[qi] : 0.0f;
      }
  }

  __device__ float score(S_t dot, S_t, float pn, int j, int b) const {
    return (qnl[j][b] + pn) - 2.0f * (float)dot;
  }

  __device__ void select(const float* S, int t0, int hi) {
#pragma unroll
    for (int i = 0; i < tile::QPW; ++i) {
      const int qq = tile::QPW * warp + i;
      if (q0 + qq >= m) break;
      float v[4];
      float tmin = pos_inf();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = t0 + lane + 32 * j;
        // rows past the tile's end hold what an earlier tile left
        v[j] = (row < hi && row != ex[i]) ? S[qq * tile::SS + lane + 32 * j] : pos_inf();
        tmin = fminf(tmin, v[j]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        tmin = fminf(tmin, __shfl_xor_sync(0xffffffffu, tmin, off));
      if (tmin < wd[i])
        replace_worst(v, t0, rd + qq * k, ri + qq * k, k, wd[i], ws[i], lane);
    }
  }

  __device__ void finish(int split, int splits) {
#pragma unroll
    for (int i = 0; i < tile::QPW; ++i) {
      const int qq = tile::QPW * warp + i;
      const int qi = q0 + qq;
      if (qi >= m) break;
      const long long o = ((long long)qi * splits + split) * k;
      extract_sorted(rd + qq * k, ri + qq * k, k, lane, part_d + o, part_i + o, 1.0f, ID_NONE);
    }
  }
};

template <typename T, int TIER = TIER_HIGHEST>
int launch(const void* pts, const float* q, const int* excl, const float* qn, const float* pn,
           int n, int d, int m, int k, int splits, float* part_d, int* part_i,
           float* out_d, int* out_i, float scale2, cudaStream_t stream) {
  tile::TiledArgs a{pts, q, qn, pn, excl, n, d, m, k, 0, 0, 0, part_d, part_i};
  cudaError_t err = tile::launch_tiled<T, RescanSelect<T>, TIER>(a, splits, 1, stream);
  if (err != cudaSuccess) return (int)err;
  // the lists hold distances already: no |q|^2 to add
  return (int)launch_split_merge(part_d, part_i, nullptr, n, m, k, splits, scale2, out_d,
                                 out_i, stream);
}

}  // namespace

extern "C" {

// device: the CUDA ordinal of every pointer.  dtype: 0 = float32,
// 1 = bfloat16, 2 = float16, 3 = int8.  tier: 0 = "highest", 1 = "split3",
// 2 = "default" (float32 only; other types take 0).  All pointers are
// device pointers, pts and pn 16-byte aligned; excl may be null.  qn (m,)
// and pn (n,) are float32; part_d/part_i hold m * splits * k entries,
// out_d/out_i m * k.  Returns the CUDA error code (0 = launched).
int exact_knn_rescan_launch(int device, const void* pts, int dtype, int tier, const float* q,
                            const int* excl, const float* qn, const float* pn, int n, int d,
                            int m, int k, int splits, float* part_d, int* part_i,
                            float* out_d, int* out_i, float scale2, void* stream) {
  if (k < 1 || k > knn::KMAX || splits < 1 || splits > MAX_SPLITS || n < 1 || d < 1 || m < 1 ||
      reinterpret_cast<uintptr_t>(pts) % 16 || reinterpret_cast<uintptr_t>(pn) % 16 ||
      !knn::tier_ok(dtype, tier))
    return (int)cudaErrorInvalidValue;
  // this library carries its own CUDA runtime: select the caller's device
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return knn::with_tier(tier, [&](auto t) {
        return launch<float, decltype(t)::value>(pts, q, excl, qn, pn, n, d, m, k, splits, part_d, part_i, out_d, out_i, scale2, s);
      });
    case 1: return launch<__nv_bfloat16>(pts, q, excl, qn, pn, n, d, m, k, splits, part_d, part_i, out_d, out_i, scale2, s);
    case 2: return launch<__half>(pts, q, excl, qn, pn, n, d, m, k, splits, part_d, part_i, out_d, out_i, scale2, s);
    case 3: return launch<int8_t>(pts, q, excl, qn, pn, n, d, m, k, splits, part_d, part_i, out_d, out_i, scale2, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// queries per block and corpus rows per tile (the rank kernel's)
int rescan_merge_knn_query_block() { return knn::tile::QB; }
int rescan_merge_knn_tile_rows() { return knn::TN; }

const char* rescan_merge_knn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
