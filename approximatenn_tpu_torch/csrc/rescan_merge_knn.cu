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
// What bounds it on this card: fp32 FMA throughput, as the rank kernel (at
// 1M x 128 and 1000 queries, 2.6e11 flop against a 512 MB corpus read).
// The TPU grid walks the corpus tiles of a query block in sequence; Hopper
// blocks run in parallel, so, as in the rank kernel, the corpus is cut into
// `splits` ranges (enough blocks to fill 132 SMs at m = 1000), each block
// keeps the running top-k of its 32 queries over its range, and a second
// pass (knn_common.cuh: split_merge_kernel) merges the splits' ascending
// lists by (distance, id).  A block computes a 32-query x 128-row tile of
// dot products with the rank kernel's tile_dots; warp w holds the 128
// distances of its queries 4w..4w+3 in registers (4 per lane), tests the
// tile's minimum against the running worst with one warp reduction, and
// runs the replace-the-worst rounds itself, so distances never pass
// through shared memory.
//
// Precision: every tier computes the dot product in IEEE fp32 on the CUDA
// cores; bf16/f16 corpora are widened as staged and the queries rounded to
// the corpus's type first; int8 multiplies int8-quantised queries in int32.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (plain C interface, loaded through ctypes).

#include "knn_common.cuh"

namespace {

using namespace knn;

constexpr int MAX_SPLITS = 32;

template <typename T>
__global__ void __launch_bounds__(NT)
rescan_merge_kernel(const T* __restrict__ pts, const float* __restrict__ q,
                    const float* __restrict__ qn, const float* __restrict__ pn,
                    const int* __restrict__ excl, int n, int d, int m, int k,
                    int tiles_per_split, int splits,
                    float* __restrict__ part_d, int* __restrict__ part_i) {
  using S = typename Tr<T>::S;
  extern __shared__ __align__(16) unsigned char smem[];
  S* Qs = reinterpret_cast<S*>(smem);                    // [DC][QB]
  S* Ps = Qs + DC * QB;                                  // [DC][PS]
  S* Pn = Ps + DC * PS;                                  // [TN] (unused: norms are pn)
  float* rd = reinterpret_cast<float*>(Pn + TN);         // [QB][k]
  int* ri = reinterpret_cast<int*>(rd + QB * k);         // [QB][k]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * QB;
  const int split = blockIdx.y;
  const long long lo = (long long)split * tiles_per_split * TN;
  const long long hi_ll = lo + (long long)tiles_per_split * TN;
  const int hi = (int)(hi_ll < n ? hi_ll : n);

  for (int e = tid; e < QB * k; e += NT) { rd[e] = pos_inf(); ri[e] = ID_NONE; }
  // warp w owns queries q0 + 4w + i: their running worst, |q|^2, exclusion
  float wd[4], qnv[4];
  int ws[4], ex[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + 4 * warp + i;
    wd[i] = pos_inf();
    ws[i] = 0;
    qnv[i] = qi < m ? qn[qi] : 0.0f;
    ex[i] = (excl && qi < m) ? excl[qi] : -1;
  }
  __syncthreads();

  for (int t0 = (int)lo; t0 < hi; t0 += TN) {
    S acc[4][4];
    tile_dots<T>(pts, q, q0, m, d, t0, hi, Qs, Ps, Pn, acc);
    float pnv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = t0 + lane + 32 * j;
      pnv[j] = row < hi ? pn[row] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qq = 4 * warp + i;
      if (q0 + qq >= m) break;
      float v[4];
      float tmin = pos_inf();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = t0 + lane + 32 * j;
        v[j] = (row < hi && row != ex[i]) ? (qnv[i] + pnv[j]) - 2.0f * (float)acc[i][j]
                                          : pos_inf();
        tmin = fminf(tmin, v[j]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        tmin = fminf(tmin, __shfl_xor_sync(0xffffffffu, tmin, off));
      if (tmin < wd[i])
        replace_worst(v, t0, rd + qq * k, ri + qq * k, k, wd[i], ws[i], lane);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qq = 4 * warp + i;
    const int qi = q0 + qq;
    if (qi >= m) break;
    const long long o = ((long long)qi * splits + split) * k;
    extract_sorted(rd + qq * k, ri + qq * k, k, lane, part_d + o, part_i + o, 1.0f, ID_NONE);
  }
}

template <typename T>
size_t rescan_merge_smem(int k) {
  using S = typename Tr<T>::S;
  return sizeof(S) * (DC * QB + DC * PS + TN) + (sizeof(float) + sizeof(int)) * (size_t)QB * k;
}

template <typename T>
int launch(const void* pts, const float* q, const int* excl, const float* qn, const float* pn,
           int n, int d, int m, int k, int splits, float* part_d, int* part_i,
           float* out_d, int* out_i, float scale2, cudaStream_t stream) {
  const int n_tiles = (n + TN - 1) / TN;
  const int tps = (n_tiles + splits - 1) / splits;
  const size_t smem = rescan_merge_smem<T>(k);
  cudaError_t err = cudaFuncSetAttribute(rescan_merge_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((m + QB - 1) / QB, splits);
  rescan_merge_kernel<T><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(pts), q, qn, pn, excl, n, d, m, k, tps, splits, part_d, part_i);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // the lists hold distances already: no |q|^2 to add
  return (int)launch_split_merge(part_d, part_i, nullptr, n, m, k, splits, scale2, out_d,
                                 out_i, stream);
}

}  // namespace

extern "C" {

// device: the CUDA ordinal of every pointer.  dtype: 0 = float32,
// 1 = bfloat16, 2 = float16, 3 = int8.  All pointers are device pointers;
// excl may be null.  qn (m,) and pn (n,) are float32; part_d/part_i hold
// m * splits * k entries, out_d/out_i m * k.  Returns the CUDA error code
// (0 = launched).
int exact_knn_rescan_launch(int device, const void* pts, int dtype, const float* q,
                            const int* excl, const float* qn, const float* pn, int n, int d,
                            int m, int k, int splits, float* part_d, int* part_i,
                            float* out_d, int* out_i, float scale2, void* stream) {
  if (k < 1 || k > knn::KMAX || splits < 1 || splits > MAX_SPLITS || n < 1 || d < 1 || m < 1)
    return (int)cudaErrorInvalidValue;
  // this library carries its own CUDA runtime: select the caller's device
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(pts, q, excl, qn, pn, n, d, m, k, splits, part_d, part_i, out_d, out_i, scale2, s);
    case 1: return launch<__nv_bfloat16>(pts, q, excl, qn, pn, n, d, m, k, splits, part_d, part_i, out_d, out_i, scale2, s);
    case 2: return launch<__half>(pts, q, excl, qn, pn, n, d, m, k, splits, part_d, part_i, out_d, out_i, scale2, s);
    case 3: return launch<int8_t>(pts, q, excl, qn, pn, n, d, m, k, splits, part_d, part_i, out_d, out_i, scale2, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* rescan_merge_knn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
