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
// What bounds it on this card: fp32 FMA throughput.  At d = 128 a batch of
// 1000 queries against 1M points is m*n*d*2 = 2.6e11 flop, while the
// corpus read is 512 MB: ~500 flop per byte read.  By the H100 SXM
// datasheet's figures (67 TFLOP/s fp32 on the CUDA cores, 3.35 TB/s of
// HBM; neither measured here) the balance point is ~20 flop per byte, so
// the arithmetic, not the read, sets the time.  The design therefore spends
// its effort on keeping the
// FMA pipes fed and reads the corpus once per block of 32 queries:
//   * pass 1, grid (query blocks x corpus splits): the TPU grid carries its
//     running top-k from one step to the next; Hopper blocks run in
//     parallel, so the corpus is cut into `splits` ranges (enough blocks to
//     fill 132 SMs at m = 1000) and every block keeps its own top-k.  A
//     block stages 128-row corpus tiles and its 32 queries in shared memory
//     in 32-feature chunks and computes a 4x4 register tile of dot products
//     per thread with fp32 FMAs on the CUDA cores (int32 multiply-adds for
//     int8).  The tile's scores go to shared memory; one warp per query
//     compares them with the query's current k-th best and inserts the few
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
// Precision: every tier ("highest", "split3", "default") computes the dot
// product in IEEE fp32 on the CUDA cores, at least as exact as each TPU
// tier.  bf16/f16 corpora are widened to fp32 as staged and the queries
// rounded to the storage type first, as the TPU kernel feeds its MXU.
// int8 corpora multiply int8-quantised queries in int32 (exact).  A
// tensor-core path (3xTF32 or bf16x3, TF32) is later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (plain C interface, loaded through ctypes).

#include "knn_common.cuh"

namespace {

using namespace knn;

constexpr int MAX_SPLITS = 32;

template <typename T>
__global__ void __launch_bounds__(NT)
knn_partial_kernel(const T* __restrict__ pts, const float* __restrict__ q,
                   const int* __restrict__ excl, int n, int d, int m, int k,
                   int tiles_per_split, int splits,
                   float* __restrict__ part_d, int* __restrict__ part_i) {
  using S = typename Tr<T>::S;
  extern __shared__ __align__(16) unsigned char smem[];
  S* Qs = reinterpret_cast<S*>(smem);                    // [DC][QB]
  S* Ps = Qs + DC * QB;                                  // [DC][PS]
  float* Ds = reinterpret_cast<float*>(Ps + DC * PS);    // [QB][TN]
  S* Pn = reinterpret_cast<S*>(Ds + QB * TN);            // [TN]
  float* topd = reinterpret_cast<float*>(Pn + TN);       // [QB][k]
  int* topi = reinterpret_cast<int*>(topd + QB * k);     // [QB][k]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * QB;
  const int split = blockIdx.y;
  const long long lo = (long long)split * tiles_per_split * TN;
  const long long hi_ll = lo + (long long)tiles_per_split * TN;
  const int hi = (int)(hi_ll < n ? hi_ll : n);

  for (int e = tid; e < QB * k; e += NT) { topd[e] = __int_as_float(0x7f800000); topi[e] = ID_NONE; }

  const int tq = tid >> 5;   // query group: queries tq*4 .. tq*4+3
  const int tp = tid & 31;   // point lane: rows tp + 32 j
  for (int t0 = (int)lo; t0 < hi; t0 += TN) {
    S acc[4][4];
    tile_dots<T>(pts, q, q0, m, d, t0, hi, Qs, Ps, Pn, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tp + 32 * j;
        Ds[(tq * 4 + i) * TN + r] = Tr<T>::score(Pn[r], acc[i][j]);
      }
    __syncthreads();
    // selection: warp w owns queries w, w + NW, ...
    for (int qq = warp; qq < QB; qq += NW) {
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
        const float dv = Ds[qq * TN + r];
        const bool ok = id < hi && id != ex && dv < __int_as_float(0x7f800000) &&
                        lex_less(dv, id, wd, wi);
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
  __syncthreads();
  for (int e = tid; e < QB * k; e += NT) {
    const int qq = e / k, j = e % k;
    const int qi = q0 + qq;
    if (qi < m) {
      const long long o = ((long long)qi * splits + split) * k + j;
      part_d[o] = topd[e];
      part_i[o] = topi[e];
    }
  }
}

template <typename T>
size_t partial_smem(int k) {
  using S = typename Tr<T>::S;
  return sizeof(S) * (DC * QB + DC * PS + TN) + sizeof(float) * QB * TN +
         (sizeof(float) + sizeof(int)) * (size_t)QB * k;
}

template <typename T>
int launch(const void* pts, const float* q, const int* excl, const float* qn,
           int n, int d, int m, int k, int splits, float* part_d, int* part_i,
           float* out_d, int* out_i, float scale2, cudaStream_t stream) {
  const int n_tiles = (n + TN - 1) / TN;
  const int tps = (n_tiles + splits - 1) / splits;
  const size_t smem = partial_smem<T>(k);
  cudaError_t err = cudaFuncSetAttribute(knn_partial_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid1((m + QB - 1) / QB, splits);
  knn_partial_kernel<T><<<grid1, NT, smem, stream>>>(
      static_cast<const T*>(pts), q, excl, n, d, m, k, tps, splits, part_d, part_i);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_split_merge(part_d, part_i, qn, n, m, k, splits, scale2, out_d,
                                 out_i, stream);
}

}  // namespace

extern "C" {

// device: the CUDA ordinal of every pointer.  dtype: 0 = float32,
// 1 = bfloat16, 2 = float16, 3 = int8.  All pointers are device pointers;
// excl may be null.  part_d/part_i hold m * splits * k
// entries, out_d/out_i m * k.  Returns the CUDA error code (0 = launched).
int exact_knn_launch(int device, const void* pts, int dtype, const float* q,
                     const int* excl, const float* qn, int n, int d, int m, int k,
                     int splits, float* part_d, int* part_i, float* out_d,
                     int* out_i, float scale2, void* stream) {
  if (k < 1 || k > knn::KMAX || splits < 1 || splits > MAX_SPLITS || n < 1 || d < 1 || m < 1)
    return (int)cudaErrorInvalidValue;
  // this library carries its own CUDA runtime: select the caller's device
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(pts, q, excl, qn, n, d, m, k, splits, part_d, part_i, out_d, out_i, scale2, s);
    case 1: return launch<__nv_bfloat16>(pts, q, excl, qn, n, d, m, k, splits, part_d, part_i, out_d, out_i, scale2, s);
    case 2: return launch<__half>(pts, q, excl, qn, n, d, m, k, splits, part_d, part_i, out_d, out_i, scale2, s);
    case 3: return launch<int8_t>(pts, q, excl, qn, n, d, m, k, splits, part_d, part_i, out_d, out_i, scale2, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* exact_knn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
