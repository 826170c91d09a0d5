// The two-phase exact k-nearest-neighbour engine for Hopper: the segment
// emit pass and the window rescan.
//
// Replaces two TPU kernels of approximatenn_tpu/ops/pallas_exact.py:
//   * _kernel_emit (launched by exact_knn_pallas(merge="twophase")): for
//     every query and every `seg`-row segment of the corpus, the minimum
//     score |x|^2 - 2 q.x and its row id.  Rows >= n and the query's
//     excluded id score +inf; ties go to the smaller id.  Segments are
//     global and contiguous: segment s is rows [s*seg, min((s+1)*seg, n)).
//   * _kernel_rescan (launched by _rescan_pallas from exact_knn_twophase):
//     for every query, P windows of `seg` rows (the P best segments, picked
//     in PyTorch from the emit output; start n = an exhausted pick), the
//     squared L2 distance in diff form, sum((x - q)^2) in fp32, and either
//     the k nearest (k <= 128, ascending, ties to the smaller id, (n, +inf)
//     past the real rows) or every window row's (distance, id) for a
//     selection outside the kernel (k > 128).
// The TPU windows are clamped to aligned DMA starts, which made the kernel
// deduplicate by position and merge the unaligned tail separately.  Here a
// window is exactly its segment: the picked segments are unique per query,
// so the windows are disjoint and no row is seen twice.
//
// What bounds them on this card:
//   * emit does the rank kernel's 2*m*n*d fp32 products (2.6e11 flop at
//     1M x 128, m = 1000) against one corpus read (512 MB) and an output of
//     m * n/seg pairs: fp32 FMA throughput sets its time.  It runs the
//     tiled CUDA-core dot product (knn_common.cuh tile_dots: 32-query x
//     128-row tiles staged in shared memory, a 4x4 register tile of dot
//     products per thread) and swaps the
//     top-k insert for a segment min/argmin taken straight from the
//     registers: a warp holds 4 queries x 128 rows, so a segment of up to
//     128 rows reduces inside the warp with shuffles, and a longer one
//     carries a running (min, id) per query across the tiles of a split.
//     Splits are cut on segment boundaries, so every segment is reduced by
//     one block and nothing is merged afterwards.
//   * rescan scores m * P * seg (query, row) pairs (786 MB of row loads at
//     1M, m = 1000, k = 10) at 3 flop per element; queries that pick the
//     same segment share its rows, so the least it must read from memory
//     is the distinct rows (~6,100 of the 7,813 segments, ~400 MB, there).
//     Memory, not arithmetic, sets its time.  One block per
//     query; a warp computes one row at a time with coalesced loads over
//     the features and a shuffle sum, then inserts the 32 rows it just
//     scored into its own sorted top-k (ballot against the current k-th,
//     warp-cooperative shift, as the rank kernel does).  The eight warp
//     lists are merged at the end.  No array of all P * seg distances is
//     kept: at seg = 512, k = 126 that would be 65,536 candidates a query.
//
// Precision: emit computes the dot products in IEEE fp32 on the CUDA cores
// for every tier (bf16/f16 corpora widened as staged, queries rounded to
// the storage type first; int8 in int32, exact), as exact_knn.cu does.
// Rescan widens every element to fp32; int8 queries arrive quantised.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (plain C interface, loaded through ctypes).

#include "knn_common.cuh"

namespace {

using namespace knn;

// Emit: grid (query blocks, corpus splits).  seg is a power of two; a
// split covers tiles_per_split tiles, a multiple of seg / TN when seg > TN.
template <typename T>
__global__ void __launch_bounds__(NT)
emit_kernel(const T* __restrict__ pts, const float* __restrict__ q,
            const int* __restrict__ excl, int n, int d, int m, int seg,
            int n_seg, int tiles_per_split, float* __restrict__ seg_d,
            int* __restrict__ seg_i) {
  using S = typename Tr<T>::S;
  extern __shared__ __align__(16) unsigned char smem[];
  S* Qs = reinterpret_cast<S*>(smem);    // [DC][QB]
  S* Ps = Qs + DC * QB;                  // [DC][PS]
  S* Pn = Ps + DC * PS;                  // [TN]

  const int tid = threadIdx.x;
  const int tq = tid >> 5;   // warp: queries tq*4 .. tq*4+3
  const int tp = tid & 31;   // lane: rows tp + 32 j of the tile
  const int q0 = blockIdx.x * QB;
  const long long lo = (long long)blockIdx.y * tiles_per_split * TN;
  if (lo >= n) return;  // uniform over the block
  const long long hi_ll = lo + (long long)tiles_per_split * TN;
  const int hi = (int)(hi_ll < n ? hi_ll : n);

  int qi[4], ex[4];
  float rd[4];  // running segment minimum (seg > TN)
  int ri[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    qi[i] = q0 + tq * 4 + i;
    ex[i] = (excl != nullptr && qi[i] < m) ? excl[qi[i]] : -1;
    rd[i] = pos_inf();
    ri[i] = ID_NONE;
  }

  for (int t0 = (int)lo; t0 < hi; t0 += TN) {
    S acc[4][4];
    tile_dots<T>(pts, q, q0, m, d, t0, hi, Qs, Ps, Pn, acc);

    float sc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = t0 + tp + 32 * j;
      const S pn = Pn[tp + 32 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        sc[i][j] = (row < hi && row != ex[i]) ? Tr<T>::score(pn, acc[i][j]) : pos_inf();
    }

    if (seg >= TN) {
      // the tile lies inside one segment: reduce it, fold it into the
      // running pair, and write the pair where the segment (or split) ends
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float bd = sc[i][0];
        int bi = t0 + tp;
#pragma unroll
        for (int j = 1; j < 4; ++j)
          if (lex_less(sc[i][j], t0 + tp + 32 * j, bd, bi)) { bd = sc[i][j]; bi = t0 + tp + 32 * j; }
        warp_lex_min(bd, bi, 32);
        if (lex_less(bd, bi, rd[i], ri[i])) { rd[i] = bd; ri[i] = bi; }
      }
      const int t_end = t0 + TN;
      if (t_end % seg == 0 || t_end >= hi) {
        const int s = t0 / seg;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (tp == 0 && qi[i] < m) {
            seg_d[(long long)qi[i] * n_seg + s] = rd[i];
            seg_i[(long long)qi[i] * n_seg + s] = ri[i];
          }
          rd[i] = pos_inf();
          ri[i] = ID_NONE;
        }
      }
    } else if (seg >= 32) {
      // a segment is seg / 32 of the thread's rows, one per 32-row chunk
      // (constant register indices: seg is 32 or 64 here)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (seg == 64 && (j & 1)) continue;
          float bd = sc[i][j];
          int bi = t0 + tp + 32 * j;
          if (seg == 64) {
            const int j2 = (j + 1) & 3;
            if (lex_less(sc[i][j2], t0 + tp + 32 * j2, bd, bi)) { bd = sc[i][j2]; bi = t0 + tp + 32 * j2; }
          }
          warp_lex_min(bd, bi, 32);
          const int s = (t0 + 32 * j) / seg;
          if (tp == 0 && qi[i] < m && s < n_seg) {
            seg_d[(long long)qi[i] * n_seg + s] = bd;
            seg_i[(long long)qi[i] * n_seg + s] = bi;
          }
        }
      }
    } else {
      // a segment is `seg` neighbouring lanes of one 32-row chunk
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float bd = sc[i][j];
          int bi = t0 + tp + 32 * j;
          warp_lex_min(bd, bi, seg);
          const int s = (t0 + 32 * j + tp) / seg;
          if ((tp & (seg - 1)) == 0 && qi[i] < m && s < n_seg) {
            seg_d[(long long)qi[i] * n_seg + s] = bd;
            seg_i[(long long)qi[i] * n_seg + s] = bi;
          }
        }
      }
    }
  }
}

// Rescan: one block per query.  starts (m, P): the first row of each
// window, n for an exhausted pick; window p covers local rows
// [p * seg, (p + 1) * seg).  k > 0: the k nearest into out (m, k);
// k == 0: every local row's (distance, id) into out (m, P * seg), +inf and
// id n where the row does not exist.
template <typename T>
__global__ void __launch_bounds__(NT)
rescan_kernel(const T* __restrict__ pts, const float* __restrict__ q,
              const int* __restrict__ starts, int n, int d, int P,
              int seg_log, int k, float* __restrict__ out_d,
              int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qv = reinterpret_cast<float*>(smem);   // [d]
  int* St = reinterpret_cast<int*>(Qv + d);      // [P]
  float* topd = reinterpret_cast<float*>(St + P);  // [NW][k]
  int* topi = reinterpret_cast<int*>(topd + NW * k);  // [NW][k]

  const int qi = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int seg = 1 << seg_log;
  const int L = P << seg_log;
  for (int c = tid; c < d; c += NT) Qv[c] = (float)Tr<T>::qv(q[(long long)qi * d + c]);
  for (int p = tid; p < P; p += NT) St[p] = starts[(long long)qi * P + p];
  for (int e = tid; e < NW * k; e += NT) { topd[e] = pos_inf(); topi[e] = ID_NONE; }
  __syncthreads();

  float* ld = topd + warp * k;
  int* li = topi + warp * k;
  float wd = pos_inf();
  int wi = ID_NONE;
  // warp w scores the 32-row groups w, w + NW, ...; lane r keeps row r's result
  for (int l0 = warp * 32; l0 < L; l0 += NW * 32) {
    float my_d = pos_inf();
    int my_i = n;
#pragma unroll 4
    for (int r = 0; r < 32; ++r) {
      const int l = l0 + r;
      bool valid = false;
      int row = 0;
      if (l < L) {
        const int s = St[l >> seg_log];
        const int o = l & (seg - 1);
        valid = s < n && o < n - s;
        if (valid) row = s + o;
      }
      float acc = 0.f;
      if (valid) {  // uniform over the warp
        const T* x = pts + (long long)row * d;
        for (int c = lane; c < d; c += 32) {
          const float df = (float)Tr<T>::pt(x, c) - Qv[c];
          acc = fmaf(df, df, acc);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == r && valid) { my_d = acc; my_i = row; }
    }
    if (k == 0) {
      const int l = l0 + lane;
      if (l < L) {
        out_d[(long long)qi * L + l] = my_d;
        out_i[(long long)qi * L + l] = my_i;
      }
      continue;
    }
    const bool ok = my_d < pos_inf() && lex_less(my_d, my_i, wd, wi);
    unsigned mask = __ballot_sync(0xffffffffu, ok);
    while (mask) {
      const int src = __ffs(mask) - 1;
      mask &= mask - 1;
      const float cd = __shfl_sync(0xffffffffu, my_d, src);
      const int ci = __shfl_sync(0xffffffffu, my_i, src);
      if (lex_less(cd, ci, wd, wi)) {
        warp_insert(ld, li, k, cd, ci, lane);
        wd = ld[k - 1];
        wi = li[k - 1];
      }
    }
  }
  if (k == 0) return;
  __syncthreads();
  // warp 0 merges the NW sorted lists (rows are disjoint across warps)
  if (warp != 0) return;
  int head = 0;
  float hd = pos_inf();
  int hid = ID_NONE;
  if (lane < NW) { hd = topd[lane * k]; hid = topi[lane * k]; }
  for (int j = 0; j < k; ++j) {
    float bd = hd;
    int bi = hid, bl = lane;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, bd, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      const int ol = __shfl_xor_sync(0xffffffffu, bl, off);
      if (lex_less(od, oi, bd, bi) || (od == bd && oi == bi && ol < bl)) { bd = od; bi = oi; bl = ol; }
    }
    if (lane == 0) {
      const long long o = (long long)qi * k + j;
      const bool real = bd < pos_inf();
      out_d[o] = real ? bd : pos_inf();
      out_i[o] = real ? bi : n;
    }
    if (lane == bl) {
      ++head;
      if (head < k) { hd = topd[lane * k + head]; hid = topi[lane * k + head]; }
      else { hd = pos_inf(); hid = ID_NONE; }
    }
  }
}

template <typename T>
int emit(const void* pts, const float* q, const int* excl, int n, int d, int m,
         int seg, int n_seg, int splits, float* seg_d, int* seg_i, cudaStream_t stream) {
  using S = typename Tr<T>::S;
  const int n_tiles = (n + TN - 1) / TN;
  const int tiles_per_seg = seg > TN ? seg / TN : 1;
  int tps = (n_tiles + splits - 1) / splits;
  tps = (tps + tiles_per_seg - 1) / tiles_per_seg * tiles_per_seg;
  const int used = (n_tiles + tps - 1) / tps;
  const size_t smem = sizeof(S) * (DC * QB + DC * PS + TN);
  dim3 grid((m + QB - 1) / QB, used);
  emit_kernel<T><<<grid, NT, smem, stream>>>(static_cast<const T*>(pts), q, excl, n, d, m,
                                             seg, n_seg, tps, seg_d, seg_i);
  return (int)cudaGetLastError();
}

template <typename T>
int rescan(const void* pts, const float* q, const int* starts, int n, int d, int m,
           int P, int seg_log, int k, float* out_d, int* out_i, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)d + sizeof(int) * (size_t)P +
                      (sizeof(float) + sizeof(int)) * (size_t)NW * k;
  cudaError_t err = cudaFuncSetAttribute(rescan_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  rescan_kernel<T><<<m, NT, smem, stream>>>(static_cast<const T*>(pts), q, starts, n, d, P,
                                            seg_log, k, out_d, out_i);
  return (int)cudaGetLastError();
}

bool pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

}  // namespace

extern "C" {

// device: the CUDA ordinal of every pointer.  dtype: 0 = float32,
// 1 = bfloat16, 2 = float16, 3 = int8.  All pointers are device pointers;
// excl may be null.  seg_d/seg_i hold m * n_seg entries, n_seg =
// ceil(n / seg).  Returns the CUDA error code (0 = launched).
int twophase_emit_launch(int device, const void* pts, int dtype, const float* q,
                         const int* excl, int n, int d, int m, int seg, int n_seg,
                         int splits, float* seg_d, int* seg_i, void* stream) {
  if (!pow2(seg) || n < 1 || d < 1 || m < 1 || splits < 1 ||
      n_seg != (int)(((long long)n + seg - 1) / seg))
    return (int)cudaErrorInvalidValue;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return emit<float>(pts, q, excl, n, d, m, seg, n_seg, splits, seg_d, seg_i, s);
    case 1: return emit<__nv_bfloat16>(pts, q, excl, n, d, m, seg, n_seg, splits, seg_d, seg_i, s);
    case 2: return emit<__half>(pts, q, excl, n, d, m, seg, n_seg, splits, seg_d, seg_i, s);
    case 3: return emit<int8_t>(pts, q, excl, n, d, m, seg, n_seg, splits, seg_d, seg_i, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// starts (m, P) int32: window first rows, n = exhausted.  seg = 1 << seg_log.
// k in [1, 128]: out_d/out_i hold m * k entries; k == 0 (emit all): m * P * seg.
int twophase_rescan_launch(int device, const void* pts, int dtype, const float* q,
                           const int* starts, int n, int d, int m, int P, int seg_log,
                           int k, float* out_d, int* out_i, void* stream) {
  if (k < 0 || k > knn::KMAX || n < 1 || d < 1 || m < 1 || P < 1 || seg_log < 0 ||
      seg_log > 30 || ((long long)P << seg_log) >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return rescan<float>(pts, q, starts, n, d, m, P, seg_log, k, out_d, out_i, s);
    case 1: return rescan<__nv_bfloat16>(pts, q, starts, n, d, m, P, seg_log, k, out_d, out_i, s);
    case 2: return rescan<__half>(pts, q, starts, n, d, m, P, seg_log, k, out_d, out_i, s);
    case 3: return rescan<int8_t>(pts, q, starts, n, d, m, P, seg_log, k, out_d, out_i, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// emit's geometry: queries per block and corpus rows per tile
int twophase_knn_query_block() { return knn::QB; }
int twophase_knn_tile_rows() { return knn::TN; }

const char* twophase_knn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
