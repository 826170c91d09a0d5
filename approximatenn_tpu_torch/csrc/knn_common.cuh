// Pieces shared by the kNN kernels (exact_knn.cu, twophase_knn.cu,
// rescan_merge_knn.cu, stream_knn.cu, probe_knn.cu): the storage-type
// traits, the (distance, id) order, the warp-cooperative insert into a
// sorted top-k list in shared memory, the unsorted replace-the-worst top-k
// of the rescan-merge and streaming kernels, and the merge of per-split
// sorted lists.  The exact kernels' dot products are on the tensor cores
// (knn_mma.cuh, knn_tile.cuh).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace knn {

constexpr int KMAX = 128;
constexpr int ID_NONE = 0x7fffffff;

constexpr int TN = 128;       // corpus rows per tile
constexpr int NT = 256;       // threads per block (8 warps)
constexpr int NW = NT / 32;

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

// storage type -> staged/compute type and conversions
template <typename T> struct Tr;
template <> struct Tr<float> {
  using S = float;
  __device__ static S pt(const float* p, long long i) { return p[i]; }
  __device__ static S qv(float v) { return v; }
  __device__ static float score(S pn, S dot) { return pn - 2.0f * dot; }
};
template <> struct Tr<__nv_bfloat16> {
  using S = float;
  __device__ static S pt(const __nv_bfloat16* p, long long i) { return __bfloat162float(p[i]); }
  __device__ static S qv(float v) { return __bfloat162float(__float2bfloat16(v)); }
  __device__ static float score(S pn, S dot) { return pn - 2.0f * dot; }
};
template <> struct Tr<__half> {
  using S = float;
  __device__ static S pt(const __half* p, long long i) { return __half2float(p[i]); }
  __device__ static S qv(float v) { return __half2float(__float2half_rn(v)); }
  __device__ static float score(S pn, S dot) { return pn - 2.0f * dot; }
};
template <> struct Tr<int8_t> {
  using S = int;
  __device__ static S pt(const int8_t* p, long long i) { return (int)p[i]; }
  // queries arrive quantised (integer values held in fp32)
  __device__ static S qv(float v) { return __float2int_rn(v); }
  __device__ static float score(S pn, S dot) { return (float)(pn - 2 * dot); }
};

__device__ __forceinline__ bool lex_less(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
}

// Insert (cd, ci) into the ascending list (ld, li) of length k; the caller
// has checked that it beats the last entry.  Whole warp participates.
__device__ __forceinline__ void warp_insert(float* ld, int* li, int k,
                                            float cd, int ci, int lane) {
  int cnt = 0;
  for (int j = lane; j < k; j += 32) cnt += lex_less(ld[j], li[j], cd, ci) ? 1 : 0;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
  const int pos = cnt;  // entries strictly before the new one
  float vd[KMAX / 32];
  int vi[KMAX / 32];
#pragma unroll
  for (int r = 0; r < KMAX / 32; ++r) {
    const int j = lane + 32 * r;
    if (j > pos && j < k) { vd[r] = ld[j - 1]; vi[r] = li[j - 1]; }
  }
  __syncwarp();
#pragma unroll
  for (int r = 0; r < KMAX / 32; ++r) {
    const int j = lane + 32 * r;
    if (j > pos && j < k) { ld[j] = vd[r]; li[j] = vi[r]; }
  }
  if (lane == 0) { ld[pos] = cd; li[pos] = ci; }
  __syncwarp();
}

// Lexicographic (distance, id) minimum over the lanes of groups of `width`
// lanes (a power of two <= 32); every lane of a group ends with its
// group's minimum.  Whole warp participates.
__device__ __forceinline__ void warp_lex_min(float& d, int& i, int width) {
  for (int off = width >> 1; off > 0; off >>= 1) {
    const float od = __shfl_xor_sync(0xffffffffu, d, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (lex_less(od, oi, d, i)) { d = od; i = oi; }
  }
}

// The unsorted running top-k of the rescan-merge and streaming kernels (the
// TPU kernels' run_d/run_i): k slots (rd, ri) in shared memory, owned by
// one warp.  Empty slots hold (+inf, ID_NONE).

// The worst slot: the largest distance, ties to the smallest slot.  Whole
// warp participates; every lane ends with (wd, ws).
__device__ __forceinline__ void worst_slot(const float* rd, int k, int lane,
                                           float& wd, int& ws) {
  float d = -pos_inf();
  int s = ID_NONE;
  for (int j = lane; j < k; j += 32)
    if (rd[j] > d) { d = rd[j]; s = j; }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float od = __shfl_xor_sync(0xffffffffu, d, off);
    const int os = __shfl_xor_sync(0xffffffffu, s, off);
    if (od > d || (od == d && os < s)) { d = od; s = os; }
  }
  wd = d;
  ws = s;
}

// Fold one tile into the running top-k, as the TPU kernels' insert loop
// does: extract the tile's smallest (distance, id), ties to the smaller id;
// while it beats the running worst, it replaces the worst slot; at most k
// rounds.  Lane l holds the tile's rows l + 32 j as v[j] (+inf where
// masked), whose ids are id0 + l + 32 j.  (wd, ws) is the running worst,
// kept up to date.  Whole warp participates.  A NaN distance (a NaN or an
// infinite coordinate) counts as +inf and never enters: left in, it would
// order differently in different lanes' reductions, and lanes would leave
// the loop apart while the others still shuffle with the whole warp.
__device__ __forceinline__ void replace_worst(float (&v)[4], int id0, float* rd, int* ri,
                                             int k, float& wd, int& ws, int lane) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (v[j] != v[j]) v[j] = pos_inf();  // NaN
  for (int round = 0; round < k; ++round) {
    float bd = v[0];
    int bi = id0 + lane;
#pragma unroll
    for (int j = 1; j < 4; ++j)
      if (lex_less(v[j], id0 + lane + 32 * j, bd, bi)) { bd = v[j]; bi = id0 + lane + 32 * j; }
    warp_lex_min(bd, bi, 32);
    if (!(bd < wd)) break;
    if (lane == 0) { rd[ws] = bd; ri[ws] = bi; }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (id0 + lane + 32 * j == bi) v[j] = pos_inf();
    __syncwarp();
    worst_slot(rd, k, lane, wd, ws);
  }
}

// The running top-k in ascending (distance, id) order into out_d/out_i, as
// the TPU kernels' final extraction: k entries, distances times scale2,
// (+inf, none_id) past the real ones.  Clobbers rd.  Whole warp
// participates.
__device__ __forceinline__ void extract_sorted(float* rd, const int* ri, int k, int lane,
                                               float* out_d, int* out_i, float scale2,
                                               int none_id) {
  for (int j = 0; j < k; ++j) {
    float bd = pos_inf();
    int bi = ID_NONE;
    for (int s = lane; s < k; s += 32)
      if (lex_less(rd[s], ri[s], bd, bi)) { bd = rd[s]; bi = ri[s]; }
    warp_lex_min(bd, bi, 32);
    if (!(bd < pos_inf())) {
      for (int r = j + lane; r < k; r += 32) { out_d[r] = pos_inf(); out_i[r] = none_id; }
      break;
    }
    if (lane == 0) { out_d[j] = bd * scale2; out_i[j] = bi; }
    for (int s = lane; s < k; s += 32)
      if (ri[s] == bi) rd[s] = pos_inf();
    __syncwarp();
  }
}

// One warp per query merges `splits` ascending lists of length k by
// (distance, id), adds |q|^2 (qn may be null: the lists already hold
// distances), scales by scale2 and writes (n, +inf) past the real
// candidates.
__global__ void split_merge_kernel(const float* __restrict__ part_d,
                                   const int* __restrict__ part_i,
                                   const float* __restrict__ qn, int n, int m,
                                   int k, int splits, float scale2,
                                   float* __restrict__ out_d, int* __restrict__ out_i) {
  const int lane = threadIdx.x & 31;
  const int qi = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (qi >= m) return;
  const float inf = pos_inf();
  const long long base = (long long)qi * splits * k;
  int head = 0;
  float hd = inf;
  int hi = ID_NONE;
  if (lane < splits) { hd = part_d[base + (long long)lane * k]; hi = part_i[base + (long long)lane * k]; }
  const float qnorm = qn ? qn[qi] : 0.0f;
  for (int j = 0; j < k; ++j) {
    float bd = hd;
    int bi = hi, bl = lane;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, bd, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      const int ol = __shfl_xor_sync(0xffffffffu, bl, off);
      if (lex_less(od, oi, bd, bi) || (od == bd && oi == bi && ol < bl)) { bd = od; bi = oi; bl = ol; }
    }
    if (lane == 0) {
      const long long o = (long long)qi * k + j;
      const bool real = bd < inf;
      out_d[o] = real ? (qn ? (bd + qnorm) * scale2 : bd * scale2) : inf;
      out_i[o] = real ? bi : n;
    }
    if (lane == bl) {
      ++head;
      if (head < k) { hd = part_d[base + (long long)lane * k + head]; hi = part_i[base + (long long)lane * k + head]; }
      else { hd = inf; hi = ID_NONE; }
    }
  }
}

// Launch split_merge_kernel (8 warps a block) on `stream`.
inline cudaError_t launch_split_merge(const float* part_d, const int* part_i, const float* qn,
                                      int n, int m, int k, int splits, float scale2,
                                      float* out_d, int* out_i, cudaStream_t stream) {
  const int wpb = 8;
  split_merge_kernel<<<(m + wpb - 1) / wpb, 32 * wpb, 0, stream>>>(
      part_d, part_i, qn, n, m, k, splits, scale2, out_d, out_i);
  return cudaGetLastError();
}

}  // namespace knn
