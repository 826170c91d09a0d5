// Pieces shared by the exact-kNN kernels (exact_knn.cu, twophase_knn.cu):
// the storage-type traits, the (distance, id) order, the warp-cooperative
// insert into a sorted top-k list in shared memory, and the tiled dot
// product that the rank kernel's pass 1 and the emit kernel both run.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace knn {

constexpr int KMAX = 128;
constexpr int ID_NONE = 0x7fffffff;

constexpr int QB = 32;        // queries per tiled block
constexpr int TN = 128;       // corpus rows per tile
constexpr int DC = 32;        // features per staged chunk
constexpr int NT = 256;       // threads per block (8 warps)
constexpr int NW = NT / 32;
constexpr int PS = TN + 1;    // padded row stride of the staged tile

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

// Dot products of the block's QB queries (from q0) with the corpus tile
// [t0, t0 + TN), staged in shared memory in DC-feature chunks (Qs [DC][QB],
// Ps [DC][PS]; queries >= m and rows >= hi stage as zeros).  Thread (warp
// tq, lane tp) ends with acc[i][j] = q[q0 + 4 tq + i] . x[t0 + tp + 32 j],
// and Pn [TN] holds the tile's |x|^2, visible to the whole block.  A block
// of NT threads participates.
template <typename T>
__device__ __forceinline__ void tile_dots(const T* __restrict__ pts, const float* __restrict__ q,
                                          int q0, int m, int d, int t0, int hi,
                                          typename Tr<T>::S* Qs, typename Tr<T>::S* Ps,
                                          typename Tr<T>::S* Pn,
                                          typename Tr<T>::S (&acc)[4][4]) {
  using S = typename Tr<T>::S;
  const int tid = threadIdx.x;
  const int tq = tid >> 5;
  const int tp = tid & 31;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = S(0);
  S pacc = S(0);
  for (int c0 = 0; c0 < d; c0 += DC) {
    __syncthreads();  // the previous chunk (and tile) is consumed
    for (int e = tid; e < QB * DC; e += NT) {
      const int c = e / QB, qq = e % QB;
      const int qr = q0 + qq, col = c0 + c;
      Qs[c * QB + qq] = (qr < m && col < d) ? Tr<T>::qv(q[(long long)qr * d + col]) : S(0);
    }
    for (int e = tid; e < TN * DC; e += NT) {
      const int r = e / DC, c = e % DC;
      const int row = t0 + r, col = c0 + c;
      Ps[c * PS + r] = (row < hi && col < d) ? Tr<T>::pt(pts, (long long)row * d + col) : S(0);
    }
    __syncthreads();
    if (tid < TN) {
#pragma unroll 8
      for (int c = 0; c < DC; ++c) { const S v = Ps[c * PS + tid]; pacc += v * v; }
    }
#pragma unroll 4
    for (int c = 0; c < DC; ++c) {
      S qv[4], pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[c * QB + tq * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) pv[j] = Ps[c * PS + tp + 32 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += qv[i] * pv[j];
    }
  }
  if (tid < TN) Pn[tid] = pacc;
  __syncthreads();
}

}  // namespace knn
