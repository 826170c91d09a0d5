// The row scorer of the gather kernels (probe_knn.cu's probe and
// twophase_knn.cu's rescan): the squared L2 distance sum((x - q)^2) in fp32
// of one query against corpus rows given by index, the diff form the TPU
// kernels compute.
//
// Both kernels read rows that are scattered (a probe window, a picked
// segment) and score each with 3 flop per element, so the loads, not the
// arithmetic, set their time, and a loop that loads one element per lane
// and reduces every row over the whole warp (32-lane shuffle sums) waits
// on one row's latency at a time.  Here:
//   * a lane group of G lanes (a power of two) scores one row; each lane
//     loads V bytes at a time (16 where the row's bytes and the data
//     pointer allow it: 4 f32, 8 bf16 or f16, 16 int8 values), neighbouring
//     lanes on neighbouring addresses, and widens them to fp32.  A row is
//     nvec = d * sizeof(T) / V vectors, read in ceil(nvec / G) passes;
//   * the lane's query vector of the first pass lives in registers, loaded
//     once; later passes read theirs from shared memory, once for ROWS
//     rows;
//   * a group reduces in log2(G) xor shuffles;
//   * every group keeps ROWS (4) rows' loads in flight before it reduces
//     any of them, so a warp has 128 / G rows in flight.
// A reading chose 4 rows in flight over 2 and 8, and lane groups that read
// a row in two passes (d = 128: G = 16 in f32, 8 in bf16, 4 in int8) over
// one pass or more: fewer shuffles a row and more rows in flight a warp
// (PERF.md §6, the row scorer's sweep; the wrappers pick G,
// ops/exact.py:gather_geometry).
// score_batch scores the 32 rows of a batch, one row index a lane, and
// leaves lane b with row b's distance: the callers select on that as
// before (a ballot against the warp's k-th, or a direct write).
//
// A NaN or infinite coordinate gives a NaN or +inf distance, and nothing
// here branches on a distance: the callers' selections take only distances
// below +inf, so such a row never enters a result and never splits a warp.

#pragma once

#include "knn_common.cuh"

namespace knn {
namespace gather {

constexpr unsigned FULL = 0xffffffffu;
constexpr int ROWS = 4;  // rows a lane group keeps in flight (ops/exact.py:GATHER_ROWS)

// The resident blocks an SM that a gather kernel's __launch_bounds__ asks
// of ptxas, so at most 65536 / (256 x this) registers a thread: four (64
// registers) where the instantiation fits them unspilled, two (128) where
// it does not (16-byte int8 rows; the probe's 16-byte half rows, whose
// selection state takes more).  Left to itself ptxas held some
// instantiations to 64 registers and spilled.
template <typename T, int V, bool PROBE>
constexpr int min_blocks() {
  if (sizeof(T) == 4 || V < 16) return 4;
  return sizeof(T) == 2 && !PROBE ? 4 : 2;
}

template <int V> struct VecT;
template <> struct VecT<16> { using type = uint4; };
template <> struct VecT<8> { using type = uint2; };
template <> struct VecT<4> { using type = unsigned int; };
template <> struct VecT<2> { using type = unsigned short; };
template <> struct VecT<1> { using type = unsigned char; };

// 32-bit word j of a V-byte vector (a narrower vector in the low bits)
template <int V>
__device__ __forceinline__ unsigned word(const typename VecT<V>::type& v, int j) {
  if constexpr (V == 16) return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
  else if constexpr (V == 8) return j == 0 ? v.x : v.y;
  else return (unsigned)v;
}

// element i (lowest first) of a 32-bit word of T values, widened to fp32
template <typename T> __device__ __forceinline__ float elem(unsigned w, int i);
template <> __device__ __forceinline__ float elem<float>(unsigned w, int) {
  return __uint_as_float(w);
}
template <> __device__ __forceinline__ float elem<__nv_bfloat16>(unsigned w, int i) {
  return __uint_as_float(i ? w & 0xffff0000u : w << 16);
}
template <> __device__ __forceinline__ float elem<__half>(unsigned w, int i) {
  return __half2float(__ushort_as_half((unsigned short)(i ? w >> 16 : w & 0xffffu)));
}
template <> __device__ __forceinline__ float elem<int8_t>(unsigned w, int i) {
  return (float)((int)(w << (24 - 8 * i)) >> 24);
}

// the V / sizeof(T) elements of one V-byte vector, widened to fp32 (by
// register arithmetic: a copy through an array of T can land in local
// memory)
template <typename T, int V>
__device__ __forceinline__ void widen(const typename VecT<V>::type& v,
                                      float (&f)[V / sizeof(T)]) {
  constexpr int E = V / sizeof(T), PER = 4 / sizeof(T);  // elements a 32-bit word
#pragma unroll
  for (int e = 0; e < E; ++e) f[e] = elem<T>(word<V>(v, e / PER), e % PER);
}

// One warp's scorer: rows of `nvec` V-byte vectors from `rows` (row r at
// vector r * nvec; the pointer and V * nvec are multiples of V), the query
// as d = nvec * E floats in shared memory, lane groups of G lanes with
// ROWS <= G <= 32.
template <typename T, int V>
struct RowScorer {
  static constexpr int R = ROWS;
  static constexpr int E = V / (int)sizeof(T);
  using VT = typename VecT<V>::type;

  const VT* __restrict__ base;
  const float* qs;
  int nvec, G, passes, lg, gbase;
  float qr[E];  // the lane's query vector of the first pass

  __device__ RowScorer(const T* rows, const float* qs_, int nvec_, int G_, int lane)
      : base(reinterpret_cast<const VT*>(rows)), qs(qs_), nvec(nvec_), G(G_),
        passes((nvec_ + G_ - 1) / G_), lg(lane & (G_ - 1)), gbase(lane & ~(G_ - 1)) {
    query(lg, qr);
  }

  __device__ __forceinline__ void query(int v, float (&f)[E]) const {
#pragma unroll
    for (int e = 0; e < E; ++e) f[e] = v < nvec ? qs[v * E + e] : 0.f;
  }

  // acc[r]: the squared distance of row[r] (0 where row[r] < 0), the same
  // in every lane of the group.  Whole warp participates.
  __device__ __forceinline__ void score(const int (&row)[R], float (&acc)[R]) const {
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.f;
    for (int p = 0; p < passes; ++p) {
      const int v = p * G + lg;
      float qv[E];
      if (p == 0) {
#pragma unroll
        for (int e = 0; e < E; ++e) qv[e] = qr[e];
      } else {
        query(v, qv);
      }
      VT x[R];
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (row[r] >= 0 && v < nvec) x[r] = __ldg(base + (long long)row[r] * nvec + v);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (row[r] < 0 || v >= nvec) continue;
        float f[E];
        widen<T, V>(x[r], f);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float df = f[e] - qv[e];
          acc[r] = fmaf(df, df, acc[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        if (off < G) acc[r] += __shfl_xor_sync(FULL, acc[r], off);
    }
  }

  // The 32 rows of a batch, lane b naming row b in `mine` (< 0: none):
  // returns row b's squared distance to lane b (0 where there is none).
  // Group g scores rows g G .. g G + G - 1, R at a time.  Whole warp
  // participates.
  __device__ __forceinline__ float score_batch(int mine) const {
    float out = 0.f;
    for (int s = 0; s < G; s += R) {
      int row[R];
#pragma unroll
      for (int r = 0; r < R; ++r) row[r] = __shfl_sync(FULL, mine, gbase + s + r);
      float acc[R];
      score(row, acc);
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (lg == s + r) out = acc[r];
    }
    return out;
  }
};

// f.template run<V>() for a launch's vector bytes V (at least sizeof(T));
// anything else is cudaErrorInvalidValue.
template <typename T, typename F>
cudaError_t dispatch(int V, F& f) {
  switch (V) {
    case 16: return f.template run<16>();
    case 8: return f.template run<8>();
    case 4: return f.template run<4>();
    case 2:
      if constexpr (sizeof(T) <= 2) return f.template run<2>();
      break;
    case 1:
      if constexpr (sizeof(T) == 1) return f.template run<1>();
      break;
    default:
      break;
  }
  return cudaErrorInvalidValue;
}

// A launch's geometry is valid: V a power of two in [sizeof(T), 16]
// dividing the row's bytes, G a power of two in [ROWS, 32].
inline bool geometry_ok(int d, int itemsize, int V, int G) {
  const bool pow2v = V == 1 || V == 2 || V == 4 || V == 8 || V == 16;
  return pow2v && V >= itemsize && ((long long)d * itemsize) % V == 0 &&
         (G == 4 || G == 8 || G == 16 || G == 32);
}

}  // namespace gather
}  // namespace knn
