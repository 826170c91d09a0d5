// The probe-window top-k of packed hash serving, for Hopper.
//
// Replaces the TPU kernel approximatenn_tpu/ops/pallas_probe.py:_kernel
// (launched by probe_topk_pallas from engine/search.py:search_packed_fused).
// For every (query, table) pair: the union of the P windows
// [start, start + window) of that table's packed rows (table t's rows start
// at row t * n_pad of pts), the squared L2 distance sum((x - q)^2) in fp32
// of every slot in the union, +inf for slots at or past the live bound, and
// the k nearest by (distance, slot) ascending.  A +inf entry carries slot
// `live`, as the TPU kernel's `pmin = where(isinf(dmin), n, pmin)` does.
// The starts arrive already widened and aligned by the wrapper
// (ops/probe.py), which is what decides the candidate set; the kernel does
// no alignment of its own.
//
// The TPU kernel DMAs every window, scores overlapping copies and removes
// equal slots during its k rounds of selection.  Here the windows of a
// pair are sorted and their union is walked once, so every slot is scored
// exactly once (copies would have equal distances: the result is the same).
//
// What bounds it on this card: the main shape (1M x 128, tries = 10, P =
// 18, window 104, m = 1000) scores ~1.6e7 (query, table, slot) triples at
// 3 flop per element, 6 GFLOP (0.09 ms at the datasheet's 67 TFLOP/s
// fp32), while the distinct rows the windows cover (903 MB of bf16) are
// read at least once (0.27 ms at 3.35 TB/s); the triples' row reads, 4 GB,
// mostly hit L2 (50 MB), since queries share buckets.  Scattered rows and
// 3 flop an element make it a latency-bound gather: the rows are scored by
// knn_gather.cuh's RowScorer (lane groups with 16-byte loads, the query in
// registers, several rows' loads in flight a group, log2(G) shuffles a
// row).  A pair's windows are sorted and their union walked once; each
// warp keeps a sorted top-k by ballot against its current k-th and a
// warp-cooperative insert (as twophase_knn.cu's rescan).  A block holds
// NW / wpp (query, table) pairs with wpp warps each (the wrapper's choice,
// from a reading); a pair's first warp merges its wpp lists.  Rows shared
// by the pairs that probe the same bucket are read once per pair (left to
// L2); sharing windows across queries is later work.
//
// Precision: rows widen to fp32 (bf16, f16, int8); queries arrive as the
// wrapper prepares them: rounded to a half row type, or q / scale in fp32
// for int8 rows, never quantised (unlike Tr<int8_t>::qv of the exact
// kernels).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (plain C interface, loaded through ctypes).

#include "knn_gather.cuh"

namespace {

using namespace knn;

// Pair p = query * tries + table; block b holds pairs b * ppb .. b * ppb +
// ppb - 1, ppb = NW / wpp, pair slot w / wpp of warp w.  starts (m, tries,
// P); out (m, tries, k).  Rows of nvec V-byte vectors, lane groups of G.
template <typename T, int V>
__global__ void __launch_bounds__(NT, (gather::min_blocks<T, V, true>()))
probe_kernel(const T* __restrict__ pts, const float* __restrict__ q,
             const int* __restrict__ starts, int pairs, int tries, int P, int d,
             int nvec, int G, int wpp, int n_pad, int window, int live, int k,
             float* __restrict__ out_d, int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ppb = NW / wpp;
  float* Qv = reinterpret_cast<float*>(smem);      // [ppb][d]
  int* Lo = reinterpret_cast<int*>(Qv + ppb * d);   // [ppb][P] first new slot of each window
  int* Off = Lo + ppb * P;                          // [ppb][P + 1] union offsets
  float* topd = reinterpret_cast<float*>(Off + ppb * (P + 1));  // [NW][k]
  int* topi = reinterpret_cast<int*>(topd + NW * k);            // [NW][k]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int slot = warp / wpp;             // the pair slot of this warp
  const int pw = warp - slot * wpp;        // the warp within its pair
  const int pt = tid - slot * wpp * 32;    // the thread within its pair
  const int nthr = wpp * 32;
  const int pair = blockIdx.x * ppb + slot;
  const bool has = pair < pairs;
  float* qv = Qv + slot * d;
  int* lo = Lo + slot * P;
  int* off = Off + slot * (P + 1);
  const int qi = pair / tries;
  const int t = pair - qi * tries;
  if (has) {
    for (int c = pt; c < d; c += nthr) qv[c] = q[(long long)qi * d + c];
    // sort the pair's window starts by rank (ties by index: ranks are unique)
    const int* st = starts + (long long)pair * P;
    for (int p = pt; p < P; p += nthr) {
      const int s = st[p];
      int r = 0;
      for (int j = 0; j < P; ++j) {
        const int o = st[j];
        r += (o < s || (o == s && j < p)) ? 1 : 0;
      }
      lo[r] = s;
    }
  }
  for (int e = tid; e < NW * k; e += NT) { topd[e] = pos_inf(); topi[e] = ID_NONE; }
  __syncthreads();
  // the union of equal-length windows in start order: window p adds the
  // slots [max(s_p, s_{p-1} + window), s_p + window)
  if (has && pt == 0) {
    int acc = 0, end = lo[0];
    for (int p = 0; p < P; ++p) {
      const int s = lo[p];
      const int a = s > end ? s : end;
      const int hi = s + window;
      lo[p] = a;
      off[p] = acc;
      acc += hi > a ? hi - a : 0;
      end = hi;
    }
    off[P] = acc;
  }
  __syncthreads();

  if (has) {
    const int L = off[P];
    const gather::RowScorer<T, V> sc(pts + (long long)t * n_pad * d, qv, nvec, G, lane);
    float* ld = topd + warp * k;
    int* li = topi + warp * k;
    float wd = pos_inf();
    int wi = ID_NONE;
    // the pair's warp pw scores the 32-slot batches pw, pw + wpp, ... of the union
    for (int l0 = pw * 32; l0 < L; l0 += nthr) {
      // lane r finds the slot of union index l0 + r: the last window whose
      // offset is <= it (that window's new run is not empty)
      int pos = -1;
      const int l = l0 + lane;
      if (l < L) {
        int a = 0, b = P - 1;
        while (a < b) {
          const int mid = (a + b + 1) >> 1;
          if (off[mid] <= l) a = mid; else b = mid - 1;
        }
        pos = lo[a] + (l - off[a]);
      }
      // slots at or past the live bound (sentinels) are not read: +inf
      const int row = pos < live ? pos : -1;
      const float dist = sc.score_batch(row);
      const float my_d = row >= 0 ? dist : pos_inf();
      const int my_i = row >= 0 ? row : live;
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
  }
  __syncthreads();
  // the pair's first warp merges its wpp sorted lists (slots are disjoint
  // across warps)
  if (!has || pw != 0) return;
  int head = 0;
  float hd = pos_inf();
  int hid = ID_NONE;
  if (lane < wpp) { hd = topd[(warp + lane) * k]; hid = topi[(warp + lane) * k]; }
  for (int j = 0; j < k; ++j) {
    float bd = hd;
    int bi = hid, bl = lane;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, bd, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      const int ol = __shfl_xor_sync(0xffffffffu, bl, o);
      if (lex_less(od, oi, bd, bi) || (od == bd && oi == bi && ol < bl)) { bd = od; bi = oi; bl = ol; }
    }
    if (lane == 0) {
      const long long o = (long long)pair * k + j;
      const bool real = bd < pos_inf();
      out_d[o] = real ? bd : pos_inf();
      out_i[o] = real ? bi : live;
    }
    if (lane == bl) {
      ++head;
      if (head < k) { hd = topd[(warp + lane) * k + head]; hid = topi[(warp + lane) * k + head]; }
      else { hd = pos_inf(); hid = ID_NONE; }
    }
  }
}

template <typename T>
struct ProbeLaunch {
  const void* pts;
  const float* q;
  const int* starts;
  int pairs, tries, P, d, nvec, G, wpp, n_pad, window, live, k;
  float* out_d;
  int* out_i;
  cudaStream_t stream;

  template <int V>
  cudaError_t run() {
    const int ppb = NW / wpp;
    const size_t smem = sizeof(float) * (size_t)ppb * d +
                        sizeof(int) * (size_t)ppb * (2 * P + 1) +
                        (sizeof(float) + sizeof(int)) * (size_t)NW * k;
    cudaError_t err = cudaFuncSetAttribute(probe_kernel<T, V>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    const unsigned blocks = (unsigned)((pairs + ppb - 1) / ppb);
    probe_kernel<T, V><<<blocks, NT, smem, stream>>>(
        static_cast<const T*>(pts), q, starts, pairs, tries, P, d, nvec, G, wpp, n_pad,
        window, live, k, out_d, out_i);
    return cudaGetLastError();
  }
};

template <typename T>
int probe(const void* pts, const float* q, const int* starts, int m, int tries, int P,
          int d, int n_pad, int window, int live, int k, int V, int G, int wpp,
          float* out_d, int* out_i, cudaStream_t stream) {
  if (!gather::geometry_ok(d, (int)sizeof(T), V, G) ||
      reinterpret_cast<uintptr_t>(pts) % V)
    return (int)cudaErrorInvalidValue;
  const int nvec = (int)((long long)d * sizeof(T) / V);
  ProbeLaunch<T> f{pts, q, starts, m * tries, tries, P, d, nvec, G, wpp, n_pad, window,
                   live, k, out_d, out_i, stream};
  return (int)gather::dispatch<T>(V, f);
}

}  // namespace

extern "C" {

// device: the CUDA ordinal of every pointer.  dtype: 0 = float32,
// 1 = bfloat16, 2 = float16, 3 = int8.  pts (tries * n_pad, d) rows;
// q (m, d) float32; starts (m, tries, P) int32 with 0 <= start <=
// n_pad - window; out_d/out_i (m, tries, k).  The scorer's geometry
// (knn_gather.cuh): vec bytes a load, lanes a group; wpp warps a (query,
// table) pair (1, 2, 4 or 8).  Returns the CUDA error code (0 = launched).
int probe_topk_launch(int device, const void* pts, int dtype, const float* q,
                      const int* starts, int m, int tries, int P, int d, int n_pad,
                      int window, int live, int k, int vec, int lanes, int wpp,
                      float* out_d, int* out_i, void* stream) {
  if (k < 1 || k > knn::KMAX || m < 1 || tries < 1 || P < 1 || d < 1 || n_pad < 1 ||
      window < 1 || window > n_pad || live < 0 || live > n_pad ||
      (long long)m * tries > 0x7fffffffLL || (long long)P * window > 0x7fffffffLL ||
      (wpp != 1 && wpp != 2 && wpp != 4 && wpp != 8))
    return (int)cudaErrorInvalidValue;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return probe<float>(pts, q, starts, m, tries, P, d, n_pad, window, live, k, vec, lanes, wpp, out_d, out_i, s);
    case 1: return probe<__nv_bfloat16>(pts, q, starts, m, tries, P, d, n_pad, window, live, k, vec, lanes, wpp, out_d, out_i, s);
    case 2: return probe<__half>(pts, q, starts, m, tries, P, d, n_pad, window, live, k, vec, lanes, wpp, out_d, out_i, s);
    case 3: return probe<int8_t>(pts, q, starts, m, tries, P, d, n_pad, window, live, k, vec, lanes, wpp, out_d, out_i, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* probe_knn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
