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
// 18, window 104, m = 1000) scores ~1e7 (query, table, slot) triples at 3
// flop per element, 4 GFLOP (0.06 ms at the datasheet's 67 TFLOP/s fp32),
// while the distinct rows the windows cover are read at least once; when
// queries share buckets the rows they read overlap, and L2 (50 MB) holds
// part of the packed table.  This first version is simple: one block of
// 256 threads per (query, table) pair, the query in shared memory, a warp
// per slot with coalesced loads over the features and a shuffle sum, each
// warp keeping a sorted top-k by ballot against its current k-th and a
// warp-cooperative insert (as twophase_knn.cu's rescan), then one warp
// merges the eight lists.  Rows shared by the pairs that probe the same
// bucket are read once per pair (left to L2); TMA window loads and sharing
// windows across queries are later work.
//
// Precision: rows widen to fp32 (bf16, f16, int8); queries arrive as the
// wrapper prepares them: rounded to a half row type, or q / scale in fp32
// for int8 rows, never quantised (unlike Tr<int8_t>::qv of the exact
// kernels).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (plain C interface, loaded through ctypes).

#include "knn_common.cuh"

namespace {

using namespace knn;

// One block per (query, table) pair, pair = query * tries + table.
// starts (m, tries, P); out (m, tries, k).
template <typename T>
__global__ void __launch_bounds__(NT)
probe_kernel(const T* __restrict__ pts, const float* __restrict__ q,
             const int* __restrict__ starts, int tries, int P, int d, int n_pad,
             int window, int live, int k, float* __restrict__ out_d,
             int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qv = reinterpret_cast<float*>(smem);         // [d]
  int* Lo = reinterpret_cast<int*>(Qv + d);            // [P] first new slot of each window
  int* Off = Lo + P;                                   // [P + 1] union offsets
  float* topd = reinterpret_cast<float*>(Off + P + 1);  // [NW][k]
  int* topi = reinterpret_cast<int*>(topd + NW * k);   // [NW][k]

  const int pair = blockIdx.x;
  const int qi = pair / tries;
  const int t = pair - qi * tries;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int c = tid; c < d; c += NT) Qv[c] = q[(long long)qi * d + c];
  // sort the pair's window starts by rank (ties by index: ranks are unique)
  const int* st = starts + (long long)pair * P;
  for (int p = tid; p < P; p += NT) {
    const int s = st[p];
    int r = 0;
    for (int j = 0; j < P; ++j) {
      const int o = st[j];
      r += (o < s || (o == s && j < p)) ? 1 : 0;
    }
    Lo[r] = s;
  }
  for (int e = tid; e < NW * k; e += NT) { topd[e] = pos_inf(); topi[e] = ID_NONE; }
  __syncthreads();
  // the union of equal-length windows in start order: window p adds the
  // slots [max(s_p, s_{p-1} + window), s_p + window)
  if (tid == 0) {
    int acc = 0, end = Lo[0];
    for (int p = 0; p < P; ++p) {
      const int s = Lo[p];
      const int lo = s > end ? s : end;
      const int hi = s + window;
      Lo[p] = lo;
      Off[p] = acc;
      acc += hi > lo ? hi - lo : 0;
      end = hi;
    }
    Off[P] = acc;
  }
  __syncthreads();

  const int L = Off[P];
  const T* rows = pts + (long long)t * n_pad * d;
  float* ld = topd + warp * k;
  int* li = topi + warp * k;
  float wd = pos_inf();
  int wi = ID_NONE;
  // warp w scores the 32-slot groups w, w + NW, ... of the union
  for (int l0 = warp * 32; l0 < L; l0 += NW * 32) {
    // lane r finds the slot of union index l0 + r: the last window whose
    // offset is <= it (that window's new run is not empty)
    int mypos = -1;
    const int l = l0 + lane;
    if (l < L) {
      int a = 0, b = P - 1;
      while (a < b) {
        const int mid = (a + b + 1) >> 1;
        if (Off[mid] <= l) a = mid; else b = mid - 1;
      }
      mypos = Lo[a] + (l - Off[a]);
    }
    float my_d = pos_inf();
    int my_i = live;
#pragma unroll 4
    for (int r = 0; r < 32; ++r) {
      const int pos = __shfl_sync(0xffffffffu, mypos, r);
      if (pos < 0) break;  // uniform: the union ended inside this group
      if (pos >= live) continue;  // uniform: a sentinel slot scores +inf
      const T* x = rows + (long long)pos * d;
      float acc = 0.f;
      for (int c = lane; c < d; c += 32) {
        const float df = (float)Tr<T>::pt(x, c) - Qv[c];
        acc = fmaf(df, df, acc);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == r) { my_d = acc; my_i = pos; }
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
  __syncthreads();
  // warp 0 merges the NW sorted lists (slots are disjoint across warps)
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
      const long long o = (long long)pair * k + j;
      const bool real = bd < pos_inf();
      out_d[o] = real ? bd : pos_inf();
      out_i[o] = real ? bi : live;
    }
    if (lane == bl) {
      ++head;
      if (head < k) { hd = topd[lane * k + head]; hid = topi[lane * k + head]; }
      else { hd = pos_inf(); hid = ID_NONE; }
    }
  }
}

template <typename T>
int probe(const void* pts, const float* q, const int* starts, int m, int tries, int P,
          int d, int n_pad, int window, int live, int k, float* out_d, int* out_i,
          cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)d + sizeof(int) * (size_t)(2 * P + 1) +
                      (sizeof(float) + sizeof(int)) * (size_t)NW * k;
  cudaError_t err = cudaFuncSetAttribute(probe_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((long long)m * tries);
  probe_kernel<T><<<blocks, NT, smem, stream>>>(static_cast<const T*>(pts), q, starts, tries,
                                                P, d, n_pad, window, live, k, out_d, out_i);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// device: the CUDA ordinal of every pointer.  dtype: 0 = float32,
// 1 = bfloat16, 2 = float16, 3 = int8.  pts (tries * n_pad, d) rows;
// q (m, d) float32; starts (m, tries, P) int32 with 0 <= start <=
// n_pad - window; out_d/out_i (m, tries, k).  Returns the CUDA error code
// (0 = launched).
int probe_topk_launch(int device, const void* pts, int dtype, const float* q,
                      const int* starts, int m, int tries, int P, int d, int n_pad,
                      int window, int live, int k, float* out_d, int* out_i,
                      void* stream) {
  if (k < 1 || k > knn::KMAX || m < 1 || tries < 1 || P < 1 || d < 1 || n_pad < 1 ||
      window < 1 || window > n_pad || live < 0 || live > n_pad ||
      (long long)m * tries > 0x7fffffffLL || (long long)P * window > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return probe<float>(pts, q, starts, m, tries, P, d, n_pad, window, live, k, out_d, out_i, s);
    case 1: return probe<__nv_bfloat16>(pts, q, starts, m, tries, P, d, n_pad, window, live, k, out_d, out_i, s);
    case 2: return probe<__half>(pts, q, starts, m, tries, P, d, n_pad, window, live, k, out_d, out_i, s);
    case 3: return probe<int8_t>(pts, q, starts, m, tries, P, d, n_pad, window, live, k, out_d, out_i, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* probe_knn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
