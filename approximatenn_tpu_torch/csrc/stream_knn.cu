// Exact k-nearest-neighbour search (squared L2, k <= 128) streaming the
// corpus through a ring of shared-memory buffers, for Hopper.
//
// Replaces the TPU kernel approximatenn_tpu/ops/pallas_exact.py:
// _stream_kernel, launched by exact_knn_pallas(stream=True).  The contract
// and the unsorted replace-the-worst merge are the rescan-merge kernel's
// (rescan_merge_knn.cu): precomputed float32 norms pn of the unrounded
// corpus, at most k replace-the-worst rounds per tile, ascending extraction
// at the end.  What defines this kernel, and what it keeps:
//   * the grid covers query blocks only: each block walks the whole corpus
//     itself;
//   * corpus tiles (128 rows) and their pn slices arrive in an n_buf-deep
//     ring of shared-memory buffers filled ahead of the compute by
//     asynchronous copies (cp.async with commit/wait groups), the Hopper
//     counterpart of the TPU kernel's hand-issued DMA;
//   * the skip test reads s = 2 q.x - pn (its maximum over the tile) before
//     any distance exists; the distance qn - s is formed only in the merge
//     branch.  This association differs from the rescan merge's
//     (qn + pn) - 2 q.x by about an ulp.
// A tile is copied as one contiguous byte range (128 rows x d x itemsize,
// a multiple of 16 bytes), so rows need no alignment of their own: 16-byte
// copies from a 16-byte aligned corpus base (the caller re-aligns any other)
// and the tail of the partial last tile byte by byte.  The TPU's 128-row
// corpus padding, its overlapping last tile and its n < 128 switch-off are
// not needed: any n >= 1 runs.
//
// What bounds it on this card: fp32 FMA throughput at the serving shape (as
// the rank kernel), unless the blocks' corpus reads are not shared through
// L2.  There are only ceil(m / 8) blocks of 8 queries (one a warp): at the
// serving batch a smaller block fills more SMs, a larger one reads the
// corpus fewer times.  Each block stages the ring's tile into the rank
// kernel's tile_dots layout (a shared-to-shared pass) and computes an
// 8 x 128 tile of dot products; each warp holds its query's distances in
// registers and merges them itself.  The ring is as deep as fits in shared
// memory beside the staging and running state (2 to 8 tiles).
//
// Precision: as the rank kernel (IEEE fp32 dots; bf16/f16 widened, queries
// rounded to the corpus's type; int8 in int32).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (plain C interface, loaded through ctypes).

#include "knn_common.cuh"

namespace {

using namespace knn;

constexpr int QW = 1;             // queries per warp
constexpr int QBW = NW * QW;      // queries per block
constexpr int MAX_BUF = 8;        // deepest ring
constexpr int SMEM_MAX = 232448;  // dynamic shared memory a block may use

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Wait until at most `pending` of this thread's copy groups are in flight.
__device__ __forceinline__ void cp_async_wait_pending(int pending) {
  switch (pending) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

// Copy nbytes from global src to shared dst, both 16-byte aligned: whole
// 16-byte units asynchronously, the tail byte by byte.  Whole block.
__device__ __forceinline__ void copy_bytes(unsigned char* dst, const unsigned char* src,
                                           long long nbytes) {
  const long long body = nbytes / 16 * 16;
  for (long long o = 16LL * threadIdx.x; o < body; o += 16LL * NT) cp_async16(dst + o, src + o);
  for (long long o = body + threadIdx.x; o < nbytes; o += NT) dst[o] = src[o];
}

template <typename T>
__global__ void __launch_bounds__(NT)
stream_kernel(const T* __restrict__ pts, const float* __restrict__ q,
              const float* __restrict__ qn, const float* __restrict__ pn,
              const int* __restrict__ excl, int n, int d, int m, int k, int n_buf,
              float scale2, float* __restrict__ out_d, int* __restrict__ out_i) {
  using S = typename Tr<T>::S;
  extern __shared__ __align__(16) unsigned char smem[];
  const long long slot_bytes = (long long)TN * d * sizeof(T);  // a multiple of 16
  unsigned char* ring = smem;                                            // [n_buf][TN * d]
  float* pn_ring = reinterpret_cast<float*>(smem + n_buf * slot_bytes);  // [n_buf][TN]
  S* Qs = reinterpret_cast<S*>(pn_ring + n_buf * TN);                    // [DC][QBW]
  S* Ps = Qs + DC * QBW;                                                 // [DC][PS]
  S* Pn = Ps + DC * PS;                                 // [TN] (unused: norms are pn)
  float* rd = reinterpret_cast<float*>(Pn + TN);        // [QBW][k]
  int* ri = reinterpret_cast<int*>(rd + QBW * k);       // [QBW][k]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * QBW;
  const int n_tiles = (n + TN - 1) / TN;
  const unsigned char* src = reinterpret_cast<const unsigned char*>(pts);

  // tile t (rows [t TN, min((t + 1) TN, n))) and its norms into slot t % n_buf
  auto issue = [&](int t) {
    const int slot = t % n_buf;
    const long long r0 = (long long)t * TN;
    const long long rows = (n - r0) < TN ? (n - r0) : TN;
    copy_bytes(ring + slot * slot_bytes, src + r0 * d * (long long)sizeof(T),
               rows * d * (long long)sizeof(T));
    copy_bytes(reinterpret_cast<unsigned char*>(pn_ring + slot * TN),
               reinterpret_cast<const unsigned char*>(pn + r0), rows * 4);
  };
  // warm-up: n_buf - 1 tiles in flight (one commit group per tile, empty
  // groups past the last tile keep the count uniform)
  for (int t = 0; t < n_buf - 1; ++t) {
    if (t < n_tiles) issue(t);
    cp_async_commit();
  }

  for (int e = tid; e < QBW * k; e += NT) { rd[e] = pos_inf(); ri[e] = ID_NONE; }
  float wd[QW], qnv[QW];
  int ws[QW], ex[QW];
#pragma unroll
  for (int i = 0; i < QW; ++i) {
    const int qi = q0 + QW * warp + i;
    wd[i] = pos_inf();
    ws[i] = 0;
    qnv[i] = qi < m ? qn[qi] : 0.0f;
    ex[i] = (excl && qi < m) ? excl[qi] : -1;
  }

  for (int t = 0; t < n_tiles; ++t) {
    __syncthreads();  // the slot the prefetch overwrites was consumed at t - 1
    if (t + n_buf - 1 < n_tiles) issue(t + n_buf - 1);
    cp_async_commit();
    cp_async_wait_pending(n_buf - 1);  // this thread's copies of tile t landed
    __syncthreads();                   // and every thread's
    const int slot = t % n_buf;
    const int t0 = t * TN;
    const int rows = (n - t0) < TN ? (n - t0) : TN;
    S acc[QW][4];
    tile_dots<T, QW>(reinterpret_cast<const T*>(ring + slot * slot_bytes), q, q0, m, d, 0,
                     rows, Qs, Ps, Pn, acc);
    const float* pnt = pn_ring + slot * TN;
    float pnv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = lane + 32 * j;
      pnv[j] = r < rows ? pnt[r] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < QW; ++i) {
      const int qq = QW * warp + i;
      if (q0 + qq >= m) break;
      float s[4];
      bool ok[4];
      float smax = -pos_inf();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = lane + 32 * j;
        s[j] = 2.0f * (float)acc[i][j] - pnv[j];
        ok[j] = r < rows && t0 + r != ex[i];
        if (ok[j]) smax = fmaxf(smax, s[j]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        smax = fmaxf(smax, __shfl_xor_sync(0xffffffffu, smax, off));
      if (qnv[i] - smax < wd[i]) {
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = ok[j] ? qnv[i] - s[j] : pos_inf();
        replace_worst(v, t0, rd + qq * k, ri + qq * k, k, wd[i], ws[i], lane);
      }
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < QW; ++i) {
    const int qq = QW * warp + i;
    const int qi = q0 + qq;
    if (qi >= m) break;
    extract_sorted(rd + qq * k, ri + qq * k, k, lane, out_d + (long long)qi * k,
                   out_i + (long long)qi * k, scale2, n);
  }
}

template <typename T>
size_t stream_smem(int d, int k, int n_buf) {
  using S = typename Tr<T>::S;
  return (size_t)n_buf * TN * (d * sizeof(T) + sizeof(float)) +
         sizeof(S) * (DC * QBW + DC * PS + TN) + (sizeof(float) + sizeof(int)) * (size_t)QBW * k;
}

template <typename T>
int launch(const void* pts, const float* q, const int* excl, const float* qn, const float* pn,
           int n, int d, int m, int k, float scale2, float* out_d, int* out_i,
           cudaStream_t stream) {
  // the deepest ring (no deeper than the tiles there are) that fits; two
  // tiles at least
  const int n_tiles = (n + TN - 1) / TN;
  int n_buf = n_tiles < 2 ? 2 : (n_tiles < MAX_BUF ? n_tiles : MAX_BUF);
  while (n_buf > 2 && stream_smem<T>(d, k, n_buf) > (size_t)SMEM_MAX) --n_buf;
  const size_t smem = stream_smem<T>(d, k, n_buf);
  if (smem > (size_t)SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(stream_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  stream_kernel<T><<<(m + QBW - 1) / QBW, NT, smem, stream>>>(
      static_cast<const T*>(pts), q, qn, pn, excl, n, d, m, k, n_buf, scale2, out_d, out_i);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// device: the CUDA ordinal of every pointer.  dtype: 0 = float32,
// 1 = bfloat16, 2 = float16, 3 = int8.  All pointers are device pointers,
// pts and pn 16-byte aligned; excl may be null.  qn (m,) and pn (n,) are
// float32; out_d/out_i hold m * k entries.  Returns the CUDA error code
// (0 = launched); cudaErrorInvalidValue also when two corpus tiles of d
// values do not fit in a block's shared memory.
int exact_knn_stream_launch(int device, const void* pts, int dtype, const float* q,
                            const int* excl, const float* qn, const float* pn, int n, int d,
                            int m, int k, float* out_d, int* out_i, float scale2, void* stream) {
  if (k < 1 || k > knn::KMAX || n < 1 || d < 1 || m < 1 ||
      reinterpret_cast<uintptr_t>(pts) % 16 || reinterpret_cast<uintptr_t>(pn) % 16)
    return (int)cudaErrorInvalidValue;
  // this library carries its own CUDA runtime: select the caller's device
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(pts, q, excl, qn, pn, n, d, m, k, scale2, out_d, out_i, s);
    case 1: return launch<__nv_bfloat16>(pts, q, excl, qn, pn, n, d, m, k, scale2, out_d, out_i, s);
    case 2: return launch<__half>(pts, q, excl, qn, pn, n, d, m, k, scale2, out_d, out_i, s);
    case 3: return launch<int8_t>(pts, q, excl, qn, pn, n, d, m, k, scale2, out_d, out_i, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* stream_knn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
