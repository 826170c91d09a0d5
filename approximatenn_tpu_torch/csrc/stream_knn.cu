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
//   * corpus tiles and their pn slices arrive in an n_buf-deep ring of
//     shared-memory buffers filled ahead of the compute by asynchronous
//     copies (cp.async with commit/wait groups), the Hopper counterpart of
//     the TPU kernel's own DMA calls;
//   * the skip test reads s = 2 q.x - pn (its maximum over the tile) before
//     any distance exists; the distance qn - s is formed only in the merge
//     branch.  This association differs from the rescan merge's
//     (qn + pn) - 2 q.x by about an ulp.
// The TPU's 128-row corpus padding, its overlapping last tile and its
// n < 128 switch-off are not needed: any n >= 1 runs.
//
// What bounds it on this card (measured at 1M x 128, 1000 queries, k = 10
// on an NVIDIA H100 80GB HBM3; the numbers are in PERF.md).  A block of
// QBW = 8 queries reads the whole corpus, so L2 serves (m / 8) x corpus
// bytes a call: with the multiplying switched off the copies alone
// take about as long as the whole float32 call with the copies switched off,
// and neither side is near the tensor cores' arithmetic peak.  What is left
// on the multiplying side is instruction count in eight warps: the float32
// split into TF32 halves (two conversions and a subtraction a value) costs
// more than the three MMAs it feeds.  With 16 queries a block (half the
// blocks, half the L2 reads, two MMAs an A fragment) the float32 call took
// longer, so there is one block size.  What the design does about it:
//   * the dot products run on the tensor cores straight from the ring slot
//     (knn_mma.cuh: tile_mma): the copies write each row at a padded stride
//     (4 mod 8 words) at which the MMA's fragment loads are free of bank
//     conflicts, so there is no staging pass and no barrier in the feature
//     loop.  float32 takes three TF32 passes (ranks as IEEE fp32 does);
//     bf16, f16 and int8 one pass at storage width, so a narrower corpus
//     halves or quarters the L2 traffic, the shared-memory loads and the
//     instructions;
//   * copying and multiplying are different warps' work: 8 warps start
//     nothing but the ring's copies, 8 warps nothing but MMAs and the merge.
//     A warp that starts a tile's copies stalls on the memory system for
//     about as long as the copies take; when the multiplying warps started
//     them, the two times added up (float32 took 21.4 ms, and about a
//     quarter less with the work split);
//   * each multiplying warp takes 16 of the tile's rows against the block's
//     queries, whose fragments are split once and kept in shared memory;
//   * the results cross to the merge's layout (a warp per query, lane l
//     holding rows l + 32 j) through a small padded array S, of which there
//     are two, so that one barrier a tile is enough: it says that S is
//     written, that the next tile has landed, and that this tile's slot may
//     be overwritten;
//   * the ring is as deep as fits beside the fragments and running state
//     (2 to 8 slots of 128 rows; 64, 32 or 16 rows where d is so large that
//     two 128-row slots do not fit: fewer warps then have rows to multiply).
// Rows are copied one by one into the padded layout by the copy routine the
// rank kernel and the rescan merge share (knn_tile.cuh: TileCopy); each
// row's bytes up to its last whole K step are zeroed once, at the start.
//
// Precision: a float32 stream at the tier asked for (knn_mma.cuh):
// "highest" is 3xTF32 with fp32 accumulation, within fp32 summation error
// of the IEEE dot product; "split3" three bf16 passes; "default" one; bf16 /
// f16 multiply queries rounded to the corpus's type, exact products, fp32
// accumulation; int8 in int32, exact.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (plain C interface, loaded through ctypes).

#include "knn_tile.cuh"

namespace {

using namespace knn;

constexpr int QBW = MMA_QUERIES;          // queries per block: one MMA's, one a merging warp
constexpr int SS = TN + 4;                // row stride of S: 4 (mod 32) words
constexpr int NP = 8;                     // copying warps, after the NW multiplying ones
constexpr int NPT = 32 * NP;              // copying threads
constexpr int NTS = NT + NPT;             // threads per block
constexpr int MAX_BUF = 8;                // deepest ring
static_assert(QBW == NW, "a multiplying warp merges one query");

// tr: corpus rows per ring slot (128, 64, 32 or 16).  Warps 0..NW-1 multiply
// and merge; warps NW..NW+NP-1 copy.  TIER: the precision tier (float32).
template <typename T, int TIER>
__global__ void __launch_bounds__(NTS)
stream_kernel(const T* __restrict__ pts, const float* __restrict__ q,
              const float* __restrict__ qn, const float* __restrict__ pn,
              const int* __restrict__ excl, int n, int d, int m, int k, int n_buf, int tr,
              float scale2, float* __restrict__ out_d, int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int stride = padded_stride(d, sizeof(T));  // words
  const int ksteps = row_words(d, sizeof(T)) / KSTEP_WORDS;
  const int slot_words = tr * stride;
  uint32_t* ring = reinterpret_cast<uint32_t*>(smem);                    // [n_buf][tr][stride]
  float* pn_ring = reinterpret_cast<float*>(ring + n_buf * slot_words);  // [n_buf][tr]
  uint32_t* qf = reinterpret_cast<uint32_t*>(pn_ring + n_buf * tr);      // query fragments
  float* Sm = reinterpret_cast<float*>(qf + fragment_words<T, TIER>(1, ksteps));  // [2][QBW][SS]
  float* rd = Sm + 2 * QBW * SS;                                         // [QBW][k]
  int* ri = reinterpret_cast<int*>(rd + QBW * k);                        // [QBW][k]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool copier = warp >= NW;
  const int ctid = tid - NT;  // a copier's index among the NPT copying threads
  const int q0 = blockIdx.x * QBW;
  const int n_tiles = (n + tr - 1) / tr;
  const unsigned char* src = reinterpret_cast<const unsigned char*>(pts);

  const int row_bytes = d * (int)sizeof(T);
  const TileCopy<NPT> tc(row_bytes, row_bytes, stride, ctid);

  // tile t (rows [t tr, min((t + 1) tr, n))) and its norms into slot
  // t % n_buf, and one commit group, empty past the last tile (wait counts
  // are per thread).  Copiers only.
  auto copy_tile = [&](int t) {
    if (t < n_tiles) {
      const int slot = t % n_buf;
      const long long r0 = (long long)t * tr;
      const int rows = (n - r0) < tr ? (int)(n - r0) : tr;
      tc.copy(ring + slot * slot_words, src + r0 * row_bytes, rows, row_bytes, ctid);
      if (ctid < rows) cp_async4(pn_ring + slot * tr + ctid, pn + r0 + ctid);
    }
    cp_async_commit();
  };
  // warm-up: n_buf - 1 tiles in flight
  if (copier)
    for (int t = 0; t < n_buf - 1; ++t) copy_tile(t);
  // bytes from a row's end to its last whole K step are zero in every slot;
  // no copy writes them
  zero_row_ends(ring, n_buf * tr, stride, row_bytes, 4 * KSTEP_WORDS * ksteps, tid, NTS);
  stage_query_fragments<T, 1, TIER>(q, q0, m, d, 0, ksteps, qf, tid, NTS);
  for (int e = tid; e < QBW * k; e += NTS) { rd[e] = pos_inf(); ri[e] = ID_NONE; }
  // a multiplying warp merges query q0 + warp
  const int qi = q0 + warp;
  const bool merges = !copier && qi < m;
  float wd = pos_inf();
  int ws = 0;
  const float qnv = merges ? qn[qi] : 0.0f;
  const int ex = (merges && excl) ? excl[qi] : -1;
  cp_async_wait_pending(n_buf - 2);  // a copier's copies of tile 0 landed
  __syncthreads();                   // and every copier's; the set-up is done

  const int g = lane >> 2, tq = lane & 3;
  for (int t = 0; t < n_tiles; ++t) {
    // Tile t is in its slot and tile t - 1 is consumed: the barrier of
    // iteration t - 1 said both.
    const int slot = t % n_buf;
    const int t0 = t * tr;
    const int rows = (n - t0) < tr ? (n - t0) : tr;
    const int wrow = MMA_ROWS * warp;  // this warp's first row of the tile
    float* St = Sm + (t & 1) * (QBW * SS);  // two S: one filled while the other is merged
    if (copier) {
      copy_tile(t + n_buf - 1);          // into tile t - 1's slot
      cp_async_wait_pending(n_buf - 2);  // this thread's copies of tile t + 1 landed
    } else if (wrow < rows) {
      typename Tr<T>::S dot[1][4];
      tile_mma<T, 1, TIER>(ring + slot * slot_words + wrow * stride, stride, ksteps, qf, lane,
                           dot);
      const float* pnt = pn_ring + slot * tr + wrow + g;
      const float p0 = pnt[0], p1 = pnt[8];
      float* s = St + (2 * tq) * SS + wrow + g;
      s[0] = 2.0f * (float)dot[0][0] - p0;
      s[SS] = 2.0f * (float)dot[0][1] - p0;
      s[8] = 2.0f * (float)dot[0][2] - p1;
      s[SS + 8] = 2.0f * (float)dot[0][3] - p1;
    }
    __syncthreads();  // S is written, tile t + 1 is in its slot, tile t is consumed
    if (!merges) continue;
    float s[4];
    bool ok[4];
    float smax = -pos_inf();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = lane + 32 * j;
      s[j] = St[warp * SS + r];
      // rows past the tile's end hold what an earlier tile left
      ok[j] = r < rows && t0 + r != ex;
      if (ok[j]) smax = fmaxf(smax, s[j]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      smax = fmaxf(smax, __shfl_xor_sync(0xffffffffu, smax, off));
    if (qnv - smax < wd) {
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = ok[j] ? qnv - s[j] : pos_inf();
      replace_worst(v, t0, rd + warp * k, ri + warp * k, k, wd, ws, lane);
    }
  }
  cp_async_wait<0>();
  if (merges)
    extract_sorted(rd + warp * k, ri + warp * k, k, lane, out_d + (long long)qi * k,
                   out_i + (long long)qi * k, scale2, n);
}

template <typename T, int TIER>
size_t stream_smem(int d, int k, int n_buf, int tr) {
  const int ksteps = row_words(d, sizeof(T)) / KSTEP_WORDS;
  return (size_t)n_buf * tr * (padded_stride(d, sizeof(T)) + 1) * 4 +
         4 * (size_t)fragment_words<T, TIER>(1, ksteps) + sizeof(float) * 2 * QBW * SS +
         (sizeof(float) + sizeof(int)) * (size_t)QBW * k;
}

template <typename T, int TIER = TIER_HIGHEST>
int launch(const void* pts, const float* q, const int* excl, const float* qn, const float* pn,
           int n, int d, int m, int k, float scale2, float* out_d, int* out_i,
           cudaStream_t stream) {
  // the most rows per slot for which two slots fit, then the deepest ring
  // (no deeper than the tiles there are) that fits
  int tr = TN;
  while (tr > MMA_ROWS && stream_smem<T, TIER>(d, k, 2, tr) > (size_t)SMEM_MAX) tr /= 2;
  const int n_tiles = (n + tr - 1) / tr;
  int n_buf = n_tiles < 2 ? 2 : (n_tiles < MAX_BUF ? n_tiles : MAX_BUF);
  while (n_buf > 2 && stream_smem<T, TIER>(d, k, n_buf, tr) > (size_t)SMEM_MAX) --n_buf;
  const size_t smem = stream_smem<T, TIER>(d, k, n_buf, tr);
  if (smem > (size_t)SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(stream_kernel<T, TIER>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  stream_kernel<T, TIER><<<(m + QBW - 1) / QBW, NTS, smem, stream>>>(
      static_cast<const T*>(pts), q, qn, pn, excl, n, d, m, k, n_buf, tr, scale2, out_d,
      out_i);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// device: the CUDA ordinal of every pointer.  dtype: 0 = float32,
// 1 = bfloat16, 2 = float16, 3 = int8.  tier: 0 = "highest", 1 = "split3",
// 2 = "default" (float32 only; other types take 0).  All pointers are
// device pointers, pts and pn 16-byte aligned; excl may be null.  qn (m,)
// and pn (n,) are float32; out_d/out_i hold m * k entries.  Returns the
// CUDA error code (0 = launched); cudaErrorInvalidValue also when two
// 16-row corpus tiles of d values do not fit in a block's shared memory.
int exact_knn_stream_launch(int device, const void* pts, int dtype, int tier, const float* q,
                            const int* excl, const float* qn, const float* pn, int n, int d,
                            int m, int k, float* out_d, int* out_i, float scale2, void* stream) {
  if (k < 1 || k > knn::KMAX || n < 1 || d < 1 || m < 1 ||
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
        return launch<float, decltype(t)::value>(pts, q, excl, qn, pn, n, d, m, k, scale2, out_d, out_i, s);
      });
    case 1: return launch<__nv_bfloat16>(pts, q, excl, qn, pn, n, d, m, k, scale2, out_d, out_i, s);
    case 2: return launch<__half>(pts, q, excl, qn, pn, n, d, m, k, scale2, out_d, out_i, s);
    case 3: return launch<int8_t>(pts, q, excl, qn, pn, n, d, m, k, scale2, out_d, out_i, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// queries per block: a call's blocks, each of which reads the whole corpus,
// number ceil(m / this)
int exact_knn_stream_query_block() { return QBW; }

const char* stream_knn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
