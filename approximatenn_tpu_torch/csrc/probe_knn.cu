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
// Two designs, one contract; ops/probe.py:probe_design picks one a call.
//
// "pairs" (probe_kernel): the work unit is a (query, table) pair.  A pair's
// windows are sorted and their union walked once; its slots' rows are
// scored by knn_gather.cuh's RowScorer (lane groups with 16-byte loads, the
// query in registers, several rows' loads in flight a group, log2(G)
// shuffles a row), and each warp keeps a sorted top-k by ballot against
// its current k-th and a warp-cooperative insert (as twophase_knn.cu's
// rescan).  A block holds NW / wpp pairs with wpp warps each (the
// wrapper's choice, from a reading); a pair's first warp merges its wpp
// lists.  What bounds it: every pair reads its own windows' rows, 3 flop
// an element on the CUDA cores, a latency-bound gather with the reuse left
// to L2: at the hash cell's shape (1M x 128 bf16, tries 10, P 18, window
// 104, m = 10,000) ~1.9e8 slot scorings read ~48 GB of rows through L2 for
// ~1.2 GB of distinct rows, ~13 ms a call.  It serves float32 and int8
// rows (whose queries are q / scale in fp32) and small batches, where
// little is shared and its one short launch wins.
//
// "tiles" (probe_kernel_tiles, bf16 and f16 rows): the work unit is a tile
// of TILE = 128 slots of one table, so a tile's rows are read once for
// every query that probes it.  One launch does all of a call's work (a
// memset of the tiles' counts before it): the kernel is persistent and
// cooperative (every block resident), with a grid barrier after each
// phase:
//   0. binning, a warp a (query, table) pair: the pair's starts sorted,
//      their union walked as runs [a, hi) clipped at the live bound, the
//      runs cut at tile edges into pieces (query, first row, end row, place
//      in the pair's score row), each piece counted into its tile, keeping
//      its rank there; the queries' |q|^2;
//   1. the tiles' counts scanned into their first entries and the work
//      items: a tile and up to CH = 64 of its entries (a tile with more is
//      several items, back to back, so the repeats read its rows from L2);
//   2. every piece to its place in tile order, with its query's |q|^2;
//   3. each block takes items in turn: the entries' queries and the tile's
//      rows that their runs cover go into a double-buffered stage of shared
//      memory by cp.async at knn_mma.cuh's padded stride, 8 warps (16 rows
//      each) multiply them on bf16 / f16 mma.sync (m16n8k16, fp32
//      accumulators, ldmatrix for both operands) with |x|^2 summed in fp32
//      from the A fragments, and a score |x|^2 + |q|^2 - 2 q.x goes to the
//      pair's score row where the row lies in the entry's run (+inf where
//      the row or the sum is not finite);
//   4. each warp takes pairs: the pair's k-th score (for k <= 32 and rows
//      of at most 2,048 slots, from the row copied into the warp's shared
//      memory, ranked among the slots within the scores' error margin,
//      margin(), of the k-th smallest of its 32 lanes' minima; else from the
//      "pairs" design's ballot-and-insert walk) plus the margin picks the
//      slots that can be among the k nearest (a few over k); those are
//      scored again as sum((x - q)^2) in fp32 from their rows (exact_dist),
//      and the k nearest by (distance, slot) are written.
// Runs are disjoint, so every slot is scored once and no slot repeats.
// What bounds it, at the hash cell's shape (~2.4 ms a call on an H100,
// PERF.md): the distinct rows once from HBM (~1.2 GB, ~0.35 ms) and a
// tile's repeats from L2 are not the limit; the scoring phase (~1.5 ms) is
// mma.sync at its rate over whole 128-row tiles (a run covers ~55 of them),
// then starting the cp.async copies and the score-row stores, each warp
// doing the three in turn; the selection reads the score rows (4 bytes a
// union slot, ~0.64 GB) and the candidates' rows; the binning ~0.1 ms.
// Two blocks an SM hold ~213 KB of stages, which leaves ~40 KB of L1: a
// register spill goes to L2 (a build that spilled 184 bytes a thread took
// ~0.7 ms more a call), so the kernel keeps within 128 registers with no
// spill (check -Xptxas -v).
//
// Precision: "pairs" widens rows to fp32 (bf16, f16, int8) and sums
// (x - q)^2; queries arrive as the wrapper prepares them: rounded to a half
// row type, or q / scale in fp32 for int8 rows, never quantised (unlike
// Tr<int8_t>::qv of the exact kernels).  "tiles" takes the queries in the
// row type (the same rounded values, so every product is exact in fp32).
// Its scores cancel |x|^2 + |q|^2 against 2 q.x, so they carry an error of
// up to ~2^-16 (|x|^2 + |q|^2), large beside the distances of clustered
// rows far from the origin: they only choose the candidates, and the
// distances it returns are sum((x - q)^2) as "pairs" sums them, so the two
// designs differ by the summation's order alone.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (plain C interface, loaded through ctypes).

#include "knn_gather.cuh"
#include "knn_tile.cuh"

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

// -- the "tiles" design ------------------------------------------------------

namespace tiles {

constexpr int TILE = TN;                  // slots a tile (and rows a block multiplies)
constexpr int CH = 64;                    // entries (queries) a work item
constexpr int NQG = CH / MMA_QUERIES;     // MMA query groups a work item
constexpr int CAP = 128;                  // candidates a warp ranks (k <= SEL_K)
constexpr int SEL_K = 32;                 // largest k of the threshold selection
constexpr int RV = 64;                    // rows up to 32 RV slots: the threshold selection's
constexpr int ROW_WORDS = 32 * RV + 4;    // a warp's copy of such a row (one 16-byte unit more)
constexpr int MAX_D = 256;                // widest row (ops/probe.py:TILES_MAX_D)
constexpr int MAX_P = 1024;               // most windows a pair (ops/probe.py:TILES_MAX_P)
constexpr int TPE = NT / CH;              // threads a work item's entry
static_assert(TILE == MMA_ROWS * NW, "a warp multiplies 16 rows of a tile");
static_assert(NQG % 2 == 0, "one ldmatrix loads two query groups");
static_assert(TPE == 4 && TILE == 128, "four threads an entry, one a word of its row mask");

// A call's sizes (m queries of a query block).
struct Sizes {
  int m, tries, P, d, n_pad, window, live, k;
  __host__ __device__ long long pairs() const { return (long long)m * tries; }
  __host__ __device__ int tiles_per_table() const { return (n_pad + TILE - 1) / TILE; }
  __host__ __device__ long long tiles() const { return (long long)tries * tiles_per_table(); }
  // slots of a pair's distance row: as many as its union can hold
  __host__ __device__ long long row_len() const {
    const long long u = (long long)P * window;
    return u < n_pad ? u : n_pad;
  }
  // entries a run is cut into, at most (a run is at most a window long)
  __host__ __device__ int spans() const { return (window - 1) / TILE + 2; }
  __host__ __device__ long long max_entries() const { return pairs() * P * spans(); }
};

// The workspace: each pair's union runs (first slot, offset in its
// distance row) and its pieces (a run cut at tile edges: the piece's tile
// and rank in it, and its entry); the tiles' entry counts and the grid barrier's count
// (zeroed together before a launch); the tiles' first entries, the
// blocks' sums, the work items (tile, first entry, entries), the entries
// in tile order, the pairs' distance rows, the queries' squared norms.  An
// entry: (query, first row | end row << 16, the query's squared norm (float
// bits: placed in phase 2), distance-row index of row 0).
struct Work {
  int* run_lo;       // [pairs][P]
  int* run_off;      // [pairs][P + 1]
  int2* piece_at;    // [pairs][P][spans]: (tile, rank), tile -1: none
  int4* piece;       // [pairs][P][spans]
  int* tile_cnt;     // [tiles]
  unsigned* bar;     // [1]
  int* tile_off;     // [tiles]
  int* block_sum;    // [2][MAX_GRID]
  int4* items;       // [max_items]
  int4* entries;     // [max_entries]
  float* dist;       // [pairs][row_len]
  float* qn;         // [m]
};

constexpr int MAX_GRID = 8192;  // most blocks a launch (its block sums' room)

// work items at most: one a tile and one a full CH of entries
inline long long max_items(const Sizes& s) { return s.tiles() + s.max_entries() / CH + 1; }

// Bytes of the workspace, carved from base into w where both are given;
// *zero_bytes: the bytes from tile_cnt to the barrier, zeroed a launch.
inline long long carve(const Sizes& s, unsigned char* base, Work* w, long long* zero_bytes) {
  long long at = 0;
  auto take = [&](long long bytes) {
    unsigned char* p = base ? base + at : nullptr;
    at += (bytes + 255) / 256 * 256;
    return p;
  };
  const long long T = s.tiles(), pairs = s.pairs(), slots = pairs * s.P * s.spans();
  unsigned char* p[12];
  p[0] = take(4 * pairs * s.P);
  p[1] = take(4 * pairs * (s.P + 1));
  p[2] = take(8 * slots);
  p[3] = take(16 * slots);
  const long long z0 = at;
  p[4] = take(4 * T);
  p[5] = take(4);
  if (zero_bytes) *zero_bytes = at - z0;
  p[6] = take(4 * T);
  p[7] = take(4 * 2 * MAX_GRID);
  p[8] = take(16 * max_items(s));
  p[9] = take(16 * s.max_entries());
  p[10] = take(4 * pairs * s.row_len());
  p[11] = take(4LL * s.m);
  if (w) {
    *w = Work{reinterpret_cast<int*>(p[0]),  reinterpret_cast<int*>(p[1]),
              reinterpret_cast<int2*>(p[2]), reinterpret_cast<int4*>(p[3]),
              reinterpret_cast<int*>(p[4]),  reinterpret_cast<unsigned*>(p[5]),
              reinterpret_cast<int*>(p[6]),  reinterpret_cast<int*>(p[7]),
              reinterpret_cast<int4*>(p[8]), reinterpret_cast<int4*>(p[9]),
              reinterpret_cast<float*>(p[10]), reinterpret_cast<float*>(p[11])};
  }
  return at;
}

// The binning of one pair (phase 0), a whole warp: sort the pair's window
// starts (each lane ranks its starts against all P), walk their union in
// sorted order as runs [a, hi) clipped at the live bound (run i keeps the
// slots window i adds: a = max(s_i, s_{i-1} + window), since the windows
// are equally long; an empty run keeps its offset), and cut each run at
// tile edges into pieces: a piece takes the next rank in its tile's count
// and keeps its entry.  No row or query is read here.
__device__ void bin_pair(const int* __restrict__ starts, const Sizes& s, const Work& w,
                         long long pair, int lane) {
  const int P = s.P, W = s.window;
  const int* st = starts + pair * P;
  int* lo = w.run_lo + pair * P;
  int* off = w.run_off + pair * (P + 1);
  for (int p = lane; p < P; p += 32) {  // rank sort (ties by index: ranks are unique)
    const int v = st[p];
    int r = 0;
    for (int j = 0; j < P; ++j) {
      const int o = st[j];
      r += (o < v || (o == v && j < p)) ? 1 : 0;
    }
    lo[r] = v;
  }
  __syncwarp();
  const long long tb = (long long)(pair % s.tries) * s.tiles_per_table();
  const int qi = (int)(pair / s.tries), spans = s.spans();
  const long long row = pair * s.row_len();
  int carry = 0, last = 0;  // the offset so far, the previous chunk's last start
  for (int base = 0; base < P; base += 32) {
    const int i = base + lane;
    const int v = i < P ? lo[i] : 0;
    const int up = __shfl_up_sync(0xffffffffu, v, 1);
    const int prev = i == 0 ? v - W : (lane == 0 ? last : up);
    const int a = v > prev + W ? v : prev + W;
    const int hc = v + W < s.live ? v + W : s.live;
    const int len = i < P && hc > a ? hc - a : 0;
    int incl = len;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += t;
    }
    last = __shfl_sync(0xffffffffu, v, 31);
    __syncwarp();  // every lane has read its start before any is overwritten
    if (i < P) {
      const int oi = carry + incl - len;
      lo[i] = a;
      off[i] = oi;
      const long long slot = (pair * P + i) * spans;
      int h = 0;
      for (int x = a; x < hc; ++h) {
        const int tile = x / TILE, t0 = tile * TILE, e = hc < t0 + TILE ? hc : t0 + TILE;
        const int rank = atomicAdd(w.tile_cnt + tb + tile, 1);
        w.piece_at[slot + h] = make_int2((int)(tb + tile), rank);
        w.piece[slot + h] = make_int4(qi, (x - t0) | (e - t0) << 16, 0,
                                      (int)(row + oi + t0 - a));
        x = e;
      }
      for (; h < spans; ++h) w.piece_at[slot + h] = make_int2(-1, 0);
    }
    carry += __shfl_sync(0xffffffffu, incl, 31);
  }
  if (lane == 0) off[P] = carry;
}

struct Args {
  const void* pts;     // (tries * n_pad, d) rows
  const void* q;       // (m, d) queries in the row type
  const int* starts;   // (m, tries, P) widened starts
  Sizes s;
  Work w;
  float* out_d;
  int* out_i;
};

// Whether a call's pairs take the threshold selection (select_small): k
// <= SEL_K and score rows of at most 32 RV slots.
__host__ __device__ inline bool small_rows(const Sizes& s) {
  return s.k <= SEL_K && s.row_len() <= 32 * RV;
}

// Bytes of dynamic shared memory: the larger of scoring's (two stages of
// the tile's rows, CH query rows, the entries and the warps' parts of the
// item's row mask) and selection's (a warp's copy of its pair's score row
// where the rows are small, its runs, candidates, top-k list and query; a
// multiple of 16 bytes).
__host__ __device__ inline int stage_words(int d) {
  return (TILE + CH) * padded_stride(d, 2) + 4 * CH + 4 * NW;
}
__host__ __device__ inline int score_bytes(int d) { return 4 * 2 * stage_words(d); }
__host__ __device__ inline int warp_words(const Sizes& s) {
  const int w = (small_rows(s) ? ROW_WORDS : 0) + 2 * s.P + 1 + 2 * CAP + 2 * s.k + s.d / 2;
  return (w + 3) & ~3;
}
inline size_t smem_bytes(const Sizes& s) {
  const int a = score_bytes(s.d), b = 4 * NW * warp_words(s);
  return (size_t)(a > b ? a : b);
}

// The slot of union index l of a pair: the last run whose offset is <= l
// (that run is not empty).
__device__ __forceinline__ int union_slot(const int* lo, const int* off, int P, int l) {
  int a = 0, b = P - 1;
  while (a < b) {
    const int mid = (a + b + 1) >> 1;
    if (off[mid] <= l) a = mid; else b = mid - 1;
  }
  return lo[a] + (l - off[a]);
}

// Ascending sort of one value a lane (bitonic, in shuffles).
__device__ __forceinline__ float warp_sort(float v, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int j = size >> 1; j > 0; j >>= 1) {
      const float o = __shfl_xor_sync(0xffffffffu, v, j);
      const bool up = (lane & size) == 0, low = (lane & j) == 0;
      v = low == up ? fminf(v, o) : fmaxf(v, o);
    }
  }
  return v;
}

// The scores' margin over (|q|^2 + tau).  A score |x|^2 + |q|^2 - 2 q.x
// (exact products; fp32 sums: ceil(d / 16) mma.sync K steps of 17 terms
// each, at worst truncated, the norms' ~d / 4 terms a lane, the sum of the
// three) lies within eps (|x|^2 + |q|^2) of the distance, eps <= (17
// ceil(d / 16) + d / 4 + 8) 2^-23, and |x|^2 <= 2 |q|^2 + 2 dist.  So with
// tau at least the k-th smallest score, every slot whose distance is among
// the k nearest scores at most tau + 6 eps (|q|^2 + tau) (to first order
// in eps); the margin, (ceil(d / 16) + 1) 2^-15, is twice that or more.
__host__ __device__ inline float margin(int d) {
  return (float)((d + 15) / 16 + 1) * (1.0f / 32768.0f);
}

// Two values of the row type in a word, widened to fp32.
template <typename T>
__device__ __forceinline__ void unpack2(uint32_t w, float& lo, float& hi) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    lo = __uint_as_float(w << 16);
    hi = __uint_as_float(w & 0xffff0000u);
  } else {
    lo = __half2float(__ushort_as_half((unsigned short)(w & 0xffffu)));
    hi = __half2float(__ushort_as_half((unsigned short)(w >> 16)));
  }
}

// The distance sum((x - q)^2) in fp32 of a row (nv 16-byte units of the
// row type) to the query staged in shared memory (4 nv words), as the plain
// version and the "pairs" design sum it up to the order; +inf where not
// finite.  One lane a row: eight units' loads in flight.
template <typename T>
__device__ float exact_dist(const uint4* __restrict__ row, const uint32_t* qs, int nv) {
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int c0 = 0; c0 < nv; c0 += 8) {
    uint4 u[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (c0 + j < nv) u[j] = __ldg(row + c0 + j);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (c0 + j < nv) {
        const uint32_t x[4] = {u[j].x, u[j].y, u[j].z, u[j].w};
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          float x0, x1, q0, q1;
          unpack2<T>(x[h], x0, x1);
          unpack2<T>(qs[4 * (c0 + j) + h], q0, q1);
          acc[h] = fmaf(x0 - q0, x0 - q0, acc[h]);
          acc[h] = fmaf(x1 - q1, x1 - q1, acc[h]);
        }
      }
    }
  }
  const float v = (acc[0] + acc[1]) + (acc[2] + acc[3]);
  return v < pos_inf() ? v : pos_inf();
}

// What selection needs of a pair beyond its scores: its runs, its query
// (staged, and its squared norm), its table's rows, the sizes.
template <typename T>
struct PairView {
  const int* lo;
  const int* off;
  const uint32_t* qs;
  const uint4* rows;  // row 0 of the pair's table
  float qn, mu;       // |q|^2, margin(d)
  int P, nv, k, live, L;
  __device__ float bound(float tau) const { return tau + mu * (qn + tau); }
  __device__ float exact(int slot) const {
    return exact_dist<T>(rows + (long long)slot * nv, qs, nv);
  }
};

// A pair's k <= SEL_K nearest from its L scores (finite or +inf), copied
// into shared memory (sv): tau, the k-th smallest of the lanes' minima
// (lane i's over the scores l = i mod 32), is at least the k-th
// smallest score, so the slots scoring at most pv.bound(tau) hold the k
// nearest.  Up to CAP of them are ranked by score, which gives the k-th
// smallest score exactly; those scoring at most pv.bound of it (a few over
// k) are scored again (exact_dist) and ranked by (distance, slot).  False
// (nothing written) where more than CAP slots score within pv.bound(tau).
// Whole warp.
template <typename T>
__device__ bool select_small(const float* sv, const PairView<T>& pv, float* cd, int* cl,
                             float* od, int* oi, int lane) {
  const float inf = pos_inf();
  float mn = inf;
  for (int l = lane; l < pv.L; l += 32) mn = fminf(mn, sv[l]);
  const float tau = __shfl_sync(0xffffffffu, warp_sort(mn, lane), pv.k - 1);
  const float lim = pv.bound(tau);
  int c = 0;
  for (int l0 = 0; l0 < pv.L; l0 += 32) {
    const int l = l0 + lane;
    const float x = l < pv.L ? sv[l] : inf;
    const bool take = x <= lim && x < inf;
    const unsigned bal = __ballot_sync(0xffffffffu, take);
    if (take) {
      const int i = c + __popc(bal & ((1u << lane) - 1u));
      if (i < CAP) { cd[i] = x; cl[i] = l; }
    }
    c += __popc(bal);
  }
  if (c > CAP) return false;
  __syncwarp();
  // the k-th smallest score (ties by place; +inf with fewer than k)
  float kth = inf;
  for (int i = lane; i < c; i += 32) {
    const float x = cd[i];
    int r = 0;
    for (int j = 0; j < c; ++j) r += (cd[j] < x || (cd[j] == x && j < i)) ? 1 : 0;
    if (r == pv.k - 1) kth = x;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) kth = fminf(kth, __shfl_xor_sync(0xffffffffu, kth, o));
  const float lim2 = pv.bound(kth);
  // keep those within its bound, in place (a chunk read before it is written)
  int c2 = 0;
  for (int base = 0; base < c; base += 32) {
    const int i = base + lane;
    const bool keep = i < c && cd[i] <= lim2;
    const int l = keep ? cl[i] : 0;
    __syncwarp();
    const unsigned bal = __ballot_sync(0xffffffffu, keep);
    if (keep) cl[c2 + __popc(bal & ((1u << lane) - 1u))] = l;
    c2 += __popc(bal);
    __syncwarp();
  }
  for (int i = lane; i < c2; i += 32) {
    const int sl = union_slot(pv.lo, pv.off, pv.P, cl[i]);
    cl[i] = sl;
    cd[i] = pv.exact(sl);
  }
  __syncwarp();
  for (int i = lane; i < c2; i += 32) {
    const float x = cd[i];
    const int sl = cl[i];
    int r = 0;
    for (int j = 0; j < c2; ++j) r += lex_less(cd[j], cl[j], x, sl) ? 1 : 0;
    if (r < pv.k) {
      od[r] = x;
      oi[r] = x < inf ? sl : pv.live;
    }
  }
  for (int r = c2 + lane; r < pv.k; r += 32) { od[r] = inf; oi[r] = pv.live; }
  return true;
}

// The k smallest by (value, slot) of value(l, slot) over the union
// indices l < L, into the sorted list (ld, li) in shared memory: a ballot
// of each 32 values against the list's last, a warp-cooperative insert of
// each that beats it (the "pairs" design's selection).  Whole warp.
template <typename T, class F>
__device__ void select_insert(F&& value, const PairView<T>& pv, float* ld, int* li, int lane) {
  const float inf = pos_inf();
  for (int j = lane; j < pv.k; j += 32) { ld[j] = inf; li[j] = ID_NONE; }
  __syncwarp();
  float wd = inf;
  int wi = ID_NONE;
  for (int l0 = 0; l0 < pv.L; l0 += 32) {
    const int l = l0 + lane;
    float my_d = inf;
    int my_i = pv.live;
    if (l < pv.L) {
      my_i = union_slot(pv.lo, pv.off, pv.P, l);
      my_d = value(l, my_i);
    }
    const bool ok = my_d < inf && lex_less(my_d, my_i, wd, wi);
    unsigned mask = __ballot_sync(0xffffffffu, ok);
    while (mask) {
      const int src = __ffs(mask) - 1;
      mask &= mask - 1;
      const float cdv = __shfl_sync(0xffffffffu, my_d, src);
      const int civ = __shfl_sync(0xffffffffu, my_i, src);
      if (lex_less(cdv, civ, wd, wi)) {
        warp_insert(ld, li, pv.k, cdv, civ, lane);
        wd = ld[pv.k - 1];
        wi = li[pv.k - 1];
      }
    }
  }
  __syncwarp();
}

// The general selection (k > SEL_K, long rows, or more than CAP slots
// within select_small's bound): the k smallest scores by select_insert,
// whose k-th bounds the k-th score; then the k nearest by distance
// (exact_dist) of the slots scoring within pv.bound of it.  Whole warp.
template <typename T>
__device__ void select_general(const float* row, const PairView<T>& pv, float* ld, int* li,
                               float* od, int* oi, int lane) {
  select_insert([&](int l, int) { return __ldcg(row + l); }, pv, ld, li, lane);
  const float lim = pv.bound(ld[pv.k - 1]);
  __syncwarp();
  select_insert([&](int l, int sl) {
    const float sc = __ldcg(row + l);
    return sc <= lim && sc < pos_inf() ? pv.exact(sl) : pos_inf();
  }, pv, ld, li, lane);
  for (int j = lane; j < pv.k; j += 32) {
    const bool real = ld[j] < pos_inf();
    od[j] = real ? ld[j] : pos_inf();
    oi[j] = real ? li[j] : pv.live;
  }
}

// The grid barrier of a cooperative launch (every block resident): the
// count, zeroed before the launch, reaches `target` (gridDim.x times the
// barrier's number).  Writes before it are seen after it by loads that
// bypass L1 (__ldcg).
__device__ __forceinline__ void grid_sync(unsigned* bar, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(bar, 1u);
    while (*reinterpret_cast<volatile unsigned*>(bar) < target) __nanosleep(32);
    __threadfence();
  }
  __syncthreads();
}

// Sums of (x, y) over the block, in every thread.  red: 2 NW ints of
// shared memory.
__device__ __forceinline__ void block_sum2(int& x, int& y, int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, o);
    y += __shfl_xor_sync(0xffffffffu, y, o);
  }
  __syncthreads();
  if (lane == 0) { red[warp] = x; red[NW + warp] = y; }
  __syncthreads();
  x = 0;
  y = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) { x += red[i]; y += red[NW + i]; }
}

// The rows of [lo, hi) in word `wd` (rows 32 wd .. 32 wd + 31) of a row mask.
__device__ __forceinline__ unsigned row_bits(int lo, int hi, int wd) {
  const int a = lo > 32 * wd ? lo - 32 * wd : 0, b = hi < 32 * wd + 32 ? hi - 32 * wd : 32;
  if (b <= a) return 0u;
  return (b == 32 ? 0xffffffffu : (1u << b) - 1u) & ~((1u << a) - 1u);
}

// The tile design's kernel, persistent and cooperative (the header's
// phases).  Phase 1 in two steps: the tiles' counts summed a block range at
// a time, then each block's range scanned into the tiles' first entries and
// the work items (CH entries an item, in tile order).
template <typename T>
__global__ void __launch_bounds__(NT, 2) probe_kernel_tiles(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int red[2 * NW];
  const Sizes& s = a.s;
  const Work& w = a.w;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long ntiles = s.tiles(), pairs = s.pairs();
  const int G = gridDim.x, bx = blockIdx.x;
  unsigned target = 0;

  // 0. the binning, a warp a pair; the queries' squared norms, a warp a
  // query (in fp32 from the queries in the row type, as the tile's |x|^2
  // are summed)
  for (long long pair = (long long)bx * NW + warp; pair < pairs; pair += (long long)G * NW)
    bin_pair(a.starts, s, w, pair, lane);
  {
    const uint32_t* qw = static_cast<const uint32_t*>(a.q);
    const int words = s.d / 2;
    for (long long qi = (long long)bx * NW + warp; qi < s.m; qi += (long long)G * NW) {
      float qn = 0.f;
      for (int j = lane; j < words; j += 32) tile::add_squares<T>(__ldg(qw + qi * words + j), qn);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) qn += __shfl_xor_sync(0xffffffffu, qn, o);
      if (lane == 0) w.qn[qi] = qn;
    }
  }
  grid_sync(w.bar, target += G);

  // 1a. the block's range of tiles: sums of entries and of work items
  const long long span = (ntiles + G - 1) / G;
  const long long t_lo = span * bx < ntiles ? span * bx : ntiles;
  const long long t_hi = t_lo + span < ntiles ? t_lo + span : ntiles;
  int se = 0, si = 0;
  for (long long t = t_lo + tid; t < t_hi; t += NT) {
    const int c = __ldcg(w.tile_cnt + t);
    se += c;
    si += (c + CH - 1) / CH;
  }
  block_sum2(se, si, red);
  if (tid == 0) { w.block_sum[bx] = se; w.block_sum[MAX_GRID + bx] = si; }
  grid_sync(w.bar, target += G);

  // 1b. the blocks before this one, all blocks' items; then this range's
  // scan in pages of NT x PER tiles
  int pe = 0, pi = 0, n_items = 0;
  {
    int all = 0;
    for (int j = tid; j < G; j += NT) {
      const int e = __ldcg(w.block_sum + j), i = __ldcg(w.block_sum + MAX_GRID + j);
      if (j < bx) { pe += e; pi += i; }
      all += i;
    }
    int dummy = 0;
    block_sum2(pe, pi, red);
    block_sum2(all, dummy, red);
    n_items = all;
  }
  constexpr int PER = 8;
  for (long long p0 = t_lo; p0 < t_hi; p0 += NT * PER) {
    int c[PER];
    int e_sum = 0, i_sum = 0;
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const long long t = p0 + (long long)PER * tid + u;
      c[u] = t < t_hi ? __ldcg(w.tile_cnt + t) : 0;
      e_sum += c[u];
      i_sum += (c[u] + CH - 1) / CH;
    }
    int ie = e_sum, ii = i_sum;  // inclusive over the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int ve = __shfl_up_sync(0xffffffffu, ie, o), vi = __shfl_up_sync(0xffffffffu, ii, o);
      if (lane >= o) { ie += ve; ii += vi; }
    }
    __syncthreads();
    if (lane == 31) { red[warp] = ie; red[NW + warp] = ii; }
    __syncthreads();
    int we = 0, wi = 0, te = 0, ti = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      if (j < warp) { we += red[j]; wi += red[NW + j]; }
      te += red[j];
      ti += red[NW + j];
    }
    int e = pe + we + ie - e_sum, it = pi + wi + ii - i_sum;
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const long long t = p0 + (long long)PER * tid + u;
      if (t < t_hi) w.tile_off[t] = e;
      for (int j = 0; j < c[u]; j += CH)
        w.items[it++] = make_int4((int)t, e + j, c[u] - j < CH ? c[u] - j : CH, 0);
      e += c[u];
    }
    pe += te;
    pi += ti;
  }
  grid_sync(w.bar, target += G);

  // 2. every piece to its place: its tile's first entry + its rank, with
  // its query's squared norm (SU pieces a thread at once: every load before
  // the first store)
  {
    constexpr int SU = 8;
    const long long slots = pairs * s.P * s.spans(), step = (long long)G * NT;
    for (long long i0 = (long long)bx * NT + tid; i0 < slots; i0 += SU * step) {
      int2 at[SU];
      int to[SU];
      int4 pc[SU];
#pragma unroll
      for (int u = 0; u < SU; ++u)
        at[u] = i0 + u * step < slots ? __ldcg(w.piece_at + i0 + u * step) : make_int2(-1, 0);
#pragma unroll
      for (int u = 0; u < SU; ++u) {
        if (at[u].x >= 0) {
          to[u] = __ldcg(w.tile_off + at[u].x) + at[u].y;
          pc[u] = __ldcg(w.piece + i0 + u * step);
        }
      }
#pragma unroll
      for (int u = 0; u < SU; ++u)
        if (at[u].x >= 0) pc[u].z = __float_as_int(__ldcg(w.qn + pc[u].x));
#pragma unroll
      for (int u = 0; u < SU; ++u)
        if (at[u].x >= 0) w.entries[to[u]] = pc[u];
    }
  }
  grid_sync(w.bar, target += G);

  // 3. the work items: the row bytes past d up to a whole K step stay zero
  const int stride = padded_stride(s.d, 2), rw = row_words(s.d, 2);
  const int ksteps = rw / KSTEP_WORDS, sw = stage_words(s.d);
  const int tpt = s.tiles_per_table(), rbytes = 2 * s.d, upr = rbytes / 16;
  // stage b at smem + 4 b sw: rows [TILE][stride], queries [CH][stride],
  // entries [CH], the warps' row-mask parts [NW][4]
  uint32_t* stage = reinterpret_cast<uint32_t*>(smem);
  const unsigned char* pts = static_cast<const unsigned char*>(a.pts);
  const unsigned char* qrows = static_cast<const unsigned char*>(a.q);
  for (int b = 0; b < 2; ++b)
    zero_row_ends(stage + b * sw, TILE + CH, stride, rbytes, 4 * rw, tid, NT);
  const int g = lane >> 2, t4 = lane & 3;
  const int my_e = tid / TPE, my_h = tid - my_e * TPE;  // four threads an entry
  const int4 none = make_int4(0, 0, 0, 0);
  auto X_at = [&](int b) { return stage + b * sw; };
  auto Q_at = [&](int b) { return stage + b * sw + TILE * stride; };
  auto E_at = [&](int b) { return reinterpret_cast<int4*>(stage + b * sw + (TILE + CH) * stride); };
  auto M_at = [&](int b) { return reinterpret_cast<unsigned*>(E_at(b) + CH); };
  auto item_at = [&](int i) { return i < n_items ? __ldcg(w.items + i) : none; };
  auto entry_at = [&](const int4 d) { return my_e < d.z ? __ldcg(w.entries + d.y + my_e) : none; };
  // before the barrier: the entries' queries, the entries, the warps' parts
  // of the row mask (word h of warp i at M[4 i + h])
  auto stage_entries = [&](int b, const int4 d, const int4 en) {
    unsigned bits = 0;
    if (my_e < d.z) {
      if (my_h == 0) E_at(b)[my_e] = en;
      bits = row_bits(en.y & 0xffff, en.y >> 16, my_h);
      const unsigned char* qs = qrows + (long long)en.x * rbytes;
      uint32_t* Q = Q_at(b);
      for (int c = my_h; c < upr; c += TPE)
        cp_async16(reinterpret_cast<unsigned char*>(Q + my_e * stride) + 16 * c, qs + 16 * c);
    }
    bits |= __shfl_xor_sync(0xffffffffu, bits, 4);
    bits |= __shfl_xor_sync(0xffffffffu, bits, 8);
    bits |= __shfl_xor_sync(0xffffffffu, bits, 16);
    if (lane < TPE) M_at(b)[4 * warp + lane] = bits;
  };
  auto mask_word = [&](int b, int wd) {
    const unsigned* M = M_at(b);
    unsigned m = 0;
#pragma unroll
    for (int i = 0; i < NW; ++i) m |= M[4 * i + wd];
    return m;
  };
  // after it: the tile's rows that the mask names (units tid, tid + NT, ...
  // of the TILE x upr 16-byte units)
  auto stage_rows = [&](int b, const int4 d) {
    const unsigned words[4] = {mask_word(b, 0), mask_word(b, 1), mask_word(b, 2), mask_word(b, 3)};
    const int table = d.x / tpt, s0 = (d.x - table * tpt) * TILE;
    const unsigned char* src = pts + ((long long)table * s.n_pad + s0) * rbytes;
    unsigned char* X = reinterpret_cast<unsigned char*>(X_at(b));
    int r = tid / upr, c = tid - r * upr;
    const int dr = NT / upr, dc = NT - dr * upr;
    for (int u = tid; u < TILE * upr; u += NT) {
      if ((words[r >> 5] >> (r & 31)) & 1u)
        cp_async16(X + 4 * r * stride + 16 * c, src + (long long)r * rbytes + 16 * c);
      r += dr;
      c += dc;
      if (c >= upr) { c -= upr; ++r; }
    }
  };
  // ldmatrix addresses (bytes from a stage): this warp's 16 rows as A, query
  // pairs of groups as B
  const uint32_t a_off = 4 * ((MMA_ROWS * warp + (lane & 7) + 8 * ((lane >> 3) & 1)) * stride +
                              4 * (lane >> 4));
  const uint32_t b_off = 4 * ((TILE + (lane & 7) + 8 * (lane >> 4)) * stride +
                              4 * ((lane >> 3) & 1));
  const uint32_t stage0 = static_cast<uint32_t>(__cvta_generic_to_shared(stage));
  const int r0 = MMA_ROWS * warp + g;  // this lane's rows r0 and r0 + 8 in the C fragments
  // a score into the pairs' rows (xn the row's squared norm): +inf where
  // the row or the sum is not finite
  auto put = [&](long long at, float xn, float v) {
    const float dist = xn < pos_inf() && v < pos_inf() ? fmaxf(v, 0.0f) : pos_inf();
    w.dist[at] = dist;
  };
  // ahead of item it: d1, e1 (item it + G's descriptor and this thread's
  // entry) and d2 (item it + 2 G's descriptor), so that no load waits
  int it = bx;
  int4 cur = item_at(it);
  if (it < n_items) stage_entries(0, cur, entry_at(cur));
  int4 d1 = item_at(it + G), d2 = item_at(it + 2 * G);
  int4 e1 = entry_at(d1);
  __syncthreads();
  if (it < n_items) stage_rows(0, cur);
  cp_async_commit();
  for (int b = 0; it < n_items; it += G, b ^= 1) {
    const bool next = it + G < n_items;
    if (next) stage_entries(b ^ 1, d1, e1);
    const int4 e2 = entry_at(d2), d3 = item_at(it + 3 * G);
    cp_async_wait<0>();
    __syncthreads();  // item it is in; the next item's mask parts too
    if (next) stage_rows(b ^ 1, d1);  // into the other stage while this one is used
    cp_async_commit();
    const int cnt = cur.z;
    const unsigned mine = (mask_word(b, warp >> 1) >> (16 * (warp & 1))) & 0xffffu;
    if (mine) {  // else none of this warp's 16 rows is in the item
      const int groups = (cnt + MMA_QUERIES - 1) / MMA_QUERIES;
      const uint32_t sb = stage0 + 4 * b * sw;
      float acc[NQG][4], x0 = 0.f, x1 = 0.f;
#pragma unroll
      for (int j = 0; j < NQG; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;
      for (int ks = 0; ks < ksteps; ++ks) {
        uint32_t af[4];
        load_a(af, sb + a_off + 4 * ks * KSTEP_WORDS);
        // rows r0 (words 0 and 2) and r0 + 8 (1 and 3): their squares
        tile::add_squares<T>(af[0], x0);
        tile::add_squares<T>(af[2], x0);
        tile::add_squares<T>(af[1], x1);
        tile::add_squares<T>(af[3], x1);
#pragma unroll
        for (int j = 0; j < NQG / 2; ++j) {
          if (2 * j < groups) {
            uint32_t bf[4];
            load_a(bf, sb + b_off + 4 * (j * 2 * MMA_QUERIES * stride + ks * KSTEP_WORDS));
            Mma<T>::step(acc[2 * j], af, bf[0], bf[1]);
            Mma<T>::step(acc[2 * j + 1], af, bf[2], bf[3]);
          }
        }
      }
      // |x|^2 of rows r0 and r0 + 8: the sums of the four lanes of each row
      x0 += __shfl_xor_sync(0xffffffffu, x0, 1);
      x0 += __shfl_xor_sync(0xffffffffu, x0, 2);
      x1 += __shfl_xor_sync(0xffffffffu, x1, 1);
      x1 += __shfl_xor_sync(0xffffffffu, x1, 2);
      const int4* E = E_at(b);
      // distances into the pairs' rows where the row lies in the entry's run
#pragma unroll
      for (int j = 0; j < NQG; ++j) {
        if (j < groups) {
#pragma unroll
          for (int ce = 0; ce < 2; ++ce) {
            const int e = MMA_QUERIES * j + 2 * t4 + ce;
            if (e < cnt) {
              const int4 en = E[e];
              const int lo = en.y & 0xffff, hi = en.y >> 16;
              const float qn = __int_as_float(en.z);
              if (r0 >= lo && r0 < hi) put(en.w + r0, x0, x0 + qn - 2.0f * acc[j][ce]);
              if (r0 + 8 >= lo && r0 + 8 < hi)
                put(en.w + r0 + 8, x1, x1 + qn - 2.0f * acc[j][2 + ce]);
            }
          }
        }
      }
    }
    __syncthreads();  // the next round may overwrite this stage
    cur = d1;
    d1 = d2;
    e1 = e2;
    d2 = d3;
  }
  grid_sync(w.bar, target += G);

  // 4. selection, a pair a warp; rows up to 32 RV slots and k <= SEL_K:
  // the score row copied into the warp's shared memory (sv, its 16-byte
  // units by cp.async) beside the pair's runs
  const bool small = small_rows(s);
  float* sv = reinterpret_cast<float*>(smem) + warp * warp_words(s);
  int* lo = reinterpret_cast<int*>(sv) + (small ? ROW_WORDS : 0);
  int* off = lo + s.P;
  float* cd = reinterpret_cast<float*>(off + s.P + 1);
  int* cl = reinterpret_cast<int*>(cd + CAP);
  float* ld = reinterpret_cast<float*>(cl + CAP);
  int* li = reinterpret_cast<int*>(ld + s.k);
  uint32_t* qs = reinterpret_cast<uint32_t*>(li + s.k);
  const long long rl = s.row_len();
  const int qwords = s.d / 2, nv = s.d / 8;
  const float mu = margin(s.d);
  const uint32_t* qw = static_cast<const uint32_t*>(a.q);
  // the next pair's union length L ahead, so that a row is read up to it
  const long long pstep = (long long)G * NW;
  auto union_len = [&](long long p) {
    return p < pairs ? __ldcg(w.run_off + p * (s.P + 1) + s.P) : 0;
  };
  long long pair = (long long)bx * NW + warp;
  int L_next = union_len(pair);
  for (; pair < pairs; pair += pstep) {
    const int L = L_next;
    L_next = union_len(pair + pstep);
    const float* row = w.dist + pair * rl;
    const int o = (int)((reinterpret_cast<uintptr_t>(row) >> 2) & 3);  // the row's place in its unit
    if (small) {
      for (int u = lane; 4 * u < o + L; u += 32) cp_async16(sv + 4 * u, row - o + 4 * u);
      cp_async_commit();
    }
    const long long qi = pair / s.tries;
    const int t = (int)(pair - qi * s.tries);
    for (int p = lane; p < s.P; p += 32) lo[p] = __ldcg(w.run_lo + pair * s.P + p);
    for (int p = lane; p <= s.P; p += 32) off[p] = __ldcg(w.run_off + pair * (s.P + 1) + p);
    for (int j = lane; j < qwords; j += 32) qs[j] = __ldg(qw + qi * qwords + j);
    if (small) cp_async_wait<0>();
    __syncwarp();
    const PairView<T> pv{lo, off, qs,
                         static_cast<const uint4*>(a.pts) + (long long)t * s.n_pad * nv,
                         __ldcg(w.qn + qi), mu, s.P, nv, s.k, s.live, L};
    float* od = a.out_d + pair * s.k;
    int* oi = a.out_i + pair * s.k;
    if (!small || !select_small(sv + o, pv, cd, cl, od, oi, lane))
      select_general(row, pv, ld, li, od, oi, lane);
    __syncwarp();
  }
}

// The counts zeroed, then the cooperative kernel on as many blocks as are
// resident, on `stream`.
template <typename T>
int launch(const Args& a, long long zero_bytes, cudaStream_t stream) {
  const Sizes& s = a.s;
  cudaError_t err = cudaMemsetAsync(a.w.tile_cnt, 0, (size_t)zero_bytes, stream);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = smem_bytes(s);
  if (smem > (size_t)SMEM_MAX) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(probe_kernel_tiles<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, probe_kernel_tiles<T>, NT, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = per_sm * sms < MAX_GRID ? per_sm * sms : MAX_GRID;
  if (grid < 1) return (int)cudaErrorInvalidConfiguration;
  Args copy = a;
  void* params[] = {&copy};
  return (int)cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(probe_kernel_tiles<T>),
                                          dim3(grid), dim3(NT), params, smem, stream);
}

// The sizes a launch takes: bf16 / f16 rows of d a multiple of 8 up to
// MAX_D, at most MAX_P windows, indices within int32.
inline bool sizes_ok(const Sizes& s) {
  return s.k >= 1 && s.k <= KMAX && s.m >= 1 && s.tries >= 1 && s.P >= 1 && s.P <= MAX_P &&
         s.d >= 8 && s.d <= MAX_D && s.d % 8 == 0 && s.n_pad >= 1 && s.window >= 1 &&
         s.window <= s.n_pad && s.live >= 0 && s.live <= s.n_pad &&
         s.pairs() * s.row_len() < 0x7fffffffLL && s.max_entries() < 0x7fffffffLL &&
         s.tiles() < 0x7fffffffLL;
}

}  // namespace tiles

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

// Bytes of the "tiles" design's workspace for m queries (-1: sizes it
// does not take).
long long probe_tiles_workspace(int m, int tries, int P, int d, int n_pad, int window, int k) {
  const tiles::Sizes s{m, tries, P, d, n_pad, window, 0, k};
  return tiles::sizes_ok(s) ? tiles::carve(s, nullptr, nullptr, nullptr) : -1;
}

// Queries a launch of the "tiles" design takes within `budget` bytes of
// workspace: the most whose workspace fits and whose indices stay within
// int32, at least one (-1: sizes it does not take).
long long probe_tiles_block(int tries, int P, int d, int n_pad, int window, int k,
                            long long budget) {
  tiles::Sizes s{1, tries, P, d, n_pad, window, 0, k};
  if (!tiles::sizes_ok(s)) return -1;
  auto fits = [&](long long m) {
    s.m = (int)m;
    return tiles::sizes_ok(s) && tiles::carve(s, nullptr, nullptr, nullptr) <= budget;
  };
  long long lo = 1, hi = 0x7fffffffLL;  // fits(lo) or lo == 1; !fits(hi)
  while (hi - lo > 1) {
    const long long mid = lo + (hi - lo) / 2;
    (fits(mid) ? lo : hi) = mid;
  }
  return lo;
}

// The "tiles" design (the header's): q (m, d) queries in the row type
// (dtype 1 = bfloat16, 2 = float16; rows and queries 16-byte aligned);
// work the workspace of probe_tiles_workspace's bytes; the rest as
// probe_topk_launch.  Two launches on the stream: a memset and the
// cooperative probe_kernel_tiles.
int probe_tiles_launch(int device, const void* pts, int dtype, const void* q,
                       const int* starts, int m, int tries, int P, int d, int n_pad,
                       int window, int live, int k, void* work, long long work_bytes,
                       float* out_d, int* out_i, void* stream) {
  const tiles::Sizes s{m, tries, P, d, n_pad, window, live, k};
  if (!tiles::sizes_ok(s) || (dtype != 1 && dtype != 2) ||
      reinterpret_cast<uintptr_t>(pts) % 16 || reinterpret_cast<uintptr_t>(q) % 16 ||
      reinterpret_cast<uintptr_t>(work) % 256 ||
      work_bytes < tiles::carve(s, nullptr, nullptr, nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  tiles::Args a{pts, q, starts, s, {}, out_d, out_i};
  long long zero_bytes = 0;
  tiles::carve(s, static_cast<unsigned char*>(work), &a.w, &zero_bytes);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? tiles::launch<__nv_bfloat16>(a, zero_bytes, st)
                    : tiles::launch<__half>(a, zero_bytes, st);
}

const char* probe_knn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
