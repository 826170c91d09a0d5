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
//   * emit does the rank kernel's 2*m*n*d products (2.6e11 flop at 1M x
//     128, m = 1000) against one corpus read (512 MB) and an output of
//     m * n/seg pairs (62.5 MB at seg = 128): the arithmetic sets its least
//     time, and on the tensor cores what bounds the rank kernel bounds it
//     (the L2 reads of the corpus once per 32-query block, the loads that
//     feed the MMAs their operands).  It runs the rank kernel's tile loop (knn_tile.cuh: a
//     cp.async ring of 128-row tiles, eight multiplying warps on
//     knn_mma.cuh:tile_mma, the scores |x|^2 - 2 q.x in a padded array S
//     with the norms of the values as streamed, as the TPU kernel takes
//     them from its tile) and swaps the top-k for a segment min/argmin:
//     warp w reads its four queries' 128 scores of a tile from S (4 a lane)
//     and reduces them with shuffles.  A segment of 128 rows or more folds
//     each tile into a running (min, id) a query, kept in registers, and
//     writes it where the segment (or the split) ends; one of 32 or 64 rows
//     reduces per 32-row chunk, a shorter one in lane groups.  Splits are
//     cut on segment boundaries (knn_tile.cuh:launch_tiled's split_tiles),
//     so every segment is reduced by one block and its pair goes straight
//     to the output: no second pass.  That loop costs ~5 ps a score at any
//     precision, the MMAs a small part of it (26x the bf16 bound at
//     Deep-10M's shape), so bf16 / f16 corpora of d a multiple of 8 up to
//     128 (ops/twophase.py:emit_design) take knn_wgmma.cuh's pipeline
//     instead: TMA-fed stages of 256 rows, wgmma with the accumulators read
//     in place by EmitSelectWG below, 128 queries a block (9.2x faster at
//     10M x 96, m = 10,000).  Float32 (every tier), int8 and other widths
//     stay on the tile loop.
//   * rescan scores m * P * seg (query, row) pairs (786 MB of row loads at
//     1M, m = 1000, k = 10) at 3 flop per element; queries that pick the
//     same segment share its rows, so the least it must read from memory
//     is the distinct rows (~6,100 of the 7,813 segments, ~400 MB, there).
//     Memory, not arithmetic, sets its time, and the rows are scattered,
//     so it is a latency-bound gather: rows are scored by knn_gather.cuh's
//     RowScorer (lane groups with 16-byte loads, the query in registers,
//     several rows' loads in flight a group, log2(G) shuffles a row), the
//     same scorer as the probe.  The grid is (query, split of the query's
//     P windows): the wrapper takes the fewest splits (at most 32) whose
//     blocks fill the card (ops/twophase.py:rescan_splits), one at the
//     serving shape and many for add_points' emit-all launches of 26
//     queries, whose every window row is read.  Each warp inserts the 32
//     rows it just scored into its own sorted top-k (ballot against the
//     current k-th, warp-cooperative shift, as the rank kernel does); the
//     eight warp lists are merged at the end, into the output or, with
//     several splits, into a split's list that knn_common.cuh's
//     split_merge_kernel merges.  Emit-all (k = 0) writes every window
//     row's pair where it belongs, so its splits need no merge.  No array
//     of all P * seg distances is kept: at seg = 512, k = 126 that would
//     be 65,536 candidates a query.
//
// Precision: emit computes what the rank kernel computes at each tier: a
// float32 stream at "highest" (three TF32 passes with fp32 accumulation,
// ranks as IEEE fp32 does), "split3" (three bf16 passes) or "default" (one
// bf16 pass), bf16 / f16 at storage width with queries rounded to the
// corpus's type, int8 in int32 with quantised queries (exact); norms are
// the streamed values' squares summed in fp32 (int32 for int8); see
// exact_knn.cu.  Rescan has no tier: it widens every element to fp32 and
// sums differences (the JAX _kernel_rescan's exact f32); int8 queries
// arrive quantised.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (plain C interface, loaded through ctypes).

#include "knn_gather.cuh"
#include "knn_tile.cuh"
#include "knn_wgmma.cuh"

namespace {

using namespace knn;

constexpr int MAX_SPLITS = 32;

// Emit's selection step on the Hopper pipeline (knn_wgmma.cuh), for bf16 /
// f16 corpora: consumer thread (warp w of its warpgroup, lane = 4 g + tq)
// holds the scores of queries A = 16 w + g and B = A + 8 against rows
// t0 + 8 j + 2 tq + b (j < 32, b < 2) of each stage, in the accumulators.
// It walks its columns in increasing row order keeping, per query, the
// running (score, row) with a strict <, so a tie keeps the smaller row and
// a NaN never enters; rows past n have norm +inf, so their scores are +inf
// or NaN.  A segment of 256 rows or more spans whole stages and the pair
// runs on from stage to stage; a shorter one spans seg / 8 of the 32
// column groups.  Where a segment ends, two xor shuffles take the minimum
// over the quad (the four threads hold the same queries, other columns),
// ties to the smaller row, and the pair goes to a staging array of SB
// segments a query in shared memory; a full array (or the unit's end) is
// written out by the whole warpgroup, SB neighbouring segments of a query
// side by side.  Every segment length has code of its own (no test inside
// a stage): 4 instructions a score (FFMA, FSETP, two selects).  A query's
// excluded row turns its products to -inf first, in the one stage that
// holds it.
template <typename T>
struct EmitSelectWG {
  static constexpr int SB = 16;      // segments staged a query
  static constexpr int SS = SB + 1;  // staging row stride
  static constexpr size_t STATE_BYTES = (size_t)wg::CONSUMERS * wg::WG_Q * SS * 8;

  const wg::Args& a;
  float* st_d;
  int* st_i;
  int wgi, wt, tq, qa;  // qa: query A's row in the warpgroup's 64
  int q0, hi, staged, sbase;
  int ex[2];               // queries A and B's excluded rows (-1: none)
  float rb[2];             // the running pairs
  int ri[2];

  __device__ EmitSelectWG(const wg::Args& a_, unsigned char* state, int wgi_, int wt_)
      : a(a_), wgi(wgi_), wt(wt_), tq(wt_ & 3),
        qa(16 * (wt_ >> 5) + ((wt_ & 31) >> 2)) {
    st_d = reinterpret_cast<float*>(state) + wgi * wg::WG_Q * SS;
    st_i = reinterpret_cast<int*>(state + wg::CONSUMERS * wg::WG_Q * SS * 4) + wgi * wg::WG_Q * SS;
  }

  __device__ void begin(int q0_, int lo, int hi_) {
    q0 = q0_;
    hi = hi_;
    staged = 0;
    sbase = lo / a.seg;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qi = q0 + qa + 8 * i;
      ex[i] = (a.excl && qi < a.m) ? a.excl[qi] : -1;
      rb[i] = pos_inf();
      ri[i] = lo + 2 * tq;
    }
  }

  // the warpgroup writes its staged pairs out
  __device__ void flush() {
    wg::named_sync(1 + wgi, wg::WG);
    for (int e = wt; e < wg::WG_Q * SB; e += wg::WG) {
      const int r = e / SB, sl = e % SB;
      const int qi = q0 + r, s = sbase + sl;
      if (sl < staged && qi < a.m && s < a.n_seg) {
        a.seg_d[(long long)qi * a.n_seg + s] = st_d[r * SS + sl];
        a.seg_i[(long long)qi * a.n_seg + s] = st_i[r * SS + sl];
      }
    }
    wg::named_sync(1 + wgi, wg::WG);
    sbase += staged;
    staged = 0;
  }

  // the running pairs are a segment's: the quad's minimum into the staging
  __device__ void finish_segment() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const float od = __shfl_xor_sync(0xffffffffu, rb[i], off);
        const int oi = __shfl_xor_sync(0xffffffffu, ri[i], off);
        if (lex_less(od, oi, rb[i], ri[i])) { rb[i] = od; ri[i] = oi; }
      }
      if (tq == i) {
        st_d[(qa + 8 * i) * SS + staged] = rb[i];
        st_i[(qa + 8 * i) * SS + staged] = ri[i];
      }
    }
    ++staged;
  }

  // one step of the running pairs: query i's column c (8 j + b of the
  // stage) scores v
  __device__ __forceinline__ static void step(float v, int c, float& b, int& bc) {
    if (v < b) { b = v; bc = c; }
  }

  // a stage of segments of SEGJ column groups (seg = 8 SEGJ < 256 rows)
  template <int SEGJ>
  __device__ __forceinline__ void short_segments(const float (&acc)[128], const float* nq,
                                                 int t0) {
#pragma unroll
    for (int j0 = 0; j0 < 32; j0 += SEGJ) {
      float b0 = pos_inf(), b1 = pos_inf();
      int c0 = 8 * j0, c1 = 8 * j0;
#pragma unroll
      for (int j = j0; j < j0 + SEGJ; ++j) {
        const float2 nn = *reinterpret_cast<const float2*>(nq + 8 * j);
        step(fmaf(-2.0f, acc[4 * j], nn.x), 8 * j, b0, c0);
        step(fmaf(-2.0f, acc[4 * j + 1], nn.y), 8 * j + 1, b0, c0);
        step(fmaf(-2.0f, acc[4 * j + 2], nn.x), 8 * j, b1, c1);
        step(fmaf(-2.0f, acc[4 * j + 3], nn.y), 8 * j + 1, b1, c1);
      }
      rb[0] = b0;
      rb[1] = b1;
      ri[0] = t0 + 2 * tq + c0;
      ri[1] = t0 + 2 * tq + c1;
      finish_segment();
      // seg = 8: 32 segments a stage, the staging is full halfway
      if (SEGJ == 1 && j0 == 15) flush();
    }
  }

  // a stage inside a segment of 256 rows or more: the running pairs go on
  __device__ __forceinline__ void long_segment(const float (&acc)[128], const float* nq, int t0) {
    if ((t0 & (a.seg - 1)) == 0) {
      rb[0] = rb[1] = pos_inf();
      ri[0] = ri[1] = t0 + 2 * tq;
    }
    float b0 = rb[0], b1 = rb[1];
    int c0 = -1, c1 = -1;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float2 nn = *reinterpret_cast<const float2*>(nq + 8 * j);
      step(fmaf(-2.0f, acc[4 * j], nn.x), 8 * j, b0, c0);
      step(fmaf(-2.0f, acc[4 * j + 1], nn.y), 8 * j + 1, b0, c0);
      step(fmaf(-2.0f, acc[4 * j + 2], nn.x), 8 * j, b1, c1);
      step(fmaf(-2.0f, acc[4 * j + 3], nn.y), 8 * j + 1, b1, c1);
    }
    rb[0] = b0;
    rb[1] = b1;
    if (c0 >= 0) ri[0] = t0 + 2 * tq + c0;
    if (c1 >= 0) ri[1] = t0 + 2 * tq + c1;
    if (((t0 + wg::ROWS) & (a.seg - 1)) == 0 || t0 + wg::ROWS >= hi) finish_segment();
  }

  __device__ void tile(float (&acc)[128], const float* nq, int t0) {
    // a query's excluded row in this stage: its products become -inf, so
    // its score is +inf, as a row past n scores with its +inf norm
    if ((unsigned)(ex[0] - t0) < (unsigned)wg::ROWS ||
        (unsigned)(ex[1] - t0) < (unsigned)wg::ROWS) {
      const int xa = ex[0] - t0 - 2 * tq, xb = ex[1] - t0 - 2 * tq;
#pragma unroll
      for (int j = 0; j < 32; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (8 * j + (e & 1) == ((e >> 1) ? xb : xa)) acc[4 * j + e] = -pos_inf();
    }
    switch (a.seg) {
      case 8: short_segments<1>(acc, nq, t0); break;
      case 16: short_segments<2>(acc, nq, t0); break;
      case 32: short_segments<4>(acc, nq, t0); break;
      case 64: short_segments<8>(acc, nq, t0); break;
      case 128: short_segments<16>(acc, nq, t0); break;
      default: long_segment(acc, nq, t0); break;
    }
    if (staged == SB || t0 + wg::ROWS >= hi) flush();
  }
};

// Emit's selection step for the tile loop: warp w takes queries QPW w ..
// QPW w + QPW - 1 and keeps their excluded ids and (seg >= TN) running
// segment minima in registers; the pairs go to seg_d/seg_i (m, n_seg), so
// there is no state in shared memory and nothing to finish.
template <typename T>
struct EmitSelect {
  using S_t = typename Tr<T>::S;
  static constexpr bool PN = false;     // no precomputed norms
  static constexpr bool NORMS = true;   // norms of the values in the slot
  static size_t state_bytes(int) { return 0; }

  int q0, m, seg, n_seg, warp, lane;
  float* seg_d;
  int* seg_i;
  int ex[tile::QPW], ri[tile::QPW];
  float rd[tile::QPW];  // seg >= TN: the running minimum of the segment

  __device__ EmitSelect(const tile::TiledArgs& a, unsigned char*, int q0_)
      : q0(q0_), m(a.m), seg(a.seg), n_seg((a.n + a.seg - 1) / a.seg),
        warp(threadIdx.x >> 5), lane(threadIdx.x & 31), seg_d(a.part_d), seg_i(a.part_i) {
#pragma unroll
    for (int i = 0; i < tile::QPW; ++i) {
      const int qi = q0 + tile::QPW * warp + i;
      ex[i] = (a.excl && qi < m) ? a.excl[qi] : -1;
      rd[i] = pos_inf();
      ri[i] = ID_NONE;
    }
  }

  __device__ float score(S_t dot, S_t norm, float, int, int) const {
    return Tr<T>::score(norm, dot);
  }

  // segment s's pair of query qi, from the lanes that hold it
  __device__ void put(int qi, int s, float v, int id) const {
    seg_d[(long long)qi * n_seg + s] = v;
    seg_i[(long long)qi * n_seg + s] = id;
  }

  __device__ void select(const float* S, int t0, int hi) {
    const int id0 = t0 + lane;  // lane's row of the tile's first 32-row chunk
#pragma unroll
    for (int i = 0; i < tile::QPW; ++i) {
      const int qq = tile::QPW * warp + i;
      const int qi = q0 + qq;
      if (qi >= m) break;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // rows past the tile's end hold what an earlier tile left; a NaN
        // score (a NaN or an infinite coordinate) counts as +inf
        const float s = S[qq * tile::SS + lane + 32 * j];
        v[j] = (id0 + 32 * j < hi && id0 + 32 * j != ex[i] && s == s) ? s : pos_inf();
      }
      if (seg >= TN) {
        // the tile lies inside one segment: fold its minimum into the
        // running pair, and write the pair where the segment or split ends
        float bd = v[0];
        int bi = id0;
#pragma unroll
        for (int j = 1; j < 4; ++j)
          if (lex_less(v[j], id0 + 32 * j, bd, bi)) { bd = v[j]; bi = id0 + 32 * j; }
        warp_lex_min(bd, bi, 32);
        if (lex_less(bd, bi, rd[i], ri[i])) { rd[i] = bd; ri[i] = bi; }
        if ((t0 + TN) % seg == 0 || t0 + TN >= hi) {
          if (lane == 0) put(qi, t0 / seg, rd[i], ri[i]);
          rd[i] = pos_inf();
          ri[i] = ID_NONE;
        }
      } else if (seg >= 32) {
        // a segment is seg / 32 (1 or 2) of the lane's rows, one a chunk
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (seg == 64 && (j & 1)) continue;
          float bd = v[j];
          int bi = id0 + 32 * j;
          if (seg == 64) {
            const int j2 = (j + 1) & 3;  // j + 1: j is even here
            if (lex_less(v[j2], id0 + 32 * j2, bd, bi)) { bd = v[j2]; bi = id0 + 32 * j2; }
          }
          warp_lex_min(bd, bi, 32);
          if (lane == 0 && t0 + 32 * j < hi) put(qi, (t0 + 32 * j) / seg, bd, bi);
        }
      } else {
        // a segment is `seg` neighbouring lanes of one 32-row chunk
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float bd = v[j];
          int bi = id0 + 32 * j;
          warp_lex_min(bd, bi, seg);
          if ((lane & (seg - 1)) == 0 && id0 + 32 * j < hi) put(qi, (id0 + 32 * j) / seg, bd, bi);
        }
      }
    }
  }

  __device__ void finish(int, int) const {}
};

// Rescan: block (query qi, split s) takes windows [s * per, min((s + 1) *
// per, P)) of the query's P.  starts (m, P): the first row of each window,
// n for an exhausted pick; window p covers local rows [p * seg, (p + 1) *
// seg).  k > 0: the k nearest of the split into out at ((qi * splits + s)
// * k) (one split: the result); k == 0: every local row's (distance, id)
// into out (m, P * seg), +inf and id n where the row does not exist.  Rows
// of nvec V-byte vectors, lane groups of G.
template <typename T, int V>
__global__ void __launch_bounds__(NT, (gather::min_blocks<T, V, false>()))
rescan_kernel(const T* __restrict__ pts, const float* __restrict__ q,
              const int* __restrict__ starts, int n, int d, int nvec, int G, int P,
              int per, int seg_log, int k, float* __restrict__ out_d,
              int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qv = reinterpret_cast<float*>(smem);   // [d]
  int* St = reinterpret_cast<int*>(Qv + d);      // [per]
  float* topd = reinterpret_cast<float*>(St + per);  // [NW][k]
  int* topi = reinterpret_cast<int*>(topd + NW * k);  // [NW][k]

  const int qi = blockIdx.x, split = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int seg = 1 << seg_log;
  const int p0 = split * per;
  const int np = min(per, P - p0);
  const int L = np << seg_log;
  for (int c = tid; c < d; c += NT) Qv[c] = (float)Tr<T>::qv(q[(long long)qi * d + c]);
  for (int p = tid; p < np; p += NT) St[p] = starts[(long long)qi * P + p0 + p];
  for (int e = tid; e < NW * k; e += NT) { topd[e] = pos_inf(); topi[e] = ID_NONE; }
  __syncthreads();

  const gather::RowScorer<T, V> sc(pts, Qv, nvec, G, lane);
  float* ld = topd + warp * k;
  int* li = topi + warp * k;
  float wd = pos_inf();
  int wi = ID_NONE;
  // warp w scores the 32-row batches w, w + NW, ...; lane r keeps row r's result
  for (int l0 = warp * 32; l0 < L; l0 += NW * 32) {
    const int l = l0 + lane;
    int row = -1;
    if (l < L) {
      const int s = St[l >> seg_log];
      const int o = l & (seg - 1);
      if (s < n && o < n - s) row = s + o;
    }
    const float dist = sc.score_batch(row);
    const float my_d = row >= 0 ? dist : pos_inf();
    const int my_i = row >= 0 ? row : n;
    if (k == 0) {
      if (l < L) {
        const long long o = (long long)qi * ((long long)P << seg_log) +
                            ((long long)p0 << seg_log) + l;
        out_d[o] = my_d;
        out_i[o] = my_i;
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
  const long long base = ((long long)qi * gridDim.y + split) * k;
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
      const bool real = bd < pos_inf();
      out_d[base + j] = real ? bd : pos_inf();
      out_i[base + j] = real ? bi : n;
    }
    if (lane == bl) {
      ++head;
      if (head < k) { hd = topd[lane * k + head]; hid = topi[lane * k + head]; }
      else { hd = pos_inf(); hid = ID_NONE; }
    }
  }
}

template <typename T, int TIER = TIER_HIGHEST>
int emit(const void* pts, const float* q, const int* excl, int n, int d, int m, int seg,
         int splits, float* seg_d, int* seg_i, cudaStream_t stream) {
  tile::TiledArgs a{pts, q, nullptr, nullptr, excl, n, d, m, 0, 0, 0, 0, seg_d, seg_i, seg};
  // a split takes whole segments
  return (int)tile::launch_tiled<T, EmitSelect<T>, TIER>(a, splits, seg > TN ? seg / TN : 1,
                                                         stream);
}

// Emit on the Hopper pipeline (bf16 / f16): the plan of the wrapper
// (ops/twophase.py:emit_plan) gives split_rows, stages and blocks.
template <typename T>
int emit_wgmma(const void* pts, const float* q, const int* excl, int n, int d, int m, int seg,
               int n_seg, int split_rows, int stages, int blocks, float* seg_d, int* seg_i,
               cudaStream_t stream) {
  const int n_qb = (m + wg::BLOCK_Q - 1) / wg::BLOCK_Q;
  const long long units = (long long)n_qb * ((n + (long long)split_rows - 1) / split_rows);
  if (units > INT32_MAX || blocks > units) return (int)cudaErrorInvalidValue;
  const wg::Args a{q, excl, seg_d, seg_i, n, d, m, seg, n_seg, (d + 15) / 16,
                   (d + wg::CHUNK - 1) / wg::CHUNK, stages, n_qb, (int)units, split_rows};
  return (int)wg::launch<T, EmitSelectWG<T>>(pts, a, blocks, stream);
}

template <typename T>
struct RescanLaunch {
  const void* pts;
  const float* q;
  const int* starts;
  int n, d, nvec, G, m, P, per, splits, seg_log, k;
  float *out_d, *part_d;
  int *out_i, *part_i;
  cudaStream_t stream;

  template <int V>
  cudaError_t run() {
    const size_t smem = sizeof(float) * (size_t)d + sizeof(int) * (size_t)per +
                        (sizeof(float) + sizeof(int)) * (size_t)NW * k;
    cudaError_t err = cudaFuncSetAttribute(rescan_kernel<T, V>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    // several selecting splits write their lists to part, merged after
    const bool merge = k > 0 && splits > 1;
    rescan_kernel<T, V><<<dim3(m, splits), NT, smem, stream>>>(
        static_cast<const T*>(pts), q, starts, n, d, nvec, G, P, per, seg_log, k,
        merge ? part_d : out_d, merge ? part_i : out_i);
    err = cudaGetLastError();
    if (err != cudaSuccess || !merge) return err;
    return launch_split_merge(part_d, part_i, nullptr, n, m, k, splits, 1.0f, out_d, out_i,
                              stream);
  }
};

// resident blocks of one rescan instantiation on an SM (by its registers
// and threads; shared memory is small), for the wrapper's split count
template <typename T>
struct RescanOccupancy {
  int* blocks;

  template <int V>
  cudaError_t run() {
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, rescan_kernel<T, V>, NT, 0);
  }
};

template <typename T>
int rescan(const void* pts, const float* q, const int* starts, int n, int d, int m, int P,
           int seg_log, int k, int V, int G, int splits, float* out_d, int* out_i,
           float* part_d, int* part_i, cudaStream_t stream) {
  if (!gather::geometry_ok(d, (int)sizeof(T), V, G) ||
      reinterpret_cast<uintptr_t>(pts) % V || (k > 0 && splits > 1 && (!part_d || !part_i)))
    return (int)cudaErrorInvalidValue;
  const int nvec = (int)((long long)d * sizeof(T) / V);
  const int per = (P + splits - 1) / splits;
  // splits that would hold no window are not launched: the caller sizes
  // part for ceil(P / per) of them
  if ((P + per - 1) / per != splits) return (int)cudaErrorInvalidValue;
  RescanLaunch<T> f{pts, q, starts, n, d, nvec, G, m, P, per, splits, seg_log, k,
                    out_d, part_d, out_i, part_i, stream};
  return (int)gather::dispatch<T>(V, f);
}

bool pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

}  // namespace

extern "C" {

// device: the CUDA ordinal of every pointer.  dtype: 0 = float32,
// 1 = bfloat16, 2 = float16, 3 = int8.  tier: 0 = "highest", 1 = "split3",
// 2 = "default" (float32 only; other types take 0).  All pointers are
// device pointers, pts 16-byte aligned; excl may be null.  seg (a power of
// two) rows a segment; seg_d/seg_i hold m * n_seg entries, n_seg =
// ceil(n / seg); splits (<= 32) corpus ranges.  Returns the CUDA error code
// (0 = launched).
int twophase_emit_launch(int device, const void* pts, int dtype, int tier, const float* q,
                         const int* excl, int n, int d, int m, int seg, int n_seg,
                         int splits, float* seg_d, int* seg_i, void* stream) {
  if (!pow2(seg) || n < 1 || d < 1 || m < 1 || splits < 1 || splits > MAX_SPLITS ||
      n_seg != (int)(((long long)n + seg - 1) / seg) || reinterpret_cast<uintptr_t>(pts) % 16 ||
      !knn::tier_ok(dtype, tier))
    return (int)cudaErrorInvalidValue;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return knn::with_tier(tier, [&](auto t) {
        return emit<float, decltype(t)::value>(pts, q, excl, n, d, m, seg, splits, seg_d, seg_i, s);
      });
    case 1: return emit<__nv_bfloat16>(pts, q, excl, n, d, m, seg, splits, seg_d, seg_i, s);
    case 2: return emit<__half>(pts, q, excl, n, d, m, seg, splits, seg_d, seg_i, s);
    case 3: return emit<int8_t>(pts, q, excl, n, d, m, seg, splits, seg_d, seg_i, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The emit on the Hopper pipeline (knn_wgmma.cuh): dtype 1 (bfloat16) or 2
// (float16), d a multiple of 8 in [8, 128], seg a power of two >= 8.  The
// corpus is cut into splits of split_rows rows (a multiple of max(seg,
// 256)), each with every block of 128 queries a work unit; `blocks`
// persistent blocks (at most the units) of `stages` ring stages walk them.
// Returns the CUDA error code (0 = launched).
int twophase_emit_wgmma_launch(int device, const void* pts, int dtype, const float* q,
                               const int* excl, int n, int d, int m, int seg, int n_seg,
                               int split_rows, int stages, int blocks, float* seg_d,
                               int* seg_i, void* stream) {
  if (!pow2(seg) || seg < 8 || n < 1 || m < 1 || d < 8 || d % 8 ||
      d > wg::MAX_CHUNKS * wg::CHUNK || n_seg != (int)(((long long)n + seg - 1) / seg) ||
      reinterpret_cast<uintptr_t>(pts) % 16 || split_rows < 1 ||
      split_rows % (seg > wg::ROWS ? seg : wg::ROWS) || stages < wg::MIN_STAGES ||
      stages > wg::MAX_STAGES || blocks < 1)
    return (int)cudaErrorInvalidValue;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1: return emit_wgmma<__nv_bfloat16>(pts, q, excl, n, d, m, seg, n_seg, split_rows, stages, blocks, seg_d, seg_i, s);
    case 2: return emit_wgmma<__half>(pts, q, excl, n, d, m, seg, n_seg, split_rows, stages, blocks, seg_d, seg_i, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// starts (m, P) int32: window first rows, n = exhausted.  seg = 1 << seg_log.
// k in [1, 128]: out_d/out_i hold m * k entries; k == 0 (emit all): m * P * seg.
// The scorer's geometry (knn_gather.cuh): vec bytes a load, lanes a group.
// splits (<= 32, each taking ceil(P /
// splits) windows, none empty) blocks a query; with k > 0 and more than one,
// part_d/part_i hold m * splits * k entries for the split lists.
int twophase_rescan_launch(int device, const void* pts, int dtype, const float* q,
                           const int* starts, int n, int d, int m, int P, int seg_log,
                           int k, int vec, int lanes, int splits, float* out_d,
                           int* out_i, float* part_d, int* part_i, void* stream) {
  if (k < 0 || k > knn::KMAX || n < 1 || d < 1 || m < 1 || P < 1 || seg_log < 0 ||
      seg_log > 30 || ((long long)P << seg_log) >= (1LL << 31) || splits < 1 ||
      splits > MAX_SPLITS || splits > P)
    return (int)cudaErrorInvalidValue;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return rescan<float>(pts, q, starts, n, d, m, P, seg_log, k, vec, lanes, splits, out_d, out_i, part_d, part_i, s);
    case 1: return rescan<__nv_bfloat16>(pts, q, starts, n, d, m, P, seg_log, k, vec, lanes, splits, out_d, out_i, part_d, part_i, s);
    case 2: return rescan<__half>(pts, q, starts, n, d, m, P, seg_log, k, vec, lanes, splits, out_d, out_i, part_d, part_i, s);
    case 3: return rescan<int8_t>(pts, q, starts, n, d, m, P, seg_log, k, vec, lanes, splits, out_d, out_i, part_d, part_i, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// resident rescan blocks an SM holds for this dtype and load width (-1 for
// a width the kernel does not take), on the current device
int twophase_rescan_blocks_per_sm(int dtype, int vec) {
  int blocks = -1;
  cudaError_t err = cudaErrorInvalidValue;
  switch (dtype) {
    case 0: { RescanOccupancy<float> f{&blocks}; err = gather::dispatch<float>(vec, f); break; }
    case 1: { RescanOccupancy<__nv_bfloat16> f{&blocks}; err = gather::dispatch<__nv_bfloat16>(vec, f); break; }
    case 2: { RescanOccupancy<__half> f{&blocks}; err = gather::dispatch<__half>(vec, f); break; }
    case 3: { RescanOccupancy<int8_t> f{&blocks}; err = gather::dispatch<int8_t>(vec, f); break; }
    default: break;
  }
  return err == cudaSuccess ? blocks : -1;
}

// emit's geometry (the tile loop's): queries per block and corpus rows per tile
int twophase_knn_query_block() { return knn::tile::QB; }
int twophase_knn_tile_rows() { return knn::TN; }

// the Hopper emit's geometry: queries a work unit, corpus rows a ring
// stage, and the shared memory a block of `stages` stages of `chunks`
// 32-feature chunks takes
int twophase_emit_wgmma_query_block() { return knn::wg::BLOCK_Q; }
int twophase_emit_wgmma_tile_rows() { return knn::wg::ROWS; }
int twophase_emit_wgmma_smem(int stages, int chunks) {
  return (int)knn::wg::smem_bytes(stages, chunks, EmitSelectWG<__nv_bfloat16>::STATE_BYTES);
}

const char* twophase_knn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
