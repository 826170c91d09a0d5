// The corpus tile ring of the tensor-core exact-kNN kernels: the one copy
// routine that fills a shared-memory slot with corpus rows by asynchronous
// copies (cp.async) at knn_mma.cuh's padded row stride (streaming kernel,
// rank kernel, rescan merge, two-phase emit), and the tile loop that the
// rank kernel (exact_knn.cu), the rescan merge (rescan_merge_knn.cu) and the
// two-phase emit (twophase_knn.cu) share; they differ only in the selection
// step they hand it.
//
// The tile loop.  Grid (query blocks of QB queries) x (corpus splits).  A
// block of NW multiplying warps and NP copying warps walks its split's
// 128-row tiles through an n_buf-deep ring:
//   * copying warps start nothing but the ring's copies (a warp that starts
//     a tile's copies stalls on the memory system about as long as they
//     take, see stream_knn.cu);
//   * each multiplying warp takes 16 of the tile's rows against the
//     block's QB queries through tile_mma<T, QB / 8, TIER>: for float32 at
//     "highest" every corpus value's split into TF32 halves feeds QB / 8 x
//     3 MMAs, at "split3" a pair of K steps' bf16 halves feed QB / 8 x 3
//     m16n8k16 MMAs, at "default" their bf16 values QB / 8 (knn_mma.cuh);
//     TIER is a compile-time parameter beside T, so each tier is a kernel
//     of its own and "highest" is the code it always was;
//   * the C fragments go, turned into scores, to a padded array S
//     [QB][TN + 4] (conflict-free stores), where the selection step reads
//     them: the rank kernel one query's 128 scores per warp and pass, the
//     rescan merge its four queries' 128 distances, emit its four queries'
//     128 scores for their segment minima;
//   * there are two S, for even and odd tiles, so that one barrier a ring
//     item is enough: it says that S is written, that the next item has
//     landed and that this one's slot may be overwritten, and a warp may
//     multiply the next tile while another still selects from this one.
// Where a whole row does not fit (two slots of 128 rows beside the query
// fragments, S and the top-k lists), tiles go in feature chunks of kc K
// steps: a ring item is one chunk of one tile, its slot also holds that
// chunk's query fragments (made by the copying warps), and the chunks'
// dot products are summed in fp32 (int32 for int8) in registers.  Any d
// runs.
//
// Build: included by the kernel sources; see exact_knn.cu.

#pragma once

#include "knn_mma.cuh"

namespace knn {

constexpr int SMEM_MAX = 232448;  // dynamic shared memory a block may use

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
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
    default: cp_async_wait<6>(); break;
  }
}

// Corpus rows into a ring slot, row r of the slot at r * stride words: up
// to span bytes of each row, the rows pitch bytes apart in the source.
// Copies go in 16-byte units where pitch is a multiple of 16 (d a multiple
// of 4 floats, 8 halves, 16 int8; the caller aligns the corpus base to 16
// bytes, and span and a chunk's start are multiples of 32), else in 4-byte
// units where it is a multiple of 4, else (odd d in halves, other d in
// int8) by plain byte loads and stores.  Thread ctid of the NTH copying
// threads takes units ctid, ctid + NTH, ... of span-byte rows: its first
// unit (row0, u0) and its step (drow, du) are worked out once here; a copy
// turns them into byte offsets and steps, so that its loop only adds.
template <int NTH>
struct TileCopy {
  int pitch, stride_bytes, unit, upr, row0, u0, drow, du;

  __device__ TileCopy(int pitch_, int span, int stride_words, int ctid)
      : pitch(pitch_), stride_bytes(4 * stride_words),
        unit(pitch_ % 16 == 0 ? 16 : (pitch_ % 4 == 0 ? 4 : 1)) {
    upr = span / unit;
    row0 = ctid / upr;
    u0 = ctid % upr;
    drow = NTH / upr;
    du = NTH % upr;
  }

  template <int UNIT>
  __device__ __forceinline__ void copy_units(unsigned char* dst, const unsigned char* src,
                                             int rows, int cbytes, int ctid) const {
    unsigned char* to = dst + row0 * stride_bytes + u0 * UNIT;
    const unsigned char* from = src + (long long)row0 * pitch + u0 * UNIT;
    const int to_step = drow * stride_bytes + du * UNIT, to_wrap = stride_bytes - upr * UNIT;
    const long long from_step = (long long)drow * pitch + du * UNIT;
    const int from_wrap = pitch - upr * UNIT;
    const int units = rows * upr, ulim = cbytes / UNIT;
    int u = u0;
    for (int e = ctid; e < units; e += NTH) {
      if (u < ulim) {
        if constexpr (UNIT == 16) cp_async16(to, from);
        else if constexpr (UNIT == 4) cp_async4(to, from);
        else *to = *from;
      }
      u += du;
      to += to_step;
      from += from_step;
      if (u >= upr) { u -= upr; to += to_wrap; from += from_wrap; }
    }
  }

  // Bytes [0, cbytes) (cbytes <= span) of rows [0, rows) from src (the
  // first row's first byte to copy) into dst.  Starts the copies; the
  // caller commits them.
  __device__ __forceinline__ void copy(uint32_t* dst, const unsigned char* src, int rows,
                                       int cbytes, int ctid) const {
    unsigned char* d8 = reinterpret_cast<unsigned char*>(dst);
    if (unit == 16) copy_units<16>(d8, src, rows, cbytes, ctid);
    else if (unit == 4) copy_units<4>(d8, src, rows, cbytes, ctid);
    else copy_units<1>(d8, src, rows, cbytes, ctid);
  }
};

// Zero bytes [from, to) of `rows` slot rows stride words apart: a row's
// bytes past its last value up to its last whole K step, which no copy
// writes.  Thread tid of nthreads.
__device__ __forceinline__ void zero_row_ends(uint32_t* base, int rows, int stride, int from,
                                              int to, int tid, int nthreads) {
  const int pad = to - from;
  if (pad == 0) return;
  if (pad % 4 == 0 && from % 4 == 0) {
    const int pw = pad / 4;
    for (int e = tid; e < rows * pw; e += nthreads)
      base[(e / pw) * stride + from / 4 + e % pw] = 0u;
  } else {
    unsigned char* b8 = reinterpret_cast<unsigned char*>(base);
    for (int e = tid; e < rows * pad; e += nthreads)
      b8[(e / pad) * stride * 4 + from + e % pad] = 0;
  }
}

// -- the tile loop of the rank kernel, the rescan merge and emit -------------

namespace tile {

constexpr int QB = 32;               // queries per block: four MMA query groups
constexpr int NQ = QB / MMA_QUERIES;
constexpr int QPW = QB / NW;         // queries a multiplying warp selects for
constexpr int SS = TN + 4;           // row stride of S: 4 (mod 32) words
constexpr int NP = 4;                // copying warps, after the NW multiplying ones
constexpr int NPT = 32 * NP;         // copying threads
constexpr int NTS = NT + NPT;        // threads per block
constexpr int MAX_BUF = 8;           // deepest ring
static_assert(TN == MMA_ROWS * NW, "a multiplying warp takes 16 rows of a tile");
static_assert(NPT >= TN, "a copying thread copies one norm of a tile");

// Sum of squares of the values packed in one 32-bit word of storage type T.
template <typename T>
__device__ __forceinline__ void add_squares(uint32_t w, typename Tr<T>::S& acc) {
  if constexpr (std::is_same<T, float>::value) {
    const float v = __uint_as_float(w);
    acc = fmaf(v, v, acc);
  } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const float lo = __uint_as_float(w << 16), hi = __uint_as_float(w & 0xffff0000u);
    acc = fmaf(hi, hi, fmaf(lo, lo, acc));
  } else if constexpr (std::is_same<T, __half>::value) {
    const float lo = __half2float(__ushort_as_half((unsigned short)(w & 0xffffu)));
    const float hi = __half2float(__ushort_as_half((unsigned short)(w >> 16)));
    acc = fmaf(hi, hi, fmaf(lo, lo, acc));
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int v = (int)(int8_t)(w >> (8 * i));
      acc += v * v;
    }
  }
}

// Words of shared memory of one ring slot: TN rows of a kc-K-step chunk at
// the padded stride, then (feature chunks only) the chunk's query fragments.
template <typename T, int TIER>
__host__ __device__ inline int tiled_slot_words(int kc, bool chunked) {
  return TN * (KSTEP_WORDS * kc + 4) + (chunked ? fragment_words<T, TIER>(NQ, kc) : 0);
}

// Bytes of dynamic shared memory of the tile loop: the ring (and a norm
// slice a slot where the kernel takes its norms in, K::PN), the query
// fragments held for the whole call (one chunk only), the two S, and the
// selection's own state (K::state_bytes).
template <typename T, class K, int TIER>
size_t tiled_smem(int ksteps, int kc, int n_buf, int k) {
  const bool chunked = kc < ksteps;
  return 4 * ((size_t)n_buf * (tiled_slot_words<T, TIER>(kc, chunked) + (K::PN ? TN : 0)) +
              (chunked ? 0 : fragment_words<T, TIER>(NQ, ksteps)) + (size_t)2 * QB * SS) +
         K::state_bytes(k);
}

// Pointers and sizes a launch hands the tile loop.
struct TiledArgs {
  const void* pts;
  const float* q;    // (m, d) float32, quantised for int8
  const float* qn;   // (m,) |q|^2 (rescan merge) or null
  const float* pn;   // (n,) |x|^2 of the unrounded corpus (rescan merge) or null
  const int* excl;   // (m,) or null
  int n, d, m, k;
  int tiles_per_split;
  int kc;            // K steps per feature chunk (all of a row's: one chunk)
  int n_buf;         // ring slots
  float* part_d;     // (m, splits, k) partial lists, or emit's (m, n_seg) minima
  int* part_i;
  int seg;           // emit: rows per segment
};

// The tile loop (see the top of this file) at precision tier TIER (float32
// only; knn_mma.cuh).  K is the selection step:
//   K::PN                  copy pn's slice of each tile into the ring
//   K::state_bytes(k)      its shared memory after S
//   K(args, state, q0)     per-thread set-up (state zeroed or filled there)
//   k.score(dot, norm, pn, j, b)  what S holds for (row, query 8 j + 2 (lane % 4) + b)
//                          from the dot product and the row's streamed norm or pn
//   k.select(S, t0, hi)    after a tile's S is written: whole multiplying warp
//   k.finish(split, splits) write this warp's queries' partial lists
template <typename T, class K, int TIER>
__global__ void __launch_bounds__(NTS, 1) tiled_kernel(const TiledArgs a) {
  using S_t = typename Tr<T>::S;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ksteps = row_words(a.d, sizeof(T)) / KSTEP_WORDS;
  const int kc = a.kc;
  const int nc = (ksteps + kc - 1) / kc;  // chunks per tile
  const bool chunked = nc > 1;
  const int stride = KSTEP_WORDS * kc + 4;
  const int slot_words = tiled_slot_words<T, TIER>(kc, chunked);
  const int n_buf = a.n_buf;
  uint32_t* ring = reinterpret_cast<uint32_t*>(smem);                            // [n_buf][slot]
  float* pn_ring = reinterpret_cast<float*>(ring + n_buf * slot_words);          // [n_buf][TN]
  uint32_t* qf_all = reinterpret_cast<uint32_t*>(pn_ring + (K::PN ? n_buf * TN : 0));
  float* Sm =
      reinterpret_cast<float*>(qf_all + (chunked ? 0 : fragment_words<T, TIER>(NQ, ksteps)));
  unsigned char* state = reinterpret_cast<unsigned char*>(Sm + 2 * QB * SS);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool copier = warp >= NW;
  const int q0 = blockIdx.x * QB;
  const long long lo_ll = (long long)blockIdx.y * a.tiles_per_split * TN;
  const long long hi_ll = lo_ll + (long long)a.tiles_per_split * TN;
  const int lo = (int)(lo_ll < a.n ? lo_ll : a.n);
  const int hi = (int)(hi_ll < a.n ? hi_ll : a.n);
  const int n_items = (hi - lo + TN - 1) / TN * nc;
  const int row_bytes = a.d * (int)sizeof(T);
  const unsigned char* src = static_cast<const unsigned char*>(a.pts);
  // a chunk's bytes of each row: all chunks but a row's last take kc K
  // steps, the last what is left
  const int kc_last = ksteps - (nc - 1) * kc;
  const int cb_last = row_bytes - (nc - 1) * 4 * KSTEP_WORDS * kc;
  const int ctid = tid - NT;  // a copier's index among the NPT copying threads
  // one copy geometry for every chunk: a row's last chunk copies fewer of
  // its units
  const TileCopy<NPT> tc(row_bytes, 4 * KSTEP_WORDS * kc, stride, ctid);

  // item i = chunk i % nc of tile i / nc, into slot i % n_buf, and one
  // commit group, empty past the last item.  Copiers only.
  auto copy_item = [&](int i) {
    if (i < n_items) {
      uint32_t* slot = ring + (i % n_buf) * slot_words;
      const int c = i % nc;
      const int r0 = lo + (i / nc) * TN;
      const int rows = hi - r0 < TN ? hi - r0 : TN;
      const bool last = c == nc - 1;
      tc.copy(slot, src + (long long)r0 * row_bytes + 4 * KSTEP_WORDS * kc * c, rows,
              last ? cb_last : 4 * KSTEP_WORDS * kc, ctid);
      // a full chunk wrote this slot's bytes past the last chunk's end
      if (chunked && last)
        zero_row_ends(slot, rows, stride, cb_last, 4 * KSTEP_WORDS * kc_last, ctid, NPT);
      // the norms are read with the tile's last chunk
      if (K::PN && last && ctid < rows)
        cp_async4(pn_ring + (i % n_buf) * TN + ctid, a.pn + r0 + ctid);
      if (chunked)
        stage_query_fragments<T, NQ, TIER>(a.q, q0, a.m, a.d, c * kc, last ? kc_last : kc,
                                           slot + TN * stride, ctid, NPT);
    }
    cp_async_commit();
  };
  if (copier)  // warm-up: n_buf - 1 items in flight
    for (int i = 0; i < n_buf - 1; ++i) copy_item(i);
  // whole rows: the bytes past a row's end are zeroed once, in every slot
  if (!chunked)
    zero_row_ends(ring, n_buf * TN, stride, row_bytes, 4 * KSTEP_WORDS * ksteps, tid, NTS);
  if (!chunked)
    stage_query_fragments<T, NQ, TIER>(a.q, q0, a.m, a.d, 0, ksteps, qf_all, tid, NTS);
  K sel(a, state, q0);
  cp_async_wait_pending(n_buf - 2);  // a copier's copies of item 0 landed
  __syncthreads();                   // and every copier's; the set-up is done

  const int g = lane >> 2, tq = lane & 3;
  const int wrow = MMA_ROWS * warp;  // this warp's first row of a tile
  S_t acc[NQ][4];
  S_t nrm = S_t(0);  // K::NORMS: lane's part of row wrow + (lane & 15)'s |x|^2
  for (int i = 0; i < n_items; ++i) {
    // Item i is in its slot and item i - 1 is consumed: the barrier of
    // iteration i - 1 said both.
    const int c = i % nc;
    const int t0 = lo + (i / nc) * TN;
    const int rows = hi - t0 < TN ? hi - t0 : TN;
    float* S = Sm + ((i / nc) & 1) * (QB * SS);  // two S: one written while the other is read
    if (copier) {
      copy_item(i + n_buf - 1);          // into item i - 1's slot
      cp_async_wait_pending(n_buf - 2);  // this thread's copies of item i + 1 landed
    } else if (wrow < rows) {
      const uint32_t* slot = ring + (i % n_buf) * slot_words;
      const int kcs = c == nc - 1 ? kc_last : kc;
      S_t dot[NQ][4];
      tile_mma<T, NQ, TIER>(slot + wrow * stride, stride, kcs,
                            chunked ? slot + TN * stride : qf_all, lane, dot);
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = c == 0 ? dot[j][e] : acc[j][e] + dot[j][e];
      if constexpr (K::NORMS) {
        // lanes l and l + 16 take row wrow + l % 16, the first and second
        // 16 bytes of each K step (conflict-free: stride = 4 mod 8 words)
        if (c == 0) nrm = S_t(0);
        const uint4* r = reinterpret_cast<const uint4*>(slot + (wrow + (lane & 15)) * stride) +
                         (lane >> 4);
        for (int ks = 0; ks < kcs; ++ks) {
          const uint4 w = r[2 * ks];
          add_squares<T>(w.x, nrm);
          add_squares<T>(w.y, nrm);
          add_squares<T>(w.z, nrm);
          add_squares<T>(w.w, nrm);
        }
      }
      if (c == nc - 1) {
        S_t n0 = S_t(0), n1 = S_t(0);
        if constexpr (K::NORMS) {
          const S_t full = nrm + __shfl_xor_sync(0xffffffffu, nrm, 16);
          n0 = __shfl_sync(0xffffffffu, full, g);
          n1 = __shfl_sync(0xffffffffu, full, g + 8);
        }
        const float* pnt = pn_ring + (i % n_buf) * TN + wrow + g;
        float* s = S + (2 * tq) * SS + wrow + g;
#pragma unroll
        for (int j = 0; j < NQ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row8 = 8 * (e >> 1);
            s[(MMA_QUERIES * j + (e & 1)) * SS + row8] =
                sel.score(acc[j][e], (e >> 1) ? n1 : n0, K::PN ? pnt[row8] : 0.0f, j, e & 1);
          }
      }
    }
    __syncthreads();  // S is written, item i + 1 is in its slot, item i is consumed
    // this S is written again two tiles on, after a barrier that every
    // multiplying warp reaches only when its selection here is done
    if (!copier && c == nc - 1) sel.select(S, t0, hi);
  }
  cp_async_wait<0>();
  if (!copier) sel.finish(blockIdx.y, gridDim.y);
}

// The ring's plan for a d-value row, as K steps per chunk (kc) and slots
// (n_buf): the whole row in one chunk if two slots fit, else the fewest
// chunks (of equal K steps, the last maybe shorter) for which two do; then
// the deepest ring (no deeper than the items of a split) that fits.
// Returns false where not even two one-step slots fit.
template <typename T, class K, int TIER>
bool tiled_plan(int d, int k, int tiles_per_split, int& kc, int& n_buf) {
  const int ksteps = row_words(d, sizeof(T)) / KSTEP_WORDS;
  kc = 0;
  for (int nc = 1; nc <= ksteps; ++nc) {
    const int c = (ksteps + nc - 1) / nc;
    if (tiled_smem<T, K, TIER>(ksteps, c, 2, k) <= (size_t)SMEM_MAX) { kc = c; break; }
  }
  if (kc == 0) return false;
  const int items = tiles_per_split * ((ksteps + kc - 1) / kc);
  n_buf = 2;
  while (n_buf < MAX_BUF && n_buf < items &&
         tiled_smem<T, K, TIER>(ksteps, kc, n_buf + 1, k) <= (size_t)SMEM_MAX)
    ++n_buf;
  return true;
}

// Launch tiled_kernel<T, K, TIER> over (ceil(m / QB), splits) blocks.  A split
// covers a multiple of split_tiles tiles (emit: a segment's, so that no
// segment is cut between two blocks); a split past the corpus's end has no
// tiles.
template <typename T, class K, int TIER>
cudaError_t launch_tiled(TiledArgs a, int splits, int split_tiles, cudaStream_t stream) {
  const int n_tiles = (a.n + TN - 1) / TN;
  a.tiles_per_split =
      ((n_tiles + splits - 1) / splits + split_tiles - 1) / split_tiles * split_tiles;
  const int ksteps = row_words(a.d, sizeof(T)) / KSTEP_WORDS;
  if (!tiled_plan<T, K, TIER>(a.d, a.k, a.tiles_per_split, a.kc, a.n_buf))
    return cudaErrorInvalidValue;
  const size_t smem = tiled_smem<T, K, TIER>(ksteps, a.kc, a.n_buf, a.k);
  cudaError_t err = cudaFuncSetAttribute(tiled_kernel<T, K, TIER>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  tiled_kernel<T, K, TIER><<<dim3((a.m + QB - 1) / QB, splits), NTS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace tile

}  // namespace knn
