// The Hopper pipeline of the rank kernel for float32 corpora at "highest"
// (three TF32 passes): corpus tiles brought into a shared-memory ring by the
// Tensor Memory Accelerator (TMA), split into their TF32 halves there,
// multiplied by warpgroup MMAs (wgmma m64n128k8 .tf32) whose accumulators
// stay in registers, and a selection step that reads the scores where the
// MMAs left them (exact_knn.cu:RankSelectWG).  It is the rank kernel's
// second design beside knn_tile.cuh's tile loop (which serves every other
// type, tier and width): the TPU kernel is still _kernel_rank.
//
// Why not the tile loop.  Its blocks take 32 queries, multiply with
// mma.sync and hand every score through shared memory to warps that select
// with shuffles: about 5 ps a score whatever the precision (~5.5x the
// 3xTF32 bound at SIFT-1M's shape).  Here, as in knn_wgmma.cuh:
//   * a block serves 128 queries for every corpus byte it reads (two
//     consumer warpgroups of 64 queries each share a ring slot);
//   * the selection step reads the accumulators: no score goes to shared
//     memory, no __syncthreads() in the loop;
//   * blocks are persistent, one an SM, over work units of (query block,
//     corpus split) that the wrapper plans (ops/exact.py:rank_plan); units
//     of one split run side by side, so they read its tiles from L2.
//
// The precision.  Each factor splits as knn_mma.cuh splits it:
// hi = cvt.rna.tf32(x), lo = cvt.rna.tf32(x - hi); a K step (8 features)
// adds lo_q hi_x, hi_q lo_x, then hi_q hi_x to fp32 accumulators (lo lo,
// 2^-22 of a product, is dropped).  Every product of two TF32 values is
// exact in fp32.  The queries split in registers once per work unit; the
// corpus in shared memory, where it lands (below).
//
// What shapes it.  A float32 row of d = 128 is 512 bytes, and the 3xTF32
// product needs it twice (hi and lo): whole rows would not leave room for a
// ring.  Query fragments for 64 queries x 128 features, hi and lo, take 128
// registers a thread, so the accumulators get 64: wgmma's N is 128 rows.  So
// a ring item is one feature box of one 128-row tile:
//   slot = hi box (8 KB: TMA box {16 features, 128 rows}, 64-byte swizzle,
//          rows 64 bytes apart, the 16-byte unit u of row r at
//          u ^ ((r >> 1) & 3); features past d and rows past n are the box's
//          out-of-bounds part, which TMA fills with zeros)
//        + lo box (8 KB, the same layout)
// and a tile is ceil(d / 16) items; the accumulators run on from item to
// item and the selection reads them after the tile's last.  A wgmma K step
// (8 features, 32 bytes) reads half a box through a descriptor of the
// 64-byte swizzle mode (8-row groups 512 bytes apart; the start advanced 32
// bytes for the odd half), as knn_wgmma.cuh reads its 16-bit chunks.
// Roles:
//   * one producer thread (warp 0 of the producer warpgroup) keeps TMA
//     loads in flight, and does nothing else: a TMA issuer that also split
//     could only load between its own items, and starved the ring;
//   * three split warps (96 threads, the producer warpgroup's others) read
//     each landed value once, write hi over it and lo into the slot's lo box
//     (both rounded on the integer pipe, rna_tf32), and sum its square into
//     the row's norm (|x|^2 of the stored values in fp32, in one order for
//     every row, so that equal rows score equal: per 16-byte unit position,
//     added up at the tile's end).  A thread takes every 96th unit of a box,
//     not whole rows, so the warps' loads are even (by rows, the warp with
//     two set the pace); the norms go to the slot of the tile's last item;
//   * two consumer warpgroups issue 6 wgmma an item (2 K steps x 3 passes),
//     commit them as a group, and release the previous item once its group
//     has completed; after a tile's last item they wait, select and release
//     it (its slot holds the norms the selection reads).
// Three mbarriers a slot:
//   full[s]   the producer's expect_tx; the TMA load completes it
//   ready[s]  the 96 split threads, after the halves (and norms) are written
//             and fenced for the async proxy
//   empty[s]  the 8 consumer warps, after their MMAs read the slot (and, for
//             a tile's last item, after the selection read its norms)
// Every role walks the same sequence of items (all units of the block,
// their tiles, each tile's boxes), so the slot and phase parity of item i
// are i % stages and (i / stages) % 2 (Slot counts them).
//
// What it takes: float32, d a multiple of 4 (TMA's row pitch is a multiple
// of 16 bytes) and at most MAX_BOXES * 16, the corpus 16-byte aligned.
//
// Registers: 384 threads a block start with 168 a thread; the producer
// warpgroup gives 112 of its own back (setmaxnreg) and each consumer takes
// 224, for 64 accumulators, 128 words of query fragments and the selection
// (232 / 40 spilled in the producer).
// Build: included by exact_knn.cu; sm_90a (wgmma, setmaxnreg).

#pragma once

#include "knn_wgmma.cuh"

namespace knn {
namespace wg {
namespace tf32 {

constexpr int ROWS = 128;                  // corpus rows a tile: wgmma's N
constexpr int BOX = 16;                    // features of a ring item (64 bytes a row)
constexpr int BOX_BYTES = ROWS * 64;       // a box: the TMA load, then its hi half
constexpr int MAX_BOXES = 8;               // d <= 128
constexpr int MAX_KSTEPS = 2 * MAX_BOXES;  // 8 features a K step
constexpr int MIN_STAGES = 4, MAX_STAGES = 12;
constexpr int SPLIT_THREADS = 96;          // producer warpgroup's warps 1..3
constexpr int UNITS = ROWS * 4;            // 16-byte units of a box
constexpr int UNITS_PER = (UNITS + SPLIT_THREADS - 1) / SPLIT_THREADS;  // a split thread's
constexpr int PRODUCER_REGS = 56, CONSUMER_REGS = 224;
static_assert(PRODUCER_REGS * WG + CONSUMER_REGS * WG * CONSUMERS <= 168 * THREADS,
              "the consumers take no more registers than the producers give back");

// What a launch hands the kernel besides the tensor map.
struct Args {
  const float* q;   // (m, d) float32 queries
  const int* excl;  // (m,) or null
  float* part_d;    // (m, splits, k) the splits' sorted lists
  int* part_i;
  int n, d, m, k;
  int boxes;        // ceil(d / BOX): items a tile
  int stages;
  int n_qb;         // query blocks of BLOCK_Q
  int units;        // n_qb x splits; unit u = (query block u % n_qb, split u / n_qb)
  int split_rows;   // a multiple of ROWS
  int splits;
};

// Boxes a ring item: two where a tile's boxes pair up, else one.
__host__ __device__ inline int boxes_per_item(int boxes) { return boxes % 2 ? 1 : 2; }

// Bytes of a ring slot: an item's hi boxes, then its lo boxes.
__host__ __device__ constexpr int slot_bytes(int bpi) { return 2 * bpi * BOX_BYTES; }

// Bytes of dynamic shared memory: 1 KB of slack to align the ring to the
// swizzle's repeat, the ring (`stages` slots of items of bpi boxes), a norm
// slice a slot, the split's norm parts of two tiles, 3 mbarriers a slot,
// then the selection step's state.
__host__ __device__ inline size_t smem_bytes(int stages, int bpi, size_t state) {
  return 1024 + (size_t)stages * slot_bytes(bpi) + (size_t)stages * ROWS * 4 + 2 * UNITS * 4 +
         (size_t)3 * stages * 8 + state;
}

#define KNN_TF32_D_REGS \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, " \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, " \
  "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define KNN_TF32_D_OPS(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), \
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), \
      "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), \
      "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), \
      "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), \
      "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

// d (+)= A B for one K step: A the warpgroup's 64 x 8 queries in registers
// (mma.sync's m16n8k8 TF32 A fragment, a warp's 16 rows each), B the tile's
// 128 rows x 8 features through `desc`; accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_128(float (&d)[64], const uint32_t (&a)[4], uint64_t desc,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " KNN_TF32_D_REGS
      ", {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : KNN_TF32_D_OPS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

#undef KNN_TF32_D_REGS
#undef KNN_TF32_D_OPS

__device__ __forceinline__ void wgmma_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// Ties the accumulators to this point of the program (see knn_wgmma.cuh).
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// One item's MMAs: K steps 2c and 2c + 1 of the tile, three passes each,
// the small products first.  hb / lb: the slot's hi and lo boxes.
__device__ __forceinline__ void mma_box(float (&acc)[64], const uint32_t (&qh0)[4],
                                        const uint32_t (&ql0)[4], const uint32_t (&qh1)[4],
                                        const uint32_t (&ql1)[4], uint32_t hb, uint32_t lb,
                                        int accumulate) {
  wgmma_128(acc, ql0, desc_sw64(hb), accumulate);
  wgmma_128(acc, qh0, desc_sw64(lb), 1);
  wgmma_128(acc, qh0, desc_sw64(hb), 1);
  wgmma_128(acc, ql1, desc_sw64(hb + 32), 1);
  wgmma_128(acc, qh1, desc_sw64(lb + 32), 1);
  wgmma_128(acc, qh1, desc_sw64(hb + 32), 1);
}

// x rounded to TF32 (10 mantissa bits) as cvt.rna.tf32.f32 rounds it, to
// nearest, ties away from zero, on the integer pipe: half a TF32 ulp added
// to the magnitude (the low 31 bits), the 13 dropped bits cleared; +-inf
// and NaN stay what they are.  ops/exact.py:split_tf32 is the same.
__device__ __forceinline__ uint32_t rna_tf32(uint32_t x) { return (x + 0x1000u) & ~0x1FFFu; }

// A landed word x: its square into the norm part p; hi (over x) and lo.
__device__ __forceinline__ void split_word(uint32_t& w, uint32_t& lo, float& p) {
  const float x = __uint_as_float(w);
  p = fmaf(x, x, p);
  const uint32_t hi = rna_tf32(w);
  lo = rna_tf32(__float_as_uint(x - __uint_as_float(hi)));  // x - hi is exact
  w = hi;
}

// 16-byte unit e of a landed box (row e / 4, features 4 (e % 4) .. + 3 of
// the box, wherever the swizzle put them) split into hb (in place) and lb,
// the squares of its four values, in order, into p.
__device__ __forceinline__ void split_unit(unsigned char* hb, unsigned char* lb, int e, float& p) {
  const int r = e >> 2;
  const int o = r * 64 + (((e & 3) ^ ((r >> 1) & 3)) << 4);
  uint4 w = *reinterpret_cast<const uint4*>(hb + o);
  uint4 l;
  split_word(w.x, l.x, p);
  split_word(w.y, l.y, p);
  split_word(w.z, l.z, p);
  split_word(w.w, l.w, p);
  *reinterpret_cast<uint4*>(hb + o) = w;
  *reinterpret_cast<uint4*>(lb + o) = l;
}

// A role's place in the ring: the slot of its next item and that slot's
// phase parity (the item's round % 2), advanced without a division.
struct Slot {
  int s = 0;
  uint32_t ph = 0;
  __device__ void next(int stages) {
    if (++s == stages) {
      s = 0;
      ph ^= 1;
    }
  }
};

// The warp's part of a slot's reading is done: one arrival a warp.
__device__ __forceinline__ void release(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// -- the kernel ------------------------------------------------------------------

// The pipeline (see the top of this file); Sel is the selection step, one
// per consumer thread:
//   Sel::state_bytes(k)        its shared memory, after the barriers
//   Sel(args, state, wg, t)    set-up of consumer thread t of warpgroup wg
//   sel.begin(q0, lo, hi)      a work unit: the warpgroup's queries q0..,
//                              rows [lo, hi)
//   sel.tile(acc, nq, t0)      a tile's scores: acc[4 j + 2 i + b] is the dot
//                              product of query 16 (warp % 4) + lane / 4 + 8 i
//                              and row t0 + 8 j + 2 (lane % 4) + b, nq[8 j + b]
//                              that row's stored |x|^2 (+inf past n)
//   sel.finish(split)          the unit's lists out
// A ring item is BPI boxes (boxes_per_item).
template <int BPI, class Sel>
__global__ void __launch_bounds__(THREADS, 1)
    rank_tf32_kernel(const __grid_constant__ CUtensorMap map, const __grid_constant__ Args a) {
  constexpr int SLOT = slot_bytes(BPI), LO = BPI * BOX_BYTES;  // a slot; its lo half
  extern __shared__ unsigned char smem_raw[];
  // offset arithmetic on smem_raw keeps the ring in the shared window
  unsigned char* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* norms = reinterpret_cast<float*>(ring + (size_t)a.stages * SLOT);
  float* nparts = norms + a.stages * ROWS;  // [2][UNITS]
  uint64_t* full = reinterpret_cast<uint64_t*>(nparts + 2 * UNITS);
  uint64_t* ready = full + a.stages;
  uint64_t* empty = ready + a.stages;
  unsigned char* state = reinterpret_cast<unsigned char*>(empty + a.stages);

  // the warpgroup's index broadcast from lane 0, so that ptxas sees it is
  // the same in the whole warp (a divergent path before a wgmma serializes
  // the MMAs)
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wgi = __shfl_sync(0xffffffffu, warp >> 2, 0);
  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(ready + s, SPLIT_THREADS);
      mbar_init(empty + s, 4 * CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wgi == CONSUMERS) {
    // -- the producer warpgroup: TMA loads (warp 0's lane 0) and the split --
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    const int pw = warp - 4 * CONSUMERS;
    if (pw == 0) {
      if (lane != 0) return;
      Slot sl;
      for (int u = blockIdx.x; u < a.units; u += gridDim.x) {
        const int lo = (u / a.n_qb) * a.split_rows;
        const int hi = min(lo + a.split_rows, a.n);
        for (int t0 = lo; t0 < hi; t0 += ROWS)
          for (int c = 0; c < a.boxes; c += BPI, sl.next(a.stages)) {
            const int s = sl.s;
            mbar_wait(empty + s, sl.ph ^ 1);  // round 0 passes
            mbar_expect_tx(full + s, (uint32_t)LO);
#pragma unroll
            for (int b = 0; b < BPI; ++b)
              tma_load(ring + (size_t)s * SLOT + b * BOX_BYTES, &map, full + s, (c + b) * BOX, t0);
          }
      }
      return;
    }
    // split threads: units st, st + 96, ... of every box (a warp's 32 units
    // are 8 whole rows), each unit's squares summed across a tile's boxes;
    // at its last box the parts go to nparts (a tile's half, by parity),
    // the split warps meet, and thread st adds up rows st and st + 96
    const int st = tid - (4 * CONSUMERS + 1) * 32;
    Slot sl;
    int tile = 0;
    for (int u = blockIdx.x; u < a.units; u += gridDim.x) {
      const int lo = (u / a.n_qb) * a.split_rows;
      const int hi = min(lo + a.split_rows, a.n);
      for (int t0 = lo; t0 < hi; t0 += ROWS, ++tile) {
        float p[UNITS_PER];
#pragma unroll
        for (int j = 0; j < UNITS_PER; ++j) p[j] = 0.0f;
        for (int c = 0; c < a.boxes; c += BPI, sl.next(a.stages)) {
          const int s = sl.s;
          mbar_wait(full + s, sl.ph);
          unsigned char* hb = ring + (size_t)s * SLOT;
#pragma unroll
          for (int b = 0; b < BPI; ++b)
#pragma unroll
            for (int j = 0; j < UNITS_PER; ++j)
              if (st + SPLIT_THREADS * j < UNITS)  // the same in the whole warp
                split_unit(hb + b * BOX_BYTES, hb + LO + b * BOX_BYTES, st + SPLIT_THREADS * j,
                           p[j]);
          if (c + BPI == a.boxes) {
            float* np = nparts + (tile & 1) * UNITS;
#pragma unroll
            for (int j = 0; j < UNITS_PER; ++j)
              if (st + SPLIT_THREADS * j < UNITS) np[st + SPLIT_THREADS * j] = p[j];
            named_sync(1, SPLIT_THREADS);
            for (int r = st; r < ROWS; r += SPLIT_THREADS)
              norms[s * ROWS + r] = t0 + r < a.n ? (np[4 * r] + np[4 * r + 1]) +
                                                       (np[4 * r + 2] + np[4 * r + 3])
                                                 : pos_inf();
          }
          fence_async_shared();
          mbar_arrive(ready + s);
        }
      }
    }
    return;
  }

  // -- a consumer warpgroup ---------------------------------------------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int wt = tid & (WG - 1);
  const int g = lane >> 2, tq = lane & 3;
  Sel sel(a, state, wgi, wt);
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  Slot sl;
  for (int u = blockIdx.x; u < a.units; u += gridDim.x) {
    const int split = u / a.n_qb;
    const int lo = split * a.split_rows;
    const int hi = min(lo + a.split_rows, a.n);
    const int q0 = (u % a.n_qb) * BLOCK_Q + wgi * WG_Q;
    const bool active = __shfl_sync(0xffffffffu, q0 < a.m, 0);  // the same in the warpgroup
    // the unit's query fragments split into TF32 halves (zero past m and d):
    // word 2 h + e of K step ks is query ra (e = 0) or rb (e = 1), feature
    // 8 ks + tq + 4 h
    uint32_t qh[MAX_KSTEPS][4], ql[MAX_KSTEPS][4];
    {
      const int ra = q0 + 16 * (warp & 3) + g, rb = ra + 8;
      const float* pa = a.q + (long long)ra * a.d;
      const float* pb = a.q + (long long)rb * a.d;
#pragma unroll
      for (int ks = 0; ks < MAX_KSTEPS; ++ks) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int f = 8 * ks + tq + 4 * h;
          const bool in = ks < 2 * a.boxes && f < a.d;
          const float va = in && ra < a.m ? pa[f] : 0.0f;
          const float vb = in && rb < a.m ? pb[f] : 0.0f;
          split_tf32(va, qh[ks][2 * h], ql[ks][2 * h]);
          split_tf32(vb, qh[ks][2 * h + 1], ql[ks][2 * h + 1]);
        }
      }
    }
    if (active) sel.begin(q0, lo, hi);
    for (int t0 = lo; t0 < hi; t0 += ROWS) {
      int prev = 0;
#pragma unroll
      for (int c = 0; c < MAX_BOXES; ++c) {
        if (c < a.boxes) {
          const int s = sl.s;
          if (c % BPI == 0) {
            mbar_wait(ready + s, sl.ph);
            if (active) wgmma_fence();
          }
          if (active) {
            const uint32_t hb = smem_u32(ring + (size_t)s * SLOT) + (c % BPI) * BOX_BYTES;
            mma_box(acc, qh[2 * c], ql[2 * c], qh[2 * c + 1], ql[2 * c + 1], hb, hb + LO, c > 0);
          }
          if (c % BPI == BPI - 1) {
            if (active) {
              wgmma_commit();
              if (c >= BPI) wgmma_wait_one();  // the previous item's MMAs are done
            }
            if (c >= BPI) release(empty + prev, lane);
            prev = s;
            sl.next(a.stages);
          }
        }
      }
      if (active) {
        wgmma_wait_all();
        fence_acc(acc);
        sel.tile(acc, norms + prev * ROWS + 2 * tq, t0);
      }
      release(empty + prev, lane);
    }
    if (active) sel.finish(split);
  }
}

// Launch rank_tf32_kernel<BPI, Sel> on `blocks` persistent blocks.
template <int BPI, class Sel>
cudaError_t launch_bpi(const CUtensorMap& map, const Args& a, int blocks, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.stages, BPI, Sel::state_bytes(a.k));
  if (smem > (size_t)SMEM_MAX) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(rank_tf32_kernel<BPI, Sel>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  rank_tf32_kernel<BPI, Sel><<<blocks, THREADS, smem, stream>>>(map, a);
  return cudaGetLastError();
}

template <class Sel>
cudaError_t launch(const void* pts, const Args& a, int blocks, cudaStream_t stream) {
  CUtensorMap map;
  const cudaError_t err = corpus_map<float>(&map, pts, a.n, a.d, BOX, ROWS);
  if (err != cudaSuccess) return err;
  return boxes_per_item(a.boxes) == 2 ? launch_bpi<2, Sel>(map, a, blocks, stream)
                                      : launch_bpi<1, Sel>(map, a, blocks, stream);
}

}  // namespace tf32
}  // namespace wg
}  // namespace knn
