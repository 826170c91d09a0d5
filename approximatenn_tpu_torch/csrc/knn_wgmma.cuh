// The Hopper pipeline of the tensor-core kNN kernels for 16-bit corpora:
// corpus tiles brought into a shared-memory ring by the Tensor Memory
// Accelerator (TMA), multiplied by warpgroup MMAs (wgmma) whose
// accumulators stay in registers, and a selection step that reads the
// scores there.  The two-phase emit for bf16 / f16 corpora runs on it
// (twophase_knn.cu:EmitSelectWG); it replaces no TPU kernel of its own (the
// TPU kernel is _kernel_emit, whose other port is knn_tile.cuh's tile loop).
// Its PTX helpers and tensor map also serve the float32 rank kernel's
// pipeline (knn_wgmma_tf32.cuh).
//
// Why not the tile loop.  knn_tile.cuh's blocks take 32 queries, multiply
// with mma.sync and hand every score through shared memory to warps that
// reduce it with shuffles: about 5 ps a score on an H100 whatever the
// precision and d, 26x the bf16 tensor-core bound at Deep-10M's shape.
// Here:
//   * a block serves 128 queries for every corpus byte it reads (two
//     consumer warpgroups of 64 queries each share a ring stage), so the
//     corpus streams from L2 once per 128 queries, not per 32;
//   * a stage is ROWS = 256 corpus rows: each consumer warpgroup issues
//     ceil(d / 16) wgmma m64n256k16 (queries as A from registers, rounded
//     to the corpus's type once per work unit; the stage as B from shared
//     memory, K-major; fp32 accumulators, 128 a thread);
//   * the selection step reads the accumulators where the MMA left them:
//     no score goes to shared memory, no __syncthreads() in the loop;
//   * one producer warp keeps TMA loads in flight; three more warps of the
//     producer warpgroup sum each landed row's squares into the stage's
//     norm slice (|x|^2 of the stored values in fp32, in one order for
//     every row, so that equal rows score equal);
//   * blocks are persistent, one an SM, over work units of (query block,
//     corpus split) that the wrapper plans (ops/twophase.py:emit_plan);
//     units of one split run side by side, so they read its tiles from L2.
//
// The ring.  `stages` stages of `chunks` swizzled chunks: chunk c holds
// features [32 c, 32 c + 32) of the stage's 256 rows, 64 bytes a row, as
// one TMA box {32, 256} of the row-major corpus writes it with the 64-byte
// swizzle (the 16-byte unit u of row r lands at unit u ^ ((r >> 1) & 3)).
// Features past d (the last chunk's tail) and rows past n are the box's
// out-of-bounds part, which TMA fills with zeros.  A wgmma K step (16
// features, 32 bytes) reads half a chunk through a descriptor of the 64-byte
// swizzle mode: 8-row groups 512 bytes apart, the start advanced 32 bytes
// for the odd half.  Three mbarriers a stage:
//   full[s]    the producer's expect_tx; the TMA loads complete it
//   normed[s]  the 96 norm threads, after the stage's norms are written
//              (a consumer waits for it after its MMAs, before selecting)
//   empty[s]   the 256 consumer threads, after their selection step read
//              the stage's norms (their MMAs had read its rows before)
// Every role walks the same sequence of tiles (all units of the block, in
// order), so the stage and phase of tile i are i % stages and i / stages.
//
// What it takes: 16-bit storage, d a multiple of 8 (TMA's row pitch is a
// multiple of 16 bytes) and at most MAX_CHUNKS * 32, the corpus 16-byte
// aligned.  The tensor map is made on the host by cuTensorMapEncodeTiled,
// looked up at run time through the CUDA runtime, so the library keeps its
// plain C interface and links nothing more.
//
// Registers: 384 threads a block start with 168 a thread; the producer
// warpgroup gives 112 of its own back (setmaxnreg) and each consumer takes
// 224, for 128 accumulators, 32 words of query fragments and the selection
// (without it the emit at Deep-10M's shape, m = 10,000, took 79.3 ms, not
// 53.9, on an H100 SXM at 700 W).  Build: included by twophase_knn.cu;
// sm_90a (wgmma, setmaxnreg).

#pragma once

#include <cuda.h>

#include "knn_tile.cuh"

namespace knn {
namespace wg {

constexpr int WG = 128;                      // threads of a warpgroup
constexpr int CONSUMERS = 2;                 // multiplying warpgroups, first
constexpr int THREADS = WG * (CONSUMERS + 1);
constexpr int ROWS = 256;                    // corpus rows a stage: wgmma's N
constexpr int WG_Q = 64;                     // queries a consumer warpgroup: wgmma's M
constexpr int BLOCK_Q = WG_Q * CONSUMERS;    // queries a work unit
constexpr int CHUNK = 32;                    // features of a 64-byte swizzled chunk
constexpr int CHUNK_BYTES = ROWS * 64;
constexpr int MAX_CHUNKS = 4;                // d <= 128
constexpr int MAX_KSTEPS = 2 * MAX_CHUNKS;
constexpr int MIN_STAGES = 3, MAX_STAGES = 8;
constexpr int NORM_THREADS = 96;             // producer warpgroup's warps 1..3
// registers a thread after setmaxnreg: the producer warpgroup gives back what
// the consumers take from the 168 a thread that 384 threads start with
constexpr int PRODUCER_REGS = 56, CONSUMER_REGS = 224;
static_assert((168 - PRODUCER_REGS) * WG >= (CONSUMER_REGS - 168) * WG * CONSUMERS,
              "the consumers take no more registers than the producers give back");

// What a launch hands the kernel besides the tensor map.
struct Args {
  const float* q;   // (m, d) float32 queries
  const int* excl;  // (m,) or null
  float* seg_d;     // (m, n_seg) minima
  int* seg_i;       // (m, n_seg) their rows
  int n, d, m, seg, n_seg;
  int ksteps, chunks, stages;
  int n_qb;         // query blocks of BLOCK_Q
  int units;        // n_qb x splits; unit u = (query block u % n_qb, split u / n_qb)
  int split_rows;   // a multiple of max(seg, ROWS)
};

// Bytes of dynamic shared memory: 1 KB of slack to align the ring to the
// swizzle's repeat, the ring, the norm slices, 3 mbarriers a stage, then
// the selection step's own state.
__host__ __device__ inline size_t smem_bytes(int stages, int chunks, size_t state) {
  return 1024 + (size_t)stages * chunks * CHUNK_BYTES + (size_t)stages * ROWS * 4 +
         (size_t)3 * stages * 8 + state;
}

// -- PTX ----------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// The box at (feature c0, row c1) of the tensor map into dst; completes on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}



// orders this thread's shared-memory accesses before later async-proxy ones (TMA)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Ties the accumulators to this point of the program: reads of them are not
// moved above the wait that completes the MMAs writing them.
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Descriptor of a K-major operand in the 64-byte swizzle mode at shared
// address `addr`: rows 64 bytes apart inside an 8-row group (implied by the
// mode), groups 512 bytes apart (stride byte offset), leading byte offset
// unused (1).
__device__ __forceinline__ uint64_t desc_sw64(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(512 >> 4) << 32) |
         ((uint64_t)2 << 62);
}

#define KNN_WG_D_REGS                                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "       \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "       \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "       \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "       \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "       \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, " \
  "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, "   \
  "%125, %126, %127}"
#define KNN_WG_D_OPS(d)                                                                     \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),      \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),           \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),        \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),        \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),        \
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),        \
      "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),        \
      "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),        \
      "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),        \
      "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),        \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]),        \
      "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]),        \
      "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]),        \
      "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),        \
      "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),        \
      "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]),        \
      "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]),     \
      "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]),  \
      "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),  \
      "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]),  \
      "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]),  \
      "+f"(d[127])

// d (+)= A B for one K step: A the warpgroup's 64 x 16 queries in
// registers (mma.sync's m16n8k16 A fragment, a warp's 16 rows each), B the
// stage's 256 rows x 16 features through `desc`; accumulate = 0 overwrites d.
template <typename T>
__device__ __forceinline__ void wgmma_256(float (&d)[128], const uint32_t (&a)[4], uint64_t desc,
                                          int accumulate) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " KNN_WG_D_REGS
        ", {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
        : KNN_WG_D_OPS(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.f16.f16 " KNN_WG_D_REGS
        ", {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
        : KNN_WG_D_OPS(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
  }
}

#undef KNN_WG_D_REGS
#undef KNN_WG_D_OPS

// A stage's KS K steps into acc: one straight chain of wgmma (KS is a
// template parameter, so no branch parts two MMAs of a chain).
template <typename T, int KS>
__device__ __forceinline__ void mma_chain(float (&acc)[128], const uint32_t (&qf)[MAX_KSTEPS][4],
                                          uint32_t sb) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    wgmma_256<T>(acc, qf[ks], desc_sw64(sb + (ks >> 1) * CHUNK_BYTES + (ks & 1) * 32), ks > 0);
}

template <typename T>
__device__ __forceinline__ void mma_stage(float (&acc)[128], const uint32_t (&qf)[MAX_KSTEPS][4],
                                          uint32_t sb, int ksteps) {
  switch (ksteps) {
    case 1: mma_chain<T, 1>(acc, qf, sb); break;
    case 2: mma_chain<T, 2>(acc, qf, sb); break;
    case 3: mma_chain<T, 3>(acc, qf, sb); break;
    case 4: mma_chain<T, 4>(acc, qf, sb); break;
    case 5: mma_chain<T, 5>(acc, qf, sb); break;
    case 6: mma_chain<T, 6>(acc, qf, sb); break;
    case 7: mma_chain<T, 7>(acc, qf, sb); break;
    default: mma_chain<T, 8>(acc, qf, sb); break;
  }
}

// Two query values rounded to T, the first in the low half.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  } else {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
}

// -- the kernel ------------------------------------------------------------------

// The pipeline (see the top of this file) for storage type T; Sel is the
// selection step, one per consumer thread:
//   Sel::STATE_BYTES           its shared memory, after the barriers
//   Sel(args, state, wg, t)    set-up of consumer thread t of warpgroup wg
//   sel.begin(q0, lo, hi)      a work unit: queries q0.., rows [lo, hi)
//   sel.tile(acc, nq, t0)      a stage's scores (acc may be overwritten):
//                              acc[4 j + 2 i + b] is the dot product of
//                              query 16 (warp % 4) + lane / 4 + 8 i and row
//                              t0 + 8 j + 2 (lane % 4) + b, nq[8 j + b] that
//                              row's stored |x|^2 (+inf past n); whole
//                              warpgroup
template <typename T, class Sel>
__global__ void __launch_bounds__(THREADS, 1)
    wg_tiled_kernel(const __grid_constant__ CUtensorMap map, const __grid_constant__ Args a) {
  extern __shared__ unsigned char smem_raw[];
  // offset arithmetic on smem_raw keeps the ring in the shared window
  unsigned char* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int stage_bytes = a.chunks * CHUNK_BYTES;
  float* norms = reinterpret_cast<float*>(ring + (size_t)a.stages * stage_bytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(norms + a.stages * ROWS);
  uint64_t* normed = full + a.stages;
  uint64_t* empty = normed + a.stages;
  unsigned char* state = reinterpret_cast<unsigned char*>(empty + a.stages);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, wgi = warp >> 2;
  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(normed + s, NORM_THREADS);
      mbar_init(empty + s, WG * CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wgi == CONSUMERS) {
    // -- the producer warpgroup: TMA loads (warp 0's lane 0) and norms ------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    const int pw = warp - 4 * CONSUMERS;
    if (pw == 0) {
      if (lane != 0) return;
      int it = 0;
      for (int u = blockIdx.x; u < a.units; u += gridDim.x) {
        const int lo = (u / a.n_qb) * a.split_rows;
        const int hi = min(lo + a.split_rows, a.n);
        for (int t0 = lo; t0 < hi; t0 += ROWS, ++it) {
          const int s = it % a.stages;
          mbar_wait(empty + s, ((it / a.stages) & 1) ^ 1);  // round 0 passes
          mbar_expect_tx(full + s, (uint32_t)stage_bytes);
          unsigned char* dst = ring + (size_t)s * stage_bytes;
          for (int c = 0; c < a.chunks; ++c)
            tma_load(dst + c * CHUNK_BYTES, &map, full + s, c * CHUNK, t0);
        }
      }
      return;
    }
    // norm threads: rows nt, nt + 96, nt + 192 side by side (the last
    // clamped, not stored, past the stage); a row's 16-byte units in feature
    // order, whatever the swizzle put where, one partial sum a unit position
    // added up at the end, so a row's norm does not depend on its place
    const int nt = tid - (4 * CONSUMERS + 1) * 32;
    constexpr int R = (ROWS + NORM_THREADS - 1) / NORM_THREADS;
    int it = 0;
    for (int u = blockIdx.x; u < a.units; u += gridDim.x) {
      const int lo = (u / a.n_qb) * a.split_rows;
      const int hi = min(lo + a.split_rows, a.n);
      for (int t0 = lo; t0 < hi; t0 += ROWS, ++it) {
        const int s = it % a.stages;
        mbar_wait(full + s, (it / a.stages) & 1);
        const unsigned char* src = ring + (size_t)s * stage_bytes;
        float part[R][4];
        int off[R];
#pragma unroll
        for (int k = 0; k < R; ++k) {
          off[k] = min(nt + k * NORM_THREADS, ROWS - 1) * 64;
#pragma unroll
          for (int un = 0; un < 4; ++un) part[k][un] = 0.0f;
        }
        for (int c = 0; c < a.chunks; ++c) {
#pragma unroll
          for (int un = 0; un < 4; ++un) {
#pragma unroll
            for (int k = 0; k < R; ++k) {
              const int sw = (off[k] >> 7) & 3;  // (r >> 1) & 3
              const uint4 w = *reinterpret_cast<const uint4*>(src + c * CHUNK_BYTES + off[k] +
                                                              ((un ^ sw) << 4));
              tile::add_squares<T>(w.x, part[k][un]);
              tile::add_squares<T>(w.y, part[k][un]);
              tile::add_squares<T>(w.z, part[k][un]);
              tile::add_squares<T>(w.w, part[k][un]);
            }
          }
        }
#pragma unroll
        for (int k = 0; k < R; ++k) {
          const int r = nt + k * NORM_THREADS;
          if (r < ROWS)
            norms[s * ROWS + r] = t0 + r < a.n
                                      ? (part[k][0] + part[k][1]) + (part[k][2] + part[k][3])
                                      : pos_inf();
        }
        fence_async_shared();
        mbar_arrive(normed + s);
      }
    }
    return;
  }

  // -- a consumer warpgroup ---------------------------------------------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int wt = tid & (WG - 1);
  const int g = lane >> 2, tq = lane & 3;
  Sel sel(a, state, wgi, wt);
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
  int it = 0;
  for (int u = blockIdx.x; u < a.units; u += gridDim.x) {
    const int lo = (u / a.n_qb) * a.split_rows;
    const int hi = min(lo + a.split_rows, a.n);
    const int q0 = (u % a.n_qb) * BLOCK_Q + wgi * WG_Q;
    const bool active = q0 < a.m;  // the same in the whole warpgroup
    // the unit's query fragments, rounded to T (zero past m and d)
    uint32_t qf[MAX_KSTEPS][4];
    {
      const int ra = q0 + 16 * (warp & 3) + g, rb = ra + 8;
      const float* pa = a.q + (long long)ra * a.d;
      const float* pb = a.q + (long long)rb * a.d;
#pragma unroll
      for (int ks = 0; ks < MAX_KSTEPS; ++ks) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int k = 16 * ks + 2 * tq + 8 * h;  // even; d is a multiple of 8
          float2 va = make_float2(0.0f, 0.0f), vb = make_float2(0.0f, 0.0f);
          if (ks < a.ksteps && k < a.d) {
            if (ra < a.m) va = *reinterpret_cast<const float2*>(pa + k);
            if (rb < a.m) vb = *reinterpret_cast<const float2*>(pb + k);
          }
          qf[ks][2 * h] = pack2<T>(va.x, va.y);
          qf[ks][2 * h + 1] = pack2<T>(vb.x, vb.y);
        }
      }
    }
    if (active) sel.begin(q0, lo, hi);
    for (int t0 = lo; t0 < hi; t0 += ROWS, ++it) {
      const int s = it % a.stages;
      const uint32_t ph = (it / a.stages) & 1;
      mbar_wait(full + s, ph);
      if (active) {
        wgmma_fence();
        mma_stage<T>(acc, qf, smem_u32(ring + (size_t)s * stage_bytes), a.ksteps);
        wgmma_commit();
        wgmma_wait_all();
        fence_acc(acc);
      }
      mbar_wait(normed + s, ph);
      if (active) sel.tile(acc, norms + s * ROWS + 2 * tq, t0);
      mbar_arrive(empty + s);
    }
  }
}

// -- the host side ------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled as the CUDA runtime looks it up (null if it cannot)
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The tensor map of an (n, d) row-major corpus of T (float32, bf16 or f16):
// boxes of {box_cols features (64 bytes), box_rows rows}, 64-byte swizzle,
// zeros out of bounds.
template <typename T>
cudaError_t corpus_map(CUtensorMap* map, const void* pts, int n, int d,
                       int box_cols = CHUNK, int box_rows = ROWS) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)n};
  const cuuint64_t strides[1] = {(cuuint64_t)d * sizeof(T)};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUtensorMapDataType type = std::is_same<T, float>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                   : std::is_same<T, __nv_bfloat16>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  const CUresult r = fn(map, type, 2, const_cast<void*>(pts), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Launch wg_tiled_kernel<T, Sel> on `blocks` persistent blocks.
template <typename T, class Sel>
cudaError_t launch(const void* pts, const Args& a, int blocks, cudaStream_t stream) {
  CUtensorMap map;
  cudaError_t err = corpus_map<T>(&map, pts, a.n, a.d);
  if (err != cudaSuccess) return err;
  const size_t smem = smem_bytes(a.stages, a.chunks, Sel::STATE_BYTES);
  if (smem > (size_t)SMEM_MAX) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(wg_tiled_kernel<T, Sel>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  wg_tiled_kernel<T, Sel><<<blocks, THREADS, smem, stream>>>(map, a);
  return cudaGetLastError();
}

}  // namespace wg
}  // namespace knn
