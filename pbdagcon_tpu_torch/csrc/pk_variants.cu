// Three other designs of the per-row histogram and payload scatter for
// Hopper (sm_90a): the kernels of the kernel-variant microbench
// (`python -m pbdagcon_tpu_torch.tools.prof_pk`). Bound to PyTorch through
// a plain C interface (`dagcon_hist_wgmma`, `dagcon_hist_row`,
// `dagcon_scatter_tile`) loaded with ctypes by `ops/pk_cuda.py`.
//
// The contracts are those of `hist_scatter.cu` (B2, B3):
//
//   hist:    out[b, d] = #{n : values[b, n] == d},  d in [0, D)
//   scatter: out[k][b, r[b, n]] += payload[k][b, n] & cut_mask
//
// with values and ranks < 0 or >= D dropped and the scatter's int32 sums
// wrapping. Each kernel carries over the idea that set its TPU kernel
// apart from B2/B3, not its blocks:
//
// - hist_wgmma_kernel replaces `tools/prof_pk.py::hist_v1` (P1): the
//   factorized one-hot product itself, on the tensor cores. With
//   hi = v >> 7 and lo = v & 127, out[hi * 128 + lo] = sum_n (lo_n == lo)
//   * (hi_n == hi): a [128 lo x 32] by [32 x NW hi] s8 one-hot product per
//   32 values, summed in int32 accumulators (exact: no byte split, no
//   float). wgmma.mma_async (sm_90a only): lo is the M side, one m64 tile
//   per consumer warpgroup; hi is the N side. Both one-hot tiles lie
//   K-major in shared memory, built once per step (B read by both
//   warpgroups) and kept zero but for their 32 ones, which the thread
//   that owns a column sets and later clears: four byte stores per value.
//   A built in registers by byte compares (~30 instructions per thread
//   per step) was measured slower than the tensor cores it fed. The N
//   width NW tracks D: ceil(D / 128) hi rows, evened over the fewest
//   tiles of at most kMaxHiTile rows, rounded up to a width PTX allows
//   for s8, so one block covers a whole row wherever D <= kMaxHiTile *
//   128. A producer warp stages the row with cp.async into a ring
//   (mbarriers); the consumers split each chunk once into a hi-byte and
//   a lo-byte plane, and fill the next group of steps while the tensor
//   cores run the last. Bound (measured on the H100): the latency chain
//   that fills a group (barrier, plane loads, byte stores, proxy fence,
//   barrier, wgmma fence/commit/wait), which the tensor-core work
//   overlaps little: alone it takes ~2/3 of the time at NW = 16 and ~1/2
//   at NW = 80, where the tensor cores are busy ~3/5 of the time at the
//   int8 rate. The warp-level (m16n8k32) design it
//   replaces gave every block 16 hi rows (2048 bins), so at D = 9234 five
//   blocks each re-read and re-split the whole row, rebuilt both
//   fragments per 8-wide tile with emulated byte compares, and at 8 warps
//   did not hide its loads: it was slower than the plain version.
// - hist_row_kernel replaces `tools/prof_pk.py::hist_v2` (P2), whose idea
//   is the row relaid on chip at once. One CTA per row holds the row's
//   whole histogram in shared memory (up to kMaxRowBins bins) and the row
//   itself beside it: a producer warp issues TMA bulk copies
//   (`cp.async.bulk`) of the whole row at the start, in pieces of
//   kRowChunk values (15.5 KB), each completing on its own mbarrier. 992
//   consumer threads zero the bins while the pieces fly, then count each
//   piece as it lands (16-byte shared loads, one shared atomic a value)
//   with no block barrier per piece, and write the bins out once with
//   16-byte stores. Where the row and the bins outgrow a CTA's 227 KB, the
//   same pieces go round a ring of slots with empty mbarriers (the "ring"
//   route, chosen by shape). Bound: the row's bytes from device memory and
//   one SM's shared-atomic rate per row; at the bench window's sizes a
//   launch's fixed cost (~2.4 us, measured on B2) weighs as much. Adds of
//   one value by lanes of one warp are rare on the bench rows: replicated
//   bins and warp-aggregated adds (`__match_any_sync`) both measured no
//   faster than plain atomics on the card (PERF.md), so neither is kept.
// - scatter_tile_kernel replaces `tools/prof_pk.py::pallas_scatter` (P3),
//   whose idea is a grid over D tiles, each tile re-reading the row. One
//   CTA per (D tile, row) holds NP planes of its tile's accumulators in
//   shared memory, the tiles as wide as one CTA's 227 KB holds beside a
//   ring of 4 stages, so a row takes the fewest tiles. Its producer thread
//   keeps TMA bulk copies of the row's ranks and payloads in flight into
//   the ring of chunk slots (a full and an empty mbarrier a stage). Two
//   groups of 256 consumer threads take alternate chunks, one 16-byte quad
//   a thread, keep the ranks in their tile and add the cut payloads with
//   shared atomics (uint32, which wrap like int32), then release the stage
//   (one arrival a warp of the group). The zeroing overlaps the first
//   loads and the write-out is coalesced 16-byte stores. No global atomics
//   and no zero fill. Bound: the row read once per tile (from L2 after the
//   first: a call's inputs were just written) and the outputs written
//   once. Tiles that form a cluster fed by one multicast load, and
//   narrower tiles with two CTAs to an SM, both measured slower on the
//   card (PERF.md).
//
// P2 and P3 stage rows by one piece plan (`row_pieces`, mirrored by
// ops/pk_cuda.py::row_pieces). A bulk copy needs 16-byte-aligned global
// and shared addresses and a multiple of 16 bytes, and a row of int32
// starts on any 4-byte boundary (row b of [B, N] at b * N values). The
// bulk copies take the row's aligned middle, in chunks that land at the
// start of their slots; the < 4 values before it and the < 4 after it
// are read by consumer threads with plain loads while the first chunks
// fly.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;  // bins per hi value (lo = v & 127)
// hist_wgmma: two consumer warpgroups (lo 0..63, 64..127) and a producer
// warp; a ring of kStages chunks of kChunk values (64 steps of 32); steps
// in groups of kGroup (one per consumer warp), two sets of a group's A and
// B tiles in shared memory; at most kMaxHiTile hi rows per block (< 255,
// so the sentinel 0xFF is never a row). ops/pk_cuda.py mirrors kMaxHiTile.
constexpr int kConsumers = 256;
constexpr int kWgmmaThreads = kConsumers + 32;
constexpr int kChunk = 2048;
constexpr int kStages = 4;
constexpr int kGroup = 8;
constexpr int kSets = 2;
constexpr int kMaxHiTile = 240;
static_assert(kGroup * 32 == kConsumers && (kChunk / 32) % kGroup == 0,
              "a consumer thread owns one column of a group");
// P2 and P3 (mirrored by ops/pk_cuda.py). P3: two groups of 256 consumer
// threads, taking alternate chunks, and a producer warp; chunks of
// kTileChunk values (256 quads, one per thread of a group); a ring of 2 to
// 8 stages. P2: 992 consumer threads and a producer warp; pieces of
// kRowChunk values (one quad per consumer).
constexpr int kTileGroup = 256;
constexpr int kTileGroups = 2;
constexpr int kTileConsumers = kTileGroups * kTileGroup;
constexpr int kTileThreads = kTileConsumers + 32;
constexpr int kTileChunk = 4 * kTileGroup;
constexpr int kMinStages = 2;
constexpr int kMaxStages = 8;
constexpr int kRowConsumers = 992;
constexpr int kRowThreads = kRowConsumers + 32;
constexpr int kRowChunk = 4 * kRowConsumers;
constexpr int kMaxRowBins = 48 * 1024;
constexpr int kMaxPayloads = 4;
constexpr int kMaxSmemBytes = 232448;
// N and D up to 2^30 keep every index and offset below in int.
constexpr int kMaxExtent = 1 << 30;

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// Arrives on `bar` once every cp.async this thread issued before has landed.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// The two consumer warpgroups only (the producer warp does not take part).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// Shared-memory descriptor of a K-major, unswizzled s8 tile (A or B):
// core matrices of 8 rows x 16 bytes (128 contiguous bytes); the two
// 16-byte halves of a row's 32 bytes of K lie 128 bytes apart (LBO), groups
// of 8 rows 256 bytes apart (SBO). Byte (row r, k) of a tile lies at
// tile_offset(r, k).
__device__ __forceinline__ int tile_offset(int r, int k) {
  return (r >> 3) * 256 + (k >> 4) * 128 + (r & 7) * 16 + (k & 15);
}

__device__ __forceinline__ uint64_t smem_desc(const void* tile) {
  return static_cast<uint64_t>((smem_u32(tile) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// D[64 x NW] (s32) += A[64 x 32] (s8) * B[32 x NW] (s8), both K-major in
// shared memory: one wgmma.mma_async.m64nNWk32 per width that PTX allows
// for s8 up to kMaxHiTile. The accumulator takes NW / 2 registers per
// thread.
template <int NW>
__device__ void wgmma_s8(int32_t (&d)[NW / 2], uint64_t a_desc,
                         uint64_t b_desc);

#define WG_R4 "%0, %1, %2, %3"
#define WG_R8 WG_R4 ", %4, %5, %6, %7"
#define WG_R12 WG_R8 ", %8, %9, %10, %11"
#define WG_R16 WG_R12 ", %12, %13, %14, %15"
#define WG_R20 WG_R16 ", %16, %17, %18, %19"
#define WG_R24 WG_R20 ", %20, %21, %22, %23"
#define WG_R28 WG_R24 ", %24, %25, %26, %27"
#define WG_R32 WG_R28 ", %28, %29, %30, %31"
#define WG_R36 WG_R32 ", %32, %33, %34, %35"
#define WG_R40 WG_R36 ", %36, %37, %38, %39"
#define WG_R44 WG_R40 ", %40, %41, %42, %43"
#define WG_R48 WG_R44 ", %44, %45, %46, %47"
#define WG_R52 WG_R48 ", %48, %49, %50, %51"
#define WG_R56 WG_R52 ", %52, %53, %54, %55"
#define WG_R60 WG_R56 ", %56, %57, %58, %59"
#define WG_R64 WG_R60 ", %60, %61, %62, %63"
#define WG_R68 WG_R64 ", %64, %65, %66, %67"
#define WG_R72 WG_R68 ", %68, %69, %70, %71"
#define WG_R76 WG_R72 ", %72, %73, %74, %75"
#define WG_R80 WG_R76 ", %76, %77, %78, %79"
#define WG_R84 WG_R80 ", %80, %81, %82, %83"
#define WG_R88 WG_R84 ", %84, %85, %86, %87"
#define WG_R92 WG_R88 ", %88, %89, %90, %91"
#define WG_R96 WG_R92 ", %92, %93, %94, %95"
#define WG_R100 WG_R96 ", %96, %97, %98, %99"
#define WG_R104 WG_R100 ", %100, %101, %102, %103"
#define WG_R108 WG_R104 ", %104, %105, %106, %107"
#define WG_R112 WG_R108 ", %108, %109, %110, %111"
#define WG_R116 WG_R112 ", %112, %113, %114, %115"
#define WG_R120 WG_R116 ", %116, %117, %118, %119"

#define WG_C4AT(d, i) "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3])
#define WG_C4(d) WG_C4AT(d, 0)
#define WG_C8(d) WG_C4(d), WG_C4AT(d, 4)
#define WG_C12(d) WG_C8(d), WG_C4AT(d, 8)
#define WG_C16(d) WG_C12(d), WG_C4AT(d, 12)
#define WG_C20(d) WG_C16(d), WG_C4AT(d, 16)
#define WG_C24(d) WG_C20(d), WG_C4AT(d, 20)
#define WG_C28(d) WG_C24(d), WG_C4AT(d, 24)
#define WG_C32(d) WG_C28(d), WG_C4AT(d, 28)
#define WG_C36(d) WG_C32(d), WG_C4AT(d, 32)
#define WG_C40(d) WG_C36(d), WG_C4AT(d, 36)
#define WG_C44(d) WG_C40(d), WG_C4AT(d, 40)
#define WG_C48(d) WG_C44(d), WG_C4AT(d, 44)
#define WG_C52(d) WG_C48(d), WG_C4AT(d, 48)
#define WG_C56(d) WG_C52(d), WG_C4AT(d, 52)
#define WG_C60(d) WG_C56(d), WG_C4AT(d, 56)
#define WG_C64(d) WG_C60(d), WG_C4AT(d, 60)
#define WG_C68(d) WG_C64(d), WG_C4AT(d, 64)
#define WG_C72(d) WG_C68(d), WG_C4AT(d, 68)
#define WG_C76(d) WG_C72(d), WG_C4AT(d, 72)
#define WG_C80(d) WG_C76(d), WG_C4AT(d, 76)
#define WG_C84(d) WG_C80(d), WG_C4AT(d, 80)
#define WG_C88(d) WG_C84(d), WG_C4AT(d, 84)
#define WG_C92(d) WG_C88(d), WG_C4AT(d, 88)
#define WG_C96(d) WG_C92(d), WG_C4AT(d, 92)
#define WG_C100(d) WG_C96(d), WG_C4AT(d, 96)
#define WG_C104(d) WG_C100(d), WG_C4AT(d, 100)
#define WG_C108(d) WG_C104(d), WG_C4AT(d, 104)
#define WG_C112(d) WG_C108(d), WG_C4AT(d, 108)
#define WG_C116(d) WG_C112(d), WG_C4AT(d, 112)
#define WG_C120(d) WG_C116(d), WG_C4AT(d, 116)

// K = NW / 2 accumulator registers %0..%K-1, then the A and B descriptors
// %K and %K+1 and scale-d %K+2 (1: accumulate).
#define WGMMA_S8(NW, K, ADESC, BDESC, SCALE)                                 \
  template <>                                                               \
  __device__ __forceinline__ void wgmma_s8<NW>(int32_t(&d)[K],              \
                                               uint64_t a_desc,             \
                                               uint64_t b_desc) {           \
    asm volatile(                                                           \
        "{\n.reg .pred p;\nsetp.ne.b32 p, " SCALE ", 0;\n"                  \
        "wgmma.mma_async.sync.aligned.m64n" #NW "k32.s32.s8.s8 {" WG_R##K \
        "}, " ADESC ", " BDESC ", p;\n}\n"                                  \
        : WG_C##K(d)                                                        \
        : "l"(a_desc), "l"(b_desc), "r"(1)                                  \
        : "memory");                                                        \
  }

WGMMA_S8(8, 4, "%4", "%5", "%6")
WGMMA_S8(16, 8, "%8", "%9", "%10")
WGMMA_S8(24, 12, "%12", "%13", "%14")
WGMMA_S8(32, 16, "%16", "%17", "%18")
WGMMA_S8(48, 24, "%24", "%25", "%26")
WGMMA_S8(64, 32, "%32", "%33", "%34")
WGMMA_S8(80, 40, "%40", "%41", "%42")
WGMMA_S8(96, 48, "%48", "%49", "%50")
WGMMA_S8(112, 56, "%56", "%57", "%58")
WGMMA_S8(128, 64, "%64", "%65", "%66")
WGMMA_S8(144, 72, "%72", "%73", "%74")
WGMMA_S8(160, 80, "%80", "%81", "%82")
WGMMA_S8(176, 88, "%88", "%89", "%90")
WGMMA_S8(192, 96, "%96", "%97", "%98")
WGMMA_S8(208, 104, "%104", "%105", "%106")
WGMMA_S8(224, 112, "%112", "%113", "%114")
WGMMA_S8(240, 120, "%120", "%121", "%122")

// P1. Grid (hi tiles, B); threads: two consumer warpgroups (0..255), then
// the producer warp. Dynamic shared memory, in order: kSets sets of kGroup
// A tiles (128 lo rows x 32 bytes) and of kGroup B tiles (NW hi rows x 32
// bytes), all K-major (tile_offset); the ring of kStages raw chunks of
// kChunk int32 values; the chunk being consumed split into a hi-byte plane
// and a lo-byte plane (kChunk bytes each); the full and empty mbarriers of
// the ring.
//
// Step s covers values 32s..32s+31 of the row: the product's K. Its A tile
// is the lo one-hot (A[lo_k, k] = 1), its B tile the hi one-hot
// (B[hi_k - hbase, k] = 1): 32 ones in each. Valid values carry
// hi - hbase < NW in the hi plane; every other value (below 0, at or past
// D, outside this tile, past N) carries `sentinel` >= NW and sets no byte
// of B, so its column of the product is zero. Consumer warpgroup w issues
// wgmma on lo rows 64w..64w+63 of A (its m64 tile) and all of B.
//
// The tiles stay zero but for those ones: consumer thread tid owns column
// k = tid % 32 of step tid / 32 of a group, writes that column's two ones,
// and clears them when it next fills the same tile set. No other thread
// touches the column, so program order is the only order the clear and the
// next set need. Building a step thus costs 32 threads four byte stores,
// where comparing bytes to build whole one-hot tiles cost every thread
// ~30 instructions per step (measured: the tensor cores waited on it).
//
// Steps go in groups of kGroup, one per consumer warp, with kSets = 2 tile
// sets: group j's wgmmas are issued; the threads wait for their own group
// j-1 and meet at a barrier (so both warpgroups' reads of set (j+1) % 2 are
// done), fill group j+1 into that set, fence the stores into the async
// proxy and meet again; then group j+1 is issued while group j may still
// run.
template <int NW>
__global__ void __launch_bounds__(kWgmmaThreads, 1)
    hist_wgmma_kernel(const int32_t* __restrict__ values,
                      int32_t* __restrict__ out, int N, int D,
                      uint32_t sentinel, bool vec) {
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  constexpr int kATile = kLanes * 32;
  constexpr int kBTile = NW * 32;
  unsigned char* a_sets = wg_smem;
  unsigned char* b_sets = a_sets + kSets * kGroup * kATile;
  int32_t* raw = reinterpret_cast<int32_t*>(b_sets + kSets * kGroup * kBTile);
  unsigned char* hi_plane = reinterpret_cast<unsigned char*>(raw + kStages * kChunk);
  unsigned char* lo_plane = hi_plane + kChunk;
  uint64_t* full = reinterpret_cast<uint64_t*>(lo_plane + kChunk);
  uint64_t* empty = full + kStages;

  const int b = blockIdx.y;
  const int hbase = blockIdx.x * NW;
  const int hcount = min(NW, (D + kLanes - 1) / kLanes - hbase);
  const int32_t* row = values + static_cast<size_t>(b) * N;
  const int nchunks = (N + kChunk - 1) / kChunk;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 32);
      mbar_init(&empty[i], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // The producer warp: chunk c into ring slot c % kStages once the
    // consumers have released it; each lane's copies arrive on full[slot].
    const int lane = threadIdx.x - kConsumers;
    for (int c = 0; c < nchunks; ++c) {
      const int st = c % kStages;
      if (c >= kStages) mbar_wait(&empty[st], (c / kStages - 1) & 1);
      const int base = c * kChunk;
      const int len = min(kChunk, N - base);
      int32_t* dst = raw + st * kChunk;
      if (vec) {
        for (int i = 4 * lane; i < len; i += 128) {
          cp_async16(dst + i, row + base + i);
        }
      } else {
        for (int i = lane; i < len; i += 32) cp_async4(dst + i, row + base + i);
      }
      cp_async_arrive(&full[st]);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int g = (tid & 31) >> 2;
  const int t = tid & 3;
  const int r0 = 64 * wg + 16 * ((tid >> 5) & 3) + g;
  constexpr int kChunkSteps = kChunk / 32;
  const int my_step = tid >> 5;  // this thread's column: value k of a step
  const int my_k = tid & 31;

  // Chunk c from its ring slot into the planes, 8 values per thread; the
  // slot goes back to the producer. The planes are free: every read of the
  // previous chunk's planes came before the barrier that ended a group.
  auto split = [&](int c) {
    const int st = c % kStages;
    mbar_wait(&full[st], (c / kStages) & 1);
    const int4* src =
        reinterpret_cast<const int4*>(raw + st * kChunk + 8 * tid);
    const int4 q0 = src[0], q1 = src[1];
    const int32_t v[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
    const int n0 = c * kChunk + 8 * tid;
    uint32_t hw[2] = {0, 0}, lw[2] = {0, 0};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int dh = (v[i] >> 7) - hbase;
      const bool in = n0 + i < N && v[i] >= 0 && v[i] < D &&
                      static_cast<unsigned>(dh) < static_cast<unsigned>(hcount);
      hw[i >> 2] |= (in ? static_cast<uint32_t>(dh) : sentinel) << (8 * (i & 3));
      lw[i >> 2] |= static_cast<uint32_t>(v[i] & 127) << (8 * (i & 3));
    }
    *reinterpret_cast<uint2*>(hi_plane + 8 * tid) = make_uint2(hw[0], hw[1]);
    *reinterpret_cast<uint2*>(lo_plane + 8 * tid) = make_uint2(lw[0], lw[1]);
    mbar_arrive(&empty[st]);
    consumers_sync();
  };

  // Group j into tile set j % 2: clear this thread's two ones of the set's
  // last group (offsets oa, ob; -1 for none), then set the new ones.
  auto fill = [&](int j, int& oa, int& ob) {
    unsigned char* at = a_sets + (j & 1) * kGroup * kATile;
    unsigned char* bt = b_sets + (j & 1) * kGroup * kBTile;
    if (oa >= 0) at[oa] = 0;
    if (ob >= 0) bt[ob] = 0;
    const int p = (j * kGroup % kChunkSteps) * 32 + tid;
    const int lo = lo_plane[p];
    const int hb = hi_plane[p];
    oa = my_step * kATile + tile_offset(lo, my_k);
    at[oa] = 1;
    ob = hb < NW ? my_step * kBTile + tile_offset(hb, my_k) : -1;
    if (ob >= 0) bt[ob] = 1;
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    consumers_sync();
  };

  int32_t acc[NW / 2];
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) acc[i] = 0;
  // Steps past N (up to a whole group, inside the last chunk) read hi
  // bytes that hold the sentinel: they add nothing.
  const int groups = (N + 32 * kGroup - 1) / (32 * kGroup);
  if (groups > 0) {
    uint4* zero = reinterpret_cast<uint4*>(wg_smem);
    for (int i = tid; i < kSets * kGroup * (kATile + kBTile) / 16;
         i += kConsumers) {
      zero[i] = make_uint4(0, 0, 0, 0);
    }
    const uint64_t a_desc = smem_desc(a_sets + wg * (kATile / 2));
    const uint64_t b_desc = smem_desc(b_sets);
    int oa0 = -1, ob0 = -1, oa1 = -1, ob1 = -1;
    split(0);  // its barrier also ends the zero fill
    fill(0, oa0, ob0);
    auto issue = [&](int j) {
      wgmma_fence();
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        const int tile = (j & 1) * kGroup + i;
        wgmma_s8<NW>(acc, a_desc + ((tile * kATile) >> 4),
                     b_desc + ((tile * kBTile) >> 4));
      }
      wgmma_commit();
    };
    auto prepare = [&](int j, int& oa, int& ob) {
      wgmma_wait<1>();
      consumers_sync();
      if (j * kGroup % kChunkSteps == 0) split(j * kGroup / kChunkSteps);
      fill(j, oa, ob);
    };
    for (int j = 0; j < groups; j += 2) {
      issue(j);
      if (j + 1 < groups) {
        prepare(j + 1, oa1, ob1);
        issue(j + 1);
      }
      if (j + 2 < groups) prepare(j + 2, oa0, ob0);
    }
    wgmma_wait<0>();
  }

  // Accumulator register 4j + i holds lo row r0 + 8 (i >> 1), hi column
  // 8j + 2t + (i & 1). Padded hi rows and bins past D are not stored.
  int32_t* orow = out + static_cast<size_t>(b) * D;
#pragma unroll
  for (int j = 0; j < NW / 8; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int dh = 8 * j + 2 * t + (i & 1);
      const int d = (hbase + dh) * kLanes + r0 + 8 * (i >> 1);
      if (dh < hcount && d < D) orow[d] = acc[4 * j + i];
    }
  }
}

template <int NW>
int launch_hist_wgmma(const int32_t* values, int32_t* out, int B, int N,
                      int D, int tiles, uint32_t sentinel, bool vec,
                      cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kSets) * kGroup * (kLanes + NW) * 32 +
                      static_cast<size_t>(kStages) * kChunk * 4 + 2 * kChunk +
                      2 * kStages * sizeof(uint64_t);
  cudaError_t e = cudaFuncSetAttribute(
      hist_wgmma_kernel<NW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  hist_wgmma_kernel<NW><<<dim3(tiles, B), kWgmmaThreads, smem, stream>>>(
      values, out, N, D, sentinel, vec);
  return static_cast<int>(cudaGetLastError());
}

// ---- P2 and P3: rows staged by TMA bulk copies ----

__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar,
                                                   uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// One bulk copy (TMA) of `bytes` (a multiple of 16; both addresses
// 16-byte aligned) from global into this CTA's shared memory, completing
// on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// As mbar_wait, but a wait past 2^34 cycles (~10 s) traps: a fault in the
// barrier protocol fails the launch with an error instead of hanging.
__device__ __forceinline__ void mbar_wait_bounded(uint64_t* bar,
                                                  uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long t0 = clock64();
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > (1LL << 34)) __trap();
  } while (!done);
}

// Named barrier 1 over the first n threads of the CTA (the consumers).
__device__ __forceinline__ void named_sync(int n) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(n) : "memory");
}

__device__ __forceinline__ int misalign(const void* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

// The piece plan of a row of N values at `row`: the bulk copies take its
// 16-byte-aligned middle [head, head + nb) (nb a multiple of 4), in chunks
// that land at the start of their slots; the head [0, head) and the tail
// [head + nb, N) hold < 4 values each and are read with plain loads.
struct RowPieces {
  int head, nb;
};

__device__ __forceinline__ RowPieces row_pieces(const int32_t* row, int N) {
  RowPieces p;
  p.head = min((4 - misalign(row)) & 3, N);
  p.nb = (N - p.head) & ~3;
  return p;
}

// Index j < N of edge value `t` (0-7) of a row: t < 4 the head's, t >= 4
// the tail's; -1 where the row has none.
__device__ __forceinline__ int edge_index(const RowPieces& p, int N, int t) {
  const int j = t < 4 ? (t < p.head ? t : -1) : p.head + p.nb + t - 4;
  return t < 8 && j < N ? j : -1;
}

// Words of the staged route's slots: piece c at c * kRowChunk, the middle
// of any row at most N & ~3 values.
__host__ __device__ __forceinline__ int staged_words(int N) { return N & ~3; }

__host__ __device__ __forceinline__ int row_plane(int D) {
  return (D + 3) / 4 * 4 + 4;
}

struct RowArgs {
  const int32_t* values;
  int32_t* out;
  int N, D, slots;
};

// P2. Grid (B); threads: kRowConsumers consumers, then the producer warp.
// Dynamic shared memory: the slots (staged: one per piece; ring: `slots`
// of kRowChunk words), the bins (row_plane(D) words), then the full and
// the empty mbarriers of each slot.
__global__ void __launch_bounds__(kRowThreads)
    hist_row_kernel(const RowArgs a) {
  extern __shared__ __align__(16) int32_t row_smem[];
  const bool ring = a.slots < (a.N + kRowChunk - 1) / kRowChunk;
  uint32_t* bins = reinterpret_cast<uint32_t*>(
      row_smem + (ring ? a.slots * kRowChunk : staged_words(a.N)));
  uint64_t* full = reinterpret_cast<uint64_t*>(bins + row_plane(a.D));
  uint64_t* empty = full + a.slots;
  const int32_t* row = a.values + static_cast<size_t>(blockIdx.x) * a.N;
  int32_t* orow = a.out + static_cast<size_t>(blockIdx.x) * a.D;
  const RowPieces rp = row_pieces(row, a.N);
  const int nchunks = (rp.nb + kRowChunk - 1) / kRowChunk;
  if (threadIdx.x == 0) {
    for (int i = 0; i < a.slots; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kRowConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kRowConsumers) {
    // The producer: every piece of the middle at once (staged), or piece
    // c into slot c % slots once the consumers have released it (ring).
    if (threadIdx.x > kRowConsumers) return;
    for (int c = 0; c < nchunks; ++c) {
      const int st = c % a.slots;
      if (c >= a.slots) mbar_wait_bounded(&empty[st], (c / a.slots - 1) & 1);
      const uint32_t bytes =
          static_cast<uint32_t>(min(kRowChunk, rp.nb - c * kRowChunk)) * 4;
      mbar_arrive_expect(&full[st], bytes);
      bulk_load(row_smem + st * kRowChunk, row + rp.head + c * kRowChunk, bytes,
                &full[st]);
    }
    return;
  }

  const int tid = threadIdx.x;
  // Bin d at pad + d, so that the write-out's 16-byte stores read
  // 16-byte-aligned shared words.
  const int pad = misalign(orow);
  uint4* bins4 = reinterpret_cast<uint4*>(bins);
  for (int i = tid; i < row_plane(a.D) / 4; i += kRowConsumers)
    bins4[i] = make_uint4(0u, 0u, 0u, 0u);
  named_sync(kRowConsumers);
  uint32_t* s0 = bins + pad;
  const unsigned D = static_cast<unsigned>(a.D);
  if (tid < 32) {  // the head and the tail, while the pieces fly
    const int j = edge_index(rp, a.N, tid);
    const int v = j >= 0 ? __ldg(row + j) : -1;
    if (static_cast<unsigned>(v) < D) atomicAdd(s0 + v, 1u);
  }
  for (int c = 0; c < nchunks; ++c) {
    const int st = c % a.slots;
    const int nq = min(kRowChunk, rp.nb - c * kRowChunk) / 4;
    const int4* slot = reinterpret_cast<const int4*>(row_smem + st * kRowChunk);
    mbar_wait_bounded(&full[st], (c / a.slots) & 1);
    if (tid < nq) {  // quad tid of the piece
      const int4 v = slot[tid];
      if (static_cast<unsigned>(v.x) < D) atomicAdd(s0 + v.x, 1u);
      if (static_cast<unsigned>(v.y) < D) atomicAdd(s0 + v.y, 1u);
      if (static_cast<unsigned>(v.z) < D) atomicAdd(s0 + v.z, 1u);
      if (static_cast<unsigned>(v.w) < D) atomicAdd(s0 + v.w, 1u);
    }
    if (ring) {
      __syncwarp();
      if ((tid & 31) == 0) mbar_arrive(&empty[st]);
    }
  }
  named_sync(kRowConsumers);
  const int head = min((4 - pad) & 3, a.D);
  if (tid < head) orow[tid] = static_cast<int32_t>(s0[tid]);
  const int nq = (a.D - head) / 4;
  for (int q = tid; q < nq; q += kRowConsumers)
    *reinterpret_cast<uint4*>(orow + head + 4 * q) =
        *reinterpret_cast<const uint4*>(s0 + head + 4 * q);
  for (int d = head + 4 * nq + tid; d < a.D; d += kRowConsumers)
    orow[d] = static_cast<int32_t>(s0[d]);
}

struct TileArgs {
  const int32_t* src[1 + kMaxPayloads];  // ranks, then the payloads
  int32_t* out[kMaxPayloads];
  int N, D, bins, stages;
  uint32_t cut;
};

// Add head or tail value j of the row, read from global memory, into the
// tile's accumulators.
template <int NP>
__device__ __forceinline__ void add_from_global(const TileArgs& a, size_t base,
                                                int j, int lo, unsigned width,
                                                uint32_t* acc, int plane,
                                                const int (&pad)[NP]) {
  const unsigned o = static_cast<unsigned>(__ldg(a.src[0] + base + j)) -
                     static_cast<unsigned>(lo);
  if (o >= width) return;
#pragma unroll
  for (int k = 0; k < NP; ++k)
    atomicAdd(acc + k * plane + pad[k] + o,
              static_cast<uint32_t>(__ldg(a.src[1 + k] + base + j)) & a.cut);
}

// P3. Grid (tiles, B); threads: kTileConsumers consumers, then the
// producer warp. Dynamic shared memory: the ring (`stages` stages of 1 +
// NP slots of kTileChunk words: ranks, then each payload), NP planes of
// bins + 4 accumulators, then the full and the empty mbarriers of each
// stage. Tile t owns bins [t * bins, (t + 1) * bins) of the row (none
// past D). The producer refills a stage once the group that took its
// last chunk has released it. A payload whose rows sit at another
// 16-byte offset than the ranks' is not staged: the consumers read it
// from global memory. Registers for two CTAs an SM, which tiles of a
// small D leave the shared memory for.
template <int NP>
__global__ void __launch_bounds__(kTileThreads, 2)
    scatter_tile_kernel(const TileArgs a) {
  constexpr int kArrays = 1 + NP;
  extern __shared__ __align__(16) int32_t tile_smem[];
  uint32_t* acc = reinterpret_cast<uint32_t*>(tile_smem + a.stages * kArrays * kTileChunk);
  const int plane = a.bins + 4;
  uint64_t* full = reinterpret_cast<uint64_t*>(acc + NP * plane);
  uint64_t* empty = full + a.stages;
  const int b = blockIdx.y;
  const int lo = blockIdx.x * a.bins;
  const unsigned width = static_cast<unsigned>(max(0, min(a.bins, a.D - lo)));
  const size_t base = static_cast<size_t>(b) * a.N;
  const RowPieces rp = row_pieces(a.src[0] + base, a.N);
  const int nchunks = (rp.nb + kTileChunk - 1) / kTileChunk;
  bool staged[kArrays];
#pragma unroll
  for (int k = 0; k < kArrays; ++k)
    staged[k] = misalign(a.src[k] + base) == misalign(a.src[0] + base);
  if (threadIdx.x == 0) {
    for (int i = 0; i < a.stages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kTileGroup / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x == kTileConsumers) {
    for (int c = 0; c < nchunks; ++c) {
      const int st = c % a.stages;
      if (c >= a.stages) mbar_wait_bounded(&empty[st], (c / a.stages - 1) & 1);
      const int s = rp.head + c * kTileChunk;
      const uint32_t bytes =
          static_cast<uint32_t>(min(kTileChunk, rp.nb - c * kTileChunk)) * 4;
      uint32_t tx = 0;
#pragma unroll
      for (int k = 0; k < kArrays; ++k) tx += staged[k] ? bytes : 0;
      mbar_arrive_expect(&full[st], tx);
#pragma unroll
      for (int k = 0; k < kArrays; ++k) {
        if (staged[k])
          bulk_load(tile_smem + (st * kArrays + k) * kTileChunk,
                    a.src[k] + base + s, bytes, &full[st]);
      }
    }
  } else if (threadIdx.x < kTileConsumers) {
    const int tid = threadIdx.x;
    // Accumulator i of plane k at k * plane + pad[k] + i, so that the
    // write-out's 16-byte stores read 16-byte-aligned shared words.
    int pad[NP];
#pragma unroll
    for (int k = 0; k < NP; ++k)
      pad[k] = misalign(a.out[k] + static_cast<size_t>(b) * a.D + lo);
    uint4* acc4 = reinterpret_cast<uint4*>(acc);
    for (int i = tid; i < NP * plane / 4; i += kTileConsumers)
      acc4[i] = make_uint4(0u, 0u, 0u, 0u);
    named_sync(kTileConsumers);
    {  // the head and the tail, while the first chunks fly
      const int j = edge_index(rp, a.N, tid);
      if (j >= 0) add_from_global<NP>(a, base, j, lo, width, acc, plane, pad);
    }
    // Group g takes chunks g, g + kTileGroups, ...; thread gt of it quad gt.
    const int gt = tid % kTileGroup;
    for (int c = tid / kTileGroup; c < nchunks; c += kTileGroups) {
      const int st = c % a.stages;
      const int nq = min(kTileChunk, rp.nb - c * kTileChunk) / 4;
      const int4* slots = reinterpret_cast<const int4*>(
          tile_smem + st * kArrays * kTileChunk);
      mbar_wait_bounded(&full[st], (c / a.stages) & 1);
      if (gt < nq) {
        const int n = rp.head + c * kTileChunk + 4 * gt;  // value of lane .x
        const int4 rq = slots[gt];
        const int32_t rv[4] = {rq.x, rq.y, rq.z, rq.w};
        uint32_t pv[NP][4];
#pragma unroll
        for (int k = 0; k < NP; ++k) {
          if (staged[1 + k]) {
            const int4 q = slots[(1 + k) * (kTileChunk / 4) + gt];
            pv[k][0] = q.x;
            pv[k][1] = q.y;
            pv[k][2] = q.z;
            pv[k][3] = q.w;
          } else {
#pragma unroll
            for (int i = 0; i < 4; ++i) pv[k][i] = __ldg(a.src[1 + k] + base + n + i);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const unsigned o = static_cast<unsigned>(rv[i]) - static_cast<unsigned>(lo);
          if (o >= width) continue;
#pragma unroll
          for (int k = 0; k < NP; ++k)
            atomicAdd(acc + k * plane + pad[k] + o, pv[k][i] & a.cut);
        }
      }
      __syncwarp();
      if ((tid & 31) == 0) mbar_arrive(&empty[st]);
    }
    named_sync(kTileConsumers);
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      int32_t* o = a.out[k] + static_cast<size_t>(b) * a.D + lo;
      const uint32_t* s0 = acc + k * plane + pad[k];
      const int w = static_cast<int>(width);
      const int head = min((4 - pad[k]) & 3, w);
      if (tid < head) o[tid] = static_cast<int32_t>(s0[tid]);
      const int nq = (w - head) / 4;
      for (int q = tid; q < nq; q += kTileConsumers)
        *reinterpret_cast<uint4*>(o + head + 4 * q) =
            *reinterpret_cast<const uint4*>(s0 + head + 4 * q);
      for (int d = head + 4 * nq + tid; d < w; d += kTileConsumers)
        o[d] = static_cast<int32_t>(s0[d]);
    }
  }
}

long long tile_smem_bytes(int NP, int bins, int stages) {
  return 4LL * stages * (1 + NP) * kTileChunk + 4LL * NP * (bins + 4) +
         2LL * stages * sizeof(uint64_t);
}

long long row_smem_bytes(int N, int D, int slots) {
  const int pieces = (N + kRowChunk - 1) / kRowChunk;
  const long long words = slots < pieces ? 1LL * slots * kRowChunk : staged_words(N);
  return 4 * words + 4LL * row_plane(D) + 2LL * slots * sizeof(uint64_t);
}

template <int NP>
cudaError_t launch_scatter_tile(const TileArgs& a, int B, int tiles, int smem,
                                cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      scatter_tile_kernel<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  scatter_tile_kernel<NP><<<dim3(tiles, B), kTileThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out [B, D] int32 (every element written: no zero fill needed); values
// [B, N] int32, values outside [0, D) dropped. Both contiguous. Launches on
// `stream` and returns cudaGetLastError(). The launch plan (`hist_v1_plan`
// in ops/pk_cuda.py): `width` hi rows per block, a width wgmma takes for s8
// and <= kMaxHiTile; `tiles` blocks per row that cover the ceil(D / 128)
// hi rows with none empty; `sentinel` in [width, 255], the hi byte of
// values that count in no row of the block.
int dagcon_hist_wgmma(const void* values, void* out, int B, int N, int D,
                      int width, int tiles, int sentinel, void* stream) {
  if (B < 0 || N < 0 || D < 0 || B > 65535 || N > kMaxExtent ||
      D > kMaxExtent)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || D == 0) return 0;
  const long long hi = (D + kLanes - 1) / kLanes;
  if (width < 1 || width > kMaxHiTile || tiles < 1 ||
      static_cast<long long>(tiles) * width < hi ||
      static_cast<long long>(tiles - 1) * width >= hi || sentinel < width ||
      sentinel > 255)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* v = static_cast<const int32_t*>(values);
  auto* o = static_cast<int32_t*>(out);
  const auto s = static_cast<uint32_t>(sentinel);
  const bool vec = reinterpret_cast<uintptr_t>(values) % 16 == 0 && N % 4 == 0;
  const auto st = static_cast<cudaStream_t>(stream);
  switch (width) {
#define HIST_WGMMA_CASE(NW) \
  case NW:                  \
    return launch_hist_wgmma<NW>(v, o, B, N, D, tiles, s, vec, st);
    HIST_WGMMA_CASE(8) HIST_WGMMA_CASE(16) HIST_WGMMA_CASE(24)
    HIST_WGMMA_CASE(32) HIST_WGMMA_CASE(48) HIST_WGMMA_CASE(64)
    HIST_WGMMA_CASE(80) HIST_WGMMA_CASE(96) HIST_WGMMA_CASE(112)
    HIST_WGMMA_CASE(128) HIST_WGMMA_CASE(144) HIST_WGMMA_CASE(160)
    HIST_WGMMA_CASE(176) HIST_WGMMA_CASE(192) HIST_WGMMA_CASE(208)
    HIST_WGMMA_CASE(224) HIST_WGMMA_CASE(240)
#undef HIST_WGMMA_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// As dagcon_hist_wgmma, by P2 under the plan of ops/pk_cuda.py::
// hist_row_plan: `slots` piece slots (staged: one per piece, at least 1;
// ring: 2 or more, fewer than the pieces), `smem` dynamic shared bytes
// (row_smem_bytes, <= 227 KB); D <= kMaxRowBins.
int dagcon_hist_row(const void* values, void* out, int B, int N, int D,
                    int slots, int smem, void* stream) {
  if (B < 0 || N < 0 || D < 0 || B > 65535 || N > kMaxExtent ||
      D > kMaxRowBins)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || D == 0) return 0;
  const int nchunks = (N + kRowChunk - 1) / kRowChunk;
  const bool staged = slots == max(nchunks, 1);
  const bool ring = slots >= 2 && slots < nchunks;
  if (!(staged || ring) || smem != row_smem_bytes(N, D, slots) ||
      smem > kMaxSmemBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(
      hist_row_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  RowArgs a{static_cast<const int32_t*>(values), static_cast<int32_t*>(out),
            N, D, slots};
  hist_row_kernel<<<B, kRowThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// outs[k] [B, D] int32 (every element written); ranks [B, N] int32 (values
// outside [0, D) dropped); payloads[k] [B, N] int32; 1 <= NP <= 4. All
// contiguous. The plan of ops/pk_cuda.py::tile_plan: `tiles` tiles of
// `bins` bins per row (bins % 4 == 0; none empty), `stages` ring stages (2
// to 8), `smem` dynamic shared bytes (tile_smem_bytes, at most 227 KB).
int dagcon_scatter_tile(const void* ranks, const void* const* payloads,
                        void* const* outs, int NP, int B, int N, int D,
                        unsigned int cut_mask, int tiles, int bins, int stages,
                        int smem, void* stream) {
  if (B < 0 || N < 0 || D < 0 || NP < 1 || NP > kMaxPayloads || B > 65535 ||
      N > kMaxExtent || D > kMaxExtent)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || D == 0) return 0;
  if (tiles < 1 || bins < 4 || bins % 4 != 0 ||
      static_cast<long long>(tiles) * bins < D ||
      static_cast<long long>(tiles - 1) * bins >= D ||
      stages < kMinStages || stages > kMaxStages ||
      smem != tile_smem_bytes(NP, bins, stages) || smem > kMaxSmemBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  TileArgs a{};
  a.src[0] = static_cast<const int32_t*>(ranks);
  for (int k = 0; k < NP; ++k) {
    a.src[1 + k] = static_cast<const int32_t*>(payloads[k]);
    a.out[k] = static_cast<int32_t*>(outs[k]);
  }
  a.N = N;
  a.D = D;
  a.bins = bins;
  a.stages = stages;
  a.cut = cut_mask;
  const auto st = static_cast<cudaStream_t>(stream);
  switch (NP) {
    case 1:
      return static_cast<int>(launch_scatter_tile<1>(a, B, tiles, smem, st));
    case 2:
      return static_cast<int>(launch_scatter_tile<2>(a, B, tiles, smem, st));
    case 3:
      return static_cast<int>(launch_scatter_tile<3>(a, B, tiles, smem, st));
    default:
      return static_cast<int>(launch_scatter_tile<4>(a, B, tiles, smem, st));
  }
}

const char* dagcon_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
