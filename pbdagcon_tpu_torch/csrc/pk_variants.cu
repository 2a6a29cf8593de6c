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
// - hist_row_kernel replaces `tools/prof_pk.py::hist_v2` (P2): one block
//   holds a row's whole histogram in shared memory (up to kMaxRowBins
//   bins), streams the row through a double-buffered cp.async stage,
//   counts with shared atomics and writes the row once, coalesced. No
//   global atomics, and the output needs no zero fill (B2 splits a row
//   over blocks and adds their bins into a zeroed output with global
//   atomics). Bound: one SM's shared-atomic rate per row, so B rows fill
//   at most B SMs.
// - scatter_tile_kernel replaces `tools/prof_pk.py::pallas_scatter` (P3):
//   grid (D tile, row). A block holds NP x T int32 accumulators of its
//   tile in shared memory, re-reads the row's ranks, adds the cut
//   payloads of the ranks in its tile with shared atomics (uint32, which
//   wrap like int32), and writes its tile out coalesced. No global
//   atomics and no zero fill (B3 adds into a zeroed output with global
//   atomics). Bound: re-reading the ranks once per tile and writing the
//   output once.

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
constexpr int kRowThreads = 1024;
// The shared-memory histogram of hist_row: 48K int32 bins (192 KB), plus
// two stage buffers of kStage values (32 KB), within the 227 KB a block
// may use.
constexpr int kMaxRowBins = 48 * 1024;
constexpr int kStage = 4096;
constexpr int kScatterThreads = 512;
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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// Copy `len` values from `src` into shared `dst` as one cp.async group:
// 16-byte copies when `vec` (src 16-byte aligned, len a multiple of 4).
__device__ __forceinline__ void stage_values(int32_t* dst,
                                             const int32_t* src, int len,
                                             bool vec) {
  if (vec) {
    for (int i = 4 * threadIdx.x; i < len; i += 4 * blockDim.x) {
      cp_async16(dst + i, src + i);
    }
  } else {
    for (int i = threadIdx.x; i < len; i += blockDim.x) {
      cp_async4(dst + i, src + i);
    }
  }
  cp_async_commit();
}

// Grid (B). Shared memory: bins [bins_pad] then two stage buffers.
__global__ void __launch_bounds__(kRowThreads)
    hist_row_kernel(const int32_t* __restrict__ values,
                    int32_t* __restrict__ out, int N, int D, int bins_pad,
                    bool vec) {
  extern __shared__ __align__(16) int32_t smem[];
  int32_t* bins = smem;
  int32_t* stage = smem + bins_pad;
  const int32_t* row = values + static_cast<size_t>(blockIdx.x) * N;
  const int nchunks = (N + kStage - 1) / kStage;
  if (nchunks > 0) stage_values(stage, row, min(kStage, N), vec);
  for (int d = threadIdx.x; d < D; d += blockDim.x) bins[d] = 0;
  for (int c = 0; c < nchunks; ++c) {
    if (c + 1 < nchunks) {
      const int next = (c + 1) * kStage;
      stage_values(stage + ((c + 1) & 1) * kStage, row + next,
                   min(kStage, N - next), vec);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int32_t* buf = stage + (c & 1) * kStage;
    const int len = min(kStage, N - c * kStage);
    for (int i = threadIdx.x; i < len; i += blockDim.x) {
      const int32_t v = buf[i];
      if (v >= 0 && v < D) atomicAdd(&bins[v], 1);
    }
    // The next iteration stages into the buffer just read.
    __syncthreads();
  }
  __syncthreads();
  int32_t* orow = out + static_cast<size_t>(blockIdx.x) * D;
  for (int d = threadIdx.x; d < D; d += blockDim.x) orow[d] = bins[d];
}

struct Payloads {
  const int32_t* p[kMaxPayloads];
  int32_t* out[kMaxPayloads];
};

// Grid (ceil(D / T), B). Shared memory: NP planes of T accumulators.
__global__ void __launch_bounds__(kScatterThreads)
    scatter_tile_kernel(const int32_t* __restrict__ ranks, Payloads pl,
                        int NP, int N, int D, int T, uint32_t cut_mask) {
  extern __shared__ uint32_t acc[];
  const int lo = blockIdx.x * T;
  const int width = min(T, D - lo);
  for (int i = threadIdx.x; i < NP * T; i += blockDim.x) acc[i] = 0;
  __syncthreads();
  const size_t base = static_cast<size_t>(blockIdx.y) * N;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    const int32_t r = ranks[base + n];
    if (r < lo || r >= lo + width) continue;
    const int o = r - lo;
#pragma unroll
    for (int k = 0; k < kMaxPayloads; ++k) {
      if (k < NP) {
        atomicAdd(&acc[k * T + o],
                  static_cast<uint32_t>(pl.p[k][base + n]) & cut_mask);
      }
    }
  }
  __syncthreads();
  const size_t obase = static_cast<size_t>(blockIdx.y) * D + lo;
#pragma unroll
  for (int k = 0; k < kMaxPayloads; ++k) {
    if (k < NP) {
      int32_t* orow = pl.out[k] + obase;
      for (int d = threadIdx.x; d < width; d += blockDim.x) {
        orow[d] = static_cast<int32_t>(acc[k * T + d]);
      }
    }
  }
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

// As dagcon_hist_wgmma without the plan; D <= kMaxRowBins (the shared-memory histogram).
int dagcon_hist_row(const void* values, void* out, int B, int N, int D,
                    void* stream) {
  if (B < 0 || N < 0 || D < 0 || N > kMaxExtent || D > kMaxRowBins)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || D == 0) return 0;
  const int bins_pad = (D + 3) / 4 * 4;
  const size_t smem = static_cast<size_t>(bins_pad + 2 * kStage) * 4;
  cudaError_t e = cudaFuncSetAttribute(
      hist_row_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const bool vec =
      reinterpret_cast<uintptr_t>(values) % 16 == 0 && N % 4 == 0;
  hist_row_kernel<<<B, kRowThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(values), static_cast<int32_t*>(out), N, D,
      bins_pad, vec);
  return static_cast<int>(cudaGetLastError());
}

// outs[k] [B, D] int32 (every element written); ranks [B, N] int32 (values
// outside [0, D) dropped); payloads[k] [B, N] int32; 1 <= NP <= 4. All
// contiguous. The tile T is the widest multiple of 128 whose NP planes fit
// the shared memory of a block, evened out over the tiles of a row.
int dagcon_scatter_tile(const void* ranks, const void* const* payloads,
                        void* const* outs, int NP, int B, int N, int D,
                        unsigned int cut_mask, void* stream) {
  if (B < 0 || N < 0 || D < 0 || NP < 1 || NP > kMaxPayloads || B > 65535 ||
      N > kMaxExtent || D > kMaxExtent)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || D == 0) return 0;
  Payloads pl{};
  for (int k = 0; k < NP; ++k) {
    pl.p[k] = static_cast<const int32_t*>(payloads[k]);
    pl.out[k] = static_cast<int32_t*>(outs[k]);
  }
  const int max_t = kMaxSmemBytes / (NP * 4) / kLanes * kLanes;
  const int tiles = (D + max_t - 1) / max_t;
  const int T = ((D + tiles - 1) / tiles + kLanes - 1) / kLanes * kLanes;
  const size_t smem = static_cast<size_t>(NP) * T * 4;
  cudaError_t e = cudaFuncSetAttribute(
      scatter_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(tiles, B);
  scatter_tile_kernel<<<grid, kScatterThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ranks), pl, NP, N, D, T, cut_mask);
  return static_cast<int>(cudaGetLastError());
}

const char* dagcon_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
