// Banded reverse max-plus consensus DP with a long-edge register file,
// for Hopper (sm_90a). Bound to PyTorch through a plain C interface
// (`dagcon_dp_scan`) loaded with ctypes by `ops/dp_cuda.py`.
//
// Replaces the TPU kernel `pbdagcon_tpu/ops/dp_pallas.py::_dp_kernel`
// (and with it the XLA scan and the blocked solve of `ops/dp.py`). The
// contract is `pbdagcon_tpu/ops/dp.py::dp_scores`: per target, for
// i = V-1 .. 0
//   s[i] = max( max_{d: win[i,d] >= 0} esc_d + s[i+1+d],
//               exit[i] >= 0 ? exit[i] : -inf,
//               max_{k: lu[k] == i} pend[k] )
//   esc_d = unsup[i+1+d] ? -10 : win[i,d] - 0.5 * cov[i+1+d]
// then pend[k] = lesc[k] + s[i] for every k with lw[k] == i.
// Nodes at or past V read as score -inf, cov 0, unsup 0.
//
// What bounds it on this card. The work is one pass over the int16 band:
// at the bench batch (B=512, V=5632, W=16, K=32) the band is 92.3 MB and
// all inputs and the output 118 MB, 35 us at 3.35 TB/s. But every node
// waits for the score of the node after it: a chain of V dependent steps
// per target, one warp per target (512 warps for 528 schedulers, so no
// other warp hides a stall). The first design (one warp max of all
// candidates per node: shared-memory ring reads, long-edge folds, five
// shuffles and a warp sync on the chain) took ~420 cycles per node,
// 1.34 ms. The chain itself is one add and one max per node (~8 cycles).
//
// What the design does about it:
// - s[i] = max(near(i), far(i)). near(i) holds the band terms d < D0
//   (and short long edges, below). Every lane computes it redundantly
//   from the last D0 scores kept in registers, so only the d = 0 term,
//   esc_0 + s[i+1], and one max wait on the previous step: no shuffle,
//   no shared memory and no warp sync sit between s[i+1] and s[i]. Each
//   chunk's near terms are made once, a row per lane, into a near table
//   in shared memory.
// - far(i) holds the exit, the band terms d >= D0 and the long edges
//   leaving i. The lanes split its terms; each lane reads the score of
//   its term from a register (lane l holds s[b+4+l+32t] at the start of
//   the group of rows [b, b+4)), and one `redux.sync` max over the warp
//   (on order-preserving integer keys, exact) reduces them. far is
//   computed one group (4 rows) ahead, at the start of the group above,
//   so the reduction has a whole group to land; its inputs and the
//   group's near-table rows are loaded a group before that.
// - D0 from the reduction's latency against a step's issue time: the
//   reduction (an estimated ~30 cycles) must land within the group it is
//   computed in (4 rows of ~40 issued instructions each), so one group
//   is enough, and it may read only scores of rows >= b+4: D0 = 8 (row
//   b-4's far terms start at d = 8, node b+5), the smallest multiple of
//   the group that allows it. Each extra near term costs every row an add
//   and a max on the issuing warp; at W = 16 (the bench batch's band)
//   D0 = 16 all the same, since its 8 far band slots would keep 24 of 32
//   lanes idle and measured slower (`tools/dp_ablate.py`, PERF.md).
// - A long edge's latch, pend[k] = lesc[k] + s[lw[k]], is exact and
//   made when s[lw[k]] is; its fold is ready because lw[k] >= lu[k] +
//   W + 1 > lu[k] + D0 for every long edge the packers make. A "short"
//   register (lu < lw <= lu + D0) would be latched too late for
//   far(lu), so its esc joins band term d = lw - lu - 1 of near(lu)
//   instead: max(a + s, b + s) == max(a, b) + s under round-to-nearest.
// - Each target starts at its last row that has a candidate (any band
//   slot >= 0, exit >= 0 or valid lu), found by a backward sweep of 32
//   rows at a time over the band and exit before the scan; rows above
//   it score -inf without being scanned (29% of the bench batch's rows).
// - The band is staged chunk by chunk (32 rows, contiguous in the
//   [B, V, W] layout) by one lane's `cp.async.bulk` into a 4-stage ring
//   completed on mbarriers, and so are the chunk's exit, cov and unsup.
//   Their rows are 16-byte aligned only when V allows it; a target's
//   misalignment is the same for all its chunks, so the lanes load the
//   head and tail bytes around each aligned interior themselves and
//   store them a chunk later, when the loads have landed.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; PERF.md): 0.35 ms at the bench
// batch, ~158 cycles per row of its longest target, against 1.34 ms for
// the first design; 10x above the bound. `tools/dp_ablate.py` splits it
// by phase clocks: the group loop takes ~100 cycles a row (mostly the
// near terms' adds and maxes; the rest waits on loads, since ptxas sinks
// the next group's near-table loads to the end of the loop body, next to
// their use), the per-chunk refill ~20, the near table ~10.

// Exactness: every candidate is the same float32 sum as the reference's
// (round-to-nearest subtract and add, no contraction: the intrinsics
// below and --fmad=false at build time), and a max of candidates is
// exact whatever its grouping, so the result is bitwise equal to
// `dp_scores`.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

// Ablation builds for `tools/dp_ablate.py` (wrong scores, timing only):
// bit 1 drops the far terms, 2 the near terms d > 0, 4 the chunk's near
// table, 8 the warp reduction.
#ifndef DP_ABLATE
#define DP_ABLATE 0
#endif
// Phase clocks for `tools/dp_ablate.py` (-D DP_PROF=1; timing only): lane
// 0 of each of the first kProfBlocks blocks writes the clock64() cycles
// its warp spent in each phase (setup, mbarrier wait, band fill and ring,
// near table, a chunk's top group, group loop, store and flush, refill)
// and its rows scanned to g_dp_prof, read by `dagcon_dp_prof_read`.
#ifndef DP_PROF
#define DP_PROF 0
#endif
// The near/far split at W = 16 (`tools/dp_ablate.py` builds 8, the split
// of every other width, to time the choice).
#ifndef DP_W16_D0
#define DP_W16_D0 16
#endif

namespace {

#if DP_PROF
constexpr int kProfBlocks = 4096;
constexpr int kPhases = 8;
__device__ unsigned long long g_dp_prof[kProfBlocks][kPhases + 1];
#define DP_PHASE(k)                               \
  do {                                            \
    const unsigned long long t_ = clock64();      \
    prof[k] += t_ - prof_t;                       \
    prof_t = t_;                                  \
  } while (0)
#define DP_PROF_STORE(rows)                                        \
  do {                                                             \
    if (lane == 0 && blockIdx.x < kProfBlocks) {                   \
      for (int k_ = 0; k_ < kPhases; ++k_)                         \
        g_dp_prof[blockIdx.x][k_] = prof[k_];                      \
      g_dp_prof[blockIdx.x][kPhases] = (rows);                     \
    }                                                              \
  } while (0)
#else
#define DP_PHASE(k) \
  do {              \
  } while (0)
#define DP_PROF_STORE(rows) \
  do {                      \
  } while (0)
#endif

constexpr int kChunk = 32;   // rows per staged chunk (= lanes)
constexpr int kGroup = 4;    // rows per unrolled group
constexpr int kRing = 256;   // node ring of 0.5 * cov and unsup
constexpr int kStages = 4;
constexpr int kMaxW = 128;
// Floats per near-table row: esc of the D0 near terms, the exit, pad.
template <int D0>
__host__ __device__ constexpr int near_row() {
  return D0 + 4;
}
constexpr float kPenalty = -10.0f;
// Per-stage bytes besides the band: the exit, cov (2 bytes a row) and
// unsup (1 byte) rows q = 0, 1, 2, each at attr_off(q) plus the target's
// misalignment (< 16 bytes).
constexpr int kAttrBytes = 256;
__device__ __forceinline__ int attr_off(int q) {
  return q == 0 ? 0 : q == 1 ? 96 : 192;
}
__device__ __forceinline__ int attr_size(int q) { return q == 2 ? 1 : 2; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
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

// One 1D bulk copy (TMA) of `bytes` (a multiple of 16; both addresses
// 16-byte aligned) from global to shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Max over the warp of a float (no NaN), exact: an order-preserving
// integer key (negative floats have their magnitude bits flipped) and
// one redux.sync. The key goes back to a float (`key_float`) only where
// it is used, a group later, so nothing waits on the reduction.
__device__ __forceinline__ int float_key(float x) {
  const int k = __float_as_int(x);
  return k ^ ((k >> 31) & 0x7FFFFFFF);
}

__device__ __forceinline__ int warp_max_key(float x) {
  return __reduce_max_sync(0xFFFFFFFFu, float_key(x));
}

__device__ __forceinline__ float key_float(int k) {
  return __int_as_float(k ^ ((k >> 31) & 0x7FFFFFFF));
}

// The head and tail bytes of a stage's attribute rows that the bulk
// copies cannot take: each lane loads at most one per row when the
// stage is issued and stores it a chunk later (`flush`).
struct Pending {
  uint32_t addr[3];  // shared-window address; 0: nothing for this lane
  uint32_t val[3];

  __device__ __forceinline__ void flush() {
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      if (addr[q])
        asm volatile("st.shared.u8 [%0], %1;\n" ::"r"(addr[q]), "r"(val[q])
                     : "memory");
      addr[q] = 0;
    }
  }
};

struct Target {
  const int16_t* band;     // [V, W]
  const int16_t* exit_c;   // [V]
  const int16_t* cov;      // [V]
  const uint8_t* unsup;    // [V]
};

// Stage chunk c (rows [32c, min(32c + 32, V))) into `st`. Element j of
// attribute row q lands at attr + attr_off(q) + off[q] + j * size, where
// off[q] is the target's misalignment of that array (the same for every
// chunk: chunks start 64 or 32 bytes apart). Lane 0 bulk-copies each
// row's aligned interior; the lanes load its head and tail bytes into
// `pend`.
__device__ __forceinline__ void issue_chunk(unsigned char* st, uint64_t* bar,
                                            const Target& t, int c, int V,
                                            int W, int lane, Pending& pend,
                                            const int (&off)[3]) {
  const int lo = c * kChunk;
  const int rows = min(kChunk, V - lo);
  const uint32_t band_bytes = static_cast<uint32_t>(rows * W * 2);
  unsigned char* attr = st + kChunk * W * 2;
  const unsigned char* gs[3] = {
      reinterpret_cast<const unsigned char*>(t.exit_c),
      reinterpret_cast<const unsigned char*>(t.cov), t.unsup};
  int head[3], nb[3];
  uint32_t tx = band_bytes;
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const int p0 = lo * attr_size(q);
    const int n = rows * attr_size(q);
    head[q] = min((16 - off[q]) & 15, n);
    nb[q] = (n - head[q]) & ~15;
    tx += static_cast<uint32_t>(nb[q]);
    const int j = lane < 16 ? lane : head[q] + nb[q] + lane - 16;
    const bool ok = lane < 16 ? lane < head[q] : j < n;
    pend.addr[q] = 0;
    if (ok) {
      pend.val[q] = __ldg(gs[q] + p0 + j);
      pend.addr[q] = smem_u32(attr + attr_off(q) + off[q] + j);
    }
  }
  if (lane == 0) {
    mbar_expect(bar, tx);
    bulk_copy(st, t.band + static_cast<size_t>(lo) * W, band_bytes, bar);
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      if (nb[q] > 0)
        bulk_copy(attr + attr_off(q) + off[q] + head[q],
                  gs[q] + lo * attr_size(q) + head[q],
                  static_cast<uint32_t>(nb[q]), bar);
    }
  }
}

// esc of a band count c >= 0 into node n, from n's ring entry {0.5 *
// cov, unsup}; -inf for no edge (c < 0). Both halves load together.
__device__ __forceinline__ float esc_of(int c, float2 hu) {
  const float e0 =
      __float_as_int(hu.y) ? kPenalty : __fsub_rn(static_cast<float>(c), hu.x);
  return c >= 0 ? e0 : -CUDART_INF_F;
}

// The inputs of far() for the 4 rows k0 .. k0-3 of a group, loaded a
// group before they are used so that no load latency sits in the scan:
// each row's exit, and this lane's band counts (d >= D0) and node ring
// entries for the window whose lane l holds node base + l + 32j.
template <int T>
struct FarIn {
  int c[kGroup][T > 0 ? T : 1];
  float ex[kGroup];
  float2 hu[T > 0 ? T : 1];
};

// Rows below the chunk (lo) read row lo: their far is discarded.
template <int T, int D0>
__device__ __forceinline__ void far_load(FarIn<T>& f, int k0, int base,
                                         int lo, const int16_t* band_rows,
                                         int W, const float* near_t,
                                         const float2* ring, int lane) {
#pragma unroll
  for (int u = 0; u < kGroup; ++u) {
    const int k = k0 - u;
    const int r = max(k - lo, 0);
    f.ex[u] = near_t[r * near_row<D0>() + D0];
#pragma unroll
    for (int j = 0; j < T; ++j) {
      const int d = base + lane + 32 * j - k - 1;
      f.c[u][j] = d >= D0 && d < W ? band_rows[r * W + d] : -1;
    }
  }
#pragma unroll
  for (int j = 0; j < T; ++j) f.hu[j] = ring[(base + lane + 32 * j) & (kRing - 1)];
}

// far() of the rows k0 .. k0-3 as warp-max keys: the exit (every lane,
// max is idempotent), this lane's band terms d >= D0 with the scores of
// its window registers sr[j], and the long edges leaving the row.
template <int T, int KPL>
__device__ __forceinline__ void far_keys(int* keys, const FarIn<T>& f, int k0,
                                         const float* sr, const int* r_lu,
                                         const float* pend) {
#pragma unroll
  for (int u = 0; u < kGroup; ++u) {
    float p = f.ex[u];
    if (!(DP_ABLATE & 1)) {
#pragma unroll
      for (int j = 0; j < T; ++j)
        p = fmaxf(p, __fadd_rn(esc_of(f.c[u][j], f.hu[j]), sr[j]));
#pragma unroll
      for (int j = 0; j < KPL; ++j) {
        if (r_lu[j] == k0 - u) p = fmaxf(p, pend[j]);
      }
    }
    keys[u] = (DP_ABLATE & 8) ? float_key(p) : warp_max_key(p);
  }
}

// A chunk's rows in its stage: the band [32][W] and the exit, cov and
// unsup rows at their alignment shifts.
struct Chunk {
  int lo, rows_real;
  int16_t* band;
  const int16_t* ex;
  const int16_t* cv;
  const uint8_t* un;
};

__device__ __forceinline__ Chunk chunk_at(unsigned char* st, int c, int V,
                                          int W, const int (&off)[3]) {
  unsigned char* attr = st + kChunk * W * 2;
  return Chunk{c * kChunk, min(kChunk, V - c * kChunk),
               reinterpret_cast<int16_t*>(st),
               reinterpret_cast<const int16_t*>(attr + attr_off(0) + off[0]),
               reinterpret_cast<const int16_t*>(attr + attr_off(1) + off[1]),
               attr + attr_off(2) + off[2]};
}

// The chunk's nodes enter the ring. Their slots alias only nodes 256 or
// more above them, which no step of this chunk reads.
__device__ __forceinline__ void fill_ring(float2* ring, const Chunk& ch,
                                          int lane) {
  const bool in = lane < ch.rows_real;
  const int cv = in ? ch.cv[lane] : 0;
  const int un = in ? ch.un[lane] : 0;
  ring[(ch.lo + lane) & (kRing - 1)] =
      make_float2(__fmul_rn(0.5f, static_cast<float>(cv)), __int_as_float(un));
}

// The chunk's near table: lane r makes row lo + r's esc of d < D0
// (its counts are 16-byte loads; D0 <= W) and its exit.
template <int D0>
__device__ __forceinline__ void near_table(float* nt, const Chunk& ch,
                                           const float2* ring, int rows, int W,
                                           int lane) {
  if (lane >= rows || (DP_ABLATE & 4)) return;
  int words[D0 / 2];
#pragma unroll
  for (int q = 0; q < D0 / 8; ++q) {
    const int4 raw = reinterpret_cast<const int4*>(ch.band + lane * W)[q];
    words[4 * q] = raw.x;
    words[4 * q + 1] = raw.y;
    words[4 * q + 2] = raw.z;
    words[4 * q + 3] = raw.w;
  }
  float2 hu[D0];
#pragma unroll
  for (int d = 0; d < D0; ++d) hu[d] = ring[(ch.lo + lane + 1 + d) & (kRing - 1)];
  float e[D0];
#pragma unroll
  for (int d = 0; d < D0; ++d) {
    const int cnt = static_cast<int16_t>(
        d & 1 ? words[d / 2] >> 16 : words[d / 2] & 0xFFFF);
    e[d] = esc_of(cnt, hu[d]);
  }
  float4* row = reinterpret_cast<float4*>(nt + lane * near_row<D0>());
#pragma unroll
  for (int q = 0; q < D0 / 4; ++q)
    row[q] = make_float4(e[4 * q], e[4 * q + 1], e[4 * q + 2], e[4 * q + 3]);
  const int ex = lane < ch.rows_real ? ch.ex[lane] : -1;
  nt[lane * near_row<D0>() + D0] =
      ex >= 0 ? static_cast<float>(ex) : -CUDART_INF_F;
}

// Rare: short long-edge registers (lu < lw <= lu + D0) of the chunk's
// rows join near(lu)'s band term lw - lu - 1 (the table must be whole).
template <int KPL, int D0>
__device__ void near_shorts(float* nt, int lo, int rows, int V,
                            const int* r_lu, const int* r_lw,
                            const float* r_le, int lane) {
  for (int src = 0; src < 32; ++src) {
#pragma unroll
    for (int j = 0; j < KPL; ++j) {
      const int u = __shfl_sync(0xFFFFFFFFu, r_lu[j], src);
      const int v = __shfl_sync(0xFFFFFFFFu, r_lw[j], src);
      const float le = __shfl_sync(0xFFFFFFFFu, r_le[j], src);
      if (lane == 0 && u >= lo && u < lo + rows && u < V && v > u &&
          v <= u + D0) {
        float* t = nt + (u - lo) * near_row<D0>() + (v - u - 1);
        *t = fmaxf(*t, le);
      }
    }
  }
  __syncwarp();
}

// D0: near band terms (8, or 16 at W = 16: then no band term is far and
// T = 0). T: window registers per lane (ceil((W - 4) / 32)); KPL:
// long-edge registers per lane (ceil(K / 32)).
template <int T, int KPL, int D0>
__global__ void __launch_bounds__(32)
    dp_scan_kernel(const int16_t* __restrict__ win,
                   const int16_t* __restrict__ exit_c,
                   const int16_t* __restrict__ cov,
                   const uint8_t* __restrict__ unsup,
                   const int32_t* __restrict__ long_u,
                   const int32_t* __restrict__ long_w,
                   const float* __restrict__ long_esc,
                   float* __restrict__ out, int V, int W, int K) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);  // [kStages]
  // Node ring: {0.5 * cov, unsup} of node n at n % kRing.
  float2* ring = reinterpret_cast<float2*>(smem + 128);
  // Near table: [32][near_row<D0>()].
  float* near_t = reinterpret_cast<float*>(ring + kRing);
  unsigned char* stages =
      reinterpret_cast<unsigned char*>(near_t + kChunk * near_row<D0>());
  const int stage_bytes = kChunk * W * 2 + kAttrBytes;

#if DP_PROF
  unsigned long long prof[kPhases] = {}, prof_t = clock64();
#endif
  const int lane = threadIdx.x;
  const size_t row0 = static_cast<size_t>(blockIdx.x) * V;
  const Target tgt{win + row0 * W, exit_c + row0, cov + row0, unsup + row0};
  float* out_t = out + row0;
  const float neg = -CUDART_INF_F;

  // Long-edge registers; the highest valid lu; any short register.
  int r_lu[KPL], r_lw[KPL];
  float r_le[KPL], pend[KPL];
  int max_lu = -1;
  bool short_reg = false;
#pragma unroll
  for (int j = 0; j < KPL; ++j) {
    const int k = lane + 32 * j;
    const bool ok = k < K;
    const size_t o = static_cast<size_t>(blockIdx.x) * K + k;
    r_lu[j] = ok ? long_u[o] : -1;
    r_lw[j] = ok ? long_w[o] : -1;
    r_le[j] = ok ? long_esc[o] : neg;
    pend[j] = neg;
    const bool valid = r_lu[j] >= 0 && r_lu[j] < V;
    if (valid) max_lu = max(max_lu, r_lu[j]);
    short_reg |= valid && r_lw[j] > r_lu[j] && r_lw[j] <= r_lu[j] + D0;
  }
  max_lu = __reduce_max_sync(0xFFFFFFFFu, max_lu);
  const bool any_short = __any_sync(0xFFFFFFFFu, short_reg);

  // Backward sweep: the last row above max_lu with a band slot >= 0 or
  // an exit >= 0, 32 rows at a time (lane l reads row hi - 1 - l).
  int top = max_lu;
  for (int hi = V; hi - 1 > max_lu; hi -= kChunk) {
    const int row = hi - 1 - lane;
    bool found = false;
    if (row > max_lu) {
      found = tgt.exit_c[row] >= 0;
      const uint4* r = reinterpret_cast<const uint4*>(tgt.band) +
                       static_cast<size_t>(row) * (W / 8);
      for (int q = 0; q < W / 8 && !found; ++q) {
        const uint4 v = __ldg(r + q);
        found = ((~v.x | ~v.y | ~v.z | ~v.w) & 0x80008000u) != 0;
      }
    }
    const unsigned ballot = __ballot_sync(0xFFFFFFFFu, found);
    if (ballot) {
      top = hi - 1 - (__ffs(ballot) - 1);
      break;
    }
  }
  // The scan starts at the end of top's group; rows above score -inf.
  const int first = top < 0 ? -1 : (top / kGroup + 1) * kGroup - 1;
  for (int r = first + 1 + lane; r < V; r += 32) out_t[r] = neg;
  if (top < 0) {
    DP_PROF_STORE(0);
    return;
  }

  for (int r = lane; r < kRing; r += 32) {
    ring[r] = make_float2(0.0f, 0.0f);
  }
  const int c_top = first / kChunk;
  const int nchunks = c_top + 1;
  if (lane == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&bars[s]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncwarp();
  Pending pend_bytes;
  const int aoff[3] = {
      static_cast<int>(reinterpret_cast<uintptr_t>(tgt.exit_c) & 15),
      static_cast<int>(reinterpret_cast<uintptr_t>(tgt.cov) & 15),
      static_cast<int>(reinterpret_cast<uintptr_t>(tgt.unsup) & 15)};
  for (int q = 0; q < kStages && q < nchunks; ++q) {
    issue_chunk(stages + q * stage_bytes, &bars[q], tgt, c_top - q, V, W,
                lane, pend_bytes, aoff);
    pend_bytes.flush();
  }

  // Score windows: near w[d] = s[i+1+d] (all lanes); far sr[j] = s[b+4+
  // lane+32j] at the start of group [b, b+4).
  constexpr int TS = T > 0 ? T : 1;  // sr[0] also carries the output
  constexpr int NQ = D0 / 4;         // float4s of a near-table row
  float w[D0];
#pragma unroll
  for (int d = 0; d < D0; ++d) w[d] = neg;
  float sr[TS];
#pragma unroll
  for (int j = 0; j < TS; ++j) sr[j] = neg;
  int far[kGroup];  // warp-max keys of the current group's far terms

  const int rows_top = first - c_top * kChunk + 1;
  DP_PHASE(0);
  for (int q = 0; q < nchunks; ++q) {
    const int c = c_top - q;
    unsigned char* st = stages + (q % kStages) * stage_bytes;
    const Chunk ch = chunk_at(st, c, V, W, aoff);
    const int lo = ch.lo;
    const int16_t* band_rows = ch.band;
    const int rows_proc = q == 0 ? rows_top : kChunk;
    mbar_wait(&bars[q % kStages], (q / kStages) & 1);
    DP_PHASE(1);
    // Rows at or past V (only in the top chunk, V % 4 != 0) read empty.
    for (int e = ch.rows_real * W + lane; e < rows_proc * W; e += 32)
      ch.band[e] = -1;
    __syncwarp();
    fill_ring(ring, ch, lane);
    __syncwarp();
    DP_PHASE(2);
    near_table<D0>(near_t, ch, ring, rows_proc, W, lane);
    __syncwarp();
    if (any_short)
      near_shorts<KPL, D0>(near_t, lo, rows_proc, V, r_lu, r_lw, r_le, lane);
    DP_PHASE(3);

    // The chunk's top group: its near-table rows, its far terms (from
    // the scores above it) and the inputs of the next group's far terms.
    const int hi_p = lo + rows_proc;
    float4 ntc[kGroup][NQ];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const float4* r = reinterpret_cast<const float4*>(
          near_t + (hi_p - 1 - u - lo) * near_row<D0>());
#pragma unroll
      for (int q = 0; q < NQ; ++q) ntc[u][q] = r[q];
    }
    FarIn<T> fin;
    far_load<T, D0>(fin, hi_p - 1, hi_p, lo, band_rows, W, near_t, ring, lane);
    far_keys<T, KPL>(far, fin, hi_p - 1, sr, r_lu, pend);
    far_load<T, D0>(fin, hi_p - 5, hi_p, lo, band_rows, W, near_t, ring, lane);
    DP_PHASE(4);

    for (int b = hi_p - kGroup; b >= lo; b -= kGroup) {
      // Loads for the next iterations: the next group's near-table rows
      // and the inputs of the far terms of the group after it (computed
      // in the next group, with the window then at base b).
      float4 ntn[kGroup][NQ];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const float4* r = reinterpret_cast<const float4*>(
            near_t + max(b - 1 - u - lo, 0) * near_row<D0>());
#pragma unroll
        for (int q = 0; q < NQ; ++q) ntn[u][q] = r[q];
      }
      FarIn<T> fnext;
      far_load<T, D0>(fnext, b - 5, b, lo, band_rows, W, near_t, ring, lane);
      // far of the next group down (rows b-1 .. b-4), from the scores of
      // rows >= b + 4 and the latches made so far; read a group later.
      int nf[kGroup];
      far_keys<T, KPL>(nf, fin, b - 1, sr, r_lu, pend);
      float s_g[kGroup];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const int i = b + kGroup - 1 - u;
        float e[D0];
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          e[4 * q] = ntc[u][q].x;
          e[4 * q + 1] = ntc[u][q].y;
          e[4 * q + 2] = ntc[u][q].z;
          e[4 * q + 3] = ntc[u][q].w;
        }
        // Maxes in pairs from the oldest scores on: only the last add and
        // max wait on s[i+1], and s[i+2] is two maxes from s[i].
        float m = key_float(far[u]);
        if (!(DP_ABLATE & 2)) {
#pragma unroll
          for (int d = D0 - 1; d >= 2; d -= 2)
            m = fmaxf(m, fmaxf(__fadd_rn(e[d], w[d]),
                               __fadd_rn(e[d - 1], w[d - 1])));
          m = fmaxf(m, __fadd_rn(e[1], w[1]));
        }
        const float s = fmaxf(m, __fadd_rn(e[0], w[0]));
#pragma unroll
        for (int j = 0; j < KPL; ++j) {
          if (r_lw[j] == i) pend[j] = __fadd_rn(r_le[j], s);
        }
#pragma unroll
        for (int d = D0 - 1; d > 0; --d) w[d] = w[d - 1];
        w[0] = s;
        s_g[u] = s;
      }
      // Shift the far window down by the group: lane l takes lane l-4's
      // value; lanes 0-3 take the group's scores (j = 0) or lanes 28-31
      // of the register below (j > 0).
#pragma unroll
      for (int j = TS - 1; j >= 0; --j) {
        const float up = __shfl_up_sync(0xFFFFFFFFu, sr[j], kGroup);
        float low;
        if (j == 0) {
          low = lane == 0 ? s_g[3] : lane == 1 ? s_g[2] : lane == 2 ? s_g[1]
                                                                    : s_g[0];
        } else {
          low = __shfl_sync(0xFFFFFFFFu, sr[j - 1], (lane + 28) & 31);
        }
        sr[j] = lane < kGroup ? low : up;
      }
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        far[u] = nf[u];
#pragma unroll
        for (int q = 0; q < NQ; ++q) ntc[u][q] = ntn[u][q];
      }
      fin = fnext;
    }
    DP_PHASE(5);
    // sr[0] of lane l is now s[lo + l].
    if (lane < rows_proc && lane < ch.rows_real) out_t[lo + lane] = sr[0];

    // The previous refill's head and tail bytes (its chunk is read at
    // the earliest kStages - 1 chunks from now), then refill this stage
    // with the chunk kStages below. Its generic reads are done (warp
    // sync) before the async proxy writes it.
    pend_bytes.flush();
    __syncwarp();
    DP_PHASE(6);
    if (q + kStages < nchunks) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue_chunk(st, &bars[q % kStages], tgt, c - kStages, V, W, lane,
                  pend_bytes, aoff);
    }
    DP_PHASE(7);
  }
  DP_PROF_STORE(first + 1);
}

template <int T, int KPL, int D0>
cudaError_t launch(const void* win, const void* exit_c, const void* cov,
                   const void* unsup, const void* lu, const void* lw,
                   const void* lesc, void* out, int B, int V, int W, int K,
                   cudaStream_t stream) {
  const size_t smem = 128 + kRing * sizeof(float2) +
                      kChunk * near_row<D0>() * sizeof(float) +
                      kStages * (kChunk * W * 2 + kAttrBytes);
  dp_scan_kernel<T, KPL, D0><<<B, 32, smem, stream>>>(
      static_cast<const int16_t*>(win), static_cast<const int16_t*>(exit_c),
      static_cast<const int16_t*>(cov), static_cast<const uint8_t*>(unsup),
      static_cast<const int32_t*>(lu), static_cast<const int32_t*>(lw),
      static_cast<const float*>(lesc), static_cast<float*>(out), V, W, K);
  return cudaGetLastError();
}

template <int T, int D0>
cudaError_t launch_k(const void* win, const void* exit_c, const void* cov,
                     const void* unsup, const void* lu, const void* lw,
                     const void* lesc, void* out, int B, int V, int W, int K,
                     cudaStream_t stream) {
  if (K <= 32)
    return launch<T, 1, D0>(win, exit_c, cov, unsup, lu, lw, lesc, out, B, V,
                            W, K, stream);
  if (K <= 64)
    return launch<T, 2, D0>(win, exit_c, cov, unsup, lu, lw, lesc, out, B, V,
                            W, K, stream);
  return launch<T, 4, D0>(win, exit_c, cov, unsup, lu, lw, lesc, out, B, V, W,
                          K, stream);
}

}  // namespace

extern "C" {

// Scores [B, V] f32 into `out`. win [B, V, W] int16 (16-byte aligned,
// 8 <= W <= 128, W % 8 == 0); exit_c, cov [B, V] int16; unsup [B, V]
// one byte each; lu, lw [B, K] int32; lesc [B, K] f32; 0 <= K <= 128.
// All contiguous. Launches on `stream` and returns cudaGetLastError().
int dagcon_dp_scan(const void* win, const void* exit_c, const void* cov,
                   const void* unsup, const void* lu, const void* lw,
                   const void* lesc, void* out, int B, int V, int W, int K,
                   void* stream) {
  if (B < 0 || V < 0 || W < 8 || W > kMaxW || W % 8 != 0 || K < 0 ||
      K > 128 || reinterpret_cast<uintptr_t>(win) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || V == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // At W = 16 (the bench batch's band) all band terms are near: no far
  // band term, no window register. Otherwise lane l's window registers
  // cover far terms up to d = 32T + 2 - u.
  if (W == 16 && DP_W16_D0 == 16)
    return static_cast<int>(launch_k<0, 16>(win, exit_c, cov, unsup, lu, lw,
                                            lesc, out, B, V, W, K, s));
  const int T = (W - 4 + 31) / 32;
  switch (T) {
    case 1:
      return static_cast<int>(launch_k<1, 8>(win, exit_c, cov, unsup, lu, lw,
                                             lesc, out, B, V, W, K, s));
    case 2:
      return static_cast<int>(launch_k<2, 8>(win, exit_c, cov, unsup, lu, lw,
                                             lesc, out, B, V, W, K, s));
    case 3:
      return static_cast<int>(launch_k<3, 8>(win, exit_c, cov, unsup, lu, lw,
                                             lesc, out, B, V, W, K, s));
    default:
      return static_cast<int>(launch_k<4, 8>(win, exit_c, cov, unsup, lu, lw,
                                             lesc, out, B, V, W, K, s));
  }
}

#if DP_PROF
// The phase clocks of the last launch's first n blocks into host [n][9]
// (unsigned 64-bit), n <= 4096.
int dagcon_dp_prof_read(void* host, int n) {
  if (n < 0 || n > kProfBlocks) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaMemcpyFromSymbol(
      host, g_dp_prof, sizeof(unsigned long long) * (kPhases + 1) * n));
}
#endif

const char* dagcon_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
