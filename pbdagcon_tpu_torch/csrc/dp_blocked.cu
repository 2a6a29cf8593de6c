// Kernel X2 of the port: the blocked int32 max-plus consensus DP, for
// Hopper (sm_90a).
//
// Replaces the XLA device programs of `pbdagcon_tpu/ops/dp_blocked.py::
// _solve_band` (its three scans: compose, prop, fill) and of
// `pbdagcon_tpu/parallel/colshard.py` (`_compose_local` and the shard-
// local fill of `_colsharded_scores`; on one card the shards are the
// blocks). The contract is the plain PyTorch version
// `pbdagcon_tpu_torch/ops/dp_blocked.py::_solve_band` on the band's
// half-unit scores, integer-equal: all of it is int32 arithmetic, every
// stored value clamped to >= SENT = -2^30 where the reference clamps, so
// every sum of two stored values is >= INT32_MIN and nothing wraps.
// Within one max the order of the terms is free (integer max is exact),
// so a kernel may keep several accumulators; the chain of clamped steps
// (compose's L steps, propagate's G steps) is never reassociated, since
// a sentinel-contaminated value depends on where each clamp falls.
//
// The state of the reverse scan at node u is x_u = [s[u], .., s[u+W-1],
// 0]; one step is x_u = A_u (x) x_{u+1}, where row 0 of A_u is
// a_u = [esc2[u, 0..W-1], e_exit2[u]], rows 1..W-1 shift the window by
// one and row W keeps the constant. The band's edge scores are formed
// here from the int16 band, cov and unsup (SPEC §2.6 doubled):
// esc2 = unsup[t] ? -20 : 2 * count - cov[t] with t = min(u + 1 + d,
// V - 1), SENT where count < 0.
//
// Every max-plus term is one Hopper DPX instruction, __viaddmax_s32
// (max(a + b, c)); no sum of two stored values leaves int32, so it is
// the same integer as the plain version's add and max.
//
// Compose, M_g = A_{gL} (x) ... (x) A_{gL+L-1} for every block of L
// rows; 2 (W+1)^2 int32 operations a node, so it is bound by the card's
// integer rate (~0.1 ms at the bench batch, B = 512, V = 5632, W = 16)
// and by the band it reads and the M it writes (about half that). Two
// routes, chosen by `ops/dp_blocked_cuda.py::compose_plan`:
//  - "column", blocked_compose_col_kernel<W> (W = 16, 32, 64, L a
//    multiple of W): column j of M evolves on its own (the new row 0 is
//    max_i(a_t[i] + M[i][j]), the band rows shift down, row W stays), so
//    a thread owns one column of one block with its W band entries in
//    registers and needs no barrier and no shuffle. The step loop is
//    unrolled by groups of W steps (32 at W = 64, then 64 moves), so the
//    shift is a static renaming of registers; 2-4 accumulators a thread. A CTA packs `blocks`
//    consecutive blocks, (W+1) threads each; it copies their raw band
//    (one contiguous run: 16-byte cp.async) and exit half-units, and
//    their cov and unsup, into shared memory, forms the a rows there
//    once (each padded to whole int4 and read as broadcast 128-bit
//    loads: ~1.25 instructions a term), then every thread runs its
//    column's L steps and writes it out in row order. Small CTAs (1-3
//    blocks), many an SM, overlap one CTA's copies with another's steps:
//    on an H100 that beat fuller lanes (9 blocks). What bounds it now (-D
//    X2_ABLATE builds, bench batch, H100): the phases of a CTA run one
//    after another and overlap little across CTAs: the copies alone take
//    ~30% of the time, forming the a rows ~25%, the steps ~30%, the
//    stores ~2-5%.
//  - "cta", blocked_compose_kernel (every other W; forced plans): a CTA
//    per block, a thread per column, the band rows of M in a ring of
//    W + 1 row slots in shared memory, one barrier a step and two
//    shared loads a term (the first design: W + 1 busy threads of 32 at
//    W = 16).
//
// Propagate, the boundary vectors x_in[b, g] for g = G-1 .. 0: G
// dependent matrix-vector steps a target, each reading one M_g of
// (W+1)^2 int32, so it is bound by one chain's latency at a few targets
// (G ~ 245 steps at one oversize target) and by the bytes of M at the
// bench batch. Two routes, chosen by `propagate_plan`:
//  - "warp", blocked_propagate_warp_kernel<R, WC> (every W; WC = 16, 32
//    at compile time): a pair of warps per target, several pairs a CTA,
//    and no block barrier after the start. The producer warp streams
//    the target's M (one contiguous run of G (W+1)^2 int32) through a
//    ring of `depth` slots in shared memory, `chunk` matrices a slot
//    (one bulk copy, TMA, of the chunk's 16-byte-aligned superset,
//    completed on the slot's mbarrier; lanes copy the words a bulk copy
//    cannot take at the tensor's misaligned ends), refilling a slot once
//    the consumer's released step count (st.release / ld.acquire in
//    shared memory) shows it read; and it writes x_in from the
//    consumer's history of x in shared memory (lanes 1-31: lane 0, whose
//    arrivals release its earlier stores, stores nothing). The consumer
//    warp only computes. At W = 16 and 32, lane i holds its band row i
//    of M in registers, the next step's loaded right after the current
//    one is used (other W: two or four rows a lane from shared memory,
//    a lane past the band recomputing row W). It reads x
//    as broadcast int4 loads and runs a row's terms as eight chains of
//    an add and a max: two instructions a term, but shorter chains than
//    one DPX a term on an H100. The exit row W is a warp reduction
//    (redux.sync) over the lanes' columns; at W = 16, lane 16 computes
//    it as its row. What bounds it now: the consumer warp's own
//    instructions, ~540 cycles a step at W = 32 (~355 without the row
//    arithmetic, -D X2_ABLATE=4); not the ring (stale slots, -D
//    X2_ABLATE=64, save ~1%).
//  - "cta", blocked_propagate_kernel (forced plans): a CTA per target,
//    M_g copied by 4-byte cp.async one step ahead, two block barriers a
//    step (the first design).
//
// Fill, every block's L scores from its incoming boundary x_in: s[L + k]
// = x_in[k] (k < W), then s[r] = max(SENT, e_exit2[r], max_d (esc2[r, d]
// + s[r + 1 + d])) for r = L-1 .. 0. All blocks are independent, so it is
// bound by the bytes of the band at the bench batch and by one block's
// chain of L dependent steps at a few targets. Two routes, chosen by
// `fill_plan`:
//  - "lane", blocked_fill_lane_kernel<R> (every W): the push form of the
//    recurrence. Once s[u] is final, every pending row r = u-1-d (d < W)
//    takes the term esc2[r, d] + s[u]; so W rows are pending at a time,
//    and each lives in one lane's register accumulator (a "slot"; slot k
//    holds rows L-1-k, L-1-k-W, ..; R = ceil(W / 32) slots a lane past
//    32). One step: one shuffle passes s[u] from the lane whose row u
//    just got its last term, every slot adds its one term (a DPX
//    __viaddmax_s32), and the finished slot takes row u-W, its
//    accumulator starting at max(SENT, e_exit2) (the SENT clamp is one
//    more term of the row's max, so the value passed on is already the
//    clamped one; the row-to-row chain is never reassociated). The chain
//    a step is the shuffle and one DPX: each slot's band entry, the
//    step's node word (its multiplier and addend: 2, -cov or 0, -20) and
//    the exit of the row a slot takes next are loaded from shared memory
//    two steps ahead, and a step's score is kept in a register of one
//    lane and stored after a chunk of steps, so that no store sits
//    between a shuffle and the next loads. A block opens with the
//    W(W+1)/2 terms of its first W rows from x_in, off the chain, on
//    two accumulators a slot. At W <= 16, 32 / W blocks share a warp
//    (groups of W lanes). A warp copies its blocks' band (one contiguous
//    run) by 16-byte cp.async, lanes copying the words at a misaligned
//    end, gathers the node words (at node min(gL + 1 + i, V - 1): cov
//    and unsup of the last blocks' boundary slots are the last node's),
//    and writes the scores out as 16-byte stores from shared memory.
//    Warps share no barrier: other warps' copies overlap a warp's chain.
//    What bounds it now (H100, `tools/blocked_ablate.py`): at one
//    oversize target the chain, ~50 cycles a step (-D X2_PROF=1); at the
//    bench batch the warps' instructions (~120 cycles a step of a warp
//    among the others) and the copies, which overlap the steps little
//    (-D X2_ABLATE=128: -23% without the band copies, 256: -42% without
//    the steps).
//  - "reduce", blocked_fill_kernel (forced plans): a warp per block, 4
//    warps a CTA, the raw inputs copied by 2-byte loads, the W-window of
//    scores in a ring in shared memory; each step a lane forms the edge
//    scores of its d's (d = lane + 32k), the warp takes the max by five
//    shuffles, and lane 0 puts the new score in the slot of the dropped
//    one (the first design).

#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

// Ablation and clock builds (`tools/blocked_ablate.py`; -D X2_ABLATE=
// bits, outputs wrong where noted, only their times count): 1 no proxy
// fence before a ring slot's bulk copy; 2 no M stores in the compose
// (wrong); 4 no row arithmetic in the propagate (wrong); 8 no steps in
// the compose (wrong); 16 no a rows formed in the compose (wrong); 32 the
// add and the max of a term as two instructions, not one DPX; 64 no ring
// refills past the first `depth` chunks, the consumer reading stale
// slots (wrong); 128 no band copies in the fill's lane route (wrong); 256
// no steps in the fill's lane route (wrong). -D X2_PROF=1 clocks the
// propagate's phases and the fill's lane route (`dagcon_x2_prof_read`).
#ifndef X2_ABLATE
#define X2_ABLATE 0
#endif
#ifndef X2_PROF
#define X2_PROF 0
#endif
#if X2_PROF
// Cycles of target 0's warps in the propagate's phases: the consumer's
// (the next slot's wait and row loads, the exit row and the rows, x
// written and the count released), its steps, the producer's (the wait
// on the count, the x_in writes, the refill's issue); then (8-12) those
// of the lane route's warp of block 0 in the fill: the copies and
// gathers until the band is in, the start terms, the steps, the stores,
// and the steps counted.
__device__ unsigned long long x2_prof[16];
#define X2_TICK(k)                                      \
  do {                                                  \
    const long long _n = clock64();                     \
    if (b == 0 && lane == 0) x2_prof[k] += _n - _t;     \
    _t = _n;                                            \
  } while (0)
#else
#define X2_TICK(k) \
  do {             \
  } while (0)
#endif

// max(a + b, c) as two instructions: the add in PTX, so that the compiler
// does not fuse it back into one DPX instruction (the propagate's chains
// of terms run shorter this way on an H100; `tools/blocked_ablate.py`).
__device__ __forceinline__ int add_then_max(int a, int b, int c) {
  int s;
  asm("add.s32 %0, %1, %2;\n" : "=r"(s) : "r"(a), "r"(b));
  return max(s, c);
}

__device__ __forceinline__ int addmax(int a, int b, int c) {
#if X2_ABLATE & 32
  int s;
  asm("add.s32 %0, %1, %2;\n" : "=r"(s) : "r"(a), "r"(b));
  return max(s, c);
#else
  return __viaddmax_s32(a, b, c);
#endif
}

namespace {

constexpr int SENT = -(1 << 30);
constexpr int PENALTY2 = -20;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_W = 128;
constexpr int MAX_L = 128;
constexpr int FILL_WARPS = 4;
// Threads a CTA of the compose's column route may have, and warps a CTA
// of the propagate's warp route.
constexpr int COL_MAX_THREADS = 512;
constexpr int PROP_MAX_WARPS = 8;
constexpr int PROP_MAX_DEPTH = 64;
constexpr int PROP_MAX_CHUNK = 32;
// Warps a CTA of the fill's lane route may have.
constexpr int LANE_MAX_WARPS = 8;

// One block's raw inputs in shared memory: the band rows [L][W] int16,
// cov and unsup of nodes gL + 1 .. gL + L + W - 1 (clamped at V - 1: the
// targets of the block's band slots, slot (r, d) at index r + d) and
// the exit half-units [L].
struct Staged {
  int* eex;       // [L]
  int16_t* win;   // [L * W]
  int16_t* cov;   // [L + W]
  uint8_t* uns;   // [L + W]
};

__host__ __device__ constexpr int staged_bytes(int W, int L) {
  return L * 4 + (L * W + L + W) * 2 + ((L + W + 15) / 16) * 16;
}

__device__ __forceinline__ Staged carve(unsigned char* p, int W, int L) {
  Staged st;
  st.eex = reinterpret_cast<int*>(p);
  st.win = reinterpret_cast<int16_t*>(p + L * 4);
  st.cov = st.win + L * W;
  st.uns = reinterpret_cast<uint8_t*>(st.cov + L + W);
  return st;
}

// Copies block g of target b into `st` with threads tid, tid + nt, ...
// (the band rows are one contiguous run: coalesced loads, all issued
// before any is used).
__device__ __forceinline__ void stage_block(
    const int16_t* __restrict__ win, const int16_t* __restrict__ cov,
    const uint8_t* __restrict__ uns, const int* __restrict__ eex,
    const Staged& st, long long b, int g, int V, int W, int L, int tid,
    int nt) {
  const long long rowbase = b * V + (long long)g * L;
  const int16_t* src = win + rowbase * W;
#pragma unroll 4
  for (int k = tid; k < L * W; k += nt) st.win[k] = src[k];
  for (int i = tid; i < L + W; i += nt) {
    const long long t = b * V + min(g * L + 1 + i, V - 1);
    st.cov[i] = cov[t];
    st.uns[i] = uns[t];
  }
  for (int r = tid; r < L; r += nt) st.eex[r] = eex[rowbase + r];
}

// esc2 of band slot (r, d) of a staged block: SENT where there is no
// edge, -20 into an unsupported node, else 2 * count - cov.
__device__ __forceinline__ int esc2_of(const Staged& st, int r, int d, int W) {
  const int wc = st.win[r * W + d];
  const int i = r + d;
  return wc < 0 ? SENT : (st.uns[i] ? PENALTY2 : 2 * wc - (int)st.cov[i]);
}

__global__ void blocked_compose_kernel(const int16_t* __restrict__ win,
                                       const int16_t* __restrict__ cov,
                                       const uint8_t* __restrict__ uns,
                                       const int* __restrict__ eex,
                                       int* __restrict__ Mout, int V, int W,
                                       int L) {
  extern __shared__ int smem[];
  const int Wp = W + 1;
  int* a_s = smem;                         // [L][Wp]
  int* ring = smem + L * Wp;               // [W + 1][Wp] band row slots
  int* exit_row = ring + (W + 1) * Wp;     // [Wp] row W
  const Staged st = carve(
      reinterpret_cast<unsigned char*>(exit_row + Wp), W, L);
  const int G = V / L;
  const int b = blockIdx.x / G;
  const int g = blockIdx.x - b * G;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;

  stage_block(win, cov, uns, eex, st, b, g, V, W, L, tid, nt);
  // The identity: slot r holds logical row r (r < W), slot W is spare.
  for (int k = tid; k < (W + 2) * Wp; k += nt) {
    const int r = k / Wp;
    const int j = k - r * Wp;
    const int diag = r <= W ? r : W;  // the exit row's 0 sits at column W
    ring[k] = (r != W && j == diag) ? 0 : SENT;
  }
  __syncthreads();
  for (int k = tid; k < L * Wp; k += nt) {
    const int r = k / Wp;
    const int d = k - r * Wp;
    a_s[k] = d < W ? esc2_of(st, r, d, W) : st.eex[r];
  }
  __syncthreads();

  int head = 0;  // slot of logical row 0
  const int j = tid;
  for (int t = 0; t < L; ++t) {
    const int* at = a_s + (L - 1 - t) * Wp;
    const int nslot = head == 0 ? W : head - 1;  // the spare slot
    if (j < Wp) {
      // Logical rows 0..W-1 sit in slots head, head + 1, .. mod W + 1:
      // n1 of them up to the ring's end, the rest from slot 0.
      int acc = max(SENT, at[W] + exit_row[j]);
      const int n1 = head == 0 ? W : W + 1 - head;
      const int* p = ring + head * Wp + j;
#pragma unroll 4
      for (int i = 0; i < n1; ++i) acc = __viaddmax_s32(at[i], p[i * Wp], acc);
      p = ring + j;
#pragma unroll 4
      for (int i = 0; i < W - n1; ++i) {
        acc = __viaddmax_s32(at[n1 + i], p[i * Wp], acc);
      }
      ring[nslot * Wp + j] = acc;
    }
    head = nslot;
    __syncthreads();
  }

  int* Mg = Mout + ((long long)b * G + g) * Wp * Wp;
  for (int k = tid; k < Wp * Wp; k += nt) {
    const int r = k / Wp;
    const int jj = k - r * Wp;
    int slot = head + r;
    if (slot > W) slot -= W + 1;
    Mg[k] = r < W ? ring[slot * Wp + jj] : exit_row[jj];
  }
}

__global__ void blocked_propagate_kernel(const int* __restrict__ M,
                                         int* __restrict__ x_in, int G,
                                         int W) {
  extern __shared__ int smem[];  // two buffers of M_g, then x
  const int Wp = W + 1;
  const int WW = Wp * Wp;
  int* x = smem + 2 * WW;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int* Mb = M + (long long)b * G * WW;
  int* xb = x_in + (long long)b * G * Wp;

  if (tid < Wp) x[tid] = tid == W ? 0 : SENT;
  for (int k = tid; k < WW; k += nt) {
    __pipeline_memcpy_async(smem + k, Mb + (long long)(G - 1) * WW + k, 4);
  }
  __pipeline_commit();
  for (int g = G - 1; g >= 0; --g) {
    const bool odd = (G - 1 - g) & 1;
    const int* cur = odd ? smem + WW : smem;
    if (g > 0) {
      int* nxt = odd ? smem : smem + WW;
      for (int k = tid; k < WW; k += nt) {
        __pipeline_memcpy_async(nxt + k, Mb + (long long)(g - 1) * WW + k, 4);
      }
    }
    __pipeline_commit();
    __pipeline_wait_prior(1);  // this thread's copies of `cur` are done
    __syncthreads();           // everyone's, and the last step's x
    int xo = SENT;
    if (tid < Wp) {
      xb[(long long)g * Wp + tid] = x[tid];
      const int* row = cur + tid * Wp;  // Wp is odd: no bank conflicts
#pragma unroll 4
      for (int jj = 0; jj < Wp; ++jj) xo = __viaddmax_s32(row[jj], x[jj], xo);
    }
    __syncthreads();  // x and `cur` read before either is overwritten
    if (tid < Wp) x[tid] = xo;
  }
}

// ---- route "column" of the compose ----

// Shared memory of one CTA of the column route: `nb` blocks' a rows
// (L rows of whole int4 each, + 16 bytes so that two blocks' rows at the
// same step fall in different bank quads), their raw exit half-units and
// band, then their cov and unsup (L + W each).
__host__ __device__ constexpr int col_a_ints(int W, int L) {
  return L * ((W + 4) / 4 * 4) + 4;
}

__host__ __device__ constexpr int col_smem(int W, int L, int nb) {
  return nb * (col_a_ints(W, L) * 4 + L * 4 + L * W * 2 + (L + W) * 3);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

template <int W>
__global__ void __launch_bounds__(COL_MAX_THREADS)
blocked_compose_col_kernel(const int16_t* __restrict__ win,
                           const int16_t* __restrict__ cov,
                           const uint8_t* __restrict__ uns,
                           const int* __restrict__ eex, int* __restrict__ Mout,
                           int B, int V, int L, int nb) {
  constexpr int Wp = W + 1;
  constexpr int WPAD = (Wp + 3) / 4 * 4;
  constexpr int NACC = W >= 32 ? 4 : 2;
  extern __shared__ __align__(16) unsigned char csm[];
  const int areg = col_a_ints(W, L);
  int* a_s = reinterpret_cast<int*>(csm);             // [nb][areg]
  int* eex_s = a_s + nb * areg;                        // [nb * L]
  int16_t* win_s = reinterpret_cast<int16_t*>(eex_s + nb * L);  // [nb*L*W]
  int16_t* cov_s = win_s + nb * L * W;                 // [nb][L + W]
  uint8_t* uns_s = reinterpret_cast<uint8_t*>(cov_s + nb * (L + W));
  const int G = V / L;
  const long long nblk = (long long)B * G;
  const long long blk0 = (long long)blockIdx.x * nb;
  const int nbk = (int)min((long long)nb, nblk - blk0);
  const int tid = threadIdx.x;
  const int nt = blockDim.x;

  // The CTA's blocks are consecutive in (b, g) order, so their band rows
  // and exit half-units are each one contiguous run (L W int16 = a whole
  // number of 16-byte words a block, L >= 16 int32).
  const int16_t* wsrc = win + blk0 * L * W;
  const int wn = nbk * L * W;
  if ((reinterpret_cast<uintptr_t>(wsrc) & 15) == 0) {
    for (int k = tid * 8; k < wn; k += nt * 8) cp_async16(win_s + k, wsrc + k);
  } else {
    for (int k = tid; k < wn; k += nt) win_s[k] = wsrc[k];
  }
  const int* esrc = eex + blk0 * L;
  const int en = nbk * L;
  if ((reinterpret_cast<uintptr_t>(esrc) & 15) == 0) {
    for (int k = tid * 4; k < en; k += nt * 4) cp_async16(eex_s + k, esrc + k);
  } else {
    for (int k = tid; k < en; k += nt) eex_s[k] = esrc[k];
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  // cov and unsup of each block's slot targets (a 2-byte and a 1-byte
  // gather, clamped at V - 1): loads issued four at a time.
#pragma unroll 4
  for (int k = tid; k < nbk * (L + W); k += nt) {
    const int q = k / (L + W);
    const int i = k - q * (L + W);
    const long long blk = blk0 + q;
    const long long b = blk / G;
    const int g = (int)(blk - b * G);
    const long long t = b * V + min(g * L + 1 + i, V - 1);
    cov_s[k] = __ldg(cov + t);
    uns_s[k] = __ldg(uns + t);
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  // The a rows: a[r][d] = esc2 of band slot (r, d), a[r][W] = exit.
  for (int q = 0; q < ((X2_ABLATE & 16) ? 0 : nbk); ++q) {
    const int16_t* wq = win_s + q * L * W;
    const int16_t* cq = cov_s + q * (L + W);
    const uint8_t* uq = uns_s + q * (L + W);
    int* aq = a_s + q * areg;
    for (int k = tid; k < L * Wp; k += nt) {
      const int r = k / Wp;
      const int d = k - r * Wp;
      int v;
      if (d < W) {
        const int wc = wq[r * W + d];
        v = wc < 0 ? SENT : (uq[r + d] ? PENALTY2 : 2 * wc - (int)cq[r + d]);
      } else {
        v = eex_s[q * L + r];
      }
      aq[r * WPAD + d] = v;
    }
  }
  __syncthreads();

  const int q = tid / Wp;
  const int j = tid - q * Wp;
  if (q >= nbk) return;
  const int* ab = a_s + q * areg;
  // Column j of the identity: c[i] = M[i][j] (i < W); row W stays put.
  int c[W];
#pragma unroll
  for (int i = 0; i < W; ++i) c[i] = i == j ? 0 : SENT;
  const int cW = j == W ? 0 : SENT;
  // Groups of GS steps, unrolled: at step u of a group logical row i
  // sits in c[(i - u) mod W], and the new row 0 takes the register of the
  // dropped row W - 1. GS = W up to 32; at W = 64 a group is 32 steps
  // and the registers then move 32 places (64 moves a group, ~3% of its
  // terms), which keeps the unrolled body, and nvcc's time, to that of
  // W = 32 twice.
  constexpr int GS = W < 32 ? W : 32;
  for (int t0 = (X2_ABLATE & 8) ? L : 0; t0 < L; t0 += GS) {
#pragma unroll
    for (int u = 0; u < GS; ++u) {
      const int4* at = reinterpret_cast<const int4*>(ab + (L - 1 - t0 - u) * WPAD);
      int acc[NACC];
#pragma unroll
      for (int h = 0; h < NACC; ++h) acc[h] = SENT;
#pragma unroll
      for (int qq = 0; qq < WPAD / 4; ++qq) {
        const int4 v = at[qq];
        const int av[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * qq + e;
          if (i < W) {
            acc[i % NACC] =
                addmax(av[e], c[(i - u + W) % W], acc[i % NACC]);
          } else if (i == W) {
            acc[i % NACC] = addmax(av[e], cW, acc[i % NACC]);
          }
        }
      }
#pragma unroll
      for (int h = 1; h < NACC; ++h) acc[0] = max(acc[0], acc[h]);
      c[W - 1 - u] = acc[0];
    }
    if (GS < W) {  // logical row i back into c[i]
      int t[W];
#pragma unroll
      for (int i = 0; i < W; ++i) t[i] = c[(i - GS + W) % W];
#pragma unroll
      for (int i = 0; i < W; ++i) c[i] = t[i];
    }
  }
  int* Mg = Mout + (blk0 + q) * Wp * Wp;
  if (X2_ABLATE & 2) {  // keep the steps: one store of their sum
    int sum = cW;
#pragma unroll
    for (int k = 0; k < W; ++k) sum += c[k];
    if (sum == 12345) Mg[j] = sum;
    return;
  }
#pragma unroll
  for (int k = 0; k < W; ++k) Mg[k * Wp + j] = c[k];
  Mg[W * Wp + j] = cW;
}

// ---- route "warp" of the propagate ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar,
                                                   uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Spins on test_wait (no suspension: the slot is nearly always ready);
// past 2^34 cycles (~10 s) it traps, so a fault in the barrier protocol
// fails the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  long long t0 = 0;
  uint32_t done;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0) t0 = clock64();
    else if (clock64() - t0 > (1LL << 34)) __trap();
  }
}

// Ints of one ring slot: the 16-byte-aligned superset of a chunk of
// `chunk` consecutive matrices of (W+1)^2 int32 (one contiguous run),
// which starts 0-3 ints before it and ends at most 3 past it.
__host__ __device__ constexpr int prop_slot_ints(int W, int chunk) {
  return (chunk * (W + 1) * (W + 1) + 6) / 4 * 4;
}

// Shared memory of one target (a consumer and a producer warp): `depth`
// ring slots, the history of x (depth chunks of vectors of whole int4s:
// x before each step, kept until the producer wrote it to x_in), an
// mbarrier a slot and the consumer's step count.
__host__ __device__ constexpr int prop_warp_bytes(int W, int depth,
                                                  int chunk) {
  return ((depth * prop_slot_ints(W, chunk) +
           depth * chunk * ((W + 4) / 4 * 4)) *
              4 +
          depth * 8 + 16 + 15) /
         16 * 16;
}

// Issues the copy of the run at `src` (WW int32: a chunk of matrices)
// into `slot`, completing on `bar` (one arrival a phase, lane 0's, with
// the bytes): lane 0 bulk-copies the run's 16-byte-aligned superset,
// which lies inside the tensor [lo, hi) but for a misaligned first or
// last run; there the lanes copy the head or tail words outside the
// bulk copy themselves, before it is issued. Called by the whole
// producer warp.
__device__ __forceinline__ void issue_matrix(const int* src, int* slot,
                                             uint64_t* bar, int WW,
                                             const int* lo, const int* hi,
                                             int lane) {
  const int mis = (int)((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
  const int* a0 = src - mis;                                // aligned down
  const int* a1 = src + WW + ((4 - ((mis + WW) & 3)) & 3);  // aligned up
  const int* b0 = a0 >= lo ? a0 : a0 + 4;
  const int* b1 = a1 <= hi ? a1 : a1 - 4;
  if (b0 != a0 || b1 != a1) {  // a misaligned end of the tensor
    const int* w = lane < 4 ? a0 + lane : a1 - 8 + lane;
    if (lane < 8 && (lane < 4 ? b0 != a0 : b1 != a1) && w >= src &&
        w < src + WW) {
      slot[w - a0] = *w;
    }
    __syncwarp();
  }
  if (lane == 0 && b1 > b0) {
#if !(X2_ABLATE & 1)
    // The slot was last read through the generic proxy.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
#endif
    const uint32_t bytes = (uint32_t)((b1 - b0) * 4);
    mbar_arrive_expect(bar, bytes);
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(slot + (b0 - a0))),
        "l"(b0), "r"(bytes), "r"(smem_u32(bar))
        : "memory");
  } else if (lane == 0) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                     smem_u32(bar))
                 : "memory");
  }
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.cta.shared.b32 %0, [%1];\n"
               : "=r"(v)
               : "r"(smem_u32(p))
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.cta.shared.b32 [%0], %1;\n" ::"r"(smem_u32(p)),
               "r"(v)
               : "memory");
}

// The max over j of m_row[j] + x[j] and SENT, in four chains; the row
// from shared memory (runtime width).
template <int R>
__device__ __forceinline__ void rows_from_smem(const int* m, const int* x,
                                               const int (&rows)[R], int Wp,
                                               int (&out)[R]) {
  int acc[R][4];
#pragma unroll
  for (int k = 0; k < R; ++k) acc[k][0] = acc[k][1] = acc[k][2] = acc[k][3] = SENT;
  const int4* x4 = reinterpret_cast<const int4*>(x);
  for (int q = 0; q < Wp / 4; ++q) {
    const int4 xv = x4[q];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int* row = m + rows[k] * Wp + 4 * q;
      acc[k][0] = addmax(row[0], xv.x, acc[k][0]);
      acc[k][1] = addmax(row[1], xv.y, acc[k][1]);
      acc[k][2] = addmax(row[2], xv.z, acc[k][2]);
      acc[k][3] = addmax(row[3], xv.w, acc[k][3]);
    }
  }
  for (int jj = Wp / 4 * 4; jj < Wp; ++jj) {
    const int xj = x[jj];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      acc[k][0] = addmax(m[rows[k] * Wp + jj], xj, acc[k][0]);
    }
  }
#pragma unroll
  for (int k = 0; k < R; ++k) {
    out[k] = max(max(acc[k][0], acc[k][1]), max(acc[k][2], acc[k][3]));
  }
}

// R band rows a lane; WC the band width where it is known at compile
// time (0: the runtime W). With WC (<= 32), the consumer holds its row of
// the next step's M in registers, loaded a step ahead.
template <int R, int WC>
__global__ void __launch_bounds__(PROP_MAX_WARPS * 64)
blocked_propagate_warp_kernel(const int* __restrict__ M,
                              int* __restrict__ x_in, int B, int G, int Wrt,
                              int depth, int chunk) {
  extern __shared__ __align__(16) unsigned char psm[];
  const int W = WC ? WC : Wrt;
  const int pairs = blockDim.x >> 6;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // Warps 0 .. pairs-1 consume, warps pairs .. 2 pairs-1 produce.
  const bool producer = warp >= pairs;
  const int pair = producer ? warp - pairs : warp;
  const long long b = (long long)blockIdx.x * pairs + pair;
  const bool live = b < B;  // the last CTA's spare pairs only sync once
  const int Wp = W + 1;
  const int WW = Wp * Wp;
  const int XP = (W + 4) / 4 * 4;  // an x vector in whole int4
  const int H = depth * chunk;     // vectors in the history of x
  const int slot = prop_slot_ints(W, chunk);
  int* ring =
      reinterpret_cast<int*>(psm + pair * prop_warp_bytes(W, depth, chunk));
  int* xh = ring + depth * slot;  // [H][XP]: x before each step
  uint64_t* bars = reinterpret_cast<uint64_t*>(xh + H * XP);
  int* cons = reinterpret_cast<int*>(bars + depth);  // consumer's steps done
  const int* Mb = M + b * G * WW;
  const int NC = (G + chunk - 1) / chunk;  // chunks: steps [c K, c K + K)
  // Chunk c holds matrices g = lo_g(c) .. G-1-cK, the run from lo_g(c).
  auto lo_g = [&](int c) { return max(0, G - (c + 1) * chunk); };

  if (!live) {
  } else if (producer) {
    if (lane == 0) {
      for (int k = 0; k < depth; ++k) mbar_init(&bars[k], 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
  } else {
    for (int k = lane; k < Wp; k += 32) xh[k] = k == W ? 0 : SENT;
    if (lane == 0) *cons = 0;
  }
  __syncthreads();  // the barriers, x before step 0 and the count
  if (!live) return;
  if (producer) {
    const int* lo = M;
    const int* hi = M + (long long)B * G * WW;
    int* xb = x_in + b * G * Wp;
    int flushed = 0;  // steps whose x went to x_in
    for (int c = 0; c <= NC; ++c) {
#if X2_PROF
      long long _t = clock64();
#endif
      // Slot c % depth is free once the consumer finished chunk c - depth.
      const int done = c == NC ? G : max(0, (c - depth + 1) * chunk);
      int seen;
      while ((seen = ld_acquire(cons)) < done) {
        __nanosleep(256);  // ~ half a consumer step
      }
      seen = __reduce_min_sync(FULL, seen);  // what every lane acquired
      X2_TICK(3);
      // x before step t is in the history once the consumer finished
      // step t - 1. Lanes 1-31 write x_in: lane 0, whose arrivals on the
      // ring's barriers release its earlier stores, stores nothing.
      const int ready = min(seen + 1, G);
      if (lane > 0) {
        for (int k = lane - 1; k < (ready - flushed) * Wp; k += 31) {
          const int q = k / Wp;
          const int j = k - q * Wp;
          const int t = flushed + q;
          xb[(long long)(G - 1 - t) * Wp + j] = xh[(t % H) * XP + j];
        }
      }
      flushed = ready;
      X2_TICK(4);
      if (c == NC) break;
      if ((X2_ABLATE & 64) && c >= depth) continue;
      const int g0 = lo_g(c);
      issue_matrix(Mb + (long long)g0 * WW, ring + (c % depth) * slot,
                   &bars[c % depth], (G - c * chunk - g0) * WW, lo, hi, lane);
      X2_TICK(6);
    }
    return;
  }

  // The consumer.
  int rows[R];
#pragma unroll
  for (int k = 0; k < R; ++k) rows[k] = min(lane + 32 * k, W);
  constexpr int WPC = WC ? WC + 1 : 1;  // a register row (WC <= 32)
  int mr[WPC];
  // This lane's exit-row entries, columns lane, lane + 32, ..
  constexpr int NE = WC ? (WC + 32) / 32 : (MAX_W + 32) / 32;
  int ex[NE];
  // The first matrix (g = G-1-cK) of chunk c in its slot.
  auto first = [&](int c) {
    const int* run = Mb + (long long)lo_g(c) * WW;
    return ring + (c % depth) * slot +
           (int)((reinterpret_cast<uintptr_t>(run) >> 2) & 3) +
           (G - 1 - c * chunk - lo_g(c)) * WW;
  };
  // This lane's row of M_g in registers (WC) and its exit-row entries.
  auto load_step = [&](const int* m) {
    if (WC) {
#pragma unroll
      for (int j = 0; j < WPC; ++j) mr[j] = m[rows[0] * Wp + j];
    }
    if (!(WC && WC < 32)) {
#pragma unroll
      for (int k = 0; k < NE; ++k) {
        ex[k] = lane + 32 * k < Wp ? m[W * Wp + lane + 32 * k] : SENT;
      }
    }
  };
  int hx = 0;        // history index of x before this step
  int nc = 0;        // the chunk of this step
  int left = chunk;  // steps of chunk nc from this one on
#if X2_PROF
  long long _t = clock64();
#endif
  mbar_wait(&bars[0], 0);
  const int* m = first(0);
  load_step(m);
  for (int s = 0; s < G; ++s) {
    const int* x = xh + hx * XP;
    hx = hx + 1 == H ? 0 : hx + 1;
    int* xn = xh + hx * XP;
    X2_TICK(0);
    // The exit row: this lane's columns, then the max over the warp
    // (at W = 16, lane 16 computes it as its band row instead).
    int e = SENT;
    if (!(WC && WC < 32)) {
#pragma unroll
      for (int k = 0; k < NE; ++k) {
        if (lane + 32 * k < Wp) e = addmax(ex[k], x[lane + 32 * k], e);
      }
      e = __reduce_max_sync(FULL, e);
    }
    int out[R];
    if (X2_ABLATE & 4) {
#pragma unroll
      for (int k = 0; k < R; ++k) out[k] = SENT;
    } else if (WC) {
      // Eight short chains of an add and a max a term.
      int xr[WPC];
      const int4* x4 = reinterpret_cast<const int4*>(x);
#pragma unroll
      for (int q = 0; q < WPC / 4; ++q) {
        const int4 xv = x4[q];
        xr[4 * q] = xv.x;
        xr[4 * q + 1] = xv.y;
        xr[4 * q + 2] = xv.z;
        xr[4 * q + 3] = xv.w;
      }
#pragma unroll
      for (int j = WPC / 4 * 4; j < WPC; ++j) xr[j] = x[j];
      constexpr int NA = 8;
      int acc[NA];
#pragma unroll
      for (int h = 0; h < NA; ++h) acc[h] = SENT;
#pragma unroll
      for (int j = 0; j < WPC; ++j) {
        acc[j % NA] = add_then_max(mr[j], xr[j], acc[j % NA]);
      }
#pragma unroll
      for (int h = 1; h < NA; ++h) acc[0] = max(acc[0], acc[h]);
      out[0] = acc[0];
    } else {
      rows_from_smem<R>(m, x, rows, Wp, out);
    }
    X2_TICK(1);
#pragma unroll
    for (int k = 0; k < R; ++k) {
      if (lane + 32 * k < W) xn[lane + 32 * k] = out[k];
    }
    if (WC && WC < 32) {
      if (lane == W) xn[W] = out[0];
    } else if (lane == 0) {
      xn[W] = e;
    }
    // The next step's matrix, into the registers just read: the next one
    // down in this chunk's slot, or the first of the next chunk, whose
    // slot it waits on.
    if (s + 1 < G) {
      if (--left == 0) {
        left = chunk;
        ++nc;
        if (!(X2_ABLATE & 64) || nc < depth) {
          mbar_wait(&bars[nc % depth], (nc / depth) & 1);
        }
        m = first(nc);
      } else {
        m -= WW;
      }
      load_step(m);
    }
    __syncwarp();  // xn written; x and this step's matrix read by all lanes
    if (lane == 0) st_release(cons, s + 1);
    X2_TICK(2);
#if X2_PROF
    if (b == 0 && lane == 0) x2_prof[5] += 1;
#endif
  }
}

__global__ void __launch_bounds__(FILL_WARPS * 32)
blocked_fill_kernel(const int16_t* __restrict__ win,
                    const int16_t* __restrict__ cov,
                    const uint8_t* __restrict__ uns,
                    const int* __restrict__ eex,
                    const int* __restrict__ x_in, int* __restrict__ s2,
                    int B, int V, int W, int L, int warp_bytes) {
  extern __shared__ unsigned char fsm[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int G = V / L;
  const long long pair = (long long)blockIdx.x * FILL_WARPS + warp;
  if (pair >= (long long)B * G) return;
  const int b = (int)(pair / G);
  const int g = (int)(pair - (long long)b * G);
  unsigned char* mine = fsm + warp * warp_bytes;
  int* ring = reinterpret_cast<int*>(mine);  // [W]
  int* outb = ring + W;                      // [L]
  const Staged st = carve(reinterpret_cast<unsigned char*>(outb + L), W, L);
  const int* xin = x_in + pair * (W + 1);
  const long long rowbase = (long long)b * V + (long long)g * L;

  stage_block(win, cov, uns, eex, st, b, g, V, W, L, lane, 32);
  for (int d = lane; d < W; d += 32) ring[d] = xin[d];
  __syncwarp();

  int head = 0;  // ring slot of window entry d = 0
  for (int t = 0; t < L; ++t) {
    const int r = L - 1 - t;
    int acc = lane == 0 ? max(SENT, st.eex[r]) : SENT;
#pragma unroll
    for (int k = 0; k < MAX_W / 32; ++k) {
      const int d = lane + 32 * k;
      if (d < W) {
        int slot = head + d;
        if (slot >= W) slot -= W;
        acc = __viaddmax_s32(esc2_of(st, r, d, W), ring[slot], acc);
      }
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) acc = max(acc, __shfl_xor_sync(FULL, acc, o));
    const int nslot = head == 0 ? W - 1 : head - 1;  // drops entry W - 1
    __syncwarp();
    if (lane == 0) {
      ring[nslot] = acc;
      outb[r] = acc;
    }
    head = nslot;
    __syncwarp();
  }
  for (int k = lane; k < L; k += 32) s2[rowbase + k] = outb[k];
}

// ---- route "lane" of the fill ----

__host__ __device__ constexpr int r16(int n) { return (n + 15) / 16 * 16; }

// Shared memory of one warp of the lane route, for `nb` consecutive
// blocks, each part whole 16-byte words: their band rows (one run of
// nb L W int16, placed at the run's own offset in a 16-byte word: up to
// 14 bytes more), their node words (L + W int2 each, after 4 words of
// padding), exits (L each, after lane_ex_pad(W) ints of padding), x_in
// (W) and scores (nb L int32 at the output's offset in a 16-byte word).
// The paddings take the loads of the steps' look-ahead past a block's
// first row (node words down to index -3, exits down to -W - 2), whose
// values no score uses.
__host__ __device__ constexpr int lane_ex_pad(int W) { return (W + 7) / 4 * 4; }

__host__ __device__ constexpr int lane_warp_bytes(int W, int L, int nb) {
  return r16(nb * L * W * 2 + 14) + r16((nb * (L + W) + 4) * 8) +
         r16((nb * L + lane_ex_pad(W)) * 4) + r16(nb * W * 4) +
         r16(nb * L * 4 + 12);
}

// The lane route: R slots a lane (R = 1 for W <= 32, `nb` blocks a warp
// in groups of W lanes; else one block a warp, slot k on lane k % 32,
// register k / 32). See the file's head for the design.
template <int R>
__global__ void __launch_bounds__(LANE_MAX_WARPS * 32)
blocked_fill_lane_kernel(const int16_t* __restrict__ win,
                         const int16_t* __restrict__ cov,
                         const uint8_t* __restrict__ uns,
                         const int* __restrict__ eex,
                         const int* __restrict__ x_in, int* __restrict__ s2,
                         int B, int V, int W, int L, int nb) {
  extern __shared__ __align__(16) unsigned char lsm[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int G = V / L;
  const long long nblk = (long long)B * G;
  const long long blk0 =
      ((long long)blockIdx.x * (blockDim.x >> 5) + warp) * nb;
  if (blk0 >= nblk) return;  // no barrier follows: the warp just leaves
  const int nbk = (int)min((long long)nb, nblk - blk0);
#if X2_PROF
  long long _f = clock64();
#define X2_FTICK(k)                                     \
  do {                                                  \
    const long long _n = clock64();                     \
    if (blk0 == 0 && lane == 0) x2_prof[k] += _n - _f;  \
    _f = _n;                                            \
  } while (0)
#else
#define X2_FTICK(k) \
  do {              \
  } while (0)
#endif
  unsigned char* p = lsm + warp * lane_warp_bytes(W, L, nb);
  int16_t* band_buf = reinterpret_cast<int16_t*>(p);
  p += r16(nb * L * W * 2 + 14);
  int2* nodes = reinterpret_cast<int2*>(p) + 4;  // [nb][L + W]
  p += r16((nb * (L + W) + 4) * 8);
  int* ex = reinterpret_cast<int*>(p) + lane_ex_pad(W);  // [nb][L]
  p += r16((nb * L + lane_ex_pad(W)) * 4);
  int* xs = reinterpret_cast<int*>(p);  // [nb][W]
  p += r16(nb * W * 4);
  int* out_buf = reinterpret_cast<int*>(p);

  // The band: one run of nbk L W int16 from blk0's first row; the
  // 16-byte words wholly inside it by cp.async, the rest by lanes.
  const int16_t* wsrc = win + blk0 * L * W;
  const int wn = nbk * L * W;
  int16_t* band = band_buf + ((reinterpret_cast<uintptr_t>(wsrc) >> 1) & 7);
  {
    const int mis = (int)(reinterpret_cast<uintptr_t>(wsrc) & 15);
    const int head = min(wn, ((16 - mis) & 15) / 2);
    const int words = (wn - head) / 8;
#if !(X2_ABLATE & 128)
    for (int k = lane; k < words; k += 32) {
      cp_async16(band + head + 8 * k, wsrc + head + 8 * k);
    }
    for (int k = lane; k < head; k += 32) band[k] = wsrc[k];
    for (int k = head + 8 * words + lane; k < wn; k += 32) band[k] = wsrc[k];
#endif
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  // Node words, exits and x_in, while the band is in flight.
  for (int q = 0; q < nbk; ++q) {
    const long long blk = blk0 + q;
    const long long b = blk / G;
    const int g = (int)(blk - b * G);
    const int16_t* cb = cov + b * V;
    const uint8_t* ub = uns + b * V;
#pragma unroll 4
    for (int i = lane; i < L + W; i += 32) {
      const int t = min(g * L + 1 + i, V - 1);
      const int c = __ldg(cb + t);
      nodes[q * (L + W) + i] =
          __ldg(ub + t) ? make_int2(0, PENALTY2) : make_int2(2, -c);
    }
  }
  for (int k = lane; k < nbk * L; k += 32) ex[k] = __ldg(eex + blk0 * L + k);
  for (int k = lane; k < nbk * W; k += 32) {
    const int q = k / W;
    xs[k] = __ldg(x_in + (blk0 + q) * (W + 1) + (k - q * W));
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncwarp();
  X2_FTICK(8);

  // This lane's group (block) and slots. Lanes past the warp's live
  // groups read group 0's words and keep no row.
  const int qg = R == 1 ? lane / W : 0;
  const bool live = qg < nbk;
  const int k0 = R == 1 ? lane - qg * W : lane;
  const int q = live ? qg : 0;
  const int16_t* bq = band + q * L * W;
  const int2* nq = nodes + q * (L + W);
  const int* eq = ex + q * L;
  const int* xq = xs + q * W;
  int* oq = out_buf + ((reinterpret_cast<uintptr_t>(s2 + blk0 * L) >> 2) & 3) +
            q * L;
  // esc2 of band slot (r, d): its node word is that of index r + d.
  auto esc = [&](int r, int d) {
    const int wc = bq[r * W + d];
    const int2 nw = nq[r + d];
    return wc < 0 ? SENT : nw.x * wc + nw.y;
  };
  int acc[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int k = k0 + 32 * j;
    const int r = L - 1 - k;  // slot k's first row
    acc[j] = SENT;
    if (live && k < W && r >= 0) {
      // Row r's terms from the boundary: d = k .. W-1, s[r+1+d] = x_in[d-k].
      int a0 = max(SENT, eq[r]), a1 = SENT;
      int d = k;
#pragma unroll 4
      for (; d + 1 < W; d += 2) {
        a0 = addmax(esc(r, d), xq[d - k], a0);
        a1 = addmax(esc(r, d + 1), xq[d + 1 - k], a1);
      }
      if (d < W) a0 = addmax(esc(r, d), xq[d - k], a0);
      acc[j] = max(a0, a1);
    }
  }
  X2_FTICK(9);

  // Step t finishes row u = L-1-t, held by slot t % W of the group.
  // The steps run in chunks of CW: W at R = 1 (so that the owner slot of
  // chunk step tt is tt), else 32; lane `me` of the group (the warp)
  // keeps chunk step me's score in a register, stored after the chunk,
  // so that no store sits between a step's shuffle and the next steps'
  // loads. Each slot's term at step t reads band word idx(t) = r (W - 1)
  // + u - 1 of its row r: one less each step, and P(u) for the slot that
  // takes row u - W (negative where that row is none: the loads clamp it
  // to 0 and the term goes to an accumulator no score reads). A step's
  // operands (those band words, the node word of u - 1, the exit of u -
  // W) are loaded two steps ahead, so that a step's chain is its shuffle
  // and one DPX.
  const int src0 = R == 1 ? qg * W : 0;
  const int CW = R == 1 ? W : 32;
  const int me = R == 1 ? k0 : lane;
  auto P = [&](int u) { return (u - W) * (W - 1) + u - 1; };
  int ix[R], w0[R], w1[R];  // idx(t + 1); the band words of steps t, t + 1
  int2 n0 = nq[L - 2], n1 = nq[L - 3];
  int x0 = eq[L - 1 - W], x1 = eq[L - 2 - W];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int k = k0 + 32 * j;
    const int i0 = k == 0 ? P(L - 1) : (L - 1 - k) * (W - 1) + L - 2;
    ix[j] = k == 1 % W ? P(L - 2) : i0 - 1;
    w0[j] = bq[max(i0, 0)];
    w1[j] = bq[max(ix[j], 0)];
  }
  int o = 0, o2 = 2 % W;  // the owner slots of steps t and t + 2
  for (int t0 = (X2_ABLATE & 256) ? L : 0; t0 < L; t0 += CW) {
    const int n = min(CW, L - t0);
    int rec = 0;
#pragma unroll 4
    for (int tt = 0; tt < n; ++tt) {
      const int u = L - 1 - t0 - tt;
      const int os = R == 1 ? tt : o;
      int v = acc[0];
#pragma unroll
      for (int j = 1; j < R; ++j) v = (os >> 5) == j ? acc[j] : v;
      const int s = __shfl_sync(FULL, v, src0 + (os & 31));
      // Step t + 2's loads.
      const int pu = P(u - 2);
      int w2[R];
#pragma unroll
      for (int j = 0; j < R; ++j) {
        ix[j] = k0 + 32 * j == o2 ? pu : ix[j] - 1;
        w2[j] = bq[max(ix[j], 0)];
      }
      const int2 n2 = nq[u - 3];
      const int x2 = eq[u - 2 - W];
      // This step: the finished slot starts row u - W at max(SENT, its
      // exit); every slot takes its term with s[u].
      rec = me == tt ? s : rec;
      const int ex0 = max(SENT, x0);
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int e = w0[j] < 0 ? SENT : n0.x * w0[j] + n0.y;
        if (k0 + 32 * j == os) acc[j] = ex0;
        acc[j] = addmax(e, s, acc[j]);
        w0[j] = w1[j];
        w1[j] = w2[j];
      }
      n0 = n1;
      n1 = n2;
      x0 = x1;
      x1 = x2;
      o = o + 1 == W ? 0 : o + 1;
      o2 = o2 + 1 == W ? 0 : o2 + 1;
    }
    if (live && me < n) oq[L - 1 - t0 - me] = rec;
  }
  __syncwarp();
  X2_FTICK(10);

  // The scores: one run of nbk L int32 from s2 + blk0 L; whole 16-byte
  // words by int4 stores, the ends by lanes.
  {
    int* dst = s2 + blk0 * L;
    const int n = nbk * L;
    const int mo = (int)((reinterpret_cast<uintptr_t>(dst) >> 2) & 3);
    const int* src = out_buf + mo;
    const int head = min(n, (4 - mo) & 3);
    const int words = (n - head) / 4;
    for (int k = lane; k < words; k += 32) {
      reinterpret_cast<int4*>(dst + head)[k] =
          reinterpret_cast<const int4*>(src + head)[k];
    }
    for (int k = lane; k < head; k += 32) dst[k] = src[k];
    for (int k = head + 4 * words + lane; k < n; k += 32) dst[k] = src[k];
  }
  X2_FTICK(11);
#if X2_PROF
  if (blk0 == 0 && lane == 0) x2_prof[12] += L;
#endif
#undef X2_FTICK
}

int round_threads(int n) { return (n + 31) / 32 * 32; }

int set_smem(const void* kernel, int smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

bool bad_shape(int B, int V, int W, int L) {
  return B < 0 || V <= 0 || W < 1 || W > MAX_W || L < 1 || L > MAX_L ||
         V % L != 0;
}

// Shared memory a CTA may take (the wrappers' MAX_SMEM).
constexpr int SMEM_CAP = 232448;

int fill_warp_bytes(int W, int L) {
  return ((W + L) * 4 + staged_bytes(W, L) + 15) / 16 * 16;
}

}  // namespace

extern "C" {

// Dynamic shared memory of each kernel's CTA.
int dagcon_blocked_compose_smem(int W, int L) {
  return (L * (W + 1) + (W + 2) * (W + 1)) * 4 + staged_bytes(W, L);
}

int dagcon_blocked_propagate_smem(int W) {
  return (2 * (W + 1) * (W + 1) + (W + 1)) * 4;
}

int dagcon_blocked_fill_smem(int W, int L) {
  return FILL_WARPS * fill_warp_bytes(W, L);
}

int dagcon_blocked_fill_lane_smem(int W, int L, int blocks, int warps) {
  return warps * lane_warp_bytes(W, L, blocks);
}

int dagcon_blocked_column_smem(int W, int L, int blocks) {
  return col_smem(W, L, blocks);
}

int dagcon_blocked_propagate_warp_smem(int W, int warps, int depth,
                                       int chunk) {
  return warps * prop_warp_bytes(W, depth, chunk);
}

// route 0 "cta": blocks == 1, threads == round_threads(W + 1), smem ==
// dagcon_blocked_compose_smem; route 1 "column": W in {16, 32, 64}, L a
// multiple of W, 1 <= blocks <= 32, threads == 32 ceil(blocks (W+1) /
// 32) <= COL_MAX_THREADS, smem == dagcon_blocked_column_smem. Any other
// plan is refused (cudaErrorInvalidValue) before a launch.
int dagcon_blocked_compose(const void* win, const void* cov, const void* uns,
                           const void* eex, void* M, int B, int V, int W,
                           int L, int route, int blocks, int threads,
                           int smem, void* stream) {
  if (bad_shape(B, V, W, L)) return (int)cudaErrorInvalidValue;
  if (route == 0) {
    if (blocks != 1 || threads != round_threads(W + 1) ||
        smem != dagcon_blocked_compose_smem(W, L) || smem > SMEM_CAP) {
      return (int)cudaErrorInvalidValue;
    }
  } else if (route == 1) {
    if ((W != 16 && W != 32 && W != 64) || L % W != 0 || blocks < 1 ||
        blocks > 32 || threads != round_threads(blocks * (W + 1)) ||
        threads > COL_MAX_THREADS || smem != col_smem(W, L, blocks) ||
        smem > SMEM_CAP) {
      return (int)cudaErrorInvalidValue;
    }
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (B == 0) return 0;
  const int16_t* w = (const int16_t*)win;
  const int16_t* c = (const int16_t*)cov;
  const uint8_t* u = (const uint8_t*)uns;
  const int* e = (const int*)eex;
  cudaStream_t st = (cudaStream_t)stream;
  if (route == 0) {
    int err = set_smem((const void*)blocked_compose_kernel, smem);
    if (err) return err;
    blocked_compose_kernel<<<B * (V / L), threads, smem, st>>>(
        w, c, u, e, (int*)M, V, W, L);
    return (int)cudaGetLastError();
  }
  const long long nblk = (long long)B * (V / L);
  const int grid = (int)((nblk + blocks - 1) / blocks);
  const void* kern = W == 16   ? (const void*)blocked_compose_col_kernel<16>
                     : W == 32 ? (const void*)blocked_compose_col_kernel<32>
                               : (const void*)blocked_compose_col_kernel<64>;
  int err = set_smem(kern, smem);
  if (err) return err;
  if (W == 16) {
    blocked_compose_col_kernel<16><<<grid, threads, smem, st>>>(
        w, c, u, e, (int*)M, B, V, L, blocks);
  } else if (W == 32) {
    blocked_compose_col_kernel<32><<<grid, threads, smem, st>>>(
        w, c, u, e, (int*)M, B, V, L, blocks);
  } else {
    blocked_compose_col_kernel<64><<<grid, threads, smem, st>>>(
        w, c, u, e, (int*)M, B, V, L, blocks);
  }
  return (int)cudaGetLastError();
}

// route 0 "cta": warps == depth == chunk == 0, smem ==
// dagcon_blocked_propagate_smem; route 1 "warp": 1 <= warps (targets a
// CTA, two warps each) <= PROP_MAX_WARPS, 1 <= chunk (matrices a ring
// slot) <= min(G, PROP_MAX_CHUNK), min(nc, 2) <= depth (slots) <=
// min(nc, PROP_MAX_DEPTH) for nc = ceil(G / chunk) chunks, smem ==
// dagcon_blocked_propagate_warp_smem. Any other plan is refused.
int dagcon_blocked_propagate(const void* M, void* x_in, int B, int G, int W,
                             int route, int warps, int depth, int chunk,
                             int smem, void* stream) {
  if (B < 0 || G <= 0 || W < 1 || W > MAX_W) return (int)cudaErrorInvalidValue;
  if (route == 0) {
    if (warps != 0 || depth != 0 || chunk != 0 ||
        smem != dagcon_blocked_propagate_smem(W)) {
      return (int)cudaErrorInvalidValue;
    }
  } else if (route == 1) {
    // depth >= 2 where there are 2 chunks or more: the consumer waits on
    // the next chunk's slot before it releases the current one.
    const int nc = chunk >= 1 ? (G + chunk - 1) / chunk : 0;
    if (warps < 1 || warps > PROP_MAX_WARPS || chunk < 1 ||
        chunk > PROP_MAX_CHUNK || chunk > G || depth < min(nc, 2) ||
        depth > nc || depth > PROP_MAX_DEPTH ||
        smem != dagcon_blocked_propagate_warp_smem(W, warps, depth, chunk) ||
        smem > SMEM_CAP) {
      return (int)cudaErrorInvalidValue;
    }
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (B == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (route == 0) {
    int err = set_smem((const void*)blocked_propagate_kernel, smem);
    if (err) return err;
    blocked_propagate_kernel<<<B, round_threads(W + 1), smem, st>>>(
        (const int*)M, (int*)x_in, G, W);
    return (int)cudaGetLastError();
  }
  // Compile-time widths for the bench's and the oversize cell's bands;
  // any other W takes two rows a lane up to 64, four past it (a lane past
  // the band recomputes row W), so that the build stays small.
  const int R = W <= 64 ? 2 : 4;
  const void* kern =
      W == 16   ? (const void*)blocked_propagate_warp_kernel<1, 16>
      : W == 32 ? (const void*)blocked_propagate_warp_kernel<1, 32>
      : R == 2  ? (const void*)blocked_propagate_warp_kernel<2, 0>
                : (const void*)blocked_propagate_warp_kernel<4, 0>;
  int err = set_smem(kern, smem);
  if (err) return err;
  const int grid = (B + warps - 1) / warps;
  const int* m = (const int*)M;
  int* x = (int*)x_in;
  if (W == 16) {
    blocked_propagate_warp_kernel<1, 16><<<grid, warps * 64, smem, st>>>(
        m, x, B, G, W, depth, chunk);
  } else if (W == 32) {
    blocked_propagate_warp_kernel<1, 32><<<grid, warps * 64, smem, st>>>(
        m, x, B, G, W, depth, chunk);
  } else if (R == 2) {
    blocked_propagate_warp_kernel<2, 0><<<grid, warps * 64, smem, st>>>(
        m, x, B, G, W, depth, chunk);
  } else {
    blocked_propagate_warp_kernel<4, 0><<<grid, warps * 64, smem, st>>>(
        m, x, B, G, W, depth, chunk);
  }
  return (int)cudaGetLastError();
}

// route 0 "reduce": blocks == 1, warps == FILL_WARPS, smem ==
// dagcon_blocked_fill_smem; route 1 "lane": 1 <= blocks <= 32 / W (1 past
// W = 32), 1 <= warps <= LANE_MAX_WARPS, smem ==
// dagcon_blocked_fill_lane_smem. Any other plan is refused before a launch.
int dagcon_blocked_fill(const void* win, const void* cov, const void* uns,
                        const void* eex, const void* x_in, void* s2, int B,
                        int V, int W, int L, int route, int blocks, int warps,
                        int smem, void* stream) {
  if (bad_shape(B, V, W, L)) return (int)cudaErrorInvalidValue;
  if (route == 0) {
    if (blocks != 1 || warps != FILL_WARPS ||
        smem != dagcon_blocked_fill_smem(W, L) || smem > SMEM_CAP) {
      return (int)cudaErrorInvalidValue;
    }
  } else if (route == 1) {
    if (blocks < 1 || blocks > (W <= 32 ? 32 / W : 1) || warps < 1 ||
        warps > LANE_MAX_WARPS ||
        smem != dagcon_blocked_fill_lane_smem(W, L, blocks, warps) ||
        smem > SMEM_CAP) {
      return (int)cudaErrorInvalidValue;
    }
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (B == 0) return 0;
  const int16_t* w = (const int16_t*)win;
  const int16_t* c = (const int16_t*)cov;
  const uint8_t* u = (const uint8_t*)uns;
  const int* e = (const int*)eex;
  const int* xi = (const int*)x_in;
  int* out = (int*)s2;
  cudaStream_t st = (cudaStream_t)stream;
  const long long nblk = (long long)B * (V / L);
  if (route == 0) {
    int err = set_smem((const void*)blocked_fill_kernel, smem);
    if (err) return err;
    const int grid = (int)((nblk + FILL_WARPS - 1) / FILL_WARPS);
    blocked_fill_kernel<<<grid, FILL_WARPS * 32, smem, st>>>(
        w, c, u, e, xi, out, B, V, W, L, fill_warp_bytes(W, L));
    return (int)cudaGetLastError();
  }
  const long long nwarps = (nblk + blocks - 1) / blocks;
  const int grid = (int)((nwarps + warps - 1) / warps);
  const int R = W <= 32 ? 1 : W <= 64 ? 2 : 4;
  const void* kern = R == 1   ? (const void*)blocked_fill_lane_kernel<1>
                     : R == 2 ? (const void*)blocked_fill_lane_kernel<2>
                              : (const void*)blocked_fill_lane_kernel<4>;
  int err = set_smem(kern, smem);
  if (err) return err;
  if (R == 1) {
    blocked_fill_lane_kernel<1><<<grid, warps * 32, smem, st>>>(
        w, c, u, e, xi, out, B, V, W, L, blocks);
  } else if (R == 2) {
    blocked_fill_lane_kernel<2><<<grid, warps * 32, smem, st>>>(
        w, c, u, e, xi, out, B, V, W, L, blocks);
  } else {
    blocked_fill_lane_kernel<4><<<grid, warps * 32, smem, st>>>(
        w, c, u, e, xi, out, B, V, W, L, blocks);
  }
  return (int)cudaGetLastError();
}

#if X2_PROF
int dagcon_x2_prof_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, x2_prof, sizeof(x2_prof));
}

int dagcon_x2_prof_reset() {
  unsigned long long z[16] = {0};
  return (int)cudaMemcpyToSymbol(x2_prof, z, sizeof(z));
}
#endif

const char* dagcon_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
