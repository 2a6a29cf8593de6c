// Kernel X1 of the port: the batched banded global aligner of the `-a`
// device path and of dazcon, for Hopper (sm_90a).
//
// Replaces the XLA device programs of `pbdagcon_tpu/ops/align_tpu.py`:
// `_align_scan` (the row scan that emits 2-bit traceback pointers) and
// `_traceback_scan` (the pointer walk that emits the move stream). The
// contracts are those of `pbdagcon_tpu_torch/ops/align_tpu.py::
// align_scan_plain` and `traceback_plain`, array-equal: all of it is
// int32 arithmetic, so there is nothing to round.
//
// The scan has two routes, chosen per batch by the launch plan
// (`ops/align_cuda.py::scan_plan`) and checked by the C entry.
//
// Route "warp" (`align_scan_warp_kernel`), the rule: one warp per pair,
// up to 8 pairs (warps) per CTA, no block barrier. Lane k of row i holds
// column j = i + dmin + k. A pair's band over rows 1..m lies in a lane
// span [ks, ks + 32 * CPL) that `pair_window` bounds from rows 1 and m
// (c(i) - i is monotone in i), with a lane of margin each side; each
// thread owns CPL consecutive lanes (CPL a multiple of 4: whole pointer
// bytes), CPL in {4, 8, ..., 32} chosen per warp by a switch over
// template instances. Per row, in registers: the diagonal term is the
// thread's own previous cell, the up term the next one (one
// __shfl_down_sync for the last), the left chain the thread's running
// max of tmp + 3k and a 5-step __shfl_up_sync scan of the thread
// totals, seeded with the lanes left of the span (NEG, or the j == 0
// lane's GAP * i). The band (as a bit mask of the thread's cells) comes
// from the centre c = i * n / m, which advances by n / m and a
// remainder a row (no division).
// The warp computes rows 1..min(m + 1, M): row m + 1 still reads row m.
// Row 1 reads row 0, which is GAP * j on every 0 <= j <= n and not
// masked to the band, so a first pass computes row 1 over all Wa lanes
// in chunks of 128. Every other pointer has a closed form: 2 ("left",
// byte 0xAA), but 1 on the j == 0 lane (`ops/align_tpu.py::
// scan_closed_form`, which the CPU model `align_scan_window_model`
// holds against the plain version). Each row's bytes go straight to
// device memory, the span's from the threads that own them and the
// closed form's from all; the rows past min(m + 1, M) as the closed form
// in 16-byte stores. Every byte of [B, M, Wa / 4] is written once. The
// pair's query bytes and the target bytes its rows read are staged
// once in the warp's slice of shared memory; the target bytes slide
// through registers a lane a row. The plan orders the pairs so that
// each CTA of 8 holds heavy and light ones (rows x CPL), warps w and
// w + 4, which share a scheduler, a heavy and a light one.
//
// Route "cta" (`align_scan_kernel`, for batches whose spans outgrow a
// warp): one CTA per pair over all Wa lanes. The previous row and the
// current one live in shared memory (two buffers of Wa + 1 int32, the
// last entry a NEG sentinel for the up read of lane Wa - 1). Each
// thread owns a run of whole pointer bytes (4 lanes each; several when
// Wa / 4 is past the CTA's 256 threads). A row is:
//   1. per lane: diag = prev[k] + sub, up = prev[k + 1] + GAP,
//      tmp = max(diag, up), masked to NEG outside the pair's band
//      (1 <= j <= n, |j - c| <= bw with c = i * n / m in 64 bits,
//      i <= m), seeded with GAP * i at j == 0; the thread's running max
//      of tmp + 3k over its lanes is stored in place;
//   2. the running max across threads: a warp inclusive scan of the
//      thread totals by __shfl_up_sync, the warp totals through shared
//      memory, each thread folding the totals of the warps before it;
//   3. per lane: H = max(prefix, local) - 3k, the pointer by the
//      reference priority diag > up > left, H masked to NEG outside the
//      band (the j == 0 column kept), 4 pointers packed per byte (lane
//      4c + r at bits 2r of byte c) and written to device memory.
// Two barriers per row.
//
// The traceback walks the pointers from (m, n) for L steps and writes
// one move a step (0 diag, 1 up, 2 left, 3 done); after (0, 0) the rest
// of the row is 3. It is a chain of dependent pointer reads, ~800 a pair
// on the bench batch, and each step but a left one goes down a row. Two
// routes, chosen by the plan (`ops/align_cuda.py::traceback_plan`):
//
// Route "warp" (`align_traceback_warp_kernel`), the rule: one warp per
// pair, up to 8 pairs a CTA, the pairs dealt longest first. The walk
// reads its pointers from a staged window in shared memory: stage c
// holds rows m - c R .. m - c R - R + 1 (R rows a stage) over `window`
// bytes (4 lanes a byte; halved while wider than a row) from a 16-byte
// boundary, placed when the walk
// enters the stage before it, at lane l, from `window` lanes left of l
// (a step moves the lane by one at most, right on an up step). Two
// stages in a ring: on entering stage c the warp's lanes issue stage
// c + 1 as 16-byte cp.async copies, wait for stage c, and write pointer
// 1 on each of its rows' j == 0 lane (the reference's rule), so the
// walk itself knows nothing of j. The walk goes an event at a time: lane
// t reads the pointer of row r + t at the walk's lane x, two ballots
// give the run of diagonal steps before the first other pointer (or
// the stage's end) and that pointer, and the lanes write the run's
// moves at once; the up or left step at its end moves x. So the chain
// of dependent reads is one a non-diagonal step (~15% of the bench
// batch's steps), not one a step. A step outside the window (or on row
// 0, or with a lane outside 0..Wa - 1, whose byte index clamps) reads
// device memory by the exact rule: the route takes any pointer tensor,
// not only the scan's. The moves go to a ring of TB_RING bytes in
// shared memory, and out as 16-byte stores (the row's partial blocks at
// either end byte by byte: row b starts at b * L), the tail of 3s by
// the whole warp.
//
// Route "thread" (`align_traceback_kernel`, the first design): one
// thread per pair, each step a dependent one-byte load from device
// memory; kept for comparison, taken only by a forced plan.
//
// The replay (`align_replay_kernel`) turns the moves into the gapped
// rows on the card: the reference's numpy replay inside `align_batch`
// (`pbdagcon_tpu/ops/align_tpu.py:244-280`), whose contract is
// `ops/align_tpu.py::replay_plain`, array-equal; the moves never leave
// the card, and one copy brings the rows and path lengths back. A warp
// per pair (see the kernel). It moves a few MB (the moves, the bases,
// the rows) and does a few integer operations a position: microseconds
// at the memory rate; its time is each warp's chain of chunks, a move
// load, the ballots and a base load each.
//
// What bounds it on this card: the scan's M sequential rows. Per pair it
// reads M + (M + Wa) bytes and writes M * Wa / 4, a few hundred KB, and
// does ~20 integer operations per band cell; the whole batch's bytes
// over the memory rate are tens of microseconds, its operations over the
// int32 rate a few more, while each pair's rows run one after another.
// The "cta" route pays two block barriers and shared-memory round trips
// a row over all Wa lanes; the "warp" route computes only the pair's
// span (about 30% of the lanes on the bench batch), in registers. Its
// time is the longest, widest pair's rows one after another: at CPL 24
// a row takes ~1,900 cycles (the first pass ~750, the warp scan ~310,
// the second pass ~530, the stores ~280, by the -D X1_PROF=1 clocks of
// `tools/align_ablate.py`), with its scheduler to itself for most of
// the run: one warp's integer instructions (16 lanes a cycle a
// scheduler) bound it. The traceback moves a few MB (the pointer bytes
// its paths read and the moves), microseconds at the memory rate; its
// time is the longest path's dependent steps. On the "thread" route a
// step is a round trip to device memory (the pointers have left L2 by
// then); on the "warp" route an event (a diagonal run and the step
// after it) is a shared-memory load, two ballots and ~50 integer
// instructions (~250 cycles by the -D X1_PROF=1 clocks), with the next
// stage's copies in flight behind the walk.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MATCH = 1;
constexpr int MISMATCH = -2;
constexpr int GAP = -3;
constexpr int NEG = -(1 << 30);
constexpr int MAX_THREADS = 256;
constexpr int MAX_WARPS = MAX_THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ bool in_band(long long j, long long lo,
                                        long long hi) {
  return j >= lo && j <= hi;
}

__global__ void __launch_bounds__(MAX_THREADS)
align_scan_kernel(const uint8_t* __restrict__ qb,
                  const uint8_t* __restrict__ tb,
                  const int* __restrict__ m_, const int* __restrict__ n_,
                  const int* __restrict__ bw_, uint8_t* __restrict__ packed,
                  int M, int T, int Wa, int dmin, int bytes_per_thread) {
  extern __shared__ int smem[];
  int* prev = smem;
  int* cur = smem + (Wa + 1);
  int* wtot = smem + 2 * (Wa + 1);
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane_id = tid & 31;
  const int warp = tid >> 5;
  const int m = m_[b];
  const int n = n_[b];
  const long long bw = bw_[b];
  const int Wa4 = Wa >> 2;
  const int c0 = min(tid * bytes_per_thread, Wa4);
  const int c1 = min(c0 + bytes_per_thread, Wa4);
  const int k0 = 4 * c0;
  const int k1 = 4 * c1;
  const uint8_t* q = qb + (size_t)b * M;
  const uint8_t* t = tb + (size_t)b * T;
  uint8_t* out = packed + (size_t)b * M * Wa4;

  // Row 0: H[0][j] = GAP * j for 0 <= j <= n.
  for (int k = tid; k < Wa; k += blockDim.x) {
    const int j0 = dmin + k;
    prev[k] = (j0 >= 0 && j0 <= n) ? GAP * j0 : NEG;
  }
  if (tid == 0) {
    prev[Wa] = NEG;
    cur[Wa] = NEG;
  }
  __syncthreads();

  for (int i = 1; i <= M; ++i) {
    const int qc = q[i - 1];
    const uint8_t* trow = t + i;  // trow[k] = t[j - 1]
    const long long c = m > 0 ? ((long long)i * n) / m : 0;
    const long long lo = c - bw > 1 ? c - bw : 1;
    const long long hi = c + bw < n ? c + bw : (long long)n;
    const bool row_ok = i <= m;
    const int jbase = i + dmin;

    // 1. tmp per lane, the thread's running max of tmp + 3k in place.
    int run = INT_MIN;
    for (int k = k0; k < k1; ++k) {
      const int j = jbase + k;
      const int sub = trow[k] == qc ? MATCH : MISMATCH;
      int tmp = max(prev[k] + sub, prev[k + 1] + GAP);
      if (!(row_ok && in_band(j, lo, hi))) tmp = NEG;
      if (j == 0) tmp = GAP * i;
      run = max(run, tmp + 3 * k);
      cur[k] = run;
    }

    // 2. The running max of the threads before this one.
    int v = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int u = __shfl_up_sync(FULL, v, off);
      if (lane_id >= off) v = max(v, u);
    }
    int excl = __shfl_up_sync(FULL, v, 1);
    if (lane_id == 0) excl = INT_MIN;
    if (lane_id == 31) wtot[warp] = v;
    __syncthreads();
    for (int w = 0; w < warp; ++w) excl = max(excl, wtot[w]);

    // 3. H, the pointers, the band mask; one byte per 4 lanes.
    for (int cb = c0; cb < c1; ++cb) {
      unsigned byte = 0;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int k = 4 * cb + r;
        const int j = jbase + k;
        const int h = max(excl, cur[k]) - 3 * k;
        const int sub = trow[k] == qc ? MATCH : MISMATCH;
        const unsigned p = h == prev[k] + sub ? 0u
                           : h == prev[k + 1] + GAP ? 1u : 2u;
        const bool keep = (row_ok && in_band(j, lo, hi)) || j == 0;
        cur[k] = keep ? h : NEG;
        byte |= p << (2 * r);
      }
      out[(size_t)(i - 1) * Wa4 + cb] = (uint8_t)byte;
    }
    __syncthreads();
    int* swap = prev;
    prev = cur;
    cur = swap;
  }
}

__global__ void align_traceback_kernel(const uint8_t* __restrict__ packed,
                                       const int* __restrict__ m_,
                                       const int* __restrict__ n_,
                                       uint8_t* __restrict__ moves, int B,
                                       int M, int Wa, int dmin, int L) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int Wa4 = Wa >> 2;
  const uint8_t* flat = packed + (size_t)b * M * Wa4;
  uint8_t* mv = moves + (size_t)b * L;
  int i = m_[b];
  int j = n_[b];
  int s = 0;
  for (; s < L; ++s) {
    if (i == 0 && j == 0) break;
    unsigned p;
    if (i == 0) {
      p = 2u;
    } else if (j == 0) {
      p = 1u;
    } else {
      const int lane = j - i - dmin;
      const int c = min(max(lane >> 2, 0), Wa4 - 1);
      p = (flat[(size_t)(i - 1) * Wa4 + c] >> (2 * (lane & 3))) & 3u;
    }
    i -= (p == 0u || p == 1u);
    j -= (p == 0u || p == 2u);
    mv[s] = (uint8_t)p;
  }
  for (; s < L; ++s) mv[s] = 3;
}

// ---- route "warp" ----

constexpr int WARP_MAX_CPL = 32;
// Ablation builds of the warp route (`tools/align_ablate.py`; their
// pointers are wrong, only their times count): bit 1 drops the stores of
// rows 2..min(m + 1, M), bit 2 the closed-form rows past them, bit 4 the
// warp scan of the thread totals.
#ifndef X1_ABLATE
#define X1_ABLATE 0
#endif

// Pair clocks for `tools/align_ablate.py` (-D X1_PROF=1; timing only):
// lane 0 of each warp writes its pair's start and end (%globaltimer,
// ns), rows, CPL, SM, hardware warp slot and the clock64() cycles of
// its rows by phase (the first pass, the warp scan, the second pass,
// the stores) to g_x1_prof, read by `dagcon_x1_prof_read`.
#ifndef X1_PROF
#define X1_PROF 0
#endif
#if X1_PROF
constexpr int kProfPairs = 4096;
__device__ unsigned long long g_x1_prof[kProfPairs][10];
__device__ __forceinline__ unsigned long long x1_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#endif

constexpr int MAX_WARPS_PER_CTA = 8;

__host__ __device__ constexpr int r16(int x) { return (x + 15) / 16 * 16; }

// Shared memory of one warp: the query bytes (M) and the target bytes
// its rows read (at most M - 1 + 32 * WARP_MAX_CPL)
// (`ops/align_cuda.py::warp_slot` computes the same).
__host__ __device__ constexpr int warp_slot(int M) {
  return r16(M) + r16(M + 32 * WARP_MAX_CPL);
}

// The pair's lane span [ks, ks + 32 * cpl): `ops/align_tpu.py::
// scan_windows`, the same arithmetic (m, n >= 1).
__device__ __forceinline__ void pair_window(int m, int n, int bw, int Wa,
                                            int dmin, int& ks, int& cpl) {
  const long long mm = m, nn = n, b = bw;
  const long long g1 = nn / mm - 1 - b;
  const long long gm = nn - mm - b;
  const long long lo = max(1 - mm, min(g1, gm)) - dmin;
  const long long hi = min(nn - 1, max(g1, gm) + 2 * b) - dmin;
  const long long s = max(0LL, lo - 1) / 4 * 4;
  const long long need = max(min((long long)Wa, hi + 2) - s, 1LL);
  const long long c = (need + 31) / 32;
  ks = (int)min(s, (long long)Wa);
  cpl = (int)min((c + 3) / 4 * 4, 1LL << 20);
}

// H[0][k]: GAP * j on 0 <= j = dmin + k <= n, NEG elsewhere and past
// the last lane.
__device__ __forceinline__ int row0(int k, int n, int Wa, int dmin) {
  const int j = dmin + k;
  return (k < Wa && j >= 0 && j <= n) ? GAP * j : NEG;
}

// The closed-form byte c of row i: 0xAA, with pointer 1 on the j == 0
// lane k0 = -i - dmin.
__device__ __forceinline__ unsigned closed_byte(int c, int i, int dmin) {
  const int k0 = -i - dmin;
  return (k0 >= 0 && (k0 >> 2) == c) ? (0xAAu ^ (3u << (2 * (k0 & 3))))
                                     : 0xAAu;
}

// Row 1 over all Wa lanes, 128 a step, straight to device memory.
__device__ __forceinline__ void scan_row1(const uint8_t* q,
                                          const uint8_t* t, uint8_t* out,
                                          int m, int n, long long bw,
                                          int Wa, int dmin, int lane) {
  const long long c1 = (long long)n / m;
  const long long lo = c1 - bw > 1 ? c1 - bw : 1;
  const long long hi = c1 + bw < n ? c1 + bw : (long long)n;
  const int qc = q[0];
  int carry = INT_MIN;
  for (int kc = 0; kc < Wa; kc += 128) {
    const int k4 = kc + 4 * lane;
    int cm[4], dg[4], up[4];
    int run = INT_MIN;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int k = k4 + r;
      const int j = 1 + dmin + k;
      const int sub = t[1 + k] == qc ? MATCH : MISMATCH;
      dg[r] = row0(k, n, Wa, dmin) + sub;
      up[r] = row0(k + 1, n, Wa, dmin) + GAP;
      int tmp = (j >= lo && j <= hi) ? max(dg[r], up[r]) : NEG;
      if (j == 0) tmp = GAP;
      run = max(run, tmp + 3 * k);
      cm[r] = run;
    }
    int v = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int u = __shfl_up_sync(FULL, v, off);
      if (lane >= off) v = max(v, u);
    }
    int excl = __shfl_up_sync(FULL, v, 1);
    if (lane == 0) excl = carry;
    excl = max(excl, carry);
    carry = max(carry, __shfl_sync(FULL, v, 31));
    unsigned byte = 0;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int h = max(excl, cm[r]) - 3 * (k4 + r);
      const unsigned p = h == dg[r] ? 0u : h == up[r] ? 1u : 2u;
      byte |= p << (2 * r);
    }
    out[kc / 4 + lane] = (uint8_t)byte;
  }
}

// One row i of the warp route over the span, in registers: Hp holds row
// i - 1 on entry and row i on exit, tq the target bytes t[i + k - 1] of
// the thread's lanes on entry and of row i + 1 on exit. ZROW: the j == 0
// lane may fall in the span (rows i <= -dmin - ks); past them it lies
// left of the span and enters through the seed only. Row i's pointer
// bytes in the span are stored to grow (none where !store) and the
// closed form to the rest of the row.
template <int CPL, bool ZROW>
__device__ __forceinline__ void warp_row(
    int i, int c, int (&Hp)[CPL], int (&tq)[CPL], const uint8_t* qs,
    const uint8_t* ts, uint8_t* __restrict__ grow, int m, int n, int bw,
    int R, int Wa, int dmin, int ks, int kb, int up_edge, int seed_neg,
    int sb, int se, bool store, int lane,
    unsigned long long (&ph)[4]) {
#if X1_PROF
  unsigned long long t_ph = clock64();
#define X1_PHASE(k)                          \
  do {                                       \
    const unsigned long long t_ = clock64(); \
    ph[k] += t_ - t_ph;                      \
    t_ph = t_;                               \
  } while (0)
#else
#define X1_PHASE(k) \
  do {              \
  } while (0)
#endif
  const int Wa4 = Wa >> 2;
  const int qc = qs[i - 1];
  const int tnext = i < R ? ts[i + lane * CPL + CPL - 1] : 0;
  // The band [max(1, c - bw), min(n, c + bw)] of row i (c = i * n / m,
  // kept by the caller) in this thread's lane offsets [vlo, vhi].
  int vlo = 1, vhi = 0;
  if (i <= m) {
    vlo = max(1, c - bw) - i - dmin - kb;
    vhi = min(min(n, c + bw) - i - dmin, Wa - 1) - kb;
  }
  const int k0 = -i - dmin;  // the j == 0 lane
  const int zc = k0 < Wa ? k0 - kb : -1;
  int upn = __shfl_down_sync(FULL, Hp[0], 1);
  if (lane == 31) upn = up_edge;

  // The band's and the j == 0 lane's cells of this thread as bits.
  const int blo = max(vlo, 0), bhi = min(vhi, CPL - 1);
  const unsigned vm =
      blo > bhi ? 0u : ((2u << bhi) - 1u) & ~((1u << blo) - 1u);
  const unsigned zm = (ZROW && zc >= 0 && zc < CPL) ? 1u << zc : 0u;
  int cm[CPL], dg[CPL], up[CPL];
  int run = INT_MIN;
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    dg[c] = Hp[c] + (tq[c] == qc ? MATCH : MISMATCH);
    up[c] = (c + 1 < CPL ? Hp[c + 1] : upn) + GAP;
    int tmp = (vm >> c) & 1u ? max(dg[c], up[c]) : NEG;
    if (ZROW && ((zm >> c) & 1u)) tmp = GAP * i;
    run = max(run, tmp + 3 * (kb + c));
    cm[c] = run;
  }
  int v = run;
  X1_PHASE(0);
  if (!(X1_ABLATE & 4)) {
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int u = __shfl_up_sync(FULL, v, off);
      if (lane >= off) v = max(v, u);
    }
  }
  int excl = __shfl_up_sync(FULL, v, 1);
  if (lane == 0) {
    excl = (k0 >= 0 && k0 < ks) ? max(seed_neg, GAP * i + 3 * k0) : seed_neg;
  }

  X1_PHASE(1);
  unsigned bytes[CPL / 4];
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    const int h = max(excl, cm[c]) - 3 * (kb + c);
    const unsigned p = h == dg[c] ? 0u : h == up[c] ? 1u : 2u;
    if ((c & 3) == 0) bytes[c >> 2] = 0;
    bytes[c >> 2] |= p << (2 * (c & 3));
    Hp[c] = ((vm | zm) >> c) & 1u ? h : NEG;
  }
#pragma unroll
  for (int c = 0; c + 1 < CPL; ++c) tq[c] = tq[c + 1];
  tq[CPL - 1] = tnext;
  X1_PHASE(2);

  if (X1_ABLATE & 1) {
    // Keep the pointers live without storing them.
    unsigned x = 0;
#pragma unroll
    for (int c4 = 0; c4 < CPL / 4; ++c4) x ^= bytes[c4];
    if (x == (unsigned)Wa * 977u) grow[0] = 0;
  } else if (store) {
#pragma unroll
    for (int c4 = 0; c4 < CPL / 4; ++c4) {
      const int bi = (kb >> 2) + c4;
      if (bi < Wa4) grow[bi] = (uint8_t)bytes[c4];
    }
    // The closed form outside the span's bytes [sb, se): the words
    // wholly outside it, then the bytes of the two words it cuts.
    const int wl = sb >> 2, wr = (se + 3) >> 2, nw = Wa4 >> 2;
    const int k0b = k0 >> 2;  // the j == 0 lane's byte (k0 >= 0)
    unsigned* gw = reinterpret_cast<unsigned*>(grow);
    for (int x = lane; x < wl + (nw - wr); x += 32) {
      const int w = x < wl ? x : wr + (x - wl);
      unsigned word = 0xAAAAAAAAu;
      if (k0 >= 0 && (k0b >> 2) == w) {
        word ^= (3u << (2 * (k0 & 3))) << (8 * (k0b & 3));
      }
      gw[w] = word;
    }
    if (lane < 8) {
      const int bi = lane < 4 ? 4 * wl + lane : se + (lane - 4);
      if ((lane < 4 ? bi < sb : bi < 4 * wr) && bi < Wa4) {
        grow[bi] = (uint8_t)closed_byte(bi, i, dmin);
      }
    }
  }
  X1_PHASE(3);
#undef X1_PHASE
}

template <int CPL>
__device__ void scan_pair_warp(const uint8_t* __restrict__ q,
                               const uint8_t* __restrict__ t,
                               uint8_t* __restrict__ out, int m, int n,
                               long long bw, int M, int T, int Wa,
                               int dmin, int ks, uint8_t* qs, uint8_t* ts,
                               int lane, int prof_b) {
  const int Wa4 = Wa >> 2;
  const int R = min(m + 1, M);
  const int span = 32 * CPL;
  // Stage the query bytes of rows 1..R and the target bytes ts[x] =
  // t[1 + ks + x] that rows 1..R read over the span (0 past T).
  for (int x = lane; x < R; x += 32) qs[x] = q[x];
  const int nt = R - 1 + span;
  for (int x = lane; x < nt; x += 32) {
    const int y = 1 + ks + x;
    ts[x] = y < T ? t[y] : 0;
  }
  __syncwarp();

  scan_row1(qs, t, out, m, n, bw, Wa, dmin, lane);

  const int kb = ks + lane * CPL;
  const int kend = ks + span;
  const int sb = ks >> 2;                       // the span's bytes
  const int se = min(Wa, kend) >> 2;            // [sb, se)
  int Hp[CPL];
  int tq[CPL];
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    Hp[c] = row0(kb + c, n, Wa, dmin);
    tq[c] = ts[lane * CPL + c];
  }
  const int seed_neg = ks > 0 ? NEG + 3 * (ks - 1) : INT_MIN;
  unsigned long long ph[4] = {0, 0, 0, 0};
  // The band centre c = i * n / m by steps: q + (r / m) a row.
  const int cq = n / m, cr = n % m;
  int c = 0, rem = 0;
  // Rows 1..iz may hold the j == 0 lane in the span; row 1's pointers
  // are the first pass's, so its row here only builds H.
  const int iz = min(R, max(0, -dmin - ks));
  const int bwi = (int)bw;
  for (int i = 1; i <= iz; ++i) {
    c += cq;
    rem += cr;
    if (rem >= m) {
      rem -= m;
      c += 1;
    }
    warp_row<CPL, true>(i, c, Hp, tq, qs, ts, out + (size_t)(i - 1) * Wa4,
                        m, n, bwi, R, Wa, dmin, ks, kb,
                        i == 1 ? row0(kend, n, Wa, dmin) : NEG, seed_neg, sb,
                        se, i >= 2, lane, ph);
  }
  for (int i = iz + 1; i <= R; ++i) {
    c += cq;
    rem += cr;
    if (rem >= m) {
      rem -= m;
      c += 1;
    }
    warp_row<CPL, false>(i, c, Hp, tq, qs, ts, out + (size_t)(i - 1) * Wa4,
                         m, n, bwi, R, Wa, dmin, ks, kb,
                         i == 1 ? row0(kend, n, Wa, dmin) : NEG, seed_neg,
                         sb, se, i >= 2, lane, ph);
  }

  // Rows R + 1..M: the closed form, 16 bytes a store.
  uint4* gout = reinterpret_cast<uint4*>(out);
  const int nvec = Wa4 >> 4;
  const int nrest = (X1_ABLATE & 2) ? 0 : (M - R) * nvec;
  for (int x = lane; x < nrest; x += 32) {
    const int i = R + 1 + x / nvec;
    const int v16 = x % nvec;
    unsigned w[4] = {0xAAAAAAAAu, 0xAAAAAAAAu, 0xAAAAAAAAu, 0xAAAAAAAAu};
    const int k0 = -i - dmin;
    if (k0 >= 0 && (k0 >> 6) == v16) {
      const int byte = (k0 >> 2) & 15;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (e == byte >> 2) w[e] ^= (3u << (2 * (k0 & 3))) << (8 * (byte & 3));
      }
    }
    gout[(size_t)(i - 1) * nvec + v16] = make_uint4(w[0], w[1], w[2], w[3]);
  }
#if X1_PROF
  if (lane == 0 && prof_b < kProfPairs) {
    for (int k = 0; k < 4; ++k) g_x1_prof[prof_b][6 + k] = ph[k];
  }
#endif
}

__global__ void __launch_bounds__(MAX_WARPS_PER_CTA * 32)
align_scan_warp_kernel(const uint8_t* __restrict__ qb,
                       const uint8_t* __restrict__ tb,
                       const int* __restrict__ m_, const int* __restrict__ n_,
                       const int* __restrict__ bw_,
                       uint8_t* __restrict__ packed,
                       const int* __restrict__ order, int M, int T, int Wa,
                       int dmin, int cpl_max) {
  extern __shared__ __align__(16) uint8_t wsm[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // The plan's pair of this warp (-1: none); it mixes heavy and light
  // pairs in each CTA, so the warps that share a scheduler share work.
  const int b = order[blockIdx.x * (blockDim.x >> 5) + warp];
  if (b < 0) return;
  uint8_t* qs = wsm + (size_t)warp * warp_slot(M);
  uint8_t* ts = qs + r16(M);
  const int m = m_[b];
  const int n = n_[b];
  const int bw = bw_[b];
  int ks, cpl;
  pair_window(m, n, bw, Wa, dmin, ks, cpl);
  // The plan promised every span within cpl_max lanes a thread.
  if (cpl > cpl_max) __trap();
  const uint8_t* q = qb + (size_t)b * M;
  const uint8_t* t = tb + (size_t)b * T;
  uint8_t* out = packed + (size_t)b * M * (Wa >> 2);
#if X1_PROF
  const unsigned long long t_start = x1_now();
#endif
#define X1_CPL(C)                                                         \
  case C:                                                                 \
    scan_pair_warp<C>(q, t, out, m, n, bw, M, T, Wa, dmin, ks, qs, ts,    \
                      lane, b);                                           \
    break;
  switch (cpl) {
    X1_CPL(4) X1_CPL(8) X1_CPL(12) X1_CPL(16)
    X1_CPL(20) X1_CPL(24) X1_CPL(28) X1_CPL(32)
    default:
      __trap();
  }
#undef X1_CPL
#if X1_PROF
  if (lane == 0 && b < kProfPairs) {
    unsigned smid, wid;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(smid));
    asm volatile("mov.u32 %0, %%warpid;" : "=r"(wid));
    g_x1_prof[b][0] = t_start;
    g_x1_prof[b][1] = x1_now();
    g_x1_prof[b][2] = min(m + 1, M);
    g_x1_prof[b][3] = cpl;
    g_x1_prof[b][4] = smid;
    g_x1_prof[b][5] = wid;
  }
#endif
}

// ---- the traceback's route "warp" ----

// Move bytes a warp buffers before they go out (`ops/align_tpu.py::
// TB_RING`), and stages in its ring of pointer windows.
constexpr int TB_RING = 512;
constexpr int TB_STAGES = 2;
constexpr int TB_MAX_WINDOW = 256;
constexpr int TB_MAX_ROWS = 256;
// Ablation build of the warp route (`tools/align_ablate.py`; exact, only
// its time differs): bit 1 cuts the look-ahead to one row, so each event
// takes one step.
#ifndef X1_TB_ABLATE
#define X1_TB_ABLATE 0
#endif
#if X1_PROF
// Per pair (-D X1_PROF=1): start and end (%globaltimer, ns), steps,
// pointer reads from device memory (outside the staged windows), steps
// walked in the windows, clock64() cycles entering stages (issuing the
// next, waiting, marking), cycles writing moves out, SM, cycles walking
// in the windows, stages entered, cycles waiting for stages, events;
// read by `dagcon_x1_tb_prof_read`.
constexpr int kTbProf = 12;
__device__ unsigned long long g_x1_tb_prof[kProfPairs][kTbProf];
#endif

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

// Bytes [g, gt) of `moves` (offsets within one pair's row): from the
// warp's ring at g mod TB_RING, or 3 where ring is null. The partial
// 16-byte blocks at either end byte by byte (a block there may hold a
// neighbour row's bytes), the whole blocks between them as 16-byte
// stores by the warp's lanes.
__device__ __forceinline__ void tb_put(uint8_t* __restrict__ moves,
                                       const uint8_t* ring, long long g,
                                       long long gt, int lane) {
  if (gt <= g) return;
  const long long ha = min(gt, (g + 15) & ~15LL);
  const long long ta = max(ha, gt & ~15LL);
  if (lane < ha - g) {
    moves[g + lane] = ring ? ring[(g + lane) & (TB_RING - 1)] : 3;
  }
  for (long long x = ha + 16LL * lane; x < ta; x += 16 * 32) {
    *reinterpret_cast<uint4*>(moves + x) =
        ring ? *reinterpret_cast<const uint4*>(ring + (x & (TB_RING - 1)))
             : make_uint4(0x03030303u, 0x03030303u, 0x03030303u,
                          0x03030303u);
  }
  if (lane < gt - ta) {
    moves[ta + lane] = ring ? ring[(ta + lane) & (TB_RING - 1)] : 3;
  }
}

// One step by the reference's rules, its pointer from device memory.
__device__ __forceinline__ unsigned tb_step(const uint8_t* flat, int i,
                                            int j, int Wa4, int dmin) {
  if (i == 0) return 2u;
  if (j == 0) return 1u;
  const int lane = j - i - dmin;
  const int c = min(max(lane >> 2, 0), Wa4 - 1);
  return (flat[(size_t)(i - 1) * Wa4 + c] >> (2 * (lane & 3))) & 3u;
}

// A stage slot's rows are the window's bytes and 16 bytes of padding (so
// the 32 rows a look-ahead reads fall on 8 banks, not 2).
constexpr int TB_ROW_PAD = 16;

__host__ __device__ constexpr int tb_row_bytes(int WB) {
  return WB + TB_ROW_PAD;
}

// Shared memory of one warp: two slots of R rows and the ring of moves
// (`ops/align_cuda.py::tb_slot` computes the same).
__host__ __device__ constexpr int tb_slot(int R, int WB) {
  return TB_STAGES * R * tb_row_bytes(WB) + TB_RING;
}

__device__ __forceinline__ unsigned lds32(const uint8_t* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

__global__ void __launch_bounds__(MAX_WARPS_PER_CTA * 32)
align_traceback_warp_kernel(const uint8_t* __restrict__ packed,
                            const int* __restrict__ m_,
                            const int* __restrict__ n_,
                            uint8_t* __restrict__ moves,
                            const int* __restrict__ order, int M, int Wa,
                            int dmin, int L, int R, int WB) {
  extern __shared__ __align__(16) uint8_t tsm[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = order[blockIdx.x * (blockDim.x >> 5) + warp];
  if (b < 0) return;
  const int RS = tb_row_bytes(WB);
  const int slot_bytes = R * RS;
  uint8_t* st = tsm + (size_t)warp * tb_slot(R, WB);
  uint8_t* ring = st + TB_STAGES * slot_bytes;
  const int Wa4 = Wa >> 2;
  int WBe = WB;  // the window's bytes a row: a power of two within the row
  while (WBe > Wa4) WBe >>= 1;
  const int XW = 4 * WBe;  // and lanes
  const int margin = WB;   // lanes left of the walk a window holds
  const uint8_t* flat = packed + (size_t)b * M * Wa4;
  const int m = m_[b];
  const int n = n_[b];
  const long long g0 = (long long)b * L;
  const int rb = (int)(g0 & (TB_RING - 1));
  long long gf = g0;  // moves before gf are out
  int i = m, j = n, s = 0;
  int cur = -1;             // the stage the walk is in
  int hi = 0, lo = 1 << 30;  // and its top and bottom rows
  int cb0 = 0, cb1 = 0;     // the window's first byte, stage slots 0 and 1
  // This lane's 16-byte pieces of a stage: piece k = lane + 32 t is row
  // k / parts, part k % parts (parts a power of two, 1..16).
  const int parts = WBe >> 4;
  const int dr = 32 / parts;
  const int r_l = lane / parts, q_l = lane % parts;
#if X1_PROF
  const unsigned long long t_start = x1_now();
  unsigned long long n_slow = 0, n_fast = 0, cyc_stage = 0, cyc_out = 0;
  unsigned long long cyc_walk = 0, n_stage = 0, cyc_wait = 0, n_event = 0;
#endif

  // Stage c (rows m - cR .. down to max(1, m - cR - R + 1)) into slot
  // c & 1, the window placed for a walk at lane lam: 16-byte cp.async
  // copies, one commit group a stage.
  auto issue = [&](int c, int lam) {
    const int top = m - c * R;
    const int nr = max(0, top - max(1, top - R + 1) + 1);
    const int cbx = min(max(((lam - margin) >> 2) & ~15, 0), Wa4 - WBe);
    if (c & 1) {
      cb1 = cbx;
    } else {
      cb0 = cbx;
    }
    uint8_t* dst = st + (c & 1) * slot_bytes + r_l * RS + 16 * q_l;
    const uint8_t* src = flat + (size_t)(top - 1 - r_l) * Wa4 + cbx + 16 * q_l;
    for (int r = r_l; r < nr; r += dr) {
      cp_async16(dst, src);
      dst += dr * RS;
      src -= (size_t)dr * Wa4;
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  if (m >= 1) {
    issue(0, n - m - dmin);
    issue(1, n - m - dmin);
  }
  bool dead = false;  // a pointer 3: the walk stays put, 3 from here on
  for (;;) {
    // The moves the ring may take before its whole blocks go out (an
    // event writes up to 33), and the row's end.
    const int sl = (int)min((long long)L, gf - g0 + TB_RING - 16);
    if (s >= L) break;
    if (s + 33 > gf - g0 + TB_RING - 16 && ((g0 + s) & ~15LL) > gf) {
#if X1_PROF
      const unsigned long long t0 = clock64();
#endif
      __syncwarp();
      const long long gt = (g0 + s) & ~15LL;
      tb_put(moves, ring, gf, gt, lane);
      gf = gt;
      __syncwarp();
#if X1_PROF
      cyc_out += clock64() - t0;
#endif
      continue;
    }
    if (i == 0 && j == 0) break;
    if (i >= 1) {
      if (i < lo) {
        // Entering stage cur + 1 at its top row: issue the stage after
        // it into the slot the stage before leaves, wait for it, mark
        // its j == 0 lanes.
#if X1_PROF
        const unsigned long long t0 = clock64();
#endif
        ++cur;
        hi = m - cur * R;
        lo = max(1, hi - R + 1);
        __syncwarp();
        if (cur >= 1) issue(cur + 1, j - i - dmin);
#if X1_PROF
        const unsigned long long tw0 = clock64();
#endif
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");
        __syncwarp();
#if X1_PROF
        cyc_wait += clock64() - tw0;
#endif
        if (lo <= -dmin) {
          const int cbx = (cur & 1) ? cb1 : cb0;
          uint8_t* sb = st + (cur & 1) * slot_bytes;
          for (int r = lane; r <= hi - lo; r += 32) {
            const int x0 = -(hi - r) - dmin - 4 * cbx;
            if (x0 >= 0 && x0 < XW) {
              uint8_t* bp = sb + r * RS + (x0 >> 2);
              const int sh = 2 * (x0 & 3);
              *bp = (uint8_t)((*bp & ~(3u << sh)) | (1u << sh));
            }
          }
          __syncwarp();
        }
#if X1_PROF
        cyc_stage += clock64() - t0;
        ++n_stage;
#endif
      }
      const int cbx = (cur & 1) ? cb1 : cb0;
      int x = j - i - dmin - 4 * cbx;
      if ((unsigned)x < (unsigned)XW && s + 33 <= sl) {
        // The walk in the window, an event at a time: lane t reads the
        // pointer of row r + t at lane x, two ballots give the diagonal
        // steps before the first other pointer (or the stage's end) and
        // that pointer, and the lanes write those moves at once. An up
        // or left step ends the event and moves x.
#if X1_PROF
        const int s_in = s;
        const unsigned long long tw = clock64();
#endif
        const uint8_t* sb = st + (cur & 1) * slot_bytes;
        const int nr = hi - lo + 1;
        int r = hi - i;
        int q = rb + s;
        const int qend = rb + sl - 33;
        for (;;) {
          const unsigned wv =
              lds32(sb + min(r + lane, nr - 1) * RS + ((x >> 2) & ~3));
          const unsigned fl = __funnelshift_r(wv, wv, 2 * x);
          // Rows at and past the stage's end stop the run (and past
          // one row in the ablation build).
          const int left_rows = (X1_TB_ABLATE & 1) ? 1 : nr - r;
          const unsigned past = left_rows >= 32 ? 0u : ~0u << left_rows;
          const unsigned blo = __ballot_sync(FULL, fl & 1u);
          const unsigned bhi = __ballot_sync(FULL, fl & 2u);
          const unsigned nz = blo | bhi | past;
          const unsigned low = nz & (0u - nz);  // the first stop
          const int k = __clz(__brev(nz));      // 32 where none
          const bool take = (low & ~past) != 0u;
          const unsigned f = ((blo & low) ? 1u : 0u) | ((bhi & low) ? 2u : 0u);
          if (lane <= k) {
            ring[(q + lane) & (TB_RING - 1)] =
                (uint8_t)(lane < k ? 0u : f);
          }
          q += k + (int)take;
#if X1_PROF
          ++n_event;
#endif
          if (take && f == 3u) {  // a pointer 3 in the window itself
            dead = true;
            break;
          }
          const int up = take && f == 1u;
          r += k + up;
          x += up - (int)(take && f == 2u);
          if (r >= nr || (unsigned)x >= (unsigned)XW || q > qend) break;
        }
        s = q - rb;
        i = hi - r;
        j = x + 4 * cbx + i + dmin;
#if X1_PROF
        n_fast += s - s_in;
        cyc_walk += clock64() - tw;
#endif
        if (dead) break;
        continue;
      }
    }
    // Off the windows (or within 33 moves of the row's end): one step by
    // the exact rule.
    const unsigned p = tb_step(flat, i, j, Wa4, dmin);
#if X1_PROF
    n_slow += (i != 0 && j != 0);
#endif
    if (lane == 0) ring[(rb + s) & (TB_RING - 1)] = (uint8_t)p;
    ++s;
    if (p == 3u) break;
    i -= (p <= 1u);
    j -= (p == 0u || p == 2u);
  }
  // Out: the ring's moves up to the next 16-byte boundary (3s past the
  // walk), then the rest of the row as 3s.
#if X1_PROF
  const unsigned long long t0 = clock64();
#endif
  // The copies still in flight land before the warp leaves.
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  const long long ge = g0 + s;
  const long long ga = min(g0 + L, (ge + 15) & ~15LL);
  if (lane < ga - ge) ring[(rb + s + lane) & (TB_RING - 1)] = 3;
  __syncwarp();
  tb_put(moves, ring, gf, ga, lane);
  tb_put(moves, nullptr, ga, g0 + L, lane);
#if X1_PROF
  cyc_out += clock64() - t0;
  if (lane == 0 && b < kProfPairs) {
    unsigned smid;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(smid));
    g_x1_tb_prof[b][0] = t_start;
    g_x1_tb_prof[b][1] = x1_now();
    g_x1_tb_prof[b][2] = s;
    g_x1_tb_prof[b][3] = n_slow;
    g_x1_tb_prof[b][4] = n_fast;
    g_x1_tb_prof[b][5] = cyc_stage;
    g_x1_tb_prof[b][6] = cyc_out;
    g_x1_tb_prof[b][7] = smid;
    g_x1_tb_prof[b][8] = cyc_walk;
    g_x1_tb_prof[b][9] = n_stage;
    g_x1_tb_prof[b][10] = cyc_wait;
    g_x1_tb_prof[b][11] = n_event;
  }
#endif
}

// The replay: the moves into gapped rows, on the card beside the moves
// the traceback wrote, so that only the rows and path lengths go to the
// host. A warp per pair, REPLAY_WARPS pairs a CTA. The path length plen
// is the first 3 of the row (L where there is none): lane t reads the
// 16-byte chunk t of each 512 bytes (one uint4 where the row sits on a
// 16-byte boundary, else bytes), finds its first 3 by the zero-byte test
// on w ^ 0x03030303 (whose lowest flagged byte is always a true zero),
// and a ballot gives the first lane that has one. Then the warp walks the
// forward positions in chunks of REPLAY_SUB x 32, lane t taking position
// p = p0 + 32 s + t, which reads move plen - 1 - p: a query base unless
// the move is 2, a target base unless it is 1. Each lane's base index is
// the popcount of the lower lanes' ballot plus the bases taken before
// the step; the base (clamped to the row), '-' where none is taken, 0
// past the path. The REPLAY_SUB steps of a chunk issue their move loads,
// then their base loads, together. plen goes out as -1 where the path
// did not take exactly m query and n target bases.
constexpr int REPLAY_WARPS = 4;
constexpr int REPLAY_SUB = 4;

__global__ void __launch_bounds__(REPLAY_WARPS * 32)
align_replay_kernel(const uint8_t* __restrict__ moves,
                    const uint8_t* __restrict__ qb,
                    const uint8_t* __restrict__ tb,
                    const int* __restrict__ m_, const int* __restrict__ n_,
                    uint8_t* __restrict__ gq, uint8_t* __restrict__ gt,
                    int* __restrict__ plen_out, int B, int M, int T, int L,
                    int dmin) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * REPLAY_WARPS + (threadIdx.x >> 5);
  if (b >= B) return;
  const uint8_t* mv = moves + (size_t)b * L;
  const bool wide = ((uintptr_t)mv & 15) == 0;
  int plen = L;
  for (int base = 0; base < L; base += 32 * 16) {
    const int c0 = base + 16 * lane;
    int hit = 16;  // the first 3 of this lane's chunk; 16 for none
    if (wide && c0 + 16 <= L) {
      const uint4 v = *reinterpret_cast<const uint4*>(mv + c0);
      const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int k = 3; k >= 0; --k) {
        const unsigned x = w[k] ^ 0x03030303u;
        const unsigned z = (x - 0x01010101u) & ~x & 0x80808080u;
        if (z) hit = 4 * k + ((__ffs(z) - 1) >> 3);
      }
    } else {
      for (int k = min(15, L - 1 - c0); k >= 0; --k) {
        if (mv[c0 + k] == 3) hit = k;
      }
    }
    const unsigned any = __ballot_sync(FULL, hit < 16);
    if (any) {
      const int src = __ffs(any) - 1;
      plen = base + 16 * src + __shfl_sync(FULL, hit, src);
      break;
    }
  }
  const uint8_t* q = qb + (size_t)b * M;
  const uint8_t* t = tb + (size_t)b * T;
  uint8_t* oq = gq + (size_t)b * L;
  uint8_t* ot = gt + (size_t)b * L;
  const unsigned lower = (1u << lane) - 1u;
  int cq = 0, ct = 0;  // the bases taken before this step
  for (int p0 = 0; p0 < L; p0 += 32 * REPLAY_SUB) {
    if (p0 >= plen) {  // past the path: 0s
#pragma unroll
      for (int s = 0; s < REPLAY_SUB; ++s) {
        const int p = p0 + 32 * s + lane;
        if (p < L) {
          oq[p] = 0;
          ot[p] = 0;
        }
      }
      continue;
    }
    unsigned mvs[REPLAY_SUB];
#pragma unroll
    for (int s = 0; s < REPLAY_SUB; ++s) {
      const int p = p0 + 32 * s + lane;
      mvs[s] = p < plen ? mv[plen - 1 - p] : 3u;
    }
    int qx[REPLAY_SUB], tx[REPLAY_SUB];
    unsigned takes = 0;  // bit 2s: a query base at step s; 2s + 1: a target
#pragma unroll
    for (int s = 0; s < REPLAY_SUB; ++s) {
      const bool in = p0 + 32 * s + lane < plen;
      const bool tq = in && mvs[s] != 2u;
      const bool tt = in && mvs[s] != 1u;
      const unsigned bq = __ballot_sync(FULL, tq);
      const unsigned bt = __ballot_sync(FULL, tt);
      qx[s] = min(cq + __popc(bq & lower), M - 1);
      tx[s] = min(max(ct + __popc(bt & lower) + 1 - dmin, 0), T - 1);
      cq += __popc(bq);
      ct += __popc(bt);
      takes |= (unsigned)tq << (2 * s) | (unsigned)tt << (2 * s + 1);
    }
#pragma unroll
    for (int s = 0; s < REPLAY_SUB; ++s) {
      const int p = p0 + 32 * s + lane;
      const uint8_t gap = p < plen ? '-' : 0;
      const uint8_t a = (takes >> (2 * s)) & 1u ? q[qx[s]] : gap;
      const uint8_t c = (takes >> (2 * s + 1)) & 1u ? t[tx[s]] : gap;
      if (p < L) {
        oq[p] = a;
        ot[p] = c;
      }
    }
  }
  if (lane == 0) {
    plen_out[b] = (cq == m_[b] && ct == n_[b]) ? plen : -1;
  }
}

// Dynamic shared memory of the "cta" route's CTA: two rows of Wa + 1
// int32 and the warp totals (`ops/align_cuda.py::scan_smem` computes the
// same).
int scan_smem(int Wa) {
  return (2 * (Wa + 1) + MAX_WARPS) * (int)sizeof(int);
}

}  // namespace

extern "C" {

// route 0 "cta": smem == scan_smem(Wa). route 1 "warp": warps pairs a
// CTA (1..8), every span within cpl_max lanes a thread (a multiple of 4
// up to 32), smem == warps * warp_slot(M), `order` the pair of each of
// the ceil(B / warps) * warps warp slots (-1 for none). Refuses any
// other plan.
int dagcon_align_scan(const void* qb, const void* tb, const void* m,
                      const void* n, const void* bw, void* packed,
                      const void* order, int B, int M, int T, int Wa,
                      int dmin, int route, int warps, int cpl_max, int smem,
                      void* stream) {
  if (Wa <= 0 || Wa % 128 != 0 || T < M + Wa || B < 0 || M < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (route == 1) {
    if (warps < 1 || warps > MAX_WARPS_PER_CTA || cpl_max < 4 ||
        cpl_max > WARP_MAX_CPL || cpl_max % 4 != 0 ||
        smem != warps * warp_slot(M) || smem > 232448 ||
        order == nullptr) {
      return (int)cudaErrorInvalidValue;
    }
  } else if (route != 0 || smem != scan_smem(Wa) || smem > 232448) {
    return (int)cudaErrorInvalidValue;
  }
  if (B == 0 || M == 0) return 0;
  if (route == 1) {
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          align_scan_warp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          smem);
      if (e != cudaSuccess) return (int)e;
    }
    align_scan_warp_kernel<<<(B + warps - 1) / warps, 32 * warps, smem,
                             (cudaStream_t)stream>>>(
        (const uint8_t*)qb, (const uint8_t*)tb, (const int*)m, (const int*)n,
        (const int*)bw, (uint8_t*)packed, (const int*)order, M, T, Wa, dmin,
        cpl_max);
    return (int)cudaGetLastError();
  }
  const int Wa4 = Wa / 4;
  const int threads = Wa4 < MAX_THREADS ? Wa4 : MAX_THREADS;
  const int per = (Wa4 + threads - 1) / threads;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        align_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  align_scan_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)qb, (const uint8_t*)tb, (const int*)m, (const int*)n,
      (const int*)bw, (uint8_t*)packed, M, T, Wa, dmin, per);
  return (int)cudaGetLastError();
}

// route 0 "thread": warps == 4 (128 threads a CTA), smem 0, no order.
// route 1 "warp": warps pairs a CTA (1..8), rows a stage (1..256),
// window bytes (a power of two, 16..256), smem == warps
// * tb_slot(rows, window), Wa a multiple of 64, packed and moves on
// 16-byte boundaries, `order` the pair of
// each of the ceil(B / warps) * warps warp slots (-1 for none). The plan
// promises 0 <= m <= M and n >= 0. Refuses any other plan.
int dagcon_align_traceback(const void* packed, const void* m, const void* n,
                           void* moves, const void* order, int B, int M,
                           int Wa, int dmin, int L, int route, int warps,
                           int rows, int window, int smem, void* stream) {
  if (Wa <= 0 || Wa % 4 != 0 || B < 0 || M < 0 || L < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (route == 1) {
    if (warps < 1 || warps > MAX_WARPS_PER_CTA || rows < 1 ||
        rows > TB_MAX_ROWS || window < 16 || window > TB_MAX_WINDOW ||
        (window & (window - 1)) != 0 || Wa % 64 != 0 ||
        smem != warps * tb_slot(rows, window) ||
        smem > 232448 || order == nullptr ||
        ((uintptr_t)packed | (uintptr_t)moves) % 16 != 0) {
      return (int)cudaErrorInvalidValue;
    }
  } else if (route != 0 || warps != 4 || smem != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (B == 0 || L == 0) return 0;
  if (route == 1) {
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          align_traceback_warp_kernel,
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return (int)e;
    }
    align_traceback_warp_kernel<<<(B + warps - 1) / warps, 32 * warps, smem,
                                  (cudaStream_t)stream>>>(
        (const uint8_t*)packed, (const int*)m, (const int*)n,
        (uint8_t*)moves, (const int*)order, M, Wa, dmin, L, rows, window);
    return (int)cudaGetLastError();
  }
  const int threads = 32 * warps;
  align_traceback_kernel<<<(B + threads - 1) / threads, threads, 0,
                           (cudaStream_t)stream>>>(
      (const uint8_t*)packed, (const int*)m, (const int*)n, (uint8_t*)moves,
      B, M, Wa, dmin, L);
  return (int)cudaGetLastError();
}

// The replay of B move rows of L bytes into gq, gt ([B, L] each) and
// plen ([B] int32, on a 4-byte boundary); qb [B, M], tb [B, T] with
// M, T >= 1, L >= 1. Refuses anything else.
int dagcon_align_replay(const void* moves, const void* qb, const void* tb,
                        const void* m, const void* n, void* gq, void* gt,
                        void* plen, int B, int M, int T, int L, int dmin,
                        void* stream) {
  if (B < 0 || M < 1 || T < 1 || L < 1 || (uintptr_t)plen % 4 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (B == 0) return 0;
  align_replay_kernel<<<(B + REPLAY_WARPS - 1) / REPLAY_WARPS,
                        32 * REPLAY_WARPS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)moves, (const uint8_t*)qb, (const uint8_t*)tb,
      (const int*)m, (const int*)n, (uint8_t*)gq, (uint8_t*)gt, (int*)plen,
      B, M, T, L, dmin);
  return (int)cudaGetLastError();
}

#if X1_PROF
// The last launch's pair clocks of pairs 0..n-1 into host [n][10]
// (unsigned 64-bit), n <= 4096.
int dagcon_x1_prof_read(void* host, int n) {
  if (n < 0 || n > kProfPairs) return (int)cudaErrorInvalidValue;
  return (int)cudaMemcpyFromSymbol(host, g_x1_prof,
                                   sizeof(unsigned long long) * 10 * n);
}

// The last warp-route traceback's pair records of pairs 0..n-1 into
// host [n][12] (unsigned 64-bit), n <= 4096.
int dagcon_x1_tb_prof_read(void* host, int n) {
  if (n < 0 || n > kProfPairs) return (int)cudaErrorInvalidValue;
  return (int)cudaMemcpyFromSymbol(host, g_x1_tb_prof,
                                   sizeof(unsigned long long) * kTbProf * n);
}
#endif

const char* dagcon_cuda_error_string(int rc) {
  return cudaGetErrorString((cudaError_t)rc);
}

}  // extern "C"
