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
// The scan, one CTA per pair. Lane k of row i holds column
// j = i + dmin + k, so the diagonal predecessor is the same lane of the
// previous row and the up predecessor lane k + 1. The previous row and
// the current one live in shared memory (two buffers of Wa + 1 int32,
// the last entry a NEG sentinel for the up read of lane Wa - 1). Each
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
// The traceback, one thread per pair, walks the pointers from device
// memory from (m, n) for L steps and writes one move a step (0 diag,
// 1 up, 2 left, 3 done); after (0, 0) the rest of the row is 3.
//
// What bounds it on this card: the scan's M sequential rows. Per pair it
// reads M + (M + Wa) bytes and writes M * Wa / 4, a few hundred KB, and
// does ~20 integer operations per cell; the whole batch's bytes over the
// memory rate are tens of microseconds, its operations over the int32
// rate a few more, while the rows run one after another inside a CTA,
// each behind two barriers. The design keeps the row recurrence in
// shared memory and the batch across CTAs (one pair each, several CTAs
// per SM); making the rows cheaper (a warp per pair, registers for the
// row, fewer barriers) is later work. The traceback is a chain of
// dependent loads per pair (latency, not bandwidth).

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

// Dynamic shared memory of the scan's CTA: two rows of Wa + 1 int32 and
// the warp totals (`ops/align_cuda.py::scan_smem` computes the same).
int scan_smem(int Wa) {
  return (2 * (Wa + 1) + MAX_WARPS) * (int)sizeof(int);
}

}  // namespace

extern "C" {

int dagcon_align_scan(const void* qb, const void* tb, const void* m,
                      const void* n, const void* bw, void* packed, int B,
                      int M, int T, int Wa, int dmin, void* stream) {
  if (B <= 0 || M <= 0) return 0;
  if (Wa <= 0 || Wa % 128 != 0 || T < M + Wa) {
    return (int)cudaErrorInvalidValue;
  }
  const int Wa4 = Wa / 4;
  const int threads = Wa4 < MAX_THREADS ? Wa4 : MAX_THREADS;
  const int per = (Wa4 + threads - 1) / threads;
  const int smem = scan_smem(Wa);
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

int dagcon_align_traceback(const void* packed, const void* m, const void* n,
                           void* moves, int B, int M, int Wa, int dmin,
                           int L, void* stream) {
  if (B <= 0 || L <= 0) return 0;
  if (Wa <= 0 || Wa % 4 != 0) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  align_traceback_kernel<<<(B + threads - 1) / threads, threads, 0,
                           (cudaStream_t)stream>>>(
      (const uint8_t*)packed, (const int*)m, (const int*)n, (uint8_t*)moves,
      B, M, Wa, dmin, L);
  return (int)cudaGetLastError();
}

const char* dagcon_cuda_error_string(int rc) {
  return cudaGetErrorString((cudaError_t)rc);
}

}  // extern "C"
