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
// Each block's raw inputs (its L band rows, one contiguous run of int16,
// the cov and unsup of the nodes its slots reach, its exit half-units)
// are first copied into shared memory with coalesced loads, all issued
// before any is used; the steps then read shared memory only.
//
// 1. blocked_compose_kernel, one CTA per (target, block of L rows): the
//    block's L rows of a (L x (W+1) int32) are formed in shared memory,
//    then M = A_{gL} (x) ... (x) A_{gL+L-1} is built in L steps, one
//    thread per column j: row0[j] = max_i(a[i] + M[i][j]), clamped. M's
//    W band rows live in a ring of W + 1 row slots in shared memory: the
//    new row 0 goes into the one slot that no thread reads in this step
//    (the row dropped a step earlier), so one barrier a step suffices
//    and no row is copied (a step reads the rows in two runs of
//    contiguous slots, around the ring's end); the exit row W stays put.
//    M_g is written to device memory in logical row order.
// 2. blocked_propagate_kernel, one CTA per target: walks g = G-1 .. 0
//    with the boundary x in shared memory, writes x_in[b, g] (block g's
//    incoming boundary), then x = max_j(M_g[i][j] + x[j]), clamped. M
//    of the next block is copied into shared memory by cp.async while
//    the current one is applied (two buffers).
// 3. blocked_fill_kernel, a warp per (target, block), 4 warps a CTA:
//    the W-window of scores lives in a per-warp ring in shared memory;
//    each step a lane forms the edge scores of its d's (d = lane + 32k)
//    from the staged block, the warp takes the max by shuffles, and lane
//    0 puts the new score in the slot of the dropped one. The block's L
//    scores are written out at the end.
//
// What bounds it on this card. The compose does 2 (W+1)^2 int32
// operations per node and writes (W+1)^2 int32 per block of L nodes: at
// W = 16 (the bench batch, B = 512, V = 5632) ~1.7 G operations and 52 MB
// of M, ~0.1 ms at the int32 rate and half that at the memory rate. The
// propagate is G dependent matrix-vector steps per target (latency: at
// one oversize target, G ~ 250 steps). The fill is L dependent steps of
// a warp reduction per block. The design is the simple one: the
// compose's CTA has only W + 1 busy threads of its 32 at W = 16, and
// each term costs two shared-memory loads beside its DPX instruction, so
// it runs at a fraction of the int32 rate; packing several blocks per
// CTA and keeping the a rows in registers is later work.

#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int SENT = -(1 << 30);
constexpr int PENALTY2 = -20;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_W = 128;
constexpr int MAX_L = 128;
constexpr int FILL_WARPS = 4;

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

int dagcon_blocked_compose(const void* win, const void* cov, const void* uns,
                           const void* eex, void* M, int B, int V, int W,
                           int L, void* stream) {
  if (bad_shape(B, V, W, L)) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const int smem = dagcon_blocked_compose_smem(W, L);
  if (smem > SMEM_CAP) return (int)cudaErrorInvalidValue;
  int e = set_smem((const void*)blocked_compose_kernel, smem);
  if (e) return e;
  blocked_compose_kernel<<<B * (V / L), round_threads(W + 1), smem,
                           (cudaStream_t)stream>>>(
      (const int16_t*)win, (const int16_t*)cov, (const uint8_t*)uns,
      (const int*)eex, (int*)M, V, W, L);
  return (int)cudaGetLastError();
}

int dagcon_blocked_propagate(const void* M, void* x_in, int B, int G, int W,
                             void* stream) {
  if (B < 0 || G <= 0 || W < 1 || W > MAX_W) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const int smem = dagcon_blocked_propagate_smem(W);
  int e = set_smem((const void*)blocked_propagate_kernel, smem);
  if (e) return e;
  blocked_propagate_kernel<<<B, round_threads(W + 1), smem,
                             (cudaStream_t)stream>>>(
      (const int*)M, (int*)x_in, G, W);
  return (int)cudaGetLastError();
}

int dagcon_blocked_fill(const void* win, const void* cov, const void* uns,
                        const void* eex, const void* x_in, void* s2, int B,
                        int V, int W, int L, void* stream) {
  if (bad_shape(B, V, W, L)) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const int smem = dagcon_blocked_fill_smem(W, L);
  if (smem > SMEM_CAP) return (int)cudaErrorInvalidValue;
  int e = set_smem((const void*)blocked_fill_kernel, smem);
  if (e) return e;
  const long long pairs = (long long)B * (V / L);
  const int blocks = (int)((pairs + FILL_WARPS - 1) / FILL_WARPS);
  blocked_fill_kernel<<<blocks, FILL_WARPS * 32, smem, (cudaStream_t)stream>>>(
      (const int16_t*)win, (const int16_t*)cov, (const uint8_t*)uns,
      (const int*)eex, (const int*)x_in, (int*)s2, B, V, W, L,
      fill_warp_bytes(W, L));
  return (int)cudaGetLastError();
}

const char* dagcon_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
