// Three other designs of the per-row histogram and payload scatter for
// Hopper (sm_90a): the kernels of the kernel-variant microbench
// (`python -m pbdagcon_tpu_torch.tools.prof_pk`). Bound to PyTorch through
// a plain C interface (`dagcon_hist_mma`, `dagcon_hist_row`,
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
// - hist_mma_kernel replaces `tools/prof_pk.py::hist_v1` (P1): the
//   factorized one-hot product itself, on the tensor cores. With
//   hi = v >> 7 and lo = v & 127, out[hi * 128 + lo] = sum_n (hi_n == hi)
//   * (lo_n == lo): int8 one-hot fragments into
//   mma.sync.m16n8k32.s8.s8.s32 with int32 accumulators (exact: no byte
//   split, no float). Each value is split once, as it is loaded, outside
//   the product loop (P1's relayout before the kernel). A block owns one
//   row and 16 hi values (2048 bins); its warps share out the row's
//   values and add their accumulators in shared memory at the end.
//   Bound: the tensor cores and the ALU work that builds the one-hot
//   fragments. It does N * 2048 multiply-adds per block, nearly all of
//   zeros, where an atomic histogram does N adds per row.
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
constexpr int kTileHi = 16;  // hi values per hist_mma block (the mma's M)
constexpr int kMmaWarps = 8;
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

// D[16x8] += A[16x32] (row-major) * B[32x8] (column-major), s8 -> s32.
__device__ __forceinline__ void mma_s8(int32_t (&c)[4], uint32_t a0,
                                       uint32_t a1, uint32_t a2, uint32_t a3,
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Split values n..n+3 of a row, one byte each: `hp` holds hi - hbase where
// the value is in [0, D) and its hi in this block's 16, else 0xFF (which
// matches no fragment row); `lj` holds lo >> 3 (the mma's n tile) and
// `le` 1 where lo & 7 == g (the thread's column of that tile).
__device__ __forceinline__ void split4(const int32_t* __restrict__ row,
                                       int n, int N, int D, int hbase, int g,
                                       uint32_t& hp, uint32_t& lj,
                                       uint32_t& le) {
  hp = lj = le = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int32_t v = n + i < N ? __ldg(row + n + i) : -1;
    const int dh = (v >> 7) - hbase;
    const bool in = v >= 0 && v < D && dh >= 0 && dh < kTileHi;
    hp |= static_cast<uint32_t>(in ? dh : 0xFF) << (8 * i);
    lj |= static_cast<uint32_t>((v >> 3) & 15) << (8 * i);
    le |= static_cast<uint32_t>((v & 7) == g) << (8 * i);
  }
}

// Grid (ceil(D / 2048), B). Fragment layouts of m16n8k32 (s8), with
// g = lane / 4 and t = lane % 4: A register r holds row g (r even) or
// g + 8 (r odd) at columns 4t..4t+3 (r < 2) or 16+4t..16+4t+3; B register
// r holds rows 4t..4t+3 (r = 0) or 16+4t..16+4t+3 of column g; C register
// i holds row g (i < 2) or g + 8, column 2t + (i & 1). Rows are hi,
// columns of A and rows of B are the 32 values of a step, columns of B
// and C are lo within an 8-wide tile.
__global__ void __launch_bounds__(kMmaWarps * 32)
    hist_mma_kernel(const int32_t* __restrict__ values,
                    int32_t* __restrict__ out, int N, int D) {
  __shared__ int32_t tile[kTileHi * kLanes];
  const int b = blockIdx.y;
  const int hbase = blockIdx.x * kTileHi;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  for (int i = threadIdx.x; i < kTileHi * kLanes; i += blockDim.x) tile[i] = 0;
  const int32_t* row = values + static_cast<size_t>(b) * N;
  int32_t acc[kLanes / 8][4];
#pragma unroll
  for (int j = 0; j < kLanes / 8; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;
  }
  const uint32_t row_g = static_cast<uint32_t>(g) * 0x01010101u;
  const uint32_t row_g8 = static_cast<uint32_t>(g + 8) * 0x01010101u;
  const int steps = (N + 31) / 32;
  for (int s = warp; s < steps; s += kMmaWarps) {
    const int n = s * 32 + 4 * t;
    uint32_t hp0, lj0, le0, hp1, lj1, le1;
    split4(row, n, N, D, hbase, g, hp0, lj0, le0);
    split4(row, n + 16, N, D, hbase, g, hp1, lj1, le1);
    const uint32_t a0 = __vcmpeq4(hp0, row_g) & 0x01010101u;
    const uint32_t a1 = __vcmpeq4(hp0, row_g8) & 0x01010101u;
    const uint32_t a2 = __vcmpeq4(hp1, row_g) & 0x01010101u;
    const uint32_t a3 = __vcmpeq4(hp1, row_g8) & 0x01010101u;
#pragma unroll
    for (int j = 0; j < kLanes / 8; ++j) {
      const uint32_t jj = static_cast<uint32_t>(j) * 0x01010101u;
      mma_s8(acc[j], a0, a1, a2, a3, __vcmpeq4(lj0, jj) & le0,
             __vcmpeq4(lj1, jj) & le1);
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kLanes / 8; ++j) {
    const int col = 8 * j + 2 * t;
    atomicAdd(&tile[g * kLanes + col], acc[j][0]);
    atomicAdd(&tile[g * kLanes + col + 1], acc[j][1]);
    atomicAdd(&tile[(g + 8) * kLanes + col], acc[j][2]);
    atomicAdd(&tile[(g + 8) * kLanes + col + 1], acc[j][3]);
  }
  __syncthreads();
  const int lo = hbase * kLanes;
  const int width = min(kTileHi * kLanes, D - lo);
  int32_t* orow = out + static_cast<size_t>(b) * D + lo;
  for (int d = threadIdx.x; d < width; d += blockDim.x) orow[d] = tile[d];
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
// `stream` and returns cudaGetLastError().
int dagcon_hist_mma(const void* values, void* out, int B, int N, int D,
                    void* stream) {
  if (B < 0 || N < 0 || D < 0 || B > 65535 || N > kMaxExtent ||
      D > kMaxExtent)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || D == 0) return 0;
  const int tiles = (D + kTileHi * kLanes - 1) / (kTileHi * kLanes);
  dim3 grid(tiles, B);
  hist_mma_kernel<<<grid, kMmaWarps * 32, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(values), static_cast<int32_t*>(out), N, D);
  return static_cast<int>(cudaGetLastError());
}

// As dagcon_hist_mma; D <= kMaxRowBins (the shared-memory histogram).
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
