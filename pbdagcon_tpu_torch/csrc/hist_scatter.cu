// Per-row integer histogram (B2) and payload scatter-add (B3) for Hopper
// (sm_90a). Bound to PyTorch through a plain C interface
// (`dagcon_hist`, `dagcon_scatter`) loaded with ctypes by
// `ops/mxu_cuda.py`.
//
// Replaces the TPU kernels `pbdagcon_tpu/ops/mxu.py::_pallas_hist` and
// `pbdagcon_tpu/ops/mxu.py::_pallas_scatter`. On the TPU both are one-hot
// matrix products on the MXU, with the payloads split into bytes so that
// every bf16 factor is exact. Here both are int32 atomics, which are
// exact without any split:
//
//   hist:    out[b, d] = #{n : values[b, n] == d},  d in [0, D)
//   scatter: out[k][b, r[b, n]] += payload[k][b, n] & cut_mask
//
// Values and ranks that are < 0 or >= D are dropped (the wrapper folds
// the `valid` mask in as -1). The cut mask keeps the low 8*nbytes bits of
// a payload, as the byte split of the TPU form does; the int32 sum wraps
// like the TPU form's `astype(int32) << 8*byte` reassembly. Unique ranks
// give a plain transport, repeated ranks a sum, so one scatter kernel
// serves both `mxu_scatter` and `mxu_weighted_hist`.
//
// What bounds them on this card: both read their inputs once (41k int32
// values per row at the bench caps, a few MB per call) and do one atomic
// per element, so they are bound by atomic throughput and launch
// latency, not by bandwidth or arithmetic.
//
// What the design does about it:
// - hist: a few blocks per row, each counting its slice of the row into
//   a shared-memory histogram of D int32 bins (dynamic shared memory, up
//   to kMaxSmemBins), so the atomics stay on the SM; the block then adds
//   its non-zero bins to the row in device memory. Domains past the
//   shared-memory limit (the L = 16384 rung) count straight into device
//   memory with global atomics.
// - scatter: one thread per (row, element) and payload; a global int32
//   atomicAdd into the zeroed output. Ranks are unique in most calls, so
//   the atomics rarely contend.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
// Shared-memory histogram up to 48K bins (192 KB of the 227 KB a block
// may use).
constexpr int kMaxSmemBins = 48 * 1024;
constexpr int kMaxPayloads = 4;

__global__ void hist_smem_kernel(const int32_t* __restrict__ values,
                                 int32_t* __restrict__ out, int N, int D,
                                 int per_block) {
  extern __shared__ int32_t bins[];
  const int b = blockIdx.y;
  const int lo = blockIdx.x * per_block;
  const int hi = min(N, lo + per_block);
  for (int d = threadIdx.x; d < D; d += blockDim.x) bins[d] = 0;
  __syncthreads();
  const int32_t* row = values + static_cast<size_t>(b) * N;
  for (int n = lo + threadIdx.x; n < hi; n += blockDim.x) {
    const int32_t v = row[n];
    if (v >= 0 && v < D) atomicAdd(&bins[v], 1);
  }
  __syncthreads();
  int32_t* orow = out + static_cast<size_t>(b) * D;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    const int32_t c = bins[d];
    if (c != 0) atomicAdd(&orow[d], c);
  }
}

__global__ void hist_global_kernel(const int32_t* __restrict__ values,
                                   int32_t* __restrict__ out, int N, int D) {
  const int b = blockIdx.y;
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int32_t v = values[static_cast<size_t>(b) * N + n];
  if (v >= 0 && v < D) atomicAdd(&out[static_cast<size_t>(b) * D + v], 1);
}

struct Payloads {
  const int32_t* p[kMaxPayloads];
  int32_t* out[kMaxPayloads];
};

__global__ void scatter_kernel(const int32_t* __restrict__ ranks,
                               Payloads pl, int NP, int N, int D,
                               uint32_t cut_mask) {
  const int b = blockIdx.y;
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const size_t i = static_cast<size_t>(b) * N + n;
  const int32_t r = ranks[i];
  if (r < 0 || r >= D) return;
  const size_t o = static_cast<size_t>(b) * D + r;
#pragma unroll
  for (int k = 0; k < kMaxPayloads; ++k) {
    if (k < NP) {
      const uint32_t v = static_cast<uint32_t>(pl.p[k][i]) & cut_mask;
      atomicAdd(reinterpret_cast<unsigned int*>(pl.out[k] + o), v);
    }
  }
}

}  // namespace

extern "C" {

// out [B, D] int32, zeroed by the caller; values [B, N] int32, -1 (or
// any value outside [0, D)) dropped. Both contiguous. Launches on
// `stream` and returns cudaGetLastError().
int dagcon_hist(const void* values, void* out, int B, int N, int D,
                void* stream) {
  if (B < 0 || N < 0 || D < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || N == 0 || D == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* v = static_cast<const int32_t*>(values);
  int32_t* o = static_cast<int32_t*>(out);
  if (B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (D <= kMaxSmemBins) {
    const size_t smem = static_cast<size_t>(D) * sizeof(int32_t);
    cudaError_t e = cudaFuncSetAttribute(
        hist_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    // Enough blocks per row to fill the card at small B, each with at
    // least 4096 values so the shared-memory clear and flush amortize.
    int splits = (N + 4095) / 4096;
    const int fill = (264 + B - 1) / B;
    if (splits > fill) splits = fill;
    if (splits < 1) splits = 1;
    const int per_block = (N + splits - 1) / splits;
    dim3 grid(splits, B);
    hist_smem_kernel<<<grid, kThreads, smem, s>>>(v, o, N, D, per_block);
  } else {
    dim3 grid((N + kThreads - 1) / kThreads, B);
    hist_global_kernel<<<grid, kThreads, 0, s>>>(v, o, N, D);
  }
  return static_cast<int>(cudaGetLastError());
}

// outs[k] [B, D] int32, zeroed by the caller; ranks [B, N] int32 (values
// outside [0, D) dropped); payloads[k] [B, N] int32; 1 <= NP <= 4. All
// contiguous. `cut_mask` keeps the payload bits that are summed. Launches
// on `stream` and returns cudaGetLastError().
int dagcon_scatter(const void* ranks, const void* const* payloads,
                   void* const* outs, int NP, int B, int N, int D,
                   unsigned int cut_mask, void* stream) {
  if (B < 0 || N < 0 || D < 0 || NP < 1 || NP > kMaxPayloads || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || N == 0 || D == 0) return 0;
  Payloads pl{};
  for (int k = 0; k < NP; ++k) {
    pl.p[k] = static_cast<const int32_t*>(payloads[k]);
    pl.out[k] = static_cast<int32_t*>(outs[k]);
  }
  dim3 grid((N + kThreads - 1) / kThreads, B);
  scatter_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ranks), pl, NP, N, D, cut_mask);
  return static_cast<int>(cudaGetLastError());
}

const char* dagcon_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
