// Per-row integer histogram (B2) and payload scatter-add (B3) for Hopper
// (sm_90a). Bound to PyTorch through a plain C interface
// (`dagcon_hist`, `dagcon_scatter`) loaded with ctypes by
// `ops/mxu_cuda.py`, which also makes each call's launch plan
// (`hist_plan`, `scatter_plan`; this file checks it and mirrors its
// constants).
//
// Replaces the TPU kernels `pbdagcon_tpu/ops/mxu.py::_pallas_hist` and
// `pbdagcon_tpu/ops/mxu.py::_pallas_scatter`. On the TPU both are one-hot
// matrix products on the MXU, with the payloads split into bytes so that
// every bf16 factor is exact. Here both are int32 sums in shared memory,
// which are exact without any split:
//
//   hist:    out[b, d] = #{n : valid[b, n] and values[b, n] == d}
//   scatter: out[k][b, r[b, n]] += payload[k][b, n] & cut_mask  (valid n)
//
// Values and ranks that are < 0 or >= D, and elements whose valid byte is
// 0, are dropped (`valid` may be null: every element counts). The cut
// mask keeps the low 8*nbytes bits of a payload, as the byte split of the
// TPU form does; the sums are unsigned adds, which wrap like the TPU
// form's int32 reassembly. Unique ranks give a plain transport, repeated
// ranks a sum, so the scatter serves both `mxu_scatter` and
// `mxu_weighted_hist`. A histogram is a scatter of the payload 1 into
// one plane, so one set of kernels serves both.
//
// What bounds them on this card: each reads its inputs once and writes
// its [B, D] outputs once (a few MB per call at the bench caps), so
// device-memory bytes bound them; at the devbuild window's sizes (9 + 8
// calls of 2-25 MB) a call's fixed costs weigh as much.
//
// What the design does about it (every route is one kernel launch):
// - "cluster" route: a row's bins live in the shared memory of a thread
//   block cluster of `cs` CTAs (cs = 1: one CTA, no cluster). CTA r owns
//   bins [r*S, (r+1)*S) of every payload plane and reads values
//   [r*per, (r+1)*per) of the row (ranks, valid bytes, payloads: 16-byte
//   loads where the rows allow), adding each element into the owning
//   CTA's bins (distributed shared memory through
//   `cluster.map_shared_rank` when another CTA owns it). It zeroes its own
//   bins first and writes every bin it owns, zeros included, so the
//   outputs need no fill and take no global atomic. Two cluster.sync()s:
//   after the zeroing (every peer cleared before the first remote add)
//   and after the adds (no CTA exits while a peer may still add into
//   it). Clusters serve rows whose planes outgrow one CTA's 227 KB (up
//   to 16 CTAs, non-portable past 8). Clusters grown past that to fill
//   the SMs at small B measured slower: the remote adds cost more than
//   the idle SMs.
// - "global" route: planes past what a 16-CTA cluster holds (hist
//   D > 929,792 bins; scatter D > 16 * floor(58,112 / NP) bins). The
//   outputs are zeroed by cudaMemsetAsync and the elements added with
//   global atomics. No call of the devbuild path reaches it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

// Mirrored by ops/mxu_cuda.py.
constexpr int kMaxPayloads = 4;
constexpr int kMaxSmemBytes = 232448;  // a CTA's most (227 KB)
constexpr int kMaxCluster = 16;        // past 8: non-portable
constexpr int kPortableCluster = 8;
// The cluster route finds a bin's owner by a float product, exact while
// bins < 2^24; every D it takes is far below (16 * 58,112).
constexpr int kMaxClusterBins = 1 << 20;
constexpr int kRouteCluster = 0;
constexpr int kRouteGlobal = 1;
constexpr int kGlobalMaxBlocks = 1 << 20;

struct Args {
  const int32_t* idx;    // values or ranks [B, N]
  const uint8_t* valid;  // [B, N] bytes, or null
  const int32_t* p[kMaxPayloads];
  int32_t* out[kMaxPayloads];
  int B, N, D;
  uint32_t cut;
  int bins;        // bins per plane a CTA of the cluster route owns
  int per;         // values a CTA of the cluster route reads, % 4 == 0
  float inv_bins;  // 1 / bins
  bool vec;       // 16-byte loads of idx/payloads, 4-byte of valid
  bool ovec;       // 16-byte stores of the outputs
};

template <int NP>
struct Quad {
  int4 r;
  uint32_t m;
  int4 p[NP];
};

template <bool kHist, int NP>
__device__ __forceinline__ Quad<NP> load_quad(const Args& a, size_t i) {
  Quad<NP> q;
  q.r = __ldg(reinterpret_cast<const int4*>(a.idx + i));
  q.m = a.valid ? __ldg(reinterpret_cast<const unsigned int*>(a.valid + i))
                : 0x01010101u;
  if constexpr (!kHist) {
#pragma unroll
    for (int k = 0; k < NP; ++k)
      q.p[k] = __ldg(reinterpret_cast<const int4*>(a.p[k] + i));
  }
  return q;
}

// Add one element into the bins of its owner: this CTA's (`sm`), or on
// the cluster route the peer's that owns bin r.
template <bool kHist, int NP, bool kCluster>
__device__ __forceinline__ void add_one(uint32_t* sm, int rank, const Args& a,
                                        int32_t r, bool ok,
                                        const uint32_t (&pv)[NP]) {
  if (!ok || static_cast<uint32_t>(r) >= static_cast<uint32_t>(a.D)) return;
  int local = r;
  uint32_t* dst = sm;
  if constexpr (kCluster) {
    int owner = __float2int_rz(__int2float_rz(r) * a.inv_bins);
    int lo = owner * a.bins;
    if (lo > r) {
      --owner;
      lo -= a.bins;
    } else if (r - lo >= a.bins) {
      ++owner;
      lo += a.bins;
    }
    local = r - lo;
    if (owner != rank) dst = cg::this_cluster().map_shared_rank(sm, owner);
  }
  if constexpr (kHist) {
    atomicAdd(dst + local, 1u);
  } else {
#pragma unroll
    for (int k = 0; k < NP; ++k) atomicAdd(dst + k * a.bins + local, pv[k] & a.cut);
  }
}

template <bool kHist, int NP, bool kCluster>
__device__ __forceinline__ void add_quad(uint32_t* sm, int rank, const Args& a,
                                         const Quad<NP>& q) {
  const int32_t r[4] = {q.r.x, q.r.y, q.r.z, q.r.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t pv[NP];
    if constexpr (!kHist) {
#pragma unroll
      for (int k = 0; k < NP; ++k) {
        const int4 p = q.p[k];
        pv[k] = static_cast<uint32_t>(j == 0 ? p.x : j == 1 ? p.y : j == 2 ? p.z : p.w);
      }
    }
    add_one<kHist, NP, kCluster>(sm, rank, a, r[j], (q.m >> (8 * j)) & 0xFFu, pv);
  }
}

template <bool kHist, int NP>
__device__ __forceinline__ void load_one(const Args& a, size_t i, int32_t& r,
                                         bool& ok, uint32_t (&pv)[NP]) {
  r = a.idx[i];
  ok = a.valid == nullptr || a.valid[i] != 0;
  if constexpr (!kHist) {
#pragma unroll
    for (int k = 0; k < NP; ++k) pv[k] = static_cast<uint32_t>(a.p[k][i]);
  }
}

// Write `width` bins of `NP` planes (plane stride `stride` in `src`) to
// row `orow_off` of each output.
template <int NP>
__device__ __forceinline__ void write_bins(const Args& a, const uint32_t* src,
                                           int stride, size_t orow_off,
                                           int width, int tid, int nthreads) {
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    int32_t* o = a.out[k] + orow_off;
    const uint32_t* s = src + k * stride;
    if (a.ovec) {
      for (int i = tid; i < width / 4; i += nthreads)
        reinterpret_cast<int4*>(o)[i] = reinterpret_cast<const int4*>(s)[i];
    } else {
      for (int i = tid; i < width; i += nthreads) o[i] = static_cast<int32_t>(s[i]);
    }
  }
}

// Cluster route. Grid (cs, B), cluster (cs, 1, 1) when kCluster.
// Shared memory: NP planes of `bins` bins.
template <bool kHist, int NP, bool kCluster>
__global__ void __launch_bounds__(1024) bins_cta_kernel(const Args a) {
  extern __shared__ __align__(16) uint32_t sm[];
  const int b = blockIdx.y;
  int rank = 0;
  if constexpr (kCluster) rank = static_cast<int>(cg::this_cluster().block_rank());
  uint4* sm4 = reinterpret_cast<uint4*>(sm);
  for (int i = threadIdx.x; i < NP * a.bins / 4; i += blockDim.x)
    sm4[i] = make_uint4(0u, 0u, 0u, 0u);
  if constexpr (kCluster) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
  const int n_lo = min(a.N, rank * a.per);
  const int n_hi = min(a.N, n_lo + a.per);
  const size_t base = static_cast<size_t>(b) * a.N;
  if (a.vec) {
    // Two quads of every thread in flight before their adds.
    const int step = 4 * blockDim.x;
    for (int n = n_lo + 4 * threadIdx.x; n < n_hi; n += 2 * step) {
      const Quad<NP> q0 = load_quad<kHist, NP>(a, base + n);
      const bool has1 = n + step < n_hi;
      Quad<NP> q1;
      if (has1) q1 = load_quad<kHist, NP>(a, base + n + step);
      add_quad<kHist, NP, kCluster>(sm, rank, a, q0);
      if (has1) add_quad<kHist, NP, kCluster>(sm, rank, a, q1);
    }
  } else {
    for (int n = n_lo + threadIdx.x; n < n_hi; n += blockDim.x) {
      int32_t r;
      bool ok;
      uint32_t pv[NP];
      load_one<kHist, NP>(a, base + n, r, ok, pv);
      add_one<kHist, NP, kCluster>(sm, rank, a, r, ok, pv);
    }
  }
  if constexpr (kCluster) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
  const int lo = rank * a.bins;
  const int width = min(a.bins, a.D - lo);
  write_bins<NP>(a, sm, a.bins, static_cast<size_t>(b) * a.D + lo, width,
                 threadIdx.x, blockDim.x);
}

// Global route: outputs zeroed before the launch; grid-stride over all
// B * N elements with global atomics.
template <bool kHist, int NP>
__global__ void bins_global_kernel(const Args a) {
  const size_t total = static_cast<size_t>(a.B) * a.N;
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    int32_t r;
    bool ok;
    uint32_t pv[NP];
    load_one<kHist, NP>(a, i, r, ok, pv);
    if (!ok || static_cast<uint32_t>(r) >= static_cast<uint32_t>(a.D)) continue;
    const size_t o = (i / a.N) * a.D + r;
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      atomicAdd(reinterpret_cast<unsigned int*>(a.out[k] + o),
                kHist ? 1u : (pv[k] & a.cut));
    }
  }
}

// The plan of ops/mxu_cuda.py::bin_plan, checked: 0 if this file takes
// it.
int check_plan(int B, int D, int NP, int route, int cs, int bins, int threads,
               int smem) {
  if (threads < 32 || threads > 1024 || threads % 32 != 0 || smem < 0 ||
      smem > kMaxSmemBytes)
    return 1;
  const long long planes = static_cast<long long>(NP) * bins * 4;
  switch (route) {
    case kRouteCluster:
      return !(cs >= 1 && cs <= kMaxCluster && bins > 0 && bins % 4 == 0 &&
               static_cast<long long>(cs) * bins >= D &&
               static_cast<long long>(cs - 1) * bins < D &&
               (cs == 1 || D <= kMaxClusterBins) && smem == planes &&
               B <= 65535);
    case kRouteGlobal:
      return !(cs == 1 && bins == 0 && smem == 0);
    default:
      return 1;
  }
}

template <typename K>
cudaError_t set_smem(K kernel, int smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

template <bool kHist, int NP>
cudaError_t launch(const Args& a, int route, int cs, int threads, int smem,
                   cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaError_t e = cudaSuccess;
  if (route == kRouteGlobal) {
    for (int k = 0; k < NP; ++k) {
      e = cudaMemsetAsync(a.out[k], 0,
                          static_cast<size_t>(a.B) * a.D * sizeof(int32_t), s);
      if (e != cudaSuccess) return e;
    }
    const long long total = static_cast<long long>(a.B) * a.N;
    if (total == 0) return cudaGetLastError();
    const long long blocks = (total + threads - 1) / threads;
    cfg.gridDim = dim3(static_cast<unsigned>(blocks < kGlobalMaxBlocks ? blocks
                                                                      : kGlobalMaxBlocks));
    e = cudaLaunchKernelEx(&cfg, bins_global_kernel<kHist, NP>, a);
  } else if (cs == 1) {
    auto kernel = bins_cta_kernel<kHist, NP, false>;
    e = set_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    cfg.gridDim = dim3(1, a.B);
    e = cudaLaunchKernelEx(&cfg, kernel, a);
  } else {
    auto kernel = bins_cta_kernel<kHist, NP, true>;
    e = set_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    if (cs > kPortableCluster) {
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (e != cudaSuccess) return e;
    }
    cfg.gridDim = dim3(cs, a.B);
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cs;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int clusters = 0;
    e = cudaOccupancyMaxActiveClusters(&clusters, reinterpret_cast<const void*>(kernel),
                                       &cfg);
    if (e != cudaSuccess) return e;
    if (clusters == 0) return cudaErrorInvalidConfiguration;
    e = cudaLaunchKernelEx(&cfg, kernel, a);
  }
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// Fill `a` for a call; returns 0, or an error if the shapes or the plan
// are refused.
int make_args(Args& a, const void* idx, const void* valid,
              const void* const* payloads, void* const* outs, int NP, int B,
              int N, int D, unsigned int cut, int route, int cs, int bins,
              int threads, int smem) {
  if (B < 0 || N < 0 || D < 0 || NP < 1 || NP > kMaxPayloads)
    return static_cast<int>(cudaErrorInvalidValue);
  if (check_plan(B, D, NP, route, cs, bins, threads, smem) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  a = Args{};
  a.idx = static_cast<const int32_t*>(idx);
  a.valid = static_cast<const uint8_t*>(valid);
  bool vec = N % 4 == 0 && aligned(idx, 16) && (!valid || aligned(valid, 4));
  bool ovec = D % 4 == 0;
  for (int k = 0; k < NP; ++k) {
    a.p[k] = payloads ? static_cast<const int32_t*>(payloads[k]) : nullptr;
    a.out[k] = static_cast<int32_t*>(outs[k]);
    if (payloads) vec = vec && aligned(payloads[k], 16);
    ovec = ovec && aligned(outs[k], 16);
  }
  a.B = B;
  a.N = N;
  a.D = D;
  a.cut = cut;
  a.bins = bins;
  a.per = route == kRouteCluster ? ((N + cs - 1) / cs + 3) / 4 * 4 : N;
  a.inv_bins = bins > 0 ? 1.0f / static_cast<float>(bins) : 0.0f;
  a.vec = vec;
  a.ovec = ovec;
  return 0;
}

}  // namespace

extern "C" {

// out [B, D] int32, every element written (the caller allocates it
// uninitialised); values [B, N] int32, valid [B, N] bytes or null; all
// contiguous. The plan (`hist_plan` in ops/mxu_cuda.py): route 0
// cluster, 1 global; cs CTAs per row; bins per CTA; threads per CTA;
// dynamic shared bytes. Launches on `stream` and returns a CUDA error code
// (0 on success).
int dagcon_hist(const void* values, const void* valid, void* out, int B, int N,
                int D, int route, int cs, int bins, int threads, int smem,
                void* stream) {
  Args a;
  void* outs[1] = {out};
  const int rc = make_args(a, values, valid, nullptr, outs, 1, B, N, D, 0u,
                           route, cs, bins, threads, smem);
  if (rc != 0) return rc;
  if (B == 0 || D == 0) return 0;
  return static_cast<int>(launch<true, 1>(a, route, cs, threads, smem,
                                          static_cast<cudaStream_t>(stream)));
}

// outs[k] [B, D] int32, every element written; ranks [B, N] int32, valid
// [B, N] bytes or null, payloads[k] [B, N] int32, 1 <= NP <= 4; all
// contiguous. `cut_mask` keeps the payload bits that are summed. The plan
// as for dagcon_hist (`scatter_plan`).
int dagcon_scatter(const void* ranks, const void* valid,
                   const void* const* payloads, void* const* outs, int NP,
                   int B, int N, int D, unsigned int cut_mask, int route,
                   int cs, int bins, int threads, int smem, void* stream) {
  Args a;
  const int rc = make_args(a, ranks, valid, payloads, outs, NP, B, N, D,
                           cut_mask, route, cs, bins, threads, smem);
  if (rc != 0) return rc;
  if (B == 0 || D == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (NP) {
    case 1:
      return static_cast<int>(launch<false, 1>(a, route, cs, threads, smem, s));
    case 2:
      return static_cast<int>(launch<false, 2>(a, route, cs, threads, smem, s));
    case 3:
      return static_cast<int>(launch<false, 3>(a, route, cs, threads, smem, s));
    default:
      return static_cast<int>(launch<false, 4>(a, route, cs, threads, smem, s));
  }
}

const char* dagcon_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
