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
// What bounds it on this card: the work is one pass over the int16 band
// (about 370 MB at B=512, V=5632, W=64), but every node waits for the
// score of the node after it, so the scan is a chain of V dependent
// steps per target. With one warp per target, a batch of 512 targets
// gives about four warps per SM: the chain's latency (shared-memory
// reads, a five-shuffle warp max) bounds the kernel, not bandwidth.
//
// What the design does about it:
// - One warp per target; the lanes split the W band slots (two int16
//   slots per 32-bit word, so W=64 is one word per lane) and the K
//   long-edge registers (which live in registers, K/32 per lane). The
//   band candidates and the folded long edges of a node are reduced in
//   ONE warp max.
// - The band is read in its native [B, V, W] layout: a chunk of 32 rows
//   of one target is one contiguous block, staged into shared memory by
//   cp.async while the previous chunk is scanned (double buffer), so
//   device-memory latency leaves the dependent chain. The chunk's
//   exit/cov/unsup values are prefetched into registers the same way
//   (lane l holds node lo + l).
// - Scores, 0.5 * cov and unsup of the last kRing nodes live in a ring
//   in shared memory; step i reads nodes i+1 .. i+W of it.
//
// Exactness: every candidate is the same float32 sum as the reference's
// (round-to-nearest subtract and add, no contraction: the intrinsics
// below and --fmad=false at build time), and f32 max is exact, so the
// result is bitwise equal to `dp_scores`.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 32;  // nodes per staged band chunk (= lanes)
constexpr int kRing = 256;  // ring length: >= kChunk + max W, power of 2
constexpr int kMaxW = 128;
constexpr float kPenalty = -10.0f;

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

// Stage rows [c*kChunk, min(c*kChunk + kChunk, V)) of one target's band
// (contiguous, 2W bytes a row, W % 8 == 0) into `dst` as 16-byte copies.
__device__ __forceinline__ void stage_chunk(int16_t* dst,
                                            const int16_t* __restrict__ band,
                                            int c, int V, int W, int lane) {
  const int lo = c * kChunk;
  const int rows = min(kChunk, V - lo);
  const int units = rows * W / 8;
  const int16_t* src = band + static_cast<size_t>(lo) * W;
  for (int u = lane; u < units; u += 32) cp_async16(dst + u * 8, src + u * 8);
}

// WPL: 32-bit band words per lane (ceil(W / 64)); KPL: long-edge
// registers per lane (ceil(K / 32)).
template <int WPL, int KPL>
__global__ void __launch_bounds__(32)
    dp_scan_kernel(const int16_t* __restrict__ win,
                   const int16_t* __restrict__ exit_c,
                   const int16_t* __restrict__ cov,
                   const uint8_t* __restrict__ unsup,
                   const int32_t* __restrict__ long_u,
                   const int32_t* __restrict__ long_w,
                   const float* __restrict__ long_esc,
                   float* __restrict__ out, int V, int W, int K) {
  extern __shared__ __align__(16) unsigned char smem[];
  int16_t* band_buf = reinterpret_cast<int16_t*>(smem);  // [2][kChunk * W]
  float* ring_s = reinterpret_cast<float*>(smem + 2 * kChunk * W * 2);
  float* ring_h = ring_s + kRing;  // 0.5 * cov
  int* ring_u = reinterpret_cast<int*>(ring_h + kRing);

  const int lane = threadIdx.x;
  const size_t row0 = static_cast<size_t>(blockIdx.x) * V;
  const int16_t* band = win + row0 * W;
  const float neg = -CUDART_INF_F;

  for (int r = lane; r < kRing; r += 32) {
    ring_s[r] = neg;
    ring_h[r] = 0.0f;
    ring_u[r] = 0;
  }
  int r_lu[KPL], r_lw[KPL];
  float r_le[KPL], pend[KPL];
#pragma unroll
  for (int j = 0; j < KPL; ++j) {
    const int k = lane + 32 * j;
    const bool ok = k < K;
    const size_t o = static_cast<size_t>(blockIdx.x) * K + k;
    r_lu[j] = ok ? long_u[o] : -1;
    r_lw[j] = ok ? long_w[o] : -1;
    r_le[j] = ok ? long_esc[o] : neg;
    pend[j] = neg;
  }

  const int nchunks = (V + kChunk - 1) / kChunk;
  int c = nchunks - 1;
  stage_chunk(band_buf + (c & 1) * kChunk * W, band, c, V, W, lane);
  cp_async_commit();
  int node = c * kChunk + lane;
  bool in = node < V;
  int a_cov = in ? cov[row0 + node] : 0;
  int a_uns = in ? unsup[row0 + node] : 0;
  int a_exit = in ? exit_c[row0 + node] : -1;

  for (; c >= 0; --c) {
    const int lo = c * kChunk;
    const int hi = min(lo + kChunk, V);
    // Prefetch the next (lower) chunk: band into the other buffer,
    // node attributes into registers.
    int n_cov = 0, n_uns = 0, n_exit = -1;
    if (c > 0) {
      stage_chunk(band_buf + ((c - 1) & 1) * kChunk * W, band, c - 1, V, W,
                  lane);
      cp_async_commit();
      node = lo - kChunk + lane;
      n_cov = cov[row0 + node];
      n_uns = unsup[row0 + node];
      n_exit = exit_c[row0 + node];
    }
    // This chunk's cov/unsup enter the ring now: its slots alias only
    // nodes >= lo + kRing, which no step of this chunk reads.
    if (lo + lane < hi) {
      const int slot = (lo + lane) & (kRing - 1);
      ring_h[slot] = __fmul_rn(0.5f, static_cast<float>(a_cov));
      ring_u[slot] = a_uns;
    }
    if (c > 0) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();

    const float my_exit = a_exit >= 0 ? static_cast<float>(a_exit) : neg;
    float my_out = neg;
    const int16_t* chunk = band_buf + (c & 1) * kChunk * W;
    const int half_w = W / 2;
    for (int i = hi - 1; i >= lo; --i) {
      const int r = i - lo;
      float m = lane == r ? my_exit : neg;
      const uint32_t* row = reinterpret_cast<const uint32_t*>(chunk + r * W);
#pragma unroll
      for (int j = 0; j < WPL; ++j) {
        const int w = lane + 32 * j;
        if (w < half_w) {
          const uint32_t word = row[w];
          const int c0 = static_cast<int16_t>(word & 0xFFFFu);
          const int c1 = static_cast<int16_t>(word >> 16);
          const int p0 = (i + 1 + 2 * w) & (kRing - 1);
          const int p1 = (p0 + 1) & (kRing - 1);
          if (c0 >= 0) {
            const float e = ring_u[p0]
                                ? kPenalty
                                : __fsub_rn(static_cast<float>(c0), ring_h[p0]);
            m = fmaxf(m, __fadd_rn(e, ring_s[p0]));
          }
          if (c1 >= 0) {
            const float e = ring_u[p1]
                                ? kPenalty
                                : __fsub_rn(static_cast<float>(c1), ring_h[p1]);
            m = fmaxf(m, __fadd_rn(e, ring_s[p1]));
          }
        }
      }
      // Fold long edges leaving node i (before latching those into i).
#pragma unroll
      for (int j = 0; j < KPL; ++j) {
        if (r_lu[j] == i) m = fmaxf(m, pend[j]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        m = fmaxf(m, __shfl_xor_sync(0xFFFFFFFFu, m, off));
      }
#pragma unroll
      for (int j = 0; j < KPL; ++j) {
        if (r_lw[j] == i) pend[j] = __fadd_rn(r_le[j], m);
      }
      if (lane == r) {
        ring_s[i & (kRing - 1)] = m;
        my_out = m;
      }
      __syncwarp();
    }
    if (lo + lane < hi) out[row0 + lo + lane] = my_out;
    a_cov = n_cov;
    a_uns = n_uns;
    a_exit = n_exit;
  }
}

template <int WPL, int KPL>
cudaError_t launch(const void* win, const void* exit_c, const void* cov,
                   const void* unsup, const void* lu, const void* lw,
                   const void* lesc, void* out, int B, int V, int W, int K,
                   cudaStream_t stream) {
  const size_t smem =
      2 * kChunk * W * sizeof(int16_t) + kRing * (2 * sizeof(float) + sizeof(int));
  dp_scan_kernel<WPL, KPL><<<B, 32, smem, stream>>>(
      static_cast<const int16_t*>(win), static_cast<const int16_t*>(exit_c),
      static_cast<const int16_t*>(cov), static_cast<const uint8_t*>(unsup),
      static_cast<const int32_t*>(lu), static_cast<const int32_t*>(lw),
      static_cast<const float*>(lesc), static_cast<float*>(out), V, W, K);
  return cudaGetLastError();
}

template <int WPL>
cudaError_t launch_k(const void* win, const void* exit_c, const void* cov,
                     const void* unsup, const void* lu, const void* lw,
                     const void* lesc, void* out, int B, int V, int W, int K,
                     cudaStream_t stream) {
  if (K <= 32)
    return launch<WPL, 1>(win, exit_c, cov, unsup, lu, lw, lesc, out, B, V, W,
                          K, stream);
  if (K <= 64)
    return launch<WPL, 2>(win, exit_c, cov, unsup, lu, lw, lesc, out, B, V, W,
                          K, stream);
  return launch<WPL, 4>(win, exit_c, cov, unsup, lu, lw, lesc, out, B, V, W, K,
                        stream);
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
      K > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || V == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (W <= 64)
    return static_cast<int>(launch_k<1>(win, exit_c, cov, unsup, lu, lw, lesc,
                                        out, B, V, W, K, s));
  return static_cast<int>(
      launch_k<2>(win, exit_c, cov, unsup, lu, lw, lesc, out, B, V, W, K, s));
}

const char* dagcon_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
