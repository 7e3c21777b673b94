// Unscaled flash-attention forward for Hopper (sm_90a), float32.
//
// Replaces the TPU kernel tinydiffusion_tpu/ops/attention.py::_fwd_kernel
// (launched by _fwd): out = softmax(Q K^T) V with NO 1/sqrt(d) scaling, plus
// the row log-sum-exp lse, without ever building the N x N logits.
//
// Layout: the conv-VAE's SelfAttention2D produces q, k, v with the token
// axis N minor, so the kernel takes qt, kt (B, D, N) and vt (B, C, N), all
// contiguous, and writes out (B, C, N) and lse (B, 1, N).
//
// Design (simple first; mma/wgmma, TMA and split keys are later work):
// - One thread owns one (batch, query) row. Its q (D <= 8) and its output
//   accumulator (C <= 64) stay in registers, in float32. Neighbouring
//   threads own neighbouring queries, so every global load and store of a
//   (B, *, N) tensor is coalesced.
// - The block stages kBlockK keys of K and V in shared memory, key-major, so
//   a thread reads one key's D (or C) values as float4 broadcasts.
// - Online softmax in base 2: q is pre-scaled by log2(e), so p = exp2(s - m).
//   The running max is updated once per kChunk keys, which bounds the
//   rescaling of the C accumulators to one multiply per chunk.
//
// Bound on an H100: 2*B*N^2*(D+C) float32 FLOPs against a few MB of traffic,
// so the work is compute-bound (N=16384, D=4, C=32, B=4: 77 GFLOP, 1.15 ms at
// 67 TFLOP/s). The kernel issues one fused multiply-add per FLOP pair on the
// CUDA cores; the tensor cores are left for a later version.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;  // query rows per block, one per thread
constexpr int kBlockK = 64;    // keys staged in shared memory per tile
constexpr int kChunk = 16;     // keys scored per online-softmax rescale
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

static_assert(kBlockK % kChunk == 0, "a chunk never straddles two tiles");

template <int D, int C>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const float* __restrict__ qt, const float* __restrict__ kt,
                     const float* __restrict__ vt, float* __restrict__ out,
                     float* __restrict__ lse, int n) {
  static_assert(D % 4 == 0 && C % 4 == 0, "float4 shared-memory reads");
  __shared__ __align__(16) float ks[kBlockK][D];
  __shared__ __align__(16) float vs[kBlockK][C];

  const int b = blockIdx.y;
  const int row = blockIdx.x * kThreads + threadIdx.x;
  const bool active = row < n;
  const float* qb = qt + static_cast<size_t>(b) * D * n;
  const float* kb = kt + static_cast<size_t>(b) * D * n;
  const float* vb = vt + static_cast<size_t>(b) * C * n;

  float q[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    q[d] = active ? qb[static_cast<size_t>(d) * n + row] * kLog2e : 0.f;
  }
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.f;
  float m = -INFINITY;  // running max of the base-2 logits
  float l = 0.f;        // running sum of exp2(s - m)

  for (int k0 = 0; k0 < n; k0 += kBlockK) {
    const int kn = min(kBlockK, n - k0);
    __syncthreads();  // every thread is done with the previous tile
    for (int e = threadIdx.x; e < D * kBlockK; e += kThreads) {
      const int d = e / kBlockK, j = e % kBlockK;
      ks[j][d] = j < kn ? kb[static_cast<size_t>(d) * n + k0 + j] : 0.f;
    }
    for (int e = threadIdx.x; e < C * kBlockK; e += kThreads) {
      const int c = e / kBlockK, j = e % kBlockK;
      vs[j][c] = j < kn ? vb[static_cast<size_t>(c) * n + k0 + j] : 0.f;
    }
    __syncthreads();

    for (int j0 = 0; j0 < kn; j0 += kChunk) {
      float s[kChunk];
      float chunk_max = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const float4* kr = reinterpret_cast<const float4*>(ks[j0 + jj]);
        float dot = 0.f;
#pragma unroll
        for (int d4 = 0; d4 < D / 4; ++d4) {
          const float4 kv = kr[d4];
          dot = fmaf(q[4 * d4 + 0], kv.x, dot);
          dot = fmaf(q[4 * d4 + 1], kv.y, dot);
          dot = fmaf(q[4 * d4 + 2], kv.z, dot);
          dot = fmaf(q[4 * d4 + 3], kv.w, dot);
        }
        s[jj] = j0 + jj < kn ? dot : -INFINITY;  // keys past N weigh 0
        chunk_max = fmaxf(chunk_max, s[jj]);
      }
      // The chunk holds key j0 < kn, so m_new is finite; exp2(-inf) = 0 on
      // the first chunk zeroes nothing that is not already zero.
      const float m_new = fmaxf(m, chunk_max);
      const float alpha = exp2f(m - m_new);
      l *= alpha;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] *= alpha;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const float p = exp2f(s[jj] - m_new);
        l += p;
        const float4* vr = reinterpret_cast<const float4*>(vs[j0 + jj]);
#pragma unroll
        for (int c4 = 0; c4 < C / 4; ++c4) {
          const float4 vv = vr[c4];
          acc[4 * c4 + 0] = fmaf(p, vv.x, acc[4 * c4 + 0]);
          acc[4 * c4 + 1] = fmaf(p, vv.y, acc[4 * c4 + 1]);
          acc[4 * c4 + 2] = fmaf(p, vv.z, acc[4 * c4 + 2]);
          acc[4 * c4 + 3] = fmaf(p, vv.w, acc[4 * c4 + 3]);
        }
      }
      m = m_new;
    }
  }

  if (active) {
    const float inv_l = 1.f / l;
    float* ob = out + static_cast<size_t>(b) * C * n;
#pragma unroll
    for (int c = 0; c < C; ++c) ob[static_cast<size_t>(c) * n + row] = acc[c] * inv_l;
    lse[static_cast<size_t>(b) * n + row] = (m + log2f(l)) * kLn2;
  }
}

template <int D, int C>
cudaError_t launch(const void* qt, const void* kt, const void* vt, void* out, void* lse,
                   int b, int n, cudaStream_t stream) {
  const dim3 grid((n + kThreads - 1) / kThreads, b);
  flash_fwd_f32_kernel<D, C><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(qt), static_cast<const float*>(kt),
      static_cast<const float*>(vt), static_cast<float*>(out), static_cast<float*>(lse), n);
  return cudaGetLastError();
}

}  // namespace

// Launches the forward on `stream` and returns cudaGetLastError() (0 on
// success). (d, c) must be one of the instantiated head widths below; any
// other pair returns cudaErrorInvalidValue without launching.
extern "C" int tdt_flash_fwd_f32(const void* qt, const void* kt, const void* vt, void* out,
                                 void* lse, int b, int n, int d, int c, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (b <= 0 || n <= 0 || b > 65535) return cudaErrorInvalidValue;
  if (d == 4 && c == 32) return launch<4, 32>(qt, kt, vt, out, lse, b, n, s);
  if (d == 8 && c == 64) return launch<8, 64>(qt, kt, vt, out, lse, b, n, s);
  return cudaErrorInvalidValue;
}
