// Fused q_sample for Hopper (sm_90a), float32.
//
// Replaces the TPU kernel tinydiffusion_tpu/ops/qsample.py::_qsample_kernel
// (launched by q_sample_fused): for each batch row, draw z ~ N(0, 1) inside
// the kernel and write x_t = sqrt(abar[t]) * x0 + sqrt(1 - abar[t]) * z and
// z itself, in one pass over the batch. The noise never makes a round trip
// through device memory before the noising.
//
// Random bits: the TPU's hardware PRNG has no counterpart here, so the
// kernel computes a counter-based Philox4x32-10 (Salmon et al., SC'11,
// the Random123 constants). Its key is a 64-bit seed and its counter is
// (element group, row, 0, 0): every row has its own stream, as `seed + row`
// gives on the TPU, and a run is a pure function of (seed, shape). The row
// is the global one: a launch on rows [r, r + b) of a data-parallel batch
// passes row_offset = r and draws exactly those rows of the global launch's
// noise (t and the buffers are indexed by the local row). One
// Philox call gives 4 uint32 for the 4 elements of one group. Each becomes a
// uniform in (0, 1] with the JAX kernel's rule (the top 24 bits times 2^-24,
// plus 2^-25, never 0), and Box-Muller turns the two pairs into 4 normals,
// using both the cosine and the sine. The plain version
// (q_sample_fused_reference in ops/qsample.py) computes the same stream with
// torch integer ops, so the two agree value for value, up to the last bits
// of logf/sincosf. The file is built without --use_fast_math, so those stay
// accurate to a few ulp.
//
// The seed: as the TPU kernel reads its seed from SMEM (seed_ref), this one
// reads it from device memory, an int64 whose bits are the key, so a train
// step captured in a CUDA graph draws its seed on the device and each replay
// noises with a new one. A null pointer selects the by-value seed instead,
// for a call from Python with an int.
//
// Bound on an H100: memory. The kernel reads x0 and writes x_t and z, 12
// bytes an element: at B = 128 and 1x28x28, 1.2 MB, 0.36 us at 3.35 TB/s.
// Its ~35 integer and float operations an element (the Philox rounds
// dominate) take a tenth of that at the CUDA cores' rate. At this size a
// separate launch, a few microseconds, costs more than the work; inside a
// CUDA graph only the kernel's own few microseconds remain, and fusing the
// noise draw into the noising (one kernel instead of randn plus two
// elementwise passes) is what the kernel buys.
//
// Layout: x0, x_t and z are (batch, feat) contiguous float32, feat = the
// product of a sample's dimensions. The grid is flat: a thread owns one
// group of 4 consecutive elements of a row, and the batch * ceil(feat / 4)
// groups fill blocks of 128 in row order (at (128, 784): 196 full blocks; a
// grid of (row, chunk of 128 groups) left a quarter of its threads idle). A
// group is read and written as one float4 when feat % 4 == 0 (784 = 4 * 196
// on the main path) and the three buffers start 16-byte aligned, and as
// scalars otherwise (a row would then not be 16-byte aligned: an odd feat,
// or a view with an odd storage offset).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // element groups per block
constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;  // key bumps: golden ratio, sqrt(3) - 1
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;
constexpr float kTwoPi = 6.28318530717958647692f;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    if (round > 0) {
      k.x += kPhiloxW0;
      k.y += kPhiloxW1;
    }
    const uint32_t hi0 = __umulhi(kPhiloxM0, c.x), lo0 = kPhiloxM0 * c.x;
    const uint32_t hi1 = __umulhi(kPhiloxM1, c.z), lo1 = kPhiloxM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

// uint32 -> (0, 1]: the top 24 bits times 2^-24, plus 2^-25 so log() stays
// finite. The product is exact; the sum rounds to nearest, as in float32 on
// the CPU.
__device__ __forceinline__ float uniform_from_bits(uint32_t bits) {
  return __fadd_rn(static_cast<float>(bits >> 8) * (1.0f / 16777216.0f),
                   1.0f / 33554432.0f);
}

__device__ __forceinline__ float2 box_muller(uint32_t bits_r, uint32_t bits_theta) {
  const float r = sqrtf(__fmul_rn(-2.0f, logf(uniform_from_bits(bits_r))));
  float s, c;
  sincosf(__fmul_rn(kTwoPi, uniform_from_bits(bits_theta)), &s, &c);
  return make_float2(__fmul_rn(r, c), __fmul_rn(r, s));
}

// sac * x + s1m * z without contraction into an fma, as the plain version
// computes it (two products, one sum).
__device__ __forceinline__ float noised(float sac, float x, float s1m, float z) {
  return __fadd_rn(__fmul_rn(sac, x), __fmul_rn(s1m, z));
}

__global__ void __launch_bounds__(kThreads)
qsample_f32_kernel(const float* __restrict__ x0, const int64_t* __restrict__ t,
                   const float* __restrict__ sac, const float* __restrict__ s1m,
                   float* __restrict__ xt, float* __restrict__ z, uint32_t groups,
                   uint32_t groups_per_row, int feat, bool vec4, int num_timesteps,
                   const int64_t* __restrict__ seed_ptr, uint2 key, uint32_t row_offset) {
  const uint32_t gid = blockIdx.x * kThreads + threadIdx.x;
  if (gid >= groups) return;
  const uint32_t row = gid / groups_per_row;
  const uint32_t group = gid - row * groups_per_row;
  const int base = static_cast<int>(group) * 4;
  if (seed_ptr != nullptr) {
    const uint64_t seed = static_cast<uint64_t>(__ldg(seed_ptr));
    key = make_uint2(static_cast<uint32_t>(seed), static_cast<uint32_t>(seed >> 32));
  }

  // Out-of-range timesteps clamp, as a JAX gather does; the wrapper cannot
  // check them without a device-to-host sync.
  int64_t tr = t[row];
  tr = tr < 0 ? 0 : (tr >= num_timesteps ? num_timesteps - 1 : tr);
  const float a = sac[tr];
  const float b = s1m[tr];

  const uint4 bits = philox4x32_10(make_uint4(group, row + row_offset, 0u, 0u), key);
  const float2 n01 = box_muller(bits.x, bits.y);
  const float2 n23 = box_muller(bits.z, bits.w);

  const size_t off = static_cast<size_t>(row) * feat + base;
  if (vec4) {
    const float4 x = *reinterpret_cast<const float4*>(x0 + off);
    *reinterpret_cast<float4*>(z + off) = make_float4(n01.x, n01.y, n23.x, n23.y);
    *reinterpret_cast<float4*>(xt + off) =
        make_float4(noised(a, x.x, b, n01.x), noised(a, x.y, b, n01.y),
                    noised(a, x.z, b, n23.x), noised(a, x.w, b, n23.y));
  } else {
    const float n[4] = {n01.x, n01.y, n23.x, n23.y};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (base + j < feat) {
        z[off + j] = n[j];
        xt[off + j] = noised(a, x0[off + j], b, n[j]);
      }
    }
  }
}

}  // namespace

// x0 (batch, feat) float32, t (batch,) int64, sac/s1m (num_timesteps,)
// float32 -> xt, z (batch, feat) float32. The key is the int64 at seed_ptr
// (device memory) or, when seed_ptr is null, `seed`; the noise of local row i
// is the stream's row row_offset + i. Returns the launch's cudaError_t.
extern "C" int tdt_qsample_f32(const float* x0, const int64_t* t, const float* sac,
                               const float* s1m, float* xt, float* z, int batch,
                               int feat, int num_timesteps, const int64_t* seed_ptr,
                               unsigned long long seed, unsigned int row_offset,
                               cudaStream_t stream) {
  if (batch <= 0 || feat <= 0) return 0;
  const uint64_t groups_per_row = (static_cast<uint64_t>(feat) + 3) / 4;
  const uint64_t groups = static_cast<uint64_t>(batch) * groups_per_row;
  if (groups > 0xFFFFFFFFull - kThreads) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((groups + kThreads - 1) / kThreads);
  const uint2 key = make_uint2(static_cast<uint32_t>(seed), static_cast<uint32_t>(seed >> 32));
  const uintptr_t bases = reinterpret_cast<uintptr_t>(x0) | reinterpret_cast<uintptr_t>(xt) |
                          reinterpret_cast<uintptr_t>(z);
  const bool vec4 = (feat & 3) == 0 && (bases & 15) == 0;
  qsample_f32_kernel<<<blocks, kThreads, 0, stream>>>(
      x0, t, sac, s1m, xt, z, static_cast<uint32_t>(groups),
      static_cast<uint32_t>(groups_per_row), feat, vec4, num_timesteps, seed_ptr, key,
      row_offset);
  return static_cast<int>(cudaGetLastError());
}
