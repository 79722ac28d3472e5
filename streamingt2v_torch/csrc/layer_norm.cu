// K7: LayerNorm and RMSNorm over rows of C contiguous channels, for Hopper,
// in one pass.
//
// Replaces no Pallas kernel: the JAX package leaves LayerNorm to XLA
// (streamingt2v_tpu/ops/norms.py `layer_norm`), and the port ran it as the
// plain chain of ops/fused_layer_norm.py `layer_norm_reference`: the f32
// copy, two means, the square, the variance, the subtraction, rsqrt, the
// scale, the bias and the cast, each a pass over the whole tensor in f32.
// The RMS entry does the same for ops/fused_layer_norm.py
// `rms_norm_reference` (Wan's q/k norm across all heads; the JAX package has
// no RMSNorm): the f32 copy, the square, the mean, rsqrt, two multiplies and
// the cast.
//
// What bounds it on the H100: bytes.  The function needs each element read
// once and written once (4 bytes an element in bf16, 8 in f32), and this
// kernel moves nothing more: a row is held in registers from its one read,
// so the statistics and the normalised output both come from the registers.
//
// A row is split over `lanes` lanes (a power of two, chosen by the wrapper
// from C, ops/fused_layer_norm.py `launch_plan`), and each lane holds VPT
// 16-byte vectors of it (8 channels in bf16, 4 in f32): lane l takes vectors
// l, l + lanes, l + 2 lanes, ..., so that the row's lanes read neighbouring
// 16-byte pieces together.  All of a lane's loads are issued before any is
// used; a lane that holds fewer than 4 vectors takes ROWS rows at once, so
// that at least 4 loads are in flight.  One sweep over the registers gives
// the lane's sum and sum of squares, a butterfly of shuffles within the
// row's lanes the row's, and the output is written from the same registers,
// 16 bytes a store.  Up to C = 4096 a row lies in one warp (up to 32 lanes,
// up to 32 vectors a lane): a C of 64 thus packs 4 rows into a warp (8
// lanes a row), C = 320 to 1280 takes 8 to 32 lanes of 5 vectors, and
// CogVideoX's f32 stream of 3072 one warp a row of 24 vectors a lane.
//
// A wider row (4096 < C <= LN_MAX_C, the WIDE instances) would need more
// registers than a warp's lanes hold at full occupancy (Wan's f32 stream of
// 5120 is 40 vectors a lane, 160 registers of data), so it is split over
// 2, 4 or 8 warps of the block (64 to 256 lanes) of 4 to 8 vectors a lane:
// Wan's 5120 takes 128 lanes of 5 vectors in bf16 and the whole block, 256
// lanes of 5, in f32 (0.447 and 0.888 ms at 65,520 rows on the H100, 89.5%
// and 90.2% of the byte bound; 64 x 10 and 256 x 3 in bf16, 128 x 10 in
// f32 ran 0 to 4% slower).  Each warp's butterfly gives its part of the
// row's sums, which its first lane puts in shared memory; after one barrier
// every lane adds its row's parts in warp order and writes from its
// registers.  LN_MAX_C = 8192 is the widest row 256 lanes of 8 vectors
// cover in f32.
//
// The statistics take the one-pass clamped form in f32, var = max(E[x^2] -
// mean^2, 0), as the plain version and K3's LN pass do; the RMS entry (RMS)
// takes Sum x^2 alone, rstd = rsqrt(E[x^2] + eps) and y = (x rstd) scale, in
// the plain chain's order.  A block takes one group of rows and the hardware
// keeps the SMs full to the last group (a persistent grid of as many blocks
// as fit, walking the groups in turn, ran 4 to 11% slower on the H100: its
// last sweeps ran with SMs part idle).  There are no atomics, so every sum is
// taken in a fixed order and the output is the same from run to run.
#include "common.cuh"

namespace st2v {
namespace {

constexpr int LN_THREADS = 256;
constexpr int LN_WARPS = LN_THREADS / 32;
constexpr int LN_NARROW_C = 4096;   // the widest row one warp takes
constexpr int LN_MAX_C = 8192;

// rows a lane takes at once: at least 4 of its 16-byte loads in flight
__host__ __device__ constexpr int ln_rows(int vpt) { return (vpt + 3) / vpt; }

// 16 bytes <-> 8 (bf16) or 4 (f32) floats
__device__ __forceinline__ void ln_unpack(const uint4& raw, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 v = __bfloat1622float2(h[e]);
    f[2 * e] = v.x;
    f[2 * e + 1] = v.y;
  }
}
__device__ __forceinline__ void ln_unpack(const uint4& raw, float (&f)[4]) {
  f[0] = __uint_as_float(raw.x);
  f[1] = __uint_as_float(raw.y);
  f[2] = __uint_as_float(raw.z);
  f[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ uint4 ln_pack(const float (&f)[8]) {
  return make_uint4(pack_bf16x2(f[0], f[1]), pack_bf16x2(f[2], f[3]), pack_bf16x2(f[4], f[5]),
                    pack_bf16x2(f[6], f[7]));
}
__device__ __forceinline__ uint4 ln_pack(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}

// VEC floats of an f32 vector (scale or bias) at channel `col`, 16-byte loads
template <int VEC>
__device__ __forceinline__ void ln_params(const float* p, int col, float (&f)[VEC]) {
  const float4* q = reinterpret_cast<const float4*>(p + col);
#pragma unroll
  for (int k = 0; k < VEC / 4; ++k) {
    const float4 v = __ldg(q + k);
    f[4 * k] = v.x;
    f[4 * k + 1] = v.y;
    f[4 * k + 2] = v.z;
    f[4 * k + 3] = v.w;
  }
}

// Thread t of a block is lane `sub` = t % lanes of row slot t / lanes; block b
// takes the LN_THREADS / lanes * ROWS rows from base = b * that, slot s rows
// base + r * slots + s (r < ROWS), so that a warp's rows are neighbours.
// WIDE: lanes is 64, 128 or 256, a row over lanes / 32 warps whose sums meet
// in shared memory.  RMS: no mean, no bias, the scale required.
template <typename T, int VPT, bool WIDE, bool RMS>
__global__ void __launch_bounds__(LN_THREADS)
layer_norm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                  const float* __restrict__ bias, T* __restrict__ y, int rows, int c, int lanes,
                  float eps) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int ROWS = ln_rows(VPT);
  const int vectors = c / VEC;
  const int sub = threadIdx.x & (lanes - 1);
  const int slots = LN_THREADS / lanes;
  const int slot = threadIdx.x / lanes;
  const float inv_c = 1.f / float(c);
  const long long base = (long long)blockIdx.x * slots * ROWS;
  uint4 v[ROWS][VPT];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const long long row = base + r * slots + slot;
    const T* src = x + row * c;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int j = sub + i * lanes;
      v[r][i] = row < rows && j < vectors
                    ? *reinterpret_cast<const uint4*>(src + j * VEC)
                    : make_uint4(0u, 0u, 0u, 0u);
    }
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      float f[VEC];
      ln_unpack(v[r][i], f);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        if constexpr (!RMS) s1 += f[e];
        s2 = fmaf(f[e], f[e], s2);
      }
    }
    // every lane of the warp shuffles, a lane past the last row too
    for (int o = (WIDE ? 32 : lanes) >> 1; o > 0; o >>= 1) {
      if constexpr (!RMS) s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    }
    if constexpr (WIDE) {
      // the row's warps' parts, added in warp order by each of its lanes
      __shared__ float2 part[ROWS][LN_WARPS];
      if ((threadIdx.x & 31) == 0) part[r][threadIdx.x >> 5] = make_float2(s1, s2);
      __syncthreads();
      const int first = slot * (lanes >> 5);
      s1 = s2 = 0.f;
      for (int w = 0; w < (lanes >> 5); ++w) {
        const float2 p = part[r][first + w];
        s1 += p.x;
        s2 += p.y;
      }
    }
    const float mean = RMS ? 0.f : s1 * inv_c;
    const float rstd = RMS ? rsqrtf(s2 * inv_c + eps)
                           : rsqrtf(fmaxf(s2 * inv_c - mean * mean, 0.f) + eps);
    const long long row = base + r * slots + slot;
    if (row >= rows) continue;
    T* dst = y + row * c;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int j = sub + i * lanes;
      if (j >= vectors) continue;
      float f[VEC];
      ln_unpack(v[r][i], f);
#pragma unroll
      for (int e = 0; e < VEC; ++e) f[e] = RMS ? f[e] * rstd : (f[e] - mean) * rstd;
      if (scale != nullptr) {
        float s[VEC];
        ln_params(scale, j * VEC, s);
#pragma unroll
        for (int e = 0; e < VEC; ++e) f[e] *= s[e];
      }
      if (!RMS && bias != nullptr) {
        float b[VEC];
        ln_params(bias, j * VEC, b);
#pragma unroll
        for (int e = 0; e < VEC; ++e) f[e] += b[e];
      }
      *reinterpret_cast<uint4*>(dst + j * VEC) = ln_pack(f);
    }
  }
}

// One instance, one block a group of rows.
template <typename T, int VPT, bool WIDE, bool RMS>
cudaError_t ln_run(const void* x, const float* scale, const float* bias, void* y, int rows,
                   int c, int lanes, float eps, cudaStream_t s) {
  const int group = LN_THREADS / lanes * ln_rows(VPT);
  layer_norm_kernel<T, VPT, WIDE, RMS>
      <<<int((rows + (long long)group - 1) / group), LN_THREADS, 0, s>>>(
          static_cast<const T*>(x), scale, bias, static_cast<T*>(y), rows, c, lanes, eps);
  return cudaGetLastError();
}

// A row in one warp (lanes <= 32) or over several (WIDE, lanes 64 to 256).
template <typename T, bool RMS>
cudaError_t ln_dispatch(const void* x, const float* scale, const float* bias, void* y,
                        int rows, int c, int lanes, int vpt, float eps, cudaStream_t s) {
  if (lanes <= 32) {
    switch (vpt) {
#define ST2V_LN_CASE(V) \
  case V:               \
    return ln_run<T, V, false, RMS>(x, scale, bias, y, rows, c, lanes, eps, s);
      ST2V_LN_CASE(1)
      ST2V_LN_CASE(2)
      ST2V_LN_CASE(3)
      ST2V_LN_CASE(4)
      ST2V_LN_CASE(5)
      ST2V_LN_CASE(6)
      ST2V_LN_CASE(8)
      ST2V_LN_CASE(12)
      ST2V_LN_CASE(16)
      ST2V_LN_CASE(24)
      ST2V_LN_CASE(32)
#undef ST2V_LN_CASE
      default:
        return cudaErrorInvalidValue;
    }
  }
  switch (vpt) {
#define ST2V_LN_WIDE_CASE(V) \
  case V:                    \
    return ln_run<T, V, true, RMS>(x, scale, bias, y, rows, c, lanes, eps, s);
    ST2V_LN_WIDE_CASE(4)
    ST2V_LN_WIDE_CASE(5)
    ST2V_LN_WIDE_CASE(6)
    ST2V_LN_WIDE_CASE(8)
#undef ST2V_LN_WIDE_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

// The launch plan's bounds, shared by both entries: a row of 16-byte
// vectors, `lanes` a power of two up to the block (a row in one warp up to
// LN_NARROW_C, over 2 to 8 warps past it), lanes * vpt vectors covering it.
bool ln_plan_ok(int rows, int c, int lanes, int vpt, int dtype) {
  const int vec = dtype == 1 ? 8 : 4;
  return rows > 0 && c > 0 && c % 8 == 0 && c <= LN_MAX_C && lanes > 0 &&
         (lanes & (lanes - 1)) == 0 && (c > LN_NARROW_C ? lanes >= 64 && lanes <= LN_THREADS
                                                         : lanes <= 32) &&
         (long long)lanes * vpt * vec >= c && (dtype == 0 || dtype == 1);
}

template <bool RMS>
int ln_entry(const void* x, const float* scale, const float* bias, void* y, int rows, int c,
             int lanes, int vpt, float eps, int dtype, void* stream) {
  if (!ln_plan_ok(rows, c, lanes, vpt, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      dtype == 1 ? ln_dispatch<bf16, RMS>(x, scale, bias, y, rows, c, lanes, vpt, eps, s)
                 : ln_dispatch<float, RMS>(x, scale, bias, y, rows, c, lanes, vpt, eps, s));
}

}  // namespace
}  // namespace st2v

// y = LayerNorm(x) * scale + bias over rows (rows, c), x and y in dtype (0 f32,
// 1 bf16), contiguous and 16-byte aligned; scale, bias: (c,) f32, 16-byte
// aligned, or null for none.  `lanes` lanes a row, `vpt` 16-byte vectors a
// lane (the wrapper's launch plan: lanes * vpt vectors cover a row).
extern "C" int st2v_layer_norm(const void* x, const float* scale, const float* bias, void* y,
                               int rows, int c, int lanes, int vpt, float eps, int dtype,
                               void* stream) {
  return st2v::ln_entry<false>(x, scale, bias, y, rows, c, lanes, vpt, eps, dtype, stream);
}

// y = x rsqrt(mean(x^2) + eps) * scale over rows (rows, c), as st2v_layer_norm
// but with no mean and no bias; scale: (c,) f32, 16-byte aligned, required.
extern "C" int st2v_rms_norm(const void* x, const float* scale, void* y, int rows, int c,
                             int lanes, int vpt, float eps, int dtype, void* stream) {
  if (scale == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return st2v::ln_entry<true>(x, scale, nullptr, y, rows, c, lanes, vpt, eps, dtype, stream);
}
