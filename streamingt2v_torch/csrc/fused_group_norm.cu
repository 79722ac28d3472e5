// K5: GroupNorm (+ SiLU) over channel-last (N, L, C) for Hopper.
//
// Replaces the Pallas kernel `_kernel` (streamingt2v_tpu/ops/
// fused_group_norm.py:30, launched from `fused_group_norm`).  On the TPU the
// grid runs in order, so phase 0 carries the group sums across L-blocks in
// scratch and phase 1 revisits the blocks.  Here blocks run in parallel, so
// the statistics are a split reduction over two launches:
//
//   pass 1: block (chunk, n) reduces rows [chunk*rows, (chunk+1)*rows) of
//           row n to per-group (count, mean, M2) partials in a small scratch;
//   pass 2: block (chunk, n) merges row n's partials (Chan's formula), turns
//           them into a per-channel affine a = rstd*scale, b = bias - mean*a,
//           and writes silu?(x*a + b) for its rows in the input type.
//
// Partials are count/mean/M2, never raw sums of x and x^2: the one-pass
// E[x^2] - E[x]^2 of the TPU kernel (fused_group_norm.py:66-67) cancels when a
// group sits at a large common offset.
//
// What bounds it on the H100: bytes.  It reads x twice (once per pass) and
// writes the output once, 3 * N * L * C * itemsize in all (the bound counts x
// read once, so this design reaches at most 2/3 of it); the partials are
// N * chunks * G * 12 bytes.
//
// Both passes give every thread one fixed 16-byte vector of channels (8 in
// bf16, 4 in f32) and a row slot: a block is C/VEC x `slots` threads (the
// wrapper's launch plan), and slot s walks rows r0 + s, r0 + s + slots, ...
// with four 16-byte loads in flight.  No per-element index arithmetic: pass 1
// keeps per-channel sums of x - shift and (x - shift)^2 in registers (the
// shift is the thread's first value of each channel, so a large common offset
// does not cancel), turns them into per-channel (mean, M2) at the end, and
// merges those per group through a small shared array; pass 2 computes its
// channels' affine once and applies it as one FMA per element, SiLU as
// y / (1 + __expf(-y)) with the fast reciprocal (within the f32 tolerance
// of 1e-4).  Pass 2 walks the blocks in reverse order, so its first blocks
// read the rows pass 1 touched last, the ones most likely still in L2.
//
// A second entry, st2v_group_norm_affine, gives the statistics alone, for a
// consumer that applies the normalisation as it reads x (K4's GroupNorm+SiLU
// prologue): pass 1 as above, then gn_affine_kernel, one block per (group,
// row), merges the group's partials and writes the per-channel f32 affine
// (a, b) of (N, C).  It reads x once, so its bound is N * L * C * itemsize
// bytes.
#include "common.cuh"

namespace st2v {

// The widest row; a block takes at most GN_MAX_C / VEC threads (512 in bf16,
// 1024 in f32): one row slot at the widest C, and 256 where rows are narrower.
constexpr int GN_MAX_C = 4096;
constexpr int GN_MAX_GROUPS = 256;
constexpr int GN_UNROLL = 4;  // 16-byte loads in flight per thread

// Chan et al.: merge (n_b, mean_b, m2_b) into (n_a, mean_a, m2_a).
__device__ __forceinline__ void chan_merge(float& n_a, float& mean_a, float& m2_a, float n_b,
                                           float mean_b, float m2_b) {
  const float n = n_a + n_b;
  if (n_b == 0.f) return;
  const float delta = mean_b - mean_a;
  const float wb = n_b / n;
  mean_a += delta * wb;
  m2_a += m2_b + delta * delta * n_a * wb;
  n_a = n;
}

// 16 bytes <-> VEC floats
__device__ __forceinline__ void unpack(const uint4& raw, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 v = __bfloat1622float2(h[e]);
    f[2 * e] = v.x;
    f[2 * e + 1] = v.y;
  }
}
__device__ __forceinline__ void unpack(const uint4& raw, float (&f)[4]) {
  f[0] = __uint_as_float(raw.x);
  f[1] = __uint_as_float(raw.y);
  f[2] = __uint_as_float(raw.z);
  f[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  return make_uint4(pack_bf16x2(f[0], f[1]), pack_bf16x2(f[2], f[3]), pack_bf16x2(f[4], f[5]),
                    pack_bf16x2(f[6], f[7]));
}
__device__ __forceinline__ uint4 pack(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}

// silu?(x * a + b) for one 16-byte vector; SiLU with the fast exponential and
// reciprocal
template <int VEC>
__device__ __forceinline__ uint4 gn_affine(const uint4& raw, const float (&a)[VEC],
                                           const float (&b)[VEC], int silu) {
  float f[VEC];
  unpack(raw, f);
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    const float v = fmaf(f[e], a[e], b[e]);
    f[e] = silu ? __fdividef(v, 1.f + __expf(-v)) : v;
  }
  return pack(f);
}

// Merges the warp's 32 (count, mean, M2) triples into every lane's.
__device__ __forceinline__ void warp_merge(float& cnt, float& mean, float& m2) {
  for (int o = 16; o > 0; o >>= 1) {
    const float cn = __shfl_xor_sync(0xffffffffu, cnt, o);
    const float mn = __shfl_xor_sync(0xffffffffu, mean, o);
    const float mm = __shfl_xor_sync(0xffffffffu, m2, o);
    chan_merge(cnt, mean, m2, cn, mn, mm);
  }
}

// Merges, per group g, `per` (count, mean, M2) triples of `src`, entry e at
// src + 3 * ((e / k) * stride + g * k + e % k), one warp per group over the
// block's whole warps; lane 0 writes the group's triple to res + 3 * g.
__device__ __forceinline__ void merge_groups(const float* src, int groups, int per, int k,
                                             int stride, float* res) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  if (warp >= warps) return;  // a partial last warp takes no group
  for (int g = warp; g < groups; g += warps) {
    float cnt = 0.f, mean = 0.f, m2 = 0.f;
    for (int e = lane; e < per; e += 32) {
      const float* t = src + 3 * ((e / k) * stride + g * k + e % k);
      chan_merge(cnt, mean, m2, t[0], t[1], t[2]);
    }
    warp_merge(cnt, mean, m2);
    if (lane == 0) {
      res[3 * g] = cnt;
      res[3 * g + 1] = mean;
      res[3 * g + 2] = m2;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(GN_MAX_C * sizeof(T) / 16)
gn_stats_kernel(const T* __restrict__ x, float* __restrict__ part, int l, int c, int groups,
                int rows_per_chunk, int slots) {
  constexpr int VEC = 16 / sizeof(T);
  // (count, mean, M2) per (slot, channel)
  extern __shared__ __align__(16) float red[];
  const int vpr = c / VEC;  // channel vectors per row
  const int slot = threadIdx.x / vpr, cv = threadIdx.x - slot * vpr;
  const int chunk = blockIdx.x, n = blockIdx.y;
  const int r0 = chunk * rows_per_chunk;
  const int r1 = min(l, r0 + rows_per_chunk);
  const size_t step = size_t(slots) * c;
  const T* src = x + (size_t(n) * l + r0 + slot) * c + cv * VEC;

  float shift[VEC], s1[VEC], s2[VEC];
  int r = r0 + slot;
  if (r < r1) {
    unpack(*reinterpret_cast<const uint4*>(src), shift);
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) shift[e] = 0.f;
  }
#pragma unroll
  for (int e = 0; e < VEC; ++e) s1[e] = s2[e] = 0.f;
  const int count = r < r1 ? (r1 - r + slots - 1) / slots : 0;
  for (; r + (GN_UNROLL - 1) * slots < r1; r += GN_UNROLL * slots) {
    uint4 raw[GN_UNROLL];
#pragma unroll
    for (int u = 0; u < GN_UNROLL; ++u) raw[u] = *reinterpret_cast<const uint4*>(src + u * step);
    src += GN_UNROLL * step;
#pragma unroll
    for (int u = 0; u < GN_UNROLL; ++u) {
      float f[VEC];
      unpack(raw[u], f);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float d = f[e] - shift[e];
        s1[e] += d;
        s2[e] = fmaf(d, d, s2[e]);
      }
    }
  }
  for (; r < r1; r += slots) {
    float f[VEC];
    unpack(*reinterpret_cast<const uint4*>(src), f);
    src += step;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float d = f[e] - shift[e];
      s1[e] += d;
      s2[e] = fmaf(d, d, s2[e]);
    }
  }

  const float inv = count > 0 ? 1.f / count : 0.f;
  float* mine = red + 3 * (slot * c + cv * VEC);
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    mine[3 * e] = float(count);
    mine[3 * e + 1] = shift[e] + s1[e] * inv;
    mine[3 * e + 2] = fmaxf(s2[e] - s1[e] * s1[e] * inv, 0.f);
  }
  __syncthreads();
  // group g's entries: (slot s, channel g * cpg + j), s * cpg + j
  const int cpg = c / groups;
  merge_groups(red, groups, slots * cpg, cpg, c,
               part + (size_t(n) * gridDim.x + chunk) * groups * 3);
}

template <typename T>
__global__ void __launch_bounds__(GN_MAX_C * sizeof(T) / 16)
gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ part,
                const float* __restrict__ scale, const float* __restrict__ bias,
                T* __restrict__ y, int l, int c, int groups, int rows_per_chunk, int slots,
                float eps, int silu) {
  __shared__ float g_stat[3 * GN_MAX_GROUPS];  // (count, mean, M2) per group
  constexpr int VEC = 16 / sizeof(T);
  // reverse order: the first blocks take the rows pass 1 read last
  const int chunks = gridDim.x;
  const int chunk = chunks - 1 - blockIdx.x, n = gridDim.y - 1 - blockIdx.y;

  // merge row n's partials: group g's entry e is chunk e's
  merge_groups(part + size_t(n) * chunks * groups * 3, groups, chunks, 1, groups, g_stat);
  __syncthreads();

  const int vpr = c / VEC, cpg = c / groups;
  const int slot = threadIdx.x / vpr, cv = threadIdx.x - slot * vpr;
  float a[VEC], b[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    const int ch = cv * VEC + e, g = ch / cpg;
    const float rstd = rsqrtf(fmaxf(g_stat[3 * g + 2] / g_stat[3 * g], 0.f) + eps);
    a[e] = rstd * scale[ch];
    b[e] = bias[ch] - g_stat[3 * g + 1] * a[e];
  }
  const int r0 = chunk * rows_per_chunk;
  const int r1 = min(l, r0 + rows_per_chunk);
  const size_t step = size_t(slots) * c;
  const size_t off = (size_t(n) * l + r0 + slot) * c + cv * VEC;
  const T* src = x + off;
  T* dst = y + off;
  int r = r0 + slot;
  for (; r + (GN_UNROLL - 1) * slots < r1; r += GN_UNROLL * slots) {
    uint4 raw[GN_UNROLL];
#pragma unroll
    for (int u = 0; u < GN_UNROLL; ++u) raw[u] = *reinterpret_cast<const uint4*>(src + u * step);
#pragma unroll
    for (int u = 0; u < GN_UNROLL; ++u)
      *reinterpret_cast<uint4*>(dst + u * step) = gn_affine(raw[u], a, b, silu);
    src += GN_UNROLL * step;
    dst += GN_UNROLL * step;
  }
  for (; r < r1; r += slots) {
    *reinterpret_cast<uint4*>(dst) = gn_affine(*reinterpret_cast<const uint4*>(src), a, b, silu);
    src += step;
    dst += step;
  }
}

// Block (g, n) merges group g's partials of row n over its threads (a few
// chunks each, then the warps, then the block's warps) and writes the
// group's channels ch of a[n, ch] = rstd_g * scale[ch] and
// b[n, ch] = bias[ch] - mean_g * a[n, ch].  (A warp a group, as in
// merge_groups, chains chunks / 32 dependent merges a lane; here a thread
// chains chunks / 256.)
constexpr int GN_AFFINE_THREADS = 256;

__global__ void __launch_bounds__(GN_AFFINE_THREADS)
gn_affine_kernel(const float* __restrict__ part, const float* __restrict__ scale,
                 const float* __restrict__ bias, float* __restrict__ a, float* __restrict__ b,
                 int c, int groups, int chunks, float eps) {
  __shared__ float red[3 * (GN_AFFINE_THREADS / 32)];  // (count, mean, M2) per warp
  const int g = blockIdx.x, n = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // chunk e's triple of group g: part[n, e, g]
  const float* src = part + (size_t(n) * chunks * groups + g) * 3;
  float cnt = 0.f, mean = 0.f, m2 = 0.f;
  for (int e = threadIdx.x; e < chunks; e += GN_AFFINE_THREADS) {
    const float* t = src + size_t(3) * e * groups;
    chan_merge(cnt, mean, m2, t[0], t[1], t[2]);
  }
  warp_merge(cnt, mean, m2);
  if (lane == 0) {
    red[3 * warp] = cnt;
    red[3 * warp + 1] = mean;
    red[3 * warp + 2] = m2;
  }
  __syncthreads();
  if (warp == 0) {
    const bool mine = lane < GN_AFFINE_THREADS / 32;
    cnt = mine ? red[3 * lane] : 0.f;
    mean = mine ? red[3 * lane + 1] : 0.f;
    m2 = mine ? red[3 * lane + 2] : 0.f;
    warp_merge(cnt, mean, m2);
    if (lane == 0) {
      red[0] = cnt;
      red[1] = mean;
      red[2] = m2;
    }
  }
  __syncthreads();
  const float rstd = rsqrtf(fmaxf(red[2] / red[0], 0.f) + eps);
  const int cpg = c / groups;
  for (int j = threadIdx.x; j < cpg; j += GN_AFFINE_THREADS) {
    const int ch = g * cpg + j;
    const float av = rstd * scale[ch];
    a[size_t(n) * c + ch] = av;
    b[size_t(n) * c + ch] = bias[ch] - red[1] * av;
  }
}

// Pass 1 over grid (chunks, n) into `part`; returns the cudaError_t.
template <typename T>
static cudaError_t launch_stats(const void* x, float* part, int n, int l, int c, int groups,
                                int rows_per_chunk, int slots, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const int threads = c / VEC * slots;
  if (threads > GN_MAX_C / VEC || threads < 32) return cudaErrorInvalidValue;
  auto stats = gn_stats_kernel<T>;
  const size_t stats_smem = sizeof(float) * 3 * size_t(slots) * c;
  cudaError_t err = set_smem(stats, stats_smem);
  if (err != cudaSuccess) return err;
  dim3 grid((l + rows_per_chunk - 1) / rows_per_chunk, n);
  stats<<<grid, threads, stats_smem, stream>>>(static_cast<const T*>(x), part, l, c, groups,
                                                rows_per_chunk, slots);
  return cudaGetLastError();
}

template <typename T>
static int launch_gn(const void* x, const float* scale, const float* bias, void* y,
                     float* part, int n, int l, int c, int groups, int rows_per_chunk,
                     int slots, float eps, int silu, cudaStream_t stream) {
  cudaError_t err = launch_stats<T>(x, part, n, l, c, groups, rows_per_chunk, slots, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int VEC = 16 / sizeof(T);
  dim3 grid((l + rows_per_chunk - 1) / rows_per_chunk, n);
  gn_apply_kernel<T><<<grid, c / VEC * slots, 0, stream>>>(
      static_cast<const T*>(x), part, scale, bias, static_cast<T*>(y), l, c, groups,
      rows_per_chunk, slots, eps, silu);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int launch_affine(const void* x, const float* scale, const float* bias, float* a,
                         float* b, float* part, int n, int l, int c, int groups,
                         int rows_per_chunk, int slots, float eps, cudaStream_t stream) {
  cudaError_t err = launch_stats<T>(x, part, n, l, c, groups, rows_per_chunk, slots, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  gn_affine_kernel<<<dim3(groups, n), GN_AFFINE_THREADS, 0, stream>>>(
      part, scale, bias, a, b, c, groups, (l + rows_per_chunk - 1) / rows_per_chunk, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace st2v

// x, y: (n, l, c) in dtype (0 = float32, 1 = bfloat16); scale, bias: (c,) f32;
// part: f32 scratch of n * chunks * groups * 3, chunks = ceil(l / rows_per_chunk).
// A block is c / (16 / itemsize) * slots threads, 32 to 4096 / (16 / itemsize).  Requires
// c % 8 == 0, c <= 4096, c % groups == 0, groups <= 256.
extern "C" int st2v_fused_group_norm(const void* x, const float* scale, const float* bias,
                                     void* y, float* part, int n, int l, int c, int groups,
                                     int rows_per_chunk, int slots, float eps, int silu,
                                     int dtype, void* stream) {
  using namespace st2v;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || n > 65535 || l <= 0 || c <= 0 || c % 8 != 0 || c > GN_MAX_C || groups <= 0 ||
      groups > GN_MAX_GROUPS || c % groups != 0 || rows_per_chunk <= 0 || slots <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1) return launch_gn<bf16>(x, scale, bias, y, part, n, l, c, groups, rows_per_chunk, slots, eps, silu, s);
  if (dtype == 0) return launch_gn<float>(x, scale, bias, y, part, n, l, c, groups, rows_per_chunk, slots, eps, silu, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The statistics alone: pass 1 over x (n, l, c) in dtype, then the merge into
// the f32 affine a, b (n, c) of GroupNorm(x) = x * a + b; scale, bias: (c,) f32;
// part, rows_per_chunk, slots and the limits as st2v_fused_group_norm's.
extern "C" int st2v_group_norm_affine(const void* x, const float* scale, const float* bias,
                                      float* a, float* b, float* part, int n, int l, int c,
                                      int groups, int rows_per_chunk, int slots, float eps,
                                      int dtype, void* stream) {
  using namespace st2v;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || n > 65535 || l <= 0 || c <= 0 || c % 8 != 0 || c > GN_MAX_C || groups <= 0 ||
      groups > GN_MAX_GROUPS || c % groups != 0 || rows_per_chunk <= 0 || slots <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1) return launch_affine<bf16>(x, scale, bias, a, b, part, n, l, c, groups, rows_per_chunk, slots, eps, s);
  if (dtype == 0) return launch_affine<float>(x, scale, bias, a, b, part, n, l, c, groups, rows_per_chunk, slots, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
