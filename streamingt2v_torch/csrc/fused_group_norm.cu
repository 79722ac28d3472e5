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
// group sits at a large common offset.  Inside pass 1 every tile of rows is
// staged in shared memory as f32, its per-group mean taken first and its M2
// around that mean second, then merged into the block's running partial.
//
// What bounds it on the H100: bytes.  It reads x twice (once per pass) and
// writes the output once, 3 * N * L * C * itemsize in all, with nothing else
// of that size in between; the partials are N * chunks * G * 12 bytes.
#include "common.cuh"

namespace st2v {

constexpr int GN_THREADS = 256;
constexpr int GN_WARPS = GN_THREADS / 32;
constexpr int GN_TILE = 8192;      // f32 elements of one staged tile
constexpr int GN_MAX_GROUPS = 256;

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

template <typename T>
__global__ void __launch_bounds__(GN_THREADS)
gn_stats_kernel(const T* __restrict__ x, float* __restrict__ part, int l, int c, int groups,
                int rows_per_chunk, int chunks) {
  extern __shared__ __align__(16) float tile[];  // GN_TILE floats
  __shared__ float acc_n[GN_MAX_GROUPS], acc_mean[GN_MAX_GROUPS], acc_m2[GN_MAX_GROUPS];
  constexpr int VEC = 16 / sizeof(T);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int chunk = blockIdx.x, n = blockIdx.y;
  const int cpg = c / groups;
  const int tile_rows = max(1, GN_TILE / c);
  const int r0 = chunk * rows_per_chunk;
  const int r1 = min(l, r0 + rows_per_chunk);
  for (int g = tid; g < groups; g += GN_THREADS) acc_n[g] = acc_mean[g] = acc_m2[g] = 0.f;

  for (int rr = r0; rr < r1; rr += tile_rows) {
    const int nr = min(tile_rows, r1 - rr);
    const int elems = nr * c;
    const T* src = x + (size_t(n) * l + rr) * c;
    __syncthreads();  // the previous tile is no longer read
    for (int i = tid * VEC; i < elems; i += GN_THREADS * VEC) {
      const uint4 raw = *reinterpret_cast<const uint4*>(src + i);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < VEC; ++j) tile[i + j] = to_float(e[j]);
    }
    __syncthreads();
    const int count = nr * cpg;
    for (int g = warp; g < groups; g += GN_WARPS) {
      float sum = 0.f;
      for (int e = lane; e < count; e += 32) sum += tile[(e / cpg) * c + g * cpg + e % cpg];
      const float mean = warp_sum(sum) / count;
      float m2 = 0.f;
      for (int e = lane; e < count; e += 32) {
        const float d = tile[(e / cpg) * c + g * cpg + e % cpg] - mean;
        m2 += d * d;
      }
      m2 = warp_sum(m2);
      if (lane == 0) chan_merge(acc_n[g], acc_mean[g], acc_m2[g], float(count), mean, m2);
    }
  }
  __syncthreads();
  float* out = part + (size_t(n) * chunks + chunk) * groups * 3;
  for (int g = tid; g < groups; g += GN_THREADS) {
    out[3 * g] = acc_n[g];
    out[3 * g + 1] = acc_mean[g];
    out[3 * g + 2] = acc_m2[g];
  }
}

template <typename T>
__global__ void __launch_bounds__(GN_THREADS)
gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ part,
                const float* __restrict__ scale, const float* __restrict__ bias,
                T* __restrict__ y, int l, int c, int groups, int rows_per_chunk, int chunks,
                float eps, int silu) {
  extern __shared__ __align__(16) float affine[];  // a[c] then b[c]
  __shared__ float g_mean[GN_MAX_GROUPS], g_rstd[GN_MAX_GROUPS];
  constexpr int VEC = 16 / sizeof(T);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int chunk = blockIdx.x, n = blockIdx.y;
  const int cpg = c / groups;

  // merge row n's partials: lane j takes chunks j, j+32, ..., then the warp
  const float* row_part = part + size_t(n) * chunks * groups * 3;
  for (int g = warp; g < groups; g += GN_WARPS) {
    float cnt = 0.f, mean = 0.f, m2 = 0.f;
    for (int j = lane; j < chunks; j += 32) {
      const float* p = row_part + (size_t(j) * groups + g) * 3;
      chan_merge(cnt, mean, m2, p[0], p[1], p[2]);
    }
    for (int o = 16; o > 0; o >>= 1) {
      const float cn = __shfl_xor_sync(0xffffffffu, cnt, o);
      const float mn = __shfl_xor_sync(0xffffffffu, mean, o);
      const float mm = __shfl_xor_sync(0xffffffffu, m2, o);
      chan_merge(cnt, mean, m2, cn, mn, mm);
    }
    if (lane == 0) {
      g_mean[g] = mean;
      g_rstd[g] = rsqrtf(fmaxf(m2 / cnt, 0.f) + eps);
    }
  }
  __syncthreads();
  float* a = affine;
  float* b = affine + c;
  for (int ch = tid; ch < c; ch += GN_THREADS) {
    const int g = ch / cpg;
    a[ch] = g_rstd[g] * scale[ch];
    b[ch] = bias[ch] - g_mean[g] * a[ch];
  }
  __syncthreads();

  const int r0 = chunk * rows_per_chunk;
  const int r1 = min(l, r0 + rows_per_chunk);
  const size_t base = (size_t(n) * l + r0) * c;
  const size_t elems = size_t(max(0, r1 - r0)) * c;
  for (size_t i = size_t(tid) * VEC; i < elems; i += size_t(GN_THREADS) * VEC) {
    const uint4 raw = *reinterpret_cast<const uint4*>(x + base + i);
    const T* e = reinterpret_cast<const T*>(&raw);
    const int ch = static_cast<int>(i % c);  // c % VEC == 0: no row wrap inside a vector
    uint4 packed;
    T* o = reinterpret_cast<T*>(&packed);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float v = to_float(e[j]) * a[ch + j] + b[ch + j];
      if (silu) v = v / (1.f + expf(-v));
      o[j] = from_float<T>(v);
    }
    *reinterpret_cast<uint4*>(y + base + i) = packed;
  }
}

template <typename T>
static int launch_gn(const void* x, const float* scale, const float* bias, void* y,
                     float* part, int n, int l, int c, int groups, int rows_per_chunk,
                     int chunks, float eps, int silu, cudaStream_t stream) {
  auto stats = gn_stats_kernel<T>;
  auto apply = gn_apply_kernel<T>;
  const size_t stats_smem = sizeof(float) * GN_TILE;
  const size_t apply_smem = sizeof(float) * 2 * size_t(c);
  cudaError_t err = set_smem(stats, stats_smem);
  if (err == cudaSuccess) err = set_smem(apply, apply_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(chunks, n);
  stats<<<grid, GN_THREADS, stats_smem, stream>>>(static_cast<const T*>(x), part, l, c, groups,
                                                   rows_per_chunk, chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  apply<<<grid, GN_THREADS, apply_smem, stream>>>(static_cast<const T*>(x), part, scale, bias,
                                                   static_cast<T*>(y), l, c, groups,
                                                   rows_per_chunk, chunks, eps, silu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace st2v

// x, y: (n, l, c) in dtype (0 = float32, 1 = bfloat16); scale, bias: (c,) f32;
// part: f32 scratch of n * chunks * groups * 3, chunks = ceil(l / rows_per_chunk).
// Requires c % 8 == 0, c <= 4096, c % groups == 0, groups <= 256.
extern "C" int st2v_fused_group_norm(const void* x, const float* scale, const float* bias,
                                     void* y, float* part, int n, int l, int c, int groups,
                                     int rows_per_chunk, float eps, int silu, int dtype,
                                     void* stream) {
  using namespace st2v;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || n > 65535 || l <= 0 || c <= 0 || c % 8 != 0 || c > 4096 || groups <= 0 ||
      groups > GN_MAX_GROUPS || c % groups != 0 || rows_per_chunk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = (l + rows_per_chunk - 1) / rows_per_chunk;
  if (dtype == 1) return launch_gn<bf16>(x, scale, bias, y, part, n, l, c, groups, rows_per_chunk, chunks, eps, silu, s);
  if (dtype == 0) return launch_gn<float>(x, scale, bias, y, part, n, l, c, groups, rows_per_chunk, chunks, eps, silu, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
