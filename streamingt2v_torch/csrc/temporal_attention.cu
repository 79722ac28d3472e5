// K6: per-pixel attention over frames on the spatial-major layout, for Hopper.
//
// Replaces the Pallas kernel `_kernel` (streamingt2v_tpu/ops/
// temporal_attention.py:43, launched from `_temporal_attention_pallas`).
// q is (B*Tq, S, H*D) and k, v are (B*Tkv, S, H*D): for one batch row b and
// one frame t the (s, h, d) suffix is contiguous, so a (pixel, head) pair p =
// s*H + h owns D contiguous elements in every frame, and its frames sit
// S*H*D elements apart.  Every pair attends over its own frames:
//
//   o[t, p] = softmax_j(q[t, p] . k[j, p] / sqrt(D)) v[j, p]
//
// A block owns P consecutive pairs of one batch row.  It stages their Tkv key
// and value rows in shared memory as f32 (each frame's P*D run is one
// contiguous read), then a warp takes one (pair, query frame) row at a time:
// the lanes hold keys j and j+32 for the scores (the query row is broadcast
// from shared memory, the key rows are padded to D+1 floats so the lanes hit
// distinct banks), the softmax runs in exp2 with the scale*log2(e) folded
// into q, and the lanes hold output columns for P.V.  Scores, probabilities
// and the f32 output never reach device memory and nothing is transposed, in
// device memory or out of it.
//
// What bounds it on the H100: bytes.  At the stage-2 level-0 geometry
// (38 frames, 14400 pixels, 5 heads of 64) it moves q, k, v and o once each,
// about 1.4 GB in bf16, for about 27 GFLOP of scores and P.V: about 20 flops
// per byte, far below the tensor-core ridge, so the products run on the FMA
// units in f32.  Takes T <= 64 frames on either side and D <= 128.
#include "common.cuh"

namespace st2v {

constexpr int TA_THREADS = 256;
constexpr int TA_WARPS = TA_THREADS / 32;
constexpr int TA_MAX_T = 64;

__host__ __device__ inline size_t ta_smem_bytes(int pairs, int tkv, int d) {
  return sizeof(float) * (size_t(pairs) * tkv * (2 * d + 1) + size_t(TA_WARPS) * (d + TA_MAX_T));
}

template <typename T>
__global__ void __launch_bounds__(TA_THREADS)
temporal_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, T* __restrict__ o, int tq, int tkv, int sh,
                          int d, int pairs, float scale_log2) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.y;
  const int p0 = blockIdx.x * pairs;
  const int np = min(pairs, sh - p0);
  const int ldk = d + 1;
  float* Ks = smem;                                  // [pair][j][d + 1]
  float* Vs = Ks + size_t(pairs) * tkv * ldk;        // [pair][j][d]
  float* Qs = Vs + size_t(pairs) * tkv * d + warp * (d + TA_MAX_T);  // this warp's q row
  float* Ps = Qs + d;                                // this warp's probabilities

  const int run = np * d;  // contiguous elements of the block's pairs in one frame
  for (int i = tid; i < tkv * run; i += TA_THREADS) {
    const int j = i / run, rem = i % run;
    const int pp = rem / d, dd = rem % d;
    const size_t src = (size_t(b) * tkv + j) * sh * d + size_t(p0) * d + rem;
    Ks[(size_t(pp) * tkv + j) * ldk + dd] = to_float(k[src]);
    Vs[(size_t(pp) * tkv + j) * d + dd] = to_float(v[src]);
  }
  __syncthreads();

  for (int item = warp; item < np * tq; item += TA_WARPS) {
    const int pp = item % np, t = item / np;
    const size_t row = ((size_t(b) * tq + t) * sh + p0 + pp) * d;
    for (int dd = lane; dd < d; dd += 32) Qs[dd] = to_float(q[row + dd]) * scale_log2;
    __syncwarp();
    const float* kp = Ks + size_t(pp) * tkv * ldk;
    float s0 = __int_as_float(0xff800000), s1 = s0;  // -inf
    if (lane < tkv) {
      float acc = 0.f;
      for (int dd = 0; dd < d; ++dd) acc = fmaf(Qs[dd], kp[lane * ldk + dd], acc);
      s0 = acc;
    }
    if (lane + 32 < tkv) {
      float acc = 0.f;
      for (int dd = 0; dd < d; ++dd) acc = fmaf(Qs[dd], kp[(lane + 32) * ldk + dd], acc);
      s1 = acc;
    }
    const float m = warp_max(fmaxf(s0, s1));
    const float e0 = lane < tkv ? exp2f(s0 - m) : 0.f;
    const float e1 = lane + 32 < tkv ? exp2f(s1 - m) : 0.f;
    const float inv = 1.f / warp_sum(e0 + e1);
    Ps[lane] = e0;
    Ps[lane + 32] = e1;
    __syncwarp();
    const float* vp = Vs + size_t(pp) * tkv * d;
    for (int dd = lane; dd < d; dd += 32) {
      float acc = 0.f;
      for (int j = 0; j < tkv; ++j) acc = fmaf(Ps[j], vp[j * d + dd], acc);
      o[row + dd] = from_float<T>(acc * inv);
    }
    __syncwarp();  // Qs and Ps are rewritten by the warp's next row
  }
}

template <typename T>
static int launch_ta(const void* q, const void* k, const void* v, void* o, int batch, int tq,
                     int tkv, int sh, int d, int pairs, float scale_log2,
                     cudaStream_t stream) {
  const size_t smem = ta_smem_bytes(pairs, tkv, d);
  auto kernel = temporal_attention_kernel<T>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((sh + pairs - 1) / pairs, batch);
  kernel<<<grid, TA_THREADS, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                             static_cast<const T*>(v), static_cast<T*>(o), tq,
                                             tkv, sh, d, pairs, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace st2v

// q, o: (batch * tq, S, H * d); k, v: (batch * tkv, S, H * d), sh = S * H.
// `pairs` (pixel, head) pairs per block.  dtype: 0 = float32, 1 = bfloat16.
// Requires tq, tkv <= 64 and d <= 128.  Returns a cudaError_t (0 = launched).
extern "C" int st2v_temporal_attention(const void* q, const void* k, const void* v, void* o,
                                       int batch, int tq, int tkv, int sh, int d, int pairs,
                                       int dtype, float scale_log2, void* stream) {
  using namespace st2v;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || batch > 65535 || tq <= 0 || tq > TA_MAX_T || tkv <= 0 || tkv > TA_MAX_T ||
      sh <= 0 || d <= 0 || d > 128 || pairs <= 0 || ta_smem_bytes(pairs, tkv, d) > 227 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1) return launch_ta<bf16>(q, k, v, o, batch, tq, tkv, sh, d, pairs, scale_log2, s);
  if (dtype == 0) return launch_ta<float>(q, k, v, o, batch, tq, tkv, sh, d, pairs, scale_log2, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
