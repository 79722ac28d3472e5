// K4: (kt,1,1) temporal convolution over (B, T, S, C) for Hopper.
//
// Replaces the Pallas kernel `_conv_body` and its four variants `_kernel`,
// `_kernel_res`, `_kernel_pre`, `_kernel_pre_res` (streamingt2v_tpu/ops/
// temporal_conv.py:29-96, launched from `_tc_pallas`):
//
//   xin = silu(x * a[b] + b[b])           (optional GroupNorm+SiLU prologue)
//   y[t] = sum_k xin[t + k - kt/2] W[k] + bias   (zero SAME padding on T)
//   out = res + res_w[b, t] * y           (optional scaled-residual epilogue)
//
// One block owns one batch row, 16 spatial positions and 32 output channels
// for every frame.  With 16 positions per frame, a 16-row tile of the product
// is exactly one frame, so the time shift of tap k is a choice of which frame
// tile feeds the product and the zero padding is a skipped tap.  The frames
// are taken in groups of 32 output frames, whose f32 accumulators stay in
// registers; a group reads its 32 + kt - 1 input frames (the kt - 1 halo
// frames are read again by the next group) in 32-channel chunks with the
// prologue applied on the way into shared memory, beside the kt weight taps of
// the chunk.  So T is bounded by nothing but the caller's memory.  The op
// moves x and out once each and is bandwidth-bound at the decoder's
// 128-channel levels; the UNet levels (320-1280 channels) re-read each input
// tile once per 32-channel output tile, from L2.
#include "common.cuh"

namespace st2v {

constexpr int TC_THREADS = 256;
constexpr int TC_WARPS = TC_THREADS / 32;
constexpr int TC_BS = 16;    // spatial positions per block (one mma row tile)
constexpr int TC_BCO = 32;   // output channels per block
constexpr int TC_KC = 32;    // input-channel chunk
constexpr int TC_TG = 32;    // output frames per group
constexpr int TC_MAXT = TC_TG * (TC_BCO / 8) / TC_WARPS;  // accumulator tiles per warp

template <typename T>
struct TCLayout {
  static constexpr int LD = TC_KC + RowPad<T>::value;
  static size_t smem_bytes(int frames_held, int kt) {
    return sizeof(T) * (size_t(frames_held) * TC_BS + size_t(kt) * TC_BCO) * LD;
  }
};

template <typename T>
__global__ void __launch_bounds__(TC_THREADS)
temporal_conv_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     const float* __restrict__ bias, const float* __restrict__ pre_a,
                     const float* __restrict__ pre_b, const T* __restrict__ res,
                     const float* __restrict__ res_w, T* __restrict__ out, int t_len,
                     int s_len, int c, int c_out, int kt) {
  typedef TCLayout<T> L;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int held = min(t_len, TC_TG) + kt - 1;   // input frames per group
  T* Xs = reinterpret_cast<T*>(smem_raw);        // [frame - f0][s][c chunk]
  T* Ws = Xs + held * TC_BS * L::LD;             // [k][co][c chunk]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int co0 = blockIdx.x * TC_BCO;
  const int s0 = blockIdx.y * TC_BS;
  const int b = blockIdx.z;
  const int lo = kt / 2;

  for (int tg0 = 0; tg0 < t_len; tg0 += TC_TG) {
    const int tiles = min(TC_TG, t_len - tg0) * (TC_BCO / 8);
    // input frames [f_lo, f_hi) feed this group; Xs row 0 is frame f0
    const int f0 = tg0 - lo;
    const int f_lo = max(0, f0);
    const int f_hi = min(t_len, tg0 + TC_TG + kt - 1 - lo);
    float acc[TC_MAXT][4];
#pragma unroll
    for (int j = 0; j < TC_MAXT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

    for (int kc = 0; kc < c; kc += TC_KC) {
      __syncthreads();  // the previous chunk's (or group's) tiles are no longer read
      for (int i = tid; i < (f_hi - f_lo) * TC_BS * TC_KC; i += TC_THREADS) {
        const int tt = f_lo + i / (TC_BS * TC_KC);
        const int rem = i % (TC_BS * TC_KC);
        const int sl = rem / TC_KC, cc = rem % TC_KC;
        const int s = s0 + sl, ch = kc + cc;
        T val = from_float<T>(0.f);
        if (s < s_len && ch < c) {
          val = x[((size_t(b) * t_len + tt) * s_len + s) * c + ch];
          if (pre_a != nullptr) {
            float f = to_float(val) * pre_a[size_t(b) * c + ch] + pre_b[size_t(b) * c + ch];
            f = f / (1.f + expf(-f));
            val = from_float<T>(f);
          }
        }
        Xs[((tt - f0) * TC_BS + sl) * L::LD + cc] = val;
      }
      for (int i = tid; i < kt * TC_KC * TC_BCO; i += TC_THREADS) {
        const int k = i / (TC_KC * TC_BCO);
        const int rem = i % (TC_KC * TC_BCO);
        const int cc = rem / TC_BCO, co = rem % TC_BCO;
        T val = from_float<T>(0.f);
        if (kc + cc < c && co0 + co < c_out) val = w[(size_t(k) * c + kc + cc) * c_out + co0 + co];
        Ws[(k * TC_BCO + co) * L::LD + cc] = val;
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < TC_MAXT; ++j) {
        const int ti = warp + j * TC_WARPS;
        if (ti < tiles) {
          const int tt = tg0 + ti / (TC_BCO / 8), nt = ti % (TC_BCO / 8);
          for (int k = 0; k < kt; ++k) {
            const int ts = tt + k - lo;
            if (ts >= 0 && ts < t_len)
              mma_tile(acc[j], Xs + (ts - f0) * TC_BS * L::LD, L::LD,
                       Ws + (k * TC_BCO + nt * 8) * L::LD, L::LD, TC_KC);
          }
        }
      }
    }

#pragma unroll
    for (int j = 0; j < TC_MAXT; ++j) {
      const int ti = warp + j * TC_WARPS;
      if (ti < tiles) {
        const int tt = tg0 + ti / (TC_BCO / 8), nt = ti % (TC_BCO / 8);
        const float rw = res != nullptr ? res_w[size_t(b) * t_len + tt] : 0.f;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int s = s0 + g + 8 * half;
          if (s >= s_len) continue;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int co = co0 + nt * 8 + 2 * t4 + e;
            if (co >= c_out) continue;
            const size_t idx = ((size_t(b) * t_len + tt) * s_len + s) * c_out + co;
            float y = acc[j][2 * half + e] + bias[co];
            if (res != nullptr) y = to_float(res[idx]) + rw * y;
            out[idx] = from_float<T>(y);
          }
        }
      }
    }
  }
}

template <typename T>
static int launch_tc(const void* x, const void* w, const float* bias, const float* pre_a,
                     const float* pre_b, const void* res, const float* res_w, void* out,
                     int batch, int t_len, int s_len, int c, int c_out, int kt,
                     cudaStream_t stream) {
  const size_t smem = TCLayout<T>::smem_bytes((t_len < TC_TG ? t_len : TC_TG) + kt - 1, kt);
  auto kernel = temporal_conv_kernel<T>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((c_out + TC_BCO - 1) / TC_BCO, (s_len + TC_BS - 1) / TC_BS, batch);
  kernel<<<grid, TC_THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), bias, pre_a, pre_b,
      static_cast<const T*>(res), res_w, static_cast<T*>(out), t_len, s_len, c, c_out, kt);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace st2v

// dtype: 0 = float32, 1 = bfloat16.  w is (kt, C, C_out); pre_a/pre_b are
// (B, C) f32 or null; res (B, T, S, C_out) and res_w (B, T) f32 or null.
// Requires odd kt <= 5; any T >= 1.
extern "C" int st2v_temporal_conv(const void* x, const void* w, const float* bias,
                                  const float* pre_a, const float* pre_b, const void* res,
                                  const float* res_w, void* out, int batch, int t_len,
                                  int s_len, int c, int c_out, int kt, int dtype,
                                  void* stream) {
  using namespace st2v;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || batch > 65535 || s_len <= 0 || c <= 0 || c_out <= 0 || kt % 2 != 1 ||
      kt > 5 || t_len <= 0 || (s_len + TC_BS - 1) / TC_BS > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1) return launch_tc<bf16>(x, w, bias, pre_a, pre_b, res, res_w, out, batch, t_len, s_len, c, c_out, kt, s);
  if (dtype == 0) return launch_tc<float>(x, w, bias, pre_a, pre_b, res, res_w, out, batch, t_len, s_len, c, c_out, kt, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
