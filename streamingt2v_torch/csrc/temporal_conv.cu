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
// What bounds it on the H100: it is an implicit GEMM, rows (b, t, s), columns
// C_out, contraction kt x C, at 2*kt*C*C_out flops per row against 2*(C +
// 2*C_out) bytes (with res), so the tensor cores at the UNet's 320-1280
// channels and the memory at the VAE's 128.
//
// The bf16 body.  A block owns one batch row, 128 positions and 64 output
// channels for every frame, and walks the input frames in order, each in
// 64-channel steps.  Each staged input tile feeds all kt taps: the block keeps
// kt output-frame accumulators in registers (acc[j] holds output frame
// f - kt/2 + j while input frame f is staged, so tap k adds into acc[kt-1-k]),
// and when frame f's last step is done, output frame f - kt/2 is complete: its
// epilogue stores it from registers and the window rolls by one.  So each
// input frame is read once per block, no halo frame is read again, and any T
// works.  The zero padding is a skipped tap.  Eight warps, 4 x 2, each own a
// 32 x 32 piece of every accumulator (`mma.sync` with `ldmatrix`; wgmma is not
// used).  A step's x tile and its chunk's kt W taps arrive by 16-byte
// `cp.async` into a ring of three stages, two steps ahead of the products; the
// GroupNorm+SiLU prologue runs once per element per block, in place in shared
// memory: each thread transforms the elements it copied itself, one step
// ahead, so the step's one barrier publishes them and it costs no other.  The
// 128 x 64 tile keeps the W taps, which every block streams again for every
// frame, at 24 KB of the 40 KB a step copies.  The wrapper pads C and W's
// C_out rows to multiples of 8 with zeros, so every copy is 16 bytes.
//
// The f32 body (full f32 on the FMA units) is the first, simple design: a
// block owns 16 positions and 32 output channels, reads its input element by
// element in 32-channel chunks and re-reads the kt - 1 halo frames per group
// of 32 output frames.
#include "common.cuh"

namespace st2v {

// ---- bf16: the implicit-GEMM body ----
constexpr int TCB_THREADS = 256;
constexpr int TCB_BM = 128;           // positions per block: the rows of one frame's tile
constexpr int TCB_BN = 64;            // output channels per block
constexpr int TCB_BK = 64;            // input channels per step
constexpr int TCB_STAGES = 3;
constexpr int TCB_LDX = TCB_BK + 8;   // smem row strides: conflict-free ldmatrix
constexpr int TCB_LDW = TCB_BN + 8;

template <int KT>
struct TCBLayout {
  static constexpr int X_ELEMS = TCB_BM * TCB_LDX;        // [position][channel]
  static constexpr int W_ELEMS = KT * TCB_BK * TCB_LDW;   // [tap][channel][out channel]
  static constexpr int STAGE = X_ELEMS + W_ELEMS;
  static constexpr size_t SMEM = TCB_STAGES * STAGE * sizeof(bf16);
};

__device__ __forceinline__ float silu_fast(float y) {
  float th;
  asm("tanh.approx.f32 %0, %1;" : "=f"(th) : "f"(0.5f * y));
  return 0.5f * y * (1.f + th);  // y * sigmoid(y)
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

template <int KT>
__global__ void __launch_bounds__(TCB_THREADS)
temporal_conv_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                          const float* __restrict__ bias, const float* __restrict__ pre_a,
                          const float* __restrict__ pre_b, const bf16* __restrict__ res,
                          const float* __restrict__ res_w, bf16* __restrict__ out, int t_len,
                          int s_len, int c, int c_out) {
  typedef TCBLayout<KT> L;
  constexpr int LO = KT / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int mi8 = lane >> 3, r8 = lane & 7;   // ldmatrix: matrix and row this lane addresses
  const int wm = warp & 3, wn = warp >> 2;    // this warp's 32 rows and 32 columns
  const int co0 = blockIdx.x * TCB_BN, s0 = blockIdx.y * TCB_BM, b = blockIdx.z;
  const int ldw = (c_out + 7) & ~7;           // W's rows, padded by the wrapper
  const int chunks = (c + TCB_BK - 1) / TCB_BK;
  const int steps = t_len * chunks;
  const bool active = co0 + wn * 32 < c_out;  // the warp has output columns

  // a step's x tile (frame f, one channel chunk) and the chunk's kt W taps,
  // by 16-byte cp.async into the step's stage, zero-filled past S, C, C_out
  auto load = [&](int step) {
    if (step < steps) {
      bf16* Xs = smem + (step % TCB_STAGES) * L::STAGE;
      bf16* Ws = Xs + L::X_ELEMS;
      const int f = step / chunks, kc = (step % chunks) * TCB_BK;
#pragma unroll
      for (int it = 0; it < TCB_BM * (TCB_BK / 8) / TCB_THREADS; ++it) {
        const int i = tid + it * TCB_THREADS;
        const int r = i >> 3, col = (i & 7) * 8;
        const bool ok = s0 + r < s_len && kc + col < c;
        cp_async_16(Xs + r * TCB_LDX + col,
                    ok ? x + ((size_t(b) * t_len + f) * s_len + s0 + r) * c + kc + col : x, ok);
      }
#pragma unroll
      for (int it = 0; it < KT * TCB_BK * (TCB_BN / 8) / TCB_THREADS; ++it) {
        const int i = tid + it * TCB_THREADS;
        const int k = i / (TCB_BK * TCB_BN / 8), rem = i % (TCB_BK * TCB_BN / 8);
        const int r = rem / (TCB_BN / 8), col = (rem % (TCB_BN / 8)) * 8;
        const bool ok = kc + r < c && co0 + col < ldw;
        cp_async_16(Ws + (k * TCB_BK + r) * TCB_LDW + col,
                    ok ? w + (size_t(k) * c + kc + r) * ldw + co0 + col : w, ok);
      }
    }
    cp_async_commit();  // one group per step, empty past the end
  };
  // the GroupNorm+SiLU prologue, in place on the x elements this thread
  // copied (visible to it after its own wait; the next barrier publishes them)
  auto prologue = [&](int step) {
    if (pre_a == nullptr || step >= steps) return;
    bf16* Xs = smem + (step % TCB_STAGES) * L::STAGE;
    const int kc = (step % chunks) * TCB_BK;
#pragma unroll
    for (int it = 0; it < TCB_BM * (TCB_BK / 8) / TCB_THREADS; ++it) {
      const int i = tid + it * TCB_THREADS;
      const int r = i >> 3, col = (i & 7) * 8, ch = kc + col;
      if (ch >= c) continue;  // zero-filled channels stay zero
      const float4* pa = reinterpret_cast<const float4*>(pre_a + size_t(b) * c + ch);
      const float4* pb = reinterpret_cast<const float4*>(pre_b + size_t(b) * c + ch);
      const float4 a0 = __ldg(pa), a1 = __ldg(pa + 1), b0 = __ldg(pb), b1 = __ldg(pb + 1);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
      uint4 raw = *reinterpret_cast<const uint4*>(Xs + r * TCB_LDX + col);
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 fv = __bfloat1622float2(h[e]);
        h[e] = __floats2bfloat162_rn(silu_fast(fmaf(fv.x, av[2 * e], bv[2 * e])),
                                     silu_fast(fmaf(fv.y, av[2 * e + 1], bv[2 * e + 1])));
      }
      *reinterpret_cast<uint4*>(Xs + r * TCB_LDX + col) = raw;
    }
  };

  float acc[KT][2][4][4];  // [window slot][16-row tile][8-column tile][fragment]
#pragma unroll
  for (int j = 0; j < KT; ++j)
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n) acc[j][m][n][0] = acc[j][m][n][1] = acc[j][m][n][2] = acc[j][m][n][3] = 0.f;
  float bias_r[4][2];
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int co = co0 + wn * 32 + n * 8 + 2 * t4 + e;
      bias_r[n][e] = co < c_out ? bias[co] : 0.f;
    }
  const bool pairs = (c_out & 1) == 0;

  // store output frame `tt` from acc[0], then roll the window by one
  auto retire = [&](int tt) {
    if (tt >= 0) {
      const float rw = res != nullptr ? res_w[size_t(b) * t_len + tt] : 0.f;
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int s = s0 + wm * 32 + m * 16 + g + 8 * half;
          if (s >= s_len) continue;
          const size_t row = ((size_t(b) * t_len + tt) * s_len + s) * c_out;
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            const int co = co0 + wn * 32 + n * 8 + 2 * t4;
            float y0 = acc[0][m][n][2 * half] + bias_r[n][0];
            float y1 = acc[0][m][n][2 * half + 1] + bias_r[n][1];
            if (pairs && co < c_out) {
              if (res != nullptr) {
                const float2 rv = __bfloat1622float2(
                    *reinterpret_cast<const __nv_bfloat162*>(res + row + co));
                y0 = rv.x + rw * y0;
                y1 = rv.y + rw * y1;
              }
              *reinterpret_cast<__nv_bfloat162*>(out + row + co) = __floats2bfloat162_rn(y0, y1);
            } else if (!pairs) {
              if (co < c_out)
                out[row + co] = __float2bfloat16(
                    res != nullptr ? __bfloat162float(res[row + co]) + rw * y0 : y0);
              if (co + 1 < c_out)
                out[row + co + 1] = __float2bfloat16(
                    res != nullptr ? __bfloat162float(res[row + co + 1]) + rw * y1 : y1);
            }
          }
        }
    }
#pragma unroll
    for (int j = 0; j + 1 < KT; ++j)
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][m][n][e] = acc[j + 1][m][n][e];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n)
        acc[KT - 1][m][n][0] = acc[KT - 1][m][n][1] = acc[KT - 1][m][n][2] = acc[KT - 1][m][n][3] = 0.f;
  };

  load(0);
  load(1);
  cp_async_wait_one();  // step 0's copies landed
  prologue(0);
  for (int i = 0; i < steps; ++i) {
    const int f = i / chunks, kc = (i - f * chunks) * TCB_BK;
    const bf16* Xs = smem + (i % TCB_STAGES) * L::STAGE;
    const bf16* Ws = Xs + L::X_ELEMS;
    __syncthreads();      // step i's stage is complete; step i-1's is no longer read
    load(i + 2);          // into step i-1's stage
    cp_async_wait_one();  // step i+1's copies landed (step i+2's are in flight)
    prologue(i + 1);
    if (active) {
#pragma unroll
      for (int ks = 0; ks < TCB_BK / 16; ++ks) {
        if (ks * 16 >= c - kc) break;  // past C (zero-filled up to the next 16)
        uint32_t a[2][4];
#pragma unroll
        for (int m = 0; m < 2; ++m)
          ldmatrix_x4(a[m], Xs + (wm * 32 + m * 16 + (lane & 15)) * TCB_LDX + ks * 16 +
                                (lane >> 4) * 8);
#pragma unroll
        for (int k = 0; k < KT; ++k) {
          const int tout = f + LO - k;  // the output frame tap k of frame f feeds
          if (tout < 0 || tout >= t_len) continue;
          uint32_t bw[4][2];
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            uint32_t r4[4];  // column tiles 2np, 2np+1; channels ks*16 .. +15
            ldmatrix_x4_trans(r4, Ws + (k * TCB_BK + ks * 16 + (mi8 & 1) * 8 + r8) * TCB_LDW +
                                      wn * 32 + np * 16 + (mi8 >> 1) * 8);
            bw[2 * np][0] = r4[0];
            bw[2 * np][1] = r4[1];
            bw[2 * np + 1][0] = r4[2];
            bw[2 * np + 1][1] = r4[3];
          }
#pragma unroll
          for (int m = 0; m < 2; ++m)
#pragma unroll
            for (int n = 0; n < 4; ++n) mma_bf16(acc[KT - 1 - k][m][n], a[m], bw[n][0], bw[n][1]);
        }
      }
    }
    if (kc + TCB_BK >= c) {  // frame f is done: output frame f - LO is complete
      retire(f - LO);
      if (f == t_len - 1) {
#pragma unroll
        for (int e = 1; e <= LO; ++e) retire(f - LO + e);
      }
    }
  }
  cp_async_wait_all();
}

template <int KT>
static int launch_tc_bf16(const void* x, const void* w, const float* bias, const float* pre_a,
                          const float* pre_b, const void* res, const float* res_w, void* out,
                          int batch, int t_len, int s_len, int c, int c_out,
                          cudaStream_t stream) {
  auto kernel = temporal_conv_bf16_kernel<KT>;
  cudaError_t err = set_smem(kernel, TCBLayout<KT>::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((c_out + TCB_BN - 1) / TCB_BN, (s_len + TCB_BM - 1) / TCB_BM, batch);
  kernel<<<grid, TCB_THREADS, TCBLayout<KT>::SMEM, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), bias, pre_a, pre_b,
      static_cast<const bf16*>(res), res_w, static_cast<bf16*>(out), t_len, s_len, c, c_out);
  return static_cast<int>(cudaGetLastError());
}

// ---- f32: the simple body ----
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

// dtype: 0 = float32, 1 = bfloat16.  w is (kt, C, C_out) for f32 and
// (kt, C, C_out rounded up to 8) for bf16, with C % 8 == 0 (the wrapper pads
// both with zeros); pre_a/pre_b are (B, C) f32 or null; res (B, T, S, C_out)
// and res_w (B, T) f32 or null.  Requires odd kt <= 5; any T >= 1.
extern "C" int st2v_temporal_conv(const void* x, const void* w, const float* bias,
                                  const float* pre_a, const float* pre_b, const void* res,
                                  const float* res_w, void* out, int batch, int t_len,
                                  int s_len, int c, int c_out, int kt, int dtype,
                                  void* stream) {
  using namespace st2v;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || batch > 65535 || s_len <= 0 || c <= 0 || c_out <= 0 || kt % 2 != 1 ||
      kt > 5 || t_len <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1) {
    if (c % 8 != 0 || (s_len + TCB_BM - 1) / TCB_BM > 65535)
      return static_cast<int>(cudaErrorInvalidValue);
    if (kt == 1) return launch_tc_bf16<1>(x, w, bias, pre_a, pre_b, res, res_w, out, batch, t_len, s_len, c, c_out, s);
    if (kt == 3) return launch_tc_bf16<3>(x, w, bias, pre_a, pre_b, res, res_w, out, batch, t_len, s_len, c, c_out, s);
    return launch_tc_bf16<5>(x, w, bias, pre_a, pre_b, res, res_w, out, batch, t_len, s_len, c, c_out, s);
  }
  if (dtype == 0 && (s_len + TC_BS - 1) / TC_BS <= 65535)
    return launch_tc<float>(x, w, bias, pre_a, pre_b, res, res_w, out, batch, t_len, s_len, c, c_out, kt, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
