// K3: fused GEGLU feed-forward for Hopper.
//
// Replaces the Pallas kernel `_ff_kernel` (streamingt2v_tpu/ops/fused_ff.py:65,
// launched from `_geglu_pallas`):
//
//   [a | b] = LN(x) W1^T + b1,   out = (a * gelu_erf(b)) W2^T + b2 (+ x)
//
// One block owns BN rows.  It normalises them once (one-pass mean/var,
// clamped at 0, eps 1e-5) into shared memory, then walks the inner axis in
// tiles of BI: the a and b halves of that tile are two products over C in
// 64-wide chunks, GEGLU with the exact erff is applied in shared memory, and
// the tile's contribution to the output is accumulated in f32 registers.  The
// (N, 2*inner) intermediate therefore never reaches device memory, which is
// the point of the kernel: at the level-0 UNet geometry that tensor is 2.4 GB
// per call.  Weights stream through shared memory once per row block, so the
// kernel is bound by the two products (and by weight re-reads from L2 at the
// 1280-channel level, where BN drops to 16 to keep the accumulator in
// registers).  Weights come in the torch Linear layout: W1 (2*inner, C) and
// W2 (C_out, inner), i.e. already "transposed B" for the tile product.
#include "common.cuh"

namespace st2v {

constexpr int FF_THREADS = 256;
constexpr int FF_WARPS = FF_THREADS / 32;
constexpr int FF_KC = 64;     // C chunk of the first product
constexpr int FF_MAXT = 20;   // output tiles per warp (80 accumulator registers)

template <typename T, int BI>
struct FFLayout {
  static constexpr int P = RowPad<T>::value;
  static constexpr int LDW1 = FF_KC + P;
  static constexpr int LDH = 2 * BI + 4;
  static constexpr int LDG = BI + P;
  static constexpr int LDW2 = BI + P;
  static size_t smem_bytes(int bn, int c, int c_out) {
    return sizeof(T) * (size_t(bn) * (c + P) + size_t(2 * BI) * LDW1 + size_t(bn) * LDG +
                        size_t(c_out) * LDW2) +
           sizeof(float) * size_t(bn) * LDH;
  }
};

template <typename T, int BN, int BI>
__global__ void __launch_bounds__(FF_THREADS)
geglu_kernel(const T* __restrict__ x, const T* __restrict__ w1, const float* __restrict__ b1,
             const T* __restrict__ w2, const float* __restrict__ b2,
             const float* __restrict__ ln_scale, const float* __restrict__ ln_bias,
             T* __restrict__ out, int n, int c, int inner, int c_out, int residual) {
  typedef FFLayout<T, BI> L;
  constexpr int VEC = 16 / sizeof(T);
  constexpr int H_TILES = (BN / 16) * (2 * BI / 8);
  constexpr int H_PER = (H_TILES + FF_WARPS - 1) / FF_WARPS;
  const int ldx = c + L::P;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Xs = reinterpret_cast<T*>(smem_raw);
  T* W1s = Xs + BN * ldx;
  T* Gs = W1s + 2 * BI * L::LDW1;
  T* W2s = Gs + BN * L::LDG;
  float* Hs = reinterpret_cast<float*>(W2s + c_out * L::LDW2);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * BN;

  for (int i = tid; i < BN * (c / VEC); i += FF_THREADS) {
    const int r = i / (c / VEC), cc = (i % (c / VEC)) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n) val = *reinterpret_cast<const uint4*>(x + size_t(row0 + r) * c + cc);
    *reinterpret_cast<uint4*>(Xs + r * ldx + cc) = val;
  }
  __syncthreads();
  if (ln_scale != nullptr) {
    for (int r = warp; r < BN; r += FF_WARPS) {
      float s1 = 0.f, s2 = 0.f;
      for (int j = lane; j < c; j += 32) {
        const float xv = to_float(Xs[r * ldx + j]);
        s1 += xv;
        s2 += xv * xv;
      }
      s1 = warp_sum(s1);
      s2 = warp_sum(s2);
      const float mean = s1 / c;
      const float var = fmaxf(s2 / c - mean * mean, 0.f);
      const float inv = rsqrtf(var + 1e-5f);
      for (int j = lane; j < c; j += 32) {
        const float xv = to_float(Xs[r * ldx + j]);
        Xs[r * ldx + j] = from_float<T>((xv - mean) * inv * ln_scale[j] + ln_bias[j]);
      }
    }
  }

  const int acc_tiles = (BN / 16) * (c_out / 8);
  float acc[FF_MAXT][4];
#pragma unroll
  for (int j = 0; j < FF_MAXT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int i0 = 0; i0 < inner; i0 += BI) {
    float h[H_PER][4];
#pragma unroll
    for (int j = 0; j < H_PER; ++j) h[j][0] = h[j][1] = h[j][2] = h[j][3] = 0.f;
    for (int kc = 0; kc < c; kc += FF_KC) {
      const int kw = min(FF_KC, c - kc);
      __syncthreads();  // W1s (and, on the first chunk, Xs/Gs/W2s) are free
      for (int i = tid; i < 2 * BI * (kw / VEC); i += FF_THREADS) {
        const int r = i / (kw / VEC), cc = (i % (kw / VEC)) * VEC;
        const int src = r < BI ? i0 + r : inner + i0 + (r - BI);
        *reinterpret_cast<uint4*>(W1s + r * L::LDW1 + cc) =
            *reinterpret_cast<const uint4*>(w1 + size_t(src) * c + kc + cc);
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < H_PER; ++j) {
        const int ti = warp + j * FF_WARPS;
        if (ti < H_TILES) {
          const int rt = ti / (2 * BI / 8), nt = ti % (2 * BI / 8);
          mma_tile(h[j], Xs + rt * 16 * ldx + kc, ldx, W1s + nt * 8 * L::LDW1, L::LDW1, kw);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < H_PER; ++j) {
      const int ti = warp + j * FF_WARPS;
      if (ti < H_TILES) {
        const int rt = ti / (2 * BI / 8), nt = ti % (2 * BI / 8);
        float* hrow = Hs + (rt * 16 + g) * L::LDH + nt * 8 + 2 * t;
        hrow[0] = h[j][0];
        hrow[1] = h[j][1];
        hrow[8 * L::LDH] = h[j][2];
        hrow[8 * L::LDH + 1] = h[j][3];
      }
    }
    for (int i = tid; i < c_out * (BI / VEC); i += FF_THREADS) {
      const int r = i / (BI / VEC), cc = (i % (BI / VEC)) * VEC;
      *reinterpret_cast<uint4*>(W2s + r * L::LDW2 + cc) =
          *reinterpret_cast<const uint4*>(w2 + size_t(r) * inner + i0 + cc);
    }
    __syncthreads();
    for (int i = tid; i < BN * BI; i += FF_THREADS) {
      const int r = i / BI, j = i % BI;
      const float a = Hs[r * L::LDH + j] + b1[i0 + j];
      const float b = Hs[r * L::LDH + BI + j] + b1[inner + i0 + j];
      const float gelu = 0.5f * b * (1.f + erff(b * 0.70710678118654752f));
      Gs[r * L::LDG + j] = from_float<T>(a * gelu);
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < FF_MAXT; ++j) {
      const int ti = warp + j * FF_WARPS;
      if (ti < acc_tiles) {
        const int rt = ti / (c_out / 8), nt = ti % (c_out / 8);
        mma_tile(acc[j], Gs + rt * 16 * L::LDG, L::LDG, W2s + nt * 8 * L::LDW2, L::LDW2, BI);
      }
    }
  }

#pragma unroll
  for (int j = 0; j < FF_MAXT; ++j) {
    const int ti = warp + j * FF_WARPS;
    if (ti < acc_tiles) {
      const int rt = ti / (c_out / 8), nt = ti % (c_out / 8);
      const int col = nt * 8 + 2 * t;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + rt * 16 + g + 8 * half;
        if (row < n) {
          float v0 = acc[j][2 * half] + b2[col];
          float v1 = acc[j][2 * half + 1] + b2[col + 1];
          if (residual) {
            v0 += to_float(x[size_t(row) * c + col]);
            v1 += to_float(x[size_t(row) * c + col + 1]);
          }
          out[size_t(row) * c_out + col] = from_float<T>(v0);
          out[size_t(row) * c_out + col + 1] = from_float<T>(v1);
        }
      }
    }
  }
}

template <typename T, int BN, int BI>
static int launch_geglu(const void* x, const void* w1, const float* b1, const void* w2,
                        const float* b2, const float* lns, const float* lnb, void* out, int n,
                        int c, int inner, int c_out, int residual, cudaStream_t stream) {
  const size_t smem = FFLayout<T, BI>::smem_bytes(BN, c, c_out);
  auto kernel = geglu_kernel<T, BN, BI>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(n + BN - 1) / BN, FF_THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), b1, static_cast<const T*>(w2), b2,
      lns, lnb, static_cast<T*>(out), n, c, inner, c_out, residual);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int BI>
static int dispatch_geglu(int bn, const void* x, const void* w1, const float* b1,
                          const void* w2, const float* b2, const float* lns, const float* lnb,
                          void* out, int n, int c, int inner, int c_out, int residual,
                          cudaStream_t s) {
  if (bn == 64) return launch_geglu<T, 64, BI>(x, w1, b1, w2, b2, lns, lnb, out, n, c, inner, c_out, residual, s);
  if (bn == 32) return launch_geglu<T, 32, BI>(x, w1, b1, w2, b2, lns, lnb, out, n, c, inner, c_out, residual, s);
  if (bn == 16) return launch_geglu<T, 16, BI>(x, w1, b1, w2, b2, lns, lnb, out, n, c, inner, c_out, residual, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Rows per block for a given output width: the largest of 64/32/16 whose
// accumulator tiles fit FF_MAXT per warp; 0 when none does.
static int block_rows(int c_out) {
  const int bns[3] = {64, 32, 16};
  for (int i = 0; i < 3; ++i) {
    const int tiles = (bns[i] / 16) * (c_out / 8);
    if ((tiles + FF_WARPS - 1) / FF_WARPS <= FF_MAXT) return bns[i];
  }
  return 0;
}

}  // namespace st2v

// dtype: 0 = float32, 1 = bfloat16.  Requires c % 16 == 0, c_out % 8 == 0 and
// inner % 32 == 0; ln_scale/ln_bias may be null (no LayerNorm prologue).
extern "C" int st2v_geglu_ff(const void* x, const void* w1, const float* b1, const void* w2,
                             const float* b2, const float* ln_scale, const float* ln_bias,
                             void* out, int n, int c, int inner, int c_out, int residual,
                             int dtype, void* stream) {
  using namespace st2v;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || c % 16 || c_out % 8 || inner % 32) return static_cast<int>(cudaErrorInvalidValue);
  const int bn = block_rows(c_out);
  if (dtype == 1) return dispatch_geglu<bf16, 32>(bn, x, w1, b1, w2, b2, ln_scale, ln_bias, out, n, c, inner, c_out, residual, s);
  if (dtype == 0) return dispatch_geglu<float, 16>(bn, x, w1, b1, w2, b2, ln_scale, ln_bias, out, n, c, inner, c_out, residual, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
