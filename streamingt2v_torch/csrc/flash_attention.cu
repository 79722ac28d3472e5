// K1 and K2: flash attention for Hopper, one kernel body for two layouts.
//
// K1 replaces the Pallas kernel `_flash_kernel` (streamingt2v_tpu/ops/
// flash_attention.py:38, launched from `_flash_pallas`) over head-folded
// (B*H, L, D) tensors.  K2 replaces `_flash_kernel_packed` (:201, launched
// from `_flash_pallas_packed`) over head-packed (B, L, H*D) tensors, the
// layout the q/k/v projections produce: a head is a D-wide column slice and a
// row of it sits H*D elements after the previous one.  Both are the same
// kernel: a block owns BQ query rows of one (batch, head) and reads every
// row at a stride `ld` from the head's column offset (K1: ld = D, one head;
// K2: ld = H*D), so the packed layout costs no transpose.
//
// The block walks every KV tile of BK keys, keeping a running row max,
// denominator and f32 output accumulator, so the (Lq, Lk) scores never reach
// device memory.  The ragged KV edge is masked directly (scores -inf), so the
// TPU's zero-pad denominator correction is not needed.
//
// Per KV tile: S = Q K^T (tensor cores for bf16) -> shared memory, an online
// softmax pass per row in exp2 with the scale*log2(e) folded into S, P (in the
// input type) -> shared memory, then O = alpha*O + P V with O in registers.
// At D=64 the UNet geometries are compute-bound (4*L^2*D flops on 2*L*D*2
// bytes per head); this first version keeps everything synchronous and pays
// four block barriers per KV tile.  D=512 (the VAE mid-block attention) uses
// 16-row query tiles so the f32 accumulator fits in registers.
#include "common.cuh"

namespace st2v {


template <typename T, int D, int BQ, int BK>
struct FlashShape {
  static constexpr int NW = 4;
  static constexpr int P = RowPad<T>::value;
  static constexpr int LDQ = D + P;   // Qs, Ks row stride (elements)
  static constexpr int LDV = BK + P;  // Vt row stride: V transposed, rows = d
  static constexpr int LDP = BK + P;  // probabilities
  static constexpr int LDS = BK + 1;  // f32 scores
  static constexpr int O_TILES = (BQ / 16) * (D / 8);
  static constexpr int OT = O_TILES / NW;
  static constexpr int S_TILES = (BQ / 16) * (BK / 8);
  static_assert(O_TILES % NW == 0, "output tiles must split evenly over warps");
  static constexpr size_t smem_bytes() {
    return sizeof(T) * (size_t(BQ) * LDQ + size_t(BK) * LDQ + size_t(D) * LDV +
                        size_t(BQ) * LDP) +
           sizeof(float) * (size_t(BQ) * LDS + 3 * BQ);
  }
};

template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(128)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ o, int lq, int lk, int heads, int ld, float scale_log2) {
  typedef FlashShape<T, D, BQ, BK> S;
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + BQ * S::LDQ;
  T* Vt = Ks + BK * S::LDQ;
  T* Ps = Vt + D * S::LDV;
  float* Ss = reinterpret_cast<float*>(Ps + BQ * S::LDP);
  float* m_s = Ss + BQ * S::LDS;
  float* l_s = m_s + BQ;
  float* a_s = l_s + BQ;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ;
  // blockIdx.y = batch * heads + head; rows of the head start at its column
  const size_t bi = blockIdx.y / heads, hi = blockIdx.y % heads;
  const T* qb = q + bi * lq * ld + hi * D;
  const T* kb = k + bi * lk * ld + hi * D;
  const T* vb = v + bi * lk * ld + hi * D;
  T* ob = o + bi * lq * ld + hi * D;

  for (int i = tid; i < BQ * (D / VEC); i += 128) {
    const int r = i / (D / VEC), c = (i % (D / VEC)) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < lq) val = *reinterpret_cast<const uint4*>(qb + size_t(q0 + r) * ld + c);
    *reinterpret_cast<uint4*>(Qs + r * S::LDQ + c) = val;
  }
  for (int i = tid; i < BQ; i += 128) {
    m_s[i] = __int_as_float(0xff800000);  // -inf
    l_s[i] = 0.f;
  }

  float acc[S::OT][4];
#pragma unroll
  for (int j = 0; j < S::OT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int kv0 = 0; kv0 < lk; kv0 += BK) {
    __syncthreads();  // the previous tile's Ks/Vt/Ps are no longer read
    for (int i = tid; i < BK * (D / VEC); i += 128) {
      const int r = i / (D / VEC), c = (i % (D / VEC)) * VEC;
      uint4 kval = make_uint4(0u, 0u, 0u, 0u), vval = make_uint4(0u, 0u, 0u, 0u);
      if (kv0 + r < lk) {
        kval = *reinterpret_cast<const uint4*>(kb + size_t(kv0 + r) * ld + c);
        vval = *reinterpret_cast<const uint4*>(vb + size_t(kv0 + r) * ld + c);
      }
      *reinterpret_cast<uint4*>(Ks + r * S::LDQ + c) = kval;
      const T* ve = reinterpret_cast<const T*>(&vval);
#pragma unroll
      for (int e = 0; e < VEC; ++e) Vt[(c + e) * S::LDV + r] = ve[e];
    }
    __syncthreads();

    for (int ti = warp; ti < S::S_TILES; ti += S::NW) {
      const int rt = ti / (BK / 8), nt = ti % (BK / 8);
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      mma_tile(c, Qs + rt * 16 * S::LDQ, S::LDQ, Ks + nt * 8 * S::LDQ, S::LDQ, D);
      float* srow = Ss + (rt * 16 + g) * S::LDS + nt * 8 + 2 * t;
      srow[0] = c[0] * scale_log2;
      srow[1] = c[1] * scale_log2;
      srow[8 * S::LDS] = c[2] * scale_log2;
      srow[8 * S::LDS + 1] = c[3] * scale_log2;
    }
    __syncthreads();

    for (int r = warp; r < BQ; r += S::NW) {
      float mx = __int_as_float(0xff800000);  // -inf
      for (int j = lane; j < BK; j += 32)
        if (kv0 + j < lk) mx = fmaxf(mx, Ss[r * S::LDS + j]);
      mx = warp_max(mx);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < BK; j += 32) {
        const float p = (kv0 + j < lk) ? exp2f(Ss[r * S::LDS + j] - m_new) : 0.f;
        Ps[r * S::LDP + j] = from_float<T>(p);
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = exp2f(m_old - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < S::OT; ++j) {
      const int ti = warp + j * S::NW;
      const int rt = ti / (D / 8), nt = ti % (D / 8);
      const float al0 = a_s[rt * 16 + g], al1 = a_s[rt * 16 + g + 8];
      acc[j][0] *= al0;
      acc[j][1] *= al0;
      acc[j][2] *= al1;
      acc[j][3] *= al1;
      mma_tile(acc[j], Ps + rt * 16 * S::LDP, S::LDP, Vt + nt * 8 * S::LDV, S::LDV, BK);
    }
  }

#pragma unroll
  for (int j = 0; j < S::OT; ++j) {
    const int ti = warp + j * S::NW;
    const int rt = ti / (D / 8), nt = ti % (D / 8);
    const int r0 = rt * 16 + g, col = nt * 8 + 2 * t;
    if (q0 + r0 < lq) {
      const float inv = 1.f / l_s[r0];
      T* dst = ob + size_t(q0 + r0) * ld + col;
      dst[0] = from_float<T>(acc[j][0] * inv);
      dst[1] = from_float<T>(acc[j][1] * inv);
    }
    if (q0 + r0 + 8 < lq) {
      const float inv = 1.f / l_s[r0 + 8];
      T* dst = ob + size_t(q0 + r0 + 8) * ld + col;
      dst[0] = from_float<T>(acc[j][2] * inv);
      dst[1] = from_float<T>(acc[j][3] * inv);
    }
  }
}

template <typename T, int D, int BQ, int BK>
static int launch_flash(const void* q, const void* k, const void* v, void* o, int batch,
                        int heads, int lq, int lk, float scale_log2, cudaStream_t stream) {
  typedef FlashShape<T, D, BQ, BK> S;
  const size_t smem = S::smem_bytes();
  auto kernel = flash_kernel<T, D, BQ, BK>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((lq + BQ - 1) / BQ, batch * heads);
  kernel<<<grid, 128, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                      static_cast<const T*>(v), static_cast<T*>(o), lq, lk,
                                      heads, heads * D, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

// One dispatch over (dtype, d) for both layouts.
static int dispatch_flash(const void* q, const void* k, const void* v, void* o, int batch,
                          int heads, int lq, int lk, int d, int dtype, float scale_log2,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || heads <= 0 || batch * heads > 65535 || lq <= 0 || lk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1 && d == 64) return launch_flash<bf16, 64, 64, 64>(q, k, v, o, batch, heads, lq, lk, scale_log2, s);
  if (dtype == 1 && d == 512) return launch_flash<bf16, 512, 16, 32>(q, k, v, o, batch, heads, lq, lk, scale_log2, s);
  if (dtype == 0 && d == 64) return launch_flash<float, 64, 64, 64>(q, k, v, o, batch, heads, lq, lk, scale_log2, s);
  if (dtype == 0 && d == 512) return launch_flash<float, 512, 16, 32>(q, k, v, o, batch, heads, lq, lk, scale_log2, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace st2v

// K1.  q/o (bh, lq, d), k/v (bh, lk, d).  dtype: 0 = float32, 1 = bfloat16.
// d must be 64 or 512 (the wrapper pads other head dims with zeros).
// Returns a cudaError_t (0 = launched).
extern "C" int st2v_flash_attention(const void* q, const void* k, const void* v, void* o,
                                    int bh, int lq, int lk, int d, int dtype,
                                    float scale_log2, void* stream) {
  return st2v::dispatch_flash(q, k, v, o, bh, 1, lq, lk, d, dtype, scale_log2, stream);
}

// K2.  q/o (batch, lq, heads*d), k/v (batch, lk, heads*d); d is 64 or 512.
extern "C" int st2v_flash_attention_packed(const void* q, const void* k, const void* v,
                                           void* o, int batch, int heads, int lq, int lk,
                                           int d, int dtype, float scale_log2, void* stream) {
  return st2v::dispatch_flash(q, k, v, o, batch, heads, lq, lk, d, dtype, scale_log2, stream);
}
