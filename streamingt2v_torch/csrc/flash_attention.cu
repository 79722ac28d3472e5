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
// What bounds it on the H100: at D=64 the UNet geometries do 4*L^2*D flops on
// 4*L*D*2 bytes per head, so the tensor cores.  The bf16 D=64 instance, which
// carries all UNet attention, is the register-resident FlashAttention-2
// structure on `mma.sync` (wgmma is not used): four warps each own 32 query
// rows (two 16-row tiles) of a 128-row tile, with their Q fragments held in
// registers, so each K and V fragment loaded feeds two products;
// S = Q K^T stays in the mma accumulators, the row max and sum go through
// quad shuffles, and P is repacked in registers as the A fragments of P V.
// K fragments come from `ldmatrix` and V's from `ldmatrix.trans` on the
// row-major V tile.  K/V tiles are double-buffered by `cp.async` (zero-filled
// past the ragged edge), with one block barrier per tile: the next tile's copy
// is in flight while this one's products run.  Masking runs on the last tile
// only.
//
// The f32 instances (FMA units, full f32) and D=512 (the VAE mid-block
// attention, 16-row query tiles so the f32 accumulator fits in registers) keep
// the first, synchronous body: S and P go through shared memory, with four
// block barriers per KV tile.
#include "common.cuh"

namespace st2v {

// ---- f32, and D = 512: the synchronous body ----
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

// ---- bf16, D = 64: the register-resident body ----
constexpr int FA_D = 64;
constexpr int FA_MT = 2;                // 16-row query tiles per warp
constexpr int FA_THREADS = 128;
constexpr int FA_BQ = FA_THREADS / 32 * 16 * FA_MT;  // query rows per block
constexpr int FA_BK = 64;               // keys per KV tile
constexpr int FA_LD = FA_D + 8;         // smem row stride: conflict-free ldmatrix
constexpr size_t FA_SMEM = sizeof(bf16) * FA_LD * (FA_BQ + 2 * 2 * FA_BK);  // Q, 2 x (K, V)

// ROWS rows x 64 columns from rows [row0, row0 + ROWS) at stride ld; rows at
// or past `rows` are zero-filled.
template <int ROWS>
__device__ __forceinline__ void fa_load_tile(bf16* dst, const bf16* src, int row0, int rows,
                                             int ld) {
#pragma unroll
  for (int it = 0; it < ROWS * (FA_D / 8) / FA_THREADS; ++it) {
    const int i = threadIdx.x + it * FA_THREADS;
    const int r = i >> 3, col = (i & 7) * 8;
    const bool ok = row0 + r < rows;
    cp_async_16(dst + r * FA_LD + col, src + size_t(ok ? row0 + r : 0) * ld + col, ok);
  }
}

__global__ void __launch_bounds__(FA_THREADS)
flash_kernel_bf16_d64(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o, int lq, int lk,
                      int heads, int ld, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* KV = Qs + FA_BQ * FA_LD;  // stage s: K at KV + 2*s*FA_BK*FA_LD, V after it

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mi = lane >> 3, r8 = lane & 7;  // ldmatrix: matrix and row this lane addresses
  const int q0 = blockIdx.x * FA_BQ;
  const size_t bi = blockIdx.y / heads, hi = blockIdx.y % heads;
  const bf16* qb = q + bi * lq * ld + hi * FA_D;
  const bf16* kb = k + bi * lk * ld + hi * FA_D;
  const bf16* vb = v + bi * lk * ld + hi * FA_D;
  bf16* ob = o + bi * lq * ld + hi * FA_D;

  fa_load_tile<FA_BQ>(Qs, qb, q0, lq, ld);
  fa_load_tile<FA_BK>(KV, kb, 0, lk, ld);
  fa_load_tile<FA_BK>(KV + FA_BK * FA_LD, vb, 0, lk, ld);
  cp_async_commit();

  // Per 16-row tile mt of this warp (rows warp*16*FA_MT + mt*16 + g and +8):
  const float neg_inf = __int_as_float(0xff800000);
  uint32_t qf[FA_MT][FA_D / 16][4];  // Q A-fragments, one per 16 columns of D
  float acc[FA_MT][FA_D / 8][4];     // O, 8 column tiles of 8
  float mx[FA_MT][2], den[FA_MT][2];  // running max (log2 units); this lane's denominator share
#pragma unroll
  for (int mt = 0; mt < FA_MT; ++mt) {
    mx[mt][0] = mx[mt][1] = neg_inf;
    den[mt][0] = den[mt][1] = 0.f;
#pragma unroll
    for (int n = 0; n < FA_D / 8; ++n) acc[mt][n][0] = acc[mt][n][1] = acc[mt][n][2] = acc[mt][n][3] = 0.f;
  }

  const int tiles = (lk + FA_BK - 1) / FA_BK;
  for (int j = 0; j < tiles; ++j) {
    cp_async_wait_all();
    __syncthreads();  // tile j landed for all; tile j-1's stage is no longer read
    if (j + 1 < tiles) {
      bf16* next = KV + ((j + 1) & 1) * 2 * FA_BK * FA_LD;
      fa_load_tile<FA_BK>(next, kb, (j + 1) * FA_BK, lk, ld);
      fa_load_tile<FA_BK>(next + FA_BK * FA_LD, vb, (j + 1) * FA_BK, lk, ld);
      cp_async_commit();
    }
    if (j == 0) {
#pragma unroll
      for (int mt = 0; mt < FA_MT; ++mt)
#pragma unroll
        for (int ks = 0; ks < FA_D / 16; ++ks)
          ldmatrix_x4(qf[mt][ks], Qs + ((warp * FA_MT + mt) * 16 + (lane & 15)) * FA_LD +
                                      ks * 16 + (lane >> 4) * 8);
    }
    const bf16* Ks = KV + (j & 1) * 2 * FA_BK * FA_LD;
    const bf16* Vs = Ks + FA_BK * FA_LD;

    // S = Q K^T: 64 keys per tile, 8 key tiles of 8; each K fragment feeds
    // every query tile of the warp
    float sc[FA_MT][FA_BK / 8][4];
#pragma unroll
    for (int mt = 0; mt < FA_MT; ++mt)
#pragma unroll
      for (int n = 0; n < FA_BK / 8; ++n) sc[mt][n][0] = sc[mt][n][1] = sc[mt][n][2] = sc[mt][n][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < FA_D / 16; ++ks) {
#pragma unroll
      for (int np = 0; np < FA_BK / 16; ++np) {
        uint32_t b[4];  // key tiles 2np, 2np+1; D columns ks*16 .. +15
        ldmatrix_x4(b, Ks + (np * 16 + (mi >> 1) * 8 + r8) * FA_LD + ks * 16 + (mi & 1) * 8);
#pragma unroll
        for (int mt = 0; mt < FA_MT; ++mt) {
          mma_bf16(sc[mt][2 * np], qf[mt][ks], b[0], b[1]);
          mma_bf16(sc[mt][2 * np + 1], qf[mt][ks], b[2], b[3]);
        }
      }
    }
    if ((j + 1) * FA_BK > lk) {  // the ragged last tile
#pragma unroll
      for (int n = 0; n < FA_BK / 8; ++n) {
        const int key = j * FA_BK + n * 8 + 2 * t;
#pragma unroll
        for (int mt = 0; mt < FA_MT; ++mt) {
          if (key >= lk) sc[mt][n][0] = sc[mt][n][2] = neg_inf;
          if (key + 1 >= lk) sc[mt][n][1] = sc[mt][n][3] = neg_inf;
        }
      }
    }

    // online softmax: rows g (elements 0, 1) and g+8 (2, 3); a row's 64
    // scores sit in the four lanes of a quad
#pragma unroll
    for (int mt = 0; mt < FA_MT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float r = neg_inf;
#pragma unroll
        for (int n = 0; n < FA_BK / 8; ++n) r = fmaxf(r, fmaxf(sc[mt][n][2 * h], sc[mt][n][2 * h + 1]));
        r = fmaxf(r, __shfl_xor_sync(0xffffffffu, r, 1));
        r = fmaxf(r, __shfl_xor_sync(0xffffffffu, r, 2));
        const float mnew = fmaxf(mx[mt][h], r * scale_log2);
        const float alpha = exp2f(mx[mt][h] - mnew);
        mx[mt][h] = mnew;
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < FA_BK / 8; ++n) {
          sc[mt][n][2 * h] = exp2f(fmaf(sc[mt][n][2 * h], scale_log2, -mnew));
          sc[mt][n][2 * h + 1] = exp2f(fmaf(sc[mt][n][2 * h + 1], scale_log2, -mnew));
          sum += sc[mt][n][2 * h] + sc[mt][n][2 * h + 1];
        }
        den[mt][h] = den[mt][h] * alpha + sum;
#pragma unroll
        for (int n = 0; n < FA_D / 8; ++n) {
          acc[mt][n][2 * h] *= alpha;
          acc[mt][n][2 * h + 1] *= alpha;
        }
      }
    }

    // O += P V: P's accumulators repacked as A fragments, 16 keys at a time;
    // each V fragment feeds every query tile of the warp
#pragma unroll
    for (int kk = 0; kk < FA_BK / 16; ++kk) {
      uint32_t a[FA_MT][4];
#pragma unroll
      for (int mt = 0; mt < FA_MT; ++mt) {
        a[mt][0] = pack_bf16x2(sc[mt][2 * kk][0], sc[mt][2 * kk][1]);
        a[mt][1] = pack_bf16x2(sc[mt][2 * kk][2], sc[mt][2 * kk][3]);
        a[mt][2] = pack_bf16x2(sc[mt][2 * kk + 1][0], sc[mt][2 * kk + 1][1]);
        a[mt][3] = pack_bf16x2(sc[mt][2 * kk + 1][2], sc[mt][2 * kk + 1][3]);
      }
#pragma unroll
      for (int dp = 0; dp < FA_D / 16; ++dp) {
        uint32_t b[4];  // D tiles 2dp, 2dp+1; keys kk*16 .. +15
        ldmatrix_x4_trans(b, Vs + (kk * 16 + (mi & 1) * 8 + r8) * FA_LD + dp * 16 + (mi >> 1) * 8);
#pragma unroll
        for (int mt = 0; mt < FA_MT; ++mt) {
          mma_bf16(acc[mt][2 * dp], a[mt], b[0], b[1]);
          mma_bf16(acc[mt][2 * dp + 1], a[mt], b[2], b[3]);
        }
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < FA_MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float l = den[mt][h];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float inv = 1.f / l;
      const int row = q0 + (warp * FA_MT + mt) * 16 + g + 8 * h;
      if (row >= lq) continue;
#pragma unroll
      for (int n = 0; n < FA_D / 8; ++n)
        *reinterpret_cast<uint32_t*>(ob + size_t(row) * ld + n * 8 + 2 * t) =
            pack_bf16x2(acc[mt][n][2 * h] * inv, acc[mt][n][2 * h + 1] * inv);
    }
  }
}

static int launch_flash_bf16_d64(const void* q, const void* k, const void* v, void* o,
                                 int batch, int heads, int lq, int lk, float scale_log2,
                                 cudaStream_t stream) {
  cudaError_t err = set_smem(flash_kernel_bf16_d64, FA_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((lq + FA_BQ - 1) / FA_BQ, batch * heads);
  flash_kernel_bf16_d64<<<grid, FA_THREADS, FA_SMEM, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), lq, lk, heads, heads * FA_D, scale_log2);
  return static_cast<int>(cudaGetLastError());
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
  if (dtype == 1 && d == 64) return launch_flash_bf16_d64(q, k, v, o, batch, heads, lq, lk, scale_log2, s);
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
