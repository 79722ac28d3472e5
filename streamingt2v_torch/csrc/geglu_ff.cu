// K3: GEGLU feed-forward for Hopper.
//
// Replaces the Pallas kernel `_ff_kernel` (streamingt2v_tpu/ops/fused_ff.py:65,
// launched from `_geglu_pallas`):
//
//   [a | b] = LN(x) W1^T + b1,   out = (a * gelu_erf(b)) W2^T + b2 (+ x)
//
// with one-pass LN statistics clamped at 0 and eps 1e-5.  Weights come in the
// torch Linear layout: W1 (2*inner, C) and W2 (C_out, inner), i.e. already
// "transposed B" for a row-major product.
//
// What bounds it on the H100: the two products, 2*N*C*2*inner +
// 2*N*inner*C_out flops on the tensor cores (1.13 TFLOP at every UNet level
// of stage 1, 1.145 ms at the bf16 peak).
//
// The bf16 body: three kernels over a chunk of rows, two of them one tiled
// GEMM core.  A fused design has to hold a (rows x C_out) f32 accumulator on
// chip, which at C_out = 1280 leaves 16 rows per block, and every block then
// streams all of W1 and W2 from L2 (71 GB of L2 reads per call at 1280
// channels).  Here:
//   - `geglu_ln_kernel` (with LN): one warp per row takes the mean and rstd in
//     one sweep and writes LN(x) rounded to bf16 (as the Pallas kernel rounds
//     it before its product), once per element; normalising inside the GEMM
//     would redo it for every 128 columns of G;
//   - pass "up" (`geglu_gemm_kernel<true, 256, 0>`): a tile is 128 rows x 128
//     columns of G, i.e. 128 rows of W1's a slab and the matching 128 of its b
//     slab (two contiguous slabs; W1 is not reordered) as the 256 columns of
//     one product, so every thread holds a and b for the same G elements.  The
//     epilogue adds b1, computes a * 0.5*b*(1+erf(b/sqrt2)), rounds G to bf16
//     (the Pallas kernel rounds g to the input dtype before the second product
//     too) and stores it with 16-byte stores staged outside the copy ring.  One
//     block per SM walks its tiles with the ring's copies running ahead across
//     tiles, so the next tile's first stages land during this one's epilogue;
//   - pass "down" (`geglu_gemm_kernel<false, 256, 64>` at C_out % 320 == 0):
//     G W2^T, a tile of 128 rows x 320 output columns (G read once at the
//     UNet widths; 64 columns elsewhere), epilogue + b2 (+ x) rounded once and stored 16 bytes at a
//     time.
// The core: two warpgroups, each 64 rows of the tile, `wgmma.mma_async` with
// both operands read from shared memory in the 128-byte swizzle (on the H100
// the unswizzled core-matrix layout ran the same products 1.6x slower).
// Operands arrive by 16-byte `cp.async` into a ring of 3 stages of 64 along
// the contraction; `cp.async` writes through the generic proxy, so each
// thread fences its landed copies to the async proxy (`fence.proxy.async`)
// before the stage's barrier, and one group of products stays in flight
// while the next stage is published.  Zero fill covers the ragged row edge,
// the ragged K tail and absent columns.  G (and LN(x)) are scratch the
// wrapper allocates for one chunk of rows, whole waves of the down pass; the
// wrapper (ops/fused_ff.py) makes the chunk plan and picks the down tile.
//
// The f32 instance keeps the first, fused body: one block owns BN rows,
// normalises them once into shared memory, walks the inner axis in tiles and
// accumulates the output in f32 registers (FMA units, full f32).
#include "common.cuh"

namespace st2v {

// ---- bf16: LN, then two passes of one GEMM core ----
constexpr int GF_THREADS = 256;    // the LN kernel
constexpr int GF_BK = 64;           // contraction per stage
constexpr int GF_SMEM = 220 * 1024; // shared memory of one block, one block per SM

struct GemmArgs {
  const bf16* a;           // up: LN(x) or x chunk (rows, k = C); down: G (rows, k = inner)
  const bf16* b;           // up: W1 (2*inner, C); down: W2 (C_out, inner)
  const float* bias;       // up: b1; down: b2
  const bf16* res;         // down: x chunk for the residual, or null
  bf16* out;               // up: G (rows, inner); down: out chunk (rows, C_out)
  int rows, k, n, inner;   // n: valid output columns (up: inner; down: C_out)
};

// LN(x) of a chunk's rows in bf16, one warp per row: the mean and rstd in one
// sweep (one-pass statistics clamped at 0, eps 1e-5), then the row again
// (from L1) normalised, scaled and shifted.
__global__ void __launch_bounds__(GF_THREADS)
geglu_ln_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_scale,
                const float* __restrict__ ln_bias, bf16* __restrict__ xn, int n, int c) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * (GF_THREADS / 32) + warp;
  if (row >= n) return;
  const bf16* xr = x + size_t(row) * c;
  float s1 = 0.f, s2 = 0.f;
  for (int col = lane * 8; col < c; col += 256) {
    uint4 raw = *reinterpret_cast<const uint4*>(xr + col);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h[e]);
      s1 += f.x + f.y;
      s2 = fmaf(f.x, f.x, fmaf(f.y, f.y, s2));
    }
  }
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  const float mean = s1 / c;
  const float rstd = rsqrtf(fmaxf(s2 / c - mean * mean, 0.f) + 1e-5f);
  for (int col = lane * 8; col < c; col += 256) {
    uint4 raw = *reinterpret_cast<const uint4*>(xr + col);
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
    const float4* ps = reinterpret_cast<const float4*>(ln_scale + col);
    const float4* pb = reinterpret_cast<const float4*>(ln_bias + col);
    const float4 sa = __ldg(ps), sb = __ldg(ps + 1), ba = __ldg(pb), bb = __ldg(pb + 1);
    const float sv[8] = {sa.x, sa.y, sa.z, sa.w, sb.x, sb.y, sb.z, sb.w};
    const float bv[8] = {ba.x, ba.y, ba.z, ba.w, bb.x, bb.y, bb.z, bb.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h[e]);
      h[e] = __floats2bfloat162_rn(fmaf((f.x - mean) * rstd, sv[2 * e], bv[2 * e]),
                                   fmaf((f.y - mean) * rstd, sv[2 * e + 1], bv[2 * e + 1]));
    }
    *reinterpret_cast<uint4*>(xn + size_t(row) * c + col) = raw;
  }
}

__device__ __forceinline__ float geglu(float a, float b) {
  return a * (0.5f * b * (1.f + erff(b * 0.70710678118654752f)));
}

// erf by Abramowitz & Stegun 7.1.26 (|error| <= 1.5e-7, below G's bf16
// rounding by four orders), without erff's branches: the bf16 up pass
// computes 64 of these per thread per tile.
__device__ __forceinline__ float erf_as(float x) {
  const float ax = fabsf(x);
  const float t = __fdividef(1.f, fmaf(0.3275911f, ax, 1.f));
  float y = fmaf(1.061405429f, t, -1.453152027f);
  y = fmaf(y, t, 1.421413741f);
  y = fmaf(y, t, -0.284496736f);
  y = fmaf(y, t, 0.254829592f);
  y = 1.f - y * t * __expf(-ax * ax);
  return copysignf(y, x);
}

__device__ __forceinline__ float geglu_bf16(float a, float b) {
  return a * (0.5f * b * (1.f + erf_as(b * 0.70710678118654752f)));
}

// ---- the wgmma core ----
constexpr int GW_THREADS = 256;     // two warpgroups, 64 tile rows each
constexpr int GW_BM = 128;          // tile rows
static_assert(GF_BK == 64, "a stage's row is one 128-byte swizzle row");

// A stage holds a tile of R rows x GF_BK (128 bytes a row) in the 128-byte
// swizzle that wgmma reads (`sw128_off`, `gmma_desc` in common.cuh).

// B rows per tile: NB through one m64nNBk16 (NB = 256 or 0) and NS through
// one m64nNSk16 (NS = 64 or 0) per 16 of the contraction.  UP takes (256, 0):
// B rows 0..127 are W1's a slab and 128..255 its b slab for the same 128 G
// columns, so a thread holds a (columns 8j..) and b (columns 128 + 8j..) for
// the same G elements.  Down: B rows are output columns, (256, 64) for 320
// columns, (0, 64) for 64.
template <bool UP, int NB, int NS>
struct GemmShape {
  static constexpr int BN = NB + NS;
  static constexpr int COLS = UP ? BN / 2 : BN;     // output columns per tile
  static constexpr int LDY = COLS + 8;              // the output staging's row stride
  static constexpr int A_BYTES = GW_BM * GF_BK * 2, B_BYTES = BN * GF_BK * 2;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int Y_BYTES = UP ? GW_BM * LDY * 2 : 0;  // staging outside the ring
  static constexpr int STAGES = (GF_SMEM - 1024 - Y_BYTES) / STAGE_BYTES < 4
                                    ? (GF_SMEM - 1024 - Y_BYTES) / STAGE_BYTES : 4;
  static constexpr size_t SMEM = size_t(STAGES) * STAGE_BYTES + Y_BYTES + 1024;  // + alignment
  static_assert(STAGE_BYTES % 1024 == 0, "stages start on swizzle atoms");
  static_assert(UP || GW_BM * LDY * 2 <= STAGES * STAGE_BYTES, "the down staging fits the ring");
  static_assert(BN % 32 == 0 && (!UP || (NB == 256 && NS == 0)), "tile shape");
};

// A block walks tiles blockIdx.x, + gridDim.x, ... (column blocks fastest, so
// the blocks at work share their rows of A in L2).  Its copies run STAGES - 1
// steps ahead of the products across tile boundaries, so the next tile's
// first stages land while this one's epilogue runs.  That needs the epilogue
// to stage its output outside the ring: UP does; the down pass stages in the
// ring and takes one tile per block (grid = tiles).
template <bool UP, int NB, int NS>
__global__ void __launch_bounds__(GW_THREADS, 1)
geglu_gemm_kernel(const GemmArgs p) {
  typedef GemmShape<UP, NB, NS> S;
  constexpr int BN = S::BN, COLS = S::COLS, STAGES = S::STAGES;
  constexpr int A_IT = GW_BM / 32, B_IT = BN / 32;  // 16-byte copies per thread per stage
  extern __shared__ __align__(16) unsigned char smem_dyn[];
  // the swizzle atoms need 1024-byte alignment (the launch adds the slack)
  unsigned char* smem_raw = smem_dyn + ((1024 - (smem_u32(smem_dyn) & 1023)) & 1023);
  bf16* Ys = reinterpret_cast<bf16*>(UP ? smem_raw + STAGES * S::STAGE_BYTES : smem_raw);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wg = warp >> 2;                          // warpgroup: tile rows wg*64 ..
  // this thread's copies: rows cr + 32*it, columns [cc, cc + 8), at byte
  // my_off + 4096*it of the tile (8 neighbouring threads copy one row)
  const int cr = tid >> 3, cg = tid & 7, cc = cg * 8;
  const int my_off = sw128_off(cr, cg);
  const int col_blocks = (p.n + COLS - 1) / COLS;
  const int tiles = col_blocks * ((p.rows + GW_BM - 1) / GW_BM);
  const int steps = (p.k + GF_BK - 1) / GF_BK;
  const size_t kstep = size_t(32) * p.k;
  const size_t slab_off = UP ? size_t(p.inner - BN / 2) * p.k : 0;  // W1's b slab

  // the loader: its tile and step, the ring slot it fills next, and its
  // copies' sources (advanced by k0 each step) and rows that exist
  int l_tile = blockIdx.x, l_step = 0, l_slot = 0;
  const bf16* a_src = p.a;
  const bf16* b_src = p.b;
  uint32_t a_ok = 0, b_ok = 0;
  auto start_tile = [&]() {
    const int row0 = (l_tile / col_blocks) * GW_BM, col0 = (l_tile % col_blocks) * COLS;
    a_src = p.a + size_t(row0 + cr) * p.k + cc;
    b_src = p.b + size_t(col0 + cr) * p.k + cc;
    a_ok = b_ok = 0;
#pragma unroll
    for (int it = 0; it < A_IT; ++it)
      if (row0 + cr + 32 * it < p.rows) a_ok |= 1u << it;
#pragma unroll
    for (int it = 0; it < B_IT; ++it) {
      const bool slab = UP && 32 * it >= BN / 2;
      if (col0 + cr + 32 * it - (slab ? BN / 2 : 0) < p.n) b_ok |= 1u << it;
    }
  };
  auto load_next = [&]() {
    if (l_tile < tiles) {
      unsigned char* As = smem_raw + l_slot * S::STAGE_BYTES;
      unsigned char* Bs = As + S::A_BYTES;
      const int k0 = l_step * GF_BK;
      const bool kin = k0 + cc < p.k;
#pragma unroll
      for (int it = 0; it < A_IT; ++it) {
        const bool ok = kin && ((a_ok >> it) & 1u);
        cp_async_16(As + my_off + 4096 * it, ok ? a_src + it * kstep + k0 : p.a, ok);
      }
#pragma unroll
      for (int it = 0; it < B_IT; ++it) {
        const bool slab = UP && 32 * it >= BN / 2;
        const bool ok = kin && ((b_ok >> it) & 1u);
        cp_async_16(Bs + my_off + 4096 * it,
                    ok ? b_src + it * kstep + (slab ? slab_off : 0) + k0 : p.b, ok);
      }
      if (++l_step == steps) {
        l_step = 0;
        l_tile += gridDim.x;
        if (l_tile < tiles) start_tile();
      }
    }
    cp_async_commit();  // one group per step, empty past the last tile
    l_slot = l_slot + 1 == STAGES ? 0 : l_slot + 1;
  };
  float acc[NB > 0 ? NB / 2 : 1];   // the m64nNBk16 accumulator
  float acs[NS > 0 ? NS / 2 : 1];   // the m64nNSk16 accumulator
  if (l_tile < tiles) start_tile();
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) load_next();
  int slot = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int row0 = (tile / col_blocks) * GW_BM, col0 = (tile % col_blocks) * COLS;
#pragma unroll
    for (int i = 0; i < (NB > 0 ? NB / 2 : 1); ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < (NS > 0 ? NS / 2 : 1); ++i) acs[i] = 0.f;
    for (int i = 0; i < steps; ++i) {
      cp_async_wait_group<STAGES - 2>();  // this thread's copies of this step landed
      fence_proxy_async();
      __syncthreads();  // the step is complete for all
      const uint32_t a0 = smem_u32(smem_raw + slot * S::STAGE_BYTES) + wg * 64 * 128;
      const uint32_t b0 = smem_u32(smem_raw + slot * S::STAGE_BYTES + S::A_BYTES);
      gmma_fence();
#pragma unroll
      for (int kk = 0; kk < GF_BK / 16; ++kk) {
        const uint64_t da = gmma_desc(a0 + kk * 32);
        if constexpr (NB > 0) wgmma_m64n256k16(acc, da, gmma_desc(b0 + kk * 32));
        if constexpr (NS > 0) wgmma_m64n64k16(acs, da, gmma_desc(b0 + NB * 128 + kk * 32));
      }
      gmma_commit();
      // the previous step's products are done (this step's run on), in
      // every warpgroup: its slot takes the copies STAGES - 1 steps ahead
      gmma_wait<1>();
      __syncthreads();
      load_next();
      slot = slot + 1 == STAGES ? 0 : slot + 1;
    }
    gmma_wait<0>();
    fence_regs(acc);
    fence_regs(acs);
    if (!UP) {  // the staging is the ring: every copy is done
      cp_async_wait_all();
      __syncthreads();
    }

    // stage the tile's bf16 output for 16-byte stores.  A thread holds, of
    // each 8-column block j of its accumulator, rows r (elements 0, 1) and
    // r + 8 (2, 3) at columns 8j + 2*t4 and + 1.
    constexpr int LDY = S::LDY;
    const int r_lo = wg * 64 + (warp & 3) * 16 + g;
    if constexpr (UP) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int cl = 8 * j + 2 * t4, gcol = col0 + cl;
        const bool ok = gcol < p.n;
        const float2 ba = ok ? __ldg(reinterpret_cast<const float2*>(p.bias + gcol))
                             : make_float2(0.f, 0.f);
        const float2 bb = ok ? __ldg(reinterpret_cast<const float2*>(p.bias + p.inner + gcol))
                             : make_float2(0.f, 0.f);
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<uint32_t*>(Ys + (r_lo + 8 * h) * LDY + cl) = pack_bf16x2(
              geglu_bf16(acc[4 * j + 2 * h] + ba.x, acc[4 * (j + 16) + 2 * h] + bb.x),
              geglu_bf16(acc[4 * j + 2 * h + 1] + ba.y, acc[4 * (j + 16) + 2 * h + 1] + bb.y));
      }
    } else {
      auto emit = [&](int cl, const float* d) {  // d: one 8-column block's 4 elements
        const int co = col0 + cl;
        const bool ok = co < p.n;
        const float bias0 = ok ? p.bias[co] : 0.f, bias1 = ok ? p.bias[co + 1] : 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r_lo + 8 * h;
          float v0 = d[2 * h] + bias0, v1 = d[2 * h + 1] + bias1;
          if (p.res != nullptr && ok && row0 + r < p.rows) {
            const float2 x2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                p.res + size_t(row0 + r) * p.n + co));
            v0 += x2.x;
            v1 += x2.y;
          }
          *reinterpret_cast<uint32_t*>(Ys + r * LDY + cl) = pack_bf16x2(v0, v1);
        }
      };
#pragma unroll
      for (int j = 0; j < NB / 8; ++j) emit(8 * j + 2 * t4, acc + 4 * j);
#pragma unroll
      for (int j = 0; j < NS / 8; ++j) emit(NB + 8 * j + 2 * t4, acs + 4 * j);
    }
    __syncthreads();
#pragma unroll
    for (int it = 0; it < (GW_BM * (COLS / 8) + GW_THREADS - 1) / GW_THREADS; ++it) {
      const int i = tid + it * GW_THREADS;
      const int r = i / (COLS / 8), c8 = (i % (COLS / 8)) * 8;
      if (r < GW_BM && row0 + r < p.rows && col0 + c8 < p.n)
        *reinterpret_cast<uint4*>(p.out + size_t(row0 + r) * p.n + col0 + c8) =
            *reinterpret_cast<const uint4*>(Ys + r * LDY + c8);
    }
    // the next tile's first barrier orders these reads of Ys before its
    // epilogue writes Ys again
  }
  cp_async_wait_all();
}

// UP: persistent, one block per SM (grid = min(tiles, sms)); down: a block
// per tile.
template <bool UP, int NB, int NS>
static int launch_gemm(const GemmArgs& p, int sms, cudaStream_t stream) {
  typedef GemmShape<UP, NB, NS> S;
  auto kernel = geglu_gemm_kernel<UP, NB, NS>;
  cudaError_t err = set_smem(kernel, S::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = static_cast<long long>((p.n + S::COLS - 1) / S::COLS) *
                          ((p.rows + GW_BM - 1) / GW_BM);
  const long long grid = UP && tiles > sms ? sms : tiles;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(grid), GW_THREADS, S::SMEM, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// One chunk of rows: LN (with ln_scale), up, down.  The caller chooses the
// down pass's output columns per block (320 where C_out % 320 == 0, or 64)
// and the SM count that caps the up pass's grid.
static int geglu_bf16_chunk(const bf16* x, const bf16* w1, const float* b1, const bf16* w2,
                            const float* b2, const float* lns, const float* lnb, bf16* out,
                            bf16* g_buf, bf16* xn, int rows, int c, int inner, int c_out,
                            int residual, int down_cols, int sms, cudaStream_t s) {
  if (sms <= 0 || !(down_cols == 64 || (down_cols == 320 && c_out % 320 == 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (lns != nullptr) {
    geglu_ln_kernel<<<(rows + GF_THREADS / 32 - 1) / (GF_THREADS / 32), GF_THREADS, 0, s>>>(
        x, lns, lnb, xn, rows, c);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  GemmArgs up{lns != nullptr ? xn : x, w1, b1, nullptr, g_buf, rows, c, inner, inner};
  int rc = launch_gemm<true, 256, 0>(up, sms, s);
  if (rc != 0) return rc;
  GemmArgs down{g_buf, w2, b2, residual ? x : nullptr, out, rows, inner, c_out, inner};
  return down_cols == 320 ? launch_gemm<false, 256, 64>(down, sms, s)
                          : launch_gemm<false, 0, 64>(down, sms, s);
}

// ---- f32: the first, fused body ----
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
      Gs[r * L::LDG + j] = from_float<T>(geglu(a, b));
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

template <int BN>
static int launch_geglu_f32(const void* x, const void* w1, const float* b1, const void* w2,
                            const float* b2, const float* lns, const float* lnb, void* out,
                            int n, int c, int inner, int c_out, int residual,
                            cudaStream_t stream) {
  constexpr int BI = 16;
  const size_t smem = FFLayout<float, BI>::smem_bytes(BN, c, c_out);
  auto kernel = geglu_kernel<float, BN, BI>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(n + BN - 1) / BN, FF_THREADS, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w1), b1,
      static_cast<const float*>(w2), b2, lns, lnb, static_cast<float*>(out), n, c, inner, c_out,
      residual);
  return static_cast<int>(cudaGetLastError());
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

// One chunk of n rows: x (n, C), out (n, C_out).  dtype: 0 = float32, 1 =
// bfloat16.  Requires C % 16 == 0, C_out % 8 == 0 and inner % 32 == 0, and
// for f32 C_out <= 1280; ln_scale/ln_bias may be null (no LayerNorm).  bf16
// only: g_scratch holds (n, inner) and ln_scratch (n, C) bf16 (LN only),
// both 16-byte aligned like x, the weights, b1 and out; down_cols (320 or
// 64) is the down pass's output columns per block and sms the up pass's grid
// cap (both unused in f32).  Returns a cudaError_t (0 = launched).
extern "C" int st2v_geglu_ff(const void* x, const void* w1, const float* b1, const void* w2,
                             const float* b2, const float* ln_scale, const float* ln_bias,
                             void* out, void* g_scratch, void* ln_scratch, int n, int c,
                             int inner, int c_out, int residual, int dtype, int down_cols,
                             int sms, void* stream) {
  using namespace st2v;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || c % 16 || c_out % 8 || inner % 32 || c <= 0 || c_out <= 0 || inner <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1) {
    if (g_scratch == nullptr || (ln_scale != nullptr && ln_scratch == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
    return geglu_bf16_chunk(static_cast<const bf16*>(x), static_cast<const bf16*>(w1), b1,
                            static_cast<const bf16*>(w2), b2, ln_scale, ln_bias,
                            static_cast<bf16*>(out), static_cast<bf16*>(g_scratch),
                            static_cast<bf16*>(ln_scratch), n, c, inner, c_out, residual,
                            down_cols, sms, s);
  }
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int bn = block_rows(c_out);
  if (bn == 64) return launch_geglu_f32<64>(x, w1, b1, w2, b2, ln_scale, ln_bias, out, n, c, inner, c_out, residual, s);
  if (bn == 32) return launch_geglu_f32<32>(x, w1, b1, w2, b2, ln_scale, ln_bias, out, n, c, inner, c_out, residual, s);
  if (bn == 16) return launch_geglu_f32<16>(x, w1, b1, w2, b2, ln_scale, ln_bias, out, n, c, inner, c_out, residual, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
