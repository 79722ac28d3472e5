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
// 2*N*inner*C_out flops (1.13 TFLOP at every UNet level of stage 1), on the
// tensor cores in bf16 (1.145 ms at the bf16 peak) and on the FMA units in
// f32 (16.9 ms at the FP32 rate).
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
// The f32 body has the same shape on the FMA units (below): the LN
// statistics, then two passes of one tiled FMA GEMM core.  It replaced the
// first, fused body (a block of 64, 32 or 16 rows holding its whole output
// row in registers, 2 x 2 microtiles fed by scalar shared loads, W1 and W2
// streamed from L2 once per block; PERF.md).
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

// ---- f32: LN statistics, then two passes of one tiled FMA GEMM core ----
//
// Full f32 on the FMA units (no TF32), so bound by the FP32 rate: 24 n C^2
// flops at inner = 4C against 4 bytes an element.  A tile is GT_BM rows x
// GT_BN columns, 256 threads, each an 8 x 8 register microtile (rows 4 ty ..
// 4 ty + 3 and 64 + 4 ty .., columns 4 tx .. and 64 + 4 tx .., so that the
// eight column groups a warp reads lie in 128 consecutive bytes).  Both
// operands are stored with the contraction axis as rows, A as [k][row] and B
// as [k][column], so a thread's 8 + 8 fragment values of a k are four 128-bit
// shared loads feeding 64 FMAs: 1 byte loaded a FMA, what shared memory
// feeds at the FMA rate.  B arrives by `cp.async` from the wrapper's k-major
// repack; A is row-major in HBM (x or G), so it goes through registers in
// 128-bit loads (four k of one row) and is stored transposed.  Two buffers:
// the next step's B copies and A loads are in flight under this step's FMAs,
// one barrier a step; two blocks an SM (at most 128 registers a thread).
// Larger lane tiles (8 x 16 and 16 x 8, 0.75 bytes a FMA, one block an SM)
// ran only 1-2% faster on the H100 and were not kept (PERF.md).
//   - `geglu_stats_kernel` (with LN): one warp a row, the mean and rstd in
//     one sweep (8 bytes a row); the up pass normalises A while it stages it
//     through registers, once per staged element (C / 16 times per element
//     of x at inner = 4C: 3 instructions against every 128 FMAs), which
//     saves the round trip of an f32 LN(x) scratch (1.18 GB at stage 1's
//     level 0);
//   - pass "up" (`geglu_f32_gemm_kernel<true>`): A = x (LN applied), B = W1
//     repacked as (C, 2 * inner64), each 128 columns 64 of W1's a slab then
//     the matching 64 of its b slab (zero past inner), so a lane's columns
//     j < 4 are a and j >= 4 b of the same four G columns; the epilogue adds
//     b1, computes a * gelu_erf(b) in f32 (`erff`) and stores G in f32, 128
//     bits at a time;
//   - pass "down" (`geglu_f32_gemm_kernel<false>`): A = G, B = W2^T (inner,
//     C_out); the epilogue adds b2 (and x) and stores 128 bits at a time.
//     The column tile is 128 and the ragged last tile is computed whole, its
//     absent columns zero-filled and not stored: at C_out = 320 the third
//     tile is half empty (the down pass does 1/3 of the flops, so 6.7% more
//     FMAs in all); 640 and 1280 divide.
// G is f32 scratch of one chunk of rows (whole waves of the down pass, at most
// `G_CHUNK_BYTES`), as in bf16.  Zero fill covers the ragged rows, the K tail
// and the absent columns.
constexpr int GT_THREADS = 256;
constexpr int GT_BM = 128;            // tile rows
constexpr int GT_BN = 128;            // tile columns (up: 64 a + 64 b, i.e. 64 G columns)
constexpr int GT_BK = 16;             // contraction a step
constexpr int GT_LDA = GT_BM + 4;     // A rows: the transposed stores of 8 neighbouring
                                      // rows x 4 k fall 2-way at most
constexpr int GT_LDB = GT_BN;         // B rows: every lane of a load reads one row
constexpr int GT_BLOCKS = 2;          // blocks an SM: at most 128 registers a thread
constexpr size_t GT_SMEM = sizeof(float) * 2 * (size_t(GT_BK) * GT_LDA + size_t(GT_BK) * GT_LDB);
static_assert(GT_BLOCKS * (GT_SMEM + 1024) <= 233472, "two blocks' shared memory per SM");
static_assert(GT_BM == GW_BM, "the chunk plan counts one tile height (ROW_TILE)");

struct GemmF32Args {
  const float* a;          // up: x chunk (rows, k = C); down: G (rows, k = inner)
  const float2* stats;     // up with LN: (mean, rstd) a row; else null
  const float* ln_scale;   // up with LN: (C,)
  const float* ln_bias;
  const float* b;          // up: W1 repacked (C, ldb = 2 * inner64); down: W2^T (inner, ldb = C_out)
  const float* bias;       // up: b1 (2 * inner); down: b2 (C_out)
  const float* res;        // down: x chunk for the residual, or null
  float* out;              // up: G (rows, inner); down: out chunk (rows, C_out)
  int rows, k, ldb, n, inner;  // n: valid output columns (up: inner; down: C_out)
};

// One warp a row: mean and rstd of x in one sweep (one-pass statistics
// clamped at 0, eps 1e-5).
__global__ void __launch_bounds__(GF_THREADS)
geglu_stats_kernel(const float* __restrict__ x, float2* __restrict__ stats, int n, int c) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * (GF_THREADS / 32) + warp;
  if (row >= n) return;
  const float* xr = x + size_t(row) * c;
  float s1 = 0.f, s2 = 0.f;
  for (int col = lane * 4; col < c; col += 128) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(xr + col));
    s1 += (v.x + v.y) + (v.z + v.w);
    s2 = fmaf(v.x, v.x, fmaf(v.y, v.y, fmaf(v.z, v.z, fmaf(v.w, v.w, s2))));
  }
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  const float mean = s1 / c;
  if (lane == 0)
    stats[row] = make_float2(mean, rsqrtf(fmaxf(s2 / c - mean * mean, 0.f) + 1e-5f));
}

// A block is one tile (column blocks fastest, so the blocks at work share
// their rows of A in L2).
template <bool UP>
__global__ void __launch_bounds__(GT_THREADS, GT_BLOCKS)
geglu_f32_gemm_kernel(const GemmF32Args p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* As = reinterpret_cast<float*>(smem_raw);  // [2][GT_BK][GT_LDA]
  float* Bs = As + 2 * GT_BK * GT_LDA;             // [2][GT_BK][GT_LDB]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tx = (warp & 1) * 8 + (lane & 7);   // column group, 0..15
  const int ty = (warp >> 1) * 4 + (lane >> 3);  // row group, 0..15
  const int col_blocks = (p.ldb + GT_BN - 1) / GT_BN;
  const int row0 = (blockIdx.x / col_blocks) * GT_BM;
  const int col0 = (blockIdx.x % col_blocks) * GT_BN;  // B's first column
  const int steps = (p.k + GT_BK - 1) / GT_BK;

  // A staging: thread i's two float4 are rows i / 4 and 64 + i / 4, k
  // 4 (i % 4) .. of the step's 16
  const int xc = (tid & 3) * 4, xs = tid >> 2;
  const bool rin0 = row0 + xs < p.rows, rin1 = row0 + xs + 64 < p.rows;
  const float* a_src = p.a + size_t(row0 + xs) * p.k + xc;
  const size_t a_half = size_t(64) * p.k;  // rows xs + 64
  const bool ln = UP && p.stats != nullptr;
  float2 st0 = make_float2(0.f, 0.f), st1 = st0;
  if (ln) {
    if (rin0) st0 = p.stats[row0 + xs];
    if (rin1) st1 = p.stats[row0 + xs + 64];
  }
  float4 xr0, xr1;
  auto load_a = [&](int step) {
    const bool kin = step * GT_BK + xc < p.k;
    const float* src = a_src + step * GT_BK;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    xr0 = rin0 && kin ? __ldg(reinterpret_cast<const float4*>(src)) : zero;
    xr1 = rin1 && kin ? __ldg(reinterpret_cast<const float4*>(src + a_half)) : zero;
  };
  auto store_a = [&](int step, int buf) {
    const int kc = step * GT_BK + xc;
    if (ln && kc < p.k) {  // rows past the chunk stay zero
      const float4 s = __ldg(reinterpret_cast<const float4*>(p.ln_scale + kc));
      const float4 b = __ldg(reinterpret_cast<const float4*>(p.ln_bias + kc));
      if (rin0) {
        xr0.x = fmaf((xr0.x - st0.x) * st0.y, s.x, b.x);
        xr0.y = fmaf((xr0.y - st0.x) * st0.y, s.y, b.y);
        xr0.z = fmaf((xr0.z - st0.x) * st0.y, s.z, b.z);
        xr0.w = fmaf((xr0.w - st0.x) * st0.y, s.w, b.w);
      }
      if (rin1) {
        xr1.x = fmaf((xr1.x - st1.x) * st1.y, s.x, b.x);
        xr1.y = fmaf((xr1.y - st1.x) * st1.y, s.y, b.y);
        xr1.z = fmaf((xr1.z - st1.x) * st1.y, s.z, b.z);
        xr1.w = fmaf((xr1.w - st1.x) * st1.y, s.w, b.w);
      }
    }
    float* d = As + buf * GT_BK * GT_LDA + xc * GT_LDA + xs;
    d[0] = xr0.x;
    d[GT_LDA] = xr0.y;
    d[2 * GT_LDA] = xr0.z;
    d[3 * GT_LDA] = xr0.w;
    d[64] = xr1.x;
    d[64 + GT_LDA] = xr1.y;
    d[64 + 2 * GT_LDA] = xr1.z;
    d[64 + 3 * GT_LDA] = xr1.w;
  };
  // B staging: thread i copies k rows i / 32 and 8 + i / 32, columns 4 (i % 32) ..
  const int wrow = tid >> 5, wcol = (tid & 31) * 4;
  const bool cin = col0 + wcol < p.ldb;  // ldb % 4 == 0: a group is whole or absent
  const float* b_src = p.b + size_t(wrow) * p.ldb + col0 + wcol;
  auto load_b = [&](int step, int buf) {
    float* d = Bs + buf * GT_BK * GT_LDB + wrow * GT_LDB + wcol;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int kr = step * GT_BK + wrow + 8 * r;
      const bool ok = cin && kr < p.k;
      cp_async_16(d + 8 * r * GT_LDB, ok ? b_src + size_t(step * GT_BK + 8 * r) * p.ldb : p.b,
                  ok);
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  load_b(0, 0);
  cp_async_commit();
  load_a(0);
  store_a(0, 0);
  cp_async_wait_all();
  __syncthreads();
  for (int step = 0; step < steps; ++step) {
    const int buf = step & 1;
    const bool more = step + 1 < steps;
    if (more) {  // the other buffers were last read before the previous barrier
      load_b(step + 1, buf ^ 1);
      cp_async_commit();
      load_a(step + 1);
    }
    const float* A = As + buf * GT_BK * GT_LDA + 4 * ty;
    const float* B = Bs + buf * GT_BK * GT_LDB + 4 * tx;
#pragma unroll
    for (int kk = 0; kk < GT_BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(A + kk * GT_LDA);
      const float4 a1 = *reinterpret_cast<const float4*>(A + kk * GT_LDA + 64);
      const float4 b0 = *reinterpret_cast<const float4*>(B + kk * GT_LDB);
      const float4 b1 = *reinterpret_cast<const float4*>(B + kk * GT_LDB + 64);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (more) store_a(step + 1, buf ^ 1);
    cp_async_wait_all();
    __syncthreads();
  }

  // row i of the microtile: 4 ty + (i & 3) + 64 (i >> 2)
  if constexpr (UP) {
    // columns j < 4 are a and j >= 4 b of G columns gc .. gc + 3
    const int gc = col0 / 2 + 4 * tx;
    if (gc >= p.n) return;  // inner % 4 == 0: a group is whole or absent
    const float4 ba = __ldg(reinterpret_cast<const float4*>(p.bias + gc));
    const float4 bb = __ldg(reinterpret_cast<const float4*>(p.bias + p.inner + gc));
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = row0 + 4 * ty + (i & 3) + 64 * (i >> 2);
      if (row >= p.rows) continue;
      *reinterpret_cast<float4*>(p.out + size_t(row) * p.n + gc) =
          make_float4(geglu(acc[i][0] + ba.x, acc[i][4] + bb.x),
                      geglu(acc[i][1] + ba.y, acc[i][5] + bb.y),
                      geglu(acc[i][2] + ba.z, acc[i][6] + bb.z),
                      geglu(acc[i][3] + ba.w, acc[i][7] + bb.w));
    }
  } else {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int co = col0 + 4 * tx + 64 * h;
      if (co >= p.n) continue;  // C_out % 4 == 0: a group is whole or absent
      const float4 bv = __ldg(reinterpret_cast<const float4*>(p.bias + co));
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int row = row0 + 4 * ty + (i & 3) + 64 * (i >> 2);
        if (row >= p.rows) continue;
        const size_t idx = size_t(row) * p.n + co;
        float4 y = make_float4(acc[i][4 * h] + bv.x, acc[i][4 * h + 1] + bv.y,
                               acc[i][4 * h + 2] + bv.z, acc[i][4 * h + 3] + bv.w);
        if (p.res != nullptr) {
          const float4 r = __ldg(reinterpret_cast<const float4*>(p.res + idx));
          y.x += r.x;
          y.y += r.y;
          y.z += r.z;
          y.w += r.w;
        }
        *reinterpret_cast<float4*>(p.out + idx) = y;
      }
    }
  }
}

template <bool UP>
static int launch_gemm_f32(const GemmF32Args& p, cudaStream_t stream) {
  auto kernel = geglu_f32_gemm_kernel<UP>;
  cudaError_t err = set_smem(kernel, GT_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = static_cast<long long>((p.ldb + GT_BN - 1) / GT_BN) *
                          ((p.rows + GT_BM - 1) / GT_BM);
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(tiles), GT_THREADS, GT_SMEM, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// One chunk of rows: the LN statistics (with ln_scale), up, down.  w1p is W1
// repacked (C, 2 * inner64) and w2t W2^T (inner, C_out), both by the wrapper.
static int geglu_f32_chunk(const float* x, const float* w1p, const float* b1, const float* w2t,
                           const float* b2, const float* lns, const float* lnb, float* out,
                           float* g_buf, float2* stats, int rows, int c, int inner, int c_out,
                           int residual, cudaStream_t s) {
  if (lns != nullptr) {
    geglu_stats_kernel<<<(rows + GF_THREADS / 32 - 1) / (GF_THREADS / 32), GF_THREADS, 0, s>>>(
        x, stats, rows, c);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int ldb1 = 2 * ((inner + 63) / 64 * 64);
  GemmF32Args up{x, lns != nullptr ? stats : nullptr, lns, lnb, w1p, b1, nullptr, g_buf,
                 rows, c, ldb1, inner, inner};
  const int rc = launch_gemm_f32<true>(up, s);
  if (rc != 0) return rc;
  GemmF32Args down{g_buf, nullptr, nullptr, nullptr, w2t, b2, residual ? x : nullptr, out,
                   rows, inner, c_out, c_out, inner};
  return launch_gemm_f32<false>(down, s);
}

}  // namespace st2v

// One chunk of n rows: x (n, C), out (n, C_out).  dtype: 0 = float32, 1 =
// bfloat16.  Requires C % 16 == 0, C_out % 8 == 0 and inner % 32 == 0;
// ln_scale/ln_bias may be null (no LayerNorm).  g_scratch holds G (n, inner)
// in x's dtype; all pointers 16-byte aligned.  bf16: w1 (2*inner, C) and w2
// (C_out, inner) as torch's Linear holds them, ln_scratch (n, C) bf16 for
// LN(x) (LN only), down_cols (320 or 64) the down pass's output columns per
// block and sms the up pass's grid cap.  f32: w1 repacked (C, 2*inner64)
// and w2 as W2^T (inner, C_out) (`fused_ff.f32_operands`), ln_scratch (n, 2)
// f32 for each row's mean and rstd (LN only); down_cols and sms unused.
// Returns a cudaError_t (0 = launched).
extern "C" int st2v_geglu_ff(const void* x, const void* w1, const float* b1, const void* w2,
                             const float* b2, const float* ln_scale, const float* ln_bias,
                             void* out, void* g_scratch, void* ln_scratch, int n, int c,
                             int inner, int c_out, int residual, int dtype, int down_cols,
                             int sms, void* stream) {
  using namespace st2v;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || c % 16 || c_out % 8 || inner % 32 || c <= 0 || c_out <= 0 || inner <= 0 ||
      g_scratch == nullptr || (ln_scale != nullptr && (ln_bias == nullptr || ln_scratch == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1)
    return geglu_bf16_chunk(static_cast<const bf16*>(x), static_cast<const bf16*>(w1), b1,
                            static_cast<const bf16*>(w2), b2, ln_scale, ln_bias,
                            static_cast<bf16*>(out), static_cast<bf16*>(g_scratch),
                            static_cast<bf16*>(ln_scratch), n, c, inner, c_out, residual,
                            down_cols, sms, s);
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  return geglu_f32_chunk(static_cast<const float*>(x), static_cast<const float*>(w1), b1,
                         static_cast<const float*>(w2), b2, ln_scale, ln_bias,
                         static_cast<float*>(out), static_cast<float*>(g_scratch),
                         static_cast<float2*>(ln_scratch), n, c, inner, c_out, residual, s);
}
