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
// The bf16 body (`temporal_conv_bf16_wgmma_kernel`).  A tile is one output
// frame of one batch row: 128 positions x 320 output channels (every channel
// of a UNet level's block, as one m64n256k16 and one m64n64k16 product per 16
// channels; 128 or 64 columns at other widths, `conv_tile_cols` in the
// wrapper).  Its contraction runs over the taps whose input frame exists (the
// zero SAME padding is a skipped tap) and, within each, C in 64-channel
// steps: the kt input frames are staged through the ring, not held, because
// a rolling window of kt output-frame accumulators at 320 columns would need
// kt x 160 f32 registers a thread.  So one tile's accumulators are 160
// registers a thread; the 256 + 64 instance builds at 255 registers with 8
// bytes of spill (its epilogue issues 16 residual loads at once, so their
// latencies overlap; 4 at once spilled nothing but ran slower).  Two warpgroups take
// 64 positions each; both operands are read by `wgmma.mma_async` from shared
// memory in the 128-byte swizzle: the step's x tile (128 x 64) and the tap's
// W rows, which the wrapper repacks tap-major and K-major, (kt, C_out, C).
// The 320-column tile makes W 40 KB of the 56 KB a step stages, against 24 of
// 40 KB for 64 columns, and every x tile staged feeds all 320 columns.
// Operands arrive by 16-byte `cp.async` into a ring of 3 stages (4 at the
// narrower tiles); each thread fences its landed copies to the async proxy
// (`fence.proxy.async.shared::cta`) before the stage's barrier, and one group
// of products stays in flight while the next stage is published.  The
// GroupNorm+SiLU prologue runs in place in shared memory on the elements a
// thread copied, after its own wait and before the same fence (wgmma reads
// the result); it runs once per staged element, so kt times per input
// element at C_out <= 320.  The grid is persistent (one block per SM walks
// tiles, output-channel blocks fastest), the copies run ahead across tile
// boundaries, and the bias and `res + res_w * y` epilogue store from
// registers, so the next tile's first stages land during it.
//
// It replaced an earlier `mma.sync` body (128 positions x 64 output channels
// for every frame, a rolling window of kt accumulators), which it beat at
// both main-path shapes on the H100 (PERF.md).
//
// The f32 body (`temporal_conv_f32_kernel`: the stage-1 temporal VAE
// decoder under the reference's f32 decode) runs full f32 on the FMA units,
// no TF32, so it is bound by the FP32 rate at every width the decoder has
// (2 * kt * C flops a row and output channel against 4 bytes).  It is the
// same implicit GEMM on 128 x 128 tiles with 8 x 8 register microtiles fed by
// 128-bit shared loads (four loads a 64 FMAs), below.  It replaced the
// first f32 body (16 positions x 32 output channels a block, one shared load
// an FMA, the prologue recomputed for every 32-column block; PERF.md).
#include "common.cuh"

namespace st2v {

__device__ __forceinline__ float silu_fast(float y) {
  float th;
  asm("tanh.approx.f32 %0, %1;" : "=f"(th) : "f"(0.5f * y));
  return 0.5f * y * (1.f + th);  // y * sigmoid(y)
}

// ---- bf16 on wgmma: an implicit GEMM with the taps in the contraction ----
constexpr int TW_THREADS = 256;      // two warpgroups, 64 positions each
constexpr int TW_BM = 128;           // positions per tile
constexpr int TW_BK = 64;            // channels per step: one 128-byte swizzle row
constexpr int TW_SMEM = 220 * 1024;  // the ring's budget: one block per SM

// A stage holds the step's x tile (TW_BM positions x TW_BK channels) and W
// tile (BN output channels x TW_BK channels), both K-major in the 128-byte
// swizzle (`sw128_off`, `gmma_desc`).  BN = NB + NS output channels go
// through one m64nNBk16 (NB = 256, 128 or 0) and one m64nNSk16 (NS = 64 or 0)
// per 16 channels.
template <int NB, int NS>
struct TWShape {
  static constexpr int BN = NB + NS;
  static constexpr int A_BYTES = TW_BM * TW_BK * 2, B_BYTES = BN * TW_BK * 2;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int FIT = (TW_SMEM - 1024) / STAGE_BYTES;
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static constexpr size_t SMEM = size_t(STAGES) * STAGE_BYTES + 1024;  // + alignment
  static_assert(STAGE_BYTES % 1024 == 0 && STAGES >= 3, "stages start on swizzle atoms");
  static_assert(SMEM <= 232448, "a block's 227 KB of shared memory");
};

struct ConvArgs {
  const bf16* x;        // (B, T, S, C), C % 8 == 0
  const bf16* w;        // (kt, C_out, C): tap-major, each output channel's row K-major
  const float* bias;    // (C_out,)
  const float* pre_a;   // (B, C) or null
  const float* pre_b;
  const bf16* res;      // (B, T, S, C_out) or null
  const float* res_w;   // (B, T)
  bf16* out;            // (B, T, S, C_out)
  int batch, t_len, s_len, c, c_out, kt;
};

// A tile is one output frame t of one batch row: TW_BM positions x BN output
// channels, contraction over the taps k whose input frame t + k - kt/2 exists
// (the zero padding is a skipped tap) and, within each, C in TW_BK steps.  A
// block walks tiles blockIdx.x, + gridDim.x, ... (output-channel blocks
// fastest, then positions, frames, batch rows, so the blocks at work share
// their x frames in L2); its copies run STAGES - 1 steps ahead of the products
// across tile boundaries, and a tile's epilogue stores from registers, so the
// next tile's first stages land while it runs.
template <int NB, int NS>
__global__ void __launch_bounds__(TW_THREADS, 1)
temporal_conv_bf16_wgmma_kernel(const ConvArgs p) {
  typedef TWShape<NB, NS> S;
  constexpr int BN = S::BN, STAGES = S::STAGES;
  constexpr int A_IT = TW_BM / 32, B_IT = BN / 32;  // 16-byte copies per thread per stage
  extern __shared__ __align__(16) unsigned char smem_dyn[];
  // the swizzle atoms need 1024-byte alignment (the launch adds the slack)
  unsigned char* smem_raw = smem_dyn + ((1024 - (smem_u32(smem_dyn) & 1023)) & 1023);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wg = warp >> 2;  // warpgroup: tile rows wg*64 ..
  // this thread's copies: rows cr + 32*it, channels [cc, cc + 8), at byte
  // my_off + 4096*it of the tile (8 neighbouring threads copy one row)
  const int cr = tid >> 3, cc = (tid & 7) * 8;
  const int my_off = sw128_off(cr, tid & 7);
  const int lo = p.kt / 2;
  const int col_blocks = (p.c_out + BN - 1) / BN;
  const int row_blocks = (p.s_len + TW_BM - 1) / TW_BM;
  const int tiles = col_blocks * row_blocks * p.t_len * p.batch;
  const size_t frame = size_t(p.s_len) * p.c;  // x elements a frame
  const size_t tap = size_t(p.c_out) * p.c;    // W elements a tap
  const size_t rstep = size_t(32) * p.c;       // 32 rows of x or W

  // tile -> output channel, position, frame, batch row
  auto tile_co0 = [&](int tile) { return (tile % col_blocks) * BN; };
  auto tile_s0 = [&](int tile) { return (tile / col_blocks % row_blocks) * TW_BM; };
  auto tile_t = [&](int tile) { return tile / (col_blocks * row_blocks) % p.t_len; };
  auto tile_b = [&](int tile) { return tile / (col_blocks * row_blocks) / p.t_len; };

  // the loader: its tile, tap and channel step, the ring slot it fills next,
  // and its copies' first sources (frame 0, tap 0) and rows that exist
  int l_tile = blockIdx.x, l_slot = 0, l_t = 0, l_k = 0, l_k_end = 0, l_kc = 0;
  const bf16* a_src = p.x;
  const bf16* b_src = p.w;
  uint32_t a_ok = 0, b_ok = 0;
  auto start_tile = [&]() {
    const int s0 = tile_s0(l_tile), co0 = tile_co0(l_tile);
    l_t = tile_t(l_tile);
    l_k = max(0, lo - l_t);
    l_k_end = min(p.kt - 1, p.t_len - 1 - l_t + lo);
    l_kc = 0;
    a_src = p.x + (size_t(tile_b(l_tile)) * p.t_len * p.s_len + s0 + cr) * p.c + cc;
    b_src = p.w + size_t(co0 + cr) * p.c + cc;
    a_ok = b_ok = 0;
#pragma unroll
    for (int it = 0; it < A_IT; ++it)
      if (s0 + cr + 32 * it < p.s_len) a_ok |= 1u << it;
#pragma unroll
    for (int it = 0; it < B_IT; ++it)
      if (co0 + cr + 32 * it < p.c_out) b_ok |= 1u << it;
  };
  auto load_next = [&]() {
    if (l_tile < tiles) {
      unsigned char* As = smem_raw + l_slot * S::STAGE_BYTES;
      unsigned char* Bs = As + S::A_BYTES;
      const bool kin = l_kc + cc < p.c;
      const bf16* a = a_src + size_t(l_t + l_k - lo) * frame + l_kc;
      const bf16* bw = b_src + size_t(l_k) * tap + l_kc;
#pragma unroll
      for (int it = 0; it < A_IT; ++it) {
        const bool ok = kin && ((a_ok >> it) & 1u);
        cp_async_16(As + my_off + 4096 * it, ok ? a + it * rstep : p.x, ok);
      }
#pragma unroll
      for (int it = 0; it < B_IT; ++it) {
        const bool ok = kin && ((b_ok >> it) & 1u);
        cp_async_16(Bs + my_off + 4096 * it, ok ? bw + it * rstep : p.w, ok);
      }
      l_kc += TW_BK;
      if (l_kc >= p.c) {
        l_kc = 0;
        if (++l_k > l_k_end) {
          l_tile += gridDim.x;
          if (l_tile < tiles) start_tile();
        }
      }
    }
    cp_async_commit();  // one group per step, empty past the last tile
    l_slot = l_slot + 1 == STAGES ? 0 : l_slot + 1;
  };
  // the GroupNorm+SiLU prologue, in place on the x elements this thread
  // copied (landed: its own wait came first); the zero-filled channels past C
  // stay zero, and rows past S are never stored
  auto prologue = [&](unsigned char* As, int b, int kc) {
    const int ch = kc + cc;
    if (ch >= p.c) return;
    const float4* pa = reinterpret_cast<const float4*>(p.pre_a + size_t(b) * p.c + ch);
    const float4* pb = reinterpret_cast<const float4*>(p.pre_b + size_t(b) * p.c + ch);
    const float4 a0 = __ldg(pa), a1 = __ldg(pa + 1), b0 = __ldg(pb), b1 = __ldg(pb + 1);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int it = 0; it < A_IT; ++it) {
      uint4* q = reinterpret_cast<uint4*>(As + my_off + 4096 * it);
      uint4 raw = *q;
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 fv = __bfloat1622float2(h[e]);
        h[e] = __floats2bfloat162_rn(silu_fast(fmaf(fv.x, av[2 * e], bv[2 * e])),
                                     silu_fast(fmaf(fv.y, av[2 * e + 1], bv[2 * e + 1])));
      }
      *q = raw;
    }
  };

  float acc[NB > 0 ? NB / 2 : 1];  // the m64nNBk16 accumulator
  float acs[NS > 0 ? NS / 2 : 1];  // the m64nNSk16 accumulator
  if (l_tile < tiles) start_tile();
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) load_next();
  const int chunks = (p.c + TW_BK - 1) / TW_BK;
  const bool pairs = (p.c_out & 1) == 0;
  int slot = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int co0 = tile_co0(tile), s0 = tile_s0(tile), t = tile_t(tile), b = tile_b(tile);
    const int steps = (min(p.kt - 1, p.t_len - 1 - t + lo) - max(0, lo - t) + 1) * chunks;
    int kc = 0;
    for (int i = 0; i < steps; ++i) {
      cp_async_wait_group<STAGES - 2>();  // this thread's copies of this step landed
      unsigned char* As = smem_raw + slot * S::STAGE_BYTES;
      if (p.pre_a != nullptr) prologue(As, b, kc);
      fence_proxy_async();  // the copies and the prologue's writes, to wgmma
      __syncthreads();      // the step is complete for all
      const uint32_t a0 = smem_u32(As) + wg * 64 * 128;
      const uint32_t b0 = smem_u32(As + S::A_BYTES);
      gmma_fence();
#pragma unroll
      for (int kk = 0; kk < TW_BK / 16; ++kk) {
        const uint64_t da = gmma_desc(a0 + kk * 32);
        const int scale = i > 0 || kk > 0;  // the tile's first product overwrites
        if constexpr (NB == 256) wgmma_m64n256k16(acc, da, gmma_desc(b0 + kk * 32), scale);
        if constexpr (NB == 128) wgmma_m64n128k16(acc, da, gmma_desc(b0 + kk * 32), scale);
        if constexpr (NS == 64) wgmma_m64n64k16(acs, da, gmma_desc(b0 + NB * 128 + kk * 32), scale);
      }
      gmma_commit();
      // the previous step's products are done (this step's run on), in every
      // warpgroup: its slot takes the copies STAGES - 1 steps ahead
      gmma_wait<1>();
      __syncthreads();
      load_next();
      slot = slot + 1 == STAGES ? 0 : slot + 1;
      kc = kc + TW_BK >= p.c ? 0 : kc + TW_BK;
    }
    gmma_wait<0>();
    fence_regs(acc);
    fence_regs(acs);

    // the epilogue from registers: a thread holds, of each 8-column block j
    // of its accumulator, rows r (elements 0, 1) and r + 8 (2, 3) at columns
    // 8j + 2*t4 and + 1.  The residual loads of EPI_GROUP blocks are issued
    // together, so their latencies overlap.
    const float rw = p.res != nullptr ? p.res_w[size_t(b) * p.t_len + t] : 0.f;
    const int r_lo = wg * 64 + (warp & 3) * 16 + g;
    const size_t row0 = ((size_t(b) * p.t_len + t) * p.s_len + s0 + r_lo) * p.c_out + co0;
    const bool rows_in[2] = {s0 + r_lo < p.s_len, s0 + r_lo + 8 < p.s_len};
    const size_t row_step = size_t(8) * p.c_out;  // row r_lo + 8
    constexpr int BLOCKS = NB / 8 + NS / 8, EPI_GROUP = 8;
    static_assert(BLOCKS % EPI_GROUP == 0, "whole groups of column blocks");
#pragma unroll
    for (int j0 = 0; j0 < BLOCKS; j0 += EPI_GROUP) {
      __nv_bfloat162 rv[EPI_GROUP][2];
      if (pairs && p.res != nullptr) {
#pragma unroll
        for (int jj = 0; jj < EPI_GROUP; ++jj) {
          const int cl = 8 * (j0 + jj) + 2 * t4;
#pragma unroll
          for (int h = 0; h < 2; ++h)
            if (co0 + cl < p.c_out && rows_in[h])
              rv[jj][h] = *reinterpret_cast<const __nv_bfloat162*>(p.res + row0 + h * row_step + cl);
        }
      }
#pragma unroll
      for (int jj = 0; jj < EPI_GROUP; ++jj) {
        const int j = j0 + jj;
        const float* d = j < NB / 8 ? acc + 4 * j : acs + 4 * (j - NB / 8);
        const int cl = 8 * j + 2 * t4, co = co0 + cl;
        if (co >= p.c_out) continue;
        const bool two = co + 1 < p.c_out;
        const float bias0 = p.bias[co], bias1 = two ? p.bias[co + 1] : 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (!rows_in[h]) continue;
          const size_t idx = row0 + h * row_step + cl;
          float y0 = d[2 * h] + bias0, y1 = d[2 * h + 1] + bias1;
          if (pairs) {  // co is even, so co + 1 < C_out and the pair is 4-byte aligned
            if (p.res != nullptr) {
              const float2 r2 = __bfloat1622float2(rv[jj][h]);
              y0 = r2.x + rw * y0;
              y1 = r2.y + rw * y1;
            }
            *reinterpret_cast<__nv_bfloat162*>(p.out + idx) = __floats2bfloat162_rn(y0, y1);
          } else {
            if (p.res != nullptr) y0 = __bfloat162float(p.res[idx]) + rw * y0;
            p.out[idx] = __float2bfloat16(y0);
            if (two) {
              if (p.res != nullptr) y1 = __bfloat162float(p.res[idx + 1]) + rw * y1;
              p.out[idx + 1] = __float2bfloat16(y1);
            }
          }
        }
      }
    }
  }
  cp_async_wait_all();
}

// Persistent: one block per SM (grid = min(tiles, sms)).
template <int NB, int NS>
static int launch_tc_wgmma(const ConvArgs& a, int sms, cudaStream_t stream) {
  typedef TWShape<NB, NS> S;
  auto kernel = temporal_conv_bf16_wgmma_kernel<NB, NS>;
  cudaError_t err = set_smem(kernel, S::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = static_cast<long long>((a.c_out + S::BN - 1) / S::BN) *
                          ((a.s_len + TW_BM - 1) / TW_BM) * a.t_len * a.batch;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = tiles < sms ? static_cast<int>(tiles) : sms;
  kernel<<<grid, TW_THREADS, S::SMEM, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ---- f32: an implicit GEMM on the FMA units ----
//
// A tile is one output frame t of one batch row: TF_BM positions x TF_BN
// output channels, 256 threads, each an 8 x 8 register microtile (rows
// 4 ty .. 4 ty + 3 and 64 + 4 ty .., columns 4 tx .. and 64 + 4 tx .., so
// that the eight column groups a warp reads lie in 128 consecutive bytes).
// The contraction runs over the taps whose input frame exists and, within
// each, over C in TF_BK-channel steps.  Both operands are stored with the
// contraction axis as rows: A (x) as [channel][position], B (W) as
// [channel][output channel], so a thread's 8 + 8 fragment values of a step
// are four 128-bit shared loads feeding 64 FMAs.  W rows arrive by
// `cp.async`; x goes through registers in 128-bit loads (four channels of
// one position), the GroupNorm+SiLU prologue is applied there, once per
// staged element, and the four values are stored transposed.  Two buffers:
// the next step's W copies and x loads are in flight under this step's
// FMAs, one barrier a step.  The epilogue (bias, then res + res_w * y)
// stores 128-bit vectors where C_out % 4 == 0.  C must be a multiple of 4
// (the wrapper zero-pads x's channels) and W is (kt, C, C_out4), zero past
// C_out (C_out4 = C_out rounded up to 4).
constexpr int TF_THREADS = 256;
constexpr int TF_BM = 128;            // positions a tile
constexpr int TF_BN = 128;            // output channels a tile
constexpr int TF_BK = 16;             // input channels a contraction step
constexpr int TF_LDA = TF_BM + 4;     // A rows: the transposed stores of 8 neighbouring
                                      // positions x 4 channels fall 2-way at most
constexpr int TF_LDB = TF_BN;         // B rows: every lane of a load reads one row
constexpr int TF_BLOCKS = 2;          // blocks an SM: at most 128 registers a thread
constexpr size_t TF_SMEM = sizeof(float) * 2 * (size_t(TF_BK) * TF_LDA + size_t(TF_BK) * TF_LDB);
static_assert(TF_BLOCKS * (TF_SMEM + 1024) <= 233472, "two blocks' shared memory per SM");

struct ConvF32Args {
  const float* x;       // (B, T, S, C), C % 4 == 0
  const float* w;       // (kt, C, C_out4)
  const float* bias;    // (C_out,)
  const float* pre_a;   // (B, C) or null
  const float* pre_b;
  const float* res;     // (B, T, S, C_out) or null
  const float* res_w;   // (B, T)
  float* out;           // (B, T, S, C_out)
  int batch, t_len, s_len, c, c_out, c_out4, kt;
};

// y * sigmoid(y) in a few ulp: `ex2.approx` and an approximate divide (an
// IEEE expf and divide would cost the FMA units a quarter of a step's issue
// slots); for y below about -87 the divisor's 2^126 and up give 0
__device__ __forceinline__ float silu_f32(float y) { return __fdividef(y, 1.f + __expf(-y)); }

__global__ void __launch_bounds__(TF_THREADS, TF_BLOCKS)
temporal_conv_f32_kernel(const ConvF32Args p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* As = reinterpret_cast<float*>(smem_raw);  // [2][TF_BK][TF_LDA]
  float* Bs = As + 2 * TF_BK * TF_LDA;             // [2][TF_BK][TF_LDB]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tx = (warp & 1) * 8 + (lane & 7);   // column group, 0..15
  const int ty = (warp >> 1) * 4 + (lane >> 3);  // row group, 0..15
  // tiles: output-channel blocks fastest, then frames (the kt frames a
  // tile reads are read by its neighbours at about the same time), then
  // position blocks, then batch rows
  const int n_co = (p.c_out + TF_BN - 1) / TF_BN;
  const int n_s = (p.s_len + TF_BM - 1) / TF_BM;
  unsigned int id = blockIdx.x;
  const int cb = id % n_co;
  id /= n_co;
  const int t = id % p.t_len;
  id /= p.t_len;
  const int s0 = (id % n_s) * TF_BM;
  const int b = id / n_s;
  const int co0 = cb * TF_BN;
  const int lo = p.kt / 2;
  const int k_first = max(0, lo - t), k_last = min(p.kt - 1, p.t_len - 1 - t + lo);
  const int n_c = (p.c + TF_BK - 1) / TF_BK;
  const int steps = (k_last - k_first + 1) * n_c;

  // x staging: thread i's two float4 are positions (i + 256 r) / 4, channels
  // 4 ((i + 256 r) % 4) of the step's 16
  const int xc = (tid & 3) * 4;
  const int xs = tid >> 2;  // and xs + 64
  float4 xr[2];
  auto load_x = [&](int step) {
    const int ts = t + k_first + step / n_c - lo, ch = (step % n_c) * TF_BK + xc;
    const float* src = p.x + ((size_t(b) * p.t_len + ts) * p.s_len) * p.c + ch;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int s = s0 + xs + 64 * r;
      xr[r] = (s < p.s_len && ch < p.c)
                  ? __ldg(reinterpret_cast<const float4*>(src + size_t(s) * p.c))
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  auto store_x = [&](int step, int buf) {
    const int ch = (step % n_c) * TF_BK + xc;
    if (p.pre_a != nullptr && ch < p.c) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(p.pre_a + size_t(b) * p.c + ch));
      const float4 c = __ldg(reinterpret_cast<const float4*>(p.pre_b + size_t(b) * p.c + ch));
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (s0 + xs + 64 * r >= p.s_len) continue;  // stays zero
        xr[r].x = silu_f32(fmaf(xr[r].x, a.x, c.x));
        xr[r].y = silu_f32(fmaf(xr[r].y, a.y, c.y));
        xr[r].z = silu_f32(fmaf(xr[r].z, a.z, c.z));
        xr[r].w = silu_f32(fmaf(xr[r].w, a.w, c.w));
      }
    }
    float* d = As + buf * TF_BK * TF_LDA + xc * TF_LDA + xs;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      d[64 * r] = xr[r].x;
      d[64 * r + TF_LDA] = xr[r].y;
      d[64 * r + 2 * TF_LDA] = xr[r].z;
      d[64 * r + 3 * TF_LDA] = xr[r].w;
    }
  };
  // W staging: thread i copies rows (i + 256 r) / 32, columns 4 ((i + 256 r) % 32)
  const int wrow = tid >> 5, wcol = (tid & 31) * 4;
  auto load_w = [&](int step, int buf) {
    const int k = k_first + step / n_c, c0 = (step % n_c) * TF_BK;
    float* d = Bs + buf * TF_BK * TF_LDB + wrow * TF_LDB + wcol;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = c0 + wrow + 8 * r;
      const bool ok = row < p.c && co0 + wcol < p.c_out4;
      const float* src = p.w + (size_t(k) * p.c + row) * p.c_out4 + co0 + wcol;
      cp_async_16(d + 8 * r * TF_LDB, ok ? src : p.w, ok);
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  load_w(0, 0);
  cp_async_commit();
  load_x(0);
  store_x(0, 0);
  cp_async_wait_all();
  __syncthreads();
  for (int step = 0; step < steps; ++step) {
    const int buf = step & 1;
    const bool more = step + 1 < steps;
    if (more) {  // the other buffers were last read before the previous barrier
      load_w(step + 1, buf ^ 1);
      cp_async_commit();
      load_x(step + 1);
    }
    const float* A = As + buf * TF_BK * TF_LDA + 4 * ty;
    const float* B = Bs + buf * TF_BK * TF_LDB + 4 * tx;
#pragma unroll
    for (int kk = 0; kk < TF_BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(A + kk * TF_LDA);
      const float4 a1 = *reinterpret_cast<const float4*>(A + kk * TF_LDA + 64);
      const float4 b0 = *reinterpret_cast<const float4*>(B + kk * TF_LDB);
      const float4 b1 = *reinterpret_cast<const float4*>(B + kk * TF_LDB + 64);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (more) store_x(step + 1, buf ^ 1);
    cp_async_wait_all();
    __syncthreads();
  }

  const float rw = p.res != nullptr ? p.res_w[size_t(b) * p.t_len + t] : 0.f;
  const size_t frame = (size_t(b) * p.t_len + t) * p.s_len;
  const bool vec = (p.c_out & 3) == 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int s = s0 + 4 * ty + (i & 3) + 64 * (i >> 2);
    if (s >= p.s_len) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int co = co0 + 4 * tx + 64 * h;
      if (co >= p.c_out) continue;
      const size_t idx = (frame + s) * p.c_out + co;
      float y[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        y[e] = acc[i][4 * h + e] + (co + e < p.c_out ? __ldg(p.bias + co + e) : 0.f);
      if (vec) {
        if (p.res != nullptr) {
          const float4 r = __ldg(reinterpret_cast<const float4*>(p.res + idx));
          y[0] = fmaf(rw, y[0], r.x);
          y[1] = fmaf(rw, y[1], r.y);
          y[2] = fmaf(rw, y[2], r.z);
          y[3] = fmaf(rw, y[3], r.w);
        }
        *reinterpret_cast<float4*>(p.out + idx) = make_float4(y[0], y[1], y[2], y[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (co + e >= p.c_out) break;
          p.out[idx + e] = p.res != nullptr ? fmaf(rw, y[e], __ldg(p.res + idx + e)) : y[e];
        }
      }
    }
  }
}

static int launch_tc_f32(const ConvF32Args& a, cudaStream_t stream) {
  cudaError_t err = set_smem(temporal_conv_f32_kernel, TF_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = static_cast<long long>((a.c_out + TF_BN - 1) / TF_BN) *
                          ((a.s_len + TF_BM - 1) / TF_BM) * a.t_len * a.batch;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  temporal_conv_f32_kernel<<<static_cast<unsigned int>(tiles), TF_THREADS, TF_SMEM, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace st2v

// dtype: 0 = float32, 1 = bfloat16.  w is (kt, C, C_out4) with C % 4 == 0
// and C_out4 = C_out rounded up to 4 for f32, and (kt, C_out, C) with
// C % 8 == 0 for bf16 (the wrapper pads and repacks);
// pre_a/pre_b are (B, C) f32 or null; res (B, T, S, C_out) and res_w (B, T)
// f32 or null.  bf16 takes `cols` output channels a tile (320, 128 or 64)
// and a grid of at most `sms` blocks.  Requires odd kt <= 5; any T >= 1.
extern "C" int st2v_temporal_conv(const void* x, const void* w, const float* bias,
                                  const float* pre_a, const float* pre_b, const void* res,
                                  const float* res_w, void* out, int batch, int t_len,
                                  int s_len, int c, int c_out, int kt, int dtype, int cols,
                                  int sms, void* stream) {
  using namespace st2v;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || batch > 65535 || s_len <= 0 || c <= 0 || c_out <= 0 || kt % 2 != 1 ||
      kt > 5 || t_len <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1) {
    if (c % 8 != 0 || sms <= 0) return static_cast<int>(cudaErrorInvalidValue);
    const ConvArgs a{static_cast<const bf16*>(x), static_cast<const bf16*>(w), bias, pre_a,
                     pre_b, static_cast<const bf16*>(res), res_w, static_cast<bf16*>(out),
                     batch, t_len, s_len, c, c_out, kt};
    if (cols == 320) return launch_tc_wgmma<256, 64>(a, sms, s);
    if (cols == 128) return launch_tc_wgmma<128, 0>(a, sms, s);
    if (cols == 64) return launch_tc_wgmma<0, 64>(a, sms, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype != 0 || c % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const ConvF32Args a{static_cast<const float*>(x), static_cast<const float*>(w), bias, pre_a,
                      pre_b, static_cast<const float*>(res), res_w, static_cast<float*>(out),
                      batch, t_len, s_len, c, c_out, (c_out + 3) & ~3, kt};
  return launch_tc_f32(a, s);
}
