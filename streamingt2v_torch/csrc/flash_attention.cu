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
// 4*L*D*2 bytes per head, so the tensor cores (and, at D=64, the exp2 of
// every score on the SFU: one per 2*D = 128 flops).  The bf16 D=64 instance,
// which carries all UNet attention, is FlashAttention-3's outline on `wgmma`
// (`flash_kernel_bf16_d64_wgmma`, below), masking the ragged KV edge on the
// last tile only.  It replaced an earlier register-resident FlashAttention-2
// body on `mma.sync`, which it beat at both main-path shapes on the H100
// (PERF.md).
//
// The bf16 D=512 instance (the VAE mid-block attention, one head) does
// 4*L^2*512 flops on 4*L*512*2 bytes per batch row, so it is bound by the
// tensor cores too, but its 64 x 512 f32 output accumulator for a 64-row query
// tile is the whole register file of a warpgroup and its Q tile alone is
// 64 KB.  So the output columns are split: two warpgroups share 64 query rows,
// S = Q K^T is computed once (each warpgroup half of the keys, on `wgmma`
// with Q resident in shared memory), P goes through shared memory in bf16,
// and each warp accumulates 64 of the 512 output columns on `mma.sync`.
// Each K/V byte fetched feeds 64 query rows.
//
// The bf16 D=128 instance (the video DiTs' heads: Wan2.1's 40 of 128) is the
// D=64 outline at twice the width (`flash_kernel_bf16_d128_wgmma`, below): O
// doubles to 64 f32 a thread, so its KV tiles halve to 64 keys to keep two
// blocks an SM.
//
// The f32 D=512 instance (the stage-1 VAE's mid-block attention under the
// reference's f32, FMA units, no TF32) does the same 4*L^2*512 flops at the
// FP32 rate, so it is bound by the FMA units.  Its body (`flash_kernel_f32_d512`,
// below) blocks 64 query rows so that each K/V byte feeds 64 rows, feeds its
// FMAs from register microtiles filled by 128-bit shared loads, splits S's
// 512-long contraction over its eight warps, and can split the keys over
// blocks with a merge so that the grid fills the SMs evenly.  The f32 D=64
// instance (the f32 references and the tiny configs; 4*L^2*64 flops on
// 4*L*64*4 bytes a head, FMA-bound too) is `flash_kernel_f32_d64`, below:
// 128 query rows a block, 8 x 8 register microtiles for S and P V alike,
// two blocks an SM.
#include "common.cuh"

namespace st2v {

// ---- f32, D = 64: row-blocked on the FMA units ----
//
// A block owns FS_BQ = 128 query rows of one (batch, head), Q resident in
// shared memory, and walks KV tiles of FS_BK = 64 keys: every K/V byte
// fetched feeds 128 rows.  A warp owns 32 rows; lane = 8 rg + kg owns rows
// r_i = 32 warp + rg + 4 i (i < 8) of S and of O alike, so the softmax's row
// max, alpha and sum stay in the lane's registers:
//   S = Q K^T: keys kg + 8 j (j < 8), an 8 x 8 register microtile, read from
//     Q and K row-major in 128-bit loads along d (dot-product order).  In one
//     load the four rows rg (Q) or the eight keys kg (K) are consecutive rows
//     16 bytes apart in the banks (row stride FS_LD = 68 floats); the lanes
//     that share a row share its load.  16 loads a 256 FMAs.
//   The online softmax in log2 units: a row's max over its eight kg lanes by
//     three shuffles; its sum stays a per-lane share until the end.  P leaves
//     transposed into the warp's own slice of shared memory, [key][rg, i], so
//     that one 128-bit load gives a lane four of its rows for one key.
//   O += P V: output columns 4 kg + c and 32 + 4 kg + c, an 8 x 8 microtile;
//     per key two 128-bit loads of P and two of V (row-major, as in memory:
//     keys are P V's contraction, no transpose).  16 loads a 256 FMAs.
// V_j arrives by `cp.async` under S_j, K_{j+1} under P V_j, into one K and one
// V buffer.  Two barriers a tile, which the second block on the SM (103 KB of
// shared memory each) runs under.
constexpr int FS_D = 64;
constexpr int FS_THREADS = 128;
constexpr int FS_BQ = 128;               // query rows a block: 32 a warp
constexpr int FS_BK = 64;                // keys a KV tile
constexpr int FS_BLOCKS = 2;             // blocks an SM
constexpr int FS_LD = FS_D + 4;          // Q and K rows (floats)
constexpr int FS_LDV = FS_D;             // V rows: every lane of a load reads one row
constexpr int FS_LDP = 32 + 4;           // a warp's P, [key][8 rg + i]
constexpr size_t FS_SMEM =
    sizeof(float) * (size_t(FS_BQ) * FS_LD + size_t(FS_BK) * FS_LD + size_t(FS_BK) * FS_LDV +
                     size_t(FS_THREADS / 32) * FS_BK * FS_LDP);
static_assert(FS_BLOCKS * (FS_SMEM + 1024) <= 233472, "two blocks' shared memory per SM");
static_assert(FS_BQ * FS_BK == 64 * FS_THREADS && FS_BQ * FS_D == 64 * FS_THREADS,
              "S and O: an 8 x 8 tile a thread");

// ROWS rows x 64 columns from rows [row0, row0 + ROWS) at stride ld into rows
// of LD floats; rows at or past `rows` are zero-filled.
template <int ROWS, int LD>
__device__ __forceinline__ void fs_load(float* dst, const float* src, int row0, int rows,
                                        int ld) {
  const int c = (threadIdx.x & 15) * 4;
#pragma unroll
  for (int r = threadIdx.x >> 4; r < ROWS; r += FS_THREADS / 16) {
    const bool ok = row0 + r < rows;
    cp_async_16(dst + r * LD + c, ok ? src + size_t(row0 + r) * ld + c : src, ok);
  }
}

__global__ void __launch_bounds__(FS_THREADS, FS_BLOCKS)
flash_kernel_f32_d64(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, int lq, int lk,
                     int heads, int ld, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);  // [FS_BQ][FS_LD]
  float* Ks = Qs + FS_BQ * FS_LD;                  // [FS_BK][FS_LD]
  float* Vs = Ks + FS_BK * FS_LD;                  // [FS_BK][FS_LDV]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rg = lane >> 3, kg = lane & 7;
  float* Pw = Vs + FS_BK * FS_LDV + warp * FS_BK * FS_LDP;  // this warp's P, [key][8 rg + i]

  const int q0 = blockIdx.x * FS_BQ;
  const size_t bi = blockIdx.y / heads, hi = blockIdx.y % heads;
  const float* qb = q + bi * lq * ld + hi * FS_D;
  const float* kb = k + bi * lk * ld + hi * FS_D;
  const float* vb = v + bi * lk * ld + hi * FS_D;
  const int row0 = warp * 32 + rg;  // this lane's rows: row0 + 4 i

  fs_load<FS_BQ, FS_LD>(Qs, qb, q0, lq, ld);
  fs_load<FS_BK, FS_LD>(Ks, kb, 0, lk, ld);
  cp_async_commit();

  const float neg_inf = __int_as_float(0xff800000);
  // per row: the running max (log2 units) and this lane's share of the sum
  float mx[8], den[8], acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    mx[i] = neg_inf;
    den[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
  }

  const int tiles = (lk + FS_BK - 1) / FS_BK;
  for (int j = 0; j < tiles; ++j) {
    cp_async_wait_all();  // K_j (and Q) landed
    __syncthreads();      // for all; P V_{j-1} is done everywhere: V is free
    fs_load<FS_BK, FS_LDV>(Vs, vb, j * FS_BK, lk, ld);
    cp_async_commit();

    float s[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) s[i][c] = 0.f;
    const float* qp = Qs + row0 * FS_LD;
    const float* kp = Ks + kg * FS_LD;
#pragma unroll 2
    for (int d = 0; d < FS_D; d += 4) {
      float4 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = *reinterpret_cast<const float4*>(qp + 4 * i * FS_LD + d);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float4 b = *reinterpret_cast<const float4*>(kp + 8 * c * FS_LD + d);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float x = fmaf(a[i].x, b.x, s[i][c]);
          x = fmaf(a[i].y, b.y, x);
          x = fmaf(a[i].z, b.z, x);
          s[i][c] = fmaf(a[i].w, b.w, x);
        }
      }
    }
    if ((j + 1) * FS_BK > lk) {  // the ragged last tile
#pragma unroll
      for (int c = 0; c < 8; ++c)
        if (j * FS_BK + kg + 8 * c >= lk)
#pragma unroll
          for (int i = 0; i < 8; ++i) s[i][c] = neg_inf;
    }
    // online softmax: a row's 64 scores sit in the eight kg lanes of its rg
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float r = s[i][0];
#pragma unroll
      for (int c = 1; c < 8; ++c) r = fmaxf(r, s[i][c]);
      r = fmaxf(r, __shfl_xor_sync(0xffffffffu, r, 1));
      r = fmaxf(r, __shfl_xor_sync(0xffffffffu, r, 2));
      r = fmaxf(r, __shfl_xor_sync(0xffffffffu, r, 4));
      // every tile has a key in range, so r is finite
      const float mnew = fmaxf(mx[i], r * scale_log2);
      const float alpha = ex2_ftz(mx[i] - mnew);
      mx[i] = mnew;
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        s[i][c] = ex2_ftz(fmaf(s[i][c], scale_log2, -mnew));
        sum += s[i][c];
      }
      den[i] = den[i] * alpha + sum;
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      float* dst = Pw + (kg + 8 * c) * FS_LDP + 8 * rg;
      *reinterpret_cast<float4*>(dst) = make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
      *reinterpret_cast<float4*>(dst + 4) = make_float4(s[4][c], s[5][c], s[6][c], s[7][c]);
    }
    cp_async_wait_all();  // V_j landed
    __syncthreads();      // V_j and every warp's P for all; K_j is read everywhere
    if (j + 1 < tiles) fs_load<FS_BK, FS_LD>(Ks, kb, (j + 1) * FS_BK, lk, ld);
    cp_async_commit();

    const float* pp = Pw + 8 * rg;
    const float* vp = Vs + 4 * kg;
#pragma unroll 4
    for (int key = 0; key < FS_BK; ++key) {
      const float4 p0 = *reinterpret_cast<const float4*>(pp + key * FS_LDP);
      const float4 p1 = *reinterpret_cast<const float4*>(pp + key * FS_LDP + 4);
      const float4 v0 = *reinterpret_cast<const float4*>(vp + key * FS_LDV);
      const float4 v1 = *reinterpret_cast<const float4*>(vp + key * FS_LDV + 32);
      const float pv[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
      const float vv[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

  float* ob = o + bi * lq * ld + hi * FS_D;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float l = den[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l += __shfl_xor_sync(0xffffffffu, l, 4);
    const int row = q0 + row0 + 4 * i;
    if (row >= lq) continue;
    const float inv = 1.f / l;
    float* dst = ob + size_t(row) * ld + 4 * kg;
    *reinterpret_cast<float4*>(dst) =
        make_float4(acc[i][0] * inv, acc[i][1] * inv, acc[i][2] * inv, acc[i][3] * inv);
    *reinterpret_cast<float4*>(dst + 32) =
        make_float4(acc[i][4] * inv, acc[i][5] * inv, acc[i][6] * inv, acc[i][7] * inv);
  }
  cp_async_wait_all();  // the last (empty) group
}

static int launch_flash_f32_d64(const void* q, const void* k, const void* v, void* o, int batch,
                                int heads, int lq, int lk, float scale_log2,
                                cudaStream_t stream) {
  cudaError_t err = set_smem(flash_kernel_f32_d64, FS_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((lq + FS_BQ - 1) / FS_BQ, batch * heads);
  flash_kernel_f32_d64<<<grid, FS_THREADS, FS_SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lq, lk, heads, heads * FS_D, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

// ---- f32, D = 512: row-blocked on the FMA units ----
//
// A block owns FF_BQ = 64 query rows of one (batch, head), Q resident in
// shared memory, and walks KV tiles of FF_BK = 16 keys, so every K/V byte
// fetched feeds 64 rows.  Shared memory delivers 128 bytes a clock to an SM
// that does 128 FMAs a clock, so a register microtile of R x C outputs keeps
// the FMA units fed only at 4 (R + C) / (R C) <= 1 byte loaded a FMA.  Per
// tile:
//   S = Q K^T: S's contraction (512) is split over the eight warps, warp w
//     summing d in [64 w, 64 w + 64) into a 4 x 8 register microtile a lane
//     (rows sy + 16 i, keys sx + 2 j; 1.5 bytes a FMA, against 2 for 4 x 4),
//     read from Q and K row-major in 128-bit loads along d (the rows' stride
//     FF_LDQ puts neighbouring rows in distinct banks).  The eight partial
//     tiles meet in shared memory, in the K tile's place once every warp is
//     done with K (one more barrier), so that Q, K, V and P fit.
//   The online softmax: a thread one row and 4 of its keys, the row's max
//     and sum over its quad; P is stored transposed, [key][row].
//   O += P V: each thread owns 8 rows x 16 of the 512 output columns (128
//     f32 accumulators; 0.75 bytes a FMA), reading 8 probabilities and 16 V
//     values a key in six 128-bit loads; V is read row-major as it is in
//     memory (keys are P V's contraction), no transpose.
// V_j arrives by `cp.async` under S_j, K_{j+1} under P V_j.  At (1, 9216,
// 512) the 144 row blocks are 1.09 waves of 132 SMs, so the wrapper may
// split the keys (`splits` blocks a row block, `tiles_per_split` tiles each):
// each split then writes its unnormalised O with its rows' max and sum, and
// `flash_merge_f32_d512` combines them.
constexpr int FF_D = 512;
constexpr int FF_THREADS = 256;
constexpr int FF_BQ = 64;                // query rows a block
constexpr int FF_BK = 16;                // keys a KV tile
constexpr int FF_SPLIT = 8;              // warps over S's contraction
constexpr int FF_LDQ = FF_D + 4;         // Q and K rows (floats)
constexpr int FF_LDV = FF_D;             // V rows: every lane of a load reads one row
constexpr int FF_LDP = FF_BQ + 8;        // P, [key][row]: a quad's 4 keys in distinct banks
constexpr size_t FF_SMEM =
    sizeof(float) * (size_t(FF_BQ) * FF_LDQ + size_t(FF_BK) * FF_LDQ + size_t(FF_BK) * FF_LDV +
                     size_t(FF_BK) * FF_LDP + 3 * FF_BQ);
static_assert(FF_SMEM + 1024 <= 233472, "one block's shared memory per SM");
static_assert(FF_SPLIT * FF_BQ * FF_BK <= FF_BK * FF_LDQ, "the partial scores fit K's tile");
static_assert(FF_SPLIT * FF_BQ * FF_BK == 4 * 8 * FF_THREADS, "S: a 4 x 8 tile a thread");
static_assert(FF_BQ * FF_D == 128 * FF_THREADS, "O: 128 accumulators a thread");

// The partial score (row, key) of warp w in K's tile: [w][key][row], the row
// index's bit 4 flipped for odd keys, so that the 32 lanes' stores (16 rows
// x 2 keys) fall in distinct banks.
__device__ __forceinline__ int ff_partial(int w, int row, int key) {
  return (w * FF_BK + key) * FF_BQ + (row ^ ((key & 1) << 4));
}

// ROWS rows x 512 columns from rows [row0, row0 + ROWS) at stride ld into
// rows of LD floats; rows at or past `rows` are zero-filled.
template <int ROWS, int LD>
__device__ __forceinline__ void ff_load(float* dst, const float* src, int row0, int rows,
                                        int ld) {
  const int c = (threadIdx.x & 127) * 4;
#pragma unroll 4
  for (int r = threadIdx.x >> 7; r < ROWS; r += FF_THREADS / 128) {
    const bool ok = row0 + r < rows;
    cp_async_16(dst + r * LD + c, ok ? src + size_t(row0 + r) * ld + c : src, ok);
  }
}

__global__ void __launch_bounds__(FF_THREADS, 1)
flash_kernel_f32_d512(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      float* __restrict__ o_part, float* __restrict__ ml_part, int lq, int lk,
                      int heads, int ld, float scale_log2, int tiles_per_split) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);  // [FF_BQ][FF_LDQ]
  float* Ks = Qs + FF_BQ * FF_LDQ;                 // [FF_BK][FF_LDQ]
  float* Vs = Ks + FF_BK * FF_LDQ;                 // [FF_BK][FF_LDV]
  float* Pt = Vs + FF_BK * FF_LDV;                 // [FF_BK][FF_LDP]
  float* Sp = Ks;                                  // the partial scores, once K is read
  float* alpha_s = Pt + FF_BK * FF_LDP;            // [FF_BQ]
  float* m_s = alpha_s + FF_BQ;
  float* l_s = m_s + FF_BQ;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * FF_BQ;
  const size_t bh = blockIdx.z, bi = bh / heads, hi = bh % heads;
  const float* qb = q + bi * lq * ld + hi * FF_D;
  const float* kb = k + bi * lk * ld + hi * FF_D;
  const float* vb = v + bi * lk * ld + hi * FF_D;
  const int tiles = (lk + FF_BK - 1) / FF_BK;
  const int j0 = blockIdx.y * tiles_per_split;
  const int j1 = min(tiles, j0 + tiles_per_split);

  // S: warp sg, rows sy + 16 i, keys sx + 2 j, d in [64 sg, 64 sg + 64)
  const int sg = warp, sy = lane >> 1, sx = lane & 1;
  // softmax: row mrow, keys mq + 4 j
  const int mrow = tid >> 2, mq = tid & 3;
  // O: rows 4 oy + i and 32 + 4 oy + i, columns 4 ox + 128 c + e
  const int oy = (warp >> 2) * 4 + (lane >> 3), ox = (warp & 3) * 8 + (lane & 7);

  ff_load<FF_BQ, FF_LDQ>(Qs, qb, q0, lq, ld);
  ff_load<FF_BK, FF_LDQ>(Ks, kb, j0 * FF_BK, lk, ld);
  cp_async_commit();

  const float neg_inf = __int_as_float(0xff800000);
  float m_run = neg_inf, l_run = 0.f;  // row mrow's running max (log2 units) and sum
  float acc[8][16];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 16; ++c) acc[i][c] = 0.f;

  for (int j = j0; j < j1; ++j) {
    cp_async_wait_all();  // K_j (and Q) landed
    __syncthreads();      // for all; P V_{j-1} is done: V, P and alpha are free
    ff_load<FF_BK, FF_LDV>(Vs, vb, j * FF_BK, lk, ld);
    cp_async_commit();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) s[i][c] = 0.f;
    const float* qp = Qs + sy * FF_LDQ + 64 * sg;
    const float* kp = Ks + sx * FF_LDQ + 64 * sg;
#pragma unroll 4
    for (int d = 0; d < 64; d += 4) {
      float4 a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(qp + 16 * i * FF_LDQ + d);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float4 b = *reinterpret_cast<const float4*>(kp + 2 * c * FF_LDQ + d);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float x = fmaf(a[i].x, b.x, s[i][c]);
          x = fmaf(a[i].y, b.y, x);
          x = fmaf(a[i].z, b.z, x);
          s[i][c] = fmaf(a[i].w, b.w, x);
        }
      }
    }
    __syncthreads();  // every warp is done with K_j: its tile takes the partial scores
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) Sp[ff_partial(sg, sy + 16 * i, sx + 2 * c)] = s[i][c];
    __syncthreads();  // the partial scores for all

    {
      float sc[4], mx = neg_inf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = mq + 4 * c;
        float p[FF_SPLIT];
#pragma unroll
        for (int w = 0; w < FF_SPLIT; ++w) p[w] = Sp[ff_partial(w, mrow, key)];
        float x = ((p[0] + p[1]) + (p[2] + p[3])) + ((p[4] + p[5]) + (p[6] + p[7]));
        x = j * FF_BK + key < lk ? x * scale_log2 : neg_inf;
        sc[c] = x;
        mx = fmaxf(mx, x);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // every tile has a key in range, so mx is finite
      const float m_new = fmaxf(m_run, mx);
      const float alpha = exp2f(m_run - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float pr = exp2f(sc[c] - m_new);
        Pt[(mq + 4 * c) * FF_LDP + mrow] = pr;
        sum += pr;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l_run = l_run * alpha + sum;
      m_run = m_new;
      if (mq == 0) alpha_s[mrow] = alpha;
    }
    cp_async_wait_all();  // V_j landed
    __syncthreads();      // V_j, P and alpha for all; the partial scores are read: K's tile is free
    if (j + 1 < j1) ff_load<FF_BK, FF_LDQ>(Ks, kb, (j + 1) * FF_BK, lk, ld);
    cp_async_commit();

#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float al = alpha_s[4 * oy + (i & 3) + 32 * (i >> 2)];
#pragma unroll
      for (int c = 0; c < 16; ++c) acc[i][c] *= al;
    }
#pragma unroll 4
    for (int key = 0; key < FF_BK; ++key) {
      const float4 p0 = *reinterpret_cast<const float4*>(Pt + key * FF_LDP + 4 * oy);
      const float4 p1 = *reinterpret_cast<const float4*>(Pt + key * FF_LDP + 32 + 4 * oy);
      const float pv[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
      float vv[16];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float4 x = *reinterpret_cast<const float4*>(Vs + key * FF_LDV + 4 * ox + 128 * c);
        vv[4 * c] = x.x;
        vv[4 * c + 1] = x.y;
        vv[4 * c + 2] = x.z;
        vv[4 * c + 3] = x.w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < 16; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

  if (mq == 0) {
    m_s[mrow] = m_run;
    l_s[mrow] = l_run;
  }
  __syncthreads();
  const bool whole = gridDim.y == 1;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = 4 * oy + (i & 3) + 32 * (i >> 2);
    if (q0 + row >= lq) continue;
    float* dst;
    float scale = 1.f;
    if (whole) {
      dst = o + (bi * lq + q0 + row) * ld + hi * FF_D;
      scale = 1.f / l_s[row];
    } else {
      const size_t part = (size_t(blockIdx.y) * gridDim.z + bh) * lq + q0 + row;
      dst = o_part + part * FF_D;
      if (ox == 0) {
        ml_part[2 * part] = m_s[row];
        ml_part[2 * part + 1] = l_s[row];
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<float4*>(dst + 4 * ox + 128 * c) =
          make_float4(acc[i][4 * c] * scale, acc[i][4 * c + 1] * scale,
                      acc[i][4 * c + 2] * scale, acc[i][4 * c + 3] * scale);
  }
  cp_async_wait_all();  // the last (empty) group
}

// O = sum_s 2^(m_s - M) O_s / sum_s 2^(m_s - M) l_s over the splits' partial
// rows (M their largest max); a thread one 4-column vector of a row.
__global__ void __launch_bounds__(256)
flash_merge_f32_d512(const float* __restrict__ o_part, const float* __restrict__ ml_part,
                     float* __restrict__ o, int lq, int heads, int ld, int splits, int bh_total) {
  const size_t rows = size_t(bh_total) * lq;
  const size_t r = size_t(blockIdx.x) * 2 + (threadIdx.x >> 7);
  if (r >= rows) return;
  const int c = (threadIdx.x & 127) * 4;
  float mx = __int_as_float(0xff800000);
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, ml_part[2 * (s * rows + r)]);
  float l = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < splits; ++s) {
    const float w = exp2f(ml_part[2 * (s * rows + r)] - mx);
    l = fmaf(w, ml_part[2 * (s * rows + r) + 1], l);
    const float4 x = *reinterpret_cast<const float4*>(o_part + (s * rows + r) * FF_D + c);
    acc.x = fmaf(w, x.x, acc.x);
    acc.y = fmaf(w, x.y, acc.y);
    acc.z = fmaf(w, x.z, acc.z);
    acc.w = fmaf(w, x.w, acc.w);
  }
  const float inv = 1.f / l;
  const size_t bh = r / lq, bi = bh / heads, hi = bh % heads;
  *reinterpret_cast<float4*>(o + (bi * lq + r % lq) * ld + hi * FF_D + c) =
      make_float4(acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv);
}

static int launch_flash_f32_d512(const void* q, const void* k, const void* v, void* o,
                                 int batch, int heads, int lq, int lk, float scale_log2,
                                 int splits, int tiles_per_split, void* o_part, void* ml_part,
                                 cudaStream_t stream) {
  const int tiles = (lk + FF_BK - 1) / FF_BK;
  if (splits <= 0 || splits > 65535 || tiles_per_split <= 0 ||
      (splits - 1) * tiles_per_split >= tiles || splits * tiles_per_split < tiles ||
      (splits > 1 && (o_part == nullptr || ml_part == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = set_smem(flash_kernel_f32_d512, FF_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((lq + FF_BQ - 1) / FF_BQ, splits, batch * heads);
  flash_kernel_f32_d512<<<grid, FF_THREADS, FF_SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), static_cast<float*>(o_part), static_cast<float*>(ml_part), lq, lk,
      heads, heads * FF_D, scale_log2, tiles_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const size_t rows = size_t(batch) * heads * lq;
  flash_merge_f32_d512<<<static_cast<unsigned int>((rows + 1) / 2), 256, 0, stream>>>(
      static_cast<const float*>(o_part), static_cast<const float*>(ml_part),
      static_cast<float*>(o), lq, heads, heads * FF_D, splits, batch * heads);
  return static_cast<int>(cudaGetLastError());
}

// ---- bf16, D = 64 on wgmma: the FlashAttention-3 outline ----
constexpr int FW_D = 64;
constexpr int FW_THREADS = 256;               // two consumer warpgroups
constexpr int FW_BQ = 128;                    // query rows per block: 64 per warpgroup
constexpr int FW_BK = 128;                    // keys per KV tile
constexpr int FW_STAGES = 2;                  // K/V tiles: this one and the next
constexpr int FW_BLOCKS = 2;                  // blocks per SM: at most 128 registers a thread
constexpr int FW_Q_BYTES = FW_BQ * FW_D * 2;  // rows of 128 bytes in the 128-byte swizzle
constexpr int FW_TILE_BYTES = FW_BK * FW_D * 2;  // a K or V tile
constexpr size_t FW_SMEM = 1024 + FW_Q_BYTES + size_t(FW_STAGES) * 2 * FW_TILE_BYTES;
static_assert(FW_BLOCKS * (FW_SMEM + 1024) <= 233472, "two blocks' shared memory per SM");

// ROWS rows x 64 columns from rows [row0, row0 + ROWS) at stride ld into the
// 128-byte swizzle (`sw128_off`); rows at or past `rows` are zero-filled.
// Eight neighbouring threads copy one 128-byte row, so thread i's copies are
// rows i / 8 + 32 it, at byte sw128_off(i / 8, i % 8) + 4096 it.
template <int ROWS>
__device__ __forceinline__ void fw_load(unsigned char* dst, const bf16* src, int row0, int rows,
                                        int ld) {
  const int cr = threadIdx.x >> 3, cg = threadIdx.x & 7;
  unsigned char* d = dst + sw128_off(cr, cg);
  const bf16* p = src + size_t(row0 + cr) * ld + cg * 8;
  const size_t step = size_t(32) * ld;
#pragma unroll
  for (int it = 0; it < ROWS / 32; ++it, p += step) {
    const bool ok = row0 + cr + 32 * it < rows;
    cp_async_16(d + 4096 * it, ok ? p : src, ok);
  }
}

// A block owns 128 query rows; warpgroup wg owns rows [64 wg, 64 wg + 64).
// Per KV tile j of 128 keys: S = Q K_j^T (wgmma m64n128k16, Q and K K-major
// in the swizzle), the online softmax on S in registers, P repacked in
// registers as the A operand of O += P V_j (wgmma m64n64k16, V_j read
// N-major: the V rows as they are in memory, transposed by the descriptor),
// one k16 slice of P packed before each product, so S's registers free as
// P's fill.  The exponentials run as `ex2.approx.ftz` (no subnormal fix-up:
// at D=64 the SFU and the ALU are as busy per tile as the tensor cores, and
// the fix-up cost 10% of the call).  Each product group is waited for at once: a group left in flight
// across the loop (P V_j under the next S) made ptxas serialize the wgmma,
// and two blocks an SM (128 registers a thread) hide more than that overlap
// did.  K/V tiles alternate between two stages: tile j + 1 is copied during
// tile j into the stage of tile j - 1, which every warpgroup finished before
// the barrier.
__global__ void __launch_bounds__(FW_THREADS, FW_BLOCKS)
flash_kernel_bf16_d64_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, bf16* __restrict__ o, int lq, int lk,
                            int heads, int ld, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_dyn[];
  // the swizzle atoms need 1024-byte alignment (the launch adds the slack)
  unsigned char* Qs = smem_dyn + ((1024 - (smem_u32(smem_dyn) & 1023)) & 1023);
  unsigned char* KV = Qs + FW_Q_BYTES;  // stage s: K at KV + 2 s FW_TILE_BYTES, V after it

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wg = warp >> 2;
  const int q0 = blockIdx.x * FW_BQ;
  const size_t bi = blockIdx.y / heads, hi = blockIdx.y % heads;
  const bf16* qb = q + bi * lq * ld + hi * FW_D;
  const bf16* kb = k + bi * lk * ld + hi * FW_D;
  const bf16* vb = v + bi * lk * ld + hi * FW_D;
  bf16* ob = o + bi * lq * ld + hi * FW_D;

  fw_load<FW_BQ>(Qs, qb, q0, lq, ld);
  fw_load<FW_BK>(KV, kb, 0, lk, ld);
  fw_load<FW_BK>(KV + FW_TILE_BYTES, vb, 0, lk, ld);
  cp_async_commit();

  const float neg_inf = __int_as_float(0xff800000);
  float acc[FW_D / 2];     // O: rows g (elements 4n, 4n+1) and g+8 (4n+2, 4n+3), columns 8n + 2t
  float s[FW_BK / 2];      // S of this tile, the same layout over its 128 keys
  uint32_t pa[FW_BK / 4];  // P in bf16: the A fragments of the 8 k16 slices of P V
  float mx[2] = {neg_inf, neg_inf};  // running max (log2 units) of rows g and g+8
  float den[2] = {0.f, 0.f};         // this lane's share of their denominators
#pragma unroll
  for (int i = 0; i < FW_D / 2; ++i) acc[i] = 0.f;

  // descriptors: this warpgroup's 64 rows of Q; stage 0's K and V.  A k16
  // slice of Q or K is 32 bytes (2 units) along the row; one of V is 16 rows
  // (2048 bytes, 128 units) down; a stage is 2 FW_TILE_BYTES further.
  const uint64_t q_desc = gmma_desc(smem_u32(Qs) + wg * 64 * 128);
  const uint64_t kv_desc = gmma_desc(smem_u32(KV));
  constexpr uint64_t TILE_UNITS = FW_TILE_BYTES >> 4;
  const int tiles = (lk + FW_BK - 1) / FW_BK;
  int stage = 0;
  for (int j = 0; j < tiles; ++j) {
    cp_async_wait_all();  // this thread's copies of tile j (and Q) landed
    fence_proxy_async();  // ... and are visible to wgmma
    __syncthreads();      // for all; tile j - 1 is done everywhere
    if (j + 1 < tiles) {
      unsigned char* next = KV + (stage == FW_STAGES - 1 ? 0 : stage + 1) * 2 * FW_TILE_BYTES;
      fw_load<FW_BK>(next, kb, (j + 1) * FW_BK, lk, ld);
      fw_load<FW_BK>(next + FW_TILE_BYTES, vb, (j + 1) * FW_BK, lk, ld);
    }
    cp_async_commit();  // empty on the last tile

    const uint64_t k_desc = kv_desc + stage * 2 * TILE_UNITS;
    gmma_fence();
#pragma unroll
    for (int kk = 0; kk < FW_D / 16; ++kk)
      wgmma_m64n128k16(s, q_desc + 2 * kk, k_desc + 2 * kk, kk > 0);
    gmma_commit();
    gmma_wait<0>();
    fence_regs(s);

    if ((j + 1) * FW_BK > lk) {  // the ragged last tile
#pragma unroll
      for (int n = 0; n < FW_BK / 8; ++n) {
        const int key = j * FW_BK + n * 8 + 2 * t;
        if (key >= lk) s[4 * n] = s[4 * n + 2] = neg_inf;
        if (key + 1 >= lk) s[4 * n + 1] = s[4 * n + 3] = neg_inf;
      }
    }
    // online softmax: a row's 128 scores sit in the four lanes of a quad
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float r = neg_inf;
#pragma unroll
      for (int n = 0; n < FW_BK / 8; ++n) r = fmaxf(r, fmaxf(s[4 * n + 2 * h], s[4 * n + 2 * h + 1]));
      r = fmaxf(r, __shfl_xor_sync(0xffffffffu, r, 1));
      r = fmaxf(r, __shfl_xor_sync(0xffffffffu, r, 2));
      // every tile has a key in range, so r is finite
      const float mnew = fmaxf(mx[h], r * scale_log2);
      const float alpha = ex2_ftz(mx[h] - mnew);
      mx[h] = mnew;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < FW_BK / 8; ++n) {
        s[4 * n + 2 * h] = ex2_ftz(fmaf(s[4 * n + 2 * h], scale_log2, -mnew));
        s[4 * n + 2 * h + 1] = ex2_ftz(fmaf(s[4 * n + 2 * h + 1], scale_log2, -mnew));
        sum += s[4 * n + 2 * h] + s[4 * n + 2 * h + 1];
      }
      den[h] = den[h] * alpha + sum;
#pragma unroll
      for (int n = 0; n < FW_D / 8; ++n) {
        acc[4 * n + 2 * h] *= alpha;
        acc[4 * n + 2 * h + 1] *= alpha;
      }
    }
    // P's accumulator layout is the A-fragment layout: keys 16kk .. 16kk + 15
    // are column blocks 2kk and 2kk + 1
    const uint64_t v_desc = k_desc + TILE_UNITS;
#pragma unroll
    for (int kk = 0; kk < FW_BK / 16; ++kk) {
      pa[4 * kk] = pack_bf16x2(s[8 * kk], s[8 * kk + 1]);
      pa[4 * kk + 1] = pack_bf16x2(s[8 * kk + 2], s[8 * kk + 3]);
      pa[4 * kk + 2] = pack_bf16x2(s[8 * kk + 4], s[8 * kk + 5]);
      pa[4 * kk + 3] = pack_bf16x2(s[8 * kk + 6], s[8 * kk + 7]);
      gmma_fence();  // this slice's P registers, to wgmma
      wgmma_m64n64k16_rt(acc, pa + 4 * kk, v_desc + 128 * kk);
    }
    gmma_commit();
    gmma_wait<0>();
    fence_regs(acc);
    stage = stage == FW_STAGES - 1 ? 0 : stage + 1;
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = den[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / l;
    const int row = q0 + wg * 64 + (warp & 3) * 16 + g + 8 * h;
    if (row >= lq) continue;
#pragma unroll
    for (int n = 0; n < FW_D / 8; ++n)
      *reinterpret_cast<uint32_t*>(ob + size_t(row) * ld + n * 8 + 2 * t) =
          pack_bf16x2(acc[4 * n + 2 * h] * inv, acc[4 * n + 2 * h + 1] * inv);
  }
  cp_async_wait_all();  // the last (empty) group
}

static int launch_flash_bf16_d64_wgmma(const void* q, const void* k, const void* v, void* o,
                                       int batch, int heads, int lq, int lk, float scale_log2,
                                       cudaStream_t stream) {
  auto kernel = flash_kernel_bf16_d64_wgmma;
  cudaError_t err = set_smem(kernel, FW_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((lq + FW_BQ - 1) / FW_BQ, batch * heads);
  kernel<<<grid, FW_THREADS, FW_SMEM, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), lq, lk, heads, heads * FW_D, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

// ---- bf16, D = 128 on wgmma: the D = 64 outline at twice the width ----
//
// The video DiTs' heads (Wan2.1: 40 heads of 128).  The outline is the D = 64
// body's: two consumer warpgroups of 64 query rows, S = Q K^T and O += P V on
// `wgmma`, P kept in registers as the A operand of P V, K/V tiles
// double-buffered by `cp.async`, the ragged KV edge masked on the last tile.
// What D = 128 changes is the register budget: O is 64 f32 a thread, twice the
// D = 64 body's, so the KV tile halves to 64 keys (S 32 f32 a thread) to keep
// the two at D = 64's 96 and two blocks an SM (128 registers, no spill).
// 128-key tiles at one block an SM (186 registers) ran as fast at the
// self-attention and 29% slower at 257 keys, whose last tile holds one key.
// A row of Q, K or V is 256 bytes: two column blocks of 64 in the 128-byte
// swizzle, block c of a ROWS-row tile at byte c * ROWS * 128, so S's eight
// k16 slices walk block 0 then block 1, and P V runs as two N = 64 products a
// k16 slice, one into each half of O (each the D = 64 body's P V, V read
// N-major).
constexpr int FH_D = 128;
constexpr int FH_THREADS = 256;               // two consumer warpgroups
constexpr int FH_BQ = 128;                    // query rows per block: 64 per warpgroup
constexpr int FH_BK = 64;                     // keys per KV tile
constexpr int FH_STAGES = 2;                  // K/V tiles: this one and the next
constexpr int FH_BLOCKS = 2;                  // blocks per SM: at most 128 registers a thread
constexpr int FH_Q_BYTES = FH_BQ * FH_D * 2;  // two column blocks of 64
constexpr int FH_TILE_BYTES = FH_BK * FH_D * 2;  // a K or V tile, the same layout
constexpr size_t FH_SMEM = 1024 + FH_Q_BYTES + size_t(FH_STAGES) * 2 * FH_TILE_BYTES;
static_assert(FH_BLOCKS * (FH_SMEM + 1024) <= 233472, "two blocks' shared memory per SM");

// ROWS rows x 128 columns from rows [row0, row0 + ROWS) at stride ld into two
// column blocks of the 128-byte swizzle; rows at or past `rows` are
// zero-filled.  Sixteen neighbouring threads copy one 256-byte row, so thread
// i's copies are rows i / 16 + 16 it of column block (i % 16) / 8.
template <int ROWS>
__device__ __forceinline__ void fh_load(unsigned char* dst, const bf16* src, int row0, int rows,
                                        int ld) {
  const int cr = threadIdx.x >> 4, cc = threadIdx.x & 15;
  unsigned char* d = dst + (cc >> 3) * (ROWS * 128) + sw128_off(cr, cc & 7);
  const bf16* p = src + size_t(row0 + cr) * ld + cc * 8;
  const size_t step = size_t(16) * ld;
#pragma unroll
  for (int it = 0; it < ROWS / 16; ++it, p += step) {
    const bool ok = row0 + cr + 16 * it < rows;
    cp_async_16(d + 2048 * it, ok ? p : src, ok);
  }
}

// A block owns 128 query rows; warpgroup wg owns rows [64 wg, 64 wg + 64).
// Per KV tile j: S = Q K_j^T over the eight k16 slices of the two column
// blocks, the online softmax in registers (exponentials as `ex2.approx.ftz`),
// then per k16 slice of P its A fragments packed and O's two halves
// accumulated from V_j's two column blocks.  Each product group is waited for
// at once, as in the D = 64 body.
__global__ void __launch_bounds__(FH_THREADS, FH_BLOCKS)
flash_kernel_bf16_d128_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, bf16* __restrict__ o, int lq, int lk,
                             int heads, int ld, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_dyn[];
  unsigned char* Qs = smem_dyn + ((1024 - (smem_u32(smem_dyn) & 1023)) & 1023);
  unsigned char* KV = Qs + FH_Q_BYTES;  // stage s: K at KV + 2 s FH_TILE_BYTES, V after it

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wg = warp >> 2;
  const int q0 = blockIdx.x * FH_BQ;
  const size_t bi = blockIdx.y / heads, hi = blockIdx.y % heads;
  const bf16* qb = q + bi * lq * ld + hi * FH_D;
  const bf16* kb = k + bi * lk * ld + hi * FH_D;
  const bf16* vb = v + bi * lk * ld + hi * FH_D;
  bf16* ob = o + bi * lq * ld + hi * FH_D;

  fh_load<FH_BQ>(Qs, qb, q0, lq, ld);
  fh_load<FH_BK>(KV, kb, 0, lk, ld);
  fh_load<FH_BK>(KV + FH_TILE_BYTES, vb, 0, lk, ld);
  cp_async_commit();

  const float neg_inf = __int_as_float(0xff800000);
  float acc[FH_D / 2];     // O: rows g (elements 4n, 4n+1) and g+8 (4n+2, 4n+3), columns 8n + 2t
  float s[FH_BK / 2];      // S of this tile, the same layout over its keys
  uint32_t pa[FH_BK / 4];  // P in bf16: the A fragments of the k16 slices of P V
  float mx[2] = {neg_inf, neg_inf};  // running max (log2 units) of rows g and g+8
  float den[2] = {0.f, 0.f};         // this lane's share of their denominators
#pragma unroll
  for (int i = 0; i < FH_D / 2; ++i) acc[i] = 0.f;

  // descriptors: this warpgroup's 64 rows of Q's column block 0 (block 1 is
  // FH_BQ * 128 bytes on); stage 0's K and V (block 1 FH_BK * 128 bytes on).
  // A k16 slice of Q or K is 32 bytes (2 units) along the row; one of V is 16
  // rows (2048 bytes, 128 units) down.
  const uint64_t q_desc = gmma_desc(smem_u32(Qs) + wg * 64 * 128);
  const uint64_t kv_desc = gmma_desc(smem_u32(KV));
  constexpr uint64_t Q_BLOCK_UNITS = (FH_BQ * 128) >> 4;
  constexpr uint64_t KV_BLOCK_UNITS = (FH_BK * 128) >> 4;
  constexpr uint64_t TILE_UNITS = FH_TILE_BYTES >> 4;
  const int tiles = (lk + FH_BK - 1) / FH_BK;
  int stage = 0;
  for (int j = 0; j < tiles; ++j) {
    cp_async_wait_all();  // this thread's copies of tile j (and Q) landed
    fence_proxy_async();  // ... and are visible to wgmma
    __syncthreads();      // for all; tile j - 1 is done everywhere
    if (j + 1 < tiles) {
      unsigned char* next = KV + (stage == FH_STAGES - 1 ? 0 : stage + 1) * 2 * FH_TILE_BYTES;
      fh_load<FH_BK>(next, kb, (j + 1) * FH_BK, lk, ld);
      fh_load<FH_BK>(next + FH_TILE_BYTES, vb, (j + 1) * FH_BK, lk, ld);
    }
    cp_async_commit();  // empty on the last tile

    const uint64_t k_desc = kv_desc + stage * 2 * TILE_UNITS;
    gmma_fence();
#pragma unroll
    for (int kk = 0; kk < FH_D / 16; ++kk)
      wgmma_m64n64k16(s, q_desc + (kk >> 2) * Q_BLOCK_UNITS + 2 * (kk & 3),
                k_desc + (kk >> 2) * KV_BLOCK_UNITS + 2 * (kk & 3), kk > 0);
    gmma_commit();
    gmma_wait<0>();
    fence_regs(s);

    if ((j + 1) * FH_BK > lk) {  // the ragged last tile
#pragma unroll
      for (int n = 0; n < FH_BK / 8; ++n) {
        const int key = j * FH_BK + n * 8 + 2 * t;
        if (key >= lk) s[4 * n] = s[4 * n + 2] = neg_inf;
        if (key + 1 >= lk) s[4 * n + 1] = s[4 * n + 3] = neg_inf;
      }
    }
    // online softmax: a row's scores sit in the four lanes of a quad
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float r = neg_inf;
#pragma unroll
      for (int n = 0; n < FH_BK / 8; ++n) r = fmaxf(r, fmaxf(s[4 * n + 2 * h], s[4 * n + 2 * h + 1]));
      r = fmaxf(r, __shfl_xor_sync(0xffffffffu, r, 1));
      r = fmaxf(r, __shfl_xor_sync(0xffffffffu, r, 2));
      // every tile has a key in range, so r is finite
      const float mnew = fmaxf(mx[h], r * scale_log2);
      const float alpha = ex2_ftz(mx[h] - mnew);
      mx[h] = mnew;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < FH_BK / 8; ++n) {
        s[4 * n + 2 * h] = ex2_ftz(fmaf(s[4 * n + 2 * h], scale_log2, -mnew));
        s[4 * n + 2 * h + 1] = ex2_ftz(fmaf(s[4 * n + 2 * h + 1], scale_log2, -mnew));
        sum += s[4 * n + 2 * h] + s[4 * n + 2 * h + 1];
      }
      den[h] = den[h] * alpha + sum;
#pragma unroll
      for (int n = 0; n < FH_D / 8; ++n) {
        acc[4 * n + 2 * h] *= alpha;
        acc[4 * n + 2 * h + 1] *= alpha;
      }
    }
    // P's accumulator layout is the A-fragment layout: keys 16kk .. 16kk + 15
    // are column blocks 2kk and 2kk + 1 of S
    const uint64_t v_desc = k_desc + TILE_UNITS;
#pragma unroll
    for (int kk = 0; kk < FH_BK / 16; ++kk) {
      pa[4 * kk] = pack_bf16x2(s[8 * kk], s[8 * kk + 1]);
      pa[4 * kk + 1] = pack_bf16x2(s[8 * kk + 2], s[8 * kk + 3]);
      pa[4 * kk + 2] = pack_bf16x2(s[8 * kk + 4], s[8 * kk + 5]);
      pa[4 * kk + 3] = pack_bf16x2(s[8 * kk + 6], s[8 * kk + 7]);
      gmma_fence();  // this slice's P registers, to wgmma
      wgmma_m64n64k16_rt(acc, pa + 4 * kk, v_desc + 128 * kk);
      wgmma_m64n64k16_rt(acc + FH_D / 4, pa + 4 * kk, v_desc + KV_BLOCK_UNITS + 128 * kk);
    }
    gmma_commit();
    gmma_wait<0>();
    fence_regs(acc);
    stage = stage == FH_STAGES - 1 ? 0 : stage + 1;
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = den[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / l;
    const int row = q0 + wg * 64 + (warp & 3) * 16 + g + 8 * h;
    if (row >= lq) continue;
#pragma unroll
    for (int n = 0; n < FH_D / 8; ++n)
      *reinterpret_cast<uint32_t*>(ob + size_t(row) * ld + n * 8 + 2 * t) =
          pack_bf16x2(acc[4 * n + 2 * h] * inv, acc[4 * n + 2 * h + 1] * inv);
  }
  cp_async_wait_all();  // the last (empty) group
}

static int launch_flash_bf16_d128_wgmma(const void* q, const void* k, const void* v, void* o,
                                        int batch, int heads, int lq, int lk, float scale_log2,
                                        cudaStream_t stream) {
  auto kernel = flash_kernel_bf16_d128_wgmma;
  cudaError_t err = set_smem(kernel, FH_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((lq + FH_BQ - 1) / FH_BQ, batch * heads);
  kernel<<<grid, FH_THREADS, FH_SMEM, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), lq, lk, heads, heads * FH_D, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

// ---- bf16, D = 512: the VAE bottleneck body ----
constexpr int FB_D = 512;
constexpr int FB_BQ = 64;                        // query rows per block: one wgmma M
constexpr int FB_BK = 64;                        // keys per KV tile
constexpr int FB_THREADS = 256;                  // two warpgroups
constexpr int FB_LDV = FB_D + 8;                 // V row stride: conflict-free ldmatrix.trans
constexpr int FB_LDP = FB_BK + 8;                // P row stride
constexpr int FB_Q_BYTES = FB_BQ * FB_D * 2;     // 8 column blocks of 64, 128-byte swizzle
constexpr int FB_K_BYTES = FB_BK * FB_D * 2;     // the same layout
constexpr int FB_V_BYTES = FB_BK * FB_LDV * 2;   // row-major, padded
constexpr int FB_P_BYTES = FB_BQ * FB_LDP * 2;
constexpr int FB_RED_BYTES = 4 * 5 * FB_BQ;      // row maxima and denominators per warpgroup, alpha
constexpr size_t FB_SMEM =
    1024 + FB_Q_BYTES + FB_K_BYTES + FB_V_BYTES + FB_P_BYTES + FB_RED_BYTES;  // + alignment
static_assert(FB_SMEM <= 232448, "one block per SM");

// ROWS rows x 512 columns from rows [row0, row0 + ROWS) at stride ld into the
// 128-byte swizzle, column block b (64 columns) at byte b * ROWS * 128; rows
// at or past `rows` are zero-filled.  Eight neighbouring threads copy one
// 128-byte run of a row; a thread's rows are r0, r0 + 4, ..., so its source
// advances by a running pointer and its destination by constants (addresses
// computed per copy and hoisted out of the tile loop would not fit beside
// the output accumulator).
template <int ROWS>
__device__ __forceinline__ void fb_load_sw(unsigned char* dst, const bf16* src, int row0,
                                           int rows, int ld) {
  constexpr int STEP = FB_THREADS / 64;  // rows per round
  const int r0 = threadIdx.x >> 6, c = threadIdx.x & 63;
  unsigned char* d = dst + (c >> 3) * (ROWS * 128) + r0 * 128;
  const int sw0 = ((c & 7) ^ (r0 & 7)) << 4, sw1 = ((c & 7) ^ ((r0 + STEP) & 7)) << 4;
  const bf16* p = src + size_t(row0 + r0) * ld + c * 8;
  const size_t step = size_t(STEP) * ld;
#pragma unroll
  for (int it = 0; it < ROWS / STEP; ++it, p += step) {
    const bool ok = row0 + r0 + STEP * it < rows;
    cp_async_16(d + it * STEP * 128 + (it & 1 ? sw1 : sw0), ok ? p : src, ok);
  }
}

// FB_BK rows of V, row-major at stride FB_LDV, zero-filled past `rows`; the
// same running-pointer copies.
__device__ __forceinline__ void fb_load_v(bf16* dst, const bf16* src, int row0, int rows,
                                          int ld) {
  constexpr int STEP = FB_THREADS / 64;
  const int r0 = threadIdx.x >> 6, c = (threadIdx.x & 63) * 8;
  bf16* d = dst + r0 * FB_LDV + c;
  const bf16* p = src + size_t(row0 + r0) * ld + c;
  const size_t step = size_t(STEP) * ld;
#pragma unroll
  for (int it = 0; it < FB_BK / STEP; ++it, p += step) {
    const bool ok = row0 + r0 + STEP * it < rows;
    cp_async_16(d + it * STEP * FB_LDV, ok ? p : src, ok);
  }
}

// d (64 x 32 f32, 16 per thread) += A (64 x 16) B^T (32 x 16), both K-major in
// shared memory (descriptors da, db).
__device__ __forceinline__ void wgmma_m64n32k16(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

// A block owns 64 query rows.  S = Q K^T: warpgroup wg takes keys
// [32 wg, 32 wg + 32) of the tile over all 512 columns (wgmma m64n32k16, Q and
// K read from the 128-byte swizzle).  The two halves' row maxima meet in
// shared memory, each warpgroup writes its half of P in bf16, and then
// O += P V: warp w owns output columns [64 w, 64 w + 64) of all 64 rows (128
// f32 accumulators a thread; `mma.sync`, P by `ldmatrix`, V by
// `ldmatrix.trans`).  Q is loaded once; K and V have one buffer each, and
// each tile's copy overlaps the other's products: V_j lands during S_j,
// K_{j+1} during the softmax and P V_j.
__global__ void __launch_bounds__(FB_THREADS, 1)
flash_kernel_bf16_d512(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ o, int lq, int lk,
                       int heads, int ld, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_dyn[];
  // the swizzle atoms need 1024-byte alignment (the launch adds the slack)
  unsigned char* Qs = smem_dyn + ((1024 - (smem_u32(smem_dyn) & 1023)) & 1023);
  unsigned char* Ks = Qs + FB_Q_BYTES;
  bf16* Vs = reinterpret_cast<bf16*>(Ks + FB_K_BYTES);
  bf16* Ps = Vs + FB_BK * FB_LDV;
  float* red_max = reinterpret_cast<float*>(Ps + FB_BQ * FB_LDP);  // [warpgroup][row]
  float* red_den = red_max + 2 * FB_BQ;                             // [warpgroup][row]
  float* alpha_s = red_den + 2 * FB_BQ;                             // [row]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mi = lane >> 3, r8 = lane & 7;  // ldmatrix: matrix and row this lane addresses
  const int wg = warp >> 2;
  const int srow = (warp & 3) * 16 + g;     // this thread's rows of S: srow and srow + 8
  const int q0 = blockIdx.x * FB_BQ;
  const size_t bi = blockIdx.y / heads, hi = blockIdx.y % heads;
  const bf16* qb = q + bi * lq * ld + hi * FB_D;
  const bf16* kb = k + bi * lk * ld + hi * FB_D;
  const bf16* vb = v + bi * lk * ld + hi * FB_D;
  bf16* ob = o + bi * lq * ld + hi * FB_D;

  fb_load_sw<FB_BQ>(Qs, qb, q0, lq, ld);
  fb_load_sw<FB_BK>(Ks, kb, 0, lk, ld);
  cp_async_commit();

  const float neg_inf = __int_as_float(0xff800000);
  float acc[4][8][4];      // O: rows 16 mt + g (+ 8), columns 64 warp + 8 n + 2t (+ 1)
  float mx[2] = {neg_inf, neg_inf};  // running max (log2 units) of rows srow, srow + 8
  float den[2] = {0.f, 0.f};         // this lane's share of their denominators, this wg's keys
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int n = 0; n < 8; ++n) acc[mt][n][0] = acc[mt][n][1] = acc[mt][n][2] = acc[mt][n][3] = 0.f;

  // descriptors of the first k16 slice of Q and of this warpgroup's keys; a
  // slice is 32 bytes (2 descriptor units) further along, a column block
  // FB_BQ * 128 (FB_BK * 128) bytes
  const uint64_t q_desc = gmma_desc(smem_u32(Qs));
  const uint64_t k_desc = gmma_desc(smem_u32(Ks) + wg * 32 * 128);
  const int tiles = (lk + FB_BK - 1) / FB_BK;
  for (int j = 0; j < tiles; ++j) {
    cp_async_wait_all();  // K_j (and Q) landed; V_{j-1} was waited for
    fence_proxy_async();  // ... and visible to wgmma
    __syncthreads();      // for all; P V_{j-1} is done everywhere: V, P and alpha are free
    fb_load_v(Vs, vb, j * FB_BK, lk, ld);
    cp_async_commit();

    float s[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) s[i] = 0.f;
    gmma_fence();
#pragma unroll
    for (int kk = 0; kk < FB_D / 16; ++kk)
      wgmma_m64n32k16(s, q_desc + (kk >> 2) * (FB_BQ * 128 / 16) + 2 * (kk & 3),
                      k_desc + (kk >> 2) * (FB_BK * 128 / 16) + 2 * (kk & 3));
    gmma_commit();
    gmma_wait<0>();
    fence_regs(s);

    const int key0 = j * FB_BK + wg * 32;
    if (key0 + 32 > lk) {  // the ragged last tile
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int key = key0 + n * 8 + 2 * t;
        if (key >= lk) s[4 * n] = s[4 * n + 2] = neg_inf;
        if (key + 1 >= lk) s[4 * n + 1] = s[4 * n + 3] = neg_inf;
      }
    }
    // row maxima of this warpgroup's half: rows srow (elements 0, 1) and
    // srow + 8 (2, 3); a row's 32 scores sit in the four lanes of a quad
    float rmax[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float r = neg_inf;
#pragma unroll
      for (int n = 0; n < 4; ++n) r = fmaxf(r, fmaxf(s[4 * n + 2 * h], s[4 * n + 2 * h + 1]));
      r = fmaxf(r, __shfl_xor_sync(0xffffffffu, r, 1));
      r = fmaxf(r, __shfl_xor_sync(0xffffffffu, r, 2));
      rmax[h] = r;
      if (t == 0) red_max[wg * FB_BQ + srow + 8 * h] = r;
    }
    __syncthreads();  // S_j is done in both warpgroups (K is free); maxima published
    if (j + 1 < tiles) fb_load_sw<FB_BK>(Ks, kb, (j + 1) * FB_BK, lk, ld);
    cp_async_commit();  // empty on the last tile

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = srow + 8 * h;
      // every tile has a key in range, so one of the two maxima is finite
      const float mnew =
          fmaxf(mx[h], fmaxf(rmax[h], red_max[(1 - wg) * FB_BQ + row]) * scale_log2);
      const float alpha = exp2f(mx[h] - mnew);
      mx[h] = mnew;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const float p0 = exp2f(fmaf(s[4 * n + 2 * h], scale_log2, -mnew));
        const float p1 = exp2f(fmaf(s[4 * n + 2 * h + 1], scale_log2, -mnew));
        sum += p0 + p1;
        *reinterpret_cast<uint32_t*>(Ps + row * FB_LDP + wg * 32 + n * 8 + 2 * t) =
            pack_bf16x2(p0, p1);
      }
      den[h] = den[h] * alpha + sum;
      if (wg == 0 && t == 0) alpha_s[row] = alpha;
    }
    cp_async_wait_group<1>();  // V_j landed (K_{j+1} may still be in flight)
    __syncthreads();           // V_j, P and alpha for all

#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const float al0 = alpha_s[mt * 16 + g], al1 = alpha_s[mt * 16 + g + 8];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        acc[mt][n][0] *= al0;
        acc[mt][n][1] *= al0;
        acc[mt][n][2] *= al1;
        acc[mt][n][3] *= al1;
      }
    }
#pragma unroll
    for (int kk = 0; kk < FB_BK / 16; ++kk) {
      uint32_t a[4][4];  // P A-fragments: rows 16 mt .. +15, keys kk*16 .. +15
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldmatrix_x4(a[mt], Ps + (mt * 16 + (lane & 15)) * FB_LDP + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int dp = 0; dp < 4; ++dp) {
        uint32_t b[4];  // column tiles 2dp, 2dp+1 of this warp's 64; keys kk*16 .. +15
        ldmatrix_x4_trans(b, Vs + (kk * 16 + (mi & 1) * 8 + r8) * FB_LDV + warp * 64 + dp * 16 +
                                 (mi >> 1) * 8);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          mma_bf16(acc[mt][2 * dp], a[mt], b[0], b[1]);
          mma_bf16(acc[mt][2 * dp + 1], a[mt], b[2], b[3]);
        }
      }
    }
  }

  // denominators: over the quad, then the two warpgroups' halves
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = den[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    if (t == 0) red_den[wg * FB_BQ + srow + 8 * h] = l;
  }
  __syncthreads();
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = mt * 16 + g + 8 * h;
      if (q0 + row >= lq) continue;
      const float inv = 1.f / (red_den[row] + red_den[FB_BQ + row]);
      bf16* dst = ob + size_t(q0 + row) * ld + warp * 64 + 2 * t;
#pragma unroll
      for (int n = 0; n < 8; ++n)
        *reinterpret_cast<uint32_t*>(dst + n * 8) =
            pack_bf16x2(acc[mt][n][2 * h] * inv, acc[mt][n][2 * h + 1] * inv);
    }
  }
  cp_async_wait_all();  // the last (empty) group
}

static int launch_flash_bf16_d512(const void* q, const void* k, const void* v, void* o,
                                  int batch, int heads, int lq, int lk, float scale_log2,
                                  cudaStream_t stream) {
  cudaError_t err = set_smem(flash_kernel_bf16_d512, FB_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((lq + FB_BQ - 1) / FB_BQ, batch * heads);
  flash_kernel_bf16_d512<<<grid, FB_THREADS, FB_SMEM, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), lq, lk, heads, heads * FB_D, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

// One dispatch over (dtype, d) for both layouts.  Only the f32 D=512 body
// splits its keys; every other instance takes splits = 1.
static int dispatch_flash(const void* q, const void* k, const void* v, void* o, int batch,
                          int heads, int lq, int lk, int d, int dtype, float scale_log2,
                          int splits, int tiles_per_split, void* o_part, void* ml_part,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || heads <= 0 || batch * heads > 65535 || lq <= 0 || lk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0 && d == 512)
    return launch_flash_f32_d512(q, k, v, o, batch, heads, lq, lk, scale_log2, splits,
                                 tiles_per_split, o_part, ml_part, s);
  if (splits != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1 && d == 64) return launch_flash_bf16_d64_wgmma(q, k, v, o, batch, heads, lq, lk, scale_log2, s);
  if (dtype == 1 && d == 512) return launch_flash_bf16_d512(q, k, v, o, batch, heads, lq, lk, scale_log2, s);
  if (dtype == 1 && d == 128)
    return launch_flash_bf16_d128_wgmma(q, k, v, o, batch, heads, lq, lk, scale_log2, s);
  if (dtype == 0 && d == 64)
    return launch_flash_f32_d64(q, k, v, o, batch, heads, lq, lk, scale_log2, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace st2v

// K1.  q/o (bh, lq, d), k/v (bh, lk, d).  dtype: 0 = float32, 1 = bfloat16.
// d must be 64 or 512, or 128 in bf16 (the wrapper pads head dims below 64
// with zeros).  f32 at
// d = 512 runs `splits` blocks a row block over `tiles_per_split` 16-key
// tiles each, the partial rows in o_part (splits, bh, lq, 512) and ml_part
// (splits, bh, lq, 2) f32 when splits > 1; every other case takes splits = 1
// and null scratch.  Returns a cudaError_t (0 = launched).
extern "C" int st2v_flash_attention(const void* q, const void* k, const void* v, void* o,
                                    int bh, int lq, int lk, int d, int dtype,
                                    float scale_log2, int splits, int tiles_per_split,
                                    void* o_part, void* ml_part, void* stream) {
  return st2v::dispatch_flash(q, k, v, o, bh, 1, lq, lk, d, dtype, scale_log2, splits,
                              tiles_per_split, o_part, ml_part, stream);
}

// K2.  q/o (batch, lq, heads*d), k/v (batch, lk, heads*d); d as K1's;
// the split and scratch as K1's, over batch * heads.
extern "C" int st2v_flash_attention_packed(const void* q, const void* k, const void* v,
                                           void* o, int batch, int heads, int lq, int lk,
                                           int d, int dtype, float scale_log2, int splits,
                                           int tiles_per_split, void* o_part, void* ml_part,
                                           void* stream) {
  return st2v::dispatch_flash(q, k, v, o, batch, heads, lq, lk, d, dtype, scale_log2, splits,
                              tiles_per_split, o_part, ml_part, stream);
}
