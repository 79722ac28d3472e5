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
// What bounds it on the H100: bytes.  At the stage-2 level-0 geometry
// (38 frames, 14400 pixels, 5 heads of 64) it moves q, k, v and o once each,
// about 1.4 GB in bf16, for about 27 GFLOP of scores and P.V: about 20 flops
// per byte, far below the tensor-core ridge.  Scores, probabilities and the
// f32 output never reach device memory and nothing is transposed, in device
// memory or out of it.
//
// The bf16 D=64 body (every head of the main path) spends its effort on
// keeping HBM busy.  A block of 4 warps walks groups of 4 consecutive pairs
// of one batch row (4 * 128 contiguous bytes per frame); each group's q, k
// and v rows arrive by 16-byte `cp.async` as bf16 into one of two buffers
// while the other group's products run, frames padded up to a multiple of 16
// with zero fill.  A warp owns one pair: per 16 query frames, S = Q K^T on
// `mma.sync` (Q and K fragments by `ldmatrix`) stays in the accumulators, the
// padded keys are masked to -inf in registers, the row max and sum go
// through quad shuffles, P is repacked as A fragments and V's fragments come
// from `ldmatrix.trans`; the output overwrites the warp's own q rows in
// shared memory and leaves in 16-byte stores.  The grid is as many blocks as
// fit on the card at once.
//
// f32 at every head dim and bf16 at head dims other than 64 run the FMA body
// (`temporal_attention_fma_kernel`, below): the same outline on the FMA units,
// one pair a group, its query rows split over four warps, products in full
// f32 from register microtiles.  Takes T <= 64 frames on either side and
// D <= 128.
#include "common.cuh"

namespace st2v {

// ---- f32 at every head dim, bf16 at head dims other than 64: the FMA body ----
//
// In f32 at stage 2's level 0 (38 frames, 14400 pixels, 5 heads of 64) the
// call moves 2.8 GB, 0.836 ms at HBM's rate, for 26.6 GFLOP, 0.40 ms at the
// FP32 rate: bytes bound, so the products must run at about half the FP32
// rate and under the copies.
//
// A block of TF_THREADS walks (batch row, pair) groups persistently.  Each
// group's q, k and v frames arrive by `cp.async` (16 bytes a copy where a
// row is a whole number of 16-byte chunks, else 4, else plain loads) into
// one of two buffers while the other group computes, as the raw type: bf16
// is widened to f32 as it leaves shared memory, so every product is f32.
// Frame rows are padded (`TaRows`) and the rows past Tq (to a multiple of 4)
// and Tkv (to a multiple of 8) stay zero: the buffers are zeroed once and
// every group of one launch copies the same rows and columns.
// The pair's query rows go out in quads, warp w taking quads w, w + 4, ...
// (at most 4 a warp: Tq <= 64); lane = 8 rg + kg owns rows 4 (w + 4 i) + rg
// (i < RI) of S and O alike.  A warp's products are `ta_pair<T, RI, KJ>`,
// its tile sizes compile-time (RI its quads, KJ = Tkv over 8 rounded up), so
// that every load of a step issues ahead of its FMAs:
//   S = Q K^T: keys kg + 8 j (j < KJ) in an RI x KJ register microtile, read
//     from Q and K row-major in 4-wide loads along d; the lanes that share a
//     row or a key share its load, and one load's four rows or eight keys
//     are consecutive rows, 16 bytes apart in the banks.  The padded keys are
//     masked to -inf; the row max and sum over the eight kg lanes are
//     shuffles, and all Tkv keys are in registers at once (no online softmax).
//   P leaves transposed into the warp's slice of shared memory, [key][4 rg +
//     i], one 128-bit load giving a lane its four rows of one key.
//   O = P V: one pass a column group of 32 (columns 4 kg + c + 32 h), V
//     row-major as in memory (keys are the contraction), a load of P and one
//     of V a key; o leaves from registers, scaled by the row's 1 / sum, in
//     16-byte stores (f32; 8 bytes in bf16) where d is a multiple of 4.
constexpr int TF_THREADS = 128;   // four warps share one pair
constexpr int TF_MAX_T = 64;
constexpr int TF_MAX_D = 128;
constexpr int TF_QUAD = 4;        // query rows padded to quads (rg)
constexpr int TF_KEYS = 8;        // keys padded to the eight kg lanes
constexpr int TF_COLS = 32;       // a column group of O: 4 columns x 8 kg lanes
constexpr int TF_PAD_BYTES = 16;  // q and k rows: the 8 keys kg of one load in distinct banks
constexpr int TF_LDP = 16 + 4;    // a warp's P, [key][4 rg + i]: a lane's four rows
constexpr int TF_BLOCKS = 3;      // blocks an SM where the shared memory allows

// Frame rows in shared memory: q and k padded by 16 bytes, v to the column
// groups; two buffers of (q, k, v), then the four warps' P.
template <typename T>
struct TaRows {
  __host__ __device__ static int dp(int d) { return (d + TF_COLS - 1) / TF_COLS * TF_COLS; }
  __host__ __device__ static int ldq(int d) { return dp(d) + TF_PAD_BYTES / int(sizeof(T)); }
  __host__ __device__ static int ldv(int d) { return dp(d); }
  __host__ __device__ static int tqp(int tq) { return (tq + TF_QUAD - 1) / TF_QUAD * TF_QUAD; }
  __host__ __device__ static int tkp(int tkv) { return (tkv + TF_KEYS - 1) / TF_KEYS * TF_KEYS; }
  __host__ __device__ static size_t buffer_elems(int tq, int tkv, int d) {
    return size_t(tqp(tq) + tkp(tkv)) * ldq(d) + size_t(tkp(tkv)) * ldv(d);
  }
  __host__ __device__ static size_t smem_bytes(int tq, int tkv, int d) {
    return 2 * buffer_elems(tq, tkv, d) * sizeof(T) +
           sizeof(float) * size_t(TF_THREADS / 32) * tkp(tkv) * TF_LDP;
  }
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ void st4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void st4(bf16* p, float a, float b, float c, float d) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16x2(a, b), pack_bf16x2(c, d));
}

// cp.async of 4 bytes (rows that are not a whole number of 16-byte chunks)
__device__ __forceinline__ void cp_async_4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

// `t_len` frame rows of pair p of batch row b (d elements each, `sh` pairs a
// frame) into rows of `ld` elements.  unit: 16 or 4 bytes a copy, 0 = plain
// loads.  Thread i copies chunks i, i + TF_THREADS, ... of the rows' chunks,
// its (row, chunk) advanced without a divide.
template <typename T>
__device__ __forceinline__ void ta_load(T* dst, const T* src, int b, int p, int t_len, int sh,
                                        int d, int ld, int unit) {
  const int per_copy = unit == 0 ? 1 : unit / int(sizeof(T));  // elements a copy
  const int cpr = d / per_copy;                                // copies a row
  const int step_r = TF_THREADS / cpr, step_c = TF_THREADS - step_r * cpr;
  const size_t frame = size_t(sh) * d;
  const T* base = src + (size_t(b) * t_len * sh + p) * d;
  int j = threadIdx.x / cpr, c = threadIdx.x - j * cpr;
  for (; j < t_len; j += step_r) {
    T* to = dst + j * ld + c * per_copy;
    const T* from = base + j * frame + c * per_copy;
    if (unit == 16) cp_async_16(to, from, true);
    else if (unit == 4) cp_async_4(to, from);
    else *to = *from;
    c += step_c;
    if (c >= cpr) {
      c -= cpr;
      ++j;
    }
  }
}

// One pair's products for a warp with RI quads of query rows (quads warp +
// 4 i) over KJ groups of eight keys; o written from registers.
template <typename T, int RI, int KJ>
__device__ __forceinline__ void ta_pair(const T* Qs, const T* Ks, const T* Vs, float* Pw,
                                        T* __restrict__ o, size_t o_row0, int tq, int tkv,
                                        size_t o_frame, int d, int ldq, int ldv, int warp,
                                        float scale_log2) {
  const int lane = threadIdx.x & 31, rg = lane >> 3, kg = lane & 7;
  const float neg_inf = __int_as_float(0xff800000);
  float s[RI][KJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < KJ; ++j) s[i][j] = 0.f;
  const T* qp = Qs + (4 * warp + rg) * ldq;
  const T* kp = Ks + kg * ldq;
  const int d4 = (d + 3) & ~3;
#pragma unroll 2
  for (int dd = 0; dd < d4; dd += 4) {
    float4 a[RI];
#pragma unroll
    for (int i = 0; i < RI; ++i) a[i] = ld4(qp + 16 * i * ldq + dd);
#pragma unroll
    for (int j = 0; j < KJ; ++j) {
      const float4 bv = ld4(kp + 8 * j * ldq + dd);
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        float x = fmaf(a[i].x, bv.x, s[i][j]);
        x = fmaf(a[i].y, bv.y, x);
        x = fmaf(a[i].z, bv.z, x);
        s[i][j] = fmaf(a[i].w, bv.w, x);
      }
    }
  }
  // softmax over all keys: a row's scores sit in the eight kg lanes of its rg
  float inv[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    if (kg + 8 * (KJ - 1) >= tkv) s[i][KJ - 1] = neg_inf;  // the padded keys
    float r = s[i][0];
#pragma unroll
    for (int j = 1; j < KJ; ++j) r = fmaxf(r, s[i][j]);
    r = fmaxf(r, __shfl_xor_sync(0xffffffffu, r, 1));
    r = fmaxf(r, __shfl_xor_sync(0xffffffffu, r, 2));
    r = fmaxf(r, __shfl_xor_sync(0xffffffffu, r, 4));
    const float m = r * scale_log2;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < KJ; ++j) {
      s[i][j] = ex2_ftz(fmaf(s[i][j], scale_log2, -m));
      sum += s[i][j];
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    sum += __shfl_xor_sync(0xffffffffu, sum, 4);
    inv[i] = 1.f / sum;
  }
#pragma unroll
  for (int j = 0; j < KJ; ++j)
    *reinterpret_cast<float4*>(Pw + (kg + 8 * j) * TF_LDP + 4 * rg) =
        make_float4(s[0][j], RI > 1 ? s[RI > 1 ? 1 : 0][j] : 0.f,
                    RI > 2 ? s[RI > 2 ? 2 : 0][j] : 0.f, RI > 3 ? s[RI > 3 ? 3 : 0][j] : 0.f);
  __syncwarp();  // the warp's P for all its lanes

  const float* pp = Pw + 4 * rg;
  for (int col = 4 * kg; col < d; col += 32) {  // one column group a pass
    float acc[RI][4];
#pragma unroll
    for (int i = 0; i < RI; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    const T* vp = Vs + col;
#pragma unroll 4
    for (int key = 0; key < tkv; ++key) {
      const float4 pr = *reinterpret_cast<const float4*>(pp + key * TF_LDP);
      const float pv[4] = {pr.x, pr.y, pr.z, pr.w};
      const float4 x = ld4(vp + key * ldv);
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        acc[i][0] = fmaf(pv[i], x.x, acc[i][0]);
        acc[i][1] = fmaf(pv[i], x.y, acc[i][1]);
        acc[i][2] = fmaf(pv[i], x.z, acc[i][2]);
        acc[i][3] = fmaf(pv[i], x.w, acc[i][3]);
      }
    }
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int row = 4 * (warp + 4 * i) + rg;
      if (row >= tq) continue;
      T* dst = o + o_row0 + row * o_frame + col;
      if ((d & 3) == 0) {
        st4(dst, acc[i][0] * inv[i], acc[i][1] * inv[i], acc[i][2] * inv[i], acc[i][3] * inv[i]);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (col + c < d) dst[c] = from_float<T>(acc[i][c] * inv[i]);
      }
    }
  }
  __syncwarp();  // P is read: the warp's next pair may rewrite it
}

// KJ = Tkv padded to the eight key lanes, over 8.
template <typename T, int KJ>
__global__ void __launch_bounds__(TF_THREADS, TF_BLOCKS)
temporal_attention_fma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, T* __restrict__ o, int batch, int tq,
                              int tkv, int sh, int d, int unit, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  typedef TaRows<T> R;
  const int ldq = R::ldq(d), ldv = R::ldv(d);
  const int tqp = R::tqp(tq), tkp = 8 * KJ;
  const size_t buf_elems = R::buffer_elems(tq, tkv, d);
  const int warp = threadIdx.x >> 5;
  float* Pw = reinterpret_cast<float*>(smem + 2 * buf_elems) + warp * tkp * TF_LDP;
  const int ri = (tqp / TF_QUAD - warp + 3) >> 2;  // this warp's quads: warp + 4 i, i < ri
  const long long total = static_cast<long long>(batch) * sh;
  const size_t o_frame = size_t(sh) * d;

  {  // zero both buffers: the padded rows and columns stay zero
    const size_t words = 2 * buf_elems * sizeof(T) / 4;
    uint32_t* z = reinterpret_cast<uint32_t*>(smem_raw);
    for (size_t i = threadIdx.x; i < words; i += TF_THREADS) z[i] = 0u;
  }
  __syncthreads();

  auto load = [&](long long grp, int buf) {
    if (grp < total) {
      const int b = static_cast<int>(grp / sh);
      const int p = static_cast<int>(grp - static_cast<long long>(b) * sh);
      T* Qs = smem + buf * buf_elems;
      T* Ks = Qs + tqp * ldq;
      ta_load(Qs, q, b, p, tq, sh, d, ldq, unit);
      ta_load(Ks, k, b, p, tkv, sh, d, ldq, unit);
      ta_load(Ks + tkp * ldq, v, b, p, tkv, sh, d, ldv, unit);
    }
    cp_async_commit();  // one group per pair, empty past the end
  };

  load(blockIdx.x, 0);
  int buf = 0;
  for (long long grp = blockIdx.x; grp < total; grp += gridDim.x, buf ^= 1) {
    load(grp + gridDim.x, buf ^ 1);  // the next pair's copies fly during these products
    cp_async_wait_group<1>();        // this pair's copies landed
    __syncthreads();
    const T* Qs = smem + buf * buf_elems;
    const T* Ks = Qs + tqp * ldq;
    const T* Vs = Ks + tkp * ldq;
    const int b = static_cast<int>(grp / sh);
    const int p = static_cast<int>(grp - static_cast<long long>(b) * sh);
    const size_t o_row0 = (size_t(b) * tq * sh + p) * d;
    switch (ri) {
      case 1:
        ta_pair<T, 1, KJ>(Qs, Ks, Vs, Pw, o, o_row0, tq, tkv, o_frame, d, ldq, ldv, warp,
                          scale_log2);
        break;
      case 2:
        ta_pair<T, 2, KJ>(Qs, Ks, Vs, Pw, o, o_row0, tq, tkv, o_frame, d, ldq, ldv, warp,
                          scale_log2);
        break;
      case 3:
        ta_pair<T, 3, KJ>(Qs, Ks, Vs, Pw, o, o_row0, tq, tkv, o_frame, d, ldq, ldv, warp,
                          scale_log2);
        break;
      case 4:
        ta_pair<T, 4, KJ>(Qs, Ks, Vs, Pw, o, o_row0, tq, tkv, o_frame, d, ldq, ldv, warp,
                          scale_log2);
        break;
      default: break;  // fewer than four quads: this warp has none
    }
    __syncthreads();  // the buffer is free for the copies two pairs on
  }
  cp_async_wait_all();
}

template <typename T, int KJ>
static int launch_ta_fma(const void* q, const void* k, const void* v, void* o, int batch, int tq,
                         int tkv, int sh, int d, float scale_log2, cudaStream_t stream) {
  typedef TaRows<T> R;
  const size_t smem = R::smem_bytes(tq, tkv, d);
  const int row_bytes = d * static_cast<int>(sizeof(T));
  const int unit = row_bytes % 16 == 0 ? 16 : row_bytes % 4 == 0 ? 4 : 0;
  auto kernel = temporal_attention_fma_kernel<T, KJ>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, TF_THREADS, smem)) !=
          cudaSuccess)
    return static_cast<int>(err);
  const long long total = static_cast<long long>(batch) * sh;
  const long long resident = static_cast<long long>(sms) * per_sm;
  const int grid = static_cast<int>(total < resident ? total : resident);
  if (grid <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  kernel<<<grid, TF_THREADS, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                             static_cast<const T*>(v), static_cast<T*>(o), batch,
                                             tq, tkv, sh, d, unit, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int dispatch_ta_fma(const void* q, const void* k, const void* v, void* o, int batch,
                           int tq, int tkv, int sh, int d, float scale_log2,
                           cudaStream_t stream) {
  switch (TaRows<T>::tkp(tkv) / TF_KEYS) {
    case 1: return launch_ta_fma<T, 1>(q, k, v, o, batch, tq, tkv, sh, d, scale_log2, stream);
    case 2: return launch_ta_fma<T, 2>(q, k, v, o, batch, tq, tkv, sh, d, scale_log2, stream);
    case 3: return launch_ta_fma<T, 3>(q, k, v, o, batch, tq, tkv, sh, d, scale_log2, stream);
    case 4: return launch_ta_fma<T, 4>(q, k, v, o, batch, tq, tkv, sh, d, scale_log2, stream);
    case 5: return launch_ta_fma<T, 5>(q, k, v, o, batch, tq, tkv, sh, d, scale_log2, stream);
    case 6: return launch_ta_fma<T, 6>(q, k, v, o, batch, tq, tkv, sh, d, scale_log2, stream);
    case 7: return launch_ta_fma<T, 7>(q, k, v, o, batch, tq, tkv, sh, d, scale_log2, stream);
    default: return launch_ta_fma<T, 8>(q, k, v, o, batch, tq, tkv, sh, d, scale_log2, stream);
  }
}

// ---- bf16, D = 64: the tensor-core body ----
constexpr int TB_D = 64;
constexpr int TB_PAIRS = 4;                 // pairs per group = warps per block
constexpr int TB_THREADS = 32 * TB_PAIRS;
constexpr int TB_LD = TB_D + 8;             // 144-byte smem rows: conflict-free ldmatrix

__host__ __device__ inline size_t tb_buffer_elems(int tq_pad, int tkv_pad) {
  return size_t(TB_PAIRS) * (tq_pad + 2 * tkv_pad) * TB_LD;
}

// KT: 16-key tiles (Tkv padded up to 16 * KT).
template <int KT>
__global__ void __launch_bounds__(TB_THREADS)
temporal_attention_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                               const bf16* __restrict__ v, bf16* __restrict__ o, int batch,
                               int tq, int tkv, int sh, float scale_log2) {
  static_assert(TB_PAIRS * (TB_D / 8) == 32, "one frame of a group is 32 granules");
  constexpr int TKP = 16 * KT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int mi = lane >> 3, r8 = lane & 7;  // ldmatrix: matrix and row this lane addresses
  const int tqp = (tq + 15) & ~15;
  const int buf_elems = static_cast<int>(tb_buffer_elems(tqp, TKP));
  const int groups_per_row = (sh + TB_PAIRS - 1) / TB_PAIRS;
  const int total = batch * groups_per_row;
  const float neg_inf = __int_as_float(0xff800000);

  // rows [0, t_pad) of the group's pairs: [pair][frame][TB_LD], zero past t_len and sh
  auto load_rows = [&](bf16* dst, const bf16* src, int b, int p0, int t_len, int t_pad) {
    for (int i = tid; i < t_pad * 32; i += TB_THREADS) {
      const int j = i >> 5, pp = (i >> 3) & 3, c = (i & 7) * 8;
      const bool ok = j < t_len && p0 + pp < sh;
      cp_async_16(dst + (pp * t_pad + j) * TB_LD + c,
                  ok ? src + ((size_t(b) * t_len + j) * sh + p0 + pp) * TB_D + c : src, ok);
    }
  };
  auto load = [&](int grp, int buf) {
    if (grp < total) {
      const int b = grp / groups_per_row, p0 = (grp % groups_per_row) * TB_PAIRS;
      bf16* Qs = smem + buf * buf_elems;
      bf16* Ks = Qs + TB_PAIRS * tqp * TB_LD;
      load_rows(Qs, q, b, p0, tq, tqp);
      load_rows(Ks, k, b, p0, tkv, TKP);
      load_rows(Ks + TB_PAIRS * TKP * TB_LD, v, b, p0, tkv, TKP);
    }
    cp_async_commit();  // one group per pair group, empty past the end
  };

  load(blockIdx.x, 0);
  int buf = 0;
  for (int grp = blockIdx.x; grp < total; grp += gridDim.x, buf ^= 1) {
    load(grp + gridDim.x, buf ^ 1);   // the next group's copies fly during these products
    cp_async_wait_group<1>();         // this group's copies landed
    __syncthreads();
    bf16* Qg = smem + buf * buf_elems;
    bf16* Qs = Qg + warp * tqp * TB_LD;
    const bf16* Ks = Qg + TB_PAIRS * tqp * TB_LD + warp * TKP * TB_LD;
    const bf16* Vs = Ks + TB_PAIRS * TKP * TB_LD;
    for (int mt = 0; mt < tqp / 16; ++mt) {
      uint32_t qf[TB_D / 16][4];
#pragma unroll
      for (int ks = 0; ks < TB_D / 16; ++ks)
        ldmatrix_x4(qf[ks], Qs + (mt * 16 + (lane & 15)) * TB_LD + ks * 16 + (lane >> 4) * 8);
      float sc[2 * KT][4];
#pragma unroll
      for (int n = 0; n < 2 * KT; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < TB_D / 16; ++ks)
#pragma unroll
        for (int np = 0; np < KT; ++np) {
          uint32_t b[4];  // key tiles 2np, 2np+1; D columns ks*16 .. +15
          ldmatrix_x4(b, Ks + (np * 16 + (mi >> 1) * 8 + r8) * TB_LD + ks * 16 + (mi & 1) * 8);
          mma_bf16(sc[2 * np], qf[ks], b[0], b[1]);
          mma_bf16(sc[2 * np + 1], qf[ks], b[2], b[3]);
        }
      if (tkv < TKP) {  // the padded keys
#pragma unroll
        for (int n = 0; n < 2 * KT; ++n) {
          const int key = n * 8 + 2 * t4;
          if (key >= tkv) sc[n][0] = sc[n][2] = neg_inf;
          if (key + 1 >= tkv) sc[n][1] = sc[n][3] = neg_inf;
        }
      }
      // softmax of rows g (elements 0, 1) and g+8 (2, 3); a row's scores sit
      // in the four lanes of a quad
      float inv[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float r = neg_inf;
#pragma unroll
        for (int n = 0; n < 2 * KT; ++n) r = fmaxf(r, fmaxf(sc[n][2 * h], sc[n][2 * h + 1]));
        r = fmaxf(r, __shfl_xor_sync(0xffffffffu, r, 1));
        r = fmaxf(r, __shfl_xor_sync(0xffffffffu, r, 2));
        const float m = r * scale_log2;
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < 2 * KT; ++n) {
          sc[n][2 * h] = exp2f(fmaf(sc[n][2 * h], scale_log2, -m));
          sc[n][2 * h + 1] = exp2f(fmaf(sc[n][2 * h + 1], scale_log2, -m));
          sum += sc[n][2 * h] + sc[n][2 * h + 1];
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        inv[h] = 1.f / sum;
      }
      float acc[TB_D / 8][4];
#pragma unroll
      for (int n = 0; n < TB_D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        uint32_t a[4];
        a[0] = pack_bf16x2(sc[2 * kk][0], sc[2 * kk][1]);
        a[1] = pack_bf16x2(sc[2 * kk][2], sc[2 * kk][3]);
        a[2] = pack_bf16x2(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
        a[3] = pack_bf16x2(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
#pragma unroll
        for (int dp = 0; dp < TB_D / 16; ++dp) {
          uint32_t b[4];  // D tiles 2dp, 2dp+1; keys kk*16 .. +15
          ldmatrix_x4_trans(b, Vs + (kk * 16 + (mi & 1) * 8 + r8) * TB_LD + dp * 16 +
                                   (mi >> 1) * 8);
          mma_bf16(acc[2 * dp], a, b[0], b[1]);
          mma_bf16(acc[2 * dp + 1], a, b[2], b[3]);
        }
      }
      __syncwarp();  // every lane has read this tile's q rows: overwrite them with o
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        bf16* row = Qs + (mt * 16 + g + 8 * h) * TB_LD + 2 * t4;
#pragma unroll
        for (int n = 0; n < TB_D / 8; ++n)
          *reinterpret_cast<uint32_t*>(row + n * 8) =
              pack_bf16x2(acc[n][2 * h] * inv[h], acc[n][2 * h + 1] * inv[h]);
      }
    }
    __syncthreads();  // every warp's o rows are staged
    const int b = grp / groups_per_row, p0 = (grp % groups_per_row) * TB_PAIRS;
    for (int i = tid; i < tq * 32; i += TB_THREADS) {
      const int j = i >> 5, pp = (i >> 3) & 3, c = (i & 7) * 8;
      if (p0 + pp < sh)
        *reinterpret_cast<uint4*>(o + ((size_t(b) * tq + j) * sh + p0 + pp) * TB_D + c) =
            *reinterpret_cast<const uint4*>(Qg + (pp * tqp + j) * TB_LD + c);
    }
    __syncthreads();  // the buffer is free for the copies two groups on
  }
  cp_async_wait_all();
}

template <int KT>
static int launch_ta_bf16(const void* q, const void* k, const void* v, void* o, int batch,
                          int tq, int tkv, int sh, float scale_log2, cudaStream_t stream) {
  const size_t smem = 2 * tb_buffer_elems((tq + 15) & ~15, 16 * KT) * sizeof(bf16);
  auto kernel = temporal_attention_bf16_kernel<KT>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, TB_THREADS, smem)) !=
          cudaSuccess)
    return static_cast<int>(err);
  const long long total = static_cast<long long>(batch) * ((sh + TB_PAIRS - 1) / TB_PAIRS);
  const long long resident = static_cast<long long>(sms) * per_sm;
  const int grid = static_cast<int>(total < resident ? total : resident);
  if (grid <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  kernel<<<grid, TB_THREADS, smem, stream>>>(static_cast<const bf16*>(q),
                                             static_cast<const bf16*>(k),
                                             static_cast<const bf16*>(v), static_cast<bf16*>(o),
                                             batch, tq, tkv, sh, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace st2v

// q, o: (batch * tq, S, H * d); k, v: (batch * tkv, S, H * d), sh = S * H.
// dtype: 0 = float32, 1 = bfloat16; q, k, v, o 16-byte aligned.  Requires
// tq, tkv <= 64 and d <= 128.  bf16 at d = 64 runs the tensor-core body,
// every other case the FMA body.  Returns a cudaError_t (0 = launched).
extern "C" int st2v_temporal_attention(const void* q, const void* k, const void* v, void* o,
                                       int batch, int tq, int tkv, int sh, int d, int dtype,
                                       float scale_log2, void* stream) {
  using namespace st2v;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || batch > 65535 || tq <= 0 || tq > TF_MAX_T || tkv <= 0 || tkv > TF_MAX_T ||
      sh <= 0 || d <= 0 || d > TF_MAX_D || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1 && d == TB_D) {
    if (static_cast<long long>(batch) * ((sh + TB_PAIRS - 1) / TB_PAIRS) > 0x7fffffffLL)
      return static_cast<int>(cudaErrorInvalidValue);
    const int kt = (tkv + 15) / 16;
    if (kt == 1) return launch_ta_bf16<1>(q, k, v, o, batch, tq, tkv, sh, scale_log2, s);
    if (kt == 2) return launch_ta_bf16<2>(q, k, v, o, batch, tq, tkv, sh, scale_log2, s);
    if (kt == 3) return launch_ta_bf16<3>(q, k, v, o, batch, tq, tkv, sh, scale_log2, s);
    return launch_ta_bf16<4>(q, k, v, o, batch, tq, tkv, sh, scale_log2, s);
  }
  if (dtype == 1) return dispatch_ta_fma<bf16>(q, k, v, o, batch, tq, tkv, sh, d, scale_log2, s);
  return dispatch_ta_fma<float>(q, k, v, o, batch, tq, tkv, sh, d, scale_log2, s);
}
