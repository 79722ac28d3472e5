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
// The f32 instance and other head dims keep the first body: a block stages
// its pairs' key and value rows in shared memory as f32 and a warp computes
// one (pair, query frame) row at a time on the FMA units.  Takes T <= 64
// frames on either side and D <= 128.
#include "common.cuh"

namespace st2v {

// ---- the first body: f32, and bf16 head dims other than 64 ----
constexpr int TA_THREADS = 256;
constexpr int TA_WARPS = TA_THREADS / 32;
constexpr int TA_MAX_T = 64;

__host__ __device__ inline size_t ta_smem_bytes(int pairs, int tkv, int d) {
  return sizeof(float) * (size_t(pairs) * tkv * (2 * d + 1) + size_t(TA_WARPS) * (d + TA_MAX_T));
}

template <typename T>
__global__ void __launch_bounds__(TA_THREADS)
temporal_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, T* __restrict__ o, int tq, int tkv, int sh,
                          int d, int pairs, float scale_log2) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.y;
  const int p0 = blockIdx.x * pairs;
  const int np = min(pairs, sh - p0);
  const int ldk = d + 1;
  float* Ks = smem;                                  // [pair][j][d + 1]
  float* Vs = Ks + size_t(pairs) * tkv * ldk;        // [pair][j][d]
  float* Qs = Vs + size_t(pairs) * tkv * d + warp * (d + TA_MAX_T);  // this warp's q row
  float* Ps = Qs + d;                                // this warp's probabilities

  const int run = np * d;  // contiguous elements of the block's pairs in one frame
  for (int i = tid; i < tkv * run; i += TA_THREADS) {
    const int j = i / run, rem = i % run;
    const int pp = rem / d, dd = rem % d;
    const size_t src = (size_t(b) * tkv + j) * sh * d + size_t(p0) * d + rem;
    Ks[(size_t(pp) * tkv + j) * ldk + dd] = to_float(k[src]);
    Vs[(size_t(pp) * tkv + j) * d + dd] = to_float(v[src]);
  }
  __syncthreads();

  for (int item = warp; item < np * tq; item += TA_WARPS) {
    const int pp = item % np, t = item / np;
    const size_t row = ((size_t(b) * tq + t) * sh + p0 + pp) * d;
    for (int dd = lane; dd < d; dd += 32) Qs[dd] = to_float(q[row + dd]) * scale_log2;
    __syncwarp();
    const float* kp = Ks + size_t(pp) * tkv * ldk;
    float s0 = __int_as_float(0xff800000), s1 = s0;  // -inf
    if (lane < tkv) {
      float acc = 0.f;
      for (int dd = 0; dd < d; ++dd) acc = fmaf(Qs[dd], kp[lane * ldk + dd], acc);
      s0 = acc;
    }
    if (lane + 32 < tkv) {
      float acc = 0.f;
      for (int dd = 0; dd < d; ++dd) acc = fmaf(Qs[dd], kp[(lane + 32) * ldk + dd], acc);
      s1 = acc;
    }
    const float m = warp_max(fmaxf(s0, s1));
    const float e0 = lane < tkv ? exp2f(s0 - m) : 0.f;
    const float e1 = lane + 32 < tkv ? exp2f(s1 - m) : 0.f;
    const float inv = 1.f / warp_sum(e0 + e1);
    Ps[lane] = e0;
    Ps[lane + 32] = e1;
    __syncwarp();
    const float* vp = Vs + size_t(pp) * tkv * d;
    for (int dd = lane; dd < d; dd += 32) {
      float acc = 0.f;
      for (int j = 0; j < tkv; ++j) acc = fmaf(Ps[j], vp[j * d + dd], acc);
      o[row + dd] = from_float<T>(acc * inv);
    }
    __syncwarp();  // Qs and Ps are rewritten by the warp's next row
  }
}

template <typename T>
static int launch_ta(const void* q, const void* k, const void* v, void* o, int batch, int tq,
                     int tkv, int sh, int d, int pairs, float scale_log2,
                     cudaStream_t stream) {
  const size_t smem = ta_smem_bytes(pairs, tkv, d);
  auto kernel = temporal_attention_kernel<T>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((sh + pairs - 1) / pairs, batch);
  kernel<<<grid, TA_THREADS, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                             static_cast<const T*>(v), static_cast<T*>(o), tq,
                                             tkv, sh, d, pairs, scale_log2);
  return static_cast<int>(cudaGetLastError());
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
// `pairs` (pixel, head) pairs per block of the first body (the bf16 d=64 body
// takes 4).  dtype: 0 = float32, 1 = bfloat16; q, k, v, o 16-byte aligned.
// Requires tq, tkv <= 64 and d <= 128.  Returns a cudaError_t (0 = launched).
extern "C" int st2v_temporal_attention(const void* q, const void* k, const void* v, void* o,
                                       int batch, int tq, int tkv, int sh, int d, int pairs,
                                       int dtype, float scale_log2, void* stream) {
  using namespace st2v;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || batch > 65535 || tq <= 0 || tq > TA_MAX_T || tkv <= 0 || tkv > TA_MAX_T ||
      sh <= 0 || d <= 0 || d > 128 || pairs <= 0 || ta_smem_bytes(pairs, tkv, d) > 227 * 1024)
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
  if (dtype == 1) return launch_ta<bf16>(q, k, v, o, batch, tq, tkv, sh, d, pairs, scale_log2, s);
  if (dtype == 0) return launch_ta<float>(q, k, v, o, batch, tq, tkv, sh, d, pairs, scale_log2, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
