// The embedding body shared by K2 (embedding_pool.cu) and K4 (featurize.cu):
// patch trunk -> banded 4-head window pooling -> 96-d head, for one clip per
// block of 256 threads.
//
//   feats = bf16(rms(x) @ Wp + bp)                        x: float32 patch row
//   2x: h = bf16(gelu(rms(feats) @ Wup + bup))            exact erff
//       feats = bf16(feats + bf16(h @ Wdown + bdown))     the add rounds to bf16
//   a = feats @ Q (192 -> 4 heads)
//   per window w, head h, k < 19 (patch p0(w) + k):
//       e = exp_c[k, h] * exp(a[p, h] - max_p a[., h]);  wgt = bf16(e / (sum_k e + 1e-30))
//       pooled[w, h, :] = sum_k wgt feats[p, :] + sum_k wgt pos_bf16[k, :]
//   norm = bf16(grouped centred RMS over the window's 4 x 192 values)
//   out = norm @ Whead + bhead                            float32
//
// Numerics follow the TPU kernel's rounding points: bf16 operands, float32
// accumulation, RMS (eps 1e-6), softmax and pooling sums in float32, the
// softmax weights rounded to bf16 after normalisation, the positional code in
// bf16. A product of two bf16 values is exact in float32, so the FMA products
// here equal the tensor cores' and only the order of the sums differs.
//
// Layout: `trunk_chunk` runs the trunk over a chunk of up to 40 patch rows;
// activations of the chunk stay in shared memory as bf16, and the weights
// (about 0.8 MB in bf16, too large for shared memory) stream through a shared
// tile of 16 rows x 192 columns that L2 serves to every block. Each thread
// holds a 5-row x 6-column register tile (rows ty + 8 i, columns tx + 32 j): a
// warp shares its rows, so activation reads are broadcasts and weight reads
// are conflict-free. The finished patch features and scores go to a global
// scratch (L2-resident) because the windows of a long clip span all of its
// patches; `pool_head` then walks the windows 16 at a time, with the grouped
// RMS and the head product in shared memory. The Pallas selector matmuls
// (tile_h, gs, sel_h) and the banded (WH, P) weight matrix become indexing
// by window start.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace trunk {

constexpr int PD = 128;     // patch values (4 frames x 32 mel)
constexpr int HID = 192;    // trunk width
constexpr int TH = 384;     // trunk MLP width
constexpr int HEADS = 4;
constexpr int WPAT = 19;    // patches per window
constexpr int EMB = 96;
constexpr int POOLED = HEADS * HID;  // 768 values per window

constexpr int THREADS = 256;
constexpr int RC = 40;      // patch rows per trunk chunk
constexpr int KT = 16;      // weight rows per shared tile
constexpr int WC = 16;      // windows per pooling chunk

using bf16 = __nv_bfloat16;

// shared-memory layout, bytes: phase 1 (trunk) and phase 2 (pooling) overlap
constexpr int S1_XN = 0;                                  // RC x HID bf16
constexpr int S1_FEATS = S1_XN + RC * HID * 2;            // RC x HID bf16
constexpr int S1_HID = S1_FEATS + RC * HID * 2;           // RC x TH bf16
constexpr int S1_WT = S1_HID + RC * TH * 2;               // KT x 192 float
constexpr int S1_END = S1_WT + KT * 192 * 4;
constexpr int S2_POOLED = 0;                              // WC x 768 float
constexpr int S2_NORM = S2_POOLED + WC * POOLED * 4;      // WC x 768 bf16
constexpr int S2_WGT = S2_NORM + WC * POOLED * 2;         // WC x HEADS x WPAT float
constexpr int S2_WT = S2_WGT + WC * HEADS * WPAT * 4;     // KT x 96 float
constexpr int S2_END = S2_WT + KT * EMB * 4;
constexpr int SMEM_BYTES = S1_END > S2_END ? S1_END : S2_END;  // 84736 B

static_assert(RC % 8 == 0 && WC % 8 == 0, "row tiles are 8 rows of threads");

// The frozen net's weights in the kernels' types, and the pooling constants.
struct Weights {
  const bf16* wp;         // (128, 192)
  const float* bp;        // (192)
  const bf16* upw;        // (nb, 192, 384)
  const float* upb;       // (nb, 384)
  const bf16* dnw;        // (nb, 384, 192)
  const float* dnb;       // (nb, 192)
  const bf16* q;          // (192, 4)
  const bf16* wh;         // (768, 96)
  const float* bh;        // (96)
  const float* expc;      // (19, 4) exp(pos @ Q - max)
  const bf16* pos;        // (19, 192)
  const int* p0;          // (W) first patch of each window
  int n_blocks;
};

__device__ __forceinline__ float bf(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float round_bf16(float v) { return __bfloat162float(__float2bfloat16(v)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// acc[i][j] += A[ty + 8 i, :K] . W[:K, n0 + tx + 32 j]; A is bf16 in shared
// memory, W bf16 in global memory streamed through wt_s in KT-row tiles.
template <int RM, int RN>
__device__ __forceinline__ void gemm_tile(const bf16* A, int lda, int K, const bf16* __restrict__ W,
                                          int ldw, int n0, float* wt_s, float (&acc)[RM][RN]) {
  constexpr int NC = 32 * RN;
  const int tid = threadIdx.x;
  const int tx = tid & 31;
  const int ty = tid >> 5;
  for (int k0 = 0; k0 < K; k0 += KT) {
    __syncthreads();
    for (int i = tid; i < KT * NC; i += THREADS) {
      const int kk = i / NC;
      const int c = i - kk * NC;
      wt_s[i] = bf(W[static_cast<size_t>(k0 + kk) * ldw + n0 + c]);
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < KT; ++kk) {
      float a[RM];
      float bv[RN];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = bf(A[(ty + 8 * i) * lda + k0 + kk]);
#pragma unroll
      for (int j = 0; j < RN; ++j) bv[j] = wt_s[kk * NC + tx + 32 * j];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
  }
  __syncthreads();
}

template <int RM, int RN>
__device__ __forceinline__ void zero(float (&acc)[RM][RN]) {
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.0f;
}

// Centred RMS of `rows` rows of width N (float32 math) -> bf16 rows of dst;
// rows rows..RC-1 are zeroed. One warp per row.
template <int N, typename Src>
__device__ __forceinline__ void rms_rows(Src load, int rows, bf16* dst) {
  constexpr int PER = N / 32;
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < RC; r += THREADS / 32) {
    if (r >= rows) {
      for (int c = lane; c < N; c += 32) dst[r * N + c] = __float2bfloat16(0.0f);
      continue;
    }
    float v[PER];
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      v[i] = load(r, lane + 32 * i);
      s += v[i];
    }
    const float mean = warp_sum(s) / N;
    float ss = 0.0f;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      v[i] -= mean;
      ss += v[i] * v[i];
    }
    const float scale = 1.0f / sqrtf(warp_sum(ss) / N + 1e-6f);
#pragma unroll
    for (int i = 0; i < PER; ++i) dst[r * N + lane + 32 * i] = __float2bfloat16(v[i] * scale);
  }
}

// Trunk of patch rows r0 .. r0 + rows - 1 (rows <= RC) of one clip;
// load(r, c) gives value c of row r0 + r. The features (bf16) and the scores
// a = feats @ Q go to the clip's scratch rows r0... `smem` holds SMEM_BYTES.
// Starts with a barrier, so the caller may have just written what load reads.
template <typename Load>
__device__ __forceinline__ void trunk_chunk(const Weights& net, Load load, int r0, int rows,
                                            bf16* feats_g, float* scores_g, unsigned char* smem) {
  const int tid = threadIdx.x;
  const int tx = tid & 31;
  const int ty = tid >> 5;
  bf16* xn_s = reinterpret_cast<bf16*>(smem + S1_XN);
  bf16* feats_s = reinterpret_cast<bf16*>(smem + S1_FEATS);
  bf16* hid_s = reinterpret_cast<bf16*>(smem + S1_HID);
  float* wt_s = reinterpret_cast<float*>(smem + S1_WT);

  __syncthreads();
  rms_rows<PD>(load, rows, xn_s);
  {
    float acc[RC / 8][6];
    zero(acc);
    gemm_tile(xn_s, PD, PD, net.wp, HID, 0, wt_s, acc);
#pragma unroll
    for (int i = 0; i < RC / 8; ++i)
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        const int c = tx + 32 * j;
        feats_s[(ty + 8 * i) * HID + c] = __float2bfloat16(acc[i][j] + net.bp[c]);
      }
  }
  for (int blk = 0; blk < net.n_blocks; ++blk) {
    __syncthreads();
    rms_rows<HID>([&](int r, int c) { return bf(feats_s[r * HID + c]); }, rows, xn_s);
    const bf16* upw = net.upw + static_cast<size_t>(blk) * HID * TH;
    const float* upb = net.upb + blk * TH;
    for (int n0 = 0; n0 < TH; n0 += 192) {
      float acc[RC / 8][6];
      zero(acc);
      gemm_tile(xn_s, HID, HID, upw, TH, n0, wt_s, acc);
#pragma unroll
      for (int i = 0; i < RC / 8; ++i)
#pragma unroll
        for (int j = 0; j < 6; ++j) {
          const int c = n0 + tx + 32 * j;
          const float h = acc[i][j] + upb[c];
          const float g = 0.5f * h * (1.0f + erff(h * 0.70710678118654752f));
          hid_s[(ty + 8 * i) * TH + c] = __float2bfloat16(g);
        }
    }
    const bf16* dnw = net.dnw + static_cast<size_t>(blk) * TH * HID;
    const float* dnb = net.dnb + blk * HID;
    float acc[RC / 8][6];
    zero(acc);
    gemm_tile(hid_s, TH, TH, dnw, HID, 0, wt_s, acc);
#pragma unroll
    for (int i = 0; i < RC / 8; ++i)
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        const int idx = (ty + 8 * i) * HID + tx + 32 * j;
        const float d = round_bf16(acc[i][j] + dnb[tx + 32 * j]);
        feats_s[idx] = __float2bfloat16(bf(feats_s[idx]) + d);
      }
  }
  __syncthreads();
  // patch scores a = feats @ Q, and the finished rows to the scratch
  for (int i = tid; i < rows * HEADS; i += THREADS) {
    const int r = i / HEADS;
    const int h = i % HEADS;
    float a = 0.0f;
    for (int d = 0; d < HID; ++d) a = fmaf(bf(feats_s[r * HID + d]), bf(net.q[d * HEADS + h]), a);
    scores_g[(r0 + r) * HEADS + h] = a;
  }
  for (int i = tid; i < rows * HID; i += THREADS) feats_g[r0 * HID + i] = feats_s[i];
}

// Banded window pooling, grouped RMS and head for one clip whose trunk rows
// 0 .. num_patches - 1 are in its scratch: out (n_windows, 96). `smem` holds
// SMEM_BYTES; red_s (THREADS floats) and hmax_s (HEADS) are shared too.
__device__ __forceinline__ void pool_head(const Weights& net, const bf16* feats_g,
                                          const float* scores_g, float* out, int num_patches,
                                          int n_windows, unsigned char* smem, float* red_s,
                                          float* hmax_s) {
  const int tid = threadIdx.x;
  const int tx = tid & 31;
  const int ty = tid >> 5;
  __syncthreads();
  {
    float m = -3.0e38f;
    for (int p = tid / HEADS; p < num_patches; p += THREADS / HEADS)
      m = fmaxf(m, scores_g[p * HEADS + tid % HEADS]);
    red_s[tid] = m;
    __syncthreads();
    if (tid < HEADS) {
      float mm = -3.0e38f;
      for (int i = tid; i < THREADS; i += HEADS) mm = fmaxf(mm, red_s[i]);
      hmax_s[tid] = mm;
    }
  }

  float* pooled_s = reinterpret_cast<float*>(smem + S2_POOLED);
  bf16* norm_s = reinterpret_cast<bf16*>(smem + S2_NORM);
  float* wgt_s = reinterpret_cast<float*>(smem + S2_WGT);
  float* wt2_s = reinterpret_cast<float*>(smem + S2_WT);

  for (int w0 = 0; w0 < n_windows; w0 += WC) {
    const int nw = min(WC, n_windows - w0);
    __syncthreads();
    // softmax weights of each (window, head) over its 19 patches
    if (tid < nw * HEADS) {
      const int w = tid / HEADS;
      const int h = tid % HEADS;
      const int p0 = net.p0[w0 + w];
      float* wg = wgt_s + (w * HEADS + h) * WPAT;
      float denom = 0.0f;
      for (int k = 0; k < WPAT; ++k) {
        const float e = net.expc[k * HEADS + h] * expf(scores_g[(p0 + k) * HEADS + h] - hmax_s[h]);
        wg[k] = e;
        denom += e;
      }
      for (int k = 0; k < WPAT; ++k) wg[k] = round_bf16(wg[k] / (denom + 1e-30f));
    }
    __syncthreads();
    // pooled = W @ feats + W @ POSP, in float32
    for (int i = tid; i < nw * POOLED; i += THREADS) {
      const int w = i / POOLED;
      const int h = (i % POOLED) / HID;
      const int d = i % HID;
      const int p0 = net.p0[w0 + w];
      const float* wg = wgt_s + (w * HEADS + h) * WPAT;
      float n1 = 0.0f;
      float n2 = 0.0f;
#pragma unroll
      for (int k = 0; k < WPAT; ++k) {
        n1 = fmaf(wg[k], bf(feats_g[(p0 + k) * HID + d]), n1);
        n2 = fmaf(wg[k], bf(net.pos[k * HID + d]), n2);
      }
      pooled_s[i] = n1 + n2;
    }
    __syncthreads();
    // grouped centred RMS over each window's 768 values, one warp per window
    {
      constexpr int PER = POOLED / 32;
      const int lane = tid & 31;
      for (int w = tid >> 5; w < WC; w += THREADS / 32) {
        if (w >= nw) {
          for (int c = lane; c < POOLED; c += 32) norm_s[w * POOLED + c] = __float2bfloat16(0.0f);
          continue;
        }
        float s = 0.0f;
        for (int i = 0; i < PER; ++i) s += pooled_s[w * POOLED + lane + 32 * i];
        const float mean = warp_sum(s) / POOLED;
        float ss = 0.0f;
        for (int i = 0; i < PER; ++i) {
          const float c = pooled_s[w * POOLED + lane + 32 * i] - mean;
          ss += c * c;
        }
        const float scale = 1.0f / sqrtf(warp_sum(ss) / POOLED + 1e-6f);
        for (int i = 0; i < PER; ++i) {
          const int c = w * POOLED + lane + 32 * i;
          norm_s[c] = __float2bfloat16((pooled_s[c] - mean) * scale);
        }
      }
    }
    // head: out = norm @ Whead + bhead
    float acc[WC / 8][EMB / 32];
    zero(acc);
    gemm_tile(norm_s, POOLED, POOLED, net.wh, EMB, 0, wt2_s, acc);
#pragma unroll
    for (int i = 0; i < WC / 8; ++i) {
      const int w = ty + 8 * i;
      if (w >= nw) continue;
#pragma unroll
      for (int j = 0; j < EMB / 32; ++j) {
        const int c = tx + 32 * j;
        out[(w0 + w) * EMB + c] = acc[i][j] + net.bh[c];
      }
    }
  }
}

}  // namespace trunk
