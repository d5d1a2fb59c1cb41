// The embedding body shared by K2 (embedding_pool.cu) and K4 (featurize.cu):
// patch trunk -> banded 4-head window pooling -> 96-d head, in blocks of 256
// threads, the products on the tensor cores (mma_sync.cuh).
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
// bf16. The products (patch_proj 128->192, up 192->384, down 384->192, the
// two pooling sums, head 768->96) run as bf16 mma.sync with float32
// accumulators: a product of two bf16 values is exact in float32, so only the
// order of the sums differs from a float32 FMA chain. The epilogues work on the accumulator fragments
// in the order and at the rounding points above. Every product walks its k
// axis in 16-wide steps from 0 up, whatever the warp tiling, so a row's
// result depends only on that row: K2's multi-clip blocks and K4's one-clip
// blocks give the same bits.
//
// Layout: `trunk_chunk<RC, WN>` runs the trunk over a chunk of up to RC patch
// rows, which may belong to several clips (the caller's loader and row map
// say whose). The chunk's activations stay in shared memory as bf16: feats
// (RC x 192) and the MLP hidden (RC x 384); the RMS output that feeds a
// product sits in the hidden buffer's upper half, which the up product's
// second column pass overwrites only after its last read. Row strides are
// padded by 8 bf16 so ldmatrix is conflict-free. The weights (about 0.8 MB in
// bf16, too large for shared memory) stream from L2 through a ring of three
// cp.async tiles of 16 rows x 192 columns, two k-steps ahead of the product
// and one barrier per k-step; each weight tile serves every row of the chunk.
// The 8 warps tile a product's 192 columns as (8 / WN) x WN warps: a warp
// takes every (8 / WN)-th m16 tile of the chunk and 192 / WN columns, and
// skips m16 tiles past the chunk's last row. The finished patch features and
// scores go to a global scratch (L2-resident) because the windows of a long
// clip span all of its patches. `pool_head` then walks one clip's windows 16
// at a time: the softmax weights in float32 on the CUDA cores, the pooling
// sums as two bf16 tensor-core products against the positional code and the
// chunk's feature rows (exact products, float32 sums, as the TPU kernel's
// banded matmuls), the grouped RMS in shared memory and the head product as
// one m16 tile (6 warps of 16 columns) whose weights stream in 64-row tiles.
// The Pallas selector matmuls (tile_h, gs, sel_h) and the banded (WH, P)
// weight matrix become indexing by window start.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_sync.cuh"

namespace trunk {

constexpr int PD = 128;     // patch values (4 frames x 32 mel)
constexpr int HID = 192;    // trunk width
constexpr int TH = 384;     // trunk MLP width
constexpr int HEADS = 4;
constexpr int WPAT = 19;    // patches per window
constexpr int EMB = 96;
constexpr int POOLED = HEADS * HID;  // 768 values per window

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int NS = HID;     // output columns of one product pass
constexpr int KT = 16;      // weight rows per staged tile: one k-step
constexpr int STAGES = 3;   // staged trunk weight tiles in flight
constexpr int HEAD_STAGES = 4;  // staged head weight tiles of HEAD_KSTEP k-steps each:
constexpr int HEAD_KSTEP = 4;   //   the head's k-steps are short, so a barrier spans four
constexpr int WC = 16;      // windows per pooling chunk: one m16 tile

using bf16 = __nv_bfloat16;

// padded row strides, in bf16 elements
constexpr int LDF = HID + 8;       // feats
constexpr int LDH = TH + 8;        // MLP hidden; the RMS output at column HID
constexpr int LDW = NS + 8;        // staged trunk weight tile
constexpr int LDN = POOLED + 8;    // normalised pooled rows
constexpr int LDW_HEAD = EMB + 8;  // staged head weight tile

// shared-memory layout of a trunk chunk of RC rows, bytes
template <int RC>
struct TrunkSmem {
  static constexpr int FEATS = 0;                                  // RC x LDF bf16
  static constexpr int HIDDEN = FEATS + RC * LDF * 2;              // RC x LDH bf16
  static constexpr int WT = HIDDEN + RC * LDH * 2;                 // STAGES x KT x LDW bf16
  static constexpr int BYTES = WT + STAGES * KT * LDW * 2;
};

// The pooling products: rows (window, head) of a chunk, WC x HEADS = 64 (4
// m16 tiles), against the positional code (k < 19, padded to 32) and against
// the feature rows of the chunk's patch span, PSPAN patches at a time.
constexpr int WH = WC * HEADS;
constexpr int KPOS = 32;
constexpr int PSPAN = 48;
constexpr int LDA_POS = KPOS + 8;
constexpr int LDA_PAT = PSPAN + 8;
constexpr int LDP = HID + 8;  // pooled rows, float: conflict-free fragment stores

// shared-memory layout of the pooling phase, bytes (over the trunk's)
constexpr int S2_POOLED = 0;                                // WH x LDP float
constexpr int S2_WGT = S2_POOLED + WH * LDP * 4;            // WC x HEADS x WPAT float
constexpr int S2_U = S2_WGT + WC * HEADS * WPAT * 4;        // the pooling products' tiles:
constexpr int S2_APOS = S2_U;                               //   WH x LDA_POS bf16
constexpr int S2_POS = S2_APOS + WH * LDA_POS * 2;          //   KPOS x LDF bf16
constexpr int S2_APAT = S2_POS + KPOS * LDF * 2;            //   WH x LDA_PAT bf16
constexpr int S2_FEATS = S2_APAT + WH * LDA_PAT * 2;        //   PSPAN x LDF bf16
constexpr int S2_NORM = S2_U;                               // then the head's A (WC x LDN bf16)
constexpr int S2_WT = 0;  // and its weight tiles over the dead pooled rows:
                          // HEAD_STAGES x HEAD_KSTEP KT x LDW_HEAD bf16
constexpr int POOL_SMEM_BYTES = S2_FEATS + PSPAN * LDF * 2;  // 100352 B
static_assert(HEAD_STAGES * HEAD_KSTEP * KT * LDW_HEAD * 2 <= S2_NORM &&
                  WC * LDN * 2 <= POOL_SMEM_BYTES - S2_NORM,
              "the head's tiles fit over the pooling's");
static_assert(WPAT <= KPOS && PSPAN % 16 == 0 && WH == 64, "pooling tiles");

static_assert((LDF * 2) % 16 == 0 && (LDH * 2) % 16 == 0 && (LDN * 2) % 16 == 0,
              "ldmatrix rows are 16-byte aligned");
static_assert(PD % KT == 0 && HID % KT == 0 && TH % KT == 0 && POOLED % KT == 0 && KT == 16,
              "one weight tile per k-step covers the k axis exactly");

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

// acc = A[rows of the chunk, :K] @ W[:K, n0 : n0 + NW] on the tensor cores.
// A is bf16 in shared memory (row stride lda); W is bf16 in global memory
// (row stride ldw), staged one 16-row k-step at a time by cp.async through a
// ring of STAGES tiles of 16 x (NW + 8) in wt_s, two k-steps ahead of the
// product (STG - 1 ahead for a ring of STG). Warps w < WM x WN compute: warp
// (wm, wn) holds m16 tiles wm + WM i (i < MT, those below m_tiles) and
// columns wn NT 8 .. + NT 8 of the pass. Ends with a barrier: A and wt_s are
// free.
template <int WM, int WN, int MT, int NT, int NW, int STG = STAGES, int KSTEP = 1>
__device__ __forceinline__ void gemm(const bf16* A, int lda, int K, const bf16* __restrict__ W,
                                     int ldw, int n0, bf16* wt_s, int m_tiles,
                                     float (&acc)[MT][NT][4]) {
  static_assert(WM * WN <= WARPS && WN * NT * 8 == NW && STG >= 2, "warp tiling");
  constexpr int LD = NW + 8;
  constexpr int ROWS = KSTEP * KT;    // weight rows per staged tile
  constexpr int ROW_PIECES = NW / 8;  // 16-byte pieces per weight row
  const int warp = threadIdx.x >> 5;
  const int wm = warp / WN;
  const int wn = warp % WN;
  const int m_active = warp < WM * WN ? (m_tiles - wm + WM - 1) / WM : 0;
  mma::zero(acc);
  const int nk = K / ROWS;
  // tile kt, if it exists, then close its group (empty past the end): group
  // kt holds tile kt, so waiting for all but the newest group finds tile kt
  auto stage = [&](int kt) {
    if (kt < nk) {
      bf16* dst = wt_s + (kt % STG) * ROWS * LD;
      const bf16* src = W + static_cast<size_t>(kt) * ROWS * ldw + n0;
      for (int p = threadIdx.x; p < ROWS * ROW_PIECES; p += THREADS) {
        const int r = p / ROW_PIECES;
        const int c = (p - r * ROW_PIECES) * 8;
        mma::cp_async16(dst + r * LD + c, src + static_cast<size_t>(r) * ldw + c);
      }
    }
    mma::cp_async_commit();
  };
#pragma unroll
  for (int kt = 0; kt < STG - 1; ++kt) stage(kt);
  for (int kt = 0; kt < nk; ++kt) {
    mma::cp_async_wait<STG - 2>();
    __syncthreads();     // tile kt (and A, on entry) visible; tile kt - 1 consumed by every warp
    stage(kt + STG - 1);  // over tile kt - 1
#pragma unroll
    for (int ks = 0; ks < KSTEP; ++ks)
      mma::mma_k16<MT, NT>(A + kt * ROWS + ks * KT, lda, wm * 16, WM * 16, m_active,
                           wt_s + (kt % STG) * ROWS * LD + ks * KT * LD, LD, wn * NT * 8, acc);
  }
  __syncthreads();
}

// f(row, col, v0, v1) for each pair of adjacent accumulators of `gemm`'s
// warp tile (columns col, col + 1 of the pass) in m16 tiles below m_tiles.
template <int WM, int WN, int MT, int NT, typename F>
__device__ __forceinline__ void epilogue(int m_tiles, const float (&acc)[MT][NT][4], F f) {
  const int warp = threadIdx.x >> 5;
  if (warp >= WM * WN) return;
  const int wm = warp / WN;
  const int wn = warp % WN;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int mt = wm + WM * i;
    if (mt >= m_tiles) break;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = (wn * NT + j) * 8 + mma::frag_col(0);
#pragma unroll
      for (int h = 0; h < 2; ++h) f(mt * 16 + mma::frag_row(2 * h), col, acc[i][j][2 * h], acc[i][j][2 * h + 1]);
    }
  }
}

__device__ __forceinline__ void store_pair(bf16* dst, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
}

// Centred RMS of `rows` rows of width N (float32 math) -> bf16 rows of dst
// (row stride ld); rows rows..rows_pad-1 are zeroed. One warp per row.
template <int N, typename Src>
__device__ __forceinline__ void rms_rows(Src load, int rows, int rows_pad, bf16* dst, int ld) {
  constexpr int PER = N / 32;
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < rows_pad; r += WARPS) {
    if (r >= rows) {
      for (int c = lane; c < N; c += 32) dst[r * ld + c] = __float2bfloat16(0.0f);
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
    for (int i = 0; i < PER; ++i) dst[r * ld + lane + 32 * i] = __float2bfloat16(v[i] * scale);
  }
}

// Trunk of `rows` (<= RC) patch rows; load(r, c) gives value c of chunk row
// r, and chunk row r goes to scratch row row_out(r) (its clip's row offset
// plus its patch): the features (bf16) to feats_g, the scores a = feats @ Q
// to scores_g. `smem` holds TrunkSmem<RC>::BYTES. Starts with a barrier, so
// the caller may have just written what load reads.
template <int RC, int WN, typename Load, typename RowOut>
__device__ __forceinline__ void trunk_chunk(const Weights& net, Load load, int rows, RowOut row_out,
                                            bf16* feats_g, float* scores_g, unsigned char* smem) {
  constexpr int WM = WARPS / WN;
  constexpr int MT = RC / 16 / WM;
  constexpr int NT = NS / 8 / WN;
  static_assert(RC % (16 * WM) == 0 && NS % (8 * WN) == 0, "chunk tiling");
  using S = TrunkSmem<RC>;
  bf16* feats_s = reinterpret_cast<bf16*>(smem + S::FEATS);
  bf16* hid_s = reinterpret_cast<bf16*>(smem + S::HIDDEN);
  bf16* xn_s = hid_s + HID;  // the RMS output: columns HID.. of the hidden rows
  bf16* wt_s = reinterpret_cast<bf16*>(smem + S::WT);
  const int m_tiles = (rows + 15) / 16;
  float acc[MT][NT][4];

  __syncthreads();
  rms_rows<PD>(load, rows, m_tiles * 16, xn_s, LDH);
  gemm<WM, WN, MT, NT, NS>(xn_s, LDH, PD, net.wp, HID, 0, wt_s, m_tiles, acc);
  epilogue<WM, WN>(m_tiles, acc, [&](int r, int c, float v0, float v1) {
    store_pair(feats_s + r * LDF + c, v0 + net.bp[c], v1 + net.bp[c + 1]);
  });
  for (int blk = 0; blk < net.n_blocks; ++blk) {
    __syncthreads();
    rms_rows<HID>([&](int r, int c) { return bf(feats_s[r * LDF + c]); }, rows, m_tiles * 16,
                  xn_s, LDH);
    const bf16* upw = net.upw + static_cast<size_t>(blk) * HID * TH;
    const float* upb = net.upb + blk * TH;
    // two column passes; the second overwrites xn_s, after gemm's closing barrier
    for (int n0 = 0; n0 < TH; n0 += NS) {
      gemm<WM, WN, MT, NT, NS>(xn_s, LDH, HID, upw, TH, n0, wt_s, m_tiles, acc);
      epilogue<WM, WN>(m_tiles, acc, [&](int r, int c, float v0, float v1) {
        const float h0 = v0 + upb[n0 + c];
        const float h1 = v1 + upb[n0 + c + 1];
        store_pair(hid_s + r * LDH + n0 + c,
                   0.5f * h0 * (1.0f + erff(h0 * 0.70710678118654752f)),
                   0.5f * h1 * (1.0f + erff(h1 * 0.70710678118654752f)));
      });
    }
    const bf16* dnw = net.dnw + static_cast<size_t>(blk) * TH * HID;
    const float* dnb = net.dnb + blk * HID;
    gemm<WM, WN, MT, NT, NS>(hid_s, LDH, TH, dnw, HID, 0, wt_s, m_tiles, acc);
    epilogue<WM, WN>(m_tiles, acc, [&](int r, int c, float v0, float v1) {
      bf16* f = feats_s + r * LDF + c;
      const float d0 = round_bf16(v0 + dnb[c]);
      const float d1 = round_bf16(v1 + dnb[c + 1]);
      store_pair(f, bf(f[0]) + d0, bf(f[1]) + d1);
    });
  }
  __syncthreads();
  // patch scores a = feats @ Q (a thread per row, its 4 heads), and the
  // finished rows to the scratch
  for (int r = threadIdx.x; r < rows; r += THREADS) {
    float a[HEADS] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
    for (int d = 0; d < HID; ++d) {
      const float f = bf(feats_s[r * LDF + d]);
#pragma unroll
      for (int h = 0; h < HEADS; ++h) a[h] = fmaf(f, bf(net.q[d * HEADS + h]), a[h]);
    }
#pragma unroll
    for (int h = 0; h < HEADS; ++h) scores_g[static_cast<size_t>(row_out(r)) * HEADS + h] = a[h];
  }
  constexpr int ROW_PIECES = HID / 8;  // 16-byte pieces per feature row
  for (int i = threadIdx.x; i < rows * ROW_PIECES; i += THREADS) {
    const int r = i / ROW_PIECES;
    const int c = (i - r * ROW_PIECES) * 8;
    *reinterpret_cast<uint4*>(feats_g + static_cast<size_t>(row_out(r)) * HID + c) =
        *reinterpret_cast<const uint4*>(feats_s + r * LDF + c);
  }
}

// Banded window pooling, grouped RMS and head for one clip whose trunk rows
// 0 .. num_patches - 1 are in its scratch: out (n_windows, 96). `smem` holds
// POOL_SMEM_BYTES; red_s (WARPS x HEADS floats) and hmax_s (HEADS) are shared too.
//
// Per chunk of WC windows the pooling sums are two products on the tensor
// cores, each exact bf16 x bf16 products summed in float32: n2 = A_pos @ pos
// (A_pos[(w, h), k] = wgt) and n1 = A_pat @ feats over the chunk's patches
// (A_pat[(w, h), p] = wgt at k = p - p0(w), zero off the band), then pooled =
// n1 + n2. 8 warps as 2 x 4: a warp holds m16 tiles wm, wm + 2 and 48 columns.
__device__ __forceinline__ void pool_head(const Weights& net, const bf16* feats_g,
                                          const float* scores_g, float* out, int num_patches,
                                          int n_windows, unsigned char* smem, float* red_s,
                                          float* hmax_s) {
  constexpr int PM = 2;  // warps along the (window, head) rows
  constexpr int PN = WARPS / PM;
  constexpr int PMT = WH / 16 / PM;
  constexpr int PNT = HID / 8 / PN;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp / PN;
  const int wn = warp % PN;
  __syncthreads();
  {
    // max over the clip's patches of each head's score: per thread, then
    // over the lanes of its head (lane % HEADS), then over the warps
    float m = -3.0e38f;
    for (int p = tid / HEADS; p < num_patches; p += THREADS / HEADS)
      m = fmaxf(m, scores_g[p * HEADS + tid % HEADS]);
#pragma unroll
    for (int off = 16; off >= HEADS; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if ((tid & 31) < HEADS) red_s[warp * HEADS + tid % HEADS] = m;
    __syncthreads();
    if (tid < HEADS) {
      float mm = -3.0e38f;
      for (int w = 0; w < WARPS; ++w) mm = fmaxf(mm, red_s[w * HEADS + tid]);
      hmax_s[tid] = mm;
    }
  }

  float* pooled_s = reinterpret_cast<float*>(smem + S2_POOLED);
  float* wgt_s = reinterpret_cast<float*>(smem + S2_WGT);
  bf16* apos_s = reinterpret_cast<bf16*>(smem + S2_APOS);
  bf16* pos_s = reinterpret_cast<bf16*>(smem + S2_POS);
  bf16* apat_s = reinterpret_cast<bf16*>(smem + S2_APAT);
  bf16* fpat_s = reinterpret_cast<bf16*>(smem + S2_FEATS);
  bf16* norm_s = reinterpret_cast<bf16*>(smem + S2_NORM);
  bf16* wt_s = reinterpret_cast<bf16*>(smem + S2_WT);
  const bf16 zero16 = __float2bfloat16(0.0f);

  for (int w0 = 0; w0 < n_windows; w0 += WC) {
    const int nw = min(WC, n_windows - w0);
    __syncthreads();
    // softmax weights of each (window, head) over its 19 patches; the
    // positional code, zero past its 19 rows
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
    for (int i = tid; i < KPOS * HID; i += THREADS) {
      const int k = i / HID;
      pos_s[k * LDF + i - k * HID] = k < WPAT ? net.pos[i] : zero16;
    }
    int plo = 1 << 30;
    int phi = 0;
    for (int w = 0; w < nw; ++w) {
      plo = min(plo, net.p0[w0 + w]);
      phi = max(phi, net.p0[w0 + w] + WPAT);
    }
    __syncthreads();
    for (int i = tid; i < WH * KPOS; i += THREADS) {
      const int r = i / KPOS;  // row (w, h)
      const int k = i - r * KPOS;
      apos_s[r * LDA_POS + k] =
          r < nw * HEADS && k < WPAT ? __float2bfloat16(wgt_s[r * WPAT + k]) : zero16;
    }
    __syncthreads();
    float acc[PMT][PNT][4];
    mma::zero(acc);
#pragma unroll
    for (int k0 = 0; k0 < KPOS; k0 += 16)
      mma::mma_k16<PMT, PNT>(apos_s + k0, LDA_POS, wm * 16, PM * 16, PMT, pos_s + k0 * LDF, LDF,
                             wn * PNT * 8, acc);
    epilogue<PM, PN>(WH / 16, acc, [&](int r, int c, float v0, float v1) {
      *reinterpret_cast<float2*>(pooled_s + r * LDP + c) = make_float2(v0, v1);  // n2
    });
    mma::zero(acc);
    for (int q0 = plo; q0 < phi; q0 += PSPAN) {
      __syncthreads();  // the previous span's tiles consumed
      for (int i = tid; i < WH * PSPAN; i += THREADS) {
        const int r = i / PSPAN;
        const int k = q0 + i - r * PSPAN - (r < nw * HEADS ? net.p0[w0 + r / HEADS] : 0);
        apat_s[r * LDA_PAT + i - r * PSPAN] =
            r < nw * HEADS && k >= 0 && k < WPAT ? __float2bfloat16(wgt_s[r * WPAT + k]) : zero16;
      }
      constexpr int ROW_PIECES = HID / 8;
      for (int i = tid; i < PSPAN * ROW_PIECES; i += THREADS) {
        const int r = i / ROW_PIECES;
        const int c = (i - r * ROW_PIECES) * 8;
        const int p = q0 + r;
        *reinterpret_cast<uint4*>(fpat_s + r * LDF + c) =
            p < phi && p < num_patches
                ? *reinterpret_cast<const uint4*>(feats_g + static_cast<size_t>(p) * HID + c)
                : make_uint4(0, 0, 0, 0);
      }
      __syncthreads();
#pragma unroll
      for (int k0 = 0; k0 < PSPAN; k0 += 16)
        mma::mma_k16<PMT, PNT>(apat_s + k0, LDA_PAT, wm * 16, PM * 16, PMT, fpat_s + k0 * LDF, LDF,
                               wn * PNT * 8, acc);
    }
    epilogue<PM, PN>(WH / 16, acc, [&](int r, int c, float v0, float v1) {
      float2* p = reinterpret_cast<float2*>(pooled_s + r * LDP + c);
      const float2 n2 = *p;
      *p = make_float2(v0 + n2.x, v1 + n2.y);  // n1 + n2
    });
    __syncthreads();
    // grouped centred RMS over each window's 768 values (its HEADS rows of
    // pooled_s, in head order), one warp per window
    {
      constexpr int PER = POOLED / 32;
      const int lane = tid & 31;
      for (int w = warp; w < WC; w += WARPS) {
        if (w >= nw) {
          for (int c = lane; c < POOLED; c += 32) norm_s[w * LDN + c] = zero16;
          continue;
        }
        // value c of the window: head c / HID, column c % HID (HID % 32 == 0)
        const float* rows = pooled_s + w * HEADS * LDP;
        auto value = [&](int i) { return rows[(i / (HID / 32)) * LDP + lane + 32 * (i % (HID / 32))]; };
        float s = 0.0f;
        for (int i = 0; i < PER; ++i) s += value(i);
        const float mean = warp_sum(s) / POOLED;
        float ss = 0.0f;
        for (int i = 0; i < PER; ++i) {
          const float c = value(i) - mean;
          ss += c * c;
        }
        const float scale = 1.0f / sqrtf(warp_sum(ss) / POOLED + 1e-6f);
        for (int i = 0; i < PER; ++i) norm_s[w * LDN + lane + 32 * i] = __float2bfloat16((value(i) - mean) * scale);
      }
    }
    // head: out = norm @ Whead + bhead, one m16 tile; warps 0-5 take 16 columns
    // each. Its weight tiles go over the pooled rows: every warp is done with them
    __syncthreads();
    float hacc[1][2][4];
    gemm<1, EMB / 16, 1, 2, EMB, HEAD_STAGES, HEAD_KSTEP>(norm_s, LDN, POOLED, net.wh, EMB, 0,
                                                        wt_s, 1, hacc);
    epilogue<1, EMB / 16>(1, hacc, [&](int w, int c, float v0, float v1) {
      if (w >= nw) return;
      float* o = out + static_cast<size_t>(w0 + w) * EMB + c;
      o[0] = v0 + net.bh[c];
      o[1] = v1 + net.bh[c + 1];
    });
  }
}

}  // namespace trunk
