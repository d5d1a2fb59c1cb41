// The float32 mel body of K1 (mel_patches.cu), K3 (mel_spectrogram.cu) and
// K4 (featurize.cu): each frame's spectrum as a real FFT on the CUDA cores,
// out of registers and shared memory, then the filterbank and the log.
//
// Per frame f: y[n] = w[n] audio[160 f + n], n = 0..511, w the periodic Hann
// window of 400 taps centred in the frame (zero outside n = 56..455). The 256
// complex points z[m] = y[2m] + i y[2m+1] go through a 256-point FFT, and a
// post-twiddle splits the real spectrum out of it:
//   Y[k] = (Z[k] + conj(Z[256 - k])) / 2 + W512^k (Z[k] - conj(Z[256 - k])) / 2i
// for bins k = 0..127 (bins >= 124 carry zero mel weight). Then power =
// |Y[k]|^2, mel = power @ fb (128, 32) over each mel bin's band, and
// log(mel + 1e-6) / 10 + 2, each value as mel_common.cuh's mel_log_store
// computes it.
//
// Why the CUDA cores: the FFT needs about 10 kFLOP a frame against the direct
// DFT's 205k (614k as the split tensor-core product this body replaces), so
// at the card's float32 rate it takes less time than the function's bytes.
// A tensor-core FFT of 512 points (16 x 32 factors) would run two complex
// products as large as the direct DFT once split to float32 accuracy, so it
// saves nothing at this size.
//
// The walk of a frame: 16 lanes of a warp, 16 points a lane. Lane l loads
// z[l + 16 j] for j = 0..15 (j = 0 and 15 are always outside the window),
// runs a radix-16 DFT over j in registers (dft16: radix 4 x 4), multiplies
// by W256^(l k1) and writes its 16 values to a padded shared-memory row per
// k1; after the exchange lane k1 holds the 16 values of its k1 and runs the
// second radix-16 DFT, which leaves Z[k1 + 16 k2] in register k2. Z[256 - k]
// of bin k = k1 + 16 k2 sits in register 15 - k2 of lane (16 - k1) % 16
// (lane 0: its own register (16 - k2) % 16), so one round of 8 shuffles
// brings each lane its partners. Each lane writes the power of its 8 bins to
// the frame's row.
//
// The two halves of a warp transform two frames side by side; their power
// rows then go through mel_log_store (mel_common.cuh) by the same warp, lane
// m summing mel bin m of both frames from the filterbank in shared memory.
// No barrier beyond the warp's own is needed from a chunk's staging barrier
// to its last value, so warps drift apart and one warp's filterbank sums and
// logs overlap the others' transforms.
//
// Invariants. A frame's bits depend on its 400 samples and nothing else: not
// on the chunk length (32 frames in K1 and K3, 144 in K4), the chunk's first
// frame, the load path or row stride, nor the warp or half-warp that
// computes it. So the two half-warps of a warp transform two frames side by
// side and never mix them (no two real frames packed into one complex FFT),
// every butterfly is written with explicit __fadd_rn / __fsub_rn / __fmul_rn
// / fmaf, which ptxas may not contract otherwise wherever the body inlines,
// and the window, twiddles and W16 constants come from one float32 table
// computed in float64 on the host (melspec_kernel._numpy_fft_table), which
// lies behind the taps buffer's operands. The libraries build without fast
// math and keep the accurate logf. Frames at or past `usable` are exact
// zeros, samples at or past t read as zeros.
//
// Two entry points. K4 calls `logmel_chunk<FRAMES>` on one clip segment at a time
// (144 frames, staged with plain loads, its caller's barrier). K1 and K3 run
// `logmel_walk`: a persistent block walks items of 32 frames of one clip
// (clip-major) and stages the next item's audio span by cp.async into the
// other of two buffers while it transforms the current one, so the audio's
// trip from memory overlaps the arithmetic (identical blocks that each load,
// then compute, stay in step and leave the card idle while they load). The
// table and the filterbank are staged once a block. Shared memory of a K1 /
// K3 block: the two spans (21 KB each), the table, the filterbank and the
// exchange buffers: 97 KB, two blocks an SM.

#pragma once

#include "mel_common.cuh"

namespace mel {

// the FFT's table: float32 values at these offsets, complex values as (re, im)
constexpr int RADIX = 16;          // lanes a frame and points a lane
constexpr int FFT_WIN = 0;         // w[n], n = 0..511
constexpr int FFT_TW1 = 512;       // W256^(l k1) at k1 * 16 + l: 256 complex
constexpr int FFT_TW2 = 1024;      // W512^k, k = 0..127: 128 complex
constexpr int FFT_TABLE = 1280;    // floats of the table
// where it lies in the taps buffer, in floats: behind the float32 taps and
// the three 16-bit operands (mel_common.cuh)
constexpr int FFT_TABLE_OFFSET = 256000;
static_assert(FFT_TABLE_OFFSET == TAPS * NCOL + 3 * TAPS * NCOL / 2, "the table follows the operands");
static_assert(FFT_TW1 == FFT_WIN + 2 * 256 && FFT_TW2 == FFT_TW1 + 2 * RADIX * RADIX &&
                  FFT_TABLE == FFT_TW2 + 2 * NBIN,
              "the table's parts, back to back");

constexpr int XLD = RADIX + 1;     // exchange row stride, complex values: conflict-free columns
constexpr int XBUF = RADIX * XLD;  // complex values of a half-warp's exchange buffer
constexpr int ITEM = 32;           // frames of a K1 / K3 item
static_assert(2 * PLD <= 2 * XBUF * 2, "a warp's two power rows fit over its exchange buffers");

// scratch of the FFT body, bytes from its base; the staged spans follow
struct FftScratch {
  static constexpr int TABLE = 0;                          // FFT_TABLE float
  static constexpr int FB = TABLE + FFT_TABLE * 4;         // FB_FLOATS float
  static constexpr int XCH = FB + FB_FLOATS * 4;           // 2 WARPS x XBUF float2
  static constexpr int SPANS = XCH + 2 * WARPS * XBUF * 8;
  static_assert(FB % 16 == 0 && XCH % 16 == 0 && SPANS % 16 == 0, "aligned parts");
};

// samples a chunk of FRAMES frames reads: 160 (FRAMES - 1) + 400 from 160 f0 + 56
template <int FRAMES>
__host__ __device__ constexpr int span_floats() { return HOP * (FRAMES - 1) + TAPS; }
static_assert(span_floats<ITEM>() % 4 == 0, "spans of whole float4s");

// shared memory of the FFT body with NSPAN staged spans of FRAMES frames
template <int FRAMES, int NSPAN>
__host__ __device__ constexpr int fft_smem_bytes() { return FftScratch::SPANS + NSPAN * span_floats<FRAMES>() * 4; }
constexpr size_t FFT_SMEM_BYTES = fft_smem_bytes<ITEM, 2>();  // K1 / K3: 99456 B

namespace fft {

__device__ __forceinline__ float2 add(float2 a, float2 b) {
  return make_float2(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
}

__device__ __forceinline__ float2 sub(float2 a, float2 b) {
  return make_float2(__fsub_rn(a.x, b.x), __fsub_rn(a.y, b.y));
}

// a w
__device__ __forceinline__ float2 cmul(float2 a, float2 w) {
  return make_float2(fmaf(a.x, w.x, __fmul_rn(-a.y, w.y)), fmaf(a.x, w.y, __fmul_rn(a.y, w.x)));
}

// the DFT of four points in place: a_k = sum_j a_j (-i)^(j k)
__device__ __forceinline__ void dft4(float2& a0, float2& a1, float2& a2, float2& a3) {
  const float2 t0 = add(a0, a2);
  const float2 t1 = sub(a0, a2);
  const float2 t2 = add(a1, a3);
  const float2 t3 = sub(a1, a3);
  a0 = add(t0, t2);
  a2 = sub(t0, t2);
  a1 = make_float2(__fadd_rn(t1.x, t3.y), __fsub_rn(t1.y, t3.x));
  a3 = make_float2(__fsub_rn(t1.x, t3.y), __fadd_rn(t1.y, t3.x));
}

// the W16 twiddles that are not exact: W16^1, W16^3 and cos(pi / 4)
struct W16 {
  float2 w1;
  float2 w3;
  float r;
};

// X[k] = sum_j x[j] W16^(j k), in place: radix 4 over j2 (j = j1 + 4 j2),
// the twiddles W16^(j1 k1a), radix 4 over j1 (k = k1a + 4 k1b)
__device__ __forceinline__ void dft16(float2 (&x)[RADIX], const W16& w) {
#pragma unroll
  for (int j1 = 0; j1 < 4; ++j1) dft4(x[j1], x[j1 + 4], x[j1 + 8], x[j1 + 12]);
  // x[j1 + 4 k1a] *= W16^(j1 k1a)
  const float r = w.r;
  auto w2 = [r](float2 a) {  // W16^2 = (r, -r)
    return make_float2(__fmul_rn(__fadd_rn(a.x, a.y), r), __fmul_rn(__fsub_rn(a.y, a.x), r));
  };
  auto w6 = [r](float2 a) {  // W16^6 = (-r, -r)
    return make_float2(__fmul_rn(__fsub_rn(a.y, a.x), r), -__fmul_rn(__fadd_rn(a.x, a.y), r));
  };
  x[5] = cmul(x[5], w.w1);
  x[9] = w2(x[9]);
  x[13] = cmul(x[13], w.w3);
  x[6] = w2(x[6]);
  x[10] = make_float2(x[10].y, -x[10].x);  // W16^4 = -i
  x[14] = w6(x[14]);
  x[7] = cmul(x[7], w.w3);
  x[11] = w6(x[11]);
  x[15] = cmul(x[15], make_float2(-w.w1.x, -w.w1.y));  // W16^9 = -W16^1
  float2 y[RADIX];
#pragma unroll
  for (int k1a = 0; k1a < 4; ++k1a) {
    dft4(x[4 * k1a], x[4 * k1a + 1], x[4 * k1a + 2], x[4 * k1a + 3]);
#pragma unroll
    for (int k1b = 0; k1b < 4; ++k1b) y[k1a + 4 * k1b] = x[4 * k1a + k1b];
  }
#pragma unroll
  for (int k = 0; k < RADIX; ++k) x[k] = y[k];
}

// The power of bins 0..127 of one frame, computed by the 16 lanes of a
// half-warp (this one's `l`, 0..15) while the other half computes another
// frame: `frame` is the span's first sample of the frame's tap 56, `buf` the
// half-warp's exchange buffer, and the powers come back in p[k2], bin l + 16
// k2. Every lane of the warp calls it (the post-twiddle's shuffles).
__device__ __forceinline__ void fft_power(const float* span, int frame, const float2* win2,
                                          const float2* tw1, const float2* tw2, const W16& w,
                                          float2* buf, int l, int lane, float (&p)[NBIN / RADIX]) {
  float2 x[RADIX];
  // z[m], m = l + 16 j: taps n = 2m, 2m + 1, non-zero for 28 <= m < 228
  x[0] = make_float2(0.0f, 0.0f);
  x[RADIX - 1] = make_float2(0.0f, 0.0f);
#pragma unroll
  for (int j = 1; j < RADIX - 1; ++j) {
    const int m = l + RADIX * j;
    const bool in = (j > 1 || l >= 12) && (j < RADIX - 2 || l < 4);
    if (in) {
      const float2 a = *reinterpret_cast<const float2*>(span + frame + 2 * m - TAP0);
      const float2 v = win2[m];
      x[j] = make_float2(__fmul_rn(a.x, v.x), __fmul_rn(a.y, v.y));
    } else {
      x[j] = make_float2(0.0f, 0.0f);
    }
  }
  dft16(x, w);
#pragma unroll
  for (int k1 = 1; k1 < RADIX; ++k1) x[k1] = cmul(x[k1], tw1[k1 * RADIX + l]);
#pragma unroll
  for (int k1 = 0; k1 < RADIX; ++k1) buf[k1 * XLD + l] = x[k1];
  __syncwarp();
  // lane l is now bin group k1 = l: A[l'] = X[k1] of lane l'
#pragma unroll
  for (int j = 0; j < RADIX; ++j) x[j] = buf[l * XLD + j];
  dft16(x, w);  // x[k2] = Z[l + 16 k2]
  const int partner = (lane & RADIX) | ((RADIX - l) & (RADIX - 1));
  float2 recv[NBIN / RADIX];
#pragma unroll
  for (int i = 0; i < NBIN / RADIX; ++i)
    recv[i] = make_float2(__shfl_sync(0xffffffffu, x[RADIX - 1 - i].x, partner),
                          __shfl_sync(0xffffffffu, x[RADIX - 1 - i].y, partner));
#pragma unroll
  for (int k2 = 0; k2 < NBIN / RADIX; ++k2) {
    const float2 z = x[k2];
    const float2 zc = l != 0 ? recv[k2] : (k2 == 0 ? x[0] : recv[k2 - 1]);  // Z[256 - k]
    const float er = __fadd_rn(z.x, zc.x);  // 2 E[k]
    const float ei = __fsub_rn(z.y, zc.y);
    const float orr = __fadd_rn(z.y, zc.y);  // 2 O[k]
    const float oi = __fsub_rn(zc.x, z.x);
    const float2 t = tw2[l + RADIX * k2];
    const float yr = fmaf(t.x, orr, fmaf(-t.y, oi, er));  // 2 Y[k]
    const float yi = fmaf(t.x, oi, fmaf(t.y, orr, ei));
    p[k2] = __fmul_rn(fmaf(yr, yr, __fmul_rn(yi, yi)), 0.25f);
  }
}

}  // namespace fft

// cp.async of 16 (or 4) bytes, zeros instead where `in` is false
__device__ __forceinline__ void cp_async16_or_zero(float* dst, const float* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(mma::smem_addr(dst)), "l"(src),
               "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async4_or_zero(float* dst, const float* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(mma::smem_addr(dst)), "l"(src),
               "r"(in ? 4 : 0));
}

// The span of a chunk from frame f0 into `span`, zeros from sample t on: a
// float4 at a time where t % 4 == 0 and the clip is 16-byte aligned (g0 is a
// multiple of 4, so a group lies wholly below t or wholly past it), else a
// float at a time; by cp.async (ASYNC: the caller commits and waits) or by
// plain loads.
template <int FRAMES, bool ASYNC>
__device__ __forceinline__ void stage_span(const float* __restrict__ clip, int t, int f0, float* span) {
  constexpr int SPAN = span_floats<FRAMES>();
  const long g0 = static_cast<long>(HOP) * f0 + TAP0;
  const int tid = threadIdx.x;
  if (t % 4 == 0 && reinterpret_cast<uintptr_t>(clip) % 16 == 0) {
#pragma unroll 4
    for (int i = 4 * tid; i < SPAN; i += 4 * THREADS) {
      const long g = g0 + i;
      if constexpr (ASYNC) {
        cp_async16_or_zero(span + i, g < t ? clip + g : clip, g < t);
      } else {
        *reinterpret_cast<float4*>(span + i) =
            g < t ? __ldg(reinterpret_cast<const float4*>(clip + g)) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    }
  } else {
#pragma unroll 4
    for (int i = tid; i < SPAN; i += THREADS) {
      const long g = g0 + i;
      if constexpr (ASYNC) {
        cp_async4_or_zero(span + i, g < t ? clip + g : clip, g < t);
      } else {
        span[i] = g < t ? clip[g] : 0.0f;
      }
    }
  }
}

__device__ __forceinline__ void stage_table(const float* __restrict__ basis, float* tab) {
  const float4* src = reinterpret_cast<const float4*>(basis + FFT_TABLE_OFFSET);
  for (int i = threadIdx.x; i < FFT_TABLE / 4; i += THREADS) reinterpret_cast<float4*>(tab)[i] = __ldg(src + i);
}

__device__ __forceinline__ void stage_fb(const float* __restrict__ fb, float* fb_s) {
  static_assert(FB_FLOATS % 4 == 0, "the filterbank in float4s");
  const float4* src = reinterpret_cast<const float4*>(fb);
  for (int i = threadIdx.x; i < FB_FLOATS / 4; i += THREADS) reinterpret_cast<float4*>(fb_s)[i] = __ldg(src + i);
}

// Frames f0 .. f0 + FRAMES - 1 of a chunk whose span, table and filterbank
// are staged (and visible): store(frame_in_chunk, mel_bin, value) for every
// frame below n_out, as mel_log_store says. Warp w takes the pairs of frames
// 2 w, 2 w + 1, 2 w + 16, ..., a half-warp a frame; only warp barriers.
template <int FRAMES, typename Store>
__device__ __forceinline__ void fft_frames(const float* span, int f0, int usable, int n_out,
                                           unsigned char* scratch, Store store) {
  static_assert(FRAMES % (2 * WARPS) == 0, "every warp takes whole pairs of frames");
  using S = FftScratch;
  const float* tab = reinterpret_cast<const float*>(scratch + S::TABLE);
  const float* fb_s = reinterpret_cast<const float*>(scratch + S::FB);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int half = lane >> 4;
  const int l = lane & (RADIX - 1);
  const float2* win2 = reinterpret_cast<const float2*>(tab + FFT_WIN);
  const float2* tw1 = reinterpret_cast<const float2*>(tab + FFT_TW1);
  const float2* tw2 = reinterpret_cast<const float2*>(tab + FFT_TW2);
  // W16^1, W16^3, W16^2 = W256^16, W256^48, W256^32: k1 = 8 and l = 2, 6, 4
  const fft::W16 w{tw1[8 * RADIX + 2], tw1[8 * RADIX + 6], tw1[8 * RADIX + 4].x};
  float2* xch = reinterpret_cast<float2*>(scratch + S::XCH) + 2 * warp * XBUF;
  float* rows = reinterpret_cast<float*>(xch);  // the warp's two power rows, over its exchange buffers
  for (int fp = 2 * warp; fp < FRAMES; fp += 2 * WARPS) {
    if (f0 + fp < usable) {  // the pair holds a real frame
      float p[NBIN / RADIX];
      fft::fft_power(span, HOP * (fp + half), win2, tw1, tw2, w, xch + half * XBUF, l, lane, p);
      __syncwarp();  // both exchanges read: the rows go over them
#pragma unroll
      for (int k2 = 0; k2 < NBIN / RADIX; ++k2) rows[half * PLD + l + RADIX * k2] = p[k2];
      __syncwarp();
    }
    mel_log_store<PLD, 32>(rows, fb_s, 2, f0 + fp, usable, n_out, lane,
                           [&](int k, int m, float v) { store(fp + k, m, v); });
    __syncwarp();  // the rows read: the next pair's exchange goes over them
  }
}

// Scaled log-mel of frames f0 .. f0 + FRAMES - 1 of one clip (t samples)
// through store(frame_in_chunk, mel_bin, value), as mel_log_store says. `basis`
// is the taps buffer (the table at FFT_TABLE_OFFSET), `fb` the filterbank
// buffer, `smem` holds fft_smem_bytes<FRAMES, 1>(); threads 0 .. THREADS - 1
// of the caller's block run it and `sync` is their barrier (the block's,
// unless the block has more threads). Starts with a barrier, so a caller may
// run chunks back to back over the same scratch.
template <int FRAMES, typename Store, typename Sync = BlockSync>
__device__ __forceinline__ void logmel_chunk(const float* __restrict__ audio_clip, int t, int f0,
                                             int usable, int n_out, const float* __restrict__ basis,
                                             const float* __restrict__ fb, unsigned char* smem,
                                             Store store, Sync sync = Sync()) {
  if (f0 >= usable) {
    zero_chunk(FRAMES, f0, n_out, store);
    return;
  }
  float* span = reinterpret_cast<float*>(smem + FftScratch::SPANS);
  sync();  // the scratch may still be read by the previous chunk
  stage_table(basis, reinterpret_cast<float*>(smem + FftScratch::TABLE));
  stage_fb(fb, reinterpret_cast<float*>(smem + FftScratch::FB));
  stage_span<FRAMES, false>(audio_clip, t, f0, span);
  sync();
  fft_frames<FRAMES>(span, f0, usable, n_out, smem, store);
}

// K1's and K3's walk: items i = blockIdx.x, blockIdx.x + gridDim.x, ... of
// `items` = clips x `chunks`; item i is frames 32 c .. 32 c + 31 (c = i %
// chunks) of clip i / chunks, whose samples clip_of(clip) points at (t of
// them); store(clip, frame, mel_bin, value) for every frame below n_out, 0
// from `usable` on. `smem` holds FFT_SMEM_BYTES. While an item is transformed,
// the next item's span loads into the other buffer (cp.async group k holds
// the span of the block's item k).
template <typename ClipOf, typename Store>
__device__ __forceinline__ void logmel_walk(int items, int chunks, int t, int usable, int n_out,
                                            const float* __restrict__ basis,
                                            const float* __restrict__ fb, unsigned char* smem,
                                            ClipOf clip_of, Store store) {
  constexpr int SPAN = span_floats<ITEM>();
  float* spans = reinterpret_cast<float*>(smem + FftScratch::SPANS);
  auto stage = [&](int item, float* span) {
    const int f0 = (item % chunks) * ITEM;
    if (item < items && f0 < usable) stage_span<ITEM, true>(clip_of(item / chunks), t, f0, span);
    mma::cp_async_commit();  // an empty group for an item without a span
  };
  stage_table(basis, reinterpret_cast<float*>(smem + FftScratch::TABLE));
  stage_fb(fb, reinterpret_cast<float*>(smem + FftScratch::FB));
  stage(blockIdx.x, spans);
  int k = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++k) {
    float* span = spans + (k & 1) * SPAN;
    mma::cp_async_wait<0>();  // this item's span
    // visible to every thread (the table and filterbank too, the first
    // time), and every warp done with the previous item's span
    __syncthreads();
    stage(item + gridDim.x, spans + ((k + 1) & 1) * SPAN);  // over the previous item's span
    const int clip = item / chunks;
    const int f0 = (item % chunks) * ITEM;
    fft_frames<ITEM>(span, f0, usable, n_out, smem, [&](int fc, int m, float v) { store(clip, f0 + fc, m, v); });
  }
}

// sets its kernel's shared memory and writes the blocks of a `logmel_walk`
// launch: as many as fit on the current card, at most one an item. The
// resident count is queried once a card and kept by device; a failed query
// returns its error (the caller then launches nothing), so a launch never
// falls back to another schedule.
template <typename Kernel>
cudaError_t walk_blocks(Kernel kernel, int items, int* blocks) {
  constexpr int MAX_DEVICES = 64;
  static int resident[MAX_DEVICES] = {};  // 0 until the card was queried
  int dev = 0;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(FFT_SMEM_BYTES));
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, FFT_SMEM_BYTES);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;  // the block does not fit on an SM
    resident[dev] = sms * per_sm;
  }
  *blocks = items < resident[dev] ? items : resident[dev];
  return cudaSuccess;
}

}  // namespace mel
