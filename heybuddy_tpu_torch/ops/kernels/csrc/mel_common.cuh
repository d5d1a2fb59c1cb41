// What the mel kernels for Hopper, sm_90a, share. K1 (mel_patches.cu), K3
// (mel_spectrogram.cu) and K4 (featurize.cu) compute their float32 log-mel
// with mel_fft.cuh's `logmel_chunk`, a real FFT on the CUDA cores; the
// bf16-DFT entries of K1 and K3 with mel_dft.cuh's `mel_dft_kernel`, a
// wgmma product; K1b (mel_patches_fat.cu) computes its spectrum another way
// (one wgmma product over hop rows, its audio split into fp16 pairs by
// `operands<3>`). All of them end in the tail `mel_log_store`, so a frame's
// log-mel follows one source of arithmetic from its power on.
//
// Per frame f: spectrum = audio[160 f + 56 .. 160 f + 456) @ basis (400, 256),
// the windowed real-DFT basis restricted to the 400 rows the centred Hann
// window leaves non-zero (the other 112 rows of the 512-point frame are
// exactly zero) and to 128 cos + 128 sin bins (bins >= 124 carry zero mel
// weight). Then power = re^2 + im^2, mel = power @ fb (128, 32),
// log(mel + 1e-6) / 10 + 2.
//
// The bf16-DFT variant of the TPU kernel (dft_dtype=bfloat16) rounds the
// audio x and the basis b to bf16 and sums their exact products in float32.
// K1b's split product of fp16 pairs, x = x_hi + x_lo and b = b_hi + b_lo
// (lo = fp16(v - hi), after exact power-of-two scalings that keep both
// inside fp16's normal range), is x_hi b_hi + x_hi b_lo + x_lo b_hi with
// float32 accumulation: 22 significant bits a pair, float32-like accuracy
// (a bf16 pair's 16 bits moved the log-mel by 2e-3 on a tone with noise 60
// dB below it; PERF.md). Power, filterbank and log stay float32 on the CUDA
// cores, compiled without fast math, with the accurate logf.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sync.cuh"

namespace mel {

constexpr int HOP = 160;
constexpr int TAP0 = 56;     // first non-zero row of the 512-point windowed basis
constexpr int TAPS = 400;    // rows [56, 456)
constexpr int NBIN = 128;    // DFT bins kept (cos block, then sin block)
constexpr int NCOL = 2 * NBIN;
constexpr int NMEL = 32;
constexpr int THREADS = 256;                      // a block of the float32 FFT body
constexpr int WARPS = THREADS / 32;
constexpr int PLD = NBIN + 8;                     // power row stride: conflict-free fragment stores
// K1b's split DFT's exact power-of-two scalings: x 2^-8 keeps int16-range
// audio (and up to 2^24) inside fp16's range, b 2^8 lifts the basis's small
// values out of fp16's subnormals; their products are x b
constexpr float X_SCALE = 1.0f / 256.0f;
constexpr float B_SCALE = 256.0f;
// The taps buffer the kernels take is the float32 (TAPS, NCOL) matrix followed
// by its operands, each (TAPS, NCOL) of 16-bit values: the fp16 pair hi, lo of
// b B_SCALE, then bf16(b) row by row from 16-bit value OPS_BF16 on (read by
// no kernel of this tree: the prefix that earlier builds of K1, K3 and K4
// read, which compare_builds launches on these constants); then the FFT's
// table (mel_fft.cuh FFT_TABLE_OFFSET) and last bf16(b) as the bf16 DFT's
// wgmma tiles (mel_dft.cuh DFT_TILES_OFFSET; melspec_kernel.mel_constants).
constexpr int OPS_BF16 = 2 * TAPS * NCOL;

// The filterbank the kernels take is the float32 (NBIN, NMEL) matrix followed
// in the same buffer by each mel bin's band, the first and the last bin its
// filter is non-zero on, as NMEL int32 each (melspec_kernel.mel_constants).
constexpr int FB_FLOATS = NBIN * NMEL + 2 * NMEL;

static_assert(TAP0 % 4 == 0 && HOP % 4 == 0, "audio loads in groups of four samples");

// the scaled log-mel of a filterbank sum
__device__ __forceinline__ float scaled_log(float mel) { return logf(mel + 1e-6f) / 10.0f + 2.0f; }

// each mel bin's band, the first and the last bin its filter is non-zero
// on, behind the filterbank in shared memory
__device__ __forceinline__ const int* mel_bands(const float* fb_s) {
  return reinterpret_cast<const int*>(fb_s + NBIN * NMEL);
}

// Frames f0 .. f0 + nf - 1 of a chunk whose power rows (nf x 128, row stride
// LD) and filterbank (its bands behind it) are in shared memory: store(f - f0, m, v) for
// every frame f < n_out, v the scaled log-mel when f < usable and 0 past it.
// NTHREADS threads take part (the whole block by default), thread `tid` of
// them the caller's. A thread carries two frames' sums at once, two
// independent chains over the same filter weights; each sum keeps its own
// order, so the values do not depend on the pairing.
template <int LD = NBIN, int NTHREADS = THREADS, typename Store>
__device__ __forceinline__ void mel_log_store(const float* power_s, const float* fb_s, int nf,
                                              int f0, int usable, int n_out, int tid,
                                              Store store) {
  static_assert(NTHREADS % NMEL == 0, "a thread keeps one mel bin");
  // The filter of mel bin m is non-zero on bins lo..hi only. A product with
  // one of its zeros adds exactly +0 to the non-negative power sum, so the
  // sum over lo..hi in bin order has the bits of the sum over all 128 bins.
  const int m = tid % NMEL;
  const int lo = mel_bands(fb_s)[m];
  const int hi = mel_bands(fb_s)[NMEL + m];
  constexpr int STEP = NTHREADS / NMEL;  // frames between a thread's two
  for (int idx = tid; idx < nf * NMEL; idx += 2 * NTHREADS) {
    const int fl = idx / NMEL;
    const int fl2 = fl + STEP < nf ? fl + STEP : fl;  // a lone last frame pairs with itself
    const float* p = power_s + fl * LD;
    const float* p2 = power_s + fl2 * LD;
    float mel = 0.0f;
    float mel2 = 0.0f;
    for (int bin = lo; bin <= hi; ++bin) {
      const float w = fb_s[bin * NMEL + m];
      mel = fmaf(p[bin], w, mel);
      mel2 = fmaf(p2[bin], w, mel2);
    }
    if (f0 + fl < n_out) store(fl, m, f0 + fl < usable ? scaled_log(mel) : 0.0f);
    if (fl2 != fl && f0 + fl2 < n_out) store(fl2, m, f0 + fl2 < usable ? scaled_log(mel2) : 0.0f);
  }
}

// A chunk that holds no real frame: zeros for its frames below n_out.
template <typename Store>
__device__ __forceinline__ void zero_chunk(int nf, int f0, int n_out, Store store) {
  for (int idx = threadIdx.x; idx < nf * NMEL; idx += THREADS) {
    const int fl = idx / NMEL;
    if (f0 + fl < n_out) store(fl, idx % NMEL, 0.0f);
  }
}

// The DFT's 16-bit operands of an audio sample x, as raw bits: for the split
// DFT (TERMS 3, K1b) the fp16 pair hi = fp16(x X_SCALE), lo = fp16(x X_SCALE -
// hi); for the bf16 DFT (TERMS 1) bf16(x) alone.
template <int TERMS>
__device__ __forceinline__ void operands(float x, uint16_t& hi, uint16_t& lo) {
  if constexpr (TERMS == 3) {
    const float v = x * X_SCALE;
    const __half h = __float2half_rn(v);
    hi = __half_as_ushort(h);
    lo = __half_as_ushort(__float2half_rn(v - __half2float(h)));
  } else {
    hi = __bfloat16_as_ushort(__float2bfloat16(x));
    lo = 0;
  }
}

__device__ __forceinline__ uint32_t pack2(uint16_t a, uint16_t b) {
  return static_cast<uint32_t>(a) | (static_cast<uint32_t>(b) << 16);  // a at the lower address
}

// The whole block's barrier: the FFT body's threads by default.
struct BlockSync {
  __device__ __forceinline__ void operator()() const { __syncthreads(); }
};

}  // namespace mel
