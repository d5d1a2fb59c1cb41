// The mel body shared by the mel kernels for Hopper, sm_90a: K1
// (mel_patches.cu), K3 (mel_spectrogram.cu) and K4 (featurize.cu) run
// `logmel_chunk`; K1b (mel_patches_fat.cu) computes its spectrum another way
// and shares the tail (`mel_log_store`). One source of the arithmetic keeps
// every kernel's log-mel equal, bit for bit, for the same audio.
//
// Per frame f: spectrum = audio[160 f + 56 .. 160 f + 456) @ basis (400, 256),
// the windowed real-DFT basis restricted to the 400 rows the centred Hann
// window leaves non-zero (the other 112 rows of the 512-point frame are
// exactly zero) and to 128 cos + 128 sin bins (bins >= 124 carry zero mel
// weight). Then power = re^2 + im^2, mel = power @ fb (128, 32),
// log(mel + 1e-6) / 10 + 2.
//
// Numerics: the DFT multiplies int16-range audio, so it is exact fp32 FMA on
// the CUDA cores (no TF32, no tensor cores); compiled without fast math, with
// the accurate logf.
//
// Layout of `logmel_chunk`: 256 threads compute one chunk of 48 frames. The
// chunk's audio span (7920 samples, 31.7 KB) is loaded once into shared
// memory with masked loads past t; the (400, 256) basis streams through
// shared memory in 16-row tiles that every block reads from L2. Each thread
// keeps a 6-frame x 8-column register tile (48 accumulators); a warp shares
// its frames, so the audio reads are broadcasts and the basis reads are
// conflict-free. Power then goes to shared memory (over the dead audio/basis
// buffers) for the mel product against the filterbank in shared memory, and
// each value goes to the caller's `store(frame_in_chunk, mel_bin, value)`.

#pragma once

#include <cuda_runtime.h>

namespace mel {

constexpr int HOP = 160;
constexpr int TAP0 = 56;     // first non-zero row of the 512-point windowed basis
constexpr int TAPS = 400;    // rows [56, 456)
constexpr int NBIN = 128;    // DFT bins kept (cos block, then sin block)
constexpr int NCOL = 2 * NBIN;
constexpr int NMEL = 32;
constexpr int FCHUNK = 48;   // frames per chunk: 12 patches
constexpr int KT = 16;       // basis rows per shared-memory tile
constexpr int THREADS = 256;
constexpr int ROWS_PER_THREAD = FCHUNK / 8;     // 6 frames (ty + 8 i)
constexpr int COLS_PER_THREAD = NCOL / 32;      // 8 columns (tx + 32 j)
constexpr int AUDIO_SPAN = HOP * (FCHUNK - 1) + TAPS;  // 7920 samples

// scratch of `logmel_chunk`, in floats
constexpr int SMEM_AUDIO = 0;
constexpr int SMEM_BASIS = SMEM_AUDIO + AUDIO_SPAN;
constexpr int SMEM_MAIN = SMEM_BASIS + KT * NCOL;      // audio + basis tile
constexpr int SMEM_POWER = 0;                          // aliases audio + basis
constexpr int SMEM_FB = SMEM_MAIN;
constexpr int SMEM_FLOATS = SMEM_FB + NBIN * NMEL;
constexpr size_t SMEM_BYTES = SMEM_FLOATS * sizeof(float);  // 64448 B

static_assert(FCHUNK * NBIN <= SMEM_MAIN, "power tile must fit over audio + basis");
static_assert(TAPS % KT == 0, "basis tiles must cover the taps exactly");
static_assert((KT * NCOL) % (4 * THREADS) == 0, "basis tile loads as float4");

// `span` samples of one clip from sample g0 on into shared memory, zero past t.
__device__ __forceinline__ void load_audio(const float* __restrict__ audio_clip, int t, long g0,
                                           int span, float* audio_s) {
  for (int i = threadIdx.x; i < span; i += THREADS) {
    const long g = g0 + i;
    audio_s[i] = g < t ? audio_clip[g] : 0.0f;
  }
}

__device__ __forceinline__ void load_fb(const float* __restrict__ fb, float* fb_s) {
  for (int i = threadIdx.x; i < NBIN * NMEL; i += THREADS) fb_s[i] = fb[i];
}

// Frames f0 .. f0 + nf - 1 of a chunk whose power rows (nf x 128) are in
// shared memory: store(f - f0, m, v) for every frame f < n_out, v the scaled
// log-mel when f < usable and 0 past it.
template <typename Store>
__device__ __forceinline__ void mel_log_store(const float* power_s, const float* fb_s, int nf,
                                              int f0, int usable, int n_out, Store store) {
  for (int idx = threadIdx.x; idx < nf * NMEL; idx += THREADS) {
    const int fl = idx / NMEL;
    const int m = idx % NMEL;
    const int f = f0 + fl;
    if (f >= n_out) continue;
    float value = 0.0f;
    if (f < usable) {
      float mel = 0.0f;
#pragma unroll 8
      for (int bin = 0; bin < NBIN; ++bin) mel = fmaf(power_s[fl * NBIN + bin], fb_s[bin * NMEL + m], mel);
      value = logf(mel + 1e-6f) / 10.0f + 2.0f;
    }
    store(fl, m, value);
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

// Scaled log-mel of frames f0 .. f0 + 47 of one clip (t samples) through
// store(), as mel_log_store says. `smem` holds SMEM_FLOATS floats; the
// caller's block has THREADS threads. Starts with a barrier, so a caller may
// run chunks back to back over the same scratch.
template <typename Store>
__device__ __forceinline__ void logmel_chunk(const float* __restrict__ audio_clip, int t, int f0,
                                             int usable, int n_out, const float* __restrict__ basis,
                                             const float* __restrict__ fb, float* smem, Store store) {
  if (f0 >= usable) {
    zero_chunk(FCHUNK, f0, n_out, store);
    return;
  }
  float* audio_s = smem + SMEM_AUDIO;
  float* basis_s = smem + SMEM_BASIS;
  float* power_s = smem + SMEM_POWER;
  float* fb_s = smem + SMEM_FB;
  const int tid = threadIdx.x;
  const int tx = tid & 31;
  const int ty = tid >> 5;

  __syncthreads();  // the scratch may still be read by the previous chunk
  load_audio(audio_clip, t, static_cast<long>(HOP) * f0 + TAP0, AUDIO_SPAN, audio_s);
  load_fb(fb, fb_s);

  float acc[ROWS_PER_THREAD][COLS_PER_THREAD];
#pragma unroll
  for (int i = 0; i < ROWS_PER_THREAD; ++i)
#pragma unroll
    for (int j = 0; j < COLS_PER_THREAD; ++j) acc[i][j] = 0.0f;

  const float4* basis4 = reinterpret_cast<const float4*>(basis);
  float4* basis_s4 = reinterpret_cast<float4*>(basis_s);
  for (int k0 = 0; k0 < TAPS; k0 += KT) {
    __syncthreads();  // previous tile consumed (and audio loaded on entry)
    for (int i = tid; i < KT * NCOL / 4; i += THREADS)
      basis_s4[i] = basis4[k0 * (NCOL / 4) + i];
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      float a[ROWS_PER_THREAD];
      float bv[COLS_PER_THREAD];
#pragma unroll
      for (int i = 0; i < ROWS_PER_THREAD; ++i)
        a[i] = audio_s[(ty + 8 * i) * HOP + k0 + kk];
#pragma unroll
      for (int j = 0; j < COLS_PER_THREAD; ++j) bv[j] = basis_s[kk * NCOL + tx + 32 * j];
#pragma unroll
      for (int i = 0; i < ROWS_PER_THREAD; ++i)
#pragma unroll
        for (int j = 0; j < COLS_PER_THREAD; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
  }
  __syncthreads();  // audio and basis tiles dead: power goes over them

  // columns tx + 32 j: j < 4 are cos bins tx + 32 j, j >= 4 the matching sin bins
#pragma unroll
  for (int i = 0; i < ROWS_PER_THREAD; ++i)
#pragma unroll
    for (int j = 0; j < COLS_PER_THREAD / 2; ++j) {
      const float re = acc[i][j];
      const float im = acc[i][j + COLS_PER_THREAD / 2];
      power_s[(ty + 8 * i) * NBIN + tx + 32 * j] = re * re + im * im;
    }
  __syncthreads();

  mel_log_store(power_s, fb_s, FCHUNK, f0, usable, n_out, store);
}

}  // namespace mel
