// Mel-patch kernel (K1) for Hopper, sm_90a.
//
// Replaces heybuddy_tpu/ops/pallas/melspec_kernel.py::mel_patches_pallas
// (dft_mode="chunked"): int16-range float32 audio (b, t) -> scaled log-mel
// written straight into the padded patch layout (b, p_pad, 128) that the
// fused embedding kernel reads. Patch p holds frames 4p..4p+3, 32 mel bins
// each, so row-major (p, k*32 + m) is the spectrogram's own (4p + k, m) order:
// real frames are stored flat, and rows num_patches..p_pad-1 are exact zeros.
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
// What bounds it: operations. Per frame 400 x 256 FMAs for the DFT and
// 128 x 32 for the mel projection, about 0.21 MFLOP, against 2.56 KB of audio
// read and 128 B written: some 80 FLOP per byte, above the fp32 ridge of the
// card (67 TFLOP/s over 3.35 TB/s = 20 FLOP/B).
//
// Design: one block of 256 threads per (clip, chunk of 48 frames = 12 patches).
// The chunk's audio span (7920 samples, 31.7 KB) is loaded once into shared
// memory with masked loads past t (this replaces the Pallas tail-zeroing
// scratch); the (400, 256) basis streams through shared memory in 16-row
// tiles that every block reads from L2. Each thread keeps a 6-frame x 8-column
// register tile (48 accumulators); a warp shares its frames, so the audio
// reads are broadcasts and the basis reads are conflict-free. Power then goes
// to shared memory (over the dead audio/basis buffers) for the mel product
// against the filterbank in shared memory. Chunks that hold no real frame
// only write the zero pad rows. The frame-selector and lane-placement matmuls
// of the Pallas kernel are plain indexed stores here.

#include <cuda_runtime.h>

namespace {

constexpr int HOP = 160;
constexpr int TAP0 = 56;     // first non-zero row of the 512-point windowed basis
constexpr int TAPS = 400;    // rows [56, 456)
constexpr int NBIN = 128;    // DFT bins kept (cos block, then sin block)
constexpr int NCOL = 2 * NBIN;
constexpr int NMEL = 32;
constexpr int FCHUNK = 48;   // frames per block: 12 patches
constexpr int KT = 16;       // basis rows per shared-memory tile
constexpr int THREADS = 256;
constexpr int ROWS_PER_THREAD = FCHUNK / 8;     // 6 frames (ty + 8 i)
constexpr int COLS_PER_THREAD = NCOL / 32;      // 8 columns (tx + 32 j)
constexpr int AUDIO_SPAN = HOP * (FCHUNK - 1) + TAPS;  // 7920 samples

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

__global__ void __launch_bounds__(THREADS, 2)
mel_patches_kernel(const float* __restrict__ audio, const float* __restrict__ basis,
                   const float* __restrict__ fb, float* __restrict__ out,
                   int t, int usable, int p_pad) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* audio_s = smem + SMEM_AUDIO;
  float* basis_s = smem + SMEM_BASIS;
  float* power_s = smem + SMEM_POWER;
  float* fb_s = smem + SMEM_FB;

  const int clip = blockIdx.x;
  const int f0 = blockIdx.y * FCHUNK;
  const int tid = threadIdx.x;
  const int tx = tid & 31;
  const int ty = tid >> 5;
  const int frames_out = 4 * p_pad;
  float* out_clip = out + static_cast<size_t>(clip) * p_pad * 4 * NMEL;

  if (f0 >= usable) {
    // only pad rows in this chunk
    for (int idx = tid; idx < FCHUNK * NMEL; idx += THREADS) {
      const int f = f0 + idx / NMEL;
      if (f < frames_out) out_clip[f * NMEL + idx % NMEL] = 0.0f;
    }
    return;
  }

  const float* audio_clip = audio + static_cast<size_t>(clip) * t;
  const long g0 = static_cast<long>(HOP) * f0 + TAP0;
  for (int i = tid; i < AUDIO_SPAN; i += THREADS) {
    const long g = g0 + i;
    audio_s[i] = g < t ? audio_clip[g] : 0.0f;
  }
  for (int i = tid; i < NBIN * NMEL; i += THREADS) fb_s[i] = fb[i];

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

  for (int idx = tid; idx < FCHUNK * NMEL; idx += THREADS) {
    const int fl = idx / NMEL;
    const int m = idx % NMEL;
    const int f = f0 + fl;
    if (f >= frames_out) continue;
    float value = 0.0f;
    if (f < usable) {
      float mel = 0.0f;
#pragma unroll 8
      for (int bin = 0; bin < NBIN; ++bin) mel = fmaf(power_s[fl * NBIN + bin], fb_s[bin * NMEL + m], mel);
      value = logf(mel + 1e-6f) / 10.0f + 2.0f;
    }
    out_clip[f * NMEL + m] = value;
  }
}

}  // namespace

extern "C" int mel_patches_launch(const void* audio, const void* basis, const void* fb, void* out,
                                  int b, int t, int usable, int p_pad, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      mel_patches_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(SMEM_BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int chunks = (4 * p_pad + FCHUNK - 1) / FCHUNK;
  dim3 grid(b, chunks);
  mel_patches_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(audio), static_cast<const float*>(basis),
      static_cast<const float*>(fb), static_cast<float*>(out), t, usable, p_pad);
  return static_cast<int>(cudaGetLastError());
}
