// Mel-spectrogram kernel (K3) for Hopper, sm_90a, and its bf16-DFT variant.
//
// Replaces heybuddy_tpu/ops/pallas/melspec_kernel.py::mel_spectrogram_pallas
// (`mel_spectrogram_bf16_launch` is its dft_dtype=bfloat16): int16-range
// float32 audio (b, t) -> scaled log-mel in spectrogram layout (b, frames,
// 32), frames = (t - 512) // 160 + 1, every frame written (no pad rows; the
// last frame need not complete a patch). The arithmetic is mel_common.cuh's,
// shared with K1 and K4, so this kernel's frames equal K1's patch rows bit
// for bit.
//
// What bounds it: as K1, the function's bytes (an FFT is about 13 kFLOP per
// frame, below the card's fp32 ridge); the kernel's own floor is its
// split direct DFT (3 x 0.2 MFLOP per frame) at the 16-bit tensor-core rate.
//
// Design: one block of 256 threads per (clip, chunk of 48 frames), laid out as
// mel_common.cuh says, three blocks per SM as K1. The Pallas kernel pads the clip to whole chunks of
// hops and the batch to its clip tile; here the audio loads are masked past t
// and the stores past the last frame, so nothing is padded.

#include "mel_common.cuh"

namespace {

template <int TERMS>
__global__ void __launch_bounds__(mel::THREADS, 3)
mel_spectrogram_kernel(const float* __restrict__ audio, const float* __restrict__ basis,
                       const float* __restrict__ fb, float* __restrict__ out, int t, int frames) {
  extern __shared__ float4 smem4[];
  const int clip = blockIdx.x;
  const int f0 = blockIdx.y * mel::FCHUNK;
  float* out_clip = out + static_cast<size_t>(clip) * frames * mel::NMEL;
  mel::logmel_chunk<TERMS>(audio + static_cast<size_t>(clip) * t, t, f0, frames, frames, basis, fb,
                           reinterpret_cast<unsigned char*>(smem4),
                           [&](int fl, int m, float v) { out_clip[(f0 + fl) * mel::NMEL + m] = v; });
}

template <int TERMS>
int launch(const void* audio, const void* basis, const void* fb, void* out, int b, int t,
           int frames, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(mel_spectrogram_kernel<TERMS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(mel::SMEM_BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(b, (frames + mel::FCHUNK - 1) / mel::FCHUNK);
  mel_spectrogram_kernel<TERMS><<<grid, mel::THREADS, mel::SMEM_BYTES,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(audio), static_cast<const float*>(basis),
      static_cast<const float*>(fb), static_cast<float*>(out), t, frames);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int mel_spectrogram_smem_bytes() { return static_cast<int>(mel::SMEM_BYTES); }

// the split DFT, fp16 pairs (K3)
extern "C" int mel_spectrogram_launch(const void* audio, const void* basis, const void* fb,
                                      void* out, int b, int t, int frames, void* stream) {
  return launch<3>(audio, basis, fb, out, b, t, frames, stream);
}

// the bf16 DFT, x_hi b_hi alone (dft_dtype=bfloat16)
extern "C" int mel_spectrogram_bf16_launch(const void* audio, const void* basis, const void* fb,
                                           void* out, int b, int t, int frames, void* stream) {
  return launch<1>(audio, basis, fb, out, b, t, frames, stream);
}
