// Mel-spectrogram kernel (K3) for Hopper, sm_90a, and its bf16-DFT variant.
//
// Replaces heybuddy_tpu/ops/pallas/melspec_kernel.py::mel_spectrogram_pallas
// (`mel_spectrogram_bf16_launch` is its dft_dtype=bfloat16): int16-range
// float32 audio (b, t) -> scaled log-mel in spectrogram layout (b, frames,
// 32), frames = (t - 512) // 160 + 1, every frame written (no pad rows; the
// last frame need not complete a patch). The float32 arithmetic is
// mel_fft.cuh's, shared with K1 and K4, and a frame's values depend only on
// its samples, so this kernel's frames equal K1's patch rows bit for bit;
// the bf16 entry runs mel_dft.cuh's `mel_dft_kernel`, as K1's does, and its
// frames equal K1-bf16's bit for bit too.
//
// What bounds it: as K1, the function's bytes (a frame's least work is about
// 9.4 kFLOP, below the card's fp32 ridge); the kernel's own method is that FFT
// on the CUDA cores, whose operations at the fp32 rate also take less time
// than the bytes.
//
// Design: K1's walk (mel_fft.cuh `logmel_walk`): persistent blocks, two an
// SM, over items of 32 frames, the next item's audio staged by cp.async while
// the current one is transformed. The Pallas kernel pads the clip to whole
// chunks of hops and the batch to its clip tile; here the audio copies are
// masked past t and the stores past the last frame, so nothing is padded.

#include "mel_dft.cuh"
#include "mel_fft.cuh"

namespace {

// the float32 FFT: persistent blocks walk (clip, 32 frames) items
__global__ void __launch_bounds__(mel::THREADS, 2)
mel_spectrogram_kernel(const float* __restrict__ audio, const float* __restrict__ basis,
                       const float* __restrict__ fb, float* __restrict__ out, int b, int t, int frames) {
  extern __shared__ float4 smem4[];
  const int chunks = (frames + mel::ITEM - 1) / mel::ITEM;
  mel::logmel_walk(b * chunks, chunks, t, frames, frames, basis, fb, reinterpret_cast<unsigned char*>(smem4),
                   [&](int clip) { return audio + static_cast<size_t>(clip) * t; },
                   [&](int clip, int f, int m, float v) {
                     out[(static_cast<size_t>(clip) * frames + f) * mel::NMEL + m] = v;
                   });
}

}  // namespace

// the larger entry's (the bf16 DFT's)
extern "C" int mel_spectrogram_smem_bytes() {
  return static_cast<int>(mel::FFT_SMEM_BYTES > mel::dft::SMEM_BYTES ? mel::FFT_SMEM_BYTES : mel::dft::SMEM_BYTES);
}

// the float32 FFT (K3)
extern "C" int mel_spectrogram_launch(const void* audio, const void* basis, const void* fb,
                                      void* out, int b, int t, int frames, void* stream) {
  const int items = b * ((frames + mel::ITEM - 1) / mel::ITEM);
  int blocks = 0;
  const cudaError_t err = mel::walk_blocks(mel_spectrogram_kernel, items, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  mel_spectrogram_kernel<<<blocks, mel::THREADS, mel::FFT_SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(audio), static_cast<const float*>(basis), static_cast<const float*>(fb),
      static_cast<float*>(out), b, t, frames);
  return static_cast<int>(cudaGetLastError());
}

// the bf16 DFT (dft_dtype=bfloat16)
extern "C" int mel_spectrogram_bf16_launch(const void* audio, const void* basis, const void* fb,
                                           void* out, int b, int t, int frames, void* stream) {
  return static_cast<int>(mel::dft::launch(audio, basis, fb, out, b, t, t, frames, frames,
                                           static_cast<cudaStream_t>(stream)));
}
