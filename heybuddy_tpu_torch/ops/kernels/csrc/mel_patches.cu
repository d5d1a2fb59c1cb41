// Mel-patch kernel (K1) for Hopper, sm_90a.
//
// Replaces heybuddy_tpu/ops/pallas/melspec_kernel.py::mel_patches_pallas
// (dft_mode="chunked"): int16-range float32 audio (b, t) -> scaled log-mel
// written straight into the padded patch layout (b, p_pad, 128) that the
// fused embedding kernel reads. Patch p holds frames 4p..4p+3, 32 mel bins
// each, so row-major (p, k*32 + m) is the spectrogram's own (4p + k, m) order:
// real frames are stored flat, and rows num_patches..p_pad-1 are exact zeros.
// The arithmetic is mel_common.cuh's, shared with K3 and K4.
//
// What bounds it: its own method's operations. It computes the DFT directly,
// per frame 400 x 256 FMAs, and 128 x 32 for the mel projection: about
// 0.21 MFLOP against 640 B of new audio read and 128 B written. The function
// needs far less: a real 512-point FFT, the power of the 120 bins a mel
// filter reads and the filterbank's 231 non-zero products come to about
// 13 kFLOP per frame, 17 FLOP per byte moved, below the card's fp32 ridge
// (67 TFLOP/s over 3.35 TB/s = 20 FLOP/B): the least time of the function is
// that of its bytes (chip_smoke.py prints both).
//
// Design: one block of 256 threads per (clip, chunk of 48 frames = 12
// patches), laid out as mel_common.cuh says. Chunks that hold no real frame
// only write the zero pad rows. The frame-selector and lane-placement matmuls
// of the Pallas kernel are plain indexed stores here.

#include "mel_common.cuh"

namespace {

__global__ void __launch_bounds__(mel::THREADS, 2)
mel_patches_kernel(const float* __restrict__ audio, const float* __restrict__ basis,
                   const float* __restrict__ fb, float* __restrict__ out,
                   int t, int usable, int p_pad) {
  extern __shared__ float4 smem4[];
  const int clip = blockIdx.x;
  const int f0 = blockIdx.y * mel::FCHUNK;
  float* out_clip = out + static_cast<size_t>(clip) * p_pad * 4 * mel::NMEL;
  mel::logmel_chunk(audio + static_cast<size_t>(clip) * t, t, f0, usable, 4 * p_pad, basis, fb,
                    reinterpret_cast<float*>(smem4),
                    [&](int fl, int m, float v) { out_clip[(f0 + fl) * mel::NMEL + m] = v; });
}

}  // namespace

extern "C" int mel_patches_launch(const void* audio, const void* basis, const void* fb, void* out,
                                  int b, int t, int usable, int p_pad, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(mel_patches_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(mel::SMEM_BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int chunks = (4 * p_pad + mel::FCHUNK - 1) / mel::FCHUNK;
  dim3 grid(b, chunks);
  mel_patches_kernel<<<grid, mel::THREADS, mel::SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(audio), static_cast<const float*>(basis),
      static_cast<const float*>(fb), static_cast<float*>(out), t, usable, p_pad);
  return static_cast<int>(cudaGetLastError());
}
