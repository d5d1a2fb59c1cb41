// Mel-patch kernel (K1) for Hopper, sm_90a, and its bf16-DFT variant.
//
// Replaces heybuddy_tpu/ops/pallas/melspec_kernel.py::mel_patches_pallas
// (dft_mode="chunked"; `mel_patches_bf16_launch` is its dft_dtype=bfloat16):
// int16-range float32 audio (b, t) -> scaled log-mel written straight into
// the padded patch layout (b, p_pad, 128) that the fused embedding kernel
// reads. Patch p holds frames 4p..4p+3, 32 mel bins each, so row-major
// (p, k*32 + m) is the spectrogram's own (4p + k, m) order: real frames are
// stored flat, and rows num_patches..p_pad-1 are exact zeros. The arithmetic
// is mel_common.cuh's, shared with K3 and K4.
//
// What bounds it: the function needs far less than the kernel's direct DFT:
// a real 512-point FFT, the power of the 120 bins a mel filter reads and the
// filterbank's 231 non-zero products come to about 13 kFLOP per frame, 17
// FLOP per byte moved, below the card's fp32 ridge: the least time of the
// function is that of its bytes (640 B of new audio per frame read, 128 B
// written; chip_smoke.py prints both bounds). The kernel's own method, a
// 400 x 256 direct DFT per frame, is 0.2 MFLOP per frame; as a split (fp16 pair)
// tensor-core product it is three times that at the 16-bit rate, a floor
// 2.6x above the byte bound at 2048 clips. Every block reads the basis's
// split (400 KB of 16-bit values, precomputed beside the float32 basis) from
// L2: 2.5 GB per 2048 clips.
//
// Design: one block of 256 threads per (clip, chunk of 48 frames = 12
// patches), laid out as mel_common.cuh says; 66 KB of shared memory and 80
// registers a thread, so three blocks (24 warps) share an SM and one block's
// audio staging and mel tail overlap the others' products. Chunks that hold no real frame only write the zero pad rows.
// The frame-selector and lane-placement matmuls of the Pallas kernel are
// plain indexed stores here.
//
// Clips lie `ld` floats apart (dense batches pass ld = t). Sliding windows of
// one stream segment are a view with ld = the window stride, rows
// overlapping, so the segment is read where it lies instead of being copied
// out window by window; each block reads its own clip's samples either way.
// The float4 loads stay whenever every clip pointer is 16-byte aligned
// (mel_common.cuh tests each one).

#include "mel_common.cuh"

namespace {

template <int TERMS>
__global__ void __launch_bounds__(mel::THREADS, 3)
mel_patches_kernel(const float* __restrict__ audio, const float* __restrict__ basis,
                   const float* __restrict__ fb, float* __restrict__ out,
                   int t, long ld, int usable, int p_pad) {
  extern __shared__ float4 smem4[];
  const int clip = blockIdx.x;
  const int f0 = blockIdx.y * mel::FCHUNK;
  float* out_clip = out + static_cast<size_t>(clip) * p_pad * 4 * mel::NMEL;
  mel::logmel_chunk<TERMS>(audio + static_cast<size_t>(clip) * ld, t, f0, usable, 4 * p_pad, basis,
                           fb, reinterpret_cast<unsigned char*>(smem4),
                           [&](int fl, int m, float v) { out_clip[(f0 + fl) * mel::NMEL + m] = v; });
}

template <int TERMS>
int launch(const void* audio, const void* basis, const void* fb, void* out, int b, int t,
           int ld, int usable, int p_pad, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(mel_patches_kernel<TERMS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(mel::SMEM_BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int chunks = (4 * p_pad + mel::FCHUNK - 1) / mel::FCHUNK;
  dim3 grid(b, chunks);
  mel_patches_kernel<TERMS><<<grid, mel::THREADS, mel::SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(audio), static_cast<const float*>(basis),
      static_cast<const float*>(fb), static_cast<float*>(out), t, static_cast<long>(ld), usable,
      p_pad);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int mel_patches_smem_bytes() { return static_cast<int>(mel::SMEM_BYTES); }

// the entries take the row stride `ld` after t; a build that says so here
// (compare_builds.py reads it) is launched with it
extern "C" int mel_patches_row_stride() { return 1; }

// the split DFT, fp16 pairs (K1)
extern "C" int mel_patches_launch(const void* audio, const void* basis, const void* fb, void* out,
                                  int b, int t, int ld, int usable, int p_pad, void* stream) {
  return launch<3>(audio, basis, fb, out, b, t, ld, usable, p_pad, stream);
}

// the bf16 DFT, x_hi b_hi alone (dft_dtype=bfloat16)
extern "C" int mel_patches_bf16_launch(const void* audio, const void* basis, const void* fb,
                                       void* out, int b, int t, int ld, int usable, int p_pad,
                                       void* stream) {
  return launch<1>(audio, basis, fb, out, b, t, ld, usable, p_pad, stream);
}
