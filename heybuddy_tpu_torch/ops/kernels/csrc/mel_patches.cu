// Mel-patch kernel (K1) for Hopper, sm_90a, and its bf16-DFT variant.
//
// Replaces heybuddy_tpu/ops/pallas/melspec_kernel.py::mel_patches_pallas
// (dft_mode="chunked"; `mel_patches_bf16_launch` is its dft_dtype=bfloat16):
// int16-range float32 audio (b, t) -> scaled log-mel written straight into
// the padded patch layout (b, p_pad, 128) that the fused embedding kernel
// reads. Patch p holds frames 4p..4p+3, 32 mel bins each, so row-major
// (p, k*32 + m) is the spectrogram's own (4p + k, m) order: real frames are
// stored flat, and rows num_patches..p_pad-1 are exact zeros. The float32
// arithmetic is mel_fft.cuh's, shared with K3 and K4; the bf16 DFT is
// mel_dft.cuh's `mel_dft_kernel`, shared with K3's bf16 entry.
//
// What bounds it: the function's bytes. A real 512-point FFT (a 256-point
// complex FFT at the split-radix count and the post-twiddle), the power of
// the 120 bins a mel filter reads and the filterbank's 231 non-zero products
// come to about 9.4 kFLOP per frame, 12 FLOP per byte moved, below the card's
// fp32 ridge: the least time of the function is that of its bytes (640 B of
// new audio per frame read, 128 B written; chip_smoke.py prints both
// bounds). The kernel's own method is that FFT, about 10 kFLOP a frame as
// written (two radix-16 passes, twiddles, post-twiddle, power, the band
// sums), on the CUDA cores: at the fp32 rate under the byte bound, so its
// floor is the bytes too, and what limits it in practice is shared memory
// (the exchange, the staged audio) and instruction throughput. The bf16 entry
// keeps the direct DFT, 400 x 256 products a frame on wgmma (mel_dft.cuh says
// what bounds it).
//
// Design: persistent blocks of 256 threads, two an SM (97 KB of shared
// memory each), walk items of 32 frames (8 patches) of one clip, clip-major;
// a block stages the next item's audio span by cp.async while it transforms
// the current one, a half-warp a frame (mel_fft.cuh `logmel_walk`). Items
// that hold no real frame only write the zero pad rows. The bf16 entry's
// persistent blocks walk items of 128 frames flat across the clips, the
// basis streamed by TMA (mel_dft.cuh). The frame-selector
// and lane-placement matmuls of the Pallas kernel are plain indexed stores
// here.
//
// Clips lie `ld` floats apart (dense batches pass ld = t). Sliding windows of
// one stream segment are a view with ld = the window stride, rows
// overlapping, so the segment is read where it lies instead of being copied
// out window by window; each block reads its own clip's samples either way.
// The 16-byte copies stay whenever a clip pointer is 16-byte aligned and t %
// 4 == 0 (mel_fft.cuh and mel_dft.cuh test each one); 4-byte copies stage
// the others.

#include "mel_dft.cuh"
#include "mel_fft.cuh"

namespace {

// the float32 FFT: persistent blocks walk (clip, 32 frames) items
__global__ void __launch_bounds__(mel::THREADS, 2)
mel_patches_kernel(const float* __restrict__ audio, const float* __restrict__ basis,
                   const float* __restrict__ fb, float* __restrict__ out,
                   int b, int t, long ld, int usable, int p_pad) {
  extern __shared__ float4 smem4[];
  const int chunks = (4 * p_pad + mel::ITEM - 1) / mel::ITEM;
  mel::logmel_walk(b * chunks, chunks, t, usable, 4 * p_pad, basis, fb, reinterpret_cast<unsigned char*>(smem4),
                   [&](int clip) { return audio + static_cast<size_t>(clip) * ld; },
                   [&](int clip, int f, int m, float v) {
                     out[(static_cast<size_t>(clip) * 4 * p_pad + f) * mel::NMEL + m] = v;
                   });
}

}  // namespace

// the larger entry's (the bf16 DFT's)
extern "C" int mel_patches_smem_bytes() {
  return static_cast<int>(mel::FFT_SMEM_BYTES > mel::dft::SMEM_BYTES ? mel::FFT_SMEM_BYTES : mel::dft::SMEM_BYTES);
}

// the entries take the row stride `ld` after t; a build that says so here
// (compare_builds.py reads it) is launched with it
extern "C" int mel_patches_row_stride() { return 1; }

// the float32 FFT (K1)
extern "C" int mel_patches_launch(const void* audio, const void* basis, const void* fb, void* out,
                                  int b, int t, int ld, int usable, int p_pad, void* stream) {
  const int items = b * ((4 * p_pad + mel::ITEM - 1) / mel::ITEM);
  int blocks = 0;
  const cudaError_t err = mel::walk_blocks(mel_patches_kernel, items, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  mel_patches_kernel<<<blocks, mel::THREADS, mel::FFT_SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(audio), static_cast<const float*>(basis), static_cast<const float*>(fb),
      static_cast<float*>(out), b, t, static_cast<long>(ld), usable, p_pad);
  return static_cast<int>(cudaGetLastError());
}

// the bf16 DFT (dft_dtype=bfloat16)
extern "C" int mel_patches_bf16_launch(const void* audio, const void* basis, const void* fb,
                                       void* out, int b, int t, int ld, int usable, int p_pad,
                                       void* stream) {
  return static_cast<int>(mel::dft::launch(audio, basis, fb, out, b, t, ld, usable, 4 * p_pad,
                                           static_cast<cudaStream_t>(stream)));
}
