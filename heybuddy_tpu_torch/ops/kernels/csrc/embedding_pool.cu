// Fused embedding kernel (K2) for Hopper, sm_90a: patch trunk -> banded
// 4-head window pooling -> 96-d head, one clip per block.
//
// Replaces heybuddy_tpu/ops/pallas/embedding_kernel.py::
// fused_embedding_from_patches (its body is _trunk_pool_body): patches
// (b, p_pad, 128) float32 -> embeddings (b, W, 96) float32. The function, its
// rounding points and its layout are trunk_pool.cuh's, shared with K4.
//
// What bounds it: operations. Per clip of 35 real patches about 26.5 MFLOP
// (the trunk is 22.4 of them) against 20 KB read and 6 KB written. This
// first kernel does them as float32 FMAs on the CUDA cores, so its own
// ceiling is the fp32 rate, 15x below the bf16 tensor-core rate the work
// could use; mma.sync / wgmma tiles are the next step.
//
// Design: one block of 256 threads per clip. The trunk runs over chunks of 40
// patch rows read from the patch tensor (the 35 real rows of a 1.44 s clip in
// one chunk), then the pooling walks the windows (trunk_pool.cuh).

#include "trunk_pool.cuh"

namespace {

using trunk::bf16;

struct Args {
  const float* patches;   // (b, P, 128)
  float* out;             // (b, W, 96)
  bf16* feats_g;          // (b, P, 192) scratch
  float* scores_g;        // (b, P, 4) scratch
  trunk::Weights net;
  int p_pad;
  int num_patches;
  int n_windows;
};

__global__ void __launch_bounds__(trunk::THREADS, 2) embedding_pool_kernel(const Args args) {
  extern __shared__ float4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  __shared__ float red_s[trunk::THREADS];
  __shared__ float hmax_s[trunk::HEADS];

  const int clip = blockIdx.x;
  const int P = args.p_pad;
  const float* patches = args.patches + static_cast<size_t>(clip) * P * trunk::PD;
  bf16* feats_g = args.feats_g + static_cast<size_t>(clip) * P * trunk::HID;
  float* scores_g = args.scores_g + static_cast<size_t>(clip) * P * trunk::HEADS;

  for (int r0 = 0; r0 < args.num_patches; r0 += trunk::RC) {
    const int rows = min(trunk::RC, args.num_patches - r0);
    trunk::trunk_chunk(
        args.net, [&](int r, int c) { return patches[(r0 + r) * trunk::PD + c]; }, r0, rows,
        feats_g, scores_g, smem);
  }
  trunk::pool_head(args.net, feats_g, scores_g,
                   args.out + static_cast<size_t>(clip) * args.n_windows * trunk::EMB,
                   args.num_patches, args.n_windows, smem, red_s, hmax_s);
}

}  // namespace

extern "C" int embedding_pool_launch(const void* patches, void* out, void* feats_g, void* scores_g,
                                     const void* wp, const void* bp, const void* upw, const void* upb,
                                     const void* dnw, const void* dnb, const void* q, const void* wh,
                                     const void* bh, const void* expc, const void* pos, const void* p0,
                                     int b, int p_pad, int num_patches, int n_windows, int n_blocks,
                                     void* stream) {
  cudaError_t err = cudaFuncSetAttribute(embedding_pool_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         trunk::SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args args;
  args.patches = static_cast<const float*>(patches);
  args.out = static_cast<float*>(out);
  args.feats_g = static_cast<bf16*>(feats_g);
  args.scores_g = static_cast<float*>(scores_g);
  args.net.wp = static_cast<const bf16*>(wp);
  args.net.bp = static_cast<const float*>(bp);
  args.net.upw = static_cast<const bf16*>(upw);
  args.net.upb = static_cast<const float*>(upb);
  args.net.dnw = static_cast<const bf16*>(dnw);
  args.net.dnb = static_cast<const float*>(dnb);
  args.net.q = static_cast<const bf16*>(q);
  args.net.wh = static_cast<const bf16*>(wh);
  args.net.bh = static_cast<const float*>(bh);
  args.net.expc = static_cast<const float*>(expc);
  args.net.pos = static_cast<const bf16*>(pos);
  args.net.p0 = static_cast<const int*>(p0);
  args.net.n_blocks = n_blocks;
  args.p_pad = p_pad;
  args.num_patches = num_patches;
  args.n_windows = n_windows;
  embedding_pool_kernel<<<b, trunk::THREADS, trunk::SMEM_BYTES,
                          static_cast<cudaStream_t>(stream)>>>(args);
  return static_cast<int>(cudaGetLastError());
}
