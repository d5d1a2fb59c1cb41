// Fused embedding kernel (K2) for Hopper, sm_90a: patch trunk -> banded
// 4-head window pooling -> 96-d head, several clips per block.
//
// Replaces heybuddy_tpu/ops/pallas/embedding_kernel.py::
// fused_embedding_from_patches (its body is _trunk_pool_body): patches
// (b, p_pad, 128) float32 -> embeddings (b, W, 96) float32. The function, its
// rounding points and its layout are trunk_pool.cuh's, shared with K4.
//
// What bounds it: operations. Per clip of 35 real patches about 26.5 MFLOP
// (the trunk is 22.4 of them) against 20 KB read and 6 KB written: the bf16
// tensor-core rate bounds the function. Its products (trunk, pooling sums,
// head) run as bf16 mma.sync (mma_sync.cuh), at most half of what the card's
// wgmma reaches; the RMS, GELU, softmax and the epilogues stay float32 on
// the CUDA cores and take the larger share of the time (PERF.md).
//
// Design: a block of 256 threads takes the patch rows of `cpb` clips (2 at
// 35 patches: 70 rows in a chunk of up to 80, five m16 tiles), so each trunk
// weight tile it reads from L2 serves all of them, not one clip's 35 rows; a
// clip longer than a chunk is walked in chunks of 80 rows. The trunk is
// row-wise, so the rows of different clips share the products; the pooling
// then runs per clip from the scratch (trunk_pool.cuh). `cpb` is chosen at
// launch: as many clips as fill a chunk, but no more than spread the batch
// over every block slot, so a small batch still occupies the card. A row's
// result does not depend on the chunk it sits in. 111 KB of shared memory:
// two blocks (16 warps) per SM, so one block's scalar phases (RMS, GELU,
// softmax, epilogues) overlap the other's products.

#include "trunk_pool.cuh"

namespace {

using trunk::bf16;

constexpr int RC = 80;   // patch rows per trunk chunk: 5 m16 tiles
constexpr int WN = 8;    // 1 x 8 warps: a warp holds 5 m16 tiles x 24 columns
constexpr int SMEM_BYTES = trunk::TrunkSmem<RC>::BYTES > trunk::POOL_SMEM_BYTES
                               ? trunk::TrunkSmem<RC>::BYTES
                               : trunk::POOL_SMEM_BYTES;  // 113920 B

struct Args {
  const float* patches;   // (b, P, 128)
  float* out;             // (b, W, 96)
  bf16* feats_g;          // (b, P, 192) scratch
  float* scores_g;        // (b, P, 4) scratch
  trunk::Weights net;
  int b;
  int cpb;                // clips per block
  int p_pad;
  int num_patches;
  int n_windows;
};

__global__ void __launch_bounds__(trunk::THREADS, 2) embedding_pool_kernel(const Args args) {
  extern __shared__ float4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  __shared__ float red_s[trunk::WARPS * trunk::HEADS];
  __shared__ float hmax_s[trunk::HEADS];

  const int c0 = blockIdx.x * args.cpb;
  const int clips = min(args.cpb, args.b - c0);
  const int np = args.num_patches;
  const int P = args.p_pad;
  const int total = clips * np;
  // chunk row g of this block: clip c0 + g / np, patch g % np
  auto scratch_row = [&](int g) {
    const int k = g / np;
    return (c0 + k) * P + (g - k * np);
  };
  for (int r0 = 0; r0 < total; r0 += RC) {
    trunk::trunk_chunk<RC, WN>(
        args.net,
        [&](int r, int c) {
          return args.patches[static_cast<size_t>(scratch_row(r0 + r)) * trunk::PD + c];
        },
        min(RC, total - r0), [&](int r) { return scratch_row(r0 + r); }, args.feats_g,
        args.scores_g, smem);
  }
  for (int k = 0; k < clips; ++k) {
    const size_t clip = c0 + k;
    trunk::pool_head(args.net, args.feats_g + clip * P * trunk::HID,
                     args.scores_g + clip * P * trunk::HEADS,
                     args.out + clip * args.n_windows * trunk::EMB, np, args.n_windows, smem,
                     red_s, hmax_s);
  }
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      count = 1;
  }
  return count;
}

}  // namespace

extern "C" int embedding_pool_smem_bytes() { return SMEM_BYTES; }

extern "C" int embedding_pool_launch(const void* patches, void* out, void* feats_g, void* scores_g,
                                     const void* wp, const void* bp, const void* upw, const void* upb,
                                     const void* dnw, const void* dnb, const void* q, const void* wh,
                                     const void* bh, const void* expc, const void* pos, const void* p0,
                                     int b, int p_pad, int num_patches, int n_windows, int n_blocks,
                                     void* stream) {
  cudaError_t err = cudaFuncSetAttribute(embedding_pool_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
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
  args.b = b;
  const int fill = RC / num_patches > 1 ? RC / num_patches : 1;
  const int slots = 2 * sm_count();  // blocks in flight: two per SM
  const int spread = (b + slots - 1) / slots;
  args.cpb = fill < spread ? fill : spread;
  args.p_pad = p_pad;
  args.num_patches = num_patches;
  args.n_windows = n_windows;
  const int grid = (b + args.cpb - 1) / args.cpb;
  embedding_pool_kernel<<<grid, trunk::THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(args);
  return static_cast<int>(cudaGetLastError());
}
