// Fused embedding kernel (K2) for Hopper, sm_90a: patch trunk -> banded
// 4-head window pooling -> 96-d head, in two kernels a launch.
//
// Replaces heybuddy_tpu/ops/pallas/embedding_kernel.py::
// fused_embedding_from_patches (its body is _trunk_pool_body): patches
// (b, p_pad, 128) float32 -> embeddings (b, W, 96) float32. The function, its
// rounding points and its layout are trunk_pool.cuh's, shared with K4.
//
// What bounds it: operations. Per clip of 35 real patches about 26.5 MFLOP
// (the trunk is 22.4 of them) against 20 KB read and 6 KB written: the bf16
// tensor-core rate bounds the function, which only wgmma reaches. Its
// products are wgmma (the pooling sums mma.sync); the weights, 0.6 MB, leave
// L2 once per 128 patch rows and the head's once per four clips. What holds
// the kernel above its bound is the CUDA-core work between the products, the
// exact-erff GELU most of all (PERF.md, phase costs).
//
// Design: `embedding_trunk_kernel` walks the batch's patch rows flat across
// clips in chunks of 128 (two warpgroup tiles of 64), one persistent block
// per SM, with the trunk's operand stream in a ring of trunk::RING slots;
// a second producer thread loads the next chunk's patch rows by TMA bulk
// copies (one a row) while the current chunk runs. A batch too small to give
// every SM a chunk of 128 rows takes tiles of 64 instead (one warpgroup a
// block), so it still spreads over the card. Then
// `embedding_pool_kernel` pools and runs the head, four 16-window chunks a
// block. A row's result does not depend on the chunk it sits in.

#include "trunk_pool.cuh"

namespace {

using trunk::bf16;

using Smem = trunk::TrunkSmem;
constexpr int TRUNK_SMEM = Smem::BYTES + 1024;  // and the alignment slack
constexpr int POOL_SMEM = trunk::POOL_SMEM_BYTES + 1024;

static_assert(TRUNK_SMEM <= 232448 && POOL_SMEM <= 232448, "at most 227 KB of shared memory a block");

struct Args {
  const float* patches;   // (b, P, 128)
  float* out;             // (b, W, 96)
  bf16* feats_g;          // (b, P, 192) scratch
  float* scores_g;        // (b, P, 4) scratch
  trunk::Weights net;
  int b;
  int tiles;              // warpgroup tiles a chunk: 2, or 1 for a small batch
  int p_pad;
  int num_patches;
  int n_windows;
};

__global__ void __launch_bounds__(trunk::THREADS, 1) embedding_trunk_kernel(const Args args) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = trunk::aligned_smem(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + Smem::BARS);
  uint64_t* patch_full = bars + 2 * trunk::RING;
  uint64_t* patch_empty = patch_full + 1;
  float* patch_s = reinterpret_cast<float*>(smem + Smem::PATCH);
  trunk::Ring ring{smem, bars, bars + trunk::RING, trunk::RING};
  if (threadIdx.x == 0) {
    ring.init(args.tiles * 4);
    hopper::mbar_init(patch_full, 1);
    hopper::mbar_init(patch_empty, args.tiles * 4);
    hopper::mbar_init_fence();
  }
  __syncthreads();

  const int np = args.num_patches;
  const int total = args.b * np;
  const int chunk_rows = args.tiles * trunk::TILE;
  const int chunks = (total + chunk_rows - 1) / chunk_rows;
  const int warp = threadIdx.x >> 5;
  const bool leader = (threadIdx.x & 31) == 0;
  if (warp >= trunk::PRODUCER_WARP) {
    hopper::setmaxnreg_dec<trunk::PRODUCER_REGS>();
    if (warp == trunk::PRODUCER_WARP && leader) {
      for (int c = blockIdx.x; c < chunks; c += gridDim.x)
        ring.fill(args.net.trunk_ops(), trunk::PROJ_SLOTS + args.net.n_blocks * trunk::BLOCK_SLOTS);
    } else if (warp == trunk::PRODUCER_WARP + 1 && leader) {
      // each chunk's patch rows, a bulk copy a row (the buffer's rows are
      // padded), once the previous chunk's are read
      int k = 0;
      for (int c = blockIdx.x; c < chunks; c += gridDim.x, ++k) {
        const int g0 = c * chunk_rows;
        const int g1 = min(total, g0 + chunk_rows);
        if (k > 0) hopper::mbar_wait(patch_empty, (k - 1) & 1);
        hopper::mbar_expect_tx(patch_full, (g1 - g0) * trunk::PD * 4);
        for (int g = g0; g < g1; ++g) {
          const int clip = g / np;
          hopper::bulk_load(patch_s + (g - g0) * trunk::LDP,
                            args.patches + (static_cast<size_t>(clip) * args.p_pad + g - clip * np) * trunk::PD,
                            trunk::PD * 4, patch_full);
        }
      }
    }
    return;
  }
  hopper::setmaxnreg_inc<trunk::CONSUMER_REGS>();
  const int wg = warp / 4;
  if (wg >= args.tiles) return;
  bf16* feats_s = reinterpret_cast<bf16*>(smem + Smem::FEATS) + wg * trunk::TILE * trunk::LDF;
  bf16* xn_s = reinterpret_cast<bf16*>(smem + Smem::XN) + wg * trunk::TILE * trunk::HID;
  int k = 0;
  for (int c = blockIdx.x; c < chunks; c += gridDim.x, ++k) {
    const int base = c * chunk_rows + wg * trunk::TILE;  // flat row of tile row 0
    // tile row r: clip g / np, patch g % np of flat row g = base + r
    auto scratch_row = [&](int r) {
      const int g = base + r;
      const int clip = g / np;
      return clip * args.p_pad + (g - clip * np);
    };
    hopper::mbar_wait(patch_full, k & 1);
    trunk::trunk_tile(
        args.net, ring, wg, feats_s, xn_s, min(trunk::TILE, total - base),
        [&](int r, int col) { return *reinterpret_cast<const float4*>(patch_s + (wg * trunk::TILE + r) * trunk::LDP + col); },
        [&] {
          __syncwarp();
          if ((threadIdx.x & 31) == 0) hopper::mbar_arrive(patch_empty);
        },
        scratch_row, args.feats_g, args.scores_g);
  }
}

__global__ void __launch_bounds__(trunk::THREADS, 1) embedding_pool_kernel(const Args args) {
  extern __shared__ unsigned char smem_raw[];
  trunk::pool_group(args.net, args.feats_g, args.scores_g, args.out, args.b, args.p_pad,
                    args.num_patches, args.n_windows, trunk::aligned_smem(smem_raw));
}

}  // namespace

extern "C" int embedding_pool_smem_bytes() { return TRUNK_SMEM > POOL_SMEM ? TRUNK_SMEM : POOL_SMEM; }

extern "C" int embedding_pool_launch(const void* patches, void* out, void* feats_g, void* scores_g,
                                     const void* wp, const void* bp, const void* upw, const void* upb,
                                     const void* dnw, const void* dnb, const void* q, const void* wh,
                                     const void* bh, const void* expc, const void* pos, const void* p0,
                                     int b, int p_pad, int num_patches, int n_windows, int n_blocks,
                                     void* stream) {
  (void)upw;  // the up and down weights are read from the operand stream behind wp
  (void)dnw;
  cudaError_t err = cudaFuncSetAttribute(embedding_trunk_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, TRUNK_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(embedding_pool_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               POOL_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args args;
  args.patches = static_cast<const float*>(patches);
  args.out = static_cast<float*>(out);
  args.feats_g = static_cast<bf16*>(feats_g);
  args.scores_g = static_cast<float*>(scores_g);
  args.net.wp = static_cast<const bf16*>(wp);
  args.net.bp = static_cast<const float*>(bp);
  args.net.upb = static_cast<const float*>(upb);
  args.net.dnb = static_cast<const float*>(dnb);
  args.net.q = static_cast<const bf16*>(q);
  args.net.wh = static_cast<const bf16*>(wh);
  args.net.bh = static_cast<const float*>(bh);
  args.net.expc = static_cast<const float*>(expc);
  args.net.pos = static_cast<const bf16*>(pos);
  args.net.p0 = static_cast<const int*>(p0);
  args.net.n_blocks = n_blocks;
  args.b = b;
  args.p_pad = p_pad;
  args.num_patches = num_patches;
  args.n_windows = n_windows;
  const long rows = static_cast<long>(b) * num_patches;
  const int sms = trunk::sm_count();
  args.tiles = (rows + trunk::CHUNK - 1) / trunk::CHUNK >= sms ? 2 : 1;
  const long chunks = (rows + args.tiles * trunk::TILE - 1) / (args.tiles * trunk::TILE);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  embedding_trunk_kernel<<<static_cast<unsigned>(chunks < sms ? chunks : sms), trunk::THREADS, TRUNK_SMEM, s>>>(
      args);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long pool_chunks = static_cast<long>(b) * ((n_windows + trunk::WC - 1) / trunk::WC);
  embedding_pool_kernel<<<static_cast<unsigned>((pool_chunks + trunk::GROUP - 1) / trunk::GROUP),
                          trunk::THREADS, POOL_SMEM, s>>>(args);
  return static_cast<int>(cudaGetLastError());
}
