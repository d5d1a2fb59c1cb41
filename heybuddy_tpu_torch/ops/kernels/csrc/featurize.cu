// One-kernel featurization (K4) for Hopper, sm_90a: audio -> log-mel patches
// -> patch trunk -> banded 4-head window pooling -> 96-d head, the log-mel
// never in device memory.
//
// Replaces heybuddy_tpu/ops/pallas/featurize_kernel.py::fused_featurize
// (featurize_batch(pooling="mega")): int16-range float32 audio (b, t) ->
// embeddings (b, W, 96) float32. It runs K1's mel body (mel_common.cuh) and
// K2's trunk and pooling (trunk_pool.cuh) as they are, so for the same audio
// its output equals K1 followed by K2 bit for bit.
//
// What bounds it: operations. The function's least work is the mel by an FFT
// (about 13 kFLOP per frame) at the fp32 rate plus the trunk (about 26.5
// MFLOP per clip of 35 patches) at the bf16 tensor-core rate, against only
// the audio read (92 KB per 1.44 s clip) and the 6 KB of embeddings written.
// The kernel runs K1's split direct DFT (fp16 pairs, mma.sync) and K2's
// wgmma trunk and pooling. What fusion saves is the patch round trip through
// device memory (20 KB per clip written by K1, read by K2) and a launch.
//
// Design: K2's two kernels, the first (`featurize_trunk_kernel`) computing
// its patch rows itself. A persistent block takes a contiguous range of
// clips and walks it in chunks of whole clips of up to 128 patch rows (three
// 1.44 s clips; a longer clip in pieces of 128). Both warpgroups first run
// the mel body over each clip of the chunk, 144 frames at a time (a 1.44 s
// clip in one pass; a frame's log-mel depends only on its frame, so any
// patch may start a mel chunk of any length), into a shared-memory buffer
// of the chunk's patch rows in the patch layout (p, k*32 + m), which takes
// the place of K2's prefetched rows; then each warpgroup runs K2's trunk
// tile on its 64 rows. The mel scratch (145 KB) overlays the trunk's operand
// ring and activations, so the producer fills the ring for a chunk once its
// mel is over (`mel_done`). The pooling kernel is K2's. The Pallas kernel's
// frame->patch redistribution matmuls at Precision.HIGHEST, its smaller
// frame chunk (32) and its raised VMEM limit exist for Mosaic's layout rules
// and have no counterpart here.

#include "mel_common.cuh"
#include "trunk_pool.cuh"

namespace {

using trunk::bf16;

using Smem = trunk::TrunkSmem;
constexpr int TRUNK_SMEM = Smem::BYTES + 1024;  // and the alignment slack
constexpr int POOL_SMEM = trunk::POOL_SMEM_BYTES + 1024;
constexpr int MEL_BAR = 3;  // the consumers' named barrier (1, 2: the warpgroups')
// The mel body a clip segment at a time, 144 frames (a 1.44 s clip's 140)
// and three basis tiles in flight a pass: each basis tile read from L2 serves
// three times K1's frames, and one block an SM hides less latency than K1's
// three. Its scratch overlays the operand ring and the trunk's activations.
constexpr int MEL_MT = 9;
constexpr int MEL_STAGES = 3;
constexpr int MEL_FRAMES = 16 * MEL_MT;

static_assert(TRUNK_SMEM <= 232448 && POOL_SMEM <= 232448, "at most 227 KB of shared memory a block");
static_assert(mel::DftSmem<MEL_MT, MEL_STAGES>::BYTES <= Smem::WORK_END,
              "the mel scratch fits over the ring and the trunk's activations");
static_assert(mel::THREADS == trunk::CONSUMERS * 128, "the consumer warpgroups run the mel body");
static_assert(trunk::PD == 4 * mel::NMEL, "a patch is 4 frames of mel bins");

struct ConsumerSync {
  __device__ __forceinline__ void operator()() const { hopper::bar_sync(MEL_BAR, mel::THREADS); }
};

struct Args {
  const float* audio;     // (b, t)
  const float* basis;     // (400, 256)
  const float* fb;        // (128, 32)
  float* out;             // (b, W, 96)
  bf16* feats_g;          // (b, P, 192) scratch
  float* scores_g;        // (b, P, 4) scratch
  trunk::Weights net;
  int b;
  int t;
  int p_pad;
  int num_patches;
  int n_windows;
};

// The batch in units of whole clips, or, for a clip longer than CHUNK
// patch rows, of CHUNK-row pieces of one; a trunk chunk is as many
// consecutive units as fit in CHUNK rows (three 1.44 s clips). Each block
// takes a contiguous range of units, so no block has more than one chunk
// beyond its share.
struct Units {
  int per_clip;   // pieces a clip (1: whole clips)
  int per_chunk;  // units a chunk
  int count;
  __host__ __device__ Units(int b, int np)
      : per_clip((np + trunk::CHUNK - 1) / trunk::CHUNK),
        per_chunk(np <= trunk::CHUNK ? trunk::CHUNK / np : 1),
        count(b * per_clip) {}
  // units of block `blk` of `grid`: [lo, hi)
  __device__ int lo(int blk, int grid) const { return static_cast<int>(static_cast<long>(count) * blk / grid); }
};

// A trunk chunk: units u .. u + n - 1. Chunk row r is patch pa + r % span of
// clip clip0 + r / span.
struct Chunk {
  int clip0;
  int clips;
  int pa;
  int pb;
  int span;  // pb - pa
  __device__ Chunk(const Units& units, int u, int n, int np) {
    clip0 = u / units.per_clip;
    clips = units.per_clip == 1 ? n : 1;
    pa = (u % units.per_clip) * trunk::CHUNK;
    pb = np < pa + trunk::CHUNK ? np : pa + trunk::CHUNK;
    span = pb - pa;
  }
  __device__ int scratch_row(int r, int p_pad) const {
    const int k = r / span;
    return (clip0 + k) * p_pad + pa + r - k * span;
  }
};

__global__ void __launch_bounds__(trunk::THREADS, 1) featurize_trunk_kernel(const Args args) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = trunk::aligned_smem(smem_raw);
  float* patch_s = reinterpret_cast<float*>(smem + Smem::PATCH);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + Smem::BARS);
  uint64_t* mel_done = bars + 2 * trunk::RING;  // the chunk's mel over: the ring is the producer's
  trunk::Ring ring{smem, bars, bars + trunk::RING, trunk::RING};
  if (threadIdx.x == 0) {
    ring.init(trunk::CONSUMERS * 4);
    hopper::mbar_init(mel_done, trunk::CONSUMERS * 4);
    hopper::mbar_init_fence();
  }
  __syncthreads();

  const int np = args.num_patches;
  const Units units(args.b, np);
  const int u_lo = units.lo(blockIdx.x, gridDim.x);
  const int u_hi = units.lo(blockIdx.x + 1, gridDim.x);
  const int warp = threadIdx.x >> 5;
  if (warp >= trunk::PRODUCER_WARP) {
    hopper::setmaxnreg_dec<trunk::PRODUCER_REGS>();
    if (warp == trunk::PRODUCER_WARP && (threadIdx.x & 31) == 0) {
      int k = 0;
      for (int u = u_lo; u < u_hi; u += units.per_chunk, ++k) {
        hopper::mbar_wait(mel_done, k & 1);
        ring.fill(args.net.trunk_ops(), trunk::PROJ_SLOTS + args.net.n_blocks * trunk::BLOCK_SLOTS);
      }
    }
    return;
  }
  hopper::setmaxnreg_inc<trunk::CONSUMER_REGS>();
  const int wg = warp / 4;
  bf16* feats_s = reinterpret_cast<bf16*>(smem + Smem::FEATS) + wg * trunk::TILE * trunk::LDF;
  bf16* xn_s = reinterpret_cast<bf16*>(smem + Smem::XN) + wg * trunk::TILE * trunk::HID;
  for (int u = u_lo; u < u_hi; u += units.per_chunk) {
    const Chunk ch(units, u, min(units.per_chunk, u_hi - u), np);
    // each clip's patches pa .. pb - 1, one mel pass a 1.44 s clip
    for (int k = 0; k < ch.clips; ++k) {
      const float* audio_clip = args.audio + static_cast<size_t>(ch.clip0 + k) * args.t;
      for (int f0 = 4 * ch.pa; f0 < 4 * ch.pb; f0 += MEL_FRAMES) {
        const int fr = 4 * k * ch.span + f0 - 4 * ch.pa;  // the chunk's frame of frame f0
        mel::logmel_chunk<3, MEL_MT, MEL_STAGES>(
            audio_clip, args.t, f0, 4 * ch.pb, 4 * ch.pb, args.basis, args.fb, smem,
            [&](int fl, int m, float v) {
              const int f = fr + fl;  // frame k of patch row p: values k * 32 .. of the row
              patch_s[(f / 4) * trunk::LDP + (f % 4) * mel::NMEL + m] = v;
            },
            ConsumerSync{});
      }
    }
    ConsumerSync{}();  // the buffer complete; the mel scratch dead
    hopper::fence_async_shared();  // its accesses ordered before the ring's TMA writes
    if ((threadIdx.x & 31) == 0) hopper::mbar_arrive(mel_done);
    const int r0 = wg * trunk::TILE;  // the tile's first chunk row
    trunk::trunk_tile(
        args.net, ring, wg, feats_s, xn_s, min(trunk::TILE, ch.clips * ch.span - r0),
        [&](int r, int col) { return *reinterpret_cast<const float4*>(patch_s + (r0 + r) * trunk::LDP + col); },
        [] {}, [&](int r) { return ch.scratch_row(r0 + r, args.p_pad); }, args.feats_g, args.scores_g);
  }
}

__global__ void __launch_bounds__(trunk::THREADS, 1) featurize_pool_kernel(const Args args) {
  extern __shared__ unsigned char smem_raw[];
  trunk::pool_group(args.net, args.feats_g, args.scores_g, args.out, args.b, args.p_pad,
                    args.num_patches, args.n_windows, trunk::aligned_smem(smem_raw));
}

}  // namespace

extern "C" int featurize_smem_bytes() { return TRUNK_SMEM > POOL_SMEM ? TRUNK_SMEM : POOL_SMEM; }

extern "C" int featurize_launch(const void* audio, const void* basis, const void* fb, void* out,
                                void* feats_g, void* scores_g, const void* wp, const void* bp,
                                const void* upw, const void* upb, const void* dnw, const void* dnb,
                                const void* q, const void* wh, const void* bh, const void* expc,
                                const void* pos, const void* p0, int b, int t, int p_pad,
                                int num_patches, int n_windows, int n_blocks, void* stream) {
  (void)upw;  // the up and down weights are read from the operand stream behind wp
  (void)dnw;
  cudaError_t err = cudaFuncSetAttribute(featurize_trunk_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, TRUNK_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(featurize_pool_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               POOL_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args args;
  args.audio = static_cast<const float*>(audio);
  args.basis = static_cast<const float*>(basis);
  args.fb = static_cast<const float*>(fb);
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
  args.t = t;
  args.p_pad = p_pad;
  args.num_patches = num_patches;
  args.n_windows = n_windows;
  const Units units(b, num_patches);
  const int sms = trunk::sm_count();
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  featurize_trunk_kernel<<<static_cast<unsigned>(units.count < sms ? units.count : sms), trunk::THREADS, TRUNK_SMEM,
                           s>>>(args);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long pool_chunks = static_cast<long>(b) * ((n_windows + trunk::WC - 1) / trunk::WC);
  featurize_pool_kernel<<<static_cast<unsigned>((pool_chunks + trunk::GROUP - 1) / trunk::GROUP),
                          trunk::THREADS, POOL_SMEM, s>>>(args);
  return static_cast<int>(cudaGetLastError());
}
