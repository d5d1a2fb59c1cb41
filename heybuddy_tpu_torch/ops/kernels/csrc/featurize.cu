// One-kernel featurization (K4) for Hopper, sm_90a: audio -> log-mel patches
// -> patch trunk -> banded 4-head window pooling -> 96-d head, one clip per
// block, the log-mel never in device memory.
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
// The kernel runs K1's split direct DFT (fp16 pairs) and K2's trunk and
// pooling (bf16), all as mma.sync. What fusion saves is the patch round trip
// through device memory (20 KB per clip written by K1, read by K2) and one
// launch; what it costs is K2's sharing of each weight tile between clips
// (a block holds one clip, so the trunk weights leave L2 once per clip).
//
// Design: one block of 256 threads per clip. For each trunk chunk of 48 patch
// rows (35 at 1.44 s: three m16 tiles, 1 x 8 warps of 24 columns each), the
// chunk's frames are computed 48 at a time by the mel body into a
// shared-memory patch buffer (48 x 128 float32, 24 KB): the patch layout
// (p, k*32 + m) is the spectrogram's own (4p + k, m) order, so frame f of the
// chunk goes to buffer offset f*32 + m by plain indexing. The trunk then reads
// the buffer in place of K2's patch tensor. The mel scratch (66 KB) and the
// trunk scratch (74 KB) are used at different times and overlap behind the
// patch buffer; the pooling (98 KB) comes last and overlaps all of it, so a
// block takes 98 KB of shared memory and 2 blocks fit on an SM. The features and scores of long clips go to the same
// L2-resident global scratch as K2's. The Pallas kernel's frame->patch
// redistribution matmuls at Precision.HIGHEST, its smaller frame chunk (32)
// and its raised VMEM limit exist for Mosaic's layout rules and have no
// counterpart here.

#include "mel_common.cuh"
#include "trunk_pool.cuh"

namespace {

using trunk::bf16;

constexpr int RC = 48;   // patch rows per trunk chunk: 3 m16 tiles
constexpr int WN = 8;    // 1 x 8 warps: a warp holds 3 m16 tiles x 24 columns
constexpr int PATCH_BYTES = RC * trunk::PD * 4;  // 24576 B
constexpr int WORK_BYTES = static_cast<int>(mel::SMEM_BYTES) > trunk::TrunkSmem<RC>::BYTES
                               ? static_cast<int>(mel::SMEM_BYTES)
                               : trunk::TrunkSmem<RC>::BYTES;
// the pooling comes after the last trunk chunk and takes the patch buffer too
constexpr int SMEM_BYTES = PATCH_BYTES + WORK_BYTES > trunk::POOL_SMEM_BYTES
                               ? PATCH_BYTES + WORK_BYTES
                               : trunk::POOL_SMEM_BYTES;  // 100608 B

static_assert(mel::THREADS == trunk::THREADS, "the mel body and the trunk share the block");
static_assert(trunk::PD == 4 * mel::NMEL, "a patch is 4 frames of mel bins");
static_assert((4 * RC) % mel::FCHUNK == 0, "trunk chunks start on K1's mel chunk boundaries");

struct Args {
  const float* audio;     // (b, t)
  const float* basis;     // (400, 256)
  const float* fb;        // (128, 32)
  float* out;             // (b, W, 96)
  bf16* feats_g;          // (b, P, 192) scratch
  float* scores_g;        // (b, P, 4) scratch
  trunk::Weights net;
  int t;
  int p_pad;
  int num_patches;
  int n_windows;
};

__global__ void __launch_bounds__(trunk::THREADS, 2) featurize_kernel(const Args args) {
  extern __shared__ float4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  float* patch_s = reinterpret_cast<float*>(smem);
  unsigned char* work = smem + PATCH_BYTES;
  __shared__ float red_s[trunk::WARPS * trunk::HEADS];
  __shared__ float hmax_s[trunk::HEADS];

  const int clip = blockIdx.x;
  const int P = args.p_pad;
  const float* audio_clip = args.audio + static_cast<size_t>(clip) * args.t;
  bf16* feats_g = args.feats_g + static_cast<size_t>(clip) * P * trunk::HID;
  float* scores_g = args.scores_g + static_cast<size_t>(clip) * P * trunk::HEADS;

  for (int r0 = 0; r0 < args.num_patches; r0 += RC) {
    const int rows = min(RC, args.num_patches - r0);
    const int fa = 4 * r0;             // first frame of the chunk
    const int fend = 4 * (r0 + rows);  // one past its last
    for (int f0 = fa; f0 < fend; f0 += mel::FCHUNK) {
      mel::logmel_chunk<3>(audio_clip, args.t, f0, fend, fend, args.basis, args.fb, work,
                           [&](int fl, int m, float v) {
                             patch_s[(f0 + fl - fa) * mel::NMEL + m] = v;
                           });
    }
    trunk::trunk_chunk<RC, WN>(
        args.net, [&](int r, int c) { return patch_s[r * trunk::PD + c]; }, rows,
        [&](int r) { return r0 + r; }, feats_g, scores_g, work);
  }
  trunk::pool_head(args.net, feats_g, scores_g,
                   args.out + static_cast<size_t>(clip) * args.n_windows * trunk::EMB,
                   args.num_patches, args.n_windows, smem, red_s, hmax_s);
}

}  // namespace

extern "C" int featurize_smem_bytes() { return SMEM_BYTES; }

extern "C" int featurize_launch(const void* audio, const void* basis, const void* fb, void* out,
                                void* feats_g, void* scores_g, const void* wp, const void* bp,
                                const void* upw, const void* upb, const void* dnw, const void* dnb,
                                const void* q, const void* wh, const void* bh, const void* expc,
                                const void* pos, const void* p0, int b, int t, int p_pad,
                                int num_patches, int n_windows, int n_blocks, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(featurize_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
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
  args.t = t;
  args.p_pad = p_pad;
  args.num_patches = num_patches;
  args.n_windows = n_windows;
  featurize_kernel<<<b, trunk::THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(args);
  return static_cast<int>(cudaGetLastError());
}
