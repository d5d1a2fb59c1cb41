// The embedding body shared by K2 (embedding_pool.cu) and K4 (featurize.cu):
// patch trunk -> banded 4-head window pooling -> 96-d head, on Hopper's
// warpgroup products (wgmma) fed by TMA through mbarrier rings (hopper.cuh).
//
//   feats = bf16(rms(x) @ Wp + bp)                        x: float32 patch row
//   2x: h = bf16(gelu(rms(feats) @ Wup + bup))            exact erff
//       feats = bf16(feats + bf16(h @ Wdown + bdown))     the add rounds to bf16
//   a = feats @ Q (192 -> 4 heads)
//   per window w, head h, k < 19 (patch p0(w) + k):
//       e = exp_c[k, h] * exp(a[p, h] - max_p a[., h]);  wgt = bf16(e / (sum_k e + 1e-30))
//       pooled[w, h, :] = sum_k wgt feats[p, :] + sum_k wgt pos_bf16[k, :]
//   norm = bf16(grouped centred RMS over the window's 4 x 192 values)
//   out = norm @ Whead + bhead                            float32
//
// Numerics follow the TPU kernel's rounding points: bf16 operands, float32
// accumulation, RMS (eps 1e-6), softmax and pooling sums in float32, the
// softmax weights rounded to bf16 after normalisation, the positional code in
// bf16. Every product is of bf16 values with float32 sums: patch_proj
// 128->192, up 192->384 and down 384->192 and the head 768->96 as
// wgmma.mma_async m64nNk16, the two pooling sums (one chain: positional code,
// then patches) as mma.sync m16n8k16. A product of two bf16 values is exact
// in float32, so only the order of the sums differs from a float32 FMA chain.
// Every product walks its k axis in 16-wide steps from 0 up with the same
// instruction shape, whatever the tiling, and every reduction (RMS, scores,
// softmax) runs over one row in one fixed order, so a row's result depends
// only on that row: K2 and K4 give the same bits for the same patches.
//
// Two phases, two kernels a launch, both with blocks of two consumer
// warpgroups and a producer warpgroup (one thread of which issues the TMA
// copies; the register file is split between them by setmaxnreg):
//  - The trunk (`trunk_tile`): chunks of 128 patch rows, which may belong to
//    several clips (K2: the batch's rows flat across clips; K4: whole clips),
//    a warpgroup a tile of 64; one persistent block an SM walks the chunks.
//    The chunk's input rows sit in a shared-memory buffer (K2 prefetches
//    them by TMA while the previous chunk runs; K4's mel writes them). The
//    weights (about 0.6 MB in bf16, too large for shared memory) are laid
//    out once on the host as one stream of 6 KB slots in the order a chunk
//    consumes them, each slot one or two k16 operand tiles in wgmma's
//    K-major layout (embedding_kernel.trunk_operands); the producer streams
//    it by TMA bulk copies through a ring of RING slots. Both warpgroups
//    read every slot, so each weight byte leaves L2 once per 128 rows, and a
//    consumer waits on a slot's barrier, never on the block. A product phase
//    (patch_proj, an up pass, a pass's down k-steps) issues all its wgmmas
//    before it waits for them. The RMS rows go to shared memory in the
//    core-matrix layout and feed patch_proj and the up product as A; the up
//    product runs in four passes of 96 hidden columns whose GELU output
//    goes, in registers, straight on as the A fragments of the down
//    product's six k-steps, which accumulate in registers across the
//    passes; the epilogues (bias, erff GELU, the residual add, the next RMS,
//    the scores a = feats @ Q) work on the accumulators, each warp on its
//    own 16 rows. The features (bf16) and scores go to an L2-resident global
//    scratch, since a long clip's windows span all of its patches.
//  - The pooling and head (`pool_group`): four chunks of up to 16 windows
//    (four clips at 1.44 s) a block. Each thread computes the softmax weights
//    of one (window, head) row; each warp pools two m16 tiles of rows (four
//    windows) against the positional code and the chunk's staged patch
//    features and takes the grouped RMS in registers; the 64 normalised
//    window rows then go through the head as one m64 product, a warpgroup
//    for each 48 of its 96 columns, its weights streamed through a ring of
//    their own. The Pallas selector matmuls (tile_h, gs, sel_h) and the
//    banded (WH, P) weight matrix become indexing by window start.
//
// Build variants for K2's stage costs (tools/kernel_perf_sweep.py), none in
// a production build: -DHB_ABLATE_<STAGE> replaces a stage by the JAX
// kernel's stand-in of the same shape (its _trunk_pool_body's `ablate`;
// embedding_kernel.ABLATIONS), each keeping the data the stand-in reads, and
// where a stand-in reads fewer weights (TRUNK, HEAD_MM, NOOP) the producer
// fills only the slots its consumers take. -DHB_K2_GROUP=<n> pools n < 4
// chunks a block; the consumer warps past them pool nothing. Without these
// defines the preprocessed source is the production one.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "hopper.cuh"
#include "mma_sync.cuh"

namespace trunk {

using bf16 = __nv_bfloat16;

constexpr int PD = 128;     // patch values (4 frames x 32 mel)
constexpr int HID = 192;    // trunk width
constexpr int TH = 384;     // trunk MLP width
constexpr int HEADS = 4;
constexpr int WPAT = 19;    // patches per window
constexpr int EMB = 96;
constexpr int POOLED = HEADS * HID;  // 768 values per window

constexpr int CONSUMERS = 2;                    // warpgroups
constexpr int THREADS = (CONSUMERS + 1) * 128;  // and a producer warpgroup
constexpr int PRODUCER_WARP = CONSUMERS * 4;    // its first warp; one thread of it loads
// The register file split unevenly (setmaxnreg): a block compiles to 168
// registers a thread (65536 over 384 threads), the producer warpgroup gives
// back all but PRODUCER_REGS and the consumers take CONSUMER_REGS, enough to
// keep the wgmma accumulators in registers without serialising the products.
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
static_assert(PRODUCER_REGS * 128 + CONSUMER_REGS * CONSUMERS * 128 <= 65536, "the register file");
constexpr int TILE = 64;                        // rows of a warpgroup: one m64 product
constexpr int CHUNK = CONSUMERS * TILE;         // rows of a trunk chunk

// The operand streams, in slots of SLOT bytes. An operand tile is k16 x N
// bf16 in the K-major layout (hopper.cuh, lbo 128, sbo 256).
constexpr int SLOT = 6144;
constexpr int UP_N = 96;                        // hidden columns of an up pass
constexpr int UP_PASSES = TH / UP_N;            // 4
constexpr int DN_K = UP_N / 16;                 // down k-steps of a pass: 6
constexpr int T_HID = 16 * HID * 2;             // a k16 x n192 tile, bytes
constexpr int T_UP = 16 * UP_N * 2;             // k16 x n96
constexpr int T_EMB = 16 * EMB * 2;             // k16 x n96 (the head)
constexpr int HID_KS = SLOT / T_HID;            // k-steps a slot: 1 of patch_proj or down
constexpr int UP_KS = SLOT / T_UP;              // 2 of an up pass
constexpr int EMB_KS = SLOT / T_EMB;            // 2 of the head
constexpr int PROJ_SLOTS = PD / 16 / HID_KS;    // 8
constexpr int UP_SLOTS = HID / 16 / UP_KS;      // 6 a pass
constexpr int DN_SLOTS = DN_K / HID_KS;         // 6 a pass
constexpr int BLOCK_SLOTS = UP_PASSES * (UP_SLOTS + DN_SLOTS);  // 48 a trunk block
constexpr int HEAD_SLOTS = POOLED / 16 / EMB_KS;                // 24
// the streams sit in the weight buffers behind wp (128 x 192 bf16) and wh
// (768 x 96 bf16) (embedding_kernel.trunk_ops_bytes, HEAD_OPS_BYTES)
constexpr int WP_BYTES = PD * HID * 2;
constexpr int WH_BYTES = POOLED * EMB * 2;
constexpr uint32_t CORE_K_BYTES = 128;  // next core matrix along k
constexpr uint32_t CORE_N_BYTES = 256;  // next along n, in an operand tile

static_assert(HID_KS * T_HID == SLOT && UP_KS * T_UP == SLOT && EMB_KS * T_EMB == SLOT &&
                  PD / 16 % HID_KS == 0 && HID / 16 % UP_KS == 0 && DN_K % HID_KS == 0,
              "every product's tiles fill whole slots");
static_assert(TH % UP_N == 0 && UP_N % 16 == 0, "up passes of whole k-steps of the down product");
// The trunk's ring. Both warpgroups read every slot and a product phase
// (patch_proj, an up pass, a pass's down k-steps) issues all of its slots
// before it waits: a warpgroup holds at most one phase's slots while the
// other may still hold the previous phase's.
constexpr int RING = 10;
static_assert(RING >= PROJ_SLOTS + 2 && RING >= UP_SLOTS + 2 && RING >= DN_SLOTS + 2,
              "a product phase's slots fit in the ring beside the other warpgroup's");

// feats rows, bf16: a stride of 400 B keeps accumulator-pair accesses conflict-free
constexpr int LDF = HID + 8;
// input patch rows, float32: a stride of 528 B keeps the RMS's float4 reads
// (16 rows, two lanes a row) conflict-free
constexpr int LDP = PD + 4;

// Element (r, c) of an A operand of K columns in the core-matrix layout:
// 8 x 8 blocks of 128 bytes, next along k 128 B apart, next along m K * 16 B.
template <int K>
__device__ __forceinline__ int a_index(int r, int c) {
  return (r >> 3) * (K * 8) + (c >> 3) * 64 + (r & 7) * 8 + (c & 7);
}

// descriptor of k-step `ks` of a 64-row A operand of K columns at `a`
template <int K>
__device__ __forceinline__ uint64_t a_desc(const bf16* a, int ks) {
  return hopper::kmajor_desc(a + ks * 128, CORE_K_BYTES, K * 16);
}

__device__ __forceinline__ uint64_t b_desc(const unsigned char* tile) {
  return hopper::kmajor_desc(tile, CORE_K_BYTES, CORE_N_BYTES);
}

// shared memory of the trunk phase, bytes from a 1024-byte-aligned base
struct TrunkSmem {
  static constexpr int FEATS = RING * SLOT;                    // CHUNK x LDF bf16
  static constexpr int XN = FEATS + CHUNK * LDF * 2;           // CHUNK x HID bf16, core matrices
  static constexpr int WORK_END = XN + CHUNK * HID * 2;
  static constexpr int PATCH = WORK_END;                       // CHUNK x LDP float32: the input rows
  static constexpr int BARS = PATCH + CHUNK * LDP * 4;         // full[RING], empty[RING], patch full, empty
  static constexpr int BYTES = BARS + (2 * RING + 2) * 8;
};

// The frozen net's weights in the kernels' types, and the pooling constants.
struct Weights {
  const bf16* wp;         // (128, 192), the trunk's operand stream behind it
  const float* bp;        // (192)
  const float* upb;       // (nb, 384)
  const float* dnb;       // (nb, 192)
  const bf16* q;          // (192, 4)
  const bf16* wh;         // (768, 96), the head's operand stream behind it
  const float* bh;        // (96)
  const float* expc;      // (19, 4) exp(pos @ Q - max)
  const bf16* pos;        // (19, 192)
  const int* p0;          // (W) first patch of each window
  int n_blocks;
  __device__ const unsigned char* trunk_ops() const {
    return reinterpret_cast<const unsigned char*>(wp) + WP_BYTES;
  }
  __device__ const unsigned char* head_ops() const {
    return reinterpret_cast<const unsigned char*>(wh) + WH_BYTES;
  }
};

// the card's SMs: the persistent kernels' grid
inline int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      count = 1;
  }
  return count;
}

// the dynamic shared memory from its first 1024-byte boundary
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + ((1024 - (hopper::smem_addr(raw) & 1023)) & 1023);
}

__device__ __forceinline__ float round_bf16(float v) { return __bfloat162float(__float2bfloat16(v)); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float gelu(float h) {
#ifdef HB_ABLATE_GELU
  return fmaxf(h, 0.0f);  // the `gelu` stand-in: ReLU
#else
  return 0.5f * h * (1.0f + erff(h * 0.70710678118654752f));
#endif
}

// A ring of operand slots filled by a producer thread. Both sides count the
// slots they have passed; slot i lives in ring position i % depth.
struct Ring {
  unsigned char* slots;
  uint64_t* full;   // the slot's bytes have landed (the producer's expect_tx)
  uint64_t* empty;  // every consumer warp is done with it
  int depth;
  int next = 0;      // slots acquired (consumer) or filled (producer)
  int released = 0;  // slots released (consumer)

  // `warps`: the consumer warps that release each slot
  __device__ void init(int warps) {
    for (int i = 0; i < depth; ++i) {
      hopper::mbar_init(full + i, 1);
      hopper::mbar_init(empty + i, warps);
    }
    hopper::mbar_init_fence();
  }
  // producer: the n slots of `src` into the ring, in order
  __device__ void fill(const unsigned char* src, int n) {
    for (int k = 0; k < n; ++k, ++next) {
      const int s = next % depth;
      if (next >= depth) hopper::mbar_wait(empty + s, ((next / depth) - 1) & 1);
      hopper::mbar_expect_tx(full + s, SLOT);
      hopper::bulk_load(slots + s * SLOT, src + static_cast<long>(k) * SLOT, SLOT, full + s);
    }
  }
  // consumer: the next slot, once it has landed
  __device__ const unsigned char* acquire() {
    const int s = next % depth;
    hopper::mbar_wait(full + s, (next / depth) & 1);
    ++next;
    return slots + s * SLOT;
  }
  // consumer, one wgmma group committed a slot: retire all but the newest N
  // groups and release their slots, one arrival a warp
  template <int N>
  __device__ void retire() {
    hopper::wgmma_wait<N>();
    if (released < next - N) {
      __syncwarp();
      const bool leader = (threadIdx.x & 31) == 0;
      for (; released < next - N; ++released)
        if (leader) hopper::mbar_arrive(empty + released % depth);
    }
  }
};

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.0f;
}

// Centred RMS (eps 1e-6) of this thread's two rows of a 64 x N accumulator
// (values v[4 j + 2 h + e], row 8 h + g of the warp's 16, column 8 j + 2 q +
// e), each row's sums over its four q threads; out(h, j, lo, hi) takes the
// normalised pair of columns 8 j + 2 q, + 1 of row 8 h + g.
template <int N, typename Out>
__device__ __forceinline__ void rms_pairs(const float (&v)[N / 2], Out out) {
#ifdef HB_ABLATE_TRUNK_RMS
  // the `trunk_rms` stand-in: a block's up product reads the features as they are
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) out(h, j, v[4 * j + 2 * h], v[4 * j + 2 * h + 1]);
#else
  float mean[2];
  float scale[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) s += v[4 * j + 2 * h] + v[4 * j + 2 * h + 1];
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    mean[h] = s / N;
    float ss = 0.0f;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const float c0 = v[4 * j + 2 * h] - mean[h];
      const float c1 = v[4 * j + 2 * h + 1] - mean[h];
      ss += c0 * c0 + c1 * c1;
    }
    ss += __shfl_xor_sync(0xffffffffu, ss, 1);
    ss += __shfl_xor_sync(0xffffffffu, ss, 2);
    scale[h] = 1.0f / sqrtf(ss / N + 1e-6f);
  }
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      out(h, j, (v[4 * j + 2 * h] - mean[h]) * scale[h], (v[4 * j + 2 * h + 1] - mean[h]) * scale[h]);
#endif
}

// The trunk of one warpgroup's tile of 64 rows, `rows` of them real (the
// rest computed on zeros and dropped): load(r, c) gives values c .. c + 3 of
// tile row r (c % 4 == 0), read once, after which input_read() is called;
// tile row r goes to scratch row row_out(r): its features (bf16) to feats_g, its scores to
// scores_g. feats_s is the tile's 64 x LDF rows, xn_s its 64 x 192 A operand;
// `ring` streams the trunk's operand slots. Every wgmma group is retired on
// return.
template <typename Load, typename InputRead, typename RowOut>
__device__ __forceinline__ void trunk_tile(const Weights& net, Ring& ring, int wg,
                                           bf16* feats_s, bf16* xn_s, int rows, Load load,
                                           InputRead input_read, RowOut row_out,
                                           bf16* __restrict__ feats_g, float* __restrict__ scores_g) {
  const int lane = threadIdx.x & 31;
  const int wi = (threadIdx.x >> 5) & 3;  // warp of the warpgroup: rows 16 wi ..
  const int g = lane >> 2;
  const int q = lane & 3;
  const int ra = 16 * wi + g;  // this thread's accumulator rows: ra, ra + 8

#ifdef HB_ABLATE_NOOP
  // the `noop` stand-in, the streaming floor: every input value read and
  // summed, 0 x each row's sum kept as its first score, which the pooling
  // kernel adds to b_head; no weights, no products
  {
    constexpr int HALF = PD / 2;
    const int r = 16 * wi + (lane & 15);
    const int c0 = HALF * (lane >> 4);
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < HALF / 4; ++i) {
      const float4 v = r < rows ? load(r, c0 + 4 * i) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      s += (v.x + v.y) + (v.z + v.w);
    }
    input_read();
    s += __shfl_xor_sync(0xffffffffu, s, 16);
    if (lane < 16 && r < rows) scores_g[static_cast<size_t>(row_out(r)) * HEADS] = 0.0f * s;
  }
#else
  // xn (the A operand) is rewritten only after every warp's products that
  // read it are retired, and published to wgmma before the next product
  auto publish = [&](auto write) {
    hopper::wg_sync(wg);
    write();
    hopper::fence_async_shared();
    hopper::wg_sync(wg);
  };
  // one product phase: SLOTS ring slots of KS k-steps each, issue(slot, k,
  // kk) for k-step k of the phase, the slot's kk-th; its groups all retired
  // on return
  auto phase = [&](auto slots, auto ks, auto issue) {
    constexpr int SLOTS = decltype(slots)::value;
    constexpr int KS = decltype(ks)::value;
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      const unsigned char* slot = ring.acquire();
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) issue(slot, KS * s + kk, kk);
      hopper::wgmma_commit();
    }
    ring.retire<0>();
  };

  // centred RMS of the input rows: lane l takes half l / 16 (64 values) of
  // row l % 16 of its warp's 16, every value loaded first (a row past `rows`
  // is zeros, and so is its RMS); the halves' sums meet by one shuffle
  publish([&] {
    constexpr int HALF = PD / 2;
    const int r = 16 * wi + (lane & 15);
    const int c0 = HALF * (lane >> 4);
    float4 v[HALF / 4];
#pragma unroll
    for (int i = 0; i < HALF / 4; ++i) v[i] = r < rows ? load(r, c0 + 4 * i) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    input_read();
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < HALF / 4; ++i) s += (v[i].x + v[i].y) + (v[i].z + v[i].w);
    const float mean = (s + __shfl_xor_sync(0xffffffffu, s, 16)) / PD;
    float ss = 0.0f;
#pragma unroll
    for (int i = 0; i < HALF / 4; ++i) {
      v[i] = make_float4(v[i].x - mean, v[i].y - mean, v[i].z - mean, v[i].w - mean);
      ss += (v[i].x * v[i].x + v[i].y * v[i].y) + (v[i].z * v[i].z + v[i].w * v[i].w);
    }
    const float scale = 1.0f / sqrtf((ss + __shfl_xor_sync(0xffffffffu, ss, 16)) / PD + 1e-6f);
#pragma unroll
    for (int i = 0; i < HALF / 4; ++i)
      *reinterpret_cast<uint2*>(xn_s + a_index<PD>(r, c0 + 4 * i)) =
          make_uint2(pack_bf16(v[i].x * scale, v[i].y * scale), pack_bf16(v[i].z * scale, v[i].w * scale));
  });

  // feats = bf16(xn @ Wp + bp); xn = rms(feats)
  float acc[HID / 2];
  zero(acc);
  phase(std::integral_constant<int, PROJ_SLOTS>{}, std::integral_constant<int, HID_KS>{}, [&](const unsigned char* slot, int k, int kk) {
    hopper::wgmma_ss192(acc, a_desc<PD>(xn_s, k), b_desc(slot + kk * T_HID), 1);
  });
#pragma unroll
  for (int j = 0; j < HID / 8; ++j) {
    const int c = 8 * j + 2 * q;
    const float b0 = __ldg(net.bp + c);
    const float b1 = __ldg(net.bp + c + 1);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      acc[4 * j + 2 * h] = round_bf16(acc[4 * j + 2 * h] + b0);
      acc[4 * j + 2 * h + 1] = round_bf16(acc[4 * j + 2 * h + 1] + b1);
      *reinterpret_cast<uint32_t*>(feats_s + (ra + 8 * h) * LDF + c) =
          pack_bf16(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
  auto to_xn = [&](int h, int j, float lo, float hi) {
    *reinterpret_cast<uint32_t*>(xn_s + a_index<HID>(ra + 8 * h, 8 * j + 2 * q)) = pack_bf16(lo, hi);
  };
#ifndef HB_ABLATE_TRUNK  // the `trunk` stand-in: no residual block
  publish([&] { rms_pairs<HID>(acc, to_xn); });

  for (int blk = 0; blk < net.n_blocks; ++blk) {
    const float* upb = net.upb + blk * TH;
    const float* dnb = net.dnb + blk * HID;
    zero(acc);  // the down product's sums, over the four passes
#pragma unroll 1
    for (int p = 0; p < UP_PASSES; ++p) {
      float up[UP_N / 2];
      zero(up);
      phase(std::integral_constant<int, UP_SLOTS>{}, std::integral_constant<int, UP_KS>{}, [&](const unsigned char* slot, int k, int kk) {
        hopper::wgmma_ss96(up, a_desc<HID>(xn_s, k), b_desc(slot + kk * T_UP), 1);
      });
      // h = bf16(gelu(up + bup)) as the down product's A fragments: k-step s
      // of this pass is hidden columns 16 s .. 16 s + 15, accumulator tiles
      // 2 s (a0: row ra, a1: row ra + 8) and 2 s + 1 (a2, a3)
      uint32_t ha[DN_K][4];
#pragma unroll
      for (int j = 0; j < UP_N / 8; ++j) {
        const int c = UP_N * p + 8 * j + 2 * q;
        const float b0 = __ldg(upb + c);
        const float b1 = __ldg(upb + c + 1);
#pragma unroll
        for (int h = 0; h < 2; ++h)
          ha[j / 2][2 * (j % 2) + h] = pack_bf16(gelu(up[4 * j + 2 * h] + b0), gelu(up[4 * j + 2 * h + 1] + b1));
      }
      phase(std::integral_constant<int, DN_SLOTS>{}, std::integral_constant<int, HID_KS>{}, [&](const unsigned char* slot, int k, int kk) {
        hopper::wgmma_rs192(acc, ha[k], b_desc(slot + kk * T_HID), 1);
      });
    }
    // feats = bf16(feats + bf16(down + bdown)), kept in acc
#pragma unroll
    for (int j = 0; j < HID / 8; ++j) {
      const int c = 8 * j + 2 * q;
      const float b0 = __ldg(dnb + c);
      const float b1 = __ldg(dnb + c + 1);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t* f = reinterpret_cast<uint32_t*>(feats_s + (ra + 8 * h) * LDF + c);
        const __nv_bfloat162 old = *reinterpret_cast<const __nv_bfloat162*>(f);
        acc[4 * j + 2 * h] = round_bf16(__low2float(old) + round_bf16(acc[4 * j + 2 * h] + b0));
        acc[4 * j + 2 * h + 1] = round_bf16(__high2float(old) + round_bf16(acc[4 * j + 2 * h + 1] + b1));
        *f = pack_bf16(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
    if (blk + 1 < net.n_blocks) publish([&] { rms_pairs<HID>(acc, to_xn); });
  }
#endif

#ifndef HB_ABLATE_SOFTMAX  // the `softmax` stand-in reads no scores
  // scores a = feats @ Q: each thread's 48 columns of its two rows, then the
  // four threads of a row; the features of the warp's rows to the scratch
  float a[2][HEADS];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int k = 0; k < HEADS; ++k) a[h][k] = 0.0f;
#pragma unroll
  for (int j = 0; j < HID / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const uint2 qv = __ldg(reinterpret_cast<const uint2*>(net.q) + 8 * j + 2 * q + e);
      const __nv_bfloat162 q01 = *reinterpret_cast<const __nv_bfloat162*>(&qv.x);
      const __nv_bfloat162 q23 = *reinterpret_cast<const __nv_bfloat162*>(&qv.y);
      const float qh[HEADS] = {__low2float(q01), __high2float(q01), __low2float(q23), __high2float(q23)};
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int k = 0; k < HEADS; ++k) a[h][k] = fmaf(acc[4 * j + 2 * h + e], qh[k], a[h][k]);
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int k = 0; k < HEADS; ++k) {
      a[h][k] += __shfl_xor_sync(0xffffffffu, a[h][k], 1);
      a[h][k] += __shfl_xor_sync(0xffffffffu, a[h][k], 2);
    }
    const int r = ra + 8 * h;
    if (q == 0 && r < rows)
      *reinterpret_cast<float4*>(scores_g + static_cast<size_t>(row_out(r)) * HEADS) =
          make_float4(a[h][0], a[h][1], a[h][2], a[h][3]);
  }
#endif
  __syncwarp();
  constexpr int ROW_PIECES = HID / 8;  // 16-byte pieces of a feature row
  for (int i = lane; i < 16 * ROW_PIECES; i += 32) {
    const int r = 16 * wi + i / ROW_PIECES;
    const int c = (i % ROW_PIECES) * 8;
    if (r < rows)
      *reinterpret_cast<uint4*>(feats_g + static_cast<size_t>(row_out(r)) * HID + c) =
          *reinterpret_cast<const uint4*>(feats_s + r * LDF + c);
  }
#endif
}

// ---- the pooling and head phase -------------------------------------------------------------

constexpr int WC = 16;            // windows of a pooling chunk
#ifndef HB_K2_GROUP
#define HB_K2_GROUP 4
#endif
constexpr int GROUP = HB_K2_GROUP;  // chunks of a block: 64 head rows
constexpr int WH = WC * HEADS;    // (window, head) rows of a chunk: 64, four m16 tiles
constexpr int KPOS = 32;          // the positional code's k, 19 padded
constexpr int PSPAN = 48;         // patches of a chunk staged at once
constexpr int LDA_POS = KPOS + 8;
constexpr int LDA_PAT = PSPAN + 8;
constexpr int HEAD_RING = 8;
#ifdef HB_ABLATE_HEAD_MM
constexpr int HEAD_MM_SLOTS = HID / 16 / EMB_KS;  // the `head_mm` stand-in's product: w_head[:192]
#endif
constexpr int POOL_BAR = 3;       // the consumers' named barrier (1, 2: the warpgroups')

// shared memory of the pooling phase, bytes from a 1024-byte-aligned base
constexpr int S_RING = 0;                                       // HEAD_RING x SLOT
constexpr int S_POS = S_RING + HEAD_RING * SLOT;                // KPOS x LDF bf16
constexpr int S_APOS = S_POS + KPOS * LDF * 2;                  // GROUP WH x LDA_POS bf16
#if HB_K2_GROUP < 4
// Fewer chunks a block: the A tiles keep a row a consumer thread (those of the
// slots past the block's chunks zero) and the head's A its 64 rows.
constexpr int S_APAT = S_APOS + CONSUMERS * 128 * LDA_POS * 2;
constexpr int S_FEATS = S_APAT + CONSUMERS * 128 * LDA_PAT * 2;
constexpr int S_HEADA = S_APAT;
constexpr int S_POOL_END = S_FEATS + GROUP * PSPAN * LDF * 2;
constexpr int S_HMAX = S_HEADA + TILE * POOLED * 2 > S_POOL_END ? S_HEADA + TILE * POOLED * 2 : S_POOL_END;
#else
constexpr int S_APAT = S_APOS + GROUP * WH * LDA_POS * 2;       // GROUP WH x LDA_PAT bf16
constexpr int S_FEATS = S_APAT + GROUP * WH * LDA_PAT * 2;      // GROUP x PSPAN x LDF bf16
constexpr int S_HEADA = S_APAT;  // then the head's A: 64 x 768 bf16 core matrices, over both
constexpr int S_HMAX = S_FEATS + GROUP * PSPAN * LDF * 2;       // GROUP x HEADS float
#endif
constexpr int S_SPAN = S_HMAX + GROUP * HEADS * 4;              // GROUP x (first, end) patch
constexpr int S_BARS = S_SPAN + GROUP * 2 * 4;                  // full[HEAD_RING], empty[...]
constexpr int POOL_SMEM_BYTES = S_BARS + 2 * HEAD_RING * 8;
static_assert(S_HEADA + TILE * POOLED * 2 <= S_HMAX, "the head's A fits over the pooling tiles");
#if HB_K2_GROUP < 4
static_assert(GROUP >= 1, "a block pools at least one chunk");
#else
static_assert(GROUP * WH == CONSUMERS * 128 && GROUP * WC == TILE, "a thread a (window, head) row");
#endif
static_assert(WPAT <= KPOS && PSPAN % 16 == 0 && S_BARS % 8 == 0, "pooling tiles");

// Pooling chunks of the batch: clip c's windows w0 .. w0 + 15, w0 = 16 k.
struct PoolChunk {
  int clip;
  int w0;
  int nw;  // windows of the chunk, 0 past the batch
  __device__ PoolChunk(int index, int b, int n_windows) {
    const int per_clip = (n_windows + WC - 1) / WC;
#if HB_K2_GROUP < 4
    // a slot past the block's GROUP chunks holds none: a chunk past the batch
    if (index >= (static_cast<int>(blockIdx.x) + 1) * GROUP) index = b * per_clip;
#endif
    clip = index / per_clip;
    w0 = (index - clip * per_clip) * WC;
    nw = clip < b ? min(WC, n_windows - w0) : 0;
  }
};

__device__ __forceinline__ void pool_sync() { hopper::bar_sync(POOL_BAR, CONSUMERS * 128); }

// Pooling chunks GROUP blockIdx.x .. + GROUP - 1 of a batch of b clips whose
// trunk rows 0 .. num_patches - 1 (of p_pad a clip) are in the scratch ->
// their rows of out (b, n_windows, 96). `smem` holds POOL_SMEM_BYTES; the
// block has THREADS threads.
__device__ __forceinline__ void pool_group(const Weights& net, const bf16* __restrict__ feats_g,
                                           const float* __restrict__ scores_g, float* __restrict__ out,
                                           int b, int p_pad, int num_patches, int n_windows,
                                           unsigned char* smem) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  Ring ring{smem + S_RING, reinterpret_cast<uint64_t*>(smem + S_BARS),
            reinterpret_cast<uint64_t*>(smem + S_BARS) + HEAD_RING, HEAD_RING};
  if (tid == 0) ring.init(CONSUMERS * 4);
  __syncthreads();
  if (warp >= PRODUCER_WARP) {
    hopper::setmaxnreg_dec<PRODUCER_REGS>();
#if defined(HB_ABLATE_HEAD_MM) && !defined(HB_ABLATE_NOOP)
    if (warp == PRODUCER_WARP && lane == 0) ring.fill(net.head_ops(), HEAD_MM_SLOTS);
#elif !defined(HB_ABLATE_NOOP)
    if (warp == PRODUCER_WARP && lane == 0) ring.fill(net.head_ops(), HEAD_SLOTS);  // in flight during the pooling
#endif
    return;
  }
  hopper::setmaxnreg_inc<CONSUMER_REGS>();
#ifdef HB_ABLATE_NOOP
  // the `noop` stand-in: b_head + the clip's first score, 0 x its first input row's sum
  for (int i = tid; i < GROUP * WC * EMB; i += CONSUMERS * 128) {
    const PoolChunk ch(blockIdx.x * GROUP + i / (WC * EMB), b, n_windows);
    const int wr = (i / EMB) % WC;
    if (wr < ch.nw)
      out[(static_cast<size_t>(ch.clip) * n_windows + ch.w0 + wr) * EMB + i % EMB] =
          __ldg(net.bh + i % EMB) + scores_g[static_cast<size_t>(ch.clip) * p_pad * HEADS];
  }
#else

  bf16* pos_s = reinterpret_cast<bf16*>(smem + S_POS);
  bf16* apos_s = reinterpret_cast<bf16*>(smem + S_APOS);
  bf16* apat_s = reinterpret_cast<bf16*>(smem + S_APAT);
  bf16* fpat_s = reinterpret_cast<bf16*>(smem + S_FEATS);
  bf16* heada_s = reinterpret_cast<bf16*>(smem + S_HEADA);
  float* hmax_s = reinterpret_cast<float*>(smem + S_HMAX);
  int* span_s = reinterpret_cast<int*>(smem + S_SPAN);
  const bf16 zero16 = __float2bfloat16(0.0f);
  const int first = blockIdx.x * GROUP;

  // the positional code, zero past its 19 rows; each chunk's head maxima
  // over its clip's patches and the span of patches its windows cover
  for (int i = tid; i < KPOS * HID / 8; i += CONSUMERS * 128) {
    const int k = i / (HID / 8);
    const int c = (i % (HID / 8)) * 8;
    *reinterpret_cast<uint4*>(pos_s + k * LDF + c) =
        k < WPAT ? *reinterpret_cast<const uint4*>(net.pos + k * HID + c) : make_uint4(0, 0, 0, 0);
  }
  if (warp < GROUP) {
    const PoolChunk ch(first + warp, b, n_windows);
#ifndef HB_ABLATE_SOFTMAX
    const float* sc = scores_g + static_cast<size_t>(ch.clip) * p_pad * HEADS;
    float m = -3.0e38f;
    if (ch.nw > 0)
      for (int p = lane / HEADS; p < num_patches; p += 32 / HEADS) m = fmaxf(m, sc[p * HEADS + lane % HEADS]);
#pragma unroll
    for (int off = 16; off >= HEADS; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (lane < HEADS) hmax_s[warp * HEADS + lane] = m;
#endif
    int lo = 1 << 30;
    int hi = 0;
    if (lane < ch.nw) {
      lo = net.p0[ch.w0 + lane];
      hi = lo + WPAT;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
    }
    if (lane == 0) {
      span_s[2 * warp] = ch.nw > 0 ? lo : 0;
      span_s[2 * warp + 1] = hi;
    }
  }
  pool_sync();

  // the softmax weights of this thread's (window, head) row: chunk tid / 64,
  // row w * 4 + h of it
  const int ci = tid / WH;
  const int w = (tid % WH) / HEADS;
  const int h = tid % HEADS;
  const PoolChunk mine(first + ci, b, n_windows);
  const bool live = w < mine.nw;
  const int p0 = live ? net.p0[mine.w0 + w] : 0;
  float wgt[WPAT];
#ifdef HB_ABLATE_SOFTMAX
  // the `softmax` stand-in: the static band, exp(pos @ Q - max) in bf16
#pragma unroll
  for (int k = 0; k < WPAT; ++k) wgt[k] = live ? round_bf16(__ldg(net.expc + k * HEADS + h)) : 0.0f;
#else
  {
    const float* sc = scores_g + (static_cast<size_t>(mine.clip) * p_pad + p0) * HEADS + h;
    float denom = 0.0f;
#pragma unroll
    for (int k = 0; k < WPAT; ++k) {
      wgt[k] = live ? __ldg(net.expc + k * HEADS + h) * expf(sc[k * HEADS] - hmax_s[ci * HEADS + h]) : 0.0f;
      denom += wgt[k];
    }
#pragma unroll
    for (int k = 0; k < WPAT; ++k) wgt[k] = round_bf16(wgt[k] / (denom + 1e-30f));
  }
#endif
#if !defined(HB_ABLATE_POSP) && !defined(HB_ABLATE_POOL_MM)
#pragma unroll
  for (int k = 0; k < KPOS; ++k) apos_s[tid * LDA_POS + k] = k < WPAT ? __float2bfloat16(wgt[k]) : zero16;
#endif
#ifdef HB_ABLATE_POOL_MM
  {
    // the row's weight sum, where the pooling tiles would be
    float sum = 0.0f;
#pragma unroll
    for (int k = 0; k < WPAT; ++k) sum += wgt[k];
    reinterpret_cast<float*>(smem + S_APAT)[tid] = sum;
  }
#endif

  int n_sub = 0;  // spans of PSPAN patches the widest chunk needs
#pragma unroll
  for (int i = 0; i < GROUP; ++i) n_sub = max(n_sub, (span_s[2 * i + 1] - span_s[2 * i] + PSPAN - 1) / PSPAN);
  // this thread's A row and the chunks' feature rows for patches
  // first + PSPAN sub .. of each chunk's span
  auto stage = [&](int sub) {
    bf16* row = apat_s + tid * LDA_PAT;
    for (int j = 0; j < PSPAN; ++j) row[j] = zero16;
    const int off = p0 - span_s[2 * ci] - PSPAN * sub;  // column of k = 0
#pragma unroll
    for (int k = 0; k < WPAT; ++k)
      if (live && off + k >= 0 && off + k < PSPAN) row[off + k] = __float2bfloat16(wgt[k]);
    constexpr int ROW_PIECES = HID / 8;
    for (int i = tid; i < GROUP * PSPAN * ROW_PIECES; i += CONSUMERS * 128) {
      const int cj = i / (PSPAN * ROW_PIECES);
      const int r = (i / ROW_PIECES) % PSPAN;
      const int c = (i % ROW_PIECES) * 8;
      const PoolChunk ch(first + cj, b, n_windows);
      const int p = span_s[2 * cj] + PSPAN * sub + r;
      bf16* dst = fpat_s + (cj * PSPAN + r) * LDF + c;
      if (ch.nw > 0 && p < span_s[2 * cj + 1] && p < num_patches)
        mma::cp_async16(dst, feats_g + (static_cast<size_t>(ch.clip) * p_pad + p) * HID + c);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
    mma::cp_async_commit();
    mma::cp_async_wait<0>();
  };
#ifndef HB_ABLATE_POOL_MM
  if (n_sub == 1) stage(0);
#endif
  pool_sync();

  // pooled rows of two m16 tiles (four windows each) of chunk warp / 2: the
  // positional code's two k-steps, then the patches' three a span; then
  // the grouped RMS of each window (its 16 (window, head) values of a
  // column pair lie in lanes that differ in bits 0-3)
  const int pc = warp / 2;
  uint32_t nrm[2][HID / 8][2];
#pragma unroll
  for (int tt = 0; tt < 2; ++tt) {
    const int row0 = pc * WH + 16 * (2 * (warp % 2) + tt);
    float pacc[1][HID / 8][4];
#ifdef HB_ABLATE_POOL_MM
    {
      // the `pool_mm` stand-in: row (w, h) is the clip's first patch's
      // features plus the row's weight sum
      const PoolChunk ch(first + pc, b, n_windows);
      const bf16* f0 = feats_g + static_cast<size_t>(ch.clip) * p_pad * HID;
      const float* wsum = reinterpret_cast<const float*>(smem + S_APAT);
      const int g = lane >> 2;
      const int q = lane & 3;
#pragma unroll
      for (int j = 0; j < HID / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          pacc[0][j][e] = ch.nw > 0 ? __bfloat162float(f0[8 * j + 2 * q + (e & 1)]) + wsum[row0 + g + 8 * (e >> 1)]
                                    : 0.0f;
    }
#else
    mma::zero(pacc);
#ifndef HB_ABLATE_POSP  // the `posp` stand-in: no positional product
#pragma unroll
    for (int k0 = 0; k0 < KPOS; k0 += 16)
#if HB_K2_GROUP < 4
      if (pc < GROUP)  // a warp past the block's chunks pools nothing
#endif
      mma::mma_k16<1, HID / 8>(apos_s + k0, LDA_POS, row0, 16, 1, pos_s + k0 * LDF, LDF, 0, pacc);
#endif
    for (int sub = 0; sub < n_sub; ++sub) {
      if (n_sub > 1) {
        pool_sync();  // the previous span's tiles consumed
        stage(sub);
        pool_sync();
      }
#pragma unroll
      for (int k0 = 0; k0 < PSPAN; k0 += 16)
#if HB_K2_GROUP < 4
        if (pc < GROUP)
#endif
        mma::mma_k16<1, HID / 8>(apat_s + k0, LDA_PAT, row0, 16, 1, fpat_s + (pc * PSPAN + k0) * LDF, LDF, 0,
                                 pacc);
    }
#endif
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
#ifdef HB_ABLATE_POOL_RMS
      // the `pool_rms` stand-in: the pooled rows in bf16, not normalised
#pragma unroll
      for (int j = 0; j < HID / 8; ++j) nrm[tt][j][hr] = pack_bf16(pacc[0][j][2 * hr], pacc[0][j][2 * hr + 1]);
#else
      float s = 0.0f;
#pragma unroll
      for (int j = 0; j < HID / 8; ++j) s += pacc[0][j][2 * hr] + pacc[0][j][2 * hr + 1];
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      const float mean = s / POOLED;
      float ss = 0.0f;
#pragma unroll
      for (int j = 0; j < HID / 8; ++j) {
        const float c0 = pacc[0][j][2 * hr] - mean;
        const float c1 = pacc[0][j][2 * hr + 1] - mean;
        ss += c0 * c0 + c1 * c1;
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
      const float scale = 1.0f / sqrtf(ss / POOLED + 1e-6f);
#pragma unroll
      for (int j = 0; j < HID / 8; ++j)
        nrm[tt][j][hr] = pack_bf16((pacc[0][j][2 * hr] - mean) * scale, (pacc[0][j][2 * hr + 1] - mean) * scale);
#endif
    }
  }
  pool_sync();  // every read of the pooling tiles done: the head's A goes over them
  {
    // row (w, h) = 16 t + g (+ 8) of the chunk -> head row 16 pc + w, columns 192 h ..
    const int g = lane >> 2;
    const int q = lane & 3;
#pragma unroll
    for (int tt = 0; tt < 2; ++tt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int wr = 4 * (2 * (warp % 2) + tt) + 2 * hr + g / HEADS;
#ifdef HB_ABLATE_HEAD_MM
        // the `head_mm` stand-in: output row i of the clip reads its norm
        // row i, (window i / 4, head i % 4), against w_head[:192]
        const int i = HEADS * wr + g % HEADS;
        if (i < WC) {
#pragma unroll
          for (int j = 0; j < HID / 8; ++j)
            *reinterpret_cast<uint32_t*>(heada_s + a_index<HID>(WC * pc + i, 8 * j + 2 * q)) = nrm[tt][j][hr];
        }
#else
#pragma unroll
        for (int j = 0; j < HID / 8; ++j)
          *reinterpret_cast<uint32_t*>(heada_s + a_index<POOLED>(WC * pc + wr, (g % HEADS) * HID + 8 * j + 2 * q)) =
              nrm[tt][j][hr];
#endif
      }
  }
  hopper::fence_async_shared();
  pool_sync();

  // out = norm @ Whead + bhead: warpgroup wg takes columns 48 wg .. + 47 of
  // the 64 rows; its warp wi holds chunk wi's windows
  const int wg = warp / 4;
  float hacc[EMB / 4];
  zero(hacc);
#ifdef HB_ABLATE_HEAD_MM
#pragma unroll 1
  for (int s = 0; s < HEAD_MM_SLOTS; ++s) {
    const unsigned char* slot = ring.acquire();
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < EMB_KS; ++kk)
      hopper::wgmma_ss48(hacc, a_desc<HID>(heada_s, EMB_KS * s + kk),
                         b_desc(slot + kk * T_EMB + wg * (EMB / 16) * CORE_N_BYTES), 1);
    hopper::wgmma_commit();
    ring.retire<HEAD_RING / 2>();
  }
#else
#pragma unroll 1
  for (int s = 0; s < HEAD_SLOTS; ++s) {
    const unsigned char* slot = ring.acquire();
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < EMB_KS; ++kk)
      hopper::wgmma_ss48(hacc, a_desc<POOLED>(heada_s, EMB_KS * s + kk),
                         b_desc(slot + kk * T_EMB + wg * (EMB / 16) * CORE_N_BYTES), 1);
    hopper::wgmma_commit();
    ring.retire<HEAD_RING / 2>();  // half the ring's slots in flight
  }
#endif
  ring.retire<0>();
  {
    const int wi = warp % 4;
    const int g = lane >> 2;
    const int q = lane & 3;
    const PoolChunk ch(first + wi, b, n_windows);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int wr = g + 8 * hr;
      if (wr >= ch.nw) continue;
      float* o = out + (static_cast<size_t>(ch.clip) * n_windows + ch.w0 + wr) * EMB + (EMB / 2) * wg;
#pragma unroll
      for (int j = 0; j < EMB / 16; ++j) {
        const int c = 8 * j + 2 * q;
        *reinterpret_cast<float2*>(o + c) =
            make_float2(hacc[4 * j + 2 * hr] + __ldg(net.bh + (EMB / 2) * wg + c),
                        hacc[4 * j + 2 * hr + 1] + __ldg(net.bh + (EMB / 2) * wg + c + 1));
      }
    }
  }
#endif
}

}  // namespace trunk
