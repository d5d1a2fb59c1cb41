// The bf16-DFT mel body of K1 (mel_patches.cu, `mel_patches_bf16_launch`)
// and K3 (mel_spectrogram.cu, `mel_spectrogram_bf16_launch`), the TPU
// kernels' dft_dtype=bfloat16, on Hopper's warpgroup products, sm_90a.
//
// Per frame f: spectrum = bf16(audio[160 f + 56 .. 160 f + 456)) @ bf16(b)
// (400, 256), b the windowed DFT basis of mel_common.cuh; each product is
// exact in float32, and wgmma sums them in float32, k-steps of 16 taps in
// the order 0 .. 24 (the 16 products of a k-step summed inside the tensor
// core). Then power = re^2 + im^2 and mel_common.cuh's tail, mel_log_store.
// An FFT cannot reproduce the rounding of x and b to bf16, so this body
// keeps the direct DFT.
//
// What bounds it: the function's bytes, as K1's and K3's (mel_patches.cu).
// The method's floor is its products, 400 x 256 a frame (204.8 kFLOP) at
// the tensor cores' bf16 rate, and the tail (power, the band sums, the log)
// at the fp32 rate. The basis in bf16 (200 KB) does not fit in shared memory
// beside the frames, so it streams from L2, once for every item of 128
// frames (the mma.sync body it replaced read it once for every 48). What
// holds it above the floor (PERF.md): the tail, a chain of loads and fmaf
// per band bin, runs on three warps beside the products and takes about as
// long as they do; the products, the basis stream, the staging and the tail
// share the SM's shared-memory bandwidth.
//
// Design: persistent blocks of two consumer warpgroups and a producer
// warpgroup (224 / 56 registers by setmaxnreg), one an SM, walk items of 128
// rows of the padded frame sequence: clip c's frames f = 0 .. usable + 1 at
// row c (usable + 2) + f, the last two of each clip computed and dropped.
// So an item's rows may span clips, and row m of an item reads, for every
// frame, hop rows m, m + 1, m + 2 of the item's staged rows: the hop rows of
// a clip's last frames are its own (the padded frames' rows), never the
// next clip's.
//  - A: an item's 130 hop rows of 160 samples (row P: samples 160 (P %
//    (usable + 2)) + 56 .. + 215 of clip P / (usable + 2), zeros from t on)
//    go to shared memory as bf16 in wgmma's K-major core-matrix layout
//    without swizzle, transposed: the 8 samples c .. c + 7 (c % 8 == 0) of
//    row r at 16-byte unit (c / 8) NR + r. A k-step's 64 x 16 A tile of a
//    warpgroup (rows 64 w + s / 10 .., samples 16 (s % 10) ..) is then 8 x 2
//    core matrices 16 B apart along m and 16 NR apart along k: one
//    descriptor, no im2col, although frames overlap. Consumer threads load
//    the next item's samples in batches while the products run and store
//    them into the other of two buffers.
//  - B: bf16(b) laid out once on the host as 25 k16 x n256 tiles in the
//    same layout, behind the FFT's table in the taps buffer
//    (melspec_kernel.dft_tiles), streamed by the producer's first thread
//    with TMA bulk copies through a ring of RING slots guarded by mbarriers.
//    Both consumer warpgroups read every slot.
//  - The product: wgmma.mma_async m64n256k16, A and B from shared memory,
//    the 128 cos | 128 sin columns in one tile, 25 k-steps issued DEPTH
//    ahead of their retirement. A thread's accumulator holds columns c and
//    c + 128 (j and j + 16), so re^2 + im^2 forms in registers, and the power
//    rows go to shared memory once.
//  - The tail: the producer warpgroup's other three warps run mel_common.cuh's
//    band sums and log on an item's power rows while the consumers multiply
//    the next item (an mbarrier pair hands the rows over and back), a thread
//    four rows and a pair of mel bins at a time, and store each row's pair.
//  - The output's pad rows (frames usable .. n_out - 1 of each clip: K1's)
//    are zeros, written clip by clip across the blocks.
// Invariants: a frame's bits depend on its 400 samples and nothing else:
// every product is the same instruction over the same k order, and the tail
// is local to a row. Not on its item, its row in the tile, the load path or
// the row stride: K3's entry equals K1's layout bit for bit.

#pragma once

#include "hopper.cuh"
#include "mel_fft.cuh"

namespace mel {
namespace dft {

constexpr int CONSUMERS = 2;                      // warpgroups that multiply
constexpr int BLOCK = (CONSUMERS + 1) * 128;      // and a producer warpgroup
constexpr int CTHREADS = CONSUMERS * 128;
// The register file split unevenly (setmaxnreg): a block compiles to 168
// registers a thread (65536 over 384 threads); the producer warpgroup (one
// thread of which issues the copies, its other warps run the tail) keeps
// PRODUCER_REGS, and the consumers take CONSUMER_REGS, room for the 128
// accumulators beside two batches of the next item's samples.
constexpr int PRODUCER_REGS = 56;
constexpr int CONSUMER_REGS = 224;
constexpr int TAIL_WARPS = 3;                     // the producer warpgroup's warps 1 .. 3
constexpr int TAIL_ROWS = 4;                      // frames a tail thread sums at once: rows lane + 32 r
constexpr int PAIR = 2;                           // mel bins a tail thread sums at once
static_assert(PRODUCER_REGS * 128 + CONSUMER_REGS * CTHREADS <= 65536, "the register file");
constexpr int TILE = 64;                          // rows of a warpgroup: one m64 tile
constexpr int ITEM = CONSUMERS * TILE;            // rows of an item
constexpr int KSTEPS = TAPS / 16;                 // 25 k16 steps
constexpr int STEPS_HOP = HOP / 16;               // k-steps a hop row: 10
constexpr int TILE_BYTES = 16 * NCOL * 2;         // one k16 x n256 bf16 operand tile
constexpr int RING = 7;                           // the most slots that fit beside the rows and power
constexpr int DEPTH = 2;                          // k-steps a warpgroup keeps in flight (1 and 4: no faster)
constexpr int HALO = (TAPS - 1) / HOP;            // hop rows past a frame's first: 2
constexpr int ROWS = ITEM + HALO;                 // staged hop rows of an item
constexpr int NR = 137;                           // rows of a staged column block: >= ROWS, 1 mod 8
constexpr int ROW_F4 = HOP / 4;                   // float4s of samples a hop row
constexpr int STAGE_N = (ROWS * ROW_F4 + CTHREADS - 1) / CTHREADS;  // float4s a thread stages: 21
constexpr int BATCH = 7;                          // float4s of a staging batch
constexpr int BATCHES = STAGE_N / BATCH;          // 3, one every BATCH_STEPS k-steps
constexpr int BATCH_STEPS = 6;
constexpr int BATCH_LAG = 12;                     // k-steps between a batch's loads and its stores
// the tiles' place in the taps buffer, in floats: behind the FFT's table
constexpr int DFT_TILES_OFFSET = 257280;
static_assert(DFT_TILES_OFFSET == FFT_TABLE_OFFSET + FFT_TABLE, "the tiles follow the table");
// wgmma descriptor strides: a B tile's core matrices (8 n x 8 k, 128
// contiguous bytes) next along k 128 B apart, next along n 256 B; an A
// tile's next along k one column block (16 NR B) apart, next along m 128 B
constexpr uint32_t CORE_K_BYTES = 128;
constexpr uint32_t CORE_N_BYTES = 256;
constexpr uint32_t A_K_BYTES = 16 * NR;
constexpr uint32_t A_M_BYTES = 128;
constexpr int SYNC_BAR = 3;                       // the consumers' named barrier (1, 2: wg_sync)
// power row stride, floats: odd, so that one bin of 32 consecutive rows lies in 32 banks
constexpr int PLR = NBIN + 9;

// shared memory, bytes from a 128-byte-aligned base
constexpr int XBYTES = (HOP / 8) * NR * 16;       // an item's staged rows
constexpr int S_RING = 0;                         // RING x TILE_BYTES
constexpr int S_X = S_RING + RING * TILE_BYTES;   // 2 x XBYTES: this item's rows and the next's
constexpr int S_POWER = S_X + 2 * XBYTES;         // ITEM x PLR float
constexpr int S_FB = S_POWER + ITEM * PLR * 4;    // FB_FLOATS float
constexpr int S_BAR = S_FB + FB_FLOATS * 4;       // full[RING], empty[RING], power full, power empty
constexpr size_t SMEM_BYTES = S_BAR + (2 * RING + 2) * 8 + 128;  // 232064 B with the alignment slack

static_assert(SMEM_BYTES <= 232448, "at most 227 KB of shared memory a block");
static_assert(TAPS % 16 == 0 && HOP % 16 == 0, "k-steps cover the taps and never cross a hop row");
static_assert(NR >= ROWS && NR % 8 == 1, "a column block holds the rows; its stride staggers the banks");
static_assert(S_X % 128 == 0 && S_POWER % 16 == 0 && S_FB % 16 == 0, "aligned parts");
static_assert(BATCHES * BATCH == STAGE_N && STAGE_N * CTHREADS >= ROWS * ROW_F4, "the batches stage every row");
static_assert(BATCH_STEPS * (BATCHES - 1) + BATCH_LAG < KSTEPS && BATCH_LAG == 2 * BATCH_STEPS,
              "the batches land within an item's k-steps, two register sets in turn");
static_assert(RING >= DEPTH + 2, "the producer keeps a slot ahead of the warpgroups' retired ones");
static_assert(TAIL_ROWS * 32 == ITEM && PLR % 2 == 1, "a tail warp's lanes and rows cover the item");

// float4 k of this consumer thread's share of item i's hop rows: float4 e =
// ctid + CTHREADS k of the rows (row e / ROW_F4) from padded row ITEM i on,
// zeros from sample t on and past the clips; a 16-byte load where the
// clip's samples are 16-byte aligned and t % 4 == 0, else four loads of 4
// bytes
__device__ __forceinline__ float4 stage_load(int item, int k, const float* __restrict__ audio, int b, int t,
                                             long ld, int rows_clip, int ctid) {
  const int e = ctid + CTHREADS * k;
  const int r = e / ROW_F4;
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const int p = item * ITEM + r;
  const int c = p / rows_clip;
  if (r < ROWS && c < b) {
    const float* clip = audio + c * ld;
    const int g = HOP * (p - c * rows_clip) + TAP0 + 4 * (e - r * ROW_F4);
    if (t % 4 == 0 && reinterpret_cast<uintptr_t>(clip) % 16 == 0) {
      if (g < t) v = __ldg(reinterpret_cast<const float4*>(clip + g));
    } else {
      v.x = g < t ? clip[g] : 0.0f;
      v.y = g + 1 < t ? clip[g + 1] : 0.0f;
      v.z = g + 2 < t ? clip[g + 2] : 0.0f;
      v.w = g + 3 < t ? clip[g + 3] : 0.0f;
    }
  }
  return v;
}

// float4 k of stage_load, rounded to bf16, into the staged rows x_s
__device__ __forceinline__ void stage_store(int k, float4 v, int ctid, unsigned char* x_s) {
  const int e = ctid + CTHREADS * k;
  const int r = e / ROW_F4;
  if (r < ROWS) {
    const int col = 4 * (e - r * ROW_F4);
    uint16_t x[4], unused;
    operands<1>(v.x, x[0], unused);
    operands<1>(v.y, x[1], unused);
    operands<1>(v.z, x[2], unused);
    operands<1>(v.w, x[3], unused);
    *reinterpret_cast<uint2*>(x_s + ((col >> 3) * NR + r) * 16 + (col & 7) * 2) =
        make_uint2(pack2(x[0], x[1]), pack2(x[2], x[3]));
  }
}

// one arrival on `bar` from the warp: lane 0's, predicated rather than
// branched (no branch between a warpgroup's wgmma instructions)
__device__ __forceinline__ void arrive_lane0(uint64_t* bar, int lane) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.eq.s32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n"
      "}\n" ::"r"(hopper::smem_addr(bar)),
      "r"(lane)
      : "memory");
}

__device__ __forceinline__ void consumers_sync() { hopper::bar_sync(SYNC_BAR, CTHREADS); }

// The filterbank sums of mel bins m, m + 1 (m even) of the power rows at
// rows[r], one fmaf chain each, both over the pair's joint band lo .. hi in
// bin order (the bands rise with the mel bin): a weight outside a mel bin's
// own band is an exact zero, whose product adds +0 to its non-negative sum,
// so each sum has the bits of mel_log_store's over its own band.
__device__ __forceinline__ void pair_sums(const float* const (&rows)[TAIL_ROWS], const float* fb_s, int m, int lo,
                                          int hi, float (&mel)[TAIL_ROWS][PAIR]) {
#pragma unroll
  for (int r = 0; r < TAIL_ROWS; ++r) mel[r][0] = mel[r][1] = 0.0f;
  for (int bin = lo; bin <= hi; ++bin) {
    const float2 w = *reinterpret_cast<const float2*>(fb_s + bin * NMEL + m);
#pragma unroll
    for (int r = 0; r < TAIL_ROWS; ++r) {
      const float p = rows[r][bin];
      mel[r][0] = fmaf(p, w.x, mel[r][0]);
      mel[r][1] = fmaf(p, w.y, mel[r][1]);
    }
  }
}

// Scaled log-mel of every frame below `usable` of b clips (clip c's samples
// from audio + c ld, t of them) into out (b, n_out, 32), frames usable ..
// n_out - 1 zero; `taps` is the taps buffer (its tiles at DFT_TILES_OFFSET),
// `fb` the filterbank buffer.
__global__ void __launch_bounds__(BLOCK, 1)
mel_dft_kernel(const float* __restrict__ audio, const float* __restrict__ taps, const float* __restrict__ fb,
               float* __restrict__ out, int b, int t, long ld, int usable, int n_out) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((128 - (hopper::smem_addr(smem_raw) & 127)) & 127);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S_BAR);
  uint64_t* empty = full + RING;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int rows_clip = usable + HALO;  // the padded frames of a clip
  const int total = b * rows_clip;      // padded rows (the wrapper keeps them below 2^31)
  const int items = (total + ITEM - 1) / ITEM;

  uint64_t* pw_full = empty + RING;   // this item's power rows are written
  uint64_t* pw_empty = pw_full + 1;   // and read by the tail
  float* power_s = reinterpret_cast<float*>(smem + S_POWER);
  float* fb_s = reinterpret_cast<float*>(smem + S_FB);
  const long clip_stride = static_cast<long>(n_out) * NMEL;

  if (tid == 0) {
    for (int i = 0; i < RING; ++i) {
      hopper::mbar_init(full + i, 1);
      hopper::mbar_init(empty + i, CONSUMERS * 4);  // one arrival a consumer warp
    }
    hopper::mbar_init(pw_full, CONSUMERS * 4);
    hopper::mbar_init(pw_empty, TAIL_WARPS);
    hopper::mbar_init_fence();
  }
  if (tid < CTHREADS) stage_fb(fb, fb_s);
  __syncthreads();

  if (warp >= CONSUMERS * 4) {
    hopper::setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == CONSUMERS * 4) {
      // the 25 tiles of every item of this block, in order, RING ahead
      if (lane == 0) {
        const unsigned char* tiles = reinterpret_cast<const unsigned char*>(taps + DFT_TILES_OFFSET);
        int step = 0;
        for (int item = blockIdx.x; item < items; item += gridDim.x) {
          for (int s = 0; s < KSTEPS; ++s, ++step) {
            const int slot = step % RING;
            if (step >= RING) hopper::mbar_wait(empty + slot, (step / RING - 1) & 1);
            hopper::mbar_expect_tx(full + slot, TILE_BYTES);
            hopper::bulk_load(smem + S_RING + slot * TILE_BYTES, tiles + s * TILE_BYTES, TILE_BYTES, full + slot);
          }
        }
      }
      return;
    }
    // The tail of every item once the consumers have written its power
    // rows: tail warp hw sums pairs hw, hw + TAIL_WARPS, ... of mel bins of
    // the rows lane + 32 r, all lanes of a warp over one joint band at a time
    // (the weights a broadcast, the rows' bins in 32 banks), and stores each
    // row's pair as one float2 (pairs dealt out by the widths of their joint
    // bands, 57 / 58 / 57 bins a warp, measured 12% slower). Row P = ITEM
    // item + m is frame P % rows_clip of clip P / rows_clip.
    const int hw = warp - (CONSUMERS * 4 + 1);
    const int* band = mel_bands(fb_s);
    for (int k = 0, item = blockIdx.x; item < items; item += gridDim.x, ++k) {
      const float* rows[TAIL_ROWS];
      long row_out[TAIL_ROWS];  // the row's offset in out, or -1: no frame to write
#pragma unroll
      for (int r = 0; r < TAIL_ROWS; ++r) {
        const int p = item * ITEM + lane + 32 * r;
        const int clip = p / rows_clip;
        const int f = p - clip * rows_clip;
        rows[r] = power_s + (lane + 32 * r) * PLR;
        row_out[r] = p < total && f < usable ? clip * clip_stride + f * NMEL : -1;
      }
      hopper::mbar_wait(pw_full, k & 1);
#pragma unroll 1
      for (int i = hw; i < NMEL / PAIR; i += TAIL_WARPS) {
        float mel[TAIL_ROWS][PAIR];
        pair_sums(rows, fb_s, PAIR * i, band[PAIR * i], band[NMEL + PAIR * i + 1], mel);
#pragma unroll
        for (int r = 0; r < TAIL_ROWS; ++r)
          if (row_out[r] >= 0)
            *reinterpret_cast<float2*>(out + row_out[r] + PAIR * i) =
                make_float2(scaled_log(mel[r][0]), scaled_log(mel[r][1]));
      }
      __syncwarp();
      arrive_lane0(pw_empty, lane);
    }
    return;
  }
  hopper::setmaxnreg_inc<CONSUMER_REGS>();

  const int wg = warp >> 2;
  const int wi = warp & 3;  // warp of the warpgroup: rows 16 wi ..
  const int g = lane >> 2;
  const int q = lane & 3;
  if (n_out > usable) {
    for (long clip = blockIdx.x; clip < b; clip += gridDim.x)
      for (int i = tid; i < (n_out - usable) * NMEL; i += CTHREADS)
        out[clip * clip_stride + static_cast<long>(usable) * NMEL + i] = 0.0f;
  }

  int item = blockIdx.x;  // a block has an item at least
  {
    float4 v[STAGE_N];
#pragma unroll
    for (int k = 0; k < STAGE_N; ++k) v[k] = stage_load(item, k, audio, b, t, ld, rows_clip, tid);
#pragma unroll
    for (int k = 0; k < STAGE_N; ++k) stage_store(k, v[k], tid, smem + S_X);
  }
  hopper::fence_async_shared();  // the rows' stores seen by wgmma
  consumers_sync();

  int step = 0;  // ring slots consumed
  for (int k = 0; item < items; item += gridDim.x, ++k) {
    const unsigned char* xb = smem + S_X + (k & 1) * XBYTES;  // this item's rows
    unsigned char* xn = smem + S_X + ((k + 1) & 1) * XBYTES;  // the next item's
    const int next = item + gridDim.x;
    float d[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) d[i] = 0.0f;
    float4 v[2][BATCH];  // two batches of the next item's samples in flight
#pragma unroll
    for (int s = 0; s < KSTEPS; ++s, ++step) {
      const int slot = step % RING;
      hopper::mbar_wait(full + slot, (step / RING) & 1);
      hopper::wgmma_fence();  // the accumulators' registers, as written before this wgmma
      // rows 64 wg + s / 10 .., samples 16 (s % 10) ..
      const uint64_t a = hopper::kmajor_desc(xb + ((2 * (s % STEPS_HOP)) * NR + TILE * wg + s / STEPS_HOP) * 16,
                                             A_K_BYTES, A_M_BYTES);
      hopper::wgmma_ss256(d, a, hopper::kmajor_desc(smem + S_RING + slot * TILE_BYTES, CORE_K_BYTES, CORE_N_BYTES),
                          1);
      hopper::wgmma_commit();
      if (s >= DEPTH) {
        hopper::wgmma_wait<DEPTH>();  // step s - DEPTH is done
        arrive_lane0(empty + (step - DEPTH) % RING, lane);
      }
      // batch j of the next item's samples: loaded at k-step BATCH_STEPS j,
      // stored BATCH_LAG k-steps later from register set j % 2
      if (next < items && s >= BATCH_LAG && s % BATCH_STEPS == 0 && (s - BATCH_LAG) / BATCH_STEPS < BATCHES) {
        const int j = (s - BATCH_LAG) / BATCH_STEPS;
#pragma unroll
        for (int i = 0; i < BATCH; ++i) stage_store(BATCH * j + i, v[j % 2][i], tid, xn);
      }
      if (next < items && s % BATCH_STEPS == 0 && s / BATCH_STEPS < BATCHES) {
        const int j = s / BATCH_STEPS;
#pragma unroll
        for (int i = 0; i < BATCH; ++i) v[j % 2][i] = stage_load(next, BATCH * j + i, audio, b, t, ld, rows_clip, tid);
      }
    }
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int i = DEPTH; i > 0; --i) arrive_lane0(empty + (step - i) % RING, lane);

    if (k > 0) hopper::mbar_wait(pw_empty, (k - 1) & 1);  // the tail has read the previous item's rows
    // d[4 j + 2 h + e] is row 16 wi + g + 8 h, column 8 j + 2 q + e: the
    // cos (re) of bin 8 j + 2 q + e for j < 16, its sin (im) at j + 16
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* p = power_s + (TILE * wg + 16 * wi + g + 8 * h) * PLR + 2 * q;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float re = d[4 * j + 2 * h + e];
          const float im = d[4 * (j + 16) + 2 * h + e];
          p[8 * j + e] = __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im));
        }
      }
    }
    __syncwarp();
    arrive_lane0(pw_full, lane);   // to the tail
    hopper::fence_async_shared();  // the next item's rows seen by wgmma
    consumers_sync();              // and in place
  }
}

// One launch of mel_dft_kernel: as many blocks as fit on the current card
// (one an SM), at most one an item. The resident count is queried once a
// card and kept by device; a failed query returns its error and launches
// nothing, so a launch never falls back to another schedule.
inline cudaError_t launch(const void* audio, const void* taps, const void* fb, void* out, int b, int t, long ld,
                          int usable, int n_out, cudaStream_t stream) {
  constexpr int MAX_DEVICES = 64;
  static int resident[MAX_DEVICES] = {};  // 0 until the card was queried
  int dev = 0;
  cudaError_t err = cudaFuncSetAttribute(mel_dft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(SMEM_BYTES));
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mel_dft_kernel, BLOCK, SMEM_BYTES);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;  // the block does not fit on an SM
    resident[dev] = sms * per_sm;
  }
  const long rows = static_cast<long>(b) * (usable + HALO);
  if (rows > (1L << 31) - ITEM) return cudaErrorInvalidValue;  // the walk counts rows in int
  const int items = static_cast<int>((rows + ITEM - 1) / ITEM);
  const int blocks = items < resident[dev] ? items : resident[dev];
  mel_dft_kernel<<<blocks, BLOCK, SMEM_BYTES, stream>>>(
      static_cast<const float*>(audio), static_cast<const float*>(taps), static_cast<const float*>(fb),
      static_cast<float*>(out), b, t, ld, usable, n_out);
  return cudaGetLastError();
}

}  // namespace dft
}  // namespace mel
