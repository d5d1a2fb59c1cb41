// What the mel kernels for Hopper, sm_90a, share. K1 (mel_patches.cu), K3
// (mel_spectrogram.cu) and K4 (featurize.cu) compute their float32 log-mel
// with mel_fft.cuh's `logmel_chunk`, a real FFT on the CUDA cores; their
// bf16-DFT entries with `logmel_chunk_bf16` below; K1b (mel_patches_fat.cu)
// computes its spectrum another way (one wgmma product over hop rows, its
// audio split into fp16 pairs by `operands<3>`). All of them end in the tail
// `mel_log_store`, so a frame's log-mel follows one source of arithmetic
// from its power on.
//
// Per frame f: spectrum = audio[160 f + 56 .. 160 f + 456) @ basis (400, 256),
// the windowed real-DFT basis restricted to the 400 rows the centred Hann
// window leaves non-zero (the other 112 rows of the 512-point frame are
// exactly zero) and to 128 cos + 128 sin bins (bins >= 124 carry zero mel
// weight). Then power = re^2 + im^2, mel = power @ fb (128, 32),
// log(mel + 1e-6) / 10 + 2.
//
// The bf16-DFT variant of the TPU kernel (dft_dtype=bfloat16) rounds the
// audio x and the basis b to bf16 and sums their exact products in float32:
// bf16(x) bf16(b) on the tensor cores (mma_sync.cuh). An FFT cannot
// reproduce that rounding, so `logmel_chunk_bf16` keeps the direct DFT.
// K1b's split product of fp16 pairs, x = x_hi + x_lo and b = b_hi + b_lo
// (lo = fp16(v - hi), after exact power-of-two scalings that keep both
// inside fp16's normal range), is x_hi b_hi + x_hi b_lo + x_lo b_hi with
// float32 accumulation: 22 significant bits a pair, float32-like accuracy
// (a bf16 pair's 16 bits moved the log-mel by 2e-3 on a tone with noise 60
// dB below it; PERF.md). Power, filterbank and log stay float32 on the CUDA
// cores, compiled without fast math, with the accurate logf.
//
// Layout of `logmel_chunk_bf16`: 256 threads compute one chunk of 48 frames
// (three m16 tiles). The chunk's audio goes to shared memory once as bf16 hop
// rows of 160 samples that start at tap 0 of the chunk's first frame: frame
// f, tap k lies at hop row f + k / 160, column k % 160, so a 16-tap k-step
// (160 % 16 == 0) is a plain 16 x 16 block of hop rows and overlapping frames
// need no im2col. Rows are padded to 168 values so ldmatrix is
// conflict-free. The basis's bf16 operand, rounded once beside the float32
// basis (the buffer `basis` points at), streams from L2 in 16-row tiles by
// cp.async through a ring of STAGES slots, STAGES - 1 k-steps ahead. 8 warps
// x 32 columns cover the 256 cos | sin columns: 3 x 4 m16n8 tiles, 48 float32
// accumulators per thread. A bin's re and im land in different warps, so the
// sin warps write im^2 to shared memory (over the dead audio / basis tiles)
// and the cos warps add re^2 in place; the power rows then go through the mel
// product against the filterbank, loaded into shared memory beside them with
// each mel bin's band of non-zero bins, and each value to the caller's
// `store(frame_in_chunk, mel_bin, value)`.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sync.cuh"

namespace mel {

constexpr int HOP = 160;
constexpr int TAP0 = 56;     // first non-zero row of the 512-point windowed basis
constexpr int TAPS = 400;    // rows [56, 456)
constexpr int NBIN = 128;    // DFT bins kept (cos block, then sin block)
constexpr int NCOL = 2 * NBIN;
constexpr int NMEL = 32;
constexpr int FCHUNK = 48;   // frames per chunk: 12 patches (3 m16 tiles of the bf16 DFT)
constexpr int KT = 16;       // basis rows per tile: one k-step
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int LDX = HOP + 8;                      // hop row stride, 16-bit values
constexpr int LDB = NCOL + 8;                     // basis tile row stride, 16-bit values
constexpr int MT = FCHUNK / 16;                   // 3 m16 tiles
constexpr int NT = NCOL / WARPS / 8;              // 4 n8 tiles per warp
constexpr int KSTEPS = TAPS / KT;                 // 25
constexpr int PLD = NBIN + 8;                     // power row stride: conflict-free fragment stores
// K1b's split DFT's exact power-of-two scalings: x 2^-8 keeps int16-range
// audio (and up to 2^24) inside fp16's range, b 2^8 lifts the basis's small
// values out of fp16's subnormals; their products are x b
constexpr float X_SCALE = 1.0f / 256.0f;
constexpr float B_SCALE = 256.0f;
// The taps buffer the kernels take is the float32 (TAPS, NCOL) matrix followed
// by its operands, each (TAPS, NCOL) of 16-bit values: the fp16 pair hi, lo of
// b B_SCALE (read by no kernel of this tree: the prefix a split-DFT build of
// K1, K3 and K4 reads), then bf16(b) from 16-bit value OPS_BF16 on; and last
// the FFT's table (mel_fft.cuh FFT_TABLE_OFFSET; melspec_kernel.mel_constants).
constexpr int OPS_BF16 = 2 * TAPS * NCOL;

// The filterbank the kernels take is the float32 (NBIN, NMEL) matrix followed
// in the same buffer by each mel bin's band, the first and the last bin its
// filter is non-zero on, as NMEL int32 each (melspec_kernel.mel_constants).
constexpr int FB_FLOATS = NBIN * NMEL + 2 * NMEL;

// Basis tiles in flight: a ring of two, one k-step ahead. A deeper ring
// measured no faster (PERF.md), and this one leaves room for three blocks on
// an SM, which hides more latency.
constexpr int STAGES = 2;

// scratch of `logmel_chunk_bf16`, bytes; the power rows and the filterbank
// come after the DFT, over its dead tiles
struct DftSmem {
  static constexpr int HOPS = FCHUNK + (TAPS - 1) / HOP;       // hop rows a chunk reads
  static constexpr int X = 0;                                   // HOPS x LDX bf16
  static constexpr int B = X + HOPS * LDX * 2;                  // STAGES x KT x LDB bf16
  static constexpr int DFT_END = B + STAGES * KT * LDB * 2;
  static constexpr int POWER = 0;                               // FCHUNK x PLD float
  static constexpr int FB = POWER + FCHUNK * PLD * 4;           // FB_FLOATS float
  static constexpr int TAIL_END = FB + FB_FLOATS * 4;
  static constexpr int BYTES = DFT_END > TAIL_END ? DFT_END : TAIL_END;
};
constexpr size_t SMEM_BYTES = DftSmem::BYTES;  // 42752 B

static_assert(HOP % 16 == 0, "a 16-tap k-step never crosses a hop row");
static_assert(TAP0 % 4 == 0 && HOP % 4 == 0, "audio loads in groups of four samples");
static_assert(TAPS % KT == 0 && KT == 16, "one basis tile per k-step covers the taps exactly");
static_assert((LDX * 2) % 16 == 0 && (LDB * 2) % 16 == 0, "ldmatrix rows are 16-byte aligned");

__device__ __forceinline__ void load_fb(const float* __restrict__ fb, float* fb_s) {
  for (int i = threadIdx.x; i < FB_FLOATS; i += THREADS) fb_s[i] = fb[i];
}

// Frames f0 .. f0 + nf - 1 of a chunk whose power rows (nf x 128, row stride
// LD) and filterbank (load_fb) are in shared memory: store(f - f0, m, v) for
// every frame f < n_out, v the scaled log-mel when f < usable and 0 past it.
// NTHREADS threads take part (the whole block by default), thread `tid` of
// them the caller's. A thread carries two frames' sums at once, two
// independent chains over the same filter weights; each sum keeps its own
// order, so the values do not depend on the pairing.
template <int LD = NBIN, int NTHREADS = THREADS, typename Store>
__device__ __forceinline__ void mel_log_store(const float* power_s, const float* fb_s, int nf,
                                              int f0, int usable, int n_out, int tid,
                                              Store store) {
  static_assert(NTHREADS % NMEL == 0, "a thread keeps one mel bin");
  // The filter of mel bin m is non-zero on bins lo..hi only. A product with
  // one of its zeros adds exactly +0 to the non-negative power sum, so the
  // sum over lo..hi in bin order has the bits of the sum over all 128 bins.
  const int m = tid % NMEL;
  const int* band = reinterpret_cast<const int*>(fb_s + NBIN * NMEL);
  const int lo = band[m];
  const int hi = band[NMEL + m];
  constexpr int STEP = NTHREADS / NMEL;  // frames between a thread's two
  for (int idx = tid; idx < nf * NMEL; idx += 2 * NTHREADS) {
    const int fl = idx / NMEL;
    const int fl2 = fl + STEP < nf ? fl + STEP : fl;  // a lone last frame pairs with itself
    const float* p = power_s + fl * LD;
    const float* p2 = power_s + fl2 * LD;
    float mel = 0.0f;
    float mel2 = 0.0f;
    for (int bin = lo; bin <= hi; ++bin) {
      const float w = fb_s[bin * NMEL + m];
      mel = fmaf(p[bin], w, mel);
      mel2 = fmaf(p2[bin], w, mel2);
    }
    if (f0 + fl < n_out) store(fl, m, f0 + fl < usable ? logf(mel + 1e-6f) / 10.0f + 2.0f : 0.0f);
    if (fl2 != fl && f0 + fl2 < n_out)
      store(fl2, m, f0 + fl2 < usable ? logf(mel2 + 1e-6f) / 10.0f + 2.0f : 0.0f);
  }
}

// A chunk that holds no real frame: zeros for its frames below n_out.
template <typename Store>
__device__ __forceinline__ void zero_chunk(int nf, int f0, int n_out, Store store) {
  for (int idx = threadIdx.x; idx < nf * NMEL; idx += THREADS) {
    const int fl = idx / NMEL;
    if (f0 + fl < n_out) store(fl, idx % NMEL, 0.0f);
  }
}

// The DFT's 16-bit operands of an audio sample x, as raw bits: for the split
// DFT (TERMS 3, K1b) the fp16 pair hi = fp16(x X_SCALE), lo = fp16(x X_SCALE -
// hi); for the bf16 DFT (TERMS 1) bf16(x) alone.
template <int TERMS>
__device__ __forceinline__ void operands(float x, uint16_t& hi, uint16_t& lo) {
  if constexpr (TERMS == 3) {
    const float v = x * X_SCALE;
    const __half h = __float2half_rn(v);
    hi = __half_as_ushort(h);
    lo = __half_as_ushort(__float2half_rn(v - __half2float(h)));
  } else {
    hi = __bfloat16_as_ushort(__float2bfloat16(x));
    lo = 0;
  }
}

__device__ __forceinline__ uint32_t pack2(uint16_t a, uint16_t b) {
  return static_cast<uint32_t>(a) | (static_cast<uint32_t>(b) << 16);  // a at the lower address
}

// The whole block's barrier: the mel body's threads by default.
struct BlockSync {
  __device__ __forceinline__ void operator()() const { __syncthreads(); }
};

// Scaled log-mel of frames f0 .. f0 + 47 of one clip (t samples) by the bf16
// DFT through store(), as mel_log_store says. `basis` is the taps buffer (its
// bf16 operand at OPS_BF16); `smem` holds SMEM_BYTES; the block's THREADS threads run
// it. Starts with a barrier, so a caller may run chunks back to back over the
// same scratch.
template <typename Store>
__device__ __forceinline__ void logmel_chunk_bf16(const float* __restrict__ audio_clip, int t, int f0,
                                                  int usable, int n_out, const float* __restrict__ basis,
                                                  const float* __restrict__ fb, unsigned char* smem,
                                                  Store store) {
  if (f0 >= usable) {
    zero_chunk(FCHUNK, f0, n_out, store);
    return;
  }
  using L = DftSmem;
  uint16_t* x_s = reinterpret_cast<uint16_t*>(smem + L::X);
  uint16_t* b_s = reinterpret_cast<uint16_t*>(smem + L::B);
  float* power_s = reinterpret_cast<float*>(smem + L::POWER);
  float* fb_s = reinterpret_cast<float*>(smem + L::FB);
  const uint16_t* b_g = reinterpret_cast<const uint16_t*>(basis + TAPS * NCOL) + OPS_BF16;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;

  // basis tile s (rows 16 s .. 16 s + 15) into ring slot s % STAGES by
  // cp.async, then close its group (empty past the last tile): group s holds
  // tile s, so waiting for all but the newest STAGES - 2 groups finds tile s
  constexpr int ROW_PIECES = NCOL / 8;  // 16-byte pieces per basis row
  auto stage = [&](int s) {
    if (s < KSTEPS) {
      const int slot = (s % STAGES) * KT * LDB;
      for (int p = tid; p < KT * ROW_PIECES; p += THREADS) {
        const int r = p / ROW_PIECES;
        const int c = (p - r * ROW_PIECES) * 8;
        mma::cp_async16(b_s + slot + r * LDB + c, b_g + (s * KT + r) * NCOL + c);
      }
    }
    mma::cp_async_commit();
  };

  __syncthreads();  // the scratch may still be read by the previous chunk
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) stage(s);
  {
    // four samples at a time (HOP % 4 == 0: a group stays in its hop row).
    // g0 is a multiple of 4, so when t is too (and the clip's base is 16-byte
    // aligned) a group lies wholly below t or wholly past it: one float4 load
    const long g0 = static_cast<long>(HOP) * f0 + TAP0;
    const bool vec = t % 4 == 0 && reinterpret_cast<uintptr_t>(audio_clip) % 16 == 0;
#pragma unroll
    for (int i = 4 * tid; i < L::HOPS * HOP; i += 4 * THREADS) {
      const int r = i / HOP;
      const long g = g0 + i;
      float v[4];
      if (vec) {
        const float4 q = g < t ? __ldg(reinterpret_cast<const float4*>(audio_clip + g))
                               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        v[0] = q.x;
        v[1] = q.y;
        v[2] = q.z;
        v[3] = q.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = g + e < t ? audio_clip[g + e] : 0.0f;
      }
      uint16_t x[4], unused;
#pragma unroll
      for (int e = 0; e < 4; ++e) operands<1>(v[e], x[e], unused);
      *reinterpret_cast<uint2*>(x_s + r * LDX + i - r * HOP) =
          make_uint2(pack2(x[0], x[1]), pack2(x[2], x[3]));
    }
  }

  float acc[MT][NT][4];
  mma::zero(acc);
  for (int s = 0; s < KSTEPS; ++s) {
    mma::cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile s (and the audio, on entry) visible; tile s - 1 consumed
    stage(s + STAGES - 1);  // over tile s - 1
    // taps 16 s .. 16 s + 15 of frame row f: hop row f + s / 10, columns 16 (s % 10) ..
    const int a_off = (s / (HOP / KT)) * LDX + (s % (HOP / KT)) * KT;
    uint32_t bh[NT][2];
    mma::load_b<NT>(b_s + (s % STAGES) * KT * LDB, LDB, warp * NT * 8, bh);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      uint32_t ah[4];
      mma::ldmatrix_a(x_s + a_off + 16 * i * LDX, LDX, ah);
#pragma unroll
      for (int j = 0; j < NT; ++j) mma::mma_16816(acc[i][j], ah, bh[j][0], bh[j][1]);
    }
  }
  __syncthreads();  // audio and basis tiles dead: power and filterbank go over them
  load_fb(fb, fb_s);  // visible to mel_log_store after the power passes' barriers

  // warps 0-3 hold the cos columns (re of bins 32 w ..), warps 4-7 the sin
  // columns of the same bins: im^2 first, then re^2 + im^2 in place
  const int half = warp >= WARPS / 2;
  const int bin0 = (warp - half * WARPS / 2) * NT * 8;
  for (int pass = 1; pass >= 0; --pass) {
    if (half == pass) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float2* p = reinterpret_cast<float2*>(power_s + (16 * i + mma::frag_row(2 * h)) * PLD +
                                                  bin0 + 8 * j + mma::frag_col(0));
            const float v0 = acc[i][j][2 * h];
            const float v1 = acc[i][j][2 * h + 1];
            if (pass) {
              *p = make_float2(__fmul_rn(v0, v0), __fmul_rn(v1, v1));
            } else {
              const float2 im2 = *p;
              *p = make_float2(__fadd_rn(__fmul_rn(v0, v0), im2.x), __fadd_rn(__fmul_rn(v1, v1), im2.y));
            }
          }
    }
    __syncthreads();
  }

  mel_log_store<PLD>(power_s, fb_s, FCHUNK, f0, usable, n_out, threadIdx.x, store);
}

}  // namespace mel
