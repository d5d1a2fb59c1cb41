// Hop-block ("fat") mel-patch kernel (K1b) for Hopper, sm_90a.
//
// Replaces heybuddy_tpu/ops/pallas/melspec_kernel.py::mel_patches_pallas with
// dft_mode="fat" (its kernel_fat): the same function as K1 (mel_patches.cu),
// audio (b, t) -> scaled log-mel in the padded patch layout (b, p_pad, 128),
// computed as one product of the clip's hop rows (160 samples each) against
// the three hop-aligned blocks of the windowed DFT basis laid side by side,
//
//   Z = hops (n_hops, 160) @ [B0 | B1 | B2] (160, 3 x 256),  Bj = rows
//       160 j .. 160 j + 159 of the 512-point basis (rows 480..511 are zero),
//   spectrum[f] = Z[f, 0:256] + Z[f + 1, 256:512] + Z[f + 2, 512:768],
//
// then the mel tail of mel_common.cuh (filterbank, log) shared with K1.
// Every frame sums three 160-deep partials in the order B0, B1, B2, as the
// Pallas kernel does, as exact float32 FMAs; K1 computes one 400-deep
// split product (fp16 pairs) on the tensor cores, so the two agree within the
// split's error, not bit for bit.
//
// What bounds it: the formulation's operations. Per frame 3 x 160 x 256 FMAs
// (480 basis rows where K1 needs the 400 the window leaves non-zero) and
// 128 x 32 for the mel projection, against 0.64 KB of new audio per frame.
// The 80 zero rows and the two halo hop rows of each block (below) are its
// extra work: 48 x 480 taps for 46 frames, a quarter more FMAs per frame than
// K1's 400. The function is K1's, and so is its least time: that of its bytes.
//
// Design: one block of 256 threads per (clip, chunk of 46 frames). The block
// loads its 48 hop rows (frames f0..f0+45 read hops f0..f0+47) into shared
// memory with masked loads past t, and computes Z over those rows one basis
// block at a time (3 passes of 256 columns; each thread a 6-row x 8-column
// register tile, the basis streaming through a 16-row shared tile). After
// pass j, hop row r adds its partial into spectrum row r - j in shared memory:
// the shifted sum is an index offset, and the halo rows (r - j outside the
// chunk) are dropped. The Pallas kernel pads the hop axis to a multiple of 8
// for a sublane rule and computes Z for every hop of the clip; here only the
// hops the chunk's frames read are loaded.

#include "mel_common.cuh"

namespace {

using mel::HOP;
using mel::KT;
using mel::NBIN;
using mel::NCOL;
using mel::NMEL;
using mel::THREADS;

constexpr int FAT_FRAMES = 46;               // frames per block
constexpr int FAT_HOPS = FAT_FRAMES + 2;     // hop rows per block: 48
constexpr int NBLK = 3;                      // hop-aligned basis blocks kept
constexpr int FAT_COLS = NBLK * NCOL;        // 768
constexpr int ROWS_PER_THREAD = FAT_HOPS / 8;  // 6 hop rows (ty + 8 i)
constexpr int COLS_PER_THREAD = NCOL / 32;     // 8 columns (tx + 32 j)

// shared memory, in floats
constexpr int S_HOPS = 0;                                 // 48 x 160
constexpr int S_BASIS = S_HOPS + FAT_HOPS * HOP;          // KT x 256
constexpr int S_POWER = 0;                                // 46 x 128 over hops + basis
constexpr int S_SPEC = S_BASIS + KT * NCOL;               // 46 x 256
constexpr int S_FB = S_SPEC + FAT_FRAMES * NCOL;          // 128 x 32 and the bands
constexpr int S_FLOATS = S_FB + mel::FB_FLOATS;
constexpr size_t SMEM_BYTES = S_FLOATS * sizeof(float);  // 110848 B

static_assert(FAT_HOPS % 8 == 0, "hop rows are 8 rows of threads");
static_assert(FAT_FRAMES * NBIN <= S_SPEC, "power tile must fit over hops + basis");
static_assert(HOP % KT == 0, "basis tiles must cover the hop exactly");
static_assert((KT * NCOL) % (4 * THREADS) == 0, "basis tile loads as float4");

__global__ void __launch_bounds__(THREADS, 2)
mel_patches_fat_kernel(const float* __restrict__ audio, const float* __restrict__ basis,
                       const float* __restrict__ fb, float* __restrict__ out,
                       int t, int usable, int p_pad) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* hops_s = smem + S_HOPS;
  float* basis_s = smem + S_BASIS;
  float* power_s = smem + S_POWER;
  float* spec_s = smem + S_SPEC;
  float* fb_s = smem + S_FB;

  const int clip = blockIdx.x;
  const int f0 = blockIdx.y * FAT_FRAMES;
  const int tid = threadIdx.x;
  const int tx = tid & 31;
  const int ty = tid >> 5;
  float* out_clip = out + static_cast<size_t>(clip) * p_pad * 4 * NMEL;
  auto store = [&](int fl, int m, float v) { out_clip[(f0 + fl) * NMEL + m] = v; };

  if (f0 >= usable) {
    mel::zero_chunk(FAT_FRAMES, f0, 4 * p_pad, store);
    return;
  }
  mel::load_audio(audio + static_cast<size_t>(clip) * t, t, static_cast<long>(HOP) * f0,
                  FAT_HOPS * HOP, hops_s);
  mel::load_fb(fb, fb_s);

  const float4* basis4 = reinterpret_cast<const float4*>(basis);
  float4* basis_s4 = reinterpret_cast<float4*>(basis_s);
  for (int blk = 0; blk < NBLK; ++blk) {
    float acc[ROWS_PER_THREAD][COLS_PER_THREAD];
#pragma unroll
    for (int i = 0; i < ROWS_PER_THREAD; ++i)
#pragma unroll
      for (int j = 0; j < COLS_PER_THREAD; ++j) acc[i][j] = 0.0f;

    for (int k0 = 0; k0 < HOP; k0 += KT) {
      __syncthreads();  // previous tile consumed (and hops loaded, last pass added)
      for (int i = tid; i < KT * NCOL / 4; i += THREADS) {
        const int kk = i / (NCOL / 4);
        const int c4 = i - kk * (NCOL / 4);
        basis_s4[i] = basis4[(k0 + kk) * (FAT_COLS / 4) + blk * (NCOL / 4) + c4];
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        float a[ROWS_PER_THREAD];
        float bv[COLS_PER_THREAD];
#pragma unroll
        for (int i = 0; i < ROWS_PER_THREAD; ++i) a[i] = hops_s[(ty + 8 * i) * HOP + k0 + kk];
#pragma unroll
        for (int j = 0; j < COLS_PER_THREAD; ++j) bv[j] = basis_s[kk * NCOL + tx + 32 * j];
#pragma unroll
        for (int i = 0; i < ROWS_PER_THREAD; ++i)
#pragma unroll
          for (int j = 0; j < COLS_PER_THREAD; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
      }
    }
    // shifted sum: hop row r feeds frame r - blk
#pragma unroll
    for (int i = 0; i < ROWS_PER_THREAD; ++i) {
      const int fr = ty + 8 * i - blk;
      if (fr < 0 || fr >= FAT_FRAMES) continue;
#pragma unroll
      for (int j = 0; j < COLS_PER_THREAD; ++j) {
        float* s = spec_s + fr * NCOL + tx + 32 * j;
        *s = blk == 0 ? acc[i][j] : *s + acc[i][j];
      }
    }
  }
  __syncthreads();  // spectrum complete; hops and basis tiles dead

  for (int idx = tid; idx < FAT_FRAMES * NBIN; idx += THREADS) {
    const int fl = idx / NBIN;
    const int bin = idx - fl * NBIN;
    const float re = spec_s[fl * NCOL + bin];
    const float im = spec_s[fl * NCOL + NBIN + bin];
    power_s[idx] = re * re + im * im;
  }
  __syncthreads();

  mel::mel_log_store(power_s, fb_s, FAT_FRAMES, f0, usable, 4 * p_pad, store);
}

}  // namespace

extern "C" int mel_patches_fat_smem_bytes() { return static_cast<int>(SMEM_BYTES); }

extern "C" int mel_patches_fat_launch(const void* audio, const void* basis, const void* fb,
                                      void* out, int b, int t, int usable, int p_pad,
                                      void* stream) {
  cudaError_t err = cudaFuncSetAttribute(mel_patches_fat_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(SMEM_BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(b, (4 * p_pad + FAT_FRAMES - 1) / FAT_FRAMES);
  mel_patches_fat_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(audio), static_cast<const float*>(basis),
      static_cast<const float*>(fb), static_cast<float*>(out), t, usable, p_pad);
  return static_cast<int>(cudaGetLastError());
}
