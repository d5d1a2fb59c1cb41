// Hop-block ("fat") mel-patch kernel (K1b) for Hopper, sm_90a, and its
// bf16-DFT variant.
//
// Replaces heybuddy_tpu/ops/pallas/melspec_kernel.py::mel_patches_pallas with
// dft_mode="fat" (its kernel_fat; `mel_patches_fat_bf16_launch` is its
// dft_dtype=bfloat16): the same function as K1 (mel_patches.cu), audio
// (b, t) -> scaled log-mel in the padded patch layout (b, p_pad, 128),
// computed as one product of the hop rows (160 samples each) against the
// three hop-aligned blocks of the windowed DFT basis laid side by side,
//
//   Z = hops (n_hops, 160) @ [B0 | B1 | B2] (160, 3 x 256),  Bj = rows
//       160 j .. 160 j + 159 of the 512-point basis (rows 480..511 are zero),
//   spectrum[f] = Z[f, 0:256] + Z[f + 1, 256:512] + Z[f + 2, 512:768],
//
// then the mel tail of mel_common.cuh (power, filterbank, log), shared with
// K1, K3 and K4. The product is a split one of fp16 pairs, as K1's
// (mel_common.cuh: X_SCALE, B_SCALE, x_hi b_hi + x_hi b_lo + x_lo b_hi,
// float32 accumulation); TERMS = 1 is the bf16 DFT, bf16(x) bf16(b) alone.
//
// What bounds it: the function's least time is its bytes, as K1's (0.64 KB
// of new audio a frame). The method's floor is its products: 480 basis rows
// a frame (80 of them zero, where K1 needs 400), three fp16 products a term
// at the tensor cores' 16-bit rate, 64 hop rows for 62 frames (PERF.md:
// 0.227 ms for 2048 clips). The products run near that floor; what holds
// the kernel above it is the work beside them: the epilogue's shifted sums,
// the mel tail and the barriers run while no product does, because a block
// takes 215 KB of shared memory and so an SM of its own. B, 480 KB of fp16
// pairs, does not fit in shared memory; a block streams all of it from L2
// per 124 frames (1.14 GB for 2048 clips). Blocks of one warpgroup, two to
// an SM, overlapped the tail but doubled that stream and ran slower, as did
// persistent blocks (PERF.md §6).
//
// Design: when t % 160 == 0 the row-major audio is already the (b t / 160,
// 160) matrix of hop rows, so the hop rows are walked flat, across clip
// boundaries: frame f of clip c reads flat rows c t / 160 + f .. + 2, and a
// clip's frames past `usable` are computed and dropped. A block of 288
// threads holds two consumer warpgroups and a producer warp.
//  - A: each warpgroup takes 64 hop rows and keeps the 62 frames that start
//    in them (the two last rows are the halo of the next warpgroup's rows: 3%
//    of the rows are computed twice). TMA loads its float32 rows in five
//    32-column boxes with the 128-byte swizzle (conflict-free fragment reads);
//    where t % 160 != 0 or the audio is not 16-byte aligned the flat view
//    does not exist, and the warpgroup loads the same layout with plain loads
//    from the clip's own rows instead. Rows past the batch are zero. A goes
//    to the tensor cores from registers: each k-step's fragment is split into
//    fp16 hi / lo there, so A is never staged a second time.
//  - B: precomputed once in wgmma's no-swizzle K-major layout (8 x 8 core
//    matrices), hi then lo, in the order the block consumes it
//    (melspec_kernel.fat_tiles), and streamed by the producer warp with TMA
//    bulk copies through a ring of RING slots of 8 KB guarded by mbarriers;
//    the filterbank comes the same way, once. Both warpgroups read each
//    slot: B costs one L2 read per 128 hop rows.
//  - The product: wgmma.mma_async m64n128k16, one n128 half of a basis block
//    at a time (the cos and sin columns of 64 bins side by side), 10 k-steps
//    of 16 hop columns, one wgmma per term; 6 passes a tile.
//  - Epilogue: the shift stays out of A. After block 0 a warpgroup writes its
//    rows to a spectrum tile in shared memory (row r -> frame r), after block
//    1 it adds row r into frame r - 1, and after block 2 it adds the tile's
//    frame r - 2 to row r in registers and forms the power there (a bin's re
//    and im lie in one thread). The tile has a row for frames -2 .. 63, so
//    no thread branches on its rows between wgmma instructions (a branch
//    there made ptxas serialize them). The 64 bins of the first half wait in
//    registers; both halves' power rows then go over the dead A tile, and
//    the warpgroup's 128 threads run mel_log_store on its 62 frames.
//  - Each clip's pad rows (frames usable .. 4 p_pad - 1) are written as
//    zeros by the warpgroup whose frames hold the clip's first pad frame.
// The TMA descriptor is encoded per launch through the runtime's driver
// entry point (no link to the driver library) and passed as a
// __grid_constant__ parameter.

#include <cuda.h>

#include "mel_common.cuh"

namespace {

using mel::FB_FLOATS;
using mel::HOP;
using mel::NBIN;
using mel::NMEL;

constexpr int CONSUMERS = 2;                       // warpgroups that multiply
constexpr int FAT_THREADS = CONSUMERS * 128 + 32;  // and one producer warp
constexpr int ROWS_WG = 64;                        // hop rows of a warpgroup: one m64 tile
constexpr int FRAMES_WG = ROWS_WG - 2;             // frames that start in them
constexpr int FRAMES_CTA = CONSUMERS * FRAMES_WG;  // 124
constexpr int NBLK = 3;                            // hop-aligned basis blocks
constexpr int HALVES = 2;                          // n128 halves of a block: 64 bins' cos | sin
constexpr int NHALF = 128;
constexpr int HALF_BINS = NHALF / 2;
constexpr int KSTEPS = HOP / 16;                   // 10 k16 steps over a hop row
constexpr int NSTAGES = HALVES * NBLK * KSTEPS;    // 60 operand tiles a tile of rows
constexpr int TILE16 = 16 * NHALF * 2;             // one k16 x n128 tile of 16-bit values
constexpr int SLOT = 2 * TILE16;                   // hi and lo
constexpr int RING = 6;
constexpr int A_BOX = 32;                          // floats a box row: the 128-byte swizzle's span
constexpr int A_BOXES = HOP / A_BOX;               // 5
constexpr int A_BYTES = ROWS_WG * HOP * 4;
constexpr int SLD = NHALF + 8;                     // spectrum row stride, floats
constexpr int SPEC_ROWS = ROWS_WG + 2;             // frames -2 .. 63: every row has one
constexpr int PLD = NBIN + 8;                      // power row stride, floats
// wgmma descriptor strides of the operand tiles: core matrices (8 rows x 16
// bytes, 128 contiguous bytes) next along k 128 B apart, next along n 256 B
constexpr int CORE_K_BYTES = 128;
constexpr int CORE_N_BYTES = 256;

// shared memory from a 1024-byte-aligned base (the 128-byte swizzle's period)
constexpr int S_A = 0;                                      // CONSUMERS x 64 x 160 float
constexpr int S_SPEC = S_A + CONSUMERS * A_BYTES;           // CONSUMERS x SPEC_ROWS x SLD float
constexpr int S_RING = S_SPEC + CONSUMERS * SPEC_ROWS * SLD * 4;
constexpr int S_FB = S_RING + RING * SLOT;
constexpr int S_BAR = S_FB + FB_FLOATS * 4;                 // full[RING], empty[RING], a[CONSUMERS], fb
constexpr int S_END = S_BAR + (2 * RING + CONSUMERS + 1) * 8;
constexpr size_t SMEM_BYTES = S_END + 1024;                 // 220664 B with the alignment slack
// byte offsets of the operand images behind the float32 blocks (160, 768)
constexpr int OPS_F16 = 0;                                  // NSTAGES x SLOT
constexpr int OPS_BF16 = NSTAGES * SLOT;                    // NSTAGES x TILE16

static_assert(SMEM_BYTES <= 232448, "at most 227 KB of shared memory a block");
static_assert(ROWS_WG * PLD * 4 <= A_BYTES, "the power rows go over the warpgroup's A tile");
static_assert(S_RING % 128 == 0 && S_BAR % 8 == 0, "operand slots and barriers aligned");
static_assert(HOP % A_BOX == 0 && HOP % 16 == 0, "boxes and k-steps cover the hop row");

// element (r, c) of a warpgroup's A tile: box c / 32, 128-byte rows, the
// 16-byte chunk index XORed with r % 8 (TMA's CU_TENSOR_MAP_SWIZZLE_128B)
__device__ __forceinline__ int a_index(int r, int c) {
  return (c / A_BOX) * (ROWS_WG * A_BOX) + r * A_BOX + ((((c % A_BOX) >> 2) ^ (r & 7)) << 2) + (c & 3);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(mma::smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(mma::smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(mma::smem_addr(bar)) : "memory");
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(mma::smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// TMA bulk copy of `bytes` contiguous bytes, completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          mma::smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(mma::smem_addr(bar))
      : "memory");
}

// TMA load of the box at (column c0, row c1) of `map`, completing on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, "
      "%3}], [%4];\n" ::"r"(mma::smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(mma::smem_addr(bar))
      : "memory");
}

// the 128 threads of warpgroup `wg`
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// descriptor of a k16 x n128 operand tile in the no-swizzle K-major layout
__device__ __forceinline__ uint64_t b_desc(const void* tile) {
  return static_cast<uint64_t>((mma::smem_addr(tile) >> 4) & 0x3FFF) |
         (static_cast<uint64_t>(CORE_K_BYTES >> 4) << 16) |
         (static_cast<uint64_t>(CORE_N_BYTES >> 4) << 32);
}

#define FAT_WGMMA_M64N128K16(TY)                                                                   \
  asm volatile(                                                                                    \
      "{\n"                                                                                        \
      ".reg .pred p;\n"                                                                            \
      "setp.ne.b32 p, %69, 0;\n"                                                                   \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "                                 \
      "{%0, %1, %2, %3, %4, %5, %6, %7, "                                                          \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                                                     \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                                                   \
      "%24, %25, %26, %27, %28, %29, %30, %31, "                                                   \
      "%32, %33, %34, %35, %36, %37, %38, %39, "                                                   \
      "%40, %41, %42, %43, %44, %45, %46, %47, "                                                   \
      "%48, %49, %50, %51, %52, %53, %54, %55, "                                                   \
      "%56, %57, %58, %59, %60, %61, %62, %63}, "                                                  \
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"                                                   \
      "}\n"                                                                                        \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),        \
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),    \
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), \
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), \
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), \
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), \
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), \
        "+f"(d[63])                                                                                \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1))

// d (64 x 128 float32 across the warpgroup) += A (64 x 16, this thread's
// fragment a) @ the k16 x n128 tile of `desc`: fp16 for the split DFT
// (TERMS 3), bf16 for the bf16 DFT (TERMS 1)
template <int TERMS>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], const uint32_t (&a)[4], uint64_t desc) {
  if constexpr (TERMS == 3) {
    FAT_WGMMA_M64N128K16("f16");
  } else {
    FAT_WGMMA_M64N128K16("bf16");
  }
}

#undef FAT_WGMMA_M64N128K16

template <int TERMS>
__global__ void __launch_bounds__(FAT_THREADS, 1)
mel_patches_fat_kernel(const __grid_constant__ CUtensorMap hops_map, const float* __restrict__ audio,
                       const unsigned char* __restrict__ ops, const float* __restrict__ fb,
                       float* __restrict__ out, int b, int t, int usable, int p_pad, int tma) {
  static_assert(TERMS == 1 || TERMS == 3, "split DFT (3 terms) or bf16 DFT (1 term)");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (mma::smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S_BAR);
  uint64_t* empty = full + RING;
  uint64_t* a_full = empty + RING;
  uint64_t* fb_full = a_full + CONSUMERS;
  float* fb_s = reinterpret_cast<float*>(smem + S_FB);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int hops_per_clip = t / HOP;
  const long rows = static_cast<long>(b) * hops_per_clip;

  if (tid == 0) {
    for (int i = 0; i < RING; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, CONSUMERS * 128);  // every consumer thread arrives
    }
    for (int w = 0; w < CONSUMERS; ++w) mbar_init(a_full + w, 1);
    mbar_init(fb_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMERS * 4) {
    // producer: the filterbank (needed last), then the 60 operand tiles in
    // order, RING ahead of the consumers
    if (lane == 0) {
      mbar_expect_tx(fb_full, FB_FLOATS * 4);
      bulk_load(fb_s, fb, FB_FLOATS * 4, fb_full);
      constexpr int STAGE_BYTES = TERMS == 3 ? SLOT : TILE16;
      const unsigned char* src = ops + (TERMS == 3 ? OPS_F16 : OPS_BF16);
      for (int st = 0; st < NSTAGES; ++st) {
        const int slot = st % RING;
        if (st >= RING) mbar_wait(empty + slot, (st / RING - 1) & 1);
        mbar_expect_tx(full + slot, STAGE_BYTES);
        bulk_load(smem + S_RING + slot * SLOT, src + static_cast<size_t>(st) * STAGE_BYTES,
                  STAGE_BYTES, full + slot);
      }
    }
    return;
  }

  const int wg = warp >> 2;
  const int wtid = tid & 127;
  const int g = lane >> 2;
  const int q = lane & 3;
  const int ra = 16 * (warp & 3) + g;  // this thread's rows: ra and ra + 8
  const long r0 = static_cast<long>(blockIdx.x) * FRAMES_CTA + wg * FRAMES_WG;
  float* a_s = reinterpret_cast<float*>(smem + S_A + wg * A_BYTES);
  // frame f of the spectrum tile at row f + 2: frames -2 .. 63, so that every
  // thread's rows have a place in each pass (frames < 0 and > 61 are dropped)
  float* spec_s = reinterpret_cast<float*>(smem + S_SPEC) + (wg * SPEC_ROWS + 2) * SLD;

  if (tma) {
    if (wtid == 0) {
      mbar_expect_tx(a_full + wg, A_BYTES);
      for (int k = 0; k < A_BOXES; ++k)
        tma_load_2d(a_s + k * ROWS_WG * A_BOX, &hops_map, k * A_BOX, static_cast<int>(r0), a_full + wg);
    }
    mbar_wait(a_full + wg, 0);
  } else {
    // the same layout by plain loads from each clip's own rows
    for (int i = wtid; i < ROWS_WG * HOP; i += 128) {
      const int r = i / HOP;
      const int c = i - r * HOP;
      const long row = r0 + r;
      float v = 0.0f;
      if (row < rows) {
        const long clip = row / hops_per_clip;
        v = audio[clip * t + (row - clip * hops_per_clip) * HOP + c];
      }
      a_s[a_index(r, c)] = v;
    }
    wg_sync(wg);
  }

  float pw0[32];  // the first half's power: rows ra, ra + 8 (frames ra - 2, ra + 6) x 8 x 2 bins
  float pw1[32];
#pragma unroll
  for (int h = 0; h < HALVES; ++h) {
#pragma unroll 1
    for (int j = 0; j < NBLK; ++j) {
      float d[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) d[i] = 0.0f;
      const int st0 = (h * NBLK + j) * KSTEPS;
#pragma unroll
      for (int s = 0; s < KSTEPS; ++s) {
        const int st = st0 + s;
        const int slot = st % RING;
        mbar_wait(full + slot, (st / RING) & 1);
        const unsigned char* tile = smem + S_RING + slot * SLOT;
        // rows ra / ra + 8, columns 16 s + 2 q (+ 1) and + 8 (+ 1): the m16n8k16 A fragment
        uint32_t ah[4], al[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = ra + 8 * (i & 1);
          const int c = 16 * s + 2 * q + 8 * (i >> 1);
          const float2 x = *reinterpret_cast<const float2*>(a_s + a_index(r, c));
          uint16_t h0, l0, h1, l1;
          mel::operands<TERMS>(x.x, h0, l0);
          mel::operands<TERMS>(x.y, h1, l1);
          ah[i] = mel::pack2(h0, h1);
          al[i] = mel::pack2(l0, l1);
        }
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
        wgmma_m64n128k16<TERMS>(d, ah, b_desc(tile));
        if constexpr (TERMS == 3) {
          wgmma_m64n128k16<TERMS>(d, ah, b_desc(tile + TILE16));
          wgmma_m64n128k16<TERMS>(d, al, b_desc(tile));
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");  // step s - 1 is done
        if (s > 0) mbar_arrive(empty + (st - 1) % RING);
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      mbar_arrive(empty + (st0 + KSTEPS - 1) % RING);

      // d[4 n + 2 hr + e] is row ra + 8 hr, column 8 n + 2 q + e of this half:
      // columns 0..63 the cos (re) of bins 64 h .., 64..127 their sin (im)
      if (j == 0) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int fr = ra + 8 * hr;
#pragma unroll
          for (int n = 0; n < 16; ++n)
            *reinterpret_cast<float2*>(spec_s + fr * SLD + 8 * n + 2 * q) =
                make_float2(d[4 * n + 2 * hr], d[4 * n + 2 * hr + 1]);
        }
      } else if (j == 1) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int fr = ra + 8 * hr - 1;
#pragma unroll
          for (int n = 0; n < 16; ++n) {
            float2* p = reinterpret_cast<float2*>(spec_s + fr * SLD + 8 * n + 2 * q);
            const float2 v = *p;
            *p = make_float2(v.x + d[4 * n + 2 * hr], v.y + d[4 * n + 2 * hr + 1]);
          }
        }
      } else {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int fr = ra + 8 * hr - 2;
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            const float2 re01 = *reinterpret_cast<const float2*>(spec_s + fr * SLD + 8 * n + 2 * q);
            const float2 im01 =
                *reinterpret_cast<const float2*>(spec_s + fr * SLD + HALF_BINS + 8 * n + 2 * q);
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float re = (e ? re01.y : re01.x) + d[4 * n + 2 * hr + e];
              const float im = (e ? im01.y : im01.x) + d[4 * (n + 8) + 2 * hr + e];
              const float p = __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im));
              if (h == 0) {
                pw0[16 * hr + 2 * n + e] = p;
              } else {
                pw1[16 * hr + 2 * n + e] = p;
              }
            }
          }
        }
      }
      wg_sync(wg);  // the spectrum tile's writes seen, or its reads done before the next half
    }
  }

  // A is dead: the power rows go over it, frame f at row f + 2 (frames -2, -1 dropped)
  float* power_s = a_s + 2 * PLD;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int fr = ra + 8 * hr - 2;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      *reinterpret_cast<float2*>(power_s + fr * PLD + 8 * n + 2 * q) =
          make_float2(pw0[16 * hr + 2 * n], pw0[16 * hr + 2 * n + 1]);
      *reinterpret_cast<float2*>(power_s + fr * PLD + HALF_BINS + 8 * n + 2 * q) =
          make_float2(pw1[16 * hr + 2 * n], pw1[16 * hr + 2 * n + 1]);
    }
  }
  wg_sync(wg);

  mbar_wait(fb_full, 0);
  const long clip_stride = static_cast<long>(p_pad) * 4 * NMEL;
  mel::mel_log_store<PLD, 128>(power_s, fb_s, FRAMES_WG, 0, FRAMES_WG, FRAMES_WG, wtid,
                               [&](int fl, int m, float v) {
                                 const long row = r0 + fl;
                                 if (row >= rows) return;
                                 const long clip = row / hops_per_clip;
                                 const long f = row - clip * hops_per_clip;
                                 if (f < usable) out[clip * clip_stride + f * NMEL + m] = v;
                               });

  // the pad rows of the clip whose first pad frame is one of these frames
  const long first_pad = r0 - usable;  // clip c's first pad frame is row c H + usable
  for (long clip = first_pad <= 0 ? 0 : (first_pad + hops_per_clip - 1) / hops_per_clip;
       clip < b && clip * hops_per_clip + usable < r0 + FRAMES_WG; ++clip) {
    float* pad = out + clip * clip_stride + static_cast<long>(usable) * NMEL;
    for (int i = wtid; i < (4 * p_pad - usable) * NMEL; i += 128) pad[i] = 0.0f;
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// the flat hop-row view exists (TMA loads it) when a clip is a whole number
// of hops and the audio is 16-byte aligned; otherwise plain loads (the rule
// of melspec_kernel.fat_load_path)
bool tma_path(const void* audio, int t) {
  return t % HOP == 0 && reinterpret_cast<uintptr_t>(audio) % 16 == 0;
}

// statuses of their own, past CUDA's error codes
constexpr int NO_ENCODER = 10001;
constexpr int ENCODE_FAILED = 10002;

template <int TERMS>
int launch(const void* audio, const void* blocks, const void* fb, void* out, int b, int t, int usable,
           int p_pad, void* stream) {
  const long rows = static_cast<long>(b) * (t / HOP);
  const int tma = tma_path(audio, t);
  CUtensorMap map = {};
  if (tma) {
    EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return NO_ENCODER;
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(HOP), static_cast<cuuint64_t>(rows)};
    const cuuint64_t strides[1] = {HOP * sizeof(float)};
    const cuuint32_t box[2] = {A_BOX, ROWS_WG};
    const cuuint32_t steps[2] = {1, 1};
    const CUresult res = encode(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(audio),
                                dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
                                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (res != CUDA_SUCCESS) return ENCODE_FAILED;
  }
  cudaError_t err = cudaFuncSetAttribute(mel_patches_fat_kernel<TERMS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(SMEM_BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long grid = (rows + FRAMES_CTA - 1) / FRAMES_CTA;
  const unsigned char* ops = static_cast<const unsigned char*>(blocks) + HOP * NBLK * 2 * NBIN * sizeof(float);
  mel_patches_fat_kernel<TERMS><<<static_cast<unsigned>(grid), FAT_THREADS, SMEM_BYTES,
                                  static_cast<cudaStream_t>(stream)>>>(
      map, static_cast<const float*>(audio), ops, static_cast<const float*>(fb),
      static_cast<float*>(out), b, t, usable, p_pad, tma);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int mel_patches_fat_smem_bytes() { return static_cast<int>(SMEM_BYTES); }

// the split DFT, fp16 pairs (K1b)
extern "C" int mel_patches_fat_launch(const void* audio, const void* blocks, const void* fb, void* out,
                                      int b, int t, int usable, int p_pad, void* stream) {
  return launch<3>(audio, blocks, fb, out, b, t, usable, p_pad, stream);
}

// the bf16 DFT, bf16(x) bf16(b) alone (dft_dtype=bfloat16)
extern "C" int mel_patches_fat_bf16_launch(const void* audio, const void* blocks, const void* fb,
                                           void* out, int b, int t, int usable, int p_pad,
                                           void* stream) {
  return launch<1>(audio, blocks, fb, out, b, t, usable, p_pad, stream);
}
