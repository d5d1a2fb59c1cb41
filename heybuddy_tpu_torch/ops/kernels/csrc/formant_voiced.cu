// The formant render's voiced part for Hopper, sm_90a: the harmonic sum of
// models/formant_device.py::render in one pass.
//
// Replaces no pallas_call: the JAX package's render (_render_impl) is plain
// jnp that XLA fuses under jit. The port's eager loop over the harmonics
// (_voiced_plain) makes about 39 elementwise passes a harmonic over (B, l_max)
// float32 tensors; here every sample keeps its state across the harmonics in
// registers. In: the decimated tracks (B, 8, n_dec) (f0, phase, f1, f2, f3,
// amp, nasal, zero, one knot every 64 samples), the clip's scale and noise
// scale (B,), its breath draws (B, l_max) and a table of constants (the phase
// step 2 pi / sr, then 1 / sqrt(h) for h = 1..harmonics, each rounded to
// float32 on the host as the plain version rounds them). Out: the voiced
// signal (B, l_max), acc * amp + breath * (0.02 noise_scale) * amp.
//
// What bounds it: operations. About 38 float32 operations a (sample,
// harmonic), five of them IEEE divisions, against 4 bytes read and 4 written
// a sample besides the few knots: far above the card's fp32 ridge.
//
// Design: one thread a sample, 256 consecutive samples of one clip a block,
// so a warp's loads and stores coalesce and a warp's samples share their two
// bracketing knots (staged in shared memory once a block). The upsampling and
// the phase polynomial are computed inline from the two knots; the harmonic
// loop runs in registers. Every rounding point is the plain version's: the
// arithmetic is written with the _rn intrinsics, so nvcc contracts nothing
// into an FMA, and divisions and reciprocals are correctly rounded (no fast
// math, no approximate intrinsic). Two exits leave the value unchanged: the
// loop stops at the first harmonic at or above Nyquist (with f0 >= 0 every
// later frequency is too, and its gated term adds 0), and a sample whose two
// amplitude knots are 0 skips the loop (its acc is multiplied by an amp of
// exactly 0). The second is uniform across a warp (a warp's 32 samples lie
// in one run of 64 between two knots), the first nearly so (f0 moves little
// within a run).

#include <cuda_runtime.h>

namespace {

constexpr int STRIDE = 64;                 // TRACK_STRIDE: samples between knots
constexpr int THREADS = 256;               // samples a block
constexpr int KNOTS = THREADS / STRIDE + 1;
constexpr int TRACKS = 8;                  // f0, phase, f1, f2, f3, amp, nasal, zero
enum { F0, PHASE, F1, F2, F3, AMP, NASAL, ZERO };

// the float32 constants of the plain version (a double literal rounded once)
constexpr float C_BW = static_cast<float>(0.08);
constexpr float C_G2 = static_cast<float>(0.6);
constexpr float C_G3 = static_cast<float>(0.3);
constexpr float C_NASAL = static_cast<float>(0.35);
constexpr float C_ZERO_GAIN = static_cast<float>(0.85);
constexpr float C_BREATH = static_cast<float>(0.02);
constexpr float INV_300 = static_cast<float>(1.0 / 300.0);
constexpr float INV_120 = static_cast<float>(1.0 / 120.0);

// 1 / (x * x + 1) and num / (x * x + 1), as the plain version rounds them
__device__ __forceinline__ float lorentz(float x) { return __frcp_rn(__fadd_rn(__fmul_rn(x, x), 1.0f)); }
__device__ __forceinline__ float lorentz(float num, float x) {
  return __fdiv_rn(num, __fadd_rn(__fmul_rn(x, x), 1.0f));
}

__global__ void __launch_bounds__(THREADS)
formant_voiced_kernel(const float* __restrict__ tracks, const float* __restrict__ scale,
                      const float* __restrict__ noise_scale, const float* __restrict__ breath,
                      const float* __restrict__ consts, float* __restrict__ out, int tiles, int n_dec,
                      int l_max, int harmonics, float nyquist) {
  __shared__ float knot[TRACKS][KNOTS];
  const int clip = blockIdx.x / tiles;
  const int n0 = (blockIdx.x % tiles) * THREADS;
  const int k0 = n0 / STRIDE;
  if (threadIdx.x < TRACKS * KNOTS) {
    const int t = threadIdx.x / KNOTS, i = threadIdx.x % KNOTS;
    const int k = k0 + i;
    knot[t][i] = k < n_dec ? tracks[(static_cast<size_t>(clip) * TRACKS + t) * n_dec + k] : 0.0f;
  }
  __syncthreads();
  const int n = n0 + threadIdx.x;
  if (n >= l_max) return;
  const int kl = threadIdx.x / STRIDE;
  const float j = static_cast<float>(threadIdx.x % STRIDE);
  const float frac = __fmul_rn(j, 1.0f / STRIDE);  // exact
  // linear upsampling: a + (b - a) * frac
  auto up = [&](int t) {
    const float a = knot[t][kl];
    return __fadd_rn(a, __fmul_rn(__fsub_rn(knot[t][kl + 1], a), frac));
  };
  const float s = scale[clip];
  const float amp = up(AMP);
  const float b_noise = __fmul_rn(__fmul_rn(breath[static_cast<size_t>(clip) * l_max + n],
                                            __fmul_rn(C_BREATH, noise_scale[clip])), amp);
  float acc = 0.0f;
  if (knot[AMP][kl] != 0.0f || knot[AMP][kl + 1] != 0.0f) {
    const float f0 = up(F0);
    const float f1s = __fmul_rn(up(F1), s);
    const float f2s = __fmul_rn(up(F2), s);
    const float f3s = __fmul_rn(up(F3), s);
    const float nasal = up(NASAL);
    const float zs = __fmul_rn(up(ZERO), s);
    // the phase: the knot's, plus the linear f0 integrated over j samples
    const float f0a = knot[F0][kl];
    const float poly = __fadd_rn(__fmul_rn(f0a, j),
                                 __fmul_rn(__fmul_rn(__fsub_rn(knot[F0][kl + 1], f0a), __fmul_rn(j, j)),
                                           1.0f / (2 * STRIDE)));  // the division by 128 is exact
    const float phase = __fadd_rn(knot[PHASE][kl], __fmul_rn(consts[0], poly));

    const float inv_bw1 = __frcp_rn(__fadd_rn(__fadd_rn(80.0f, __fmul_rn(C_BW, f1s)), __fmul_rn(160.0f, nasal)));
    const float inv_bw2 = __frcp_rn(__fadd_rn(80.0f, __fmul_rn(C_BW, f2s)));
    const float inv_bw3 = __frcp_rn(__fadd_rn(80.0f, __fmul_rn(C_BW, f3s)));
    const float open = __fsub_rn(1.0f, __fmul_rn(C_NASAL, nasal));
    const float g2 = __fmul_rn(C_G2, open);
    const float g3 = __fmul_rn(C_G3, open);
    const float nasal_gain = __fmul_rn(C_ZERO_GAIN, nasal);
    const float murmur = __fmul_rn(0.5f, nasal);
    const float mur_center = __fmul_rn(280.0f, s);

    const float two_cos = __fmul_rn(2.0f, cosf(phase));
    float sin_h = sinf(phase);
    float sin_prev = 0.0f;
    for (int h = 1; h <= harmonics; ++h) {
      const float freq = __fmul_rn(static_cast<float>(h), f0);
      if (!(freq < nyquist)) break;  // this and every later harmonic gated to 0
      float env = lorentz(__fmul_rn(__fsub_rn(freq, f1s), inv_bw1));
      env = __fadd_rn(env, lorentz(g2, __fmul_rn(__fsub_rn(freq, f2s), inv_bw2)));
      env = __fadd_rn(env, lorentz(g3, __fmul_rn(__fsub_rn(freq, f3s), inv_bw3)));
      env = __fmul_rn(env, __fsub_rn(1.0f, lorentz(nasal_gain, __fmul_rn(__fsub_rn(freq, zs), INV_300))));
      env = __fadd_rn(env, lorentz(murmur, __fmul_rn(__fsub_rn(freq, mur_center), INV_120)));
      acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(env, __ldg(consts + h)), sin_h));
      const float next = __fsub_rn(__fmul_rn(two_cos, sin_h), sin_prev);
      sin_prev = sin_h;
      sin_h = next;
    }
  }
  out[static_cast<size_t>(clip) * l_max + n] = __fadd_rn(__fmul_rn(acc, amp), b_noise);
}

}  // namespace

// static shared memory only
extern "C" int formant_voiced_smem_bytes() { return 0; }

extern "C" int formant_voiced_launch(const void* tracks, const void* scale, const void* noise_scale,
                                     const void* breath, const void* consts, void* out, int b, int n_dec,
                                     int l_max, int harmonics, int sample_rate, void* stream) {
  const int tiles = (l_max + THREADS - 1) / THREADS;
  formant_voiced_kernel<<<b * tiles, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tracks), static_cast<const float*>(scale), static_cast<const float*>(noise_scale),
      static_cast<const float*>(breath), static_cast<const float*>(consts), static_cast<float*>(out), tiles, n_dec,
      l_max, harmonics, 0.5f * static_cast<float>(sample_rate));
  return static_cast<int>(cudaGetLastError());
}
