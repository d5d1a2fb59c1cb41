"""The formant render's voiced kernel (``csrc/formant_voiced.cu``).

On the CPU: a numpy emulation of the kernel's walk (each sample from its two
bracketing knots: the inline upsampling, the phase polynomial, the harmonic
loop with its exits at Nyquist and at a zero amplitude, every rounding point
written out in float32) against the plain loop ``_voiced_plain``, and the
render's dispatch (a CPU tensor takes the plain path, unchanged). On the card
(skipped without one): the kernel's render against the CPU's float32 render
from the same plans and draws. This file imports no JAX, so the card test
runs on a machine without it: ``python -m pytest --noconftest
tests/test_torch_formant_voiced.py``.
"""

import numpy as np
import pytest
import torch

from hbbench.reference import formant as frozen
from heybuddy_tpu_torch.models import formant_device as fd
from heybuddy_tpu_torch.ops.kernels import build

F32 = np.float32
# (text, speaker, seed, length scale, noise scale): a low and a high voice
CASES = [("hey buddy", 0, 1234, 1.0, 0.667), ("good morning", 13, 7, 0.75, 1.0)]
EMU_SAMPLES = 4800  # 75 knots: 18.75 blocks of 256 samples


@pytest.fixture(autouse=True)
def simple_phonemizer(monkeypatch):
    monkeypatch.setenv("HEYBUDDY_PHONEMIZER", "simple")


@pytest.fixture(autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def plans_for(cases, max_samples=fd.DEFAULT_MAX_SAMPLES):
    planner = fd.DeviceFormantPlanner(max_samples=max_samples)
    plans = [planner.plan(text, speaker=sp, seed=seed, length_scale=ls, noise_scale=ns)
             for text, sp, seed, ls, ns in cases]
    assert all(p is not None for p in plans)
    return plans


def emulate_voiced(tracks, scale, noise_scale, breath, consts, l_max, harmonics, sample_rate):
    """The kernel's walk in numpy float32, all samples at once: sample n of a
    clip reads knots k = n // 64 and k + 1 of its tracks, computes the
    upsampled tracks and its phase from them, and runs the harmonic loop
    until the first harmonic at or above Nyquist; a sample whose two
    amplitude knots are 0 runs no harmonic. sin / cos are torch's (the
    kernel's are the card's ``sinf`` / ``cosf``)."""
    n = np.arange(l_max)
    k, j = n // fd.TRACK_STRIDE, (n % fd.TRACK_STRIDE).astype(F32)
    frac = j * F32(1.0 / fd.TRACK_STRIDE)
    lo, hi = tracks[:, :, k], tracks[:, :, k + 1]

    def up(t):
        return lo[:, t] + (hi[:, t] - lo[:, t]) * frac

    s = scale[:, None]
    amp = up(5)
    b_noise = (breath * (F32(0.02) * noise_scale[:, None])) * amp
    f0, f1s, f2s, f3s, nasal, zs = up(0), up(2) * s, up(3) * s, up(4) * s, up(6), up(7) * s
    poly = lo[:, 0] * j + ((hi[:, 0] - lo[:, 0]) * (j * j)) * F32(1.0 / (2 * fd.TRACK_STRIDE))
    phase = torch.from_numpy(lo[:, 1] + consts[0] * poly)
    sin_h, two_cos = torch.sin(phase).numpy(), F32(2.0) * torch.cos(phase).numpy()
    inv_bw1 = F32(1.0) / ((F32(80.0) + F32(0.08) * f1s) + F32(160.0) * nasal)
    inv_bw2 = F32(1.0) / (F32(80.0) + F32(0.08) * f2s)
    inv_bw3 = F32(1.0) / (F32(80.0) + F32(0.08) * f3s)
    open_ = F32(1.0) - F32(0.35) * nasal
    g2, g3 = F32(0.6) * open_, F32(0.3) * open_
    nasal_gain, murmur, mur_center = F32(0.85) * nasal, F32(0.5) * nasal, F32(280.0) * s
    nyquist = F32(0.5 * sample_rate)

    def lorentz(num, x):
        return num / (x * x + F32(1.0))

    alive = (lo[:, 5] != 0) | (hi[:, 5] != 0)
    acc = np.zeros_like(amp)
    sin_prev = np.zeros_like(amp)
    for h in range(1, harmonics + 1):
        freq = F32(h) * f0
        alive &= freq < nyquist
        if not alive.any():
            break
        env = lorentz(F32(1.0), (freq - f1s) * inv_bw1)
        env = env + lorentz(g2, (freq - f2s) * inv_bw2)
        env = env + lorentz(g3, (freq - f3s) * inv_bw3)
        env = env * (F32(1.0) - lorentz(nasal_gain, (freq - zs) * F32(1.0 / 300.0)))
        env = env + lorentz(murmur, (freq - mur_center) * F32(1.0 / 120.0))
        acc = np.where(alive, acc + (env * consts[h]) * sin_h, acc)
        sin_prev, sin_h = sin_h, two_cos * sin_h - sin_prev
    return acc * amp + b_noise, alive


def test_kernel_walk_emulation_matches_plain_loop():
    """2 clips x 4,800 samples, a window of each clip's knots across its end
    (so samples past the length, with zero amplitude knots, are in it): the
    emulated walk equals the plain loop bit for bit, with the kernel's own
    constant table and exits; the exits are taken."""
    plans = plans_for(CASES)
    knots = EMU_SAMPLES // fd.TRACK_STRIDE + 1
    windows = []
    for p in plans:
        start = max(p.length // fd.TRACK_STRIDE - knots // 2, 0)
        windows.append(p.tracks[:, start:start + knots])
    tracks = np.stack(windows)
    scale = np.array([p.scale for p in plans], F32)
    noise_scale = np.array([p.noise_scale for p in plans], F32)
    breath = np.random.default_rng(5).standard_normal((len(plans), EMU_SAMPLES)).astype(F32)
    consts = fd._voiced_constants(fd.DEFAULT_HARMONICS, fd.SAMPLE_RATE, torch.device("cpu")).numpy()
    assert consts[0] == fd._c(2.0 * np.pi / fd.SAMPLE_RATE, torch.float32)
    assert all(consts[h] == fd._c(1.0 / np.sqrt(h), torch.float32) for h in range(1, fd.DEFAULT_HARMONICS + 1))

    got, _ = emulate_voiced(tracks, scale, noise_scale, breath, consts, EMU_SAMPLES, fd.DEFAULT_HARMONICS,
                            fd.SAMPLE_RATE)
    want = fd._voiced_plain(*(torch.from_numpy(a) for a in (tracks, scale, noise_scale, breath)),
                            l_max=EMU_SAMPLES, harmonics=fd.DEFAULT_HARMONICS, sample_rate=fd.SAMPLE_RATE,
                            dtype=torch.float32).numpy()
    assert got.shape == want.shape == (len(plans), EMU_SAMPLES)
    np.testing.assert_array_equal(got, want)
    # both exits were taken: silent samples, and voices whose top harmonic is below 100
    silent = (tracks[:, 5, :-1] == 0) & (tracks[:, 5, 1:] == 0)
    assert silent.any() and not silent.all()
    f0 = tracks[:, 0][tracks[:, 5] != 0]
    assert (fd.DEFAULT_HARMONICS * f0 >= 0.5 * fd.SAMPLE_RATE).any()


def packed_inputs(plans, l_max):
    packed = fd.pack_plans(plans, l_max)
    t = {k: torch.from_numpy(v) for k, v in packed.items() if k != "seeds"}
    breath, white = fd.clip_noise(packed["seeds"], l_max, "cpu")
    return (t["tracks"], t["table"], t["scale"], t["noise_scale"], t["length"], breath, white)


def test_cpu_render_takes_the_plain_path_unchanged():
    """A CPU tensor renders through ``_voiced_plain``: bit-equal to the
    render as it was written before the kernel (the benchmark's frozen copy
    of it), with no kernel launched; a device that is neither raises."""
    l_max = 24000
    plans = plans_for(CASES, l_max)
    args = packed_inputs(plans, l_max)
    before = sum(build.LAUNCHES.values())
    got = fd.render(*args, l_max=l_max)
    want = frozen.render(*args, l_max=l_max)
    assert sum(build.LAUNCHES.values()) == before
    assert torch.equal(got, want)
    assert torch.equal(fd.render(*args, l_max=l_max, dtype=torch.float64),
                       frozen.render(*args, l_max=l_max, dtype=torch.float64))
    with pytest.raises(ValueError, match="unsupported device"):
        fd.render(*(a.to("meta") for a in args), l_max=l_max)


def test_kernel_wrapper_refuses_mismatched_shapes():
    l_max = 1024
    tracks = torch.zeros((2, 8, l_max // fd.TRACK_STRIDE + 1))
    ok = dict(l_max=l_max, harmonics=10, sample_rate=fd.SAMPLE_RATE)
    with pytest.raises(ValueError, match="do not cover"):
        fd._voiced_kernel(tracks[:, :, :-1], torch.ones(2), torch.ones(2), torch.zeros((2, l_max)), **ok)
    with pytest.raises(ValueError, match="do not match"):
        fd._voiced_kernel(tracks, torch.ones(2), torch.ones(2), torch.zeros((2, l_max - 64)), **ok)


@pytest.mark.parametrize("case", ["batch8", "ragged"])
def test_render_on_the_card_matches_the_cpu(case):
    """The kernel's render on the card against the float32 render on the
    CPU, same plans and draws: 8 clips at 48,000 samples and 100 harmonics;
    and a ragged case (47,808 samples, not a multiple of the kernel's
    256-sample block; 37 harmonics; one clip one track step long). The
    limit is chip_smoke's: 3x the CPU's own float32-vs-float64 spread on
    those clips, at most 1e-3 of the 0.7 peak."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs on the card alone")
    dev = torch.device("cuda", 0)
    cases = [(text, 7 * i, 100 + i, 0.75 + 0.1 * i, 0.667) for i, text in
             enumerate(["hey buddy", "good morning", "bunny", "okay computer", "hay bunny", "play music",
                        "hey buddy stop", "the quick fox"])]
    plans = plans_for(cases)
    harmonics, l_max = fd.DEFAULT_HARMONICS, fd.DEFAULT_MAX_SAMPLES
    args = list(packed_inputs(plans, l_max))
    if case == "ragged":
        harmonics, l_max = 37, 47808
        args[0] = args[0][:, :, : l_max // fd.TRACK_STRIDE + 1].contiguous()
        args[4] = args[4].clone()
        args[4][3] = fd.TRACK_STRIDE
        args[5], args[6] = args[5][:, :l_max].contiguous(), args[6][:, : l_max + fd.NOISE_FFT].contiguous()
    kw = dict(l_max=l_max, harmonics=harmonics)
    cpu32 = fd.render(*args, **kw)
    cpu64 = fd.render(*args, **kw, dtype=torch.float64)
    before = build.LAUNCHES["formant_voiced"]
    card = fd.render(*(a.to(dev) for a in args), **kw)
    torch.cuda.synchronize()
    assert build.LAUNCHES["formant_voiced"] == before + 1
    with pytest.raises(ValueError, match="float32 alone"):
        fd.render(*(a.to(dev) for a in args), **kw, dtype=torch.float64)
    card = card.cpu()
    spread = float((cpu32.double() - cpu64).abs().max())
    err = float((card - cpu32).abs().max())
    assert err <= min(3.0 * spread, 1e-3 * 0.7), (err, spread)
    lengths = args[4]
    for i in range(len(plans)):
        assert not card[i, int(lengths[i]):].any()
    np.testing.assert_allclose(card.abs().amax(dim=1).numpy(), 0.7, atol=1e-5)
    # the voiced part alone against the plain loop on the card (the same sinf / cosf)
    dargs = [a.to(dev) for a in (args[0], args[2], args[3], args[5])]
    kernel = fd._voiced_kernel(*dargs, l_max=l_max, harmonics=harmonics, sample_rate=fd.SAMPLE_RATE)
    plain = fd._voiced_plain(*dargs, l_max=l_max, harmonics=harmonics, sample_rate=fd.SAMPLE_RATE,
                             dtype=torch.float32)
    assert float((kernel - plain).abs().max()) <= 1e-3 * 0.7 * float(plain.abs().max())
