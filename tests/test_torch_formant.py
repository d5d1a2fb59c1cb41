"""The port's formant TTS against the JAX package's: the host synthesizer and
the planner bit for bit, the device render with JAX's noise draws injected
(``jax.random`` cannot be reproduced in torch), batch independence, and the
render's log-mel agreement with the host synthesizer."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heybuddy_tpu.models import formant as jax_formant
from heybuddy_tpu.models import formant_device as jax_fd
from heybuddy_tpu.models import tts as jax_tts
from heybuddy_tpu.models import vad as jax_vad
from heybuddy_tpu_torch.models import formant, formant_device, tts, vad
from heybuddy_tpu_torch.ops.kernels.melspec_kernel import mel_spectrogram

L_MAX = 24000  # 1.5 s, as the JAX package's device-render tests: a quick CPU compile
# (text, speaker, seed, length scale, noise scale); "she sells sea shells" at
# 1.25 is too long for L_MAX and falls back to the host renderer in both
CASES = [
    ("hey buddy", 0, 1234, 1.0, 0.667),
    ("good morning", 13, 7, 0.75, 1.0),
    ("she sells sea shells", 26, 99, 1.25, 0.667),
    ("bunny", 39, 3, 1.5, 1.0),
    ("hay bunny", 52, 11, 1.0, 0.667),
    ("okay computer", 65, 5, 0.75, 0.667),
    ("hey buddy. play", 78, 42, 1.0, 1.0),
    ("the quick fox", 904 * 3 + 1, 8, 1.25, 0.667),
]


@pytest.fixture(autouse=True)
def simple_phonemizer(monkeypatch):
    monkeypatch.setenv("HEYBUDDY_PHONEMIZER", "simple")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: these tests run thousands of small eager ops, and
    the suite runs several workers on the machine's cores, where thread
    pools oversubscribe."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def planned():
    jp, pp = jax_fd.DeviceFormantPlanner(max_samples=L_MAX), formant_device.DeviceFormantPlanner(max_samples=L_MAX)
    pairs = []
    for text, speaker, seed, length_scale, noise_scale in CASES:
        kwargs = dict(speaker=speaker, seed=seed, length_scale=length_scale, noise_scale=noise_scale)
        pairs.append((jp.plan(text, **kwargs), pp.plan(text, **kwargs)))
    return pairs


def jax_clip_noise(seeds: np.ndarray, l_max: int):
    """The JAX render's per-clip breath and white draws (``_render_impl``'s ``_clip_noise``)."""
    def one(seed):
        key = jax.random.fold_in(jax.random.PRNGKey(0x600DF00D), seed)
        breath = jax.random.normal(jax.random.fold_in(key, 0), (l_max,), jnp.float32)
        white = jax.random.normal(jax.random.fold_in(key, 1), (l_max + formant_device.NOISE_FFT,), jnp.float32)
        return breath, white

    breath, white = jax.vmap(one)(jnp.asarray(seeds))
    return torch.from_numpy(np.array(breath)), torch.from_numpy(np.array(white))


def test_synthesizer_and_plans_bit_equal_jax(planned):
    host, ref_host = formant.FormantSynthesizer(), jax_formant.FormantSynthesizer()
    assert formant.FORMANT_VERSION == jax_formant.FORMANT_VERSION
    assert formant_device.DEVICE_FORMANT_VERSION == jax_fd.DEVICE_FORMANT_VERSION
    assert tts.SAMPLING_VERSION == jax_tts.SAMPLING_VERSION
    for (text, speaker, seed, length_scale, noise_scale), (ref, got) in zip(CASES, planned):
        kwargs = dict(speaker=speaker, seed=seed, length_scale=length_scale, noise_scale=noise_scale)
        audio = host.synthesize(text, **kwargs)
        np.testing.assert_array_equal(audio, ref_host.synthesize(text, **kwargs))
        assert audio.dtype == np.float32 and len(audio) > 4000
        blended = tts._blend_speaker_params(host, speaker, speaker + 1, 0.25)
        assert blended == jax_tts._blend_speaker_params(ref_host, speaker, speaker + 1, 0.25)
        np.testing.assert_array_equal(host.synthesize(text, speaker_params=blended, **kwargs),
                                      ref_host.synthesize(text, speaker_params=blended, **kwargs))
        assert (got is None) == (ref is None), text
        if got is None:
            continue
        for field in ("length", "scale", "noise_scale", "clip_seed"):
            assert getattr(got, field) == getattr(ref, field), field
        np.testing.assert_array_equal(got.tracks, ref.tracks)
        np.testing.assert_array_equal(got.noise_table, ref.noise_table)
    assert sum(p is None for _, p in planned) == 1
    for got, ref in zip(formant_device._dft_matrices(), jax_fd._dft_matrices()):
        np.testing.assert_array_equal(got, ref)


def test_render_with_jax_noise_matches_jax_render(planned):
    """The render's float32 arithmetic against JAX's on the same plans and
    draws. The limit: 3x the JAX render's own float32 error (its distance
    from the same render in float64), at most 1e-3 of the 0.7 peak. Measured
    here: port vs JAX 3.5e-4, JAX float32 vs float64 7.0e-4 (limit 7e-4):
    the Chebyshev recurrence over 100 harmonics carries each package's
    float32 sin / cos rounding on."""
    plans = [ref for ref, _ in planned if ref is not None]
    packed = jax_fd.pack_plans(plans, L_MAX)
    ref = np.asarray(jax_fd._jitted_render(L_MAX, jax_fd.DEFAULT_HARMONICS, 16000)(
        *(packed[k] for k in ("tracks", "table", "scale", "noise_scale", "length", "seeds"))))
    t = {k: torch.from_numpy(np.array(v)) for k, v in formant_device.pack_plans(plans, L_MAX).items()}
    breath, white = jax_clip_noise(packed["seeds"], L_MAX)
    args = (t["tracks"], t["table"], t["scale"], t["noise_scale"], t["length"], breath, white)
    got = formant_device.render(*args, l_max=L_MAX).numpy()
    exact = formant_device.render(*args, l_max=L_MAX, dtype=torch.float64).numpy()
    spread = float(np.abs(ref - exact).max())
    limit = min(3.0 * spread, 1e-3 * 0.7)
    err = float(np.abs(got - ref).max())
    assert got.shape == ref.shape == (len(plans), L_MAX) and got.dtype == np.float32
    assert err <= limit, (err, spread, limit)
    np.testing.assert_allclose(np.abs(got).max(axis=1), 0.7, atol=1e-6)
    for i, plan in enumerate(plans):
        assert not got[i, plan.length:].any()


def test_render_deterministic_and_batch_independent(planned):
    plans = [p for _, p in planned if p is not None]
    solo = formant_device.render_batch([plans[2]], l_max=L_MAX, device="cpu")[0]
    again = formant_device.render_batch([plans[2]], l_max=L_MAX, device="cpu")[0]
    in_batch = formant_device.render_batch(plans, l_max=L_MAX, device="cpu")[2]
    np.testing.assert_array_equal(solo, again)
    np.testing.assert_allclose(solo, in_batch, atol=1e-6)
    assert len(solo) == plans[2].length and solo.dtype == np.float32
    breath, white = formant_device.clip_noise(np.array([plans[2].clip_seed, 5]), L_MAX, "cpu")
    breath1, white1 = formant_device.clip_noise(np.array([plans[2].clip_seed]), L_MAX, "cpu")
    assert torch.equal(breath[:1], breath1) and torch.equal(white[:1], white1)
    assert not torch.equal(breath[0], breath[1])


def _logmel(audio: np.ndarray) -> np.ndarray:
    pad = np.zeros((1, 23040), np.float32)
    pad[0, : min(len(audio), 23040)] = audio[:23040]
    return mel_spectrogram(torch.from_numpy(pad * 32768.0))[0].numpy()


def test_render_log_mel_matches_host_synthesizer(planned):
    """The device render and the host synthesizer render the same plan: their
    log-mel frames correlate above 0.9 (the JAX package's bound)."""
    host = formant.FormantSynthesizer()
    cases = [(c, p) for c, (_, p) in zip(CASES, planned) if p is not None][:4]
    rendered = formant_device.render_batch([p for _, p in cases], l_max=L_MAX, device="cpu")
    for (text, speaker, seed, length_scale, noise_scale), dev in zip((c for c, _ in cases), rendered):
        ref = host.synthesize(text, speaker=speaker, seed=seed, length_scale=length_scale, noise_scale=noise_scale)
        assert len(dev) == len(ref)
        m_dev, m_host = _logmel(dev), _logmel(ref)
        active = (m_host.std(axis=-1) > 0.1) & (m_dev.std(axis=-1) > 0.1)
        assert active.sum() > 10
        corr = [np.corrcoef(m_dev[i], m_host[i])[0, 1] for i in np.flatnonzero(active)]
        assert np.mean(corr) > 0.9, (text, float(np.mean(corr)))


def test_device_tts_contract_on_the_cpu(monkeypatch):
    """``DeviceFormantTTS`` through the BaseTTS call: the grids and int16
    normalisation as JAX's; the plans (as_plans) equal to JAX's."""
    port = tts.DeviceFormantTTS(max_samples=L_MAX, harmonics=48, device="cpu")
    ref = jax_tts.DeviceFormantTTS(max_samples=L_MAX, harmonics=48)
    samples = port(["hey buddy", "hay bunny"], num_samples=3, batch_size=3, seed=11)
    assert [t for t, _ in samples] == [t for t, _ in ref(["hey buddy", "hay bunny"], num_samples=3, batch_size=3,
                                                       seed=11, as_plans=True)]
    for _, pcm in samples:
        assert pcm.dtype == np.int16 and len(pcm) > 2000 and np.abs(pcm).max() > 8000
    got = port(["hey buddy"], num_samples=4, batch_size=2, seed=3, as_plans=True, settings_offset=5)
    want = ref(["hey buddy"], num_samples=4, batch_size=2, seed=3, as_plans=True, settings_offset=5)
    for (t1, p1), (t2, p2) in zip(got, want):
        assert t1 == t2
        np.testing.assert_array_equal(p1.tracks, p2.tracks)
    # trim_silence cuts with the shared VAD (it raised while the VAD was not
    # ported): the energy VAD's trim of the untrimmed clip, as JAX's trims it
    monkeypatch.setattr(vad, "_GLOBAL_VAD", {})
    (_, pcm), = port(["hey buddy"], num_samples=1, seed=2)
    (_, trimmed), = port(["hey buddy"], num_samples=1, seed=2, trim_silence=True)
    want = jax_vad.EnergyVAD().trim(pcm.astype(np.float32) / 32768.0, threshold=0.05)
    np.testing.assert_array_equal(trimmed, np.clip(want * 32767.0, -32768, 32767).astype(np.int16))
    assert trimmed.dtype == np.int16 and 2000 < len(trimmed) <= len(pcm)
    if not torch.cuda.is_available():  # the VITS backend is ported; its default device is the card
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tts.VitsTTS()
