"""The formant planner's batch path (``DeviceFormantPlanner.plan_batch``)
against the JAX package's one-clip planner, bit for bit: every track, the
noise table, the length, scales and clip seed of each clip, the host
fallbacks at the same indices; a clip planned alone, first or last of a
batch alike; ``DeviceFormantTTS.plan_batch``'s items, counters and spans."""

import numpy as np
import pytest
import torch

from heybuddy_tpu.models import formant_device as jax_fd
from heybuddy_tpu_torch.constants import DEFAULT_TTS_LENGTH_SCALES, DEFAULT_TTS_NOISE_SCALES
from heybuddy_tpu_torch.models import formant_device, tts

# positive phrase-augmented texts, adversarial-style words, nasals on both
# sides of vowels, a clip with no voiced segment, one with no phones
TEXTS = [
    "hey buddy", "hey buddy. explain", "hey buddy. play", "hey buddy, what time is it",
    "hay bunny", "hey body", "buddy", "hey daddy", "hi money", "hey mommy", "a penny",
    "hey nina", "hey ninny", "hello bud", "heyo", "honey bunny", "okay computer", "shh",
    "the quick fox", "thanks buddy", "",
]
TOO_LONG = "she sells sea shells by the sea shore and the quick brown fox jumps"
NOISY = "pst pst pst pst pst pst pst"   # 28 noise segments in 1.7 s at length scale 0.75
N_CLIPS = 130                           # five chunks of the knot grid, the last of two
LONG_AT, NOISY_AT = 50, 77


@pytest.fixture(autouse=True)
def simple_phonemizer(monkeypatch):
    monkeypatch.setenv("HEYBUDDY_PHONEMIZER", "simple")


def _clips():
    """(text, speaker id, length scale, noise scale, seed, blended voice) of each clip."""
    host = formant_device.DeviceFormantPlanner().synth
    clips = []
    for j in range(N_CLIPS):
        s1, s2 = (j * 37) % 904, (j * 101 + 5) % 904
        weight = (0.0, 0.25, 0.5, 0.75)[j % 4]
        clips.append((TEXTS[j % len(TEXTS)], s1 * 104729 + s2, DEFAULT_TTS_LENGTH_SCALES[j % 4],
                      DEFAULT_TTS_NOISE_SCALES[(j // 4) % 2], 4242 * 31 + j,
                      tts._blend_speaker_params(host, s1, s2, weight)))
    clips[LONG_AT] = (TOO_LONG, 7, 1.5, 0.667, 99, None)
    clips[NOISY_AT] = (NOISY, 8, 0.75, 1.0, 98, (120.0, 1.0))
    return clips


def _batch(planner, clips):
    return planner.plan_batch(*(list(column) for column in zip(*clips)))


def _assert_same(got, ref):
    assert (got is None) == (ref is None)
    if ref is None:
        return
    for key in ("length", "scale", "noise_scale", "clip_seed"):
        assert getattr(got, key) == getattr(ref, key), key
    assert got.tracks.dtype == ref.tracks.dtype == np.float32 and got.tracks.shape == ref.tracks.shape
    for k in range(ref.tracks.shape[0]):
        np.testing.assert_array_equal(got.tracks[k], ref.tracks[k], err_msg=f"track {k}")
    assert got.noise_table.dtype == np.float32
    np.testing.assert_array_equal(got.noise_table, ref.noise_table)


@pytest.fixture(scope="module")
def planned():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HEYBUDDY_PHONEMIZER", "simple")
        clips = _clips()
        ref = jax_fd.DeviceFormantPlanner()
        refs = [ref.plan(text, speaker=speaker, length_scale=ls, noise_scale=ns, seed=seed, speaker_params=params)
                for text, speaker, ls, ns, seed, params in clips]
        return clips, _batch(formant_device.DeviceFormantPlanner(), clips), refs


def test_batch_plans_bit_equal_jax(planned):
    clips, got, refs = planned
    assert len(got) == len(refs) == N_CLIPS
    for j, (g, r) in enumerate(zip(got, refs)):
        try:
            _assert_same(g, r)
        except AssertionError as err:
            raise AssertionError(f"clip {j} {clips[j][0]!r}: {err}") from None


def test_fallbacks_land_at_the_same_indices(planned):
    clips, got, refs = planned
    assert [j for j, r in enumerate(refs) if r is None] == [j for j, g in enumerate(got) if g is None]
    assert got[LONG_AT] is None and got[NOISY_AT] is None
    assert all(got[j] is None for j, c in enumerate(clips) if c[0] == "")
    assert sum(g is not None for g in got) >= 120


def test_the_batch_covers_every_track_feature(planned):
    """The batch holds nasals and nasal ramps, a clip with no control point
    and aspirations, so each batched path is exercised."""
    _, got, _ = planned
    plans = [g for g in got if g is not None]
    assert any(np.any((p.tracks[6] > 0) & (p.tracks[6] < 1)) for p in plans)   # a vowel's nasal ramp
    assert any(np.any(p.tracks[6] == 1) for p in plans)                        # a nasal
    assert any(np.all(p.tracks[2] == np.float32(500.0)) for p in plans)        # "shh": no voiced point
    assert any(p.noise_table[:, 3].max() == 1.0 for p in plans)               # an aspiration


@pytest.mark.parametrize("j", [0, 3, 13, 17, 64, 129])
def test_a_plan_is_the_same_alone_first_and_last(planned, j):
    clips, got, refs = planned
    planner = formant_device.DeviceFormantPlanner()
    text, speaker, ls, ns, seed, params = clips[j]
    alone = planner.plan(text, speaker=speaker, length_scale=ls, noise_scale=ns, seed=seed, speaker_params=params)
    others = [c for i, c in enumerate(clips) if i != j][:127]
    first = _batch(planner, [clips[j]] + others)[0]
    last = _batch(planner, others + [clips[j]])[127]
    for plan in (alone, first, last):
        _assert_same(plan, refs[j])
    _assert_same(got[j], refs[j])


def test_the_g2p_runs_once_for_each_distinct_word(monkeypatch):
    planner = formant_device.DeviceFormantPlanner()
    words = []
    original = planner.synth.phonemizer.word_phones
    monkeypatch.setattr(planner.synth.phonemizer, "word_phones", lambda w: words.append(w) or original(w))
    texts = ["hey buddy", "hey body", "hey buddy", "buddy hey"]
    n = len(texts)
    _batch(planner, list(zip(texts, range(n), [1.0] * n, [0.667] * n, range(n), [None] * n)))
    assert sorted(words) == ["body", "buddy", "hey"]
    _batch(planner, list(zip(texts, range(n), [1.0] * n, [0.667] * n, range(n), [None] * n)))
    assert len(words) == 6   # a lexicon of the call, not one kept across calls


def _tts_call(model, texts):
    speakers = [(j * 7 % 904, j * 13 % 904) for j in range(len(texts))]
    return model.plan_batch(texts, speakers, 0.25, 1.5, 0.667, 0.8, 321)


def test_tts_plan_batch_items_in_order():
    model = tts.DeviceFormantTTS(device="cpu")
    texts = ["hey buddy", TOO_LONG, "hay bunny", "hey buddy", NOISY, "hey body"]
    items = _tts_call(model, texts)
    assert len(items) == len(texts)
    plans = [it for it in items if isinstance(it, formant_device.ClipPlan)]
    assert len({id(p) for p in plans}) == len(plans) == 4
    assert isinstance(items[1], np.ndarray) and items[1].dtype == np.float32
    for j, (text, item) in enumerate(zip(texts, items)):
        s1, s2 = j * 7 % 904, j * 13 % 904
        voice = dict(speaker=s1 * 104729 + s2, length_scale=1.5, noise_scale=0.667, seed=321 * 31 + j,
                     speaker_params=tts._blend_speaker_params(model._host, s1, s2, 0.25))
        if isinstance(item, np.ndarray):
            np.testing.assert_array_equal(item, model._host.synthesize(text, **voice))
        else:
            _assert_same(item, model.planner.plan(text, **voice))


def test_tts_counters_add_up():
    model = tts.DeviceFormantTTS(device="cpu")
    assert model.clips_planned == model.clips_host_fallback == 0
    batches = [["hey buddy", TOO_LONG, "hay bunny"], ["hey body"] * 5, [TOO_LONG, NOISY]]
    items = [it for texts in batches for it in _tts_call(model, texts)]
    fallback = sum(isinstance(it, np.ndarray) for it in items)
    assert model.clips_host_fallback == fallback >= 2
    assert model.clips_planned + model.clips_host_fallback == len(items) == 10


def test_plan_spans_inside_formant_plan():
    model = tts.DeviceFormantTTS(device="cpu")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _tts_call(model, ["hey buddy", "hay bunny"])
    ranges = {e.name: e.time_range for e in prof.events() if e.name.startswith("formant/plan")}
    assert set(ranges) == {"formant/plan", "formant/plan/segments", "formant/plan/tracks"}
    outer = ranges["formant/plan"]
    for name in ("formant/plan/segments", "formant/plan/tracks"):
        assert outer.start <= ranges[name].start and ranges[name].end <= outer.end
    assert ranges["formant/plan/segments"].end <= ranges["formant/plan/tracks"].start
