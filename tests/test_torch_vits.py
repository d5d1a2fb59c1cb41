"""The port's VITS (``models/vits``, ``ops/monotonic_align.py``, ``text/piper_maps.py``,
``VitsTTS``) against the JAX package's on the CPU, at the tiny configurations of
tests/test_vits_training.py and tests/test_tts.py. JAX's parameter trees reach the port
through ``Vits.from_jax_params``; JAX's random draws are injected. Also the round trip
JAX tree -> port -> ``state_dict()`` as a Piper ``.pt`` -> JAX's ``import_torch_checkpoint``."""

import functools
import io
import os
import tempfile
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heybuddy_tpu.models import tts as jax_tts
from heybuddy_tpu.models.vits import modules as jm
from heybuddy_tpu.models.vits import synthesizer as js
from heybuddy_tpu.models.vits import training as jt
from heybuddy_tpu.models.vits.transforms import rational_quadratic_spline as jax_spline
from heybuddy_tpu.ops import monotonic_align as jax_ma
from heybuddy_tpu.text import piper_maps as jax_maps
from heybuddy_tpu_torch.cli import main as cli_main
from heybuddy_tpu_torch.data import space
from heybuddy_tpu_torch.models import featurizer, tts
from heybuddy_tpu_torch.models.vits import modules as pm
from heybuddy_tpu_torch.models.vits import synthesizer as ps
from heybuddy_tpu_torch.models.vits import training as pt
from heybuddy_tpu_torch.models.vits.transforms import rational_quadratic_spline
from heybuddy_tpu_torch.ops import monotonic_align as ma
from heybuddy_tpu_torch.text import piper_maps
from torch_fixtures import perturbed_vits

TINY = dict(n_speakers=4, gin_channels=16, n_layers=2, hidden_channels=64, filter_channels=128,
            inter_channels=64, upsample_initial_channel=64)
# float32 on both sides, the same arithmetic in another summation order (measured at most 2.0e-6
# on the modules, 5.2e-6 on the bare spline of standard-normal bin logits, 3.7e-8 on infer's audio)
ATOL = 1e-5


def t(x, dtype=torch.float32):
    return torch.from_numpy(np.asarray(x)).to(dtype)


def close(got, want, atol=ATOL, rtol=0.0):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol)


def trees(cfg, seed=0, sdp_posterior=False):
    """(JAX's tree, the port's Vits) on one seeded parameter set: the port's init_params, perturbed,
    through ``Vits.from_jax_params`` and, as a Piper .pt, JAX's ``import_torch_checkpoint`` (which
    adds its ``Static`` leaves; JAX's own seeded init compiles for some 20 s on the CPU). With
    ``sdp_posterior`` the SDP's posterior flows are in both, as JAX's tree's ``dp_posterior``."""
    cfg_p = ps.VitsConfig(**cfg)
    gen = torch.Generator().manual_seed(seed)
    tree = ps.init_params(gen, cfg_p)
    if sdp_posterior:
        tree["dp_posterior"] = pt.sdp_posterior_init(gen, cfg_p.hidden_channels)
    tree = perturbed_vits(tree, seed + 7)
    model = ps.Vits.from_jax_params(tree, cfg_p, device="cpu")
    buf = io.BytesIO()
    torch.save(model.state_dict(), buf)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "voice.pt")
        with open(path, "wb") as f:
            f.write(buf.getvalue())
        return js.import_torch_checkpoint(path, js.VitsConfig(**cfg)), model


@pytest.fixture(scope="module")
def tiny():
    params, model = trees(TINY)
    return js.VitsConfig(**TINY), ps.VitsConfig(**TINY), params, model


def masks(rng, b, t_len, lengths):
    mask = np.zeros((b, 1, t_len), np.float32)
    for i, n in enumerate(lengths):
        mask[i, :, :n] = 1.0
    return mask


def test_conv1d_and_conv_transpose1d():
    rng = np.random.default_rng(0)
    conv = torch.nn.Conv1d(6, 6, 5, groups=3)
    x = rng.normal(size=(2, 6, 32)).astype(np.float32)
    p = {"w": jnp.asarray(conv.weight.detach().numpy()), "b": jnp.asarray(conv.bias.detach().numpy())}
    close(pm.conv1d(conv, t(x), padding=4, dilation=2, groups=3), jm.conv1d(p, x, padding=4, dilation=2, groups=3))
    for in_ch, out_ch, kernel, stride, padding in [(8, 4, 16, 8, 4), (6, 3, 8, 4, 2), (4, 2, 3, 1, 1)]:
        up = torch.nn.ConvTranspose1d(in_ch, out_ch, kernel)
        x = rng.normal(size=(2, in_ch, 20)).astype(np.float32)
        w = up.weight.detach().numpy()  # Piper's (in, out, k); JAX's flipped (out, in, k)
        p = {"w": jnp.asarray(np.flip(np.transpose(w, (1, 0, 2)), -1).copy()), "b": jnp.asarray(up.bias.detach())}
        close(pm.conv_transpose1d(up, t(x), stride, padding), jm.conv_transpose1d(p, x, stride, padding))


def test_channel_layernorm_and_generate_path():
    rng = np.random.default_rng(1)
    norm = pm.LayerNorm(12)
    with torch.no_grad():
        norm.gamma.copy_(t(rng.normal(size=12)))
        norm.beta.copy_(t(rng.normal(size=12)))
    x = rng.normal(size=(2, 12, 9)).astype(np.float32)
    p = {"g": jnp.asarray(norm.gamma.detach().numpy()), "b": jnp.asarray(norm.beta.detach().numpy())}
    close(norm(t(x)), jm.channel_layernorm(p, x))
    duration = np.ceil(rng.uniform(0, 4, (2, 1, 7))).astype(np.float32)
    mask = masks(rng, 2, 7, [7, 5])[:, :, None, :] * np.ones((2, 1, 20, 1), np.float32)
    np.testing.assert_array_equal(ps.generate_path(t(duration), t(mask)).numpy(),
                                  np.asarray(js.generate_path(duration, mask)))


@pytest.mark.parametrize("inverse", [False, True])
def test_rational_quadratic_spline(inverse):
    """Forward and inverse, inputs inside and outside the tails."""
    rng = np.random.default_rng(2)
    x = rng.uniform(-7, 7, (2, 3, 11)).astype(np.float32)
    w, h = (rng.normal(size=(2, 3, 11, 10)).astype(np.float32) for _ in range(2))
    d = rng.normal(size=(2, 3, 11, 9)).astype(np.float32)
    out, logdet = rational_quadratic_spline(t(x), t(w), t(h), t(d), inverse=inverse)
    ref_out, ref_logdet = jax_spline(x, w, h, d, inverse=inverse)
    close(out, ref_out)
    close(logdet, ref_logdet, rtol=1e-5)  # a log of the knots' ratios: 3.4e-6 relative measured


def test_wn_coupling_and_convflow(tiny):
    """WN, the coupling layer and the spline flow (with DDSConv) forward and reverse, as the flow
    and the SDP's flows hold them."""
    cfg_j, _, params, model = tiny
    rng = np.random.default_rng(3)
    b, tl = 2, 12
    mask = masks(rng, b, tl, [12, 9])
    g = rng.normal(size=(b, cfg_j.gin_channels, 1)).astype(np.float32)
    z = rng.normal(size=(b, cfg_j.inter_channels, tl)).astype(np.float32)
    layer_p, layer_j = model.flow.couplings()[0], params["flow"]["layers"][0]
    close(layer_p.enc(t(z[:, : cfg_j.hidden_channels]), t(mask), t(g)),
          jm.wn(layer_j["enc"], z[:, : cfg_j.hidden_channels], mask, g))
    for reverse in (False, True):
        close(layer_p(t(z), t(mask), t(g), reverse=reverse),
              jm.residual_coupling_layer(layer_j, z, mask, g=g, reverse=reverse))
    cf_p, cf_j = model.dp.flows[1], params["dp"]["flows"][1]["convflow"]
    x2 = rng.normal(size=(b, 2, tl)).astype(np.float32)
    cond = rng.normal(size=(b, cfg_j.hidden_channels, tl)).astype(np.float32)
    for reverse in (False, True):
        got, got_logdet = cf_p(t(x2), t(mask), t(cond), reverse=reverse)
        want, want_logdet = jm.convflow(cf_j, x2, mask, g=cond, reverse=reverse)
        close(got, want)
        if not reverse:
            close(got_logdet, want_logdet)


def test_text_encoder_flow_generator(tiny):
    """The attention encoder (relative positions, window 4), the flow both ways and HiFiGAN."""
    cfg_j, _, params, model = tiny
    rng = np.random.default_rng(4)
    ids = rng.integers(3, 40, (2, 13))
    mask = masks(rng, 2, 13, [13, 6])
    for got, want in zip(model.enc_p(t(ids, torch.long), t(mask)),
                         js.text_encoder(params["enc_p"], jnp.asarray(ids), mask, cfg_j.hidden_channels)):
        close(got, want)
    z = rng.normal(size=(2, cfg_j.inter_channels, 10)).astype(np.float32)
    y_mask = masks(rng, 2, 10, [10, 7])
    g = rng.normal(size=(2, cfg_j.gin_channels, 1)).astype(np.float32)
    close(model.flow.reverse(t(z), t(y_mask), t(g)), js.residual_coupling_reverse(params["flow"], z, y_mask, g))
    close(model.flow(t(z), t(y_mask), t(g)), jt.residual_coupling_forward(params["flow"], z, y_mask, g))
    close(model.dec(t(z), t(g)), js.generator(params["dec"], z, g, cfg_j))


def test_duration_predictors(tiny):
    """The SDP's reverse pass with JAX's noise, and the deterministic predictor."""
    cfg_j, cfg_p, params, model = tiny
    rng = np.random.default_rng(5)
    h = rng.normal(size=(2, cfg_j.hidden_channels, 11)).astype(np.float32)
    mask = masks(rng, 2, 11, [11, 8])
    g = rng.normal(size=(2, cfg_j.gin_channels, 1)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    noise = np.asarray(jax.random.normal(key, (2, 2, 11)))
    close(model.dp.reverse(t(h), t(mask), t(g), t(noise), 0.8),
          js.stochastic_duration_reverse(params["dp"], key, h, mask, g, jnp.float32(0.8)))
    params_n, model_n = trees(dict(TINY, use_sdp=False), seed=1)
    assert not model_n.sdp
    close(model_n.dp(t(h), t(mask), t(g)), js.duration_predictor(params_n["dp"], h, mask, g))


@pytest.mark.parametrize("use_sdp", [True, False])
def test_infer_matches_jax(use_sdp):
    """infer (tests/test_tts.py's configuration, perturbed weights so that the flow reverse and the
    SDP's spline are not identities) with JAX's two noise draws: lengths equal, audio 1e-5."""
    cfg = dict(n_speakers=4, gin_channels=32, n_layers=1, hidden_channels=96, filter_channels=192,
               upsample_initial_channel=128, use_sdp=use_sdp)
    cfg_j, cfg_p = js.VitsConfig(**cfg), ps.VitsConfig(**cfg)
    params, model = trees(cfg)
    ids = np.random.default_rng(0).integers(3, 50, (2, 16)).astype(np.int32)
    lengths = np.asarray([16, 10], np.int32)
    spk = np.asarray(params["emb_g"])[[0, 1]]
    key = jax.random.PRNGKey(1)
    audio, audio_lengths = jax.jit(functools.partial(js.infer, max_frames=64, config=cfg_j))(
        params, key, ids, lengths, spk)
    k_dur, k_noise = jax.random.split(key)
    with torch.no_grad():
        got, got_lengths = model.infer(
            t(ids, torch.long), t(lengths, torch.int32), t(spk), max_frames=64,
            noise_dur=t(jax.random.normal(k_dur, (2, 2, 16))),
            noise_prior=t(jax.random.normal(k_noise, (2, cfg_j.inter_channels, 64))))
    np.testing.assert_array_equal(got_lengths.numpy(), np.asarray(audio_lengths))
    assert got.shape == (2, 64 * cfg_p.hop_samples)
    close(got, audio)


def test_maximum_path_bit_exact():
    """The port's C++ library and numpy DP against JAX's native DP and its numpy DP, batched with padding."""
    rng = np.random.default_rng(2)
    for sizes, (max_tx, max_ty) in [([(4, 20), (10, 40), (2, 7), (1, 1)], (10, 40)), ([(9, 30)], (9, 30))]:
        value = rng.normal(size=(len(sizes), max_tx, max_ty)).astype(np.float32)
        mask = np.zeros_like(value)
        for b, (tx, ty) in enumerate(sizes):
            mask[b, :tx, :ty] = 1.0
        native = ma.maximum_path(value, mask)
        np.testing.assert_array_equal(native, jax_ma.maximum_path(value, mask))
        np.testing.assert_array_equal(native, ma.maximum_path_plain(value, mask))
        for b, (tx, ty) in enumerate(sizes):
            expected = jax_ma._maximum_path_numpy((value * mask)[b, :tx, :ty], tx, ty)
            np.testing.assert_array_equal(native[b, :tx, :ty], expected)
    assert os.path.basename(ma.library_path()).startswith("monotonic_align_")


def test_piper_maps_equal_jax():
    assert piper_maps.piper_phoneme_id_map() == jax_maps.piper_phoneme_id_map()
    assert piper_maps.piper_speaker_id_map() == jax_maps.piper_speaker_id_map()
    assert len(piper_maps.piper_speaker_id_map()) == 904


def test_vits_tts_phonemize_slerp_and_batches(tmp_path, monkeypatch):
    """VitsTTS on the CPU: phonemize_ids and _slerp as JAX's, the batch layout (t_x bucket of 16 and
    the max_frames formula), a seeded synthesis, and HEYBUDDY_TTS_CHECKPOINT through the importer."""
    monkeypatch.delenv("HEYBUDDY_TTS_CHECKPOINT", raising=False)
    port = tts.VitsTTS(device="cpu")
    ref = types.SimpleNamespace(phonemizer=port.phonemizer, phoneme_id_map=jax_maps.piper_phoneme_id_map())
    for text in ("hey buddy", "turn on the lights, please", "okay computer"):
        assert port.phonemize_ids(text) == jax_tts.VitsTTS.phonemize_ids(ref, text)
    rng = np.random.default_rng(6)
    a, b = rng.normal(size=(3, 512)), rng.normal(size=(3, 512))
    for w in (0.0, 0.3, 1.0):
        np.testing.assert_array_equal(port._slerp(a, b, w), jax_tts.VitsTTS._slerp(None, a, b, w))
    np.testing.assert_array_equal(port._slerp(a, a, 0.5), jax_tts.VitsTTS._slerp(None, a, a, 0.5))
    texts = ["hey buddy", "what time is it"]
    ids, lengths, spk, max_frames = port.batch_inputs(texts, [(0, 1), (2, 3)], 0.5, 1.2)
    assert ids.shape[1] % 16 == 0 and ids.shape[1] >= lengths.max()
    assert max_frames == int(np.ceil(ids.shape[1] * 2 * 1.2 / 64) * 64)
    clips = port.synthesize_batch(texts, [(0, 1), (2, 3)], 0.5, 1.0, 0.667, 0.8, seed=3)
    again = port.synthesize_batch(texts, [(0, 1), (2, 3)], 0.5, 1.0, 0.667, 0.8, seed=3)
    assert [len(c) % port.config.hop_samples for c in clips] == [0, 0]
    for c, d in zip(clips, again):
        np.testing.assert_array_equal(c, d)
    ckpt = str(tmp_path / "voice.pt")
    torch.save(port.model.state_dict(), ckpt)
    monkeypatch.setenv("HEYBUDDY_TTS_CHECKPOINT", ckpt)
    loaded = tts.VitsTTS(device="cpu")
    for (k, v), w in zip(loaded.model.state_dict().items(), port.model.state_dict().values()):
        assert torch.equal(v, w), k


def weight_normed(state, layout):
    """Every conv weight of a state dict as weight norm (g = ||w|| over all but dim 0, v = w)."""
    out = {}
    for key, value in state.items():
        if key.endswith(".weight") and value.ndim == 3:
            prefix = key[: -len(".weight")]
            g = np.sqrt((value ** 2).sum(axis=(1, 2), keepdims=True)).astype(np.float32)
            names = ((".weight_g", ".weight_v") if layout == "weight_g" else
                     (".parametrizations.weight.original0", ".parametrizations.weight.original1"))
            out[prefix + names[0]], out[prefix + names[1]] = torch.from_numpy(g), torch.from_numpy(value.copy())
        else:
            out[key] = torch.from_numpy(np.array(value))
    return out


def jax_leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


@pytest.mark.parametrize("use_sdp", [True, False])
def test_state_dict_round_trip_through_jax_import(tmp_path, use_sdp):
    """JAX tree -> port -> state_dict() as .pt -> JAX's import_torch_checkpoint: equal bit for bit
    (both name mappings at once), the SDP's posterior flows included. The weight-norm layouts and
    .safetensors: the port's import equals JAX's bit for bit, and both fold back within 1e-6."""
    cfg = dict(TINY, use_sdp=use_sdp)
    cfg_j, cfg_p = js.VitsConfig(**cfg), ps.VitsConfig(**cfg)
    tree, _ = trees(cfg, sdp_posterior=use_sdp)
    model = ps.Vits.from_jax_params(tree, cfg_p, device="cpu")
    assert model.sdp == use_sdp and (not use_sdp or model.dp.has_posterior)
    path = str(tmp_path / "voice.pt")
    torch.save(model.state_dict(), path)
    back = js.import_torch_checkpoint(path, cfg_j)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for got, want in zip(jax_leaves(back), jax_leaves(tree)):
        np.testing.assert_array_equal(got, want)
    # the layout of JAX's own init (traced, not run): the same tree, leaf for leaf in shape
    init = jax.eval_shape(functools.partial(js.init_params, config=cfg_j), jax.random.PRNGKey(0))
    main = {k: v for k, v in back.items() if k != "dp_posterior"}
    assert jax.tree_util.tree_structure(main) == jax.tree_util.tree_structure(init)
    assert [x.shape for x in jax_leaves(main)] == [x.shape for x in jax.tree_util.tree_leaves(init)]
    reloaded = ps.import_torch_checkpoint(path, cfg_p, device="cpu")
    for (k, v), w in zip(reloaded.state_dict().items(), model.state_dict().values()):
        assert torch.equal(v, w), k

    state = {k: v.numpy() for k, v in model.state_dict().items()}
    for layout in ("weight_g", "parametrizations"):
        variant = str(tmp_path / f"{layout}.pt")
        torch.save({"model": weight_normed(state, layout)}, variant)
        port_state = ps.import_torch_checkpoint(variant, cfg_p, device="cpu").state_dict()
        jax_state = ps.jax_params_to_state(js.import_torch_checkpoint(variant, cfg_j))
        assert set(port_state) == set(jax_state)
        for k, v in port_state.items():
            np.testing.assert_array_equal(v.numpy(), jax_state[k])
            np.testing.assert_allclose(v.numpy(), state[k], rtol=1e-6, atol=1e-9)
    from safetensors.numpy import save_file

    st_path = str(tmp_path / "voice.safetensors")
    save_file(state, st_path)
    port_state = ps.import_torch_checkpoint(st_path, cfg_p, device="cpu").state_dict()
    for got, want in zip(jax_leaves(js.import_torch_checkpoint(st_path, cfg_j)), jax_leaves(tree)):
        np.testing.assert_array_equal(got, want)
    for k, v in port_state.items():
        np.testing.assert_array_equal(v.numpy(), state[k])


def test_cli_trains_on_the_vits_route(tmp_path, monkeypatch, capsys):
    """``train`` from an empty dataset directory with HEYBUDDY_TTS_CHECKPOINT naming a full-width
    Piper .pt: the backend resolves to vits, the caches hold exact, finite rows, and their sidecars
    name the checkpoint as the synthesis source."""
    data_dir = tmp_path / "data"
    for key, value in (("HEYBUDDY_OFFLINE", "1"), ("HEYBUDDY_PHONEMIZER", "simple"),
                       ("HEYBUDDY_DATASET_DIR", str(data_dir))):
        monkeypatch.setenv(key, value)
    for key in ("HEYBUDDY_TTS_BACKEND", "HEYBUDDY_EMBEDDING_ONNX"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setattr(tts, "_GLOBAL_TTS", {})
    monkeypatch.setattr(featurizer, "_GLOBAL_EMBEDDINGS", {})
    ckpt = str(tmp_path / "voice.pt")
    model = ps.Vits.from_jax_params(ps.init_params(torch.Generator().manual_seed(3)), device="cpu")
    torch.save(model.state_dict(), ckpt)
    monkeypatch.setenv("HEYBUDDY_TTS_CHECKPOINT", ckpt)
    argv = ["train", "hey buddy", "--device", "cpu", "--positive-samples", "4", "--adversarial-samples", "4",
            "--validation-samples", "2", "--testing-positive-samples", "0", "--testing-adversarial-samples", "0",
            "--steps", "3", "--stages", "1", "--positive-batch-size", "2", "--adversarial-batch-size", "2",
            "--training-no-default-dataset", "--adversarial-phrases", "4", "--num-batch-threads", "1",
            "--checkpoint-dir", str(tmp_path / "ckpt")]
    assert cli_main(argv) == 0
    assert capsys.readouterr().out.startswith("Training complete")
    assert isinstance(tts._GLOBAL_TTS[("vits", "cpu")], tts.VitsTTS)
    for name, n in {"hey-buddy": 4, "hey-buddy-adversarial": 4, "hey-buddy-testing-validation": 2}.items():
        data = np.load(str(data_dir / f"{name}.npy"))
        assert data.shape == (n, 16, 96) and np.isfinite(data).all(), name
        assert space.read_space_sidecar(str(data_dir / f"{name}.npy"))["tts"].startswith("vits:voice.pt;")
