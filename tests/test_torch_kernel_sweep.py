"""K2's stage stand-ins and the kernel sweep's tool against the JAX package.

The port's plain K2 with each of the JAX sweep's ablation sets against JAX's
``fused_embedding_windows(..., interpret=True, ablate=...)`` on the same
numpy spectrogram; the build's variant keys; the tool's CPU rehearsal. The
CUDA variants run only on the card (``chip_smoke.py``'s sweep phase).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heybuddy_tpu.models import embedding_net as jax_net
from heybuddy_tpu.ops.melspec import mel_spectrogram as jax_mel_spectrogram
from heybuddy_tpu.ops.pallas.embedding_kernel import fused_embedding_windows as jax_fused_embedding_windows
from heybuddy_tpu.ops.windows import embedding_window_starts
from heybuddy_tpu_torch.convert import embedding_params_from_numpy
from heybuddy_tpu_torch.models import embedding_net as torch_net
from heybuddy_tpu_torch.ops.kernels import build
from heybuddy_tpu_torch.ops.kernels import embedding_kernel as ek
from heybuddy_tpu_torch.tools import kernel_perf_sweep as sweep

# the JAX suite's bound for a bf16 path (test_torch_embedding.BF16_PATH_TOL)
BF16_PATH_TOL = 0.05
# Without the grouped RMS a window's outputs are as large as its pooled rows
# (a window's rms up to about 25 instead of about 1), and the bf16 flips that
# part the two packages (exact erf here, a polynomial there, and another
# summation order) scale with them: on the production path they already
# reach 6.4% of a window's rms. Sets without the grouped RMS are held to
# 0.05 + 0.1 x the rms of the window's 96 outputs.
UNNORMALISED_WINDOW_RTOL = 0.1
CLIP = 23040


@pytest.fixture(scope="module")
def jax_params():
    return jax_net.default_params()


@pytest.fixture(scope="module")
def net():
    return embedding_params_from_numpy(torch_net.default_params())


@pytest.fixture(scope="module")
def spec():
    """A writable (2, 141, 32) float32 log-mel of seeded noise, by JAX's mel."""
    audio = np.random.default_rng(31).normal(0.0, 1000.0, (2, CLIP)).astype(np.float32)
    return np.array(jax_mel_spectrogram(jnp.asarray(audio)))


def test_the_sweep_runs_the_jax_scripts_sets():
    assert [label for label, _ in sweep.ABLATION_SETS] == [
        "ablate_softmax", "ablate_pool_rms", "ablate_trunk_rms", "ablate_gelu", "ablate_posp",
        "ablate_trunk", "ablate_pool_mm", "ablate_head_mm", "ablate_noop", "ablate_all_vpu",
        "ablate_all_mm_but_trunk"]
    assert set().union(*(s for _, s in sweep.ABLATION_SETS)) == set(ek.ABLATIONS)


@pytest.mark.parametrize("label,ablate", sweep.ABLATION_SETS, ids=[label for label, _ in sweep.ABLATION_SETS])
def test_ablated_plain_matches_jax(jax_params, net, spec, label, ablate):
    starts = embedding_window_starts(CLIP)
    ref = np.asarray(jax_fused_embedding_windows(jax_params, jnp.asarray(spec), starts, interpret=True,
                                                 ablate=ablate))
    got = ek.fused_embedding_windows(net, torch.from_numpy(spec), starts, ablate=ablate).numpy()
    assert got.shape == ref.shape == (2, len(starts), 96)
    assert np.isfinite(got).all()
    window_rms = np.sqrt((ref**2).mean(axis=2, keepdims=True))
    limit = BF16_PATH_TOL + (UNNORMALISED_WINDOW_RTOL * window_rms if "pool_rms" in ablate else 0.0)
    err = np.abs(got - ref)
    assert (err <= limit).all(), (label, err.max(), np.abs(ref).mean())
    # the stand-in changed the output: it is not the production path
    plain = ek.fused_embedding_windows(net, torch.from_numpy(spec), starts).numpy()
    assert np.abs(plain - got).max() > BF16_PATH_TOL


def test_empty_ablate_is_the_production_path(net, spec):
    starts = embedding_window_starts(CLIP)
    x = torch.from_numpy(spec)
    assert torch.equal(ek.fused_embedding_windows(net, x, starts, ablate=frozenset()),
                       ek.fused_embedding_windows(net, x, starts))


def test_an_unknown_member_raises(net, spec):
    with pytest.raises(ValueError, match="unknown ablation"):
        ek.fused_embedding_windows(net, torch.from_numpy(spec), embedding_window_starts(CLIP),
                                   ablate=frozenset({"gelu", "layernorm"}))
    with pytest.raises(ValueError, match="unknown ablation"):
        ek.ablation_defines(frozenset({"softmaxx"}))


def test_ablation_defines_name_each_member_in_order():
    assert ek.ablation_defines(frozenset()) == ()
    assert ek.ablation_defines(frozenset({"pool_rms", "gelu"})) == ("HB_ABLATE_GELU", "HB_ABLATE_POOL_RMS")


def test_defines_give_their_own_library_and_label():
    plain = build._target("embedding_pool")[1]
    assert build._target("embedding_pool", ())[1] == plain
    a = build._target("embedding_pool", ("HB_ABLATE_GELU",))[1]
    b = build._target("embedding_pool", ("HB_ABLATE_SOFTMAX",))[1]
    g = build._target("embedding_pool", ("HB_K2_GROUP=2",))[1]
    assert len({plain, a, b, g}) == 4
    assert build._target("embedding_pool", ("HB_ABLATE_GELU",))[1] == a
    assert build.label("embedding_pool", ()) == "embedding_pool"
    assert build.label("embedding_pool", ("HB_K2_GROUP=2",)) == "embedding_pool[HB_K2_GROUP=2]"


def test_nvcc_command_passes_the_defines(monkeypatch):
    monkeypatch.setattr(build, "_nvcc", lambda: "nvcc")
    assert build.nvcc_command("k.cu", "libk.so", ("HB_ABLATE_GELU", "HB_K2_GROUP=2")) == [
        "nvcc", *build.NVCC_FLAGS, "-DHB_ABLATE_GELU", "-DHB_K2_GROUP=2", "-o", "libk.so", "k.cu"]


def test_tile_defines_and_default_tiles():
    assert sweep.tile_defines(sweep.PRODUCTION_GROUP) == ()
    assert sweep.tile_defines(2) == ("HB_K2_GROUP=2",)
    assert sweep.parse_tiles(None) == [sweep.PRODUCTION_GROUP, 1, 2, 3]
    assert sweep.parse_tiles("2,4") == [4, 2]


def test_cpu_rehearsal_writes_the_jax_rows(tmp_path, capsys):
    out = tmp_path / "sweep.jsonl"
    assert sweep.main(["--device", "cpu", "--batch", "2", "--passes", "1", "--out", str(out)]) == 0
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    labels = [r["label"] for r in rows]
    assert labels == [f"baseline_t{sweep.PRODUCTION_GROUP}", *(label for label, _ in sweep.ABLATION_SETS),
                      "tile_1", "tile_2", "tile_3"]
    for r in rows:
        assert {"label", "ms_per_batch", "clips_per_s", "device"} <= set(r)
        assert r["device"] == "cpu" and r["ms_per_batch"] > 0
    assert rows[1]["ablate"] == ["softmax"] and rows[-1]["clip_tile"] == 3
    assert "=== summary (min over interleaved passes) ===" in capsys.readouterr().out
