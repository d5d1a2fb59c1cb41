"""The port's VITS training graph (``models/vits/training.py``) against the JAX package's on the
CPU: ``training_forward``'s alignment, losses and every parameter's gradient against ``jax.grad``
with JAX's draws injected, in each duration-loss branch, and ``rand_slice_segments``. The
configuration and parameter helpers are tests/test_torch_vits.py's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heybuddy_tpu.models.vits import synthesizer as js
from heybuddy_tpu.models.vits import training as jt
from heybuddy_tpu_torch.models.vits import synthesizer as ps
from heybuddy_tpu_torch.models.vits import training as pt
from heybuddy_tpu.models.vits import modules as jm
from test_torch_vits import TINY, close, t, trees

# a parameter's gradient against jax.grad's: the norm of the difference within GRAD_RTOL of the
# gradient's norm plus GRAD_ATOL (float32 noise on gradients that are zero analytically, as the
# key biases' under softmax: 1.1e-7 measured)
GRAD_RTOL = 1e-4
GRAD_ATOL = 1e-6


def grads_as_state(grads_tree, post_grads):
    """JAX gradient trees keyed as the port's parameters (the import mapping, linear in the weights)."""
    state = {f"model.{k}": v for k, v in ps.jax_params_to_state(grads_tree).items()}
    state.update({f"posterior.{k}": v for k, v in pt.posterior_params_to_state(post_grads).items()})
    return state


@pytest.mark.parametrize("duration", ["sdp_nll", "sdp_proj", "non_sdp"])
def test_training_forward_losses_gradients_alignment(duration):
    """training_forward with JAX's draws: the alignment exact, the losses 1e-5 relative, every
    parameter's gradient within GRAD_RTOL of its norm against jax.grad; the duration loss by each
    branch (the SDP NLL, the SDP's projection without posterior flows, the deterministic predictor)."""
    cfg = dict(TINY, use_sdp=duration != "non_sdp")
    cfg_j, cfg_p = js.VitsConfig(**cfg), ps.VitsConfig(**cfg)
    params, model = trees(cfg, sdp_posterior=duration == "sdp_nll")
    sdp_post = params.pop("dp_posterior", None)
    post = pt.posterior_encoder_init(torch.Generator().manual_seed(1), in_channels=65,
                                     out_channels=cfg_j.inter_channels, hidden_channels=cfg_j.hidden_channels,
                                     n_layers=2, gin_channels=cfg_j.gin_channels)
    posterior = pt.PosteriorEncoder.from_jax_params(post, device="cpu")
    post["enc"].update(kernel_size=jm.Static(5), dilation_rate=jm.Static(1))  # JAX's static leaves
    rng = np.random.default_rng(0)
    ids = rng.integers(3, 40, (2, 12)).astype(np.int32)
    id_lengths = np.asarray([12, 8], np.int32)
    spec = rng.normal(0, 1, (2, 65, 40)).astype(np.float32)
    spec_lengths = np.asarray([40, 30], np.int32)
    speakers = np.asarray([0, 1])
    key = jax.random.PRNGKey(3)

    def jax_loss(p, q, sp):
        out = jt.training_forward(p, q, key, ids, id_lengths, spec, spec_lengths, p["emb_g"][speakers],
                                  segment_size=8, config=cfg_j, sdp_posterior_params=sp)
        loss = out["kl_loss"] + out["duration_loss"] + jnp.mean(jnp.square(out["audio_segment"]))
        return loss, out

    (loss_j, out_j), grads = jax.jit(jax.value_and_grad(jax_loss, argnums=(0, 1, 2), has_aux=True))(
        params, post, sdp_post)

    k_post, k_slice, k_dur = jax.random.split(key, 3)
    draws = {"post": t(jax.random.normal(k_post, (2, cfg_j.inter_channels, 40))),
             "slice": t(jax.random.uniform(k_slice, (2,))), "dur": t(jax.random.normal(k_dur, (2, 2, 12)))}
    out = pt.training_forward(model, posterior, t(ids, torch.long), t(id_lengths, torch.long), t(spec),
                              t(spec_lengths, torch.long), model.emb_g.weight[t(speakers, torch.long)],
                              segment_size=8, draws=draws)
    loss = out["kl_loss"] + out["duration_loss"] + out["audio_segment"].square().mean()
    loss.backward()

    np.testing.assert_array_equal(out["attn"].numpy(), np.asarray(out_j["attn"]))
    np.testing.assert_array_equal(out["ids_slice"].numpy(), np.asarray(out_j["ids_slice"]))
    for name in ("kl_loss", "duration_loss"):
        np.testing.assert_allclose(float(out[name]), float(out_j[name]), rtol=1e-5)
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-5)
    close(out["audio_segment"], out_j["audio_segment"])

    g_params, g_post, g_sdp = grads
    if g_sdp is not None:
        g_params = dict(g_params, dp_posterior=g_sdp)
    want = grads_as_state(g_params, g_post)
    got = {f"model.{k}": p.grad for k, p in model.named_parameters()}
    got.update({f"posterior.{k}": p.grad for k, p in posterior.named_parameters()})
    assert set(got) == set(want)
    gaps = {}
    for name, g in got.items():
        ref = want[name]
        g = np.zeros_like(ref) if g is None else g.numpy()
        gaps[name] = (float(np.linalg.norm(g - ref)), float(np.linalg.norm(ref)))
    for name, (gap, scale) in gaps.items():
        assert gap <= GRAD_RTOL * scale + GRAD_ATOL, name
    if duration == "non_sdp":  # the predictor's inputs are detached: no duration gradient reaches the encoder
        assert float(np.abs(want["model.dp.conv_1.weight"]).sum()) > 0


def test_rand_slice_segments_clamps_as_dynamic_slice():
    x = np.arange(2 * 3 * 20, dtype=np.float32).reshape(2, 3, 20)
    lengths = np.asarray([20, 12], np.int32)
    key = jax.random.PRNGKey(0)
    want, want_starts = jt.rand_slice_segments(key, x, lengths, 8)
    got, starts = pt.rand_slice_segments(t(x), t(lengths, torch.long), 8, t(jax.random.uniform(key, (2,))))
    np.testing.assert_array_equal(starts.numpy(), np.asarray(want_starts))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    u = t(np.asarray([0.999, 0.999], np.float32))
    segments, _ = pt.rand_slice_segments(t(x), t(np.asarray([40, 40]), torch.long), 8, u)
    np.testing.assert_array_equal(segments.numpy(), x[:, :, 12:20])  # a start past the end is clamped
