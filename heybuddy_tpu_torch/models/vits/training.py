"""
The VITS training-side graph, the JAX package's ``models/vits/training.py``
in PyTorch: the posterior encoder (Piper's ``enc_q``), the SDP's negative
log-likelihood of the aligned durations, random decoder segments, the flow's
forward direction, the KL term and ``training_forward``. As there, the GAN
discriminators are out of scope: this is the generator side a voice is
fine-tuned with.

The alignment (the monotonic maximum path) runs on the host: the
log-likelihood matrix is copied off the device (one sync a step), the C++
DP (``ops/monotonic_align.py``) finds the path, and the path comes back as a
constant, with no gradient through it, as JAX's ``pure_callback`` with a
zero JVP and VITS's detach do.

The random draws (the posterior's (b, inter, t_y) normal, the segment
starts' (b,) uniform, the SDP NLL's (b, 2, t_x) normal, in that order) come
from a ``torch.Generator`` or are passed in ``draws``, so that tests can use
JAX's.
"""

from __future__ import annotations

import math
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from heybuddy_tpu_torch.device import DeviceLike, resolve_device
from heybuddy_tpu_torch.models.vits import modules as m
from heybuddy_tpu_torch.models.vits.synthesizer import ParamDraws, StochasticDurationPredictor, Vits
from heybuddy_tpu_torch.ops.monotonic_align import maximum_path

__all__ = [
    "PosteriorEncoder",
    "posterior_encoder_init",
    "posterior_params_to_state",
    "sdp_posterior_init",
    "stochastic_duration_nll",
    "rand_slice_segments",
    "kl_loss",
    "training_forward",
    "ALIGN_SECONDS",
]

Params = Dict[str, Any]

# host seconds spent in the alignment (copy off the device, DP, copy back), summed over calls
ALIGN_SECONDS = [0.0]


class PosteriorEncoder(nn.Module):
    """(b, spec_channels, t) linear spectrogram -> sampled latent z, its stats, the mask."""

    def __init__(
        self, in_channels: int = 513, out_channels: int = 192, hidden_channels: int = 192, kernel_size: int = 5,
        n_layers: int = 16, gin_channels: int = 512,
    ) -> None:
        super().__init__()
        self.pre = nn.Conv1d(in_channels, hidden_channels, 1)
        self.enc = m.WN(hidden_channels, kernel_size, 1, n_layers, gin_channels)
        self.proj = nn.Conv1d(hidden_channels, 2 * out_channels, 1)

    @classmethod
    def from_jax_params(cls, tree: Params, device: DeviceLike = "cuda") -> "PosteriorEncoder":
        """The module from JAX's ``posterior_encoder_init`` tree (or this module's ``posterior_encoder_init``)."""
        in_layers = tree["enc"]["in_layers"]
        gin = np.shape(tree["enc"]["cond_layer"]["w"])[1] if "cond_layer" in tree["enc"] else 0
        pre_out, pre_in, _ = np.shape(tree["pre"]["w"])
        module = cls(pre_in, np.shape(tree["proj"]["w"])[0] // 2, pre_out, np.shape(in_layers[0]["w"])[-1],
                     len(in_layers), gin)
        module.load_state_dict({k: torch.from_numpy(v) for k, v in posterior_params_to_state(tree).items()})
        return module.to(resolve_device(device))

    def forward(
        self, spec: torch.Tensor, spec_lengths: torch.Tensor, g: Optional[torch.Tensor], noise: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        y_mask = m.sequence_mask(spec_lengths, spec.shape[-1])[:, None, :]
        h = m.conv1d(self.pre, spec) * y_mask
        stats = m.conv1d(self.proj, self.enc(h, y_mask, g=g)) * y_mask
        out = stats.shape[1] // 2
        m_q, logs_q = stats[:, :out], stats[:, out:]
        z = (m_q + noise * torch.exp(logs_q)) * y_mask
        return z, m_q, logs_q, y_mask


def posterior_params_to_state(tree: Params) -> Dict[str, np.ndarray]:
    """A JAX-layout posterior encoder tree -> ``PosteriorEncoder``'s state dict (Piper's ``enc_q`` keys)."""
    convs = {"pre": tree["pre"], "proj": tree["proj"]}
    for name in ("in_layers", "res_skip_layers"):
        convs.update({f"enc.{name}.{i}": p for i, p in enumerate(tree["enc"][name])})
    if "cond_layer" in tree["enc"]:
        convs["enc.cond_layer"] = tree["enc"]["cond_layer"]
    state = {}
    for prefix, p in convs.items():
        state[f"{prefix}.weight"] = np.array(p["w"], dtype=np.float32)
        state[f"{prefix}.bias"] = np.array(p["b"], dtype=np.float32)
    return state


def posterior_encoder_init(
    generator: torch.Generator, in_channels: int = 513, out_channels: int = 192, hidden_channels: int = 192,
    kernel_size: int = 5, n_layers: int = 16, gin_channels: int = 512,
) -> Params:
    """The posterior encoder's tree in JAX's layout, drawn as ``synthesizer.init_params`` draws."""
    d = ParamDraws(generator)
    return {"pre": d.conv(in_channels, hidden_channels, 1),
            "enc": d.wn(hidden_channels, kernel_size, n_layers, gin_channels),
            "proj": d.conv(hidden_channels, 2 * out_channels, 1)}


def sdp_posterior_init(generator: torch.Generator, filter_channels: int = 192, kernel_size: int = 3) -> Params:
    """The SDP's posterior flows in JAX's layout (``dp_posterior``), for ``Vits.from_jax_params``."""
    d = ParamDraws(generator)
    fc = filter_channels
    return {"post_pre": d.conv(1, fc, 1), "post_proj": d.conv(fc, fc, 1),
            "post_convs": d.ddsconv(fc, kernel_size), "post_flows": d.sdp_flows(fc, kernel_size)}


def _flows_forward(
    flows: nn.ModuleList, z: torch.Tensor, x_mask: torch.Tensor, cond: torch.Tensor, logdet_tot: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Affine, then each ConvFlow followed by a flip; adds each log-determinant to ``logdet_tot`` in turn."""
    z, logdet = flows[0](z, x_mask)
    logdet_tot = logdet_tot + logdet
    for flow in flows[1:]:
        if isinstance(flow, m.ConvFlow):
            z, logdet = flow(z, x_mask, g=cond, reverse=False)
            logdet_tot = logdet_tot + logdet
            z = m.flip_flow(z)
    return z, logdet_tot


def stochastic_duration_nll(
    dp: StochasticDurationPredictor,
    h: torch.Tensor,
    x_mask: torch.Tensor,
    durations: torch.Tensor,
    g: Optional[torch.Tensor],
    noise: torch.Tensor,
) -> torch.Tensor:
    """
    The SDP's forward-direction negative log-likelihood of ``durations``
    (b, 1, t_x): the posterior flows model the dequantisation noise, the main
    flows (d - u, z1); returns nll + log q per row (b,). ``noise`` is the
    (b, 2, t_x) standard normal; ``h`` and ``g`` are detached, as in VITS.
    """
    x = dp.condition(h.detach(), x_mask, None if g is None else g.detach())
    w = durations * x_mask
    h_w = m.conv1d(dp.post_pre, w)
    h_w = m.conv1d(dp.post_proj, dp.post_convs(h_w, x_mask)) * x_mask
    e_q = noise * x_mask
    zeros = torch.zeros(x.shape[0], device=x.device)
    z_q, logdet_tot_q = _flows_forward(dp.post_flows, e_q, x_mask, x + h_w, zeros)
    z_u, z1 = z_q[:, 0:1], z_q[:, 1:2]
    u = torch.sigmoid(z_u) * x_mask
    z0 = (w - u) * x_mask
    logdet_tot_q = logdet_tot_q + ((F.logsigmoid(z_u) + F.logsigmoid(-z_u)) * x_mask).sum(dim=(1, 2))
    logq = (-0.5 * (math.log(2 * math.pi) + e_q.square()) * x_mask).sum(dim=(1, 2)) - logdet_tot_q

    z0, logdet = m.log_flow(z0, x_mask)
    z, logdet_tot = _flows_forward(dp.flows, torch.cat([z0, z1], dim=1), x_mask, x, zeros + logdet)
    nll = (0.5 * (math.log(2 * math.pi) + z.square()) * x_mask).sum(dim=(1, 2)) - logdet_tot
    return nll + logq


def rand_slice_segments(
    x: torch.Tensor, lengths: torch.Tensor, segment_size: int, uniform: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """
    Fixed-size time slices per row: start = floor(u * max(length - size, 1))
    from the (b,) ``uniform`` draws. A start past the end is clamped for the
    slice, as ``lax.dynamic_slice`` clamps; the starts are returned unclamped.
    """
    t = x.shape[-1]
    max_start = torch.clamp(lengths - segment_size, min=1).float()
    starts = (uniform * max_start).to(torch.int32)
    begin = torch.clamp(starts.long(), 0, t - segment_size)
    idx = begin[:, None] + torch.arange(segment_size, device=x.device)[None, :]
    return torch.gather(x, 2, idx[:, None, :].expand(-1, x.shape[1], -1)), starts


def kl_loss(z_p: torch.Tensor, logs_q: torch.Tensor, m_p: torch.Tensor, logs_p: torch.Tensor,
            y_mask: torch.Tensor) -> torch.Tensor:
    """The prior / posterior KL on flow-mapped latents, averaged over the mask."""
    kl = logs_p - logs_q - 0.5
    kl = kl + 0.5 * (z_p - m_p).square() * torch.exp(-2.0 * logs_p)
    return (kl * y_mask).sum() / torch.clamp(y_mask.sum(), min=1.0)


def _alignment(neg_cent: torch.Tensor, attn_mask: torch.Tensor) -> torch.Tensor:
    """The host DP on a detached copy; the path comes back as a constant on the device."""
    t0 = time.perf_counter()
    value = neg_cent.detach().cpu().numpy()
    mask = attn_mask.detach().cpu().numpy()
    path = maximum_path(np.transpose(value, (0, 2, 1)), np.transpose(mask, (0, 2, 1)))
    out = torch.from_numpy(np.ascontiguousarray(path.transpose(0, 2, 1), dtype=np.float32)).to(neg_cent.device)
    ALIGN_SECONDS[0] += time.perf_counter() - t0
    return out


def training_forward(
    model: Vits,
    posterior: PosteriorEncoder,
    phoneme_ids: torch.Tensor,
    phoneme_lengths: torch.Tensor,
    spec: torch.Tensor,
    spec_lengths: torch.Tensor,
    speaker_embedding: Optional[torch.Tensor] = None,
    segment_size: int = 32,
    generator: Optional[torch.Generator] = None,
    draws: Optional[Dict[str, torch.Tensor]] = None,
) -> Dict[str, torch.Tensor]:
    """
    VITS's generator training forward: the decoded audio segment, the slice
    starts, the duration loss (the SDP NLL when ``model.dp`` has its
    posterior flows, else the log-domain MSE of the JAX function's other
    branches), the KL loss, the alignment and the intermediates.
    ``draws`` may hold "post", "slice" and "dur" to replace the generator's.
    """
    draws = dict(draws or {})
    dev = phoneme_ids.device
    b, t_x = phoneme_ids.shape
    x_mask = m.sequence_mask(phoneme_lengths, t_x)[:, None, :]
    h, m_p, logs_p = model.enc_p(phoneme_ids, x_mask)
    g = speaker_embedding[:, :, None] if speaker_embedding is not None else None

    inter = posterior.proj.out_channels // 2
    if "post" not in draws:
        draws["post"] = torch.randn((b, inter, spec.shape[-1]), generator=generator, device=dev)
    if "slice" not in draws:
        draws["slice"] = torch.rand((b,), generator=generator, device=dev)
    z, m_q, logs_q, y_mask = posterior(spec, spec_lengths, g, draws["post"])
    z_p = model.flow(z, y_mask, g)

    s_p_sq_r = torch.exp(-2.0 * logs_p)  # (b, d, t_x)
    neg_cent1 = (-0.5 * math.log(2 * math.pi) - logs_p).sum(dim=1)[:, None, :]
    neg_cent2 = torch.einsum("bdy,bdx->byx", -0.5 * z_p.square(), s_p_sq_r)
    neg_cent3 = torch.einsum("bdy,bdx->byx", z_p, m_p * s_p_sq_r)
    neg_cent4 = (-0.5 * m_p.square() * s_p_sq_r).sum(dim=1)[:, None, :]
    neg_cent = neg_cent1 + neg_cent2 + neg_cent3 + neg_cent4  # (b, t_y, t_x)
    attn_mask = y_mask[:, 0, :, None] * x_mask[:, 0, None, :]
    attn = _alignment(neg_cent, attn_mask)
    durations = attn.sum(dim=1)[:, None, :]  # (b, 1, t_x)

    n_tokens = torch.clamp(x_mask.sum(), min=1.0)
    if model.sdp and model.dp.has_posterior:
        if "dur" not in draws:
            draws["dur"] = torch.randn((b, 2, t_x), generator=generator, device=dev)
        nll = stochastic_duration_nll(model.dp, h, x_mask, durations, g, draws["dur"])
        duration_loss = nll.sum() / n_tokens
    else:
        logw_target = torch.log(durations + 1e-6) * x_mask
        g_det = None if g is None else g.detach()
        if model.sdp:
            # the SDP without its posterior flows: its conditioning stack's projection, log-MSE
            logw_hat = model.dp.condition(h.detach(), x_mask, g_det)[:, :1] * x_mask
        else:
            logw_hat = model.dp(h.detach(), x_mask, g_det)
        duration_loss = ((logw_hat - logw_target).square() * x_mask).sum() / n_tokens

    m_p_exp = torch.einsum("byx,bdx->bdy", attn, m_p)
    logs_p_exp = torch.einsum("byx,bdx->bdy", attn, logs_p)
    loss_kl = kl_loss(z_p, logs_q, m_p_exp, logs_p_exp, y_mask)

    z_slice, ids_slice = rand_slice_segments(z, spec_lengths, segment_size, draws["slice"])
    audio_segment = model.dec(z_slice, g)
    return {
        "audio_segment": audio_segment,
        "ids_slice": ids_slice,
        "attn": attn,
        "duration_loss": duration_loss,
        "kl_loss": loss_kl,
        "z": z,
        "z_p": z_p,
        "m_p": m_p_exp,
        "logs_p": logs_p_exp,
        "m_q": m_q,
        "logs_q": logs_q,
        "x_mask": x_mask,
        "y_mask": y_mask,
    }
