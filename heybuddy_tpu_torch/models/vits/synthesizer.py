"""
The VITS synthesizer (inference path), the JAX package's
``models/vits/synthesizer.py`` as ``nn.Module``s.

``Vits`` holds Piper's top-level parts under Piper's names: ``enc_p`` (text
encoder: relative-attention transformer), ``dp`` (the stochastic duration
predictor's spline flows, or the deterministic predictor of ``use_sdp:
false`` voices), ``flow`` (residual couplings), ``dec`` (the HiFiGAN
generator) and ``emb_g`` (speaker table). Its ``state_dict()`` is a Piper
checkpoint with weight norm folded; ``import_torch_checkpoint`` reads one
(``.pt`` or ``.safetensors``, weight norm in any of its three layouts).

``Vits.infer`` keeps the JAX function's static-shape semantics, because they
change the output: a ``max_frames`` budget, the frame count clipped into it,
zero-padded ids. Its two noise draws (the duration flow's (b, 2, t_x) and the
prior's (b, inter, max_frames) standard normals) come from a
``torch.Generator`` in that order, or are passed in, so that tests can use
JAX's draws.

``init_params(generator, config)`` draws a parameter tree in the JAX
package's layout (numpy) with its distributions and in its order; the values
differ from ``jax.random``'s for any seed. ``Vits.from_jax_params`` builds
the module from such a tree or from JAX's own: the inverse of JAX's import
mapping, which un-flips and transposes the transposed-conv weights.
"""

from __future__ import annotations

import json
import math
import struct
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from heybuddy_tpu_torch.device import DeviceLike, resolve_device
from heybuddy_tpu_torch.models.vits import modules as m
from heybuddy_tpu_torch.models.vits.attention import Encoder
from heybuddy_tpu_torch.utils.profiling import span

__all__ = [
    "VitsConfig",
    "Vits",
    "init_params",
    "ParamDraws",
    "generate_path",
    "import_torch_checkpoint",
    "read_state_file",
    "fold_weight_norm",
    "jax_params_to_state",
]

Params = Dict[str, Any]


class VitsConfig(NamedTuple):
    """Static hyperparameters (piper-libritts-en-r-medium defaults)."""

    n_vocab: int = 256
    inter_channels: int = 192
    hidden_channels: int = 192
    filter_channels: int = 768
    n_heads: int = 2
    n_layers: int = 6
    kernel_size: int = 3
    resblock_kernel_sizes: Tuple[int, ...] = (3, 5, 7)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = ((1, 2), (2, 6), (3, 12))
    upsample_rates: Tuple[int, ...] = (8, 8, 4)
    upsample_initial_channel: int = 256
    upsample_kernel_sizes: Tuple[int, ...] = (16, 16, 8)
    n_speakers: int = 904
    gin_channels: int = 512
    use_sdp: bool = True
    sample_rate: int = 22050

    @property
    def hop_samples(self) -> int:
        return int(np.prod(self.upsample_rates))


# the fixed shapes of the JAX package's (and Piper's) SDP and flow
SDP_FLOWS = 4
SDP_LAYERS = 3
SDP_BINS = 10
FLOW_COUPLINGS = 4
FLOW_KERNEL = 5
FLOW_WN_LAYERS = 4
NON_SDP_FILTERS = 256


# ------------------------------------------------------------------ modules


class TextEncoder(nn.Module):
    """(b, t) ids -> hidden (b, c, t) and the prior's mean / log-std (b, inter, t)."""

    def __init__(self, cfg: VitsConfig) -> None:
        super().__init__()
        self.hidden_channels = cfg.hidden_channels
        self.emb = nn.Embedding(cfg.n_vocab, cfg.hidden_channels)
        self.encoder = Encoder(cfg.hidden_channels, cfg.filter_channels, cfg.n_heads, cfg.n_layers, cfg.kernel_size)
        self.proj = nn.Conv1d(cfg.hidden_channels, 2 * cfg.inter_channels, 1)

    def forward(self, ids: torch.Tensor, x_mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        h = (self.emb.weight[ids] * math.sqrt(self.hidden_channels)).permute(0, 2, 1)
        h = self.encoder(h, x_mask)
        stats = m.conv1d(self.proj, h) * x_mask
        inter = stats.shape[1] // 2
        return h, stats[:, :inter], stats[:, inter:]


def _sdp_flows(channels: int, kernel_size: int) -> nn.ModuleList:
    """[ElementwiseAffine, ConvFlow, Flip, ConvFlow, Flip, ...]: Piper's list, flips included."""
    flows: List[nn.Module] = [m.ElementwiseAffine(2)]
    for _ in range(SDP_FLOWS):
        flows += [m.ConvFlow(2, channels, kernel_size, SDP_LAYERS, SDP_BINS), m.Flip()]
    return nn.ModuleList(flows)


class StochasticDurationPredictor(nn.Module):
    """
    Piper's stochastic duration predictor: the conditioning stack and the
    main spline flows; with ``posterior`` also the posterior flows
    (``post_*``), which only the training direction needs.
    """

    def __init__(self, cfg: VitsConfig, posterior: bool = False) -> None:
        super().__init__()
        fc = cfg.hidden_channels  # filter channels == in channels (reference models.py:63)
        self.pre = nn.Conv1d(cfg.hidden_channels, fc, 1)
        self.proj = nn.Conv1d(fc, fc, 1)
        self.convs = m.DDSConv(fc, cfg.kernel_size, SDP_LAYERS)
        self.cond = nn.Conv1d(cfg.gin_channels, fc, 1)
        self.flows = _sdp_flows(fc, cfg.kernel_size)
        if posterior:
            self.post_pre = nn.Conv1d(1, fc, 1)
            self.post_proj = nn.Conv1d(fc, fc, 1)
            self.post_convs = m.DDSConv(fc, cfg.kernel_size, SDP_LAYERS)
            self.post_flows = _sdp_flows(fc, cfg.kernel_size)

    @property
    def has_posterior(self) -> bool:
        return hasattr(self, "post_pre")

    def condition(self, x: torch.Tensor, x_mask: torch.Tensor, g: Optional[torch.Tensor]) -> torch.Tensor:
        h = m.conv1d(self.pre, x)
        if g is not None:
            h = h + m.conv1d(self.cond, g)
        return m.conv1d(self.proj, self.convs(h, x_mask)) * x_mask

    def reverse(
        self, x: torch.Tensor, x_mask: torch.Tensor, g: Optional[torch.Tensor], noise: torch.Tensor,
        noise_scale: float,
    ) -> torch.Tensor:
        """Reverse pass -> log durations (b, 1, t); ``noise`` (b, 2, t) standard normal."""
        h = self.condition(x, x_mask, g)
        z = noise * noise_scale
        # VITS's reverse skips the first ConvFlow ("remove a useless vflow"):
        # flip, cf4, flip, cf3, flip, cf2, flip, then the affine
        convflows = [f for f in self.flows if isinstance(f, m.ConvFlow)]
        for cf in reversed(convflows[1:]):
            z, _ = cf(m.flip_flow(z), x_mask, g=h, reverse=True)
        z, _ = self.flows[0](m.flip_flow(z), x_mask, reverse=True)
        return z[:, 0:1]


class DurationPredictor(nn.Module):
    """The deterministic predictor of ``use_sdp: false`` voices -> log durations."""

    def __init__(self, cfg: VitsConfig, cond: bool = True) -> None:
        super().__init__()
        dfc = NON_SDP_FILTERS
        self.conv_1 = nn.Conv1d(cfg.hidden_channels, dfc, cfg.kernel_size)
        self.norm_1 = m.LayerNorm(dfc)
        self.conv_2 = nn.Conv1d(dfc, dfc, cfg.kernel_size)
        self.norm_2 = m.LayerNorm(dfc)
        self.proj = nn.Conv1d(dfc, 1, 1)
        if cond:
            self.cond = nn.Conv1d(cfg.gin_channels, cfg.hidden_channels, 1)

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor, g: Optional[torch.Tensor]) -> torch.Tensor:
        pad = self.conv_1.weight.shape[-1] // 2
        h = x
        if g is not None and hasattr(self, "cond"):
            h = h + m.conv1d(self.cond, g)
        h = self.norm_1(torch.relu(m.conv1d(self.conv_1, h * x_mask, padding=pad)))
        h = self.norm_2(torch.relu(m.conv1d(self.conv_2, h * x_mask, padding=pad)))
        return m.conv1d(self.proj, h * x_mask) * x_mask


class ResidualCouplingBlock(nn.Module):
    """Four mean-only couplings, each followed by a flip (Piper's ``flow.flows``)."""

    def __init__(self, cfg: VitsConfig) -> None:
        super().__init__()
        flows: List[nn.Module] = []
        for _ in range(FLOW_COUPLINGS):
            flows += [m.ResidualCouplingLayer(cfg.inter_channels, cfg.hidden_channels, FLOW_KERNEL, 1,
                                              FLOW_WN_LAYERS, gin_channels=cfg.gin_channels), m.Flip()]
        self.flows = nn.ModuleList(flows)

    def couplings(self) -> List[m.ResidualCouplingLayer]:
        return [f for f in self.flows if isinstance(f, m.ResidualCouplingLayer)]

    def forward(self, z: torch.Tensor, y_mask: torch.Tensor, g: Optional[torch.Tensor]) -> torch.Tensor:
        """z -> z_p, the training direction."""
        for layer in self.couplings():
            z = m.flip_flow(layer(z, y_mask, g=g, reverse=False))
        return z

    def reverse(self, z: torch.Tensor, y_mask: torch.Tensor, g: Optional[torch.Tensor]) -> torch.Tensor:
        for layer in reversed(self.couplings()):
            z = layer(m.flip_flow(z), y_mask, g=g, reverse=True)
        return z


class Generator(nn.Module):
    """HiFiGAN decoder: (b, inter, t) latents -> (b, t * hop) waveform."""

    def __init__(self, cfg: VitsConfig) -> None:
        super().__init__()
        self.cfg = cfg
        ch = cfg.upsample_initial_channel
        self.conv_pre = nn.Conv1d(cfg.inter_channels, ch, 7)
        ups, resblocks = [], []
        for kernel in cfg.upsample_kernel_sizes:
            ups.append(nn.ConvTranspose1d(ch, ch // 2, kernel))
            ch //= 2
            for k_size, dilations in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes):
                resblocks.append(m.ResBlock2(ch, k_size, dilations))
        self.ups = nn.ModuleList(ups)
        self.resblocks = nn.ModuleList(resblocks)
        self.conv_post = nn.Conv1d(ch, 1, 7)
        self.cond = nn.Conv1d(cfg.gin_channels, cfg.upsample_initial_channel, 1)

    def forward(self, z: torch.Tensor, g: Optional[torch.Tensor]) -> torch.Tensor:
        cfg = self.cfg
        x = m.conv1d(self.conv_pre, z, padding=3)
        if g is not None:
            x = x + m.conv1d(self.cond, g)
        n_kernels = len(cfg.resblock_kernel_sizes)
        for i, (rate, kernel) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
            x = m.conv_transpose1d(self.ups[i], F.leaky_relu(x, 0.1), stride=rate, padding=(kernel - rate) // 2)
            acc = None
            for j in range(n_kernels):
                block = self.resblocks[i * n_kernels + j](x)
                acc = block if acc is None else acc + block
            x = acc / n_kernels
        x = m.conv1d(self.conv_post, F.leaky_relu(x, 0.1), padding=3)
        return torch.tanh(x)[:, 0]


def generate_path(duration: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Monotonic path: duration (b, 1, t_x), mask (b, 1, t_y, t_x) -> path (b, 1, t_y, t_x)."""
    t_y = mask.shape[2]
    cum = torch.cumsum(duration, dim=-1)  # (b, 1, t_x)
    positions = torch.arange(t_y, device=duration.device)[None, :, None]
    path = (positions < cum[:, 0][:, None, :]).float()  # (b, t_y, t_x)
    path = path - F.pad(path, (1, 0))[:, :, :-1]
    return path[:, None] * mask


class Vits(nn.Module):
    """
    The synthesizer at ``config``. ``sdp`` picks the duration predictor's
    layout (default ``config.use_sdp``); ``sdp_posterior`` adds the SDP's
    posterior flows; ``speaker_table`` the ``emb_g`` table (default: more
    than one speaker); ``dp_cond`` the non-SDP predictor's speaker
    conditioning.
    """

    def __init__(
        self,
        config: VitsConfig = VitsConfig(),
        sdp: Optional[bool] = None,
        sdp_posterior: bool = False,
        speaker_table: Optional[bool] = None,
        dp_cond: bool = True,
    ) -> None:
        super().__init__()
        self.config = config
        sdp = config.use_sdp if sdp is None else sdp
        self.enc_p = TextEncoder(config)
        self.dp: nn.Module = (
            StochasticDurationPredictor(config, sdp_posterior) if sdp else DurationPredictor(config, dp_cond))
        self.flow = ResidualCouplingBlock(config)
        self.dec = Generator(config)
        if speaker_table is None:
            speaker_table = config.n_speakers > 1
        if speaker_table:
            self.emb_g = nn.Embedding(config.n_speakers, config.gin_channels)

    @property
    def sdp(self) -> bool:
        return isinstance(self.dp, StochasticDurationPredictor)

    @classmethod
    def from_jax_params(
        cls, tree: Params, config: VitsConfig = VitsConfig(), sdp_posterior: Optional[Params] = None,
        device: DeviceLike = "cuda",
    ) -> "Vits":
        """The module from a JAX-layout parameter tree (numpy or JAX arrays; ``Static`` leaves ignored)."""
        state = jax_params_to_state(tree, sdp_posterior)
        return cls.from_state(state, config, device)

    @classmethod
    def from_state(cls, state: Dict[str, np.ndarray], config: VitsConfig, device: DeviceLike = "cuda") -> "Vits":
        """
        The module from a Piper state dict with weight norm folded; the layout
        follows the keys, as JAX's import does: the deterministic predictor
        when there is no ``dp.flows.0.m`` but a ``dp.conv_1``, the SDP's
        posterior flows when ``dp.post_pre.weight`` is there, ``emb_g`` when
        ``emb_g.weight`` is. A missing bias is zero; a missing weight raises.
        """
        sdp = not ("dp.flows.0.m" not in state and "dp.conv_1.weight" in state)
        model = cls(
            config, sdp=sdp, sdp_posterior=sdp and "dp.post_pre.weight" in state,
            speaker_table="emb_g.weight" in state, dp_cond="dp.cond.weight" in state,
        )
        own = model.state_dict()
        loaded = {}
        for key, ref in own.items():
            if key in state:
                value = np.asarray(state[key], dtype=np.float32)
            elif key.endswith(".bias"):
                value = np.zeros(tuple(ref.shape), np.float32)
            else:
                raise KeyError(f"Missing weight for {key}")
            if tuple(value.shape) != tuple(ref.shape):
                raise ValueError(f"{key}: shape {value.shape} in the checkpoint, {tuple(ref.shape)} in the model")
            loaded[key] = torch.from_numpy(np.array(value, dtype=np.float32))
        model.load_state_dict(loaded)
        return model.to(resolve_device(device))

    def speaker_embedding(self, speakers: torch.Tensor) -> torch.Tensor:
        return self.emb_g.weight[speakers]

    def infer(
        self,
        phoneme_ids: torch.Tensor,
        phoneme_lengths: torch.Tensor,
        speaker_embedding: Optional[torch.Tensor] = None,
        noise_scale: float = 0.667,
        length_scale: float = 1.0,
        noise_scale_w: float = 0.8,
        max_frames: int = 512,
        generator: Optional[torch.Generator] = None,
        noise_dur: Optional[torch.Tensor] = None,
        noise_prior: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """
        (b, t_x) zero-padded ids, (b,) lengths, (b, gin) speaker vectors ->
        (audio (b, max_frames * hop), audio lengths (b,)). Durations are
        clipped into the static ``max_frames`` budget. Each stage is a
        ``span``: ``vits/infer`` > ``vits/encoder``, ``vits/duration``,
        ``vits/path``, ``vits/flow``, ``vits/decoder``.
        """
        cfg = self.config
        b, t_x = phoneme_ids.shape
        dev = phoneme_ids.device
        with span("vits/infer"):
            with span("vits/encoder"):
                x_mask = m.sequence_mask(phoneme_lengths, t_x)[:, None, :]
                h, m_p, logs_p = self.enc_p(phoneme_ids, x_mask)
            g = speaker_embedding[:, :, None] if speaker_embedding is not None else None
            with span("vits/duration"):
                if self.sdp:
                    if noise_dur is None:
                        noise_dur = torch.randn((b, 2, t_x), generator=generator, device=dev)
                    logw = self.dp.reverse(h, x_mask, g, noise_dur, noise_scale_w)
                else:
                    logw = self.dp(h, x_mask, g)
            with span("vits/path"):
                w = torch.exp(logw) * x_mask * length_scale
                w_ceil = torch.ceil(w)
                y_lengths = torch.clamp(w_ceil.sum(dim=(1, 2)), 1, max_frames).to(torch.int32)
                y_mask = m.sequence_mask(y_lengths, max_frames)[:, None, :]
                attn = generate_path(w_ceil, x_mask[:, :, None, :] * y_mask[:, :, :, None])[:, 0]  # (b, t_y, t_x)
                m_p = torch.einsum("byx,bcx->bcy", attn, m_p)
                logs_p = torch.einsum("byx,bcx->bcy", attn, logs_p)
                if noise_prior is None:
                    noise_prior = torch.randn(m_p.shape, generator=generator, device=dev)
                z_p = m_p + noise_prior * torch.exp(logs_p) * noise_scale
            with span("vits/flow"):
                z = self.flow.reverse(z_p, y_mask, g)
            with span("vits/decoder"):
                audio = self.dec(z * y_mask, g)
        return audio, y_lengths * cfg.hop_samples


# ------------------------------------------------------------------ parameters


class ParamDraws:
    """
    The JAX package's init functions as draws from one ``torch.Generator``,
    each returning a JAX-layout numpy subtree: convs uniform in
    +-1/sqrt(fan_in) (transposed convs +-1/sqrt(out * k)), weight then bias,
    or zero; LayerNorms 1 / 0; normals scaled by ``std``.
    """

    def __init__(self, generator: torch.Generator) -> None:
        self.generator = generator

    def uniform(self, shape: Tuple[int, ...], bound: float) -> np.ndarray:
        u = torch.rand(shape, generator=self.generator, device=self.generator.device)
        return (-bound + 2.0 * bound * u).cpu().numpy()

    def normal(self, shape: Tuple[int, ...], std: float) -> np.ndarray:
        return (std * torch.randn(shape, generator=self.generator, device=self.generator.device)).cpu().numpy()

    def conv(self, in_ch: int, out_ch: int, kernel: int, zero: bool = False) -> Params:
        if zero:
            return {"w": np.zeros((out_ch, in_ch, kernel), np.float32), "b": np.zeros((out_ch,), np.float32)}
        bound = 1.0 / math.sqrt(in_ch * kernel)
        return {"w": self.uniform((out_ch, in_ch, kernel), bound), "b": self.uniform((out_ch,), bound)}

    def tconv(self, in_ch: int, out_ch: int, kernel: int) -> Params:
        bound = 1.0 / math.sqrt(out_ch * kernel)
        return {"w": self.uniform((out_ch, in_ch, kernel), bound), "b": self.uniform((out_ch,), bound)}

    @staticmethod
    def norm(ch: int) -> Params:
        return {"g": np.ones((ch,), np.float32), "b": np.zeros((ch,), np.float32)}

    def ddsconv(self, ch: int, kernel: int, n_layers: int = SDP_LAYERS) -> Params:
        return {"layers": [{"sep": self.conv(1, ch, kernel), "pw": self.conv(ch, ch, 1), "norm1": self.norm(ch),
                            "norm2": self.norm(ch)} for _ in range(n_layers)]}

    def wn(self, hidden: int, kernel: int, n_layers: int, gin: int) -> Params:
        in_layers, res_skip = [], []
        for i in range(n_layers):
            in_layers.append(self.conv(hidden, 2 * hidden, kernel))
            res_skip.append(self.conv(hidden, 2 * hidden if i < n_layers - 1 else hidden, 1))
        out: Params = {"in_layers": in_layers, "res_skip_layers": res_skip}
        if gin > 0:
            out["cond_layer"] = self.conv(gin, 2 * hidden * n_layers, 1)
        return out

    def sdp_flows(self, ch: int, kernel: int) -> List[Params]:
        affine = {"affine": {"m": np.zeros((2, 1), np.float32), "logs": np.zeros((2, 1), np.float32)}}
        return [affine] + [
            {"convflow": {"pre": self.conv(1, ch, 1), "convs": self.ddsconv(ch, kernel),
                          "proj": self.conv(ch, SDP_BINS * 3 - 1, 1, zero=True)}}
            for _ in range(SDP_FLOWS)]


def init_params(generator: torch.Generator, config: VitsConfig = VitsConfig()) -> Params:
    """
    A fresh parameter tree in the JAX package's layout (float32 numpy, no
    ``Static`` leaves) drawn from ``generator`` with JAX's distributions
    (``ParamDraws``) and in the order of its init functions: the embedding
    N(0, hidden^-1), the relative tables N(0, head_dim^-1), the coupling
    posts and spline projections zero, the speaker table 0.1 N(0, 1).
    """
    cfg = config
    d = ParamDraws(generator)
    hidden = cfg.hidden_channels
    head_dim = hidden // cfg.n_heads
    emb = d.normal((cfg.n_vocab, hidden), hidden ** -0.5)
    layers = []
    for _ in range(cfg.n_layers):
        attn = {name: d.conv(hidden, hidden, 1) for name in ("conv_q", "conv_k", "conv_v", "conv_o")}
        attn["emb_rel_k"] = d.normal((1, 9, head_dim), head_dim ** -0.5)
        attn["emb_rel_v"] = d.normal((1, 9, head_dim), head_dim ** -0.5)
        ffn = {"conv1": d.conv(hidden, cfg.filter_channels, cfg.kernel_size),
               "conv2": d.conv(cfg.filter_channels, hidden, cfg.kernel_size)}
        layers.append({"attn": attn, "norm1": d.norm(hidden), "ffn": ffn, "norm2": d.norm(hidden)})
    enc_p = {"emb": emb, "encoder": {"layers": layers}, "proj": d.conv(hidden, 2 * cfg.inter_channels, 1)}

    if cfg.use_sdp:
        dp: Params = {"pre": d.conv(hidden, hidden, 1), "proj": d.conv(hidden, hidden, 1),
                      "convs": d.ddsconv(hidden, cfg.kernel_size), "cond": d.conv(cfg.gin_channels, hidden, 1)}
        dp["flows"] = d.sdp_flows(hidden, cfg.kernel_size)
    else:
        dfc = NON_SDP_FILTERS
        dp = {"conv_1": d.conv(hidden, dfc, cfg.kernel_size), "norm_1": d.norm(dfc),
              "conv_2": d.conv(dfc, dfc, cfg.kernel_size), "norm_2": d.norm(dfc), "proj": d.conv(dfc, 1, 1),
              "cond": d.conv(cfg.gin_channels, hidden, 1)}

    flow = {"layers": [
        {"pre": d.conv(cfg.inter_channels // 2, hidden, 1),
         "enc": d.wn(hidden, FLOW_KERNEL, FLOW_WN_LAYERS, cfg.gin_channels),
         "post": d.conv(hidden, cfg.inter_channels // 2, 1, zero=True)}
        for _ in range(FLOW_COUPLINGS)]}

    ups, resblocks = [], []
    ch = cfg.upsample_initial_channel
    for kernel in cfg.upsample_kernel_sizes:
        ups.append(d.tconv(ch, ch // 2, kernel))
        ch //= 2
        for k_size, dilations in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes):
            resblocks.append({"convs": [d.conv(ch, ch, k_size) for _ in dilations]})
    dec = {"conv_pre": d.conv(cfg.inter_channels, cfg.upsample_initial_channel, 7), "ups": ups,
           "resblocks": resblocks, "conv_post": d.conv(ch, 1, 7),
           "cond": d.conv(cfg.gin_channels, cfg.upsample_initial_channel, 1)}

    params: Params = {"enc_p": enc_p, "dp": dp, "flow": flow, "dec": dec}
    if cfg.n_speakers > 1:
        params["emb_g"] = d.normal((cfg.n_speakers, cfg.gin_channels), 0.1)
    return params


def jax_params_to_state(tree: Params, sdp_posterior: Optional[Params] = None) -> Dict[str, np.ndarray]:
    """
    A JAX-layout parameter tree -> the Piper state dict that JAX's
    ``import_torch_checkpoint`` maps back to it: the inverse of its mapping,
    with transposed-conv weights un-flipped and transposed back to Piper's
    (in, out, k). ``sdp_posterior`` (or the tree's ``dp_posterior``) adds
    the SDP's posterior flows.
    """
    state: Dict[str, np.ndarray] = {}

    def arr(x: Any) -> np.ndarray:
        return np.asarray(x, dtype=np.float32)

    def conv(prefix: str, p: Params) -> None:
        state[f"{prefix}.weight"] = arr(p["w"])
        state[f"{prefix}.bias"] = arr(p["b"])

    def norm(prefix: str, p: Params) -> None:
        state[f"{prefix}.gamma"] = arr(p["g"])
        state[f"{prefix}.beta"] = arr(p["b"])

    def ddsconv(prefix: str, p: Params) -> None:
        for i, layer in enumerate(p["layers"]):
            conv(f"{prefix}.convs_sep.{i}", layer["sep"])
            conv(f"{prefix}.convs_1x1.{i}", layer["pw"])
            norm(f"{prefix}.norms_1.{i}", layer["norm1"])
            norm(f"{prefix}.norms_2.{i}", layer["norm2"])

    def flows(prefix: str, layers: List[Params]) -> None:
        state[f"{prefix}.0.m"] = arr(layers[0]["affine"]["m"])
        state[f"{prefix}.0.logs"] = arr(layers[0]["affine"]["logs"])
        for i, layer in enumerate(layers[1:]):
            cf = layer["convflow"]
            conv(f"{prefix}.{1 + 2 * i}.pre", cf["pre"])
            ddsconv(f"{prefix}.{1 + 2 * i}.convs", cf["convs"])
            conv(f"{prefix}.{1 + 2 * i}.proj", cf["proj"])

    def wn(prefix: str, p: Params) -> None:
        for i, layer in enumerate(p["in_layers"]):
            conv(f"{prefix}.in_layers.{i}", layer)
        for i, layer in enumerate(p["res_skip_layers"]):
            conv(f"{prefix}.res_skip_layers.{i}", layer)
        if "cond_layer" in p:
            conv(f"{prefix}.cond_layer", p["cond_layer"])

    enc = tree["enc_p"]
    state["enc_p.emb.weight"] = arr(enc["emb"])
    for i, layer in enumerate(enc["encoder"]["layers"]):
        prefix = "enc_p.encoder"
        for name in ("conv_q", "conv_k", "conv_v", "conv_o"):
            conv(f"{prefix}.attn_layers.{i}.{name}", layer["attn"][name])
        state[f"{prefix}.attn_layers.{i}.emb_rel_k"] = arr(layer["attn"]["emb_rel_k"])
        state[f"{prefix}.attn_layers.{i}.emb_rel_v"] = arr(layer["attn"]["emb_rel_v"])
        norm(f"{prefix}.norm_layers_1.{i}", layer["norm1"])
        conv(f"{prefix}.ffn_layers.{i}.conv_1", layer["ffn"]["conv1"])
        conv(f"{prefix}.ffn_layers.{i}.conv_2", layer["ffn"]["conv2"])
        norm(f"{prefix}.norm_layers_2.{i}", layer["norm2"])
    conv("enc_p.proj", enc["proj"])

    dp = tree["dp"]
    if "flows" in dp:
        for name in ("pre", "proj", "cond"):
            conv(f"dp.{name}", dp[name])
        ddsconv("dp.convs", dp["convs"])
        flows("dp.flows", dp["flows"])
    else:
        for name in ("conv_1", "conv_2", "proj") + (("cond",) if "cond" in dp else ()):
            conv(f"dp.{name}", dp[name])
        norm("dp.norm_1", dp["norm_1"])
        norm("dp.norm_2", dp["norm_2"])
    post = sdp_posterior if sdp_posterior is not None else tree.get("dp_posterior")
    if post is not None:
        conv("dp.post_pre", post["post_pre"])
        conv("dp.post_proj", post["post_proj"])
        ddsconv("dp.post_convs", post["post_convs"])
        flows("dp.post_flows", post["post_flows"])

    for i, layer in enumerate(tree["flow"]["layers"]):
        conv(f"flow.flows.{2 * i}.pre", layer["pre"])
        wn(f"flow.flows.{2 * i}.enc", layer["enc"])
        conv(f"flow.flows.{2 * i}.post", layer["post"])

    dec = tree["dec"]
    for name in ("conv_pre", "conv_post", "cond"):
        conv(f"dec.{name}", dec[name])
    for i, up in enumerate(dec["ups"]):
        # JAX keeps (out, in, k) flipped for its input-dilation conv; Piper (in, out, k)
        state[f"dec.ups.{i}.weight"] = np.ascontiguousarray(np.transpose(np.flip(arr(up["w"]), -1), (1, 0, 2)))
        state[f"dec.ups.{i}.bias"] = arr(up["b"])
    for i, block in enumerate(dec["resblocks"]):
        for d, c in enumerate(block["convs"]):
            conv(f"dec.resblocks.{i}.convs.{d}", c)
    if "emb_g" in tree:
        state["emb_g.weight"] = arr(tree["emb_g"])
    return state


# ------------------------------------------------------------------ checkpoints


def _read_safetensors(path: str) -> Dict[str, np.ndarray]:
    """A ``.safetensors`` file: an 8-byte header length, a JSON header, the raw tensors."""
    dtypes = {"F32": np.float32, "F16": np.float16, "F64": np.float64, "I64": np.int64, "I32": np.int32}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = f.read()
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        begin, end = info["data_offsets"]
        out[name] = np.frombuffer(data[begin:end], dtype=dtypes[info["dtype"]]).reshape(info["shape"]).copy()
    return out


def read_state_file(path: str) -> Dict[str, np.ndarray]:
    """A Piper checkpoint (``.safetensors`` or a torch ``.pt`` state dict, bare or under "model") as numpy."""
    if path.endswith(".safetensors"):
        return _read_safetensors(path)
    loaded = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(loaded, dict) and "model" in loaded:
        loaded = loaded["model"]
    return {k: v.numpy() for k, v in loaded.items()}


def fold_weight_norm(state: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """
    Every weight-normed tensor (``weight_g`` / ``weight_v``, or torch's
    ``parametrizations.weight.original0`` / ``original1``) folded into
    ``weight`` as ``g * v / (||v|| + 1e-9)`` over all but the first axis,
    in numpy as the JAX package folds it. Other keys pass as they are.
    """
    out: Dict[str, np.ndarray] = {}
    for key, value in state.items():
        for g_suffix, v_suffix in ((".weight_g", ".weight_v"),
                                   (".parametrizations.weight.original0", ".parametrizations.weight.original1")):
            if key.endswith(v_suffix):
                prefix = key[: -len(v_suffix)]
                if f"{prefix}.weight" not in state:
                    v, g = value, state[prefix + g_suffix]
                    norm = np.sqrt((v ** 2).sum(axis=tuple(range(1, v.ndim)), keepdims=True))
                    out[f"{prefix}.weight"] = g * v / (norm + 1e-9)
                break
            if key.endswith(g_suffix):
                break
        else:
            out[key] = value
    return out


def import_torch_checkpoint(path: str, config: VitsConfig = VitsConfig(), device: DeviceLike = "cuda") -> Vits:
    """Load a Piper / VITS checkpoint (``.pt`` or ``.safetensors``) into a ``Vits`` on ``device``."""
    raw = read_state_file(path)
    state = fold_weight_norm(raw)
    # JAX reads the posterior flows only under the plain key
    if "dp.post_pre.weight" not in raw:
        state = {k: v for k, v in state.items() if not k.startswith("dp.post_")}
    return Vits.from_state(state, config, device)
